"""The launch plans of the persistent LSTM scan and the register-tiled
flash forward, checked on the CPU: which block owns which hidden units,
what fits an H100's shared memory and SM count, and which layout each
shape gets. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import pytest

from neuralmonkey_tpu_torch.ops import cuda_rnn
from neuralmonkey_tpu_torch.ops import flash_attention as fa

H100_SMS, H100_SMEM = 132, 232448  # SMs; opt-in shared bytes a block

# (batch, hidden, directions): the smoke's encoder, the card tests'
# shapes, and the edges of what lstm_scan_fits accepts
LSTM_SHAPES = [(64, 512, 2), (6, 16, 1), (6, 64, 2), (6, 200, 1),
               (6, 6, 2), (6, 512, 2), (5, 200, 1), (1, 512, 2),
               (160, 512, 2), (64, 1024, 2), (3, 8300, 1), (64, 8300, 2),
               (512, 8300, 1), (1, 1, 1), (256, 4096, 2), (5, 64, 2)]


def _plan(batch, hidden, n_dirs):
    return cuda_rnn.lstm_scan_plan(batch, hidden, n_dirs, H100_SMS,
                                   H100_SMEM)


@pytest.mark.parametrize("batch,hidden,n_dirs", LSTM_SHAPES)
def test_lstm_scan_plan_owns_every_unit_once(batch, hidden, n_dirs):
    plan = _plan(batch, hidden, n_dirs)
    owned = [u for block in range(plan.blocks_per_dir)
             for u in range(block * plan.units,
                            min((block + 1) * plan.units, hidden))]
    assert owned == list(range(hidden))
    # no block of a direction is left without a unit
    assert (plan.blocks_per_dir - 1) * plan.units < hidden


@pytest.mark.parametrize("batch,hidden,n_dirs", LSTM_SHAPES)
def test_lstm_scan_plan_fits_the_card(batch, hidden, n_dirs):
    """Shared memory as the kernel lays it out (W_h slice or k tile, the
    h row tile, the partial sums, the mask), within 227 KB; one block
    per SM at most, so a cooperative launch holds every block; the k
    split fits the block's threads."""
    plan = _plan(batch, hidden, n_dirs)
    cols, h4 = 4 * plan.units, -(-hidden // 4) * 4
    assert plan.smem_bytes == 4 * (
        plan.k_tile * cols + plan.rows * (h4 + 4)
        + plan.k_split * plan.rows * cols + plan.rows)
    assert plan.smem_bytes <= H100_SMEM
    assert plan.blocks_per_dir * n_dirs <= H100_SMS
    assert 1 <= plan.rows <= batch
    assert plan.rows == batch or plan.rows % 4 == 0
    assert plan.k_tile % 4 == 0 and 4 <= plan.k_tile <= h4
    assert plan.resident == (plan.k_tile == h4)
    tasks = plan.units * -(-plan.rows // 4)
    assert plan.k_split == 1 or (
        tasks * plan.k_split <= cuda_rnn.LSTM_SCAN_THREADS
        and plan.k_split <= 8)


def test_lstm_scan_plan_keeps_w_resident_at_the_encoder_shape():
    """B 64, H 512, two directions: 64 blocks a direction of 8 units,
    each holding its 64 KB slice of W_h and every row of h."""
    plan = _plan(64, 512, 2)
    assert plan.resident and plan.rows == 64
    assert (plan.blocks_per_dir, plan.units) == (64, 8)
    assert plan.k_split == 2 and plan.smem_bytes == 214272


@pytest.mark.parametrize("batch,hidden,n_dirs,resident,tiles", [
    (160, 512, 2, True, 3),   # rows in tiles
    (64, 1024, 2, False, 2),  # the slice streams in k tiles
    (64, 8300, 2, False, 16)])
def test_lstm_scan_plan_tiles_what_does_not_fit(batch, hidden, n_dirs,
                                                resident, tiles):
    plan = _plan(batch, hidden, n_dirs)
    assert plan.resident == resident
    assert -(-batch // plan.rows) == tiles


def test_lstm_scan_plan_reads_the_card():
    """Fewer SMs give fewer, wider blocks; less shared memory a stream."""
    small = cuda_rnn.lstm_scan_plan(64, 512, 2, 16, H100_SMEM)
    assert (small.blocks_per_dir, small.units) == (8, 64)
    assert not small.resident and small.smem_bytes <= H100_SMEM
    tight = cuda_rnn.lstm_scan_plan(64, 512, 2, H100_SMS, 100 * 1024)
    assert not tight.resident and tight.smem_bytes <= 100 * 1024


@pytest.mark.parametrize("sms,smem", [(1, H100_SMEM), (132, 2048)])
def test_lstm_scan_plan_raises_where_nothing_fits(sms, smem):
    with pytest.raises(ValueError, match="lstm_scan"):
        cuda_rnn.lstm_scan_plan(64, 512, 2, sms, smem)


# (batch, heads, q len, kv len, head dim): the Transformer's encoder,
# decoder self- and cross-attention, the long source, and the card
# tests' shapes
FLASH_SHAPES = [(64, 8, 32, 32, 64), (64, 8, 48, 48, 64),
                (64, 8, 48, 32, 64), (8, 8, 512, 512, 64),
                (3, 5, 37, 70, 40), (1, 2, 9, 130, 8), (2, 2, 40, 40, 128),
                (4, 2, 32, 1, 64), (4, 2, 32, 33, 64), (2, 3, 33, 70, 6)]


@pytest.mark.parametrize("batch,heads,q_len,kv_len,dim", FLASH_SHAPES)
def test_flash_forward_plan_fits_the_card(batch, heads, q_len, kv_len,
                                          dim):
    plan = fa.flash_forward_plan(batch, heads, q_len, kv_len, dim)
    assert plan.grid == (batch * heads, -(-q_len // 32))
    assert dim <= plan.width and plan.width in (32, 64, 128)
    assert plan.stages == (2 if kv_len > plan.key_tile else 1)
    assert plan.smem_bytes <= H100_SMEM
    assert plan.threads % 32 == 0
    assert plan.rows * 8 == plan.threads * 2  # 8 threads a row, 2 rows each


@pytest.mark.parametrize("kv_len,blocks_per_sm", [(32, 8), (48, 5),
                                                  (512, 5)])
def test_flash_forward_plan_leaves_room_for_more_blocks(kv_len,
                                                        blocks_per_sm):
    """At head dim 64 more blocks share an SM's 228 KB than the three
    of the first design's 58 KB."""
    plan = fa.flash_forward_plan(64, 8, 32, kv_len, 64)
    assert (228 * 1024) // (plan.smem_bytes + 1024) == blocks_per_sm


def test_flash_forward_plan_rejects_wide_heads():
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward_plan(1, 1, 8, 8, 129)
