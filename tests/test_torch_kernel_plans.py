"""The launch plans of the persistent LSTM scan and the register-tiled
flash forward and backward, checked on the CPU: which block owns which
hidden units, queries or keys, which tiles each block walks, what fits
an H100's shared memory and SM count, and which layout each shape gets. The kernels themselves run only on the card
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


# the backward at every forward shape, causal where the query and key
# lengths match (the decoder's self-attention)
BACKWARD_CASES = [shape + (causal,) for shape in FLASH_SHAPES
                  for causal in (False, True)
                  if not causal or shape[2] == shape[3]]


@pytest.mark.parametrize("batch,heads,q_len,kv_len,dim,causal",
                         BACKWARD_CASES)
def test_flash_backward_plan_owns_every_row_once(batch, heads, q_len, kv_len,
                                                 dim, causal):
    """dq's blocks own every query of a (batch, head) once, dkv's every
    key; 8 threads a row, 2 rows a thread."""
    plan = fa.flash_backward_plan(batch, heads, q_len, kv_len, dim, causal)
    for launch, length in ((plan.dq, q_len), (plan.dkv, kv_len)):
        assert launch.grid[0] == batch * heads
        owned = [r for y in range(launch.grid[1])
                 for r in range(y * launch.rows,
                                min((y + 1) * launch.rows, length))]
        assert owned == list(range(length))
        assert (launch.grid[1] - 1) * launch.rows < length
        assert len(launch.walks) == launch.grid[1]
        assert launch.rows * 8 == launch.threads * 2


@pytest.mark.parametrize("batch,heads,q_len,kv_len,dim,causal",
                         BACKWARD_CASES)
def test_flash_backward_plan_walks_every_visible_pair(batch, heads, q_len,
                                                      kv_len, dim, causal):
    """Every (query, key) pair the mask leaves visible lies in a tile
    that the query's dq block and the key's dkv block walk; under the
    causal mask no block walks a tile whose pairs are all hidden: dq
    skips the key tiles above the diagonal, dkv the query tiles before
    it."""
    plan = fa.flash_backward_plan(batch, heads, q_len, kv_len, dim, causal)
    dq, dkv = plan.dq, plan.dkv
    for query in range(q_len):
        for key in range(kv_len if not causal else query + 1):
            first, end = dq.walks[query // dq.rows]
            assert first <= key // dq.tile < end
            first, end = dkv.walks[key // dkv.rows]
            assert first <= query // dkv.tile < end
    for y, (first, end) in enumerate(dq.walks):
        assert 0 <= first < end <= -(-kv_len // dq.tile)
        last_query = min((y + 1) * dq.rows, q_len) - 1
        assert not causal or (end - 1) * dq.tile <= last_query
    for y, (first, end) in enumerate(dkv.walks):
        assert 0 <= first < end <= -(-q_len // dkv.tile)
        assert not causal or (first + 1) * dkv.tile - 1 >= y * dkv.rows


@pytest.mark.parametrize("dim,width", [(6, 32), (16, 32), (32, 32),
                                       (40, 64), (64, 64), (128, 128)])
@pytest.mark.parametrize("length", [48, 512])
def test_flash_backward_plan_fits_the_card(dim, width, length):
    """Shared memory as the kernels lay it out (their rows of two
    matrices, and a stage of the other two with the mask, or lse and
    dcap), within 227 KB, at every width the kernels are built for."""
    plan = fa.flash_backward_plan(8, 8, length, length, dim, False)
    for launch, vectors in ((plan.dq, 1), (plan.dkv, 2)):
        assert launch.width == width
        row = width + 4  # the padded row stride
        assert launch.smem_bytes == 4 * (
            2 * launch.rows * row
            + launch.stages * (2 * launch.tile * row + vectors * launch.tile))
        assert launch.smem_bytes <= H100_SMEM


@pytest.mark.parametrize("q_len,kv_len", [(32, 1), (32, 31), (32, 32),
                                          (31, 33), (48, 48), (48, 32),
                                          (512, 512)])
def test_flash_backward_plan_double_buffers_past_one_tile(q_len, kv_len):
    """One stage when the walked axis fits one 32-row tile, two beyond:
    dq walks the keys, dkv the queries."""
    plan = fa.flash_backward_plan(2, 2, q_len, kv_len, 64, False)
    assert plan.dq.stages == (1 if kv_len <= 32 else 2)
    assert plan.dkv.stages == (1 if q_len <= 32 else 2)


def test_flash_backward_plan_at_the_encoder_shape():
    """B 64, H 8, 32 x 32, Dh 64: one block per (batch, head) for each
    kernel, one tile of 32, and 34 KB a block, so six blocks share an
    SM."""
    plan = fa.flash_backward_plan(64, 8, 32, 32, 64, False)
    for launch in plan:
        assert launch.grid == (512, 1) and launch.walks == ((0, 1),)
        assert launch.stages == 1 and launch.tile == 32
        assert (228 * 1024) // (launch.smem_bytes + 1024) == 6


@pytest.mark.parametrize("dim", [0, 129])
def test_flash_backward_plan_rejects_wide_heads(dim):
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_backward_plan(1, 1, 8, 8, dim, False)
