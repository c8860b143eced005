"""The launch plans of the persistent LSTM scan and BPTT, the persistent
GRU scan (K1) and BPTT, the fused cross-entropy's dx and dW, the
register-tiled flash forward and backward, K2's thread-block
clusters, the lineage attention's pipelined lane chunks and K4's warps,
checked on the CPU: which block owns which hidden units, rows, queries,
keys, source positions, columns, lanes or slots, which tiles each block
walks, what fits an H100's shared memory and SM count, and which layout
each shape gets. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import pytest

from neuralmonkey_tpu_torch.ops import beam_select, cuda_attention, cuda_rnn
from neuralmonkey_tpu_torch.ops import flash_attention as fa
from neuralmonkey_tpu_torch.ops import fused_xent
from neuralmonkey_tpu_torch.ops import lineage_attention as la

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


def _bptt_plan(batch, hidden, n_dirs):
    return cuda_rnn.lstm_bptt_plan(batch, hidden, n_dirs, H100_SMS,
                                   H100_SMEM)


@pytest.mark.parametrize("batch,hidden,n_dirs", LSTM_SHAPES)
def test_lstm_bptt_plan_owns_every_unit_once(batch, hidden, n_dirs):
    plan = _bptt_plan(batch, hidden, n_dirs)
    owned = [u for block in range(plan.blocks_per_dir)
             for u in range(block * plan.units,
                            min((block + 1) * plan.units, hidden))]
    assert owned == list(range(hidden))
    assert (plan.blocks_per_dir - 1) * plan.units < hidden


@pytest.mark.parametrize("batch,hidden,n_dirs", LSTM_SHAPES)
def test_lstm_bptt_plan_fits_the_card(batch, hidden, n_dirs):
    """Shared memory as csrc/lstm_bptt.cu lays it out (the W_h slice or
    k tile at its padded stride, the h row tile, the z sums whose first
    plane then holds dz, the mask), within 227 KB; one block per SM at
    most, so the cooperative launch holds every block; the z product's
    k split and the partial product's 4 x 4 tasks fit the threads."""
    plan = _bptt_plan(batch, hidden, n_dirs)
    cols, h4 = 4 * plan.units, -(-hidden // 4) * 4
    stride = cuda_rnn.lstm_bptt_slice_stride(plan.units)
    assert stride >= cols + 4 and (stride // 4) % 2 == 1
    assert plan.smem_bytes == 4 * (
        plan.k_tile * stride + plan.rows * (h4 + 4)
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


def test_lstm_bptt_plan_keeps_w_resident_at_the_encoder_shape():
    """B 64, H 512, two directions: 64 blocks a direction of 8 units,
    each holding its slice of W_h (rows of 36 floats) and every row of
    h_prev, 217 KB."""
    plan = _bptt_plan(64, 512, 2)
    assert plan.resident and plan.rows == 64
    assert (plan.blocks_per_dir, plan.units) == (64, 8)
    assert plan.k_split == 2 and plan.smem_bytes == 222464


@pytest.mark.parametrize("batch,hidden,n_dirs,tiles", [
    (64, 1024, 2, 2), (64, 4096, 2, 8), (64, 8300, 2, 16),
    (512, 8300, 1, 128)])
def test_lstm_bptt_plan_streams_what_does_not_fit(batch, hidden, n_dirs,
                                                 tiles):
    """Where the slice does not fit beside 16 rows of h, it streams in k
    tiles (both products walk them), and the rows go in tiles."""
    plan = _bptt_plan(batch, hidden, n_dirs)
    assert not plan.resident and plan.k_tile < hidden
    assert -(-batch // plan.rows) == tiles


def test_lstm_bptt_plan_reads_the_card():
    """Fewer SMs give fewer, wider blocks; less shared memory a stream."""
    small = cuda_rnn.lstm_bptt_plan(64, 512, 2, 16, H100_SMEM)
    assert (small.blocks_per_dir, small.units) == (8, 64)
    assert not small.resident and small.smem_bytes <= H100_SMEM
    tight = cuda_rnn.lstm_bptt_plan(64, 512, 2, H100_SMS, 100 * 1024)
    assert not tight.resident and tight.smem_bytes <= 100 * 1024


@pytest.mark.parametrize("sms,smem", [(1, H100_SMEM), (132, 2048)])
def test_lstm_bptt_plan_raises_where_nothing_fits(sms, smem):
    with pytest.raises(ValueError, match="lstm_bptt"):
        cuda_rnn.lstm_bptt_plan(64, 512, 2, sms, smem)


# (N, D, V): the decoder's loss tail at bench widths, the card tests'
# shapes, a ragged case, and the edges (one row, one vocabulary column, D
# past one 128-column pass)
DX_SHAPES = [(3072, 512, 30000), (333, 130, 1000), (70, 40, 300),
             (256, 128, 1024), (33, 130, 129), (40, 600, 200), (1, 1, 1),
             (3072, 512, 1000), (100000, 512, 30000), (128, 64, 129)]


def _dx_plan(n, d, v):
    return fused_xent.dx_plan(n, d, v, H100_SMS, H100_SMEM)


@pytest.mark.parametrize("n,d,v", DX_SHAPES)
def test_dx_plan_visits_every_row_and_column_once(n, d, v):
    """Every (row, vocabulary column) pair lies in exactly one block's
    row tile and vocabulary walk, and every column of D in that same
    block: each logit tile is computed once, where the first design
    computed it once per 128 columns of D."""
    plan = _dx_plan(n, d, v)
    rows_tiles, splits = plan.grid
    assert splits == plan.splits == len(plan.walks)
    rows = [r for y in range(rows_tiles)
            for r in range(y * plan.rows, min((y + 1) * plan.rows, n))]
    assert rows == list(range(n))
    columns = [c for first, end in plan.walks
               for tile in range(first, end)
               for c in range(tile * plan.vocab_tile,
                              min((tile + 1) * plan.vocab_tile, v))]
    assert columns == list(range(v))
    assert all(end - first <= plan.tiles_per_chunk and end > first
               for first, end in plan.walks)
    vocab_tiles = -(-v // plan.vocab_tile)
    logit_tiles = rows_tiles * sum(end - first for first, end in plan.walks)
    assert logit_tiles == rows_tiles * vocab_tiles
    # every block covers all of D in passes of d_tile columns
    assert plan.d_tile * -(-d // plan.d_tile) >= d


@pytest.mark.parametrize("n,d,v", DX_SHAPES)
def test_dx_plan_fits_the_card(n, d, v):
    """Two stages of a 128 x 36 x tile and a W tile, and the dl of two
    vocabulary tiles (128 x 260) in shared memory, one block an SM; 256
    threads, 8 warps whose 64 x 32 mma tiles keep 64 sums a thread and
    cover the 128 x 128 tile."""
    plan = _dx_plan(n, d, v)
    assert plan.smem_bytes == 4 * (2 * (128 * 36 + 128 * 36)
                                   + 128 * 260) == 206848
    assert plan.smem_bytes + 1024 <= 228 * 1024
    assert plan.threads == 256 and plan.thread_sums == 64
    assert plan.threads * plan.thread_sums == plan.rows * plan.d_tile
    assert (plan.threads // 32) * 64 * 32 == plan.rows * plan.vocab_tile


def test_dx_plan_fills_the_card_at_the_bench_shape():
    """N 3072, D 512, V 30000: 24 row tiles x 11 chunks of 22 vocabulary
    tiles, 264 blocks, two waves on the 132 SMs (the first design had
    96 blocks)."""
    plan = _dx_plan(3072, 512, 30000)
    assert plan.grid == (24, 11) and plan.tiles_per_chunk == 22
    assert plan.grid[0] * plan.grid[1] >= H100_SMS
    assert plan.grid[0] * plan.grid[1] == 2 * H100_SMS


def test_dx_plan_ragged_and_small():
    """333 x 130 x 1000: 3 row tiles, 8 chunks of one vocabulary tile;
    one row tile and one vocabulary tile need no fold (S = 1)."""
    plan = _dx_plan(333, 130, 1000)
    assert plan.grid == (3, 8) and plan.walks[-1] == (7, 8)
    assert _dx_plan(1, 1, 1).splits == 1


@pytest.mark.parametrize("sms,smem", [(0, H100_SMEM), (132, 200 * 1024)])
def test_dx_plan_raises_where_nothing_fits(sms, smem):
    with pytest.raises(ValueError, match="fused_xent_bwd_dx"):
        fused_xent.dx_plan(3072, 512, 30000, sms, smem)


def _dw_plan(n, d, v):
    return fused_xent.dw_plan(n, d, v, H100_SMS, H100_SMEM)


@pytest.mark.parametrize("n,d,v", DX_SHAPES)
def test_dw_plan_visits_every_row_and_column_once(n, d, v):
    """Every (row, vocabulary column) pair lies in exactly one block's
    vocabulary tile and row walk, and every row of D in that same block:
    each logit tile is computed once, where the first design computed
    it once per 128 rows of D."""
    plan = _dw_plan(n, d, v)
    vocab_tiles, splits = plan.grid
    assert splits == plan.splits == len(plan.walks)
    columns = [c for x in range(vocab_tiles)
               for c in range(x * plan.vocab_tile,
                              min((x + 1) * plan.vocab_tile, v))]
    assert columns == list(range(v))
    rows = [r for first, end in plan.walks for tile in range(first, end)
            for r in range(tile * plan.rows, min((tile + 1) * plan.rows, n))]
    assert rows == list(range(n))
    assert all(end - first <= plan.tiles_per_chunk and end > first
               for first, end in plan.walks)
    logit_tiles = vocab_tiles * sum(end - first for first, end in plan.walks)
    assert logit_tiles == vocab_tiles * -(-n // plan.rows)
    # every block covers all of D in passes of d_tile rows
    assert plan.d_tile * -(-d // plan.d_tile) >= d


@pytest.mark.parametrize("n,d,v", DX_SHAPES)
def test_dw_plan_fits_the_card(n, d, v):
    """Two stages of a 128 x 36 x tile and a W tile, and the dl of two
    row tiles one above the other (256 x 136) in shared memory, one
    block an SM; dx's 256 threads and 64 register sums a thread, which
    cover a 128 x 128 tile of dW."""
    plan = _dw_plan(n, d, v)
    assert plan.smem_bytes == 4 * (2 * (128 * 36 + 128 * 36)
                                   + 256 * 136) == 212992
    assert plan.smem_bytes + 1024 <= 228 * 1024
    assert plan.threads == 256 and plan.thread_sums == 64
    assert plan.threads * plan.thread_sums == plan.d_tile * plan.vocab_tile


def test_dw_plan_fills_the_card_at_the_bench_shape():
    """N 3072, D 512, V 30000: 235 vocabulary tiles, one chunk of all 24
    row tiles: 235 blocks on the 132 SMs, writing dW itself (no
    scratch, no fold)."""
    plan = _dw_plan(3072, 512, 30000)
    assert plan.grid == (235, 1) and plan.tiles_per_chunk == 24
    assert plan.walks == ((0, 24),)
    assert plan.grid[0] * plan.grid[1] >= H100_SMS


def test_dw_plan_ragged_and_small():
    """333 x 130 x 1000: 8 vocabulary tiles, 3 chunks of one row tile,
    folded; one row tile and one vocabulary tile need no fold (S = 1)."""
    plan = _dw_plan(333, 130, 1000)
    assert plan.grid == (8, 3) and plan.walks == ((0, 1), (1, 2), (2, 3))
    assert _dw_plan(1, 1, 1).splits == 1


@pytest.mark.parametrize("sms,smem", [(0, H100_SMEM), (132, 200 * 1024)])
def test_dw_plan_raises_where_nothing_fits(sms, smem):
    with pytest.raises(ValueError, match="fused_xent_bwd_dw"):
        fused_xent.dw_plan(3072, 512, 30000, sms, smem)


# (batch, hidden, directions): the smoke's encoder, the card tests'
# shapes, and the edges of what bptt_fits accepts
GRU_SHAPES = [(64, 512, 2), (6, 16, 1), (6, 64, 2), (6, 6, 2), (6, 517, 2),
              (5, 37, 2), (64, 1024, 2), (64, 2048, 2), (5, 4099, 1),
              (64, 4096, 2), (3, 7264, 1), (64, 7264, 2), (1, 1, 1),
              (160, 512, 2), (512, 512, 1)]


def _gru_plan(batch, hidden, n_dirs):
    return cuda_rnn.gru_bptt_plan(batch, hidden, n_dirs, H100_SMS,
                                  H100_SMEM)


@pytest.mark.parametrize("batch,hidden,n_dirs", GRU_SHAPES)
def test_gru_bptt_plan_owns_every_unit_once(batch, hidden, n_dirs):
    """Blocks of a multiple of 4 units cover every unit of a direction
    once; no block of a direction is left without a unit."""
    plan = _gru_plan(batch, hidden, n_dirs)
    assert plan.units % 4 == 0
    owned = [u for block in range(plan.blocks_per_dir)
             for u in range(block * plan.units,
                            min((block + 1) * plan.units, hidden))]
    assert owned == list(range(hidden))
    assert (plan.blocks_per_dir - 1) * plan.units < hidden


@pytest.mark.parametrize("batch,hidden,n_dirs", GRU_SHAPES)
def test_gru_bptt_plan_fits_the_card(batch, hidden, n_dirs):
    """Shared memory as csrc/gru_bptt.cu lays it out (the slice of three
    gate columns a unit, or its k tile, in the place of the prologue's
    two 16 x 132 tile stages; then a row of dr, du·u(1−u), dxc and the
    mask for each of the tile's rows) within 227 KB; one block per SM at
    most, so the cooperative launch holds every block."""
    plan = _gru_plan(batch, hidden, n_dirs)
    units, h4 = plan.units, -(-hidden // 4) * 4
    assert plan.smem_bytes == 4 * (max(plan.k_tile * 3 * units, 2 * 16 * 132)
                                   + plan.rows * (3 * units + 1))
    assert plan.smem_bytes <= H100_SMEM
    assert plan.blocks_per_dir * n_dirs <= H100_SMS
    assert 1 <= plan.rows <= batch
    assert plan.rows == batch or plan.rows % 4 == 0
    assert plan.k_tile % 4 == 0 and 4 <= plan.k_tile <= h4
    assert plan.resident == (plan.k_tile == h4)


def test_gru_bptt_plan_keeps_the_slice_resident_at_the_encoder_shape():
    """B 64, H 512, two directions: 64 blocks a direction of 8 units,
    each holding its 24 x 512 slice and the step values of every row:
    55,552 bytes."""
    plan = _gru_plan(64, 512, 2)
    assert plan.resident and plan.rows == 64
    assert (plan.blocks_per_dir, plan.units) == (64, 8)
    assert plan.smem_bytes == 55552


@pytest.mark.parametrize("batch,hidden,n_dirs,tiles", [
    (64, 2048, 2, 4), (5, 4099, 1, 1), (64, 4096, 2, 4), (3, 7264, 1, 1),
    (64, 7264, 2, 4)])
def test_gru_bptt_plan_streams_what_does_not_fit(batch, hidden, n_dirs,
                                                 tiles):
    """Where the slice does not fit beside 16 rows, the partial products
    stream it in k tiles, and the rows go in tiles; H 7264, the largest
    bptt_fits takes, still fits."""
    assert cuda_rnn.bptt_fits(hidden)
    plan = _gru_plan(batch, hidden, n_dirs)
    assert not plan.resident and plan.k_tile < hidden
    assert -(-batch // plan.rows) == tiles


def test_gru_bptt_takes_what_its_first_design_took():
    assert cuda_rnn.bptt_fits(7264) and not cuda_rnn.bptt_fits(7265)


def test_gru_bptt_plan_reads_the_card():
    """Fewer SMs give fewer, wider blocks and a stream; less shared
    memory a stream."""
    small = cuda_rnn.gru_bptt_plan(64, 512, 2, 16, H100_SMEM)
    assert (small.blocks_per_dir, small.units) == (8, 64)
    assert not small.resident and small.smem_bytes <= H100_SMEM
    tight = cuda_rnn.gru_bptt_plan(64, 512, 2, H100_SMS, 48 * 1024)
    assert not tight.resident and tight.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("sms,smem", [(1, H100_SMEM), (132, 2048)])
def test_gru_bptt_plan_raises_where_nothing_fits(sms, smem):
    with pytest.raises(ValueError, match="gru_bptt"):
        cuda_rnn.gru_bptt_plan(64, 512, 2, sms, smem)


# (batch, hidden, directions): the smoke's encoder, the card tests'
# shapes, and the edges of what scan_fits accepts
GRU_SCAN_SHAPES = [(64, 512, 2), (6, 16, 1), (6, 64, 2), (6, 1024, 2),
                   (6, 6, 2), (6, 4099, 1), (5, 24, 2), (4, 8, 1),
                   (4, 20, 1), (5, 50, 2), (64, 2048, 2), (64, 4099, 2),
                   (64, 7264, 2), (3, 19368, 1), (64, 19368, 2),
                   (1, 1, 1), (160, 512, 2), (512, 512, 1), (1, 512, 2)]


def _scan_plan(batch, hidden, n_dirs):
    return cuda_rnn.gru_scan_plan(batch, hidden, n_dirs, H100_SMS,
                                  H100_SMEM)


@pytest.mark.parametrize("batch,hidden,n_dirs", GRU_SCAN_SHAPES)
def test_gru_scan_plan_owns_every_unit_once(batch, hidden, n_dirs):
    """Blocks of a multiple of 4 units cover every unit of a direction
    once; no block of a direction is left without a unit."""
    plan = _scan_plan(batch, hidden, n_dirs)
    assert plan.units % 4 == 0
    owned = [u for block in range(plan.blocks_per_dir)
             for u in range(block * plan.units,
                            min((block + 1) * plan.units, hidden))]
    assert owned == list(range(hidden))
    assert (plan.blocks_per_dir - 1) * plan.units < hidden


@pytest.mark.parametrize("batch,hidden,n_dirs", GRU_SCAN_SHAPES)
def test_gru_scan_plan_fits_the_card(batch, hidden, n_dirs):
    """Shared memory as csrc/gru_scan.cu lays it out (the slice of three
    gate columns a unit, or its k tile; the staged h or r·h rows of a
    tile; the partial sums of phase 1's two gates, k_split parts; the
    mask) within 227 KB; one block per SM at most, so the cooperative
    launch holds every block; both phases' k splits fit the block's
    threads (phase 2 has half the columns in twice the parts)."""
    plan = _scan_plan(batch, hidden, n_dirs)
    units, h4 = plan.units, -(-hidden // 4) * 4
    assert plan.smem_bytes == 4 * (
        plan.k_tile * 3 * units + plan.rows * (h4 + 4)
        + plan.k_split * plan.rows * 2 * units + plan.rows)
    assert plan.smem_bytes <= H100_SMEM
    assert plan.blocks_per_dir * n_dirs <= H100_SMS
    assert 1 <= plan.rows <= batch
    # whole tiles of 4 rows, unless fewer than 4 rows fit
    assert plan.rows == batch or plan.rows % 4 == 0 or plan.rows < 4
    assert plan.k_tile % 4 == 0 and 4 <= plan.k_tile <= h4
    assert plan.resident == (plan.k_tile == h4)
    row_groups = -(-plan.rows // 4)
    phase1 = (2 * units // 4) * row_groups * plan.k_split
    phase2 = (units // 4) * row_groups * 2 * plan.k_split
    assert phase1 == phase2
    assert plan.k_split == 1 or phase1 <= cuda_rnn.LSTM_SCAN_THREADS


def test_gru_scan_plan_keeps_the_slice_resident_at_the_encoder_shape():
    """B 64, H 512, two directions: 64 blocks a direction of 8 units,
    each holding its 24 x 512 slice (48 KB) beside all 64 rows of h and
    four parts of phase 1's sums: 197,888 bytes."""
    plan = _scan_plan(64, 512, 2)
    assert plan.resident and plan.rows == 64
    assert (plan.blocks_per_dir, plan.units, plan.k_split) == (64, 8, 4)
    assert plan.smem_bytes == 197888


@pytest.mark.parametrize("batch,hidden,n_dirs,tiles", [
    (64, 2048, 2, 4), (64, 4099, 2, 8), (6, 4099, 1, 1), (64, 7264, 2, 16),
    (3, 19368, 1, 2), (64, 19368, 2, 32)])
def test_gru_scan_plan_streams_what_does_not_fit(batch, hidden, n_dirs,
                                                 tiles):
    """Where the slice does not fit beside 16 rows, it streams in k
    tiles, and the rows go in tiles; H 19368, the largest scan_fits
    takes, still fits."""
    assert cuda_rnn.scan_fits(hidden)
    plan = _scan_plan(batch, hidden, n_dirs)
    assert not plan.resident and plan.k_tile < hidden
    assert -(-batch // plan.rows) == tiles


@pytest.mark.parametrize("hidden", [1, 3, 4, 5, 255, 512, 1000, 4100,
                                    8300, 12345, 16384, 19368])
@pytest.mark.parametrize("batch,n_dirs", [(1, 1), (64, 2), (256, 2)])
def test_gru_scan_plan_lays_out_every_size_scan_fits_takes(hidden, batch,
                                                          n_dirs):
    assert cuda_rnn.scan_fits(hidden)
    plan = _scan_plan(batch, hidden, n_dirs)
    assert plan.smem_bytes <= H100_SMEM and plan.rows >= 1
    assert plan.blocks_per_dir * plan.units >= hidden


def test_gru_scan_plan_reads_the_card():
    """Fewer SMs give fewer, wider blocks and a stream; less shared
    memory a stream."""
    small = cuda_rnn.gru_scan_plan(64, 512, 2, 16, H100_SMEM)
    assert (small.blocks_per_dir, small.units) == (8, 64)
    assert not small.resident and small.smem_bytes <= H100_SMEM
    tight = cuda_rnn.gru_scan_plan(64, 512, 2, H100_SMS, 48 * 1024)
    assert not tight.resident and tight.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("batch,hidden,sms,smem", [
    (64, 512, 1, H100_SMEM), (64, 512, 132, 2048),
    (1, 19368, 1, H100_SMEM), (1, 19368, 132, 64 * 1024)])
def test_gru_scan_plan_raises_where_nothing_fits(batch, hidden, sms, smem):
    with pytest.raises(ValueError, match="gru_scan"):
        cuda_rnn.gru_scan_plan(batch, hidden, 2 if sms == 1 else 1, sms,
                               smem)


# (batch, heads, q len, kv len, head dim): the Transformer's encoder,
# decoder self- and cross-attention, the long source, and the card
# tests' shapes
FLASH_SHAPES = [(64, 8, 32, 32, 64), (64, 8, 48, 48, 64),
                (64, 8, 48, 32, 64), (8, 8, 512, 512, 64),
                (3, 5, 37, 70, 40), (1, 2, 9, 130, 8), (2, 2, 40, 40, 128),
                (4, 2, 32, 1, 64), (4, 2, 32, 33, 64), (2, 3, 33, 70, 6),
                (2, 2, 9, 40, 192), (2, 1, 33, 70, 256)]


@pytest.mark.parametrize("batch,heads,q_len,kv_len,dim", FLASH_SHAPES)
def test_flash_forward_plan_fits_the_card(batch, heads, q_len, kv_len,
                                          dim):
    plan = fa.flash_forward_plan(batch, heads, q_len, kv_len, dim)
    assert plan.grid == (batch * heads, -(-q_len // 32))
    assert dim <= plan.width and plan.width in (32, 64, 128, 256)
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


@pytest.mark.parametrize("dim", [0, 320, 512, 1024])
def test_flash_forward_plan_rejects_wide_heads(dim):
    """Head dim 0 has no plan; past 256 the chunked launch: a column
    block of 256 output columns for each 256 of the head dim, one stage
    of the q and k chunks, the v slice and the key mask, within 227 KB."""
    if dim == 0:
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_forward_plan(1, 1, 8, 8, dim)
        return
    plan = fa.flash_forward_plan(2, 3, 40, 70, dim)
    assert plan.grid == (6, 2) and plan.width == fa.CHUNK == 256
    assert plan.column_blocks == plan.chunks == -(-dim // 256)
    assert plan.stages == 1
    assert plan.smem_bytes == 4 * (2 * 32 * 260 + 32 * 256 + 32)
    assert plan.smem_bytes <= H100_SMEM


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
                                       (40, 64), (64, 64), (128, 128),
                                       (192, 256), (256, 256)])
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


@pytest.mark.parametrize("dim", [0, 257, 320, 512, 1024])
def test_flash_backward_plan_rejects_wide_heads(dim):
    """Head dim 0 has no plan; past 256 the chunked launches: dq holds q,
    dO, k and v chunks and its k slice, dkv its k and v chunks, q and dO
    chunks and their slices, one stage each, within 227 KB, walking the
    tiles the single pass walks, in a column block for each 256 of the
    head dim."""
    if dim == 0:
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_backward_plan(1, 1, 8, 8, dim, False)
        return
    plan = fa.flash_backward_plan(2, 2, 48, 48, dim, True)
    narrow = fa.flash_backward_plan(2, 2, 48, 48, 64, True)
    row = 256 + 4
    for launch, wide, vectors in ((plan.dq, 5, 1), (plan.dkv, 6, 2)):
        assert launch.column_blocks == launch.chunks == -(-dim // 256)
        assert launch.width == 256 and launch.stages == 1
        assert launch.smem_bytes == 4 * (wide * 32 * row + vectors * 32)
        assert launch.smem_bytes <= H100_SMEM
    assert (plan.dq.walks, plan.dkv.walks) == (narrow.dq.walks,
                                               narrow.dkv.walks)


# (batch, time, att, dim): the bench shape, the card tests' shapes (ragged
# ones with unaligned widths, B 1, T 1, streamed states), the
# longest source the first design took (T 12288), a beam of 640 rows
BAHDANAU_SHAPES = [(64, 32, 512, 1024), (5, 9, 48, 80), (5, 9, 47, 81),
                   (7, 13, 50, 83), (1, 32, 512, 1024), (1, 1, 512, 1024),
                   (1, 1, 1, 1), (64, 1, 3, 5), (2, 1000, 64, 1024),
                   (3, 3000, 37, 1023), (64, 12288, 512, 1024),
                   (640, 32, 512, 1024), (128, 50, 256, 512),
                   (3, 7, 40000, 6), (7, 13, 48, 88), (64, 64, 512, 1024),
                   (64, 8, 512, 1024)]


def _bahdanau_plan(batch, time, att, dim):
    return cuda_attention.bahdanau_plan(batch, time, att, dim, H100_SMS,
                                        H100_SMEM)


@pytest.mark.parametrize("batch,time,att,dim", BAHDANAU_SHAPES)
def test_bahdanau_plan_owns_every_position_and_column_once(batch, time, att,
                                                           dim):
    """Each source position's energy is computed by exactly one block of
    a row's cluster, and each context column by exactly one: the chunks
    the kernel takes from its rank (r * positions .., r * columns ..)."""
    plan = _bahdanau_plan(batch, time, att, dim)
    ranks = range(plan.cluster)
    positions = [t for r in ranks for t in range(
        r * plan.positions, min(time, (r + 1) * plan.positions))]
    columns = [c for r in ranks for c in range(
        r * plan.columns, min(dim, (r + 1) * plan.columns))]
    assert positions == list(range(time)) and columns == list(range(dim))
    assert plan.columns % 4 == 0
    # the first block owns a position and a 4-column group
    assert plan.positions >= 1 and plan.columns >= 4


@pytest.mark.parametrize("batch,time,att,dim", BAHDANAU_SHAPES)
def test_bahdanau_plan_fits_the_card(batch, time, att, dim):
    """Shared memory as the kernel lays it out (energies, reductions,
    context partials; pq, v, the mask row and the block's keys when
    staged) within 227 KB; a portable cluster of at most 8 blocks, no
    more than the positions or 4-column groups; B clusters; the operands
    staged exactly when they fit; the states slice in registers exactly
    when D is a multiple of 4 and each thread holds at most 8 float4 of
    it: a block's 4-column units share its 256 threads, each unit's T
    rows split over the threads it gets."""
    plan = _bahdanau_plan(batch, time, att, dim)

    def layout(staged):
        def round4(n):
            return -(-n // 4) * 4
        return 4 * (round4(time) + 32 + 1024
                    + staged * ((2 + plan.positions) * round4(att)
                                + round4(time)))
    assert plan.smem_bytes == layout(plan.staged) <= H100_SMEM
    assert 1 <= plan.cluster <= 8
    assert plan.cluster <= min(time, -(-dim // 4))
    assert plan.grid == batch * plan.cluster and plan.threads == 256
    assert plan.staged == (layout(True) <= H100_SMEM)
    units = plan.columns // 4
    held = -(-time // (256 // units)) if units <= 256 else None
    assert plan.resident == (dim % 4 == 0 and held is not None
                             and held <= 8)


@pytest.mark.parametrize("batch,cluster,staged", [(64, 4, True),
                                                  (640, 1, False)])
def test_bahdanau_plan_at_the_image_shapes(batch, cluster, staged):
    """A 14 x 14 x 512 image map projected to 512, attention 512: greedy
    at B 64 takes clusters of 4, 49 positions a block, the operands
    staged; the hierarchical children under beam 10 (B 640) take one
    block a row, the 2 + 196 operand rows of 512 read in place (405 KB
    would not fit). The states are streamed at both (T 196 is past what
    a thread holds)."""
    plan = _bahdanau_plan(batch, 196, 512, 512)
    assert (plan.cluster, plan.staged, plan.resident) == (cluster, staged,
                                                          False)
    assert plan.positions == 196 // cluster and plan.grid == batch * cluster
    assert plan.smem_bytes <= H100_SMEM


def test_bahdanau_plan_fills_the_card_at_the_bench_shape():
    """B 64, T 32, A 512, D 1024: clusters of 4, 256 blocks on the 132
    SMs (the first design had 64), each with 8 positions, whose 16 KB of
    keys are staged beside pq, v and the mask, and a 32 KB slice of 256
    columns of the states in registers, 8 float4 a thread."""
    plan = _bahdanau_plan(64, 32, 512, 1024)
    assert plan.cluster == 4 and plan.grid == 256 >= H100_SMS
    assert (plan.positions, plan.columns) == (8, 256)
    assert plan.resident and plan.staged
    assert 32 * 256 == 8 * 4 * plan.threads
    assert plan.smem_bytes == 4 * (32 + 32 + 1024 + 10 * 512 + 32) == 24960


@pytest.mark.parametrize("batch,time,att,dim,cluster", [
    (1, 32, 512, 1024, 8),   # B 1: the largest portable cluster
    (1, 1, 512, 1024, 1),    # T 1: one block owns the one position
    (64, 1, 3, 5, 1),
    (1, 1, 1, 1, 1),
    (5, 9, 48, 80, 8),       # T 9 over 8 blocks: chunks of 2, the last empty
    (128, 50, 256, 512, 2),
    (640, 32, 512, 1024, 1)])
def test_bahdanau_plan_cluster_sizes(batch, time, att, dim, cluster):
    assert _bahdanau_plan(batch, time, att, dim).cluster == cluster


@pytest.mark.parametrize("batch,time,att,dim,staged", [
    (64, 12288, 512, 1024, False),  # the longest source the first design took
    (2, 1000, 64, 1024, True), (3, 3000, 37, 1023, True),
    (7, 13, 50, 83, True), (64, 64, 512, 1024, True)])
def test_bahdanau_plan_streams_long_sources(batch, time, att, dim, staged):
    """Where a thread's share of the states slice passes 8 float4 (or D
    is not a multiple of 4), the context pass reads it from device
    memory; where a block's keys do not fit in shared memory either, the
    energies read their operands in place."""
    plan = _bahdanau_plan(batch, time, att, dim)
    assert not plan.resident and plan.staged == staged


@pytest.mark.parametrize("batch,time,att,dim", [
    (1, 32, 512, 1024), (64, 1, 512, 1024), (7, 13, 48, 88),
    (64, 8, 512, 1024)])
def test_bahdanau_plan_holds_short_sources_in_registers(batch, time, att,
                                                        dim):
    assert _bahdanau_plan(batch, time, att, dim).resident


def test_bahdanau_plan_reads_the_operands_in_place_when_they_do_not_fit():
    plan = _bahdanau_plan(3, 7, 40000, 6)
    assert not plan.staged and not plan.resident


@pytest.mark.parametrize("batch,time,sms,smem", [
    (64, 32, 0, H100_SMEM), (0, 32, 132, H100_SMEM),
    (64, 32, 132, 2048), (1, 60000, 132, H100_SMEM)])
def test_bahdanau_plan_raises_where_nothing_fits(batch, time, sms, smem):
    with pytest.raises(ValueError, match="fused_bahdanau_step"):
        cuda_attention.bahdanau_plan(batch, time, 512, 1024, sms, smem)


# ---------------------------------------------------------------------- #
# the lineage attention
# ---------------------------------------------------------------------- #
# (batch, heads, beam, head dim, cache lanes, lanes read): the smoke's beam
# step at its windows, a server's few sentences, the card tests' shapes,
# 63 lanes, K past 16, one lane, head dims past 256
LINEAGE_SHAPES = [(64, 8, 10, 64, 480, 480), (64, 8, 10, 64, 480, 120),
                  (64, 8, 10, 64, 480, 240), (1, 8, 10, 64, 480, 480),
                  (1, 8, 10, 64, 480, 1), (2, 4, 1, 64, 96, 96),
                  (3, 2, 7, 40, 63, 35), (2, 4, 17, 64, 340, 340),
                  (8, 8, 10, 256, 480, 480), (16, 8, 10, 128, 480, 480),
                  (4, 2, 33, 16, 99, 99), (1, 1, 1, 16, 1, 1),
                  (128, 16, 4, 32, 400, 400), (1, 8, 64, 256, 3072, 3000),
                  (2, 2, 10, 384, 480, 480), (1, 8, 10, 512, 480, 480),
                  (8, 1, 7, 512, 63, 63), (64, 8, 33, 512, 99, 99)]


def _lineage_plan(batch, heads, beam, dim, total, lanes, aligned=True):
    return la.lineage_plan(batch, heads, beam, dim, total, lanes, H100_SMS,
                           H100_SMEM, aligned)


@pytest.mark.parametrize("batch,heads,beam,dim,total,lanes", LINEAGE_SHAPES)
def test_lineage_plan_covers_every_lane_and_slot_once(batch, heads, beam,
                                                      dim, total, lanes):
    """Each (b, h, slot group) block walks its chunk of the lanes: the
    chunks tile the W lanes read, none empty, each a whole number of the
    plan's lane tiles; the groups hold every slot once, in tiles of 8 (at
    most 4 a block), the beam rounded up to 8 where one group holds it; a
    warp for each 16-lane tile of a stage and each 8 slots."""
    plan = _lineage_plan(batch, heads, beam, dim, total, lanes)
    assert plan.tile == (16 if plan.dmax > 256 else 32)
    assert plan.chunk % plan.tile == 0
    chunks = [range(s * plan.chunk, min(lanes, (s + 1) * plan.chunk))
              for s in range(plan.splits)]
    assert all(len(c) for c in chunks)
    assert [lane for c in chunks for lane in c] == list(range(lanes))
    assert plan.slots % la.SLOT_TILE == 0
    assert plan.slots <= la.SLOT_TILE * la.MAX_SLOT_TILES
    slots = [k for g in range(plan.groups)
             for k in range(g * plan.slots, min(beam, (g + 1) * plan.slots))]
    assert slots == list(range(beam))
    if beam <= la.SLOT_TILE * la.MAX_SLOT_TILES and dim <= 128:
        assert plan.groups == 1 and plan.slots == -(-beam // 8) * 8
    assert plan.threads == 32 * plan.tile // 16 * plan.slots // 8 <= 512
    assert plan.dmax == min(pad for pad in la.HEAD_DIM_PADS if pad >= dim)


@pytest.mark.parametrize("batch,heads", [(1, 1), (1, 8), (4, 8), (16, 8),
                                         (32, 8), (33, 8), (64, 8),
                                         (128, 16)])
def test_lineage_plan_splits_lanes_where_the_grid_is_small(batch, heads):
    """Under twice the SM count of (b, h) blocks the lanes split so that
    the blocks fill the card twice (or a chunk is one tile); at or over
    it, one chunk."""
    plan = _lineage_plan(batch, heads, 10, 64, 960, 960)
    blocks = batch * heads * plan.groups
    if blocks < 2 * H100_SMS:
        assert plan.splits > 1
        assert (blocks * plan.splits >= 2 * H100_SMS
                or plan.chunk == plan.tile)
    else:
        assert plan.splits == 1 and plan.chunk >= 960


@pytest.mark.parametrize("dim", [16, 32, 40, 64, 96, 128, 192, 256, 384,
                                 512])
@pytest.mark.parametrize("beam", [1, 4, 10, 16, 17, 32, 64])
def test_lineage_plan_fits_the_card(dim, beam):
    """Shared memory as the kernel lays it out (a K, a V and a bias tile
    a stage, q, each warp's weights), within 227 KB; 2-4 stages; the
    resident blocks an SM that shared memory, threads and the registers
    of the kernel's launch bounds (128 a thread, 256 from a padded 256)
    allow; the ring large enough for the warps' partials at the end."""
    plan = _lineage_plan(64, 8, beam, dim, 480, 480)
    assert plan.smem_bytes == la.lineage_smem_bytes(plan.dmax, plan.slots,
                                                    plan.tile, plan.stages)
    assert plan.smem_bytes <= H100_SMEM and 2 <= plan.stages <= 4
    registers = 256 if plan.dmax >= 256 else 128
    assert plan.blocks_per_sm == min(
        2048 // plan.threads,
        la.SM_SHARED_BYTES // (plan.smem_bytes + la.BLOCK_RESERVED_BYTES),
        65536 // (registers * plan.threads))
    stage = (plan.dmax * (plan.tile + 8) + plan.tile * (plan.dmax + 8)
             + plan.slots * plan.tile)
    warps = plan.threads // 32
    assert plan.stages * stage >= warps * (16 + plan.dmax * 8)


def test_lineage_plan_at_the_smoke_shape():
    """B 64, H 8, K 10, Dh 64, 480 lanes: no lane split, 16 slot rows
    (two 8-wide tiles), 32-lane stages, 4 warps a block, 2 stages, 4
    blocks an SM, 16-byte copies."""
    plan = _lineage_plan(64, 8, 10, 64, 480, 480)
    assert (plan.splits, plan.slots, plan.groups, plan.tile, plan.threads,
            plan.stages, plan.blocks_per_sm, plan.vec) == (
                1, 16, 1, 32, 128, 2, 4, True)


@pytest.mark.parametrize("beam,dim", [(10, 64), (10, 256), (4, 32),
                                      (17, 128), (10, 512), (1, 16)])
def test_lineage_plan_keeps_the_most_warps_resident(beam, dim):
    """No other stage count that fits keeps more warps resident an SM
    (by shared memory, threads and registers) than the plan's, and where
    registers bind, more stages cost no residency, so the plan takes the
    most that keep it."""
    plan = _lineage_plan(64, 8, beam, dim, 480, 480)
    registers = 256 if plan.dmax >= 256 else 128
    for stages in (2, 3, 4):
        smem = la.lineage_smem_bytes(plan.dmax, plan.slots, plan.tile, stages)
        if smem <= H100_SMEM:
            resident = min(
                2048 // plan.threads,
                la.SM_SHARED_BYTES // (smem + la.BLOCK_RESERVED_BYTES),
                65536 // (registers * plan.threads))
            assert resident <= plan.blocks_per_sm
            assert resident < plan.blocks_per_sm or stages <= plan.stages


@pytest.mark.parametrize("dim,total,aligned,vec", [
    (64, 480, True, True), (40, 63, True, False), (64, 63, True, False),
    (42, 480, True, False), (64, 480, False, False), (256, 3072, True, True)])
def test_lineage_plan_takes_4_byte_copies_off_16_bytes(dim, total, aligned,
                                                      vec):
    """16-byte copies need the K rows (total lanes) and the V rows (head
    dim) in multiples of 4 floats and aligned caches; 63 lanes (the
    smoke's ragged shape) take 4-byte copies."""
    assert _lineage_plan(3, 2, 7, dim, total, total, aligned).vec == vec


@pytest.mark.parametrize("dim,lanes", [(1024, 0), (0, 10), (64, 0),
                                       (64, 481)])
def test_lineage_plan_refuses_what_the_kernel_does_not_take(dim, lanes):
    with pytest.raises(ValueError, match="lineage_attention"):
        _lineage_plan(2, 2, 4, dim, 480, lanes)


@pytest.mark.parametrize("batch,heads,beam,dim,lanes", [
    (2, 2, 10, 640, 480), (64, 8, 10, 1024, 480), (1, 1, 1, 513, 1),
    (3, 1, 7, 1000, 63), (1, 8, 10, 4096, 480)])
def test_lineage_plan_chunks_wide_heads(batch, heads, beam, dim, lanes):
    """Past head dim 512 the chunked instance: a block a slot (groups of
    one), a column block for each 512 context columns, 32-lane tiles,
    one stage, q and the tile's scores and weights in shared memory; the
    lanes split as the single pass splits them (chunks of whole tiles
    that cover every lane once, never empty)."""
    plan = _lineage_plan(batch, heads, beam, dim, lanes, lanes)
    assert (plan.slots, plan.groups, plan.tile, plan.stages) == (1, beam,
                                                                 32, 1)
    assert plan.dmax == 512 and plan.column_blocks == -(-dim // 512)
    assert plan.smem_bytes == la.wide_smem_bytes(dim) <= H100_SMEM
    chunks = [range(s * plan.chunk, min(lanes, (s + 1) * plan.chunk))
              for s in range(plan.splits)]
    assert all(len(c) for c in chunks) and plan.chunk % plan.tile == 0
    assert [lane for c in chunks for lane in c] == list(range(lanes))
    blocks = batch * heads * beam * plan.column_blocks
    assert plan.splits == 1 or blocks < 2 * H100_SMS


# ---------------------------------------------------------------------- #
# K4
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 31, 300, 1280, 2400, 12001, 15360, 16384,
                               16385, 30720, 100000])
@pytest.mark.parametrize("k", [1, 10, 16, 17, 32, 33, 64])
def test_topk_plan_lays_out_every_row(n, k):
    """Lists of the smallest size that holds k; one warp a row up to the
    long-row threshold, 4 rows a block; past it 2-8 warps a row (one per
    warp span or so) and fewer rows a block, at most 8 warps a block;
    every row in a block; float4 loads where n is a multiple of 4."""
    if k > n:
        return
    plan = beam_select.topk_plan(64, n, k)
    assert plan.k_max == min(size for size in beam_select.TOPK_LIST_SIZES
                             if size >= k)
    if n <= beam_select.TOPK_WARP_SPAN:
        assert (plan.warps_per_row, plan.rows_per_block) == (
            1, beam_select.TOPK_ROWS_PER_BLOCK)
    else:
        assert 2 <= plan.warps_per_row <= 8
        span = beam_select.TOPK_WARP_SPAN
        assert plan.warps_per_row >= min(8, -(-n // span))
    assert plan.warps_per_row * plan.rows_per_block <= 8
    assert plan.blocks * plan.rows_per_block >= 64 > (
        plan.blocks - 1) * plan.rows_per_block
    assert plan.smem_bytes == 4 * plan.warps_per_row * plan.rows_per_block \
        * 2 * (64 + 256)
    assert plan.vec == (n % 4 == 0)
    assert not beam_select.topk_plan(64, n, k, aligned=False).vec


@pytest.mark.parametrize("n,warps,rows,blocks", [
    (2400, 4, 1, 64), (1280, 2, 2, 32), (1024, 1, 4, 16), (300, 1, 4, 16)])
def test_topk_plan_spreads_the_smoke_rows(n, warps, rows, blocks):
    """64 rows of 2400 (the group stage: a warp for each of its three
    chunks, rounded to 4) and of 1280 (the candidate stage: 2 warps);
    rows of one chunk: one warp a row, 4 rows a block."""
    plan = beam_select.topk_plan(64, n, 10)
    assert (plan.k_max, plan.warps_per_row, plan.rows_per_block,
            plan.blocks) == (16, warps, rows, blocks)


@pytest.mark.parametrize("batch,n,k", [(4, 100, 65), (4, 10, 11),
                                       (0, 10, 1)])
def test_topk_plan_refuses_what_the_kernel_does_not_take(batch, n, k):
    with pytest.raises(ValueError, match="small_topk"):
        beam_select.topk_plan(batch, n, k)


@pytest.mark.parametrize("batch,heads,beam,dim,lanes", [
    (64, 8, 10, 64, 480), (1, 8, 10, 64, 480), (2, 2, 70, 16, 420),
    (4, 2, 10, 512, 480), (2, 2, 10, 640, 120), (1, 1, 1, 32, 1)])
def test_lineage_bf16_plan_covers_every_lane_slot_and_column(batch, heads,
                                                             beam, dim, lanes):
    """The bf16 instance's context launch: slot tiles of 8 cover the
    beam, blocks of 256 context columns the head dim, and chunks of whole
    64-lane steps every lane once, none empty; the lanes split only where
    the (b, h, slot tile, column block) blocks would not fill 132 SMs
    twice."""
    plan = la.lineage_bf16_plan(batch, heads, beam, dim, lanes, 132)
    assert 8 * plan.slot_tiles >= beam > 8 * (plan.slot_tiles - 1)
    assert 256 * plan.column_blocks >= dim > 256 * (plan.column_blocks - 1)
    assert plan.chunk % 64 == 0
    assert (plan.splits - 1) * plan.chunk < lanes <= plan.splits * plan.chunk
    blocks = batch * heads * plan.slot_tiles * plan.column_blocks
    assert (plan.splits > 1) == (blocks < 2 * 132 and lanes > 64)
