"""The plans of three kernels, which the wrappers compute in Python and the
CUDA kernels check and follow: ``lstm_fwd``'s route (a thread-block
cluster per row tile or a cooperative grid), units, rows, depth chunks and
shared memory; ``lstm_bwd``'s grid (hidden units and batch rows a block
owns, the thread groups of its per-tick product, its shared memory) and
the depth slices of its dWh product; and the bf16 ``fused_c3_bwd_w``'s
pixel slices and scratch. They run on the card only
(tests/test_torch_cuda.py, chip_smoke.py); here each plan is held to what
the kernels rely on."""

import inspect

import pytest

from deeplearning4j_tpu_torch.ops import fused_conv as fc
from deeplearning4j_tpu_torch.ops import fused_lstm as fl

H100_SMS = 132
# (T, N, H): the slice shape, the kernels phase's benchmark geometry, the
# on-card tests' edge shapes, a narrow model, and shapes that stress the
# unit and row rules
LSTM_SHAPES = [(60, 128, 256), (128, 256, 512), (1, 5, 20), (4, 129, 256),
               (3, 50, 200), (6, 7, 10), (7, 4, 8), (9, 300, 48),
               (9, 6, 32), (1, 1, 1), (2, 1000, 64), (5, 3, 1024),
               (3, 2, 1000)]


def test_lstm_plan_is_a_function_of_the_shapes_and_the_sm_count():
    assert list(inspect.signature(fl.lstm_bwd_plan).parameters) == [
        "t_len", "n", "h", "bf16", "sms"]
    assert fl.lstm_bwd_plan(60, 128, 256, False, H100_SMS) == \
        fl.LstmBwdPlan(units=32, slices=8, rows=8, row_tiles=16, groups=4,
                       dw_chunk=960, dw_splits=8, smem=186432,
                       xbuf=524288, ws=8 * 256 * 1024)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("t,n,h", LSTM_SHAPES)
def test_lstm_plan_covers_units_rows_and_depth(t, n, h, bf16):
    p = fl.lstm_bwd_plan(t, n, h, bf16, H100_SMS)
    # units: a power of two of at least 4; the slices cover H, none empty
    assert p.units >= 4 and p.units & (p.units - 1) == 0
    assert (p.slices - 1) * p.units < h <= p.slices * p.units
    # rows: the row tiles cover N, none empty
    assert (p.row_tiles - 1) * p.rows < n <= p.row_tiles * p.rows
    # one resident block a SM at most, in the shared memory a block has
    assert p.slices * p.row_tiles <= H100_SMS
    assert p.smem == fl.lstm_bwd_smem(p.units, p.rows, h, p.groups,
                                      2 if bf16 else 4)
    assert p.smem <= fl.LSTM_SMEM_BUDGET <= 232448
    # product groups: a power of two that divides the depth 4U, each part
    # at least 4 deep, the tiles of all groups no more than the threads
    g = p.groups
    assert g & (g - 1) == 0 and (4 * p.units) % g == 0
    assert 4 * p.units // g >= 4
    tiles = -(-p.rows // 8) * -(-h // 4)
    assert g == 1 or g * tiles <= 256      # the block's threads
    # dWh slices: whole 32-row steps covering T·N, none empty
    assert p.dw_chunk % 32 == 0
    assert (p.dw_splits - 1) * p.dw_chunk < t * n <= p.dw_splits * p.dw_chunk
    # scratch: the two exchange slots, then the planes when sliced
    assert p.xbuf == 2 * p.slices * n * (-(-h // 4) * 4)
    assert p.ws == (p.dw_splits * h * 4 * h if p.dw_splits > 1 else 0)


def test_lstm_plan_prefers_few_slices():
    """The widest block that fits wins: fewer slices mean fewer dh
    partial planes crossing L2 each tick."""
    wide = fl.lstm_bwd_plan(60, 128, 256, False, H100_SMS)
    assert fl.lstm_bwd_smem(2 * wide.units, wide.rows, 256, wide.groups,
                            4) > fl.LSTM_SMEM_BUDGET
    big = fl.lstm_bwd_plan(128, 256, 512, False, H100_SMS)
    assert (big.units, big.slices, big.rows, big.groups) == (16, 32, 64, 1)


def test_lstm_plan_refuses_what_no_block_can_hold():
    with pytest.raises(ValueError, match="no block fits"):
        fl.lstm_bwd_plan(2, 4, 20000, False, H100_SMS)
    with pytest.raises(ValueError, match="bad shape"):
        fl.lstm_bwd_plan(0, 4, 8, False, H100_SMS)


# (T, N, H) of lstm_fwd: the slice shape, the kernels phase's benchmark
# geometry, one generated char, the on-card tests' edge shapes, and shapes
# that stress the unit, row and chunk rules
LSTM_FWD_SHAPES = [(60, 128, 256), (128, 256, 512), (1, 1, 256),
                   (4, 129, 256), (3, 50, 200), (6, 7, 10), (3, 600, 520),
                   (7, 4, 8), (1, 5, 20), (5, 8, 32), (5, 15, 64),
                   (3, 2, 1000), (9, 300, 48), (2, 1000, 64), (5, 3, 1024),
                   (1, 1, 1)]


def test_lstm_fwd_plan_is_a_function_of_the_shapes_and_the_sm_count():
    assert list(inspect.signature(fl.lstm_fwd_plan).parameters) == [
        "t_len", "n", "h", "bf16", "sms"]
    # the slice shape in bf16: 7 clusters of 16 blocks, 19 rows each
    assert fl.lstm_fwd_plan(60, 128, 256, True, H100_SMS) == fl.LstmFwdPlan(
        route="cluster", slices=16, units=16, rows=19, row_tiles=7,
        depth=256, chunk=256, stages=1, groups=1, smem=62240, xbuf=0)
    # and in f32: the grid of 8 x 16 blocks of 8 rows, 8 depth ranges
    assert fl.lstm_fwd_plan(60, 128, 256, False, H100_SMS) == fl.LstmFwdPlan(
        route="grid", slices=8, units=32, rows=8, row_tiles=16, depth=256,
        chunk=256, stages=2, groups=8, smem=fl.lstm_fwd_smem(
            "grid", 32, 8, 256, 256, 2, 8, 4), xbuf=2 * 128 * 256)
    assert fl.lstm_fwd_plan(60, 128, 256, False, H100_SMS) is \
        fl.lstm_fwd_plan(60, 128, 256, False, H100_SMS)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("t,n,h,sms",
                         [s + (H100_SMS,) for s in LSTM_FWD_SHAPES]
                         + [(60, 128, 256, 114), (128, 256, 512, 114),
                            (1, 1, 256, 114)])
def test_lstm_fwd_plan_covers_units_rows_and_depth(t, n, h, sms, bf16):
    p = fl.lstm_fwd_plan(t, n, h, bf16, sms)
    isz = 2 if bf16 else 4
    # units: a power of two of at least 8; the slices cover H, none empty
    assert p.units >= 8 and p.units & (p.units - 1) == 0
    assert (p.slices - 1) * p.units < h <= p.slices * p.units
    # rows: the row tiles cover N, none empty
    assert (p.row_tiles - 1) * p.rows < n <= p.row_tiles * p.rows
    # depth: slices x units rounded up to whole 32-deep steps
    assert p.depth == -(-p.slices * p.units // 32) * 32
    # every block fits the shared memory a block may opt into
    assert p.smem == fl.lstm_fwd_smem(p.route, p.units, p.rows, p.depth,
                                      p.chunk, p.stages, p.groups, isz)
    # depth groups: a power of two, bf16 one; every group's thread items
    # find a thread and keep at least 16 of the depth
    g = p.groups
    assert g & (g - 1) == 0 and (g == 1 or not bf16)
    assert g == 1 or (g * p.units * -(-p.rows // 8) <= 256
                      and p.depth // g >= 16)
    assert p.smem <= fl.LSTM_SMEM_BUDGET <= 232448
    if p.route == "cluster":
        # one cluster holds a row tile, all clusters resident at once
        assert p.slices <= fl.FWD_MAX_CLUSTER
        assert p.row_tiles <= fl._cluster_limit(p.slices, sms)
        assert (p.chunk, p.stages, p.xbuf) == (p.depth, 1, 0)
    else:
        # one resident block an SM (a cooperative launch); whole product
        # steps a chunk, the chunks covering the depth; the exchange
        assert p.slices * p.row_tiles <= sms
        assert p.chunk % (32 if bf16 else 16 * g) == 0
        assert 2 <= p.stages <= 4
        assert p.chunk <= p.depth < p.chunk * (-(-p.depth // p.chunk) + 1)
        assert p.xbuf == 2 * n * p.slices * p.units


def test_lstm_fwd_plan_routes_the_kernels_phase_shapes():
    """f32 at H 512 (4 MiB of Wh) fits no cluster: the grid route. bf16
    takes the cluster route wherever one fits, at the slice shape and at
    H 512. f32 at the slice shape takes the grid route: there the grid
    gives every SM a block of 8 rows (8 x 32 units), where the 15 clusters
    of 8 (or 7 of 16) the card keeps resident leave 19 rows padded to 24
    a block, and f32's product dominates its tick (0.390 against 0.545 ms
    a call on an H100, tools/port_probe.py plans)."""
    route = lambda *s: fl.lstm_fwd_plan(*s, H100_SMS).route
    assert route(128, 256, 512, False) == "grid"
    assert route(128, 256, 512, True) == "cluster"
    assert route(60, 128, 256, True) == "cluster"
    assert route(60, 128, 256, False) == "grid"
    # a cluster is preferred where its product a block is no larger
    assert route(3, 50, 200, False) == "cluster"


def test_lstm_fwd_cluster_limits_match_the_measured_occupancy():
    """cudaOccupancyMaxActiveClusters for one block an SM on an H100 80GB
    HBM3 (chip_smoke.py's kernels phase prints it beside each plan)."""
    measured = {1: 132, 2: 66, 4: 30, 7: 15, 8: 15, 13: 7, 16: 7}
    assert {c: fl._cluster_limit(c, H100_SMS) for c in measured} == measured
    assert fl._cluster_limit(17, H100_SMS) == 0


def test_lstm_fwd_plan_refuses_what_no_block_can_hold():
    with pytest.raises(ValueError, match="no block fits"):
        fl.lstm_fwd_plan(2, 4, 20000, False, H100_SMS)
    with pytest.raises(ValueError, match="bad shape"):
        fl.lstm_fwd_plan(0, 4, 8, False, H100_SMS)


# the 3×3 calls of the ResNet50 path at batch 32 and 128 as (M, Cin, Cout),
# and shapes no tile or step divides
C3_SHAPES = [(32 * 256, 64, 64), (32 * 64, 128, 128), (32 * 16, 256, 256),
             (32 * 4, 512, 512), (128 * 256, 64, 64), (128 * 64, 128, 128),
             (128 * 16, 256, 256), (128 * 4, 512, 512), (48, 5, 16),
             (90, 24, 13), (1, 8, 8)]


def test_c3_bwd_w_plan_is_a_function_of_the_shapes_alone():
    assert list(inspect.signature(fc.c3_bwd_w_plan).parameters) == [
        "m", "cin", "cout"]
    # stage 4 on the main path: one pixel slice at both batches
    assert fc.c3_bwd_w_plan(128, 512, 512).dw_slices == 1
    assert fc.c3_bwd_w_plan(512, 512, 512).dw_slices == 1


@pytest.mark.parametrize("m,cin,cout", C3_SHAPES)
def test_c3_bwd_w_plan_cuts_and_lays_out_one_call(m, cin, cout):
    p = fc.c3_bwd_w_plan(m, cin, cout)
    # whole DX_STEP slices covering the M pixels, none empty
    assert p.dw_chunk % fc.DX_STEP == 0
    assert (p.dw_slices - 1) * p.dw_chunk < m <= p.dw_slices * p.dw_chunk
    # dW first, then the planes, then the bf16 dyc; 16-byte aligned, apart
    assert p.dw_ws == -(-9 * cin * cout // 4) * 4
    planes = p.dw_slices * 9 * cin * cout if p.dw_slices > 1 else 0
    assert p.dyc >= p.dw_ws + planes
    assert p.size >= p.dyc + -(-m * cout // 2)
    assert all(o % 4 == 0 for o in (p.dw_ws, p.dyc, p.size))
