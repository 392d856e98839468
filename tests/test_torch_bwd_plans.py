"""The plans of two backward kernels, which the wrappers compute in Python
and the CUDA kernels check and follow: ``lstm_bwd``'s grid (hidden units
and batch rows a block owns, the thread groups of its per-tick product,
its shared memory) and the depth slices of its dWh product, and the bf16
``fused_c3_bwd_w``'s pixel slices and scratch. They run on the card only
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
