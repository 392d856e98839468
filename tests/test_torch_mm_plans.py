"""The plans of the bf16 1×1 conv kernels (``fused_mm`` and
``fused_mm_bwd``), which the wrappers compute in Python and the CUDA
kernels check and follow: how the forward cuts its depth Cin into K slices
added in one thread-block cluster, and how the backward cuts its dx depth
(Cout, also a cluster) and its dW depth (the pixels) and lays out its f32
scratch. They run on the card only (tests/test_torch_cuda.py,
chip_smoke.py); here each plan is held to what the kernels rely on."""

import inspect

import pytest

from deeplearning4j_tpu_torch.ops import fused_conv as fc

# the ResNet50 path's 1×1 calls at batch 32 as (M, Cin, Cout, normalize):
# M = N·Ho·Wo rows of dy (chip_smoke.path_calls on the 64×64 model)
MM_PATH = [(8192, 64, 64, False), (8192, 64, 256, True),
           (8192, 64, 256, False), (8192, 256, 64, False),
           (2048, 256, 128, False), (2048, 128, 512, True),
           (2048, 256, 512, False), (2048, 512, 128, False),
           (512, 512, 256, False), (512, 256, 1024, True),
           (512, 512, 1024, False), (512, 1024, 256, False),
           (128, 1024, 512, False), (128, 512, 2048, True),
           (128, 1024, 2048, False), (128, 2048, 512, False)]
# and at the train batch 128: four times the rows
MM_TRAIN = [(4 * m, cin, cout, norm) for m, cin, cout, norm in MM_PATH]
ODD = [(1, 16, 8, True), (70, 24, 40, True), (243, 64, 130, False),
       (18, 1100, 70, True), (9, 5, 13, False)]


def test_forward_slices_are_a_function_of_k_alone():
    """The slice count takes K and nothing else, so a row's bits cannot
    depend on M (a padded serving batch answers bitwise)."""
    assert list(inspect.signature(fc.mm_slices).parameters) == ["k"]
    assert [fc.mm_slices(k) for k in (2048, 1024, 512, 256, 128, 64)] == [
        (8, 256), (4, 256), (2, 256), (1, 256), (1, 128), (1, 64)]


@pytest.mark.parametrize("k", [1, 8, 16, 24, 64, 100, 256, 257, 1100, 2048,
                               2049, 5000, 100000])
def test_forward_slices_cover_k_in_one_cluster(k):
    slices, depth = fc.mm_slices(k)
    assert 1 <= slices <= fc.MAX_CLUSTER == 8     # a portable cluster
    assert depth % fc.DX_STEP == 0 and fc.DX_STEP % 16 == 0   # k16 MMAs
    assert (slices - 1) * depth < k <= slices * depth          # none empty


@pytest.mark.parametrize("m,cin,cout,norm", MM_PATH + MM_TRAIN + ODD)
def test_backward_plan_cuts_and_lays_out_one_call(m, cin, cout, norm):
    plan = fc.mm_bwd_plan(m, cin, cout, norm)
    assert plan == fc.mm_bwd_plan(m, cin, cout, norm)
    # the dx depth: dx_slices' rule, at most one cluster, none empty
    assert (plan.slices, plan.depth) == fc.dx_slices(m, cin, cout,
                                                     fc.MAX_CLUSTER)
    assert 1 <= plan.slices <= fc.MAX_CLUSTER
    assert plan.depth % fc.DX_STEP == 0
    assert (plan.slices - 1) * plan.depth < cout <= plan.slices * plan.depth
    # dW slices: whole 32-pixel steps that cover M, none empty
    assert plan.dw_chunk % fc.DX_STEP == 0
    assert plan.dw_chunk >= fc.dw_chunk(cin, cout, m)
    assert (plan.dw_slices - 1) * plan.dw_chunk < m <= \
        plan.dw_slices * plan.dw_chunk
    # one (Σdpre·x, Σdpre) row per 64-row dx tile, none without the norm
    assert plan.row_tiles == (-(-m // 64) if norm else 0)
    # disjoint, ordered, 16-byte aligned segments of one f32 buffer
    dw_planes = plan.dw_slices * cin * cout if plan.dw_slices > 1 else 0
    starts = [0, plan.dw_ws, plan.partial, plan.sums, plan.dyc]
    ends = [cin * cout, plan.dw_ws + dw_planes,
            plan.partial + plan.row_tiles * 2 * cin, plan.sums + 2 * cin,
            plan.dyc + -(-m * cout // 2)]
    assert all(a % 4 == 0 for a in starts)
    assert all(e <= b for e, b in zip(ends, starts[1:]))
    assert ends[-1] <= plan.size < ends[-1] + 4


@pytest.mark.parametrize("m,cin,cout,norm", MM_PATH + MM_TRAIN)
def test_backward_plan_fills_the_card_at_the_path_shapes(m, cin, cout, norm):
    """Both products share one grid: it has about one block per SM of an
    H100 (132) or more at every path shape (the fewest, 128, at M 512,
    Cin 512, Cout 256, where no slice may be shallower than 256), and the
    dx tiles of the deep, short layers are split (M = 128: 2 row tiles)."""
    plan = fc.mm_bwd_plan(m, cin, cout, norm)
    dx = -(-m // 64) * -(-cin // 64) * plan.slices
    dw = -(-cin // 64) * -(-cout // 64) * plan.dw_slices
    assert dx + dw >= 128
    if m == 128 and cout >= 512:
        assert plan.slices >= 2
