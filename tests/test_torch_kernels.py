"""The port's CUDA kernels (K1, the window-attention forward; K2, its
backward; K3, the fused run of Swin blocks; K4, the per-head window
attention) against their plain PyTorch versions, on a CUDA device, with
the route (tensor cores or CUDA cores) each takes and the batch split of
K1, K2 and K4.  Every test here is marked `cuda` and skips on a host
without one.

This file imports neither JAX nor `fiber_tpu`, so it also runs where only
PyTorch is installed (the repo's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.models import swin
from fiber_torch.models.swin import SwinBlock
from fiber_torch.ops import swin_stage as tss
from fiber_torch.ops import window_attention as twa

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, nW, N, h, hd, seed, device, dtype):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=g)
    bias = torch.randn(1, h, N, N, generator=g) * 0.1
    bias = bias + torch.where(torch.rand(nW, 1, N, N, generator=g) < 0.3,
                              -100.0, 0.0)
    return qkv.to(device, dtype), bias.to(device)


TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


SHAPES = [(2, 64, 144, 4, 32), (2, 1, 144, 32, 32),  # FIBER-Base stages 1, 4
          (16, 4, 144, 16, 32), (24, 4, 144, 16, 32),  # stage 3: the report
          (1, 4, 144, 16, 32), (5, 4, 144, 16, 32),    # shape, the train
          (3, 3, 49, 4, 64), (2, 2, 16, 2, 8),         # step's B = 24, splits
          (2, 2, 4, 1, 16)]                            # that leave a remainder
# FIBER-Base 576^2 (18 x 18 windows, N = 324): stages 1, 3 and 4, on the
# long-window tensor-core route in bf16 and the CUDA cores' 11-chunk
# instance in fp32
LONG_SHAPES = [(2, 64, 324, 4, 32), (4, 4, 324, 16, 32), (1, 1, 324, 32, 32),
               (3, 2, 150, 2, 8), (2, 2, 352, 1, 64)]
# fp32 K and V at N=256, hd=128 exceed a block's shared memory (the wrapper
# raises, see test_window_attention_kernel_rejects); bf16 fits, on the CUDA
# cores, as bf16 at hd = 128 does; bf16 beyond the tensor-core tiles (N =
# 160) takes the long-window route
CASES = ([(torch.float32, s) for s in SHAPES + LONG_SHAPES]
         + [(torch.bfloat16, s) for s in SHAPES + [(1, 2, 256, 2, 128),
                                                  (2, 2, 160, 2, 32)]
            + LONG_SHAPES])


def _case_ids(cases):
    """route-dtype-shape, e.g. tc-bfloat16-16x4x144x16x32 (`-k tc-bfloat16`
    picks the tensor-core cases)."""
    return [f"{twa._fwd_route(d, s[2], s[4])}-{str(d)[6:]}-"
            f"{'x'.join(map(str, s))}" for d, s in cases]


def _launch_counts(op):
    return op.launches, dict(op.route_launches)


def _assert_one_launch(op, before, route, splits):
    launches, routes = before
    assert op.launches == launches + 1
    assert {k: op.route_launches[k] - routes[k] for k in routes} == {
        k: int(k == route) for k in routes}
    assert op.last_splits == splits


def _fwd_splits(route, name, B, nW, N, h, hd, device):
    """The batch splits the forward's wrapper gives this shape on this
    card: `_bwd_splits` on the tensor-core kernel's occupancy, `_long_plan`'s
    on the long-window route; B (one block per batch element) on the CUDA
    cores."""
    if route == "cuda_core":
        return B
    if route == "tc_long":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return twa._long_plan(B, nW, h, N, hd, sms)[2]
    sms, per_sm = twa._split_plan(name, torch.bfloat16, N, hd,
                                  device.index or 0)
    return twa._bwd_splits(B, nW, h, sms, per_sm)


@pytest.mark.parametrize("dtype,shape", CASES, ids=_case_ids(CASES))
def test_window_attention_kernel_matches_plain(cuda, dtype, shape):
    B, nW, N, h, hd = shape
    qkv, bias = _inputs(B, nW, N, h, hd, N + hd, cuda, dtype)
    route = twa._fwd_route(dtype, N, hd)
    bf16_tc = dtype == torch.bfloat16 and hd <= 64
    assert route == ("tc" if bf16_tc and N <= 144 else "tc_long"
                     if bf16_tc and N <= 352 else "cuda_core")
    before = _launch_counts(twa.window_attention)
    with torch.inference_mode():
        out = twa.window_attention(qkv, bias, h)
        ref = twa.window_attention_reference(qkv, bias, h)
    torch.cuda.synchronize()
    _assert_one_launch(twa.window_attention, before, route, _fwd_splits(
        route, "window_attention_tc", B, nW, N, h, hd, cuda))
    assert out.dtype == dtype and out.shape == (B, nW, N, h * hd)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_window_attention_kernel_broadcast_bias(cuda):
    qkv, bias = _inputs(2, 4, 144, 4, 32, 0, cuda, torch.bfloat16)
    one = bias[:1].contiguous()
    before = _launch_counts(twa.window_attention)
    with torch.inference_mode():
        a = twa.window_attention(qkv, one.expand(4, 4, 144, 144), 4)
        b = twa.window_attention(qkv, one.expand(4, 4, 144, 144).contiguous(), 4)
    assert twa.window_attention.route_launches["tc"] == before[1]["tc"] + 2
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_kernel_is_deterministic(cuda, dtype):
    """Two calls give the same bits: every output element is written by
    one thread, without atomics (S = 2 at this shape on an H100)."""
    qkv, bias = _inputs(16, 4, 144, 16, 32, 7, cuda, dtype)
    with torch.inference_mode():
        a = twa.window_attention(qkv, bias, 16)
        b = twa.window_attention(qkv, bias, 16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_kernel_long_windows(cuda, dtype, shifted):
    """K1 at FIBER-Base 576^2 stage 1 (N = 324, 64 windows, B = 2), with
    the shift mask or with a broadcast (stride-0) bias: the long-window
    tensor-core route in bf16 (its rows a block, warps a slab and splits
    from `_long_plan`), the CUDA cores in fp32; two calls give the same
    bits."""
    B, nW, N, h, hd = 2, 64, 324, 4, 32
    qkv, bias = _inputs(B, nW, N, h, hd, 11, cuda, dtype)
    if not shifted:
        bias = bias[:1].contiguous().expand(nW, h, N, N)
    route = "tc_long" if dtype == torch.bfloat16 else "cuda_core"
    before = _launch_counts(twa.window_attention)
    with torch.inference_mode():
        out = twa.window_attention(qkv, bias, h)
        again = twa.window_attention(qkv, bias, h)
        ref = twa.window_attention_reference(qkv, bias, h)
    torch.cuda.synchronize()
    assert twa.window_attention.launches == before[0] + 2
    assert twa.window_attention.route_launches[route] == before[1][route] + 2
    if route == "tc_long":
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        R, parts, S, _ = twa._long_plan(B, nW, h, N, hd, sms)
        assert (twa.window_attention.last_rows,
                twa.window_attention.last_parts,
                twa.window_attention.last_splits) == (R, parts, S)
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_window_attention_long_kernel_smem_is_the_plans(cuda):
    """The C libraries' shared-memory sizes are the plans' formulas, and
    each plan's block fits an SM as the plan counts: K1's long-window
    kernel (rows and parts), K2's bf16 row and column kernels, K2's fp32
    long-window kernels."""
    k1 = twa._long_lib("window_attention_tc_long")
    k4 = twa._long_lib("window_attention_heads_tc_long")
    k2 = twa._long_lib("window_attention_bwd_tc_long")
    fp32 = twa._split_lib("window_attention_bwd")
    for N, hd in ((324, 32), (352, 64), (150, 8)):
        for R in range(16, 129, 16):
            for parts in (1, 2, 3):
                if R // 16 * parts <= twa._LONG_SM_WARPS:
                    assert k1.fiber_window_attention_tc_long_smem_bytes(
                        N, hd, R, parts) == twa._fwd_long_smem_bytes(
                            N, hd, R, parts)
                    assert k4.fiber_window_attention_heads_tc_long_smem_bytes(
                        N, hd, R, parts) == twa._fwd_long_smem_bytes(
                            N, hd, R, parts)
        for stages in (0, 2, 3, 4):
            for parts in (1, 2):
                assert k2.fiber_window_attention_bwd_tc_long_smem_bytes(
                    N, hd, parts, stages, 0) == \
                    twa._bwd_rows_smem_bytes(N, hd, parts, stages)
            if not stages:
                continue
            for Rc in (64, 128):
                assert k2.fiber_window_attention_bwd_tc_long_smem_bytes(
                    N, hd, Rc, stages, 1) == \
                    twa._bwd_cols_smem_bytes(N, hd, Rc, stages)
        R, parts, _, per_sm = twa._long_plan(4, 4, 16, N, hd, 132)
        assert k1.fiber_window_attention_tc_long_blocks_per_sm(
            N, hd, R, parts) >= per_sm
        assert k4.fiber_window_attention_heads_tc_long_blocks_per_sm(
            N, hd, R, parts) >= per_sm
        _, parts, stages, _, Rc, _, col_stages = twa._bwd_long_plan(
            4, 4, 16, N, hd, 132)
        assert k2.fiber_window_attention_bwd_tc_long_blocks_per_sm(
            N, hd, parts, stages, 0) >= 1
        # the plan's count of column blocks an SM (registers included)
        assert k2.fiber_window_attention_bwd_tc_long_blocks_per_sm(
            N, hd, Rc, col_stages, 1) >= min(twa._resident(
                twa._bwd_cols_smem_bytes(N, hd, Rc, col_stages),
                Rc // 16 + 1), 128 // Rc)
        assert fp32.fiber_window_attention_bwd_long_smem_bytes(N, hd) == \
            twa._bwd_long_smem_bytes(N, hd)
        assert fp32.fiber_window_attention_bwd_long_blocks_per_sm(N, hd) >= 1
    bwd = twa._split_lib("window_attention_bwd_tc")
    for N, hd in ((144, 32), (144, 64), (16, 128), (49, 64)):
        assert bwd.fiber_window_attention_bwd_tc_smem_bytes(N, hd) == \
            twa._bwd_tc_smem_bytes(N, hd)
        assert fp32.fiber_window_attention_bwd_smem_bytes(N, hd) == \
            twa._bwd_smem_bytes(N, hd)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "noncontig",
                                  "bias_dtype", "too_large",
                                  "misaligned_bf16", "misaligned_bias_bf16",
                                  "misaligned_long_bf16", "too_long"])
def test_window_attention_kernel_rejects(cuda, case):
    qkv, bias = _inputs(1, 2, 16, 2, 32, 1, cuda, torch.float32)
    h, err = 2, ValueError
    if case == "head_dim":                    # hd = 24 is not built
        qkv, bias = _inputs(1, 2, 16, 2, 24, 1, cuda, torch.float32)
    elif case == "dtype":
        qkv, err = qkv.half(), TypeError
    elif case == "noncontig":
        qkv = qkv.transpose(1, 2)
    elif case == "bias_dtype":
        bias, err = bias.double(), TypeError
    elif case == "too_large":
        qkv, bias = _inputs(1, 1, 256, 1, 128, 2, cuda, torch.float32)
        h = 1
    elif case == "misaligned_bf16":           # the tc route copies 16 bytes
        qkv = torch.empty(qkv.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view_as(qkv).copy_(qkv)
    elif case == "misaligned_bias_bf16":
        qkv = qkv.bfloat16()
        bias = torch.empty(bias.numel() + 1, device=cuda)[1:].view_as(
            bias).copy_(bias)
    elif case == "misaligned_long_bf16":      # so does the tc_long route
        qkv, bias = _inputs(1, 2, 324, 2, 32, 1, cuda, torch.bfloat16)
        qkv = torch.empty(qkv.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view_as(qkv).copy_(qkv)
    elif case == "too_long":                  # K1 takes N <= 352
        qkv, bias = _inputs(1, 1, 361, 1, 32, 1, cuda, torch.bfloat16)
        h = 1
    before = twa.window_attention.launches
    with pytest.raises(err):
        twa.window_attention(qkv, bias, h)
    assert twa.window_attention.launches == before


# K2: FIBER-Base 384^2 stage shapes (N = 144, hd = 32) at B = 2, the
# report shape (stage 3, split in 2 on an H100) and stage 1 at the train
# step's B = 24, B = 1 and B = 5 (the split does not divide the batch),
# then small ones
BWD_SHAPES = [(2, 64, 144, 4, 32), (2, 16, 144, 8, 32), (2, 4, 144, 16, 32),
              (3, 1, 144, 32, 32), (24, 4, 144, 16, 32), (24, 64, 144, 4, 32),
              (1, 4, 144, 16, 32), (5, 4, 144, 16, 32), (5, 3, 49, 4, 64),
              (3, 3, 49, 4, 64), (2, 2, 16, 2, 8), (2, 2, 4, 1, 16),
              (1, 2, 16, 2, 128)]
# K2 at the long windows: FIBER-Base 576^2 stages 1 and 3 (N = 324), the
# train step's B = 8 at stage 3, a window past the whole tiles (N = 150),
# the cap (N = 352, hd = 64), and bf16 hd = 64 at N = 144 (the whole-tile
# kernel's tiles do not fit; fp32 takes its long-window kernels there too)
BWD_LONG_SHAPES = [(2, 64, 324, 4, 32), (8, 4, 324, 16, 32),
                   (3, 2, 150, 2, 8), (2, 2, 352, 1, 64), (2, 1, 144, 2, 64)]
BWD_CASES = [(d, s) for d in (torch.float32, torch.bfloat16)
             for s in BWD_SHAPES + BWD_LONG_SHAPES]
BWD_ROUTES = {torch.float32: "cuda_core", torch.bfloat16: "tc"}


def _bwd_inputs(shape, dtype, device, seed):
    B, nW, N, h, hd = shape
    qkv, bias = _inputs(B, nW, N, h, hd, seed, device, dtype)
    g = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn(B, nW, N, h * hd, generator=g).to(device, dtype)
    return qkv, bias, dout


def _assert_bwd_close(got, ref, dtype):
    (dqkv, dbias), (rq, rb) = got, ref
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    torch.testing.assert_close(dqkv.float(), rq.float(), **TOL[dtype])
    # dbias is fp32 in both; only the order of the batch and row sums differs
    torch.testing.assert_close(dbias, rb, **TOL[dtype])


def _expected_plan(shape, dtype, device):
    """The route `_bwd_route` gives this shape and the plan its wrapper
    takes on this card: (S,) from `_bwd_splits` on the whole-tile kernels'
    occupancy, `_bwd_long_plan`'s (R, parts, stages, S, Rc, S', stages')
    or the fp32 long-window kernels' (S, S)."""
    B, nW, N, h, hd = shape
    route = twa._bwd_route(dtype, N, hd)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if route == "tc_long":
        return route, twa._bwd_long_plan(B, nW, h, N, hd, sms)
    if route == "cuda_core_long":
        S = twa._bwd_fp32_long_plan(B, nW, h, N, hd, sms)
        return route, (S, S)
    sms, per_sm = twa._split_plan(twa._BWD_LIBS[route], dtype, N, hd,
                                  device.index or 0)
    return route, (twa._bwd_splits(B, nW, h, sms, per_sm),)


def _ulp_close(got, ref):
    """Within one bf16 ulp of each row's largest magnitude (the rows of
    dq, dk and dv: each third of a dqkv row)."""
    C = ref.shape[-1] // 3
    for i in range(3):
        r = ref[..., i * C:(i + 1) * C].float()
        g = got[..., i * C:(i + 1) * C].float()
        ulp = 2.0 ** (torch.floor(torch.log2(
            r.abs().amax(-1, keepdim=True).clamp_min(1e-30))) - 7)
        assert bool(((g - r).abs() <= ulp).all()), i


def _bwd_case_ids(cases):
    """route-dtype-shape, e.g. tc_long-bfloat16-2x64x324x4x32 (`-k
    tc_long` picks the long-window cases)."""
    return [f"{twa._bwd_route(d, s[2], s[4])}-{str(d)[6:]}-"
            f"{'x'.join(map(str, s))}" for d, s in cases]


@pytest.mark.parametrize("dtype,shape", BWD_CASES, ids=_bwd_case_ids(BWD_CASES))
def test_window_attention_bwd_kernel_matches_plain(cuda, dtype, shape):
    qkv, bias, dout = _bwd_inputs(shape, dtype, cuda, sum(shape))
    route, plan = _expected_plan(shape, dtype, cuda)
    before = _launch_counts(twa.window_attention_bwd)
    got = twa.window_attention_bwd(qkv, bias, dout, shape[3])
    again = twa.window_attention_bwd(qkv, bias, dout, shape[3])
    ref = twa.window_attention_bwd_reference(qkv, bias, dout, shape[3])
    torch.cuda.synchronize()
    assert twa.window_attention_bwd.launches == before[0] + 2
    assert twa.window_attention_bwd.route_launches[route] == before[1][route] + 2
    assert twa.window_attention_bwd.last_plan == plan
    assert twa.window_attention_bwd.last_splits == plan[3 if route == "tc_long"
                                                        else 0]
    _assert_bwd_close(got, ref, dtype)
    if route.endswith("long"):
        # two calls give the same bits; bf16 within one ulp, fp32 1e-5
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        if dtype == torch.bfloat16:
            _ulp_close(got[0], ref[0])
        else:
            torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
        torch.testing.assert_close(got[1], ref[1], rtol=0,
                                   atol=1e-5 * ref[1].abs().max().item())


def test_window_attention_bwd_long_broadcast_bias(cuda):
    """The bf16 long-window K2 at 576^2 stage 2 (N = 324, 16 windows) with
    a broadcast (stride-0) bias: the bits of the same bias laid out per
    window, dq / dk / dv within one bf16 ulp of the plain version and
    dbias within 1e-5 of its max-abs."""
    qkv, bias, dout = _bwd_inputs((4, 16, 324, 8, 32), torch.bfloat16, cuda,
                                  12)
    one = bias[:1].contiguous().expand(16, 8, 324, 324)
    a = twa.window_attention_bwd(qkv, one, dout, 8)
    b = twa.window_attention_bwd(qkv, one.contiguous(), dout, 8)
    ref = twa.window_attention_bwd_reference(qkv, one, dout, 8)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _ulp_close(a[0], ref[0])
    torch.testing.assert_close(a[1], ref[1], rtol=0,
                               atol=1e-5 * ref[1].abs().max().item())


def test_window_attention_bwd_long_kernels_apart(cuda):
    """The bf16 long-window K2's row kernel, then its column kernel, each
    launched alone (`window_attention_bwd_tc_long_kernels`, for timing),
    give the bits of the two launched together and of the op."""
    qkv, bias, dout = _bwd_inputs((2, 4, 324, 4, 32), torch.bfloat16, cuda, 13)
    launch, plan = twa.window_attention_bwd_tc_long_kernels(qkv, bias, dout, 4)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan == twa._bwd_long_plan(2, 4, 4, 324, 32, sms)
    both = [t.clone() for t in launch(twa._BWD_ROW_KERNEL
                                      | twa._BWD_COL_KERNEL)]
    launch(twa._BWD_ROW_KERNEL)
    apart = launch(twa._BWD_COL_KERNEL)
    op = twa.window_attention_bwd(qkv, bias, dout, 4)
    torch.cuda.synchronize()
    for x, y, z in zip(both, apart, op):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_bwd_kernel_is_deterministic(cuda, dtype):
    """Two calls give the same bits: the split's dbias partials are summed
    in a fixed order, without atomics (S > 1 at this shape on an H100)."""
    shape = (24, 4, 144, 16, 32)
    qkv, bias, dout = _bwd_inputs(shape, dtype, cuda, 9)
    a = twa.window_attention_bwd(qkv, bias, dout, shape[3])
    b = twa.window_attention_bwd(qkv, bias, dout, shape[3])
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_bwd_route_by_dtype(cuda, dtype):
    """bf16 launches the tensor-core kernel, fp32 the CUDA-core one."""
    qkv, bias, dout = _bwd_inputs((2, 4, 144, 16, 32), dtype, cuda, 6)
    route = BWD_ROUTES[dtype]
    before = dict(twa.window_attention_bwd.route_launches)
    twa.window_attention_bwd(qkv, bias, dout, 16)
    torch.cuda.synchronize()
    after = twa.window_attention_bwd.route_launches
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    assert twa._bwd_route(dtype, 144, 32) == route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_autograd_runs_k1_and_k2(cuda, dtype):
    """Grad enabled on the card: K1 forward, K2 backward, through one
    autograd Function; a broadcast bias's gradient reaches its (1, h, N, N)
    source summed over the windows."""
    B, nW, N, h, hd = 2, 4, 144, 4, 32
    qkv, bias, dout = _bwd_inputs((B, nW, N, h, hd), dtype, cuda, 5)
    src = bias[:1].detach().clone().requires_grad_(True)
    x = qkv.detach().clone().requires_grad_(True)
    f0, b0 = twa.window_attention.launches, twa.window_attention_bwd.launches
    out = twa.window_attention(x, src.expand(nW, h, N, N), h)
    out.backward(dout)
    torch.cuda.synchronize()
    assert twa.window_attention.launches == f0 + 1
    assert twa.window_attention_bwd.launches == b0 + 1
    rq, rb = twa.window_attention_bwd_reference(
        qkv, src.detach().expand(nW, h, N, N), dout, h)
    _assert_bwd_close((x.grad, src.grad[0].expand(nW, h, N, N)),
                      (rq, rb.sum(0, keepdim=True).expand(nW, h, N, N)), dtype)
    torch.testing.assert_close(out.float(), twa.window_attention_reference(
        qkv, src.detach().expand(nW, h, N, N), h).float(), **TOL[dtype])


@pytest.mark.parametrize("case", ["dout_dtype", "dout_noncontig",
                                  "dout_shape", "host", "too_large_long",
                                  "too_large_bf16", "misaligned_long_bf16",
                                  "long_hd128_bf16", "misaligned_bf16",
                                  "too_long"])
def test_window_attention_bwd_kernel_rejects(cuda, case):
    qkv, bias, dout = _bwd_inputs((1, 2, 16, 2, 32), torch.float32, cuda, 3)
    h, err = 2, ValueError
    if case == "dout_dtype":
        dout, err = dout.bfloat16(), TypeError
    elif case == "dout_noncontig":
        dout = dout.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "dout_shape":
        dout = dout[..., :-2].contiguous()
    elif case == "host":
        qkv, bias, dout = qkv.cpu(), bias.cpu(), dout.cpu()
    elif case == "too_large_long":         # fp32 K and V at hd = 128, N = 324
        qkv, bias, dout = _bwd_inputs((1, 1, 324, 1, 128), torch.float32,
                                      cuda, 4)
        h = 1
    elif case == "too_large_bf16":
        # q, k, v and dO at hd = 128 beside the bias and dbias tiles, and
        # no long-window kernel at hd = 128
        qkv, bias, dout = _bwd_inputs((1, 1, 144, 1, 128), torch.bfloat16,
                                      cuda, 4)
        h = 1
    elif case == "misaligned_long_bf16":   # the long kernels copy 16 bytes too
        qkv, bias, dout = _bwd_inputs((1, 1, 324, 2, 32), torch.bfloat16,
                                      cuda, 4)
        dout = torch.empty(dout.numel() + 1, dtype=dout.dtype,
                           device=cuda)[1:].view_as(dout).copy_(dout)
    elif case == "long_hd128_bf16":        # bf16 hd = 128 beyond N = 144
        qkv, bias, dout = _bwd_inputs((1, 1, 324, 1, 128), torch.bfloat16,
                                      cuda, 4)
        h = 1
    elif case == "misaligned_bf16":        # the kernel copies 16-byte chunks
        qkv, bias, dout = _bwd_inputs((1, 2, 16, 2, 32), torch.bfloat16,
                                      cuda, 4)
        qkv = torch.empty(qkv.numel() + 1, dtype=qkv.dtype,
                          device=cuda)[1:].view_as(qkv).copy_(qkv)
    elif case == "too_long":               # K2 takes N <= 352, as K1
        qkv, bias, dout = _bwd_inputs((1, 1, 353, 1, 32), torch.bfloat16,
                                      cuda, 4)
        h = 1
    before = twa.window_attention_bwd.launches
    with pytest.raises(err):
        twa.window_attention_bwd_cuda(qkv, bias, dout, h)
    assert twa.window_attention_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_model_kernel_path_matches_plain_path(cuda, dtype, monkeypatch):
    """One seed: the tiny model's fused forward with the kernel on the card
    against the plain path.  fp32: the plain path on the host.  bf16: the
    plain window attention on the card (every other op the same kernels,
    so only K1's tensor-core route differs), to bf16's tolerance."""
    cfg = FiberConfig.tiny_test(loss_names=("itm", "mlm", "itc"),
                                compute_dtype=dtype)
    devices = (cuda, "cpu" if dtype == torch.float32 else cuda)
    models = [FiberCoarse(cfg, device=d, seed=0).eval() for d in devices]
    gen = torch.Generator().manual_seed(1)
    for m in models:
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith(("alpha_i2t", "alpha_t2i")):
                    p.fill_(0.5)
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.standard_normal(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    ids = torch.randint(4, cfg.vocab_size, (2, cfg.max_text_len), generator=gen)
    masks = torch.ones_like(ids)
    before = _launch_counts(twa.window_attention)
    with torch.inference_mode():
        out = models[0].infer(img.to(cuda), ids.to(cuda), masks.to(cuda))
        assert twa.window_attention.launches - before[0] == sum(cfg.swin_depths)
        route = "tc" if dtype == torch.bfloat16 else "cuda_core"
        assert (twa.window_attention.route_launches[route] - before[1][route]
                == sum(cfg.swin_depths))
        monkeypatch.setattr(swin, "window_attention",
                            twa.window_attention_reference)
        x = tuple(t.to(devices[1]) for t in (img, ids, masks))
        ref = models[1].infer(*x)
    tol = (dict(rtol=0, atol=1e-4) if dtype == torch.float32
           else dict(rtol=5e-2, atol=5e-2))
    for k in ref:
        torch.testing.assert_close(out[k].float().cpu(), ref[k].float().cpu(),
                                   **tol)


def test_tiny_vqa_step_at_window_18(cuda):
    """The VQA finetuning step at tiny widths with FIBER's 576^2 window (18
    x 18, N = 324 in stages 1-3 of a 288^2 image; 81 in stage 4) on the
    card.  fp32: K1 and K2 in every Swin block (K2 on its long-window
    CUDA-core kernels at N = 324) and the host's plain path give the same
    loss and gradients, each within 1e-3 of its max-abs.  bf16: every K2
    launch at N = 324 on the long-window tensor-core route, the loss and
    gradients finite."""
    from fiber_torch.train.trainer import CoarseTrainer
    kw = dict(loss_names=("vqa",), image_size=288, window_size=18,
              warmup_steps=0)
    rng = np.random.default_rng(3)
    cfg = FiberConfig.tiny_test(**kw)
    batch = {"image": rng.standard_normal((2, 288, 288, 3)).astype(np.float32),
             "text_ids": rng.integers(4, cfg.vocab_size, (2, cfg.max_text_len)),
             "text_masks": np.ones((2, cfg.max_text_len), np.int64),
             "vqa_targets": (rng.random((2, cfg.vqav2_label_size)) < 0.3
                             ).astype(np.float32)}
    blocks = sum(cfg.swin_depths)
    long_blocks = sum(cfg.swin_depths[:3])
    grads, losses = {}, {}
    for dev in (cuda, "cpu"):
        tr = CoarseTrainer(cfg, device=dev, seed=0)
        before = _launch_counts(twa.window_attention_bwd)
        losses[dev] = float(tr._grads(batch, None)["total_loss"])
        grads[dev] = {n: p.grad.detach().cpu().clone()
                      for n, p in tr.model.named_parameters()}
        if dev == cuda:
            routes = {k: twa.window_attention_bwd.route_launches[k]
                      - before[1][k] for k in before[1]}
            assert routes["cuda_core_long"] == long_blocks
            assert sum(routes.values()) == blocks
    assert abs(losses[cuda] - losses["cpu"]) <= 1e-3 * abs(losses["cpu"])
    # the Swin blocks' weights and bias tables, which K1 and K2 reach (a
    # key bias's true gradient is 0: only rounding noise to compare)
    checked = [n for n in grads["cpu"] if n.startswith("vit_model.")
               and n.endswith(("weight", "relative_position_bias_table"))]
    assert len(checked) > 4 * blocks
    for n in checked:
        g = grads["cpu"][n]
        scale = g.abs().max().item()
        assert (grads[cuda][n] - g).abs().max().item() <= 1e-3 * scale, n
    tr = CoarseTrainer(FiberConfig.tiny_test(compute_dtype=torch.bfloat16,
                                             **kw), device=cuda, seed=0)
    before = _launch_counts(twa.window_attention_bwd)
    loss = tr.train_step(batch)["total_loss"]
    assert twa.window_attention_bwd.route_launches["tc_long"] - \
        before[1]["tc_long"] == long_blocks
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in tr.params)


# K4: FIBER-Base 384^2 stage 1 and 3 shapes, then small ones
HEADS_SHAPES = [(2, 64, 144, 4, 32), (2, 4, 144, 16, 32), (16, 4, 144, 16, 32),
                (5, 4, 144, 16, 32), (3, 3, 49, 4, 64), (2, 2, 16, 2, 8),
                (2, 2, 4, 1, 16)]
HEADS_CASES = ([(d, s) for d in (torch.float32, torch.bfloat16)
                for s in HEADS_SHAPES]
               + [(torch.bfloat16, (1, 2, 256, 2, 128))])   # the CUDA cores


@pytest.mark.parametrize("dtype,shape", HEADS_CASES,
                         ids=_case_ids(HEADS_CASES))
def test_window_attention_heads_kernel_matches_plain(cuda, dtype, shape):
    B, nW, N, h, hd = shape
    qkv, bias = _inputs(B, nW, N, h, hd, N + hd + 1, cuda, dtype)
    q, k, v = twa.split_heads_qkv(qkv, h)
    route = twa._fwd_route(dtype, N, hd)
    assert route == ("tc" if dtype == torch.bfloat16 and N <= 144
                     and hd <= 64 else "cuda_core")
    before = _launch_counts(twa.window_attention_heads)
    with torch.inference_mode():
        out = twa.window_attention_heads(q, k, v, bias)
        ref = twa.window_attention_heads_reference(q, k, v, bias)
        packed = twa.window_attention(qkv, bias, h)
    torch.cuda.synchronize()
    _assert_one_launch(twa.window_attention_heads, before, route, _fwd_splits(
        route, "window_attention_heads_tc", B, nW, N, h, hd, cuda))
    assert out.dtype == dtype and out.shape == (B, nW, h, N, hd)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    # K4 runs K1's routine on other strides: the same numbers
    torch.testing.assert_close(out.transpose(2, 3).reshape(B, nW, N, h * hd),
                               packed, rtol=0, atol=0)


def test_window_attention_heads_kernel_broadcast_bias(cuda):
    qkv, bias = _inputs(2, 4, 144, 4, 32, 0, cuda, torch.bfloat16)
    q, k, v = twa.split_heads_qkv(qkv, 4)
    one = bias[:1].contiguous()
    before = _launch_counts(twa.window_attention_heads)
    with torch.inference_mode():
        a = twa.window_attention_heads(q, k, v, one.expand(4, 4, 144, 144))
        b = twa.window_attention_heads(
            q, k, v, one.expand(4, 4, 144, 144).contiguous())
    assert (twa.window_attention_heads.route_launches["tc"]
            == before[1]["tc"] + 2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# K4 at FIBER's 576^2 windows (N = 324): stages 1 and 3, one window, and
# the cap; bf16 on the long-window tensor-core route (K1's routine on
# per-head rows), fp32 on the CUDA cores' 11-chunk instance
HEADS_LONG_SHAPES = [(2, 64, 324, 4, 32), (2, 4, 324, 16, 32),
                     (1, 1, 324, 2, 16), (2, 2, 352, 1, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", HEADS_LONG_SHAPES,
                         ids=["x".join(map(str, s)) for s in HEADS_LONG_SHAPES])
def test_window_attention_heads_kernel_long_windows(cuda, dtype, shape):
    """K4 beyond 144 tokens against its plain version: bf16 on "tc_long"
    (within one bf16 ulp of each row's max, its plan `_long_plan`'s), fp32
    on the CUDA cores.  Either way it runs K1's routine for the dtype on
    other strides, so K4 and K1 agree bit for bit, and two calls give the
    same bits."""
    B, nW, N, h, hd = shape
    qkv, bias = _inputs(B, nW, N, h, hd, N + hd + 3, cuda, dtype)
    q, k, v = twa.split_heads_qkv(qkv, h)
    route = "tc_long" if dtype == torch.bfloat16 else "cuda_core"
    assert twa._heads_route(dtype, N, hd) == route
    before = _launch_counts(twa.window_attention_heads)
    with torch.inference_mode():
        out = twa.window_attention_heads(q, k, v, bias)
        ref = twa.window_attention_heads_reference(q, k, v, bias)
        packed = twa.window_attention(qkv, bias, h)
    torch.cuda.synchronize()
    _assert_one_launch(twa.window_attention_heads, before, route, _fwd_splits(
        route, "window_attention_heads_tc_long", B, nW, N, h, hd, cuda))
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(
        out.transpose(2, 3).reshape(B, nW, N, h * hd), packed, rtol=0, atol=0)
    if route == "tc_long":
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        R, parts, S, _ = twa._long_plan(B, nW, h, N, hd, sms)
        assert (twa.window_attention_heads.last_rows,
                twa.window_attention_heads.last_parts) == (R, parts)
        flat = lambda t: t.transpose(2, 3).reshape(B, nW, N, h * hd)
        _ulp_close(torch.cat([flat(out)] * 3, -1), torch.cat([flat(ref)] * 3, -1))
    with torch.inference_mode():
        again = twa.window_attention_heads(q, k, v, bias)
    assert torch.equal(out, again)


def test_window_attention_heads_kernel_long_broadcast_bias(cuda):
    """The long-window K4 with a broadcast (stride-0) bias gives the bits
    of the same bias laid out per window."""
    qkv, bias = _inputs(2, 16, 324, 4, 32, 5, cuda, torch.bfloat16)
    q, k, v = twa.split_heads_qkv(qkv, 4)
    one = bias[:1].contiguous()
    before = _launch_counts(twa.window_attention_heads)
    with torch.inference_mode():
        a = twa.window_attention_heads(q, k, v, one.expand(16, 4, 324, 324))
        b = twa.window_attention_heads(
            q, k, v, one.expand(16, 4, 324, 324).contiguous())
    assert (twa.window_attention_heads.route_launches["tc_long"]
            == before[1]["tc_long"] + 2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["head_dim", "noncontig", "dtypes",
                                  "misaligned_bf16", "misaligned_long_bf16",
                                  "long_fp32_hd128", "beyond_cap"])
def test_window_attention_heads_kernel_rejects(cuda, case):
    qkv, bias = _inputs(1, 2, 16, 2, 32, 1, cuda, torch.float32)
    q, k, v = twa.split_heads_qkv(qkv, 2)
    err = ValueError
    if case == "head_dim":
        qkv, bias = _inputs(1, 2, 16, 2, 24, 1, cuda, torch.float32)
        q, k, v = twa.split_heads_qkv(qkv, 2)
    elif case == "noncontig":
        q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif case == "misaligned_bf16":           # the tc route copies 16 bytes
        q, k = q.bfloat16(), k.bfloat16()
        v = torch.empty(v.numel() + 1, dtype=torch.bfloat16,
                        device=cuda)[1:].view_as(v).copy_(v)
    elif case == "misaligned_long_bf16":      # so does the tc_long route
        qkv, bias = _inputs(1, 2, 324, 2, 32, 1, cuda, torch.bfloat16)
        q, k, v = twa.split_heads_qkv(qkv, 2)
        v = torch.empty(v.numel() + 1, dtype=torch.bfloat16,
                        device=cuda)[1:].view_as(v).copy_(v)
    elif case in ("long_fp32_hd128", "beyond_cap"):
        # fp32 K and V of 324 rows at hd = 128 exceed a block's shared
        # memory; 353 tokens exceed every kernel's cap
        N, hd = (324, 128) if case == "long_fp32_hd128" else (353, 32)
        qkv, bias = _inputs(1, 1, N, 1, hd, 1, cuda, torch.float32)
        q, k, v = twa.split_heads_qkv(qkv, 1)
    else:
        k, err = k.bfloat16(), TypeError
    before = twa.window_attention_heads.launches
    with pytest.raises(err):
        twa.window_attention_heads(q, k, v, bias)
    assert twa.window_attention_heads.launches == before


# K3: (B, H, W, C, heads, window, blocks); shifted stacks, a FIBER-Base-like
# N = 144 stage, hd 8 / 16 / 64, one-window stacks (the window clamped to
# the map, no shift: the stage-4 layout), a FIBER-Base stage-3 stack at
# full width, and hd = 128 (bf16 on the CUDA cores)
K3_SHAPES = [(2, 8, 8, 64, 2, 4, 3), (2, 24, 24, 128, 4, 12, 2),
             (2, 4, 4, 32, 4, 2, 3), (1, 8, 8, 64, 4, 4, 2),
             (1, 14, 14, 128, 2, 7, 2), (2, 12, 12, 128, 4, 12, 2),
             (3, 4, 4, 64, 2, 4, 1), (1, 24, 24, 512, 16, 12, 2),
             (1, 8, 8, 256, 2, 4, 2)]
K3_CASES = [(d, s) for d in (torch.float32, torch.bfloat16) for s in K3_SHAPES]
# of the output's max-abs
K3_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _k3_route(dtype, shape):
    B, H, W, C, h, window, n = shape
    return tss._k3_route(dtype, window * window, C // h)


def _k3_case_ids(cases):
    """route-dtype-shape, e.g. tc-bfloat16-1x24x24x512x16x12x2 (`-k
    "fused_swin_blocks and tc-bfloat16"` picks K3's tensor-core cases)."""
    return [f"{_k3_route(d, s)}-{str(d)[6:]}-{'x'.join(map(str, s))}"
            for d, s in cases]


def _k3_stack(shape, dtype, device, seed):
    """Seeded blocks of one stage (LayerNorms and biases off 1 / 0), stacked,
    and an input."""
    B, H, W, C, h, window, n = shape
    gen = torch.Generator().manual_seed(seed)
    blocks = [SwinBlock(C, (H, W), h, window, (window // 2) * (i % 2))
              for i in range(n)]
    with torch.no_grad():
        for blk in blocks:
            for name, p in blk.named_parameters():
                r = torch.randn(p.shape, generator=gen)
                p.copy_(1 + 0.1 * r if name.startswith("norm") and
                        name.endswith("weight") else
                        0.5 * r if "bias_table" in name else
                        0.05 * r)
    blocks = [b.to(device) for b in blocks]
    x = torch.randn(B, H, W, C, generator=gen).to(device, dtype)
    return x, blocks, tss.stack_stage(blocks, dtype)


@pytest.mark.parametrize("dtype,shape", K3_CASES, ids=_k3_case_ids(K3_CASES))
def test_fused_swin_blocks_kernel_matches_plain(cuda, dtype, shape):
    x, _, st = _k3_stack(shape, dtype, cuda, sum(shape))
    assert st.use_shift == (shape[1] > shape[5] and shape[6] > 1)
    route = _k3_route(dtype, shape)
    assert route == ("tc" if dtype == torch.bfloat16 and shape[5] <= 12
                     and shape[3] // shape[4] <= 64 else "cuda_core")
    before = _launch_counts(tss.fused_swin_blocks)
    with torch.inference_mode():
        out = st(x)
        ref = tss.fused_swin_blocks_reference(x, st.params, st.mask,
                                              st.window, st.num_heads,
                                              st.use_shift)
    torch.cuda.synchronize()
    launches, routes = before
    assert tss.fused_swin_blocks.launches == launches + 1
    assert {k: tss.fused_swin_blocks.route_launches[k] - routes[k]
            for k in routes} == {k: int(k == route) for k in routes}
    assert tss.fused_swin_blocks.last_grid > 0
    assert out.dtype == dtype and out.shape == x.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= K3_TOL[dtype] * ref.float().abs().max().item(), err


def test_fused_swin_blocks_kernel_is_deterministic(cuda):
    """Two calls of the tensor-core K3 give the same bits: every output
    element is written by one thread, without atomics."""
    x, _, st = _k3_stack((2, 24, 24, 128, 4, 12, 2), torch.bfloat16, cuda, 8)
    before = tss.fused_swin_blocks.route_launches["tc"]
    with torch.inference_mode():
        a, b = st(x), st(x)
    torch.cuda.synchronize()
    assert tss.fused_swin_blocks.route_launches["tc"] == before + 2
    assert torch.equal(a, b)


# K3 at FIBER's 576^2 windows (18 x 18, N = 324): bf16 on the long-window
# tensor-core route, fp32 on the CUDA cores' 11-chunk instance: one window,
# four windows shifted, and 576^2 stage 3's width (C = 512, 16 heads)
K3_LONG_SHAPES = [(1, 18, 18, 64, 2, 18, 2), (2, 36, 36, 64, 4, 18, 2),
                  (1, 36, 36, 512, 16, 18, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_LONG_SHAPES,
                         ids=["x".join(map(str, s)) for s in K3_LONG_SHAPES])
def test_fused_swin_blocks_kernel_long_windows(cuda, dtype, shape):
    """K3 beyond 256 tokens against its plain version: bf16 on "tc_long"
    (one block an SM, two calls bit-equal), fp32 on a grid of the resident
    blocks the card reports for the 11-chunk instance."""
    x, _, st = _k3_stack(shape, dtype, cuda, sum(shape) + 1)
    assert st.use_shift == (shape[1] > shape[5])
    route = "tc_long" if dtype == torch.bfloat16 else "cuda_core"
    assert _k3_route(dtype, shape) == route
    before = _launch_counts(tss.fused_swin_blocks)
    with torch.inference_mode():
        out = st(x)
        ref = tss.fused_swin_blocks_reference(x, st.params, st.mask,
                                              st.window, st.num_heads,
                                              st.use_shift)
    torch.cuda.synchronize()
    assert tss.fused_swin_blocks.launches == before[0] + 1
    assert {k: tss.fused_swin_blocks.route_launches[k] - before[1][k]
            for k in before[1]} == {k: int(k == route) for k in before[1]}
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if route == "cuda_core":
        attrs = tss.cuda_core_attrs(shape[5] ** 2, shape[3] // shape[4],
                                    dtype)
        assert attrs["blocks_per_sm"] >= 1
        assert tss.fused_swin_blocks.last_grid == attrs["blocks_per_sm"] * sms
    else:
        assert tss.fused_swin_blocks.last_grid == sms
        with torch.inference_mode():
            again = st(x)
        assert torch.equal(out, again)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= K3_TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("case", ["noncontig", "head_dim", "grad",
                                  "weight_dtype", "misaligned_bf16",
                                  "long_fp32_hd128", "misaligned_bf16_long"])
def test_fused_swin_blocks_kernel_rejects(cuda, case):
    shape = (2, 8, 8, 64, 2, 4, 2)
    x, blocks, st = _k3_stack(shape, torch.float32, cuda, 3)
    sp, err = st.params, ValueError
    call = lambda: tss.fused_swin_blocks(x, sp, st.mask, st.window,
                                         st.num_heads, st.use_shift)
    if case == "noncontig":
        x = x.transpose(1, 2)
    elif case == "head_dim":         # C = 96 in 4 heads: hd = 24
        x, _, st = _k3_stack((2, 8, 8, 96, 4, 4, 2), torch.float32, cuda, 4)
        sp = st.params
    elif case == "grad":
        x, err = x.requires_grad_(True), RuntimeError
    elif case == "misaligned_bf16":  # the tc route copies 16-byte chunks
        x, _, st = _k3_stack(shape, torch.bfloat16, cuda, 3)
        sp = st.params
        x = torch.empty(x.numel() + 1, dtype=x.dtype,
                        device=cuda)[1:].view_as(x).copy_(x)
    elif case == "misaligned_bf16_long":  # so does the tc_long route
        x, _, st = _k3_stack((1, 18, 18, 64, 2, 18, 1), torch.bfloat16, cuda,
                             6)
        sp = st.params
        x = torch.empty(x.numel() + 1, dtype=x.dtype,
                        device=cuda)[1:].view_as(x).copy_(x)
    elif case == "long_fp32_hd128":  # 324 rows of fp32 K, V exceed a block
        x, _, st = _k3_stack((1, 18, 18, 256, 2, 18, 1), torch.float32, cuda,
                             5)
        sp = st.params
    else:
        sp = dict(sp, qkv_w=sp["qkv_w"].bfloat16())
    before = tss.fused_swin_blocks.launches
    with pytest.raises(err):
        call()
    assert tss.fused_swin_blocks.launches == before
