"""The fp32 window attention at hd <= 64: K1's and K4's register-tiled
CUDA-core forward (route "f32_tiled": `csrc/window_attention_f32.cu`,
`csrc/window_attention_heads_f32.cu`) and K2's split-TF32 backward on the
tensor cores (route "tc_f32": `csrc/window_attention_bwd_tf32.cu`): the
route rule, the plans (`_f32_plan`, `_bwd_f32_plan`), and a plain-torch
emulation of the split-TF32 product K2 runs (each fp32 operand rounded to
TF32's 10-bit mantissa as big + small, three products) held against fp64
at FIBER's 576^2 windows (N = 324, hd = 32) within the limits the card
checks use, and of the tensor cores' rounding of a sum toward zero, which
is why K2 sums each product apart.  The emulation is a test helper; the
port never calls it.

The `cuda`-marked cases hold the kernels against their plain versions on a
card and skip here.  This file imports neither JAX nor `fiber_tpu`:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_window_attention_tf32.py
"""

import numpy as np
import pytest
import torch

from fiber_torch.ops import window_attention as twa

torch.set_num_threads(1)

# the card checks' fp32 limits (chip_smoke.py): TOL[float32] and the
# long-window K1 / K2 limits, all absolute
FP32_ATOL = 1e-4
LONG_FP32_ATOL = 1e-5

# FIBER-Base 576^2 stages (nW, h) and the detection / Swin-T stage 1
STAGES_576 = [(64, 4), (16, 8), (4, 16), (1, 32)]


# ---- the route ------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 16, 49, 144, 150, 324, 352])
@pytest.mark.parametrize("hd", [8, 16, 32, 64])
def test_fp32_takes_tc_f32(N, hd):
    """fp32 K2 runs the split-TF32 route, K1 and K4 the tiled CUDA-core
    one, at every head dim the tensor cores take and every N <= 352:
    FIBER-B at 384^2 and 576^2, Swin-T and the detection stages (hd = 32
    at N = 49, 144, 324)."""
    assert twa._fwd_route(torch.float32, N, hd) == "f32_tiled"
    assert twa._heads_route(torch.float32, N, hd) == "f32_tiled"
    assert twa._bwd_route(torch.float32, N, hd) == "tc_f32"


@pytest.mark.parametrize("N", [49, 144, 324])
def test_fp32_hd128_stays_on_the_cuda_cores(N):
    """hd = 128 has no model path and keeps the CUDA-core kernels: K1 and
    K4 on `cuda_core`, K2 on its whole tiles or its row and column kernels
    where K and V fit a block, and a ValueError where they do not."""
    assert twa._fwd_route(torch.float32, N, 128) == "cuda_core"
    assert twa._heads_route(torch.float32, N, 128) == "cuda_core"
    if N <= 144:
        assert twa._bwd_route(torch.float32, N, 128) == (
            "cuda_core" if N == 49 else "cuda_core_long")
    else:
        with pytest.raises(ValueError, match="shared memory"):
            twa._bwd_route(torch.float32, N, 128)


def test_bf16_routes_unchanged():
    assert twa._fwd_route(torch.bfloat16, 144, 32) == "tc"
    assert twa._fwd_route(torch.bfloat16, 324, 32) == "tc_long"
    assert twa._bwd_route(torch.bfloat16, 144, 32) == "tc"
    assert twa._bwd_route(torch.bfloat16, 324, 32) == "tc_long"


@pytest.mark.parametrize("N,hd", [(353, 32), (0, 32), (49, 128), (49, 24)])
def test_f32_plans_raise_off_their_shapes(N, hd):
    with pytest.raises(ValueError):
        fwd_plan(2, 4, 4, N, hd, 132)
    with pytest.raises(ValueError):
        bwd_plan(2, 4, 4, N, hd, 132)


def test_fp32_backward_raises_past_the_cap():
    with pytest.raises(ValueError, match="352"):
        twa._bwd_route(torch.float32, 353, 32)


# ---- the plans --------------------------------------------------------------

# On the card the plans take each kernel's blocks an SM from the CUDA
# occupancy API (`twa._f32_occupancy`).  Here they take this model of an
# H100's: the kernels' shared-memory layouts, and the warps an SM holds at
# their registers (hd = 32): each of an SM's four schedulers has 16,384
# registers, so a kernel of up to 128 a thread holds 4 warps a scheduler,
# one of up to 255 2.  The forward takes up to 128 registers a thread at
# KC <= 5 keys a lane, 186-254 at 8 and 11; K2's row and column kernels
# 204-222.  `test_tc_f32_occupancy_model_is_the_cards` holds the model to
# the card at hd = 32; at hd = 8 and 16 the card holds more of K2's blocks
# than the model says (fewer registers), so plans there differ from the
# card's.
SM_WARPS_FWD = {2: 16, 5: 16, 8: 8, 11: 8}
SM_WARPS_BWD = 8
STAGES = {"rows": 3, "cols": 4}


def key_chunks(N: int) -> int:
    """Keys a lane of the fp32 forward holds (`f32_key_chunks`), over 32."""
    return 2 if N <= 64 else 5 if N <= 160 else 8 if N <= 256 else 11


def fwd_smem_bytes(N: int, hd: int, warps: int) -> int:
    """`attend_f32_smem_bytes`: K (32 KC rows of hd + 4 fp32), V (32 KC
    rows of hd), the block's q~ rows and each warp's 32 x 8 fp32 p
    exchange."""
    kc = key_chunks(N)
    return 4 * (32 * kc * (hd + 4) + 32 * kc * hd + 8 * warps * hd
                + warps * 32 * 8)


def stage_bytes(hd: int) -> int:
    """One ring stage of K2's split-TF32 kernels: 32 rows of two operands,
    each a big and a small plane of fp32 rows of hd + 4."""
    return 4 * 4 * 32 * (hd + 4)


def rows_smem_bytes(N: int, hd: int, warps: int) -> int:
    """`rows_smem_bytes`: the ring of K and V, then the block's 16 warps
    dbias rows of NP + 8 fp32."""
    return (STAGES["rows"] * stage_bytes(hd)
            + 4 * 16 * warps * (twa._up16(N) + 8))


def cols_smem_bytes(hd: int) -> int:
    """`cols_smem_bytes`: its stages of 32 rows of q and dO and their (M,
    1 / L, D, 0)."""
    return STAGES["cols"] * (stage_bytes(hd) + 16 * 32)


def occupancy(smem, sm_warps: int):
    """Blocks an SM holds at 1 ... 8 warps a block, by `twa._resident`."""
    return tuple(twa._resident(smem(w), w, sm_warps)
                 for w in range(1, twa._F32_MAX_WARPS + 1))


def fwd_occupancy(N: int, hd: int):
    return occupancy(lambda w: fwd_smem_bytes(N, hd, w),
                     SM_WARPS_FWD[key_chunks(N)])


def bwd_occupancy(N: int, hd: int):
    return (occupancy(lambda w: rows_smem_bytes(N, hd, w), SM_WARPS_BWD),
            occupancy(lambda w: cols_smem_bytes(hd), SM_WARPS_BWD))


def fwd_plan(B, nW, h, N, hd, sms):
    """`twa._f32_plan` on the modelled H100's occupancy."""
    twa._check_f32(N, hd)
    return twa._f32_plan(B, nW, h, N, hd, sms, fwd_occupancy(N, hd))


def bwd_plan(B, nW, h, N, hd, sms):
    """`twa._bwd_f32_plan` on the modelled H100's occupancy."""
    twa._check_f32(N, hd)
    return twa._bwd_f32_plan(B, nW, h, N, hd, sms, *bwd_occupancy(N, hd))


SHAPES = ([(4, nW, h, 324) for nW, h in STAGES_576]
          + [(8, nW, h, 324) for nW, h in STAGES_576]
          + [(2, 476, 4, 144), (2, 1392, 3, 49), (24, 4, 16, 144),
             (1, 1, 1, 4), (3, 2, 2, 150), (2, 2, 1, 352)])


@pytest.mark.parametrize("B,nW,h,N", SHAPES)
@pytest.mark.parametrize("hd", [8, 32, 64])
def test_f32_plan_covers_the_rows(B, nW, h, N, hd):
    """The forward's blocks of `warps` warps of 8 query rows cover every
    row with at most 8 warps a block and no block without rows, fit a
    block's shared memory, and split the batch into 1 ... B runs."""
    warps, S, per_sm = fwd_plan(B, nW, h, N, hd, 132)
    units = -(-N // 8)
    blocks = -(-units // warps)
    assert 1 <= warps <= twa._F32_MAX_WARPS and warps <= units
    assert (blocks - 1) * warps < units <= blocks * warps
    assert 1 <= S <= B and per_sm >= 1
    assert (fwd_smem_bytes(N, hd, warps) + 1024) * per_sm <= twa._SM_SMEM


@pytest.mark.parametrize("B,nW,h,N", SHAPES)
@pytest.mark.parametrize("hd", [8, 32, 64])
def test_bwd_f32_plan_fits(B, nW, h, N, hd):
    """K2's row kernel keeps 16 W rows of dbias (NP + 8 fp32 each) beside
    its ring: W is chosen so that the block fits; both kernels' blocks
    cover the rows (keys), and each splits the batch into 1 ... B runs."""
    W, S, Wc, Sc = bwd_plan(B, nW, h, N, hd, 132)
    slabs = -(-N // 16)
    for w, s in ((W, S), (Wc, Sc)):
        assert 1 <= w <= min(twa._F32_MAX_WARPS, slabs)
        assert (-(-slabs // w) - 1) * w < slabs
        assert 1 <= s <= B
    assert rows_smem_bytes(N, hd, W) <= twa._MAX_SMEM
    assert cols_smem_bytes(hd) <= twa._MAX_SMEM


def test_f32_plans_at_fiber_shapes():
    """The plans at the shapes the model paths run (hd = 32, 132 SMs): K2
    at 576^2 stage 1 in 3 blocks of 8 warps (both kernels), at the
    detection stage 1 in 3 of 4 (two blocks an SM: the widths an H100 ran
    fastest), at Swin-T's N = 49 in one block of 4; the forward at N = 324
    in 6 blocks of 8 warps (64 rows, one block an SM at its registers), at
    N = 144 in 4 of 5 (three an SM)."""
    assert bwd_plan(8, 64, 4, 324, 32, 132)[::2] == (8, 8)
    assert bwd_plan(2, 476, 4, 144, 32, 132)[::2] == (4, 4)
    assert bwd_plan(2, 1392, 3, 49, 32, 132)[::2] == (4, 4)
    assert fwd_plan(4, 64, 4, 324, 32, 132)[::2] == (8, 1)
    assert fwd_plan(2, 476, 4, 144, 32, 132)[::2] == (5, 3)


def test_f32_warps_raise_where_no_block_fits():
    """A shape whose kernel no SM holds at any width raises."""
    with pytest.raises(ValueError, match="fits an SM"):
        twa._f32_plan(2, 4, 4, 49, 32, 132, (0,) * twa._F32_MAX_WARPS)


def test_f32_smem_layouts():
    """The model's copies of the kernels' shared-memory layouts: the
    forward's K (32 KC rows of hd + 4 fp32, KC = 11 at N = 324), V (32 KC
    rows of hd), 8 q~ rows a warp and a warp's 32 x 8 p exchange; K2's ring
    stage is 32 rows of two operands, each a big and a small plane of hd +
    4 fp32; the row kernel 3 stages, then 16 W rows of NP + 8 fp32; the
    column kernel 4, each with 32 rows' (M, 1 / L, D, 0)."""
    assert fwd_smem_bytes(324, 32, 6) == 4 * (
        352 * 36 + 352 * 32 + 48 * 32 + 6 * 256)
    assert fwd_smem_bytes(49, 32, 4) == 4 * (
        64 * 36 + 64 * 32 + 32 * 32 + 4 * 256)
    assert rows_smem_bytes(324, 32, 7) == (
        3 * 4 * 32 * 36 * 4 + 16 * 7 * 344 * 4)
    assert cols_smem_bytes(64) == 4 * (4 * 32 * 68 * 4 + 512)


# ---- the split-TF32 product, emulated ---------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as `cvt.rna.tf32.f32` rounds: add half of the 13
    dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: three TF32 products into an fp32
    accumulator, the small terms first."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on TF32 operands alone (one product)."""
    return tf32(a) @ tf32(b)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0], dtype=torch.float32)
    want = [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
            -(1.0 + 2 ** -10), 1.0, 3.0]
    assert tf32(x).tolist() == want
    big, small = split(torch.tensor([1.0 + 2 ** -11 + 2 ** -20]))
    assert float(big + small) == 1.0 + 2 ** -11 + 2 ** -20


def _draws(B, nW, h, N, hd, seed):
    """Inputs shaped as the card checks draw them: standard-normal qkv and
    dout, a bias of 0.1 N(0, 1) with the shift mask's -100 on 30% of its
    elements."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, nW, h, N, hd)))
               .float() for _ in range(3))
    bias = (torch.from_numpy(0.1 * rng.standard_normal((nW, h, N, N))
                             - 100.0 * (rng.random((nW, h, N, N)) < 0.3))
            .float())
    do = torch.from_numpy(rng.standard_normal((B, nW, h, N, hd))).float()
    return q, k, v, bias, do


def _forward(q, k, v, bias, mm):
    """K1 in fp32 with every product through `mm` (fp64 inputs: exact)."""
    scale = q.shape[-1] ** -0.5
    s = bias[None] + mm(q * scale, k.transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    return mm(p, v), p


def _backward(q, k, v, bias, do, mm):
    """K2's five products through `mm`: dq, dk, dv, dbias."""
    scale = q.shape[-1] ** -0.5
    _, p = _forward(q, k, v, bias, mm)
    dv = mm(p.transpose(-1, -2), do)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = mm(ds, k) * scale
    dk = mm(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv, ds.sum(0)


@pytest.fixture(scope="module")
def long_draws():
    """576^2 stage-1 windows, cut to two windows and two heads."""
    return _draws(2, 2, 2, 324, 32, 21)


def test_split_tf32_forward_within_the_fp32_limit(long_draws):
    """At N = 324, hd = 32 a split-TF32 forward stays within
    K1_LONG_FP32_ATOL (1e-5) of fp64; one TF32 product a product (what
    TF32 mode would do) does not, which is why K2 takes three.  (K1 and K4
    run the plain version's own fp32 operations, not this.)"""
    q, k, v, bias, _ = long_draws
    exact, _ = _forward(*(t.double() for t in (q, k, v, bias)), torch.matmul)
    three, _ = _forward(q, k, v, bias, mm3)
    one, _ = _forward(q, k, v, bias, mm1)
    plain, _ = _forward(q, k, v, bias, torch.matmul)
    err3 = (three.double() - exact).abs().max().item()
    err1 = (one.double() - exact).abs().max().item()
    err_plain = (plain.double() - exact).abs().max().item()
    assert err3 <= LONG_FP32_ATOL, err3
    assert err1 > LONG_FP32_ATOL, err1
    # about fp32's own error: within a few times the plain fp32 version's
    assert err3 <= 8 * err_plain + 1e-7, (err3, err_plain)


def test_split_tf32_backward_within_the_fp32_limit(long_draws):
    """At N = 324, hd = 32 the split-TF32 backward's dq, dk, dv and dbias
    stay within K2_LONG_FP32_ATOL (1e-5) of fp64, and one TF32 product a
    product does not."""
    q, k, v, bias, do = long_draws
    exact = _backward(*(t.double() for t in (q, k, v, bias, do)),
                      torch.matmul)
    three = _backward(q, k, v, bias, do, mm3)
    one = _backward(q, k, v, bias, do, mm1)
    err3 = max((a.double() - e).abs().max().item()
               for a, e in zip(three, exact))
    err1 = max((a.double() - e).abs().max().item()
               for a, e in zip(one, exact))
    assert err3 <= LONG_FP32_ATOL, err3
    assert err1 > LONG_FP32_ATOL, err1


@pytest.mark.parametrize("N", [49, 144])
def test_split_tf32_within_the_fp32_limit_at_short_windows(N):
    """The Swin-T (N = 49) and detection / 384^2 (N = 144) windows: the
    forward and the backward within 1e-5 of fp64, far inside TOL's 1e-4."""
    q, k, v, bias, do = _draws(2, 3, 2, N, 32, N)
    ex = [t.double() for t in (q, k, v, bias, do)]
    out, _ = _forward(q, k, v, bias, mm3)
    want, _ = _forward(*ex[:4], torch.matmul)
    assert (out.double() - want).abs().max().item() <= LONG_FP32_ATOL
    for a, e in zip(_backward(q, k, v, bias, do, mm3),
                    _backward(*ex, torch.matmul)):
        assert (a.double() - e).abs().max().item() <= LONG_FP32_ATOL


def rz32(x64: torch.Tensor) -> torch.Tensor:
    """fp64 values rounded toward zero to fp32, as a tensor core rounds
    the sum it writes to an fp32 accumulator."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def mm3_tensor_core(a: torch.Tensor, b: torch.Tensor, apart: bool
                    ) -> torch.Tensor:
    """a @ b as three TF32 products a k8 step on the tensor cores: each
    step's eight products exact, their sum with the accumulator rounded
    toward zero.  apart=False chains every step into one accumulator;
    apart=True is `mma_3xtf32`: the small products from 0 into one
    accumulator, the big one into another, both added in fp32 to
    nearest."""
    (ab, as_), (bb, bs) = split(a), split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k in range(0, a.shape[-1], 8):
        sl = slice(k, k + 8)
        small = [(x[..., sl].double() @ y[..., sl, :].double())
                 for x, y in ((as_, bb), (ab, bs))]
        big = ab[..., sl].double() @ bb[..., sl, :].double()
        if apart:
            s = rz32(rz32(small[0]).double() + small[1])
            out = (out + rz32(big)) + s
        else:
            for part in small + [big]:
                out = rz32(out.double() + part)
    return out


def test_products_summed_apart_keep_plain_fp32_accuracy():
    """Why `mma_3xtf32` sums each product apart: at N = 144, hd = 32 (the
    detection windows) a forward whose products chain in one tensor-core
    accumulator lands further from fp64 than the plain fp32 version does
    (1.4e-6 here; on an H100 2e-6 from the plain version), while the
    products summed apart stay within twice the plain version's own
    error."""
    q, k, v, bias, _ = _draws(1, 1, 2, 144, 32, 144)
    exact, _ = _forward(*(t.double() for t in (q, k, v, bias)), torch.matmul)
    plain, _ = _forward(q, k, v, bias, torch.matmul)
    err = lambda o: (o.double() - exact).abs().max().item()
    chained, _ = _forward(q, k, v, bias,
                          lambda a, b: mm3_tensor_core(a, b, False))
    apart, _ = _forward(q, k, v, bias,
                        lambda a, b: mm3_tensor_core(a, b, True))
    assert err(apart) <= 2 * err(plain), (err(apart), err(plain))
    assert err(chained) > 2 * err(apart), (err(chained), err(apart))


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = [(2, 64, 324, 4, 32), (2, 8, 144, 4, 32), (2, 12, 49, 3, 32),
               (3, 2, 150, 2, 8), (2, 2, 352, 1, 64), (2, 3, 16, 2, 16),
               (1, 2, 4, 1, 8)]


def _card_inputs(shape, device, seed):
    B, nW, N, h, hd = shape
    q, k, v, bias, do = _draws(B, nW, h, N, hd, seed)
    qkv = torch.cat([t.transpose(2, 3).reshape(B, nW, N, h * hd)
                     for t in (q, k, v)], -1).contiguous()
    dout = do.transpose(2, 3).reshape(B, nW, N, h * hd).contiguous()
    return qkv.to(device), bias.to(device), dout.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=["x".join(map(str, s)) for s in CARD_SHAPES])
def test_tc_f32_kernels_match_plain(cuda, shape):
    """K1 and K4 on "f32_tiled", K2 on "tc_f32", against their plain
    versions within 1e-5; K1 and K4 bit-equal (one routine); two K2 calls
    bit-equal; one launch each on its route."""
    B, nW, N, h, hd = shape
    qkv, bias, dout = _card_inputs(shape, cuda, sum(shape))
    before = (dict(twa.window_attention.route_launches),
              dict(twa.window_attention_heads.route_launches),
              dict(twa.window_attention_bwd.route_launches))
    with torch.inference_mode():
        out = twa.window_attention(qkv, bias, h)
        ref = twa.window_attention_reference(qkv, bias, h)
        q, k, v = twa.split_heads_qkv(qkv, h)
        heads = twa.window_attention_heads(q, k, v, bias)
    got = twa.window_attention_bwd(qkv, bias, dout, h)
    again = twa.window_attention_bwd(qkv, bias, dout, h)
    want = twa.window_attention_bwd_reference(qkv, bias, dout, h)
    torch.cuda.synchronize()
    after = (twa.window_attention.route_launches,
             twa.window_attention_heads.route_launches,
             twa.window_attention_bwd.route_launches)
    assert [a[r] - b[r] for a, b, r in zip(
        after, before, ("f32_tiled", "f32_tiled", "tc_f32"))] == [1, 1, 2]
    torch.testing.assert_close(out, ref, rtol=0, atol=LONG_FP32_ATOL)
    assert torch.equal(heads.transpose(2, 3).reshape(out.shape), out)
    for a, b, r in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, r, rtol=0, atol=LONG_FP32_ATOL)


@pytest.mark.cuda
def test_tc_f32_layouts_are_the_kernels(cuda):
    """The model's copies of the shared-memory layouts are the kernels',
    and every plan the card takes has blocks an SM."""
    k1 = twa._long_lib("window_attention_f32")
    k4 = twa._long_lib("window_attention_heads_f32")
    k2 = twa._long_lib("window_attention_bwd_tf32")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for hd in (8, 16, 32, 64):
        for N in (49, 144, 324, 352):
            for warps in range(1, twa._F32_MAX_WARPS + 1):
                assert k1.fiber_window_attention_f32_smem_bytes(
                    N, hd, warps) == fwd_smem_bytes(N, hd, warps)
                assert k4.fiber_window_attention_heads_f32_smem_bytes(
                    N, hd, warps) == fwd_smem_bytes(N, hd, warps)
                assert k2.fiber_window_attention_bwd_tf32_smem_bytes(
                    N, hd, warps, 0) == rows_smem_bytes(N, hd, warps)
                assert k2.fiber_window_attention_bwd_tf32_smem_bytes(
                    N, hd, warps, 1) == cols_smem_bytes(hd)
            occ = twa._f32_occupancy("window_attention_f32", N, hd, 0)
            assert twa._f32_plan(2, 4, 4, N, hd, sms, occ)[2] >= 1
            assert twa._bwd_f32_card_plan(2, 4, 4, N, hd, cuda)[0] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("N", [49, 144, 324])
def test_tc_f32_occupancy_model_is_the_cards(cuda, N):
    """At hd = 32, the head dim of every model path, the occupancy API
    gives K1's and K2's kernels, for every width, the blocks an SM the CPU
    model gives: the CPU cases' plans are the card's.  K4's kernel is the
    same at N > 64; at N <= 64 it takes fewer registers than K1's and an
    SM holds at least the model's blocks (on an H100 more: 10 of 2 warps
    where the model says 8)."""
    assert twa._f32_occupancy("window_attention_f32", N, 32, 0) == \
        fwd_occupancy(N, 32)
    k4 = twa._f32_occupancy("window_attention_heads_f32", N, 32, 0)
    if N > 64:
        assert k4 == fwd_occupancy(N, 32)
    else:
        assert all(a >= b for a, b in zip(k4, fwd_occupancy(N, 32)))
    assert (twa._f32_occupancy("window_attention_bwd_tf32", N, 32, 0, 0),
            twa._f32_occupancy("window_attention_bwd_tf32", N, 32, 0, 1)) \
        == bwd_occupancy(N, 32)


@pytest.mark.cuda
def test_tc_f32_raises_on_a_misaligned_operand(cuda):
    """A CUDA fp32 tensor launches the kernel or raises: an operand off a
    16-byte boundary raises, with no fallback to the plain version."""
    qkv, bias, _ = _card_inputs((1, 1, 16, 1, 8), cuda, 0)
    flat = torch.empty(qkv.numel() + 1, device=cuda)
    shifted = flat[1:].view(qkv.shape)
    shifted.copy_(qkv)
    with pytest.raises(ValueError, match="16-byte"):
        twa.window_attention(shifted, bias, 1)


# ---- the bf16 long-window K2 check's one-flip bound (chip_smoke.py) --------

def test_k2_flip_bound_takes_the_plain_version_and_refuses_a_wrong_row():
    """`chip_smoke.within_ulp_or_flip_bwd` (the bf16 `k2_check_long`
    bound): the plain backward passes against itself, and a dq / dk / dv
    element moved by its row's largest magnitude does not."""
    import chip_smoke as cs
    B, nW, h, N, hd = 1, 2, 2, 49, 32
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=g).bfloat16()
    bias = torch.randn(nW, h, N, N, generator=g) * 0.1
    dout = torch.randn(B, nW, N, h * hd, generator=g).bfloat16()
    ref, _ = twa.window_attention_bwd_reference(qkv, bias, dout, h)
    assert cs.within_ulp_or_flip_bwd(ref, ref, qkv, bias, dout, h)
    for part in range(3):
        bad = ref.clone()
        col = part * h * hd + 5
        bad[0, 1, 7, col] += bad[0, 1, 7].float().abs().max().bfloat16()
        assert not cs.within_ulp_or_flip_bwd(bad, ref, qkv, bias, dout, h)
