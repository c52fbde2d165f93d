"""K3's fp32 route on the tensor cores ("tc_f32", `csrc/swin_stage_tf32.cu`),
on the CPU: the route rule, the per-product tile plan and shared memory at
the FIBER-Base stages of 384^2 and 576^2, that the kernel's constants are
the plan's and its staged rows feed the fragment reads without bank
conflicts,
a torch model of the split-TF32 product's rounding at K3's reduction
depths (K = 512 ... 4096: chained in one tensor-core accumulator against a
32-deep stage summed apart), and a model of `attend_f32`'s K3 option
against the plain version's attention.  The models are test helpers; the
port never calls them.

The `cuda`-marked cases hold the kernel against its plain version on a
card and skip here.  This file imports neither JAX nor `fiber_tpu`:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_swin_stage_tf32.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fiber_torch.config import FiberConfig
from fiber_torch.models.swin import SwinBlock
from fiber_torch.ops import swin_stage as tss
from fiber_torch.ops import window_attention as twa

torch.set_num_threads(1)

CSRC = Path(tss.__file__).resolve().parent.parent / "csrc"
SRC = (CSRC / "swin_stage_tf32.cu").read_text()
# the fp32 limit of K3 against its plain version, of the output's max-abs
# (chip_smoke.py K3_RTOL; tests/test_torch_kernels.py K3_TOL)
K3_FP32_RTOL = 1e-4


# ---- the route --------------------------------------------------------------

@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("N", [4, 16, 49, 144, 150, 256, 324, 352])
def test_fp32_takes_tc_f32(N, hd):
    """fp32 at every head dim the tensor cores take and every window up to
    the cap runs the split-TF32 kernel; bf16 keeps its two routes."""
    assert tss._k3_route(torch.float32, N, hd) == "tc_f32"
    assert tss._k3_route(torch.bfloat16, N, hd) == (
        "tc" if N <= 144 else "tc_long")


@pytest.mark.parametrize("N", [4, 49, 144, 324])
def test_hd128_stays_on_the_cuda_cores(N):
    for dtype in (torch.float32, torch.bfloat16):
        assert tss._k3_route(dtype, N, 128) == "cuda_core"


def test_route_counts_take_tc_f32():
    assert set(tss.fused_swin_blocks.route_launches) == {
        "tc", "tc_long", "tc_f32", "cuda_core"}


# ---- the plan ---------------------------------------------------------------

BASE = FiberConfig.base()
GRID = 132     # an H100's SMs, one block each (the kernel's occupancy there)


def _stages(size):
    """FIBER-Base's stages at an image size: (H, C, heads, window)."""
    win = 12 if size == 384 else 18
    out = []
    for s in range(4):
        H = size // 4 // 2 ** s
        out.append((H, BASE.stage_dim(s), BASE.swin_num_heads[s], min(win, H)))
    return out


def test_stages():
    assert _stages(384) == [(96, 128, 4, 12), (48, 256, 8, 12),
                            (24, 512, 16, 12), (12, 1024, 32, 12)]
    assert _stages(576) == [(144, 128, 4, 18), (72, 256, 8, 18),
                            (36, 512, 16, 18), (18, 1024, 32, 18)]


@pytest.mark.parametrize("size", [384, 576])
@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("B", [1, 2, 4, 16])
def test_plan_fits_and_covers(size, stage, B):
    """At every FIBER-Base stage, 384^2 and 576^2, B 1-16: each product's
    tile is one of the kernel's and its tiles cover the output on the
    grid's loop; the attention items' row blocks cover the window and the
    splits split the batch; the block's shared memory fits."""
    H, C, h, win = _stages(size)[stage]
    N = win * win
    plan = tss._k3_f32_plan(B, H, H, C, 4 * C, win, h, GRID)
    M = B * H * H
    for name, n_out in (("qkv", 3 * C), ("proj", C), ("fc1", 4 * C),
                        ("fc2", C)):
        BM, BN = plan[name]
        assert (BM, BN) in tss._K3_F32_TILES
        tm, tn = -(-M // BM), -(-n_out // BN)
        seen = {(t % tm, t // tm) for b in range(GRID)
                for t in range(b, tm * tn, GRID)}
        assert len(seen) == tm * tn
    assert plan["rows"] == tss._K3_F32_ROWS
    assert (-(-N // plan["rows"]) - 1) * plan["rows"] < N
    assert 1 <= plan["splits"] <= B
    assert tss._k3_f32_smem_bytes(N, C // h) <= twa._MAX_SMEM


def test_plan_at_the_report_shapes():
    """384^2 stage 3 at B = 4 (M = 2304): qkv on 216 tiles of 128 x 128 in
    two waves; proj and fc2 on 96 tiles of 96 x 128 in one wave (128 x 128
    would leave 60 of the 132 blocks idle), fc1 on 384 in three.  576^2
    stage 3 at B = 2 (M = 2592): proj and fc2 on 108 tiles of 96 x 128.
    The attention's 192 and 384 items of 64 rows in 2 and 1 splits."""
    big, tall = (128, 128), (96, 128)
    assert tss._k3_f32_plan(4, 24, 24, 512, 2048, 12, 16, GRID) == dict(
        qkv=big, proj=tall, fc1=tall, fc2=tall, rows=64, splits=2)
    assert tss._k3_f32_plan(2, 36, 36, 512, 2048, 18, 16, GRID) == dict(
        qkv=big, proj=tall, fc1=big, fc2=tall, rows=64, splits=1)
    assert tss._k3_tile_bytes((96, 128), tss._K3_F32_WARPS) == 27648


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
def test_every_shape_fits_a_block(hd):
    """The products' shared memory and attend_f32's staging fit a block at
    every N the route takes: 147,456 bytes, attend_f32's 210,432 at hd =
    64 beyond N = 256."""
    sizes = [tss._k3_f32_smem_bytes(N, hd) for N in range(1, 353)]
    assert max(sizes) <= twa._MAX_SMEM
    assert min(sizes) == tss._K3_F32_GEMM_SMEM == 147456
    assert tss._k3_f32_smem_bytes(324, 64) == 210432


# ---- the kernel's constants and layout ----------------------------------------

def _constant(name, src=SRC):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _function(name, src=SRC, **consts):
    """The one-line return expression of a device function of the source,
    as Python evaluates it (the same operators on non-negative ints), with
    the source's constants `consts`."""
    body = re.search(rf"int {name}\((.*?)\) \{{\n\s*return (.*?);\n\}}", src,
                     re.S)
    args = [a.split()[-1] for a in body.group(1).split(",")]
    return eval(f"lambda {', '.join(args)}: {body.group(2)}", consts)


def test_constants_are_the_plans():
    """kF32BK, kF32Stages and the largest tile give the plan's ring; the
    attention rows are attend_f32's 8 warps of 8 rows; the tile table is
    the bf16 kernel's and 96 x 128, in the plan's order (the kernel takes
    indices into it), with the plan's warp layouts."""
    f32 = (CSRC / "window_attention_f32.cuh").read_text()
    bk, stages = _constant("kF32BK"), _constant("kF32Stages")
    assert "constexpr int kRawF = kF32BK + 4;" in SRC
    assert (128 + 128) * stages * (bk + 4) * 4 == tss._K3_F32_GEMM_SMEM
    body = re.search(r"kF32Tiles\[4\]\[2\] = \{(.*?)\};", SRC, re.S).group(1)
    assert re.findall(r"kTiles\[(\d)\]\[0\], kTiles\[\d\]\[1\]", body) == \
        ["0", "1", "2"]
    assert tss._K3_F32_TILES == tss._K3_TILES + (tuple(
        int(v) for v in re.search(r"\{(\d+), (\d+)\}", body).groups()),)
    assert _constant("kF32RowsWarp", f32) * _constant(
        "kF32FwdMaxWarps", f32) == tss._K3_F32_ROWS
    warps = re.findall(r"(?:case \d|default): gemm_f32_phase<kF32Tiles\[(\d)\]"
                       r"\[0\], kF32Tiles\[\d\]\[1\], (\d), (\d), EPI>", SRC)
    assert {tss._K3_F32_TILES[int(i)]: (int(a), int(b))
            for i, a, b in warps} == tss._K3_F32_WARPS
    chunks = re.search(r"return N <= 64 \? 2 : N <= 160 \? 5 : N <= 256 \? 8 "
                       r": 11;", f32)
    assert chunks and [tss._k3_f32_key_chunks(N) for N in (64, 65, 160, 161,
                       256, 257, 352)] == [2, 5, 5, 8, 8, 11, 11]


def test_staged_rows_feed_the_fragments():
    """The ring's rows of kRawF = kF32BK + 4 floats: each 16-byte cp.async
    lands aligned, and a warp's fragment reads of a k8 step (thread (g, c):
    rows g (and g + 8), values 8 kk + c and 8 kk + c + 4) hit 32 distinct
    banks, for A's 16-row and W's 8-row fragments alike."""
    bk = _constant("kF32BK")
    raw_f = bk + 4
    assert (raw_f * 4) % 16 == 0
    for kk in range(bk // 8):
        for hi in (0, 4):
            for base in (0, 8, 16, 40):
                banks = {((base + g) * raw_f + 8 * kk + c + hi) % 32
                         for g in range(8) for c in range(4)}
                assert len(banks) == 32
    fragment = re.search(r"a\[mi\]\.set\(r\[0\], r\[8 \* kRawF\], r\[4\], "
                         r"r\[8 \* kRawF \+ 4\]\)", SRC)
    assert fragment, "A's fragment: rows g, g + 8; values c, c + 4"


def test_phase_timer_build_is_a_library_of_its_own():
    """`tf32_phase_ms`'s build: the same source with FIBER_K3_PHASE_TIMES
    defined, under a library name of its own, whose kernel marks each of
    the seven phases and exports the times; the plain build has neither."""
    from fiber_torch.kernels import _build
    src, flags = _build._source_and_flags(tss._TF32_TIMED)
    assert src == CSRC / "swin_stage_tf32.cu"
    assert flags == [*_build.NVCC_FLAGS, "-DFIBER_K3_PHASE_TIMES"]
    assert _build._source_and_flags(tss._TF32) == (src, list(_build.NVCC_FLAGS))
    assert _build._target(tss._TF32_TIMED).name.startswith(
        "libswin_stage_tf32_FIBER_K3_PHASE_TIMES_")
    assert SRC.count("#ifdef FIBER_K3_PHASE_TIMES") == 2
    marks = [int(m) for m in re.findall(r"clock\.mark\((\d)\);", SRC)]
    assert marks == list(range(len(tss.K3_F32_PHASES)))


# ---- the split-TF32 product, modelled ------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 to nearest, ties away (`cvt.rna.tf32.f32`)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def rz32(x64: torch.Tensor) -> torch.Tensor:
    """fp64 rounded toward zero to fp32: a tensor core's write of its sum."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def product(a: torch.Tensor, b: torch.Tensor, stage: int) -> torch.Tensor:
    """a @ b as three TF32 products a k8 step (small . big, big . small,
    big . big), each step's eight products exact and their sum with the
    accumulator rounded toward zero.  stage = 0 chains every step into one
    accumulator; stage = S sums each S-deep stage from zero and adds it
    into an fp32 accumulator to nearest, as the kernel does (S = kF32BK)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    part = acc
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            part = rz32(part.double() + x[:, s].double() @ y[s].double())
        if stage and (k + 8) % stage == 0:
            acc, part = acc + part, torch.zeros_like(acc)
    return part if not stage else acc


@pytest.mark.parametrize("K", [512, 1024, 2048, 4096])
def test_stage_sums_keep_fp32_accuracy(K):
    """At K3's reduction depths (C = 512 and 1024 for qkv, proj, fc1; 4C =
    2048 and 4096 for fc2 at FIBER-Base's stages 3 and 4) operands drawn as
    K3 sees them (LayerNorm rows, weights of 0.02 N(0, 1)): a 32-deep
    stage from zero, added to nearest, stays within twice the plain fp32
    product's own error of fp64; one accumulator chained over the whole
    reduction drifts toward zero, past 4x that at every depth (5e-5 of the
    max-abs at K = 4096, half the K3 limit)."""
    g = torch.Generator().manual_seed(K)
    a = torch.randn(64, K, generator=g)
    b = 0.02 * torch.randn(K, 64, generator=g)
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    err = lambda o: (o.double() - exact).abs().max().item() / scale
    plain = err(a @ b)
    staged = err(product(a, b, _constant("kF32BK")))
    chained = err(product(a, b, 0))
    assert staged <= max(2 * plain, 1e-6), (staged, plain)
    assert chained > 4 * max(staged, plain), (chained, staged)
    assert staged <= K3_FP32_RTOL / 100


# ---- attend_f32's K3 option, modelled ------------------------------------------

def attend_f32_k3(qkv, rpb, mask, h):
    """attend_f32 with K3 = true, for every row: the logits a chain of fp32
    multiply-adds over the head dim, times hd^-1/2, plus rpb, plus the mask
    row; the row's max, exp(logit - max), their sum, p = e / sum; the
    output a chain of p_j v_j over the keys in order."""
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // h
    q, k, v = (t.reshape(B, nW, N, h, hd).transpose(2, 3)
               for t in qkv.split(C, -1))
    s = torch.zeros(B, nW, h, N, N)
    for d in range(hd):
        s = s + q[..., d, None] * k[..., None, :, d]
    s = s * np.float32(hd ** -0.5)
    s = s + rpb
    if mask is not None:
        s = s + mask[:, None]
    e = torch.exp(s - s.max(-1, keepdim=True).values)
    p = e / e.sum(-1, keepdim=True)
    out = torch.zeros(B, nW, h, N, hd)
    for j in range(N):
        out = out + p[..., j, None] * v[..., None, j, :]
    return out.transpose(2, 3).reshape(B, nW, N, C)


@pytest.mark.parametrize("N,shifted", [(144, True), (324, True), (49, False)])
def test_attend_f32_k3_option_is_the_plain_attention(N, shifted):
    """The K3 option's order of operations (scale after the product, bias
    then mask) gives the plain version's attention (`_attention_reference`)
    within 1e-6 of its max-abs: fp32 summation order apart, one function."""
    rng = np.random.default_rng(N)
    B, nW, h, hd = 2, 2, 2, 32
    qkv = torch.from_numpy(rng.standard_normal((B, nW, N, 3 * h * hd))
                           .astype(np.float32))
    rpb = torch.from_numpy(0.5 * rng.standard_normal((h, N, N))
                           .astype(np.float32))
    mask = (torch.from_numpy(-100.0 * (rng.random((nW, N, N)) < 0.3)
                             .astype(np.float32)) if shifted else None)
    want = tss._attention_reference(qkv, rpb, mask, h)
    got = attend_f32_k3(qkv, rpb, mask, h)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-6 * scale


# ---- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stack(shape, device, seed):
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
                        0.5 * r if "bias_table" in name else 0.05 * r)
    x = torch.randn(B, H, W, C, generator=gen).to(device)
    return x, tss.stack_stage([b.to(device) for b in blocks], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 24, 24, 128, 4, 12, 2),
                                   (1, 36, 36, 64, 2, 18, 2)],
                         ids=["N144", "N324"])
def test_tc_f32_two_calls_give_the_same_bits(cuda, shape):
    x, st = _stack(shape, cuda, 5)
    before = tss.fused_swin_blocks.route_launches["tc_f32"]
    with torch.inference_mode():
        a, b = st(x), st(x)
        ref = tss.fused_swin_blocks_reference(x, st.params, st.mask,
                                              st.window, st.num_heads,
                                              st.use_shift)
    torch.cuda.synchronize()
    assert tss.fused_swin_blocks.route_launches["tc_f32"] == before + 2
    assert torch.equal(a, b)
    err = (a - ref).abs().max().item()
    assert err <= K3_FP32_RTOL * ref.abs().max().item()


@pytest.mark.cuda
def test_tc_f32_layout_is_the_kernels(cuda):
    """The kernel's shared memory is the plan's model of it at every head
    dim and key-chunk count, and the card holds a block of each."""
    lib = tss._tf32_lib()
    for hd in (8, 16, 32, 64):
        for N in (16, 64, 65, 144, 161, 256, 257, 324, 352):
            assert lib.fiber_fused_swin_blocks_tf32_smem_bytes(N, hd) == \
                tss._k3_f32_smem_bytes(N, hd)
            assert tss.tf32_attrs(N, hd)["blocks_per_sm"] >= 1
    assert lib.fiber_fused_swin_blocks_tf32_smem_bytes(353, 32) == -1
    assert lib.fiber_fused_swin_blocks_tf32_smem_bytes(144, 128) == -1


@pytest.mark.cuda
def test_tc_f32_phase_times(cuda):
    """The phase-timer build runs the op's launch and reads back a
    positive device time for each of the seven phases."""
    x, st = _stack((2, 24, 24, 128, 4, 12, 2), cuda, 6)
    with torch.inference_mode():
        st(x)
        ms = tss.tf32_phase_ms(lambda: st(x), cuda)
    assert list(ms) == list(tss.K3_F32_PHASES)
    assert all(v > 0 for v in ms.values())
