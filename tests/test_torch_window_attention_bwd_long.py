"""K2 at the long windows (FIBER's 18 x 18 windows at 576^2, N = 324), on
the CPU: the route rule `_bwd_route` around the whole-tile kernels' limits,
the plans of the bf16 row and column kernels
(`csrc/window_attention_bwd_tc_long.cu`) and of the fp32 ones
(`csrc/window_attention_bwd.cu`) at the FIBER-Base 576^2 stages, and a
numpy emulation of the bf16 kernels' order of work (the row statistics and
D = rowsum(dP * P) in 64-key blocks taken in turn by the row kernel's
parts, dq summed block by block and then over the parts, P from the
statistics in the column kernel with dk and dv summed over 64-row query
blocks, the fixed-order sum of the dbias splits) against the plain
backward in bf16.
The kernels themselves are held against the plain backward on a CUDA
device in tests/test_torch_kernels.py.  No JAX here."""

import numpy as np
import pytest
import torch

from fiber_torch.config import task_finetune_vqa
from fiber_torch.ops import window_attention as twa

torch.set_num_threads(1)

SMS = 132                                   # an H100 SXM
VQA = task_finetune_vqa()
STAGES_576 = [((VQA.stage_resolution(s)[0] // VQA.derived_window_size) ** 2,
               VQA.swin_num_heads[s]) for s in range(4)]


@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [144, 145, 256, 324, 352, 353])
def test_bwd_route(N, dtype, hd):
    """bf16: the whole-tile kernel where N <= 144 and its tiles fit (not
    hd = 64 or 128 at N = 144), the long-window kernels for hd <= 64 up to
    N = 352, and a ValueError for hd = 128 beyond the whole tiles.  fp32:
    the split-TF32 row and column kernels for hd <= 64 up to N = 352; at
    hd = 128 the whole-tile kernel where its (N, N) tiles fit, the
    long-window kernels where K and V fit (not beyond N = 195).  Every
    dtype raises beyond N = 352."""
    if N > 352:
        with pytest.raises(ValueError):
            twa._bwd_route(dtype, N, hd)
        return
    if dtype == torch.bfloat16:
        if N <= 144 and hd <= 32:
            assert twa._bwd_route(dtype, N, hd) == "tc"
        elif hd <= 64:
            assert twa._bwd_route(dtype, N, hd) == "tc_long"
        else:
            with pytest.raises(ValueError, match="bf16 at hd=128"):
                twa._bwd_route(dtype, N, hd)
    elif hd <= 64:
        assert twa._bwd_route(dtype, N, hd) == "tc_f32"
    else:
        if N <= 145 and hd <= 32:
            assert twa._bwd_route(dtype, N, hd) == "cuda_core"
        elif hd <= 64 or N <= 195:
            assert twa._bwd_route(dtype, N, hd) == "cuda_core_long"
        else:
            with pytest.raises(ValueError, match="shared memory"):
                twa._bwd_route(dtype, N, hd)


def test_bwd_route_limits_are_the_kernels():
    """The whole-tile limits the rule reads are the kernels' layouts: the
    bf16 kernel's 221,184 bytes at N = 144, hd = 32 (its source's count),
    and the fp32 whole-tile kernel's limit below N = 256 at hd = 32; the
    fp32 long-window kernels take hd = 128 up to N = 195."""
    assert twa._bwd_tc_smem_bytes(144, 32) == 221184
    assert twa._bwd_tc_smem_bytes(144, 64) > twa._MAX_SMEM
    assert twa._bwd_smem_bytes(144, 32) <= twa._MAX_SMEM
    assert twa._bwd_smem_bytes(256, 32) > twa._MAX_SMEM
    assert twa._bwd_long_smem_bytes(195, 128) <= twa._MAX_SMEM
    assert twa._bwd_long_smem_bytes(196, 128) > twa._MAX_SMEM
    assert twa._bwd_route(torch.float32, 195, 128) == "cuda_core_long"


def test_576_stages():
    assert VQA.derived_window_size == 18
    assert STAGES_576 == [(64, 4), (16, 8), (4, 16), (1, 32)]


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("B", [1, 4, 8, 24])
def test_bwd_long_plan_at_the_576_stages(B, stage):
    """Each kernel's block fits Hopper's shared memory and an SM, and each
    split S is within 1/8 of the fewest waves x batch elements a block over
    its own grid.  At N = 324, hd = 32 the row kernel takes 64 rows on two
    consumer warpgroups with each element's K and V resident (stages 0),
    the column kernel 64 keys and 2 stages (two blocks an SM)."""
    nW, h = STAGES_576[stage]
    N, hd = 324, 32
    R, parts, stages, S, Rc, Sc, col_stages = twa._bwd_long_plan(
        B, nW, h, N, hd, SMS)
    assert (R, parts, stages, Rc, col_stages) == (64, 2, 0, 64, 2)
    for rows, warps, splits, smem, cap in (
            (R, 4 * parts + 1, S,
             twa._bwd_rows_smem_bytes(N, hd, parts, stages), 1),
            (Rc, Rc // 16 + 1, Sc,
             twa._bwd_cols_smem_bytes(N, hd, Rc, col_stages), 128 // Rc)):
        per_sm = min(twa._resident(smem, warps), cap)
        assert smem <= twa._MAX_SMEM and per_sm >= 1
        assert 1 <= splits <= B
        units = nW * h * -(-N // rows)
        cost = lambda s: -(-units * s // (SMS * per_sm)) * -(-B // s)
        assert 8 * cost(splits) <= 9 * min(cost(s) for s in range(1, B + 1))
    S32 = twa._bwd_fp32_long_plan(B, nW, h, N, hd, SMS)
    assert 1 <= S32 <= B
    assert twa._bwd_long_smem_bytes(N, hd) <= twa._MAX_SMEM


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
def test_every_long_window_has_a_bwd_plan(hd):
    """Every window the route sends to "tc_long" (N = 144 at hd = 64, and
    145 ... 352) has a plan whose two blocks fit Hopper's 232,448 bytes:
    two parts wherever they fit (not at hd = 64 past N = 336), each
    element's K and V resident in the row kernel wherever they fit, else
    a ring of 2 to 4 stages, and no more column stages than two elements'
    query blocks."""
    for N in list(range(145, twa._LONG_MAX_N + 1, 7)) + [144, 352]:
        R, parts, stages, S, Rc, Sc, col_stages = twa._bwd_long_plan(
            8, 4, 16, N, hd, SMS)
        assert R == 64 and Rc in (64, 128)
        assert twa._bwd_rows_smem_bytes(N, hd, parts, stages) <= \
            twa._MAX_SMEM
        assert twa._bwd_cols_smem_bytes(N, hd, Rc, col_stages) <= \
            twa._MAX_SMEM
        assert parts == (1 if hd == 64 and N > 336 else 2)
        fits = twa._bwd_rows_smem_bytes(N, hd, parts, 0) <= twa._MAX_SMEM
        assert (stages == 0) == fits
        assert stages == 0 or 2 <= stages <= 4
        assert 2 <= col_stages <= 4
        assert col_stages <= 2 * -(-N // 64)
        assert 1 <= S <= 8 and 1 <= Sc <= 8


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("hd", [8, 16, 32, 64])
def test_bwd_long_plans_fit_hopper(stage, hd):
    """At each 576^2 stage and head dim, for every long N, every (parts,
    stages) the row kernel may take and every (Rc, stages) of the column
    kernel is priced by the layout functions, and the plan's pair is one
    that fits a block and an SM; a block past 232,448 bytes is never
    planned."""
    nW, h = STAGES_576[stage]
    for N in range(145, twa._LONG_MAX_N + 1):
        R, parts, stages, S, Rc, Sc, col_stages = twa._bwd_long_plan(
            8, nW, h, N, hd, SMS)
        # the row kernel's choices in the plan's order of preference
        order = [(p, st) for p in (2, 1) for st in (0, 4, 3, 2)]
        rows = {c: twa._bwd_rows_smem_bytes(N, hd, *c) for c in order}
        cols = {(w, st): twa._bwd_cols_smem_bytes(N, hd, w, st)
                for w in (64, 128) for st in (2, 3, 4)}
        assert rows[(parts, stages)] <= twa._MAX_SMEM
        assert cols[(Rc, col_stages)] <= twa._MAX_SMEM
        assert (parts, stages) == next(c for c in order
                                       if rows[c] <= twa._MAX_SMEM)


def test_bwd_layouts():
    """The row kernel's layout at N = 324, hd = 32, two parts, 4 stages:
    128 bytes of barriers, its bias and dbias rows (64 x 344 fp32 each), 4
    stages of a key block's K and V (64 x 32 bf16 each, the core layout),
    two (max, sum, dot) a row and one dq accumulator (64 x 32 fp32); the
    column kernel's at Rc = 128, 4 stages: barriers, its keys' bias
    columns for every query row (336 x 132 fp32), the two warpgroups' q~
    (64 x 32 each), four stages of 64 query rows of q and dO and 64 rows
    of statistics."""
    assert twa._bwd_rows_smem_bytes(324, 32, 2, 4) == (
        128 + 2 * 64 * 344 * 4 + 4 * 2 * 64 * 32 * 2 + 2 * 64 * 16
        + 64 * 32 * 4) == 219264
    assert twa._bwd_rows_smem_bytes(324, 32, 2, 4) <= twa._MAX_SMEM
    # with the element's K and V resident: 336 rows each for the 4 stages
    assert twa._bwd_rows_smem_bytes(324, 32, 2, 0) == (
        128 + 2 * 64 * 344 * 4 + 2 * 336 * 32 * 2 + 2 * 64 * 16
        + 64 * 32 * 4) == 229504
    assert twa._bwd_rows_smem_bytes(324, 64, 1, 0) > twa._MAX_SMEM
    assert twa._bwd_rows_smem_bytes(352, 64, 2, 2) > twa._MAX_SMEM
    assert twa._bwd_rows_smem_bytes(352, 64, 1, 2) <= twa._MAX_SMEM
    assert twa._bwd_cols_smem_bytes(324, 32, 128, 4) == (
        128 + 336 * 132 * 4 + 2 * 64 * 32 * 2
        + 4 * (2 * 64 * 32 * 2 + 64 * 16)) == 222592


# ---- the kernels' order of work, emulated in numpy ----------------------

LOG2E = np.float32(1.4426950408889634)


def _bf16(x):
    """x rounded to the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _exp2_fma(s, ml):
    """exp2f(fmaf(s, log2e, -ml)) in float32."""
    with np.errstate(invalid="ignore"):
        x = (s.astype(np.float64) * np.float64(LOG2E) - ml).astype(np.float32)
    return np.exp2(x).astype(np.float32)


def _fma32(a, b, c):
    """fmaf(a, b, c) in float32: the exact product and sum, rounded once."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _row_stats(s, dp, parts):
    """The row kernel's pass A on (NP, NP) logits s (-inf on padded keys)
    and dP.  The keys come in blocks of 64 (8 n8 tiles, fewer in the
    last), block kb to part kb % parts, each part its blocks in order; lane
    c of a row's quad takes columns 2c, 2c + 1 of each tile; per block the
    max t, l and g rescaled by exp2((m - t) log2e) when t > m, then per
    tile the pair's exponentials added to the block's sum and fmaf'd with
    dP into its dot; the quad's max M_p and the sums of l and g times
    exp2((m - M_p) log2e).  M is the parts' max and L and G the sums over
    p of L_p and G_p times exp2((M_p - M) log2e), fmaf in the order of the
    parts.  Returns M, 1 / L and D = G / L."""
    NP = s.shape[0]
    NT = NP // 8
    ls = s.reshape(NP, NT, 4, 2).transpose(0, 2, 1, 3)
    ld = dp.reshape(NP, NT, 4, 2).transpose(0, 2, 1, 3)
    quad = lambda x: (x[:, 0] + x[:, 1]) + (x[:, 2] + x[:, 3])
    blocks = range(0, NT, 8)
    stats = []
    for part in range(parts):
        m = np.full((NP, 4), -np.inf, np.float32)
        l = np.zeros((NP, 4), np.float32)
        g = np.zeros((NP, 4), np.float32)
        for t0 in blocks[part::parts]:
            vals = ls[:, :, t0:t0 + 8]
            dv = ld[:, :, t0:t0 + 8]
            t = vals.max((-1, -2))
            grow = t > m
            with np.errstate(invalid="ignore", over="ignore"):
                r = np.exp2(((m - t) * LOG2E).astype(np.float32))
                l = np.where(grow, (l * r).astype(np.float32), l)
                g = np.where(grow, (g * r).astype(np.float32), g)
            m = np.where(grow, t, m)
            e = _exp2_fma(vals, (m * LOG2E)[..., None, None].astype(np.float64))
            add = np.zeros((NP, 4), np.float32)
            dot = np.zeros((NP, 4), np.float32)
            for u in range(vals.shape[2]):
                add = (add + (e[:, :, u, 0] + e[:, :, u, 1])).astype(np.float32)
                inner = _fma32(e[:, :, u, 1], dv[:, :, u, 1], dot)
                dot = _fma32(e[:, :, u, 0], dv[:, :, u, 0], inner)
            live = m > -np.inf
            l = np.where(live, (l + add).astype(np.float32), l)
            g = np.where(live, (g + dot).astype(np.float32), g)
        Mp = m.max(-1)
        with np.errstate(invalid="ignore"):
            r = np.exp2(((m - Mp[:, None]) * LOG2E).astype(np.float32))
        r = np.where(m > -np.inf, r, np.float32(0))
        stats.append((Mp, quad((l * r).astype(np.float32)),
                      quad((g * r).astype(np.float32))))
    M = np.max([Mp for Mp, _, _ in stats], axis=0)
    L = np.zeros(NP, np.float32)
    G = np.zeros(NP, np.float32)
    for Mp, Lp, Gp in stats:
        with np.errstate(invalid="ignore"):
            e = np.exp2(((Mp - M) * LOG2E).astype(np.float32))
        L, G = _fma32(Lp, e, L), _fma32(Gp, e, G)
    inv = (np.float32(1) / L).astype(np.float32)
    return M, inv, (G * inv).astype(np.float32)


def _blocked(a, b, step):
    """a . b summed in fp32 over blocks of `step` of the inner axis, in
    order: the wgmma accumulators across the ring's blocks."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], step):
        out = (out + (a[:, k0:k0 + step] @ b[k0:k0 + step]).astype(np.float32)
               ).astype(np.float32)
    return out


def _bwd_emulated(qkv, bias, dout, h, splits, parts):
    """The bf16 long-window K2 on (B, 1, N, 3C) qkv, (1, h, N, N) bias and
    dout, bf16 values as float32: per (element, head) the row kernel's
    S = bias + round(q * scale) . K^T and dP = dO . V^T (fp32), its
    statistics on `parts` consumer warpgroups, P = exp2(s log2e - M log2e)
    * (1 / L), dS = P (dP - D), dq = round(scale round(dS) . K) (each
    part's 64-key blocks summed in fp32 in order, then the parts in
    order); the column kernel's dv = round(round(P)^T . dO) and dk =
    round(scale round(dS)^T . q), each summed over 64-row query blocks in
    order; dbias summed over each split's elements in order, then over the
    splits in order."""
    B, _, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // h
    scale = np.float32(hd ** -0.5)
    NP = -(-N // 16) * 16
    dqkv = np.zeros_like(qkv)
    dbias = np.zeros((1, h, N, N), np.float32)
    bounds = [s * B // splits for s in range(splits + 1)]
    for head in range(h):
        sl = lambda x, i: np.pad(x[..., i * C + head * hd:i * C + (head + 1) * hd],
                                 ((0, NP - N), (0, 0)))
        split_sums = []
        for s in range(splits):
            acc = np.zeros((NP, NP), np.float32)
            for b in range(bounds[s], bounds[s + 1]):
                x = qkv[b, 0]
                q, k, v = sl(x, 0), sl(x, 1), sl(x, 2)
                do = np.pad(dout[b, 0, :, head * hd:(head + 1) * hd],
                            ((0, NP - N), (0, 0)))
                st = np.zeros((NP, NP), np.float32)
                st[:N, :N] = bias[0, head]
                st[:, N:] = -np.inf
                st = (st + _bf16(q * scale) @ k.T).astype(np.float32)
                dp = (do @ v.T).astype(np.float32)
                M, inv, D = _row_stats(st, dp, parts)
                p = (_exp2_fma(st, (M * LOG2E).astype(np.float32)[:, None]
                               .astype(np.float64)) * inv[:, None]
                     ).astype(np.float32)
                ds = (p * (dp - D[:, None]).astype(np.float32)).astype(np.float32)
                acc = (acc + ds).astype(np.float32)
                dsr = _bf16(ds)
                cols = slice(head * hd, (head + 1) * hd)
                dq = np.zeros((NP, hd), np.float32)
                for p_ in range(parts):
                    mine = np.zeros((NP, hd), np.float32)
                    for k0 in range(64 * p_, NP, 64 * parts):
                        keys = slice(k0, k0 + 64)
                        mine = (mine + (dsr[:, keys] @ k[keys]).astype(
                            np.float32)).astype(np.float32)
                    dq = (dq + mine).astype(np.float32)
                dqkv[b, 0, :, cols] = _bf16(dq * scale)[:N]
                dqkv[b, 0, :, C:][:, cols] = _bf16(
                    _blocked(dsr.T, q, 64) * scale)[:N]
                dqkv[b, 0, :, 2 * C:][:, cols] = _bf16(
                    _blocked(_bf16(p).T, do, 64))[:N]
            split_sums.append(acc)
        total = split_sums[0]
        for part in split_sums[1:]:
            total = (total + part).astype(np.float32)
        dbias[0, head] = total[:N, :N]
    return dqkv, dbias


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("N,h,hd", [(324, 1, 32), (150, 2, 8), (200, 1, 16)])
def test_bwd_order_matches_the_plain_version(N, h, hd, splits, parts):
    """The row statistics in 64-key blocks, on one or two consumer
    warpgroups, D from them and P recomputed from them column-wise give
    the plain backward's gradients in bf16: dq,
    dk and dv within one ulp at each row's largest magnitude (the products
    sum in fp32 in another order on either side), dbias (fp32, summed over
    the batch and the splits in order) within 1e-5 of its max-abs."""
    B = 3
    rng = np.random.default_rng(N + hd + splits + 10 * parts)
    qkv = _bf16(rng.standard_normal((B, 1, N, 3 * h * hd)))
    dout = _bf16(rng.standard_normal((B, 1, N, h * hd)))
    bias = (rng.standard_normal((1, h, N, N)) * 0.5).astype(np.float32)
    bias += np.where(rng.random((1, 1, N, N)) < 0.3, -100.0, 0.0
                     ).astype(np.float32)
    rq, rb = twa.window_attention_bwd_reference(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(bias),
        torch.from_numpy(dout).bfloat16(), h)
    assert rq.dtype == torch.bfloat16 and rb.dtype == torch.float32
    rq, rb = rq.float().numpy(), rb.numpy()
    gq, gb = _bwd_emulated(qkv, bias, dout, h, splits, parts)
    C = h * hd
    for i in range(3):                      # dq, dk, dv
        ref, got = rq[..., i * C:(i + 1) * C], gq[..., i * C:(i + 1) * C]
        row = np.abs(ref).max(-1, keepdims=True)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(row, 1e-30))) - 7)
        assert (np.abs(got - ref) <= ulp).all(), i
    assert np.abs(gb - rb).max() <= 1e-5 * np.abs(rb).max()


def test_column_rows_hide_the_ring():
    """The column kernel streams its query blocks through a ring fed by a
    producer warp, so the plan counts the consumer warpgroups an SM runs at
    once (blocks x Rc / 64; two 64-key blocks or one 128-key block fit an
    SM's registers), then the blocks, then the stages: at N = 324, hd =
    32, 64 keys in 2 stages and 128 keys in 2 to 4 all give two warpgroups
    an SM (the keys' bias columns take 91 or 177 KB), and two blocks of 64
    keys in 2 stages are taken."""
    smem = lambda Rc, st: twa._bwd_cols_smem_bytes(324, 32, Rc, st)
    groups = {(Rc, st): min(twa._resident(smem(Rc, st), Rc // 16 + 1),
                            128 // Rc) * Rc // 64
              for Rc in (64, 128) for st in (2, 3, 4)}
    assert groups == {(64, 2): 2, (64, 3): 1, (64, 4): 1,
                      (128, 2): 2, (128, 3): 2, (128, 4): 2}
    plan = twa._bwd_long_plan(8, 64, 4, 324, 32, SMS)
    assert (plan[4], plan[6]) == (64, 2)
