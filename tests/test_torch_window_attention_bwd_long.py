"""K2 at the long windows (FIBER's 18 x 18 windows at 576^2, N = 324), on
the CPU: the route rule `_bwd_route` around the whole-tile kernels' limits,
the plans of the bf16 row and column kernels
(`csrc/window_attention_bwd_tc_long.cu`) and of the fp32 ones
(`csrc/window_attention_bwd.cu`) at the FIBER-Base 576^2 stages, and a
numpy emulation of the bf16 kernels' order of work (the row statistics and
D = rowsum(dP * P) in 64-key steps, P from them in the column kernel, the
fixed-order sum of the dbias splits) against the plain backward in bf16.
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
    the whole-tile kernel where its (N, N) tiles fit (N <= 144 at hd <=
    32), the long-window kernels where K and V fit (not hd = 128 beyond
    N = 195).  Every dtype raises beyond N = 352."""
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
    """Each kernel's R fits a block (its shared memory and 16 warps an SM)
    and each split S is within 1/8 of the fewest waves x batch elements a
    block over its own grid.  At N = 324, hd = 32 the row kernel takes 32
    rows on 6 warps a slab (12 warps), its operands double-buffered."""
    nW, h = STAGES_576[stage]
    N, hd = 324, 32
    R, parts, buffers, S, Rc, Sc = twa._bwd_long_plan(B, nW, h, N, hd, SMS)
    assert (R, parts, buffers) == (32, 6, 2)
    for rows, warps, splits, smem in (
            (R, R // 16 * parts, S,
             twa._bwd_rows_smem_bytes(N, hd, R, parts, buffers)),
            (Rc, Rc // 16, Sc, twa._bwd_cols_smem_bytes(N, hd, Rc))):
        assert rows % 16 == 0 and 16 <= rows <= 16 * twa._LONG_MAX_WARPS
        per_sm = twa._resident(smem, warps, twa._LONG_SM_WARPS)
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
    for N in list(range(145, twa._LONG_MAX_N + 1, 7)) + [144, 352]:
        R, parts, buffers, S, Rc, Sc = twa._bwd_long_plan(8, 4, 16, N, hd,
                                                          SMS)
        assert twa._bwd_rows_smem_bytes(N, hd, R, parts, buffers) <= \
            twa._MAX_SMEM
        assert twa._bwd_cols_smem_bytes(N, hd, Rc) <= twa._MAX_SMEM
        assert 1 <= parts <= twa._BWD_LONG_MAX_PARTS
        assert parts == 1 or R // 16 * parts <= twa._LONG_PART_WARPS
        # two buffers wherever they fit; one only for hd = 64 past N = 304
        assert buffers == (1 if hd == 64 and N > 304 else 2)
        assert 1 <= S <= 8 and 1 <= Sc <= 8


def test_bwd_layouts():
    """The row kernel's layout at N = 324, hd = 32, R = 32 on 6 parts: its
    bias and dbias rows (32 x 344 fp32 each), two buffers of K and V (336 x
    40 bf16 each) and q and dO (32 x 40), the exchange of 5 dq
    accumulators (32 x 32 fp32) and 6 (max, sum, dot) a row; the column
    kernel's at Rc = 32: two buffers each of K and V (32 x 40), two stages
    of 64 query rows of q and dO, the 64 x 36 fp32 bias block and 64 rows
    of statistics."""
    assert twa._bwd_rows_smem_bytes(324, 32, 32, 6) == (
        2 * 32 * 344 * 4 + 2 * (2 * 336 * 40 * 2 + 2 * 32 * 40 * 2)
        + 5 * 32 * 32 * 4 + 6 * 32 * 16) == 229376
    assert twa._bwd_rows_smem_bytes(324, 32, 32, 6) <= twa._MAX_SMEM
    assert twa._bwd_rows_smem_bytes(352, 64, 16, 1) > twa._MAX_SMEM
    assert twa._bwd_rows_smem_bytes(352, 64, 16, 1, 1) <= twa._MAX_SMEM
    assert twa._bwd_cols_smem_bytes(324, 32, 32) == (
        4 * 32 * 40 * 2 + 2 * (2 * 64 * 40 * 2 + 64 * 36 * 4 + 64 * 16))


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
    and dP.  The NP / 16 tile pairs are cut into `parts` runs; in each,
    lane c of a row's quad takes columns 2c, 2c + 1 of each n8 tile, 8
    tiles a step from the run's start; per step the max t, l and g
    rescaled by exp2((m - t) log2e) when t > m, then per tile the pair's
    exponentials added to the step's sum and fmaf'd with dP into its dot;
    the quad's max M_p and the sums of l and g times exp2((m - M_p) log2e).
    With more than one part, M is the parts' max and L and G the sums over
    p of L_p and G_p times exp2((M_p - M) log2e), fmaf in the order of the
    parts.  Returns M, 1 / L and D = G / L."""
    NP = s.shape[0]
    NT, pairs = NP // 8, NP // 16
    ls = s.reshape(NP, NT, 4, 2).transpose(0, 2, 1, 3)
    ld = dp.reshape(NP, NT, 4, 2).transpose(0, 2, 1, 3)
    quad = lambda x: (x[:, 0] + x[:, 1]) + (x[:, 2] + x[:, 3])
    runs = [(2 * (p * pairs // parts), 2 * ((p + 1) * pairs // parts))
            for p in range(parts)]
    stats = []
    for t_begin, t_end in runs:
        m = np.full((NP, 4), -np.inf, np.float32)
        l = np.zeros((NP, 4), np.float32)
        g = np.zeros((NP, 4), np.float32)
        for t0 in range(t_begin, t_end, 8):
            vals = ls[:, :, t0:min(t0 + 8, t_end)]
            dv = ld[:, :, t0:min(t0 + 8, t_end)]
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
    if parts == 1:
        M, L, G = stats[0]
    else:
        M = np.max([Mp for Mp, _, _ in stats], axis=0)
        L = np.zeros(NP, np.float32)
        G = np.zeros(NP, np.float32)
        for Mp, Lp, Gp in stats:
            e = np.exp2(((Mp - M) * LOG2E).astype(np.float32))
            L, G = _fma32(Lp, e, L), _fma32(Gp, e, G)
    inv = (np.float32(1) / L).astype(np.float32)
    return M, inv, (G * inv).astype(np.float32)


def _bwd_emulated(qkv, bias, dout, h, splits, parts):
    """The bf16 long-window K2 on (B, 1, N, 3C) qkv, (1, h, N, N) bias and
    dout, bf16 values as float32: per (element, head) the row kernel's
    S = bias + round(q * scale) . K^T and dP = dO . V^T (fp32), its
    statistics on `parts` warps a slab, P = exp2(s log2e - M log2e) *
    (1 / L), dS = P (dP - D), dq = round(scale round(dS) . K) (each part's
    run of keys summed in fp32, then the parts in order); the column
    kernel's dv =
    round(round(P)^T . dO) and dk = round(scale round(dS)^T . q); dbias
    summed over each split's elements in order, then over the splits in
    order."""
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
                pairs = NP // 16
                dq = np.zeros((NP, hd), np.float32)
                for p_ in range(parts):
                    keys = slice(16 * (p_ * pairs // parts),
                                 16 * ((p_ + 1) * pairs // parts))
                    dq = (dq + (dsr[:, keys] @ k[keys]).astype(np.float32)
                          ).astype(np.float32)
                dqkv[b, 0, :, cols] = _bf16(dq * scale)[:N]
                dqkv[b, 0, :, C:][:, cols] = _bf16(
                    (dsr.T @ q).astype(np.float32) * scale)[:N]
                dqkv[b, 0, :, 2 * C:][:, cols] = _bf16(_bf16(p).T @ do)[:N]
            split_sums.append(acc)
        total = split_sums[0]
        for part in split_sums[1:]:
            total = (total + part).astype(np.float32)
        dbias[0, head] = total[:N, :N]
    return dqkv, dbias


@pytest.mark.parametrize("parts", [1, 6])
@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("N,h,hd", [(324, 1, 32), (150, 2, 8), (200, 1, 16)])
def test_bwd_order_matches_the_plain_version(N, h, hd, splits, parts):
    """The row statistics in 64-key steps, on one warp a slab or the
    plan's 6, D from them and P recomputed from them column-wise give the
    plain backward's gradients in bf16: dq,
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
    """The column kernel streams its query blocks through a ring, so the
    plan counts the warps an SM runs at once: at N = 324, hd = 32, Rc = 96
    (2 blocks of 6 warps an SM) costs least, then 48 (3 of 3), 32 (4 of 2)
    and 16 (6 of 1): the order measured on an H100."""
    smem = lambda R: twa._bwd_cols_smem_bytes(324, 32, R)
    per_sm = {R: twa._resident(smem(R), R // 16, twa._LONG_SM_WARPS)
              for R in (16, 32, 48, 96)}
    assert per_sm == {16: 6, 32: 4, 48: 3, 96: 2}
    cost = {R: -(-324 // R) * (R // 16) / min(n * (R // 16),
                                              twa._LONG_PART_WARPS)
            for R, n in per_sm.items()}
    assert cost[96] < cost[48] < cost[32] < cost[16]
    assert twa._ring_rows(324, 32, smem) == (96, 2)
