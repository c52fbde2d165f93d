"""The long-window attention routine's order of work (attend_long_rows in
`fiber_torch/csrc/window_attention_tc_long.cuh`, which K1, K3 and K4 run
at 144 < N <= 352), emulated in numpy, for the CPU tests of those
routes."""

import numpy as np

LOG2E = np.float32(1.4426950408889634)


def bf16(x):
    """x rounded to the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def fma_exp2(s, ml):
    """exp2f(fmaf(s, log2e, -ml)) in float32."""
    with np.errstate(invalid="ignore"):
        x = (s.astype(np.float64) * np.float64(LOG2E) - ml).astype(np.float32)
    return np.exp2(x).astype(np.float32)


def fma32(a, b, c):
    """fmaf(a, b, c) in float32: the exact product and sum, rounded once."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def two_pass_emulated(q, k, v, bias, scale, parts, scale_after=False):
    """The long-window routine (attend_long_rows) on one (batch, window,
    head): q, k, v (N, hd) bf16 values as float32, bias (N, N) fp32 as
    staged.  Keys padded to NP (16), hd to 16; S = bias + round(q * scale)
    . K^T (K1's and K4's rounding), or with `scale_after` (K3's) S =
    fp32(fp32(q . K^T) * scale) + bias, the accumulators from 0; -inf on
    padded keys, 0 on padded rows.  The NP
    / 16 tile pairs are cut into `parts` runs (part p: pairs [p n / P,
    (p + 1) n / P)); in pass 1 each part runs as the kernel's lanes do:
    lane c of a row's quad takes columns 2c, 2c + 1 of each n8 tile, 8
    tiles (64 keys) a step from the run's start, the last step the tiles
    left; per step the max t of its values, the running sum l rescaled by
    exp2((m - t) log2e) when t > m, then the step's exponentials added tile
    by tile (each tile's pair first) and the step's sum added to l; the
    quad's max and sum of l exp2((m - max) log2e).  With more than one
    part, M is the parts' max and L the sum over p of L_p exp2((M_p - M)
    log2e), fmaf in the order of the parts.  Pass 2: p = exp2(s log2e -
    M log2e) * (1 / L), rounded; each part's P.V in fp32, summed over the
    parts in order, rounded."""
    N, hd = q.shape
    NP, HP = -(-N // 16) * 16, max(hd, 16)
    NT, pairs = NP // 8, NP // 16
    pad = lambda x: np.pad(x, ((0, NP - N), (0, HP - hd)))
    qs, ks, vs = pad(q), pad(k), pad(v)
    s = np.zeros((NP, NP), np.float32)
    s[:N, :N] = bias
    s[:, N:] = -np.inf
    if scale_after:
        prod = ((qs @ ks.T).astype(np.float32) * np.float32(scale)).astype(
            np.float32)
        s = (prod + s).astype(np.float32)
    else:
        s = (s + bf16(qs * np.float32(scale)) @ ks.T).astype(np.float32)
    # (row, lane c, tile, pair element)
    lanes = s.reshape(NP, NT, 4, 2).transpose(0, 2, 1, 3)
    runs = [(2 * (p * pairs // parts), 2 * ((p + 1) * pairs // parts))
            for p in range(parts)]
    stats = []
    for t_begin, t_end in runs:
        m = np.full((NP, 4), -np.inf, np.float32)
        l = np.zeros((NP, 4), np.float32)
        for t0 in range(t_begin, t_end, 8):
            vals = lanes[:, :, t0:min(t0 + 8, t_end)]    # row, c, tile, pair
            t = vals.max((-1, -2))
            grow = t > m
            with np.errstate(invalid="ignore", over="ignore"):
                resc = np.exp2(((m - t) * LOG2E).astype(np.float32))
            l = np.where(grow, (l * resc).astype(np.float32), l)
            m = np.where(grow, t, m)
            e = fma_exp2(vals, (m * LOG2E)[..., None, None].astype(np.float64))
            add = np.zeros((NP, 4), np.float32)
            for u in range(vals.shape[2]):
                add = (add + (e[:, :, u, 0] + e[:, :, u, 1])).astype(np.float32)
            l = np.where(m > -np.inf, (l + add).astype(np.float32), l)
        Mp = m.max(-1)
        with np.errstate(invalid="ignore"):
            w = (l * np.exp2(((m - Mp[:, None]) * LOG2E).astype(np.float32))
                 ).astype(np.float32)
        w = np.where(m > -np.inf, w, np.float32(0))
        stats.append((Mp, (w[:, 0] + w[:, 1]) + (w[:, 2] + w[:, 3])))
    if parts == 1:
        M, L = stats[0]
    else:
        M = np.max([Mp for Mp, _ in stats], axis=0)
        L = np.zeros(NP, np.float32)
        for Mp, Lp in stats:
            L = fma32(Lp, np.exp2(((Mp - M) * LOG2E).astype(np.float32)), L)
    inv = (np.float32(1) / L).astype(np.float32)
    p = bf16((fma_exp2(s, (M * LOG2E).astype(np.float32)[:, None]
                         .astype(np.float64)) * inv[:, None]).astype(np.float32))
    out = np.zeros((NP, HP), np.float32)
    for t_begin, t_end in runs:
        keys = slice(8 * t_begin, 8 * t_end)
        out = (out + (p[:, keys] @ vs[keys]).astype(np.float32)).astype(
            np.float32)
    return bf16(out)[:N, :hd]
