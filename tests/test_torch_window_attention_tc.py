"""The window-attention forward's tensor-core route (K1's
`csrc/window_attention_tc.cu`, K4's `csrc/window_attention_heads_tc.cu`,
both running `attend_heads_tc` of `csrc/window_attention_tc.cuh`), on the
CPU: the route rule, the batch split of its grid, that every shape the
route takes fits a block, and a numpy emulation of the routine's rounding
steps against the plain version in bf16.  The kernels themselves are held
against the plain version on a CUDA device in tests/test_torch_kernels.py;
the plain version is held against JAX in test_torch_window_attention.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fiber_torch.config import FiberConfig
from fiber_torch.ops import window_attention as twa

torch.set_num_threads(1)

CSRC = Path(twa.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("N", [4, 16, 49, 144])
def test_fwd_route_bf16_tensor_cores(N, hd):
    assert twa._fwd_route(torch.bfloat16, N, hd) == "tc"


@pytest.mark.parametrize("N,hd", [(256, 32), (145, 32), (160, 8), (144, 128),
                                  (49, 128), (256, 128)])
def test_fwd_route_bf16_beyond_the_tiles(N, hd):
    """A slab's logits in registers cap route "tc" at N = 144: beyond it
    (up to N = 352) bf16 takes the long-window tensor-core route; hd = 128
    is built on neither, and runs on the CUDA cores."""
    assert twa._fwd_route(torch.bfloat16, N, hd) == (
        "cuda_core" if hd == 128 else "tc_long")


@pytest.mark.parametrize("N,hd", [(4, 8), (16, 16), (49, 32), (144, 32),
                                  (144, 64), (256, 128)])
def test_fwd_route_fp32_cuda_cores(N, hd):
    """fp32 runs the older CUDA-core kernel at hd = 128 only; at the head
    dims the tensor cores take, the register-tiled route "f32_tiled"."""
    assert twa._fwd_route(torch.float32, N, hd) == (
        "cuda_core" if hd == 128 else "f32_tiled")


def _tc_smem_bytes(N, hd):
    """`attend_tc_smem_bytes`: the fp32 bias tile (NP, NP + 8) and two
    buffers of q, K, V (NP, max(hd, 16) + 8) bf16, NP = N padded to 16."""
    np_ = -(-N // 16) * 16
    a16 = lambda x: -(-x // 16) * 16
    return a16(4 * np_ * (np_ + 8)) + 6 * a16(2 * np_ * (max(hd, 16) + 8))


def test_tc_route_fits_a_block():
    """Every shape the route takes fits a block's shared memory, and the
    route's limits are the kernel's (kTcMaxNP, the head dims it builds)."""
    src = (CSRC / "window_attention_tc.cuh").read_text()
    assert int(re.search(r"kTcMaxNP = (\d+);", src).group(1)) == twa._TC_MAX_N
    takes = re.search(r"bool attend_tc_takes\(int N, int hd\) \{(.*?)\}",
                      src, re.S).group(1)
    assert "N <= kTcMaxNP" in takes
    assert sorted(int(d) for d in re.findall(r"hd == (\d+)", takes)) == \
        list(twa._TC_HEAD_DIMS)
    assert _tc_smem_bytes(144, 32) == 156672
    assert max(_tc_smem_bytes(N, hd) for N in range(1, twa._TC_MAX_N + 1)
               for hd in twa._TC_HEAD_DIMS) == _tc_smem_bytes(144, 64) \
        <= twa._MAX_SMEM


# FIBER-Base 384^2 stages (nW, h) and the splits of K1's (nW h, S) grid on
# 132 SMs with one resident block (shared memory: 156,672 bytes at N =
# 144, hd = 32), by batch
BASE = FiberConfig.base()
STAGES = [((BASE.stage_resolution(s)[0] // BASE.derived_window_size) ** 2,
           BASE.swin_num_heads[s]) for s in range(4)]
SPLITS = {1: (1, 1, 1, 1), 2: (1, 1, 2, 2), 4: (1, 1, 2, 4), 5: (1, 1, 2, 3),
          8: (1, 1, 2, 4), 16: (1, 1, 2, 4), 24: (1, 1, 2, 4),
          64: (1, 1, 2, 4)}


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("B", sorted(SPLITS))
def test_fwd_splits_at_the_base_stages(B, stage):
    nW, h = STAGES[stage]
    S = twa._bwd_splits(B, nW, h, 132, 1)
    assert S == SPLITS[B][stage]
    assert 1 <= S <= B
    if (B, stage) == (16, 2):      # the report shape: 128 blocks of 8
        assert (nW * h * S, -(-B // S)) == (128, 8)


def test_base_stages():
    assert STAGES == [(64, 4), (16, 8), (4, 16), (1, 32)]


# ---- the routine's rounding steps, emulated in numpy --------------------

def _bf16(x):
    """x rounded to the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _attend_heads_tc_emulated(q, k, v, bias):
    """attend_heads_tc on one (batch, window, head), q, k, v (N, hd) bf16
    values as float32, bias (N, N) fp32: N padded to 16 and hd to 16 with
    zeros, the logits starting as the bias (-inf on padded keys, 0 on
    padded rows), q scaled in fp32 and rounded, fp32 products, the
    softmax by exp2 of prescaled logits and one reciprocal a row, P
    rounded, out rounded; rows < N and channels < hd kept."""
    N, hd = q.shape
    NP, HP = -(-N // 16) * 16, max(hd, 16)
    pad = lambda x: np.pad(x, ((0, NP - N), (0, HP - hd)))
    qs, ks, vs = pad(q), pad(k), pad(v)
    s = np.zeros((NP, NP), np.float32)
    s[:N, :N] = bias
    s[:, N:] = -np.inf
    s = s + _bf16(qs * np.float32(hd ** -0.5)) @ ks.T
    log2e = np.float32(1.4426950408889634)
    m = s.max(-1, keepdims=True) * log2e
    p = np.exp2(s * log2e - m).astype(np.float32)
    r = np.float32(1) / p.sum(-1, keepdims=True, dtype=np.float32)
    out = _bf16(_bf16(p * r) @ vs)
    return out[:N, :hd]


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("N,h,hd", [(4, 1, 16), (16, 2, 8), (49, 2, 32),
                                    (16, 2, 64)])
def test_tc_rounding_steps_are_the_plain_versions(N, h, hd, with_mask):
    """The kernel's contract (round(q * scale), fp32 logits on the fp32
    bias, fp32 softmax, round(P), fp32 P.V rounded on store) is the plain
    version's in bf16: they agree to the tolerance the card holds K1 to,
    and mostly to the bit."""
    B, nW = 2, 3
    rng = np.random.default_rng(N * hd + with_mask)
    qkv = _bf16(rng.standard_normal((B, nW, N, 3 * h * hd)))
    bias = (rng.standard_normal((nW, h, N, N)) * 0.5).astype(np.float32)
    if with_mask:
        bias += np.where(rng.random((nW, 1, N, N)) < 0.3, -100.0, 0.0
                         ).astype(np.float32)
    ref = twa.window_attention_reference(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(bias), h)
    assert ref.dtype == torch.bfloat16
    ref = ref.float().numpy()
    C = h * hd
    got = np.zeros_like(ref)
    for b in range(B):
        for w in range(nW):
            for head in range(h):
                q, k, v = (qkv[b, w, :, i * C + head * hd:i * C + (head + 1) * hd]
                           for i in range(3))
                got[b, w, :, head * hd:(head + 1) * hd] = \
                    _attend_heads_tc_emulated(q, k, v, bias[w, head])
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert np.mean(got == ref) >= 0.99
