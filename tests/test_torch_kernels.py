"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device.  Every test here is marked `cuda` and skips on a host without one.

This file imports neither JAX nor `fiber_tpu`, so it also runs where only
PyTorch is installed (the repo's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
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
          (3, 3, 49, 4, 64), (2, 2, 16, 2, 8), (2, 2, 4, 1, 16)]
# fp32 K and V at N=256, hd=128 exceed a block's shared memory (the wrapper
# raises, see test_window_attention_kernel_rejects); bf16 fits
CASES = ([(torch.float32, s) for s in SHAPES]
         + [(torch.bfloat16, s) for s in SHAPES + [(1, 2, 256, 2, 128)]])


@pytest.mark.parametrize("dtype,shape", CASES)
def test_window_attention_kernel_matches_plain(cuda, dtype, shape):
    B, nW, N, h, hd = shape
    qkv, bias = _inputs(B, nW, N, h, hd, N + hd, cuda, dtype)
    before = twa.window_attention.launches
    with torch.inference_mode():
        out = twa.window_attention(qkv, bias, h)
        ref = twa.window_attention_reference(qkv, bias, h)
    torch.cuda.synchronize()
    assert twa.window_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, nW, N, h * hd)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_window_attention_kernel_broadcast_bias(cuda):
    qkv, bias = _inputs(2, 4, 144, 4, 32, 0, cuda, torch.bfloat16)
    one = bias[:1].contiguous()
    with torch.inference_mode():
        a = twa.window_attention(qkv, one.expand(4, 4, 144, 144), 4)
        b = twa.window_attention(qkv, one.expand(4, 4, 144, 144).contiguous(), 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["grad", "head_dim", "dtype", "noncontig",
                                  "bias_dtype", "too_large"])
def test_window_attention_kernel_rejects(cuda, case):
    qkv, bias = _inputs(1, 2, 16, 2, 32, 1, cuda, torch.float32)
    h, err = 2, ValueError
    if case == "grad":
        qkv.requires_grad_(True)
        err = RuntimeError
    elif case == "head_dim":                  # hd = 24 is not built
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
    before = twa.window_attention.launches
    with pytest.raises(err):
        twa.window_attention(qkv, bias, h)
    assert twa.window_attention.launches == before


def test_tiny_model_kernel_path_matches_plain_path(cuda):
    """One seed, two devices: the tiny model's fused forward with the kernel
    on the card against the plain path on the host, fp32."""
    cfg = FiberConfig.tiny_test(loss_names=("itm", "mlm", "itc"))
    models = [FiberCoarse(cfg, device=d, seed=0).eval() for d in (cuda, "cpu")]
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
    before = twa.window_attention.launches
    with torch.inference_mode():
        out = models[0].infer(img.to(cuda), ids.to(cuda), masks.to(cuda))
        ref = models[1].infer(img, ids, masks)
    assert twa.window_attention.launches - before == sum(cfg.swin_depths)
    for k in ref:
        torch.testing.assert_close(out[k].cpu(), ref[k], rtol=0, atol=1e-4)
