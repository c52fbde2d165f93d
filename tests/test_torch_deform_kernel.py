"""The modulated deformable conv's sampling kernel (`deform_im2col`,
`fiber_torch/csrc/deform_im2col.cu`) against its plain twin
(`fiber_torch/detection/deform_conv.py::_deform_im2col_plain`).

On the host: the wrapper runs the plain version on a CPU tensor, counts no
launch and builds nothing; a torch emulation of the kernel's order of work
(clamped corners read as 0 outside the map, the fp32 steps one by one)
gives the plain version's bits; the C entry takes the arguments the
wrapper passes; the benchmark's reader `deform_ms.det` reads the kernel's
device time a pass.  On a CUDA device (tests marked `cuda`, skipped
without one): the kernel's matrix and the layer's output equal to the
plain twin's (`torch.equal`) in bf16 and fp32, at stride 1 and 2, on the
DyHead's strided and reinterpreted offsets, with samples past every
border, at Cin 256 and at widths off the 16-byte vector; the gradients
through `_DeformConvFunction` against the plain twin's autograd; the
launch counter; the raises.

This file imports neither JAX nor `fiber_tpu`, so it also runs where only
PyTorch is installed (the repo's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_deform_kernel.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fiber_torch.detection import deform_conv as dc
from fiber_torch.detection.dyhead import reinterpret

torch.set_num_threads(1)
SRC = Path(dc.__file__).resolve().parent.parent / "csrc" / "deform_im2col.cu"


def _inputs(B, Cin, H, W, stride, layout, dtype, seed, device="cpu",
            off_scale=2.5, off_dtype=None):
    """x (B, Cin, H, W) and the offsets and masks a conv of `layout` reads:
    "same" and "down" (stride 2) a slice of an offset conv's 27 channels
    at the output's size (batch stride 27 Ho Wo), "up" the reinterpreted
    buffers of the level below (2x the size: a flat prefix of each
    image's buffer).  Offsets N(0, off_scale), a quarter of them whole
    numbers (samples on grid lines and on the borders -1, H), a few far
    outside the map."""
    g = torch.Generator().manual_seed(seed)
    Ho, Wo = -(-H // stride), -(-W // stride)
    Hb, Wb = (2 * H, 2 * W) if layout == "up" else (Ho, Wo)
    x = torch.randn(B, Cin, H, W, generator=g)
    om = torch.randn(B, 27, Hb, Wb, generator=g) * off_scale
    om = torch.where(torch.rand(om.shape, generator=g) < 0.25, om.round(), om)
    om[:, :18] += torch.where(torch.rand(B, 18, Hb, Wb, generator=g) < 0.02,
                              3.0 * max(H, W), 0.0)
    od = off_dtype or dtype
    om = om.to(device, od)
    offset, mask = om[:, :18], torch.sigmoid(om[:, 18:])
    if layout == "up":
        offset, mask = reinterpret(offset, H, W), reinterpret(mask, H, W)
    return x.to(device, dtype), offset, mask


# (B, Cin, H, W, stride, layout): FIBER-B's P6 / P7 widths at odd sizes,
# the stride-2 conv from the level above, the reinterpreted conv from the
# level below, widths off the 16-byte vector (13: both dtypes element by
# element; 20: bf16 element by element, fp32 vectors), and a row past 256
# columns, where bf16 rounds the grid (T(T(i) * stride))
CASES = [(2, 256, 13, 21, 1, "same"), (2, 256, 25, 42, 2, "down"),
         (2, 256, 7, 11, 1, "up"), (3, 13, 9, 11, 1, "same"),
         (2, 20, 10, 9, 2, "down"), (2, 20, 5, 7, 1, "up"),
         (1, 16, 3, 301, 1, "same"), (1, 16, 3, 602, 2, "down")]
DTYPES = [torch.bfloat16, torch.float32]


def _emulate_kernel(x, offset, mask, stride, order=(0, 1, 2, 3)):
    """The kernel's order of work in torch on the host: the grid point
    T(T(i) * stride), the sample (base + tap) + offset in fp32, the top-left
    corner clamped to [-1, H - 1] x [-1, W - 1], each corner read from the
    NHWC map where it lies inside and 0 elsewhere, ((v0 w0 + v1 w1) + v2 w2)
    + v3 w3 times (valid * mask), rounded to T.  `order` sums the corners
    in another order."""
    B, Cin, H, W = x.shape
    Ho, Wo = offset.shape[-2:]
    T = x.dtype
    rt = lambda v: v.to(T).float()
    base_y = rt(rt(torch.arange(Ho).float()) * stride)
    base_x = rt(rt(torch.arange(Wo).float()) * stride)
    k = torch.arange(9)
    tap_y, tap_x = (k // 3 - 1).float(), (k % 3 - 1).float()
    off = offset.float()
    sy = (base_y[None, None, :, None] + tap_y[None, :, None, None]) + off[:, 0::2]
    sx = (base_x[None, None, None, :] + tap_x[None, :, None, None]) + off[:, 1::2]
    valid = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0f, sx - x0f
    hy, hx = 1 - ly, 1 - lx
    weights = (hy * hx, hy * lx, ly * hx, ly * lx)
    y0 = y0f.clamp(-1, H - 1).long()
    x0 = x0f.clamp(-1, W - 1).long()
    xh = x.permute(0, 2, 3, 1)
    b = torch.arange(B)[:, None, None, None]
    acc = None
    corners = ((0, 0), (0, 1), (1, 0), (1, 1))
    for i in order:
        (dy, dx), w = corners[i], weights[i]
        y, xx = y0 + dy, x0 + dx
        inside = (y >= 0) & (y < H) & (xx >= 0) & (xx < W)
        v = xh[b, y.clamp(0, H - 1), xx.clamp(0, W - 1)].float()
        term = torch.where(inside[..., None], v, 0.0) * w[..., None]
        acc = term if acc is None else acc + term
    cols = (acc * (valid.float() * mask.float())[..., None]).to(T)
    return cols.permute(0, 2, 3, 1, 4).reshape(B * Ho * Wo, 9 * Cin)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_order_of_work_gives_the_plain_bits(case, dtype):
    B, Cin, H, W, stride, layout = case
    x, offset, mask = _inputs(B, Cin, H, W, stride, layout, dtype, seed=1)
    assert torch.equal(_emulate_kernel(x, offset, mask, stride),
                       dc._deform_im2col_plain(x, offset, mask, stride))


def test_bit_equality_sees_another_order():
    """The comparison is strict: the corners summed in reverse order move
    some fp32 values."""
    x, offset, mask = _inputs(2, 256, 13, 21, 1, "same", torch.float32, 2)
    ref = dc._deform_im2col_plain(x, offset, mask, 1)
    assert not torch.equal(_emulate_kernel(x, offset, mask, 1, (3, 2, 1, 0)),
                           ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_cpu_tensor_runs_the_plain_twin_and_builds_nothing(dtype,
                                                          monkeypatch):
    from fiber_torch.kernels import _build

    def refuse(*_):
        raise AssertionError("a CPU call must build and load no kernel")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(dc.modulated_deform_conv2d, "launches", 0)
    x, offset, mask = _inputs(2, 20, 10, 9, 2, "down", dtype, seed=3)
    g = torch.Generator().manual_seed(4)
    w = (torch.randn(7, 20, 3, 3, generator=g) * 0.1).to(dtype)
    bias = torch.randn(7, generator=g).to(dtype)
    for grad in (False, True):
        leaves = [t.detach().clone().requires_grad_(grad)
                  for t in (x, offset, mask, w, bias)]
        out = dc.modulated_deform_conv2d(*leaves, stride=2)
        ref = dc._modulated_deform_conv2d_plain(*leaves, stride=2)
        assert torch.equal(out, ref) and out.shape == (2, 7, 5, 5)
        assert out.requires_grad == grad
    assert dc.modulated_deform_conv2d.launches == 0


def test_c_entry_takes_the_wrappers_arguments():
    """The C entry's parameters, counted in the source, are the ctypes
    signature `_lib` gives it: 4 pointers, 7 ints, 8 strides, 3 dtypes,
    the stream."""
    src = SRC.read_text()
    params = re.search(r"int fiber_deform_im2col\(([^)]*)\)", src).group(1)
    kinds = [p.split()[0] if not p.strip().startswith("long long") else
             "long long" for p in params.split(",")]
    assert kinds == (["const"] * 3 + ["void*"] + ["int"] * 7
                     + ["long long"] * 8 + ["int"] * 3 + ["void*"])
    assert "deform_im2col_kernel" in src      # the name the benchmark reads


def _trace(names, durations_us, passes):
    from portbench.harness.trace import Trace
    t = Trace(False)
    starts = np.cumsum([0] + [d + 5 for d in durations_us[:-1]]) * 1000
    t.names = list(names)
    t.starts = np.array(starts, np.int64)
    t.ends = t.starts + np.array(durations_us, np.int64) * 1000
    hs = np.arange(passes, dtype=np.int64) * 10 ** 6
    t.host = (hs, hs + 500, ["det.pass"] * passes)
    return t


def test_deform_ms_reader():
    """`deform_ms.det`: the device ms a pass of the operations named
    `deform_im2col`; nothing to read without the kernel (the parent) or
    without passes."""
    from types import SimpleNamespace
    from portbench.harness import core, runner
    read = runner.load_file(core.BENCH / "metrics" / "deform_ms.det.py").read
    k = "void (anonymous namespace)::deform_im2col_kernel<__nv_bfloat16, true>"
    t = _trace([k, "ampere_bf16_gemm", k, k], [300, 900, 200, 100], 2)
    assert read(SimpleNamespace(trace=t)) == pytest.approx(0.3)
    t = _trace(["ampere_bf16_gemm", "elementwise_kernel"], [300, 900], 2)
    assert read(SimpleNamespace(trace=t)) is None
    t = _trace([k], [300], 0)
    assert read(SimpleNamespace(trace=t)) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _weights(Cout, Cin, dtype, device, seed=7):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(Cout, Cin, 3, 3, generator=g) * (9 * Cin) ** -0.5
    b = torch.randn(Cout, generator=g) * 0.1
    return w.to(device, dtype), b.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_equals_the_plain_twin(cuda, case, dtype):
    B, Cin, H, W, stride, layout = case
    x, offset, mask = _inputs(B, Cin, H, W, stride, layout, dtype, 11, cuda)
    if layout != "same":
        assert offset.stride(0) != offset[0].numel()   # a strided batch
    n = dc.modulated_deform_conv2d.launches
    cols = dc.deform_im2col(x, offset, mask, stride)
    assert dc.modulated_deform_conv2d.launches == n + 1
    ref = dc._deform_im2col_plain(x, offset, mask, stride)
    assert cols.dtype == dtype and torch.equal(cols, ref)
    assert torch.equal(cols.cpu(), _emulate_kernel(x.cpu(), offset.cpu(),
                                                   mask.cpu(), stride))
    w, b = _weights(32, Cin, dtype, cuda)
    with torch.no_grad():
        out = dc.modulated_deform_conv2d(x, offset, mask, w, b, stride)
    assert dc.modulated_deform_conv2d.launches == n + 2
    assert torch.equal(out, dc._modulated_deform_conv2d_plain(
        x, offset, mask, w, b, stride))
    assert torch.equal(dc.modulated_deform_conv2d(x, offset, mask, w, None,
                                                  stride),
                       dc._modulated_deform_conv2d_plain(x, offset, mask, w,
                                                         None, stride))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_kernel_takes_offsets_of_another_dtype(cuda, dtype):
    """Under autocast the offset conv gives bf16 while the features stay
    fp32 (and the other way round): the kernel reads each in its dtype."""
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    x, offset, mask = _inputs(2, 256, 13, 21, 1, "same", dtype, 12, cuda,
                              off_dtype=other)
    assert torch.equal(dc.deform_im2col(x, offset, mask, 1),
                       dc._deform_im2col_plain(x, offset, mask, 1))


@pytest.mark.cuda
def test_kernel_at_p3_is_bit_equal_and_deterministic(cuda):
    """FIBER-B's P3 level at 800x1344 (100 x 168, 256 channels), B = 2."""
    x, offset, mask = _inputs(2, 256, 100, 168, 1, "same", torch.bfloat16,
                              13, cuda)
    a = dc.deform_im2col(x, offset, mask, 1)
    assert torch.equal(a, dc.deform_im2col(x, offset, mask, 1))
    assert torch.equal(a, dc._deform_im2col_plain(x, offset, mask, 1))


def _grads(fn, leaves, g):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    (fn(*leaves) * g).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES[:3] + CASES[4:5],
                         ids=lambda c: "x".join(map(str, c)))
def test_gradients_through_the_function(cuda, case):
    """fp32: every input's gradient through the kernel's Function against
    the plain twin's autograd, within fp32 round-off (the corners'
    scatter-add sums in no fixed order on the card)."""
    B, Cin, H, W, stride, layout = case
    x, offset, mask = _inputs(B, Cin, H, W, stride, layout, torch.float32,
                              14, cuda)
    w, b = _weights(24, Cin, torch.float32, cuda)
    gen = torch.Generator().manual_seed(15)
    Ho, Wo = offset.shape[-2:]
    g = torch.randn(B, 24, Ho, Wo, generator=gen).to(cuda)
    n = dc.modulated_deform_conv2d.launches
    got = _grads(lambda *a: dc.modulated_deform_conv2d(*a, stride=stride),
                 (x, offset, mask, w, b), g)
    assert dc.modulated_deform_conv2d.launches == n + 1   # forward only
    ref = _grads(lambda *a: dc._modulated_deform_conv2d_plain(
        *a, stride=stride), (x, offset, mask, w, b), g)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5 * float(
            r.abs().max()))


@pytest.mark.cuda
def test_gradients_under_autocast(cuda):
    """Training's mixed precision: fp32 features and weights, the offsets
    bf16 from an autocast conv; the backward recomputes under the
    forward's autocast state."""
    x, offset, mask = _inputs(2, 64, 13, 21, 2, "down", torch.float32, 16,
                              cuda, off_dtype=torch.bfloat16)
    w, b = _weights(32, 64, torch.float32, cuda)
    g = torch.randn(2, 32, 7, 11, generator=torch.Generator().manual_seed(17)
                    ).to(cuda)

    def under_autocast(fn):
        def run(*a):
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return fn(*a, stride=2)
        return run

    got = _grads(under_autocast(dc.modulated_deform_conv2d),
                 (x, offset, mask, w, b), g)
    ref = _grads(under_autocast(dc._modulated_deform_conv2d_plain),
                 (x, offset, mask, w, b), g)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype
        torch.testing.assert_close(a, r, rtol=0, atol=1e-3 * float(
            r.abs().max()))


@pytest.mark.cuda
def test_kernel_rejects(cuda):
    x, offset, mask = _inputs(1, 8, 5, 6, 1, "same", torch.float32, 18, cuda)
    with pytest.raises(TypeError):
        dc.deform_im2col(x.half(), offset, mask)
    with pytest.raises(TypeError):
        dc.deform_im2col(x.double(), offset, mask)
    with pytest.raises(TypeError):
        dc.deform_im2col(x, offset.half(), mask)
    with pytest.raises(ValueError):
        dc.deform_im2col(x, offset[:, :17], mask)
    with pytest.raises(ValueError):
        dc.deform_im2col(x, offset, mask[:, :, :4])
    with pytest.raises(ValueError):
        dc.deform_im2col(x, offset.cpu(), mask)
    with pytest.raises(ValueError):
        dc.deform_im2col(x, offset, mask, stride=0)
    w, _ = _weights(4, 9, torch.float32, cuda)
    with torch.no_grad(), pytest.raises(ValueError):
        dc.modulated_deform_conv2d(x, offset, mask, w)
