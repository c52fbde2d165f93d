"""On-device preprocessing of the port (`fiber_torch/data/device_transforms`)
against `fiber_tpu/data/device_transforms` on the CPU: the resize against
`jax.image.scale_and_translate`, the six RandAugment warps, both pipelines
end to end (the training one fed JAX's own draws), and the port's own
draws checked by their statistics.

The JAX functions run under `jax.jit`, as the pipelines run them.  The
images are smoothed, as `tests/test_device_transforms.py` smooths them, so
that a sample position one fp32 ulp apart (XLA fuses the position
arithmetic and has its own sin and cos) moves a pixel by little.

Limits: 1e-3 absolute on the 0-255 scale for the resize and the warps;
2e-5 absolute on the normalized fp32 output of both pipelines, and on their
bf16 output that carried through one rounding to bf16: one bf16 ulp of the
value beyond 2e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.data import device_transforms as jdt
from fiber_torch.data import device_transforms as tdt

torch.set_num_threads(1)
PIXEL_ATOL = 1e-3
NORM_ATOL = 2e-5


def _smooth_images(rng, sizes):
    """uint8 (h, w, 3) arrays, smoothed so that resampler differences are
    not amplified by noise."""
    out = []
    for h, w in sizes:
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
        for ax in (0, 1):
            arr = (np.roll(arr, 1, ax) + arr + np.roll(arr, -1, ax)) / 3
        out.append(arr.astype(np.uint8))
    return out


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_within_ulp(got: torch.Tensor, want) -> None:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert (np.abs(g - w) <= _bf16_ulp(w) + NORM_ATOL).all(), \
        np.abs(g - w).max()


_jax_resize = jax.jit(jdt._resize_one, static_argnums=3)
_jax_warp = jax.jit(jdt._randaug_geometric, static_argnums=3)


# ---------------------------------------------------------------------------
# the resize
# ---------------------------------------------------------------------------
RESIZE_CASES = {
    # name: (S0, out, native (h, w), crop [y0, x0, ch, cw])
    "down_576_to_384": (576, 384, (576, 576), (0.0, 0.0, 576.0, 576.0)),
    "up_crop_120x90_to_384": (256, 384, (200, 240), (10.0, 20.0, 90.0, 120.0)),
    "down_864_to_576": (864, 576, (864, 700), (0.0, 0.0, 864.0, 700.0)),
    "crop_off_origin": (576, 384, (500, 560), (37.25, 81.5, 401.75, 455.0)),
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_matches_scale_and_translate(case):
    S0, out, (h, w), crop = RESIZE_CASES[case]
    rng = np.random.default_rng(0)
    staged, _ = tdt.stage_host(_smooth_images(rng, [(h, w)])[0], S0)
    want = np.asarray(_jax_resize(jnp.asarray(staged), None,
                                  jnp.asarray(crop, jnp.float32), out))
    got = tdt.resize_crops(torch.from_numpy(staged)[None],
                           torch.tensor([crop]), out)[0].numpy()
    assert got.shape == want.shape == (out, out, 3)
    assert np.abs(got - want).max() <= PIXEL_ATOL


def test_resize_weights_are_batched_per_image():
    """Two crop boxes in one batch give each image its own weights."""
    rng = np.random.default_rng(1)
    staged, _ = tdt.stage_host_batch(_smooth_images(rng, [(80, 96), (96, 60)]),
                                     96)
    crops = torch.tensor([[0.0, 0.0, 80.0, 96.0], [5.0, 7.5, 50.0, 40.0]])
    both = tdt.resize_crops(torch.from_numpy(staged), crops, 64)
    for b in range(2):
        one = tdt.resize_crops(torch.from_numpy(staged[b:b + 1]),
                               crops[b:b + 1], 64)
        torch.testing.assert_close(both[b:b + 1], one, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the RandAugment warps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("magnitude", [0.0, 0.4, -0.7])
@pytest.mark.parametrize("op", range(6))
def test_warp_matches_randaug_geometric(op, magnitude):
    S = 64
    mag = magnitude * (30.0 if op == 5 else 1.0)      # degrees for rotate
    img = _smooth_images(np.random.default_rng(op), [(S, S)])[0].astype(
        np.float32)
    want = np.asarray(_jax_warp(
        jnp.asarray(img), jnp.int32(op), jnp.float32(mag), S))
    got = tdt.affine_warp(
        torch.from_numpy(img)[None],
        tdt.randaug_matrices(torch.tensor([op]), torch.tensor([mag]), S))
    assert np.abs(got[0].numpy() - want).max() <= PIXEL_ATOL
    if op == 0:                                       # identity: exactly
        np.testing.assert_array_equal(got[0].numpy(), img)


def test_warp_batches_different_ops():
    S = 32
    imgs = np.stack(_smooth_images(np.random.default_rng(7), [(S, S)] * 6)
                    ).astype(np.float32)
    ops = torch.arange(6)
    mags = torch.tensor([0.0, 0.2, -0.2, 0.3, -0.1, 12.0])
    got = tdt.affine_warp(torch.from_numpy(imgs),
                          tdt.randaug_matrices(ops, mags, S))
    for b in range(6):
        want = np.asarray(_jax_warp(
            jnp.asarray(imgs[b]), jnp.int32(b), jnp.float32(mags[b]), S))
        assert np.abs(got[b].numpy() - want).max() <= PIXEL_ATOL


# ---------------------------------------------------------------------------
# the pipelines end to end
# ---------------------------------------------------------------------------
S0, OUT = 96, 64
NATIVE = [(80, 96), (96, 60), (120, 150), (33, 47)]   # one above S0


@pytest.fixture(scope="module")
def staged():
    rng = np.random.default_rng(3)
    return tdt.stage_host_batch(_smooth_images(rng, NATIVE), S0)


def test_stage_host_on_arrays_matches_jax(staged):
    rng = np.random.default_rng(3)
    imgs = _smooth_images(rng, NATIVE)
    want = jdt.stage_host_batch(imgs, S0)
    np.testing.assert_array_equal(staged[0], want[0])
    np.testing.assert_array_equal(staged[1], want[1])
    assert staged[1].tolist()[2] == [76, 96]          # nearest downscale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_preprocess_matches_jax(staged, dtype):
    want = jdt.device_eval_preprocess(jnp.asarray(staged[0]),
                                      jnp.asarray(staged[1]), OUT,
                                      dtype_name=dtype)
    got = tdt.device_eval_preprocess(torch.from_numpy(staged[0]),
                                     torch.from_numpy(staged[1]), OUT,
                                     dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    if dtype == "float32":
        assert np.abs(got.numpy() - np.asarray(want)).max() <= NORM_ATOL
    else:
        _assert_within_ulp(got, want)


@functools.partial(jax.jit, static_argnames=("n_randaug",))
def _jax_draws(key, sizes, n_randaug=2, randaug_level=7):
    """The draws `fiber_tpu`'s device_train_preprocess makes from `key`,
    split and used as its body does."""
    B = sizes.shape[0]
    kc, ka, kxy, kf, kops, kmag, ksgn = jax.random.split(key, 7)
    hw = sizes.astype(jnp.float32)
    area = hw[:, 0] * hw[:, 1]
    target = jax.random.uniform(kc, (B,), minval=0.5, maxval=1.0) * area
    ar = jnp.exp(jax.random.uniform(ka, (B,), minval=jnp.log(3 / 4),
                                    maxval=jnp.log(4 / 3)))
    cw = jnp.minimum(jnp.sqrt(target * ar), hw[:, 1])
    ch = jnp.minimum(jnp.sqrt(target / ar), hw[:, 0])
    u = jax.random.uniform(kxy, (B, 2))
    crops = jnp.stack([u[:, 0] * (hw[:, 0] - ch), u[:, 1] * (hw[:, 1] - cw),
                       ch, cw], axis=1)
    flip = jax.random.bernoulli(kf, 0.5, (B,))
    lvl = randaug_level / 10.0
    ops, mags = [], []
    for i in range(n_randaug):
        op = jax.random.randint(jax.random.fold_in(kops, i), (B,), 0, 6)
        sgn = jnp.where(
            jax.random.bernoulli(jax.random.fold_in(ksgn, i), 0.5, (B,)),
            1.0, -1.0)
        mag01 = jax.random.uniform(jax.random.fold_in(kmag, i), (B,))
        table = jnp.stack([jnp.zeros((B,)), 0.3 * lvl * mag01 * sgn,
                           0.3 * lvl * mag01 * sgn, 0.45 * lvl * mag01 * sgn,
                           0.45 * lvl * mag01 * sgn, 30.0 * lvl * mag01 * sgn],
                          axis=1)
        ops.append(op)
        mags.append(jnp.take_along_axis(table, op[:, None], axis=1)[:, 0])
    return crops, flip, jnp.stack(ops), jnp.stack(mags)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_preprocess_matches_jax_on_its_draws(staged, dtype, seed):
    key = jax.random.PRNGKey(seed)
    sizes = jnp.asarray(staged[1])
    want = jdt.device_train_preprocess(jnp.asarray(staged[0]), sizes, key,
                                       OUT, dtype_name=dtype)
    crops, flip, ops, mags = (np.array(a) for a in _jax_draws(key, sizes))
    draws = {"crops": torch.from_numpy(crops), "flip": torch.from_numpy(flip),
             "ops": torch.from_numpy(ops).long(),
             "mags": torch.from_numpy(mags)}
    got = tdt.apply_train_preprocess(torch.from_numpy(staged[0]), draws, OUT,
                                     dtype=getattr(torch, dtype))
    assert got.shape == want.shape == (len(NATIVE), OUT, OUT, 3)
    if dtype == "float32":
        assert np.abs(got.numpy() - np.asarray(want)).max() <= NORM_ATOL
    else:
        _assert_within_ulp(got, want)


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------
def test_own_draws_statistics():
    rng = np.random.default_rng(11)
    n = 512
    sizes = np.stack([rng.integers(24, 200, n), rng.integers(24, 200, n)],
                     axis=1).astype(np.int32)
    sizes[:8] = [[30, 190]] * 8                       # forces the clamp
    gen = torch.Generator().manual_seed(0)
    d = tdt.draw_train_params(torch.from_numpy(sizes), gen)
    y0, x0, ch, cw = d["crops"].double().numpy().T
    h, w = sizes[:, 0].astype(np.float64), sizes[:, 1].astype(np.float64)
    frac = ch * cw / (h * w)
    clamped = (ch >= h - 1e-4) | (cw >= w - 1e-4)
    assert ((frac >= 0.5 - 1e-5) & (frac <= 1 + 1e-5) | clamped).all()
    assert clamped[:8].all() and not clamped.all()
    # the crop never leaves the native image
    eps = 1e-3
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + ch <= h + eps).all() and (x0 + cw <= w + eps).all()
    flip = d["flip"].float().mean().item()
    assert 0.4 <= flip <= 0.6, flip
    assert d["ops"].shape == (2, n)
    assert set(d["ops"].flatten().tolist()) == set(range(6))
    mags = d["mags"].numpy()
    assert (mags[d["ops"].numpy() == 0] == 0).all()
    assert np.abs(mags[d["ops"].numpy() == 5]).max() <= 21.0
    assert (mags < 0).any() and (mags > 0).any()


def test_train_preprocess_never_samples_padding():
    """A constant-white image must stay white under crop + flip (no
    randaug): any dark leak means the crop sampled outside the native
    region."""
    img = np.full((150, 210, 3), 255, np.uint8)
    staged, hw = tdt.stage_host_batch([img], 256)
    out = tdt.device_train_preprocess(
        torch.from_numpy(staged), torch.from_numpy(hw),
        torch.Generator().manual_seed(4), 64, dtype=torch.float32,
        n_randaug=0)
    white = (1.0 - np.array(tdt.IMAGENET_DEFAULT_MEAN)) / np.array(
        tdt.IMAGENET_DEFAULT_STD)
    assert np.abs(out[0].numpy() - white).max() < 0.05


def test_train_preprocess_is_seeded_and_varies(staged):
    args = (torch.from_numpy(staged[0]), torch.from_numpy(staged[1]))
    run = [tdt.device_train_preprocess(*args, torch.Generator().manual_seed(s),
                                       OUT, dtype=torch.float32)
           for s in (1, 1, 2)]
    torch.testing.assert_close(run[0], run[1], rtol=0, atol=0)
    assert (run[0] - run[2]).abs().max() > 1e-3
    assert torch.isfinite(run[0]).all()


def test_numpy_inputs_go_to_the_card_or_raise(staged):
    """No silent move to the host: numpy input without a card raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdt.device_eval_preprocess(staged[0], staged[1], OUT)
    out = tdt.device_eval_preprocess(staged[0], staged[1], OUT,
                                     dtype=torch.float32, device="cpu")
    assert out.shape == (len(NATIVE), OUT, OUT, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_on_device_matches_jax(dtype):
    from fiber_tpu.data.transforms import normalize_on_device as jax_norm
    from fiber_torch.data.transforms import normalize_on_device
    img = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3),
                                            dtype=np.uint8)
    got = normalize_on_device(torch.from_numpy(img),
                              dtype=getattr(torch, dtype))
    want = jax_norm(jnp.asarray(img), dtype=getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert np.abs(got.numpy() - np.asarray(want)).max() <= NORM_ATOL
    else:
        _assert_within_ulp(got, want)
