"""Fused Swin blocks (kernel K3's op): the port's plain version against the
JAX package's `fused_swin_blocks` in interpret mode and against the port's
own per-block `SwinBlock`s, the stacked-parameter carry-across, the
stacking checks, and the op's dispatch, on the CPU.  The kernel itself is
held against the plain version on a CUDA device in
tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.models import swin as jswin
from fiber_tpu.ops import swin_stage as jstage
from fiber_torch.config import FiberConfig
from fiber_torch.models import swin as tswin
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.ops import swin_stage as tstage
from fiber_torch.utils.convert import stacked_params_from_flax
from torch_parity import flatten, load_into, perturb, unflatten

torch.set_num_threads(1)

# the shapes of tests/test_swin_stage_kernel.py
B, H, W, C = 2, 8, 8, 32
WIN, HEADS, NBLK = 4, 4, 3


def _blocks(res, n, shifted, seed, win=WIN, heads=HEADS):
    """n JAX blocks (alternating shift if `shifted`), their perturbed
    parameters, and the same blocks in the port."""
    x = jnp.zeros((1,) + res + (C,), jnp.float32)
    jparams, tblocks = [], []
    for b in range(n):
        shift = win // 2 if shifted and b % 2 else 0
        jblk = jswin.SwinBlock(dim=C, input_resolution=res, num_heads=heads,
                               window_size=win, shift_size=shift, drop=0.0,
                               attn_drop=0.0, drop_path=0.0)
        flat = perturb(flatten(jblk.init(jax.random.PRNGKey(seed + b),
                                         x)["params"]), seed + b)
        tblk = tswin.SwinBlock(C, res, heads, win, shift).eval()
        load_into(tblk, flat, "vit_model/layers_0/blocks_0/",
                  "vit_model.layers.0.blocks.0.")
        jparams.append(unflatten(flat))
        tblocks.append(tblk)
    return jparams, tblocks


def _case(one_window):
    """(x, JAX stack, port blocks, mask, use_shift) of the shifted stack or
    the one-window (stage-4 layout) stack."""
    if one_window:
        res, n, shifted, seed = (WIN, WIN), 2, False, 20
    else:
        res, n, shifted, seed = (H, W), NBLK, True, 1
    jparams, tblocks = _blocks(res, n, shifted, seed)
    x = np.random.default_rng(seed).standard_normal((B,) + res + (C,)
                                                    ).astype(np.float32)
    N = WIN * WIN
    mask = (tswin.shifted_window_mask(H, W, WIN, WIN // 2) if shifted
            else np.zeros((1, N, N), np.float32))
    return x, jstage.stack_block_params(tuple(jparams), WIN, HEADS), \
        tblocks, mask, shifted


@pytest.mark.parametrize("one_window", [False, True])
def test_plain_matches_jax_interpret_fp32(one_window):
    x, jsp, tblocks, mask, use_shift = _case(one_window)
    ref = jstage.fused_swin_blocks(jnp.asarray(x), jsp, jnp.asarray(mask),
                                   window=WIN, num_heads=HEADS,
                                   use_shift=use_shift, interpret=True)
    sp = tstage.stack_block_params(tblocks, WIN, HEADS, use_shift)
    with torch.inference_mode():
        out = tstage.fused_swin_blocks(torch.from_numpy(x), sp,
                                       torch.from_numpy(mask), WIN, HEADS,
                                       use_shift)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_matches_jax_interpret_at_window_18():
    """FIBER's 576^2 windows (18 x 18, N = 324), beyond the 256 tokens the
    kernel's first attention instance takes: one window, B = 1, C = 32 in
    2 heads, two blocks."""
    win, heads = 18, 2
    jparams, tblocks = _blocks((win, win), 2, False, 40, win, heads)
    x = np.random.default_rng(40).standard_normal((1, win, win, C)
                                                  ).astype(np.float32)
    mask = np.zeros((1, win * win, win * win), np.float32)
    ref = jstage.fused_swin_blocks(
        jnp.asarray(x), jstage.stack_block_params(tuple(jparams), win, heads),
        jnp.asarray(mask), window=win, num_heads=heads, use_shift=False,
        interpret=True)
    sp = tstage.stack_block_params(tblocks, win, heads, False)
    assert tuple(sp["rpb"].shape) == (2, heads, 324, 324)
    with torch.inference_mode():
        out = tstage.fused_swin_blocks(torch.from_numpy(x), sp,
                                       torch.from_numpy(mask), win, heads,
                                       False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_matches_jax_interpret_bf16():
    """x and the weights in bf16 on both sides (JAX's stack cast as the
    port casts it: LayerNorm parameters and the bias tables stay fp32)."""
    x, jsp, tblocks, mask, use_shift = _case(False)
    jsp = {k: (v if k in tstage.FP32_KEYS else v.astype(jnp.bfloat16))
           for k, v in jsp.items()}
    ref = jstage.fused_swin_blocks(jnp.asarray(x, jnp.bfloat16), jsp,
                                   jnp.asarray(mask), window=WIN,
                                   num_heads=HEADS, use_shift=True,
                                   interpret=True)
    sp = tstage.stack_block_params(tblocks, WIN, HEADS, dtype=torch.bfloat16)
    with torch.inference_mode():
        out = tstage.fused_swin_blocks(torch.from_numpy(x).bfloat16(), sp,
                                       torch.from_numpy(mask), WIN, HEADS)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("one_window", [False, True])
def test_plain_matches_port_blocks(one_window):
    """Against the per-block path (torch.erf GELU, the per-block rounding):
    within the A-S erf's error, the tolerance JAX's own test uses."""
    x, _, tblocks, mask, use_shift = _case(one_window)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        ref = xt
        for blk in tblocks:
            ref = blk(ref)
        out = tstage.fused_swin_blocks(
            xt, tstage.stack_block_params(tblocks, WIN, HEADS, use_shift),
            torch.from_numpy(mask), WIN, HEADS, use_shift)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-4)


@pytest.mark.parametrize("one_window", [False, True])
def test_stacked_params_from_flax_equals_port_stack(one_window):
    _, jsp, tblocks, _, use_shift = _case(one_window)
    got = stacked_params_from_flax({k: np.asarray(v) for k, v in jsp.items()})
    want = tstage.stack_block_params(tblocks, WIN, HEADS, use_shift)
    assert set(got) == set(want) == set(tstage.STACK_KEYS)
    for k in tstage.STACK_KEYS:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("case", ["odd_start", "padded", "window"])
def test_stack_block_params_raises(case):
    if case == "odd_start":          # a stack that starts on a shifted block
        blocks = [tswin.SwinBlock(C, (H, W), HEADS, WIN, s)
                  for s in (WIN // 2, 0)]
    elif case == "padded":           # a detection block padded 6 -> 8
        blocks = [tswin.SwinBlock(C, (6, 6), HEADS, WIN, 0,
                                  pad_to_window=True)]
    else:                            # a block whose window was clamped
        blocks = [tswin.SwinBlock(C, (H, W), HEADS, WIN, 0),
                  tswin.SwinBlock(C, (2, 2), HEADS, WIN, 0)]
    with pytest.raises(ValueError):
        tstage.stack_block_params(blocks, WIN, HEADS)


def test_op_on_cpu_takes_plain_path_and_no_grad():
    x, _, tblocks, mask, _ = _case(False)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    sp = tstage.stack_block_params(tblocks, WIN, HEADS)
    before = tstage.fused_swin_blocks.launches
    with torch.no_grad():
        out = tstage.fused_swin_blocks(xt, sp, mt, WIN, HEADS)
    assert tstage.fused_swin_blocks.launches == before
    torch.testing.assert_close(out, tstage.fused_swin_blocks_reference(
        xt, sp, mt, WIN, HEADS), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no gradient"):
        tstage.fused_swin_blocks(xt.requires_grad_(True), sp, mt, WIN, HEADS)


def test_kernel_wrapper_rejects_host_tensors():
    x, _, tblocks, mask, _ = _case(False)
    sp = tstage.stack_block_params(tblocks, WIN, HEADS)
    with pytest.raises(ValueError, match="CUDA"):
        tstage.fused_swin_blocks_cuda(torch.from_numpy(x), sp,
                                      torch.from_numpy(mask), WIN, HEADS)


@pytest.fixture(scope="module")
def tiny_model():
    cfg = FiberConfig.tiny_test(loss_names=("itm", "itc"))
    model = FiberCoarse(cfg, device="cpu", seed=0).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():        # move LayerNorms and biases off 1 / 0
        for name, p in model.named_parameters():
            if name.startswith("vit_model") and p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    img = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    return cfg, model, img


def test_stacked_trunk_matches_encode_image_trunk(tiny_model):
    """The trunk composed from the model's modules with one op per stage
    run (stages 1-2 and the unfused stage-3 blocks) against the per-block
    `encode_image_trunk`."""
    cfg, model, img = tiny_model
    swin = model.vit_model
    n_pre = cfg.swin_depths[2] - (cfg.num_fuse_block - cfg.swin_depths[3])
    with torch.inference_mode():
        stacks = tstage.stack_swin(swin, cfg.swin_depths[:2] + (n_pre,))
        assert len(stacks) == 3
        x = tstage.run_stacks(swin, stacks, img)
        ref = model.encode_image_trunk(img)
    torch.testing.assert_close(x, ref, rtol=0, atol=2e-4)


def test_stacked_itc_tower_matches_vit_model(tiny_model):
    """All four stages, stage 4 one window without shift."""
    cfg, model, img = tiny_model
    swin = model.vit_model
    with torch.inference_mode():
        stacks = tstage.stack_swin(swin)
        assert [s.use_shift for s in stacks] == [False, False, True, False]
        out = tstage.run_stacks(swin, stacks, img)
        ref = swin(img)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-4)
