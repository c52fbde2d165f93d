"""The port's detector against the JAX package's at FIBER-B widths and
depth (Swin-B 128 / (2, 2, 18, 2), RoBERTa-base, 6 fused blocks, FPN 256,
6 DyConvs with deform, T = 256) at 320x480, fp32 on the CPU: every head
output at every level and the language dict within 1e-3 of each tensor's
max-abs.  Minutes of JAX compile and CPU time: the slow tier."""

import pytest
import torch

from torch_detection_parity import (assert_heads_match, build_detectors,
                                    inputs, jax_forward, port_forward)

pytestmark = pytest.mark.slow

torch.set_num_threads(4)


def test_whole_detector_parity_fulldim():
    jmodel, variables, tmodel, _ = build_detectors(
        0, full=True, image_size=(320, 480))
    batch = inputs(jmodel.cfg, 1, 0)
    jout = jax_forward(jmodel)(variables, batch["images"],
                               batch["input_ids"], batch["attention_mask"])
    assert_heads_match(jout, port_forward(tmodel, batch))
