"""The plain reference against the port's plain CPU path on
``configs/demo/cmsr_tiny.yml`` (and its CoModGAN variant), in float32."""

import copy

import numpy as np
import pytest
import torch

from portbench.reference.gan import GAN, build_discriminator, build_generator, eval_forward
from portbench.tests.tiny import tiny_config


def weights(cfg, seed=3):
    gen = torch.Generator().manual_seed(seed)
    g = build_generator(cfg["model"]["G"], generator=gen)
    d = build_discriminator(cfg["model"]["D"], generator=gen)
    return g, d


def batch(cfg, n, seed=4):
    gen = torch.Generator().manual_seed(seed)
    res = cfg["model"]["G"]["img_resolution"]
    return {"A": torch.rand((n, 4, res, res), generator=gen) * 2 - 1,
            "B": torch.rand((n, 1, res, res), generator=gen) * 2 - 1,
            "slice_idx": torch.rand((n, 1), generator=gen)}


@pytest.mark.parametrize("net_g", ["stylegan3", "comodgan"])
def test_reference_generator_equals_the_port(net_g):
    from afcm_tpu_torch.models import build_eval_model
    from afcm_tpu_torch.models.gan_model import eval_forward as port_forward
    cfg = tiny_config(net_g)
    g, _ = weights(cfg)
    port = build_eval_model(dict(cfg["model"]["G"]), compute_dtype="float32")
    port.generator_ema.load_state_dict(g.state_dict(), strict=True)
    b = batch(cfg, 3)
    z = torch.randn((3, cfg["model"]["G"]["z_dim"]), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = port_forward(port.generator_ema, 1, b["A"], b["slice_idx"], z)
        got = eval_forward(g.eval(), 1, b["A"], b["slice_idx"], z)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("net_g", ["stylegan3", "comodgan"])
def test_reference_train_steps_equal_the_port(net_g):
    from afcm_tpu_torch.config.config import CfgNode
    from afcm_tpu_torch.models import build_gan_model
    cfg = tiny_config(net_g)
    g, d = weights(cfg)
    port = build_gan_model(CfgNode(copy.deepcopy(cfg)))
    port.generator.load_state_dict(g.state_dict())
    port.generator_ema.load_state_dict(g.state_dict())
    port.discriminator.load_state_dict(d.state_dict())
    ref = GAN(cfg, g, d)
    n = cfg["loaders"]["batch_size"]
    for step in range(2):
        b = batch(cfg, n, seed=10 + step)
        want = port.train_step(b, float((step + 1) * n), with_r1=True,
                               generator=torch.Generator().manual_seed(20 + step))
        got = ref.train_step(b, float((step + 1) * n), True,
                             torch.Generator().manual_seed(20 + step))
        for key in got:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-6)
    for mine, theirs in ((g, port.generator), (d, port.discriminator),
                         (ref.generator_ema, port.generator_ema)):
        for (k, a), (_, b_) in zip(mine.named_parameters(), theirs.named_parameters()):
            torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-5, msg=k)
