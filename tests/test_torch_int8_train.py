"""The train step under the int8 conv (K4: K3 forward, fp32 conv adjoint
backward) against the JAX package's, on CPU.

Both packages route every eligible 3x3 conv of tests/test_torch_train.py's
tiny G and D (channel floor 32, mode ``int8_all``; the JAX package through
its off-TPU test hook, its Pallas kernel in interpret mode), so the step's
G forwards, D forwards and the R1 penalty's double backward through D all
run through the routed convs: JAX differentiates its ``custom_vjp``'s
backward rule, the port K4's backward, both the fp32 conv adjoint. One step
from one ``GANTrainState`` with z injected; the gradients (Adam's first
moment at beta1 0) are held per net at >= 30 dB, the bound of the int8
straight-through gradients (tests/test_conv_int8.py:139-159), against JAX's
int8 step and against the port's float step; the losses G_GAN, G_L1,
D_real and D_fake at rtol 5e-3, the generator contract of
docs/porting.md:30-32. D_r1 is held finite only: the penalty is the norm of
D's input gradient, which at this D's init moves by ~20% between two int8
forwards that differ by one bf16 unit in a few elements (the port's K4
backward fed the JAX step's forward values gives JAX's input gradient
within 1e-3 in L2), and D's gradients, which carry R1's, are held at 30 dB.

A gradient 30 dB from another over a whole net does not show that K4's
backward is the straight-through rule inside the step, so the port's step
is also audited call by call with chip_smoke.py's ``ste_backward_audit``
(phase 18's check): every routed conv's dx and dw against the fp32 conv
adjoint at its own saved x and w and incoming dy, within
``chip_smoke.STE_BOUND`` in relative L2.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu import models as jmodels  # noqa: E402
from afcm_tpu.ops import modulated_conv as jmc  # noqa: E402
from afcm_tpu_torch.models import (GANConfig, GANModel, build_discriminator,  # noqa: E402
                                   build_generator)
from afcm_tpu_torch.ops import modulated_conv as tmc  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_train_state  # noqa: E402
from tests.test_torch_int8 import _psnr  # noqa: E402
from tests.test_torch_train import (STEP_CFG, TINY_D, TINY_G, _adam_mu_nu,  # noqa: E402
                                    _batch)

torch.set_num_threads(1)

# one step's calls of conv2d in the port and the routed ones among them:
# G's 10 in each of its two forwards (8 routed), D's 5 in each of its three
# (3 routed); the JAX step runs D a fourth time for R1's gradient
CONV_CALLS, ROUTED = 2 * 10 + 3 * 5, 2 * 8 + 3 * 3


def _spy(module, monkeypatch):
    calls = []
    original = module._try_conv_int8

    def wrapped(x, w, padding):
        y = original(x, w, padding)
        calls.append((tuple(x.shape), tuple(w.shape), y is not None))
        return y
    monkeypatch.setattr(module, "_try_conv_int8", wrapped)
    return calls


def _port_step(state, batch, z):
    net_g = build_generator(dict(TINY_G))
    port = GANModel(GANConfig(**STEP_CFG), copy.deepcopy(net_g), net_g,
                    build_discriminator(dict(TINY_D)))
    load_jax_train_state(port, state)
    metrics = port.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                              2.0, z=torch.from_numpy(z))
    grads = {name: {k: opt.state[p]["exp_avg"].numpy() for k, p in net.named_parameters()}
             for name, net, opt in (("G", port.generator, port.opt_G),
                                    ("D", port.discriminator, port.opt_D))}
    return metrics, grads


def _flat(grads):
    return np.concatenate([g.ravel() for _, g in sorted(grads.items())])


def test_int8_train_step_matches_jax(monkeypatch):
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                              jmodels.build_discriminator(dict(TINY_D)),
                              jmodels.GANConfig(**STEP_CFG))
    state = jax.tree.map(np.asarray, jmodel.init_state(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in _batch(0).items()}))
    batch = _batch(41)
    z = np.random.RandomState(42).randn(2, 32).astype(np.float32)
    _, float_grads = _port_step(state, batch, z)

    saved = jmc._FORCE_INT8
    jax_calls, port_calls = _spy(jmc, monkeypatch), _spy(tmc, monkeypatch)
    try:
        jmc._FORCE_INT8 = True
        for module in (jmc, tmc):
            module.set_conv_impl("int8_all", min_ch=32)
        key = jax.random.PRNGKey(5)
        new_state, jax_metrics = jax.jit(lambda st, b, z: jmodel._train_step_impl(
            st, b, z, key, key, 2.0))(jax.tree.map(jnp.asarray, state),
                                       {k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.asarray(z))
        metrics, grads = _port_step(state, batch, z)
    finally:
        jmc._FORCE_INT8 = saved
        for module in (jmc, tmc):
            module.set_conv_impl("xla", min_ch=64)

    assert set(port_calls) == set(jax_calls)
    assert len(port_calls) == CONV_CALLS and sum(c[2] for c in port_calls) == ROUTED
    assert len(jax_calls) == CONV_CALLS + 5 and sum(c[2] for c in jax_calls) == ROUTED + 3
    assert np.isfinite(float(metrics["D_r1"]))
    for k in ("G_GAN", "G_L1", "D_real", "D_fake"):
        np.testing.assert_allclose(float(metrics[k]), float(jax_metrics[k]), rtol=5e-3,
                                   err_msg=k)
    new_state = jax.tree.map(np.asarray, new_state)
    for name, opt_state in (("G", new_state.opt_state_G), ("D", new_state.opt_state_D)):
        want = _adam_mu_nu(opt_state)[0]
        got, flt = _flat(grads[name]), _flat(float_grads[name])
        assert _psnr(got, _flat(want)) >= 30, name
        assert _psnr(got, flt) >= 30 and not np.array_equal(got, flt), name


def test_int8_train_step_backward_is_the_fp32_adjoint(monkeypatch):
    """Each routed conv of the tiny step gets at least one K4 backward but
    G's 8 in the D phase's forward, whose fake is detached (R1's gradient
    and D's loss both cross D's forward on real images), and every call's
    dx and dw is the fp32 conv adjoint at its inputs."""
    import chip_smoke
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                              jmodels.build_discriminator(dict(TINY_D)),
                              jmodels.GANConfig(**STEP_CFG))
    state = jax.tree.map(np.asarray, jmodel.init_state(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in _batch(0).items()}))
    z = np.random.RandomState(42).randn(2, 32).astype(np.float32)
    calls = _spy(tmc, monkeypatch)
    try:
        tmc.set_conv_impl("int8_all", min_ch=32)
        with chip_smoke.ste_backward_audit() as errors:
            metrics, _ = _port_step(state, _batch(41), z)
    finally:
        tmc.set_conv_impl("xla", min_ch=64)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert sum(c[2] for c in calls) == ROUTED
    assert sum(e[0] for e in errors) == ROUTED - 8
    assert len(errors) == ROUTED - 8 + 3        # D's 3 on real images, twice
    for first, dx_err, dw_err in errors:
        assert dx_err is not None and dx_err <= chip_smoke.STE_BOUND, errors
        assert dw_err is None or dw_err <= chip_smoke.STE_BOUND, errors
