"""Style mixing in the port's train step against the JAX package's, on CPU.

The counterparts of tests/test_train_step.py:125,220: whole steps of
``GANModel.train_step`` with ``style_mixing_prob`` 0.9 against
``afcm_tpu``'s ``_train_step_impl`` from one ``GANTrainState``, plain (two G
forwards) and with ``shared_g_fwd``, mixing on and off by the coin. Random
draws cannot match across frameworks, so the JAX step's ``(z2, cutoff,
coin)`` are made from its keys with ``jax.random`` exactly as
``afcm_tpu/models/gan_model.py:167-181`` makes them and passed to the port
as ``StyleMix``; the keys are the first whose coin falls each way. The
steps are held to tests/test_torch_train.py's tolerances (``_compare_step``:
losses rtol 1e-4, gradients rtol 1e-3 / atol 1e-3·max|g|, parameters and
EMA 1e-5), and the mapper's ``w_avg``, which the mixed forward moves in both
generator families, at rtol 1e-5 / atol 1e-6.
"""

import copy
import importlib
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu import models as jmodels  # noqa: E402
from afcm_tpu_torch import parallel  # noqa: E402
from afcm_tpu_torch.models import (GANConfig, GANModel, StyleMix,  # noqa: E402
                                   build_discriminator, build_generator)
from afcm_tpu_torch.utils.port import load_jax_train_state  # noqa: E402
from tests import test_torch_comodgan as comod  # noqa: E402
from tests.test_torch_train import (STEP_CFG, TINY_D, TINY_G, _batch,  # noqa: E402
                                    _compare_step)

torch.set_num_threads(1)

PROB = 0.9            # tests/test_train_step.py:127
NUM_WS = 6            # the tiny G's num_layers 4 + 2


def _mix_draws(key, z_shape, num_ws=NUM_WS):
    """JAX's style-mixing draws of one ``_run_g`` call with ``key``."""
    rng_mix = jax.random.split(key, 3)[2]
    rng_z2, rng_cut, rng_coin = jax.random.split(rng_mix, 3)
    z2 = np.array(jax.random.normal(rng_z2, z_shape), np.float32)
    cutoff = int(jax.random.randint(rng_cut, (), 1, num_ws))
    coin = bool(jax.random.uniform(rng_coin, ()) < PROB)
    return StyleMix(torch.from_numpy(z2), cutoff, coin)


def _keys(coin, count=1, z_shape=(2, 32)):
    """The first ``count`` keys PRNGKey(i) whose coin falls as ``coin``."""
    found = []
    for i in range(200):
        if _mix_draws(jax.random.PRNGKey(i), z_shape).coin == coin:
            found.append(jax.random.PRNGKey(i))
            if len(found) == count:
                return found
    raise AssertionError("no key")


@pytest.fixture(scope="module")
def jax_state():
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                              jmodels.build_discriminator(dict(TINY_D)),
                              jmodels.GANConfig(**STEP_CFG))
    state = jmodel.init_state(jax.random.PRNGKey(0),
                              {k: jnp.asarray(v) for k, v in _batch(0).items()})
    return jax.tree.map(np.asarray, state)


def _keys_of(case):
    on, on2 = _keys(True, 2)
    off = _keys(False)[0]
    return {"two_forwards_mixed": (on, on2), "two_forwards_d_unmixed": (off, on),
            "shared_mixed": (on, on), "shared_unmixed": (off, off)}[case]


@pytest.mark.parametrize("case", ["two_forwards_mixed", "two_forwards_d_unmixed",
                                  "shared_mixed", "shared_unmixed"])
def test_mixed_step_matches_jax(jax_state, case):
    """One step with style_mixing_prob 0.9: the D phase's and the G phase's
    forwards take the draws of the JAX step's rng_gd and rng_gg (equal keys
    for the shared forward, which draws once)."""
    cfg = dict(STEP_CFG, style_mixing_prob=PROB, shared_g_fwd=case.startswith("shared"))
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                              jmodels.build_discriminator(dict(TINY_D)),
                              jmodels.GANConfig(**cfg))
    net_g = build_generator(dict(TINY_G))
    port = GANModel(GANConfig(**cfg), copy.deepcopy(net_g), net_g,
                    build_discriminator(dict(TINY_D)))
    load_jax_train_state(port, jax_state)
    w_avg0 = port.generator.mapping.w_avg.clone()

    key_gd, key_gg = _keys_of(case)
    batch = _batch(31)
    z = np.random.RandomState(32).randn(2, 32).astype(np.float32)
    state, jax_metrics = jax.jit(lambda st, b, z: jmodel._train_step_impl(
        st, b, z, key_gd, key_gg, 2.0))(jax.tree.map(jnp.asarray, jax_state),
                                        {k: jnp.asarray(v) for k, v in batch.items()},
                                        jnp.asarray(z))
    state = jax.tree.map(np.asarray, state)
    mixes = [_mix_draws(key_gd, z.shape), _mix_draws(key_gg, z.shape)]
    assert [m.coin for m in mixes] == {"two_forwards_mixed": [True, True],
                                       "two_forwards_d_unmixed": [False, True],
                                       "shared_mixed": [True, True],
                                       "shared_unmixed": [False, False]}[case]
    metrics = port.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                              2.0, z=torch.from_numpy(z), mix=mixes)
    _compare_step(port, state, metrics, jax_metrics, case, {})
    want = state.moments_G["mapping"]["w_avg"]
    got = port.generator.mapping.w_avg.numpy()
    assert not np.allclose(got, w_avg0.numpy())        # the mixed forward moved it
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port.generator_ema.mapping.w_avg.numpy(), got)


def test_mixed_forward_takes_the_second_latents_styles_from_the_cutoff():
    """The styles the synthesis gets: those of z before the cutoff, those of
    z2 from it on, when the coin says mix; those of z alone when not."""
    cfg = GANConfig(**dict(STEP_CFG, style_mixing_prob=PROB))
    net_g = build_generator(dict(TINY_G), generator=torch.Generator().manual_seed(0))
    port = GANModel(cfg, copy.deepcopy(net_g), net_g,
                    build_discriminator(dict(TINY_D), generator=torch.Generator().manual_seed(1)))
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    z, z2 = torch.randn(2, 32), torch.randn(2, 32)
    c = port._cond(batch)
    seen = []
    hook = net_g.synthesis.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            for coin in (True, False):
                port._run_g(z, c, batch["A"], batch["B"], None, StyleMix(z2, 4, coin))
            want_z, want_z2 = net_g.mapping(z, c), net_g.mapping(z2, c)
    finally:
        hook.remove()
    torch.testing.assert_close(seen[0][:, :4], want_z[:, :4], rtol=0, atol=0)
    torch.testing.assert_close(seen[0][:, 4:], want_z2[:, 4:], rtol=0, atol=0)
    torch.testing.assert_close(seen[1], want_z, rtol=0, atol=0)


def test_mix_draws_are_the_global_batchs_on_every_rank():
    """Under data parallelism z2 is drawn for the global batch and sliced,
    and the cutoff and the coin are one draw each, equal on every rank."""
    cfg = GANConfig(**dict(STEP_CFG, style_mixing_prob=PROB))
    port = GANModel(cfg, build_generator(dict(TINY_G)))
    whole = port._draw_mix(torch.zeros(4, 32), NUM_WS, torch.Generator().manual_seed(7))
    for rank in range(2):
        group = types.SimpleNamespace(rank=rank, world=2,
                                      rows=lambda n, r=rank: slice(r * n, (r + 1) * n))
        draws = parallel.GlobalDraws(torch.Generator().manual_seed(7), group)
        got = port._draw_mix(torch.zeros(2, 32), NUM_WS, draws)
        assert torch.equal(got.z2, whole.z2[2 * rank:2 * rank + 2])
        assert int(got.cutoff) == int(whole.cutoff) and bool(got.coin) == bool(whole.coin)
    assert 1 <= int(whole.cutoff) < NUM_WS


def test_comodgan_mixed_step_matches_jax(monkeypatch):
    """The CoModGAN family under style mixing (coin true): as
    tests/test_torch_comodgan.py's step, the noise replaced in both by the
    same numpy arrays; JAX's z2 is a ``jax.random.normal`` draw too, so it is
    that replacement's array, and the port is given it."""
    cfg = dict(comod.STEP_CFG, style_mixing_prob=PROB)
    rng = np.random.RandomState(0)
    batch = {"A": rng.randn(2, 4, 64, 64).clip(-1, 1).astype(np.float32),
             "B": rng.randn(2, 1, 64, 64).clip(-1, 1).astype(np.float32),
             "slice_idx": rng.rand(2, 1).astype(np.float32)}
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(comod.TINY_G)),
                              jmodels.build_discriminator(dict(comod.TINY_D)),
                              jmodels.GANConfig(**cfg))
    state = jmodel.init_state(jax.random.PRNGKey(0), {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
    state = jax.tree.map(np.asarray, state)
    state = state.replace(
        params_G=comod._perturb(state.params_G, np.random.RandomState(1)),
        params_G_ema=comod._perturb(state.params_G_ema, np.random.RandomState(1)))
    net_g = build_generator(dict(comod.TINY_G))
    num_ws = net_g.synthesis.num_ws
    port = GANModel(GANConfig(**cfg), copy.deepcopy(net_g), net_g,
                    build_discriminator(dict(comod.TINY_D)))
    load_jax_train_state(port, state)

    z = np.random.RandomState(21).randn(2, 64).astype(np.float32)
    # the second key whose coin mixes: with the first, one element of
    # synthesis.e_b4.conv_layer1.weight with |g| 1.4e-6 (4e-7 of max|g|)
    # moved by Adam 1.24e-5 against the 1e-5 of _compare_step, the Adam
    # sensitivity its docstring describes; its gradient held
    key = [jax.random.PRNGKey(i) for i in range(200)
           if _mix_draws(jax.random.PRNGKey(i), z.shape, num_ws).coin][1]
    mix = _mix_draws(key, z.shape, num_ws)
    mix = mix._replace(z2=torch.from_numpy(comod._noise(z.shape)))
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda k, shape, *a, **kw: jnp.asarray(comod._noise(shape)))
        new_state, jax_metrics = jax.jit(lambda st, b, z: jmodel._train_step_impl(
            st, b, z, key, key, 2.0))(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.asarray(z))
    new_state = jax.tree.map(np.asarray, new_state)
    comodgan = importlib.import_module("afcm_tpu_torch.nn.comodgan")
    with monkeypatch.context() as mp:
        mp.setattr(comodgan.torch, "randn", lambda shape, **kw: torch.from_numpy(comod._noise(shape)))
        metrics = port.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                  2.0, z=torch.from_numpy(z), mix=mix,
                                  generator=torch.Generator().manual_seed(0))
    _compare_step(port, new_state, metrics, jax_metrics, "comodgan mixed step", {})
    np.testing.assert_allclose(port.generator.mapping.w_avg.numpy(),
                               new_state.moments_G["mapping"]["w_avg"], rtol=1e-5, atol=1e-6)


def test_ref_mapping_network_raises_under_style_mixing_in_both_packages():
    """The RefMappingNetwork mapper maps the reference image, not a latent:
    the JAX step's mixed forward calls it without one and fails its
    assertion; the port's raises too. Neither is repaired on one side."""
    g = dict(comod.TINY_G, mapping_kwargs=comod.REF_MAP)
    cfg = dict(comod.STEP_CFG, style_mixing_prob=PROB)
    rng = np.random.RandomState(0)
    batch = {"A": rng.randn(2, 4, 64, 64).clip(-1, 1).astype(np.float32),
             "B": rng.randn(2, 1, 64, 64).clip(-1, 1).astype(np.float32),
             "slice_idx": rng.rand(2, 1).astype(np.float32)}
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(g)),
                              jmodels.build_discriminator(dict(comod.TINY_D)),
                              jmodels.GANConfig(**cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jmodel.init_state(jax.random.PRNGKey(0), jbatch)
    z = jnp.zeros((2, 64))
    with pytest.raises(AssertionError):
        jmodel._train_step_impl(state, jbatch, z, jax.random.PRNGKey(1),
                                jax.random.PRNGKey(1), 2.0)
    net_g = build_generator(dict(g))
    port = GANModel(GANConfig(**cfg), copy.deepcopy(net_g), net_g,
                    build_discriminator(dict(comod.TINY_D)))
    with pytest.raises(ValueError, match="RefMappingNetwork"):
        port.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, 2.0,
                        z=torch.zeros(2, 64), generator=torch.Generator().manual_seed(0))
