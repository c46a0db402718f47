"""The port's CoModGAN family against the JAX package's, on the CPU.

Tiny generators are initialized in JAX and carried across with
``load_jax_variables``; the same numpy z, c and images go through both, with
``noise_mode="const"`` (the ``noise_const`` buffers come across too) and the
noise strengths and ``w_avg`` moved off their init so that they count.
Tolerance: fp32 rtol 5e-3 / atol 2e-4, the generator contract of
docs/porting.md:30-32 (observed ~3e-6 on a 2.9-range output). The train step
is held to tests/test_torch_train.py's tolerances, with the noise the two
steps draw replaced by the same numpy arrays (random draws cannot match
across frameworks) and the co-modulation dropout at 0. The int8 routing of
the full-width ADNI CCSR generator is recorded on the meta device and held
to the JAX package's gate and routability rule, conv by conv.
"""

import copy
import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu import models as jmodels  # noqa: E402
from afcm_tpu.nn import CoModGenerator as JaxCoModGenerator  # noqa: E402
from afcm_tpu.nn import ca_variants as jca  # noqa: E402
from afcm_tpu.ops import modulated_conv2d_resample as jax_modconv  # noqa: E402
from afcm_tpu.ops import setup_filter as jax_setup_filter  # noqa: E402
from afcm_tpu_torch.models import (GANConfig, GANModel, build_discriminator,  # noqa: E402
                                   build_eval_model, build_gan_model,
                                   build_generator)
from afcm_tpu_torch.nn import CoModGenerator  # noqa: E402
from afcm_tpu_torch.nn import ca_variants  # noqa: E402
from afcm_tpu_torch.ops import (modulated_conv2d_resample, set_conv_impl,  # noqa: E402
                                setup_filter)
from afcm_tpu_torch.utils.port import (load_jax_train_state,  # noqa: E402
                                       load_jax_variables, variables_to_state_dict)
from tests.test_torch_train import _compare_step  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_TOL = dict(rtol=5e-3, atol=2e-4)
# tests/test_comodgan_parity.py:13-18
GEN = dict(z_dim=64, c_dim=1, w_dim=64, img_resolution=64, img_channels_in=4,
           img_channels_out=1)
SYNTH = dict(channel_base=4096, channel_max=128, skip_resolution=32, cond_mod=True,
             conv_clamp=None, channel_attention=False)
MAP = dict(num_layers=2)
REF_MAP = dict(name="RefMappingNetwork", img_resolution=64, img_channels=1,
               channel_base=4096, channel_max=128)
# configs/adni/comodgan/ccsr.yml's G as the config layer resolves it
CCSR_G = dict(netG="comodgan", z_dim=512, w_dim=512, c_dim=1, img_resolution=256,
              img_channels_in=4, img_channels_out=1,
              synthesis_kwargs=dict(name="SynthesisNetwork", channel_base=16384,
                                    channel_max=512, skip_resolution=256,
                                    cond_mod=True, conv_clamp=None,
                                    channel_attention=False),
              mapping_kwargs=dict(name="MappingNetwork", num_layers=8))
# what phase 12c of chip_smoke.py holds the card to, per batch
CCSR_INT8_ROUTED = 9


def _perturb(tree, rng):
    """Trained-looking state: noise strengths and w_avg off their zero init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("noise_strength", "w_avg"):
            out[k] = np.asarray(rng.randn(*np.shape(v)) * 0.3, np.float32)
        else:
            out[k] = v
    return out


def _init_jax(module, *args, **kwargs):
    variables = module.init({"params": jax.random.PRNGKey(0),
                             "noise": jax.random.PRNGKey(1)}, *args, **kwargs)
    return _perturb(jax.tree.map(np.asarray, dict(variables)), np.random.RandomState(9))


def _inputs(seed=0, n=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 64).astype(np.float32), rng.rand(n, 1).astype(np.float32),
            rng.randn(n, 4, 64, 64).clip(-1, 1).astype(np.float32),
            rng.randn(n, 1, 64, 64).clip(-1, 1).astype(np.float32))


@pytest.mark.parametrize("mapping,attention", [
    (MAP, False), (MAP, True), (REF_MAP, False)],
    ids=["mapping", "channel_attention", "ref_mapping"])
def test_generator_matches_jax(mapping, attention):
    """The tiny CoModGAN generator of tests/test_comodgan_parity.py, with
    the z mapper, with channel attention in the synthesis blocks, and with
    the image mapper (RefMappingNetwork, which maps ref_img)."""
    z, c, cond, ref = _inputs()
    synth = dict(SYNTH, channel_attention=attention)
    jgen = JaxCoModGenerator(mapping_kwargs=dict(mapping), synthesis_kwargs=synth, **GEN)
    variables = _init_jax(jgen, z, c, cond, ref_img=ref, noise_mode="const")
    want = np.asarray(jgen.apply(variables, z, c, cond, ref_img=ref, noise_mode="const"))
    net = CoModGenerator(mapping_kwargs=dict(mapping), synthesis_kwargs=synth, **GEN)
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (z, c, cond)), ref_img=torch.from_numpy(ref),
                  noise_mode="const").numpy()
    assert got.shape == want.shape == (2, 1, 64, 64)
    np.testing.assert_allclose(got, want, **GEN_TOL)


def test_build_generator_and_eval_step_match_jax():
    """build_eval_model of a netG: comodgan config: the EMA G in float32
    whatever the compute dtype (no compute_dtype reaches it), eval_step
    with const noise and ref_img, against afcm_tpu's eval_step."""
    z, c, cond, ref = _inputs(seed=1)
    g_cfg = dict(netG="comodgan", **GEN, synthesis_kwargs=dict(SYNTH, name="SynthesisNetwork"),
                 mapping_kwargs=dict(MAP, name="MappingNetwork", img_resolution=64))
    jgen = jmodels.build_generator(dict(g_cfg))
    variables = _init_jax(jgen, z, c, cond, noise_mode="const")
    want = np.asarray(jgen.apply(variables, z, c, cond, noise_mode="const"))
    model = build_eval_model(g_cfg, compute_dtype="bfloat16")
    load_jax_variables(model.generator_ema, variables)
    assert {p.dtype for p in model.generator_ema.parameters()} == {torch.float32}
    got = model.eval_step(torch.from_numpy(cond), torch.from_numpy(c),
                          z=torch.from_numpy(z), ref_img=torch.from_numpy(ref))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **GEN_TOL)
    assert set(model.generator_ema.state_dict()) == set(variables_to_state_dict(variables))


def test_ca_synthesis_network_matches_jax():
    """CASynthesisNetwork at tests/test_variants.py's size."""
    kw = dict(w_dim=32, img_resolution=32, img_channels_in=4, img_channels_out=1,
              channel_base=512, channel_max=32, skip_resolution=16, cond_mod=True)
    rng = np.random.RandomState(2)
    jnet = jca.CASynthesisNetwork(**kw)
    ws = rng.randn(2, jnet.num_ws, 32).astype(np.float32)
    img = rng.randn(2, 4, 32, 32).astype(np.float32)
    variables = _init_jax(jnet, ws, img, noise_mode="const")
    want = np.asarray(jnet.apply(variables, ws, img, noise_mode="const"))
    net = ca_variants.CASynthesisNetwork(**kw)
    assert net.num_ws == jnet.num_ws
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net(torch.from_numpy(ws), torch.from_numpy(img), noise_mode="const").numpy()
    assert got.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(got, want, **GEN_TOL)


def test_cain_synthesis_network_matches_jax():
    """CAINSynthesisNetwork at tests/test_variants.py's size; its RCAB and
    ResidualGroup building blocks too."""
    kw = dict(w_dim=16, img_resolution=32, img_channels_in=4, img_channels_out=1,
              depth=2, n_resgroups=1, n_resblocks=2)
    rng = np.random.RandomState(3)
    jnet = jca.CAINSynthesisNetwork(**kw)
    ws = rng.randn(1, jnet.num_ws, 16).astype(np.float32)
    img = rng.randn(1, 4, 32, 32).astype(np.float32)
    variables = _init_jax(jnet, ws, img, noise_mode="const")
    want = np.asarray(jnet.apply(variables, ws, img, noise_mode="const"))
    net = ca_variants.CAINSynthesisNetwork(**kw)
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net(torch.from_numpy(ws), torch.from_numpy(img), noise_mode="const").numpy()
    np.testing.assert_allclose(got, want, **GEN_TOL)

    x = rng.randn(2, 32, 8, 8).astype(np.float32)
    for jmod, mod in ((jca.ResidualGroup(2, 32, 3, reduction=16, norm=True),
                       ca_variants.ResidualGroup(2, 32, 3, reduction=16, norm=True)),
                      (jca.RCAB(32, 32, 3, reduction=8, downscale=True),
                       ca_variants.RCAB(32, 32, 3, reduction=8, downscale=True))):
        variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(4), x)))
        load_jax_variables(mod, variables)
        with torch.no_grad():
            got = mod(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, x)), **GEN_TOL)
    np.testing.assert_array_equal(
        ca_variants.pixel_shuffle(torch.from_numpy(x), 1 / 2).numpy(),
        np.asarray(jca.pixel_shuffle(jnp.asarray(x), 1 / 2)))


def test_motion_synthesis_names_its_item():
    """get_synthesizer names MotionSynthesisNetwork in both packages: the
    port's class, whose num_ws and channel widths are the JAX module's at
    the motion family's test size (tests/test_torch_motion.py holds its
    forward); a name neither package has raises naming it."""
    from afcm_tpu.nn.comodgan import get_synthesizer as jax_get_synthesizer
    from afcm_tpu_torch.nn import get_synthesizer, motion
    kw = dict(w_dim=16, motion_v_dim=16, img_resolution=32, img_channels_in=4,
              img_channels_out=1, channel_base=1024, channel_max=32, global_enc=True)
    want = jax_get_synthesizer("MotionSynthesisNetwork")(**kw)
    got = get_synthesizer("MotionSynthesisNetwork")(**kw)
    assert isinstance(got, motion.MotionSynthesisNetwork)
    assert (got.num_ws, got.early_channels, got.global_w_dim) == (
        want.num_ws, want.early_channels, want.global_w_dim)
    for lookup in (jax_get_synthesizer, get_synthesizer):
        with pytest.raises(NotImplementedError, match="NoSuchNetwork"):
            lookup("NoSuchNetwork")


@pytest.mark.parametrize("up,demodulate", [(2, True), (1, True), (1, False)])
def test_modulated_conv2d_resample_matches_jax(up, demodulate):
    """The StyleGAN2 modulated conv with up 2 (a transposed FIR conv) and
    noise, and without demodulation (toRGB)."""
    rng = np.random.RandomState(4 + up)
    x = rng.randn(2, 8, 9, 9).astype(np.float32)
    w = rng.randn(6, 8, 3, 3).astype(np.float32)
    s = (rng.rand(2, 8) + 0.5).astype(np.float32)
    size = 9 * up
    noise = rng.randn(2, 1, size, size).astype(np.float32)
    kw = dict(up=up, padding=1, demodulate=demodulate, flip_weight=(up == 1))
    want = np.asarray(jax_modconv(x, w, s, noise=noise,
                                  resample_filter=jax_setup_filter([1, 3, 3, 1]), **kw))
    got = modulated_conv2d_resample(*map(torch.from_numpy, (x, w, s)),
                                    noise=torch.from_numpy(noise),
                                    resample_filter=setup_filter([1, 3, 3, 1]), **kw)
    assert got.shape == (2, 6, size, size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- the train step ----------------------------------------------------------

TINY_G = dict(netG="comodgan", **GEN,
              synthesis_kwargs=dict(SYNTH, name="SynthesisNetwork", dropout_rate=0.0),
              mapping_kwargs=dict(MAP, name="MappingNetwork"))
TINY_D = dict(netD="comodgan", c_dim=1, img_resolution=64, img_channels=5,
              channel_base=1024, channel_max=32, epilogue_kwargs=dict(mbstd_group_size=2))
STEP_CFG = dict(z_dim=64, c_dim=1, batch_size=2, blur_init_sigma=2.0, blur_fade_kimg=1.0)


def _noise(shape):
    """The noise both steps add where a synthesis layer draws it: a numpy
    function of the shape."""
    shape = tuple(int(d) for d in shape)
    return np.random.RandomState(sum(shape) * 7 + shape[-1]).randn(*shape).astype(np.float32)


def test_train_step_matches_jax(monkeypatch):
    """One CoModGAN step of the port's GANModel.train_step against
    afcm_tpu's _train_step_impl from one GANTrainState, z injected and the
    noise replaced in both: losses, gradients, parameters, EMA, and w_avg,
    which G's two train-mode forwards move and G_ema takes over."""
    rng = np.random.RandomState(0)
    batch = {"A": rng.randn(2, 4, 64, 64).clip(-1, 1).astype(np.float32),
             "B": rng.randn(2, 1, 64, 64).clip(-1, 1).astype(np.float32),
             "slice_idx": rng.rand(2, 1).astype(np.float32)}
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                              jmodels.build_discriminator(dict(TINY_D)),
                              jmodels.GANConfig(**STEP_CFG))
    state = jmodel.init_state(jax.random.PRNGKey(0), {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
    state = jax.tree.map(np.asarray, state)
    # noise that counts: strengths off their zero init
    state = state.replace(params_G=_perturb(state.params_G, np.random.RandomState(1)),
                          params_G_ema=_perturb(state.params_G_ema,
                                                np.random.RandomState(1)))
    net_g = build_generator(dict(TINY_G))
    port = GANModel(GANConfig(**STEP_CFG), copy.deepcopy(net_g), net_g,
                    build_discriminator(dict(TINY_D)))
    load_jax_train_state(port, state)
    w_avg0 = port.generator.mapping.w_avg.clone()

    z = np.random.RandomState(21).randn(2, 64).astype(np.float32)
    key = jax.random.PRNGKey(5)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda k, shape, *a, **kw: jnp.asarray(_noise(shape)))
        new_state, jax_metrics = jax.jit(lambda st, b, z: jmodel._train_step_impl(
            st, b, z, key, key, 2.0))(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.asarray(z))
    new_state = jax.tree.map(np.asarray, new_state)
    comodgan = importlib.import_module("afcm_tpu_torch.nn.comodgan")
    with monkeypatch.context() as mp:
        mp.setattr(comodgan.torch, "randn", lambda shape, **kw: torch.from_numpy(_noise(shape)))
        metrics = port.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                  2.0, z=torch.from_numpy(z),
                                  generator=torch.Generator().manual_seed(0))
    _compare_step(port, new_state, metrics, jax_metrics, "comodgan step", {})
    want_w_avg = new_state.moments_G["mapping"]["w_avg"]
    got_w_avg = port.generator.mapping.w_avg.numpy()
    assert not np.allclose(got_w_avg, w_avg0.numpy())
    np.testing.assert_allclose(got_w_avg, want_w_avg, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port.generator_ema.mapping.w_avg.numpy(), got_w_avg)
    np.testing.assert_allclose(new_state.moments_G_ema["mapping"]["w_avg"], want_w_avg)


def test_w_avg_moves_only_in_train_mode():
    """The mapper's w_avg EMA runs in every train-mode forward (two per
    step unless the forward is shared) and in no eval forward."""
    net = build_generator(dict(TINY_G), generator=torch.Generator().manual_seed(0))
    z, c, cond, _ = map(torch.from_numpy, _inputs(seed=5))
    before = net.mapping.w_avg.clone()
    with torch.no_grad():
        net(z, c, cond, noise_mode="const")
        assert torch.equal(net.mapping.w_avg, before)
        net(z, c, cond, train=True, generator=torch.Generator().manual_seed(1))
    ws = net.mapping(z, c)[:, 0]
    want = ws.mean(0) + (before - ws.mean(0)) * 0.995
    torch.testing.assert_close(net.mapping.w_avg, want.detach(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="generator"):
        net(z, c, cond, train=True)


# -- the int8 routing at full width ------------------------------------------

def _routed_convs(monkeypatch):
    """Every conv the full-width CCSR generator makes under mode 'int8',
    recorded on the meta device: (x shape, w shape, padding, routed)."""
    conv_mod = importlib.import_module("afcm_tpu_torch.ops.conv2d_resample")
    mc = importlib.import_module("afcm_tpu_torch.ops.modulated_conv")
    calls, routed = [], []
    conv = conv_mod.conv2d

    def record(x, w, padding=0, groups=1, flip_weight=True):
        calls.append((tuple(x.shape), tuple(w.shape), padding, groups))
        return conv(x, w, padding=padding, groups=groups, flip_weight=flip_weight)

    def kernel(x, w, padding, extra_scale=None):
        routed.append((tuple(x.shape), tuple(w.shape), padding))
        size = x.shape[2] + 2 * padding - 2
        return x.new_empty((x.shape[0], w.shape[0], size, size))
    monkeypatch.setattr(conv_mod, "conv2d", record)
    monkeypatch.setattr(mc, "conv3x3_int8_ste", kernel)
    net = build_generator(dict(CCSR_G), generator=torch.Generator().manual_seed(0))
    net = net.to("meta")
    set_conv_impl("int8")
    try:
        with torch.no_grad():
            out = net(torch.empty((16, 512), device="meta"),
                      torch.empty((16, 1), device="meta"),
                      torch.empty((16, 4, 256, 256), device="meta"), noise_mode="const")
    finally:
        set_conv_impl("xla")
    assert out.shape == (16, 1, 256, 256)
    return calls, routed


def test_ccsr_int8_routing_matches_jax(monkeypatch):
    """Each conv of the full-width ADNI CCSR generator is routed to K3 under
    mode 'int8' exactly where afcm_tpu's _try_conv_int8 routes it: symmetric
    padding, channels >= 64, its gate (min(O, I) >= 256 and H <= 56) and
    int8_routable. Nine 512 -> 512 convs per batch, at 10^2, 18^2 and 34^2
    padding 0 (the encoder's conv_layer0 and conv0/conv1 of b8-b32; the
    6^2 convs of the 4x4 stage are declined)."""
    from afcm_tpu.ops.modulated_conv import _int8_gate
    from afcm_tpu.ops.pallas.conv_int8 import int8_routable
    calls, routed = _routed_convs(monkeypatch)
    want = [(x, w, p) for x, w, p, groups in calls
            if groups == 1 and min(w[0], w[1]) >= 64 and _int8_gate(x, w)
            and int8_routable(x, w, p, "dots")]
    assert routed == want
    assert len(routed) == CCSR_INT8_ROUTED
    assert sorted({(x[2], p) for x, _, p in routed}) == [(10, 0), (18, 0), (34, 0)]
    assert {w for _, w, _ in routed} == {(512, 512, 3, 3)}
    assert any(x[2] == 6 for x, w, _, _ in calls if w[0] == 512)   # declined


def test_ccsr_config_builds_the_comodgan_model():
    """configs/adni/comodgan/ccsr.yml through build_gan_model: the G of
    CCSR_G (D follows tpu.compute_dtype, G stays float32), and the mapper's
    w_avg and the noise buffers in G_ema's state_dict."""
    pytest.importorskip("yaml")
    from afcm_tpu_torch.config import default_argument_parser
    cfg = default_argument_parser(["--config-file",
                                   os.path.join(REPO, "configs/adni/comodgan/ccsr.yml"),
                                   "tpu.compute_dtype", "bfloat16"])
    g = dict(cfg.model.G)
    for key in ("netG", "z_dim", "w_dim", "c_dim", "img_resolution", "img_channels_in",
                "img_channels_out"):
        assert g[key] == CCSR_G[key], key
    sk = dict(g["synthesis_kwargs"])
    assert {k: sk[k] for k in CCSR_G["synthesis_kwargs"]} == CCSR_G["synthesis_kwargs"]
    model = build_gan_model(cfg, generator=torch.Generator().manual_seed(0))
    assert isinstance(model.generator, CoModGenerator)
    assert model.discriminator.compute_dtype == torch.bfloat16
    keys = set(model.generator_ema.state_dict())
    assert "mapping.w_avg" in keys and "synthesis.b256.conv1.noise_const" in keys


def test_jax_comodgan_checkpoint_converts(tmp_path):
    """scripts/jax_ckpt_to_torch.py on a tiny JAX CoModGAN state: the EMA G,
    G and D load strictly into the port's nets, noise_const and w_avg
    included."""
    import importlib.util
    from afcm_tpu.utils.checkpoint import save_generator_only, save_state
    rng = np.random.RandomState(0)
    batch = {"A": rng.randn(1, 4, 64, 64).astype(np.float32),
             "B": rng.randn(1, 1, 64, 64).astype(np.float32),
             "slice_idx": rng.rand(1, 1).astype(np.float32)}
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                              jmodels.build_discriminator(dict(TINY_D)),
                              jmodels.GANConfig(**STEP_CFG))
    state = jax.tree.map(np.asarray, jmodel.init_state(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    state = state.replace(moments_G_ema=_perturb(state.moments_G_ema, rng))
    save_generator_only(state, str(tmp_path), "latest")
    save_state(state, str(tmp_path), "latest")
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts", "jax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    ema_path = script.convert(str(tmp_path), "latest")
    g_path, d_path = script.convert_train_state(str(tmp_path), "latest")
    for path, net in ((ema_path, build_generator(dict(TINY_G))),
                      (g_path, build_generator(dict(TINY_G))),
                      (d_path, build_discriminator(dict(TINY_D)))):
        net.load_state_dict(torch.load(path, weights_only=True), strict=True)
    ema = build_generator(dict(TINY_G))
    ema.load_state_dict(torch.load(ema_path, weights_only=True), strict=True)
    np.testing.assert_array_equal(ema.mapping.w_avg.numpy(),
                                  state.moments_G_ema["mapping"]["w_avg"])
    np.testing.assert_array_equal(
        ema.synthesis.b64.conv1.noise_const.numpy(),
        state.constants_G["synthesis"]["b64"]["conv1"]["noise_const"])


@pytest.mark.slow
def test_full_width_ccsr_generator_matches_jax():
    """The full-width ADNI CCSR generator (256^2, 4-slice input, c_dim 1) at
    batch 1, JAX's init carried across, const noise: within the generator
    tolerance (run by itself with -m slow; its max error is in PERF.md)."""
    rng = np.random.RandomState(11)
    z = rng.randn(1, 512).astype(np.float32)
    c = rng.rand(1, 1).astype(np.float32)
    cond = rng.randn(1, 4, 256, 256).clip(-1, 1).astype(np.float32)
    jgen = jmodels.build_generator(dict(CCSR_G))
    variables = _init_jax(jgen, z, c, cond, noise_mode="const")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jgen.apply(variables, z, c, cond, noise_mode="const"))
    net = build_generator(dict(CCSR_G))
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (z, c, cond)), noise_mode="const").numpy()
    err = float(np.abs(got - want).max())
    print(f"full-width CCSR max |port - JAX| {err:.3g}, max |JAX| {np.abs(want).max():.3g}")
    np.testing.assert_allclose(got, want, **GEN_TOL)


def test_port_checkpoint_dict_of_a_jax_state_loads(tmp_path):
    """load_jax_train_state takes a CoModGAN state as flax's msgpack_restore
    gives it (dicts for the optax tuples)."""
    from flax import serialization
    rng = np.random.RandomState(1)
    batch = {"A": rng.randn(1, 4, 64, 64).astype(np.float32),
             "B": rng.randn(1, 1, 64, 64).astype(np.float32),
             "slice_idx": rng.rand(1, 1).astype(np.float32)}
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                              jmodels.build_discriminator(dict(TINY_D)),
                              jmodels.GANConfig(**STEP_CFG))
    state = jax.tree.map(np.asarray, jmodel.init_state(
        jax.random.PRNGKey(2), {k: jnp.asarray(v) for k, v in batch.items()}))
    port = GANModel(GANConfig(**STEP_CFG), build_generator(dict(TINY_G)),
                    build_generator(dict(TINY_G)), build_discriminator(dict(TINY_D)))
    load_jax_train_state(port, SimpleNamespace(**serialization.to_state_dict(state)))
    np.testing.assert_array_equal(
        port.generator_ema.synthesis.b8.conv0.noise_const.numpy(),
        state.constants_G["synthesis"]["b8"]["conv0"]["noise_const"])


def test_cli_train_evaluate_export_serve_tiny_comodgan(tmp_path):
    """The tiny demo config as a CoModGAN model (``model.name comodgan
    model.G.netG comodgan``: 64^2, 32 channels) through the train CLI (two
    steps, w_avg moved in the saved G_ema), the evaluate CLI, the export CLI
    (an artifact with no filtered_lrelu node) and the serve CLI, whose
    volume from the artifact equals its in-process one."""
    pytest.importorskip("h5py")
    import glob
    from afcm_tpu_torch import serve
    from afcm_tpu_torch import train as train_cli
    from afcm_tpu_torch.data.demo import write_demo_tree
    from afcm_tpu_torch.evaluate import main as evaluate_main
    from afcm_tpu_torch.infer import export
    from afcm_tpu_torch.utils.nifti import read_nifti
    write_demo_tree(str(tmp_path / "data"), n_train=1, n_val=1, n_test=1, depth=8, size=64)
    argv = ["--config-file", os.path.join(REPO, "configs/demo/cmsr_tiny.yml"),
            "--device", "cpu", "model.name", "comodgan", "model.G.netG", "comodgan",
            "loaders.train.file_paths", f"['{tmp_path}/data/train']",
            "loaders.val.file_paths", f"['{tmp_path}/data/val']",
            "loaders.test.file_paths", f"['{tmp_path}/data/test']",
            "checkpoints_dir", str(tmp_path / "checkpoints")]
    val = train_cli.main(argv + ["trainer.max_iters", "4"])
    assert np.isfinite(val["psnr"]) and np.isfinite(val["ssim"])
    run_dir = tmp_path / "checkpoints" / "demo_tiny"
    ema = torch.load(run_dir / "latest_net_G_ema.pth", weights_only=True)
    assert "synthesis.b64.conv1.noise_const" in ema and float(ema["mapping.w_avg"].abs().max()) > 0
    result = evaluate_main(argv)
    assert np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])

    art = export.main(argv)
    assert export.count_nodes(export.load_exported(art)[0]) == 0
    out1 = serve.main(argv + ["--out", str(tmp_path / "out1")])
    out2 = serve.main(argv + ["--artifact", art, "--out", str(tmp_path / "out2")])
    (f1,), (f2,) = (sorted(glob.glob(d + "/*_predictions0.nii.gz")) for d in (out1, out2))
    v1, v2 = read_nifti(f1)[0], read_nifti(f2)[0]
    assert v1.shape == (8, 64, 64) and np.abs(v1 - v2).max() < 5e-6
