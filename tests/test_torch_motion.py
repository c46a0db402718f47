"""The port's StyleGAN-V (motion) family and grid_sample against the JAX
package's, on the CPU.

Modules are initialized in JAX and carried across with
``load_jax_variables``; the same numpy inputs (frame times, the trajectory
noise ``motion_z``, images) go through both, with ``noise_mode="const"``
and the noise strengths and ``w_avg`` moved off their init so that they
count. The sizes are those of tests/test_motion_parity.py. Tolerances: the
time encoders and the motion mapping rtol 1e-5 / atol 1e-5 (a few float32
ops apart); the generator and the discriminator rtol 5e-3 / atol 2e-4, the
generator contract of docs/porting.md:30-32; D's parameter gradients rtol
1e-3 / atol 1e-4·max|g|; grid_sample rtol 1e-5 / atol 1e-5 against JAX's
and ``F.grid_sample``, its second-order gradients rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from afcm_tpu.nn import motion as jmotion  # noqa: E402
from afcm_tpu.nn.comodgan import CoModGenerator as JaxCoModGenerator  # noqa: E402
from afcm_tpu.ops import grid_sample as jax_grid_sample  # noqa: E402
from afcm_tpu_torch.nn import CoModGenerator, get_synthesizer, motion  # noqa: E402
from afcm_tpu_torch.ops import grid_sample  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_variables  # noqa: E402

torch.set_num_threads(1)

MAX_NUM_FRAMES = 8
MOTION_KW = dict(motion_z_dim=8, motion_z_distance=2, motion_kernel_size=3,
                 time_encoder_kwargs=dict(dim=8, min_period_len=2, max_period_len=8))
GEN = dict(z_dim=16, c_dim=1, w_dim=16, motion_v_dim=16, img_resolution=32,
           img_channels_in=4, img_channels_out=1, max_num_frames=MAX_NUM_FRAMES)
GEN_SYNTH = dict(channel_base=1024, channel_max=32, skip_resolution=16, cond_mod=True,
                 global_enc=True, conv_clamp=256)
DISC = dict(c_dim=1, img_resolution=32, img_channels=1, num_frames=3,
            channel_base=2048, channel_max=32, conv_clamp=256,
            num_frames_div_factor=2, max_num_frames=MAX_NUM_FRAMES, concat_res=16,
            epilogue_kwargs=dict(mbstd_group_size=2))
CLOSE = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=5e-3, atol=2e-4)


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
    init = jax.jit(lambda *a: module.init({"params": jax.random.PRNGKey(0),
                                           "noise": jax.random.PRNGKey(1)}, *a, **kwargs))
    variables = init(*args)
    return _perturb(jax.tree.map(np.asarray, dict(variables)), np.random.RandomState(9))


def _traj_inputs(rng, batch, motion_z_dim, motion_z_distance, kernel_size):
    max_traj_len = int(np.ceil((MAX_NUM_FRAMES - 1) / motion_z_distance)) \
        + 2 + (kernel_size - 1) * 2
    t = rng.randint(0, MAX_NUM_FRAMES - 1, size=(batch, 1)).astype(np.float32)
    motion_z = rng.randn(batch, max_traj_len, motion_z_dim).astype(np.float32)
    return t, motion_z


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_time_encoders_match_jax():
    """construct_log_spaced_freqs exactly; FixedTimeEncoder and
    TemporalDifferenceEncoder (its embedding carried across) on the same
    time differences, two of them at .5 (round half to even in both)."""
    for frames, skip in ((8, 0), (128, 0), (100, 2)):
        np.testing.assert_array_equal(motion.construct_log_spaced_freqs(frames, skip),
                                      jmotion.construct_log_spaced_freqs(frames, skip))
    delta_t = np.array([[0.0], [1.5], [2.5], [7.0]], np.float32)
    enc = jmotion.FixedTimeEncoder(MAX_NUM_FRAMES)
    want = np.asarray(enc.apply({}, delta_t))
    port = motion.FixedTimeEncoder(MAX_NUM_FRAMES)
    assert port.get_dim() == enc.get_dim() == want.shape[1]
    np.testing.assert_allclose(port(*_t(delta_t)).numpy(), want, **CLOSE)

    jenc = jmotion.TemporalDifferenceEncoder(MAX_NUM_FRAMES, d=16)
    variables = jax.tree.map(np.asarray, dict(jenc.init(jax.random.PRNGKey(3), delta_t)))
    tenc = load_jax_variables(motion.TemporalDifferenceEncoder(MAX_NUM_FRAMES, d=16),
                              variables)
    assert set(tenc.state_dict()) == {"const_embed.weight"}
    want = np.asarray(jenc.apply(variables, delta_t))
    assert tenc.get_dim() == jenc.get_dim() == want.shape[1]
    np.testing.assert_allclose(tenc(*_t(delta_t)).detach().numpy(), want, **CLOSE)


@pytest.mark.parametrize("fourier,z_dim", [(True, 8), (False, 16)],
                         ids=["fourier", "mapping"])
def test_motion_mapping_matches_jax(fourier, z_dim):
    """MotionMappingNetwork's 'conv' strategy through the aligned time
    encoder, and its non-Fourier branch through a 2-layer MappingNetwork."""
    kw = dict(MOTION_KW, motion_z_dim=z_dim)
    if not fourier:
        kw.pop("time_encoder_kwargs")
    rng = np.random.RandomState(0)
    t, motion_z = _traj_inputs(rng, 3, z_dim, kw["motion_z_distance"],
                               kw["motion_kernel_size"])
    jnet = jmotion.MotionMappingNetwork(max_num_frames=MAX_NUM_FRAMES, motion_v_dim=16,
                                        fourier=fourier, **kw)
    variables = _init_jax(jnet, t, motion_z=motion_z)
    want = jax.jit(jnet.apply)(variables, t, motion_z=motion_z)
    net = motion.MotionMappingNetwork(max_num_frames=MAX_NUM_FRAMES, motion_v_dim=16,
                                      fourier=fourier, **kw)
    assert net.max_traj_len() == jnet.max_traj_len() == motion_z.shape[1]
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net(*_t(t), motion_z=torch.from_numpy(motion_z))
    assert got["motion_v"].shape == (3, 16)
    np.testing.assert_allclose(got["motion_v"].numpy(), np.asarray(want["motion_v"]),
                               **CLOSE)
    # without motion_z the trajectory noise comes from the generator given
    drawn = net(*_t(t), generator=torch.Generator().manual_seed(0))["motion_z"]
    assert drawn.shape == motion_z.shape


def _generator_inputs(seed, batch=2):
    rng = np.random.RandomState(seed)
    t, motion_z = _traj_inputs(rng, batch, MOTION_KW["motion_z_dim"],
                               MOTION_KW["motion_z_distance"],
                               MOTION_KW["motion_kernel_size"])
    z = rng.randn(batch, GEN["z_dim"]).astype(np.float32)
    c = rng.rand(batch, GEN["c_dim"]).astype(np.float32)
    delta_t = rng.randint(0, MAX_NUM_FRAMES - 1, size=(batch, 1)).astype(np.float32)
    cond = rng.randn(batch, GEN["img_channels_in"], GEN["img_resolution"],
                     GEN["img_resolution"]).clip(-1, 1).astype(np.float32)
    return z, c, t, delta_t, cond, motion_z


@pytest.mark.parametrize("synth", [
    GEN_SYNTH,
    dict(GEN_SYNTH, global_enc=False, relative_enc=True, comod_emb=True),
], ids=["global_enc", "relative_enc_comod_emb"])
def test_styleganv_generator_matches_jax(synth):
    """StyleGANVGenerator at tests/test_motion_parity.py's size: the motion
    code tiled into the seed (global_enc), and the time-difference encoder
    in the seed and the co-modulation vector (relative_enc, comod_emb)."""
    z, c, t, delta_t, cond, motion_z = _generator_inputs(1)
    kw = dict(mapping_kwargs=dict(num_layers=2), synthesis_kwargs=dict(synth),
              motion_mapping_kwargs=dict(MOTION_KW), **GEN)
    jgen = jmotion.StyleGANVGenerator(**kw)
    args = (z, c, t, delta_t, cond)
    variables = _init_jax(jgen, *args, motion_z=motion_z, noise_mode="const")
    want = np.asarray(jax.jit(lambda v, *a: jgen.apply(v, *a, motion_z=motion_z,
                                                       noise_mode="const"))(variables, *args))
    gen = load_jax_variables(motion.StyleGANVGenerator(**kw), variables)
    assert gen.synthesis.num_ws == jmotion.MotionSynthesisNetwork(
        w_dim=16, motion_v_dim=16, img_resolution=32, img_channels_in=4,
        img_channels_out=1, **synth).num_ws
    with torch.no_grad():
        got = gen(*_t(*args), motion_z=torch.from_numpy(motion_z),
                  noise_mode="const").numpy()
    assert got.shape == want.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(got, want, **NET_TOL)


def test_styleganv_generator_train_mode_draws_from_its_generator():
    """A train-mode forward (co-modulation dropout, random noise, the
    trajectory drawn) is reproducible from its torch.Generator and moves
    the mapper's w_avg."""
    z, c, t, delta_t, cond, _ = _generator_inputs(2)
    gen = motion.StyleGANVGenerator(mapping_kwargs=dict(num_layers=2),
                                    synthesis_kwargs=dict(GEN_SYNTH),
                                    motion_mapping_kwargs=dict(MOTION_KW), **GEN,
                                    generator=torch.Generator().manual_seed(0))
    outs = []
    for _ in range(2):
        with torch.no_grad():
            outs.append(gen(*_t(z, c, t, delta_t, cond), train=True,
                            generator=torch.Generator().manual_seed(4)))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert float(gen.mapping.w_avg.abs().max()) > 0


def _disc_inputs(seed, batch=2):
    rng = np.random.RandomState(seed)
    img = rng.randn(batch, DISC["num_frames"] * DISC["img_channels"],
                    DISC["img_resolution"], DISC["img_resolution"]).astype(np.float32)
    c = rng.rand(batch, DISC["c_dim"]).astype(np.float32)
    delta_t = rng.randint(0, MAX_NUM_FRAMES - 1, size=(batch, 1)).astype(np.float32)
    return img, c, delta_t


def _check_styleganv_discriminator(**kwargs):
    """The port's StyleGANVDiscriminator(**DISC, **kwargs) on JAX's weights:
    the logits, and every parameter's gradient of their sum. Returns the
    port's D."""
    img, c, delta_t = _disc_inputs(2)
    args = dict(DISC, **kwargs)
    jdisc = jmotion.StyleGANVDiscriminator(**args)
    variables = _init_jax(jdisc, img, c, delta_t)
    want = np.asarray(jax.jit(jdisc.apply)(variables, img, c, delta_t))
    disc = load_jax_variables(motion.StyleGANVDiscriminator(**args), variables)
    got = disc(*_t(img, c, delta_t))
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **NET_TOL)

    grads = jax.jit(jax.grad(lambda p: jnp.sum(jdisc.apply({"params": p}, img, c,
                                                            delta_t))))(variables["params"])
    want_grads = load_jax_variables(motion.StyleGANVDiscriminator(**args),
                                    {"params": jax.tree.map(np.asarray, grads)})
    got.sum().backward()
    want_named = dict(want_grads.named_parameters())
    for name, p in disc.named_parameters():
        g_want = want_named[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=1e-3,
                                   atol=1e-4 * np.abs(g_want).max() + 1e-12, err_msg=name)
    return disc


def test_styleganv_discriminator_matches_jax():
    """StyleGANVDiscriminator (frames concatenated at 16²): the logits, and
    every parameter's gradient of their sum."""
    _check_styleganv_discriminator()


@pytest.mark.parametrize("block_kwargs", [None, dict(resample_filter=[1, 2, 1],
                                                     activation="swish")])
def test_styleganv_discriminator_orig_matches_jax(block_kwargs):
    """``architecture="orig"`` (no residual branch) reaches the blocks and
    the epilogue, and ``block_kwargs`` the blocks, as in
    ``afcm_tpu/nn/motion.py:475-531``."""
    disc = _check_styleganv_discriminator(architecture="orig", block_kwargs=block_kwargs)
    names = [k for k, _ in disc.named_parameters()]
    assert not any(".skip." in k for k in names)


def test_styleganv_discriminator_skip_fails_in_both_packages():
    """ROADMAP C15: at ``architecture="skip"`` the JAX D adds the
    un-concatenated image's ``fromrgb`` to the frame-concatenated features
    at ``concat_res`` and fails; the port refuses it when it is built."""
    img, c, delta_t = _disc_inputs(2)
    with pytest.raises(TypeError, match="incompatible shapes"):
        _init_jax(jmotion.StyleGANVDiscriminator(**dict(DISC, architecture="skip")),
                  img, c, delta_t)
    with pytest.raises(NotImplementedError, match="C15"):
        motion.StyleGANVDiscriminator(**dict(DISC, architecture="skip"))


def test_comod_generator_cannot_build_motion_synthesis():
    """get_synthesizer gives MotionSynthesisNetwork in both packages, and
    CoModGenerator, which passes it no motion_v_dim, fails on it in both."""
    assert get_synthesizer("MotionSynthesisNetwork") is motion.MotionSynthesisNetwork
    kw = dict(z_dim=16, c_dim=1, w_dim=16, img_resolution=32, img_channels_in=4,
              img_channels_out=1, mapping_kwargs=dict(num_layers=2),
              synthesis_kwargs=dict(name="MotionSynthesisNetwork", channel_base=1024,
                                    channel_max=32))
    _, c, _, _, cond, _ = _generator_inputs(3)
    z = np.zeros((2, 16), np.float32)
    with pytest.raises(TypeError, match="motion_v_dim"):
        JaxCoModGenerator(**kw).init({"params": jax.random.PRNGKey(0),
                                      "noise": jax.random.PRNGKey(1)}, z, c, cond)
    with pytest.raises(TypeError, match="motion_v_dim"):
        CoModGenerator(**kw)


@pytest.mark.parametrize("shape,out_hw", [((2, 3, 8, 8), (5, 7)),
                                          ((1, 1, 16, 12), (16, 12))])
def test_grid_sample_matches_jax_and_torch(shape, out_hw):
    """tests/test_grid_sample.py's cases, out-of-bounds taps included."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    grid = rng.uniform(-1.5, 1.5, (shape[0], *out_hw, 2)).astype(np.float32)
    got = grid_sample(*_t(x, grid)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_grid_sample(x, grid)), **CLOSE)
    want = F.grid_sample(*_t(x, grid), mode="bilinear", padding_mode="zeros",
                         align_corners=False).numpy()
    np.testing.assert_allclose(got, want, **CLOSE)


def test_grid_sample_second_order_gradients_match_jax():
    """The gradient of |∇ sum(grid_sample²)|², w.r.t. the input and w.r.t.
    the grid, against JAX's; the first-order gradients against
    F.grid_sample's (whose backward has no backward of its own)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 2, 7, 9).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 5, 2)).astype(np.float32)

    def jax_second(wrt):
        def inner(x, g):
            return jnp.sum(jax_grid_sample(x, g) ** 2)
        first = jax.grad(inner, argnums=wrt)
        return np.asarray(jax.grad(lambda x, g: jnp.sum(first(x, g) ** 2),
                                   argnums=wrt)(x, grid))

    for wrt in (0, 1):
        xt, gt = (a.requires_grad_(True) for a in _t(x, grid))
        (first,) = torch.autograd.grad((grid_sample(xt, gt) ** 2).sum(), (xt, gt)[wrt],
                                       create_graph=True)
        (second,) = torch.autograd.grad((first ** 2).sum(), (xt, gt)[wrt])
        np.testing.assert_allclose(second.numpy(), jax_second(wrt), rtol=1e-4, atol=1e-5)
        xr, gr = (a.requires_grad_(True) for a in _t(x, grid))
        (want,) = torch.autograd.grad((F.grid_sample(xr, gr, align_corners=False) ** 2).sum(),
                                      (xr, gr)[wrt])
        np.testing.assert_allclose(first.detach().numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
