"""The port's tensor parallelism for the CoModGAN generator family
(``SynthesisLayerSG2``, ``ToRGBLayer``, ``Conv1x1``, ``PlainConv``,
``EqLRConv1d``, ``_Embedding``) against afcm_tpu on the CPU.

``afcm_tpu`` shards every GAN state over the mesh's model axis by shape
(``shard_params``); the port shards the same parameters in its
tensor-parallel layers (``parallel/tensor.py``). Here: every parameter the
rule shards in each network of the family sits in such a layer, and the
shipped CCSR GAN's sharded tensors are the ones ``afcm_tpu`` places on its
model axis; a tiny CoModGAN GAN's (2, 2) train step with R1 against
``afcm_tpu``'s step on its virtual (2, 2) mesh, the noise replaced in both
by the same numpy arrays (tests/test_torch_comodgan.py's precedent), at
``_compare_step``'s bounds, and against the port's one-process step; a
(1, 2) checkpoint that loads bit-equal into one process; the sharded eval
step and stitched volume over (2, 2) (rtol 2e-4, atol 2e-5); the int8
routing of a sharded ``SynthesisLayerSG2`` decided on the whole conv; the
CA, CAIN and StyleGAN-V networks sharded over (1, 2) against
``afcm_tpu``'s unsharded forward at the tolerances of
tests/test_torch_comodgan.py and tests/test_torch_motion.py; and the train
and evaluate CLIs over (1, 2). The ranks are in tests/_torch_ranks.py, one
thread each.
"""

import collections
import copy
import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from afcm_tpu import models as jmodels  # noqa: E402
from afcm_tpu.nn import ca_variants as jca  # noqa: E402
from afcm_tpu.nn import motion as jmotion  # noqa: E402
from afcm_tpu.parallel import infer_param_sharding as jax_rule  # noqa: E402
from afcm_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from afcm_tpu.parallel import shard_batch as jax_shard_batch  # noqa: E402
from afcm_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from afcm_tpu_torch import parallel  # noqa: E402
from afcm_tpu_torch.models import (GANConfig, GANModel, build_discriminator,  # noqa: E402
                                   build_generator)
from afcm_tpu_torch.nn import ca_variants, motion  # noqa: E402
from afcm_tpu_torch.nn.comodgan import SynthesisLayerSG2  # noqa: E402
from afcm_tpu_torch.ops import modulated_conv, modulated_conv2d_resample  # noqa: E402
from afcm_tpu_torch.parallel.tensor import SHARD, ModelGroup, infer_param_sharding  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_train_state, load_jax_variables  # noqa: E402
from tests import _torch_ranks as ranks  # noqa: E402
from tests.test_torch_comodgan import GEN_TOL, TINY_D, TINY_G, _perturb  # noqa: E402
from tests.test_torch_motion import NET_TOL  # noqa: E402
from tests.test_torch_motion import _init_jax as init_jax  # noqa: E402
from tests.test_torch_tensor_parallel import (_assert_equal_states, _load,  # noqa: E402
                                              _spawn, _whole_model)
from tests.test_torch_train import _compare_step as compare_gan_step  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/demo/cmsr_tiny.yml")
CCSR = os.path.join(REPO, "configs/adni/comodgan/ccsr.yml")
COMOD = ("model.name", "comodgan", "model.G.netG", "comodgan")
STEP_CFG = dict(z_dim=32, c_dim=1, batch_size=4, blur_init_sigma=2.0, blur_fade_kimg=1.0)
# tests/test_torch_comodgan.py's tiny GAN at 32², every conv 32 wide
STEP_G = dict(TINY_G, z_dim=32, w_dim=32, img_resolution=32,
              synthesis_kwargs=dict(TINY_G["synthesis_kwargs"], channel_base=1024,
                                    channel_max=32, skip_resolution=16))
STEP_D = dict(TINY_D, img_resolution=32)


def _batch(seed, n=4, size=32):
    rng = np.random.RandomState(seed)
    return {"A": rng.randn(n, 4, size, size).clip(-1, 1).astype(np.float32),
            "B": rng.randn(n, 1, size, size).clip(-1, 1).astype(np.float32),
            "slice_idx": rng.rand(n, 1).astype(np.float32)}


# -- the placement rule over the family ------------------------------------------------

def _ccsr_gan(*opts):
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.models import build_gan_model
    return build_gan_model(default_argument_parser(["--config-file", CCSR, *opts]))


MOTION_MAPPING = dict(motion_z_dim=512, motion_z_distance=32, motion_kernel_size=5,
                      time_encoder_kwargs=dict(dim=256, min_period_len=16,
                                               max_period_len=1024))
FAMILIES = {
    # the shipped CCSR GAN (configs/adni/comodgan/ccsr.yml)
    "ccsr_G": (lambda: _ccsr_gan().generator,
               {"SynthesisLayerSG2": 13, "Conv2dLayer": 14, "FullyConnected": 31}),
    "ccsr_D": (lambda: _ccsr_gan().discriminator,
               {"Conv2dLayer": 20, "FullyConnected": 11}),
    # the variants the config keys select, at the CCSR widths
    "CASynthesisNetwork": (
        lambda: _ccsr_gan("model.G.synthesis_kwargs.name", "CASynthesisNetwork",
                          "model.G.synthesis_kwargs.channel_attention", "True").generator,
        {"SynthesisLayerSG2": 11, "ToRGBLayer": 6, "Conv1x1": 19, "PlainConv": 1,
         "Conv2dLayer": 11, "FullyConnected": 28}),
    "CAINSynthesisNetwork": (
        lambda: ca_variants.CAINSynthesisNetwork(w_dim=512, img_resolution=256,
                                                 img_channels_in=4, img_channels_out=1),
        {"SynthesisLayerSG2": 120, "Conv1x1": 60, "PlainConv": 2, "Conv2dLayer": 60,
         "FullyConnected": 120}),
    "MotionSynthesisNetwork": (
        lambda: motion.MotionSynthesisNetwork(w_dim=512, motion_v_dim=512, img_resolution=256,
                                              img_channels_in=4, img_channels_out=1,
                                              channel_base=16384),
        {"SynthesisLayerSG2": 13, "Conv2dLayer": 14, "FullyConnected": 21}),
    "StyleGANVGenerator": (
        lambda: motion.StyleGANVGenerator(
            z_dim=512, c_dim=1, w_dim=512, motion_v_dim=512, img_resolution=256,
            img_channels_in=4, img_channels_out=1, max_num_frames=128,
            synthesis_kwargs=dict(channel_base=16384, global_enc=True),
            motion_mapping_kwargs=dict(MOTION_MAPPING)),
        {"SynthesisLayerSG2": 13, "EqLRConv1d": 2, "Conv2dLayer": 14, "FullyConnected": 33}),
    "StyleGANVDiscriminator": (
        lambda: motion.StyleGANVDiscriminator(c_dim=1, img_resolution=256, img_channels=1,
                                              channel_base=16384, max_num_frames=128),
        {"_Embedding": 1, "Conv2dLayer": 20, "FullyConnected": 11}),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_sharded_parameter_sits_in_a_tensor_parallel_layer(family):
    """Each network of the CoModGAN family, built at the CCSR widths on the
    meta device: at model axes of 2 and 4 ``shard_module`` takes every
    parameter the rule shards (none raises), each in a layer whose forward
    is tensor-parallel, and keeps 1/M of its rows; the sharded layers by
    class at M = 2."""
    build, want = FAMILIES[family]
    for model in (2, 4):
        with torch.device("meta"):
            net = build()
        shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}
        parallel.shard_module(net, ModelGroup(None, 0, model))
        for name, p in net.named_parameters():
            rows = shapes[name][0] if shapes[name] else None
            if infer_param_sharding(name, shapes[name], model) == SHARD:
                assert p.shape[0] == rows // model, name
            else:
                assert tuple(p.shape) == shapes[name], name
        layers = collections.Counter(type(m).__name__
                                     for m in parallel.tensor.sharded_layers(net))
        assert sum(layers.values()) == sum(
            infer_param_sharding(k, s, model) == SHARD for k, s in shapes.items())
        if model == 2:
            assert dict(layers) == want


def test_a_layer_without_a_tensor_parallel_forward_is_named():
    """A parameter the rule shards in a layer with no tensor-parallel
    forward raises, naming the layer's class (``ConvNorm`` of the RCAB
    blocks, which no network of the family builds)."""
    with pytest.raises(NotImplementedError, match="ConvNorm has no tensor-parallel"):
        parallel.shard_module(ca_variants.ResidualGroup(1, 32, 3), ModelGroup(None, 0, 2))


@pytest.mark.parametrize("model", [2, 4])
def test_rule_on_the_shipped_ccsr_gan(model):
    """The shipped CCSR GAN (G 68,248,788 parameters in 143 tensors, D
    26,365,632 in 56): the tensors the port shards are those ``afcm_tpu``'s
    ``infer_param_sharding`` places on the model axis over its own
    parameter tree (``jax.eval_shape`` of its ``init_state``), by name, and
    their counts and elements."""
    from afcm_tpu.config import setup

    class Args:
        config_file, model, opts = CCSR, None, []
    jmodel = jmodels.build_gan_model(setup(Args()))
    spec = {"A": jax.ShapeDtypeStruct((1, 4, 256, 256), jnp.float32),
            "B": jax.ShapeDtypeStruct((1, 1, 256, 256), jnp.float32),
            "slice_idx": jax.ShapeDtypeStruct((1, 1), jnp.float32)}
    state = jax.eval_shape(jmodel.init_state, jax.random.PRNGKey(0), spec)
    mesh = jax_make_mesh((8 // model, model))
    with torch.device("meta"):
        port = _ccsr_gan()
    for tree, net, whole in ((state.params_G, port.generator, (143, 68_248_788)),
                             (state.params_D, port.discriminator, (56, 26_365_632))):
        leaves = {".".join(str(k.key) for k in path): leaf for path, leaf in
                  jax.tree_util.tree_flatten_with_path(tree)[0]}
        ours = {k: tuple(p.shape) for k, p in net.named_parameters()}
        assert {k: tuple(v.shape) for k, v in leaves.items()} == ours
        assert (len(ours), sum(int(np.prod(s)) for s in ours.values())) == whole
        jax_sharded = {k for k, v in leaves.items()
                       if jax_rule(k, v.shape, mesh).spec == P("model")}
        assert jax_sharded == {k for k, s in ours.items()
                               if infer_param_sharding(k, s, model) == SHARD}
        assert jax_sharded


# -- training ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def comod_case(tmp_path_factory):
    """afcm_tpu's initial state of a tiny CoModGAN GAN (noise strengths
    off their zero init), the port's model carried from it (pickled for
    the ranks), and two steps' inputs (R1 on both)."""
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(STEP_G)),
                              jmodels.build_discriminator(dict(STEP_D)),
                              jmodels.GANConfig(**STEP_CFG))
    state = jax.tree.map(np.asarray, jmodel.init_state(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in _batch(0).items()}))
    state = state.replace(params_G=_perturb(state.params_G, np.random.RandomState(1)),
                          params_G_ema=_perturb(state.params_G_ema, np.random.RandomState(1)))
    net_g = build_generator(dict(STEP_G))
    port = GANModel(GANConfig(**STEP_CFG), copy.deepcopy(net_g), net_g,
                    build_discriminator(dict(STEP_D)))
    load_jax_train_state(port, state)
    path = tmp_path_factory.mktemp("comod") / "model.pt"
    torch.save(port, path)
    steps = [(_batch(200 + i), np.random.RandomState(220 + i).randn(4, 32).astype(np.float32),
              4.0 * i, True) for i in (1, 2)]
    return jmodel, state, str(path), steps


def _grads(model):
    """Per net, each parameter's gradient of the step (Adam's first moment,
    beta1 = 0), as numpy by name."""
    return {name: {k: opt.state[p]["exp_avg"].numpy() for k, p in net.named_parameters()}
            for name, net, opt in (("G", model.generator, model.opt_G),
                                   ("D", model.discriminator, model.opt_D))}


def test_comodgan_train_step_on_a_2x2_mesh_matches_jax(comod_case, tmp_path, monkeypatch):
    """A CoModGAN step with R1 over a (2, 2) mesh, z injected and the
    synthesis noise replaced by the same numpy function of the global shape
    (tests/test_torch_comodgan.py's precedent), against afcm_tpu's
    ``_train_step_impl`` on its (2, 2) mesh (``shard_params``,
    ``shard_batch``): each rank's losses and whole G, D, G_ema and Adam
    moments at ``_compare_step``'s bounds, and the mapper's w_avg at rtol
    1e-5. Against the port's one-process step on the same inputs, what the
    model axis alone changes: every gradient within 1e-4 of its tensor's
    max. All four ranks end with the same whole state; the census counts
    the styles' and channels' gathers and one partial-gradient sum per net
    (the biases and noise strengths of the sharded layers)."""
    jmodel, state, path, steps = comod_case
    batch, z, nimg, _ = steps[0]
    _spawn(tmp_path, 4, ranks.tp_steps, path, [(2, steps[:1])], str(tmp_path), True)
    one = _load(path)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "randn", lambda shape, **kw: torch.from_numpy(ranks.noise(shape)))
        one.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, nimg,
                       with_r1=True, z=torch.from_numpy(z),
                       generator=torch.Generator().manual_seed(1))
    one_grads = _grads(one)
    mesh = jax_make_mesh((2, 2))
    key = jax.random.PRNGKey(5)           # dropout is 0 and the noise replaced
    monkeypatch.setattr(jax.random, "normal",
                        lambda k, shape, *a, **kw: jnp.asarray(ranks.noise(shape)))
    want, jax_metrics = jax.jit(functools.partial(jmodel._train_step_impl, with_r1=True))(
        jax_shard_params(jax.tree.map(jnp.asarray, state), mesh),
        jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh),
        jnp.asarray(z), key, key, jnp.asarray(nimg))
    want = jax.tree.map(np.asarray, want)
    results = [_load(tmp_path / f"r{r}_m2_s1.pt") for r in range(4)]
    for rank, (metrics, nets, optim, census) in enumerate(results):
        model = _whole_model(path, nets, optim)
        compare_gan_step(model, want, metrics, jax_metrics, f"comodgan (2, 2) rank {rank}", {})
        np.testing.assert_allclose(model.generator.mapping.w_avg.numpy(),
                                   want.moments_G["mapping"]["w_avg"], rtol=1e-5, atol=1e-6)
        for net, grads in _grads(model).items():
            for k, g in grads.items():
                g_one = one_grads[net][k]
                np.testing.assert_allclose(g, g_one, rtol=0,
                                           atol=1e-4 * float(np.abs(g_one).max()),
                                           err_msg=f"{net} {k}")
        _assert_equal_states(nets, results[0][1])
        assert census["tp_styles"]["count"] > 0 and census["tp_gather"]["count"] > 0
        assert census["tp_partial_grads"]["count"] == 2


def test_comodgan_checkpoint_at_1x2_loads_into_one_process(comod_case, tmp_path):
    """``save_state`` over a (1, 2) mesh writes the CoModGAN's whole tensors:
    they load strictly into one process bit-equal to the ranks' whole state,
    Adam's moments, w_avg and the noise buffers too; ``load_state`` back
    over (1, 2) resumes bit for bit."""
    from afcm_tpu_torch.utils import checkpoint as ckpt
    _, _, path, steps = comod_case
    _spawn(tmp_path, 2, ranks.tp_checkpoint, path, steps, str(tmp_path))
    one = _load(path)
    ckpt.load_state(one, str(tmp_path / "ckpt"), "mid")
    for rank in range(2):
        result = _load(tmp_path / f"r{rank}_ckpt.pt")
        nets, optim = result["saved"]
        _assert_equal_states(nets, {n: getattr(one, n).state_dict() for n in nets})
        assert "mapping.w_avg" in nets["generator_ema"]
        for key in optim:
            got = getattr(one, key).state_dict()["state"]
            for i, entry in optim[key]["state"].items():
                assert all(torch.equal(entry[k], got[i][k]) for k in entry), (key, i)
        first, loaded = result["metrics"]
        assert {k: float(v) for k, v in first.items()} == \
            {k: float(v) for k, v in loaded.items()}
        _assert_equal_states(*(nets for nets, _ in result["after"]))


# -- serving ---------------------------------------------------------------------------

def test_comodgan_eval_step_and_stitched_volume_over_2x2_match(tmp_path):
    """The tiny demo config as a CoModGAN model served by
    ``evaluate.ModelAxisServer`` over a (2, 2) mesh: one batch's eval step
    and the stitched volume of ten 64² slices against one process's and
    against afcm_tpu's over its (2, 2) mesh (``shard_params``), rtol 2e-4,
    atol 2e-5; the noise strengths off their init, so the const noise
    counts."""
    from afcm_tpu.config import setup
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.evaluate import make_forward_fn
    from afcm_tpu_torch.models import build_eval_model
    from afcm_tpu_torch.models.gan_model import eval_forward

    class Args:
        config_file, model, opts = CONFIG, None, list(COMOD)
    jmodel = jmodels.build_gan_model(setup(Args()))
    dummy = {"A": jnp.zeros((1, 4, 64, 64)), "B": jnp.zeros((1, 1, 64, 64)),
             "slice_idx": jnp.zeros((1, 1))}
    state = jax.tree.map(np.asarray, jmodel.init_state(jax.random.PRNGKey(0), dummy))
    variables = {"params": _perturb(state.params_G_ema, np.random.RandomState(3)),
                 "moments": state.moments_G_ema, "constants": state.constants_G}
    argv = ["--config-file", CONFIG, *COMOD, "checkpoints_dir", str(tmp_path / "ckpt"),
            "loaders.batch_size", "4"]
    model = build_eval_model(dict(default_argument_parser(argv).model.G))
    load_jax_variables(model.generator_ema, variables)
    (tmp_path / "ckpt" / "demo_tiny").mkdir(parents=True)
    torch.save(model.generator_ema.state_dict(),
               tmp_path / "ckpt" / "demo_tiny" / "latest_net_G_ema.pth")
    rng = np.random.RandomState(4)
    batch = (rng.randn(4, 4, 64, 64).clip(-1, 1).astype(np.float32),
             rng.rand(4, 1).astype(np.float32), rng.randn(4, 64).astype(np.float32))
    _spawn(tmp_path, 4, ranks.tp_serve, argv + ["tpu.mesh_shape", "[2, 2]"], batch, 10,
           str(tmp_path))
    out, volume, census = _load(tmp_path / "r0_serve.pt")
    with torch.no_grad():
        want = eval_forward(model.generator_ema, 1, *(torch.from_numpy(v) for v in batch))
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-5)
    one = ranks.stitched(make_forward_fn(model, "cpu", seed=3), tmp_path / "one",
                         ranks.stub_loader(10, 64))
    assert volume.shape == (10, 64, 64) and np.isfinite(volume).all()
    np.testing.assert_allclose(volume, one, rtol=2e-4, atol=2e-5)
    assert census["tp_gather"]["count"] > 0 and census["tp_styles"]["count"] > 0

    mesh = jax_make_mesh((2, 2))
    sharded = jax_shard_params(variables, mesh)
    on_data = NamedSharding(mesh, P("data"))
    apply = jax.jit(lambda z, c, a: jmodel.generator.apply(
        sharded, z, c, a, train=False, noise_mode="const"))
    np.testing.assert_allclose(out.numpy(), np.asarray(apply(*(
        jax.device_put(jnp.asarray(v), on_data) for v in (batch[2], batch[1], batch[0])))),
        rtol=2e-4, atol=2e-5)
    draws = torch.Generator().manual_seed(3)

    def jax_forward(a_batch, slice_idx):
        z = torch.randn((a_batch.shape[0], 64), generator=draws).numpy()
        return apply(*(jax.device_put(jnp.asarray(x), on_data)
                       for x in (z, slice_idx, a_batch)))

    np.testing.assert_allclose(volume, ranks.stitched(jax_forward, tmp_path / "jax",
                                                      ranks.stub_loader(10, 64)),
                               rtol=2e-4, atol=2e-5)


# -- sharded forwards of the family --------------------------------------------------

def _int8_layer_case(tmp_path):
    """A CCSR-width synthesis layer (512 -> 512 at 16², the gate's class)
    with its noise strength off zero; its whole forward under ``int8``, the
    routed convs' weight shapes recorded."""
    layer = SynthesisLayerSG2(512, 512, w_dim=32, resolution=16,
                              generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        layer.noise_strength.fill_(0.4)
    rng = np.random.RandomState(8)
    args = (rng.randn(2, 512, 16, 16).astype(np.float32), rng.randn(2, 32).astype(np.float32))
    path = tmp_path / "int8_layer.pt"
    torch.save(layer, path)
    routed = []
    real = modulated_conv.conv3x3_int8_ste
    modulated_conv.conv3x3_int8_ste = lambda x, w, p: routed.append(tuple(w.shape)) or \
        real(x, w, p)
    modulated_conv.set_conv_impl("int8")
    try:
        with torch.no_grad():
            want = layer(*map(torch.from_numpy, args), noise_mode="const")
    finally:
        modulated_conv.conv3x3_int8_ste = real
        modulated_conv.set_conv_impl("xla")
    return ("int8_layer", str(path), args, {"noise_mode": "const"}, False, "int8"), \
        (want, routed)


def _family_cases(tmp_path):
    """The CA, CAIN and StyleGAN-V networks at sizes the rule shards at
    M = 2, initialized by afcm_tpu and carried across: for each, the
    rank function's case and afcm_tpu's output (and, for D, its parameter
    gradients of the logits' sum)."""
    rng = np.random.RandomState(12)
    cases, wants = [], {}

    def add(name, jnet, net, args, kwargs, tol, grads=False):
        variables = init_jax(jnet, *args, **kwargs)
        want = np.asarray(jax.jit(lambda v, *a: jnet.apply(v, *a, **kwargs))(variables, *args))
        load_jax_variables(net, variables)
        path = tmp_path / f"{name}.pt"
        torch.save(net, path)
        jgrads = None
        if grads:
            g = jax.jit(jax.grad(lambda p: jnp.sum(jnet.apply({"params": p}, *args, **kwargs))))(
                variables["params"])
            jgrads = dict(load_jax_variables(copy.deepcopy(net), {
                "params": jax.tree.map(np.asarray, g)}).named_parameters())
        cases.append((name, str(path), args, kwargs, grads, "xla"))
        wants[name] = (want, jgrads, tol)

    ca = dict(w_dim=32, img_resolution=32, img_channels_in=4, img_channels_out=1,
              channel_base=512, channel_max=32, skip_resolution=16, cond_mod=True,
              channel_attention=True)
    jnet = jca.CASynthesisNetwork(**ca)
    add("CASynthesisNetwork", jnet, ca_variants.CASynthesisNetwork(**ca),
        (rng.randn(2, jnet.num_ws, 32).astype(np.float32),
         rng.randn(2, 4, 32, 32).astype(np.float32)), {"noise_mode": "const"}, GEN_TOL)
    cain = dict(w_dim=16, img_resolution=32, img_channels_in=4, img_channels_out=1,
                depth=2, n_resgroups=1, n_resblocks=2)
    jnet = jca.CAINSynthesisNetwork(**cain)
    add("CAINSynthesisNetwork", jnet, ca_variants.CAINSynthesisNetwork(**cain),
        (rng.randn(2, jnet.num_ws, 16).astype(np.float32),
         rng.randn(2, 4, 32, 32).astype(np.float32)), {"noise_mode": "const"}, GEN_TOL)
    frames = 16
    mm = dict(motion_z_dim=16, motion_z_distance=2, motion_kernel_size=3,
              time_encoder_kwargs=dict(dim=16, min_period_len=2, max_period_len=16))
    gen = dict(z_dim=16, c_dim=1, w_dim=32, motion_v_dim=16, img_resolution=32,
               img_channels_in=4, img_channels_out=1, max_num_frames=frames,
               mapping_kwargs=dict(num_layers=2), motion_mapping_kwargs=mm,
               synthesis_kwargs=dict(channel_base=1024, channel_max=32, skip_resolution=16,
                                     cond_mod=True, relative_enc=True, comod_emb=True,
                                     conv_clamp=256))
    traj = int(np.ceil((frames - 1) / 2)) + 2 + 4
    args = (rng.randn(2, 16).astype(np.float32), rng.rand(2, 1).astype(np.float32),
            rng.randint(0, frames - 1, size=(2, 1)).astype(np.float32),
            rng.randint(0, frames - 1, size=(2, 1)).astype(np.float32),
            rng.randn(2, 4, 32, 32).clip(-1, 1).astype(np.float32))
    add("StyleGANVGenerator", jmotion.StyleGANVGenerator(**gen),
        motion.StyleGANVGenerator(**gen), args,
        {"motion_z": rng.randn(2, traj, 16).astype(np.float32), "noise_mode": "const"},
        NET_TOL)
    disc = dict(c_dim=1, img_resolution=32, img_channels=1, num_frames=3, channel_base=2048,
                channel_max=32, conv_clamp=256, num_frames_div_factor=2,
                max_num_frames=frames, concat_res=16, epilogue_kwargs=dict(mbstd_group_size=2))
    add("StyleGANVDiscriminator", jmotion.StyleGANVDiscriminator(**disc),
        motion.StyleGANVDiscriminator(**disc),
        (rng.randn(2, 3, 32, 32).astype(np.float32), rng.rand(2, 1).astype(np.float32),
         rng.randint(0, frames - 1, size=(2, 1)).astype(np.float32)), {}, NET_TOL, grads=True)
    return cases, wants


@pytest.fixture(scope="module")
def family_run(tmp_path_factory):
    """One (1, 2) spawn for every sharded forward below."""
    tmp_path = tmp_path_factory.mktemp("family")
    cases, wants = _family_cases(tmp_path)
    int8_case, int8_want = _int8_layer_case(tmp_path)
    _spawn(tmp_path, 2, ranks.tp_forwards, cases + [int8_case], str(tmp_path))
    return [_load(tmp_path / f"r{r}_forwards.pt") for r in range(2)], wants, int8_want


@pytest.mark.parametrize("name", ["CASynthesisNetwork", "CAINSynthesisNetwork",
                                  "StyleGANVGenerator", "StyleGANVDiscriminator"])
def test_sharded_family_forward_matches_jax(family_run, name):
    """Each network sharded over (1, 2) against afcm_tpu's unsharded
    forward at tests/test_torch_comodgan.py's and tests/test_torch_motion.py's
    tolerances, both ranks alike; the census shows the layers of the
    network's kind crossing the model axis (the styles of the CA and CAIN
    blocks, the StyleGAN-V D's embedding table). For D, every parameter's
    whole gradient of the logits' sum too, at rtol 1e-3 / atol 1e-4·max|g|."""
    results, wants, _ = family_run
    want, jgrads, tol = wants[name]
    (out, grads, _, census), (out1, grads1, _, _) = (r[name] for r in results)
    assert out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), want, **tol)
    assert torch.equal(out, out1)
    assert census["tp_gather"]["count"] > 0
    if name.startswith("CA"):
        assert census["tp_styles"]["count"] > 0
    if jgrads is not None:
        assert census["tp_table"]["count"] == 1
        for k, g in grads.items():
            g_want = jgrads[k].detach().numpy()
            np.testing.assert_allclose(g.numpy(), g_want, rtol=1e-3,
                                       atol=1e-4 * np.abs(g_want).max() + 1e-12, err_msg=k)
            assert torch.equal(g, grads1[k]), k


def test_int8_routing_of_a_sharded_synthesis_layer_is_the_whole_convs(family_run):
    """``modulated_conv2d_resample`` routes a slice of output channels under
    ``int8`` as the whole conv is routed (``out_channels``: the gate sees
    O = 512 where the slice holds 256), and, the quantization being per
    output channel, the slices' outputs are the whole conv's bit for bit;
    a 128-channel slice, under the gate's 256 by itself, is routed only
    when ``out_channels`` names the whole conv. Over (1, 2) each rank's
    sharded ``SynthesisLayerSG2`` routes its 256-channel slice once, and the gathered output equals the
    whole layer's within 1e-5 of its range (the noise and the bias are
    added per slice in another order of the same float32 ops)."""
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(2, 512, 12, 12).astype(np.float32))
    w = torch.from_numpy(rng.randn(512, 512, 3, 3).astype(np.float32))
    s = torch.from_numpy((rng.rand(2, 512) + 0.5).astype(np.float32))
    noise = torch.from_numpy(rng.randn(2, 1, 12, 12).astype(np.float32))
    routed = []
    real = modulated_conv.conv3x3_int8_ste
    modulated_conv.conv3x3_int8_ste = lambda x, w, p: routed.append(tuple(w.shape)) or \
        real(x, w, p)
    modulated_conv.set_conv_impl("int8")
    try:
        whole = modulated_conv2d_resample(x, w, s, noise=noise, padding=1)
        parts = [modulated_conv2d_resample(x, w[i * 256:(i + 1) * 256], s, noise=noise,
                                           padding=1, out_channels=512) for i in range(2)]
        assert routed == [(512, 512, 3, 3), (256, 512, 3, 3), (256, 512, 3, 3)]
        modulated_conv2d_resample(x, w[:128], s, padding=1)
        modulated_conv2d_resample(x, w[:128], s, padding=1, out_channels=512)
        assert routed[3:] == [(128, 512, 3, 3)]
    finally:
        modulated_conv.conv3x3_int8_ste = real
        modulated_conv.set_conv_impl("xla")
    assert torch.equal(torch.cat(parts, 1), whole)

    results, _, (want, want_routed) = family_run
    assert want_routed == [(512, 512, 3, 3)]
    for result in results:
        out, _, got_routed, census = result["int8_layer"]
        assert got_routed == [(256, 512, 3, 3)]
        torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * float(want.abs().max()))
        assert census["tp_gather"]["count"] == 1


# -- the CLIs ----------------------------------------------------------------------------

def test_comodgan_train_and_evaluate_clis_over_a_1x2_mesh(tmp_path, monkeypatch):
    """``python -m afcm_tpu_torch.train --device cpu model.name comodgan
    model.G.netG comodgan tpu.mesh_shape [1, 2]`` starts two gloo ranks
    (two steps), whose G_ema checkpoint loads strictly into one process;
    ``python -m afcm_tpu_torch.evaluate`` with the same arguments serves and
    scores the test subject over the two ranks, within rtol 2e-4 of one
    process's scores (``tpu.mesh_shape [0, 1]``)."""
    pytest.importorskip("h5py")
    from afcm_tpu_torch import evaluate
    from afcm_tpu_torch import train as train_cli
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.data.demo import write_demo_tree
    from afcm_tpu_torch.models import build_eval_model
    write_demo_tree(str(tmp_path / "data"), n_train=1, n_val=1, n_test=1, depth=8, size=64)
    worlds = []
    real = parallel.spawn

    def spawn(fn, world, args, **kw):
        worlds.append(world)
        return real(fn, world, args, **dict(kw, threads=1, timeout_s=300))

    monkeypatch.setattr(parallel, "spawn", spawn)
    argv = ["--config-file", CONFIG, "--device", "cpu", *COMOD,
            "loaders.train.file_paths", f"['{tmp_path}/data/train']",
            "loaders.val.file_paths", f"['{tmp_path}/data/val']",
            "loaders.test.file_paths", f"['{tmp_path}/data/test']",
            "checkpoints_dir", str(tmp_path / "checkpoints")]
    mesh = ["tpu.mesh_shape", "[1, 2]"]
    assert train_cli.main(argv + ["trainer.max_iters", "4"] + mesh) == {}
    run_dir = tmp_path / "checkpoints" / "demo_tiny"
    model = build_eval_model(dict(default_argument_parser(argv[:2] + list(COMOD)).model.G))
    evaluate.load_generator_ema(model, str(run_dir), "latest")
    over_mesh = evaluate.main(argv + mesh)
    one = evaluate.main(argv + ["tpu.mesh_shape", "[0, 1]"])
    for k in ("psnr", "ssim"):
        assert np.isfinite(over_mesh[k]) and over_mesh[k] == pytest.approx(one[k], rel=2e-4), k
    assert worlds == [2, 2]
