"""The port's pix2pix baseline against the JAX package's, on the CPU.

The UNet G, the PatchGAN and PixelGAN D, their objectives, whole train
steps from one ``Pix2PixState`` carried across by ``load_jax_train_state``,
the weight initializers, the template model, the train CLI on a tiny
aligned tree and the checkpoint conversion. The same numpy inputs, made
from a seed, go through both packages; random draws cannot match across
frameworks, so the tests hand the port flax's: the dropout keep masks of
each train-mode G forward (read off flax's ``nn.Dropout`` by method
interception, keyed by the ``mid{i}`` level) and the gradient penalty's
interpolation weights (``jax.random.uniform`` of the step's key).

Tolerances: a forward's output and batch statistics within 1e-5 of the
maximum of JAX's (relative to the tensor); a step's losses at rtol 1e-5;
gradients (Adam's first moment) at rtol 1e-3 / atol 1e-3·max|g|; the
parameters after the step at atol 1e-4 wherever |g| > 1e-6 (Adam's first
step moves every other parameter by ±lr whatever the size of its gradient,
so a gradient at the level of the two frameworks' rounding can take
either sign), the statistics after the step within 1e-5 of the maximum.
"""

import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from afcm_tpu.models import losses as jlosses  # noqa: E402
from afcm_tpu.models.pix2pix_model import Pix2PixConfig as JaxConfig  # noqa: E402
from afcm_tpu.models.pix2pix_model import Pix2PixModel as JaxModel  # noqa: E402
from afcm_tpu.nn import pix2pix as jpix  # noqa: E402
from afcm_tpu_torch.models import build_model, losses  # noqa: E402
from afcm_tpu_torch.models.pix2pix_model import (Pix2PixConfig,  # noqa: E402
                                                 Pix2PixModel)
from afcm_tpu_torch.nn import pix2pix  # noqa: E402
from afcm_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from afcm_tpu_torch.utils.port import (jax_state_dict,  # noqa: E402
                                       load_jax_train_state, load_jax_variables)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs/demo/pix2pix_tiny.yml")
ADNI_BASE = os.path.join(REPO, "configs/adni/base.yml")
# tests/test_pix2pix.py:test_pix2pix_train_step's nets
G_KW = dict(input_nc=1, output_nc=1, num_downs=6, ngf=4)
D_KW = dict(input_nc=2, ndf=4, n_layers=2)


def _rel_close(got, want, rel=1e-5, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{label}: {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{label}: max|diff| / max|want| {err:.3g} > {rel}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb_stats(stats, rng):
    """Running statistics off their init (mean 0, var 1), so that eval mode
    and the moved statistics count."""
    return jax.tree.map(lambda v: np.asarray(
        rng.randn(*v.shape) * 0.3 + (1.5 if v.min() > 0 else 0.0), np.float32)
        if v.ndim else v, _np(stats))


def _named(tree):
    return {k: v.numpy() for k, v in jax_state_dict({"params": _np(tree)}).items()}


def flax_train_forward(generator, variables, x, key):
    """A train-mode forward of the flax ``generator`` with dropout key
    ``key``: its output, the moved statistics and the keep masks its
    ``nn.Dropout``s draw, by ``mid{i}`` level. The masks depend on the key
    and the module path only, so a forward outside the jitted train step
    gives the step's."""
    y, updated, masks = _jitted_train_forward(generator)(variables, x, key)
    return y, updated, {k: torch.from_numpy(np.array(v)) for k, v in masks.items()}


@functools.lru_cache(maxsize=None)
def _jitted_train_forward(generator):
    def run(variables, x, key):
        masks = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout):
                masks[context.module.scope.path[-2]] = out != 0
            return out

        with fnn.intercept_methods(record):
            y, updated = generator.apply(variables, x, train=True, rngs={"dropout": key},
                                         mutable=["batch_stats"])
        return y, updated, masks

    return jax.jit(run)


def flax_dropout_masks(generator, variables, x, key):
    return flax_train_forward(generator, variables, x, key)[2]


def _nets(norm, dropout=True):
    return {"unet": (jpix.UnetGenerator(norm=norm, use_dropout=dropout, **G_KW),
                     pix2pix.UnetGenerator(norm=norm, use_dropout=dropout, **G_KW), 1),
            "basic": (jpix.NLayerDiscriminator(norm=norm, **D_KW),
                      pix2pix.NLayerDiscriminator(norm=norm, **D_KW), 2),
            "pixel": (jpix.PixelDiscriminator(input_nc=2, ndf=4, norm=norm),
                      pix2pix.PixelDiscriminator(input_nc=2, ndf=4, norm=norm), 2)}


@functools.lru_cache(maxsize=None)
def _net_case(net, norm):
    """An input and the JAX net's variables (running statistics off their
    init), shared by the train- and eval-mode cases."""
    jnet, _, channels = _nets(norm)[net]
    rng = np.random.RandomState(["unet", "basic", "pixel"].index(net) * 3 +
                                ["batch", "instance", "none"].index(norm))
    x = rng.randn(2, channels, 64, 64).astype(np.float32)
    variables = _np(jax.jit(lambda x: jnet.init({"params": jax.random.PRNGKey(0),
                                                 "dropout": jax.random.PRNGKey(1)},
                                                x, train=True))(x))
    if "batch_stats" in variables:
        variables["batch_stats"] = _perturb_stats(variables["batch_stats"], rng)
    return x, variables


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("norm", ["batch", "instance", "none"])
@pytest.mark.parametrize("net", ["unet", "basic", "pixel"])
def test_nets_match_jax(net, norm, train):
    """Each net at each norm kind, in train mode (batch statistics, flax's
    dropout masks, the running statistics moved) and eval mode (running
    statistics off their init, no dropout); the state_dict keys are the JAX
    tree's."""
    jnet, tnet, _ = _nets(norm)[net]
    x, variables = _net_case(net, norm)
    assert ("batch_stats" in variables) == (norm == "batch")
    load_jax_variables(tnet, variables)
    assert set(tnet.state_dict()) == set(jax_state_dict(variables))
    kw = {}
    if train:
        want, updated, masks = flax_train_forward(jnet, variables, x, jax.random.PRNGKey(7))
        if net == "unet":
            kw["dropout_masks"] = masks
            assert sorted(masks) == tnet.dropout_blocks == ["mid0"]
    else:
        want, updated = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, x), {}
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), train=train, **kw)
    _rel_close(got.numpy(), want, label=f"{net} {norm}")
    if updated.get("batch_stats"):
        buffers = dict(tnet.named_buffers())
        for k, v in jax_state_dict({"batch_stats": _np(updated["batch_stats"])}).items():
            _rel_close(buffers[k].numpy(), v.numpy(), label=k)


def test_norm_statistics_match_jax():
    """_Norm's batch norm: the running variance moves by the biased batch
    variance (not nn.BatchNorm2d's unbiased one), no update with
    update_stats=False; instance norm keeps no statistics."""
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 4, 6).astype(np.float32) * 2 + 1
    jn = jpix._Norm(5, "batch", 0.02)
    variables = _np(jn.init(jax.random.PRNGKey(0), x, train=True))
    np.testing.assert_array_equal(variables["batch_stats"]["var"], np.ones(5))
    _, upd = jn.apply(variables, x, train=True, mutable=["batch_stats"])
    norm = load_jax_variables(pix2pix._Norm(5, "batch", 0.02), variables)
    norm(torch.from_numpy(x), train=True, update_stats=False)
    torch.testing.assert_close(norm.var, torch.ones(5), rtol=0, atol=0)
    norm(torch.from_numpy(x), train=True)
    for k in ("mean", "var"):
        _rel_close(getattr(norm, k).numpy(), upd["batch_stats"][k], label=k)
    biased = 0.9 + 0.1 * x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(norm.var.numpy(), biased, rtol=1e-6)
    assert not list(pix2pix._Norm(5, "instance").state_dict())


def _batch(seed, channels=1, size=64):
    rng = np.random.RandomState(seed)
    return {"A": rng.randn(2, channels, size, size).clip(-1, 1).astype(np.float32),
            "B": rng.randn(2, 1, size, size).clip(-1, 1).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_model(gan_mode, dropout, norm="batch", lambda_gp=0.0):
    """One JAX model per configuration, so that its jitted methods compile
    once in the module."""
    return JaxModel(jpix.UnetGenerator(norm=norm, use_dropout=dropout, **G_KW),
                    jpix.NLayerDiscriminator(norm=norm, **D_KW),
                    JaxConfig(gan_mode=gan_mode, lambda_gp=lambda_gp))


def _models(gan_mode, dropout, norm="batch", lambda_gp=0.0):
    port = Pix2PixModel(pix2pix.UnetGenerator(norm=norm, use_dropout=dropout, **G_KW),
                        pix2pix.NLayerDiscriminator(norm=norm, **D_KW),
                        Pix2PixConfig(gan_mode=gan_mode, lambda_gp=lambda_gp))
    return _jax_model(gan_mode, dropout, norm, lambda_gp), port


@functools.lru_cache(maxsize=None)
def _jax_state(dropout=True, norm="batch", seed=0):
    """The JAX nets' initial state (whatever the objective: the state does
    not depend on it), running statistics off their init."""
    batch = _batch(seed)
    state = _np(_jax_model("vanilla", dropout, norm).init_state(
        jax.random.PRNGKey(seed), {k: jnp.asarray(v) for k, v in batch.items()}))
    rng = np.random.RandomState(seed + 11)
    return state.replace(stats_G=_perturb_stats(state.stats_G, rng),
                         stats_D=_perturb_stats(state.stats_D, rng))


def _step_draws(jmodel, state, batch, key, dropout):
    """The masks and interpolation weights the JAX step draws from ``key``."""
    rng_g1, rng_g2, rng_gp = jax.random.split(key, 3)
    alpha = torch.from_numpy(np.array(jax.random.uniform(rng_gp, (2, 1, 1, 1))))
    if not dropout:
        return (None, None), alpha
    variables = {"params": state.params_G, "batch_stats": state.stats_G}
    return tuple(flax_dropout_masks(jmodel.generator, variables, batch["A"], k)
                 for k in (rng_g1, rng_g2)), alpha


def _adam_mu(opt_state):
    return _named(opt_state.inner_state[0].mu)


def _compare_step(port, new_state, metrics, jax_metrics, label):
    for k in ("G_GAN", "G_L1", "D_real", "D_fake"):
        np.testing.assert_allclose(float(metrics[k]), float(jax_metrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"{label} {k}")
    for name, net, opt, params, opt_state, stats in (
            ("G", port.generator, port.opt_G, new_state.params_G, new_state.opt_state_G,
             new_state.stats_G),
            ("D", port.discriminator, port.opt_D, new_state.params_D,
             new_state.opt_state_D, new_state.stats_D)):
        mu, want = _adam_mu(opt_state), _named(params)
        for key, p in net.named_parameters():
            where = f"{label} {name} {key}"
            g_want, g_got = mu[key], opt.state[p]["exp_avg"].numpy()
            np.testing.assert_allclose(g_got, g_want, rtol=1e-3,
                                       atol=1e-3 * np.abs(g_want).max(), err_msg=where)
            big = np.abs(g_want) > 1e-6
            np.testing.assert_allclose(p.detach().numpy()[big], want[key][big], atol=1e-4,
                                       err_msg=where)
        buffers = dict(net.named_buffers())
        stat_dict = jax_state_dict({"batch_stats": _np(stats)})
        assert set(buffers) == set(stat_dict)
        for key, v in stat_dict.items():
            _rel_close(buffers[key].numpy(), v.numpy(), label=f"{label} {name} {key}")


@pytest.mark.parametrize("dropout", [True, False], ids=["dropout_masks", "no_dropout"])
@pytest.mark.parametrize("gan_mode,lambda_gp", [("vanilla", 0.0), ("lsgan", 0.0),
                                                ("wgangp", 10.0)])
def test_train_step_matches_jax(gan_mode, lambda_gp, dropout):
    """One Pix2PixModel.train_step against afcm_tpu's jitted train_step from
    one Pix2PixState (running statistics off their init), at each gan_mode
    (wgangp with its gradient penalty), with flax's dropout masks and with
    dropout off: losses, gradients, parameters and the statistics of G and
    D after the step; the Adam step count and the learning rate."""
    batch = _batch(0)
    jmodel, port = _models(gan_mode, dropout, lambda_gp=lambda_gp)
    state = _jax_state(dropout)
    load_jax_train_state(port, state)
    key = jax.random.PRNGKey(5)
    masks, alpha = _step_draws(jmodel, state, batch, key, dropout)
    new_state, jax_metrics = jmodel.train_step(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    new_state = _np(new_state)
    metrics = port.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                              dropout_masks=masks, gp_alpha=alpha)
    _compare_step(port, new_state, metrics, _np(jax_metrics), f"{gan_mode} {dropout}")
    assert port.step == int(new_state.step) == 1
    assert all(int(s["step"]) == 1 for s in port.opt_G.state.values())

    # the eval step on the moved statistics
    want = np.asarray(jmodel.eval_step(new_state, jnp.asarray(batch["A"])))
    got = port.eval_step(torch.from_numpy(batch["A"]), None).numpy()
    _rel_close(got, want, label="eval_step")


def test_two_steps_with_lr_and_instance_norm_match_jax():
    """Two steps with the instance norm (biases instead of statistics) and
    a learning rate set between them by with_lr, as the epoch schedule does."""
    batches = [_batch(1), _batch(2)]
    jmodel, port = _models("lsgan", True, norm="instance")
    state = _jax_state(True, "instance", seed=3)
    assert not state.stats_G and not state.stats_D
    load_jax_train_state(port, state)
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(20 + i)
        masks, _ = _step_draws(jmodel, state, batch, key, True)
        state = state.with_lr(1e-4 * (i + 1), 3e-4)
        port.with_lr(1e-4 * (i + 1), 3e-4)
        state, jax_metrics = jmodel.train_step(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        state = _np(state)
        metrics = port.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                  dropout_masks=masks)
        np.testing.assert_allclose(float(metrics["G_L1"]), float(jax_metrics["G_L1"]),
                                   rtol=1e-5)
    want = _named(state.params_G)
    for key, p in port.generator.named_parameters():
        big = np.abs(_adam_mu(state.opt_state_G)[key]) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[big], want[key][big], atol=1e-4,
                                   err_msg=key)
    assert port.opt_G.param_groups[0]["lr"] == 2e-4


def test_train_step_draws_from_its_generator():
    """Without masks or alpha the step's dropout and interpolation come from
    the torch.Generator: two models from one state and one seed step alike,
    and the statistics of G and D move."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    state = _jax_state()
    runs = []
    for _ in range(2):
        _, port = _models("wgangp", True, lambda_gp=10.0)
        load_jax_train_state(port, state)
        before = {k: v.clone() for k, v in port.generator.named_buffers()}
        metrics = port.train_step(batch, generator=torch.Generator().manual_seed(3))
        runs.append((metrics, port))
        assert all(not torch.equal(before[k], v) for k, v in port.generator.named_buffers())
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k
    with pytest.raises(ValueError, match="generator"):
        runs[0][1].train_step(batch)


@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "wgangp"])
def test_gan_losses_match_jax(mode):
    """gan_loss at each mode and target; cal_gradient_penalty with the same
    interpolation weights through a quadratic critic; the dice and
    BCE-dice losses."""
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 1, 6, 6).astype(np.float32) * 3
    for real in (True, False):
        np.testing.assert_allclose(
            float(losses.gan_loss(mode, torch.from_numpy(logits), real)),
            float(jlosses.gan_loss(mode, jnp.asarray(logits), real)), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        losses.gan_loss("hinge", torch.from_numpy(logits), True)

    real_x, fake_x = rng.randn(2, 3, 5, 5).astype(np.float32), rng.randn(2, 3, 5, 5).astype(
        np.float32)
    w = rng.randn(3, 5, 5).astype(np.float32)
    key = jax.random.PRNGKey(int(rng.randint(100)))
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)))
    want, want_grads = jlosses.cal_gradient_penalty(
        lambda x: jnp.sum((x * w) ** 2, axis=(1, 2, 3)), real_x, fake_x, key)
    wt = torch.from_numpy(w).requires_grad_(True)
    got, grads = losses.cal_gradient_penalty(
        lambda x: ((x * wt) ** 2).sum(dim=(1, 2, 3)), torch.from_numpy(real_x),
        torch.from_numpy(fake_x), alpha=torch.from_numpy(alpha))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(grads.detach().numpy(), np.asarray(want_grads), rtol=1e-5)
    # the penalty differentiates into the critic's parameters
    (dw,) = torch.autograd.grad(got, wt)
    jdw = jax.grad(lambda w: jlosses.cal_gradient_penalty(
        lambda x: jnp.sum((x * w) ** 2, axis=(1, 2, 3)), real_x, fake_x, key)[0])(w)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-4, atol=1e-6)

    target = (rng.rand(2, 1, 6, 6) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.dice_loss_1class(torch.from_numpy(logits), torch.from_numpy(target))),
        float(jlosses.dice_loss_1class(jnp.asarray(logits), jnp.asarray(target))), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.bce_dice_loss(torch.from_numpy(logits), torch.from_numpy(target),
                                   0.5, 2.0)),
        float(jlosses.bce_dice_loss(jnp.asarray(logits), jnp.asarray(target), 0.5, 2.0)),
        rtol=1e-6)


@pytest.mark.parametrize("shape", [(64, 32, 4, 4), (64, 2, 4, 4)], ids=["wide", "tall"])
@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_weight_init_types(init_type, shape):
    """The distributions of tests/test_pix2pix.py:test_weight_init_types
    against the JAX package's draws at the same shape: std within 10% of
    JAX's and of the formula; orthogonal with orthonormal rows ([out, k],
    k >= out) or columns (k < out) as flax's column_axis=0 gives."""
    gain = 0.02 if init_type != "xavier" else 1.0
    got = pix2pix.make_weight_init(init_type, gain)(shape, torch.Generator().manual_seed(0))
    want = np.asarray(jpix.make_weight_init(init_type, gain)(jax.random.PRNGKey(0), shape))
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    got = got.numpy()
    out, k = shape[0], int(np.prod(shape[1:]))
    if init_type == "orthogonal":
        for w in (got, want):
            flat = w.reshape(out, k) / gain
            gram = flat @ flat.T if k >= out else flat.T @ flat
            np.testing.assert_allclose(gram, np.eye(min(out, k)), atol=1e-4)
        return
    rf = int(np.prod(shape[2:]))
    std = {"normal": gain, "xavier": gain * np.sqrt(2.0 / (shape[1] * rf + out * rf)),
           "kaiming": np.sqrt(2.0 / (shape[1] * rf))}[init_type]
    for w in (got, want):
        assert abs(w.std() - std) < 0.1 * std, (w.std(), std)
    assert abs(got.std() - want.std()) < 0.1 * std


def test_weight_init_of_the_nets():
    """Every kernel of the built nets follows its init type, BN scales are
    N(1, init_gain), biases 0, running statistics 0 and 1; unknown names
    raise."""
    g = pix2pix.UnetGenerator(4, 1, num_downs=7, ngf=8, init_type="kaiming",
                              generator=torch.Generator().manual_seed(0))
    w = g.mid1.down_w.detach().numpy()
    assert abs(w.std() - np.sqrt(2.0 / (64 * 16))) < 0.1 * np.sqrt(2.0 / (64 * 16))
    scales = torch.cat([m.scale for m in g.modules() if isinstance(m, pix2pix._Norm)])
    assert abs(float(scales.mean()) - 1) < 0.01 and abs(float(scales.std()) - 0.02) < 0.005
    assert not g.outer.up_b.detach().any()
    assert not any(b.any() for n, b in g.named_buffers() if n.endswith(".mean"))
    assert all(b.eq(1).all() for n, b in g.named_buffers() if n.endswith(".var"))
    with pytest.raises(NotImplementedError):
        pix2pix.make_weight_init("bogus")
    with pytest.raises(NotImplementedError):
        pix2pix._Norm(4, "group")


@pytest.mark.parametrize("overrides", [
    [],
    ["model.G.netG", "unet_128", "model.D.netD", "pixel"],
    ["model.G.norm", "instance", "model.D.netD", "n_layers", "model.D.n_layers", "4",
     "model.D.norm", "none", "model.G.dropout", "False"],
], ids=["default", "unet_128_pixel", "instance_n_layers"])
def test_build_model_matches_jax_tree(overrides):
    """build_model on the tiny config gives a Pix2PixModel whose G and D
    hold the JAX package's variables, name for name and shape for shape,
    and its config's objective and optimizers."""
    from afcm_tpu.config import default_argument_parser as jparse
    from afcm_tpu.models import build_model as jbuild
    from afcm_tpu_torch.config import default_argument_parser
    argv = ["--config-file", TINY, "model.G.ngf", "4", "model.D.ndf", "4", *overrides]
    jmodel, port = jbuild(jparse(argv)), build_model(default_argument_parser(argv))
    assert isinstance(port, Pix2PixModel) and port.config == Pix2PixConfig(
        **vars(jmodel.config))
    shapes = jax.eval_shape(jmodel.init_state, jax.random.PRNGKey(0),
                            {"A": jnp.zeros((2, 1, 128, 128)),
                             "B": jnp.zeros((2, 1, 128, 128))})
    for net, params, stats in ((port.generator, shapes.params_G, shapes.stats_G),
                               (port.discriminator, shapes.params_D, shapes.stats_D)):
        want = {**_flat_shapes(params), **_flat_shapes(stats)}
        assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == want
    assert port.opt_G.defaults["betas"] == (0.5, 0.999)


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_adni_base_config_raises_in_both_packages():
    """Fault C8: configs/adni/base.yml as shipped selects pix2pix over the
    4-slice CMSR window but leaves G.input_nc 1 and D.input_nc 2 (the
    pix2pix defaults), so both packages fail on a [2, 4, 256, 256] A; with
    model.G.input_nc 4 model.D.input_nc 5 (at narrow widths here) both
    build and agree."""
    from afcm_tpu.config import default_argument_parser as jparse
    from afcm_tpu.models import build_model as jbuild
    from afcm_tpu_torch.config import default_argument_parser
    argv = ["--config-file", ADNI_BASE]
    batch = {"A": np.zeros((2, 4, 256, 256), np.float32),
             "B": np.zeros((2, 1, 256, 256), np.float32)}
    cfg = default_argument_parser(argv)
    assert (cfg.model.G.input_nc, cfg.model.D.input_nc, cfg.loaders.slice_num) == (1, 2, 4)
    with pytest.raises(ValueError):
        jbuild(jparse(argv)).init_state(jax.random.PRNGKey(0),
                                        {k: jnp.asarray(v) for k, v in batch.items()})
    port = build_model(cfg)
    with pytest.raises(RuntimeError, match="channels"):
        port.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                        generator=torch.Generator().manual_seed(0))

    fixed = argv + ["model.G.input_nc", "4", "model.D.input_nc", "5",
                    "model.G.ngf", "2", "model.D.ndf", "2"]
    jmodel, port = jbuild(jparse(fixed)), build_model(default_argument_parser(fixed))
    a = np.random.RandomState(8).randn(2, 4, 256, 256).astype(np.float32)
    state = _np(jmodel.init_state(jax.random.PRNGKey(0), {**batch, "A": jnp.asarray(a)}))
    load_jax_train_state(port, state)
    _rel_close(port.eval_step(torch.from_numpy(a)).numpy(),
               np.asarray(jmodel.eval_step(state, jnp.asarray(a))), label="eval_step")


def _write_aligned_tree(root, n_train=4, n_test=2, size=128):
    """tests/test_pix2pix.py's synthetic A|B side-by-side RGB images."""
    from PIL import Image
    rng = np.random.RandomState(0)
    for phase, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(root, phase)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            ab = rng.randint(0, 255, (size, 2 * size, 3), np.uint8)
            Image.fromarray(ab).save(os.path.join(d, f"{i}.png"))


def test_train_cli_end_to_end_and_resume(tmp_path, capsys):
    """python -m afcm_tpu_torch.train on configs/demo/pix2pix_tiny.yml with
    --device cpu over a tiny aligned tree (validating on its test/ folder):
    finite PSNR/SSIM, the pix2pix checkpoint files (G and D with their
    statistics, the optimizers; no G_ema), the loss log; then a resume
    from them continues where the run stopped."""
    pytest.importorskip("PIL")
    from afcm_tpu_torch import train as train_cli
    _write_aligned_tree(str(tmp_path / "data"))
    common = ["--config-file", TINY, "--device", "cpu",
              "loaders.dataroot", str(tmp_path / "data"),
              "checkpoints_dir", str(tmp_path / "ckpt")]
    result = train_cli.main(common + ["trainer.max_iters", "4"])
    assert np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])
    run_dir = tmp_path / "ckpt" / "pix2pix_tiny"
    names = sorted(os.listdir(run_dir))
    for name in ("latest_net_G.pth", "latest_net_D.pth", "latest_optim.pth"):
        assert name in names
    assert not any("G_ema" in n for n in names)
    assert "G_L1" in (run_dir / "loss_log.txt").read_text()
    state_g = torch.load(run_dir / "latest_net_G.pth", weights_only=True)
    assert "mid0.down_norm.var" in state_g and not state_g["mid0.down_norm.var"].eq(1).all()
    optim = torch.load(run_dir / "latest_optim.pth", weights_only=True)
    assert optim["step"] == 2

    capsys.readouterr()
    train_cli.main(common + ["trainer.max_iters", "2", "continue_train", "True"])
    assert f"resuming from {run_dir}/latest" in capsys.readouterr().out
    assert torch.load(run_dir / "latest_optim.pth", weights_only=True)["step"] == 3


def test_checkpoint_round_trip(tmp_path):
    """save_state -> load_state into a model built from another seed gives
    the same parameters, statistics, Adam states and step; the next step
    then equals the live model's bit for bit."""
    from afcm_tpu_torch.config import default_argument_parser
    cfg = default_argument_parser(["--config-file", TINY])
    live = build_model(cfg, generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(9, size=128).items()}
    live.train_step(batch, generator=torch.Generator().manual_seed(1))
    ckpt.save_state(live, str(tmp_path), "latest")
    fresh = build_model(cfg, generator=torch.Generator().manual_seed(5))
    assert ckpt.checkpoint_exists(str(tmp_path), "latest", fresh)
    ckpt.load_state(fresh, str(tmp_path), "latest")
    for a, b in ((live.generator, fresh.generator),
                 (live.discriminator, fresh.discriminator)):
        for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(v, w), k
    assert fresh.step == live.step == 1
    metrics = [m.train_step(batch, generator=torch.Generator().manual_seed(2))
               for m in (live, fresh)]
    for k in metrics[0]:
        assert torch.equal(metrics[0][k], metrics[1][k]), k
    for (k, v), (_, w) in zip(live.generator.state_dict().items(),
                              fresh.generator.state_dict().items()):
        assert torch.equal(v, w), k


def test_train_cli_without_a_card_raises_unless_cpu_is_asked(tmp_path):
    """The pix2pix train CLI runs on the card: without one and without
    --device cpu it raises before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device exists")
    from afcm_tpu_torch import train as train_cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config-file", TINY, "checkpoints_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_template_model_matches_jax():
    """The template model: two L1 regression steps from the same weights,
    the loss and the parameters after each."""
    from afcm_tpu.models.template_model import TemplateModel as JaxTemplate
    from afcm_tpu_torch.models.template_model import TemplateModel
    rng = np.random.RandomState(10)
    batch = {"A": rng.randn(2, 3, 16, 16).astype(np.float32),
             "B": rng.randn(2, 1, 16, 16).astype(np.float32)}
    jmodel = JaxTemplate()
    state = _np(jmodel.init_state(jax.random.PRNGKey(0), batch))
    port = TemplateModel(3)
    load_jax_variables(port.net, {"params": state.params})
    for _ in range(2):
        state, jax_metrics = jmodel.train_step(state, batch)
        metrics = port.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(metrics["loss_G"]), float(jax_metrics["loss_G"]),
                                   rtol=1e-5)
    want = _named(state.params)
    for k, p in port.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], atol=1e-5, err_msg=k)
    _rel_close(port.eval_step(torch.from_numpy(batch["A"])).numpy(),
               np.asarray(jmodel.eval_step(state, batch["A"])), label="eval_step")
    # a fresh net draws flax's lecun_normal: std sqrt(1 / fan_in)
    w = TemplateModel(64, generator=torch.Generator().manual_seed(0)).net.Conv_0.kernel
    assert abs(float(w.std()) - np.sqrt(1 / 576)) < 0.1 * np.sqrt(1 / 576)


def test_jax_checkpoint_converts_to_port_weights(tmp_path):
    """scripts/jax_ckpt_to_torch.py on a pix2pix run: latest_state.msgpack
    -> latest_net_G.pth and latest_net_D.pth with the batch statistics,
    which load strictly into the port's nets, equal; no G_ema file."""
    import importlib.util
    from afcm_tpu.utils.checkpoint import save_state
    _, port = _models("vanilla", True)
    state = _jax_state(seed=12)
    save_state(state, str(tmp_path), "latest")
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts", "jax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main([str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["latest_net_D.pth", "latest_net_G.pth",
                                            "latest_state.msgpack"]
    for name, net, params, stats in (("G", port.generator, state.params_G, state.stats_G),
                                     ("D", port.discriminator, state.params_D,
                                      state.stats_D)):
        net.load_state_dict(torch.load(tmp_path / f"latest_net_{name}.pth",
                                       weights_only=True), strict=True)
        want = jax_state_dict({"params": params, "batch_stats": stats})
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k]), k
    with pytest.raises(SystemExit):
        script.main([str(tmp_path / "none")])


@pytest.mark.slow
def test_full_width_unet_256_forward_matches_jax():
    """The full-width unet_256 G of configs/adni/base.yml (with
    model.G.input_nc 4, fault C8) at batch 1, eval mode on running
    statistics off their init, JAX's init carried across."""
    g = jpix.UnetGenerator(input_nc=4, output_nc=1, num_downs=8, ngf=64)
    rng = np.random.RandomState(13)
    x = rng.randn(1, 4, 256, 256).clip(-1, 1).astype(np.float32)
    variables = _np(jax.jit(lambda x: g.init({"params": jax.random.PRNGKey(0),
                                              "dropout": jax.random.PRNGKey(1)},
                                             x, train=True))(x))
    variables["batch_stats"] = _perturb_stats(variables["batch_stats"], rng)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, x: g.apply(v, x, train=False))(variables, x))
    port = load_jax_variables(pix2pix.UnetGenerator(4, 1, num_downs=8, ngf=64), variables)
    assert sum(p.numel() for p in port.parameters()) == 54_410_881 == sum(
        np.size(v) for v in jax.tree.leaves(variables["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=False).numpy()
    err = float(np.abs(got - want).max())
    print(f"full-width unet_256 max|port - JAX| {err:.3g} of max|JAX| "
          f"{float(np.abs(want).max()):.4g}")
    _rel_close(got, want, label="unet_256")
