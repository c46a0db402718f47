"""The port's training path against the JAX package's on CPU.

The same numpy inputs, made from a seed, go through ``afcm_tpu`` and
``afcm_tpu_torch``: the filtered_lrelu backward's plain version (K2's
oracle), the blur, the discriminator, the losses, the LR schedule and whole
train steps from one ``GANTrainState`` carried across by
``load_jax_train_state``. The tiny G and D are those of
tests/test_train_step.py, with the co-modulation dropout at 0 as in
tests/test_train_parity.py (dropout masks cannot match across frameworks).
"""

import copy
import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu import models as jmodels  # noqa: E402
from afcm_tpu.models import losses as jlosses  # noqa: E402
from afcm_tpu.models.schedulers import LRScheduler as JaxLRScheduler  # noqa: E402
from afcm_tpu.nn.layers import MinibatchStdLayer as JaxMbstd  # noqa: E402
from afcm_tpu.ops import filtered_lrelu as jax_filtered_lrelu  # noqa: E402
from afcm_tpu.ops import gaussian_blur2d as jax_blur  # noqa: E402
from afcm_tpu.ops.filter_design import design_lowpass_filter  # noqa: E402
from afcm_tpu.ops.pallas.filtered_lrelu_mxu import filtered_lrelu_mxu  # noqa: E402
from afcm_tpu.utils.easydict import EasyDict as ED  # noqa: E402
from afcm_tpu.utils.port import variables_to_state_dict  # noqa: E402
from afcm_tpu_torch.models import (GANConfig, GANModel,  # noqa: E402
                                   build_discriminator, build_generator)
from afcm_tpu_torch.models import losses  # noqa: E402
from afcm_tpu_torch.models.schedulers import LRScheduler  # noqa: E402
from afcm_tpu_torch.nn import MinibatchStdLayer, SynthesisNetwork  # noqa: E402
from afcm_tpu_torch.ops import gaussian_blur2d  # noqa: E402
from afcm_tpu_torch.ops.cuda.filtered_lrelu import (  # noqa: E402
    filtered_lrelu_bwd_plain)
from afcm_tpu_torch.utils.port import (load_jax_train_state,  # noqa: E402
                                       load_jax_variables)

torch.set_num_threads(1)

TINY_G = dict(netG="stylegan3", z_dim=32, c_dim=1, w_dim=32, img_resolution=32,
              img_channels_in=4, img_channels_out=1,
              mapping_kwargs=dict(num_layers=2),
              synthesis_kwargs=dict(channel_base=1024, channel_max=32,
                                    num_layers=4, num_critical=2,
                                    skip_resolution=16, conv_clamp=256,
                                    margin_size=4, lrelu_upsampling=2,
                                    dropout_rate=0.0))
TINY_D = dict(netD="comodgan", c_dim=1, img_resolution=32, img_channels=5,
              channel_base=1024, channel_max=32,
              epilogue_kwargs=dict(mbstd_group_size=2))
STEP_CFG = dict(z_dim=32, c_dim=1, batch_size=2, blur_init_sigma=2.0,
                blur_fade_kimg=1.0)

# tests/test_pallas_mxu.py:21-27, at batch 1
MXU_CONFIGS = [
    dict(size=36, c=8, up=2, down=2, ntu=12, ntd=12, pad=(9, 8, 9, 8)),
    dict(size=40, c=4, up=4, down=2, ntu=24, ntd=12, pad=(-6, -9, -6, -9)),
    dict(size=48, c=4, up=2, down=4, ntu=12, ntd=24, pad=(34, 33, 34, 33)),
    dict(size=70, c=3, up=2, down=2, ntu=12, ntd=12,
         pad=(-11, -12, -11, -12)),
]


def _mxu_case(cfg, seed=0):
    rng = np.random.RandomState(seed)
    fs = cfg["size"] * cfg["up"]
    fu = design_lowpass_filter(cfg["ntu"], cutoff=cfg["size"] / 4,
                               width=cfg["size"] / 4, fs=fs)
    fd = design_lowpass_filter(cfg["ntd"], cutoff=cfg["size"] / 4,
                               width=cfg["size"] / 4, fs=fs)
    x = rng.randn(1, cfg["c"], cfg["size"], cfg["size"]).astype(np.float32)
    b = rng.randn(cfg["c"]).astype(np.float32)
    kw = dict(fu=fu, fd=fd, up=cfg["up"], down=cfg["down"], padding=cfg["pad"],
              gain=float(np.sqrt(2)), slope=0.2, clamp=256.0)
    y = np.asarray(jax_filtered_lrelu(x, b=b, impl="xla", **kw))
    dy = rng.randn(*y.shape).astype(np.float32)
    return x, b, dy, kw


@pytest.mark.parametrize("cfg", MXU_CONFIGS,
                         ids=lambda c: f"u{c['up']}d{c['down']}s{c['size']}")
def test_filtered_lrelu_bwd_plain_matches_jax(cfg):
    """K2's plain version against jax.vjp of the XLA composition and of the
    Pallas kernel's custom VJP in interpret mode (the contract of
    tests/test_pallas_mxu.py:62-85: rtol 1e-4, atol 1e-5)."""
    x, b, dy, kw = _mxu_case(cfg)
    got_dx, got_db = filtered_lrelu_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(dy), b=torch.from_numpy(b), **kw)

    _, vjp = jax.vjp(lambda x, b: jax_filtered_lrelu(x, b=b, impl="xla", **kw),
                     x, b)
    _, vjp_mxu = jax.vjp(lambda x, b: filtered_lrelu_mxu(
        x, kw["fu"], kw["fd"], b, kw["up"], kw["down"], kw["padding"],
        kw["gain"], kw["slope"], kw["clamp"], False, interpret=True), x, b)
    for want_dx, want_db in (vjp(dy), vjp_mxu(dy)):
        np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_db.numpy(), np.asarray(want_db),
                                   rtol=1e-4, atol=1e-5)


def test_cpu_autograd_takes_the_plain_backward_and_k2_refuses_cpu():
    """On a CPU tensor filtered_lrelu differentiates the plain composition
    (what filtered_lrelu_bwd_plain returns); the K1/K2 wrappers refuse CPU
    tensors rather than run the plain version themselves."""
    from afcm_tpu_torch.ops import filtered_lrelu
    from afcm_tpu_torch.ops.cuda import filtered_lrelu as k1
    x, b, dy, kw = _mxu_case(MXU_CONFIGS[0], seed=3)
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    launches = (k1.launches, k1.bwd_launches)
    dx, db = torch.autograd.grad(filtered_lrelu(xt, b=bt, **kw), (xt, bt),
                                 torch.from_numpy(dy))
    want_dx, want_db = filtered_lrelu_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(dy), b=torch.from_numpy(b), **kw)
    assert (k1.launches, k1.bwd_launches) == launches
    torch.testing.assert_close(dx, want_dx)
    torch.testing.assert_close(db, want_db)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.filtered_lrelu_bwd_cuda(xt.detach(), torch.from_numpy(dy), b=bt, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.filtered_lrelu_cuda(xt.detach(), b=bt, **kw)


@pytest.mark.parametrize("sigma", [0.0, 0.2, 2.0, 10.0])
def test_gaussian_blur2d_matches_jax(sigma):
    """The static 61-tap footprint of the shipped blur (init sigma 10)."""
    x = np.random.RandomState(1).randn(2, 5, 40, 40).astype(np.float32)
    want = np.asarray(jax_blur(jnp.asarray(x), sigma, max_radius=30))
    got = gaussian_blur2d(torch.from_numpy(x), torch.tensor(sigma), max_radius=30)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if sigma < 1 / 3:
        np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("groups,stride,padding,kernel,size", [
    (3, (1, 2), (0, 0), (1, 4), (9, 11)),   # the D's FIR passes, odd sizes
    (3, (2, 1), (0, 0), (4, 1), (12, 7)),
    (3, (1, 1), (0, 3), (1, 7), (8, 8)),    # the blur's passes
    (1, (1, 1), (1, 1), (3, 3), (8, 9)),    # D's 3x3 convs
    (1, (2, 2), (0, 0), (3, 3), (11, 10)),  # conv1 after its FIR, stride 2
])
def test_conv2d_gradfix_derivatives(groups, stride, padding, kernel, size):
    """conv2d_gradfix against F.conv2d and its autograd in float64: the
    value, the gradients (also where the stride drops trailing rows) and
    R1's double backward, for a trained weight (groups 1) and the constant
    depthwise taps of depthwise_conv2d; torch's gradgradcheck; and no
    autograd convolution node in the gradient's graph."""
    from afcm_tpu_torch.ops import conv2d_gradfix
    from afcm_tpu_torch.ops.upfirdn2d import depthwise_conv2d
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 3, *size)).requires_grad_(True)
    if groups == 1:
        w = torch.from_numpy(rng.randn(4, 3, *kernel)).requires_grad_(True)
        inputs = (x, w)
        port = functools.partial(conv2d_gradfix.conv2d, stride=stride,
                                 padding=padding)
    else:
        taps = rng.randn(*kernel)
        w = torch.from_numpy(taps)[None, None].expand(3, 1, *kernel)
        inputs = (x,)
        port = functools.partial(depthwise_conv2d, taps=taps, stride=stride,
                                 padding=padding)

    def plain(x, w=w):
        return torch.nn.functional.conv2d(x, w, stride=stride, padding=padding,
                                          groups=groups)

    def graph_nodes(t):
        seen, todo = set(), [t.grad_fn]
        while todo:
            node = todo.pop()
            if node is not None and node not in seen:
                seen.add(node)
                todo.extend(f for f, _ in node.next_functions)
        return {type(n).__name__ for n in seen}

    results = []
    for fn in (plain, port):
        y = fn(*inputs)
        # a nonlinear head, so that the gradient depends on x as R1's does
        (dx,) = torch.autograd.grad(torch.tanh(y).sum(), x, create_graph=True)
        second = torch.autograd.grad(dx.square().sum(), inputs)
        results.append((y, dx, *second))
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    nodes = graph_nodes(results[1][1])
    assert "_InputGradBackward" in nodes, nodes
    assert not any(n.startswith("ConvolutionBackward") for n in nodes), nodes
    assert torch.autograd.gradgradcheck(port, inputs)


def test_minibatch_std_matches_jax():
    x = np.random.RandomState(2).randn(4, 6, 4, 4).astype(np.float32)
    for group_size, channels in ((2, 1), (4, 2), (None, 3)):
        want = np.asarray(JaxMbstd(group_size=group_size, num_channels=channels)
                          .apply({}, jnp.asarray(x)))
        got = MinibatchStdLayer(group_size, channels)(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_model():
    return jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                            jmodels.build_discriminator(dict(TINY_D)),
                            jmodels.GANConfig(**STEP_CFG))


def _batch(seed, n=2, res=32):
    rng = np.random.RandomState(seed)
    return {"A": rng.randn(n, 4, res, res).clip(-1, 1).astype(np.float32),
            "B": rng.randn(n, 1, res, res).clip(-1, 1).astype(np.float32),
            "slice_idx": rng.rand(n, 1).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_state(jax_model):
    state = jax_model.init_state(jax.random.PRNGKey(0),
                                 {k: jnp.asarray(v) for k, v in _batch(0).items()})
    return jax.tree.map(np.asarray, state)


def test_discriminator_and_r1_match_jax(jax_model, jax_state):
    """The tiny D forward with the JAX weights carried across, and R1 through
    the blur (sigma 2) at the same weights."""
    batch = _batch(3)
    img = np.concatenate([batch["A"], batch["B"]], axis=1)
    c = batch["slice_idx"]
    disc = load_jax_variables(build_discriminator(dict(TINY_D)),
                              {"params": jax_state.params_D})
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_model._run_d(jax_state.params_D, img, c, 0.0))
        want_r1 = float(jlosses.r1_penalty(
            lambda x: jax_model._run_d(jax_state.params_D, x, c, 2.0), img))
    got = disc(torch.from_numpy(img), torch.from_numpy(c))
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)

    model = GANModel(GANConfig(**STEP_CFG), copy.deepcopy(disc), disc, disc)
    x = torch.from_numpy(img).requires_grad_(True)
    got_r1 = losses.r1_penalty(model._run_d(x, torch.from_numpy(c), 2.0), x)
    np.testing.assert_allclose(float(got_r1.detach()), want_r1, rtol=1e-4)


def test_shipped_discriminator_layout_matches_jax():
    """The shipped CMSR D (configs/adni/stylegan3/cmsr.yml: c_dim 1, 5 input
    channels, mbstd group 16) has the JAX D's parameter names and shapes,
    so its weights load strictly; the layout comes from jax.eval_shape."""
    d_cfg = dict(netD="comodgan", c_dim=1, img_resolution=256, img_channels=5,
                 channel_base=16384, channel_max=512, conv_clamp=None,
                 mapping_kwargs=dict(num_layers=8),
                 epilogue_kwargs=dict(mbstd_group_size=16))
    jdisc = jmodels.build_discriminator(dict(d_cfg))
    shapes = jax.eval_shape(lambda: jdisc.init(
        jax.random.PRNGKey(0), jnp.zeros((16, 5, 256, 256)), jnp.zeros((16, 1))))
    want = {k: tuple(v.shape) for k, v in variables_to_state_dict(
        jax.tree.map(lambda s: np.empty(s.shape, s.dtype), shapes)).items()}
    port = build_discriminator(dict(d_cfg))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert sum(p.numel() for p in port.parameters()) == 26_365_632


def test_label_mapper_matches_jax():
    """D's label-only mapper: z_dim 0, num_ws None, no w_avg."""
    from afcm_tpu.nn.mapping import MappingNetwork as JaxMapping
    from afcm_tpu_torch.nn import MappingNetwork
    c = np.random.RandomState(4).rand(3, 1).astype(np.float32)
    jmap = JaxMapping(z_dim=0, c_dim=1, w_dim=16, num_ws=None, w_avg_beta=None,
                      num_layers=8)
    variables = jax.tree.map(np.asarray, jmap.init(jax.random.PRNGKey(1), None, c))
    port = load_jax_variables(MappingNetwork(0, 1, 16, num_ws=None,
                                             w_avg_beta=None, num_layers=8),
                              variables)
    assert not dict(port.named_buffers())
    np.testing.assert_allclose(port(None, torch.from_numpy(c)).detach().numpy(),
                               np.asarray(jmap.apply(variables, None, c)),
                               rtol=1e-5, atol=1e-6)


def test_lr_scheduler_matches_jax():
    for policy in ("linear", "step", "cosine", "plateau"):
        cfg = ED(scheduler=ED(lr_policy=policy, epoch_count=1, n_epochs=5,
                              n_epochs_decay=5, lr_decay_iters=3))
        want, got = JaxLRScheduler(cfg), LRScheduler(cfg)
        metrics = [None, -0.5, -0.6, -0.6, -0.59, -0.6, -0.6, -0.6, -0.6,
                   -0.6, -0.6, -0.6]
        for epoch, metric in enumerate(metrics, start=1):
            assert got.factor(epoch, metric) == want.factor(epoch, metric), \
                (policy, epoch)
    with pytest.raises(NotImplementedError):
        LRScheduler(ED(scheduler=ED(lr_policy="exp", n_epochs=1,
                                    n_epochs_decay=1, lr_decay_iters=1)))


def test_lr_factor_matches_jax():
    """``train.lr_factor``, the stateless per-epoch factor, against
    ``afcm_tpu.train.lr_factor`` for the three stateless policies, and its
    refusal of ``plateau`` in both packages."""
    from afcm_tpu.train import lr_factor as jax_lr_factor
    from afcm_tpu_torch.train import lr_factor
    for policy in ("linear", "step", "cosine"):
        cfg = ED(scheduler=ED(lr_policy=policy, epoch_count=1, n_epochs=5,
                              n_epochs_decay=5, lr_decay_iters=3))
        for epoch in range(1, 12):
            assert lr_factor(epoch, cfg) == jax_lr_factor(epoch, cfg), (policy, epoch)
    cfg = ED(scheduler=ED(lr_policy="plateau", epoch_count=1, n_epochs=5,
                          n_epochs_decay=5, lr_decay_iters=3))
    for fn in (lr_factor, jax_lr_factor):
        with pytest.raises(ValueError, match="plateau"):
            fn(3, cfg, -0.5)


def test_dropout_draws_from_an_explicit_generator():
    """The co-modulation dropout of the port drew from the global RNG
    (F.dropout): two train-mode forwards from one seed differed, and the
    global RNG state moved. It now draws from the generator it is handed:
    the same seed gives the same mask whatever the global RNG holds, and the
    global state is left alone. The kept values are scaled by 1/(1 - rate),
    as flax's nn.Dropout does."""
    net = SynthesisNetwork(w_dim=8, img_resolution=32, img_channels_in=4,
                           img_channels_out=1, channel_base=256,
                           channel_max=8, num_layers=4, num_critical=2,
                           margin_size=4, skip_resolution=16,
                           global_w_dim=16, dropout_rate=0.5,
                           generator=torch.Generator().manual_seed(0))
    pooled = torch.randn(3, 16, generator=torch.Generator().manual_seed(1))

    torch.manual_seed(0)
    first = torch.nn.functional.dropout(pooled, p=0.5, training=True)
    second = torch.nn.functional.dropout(pooled, p=0.5, training=True)
    assert not torch.equal(first, second)          # what the old code did

    state = torch.get_rng_state()
    outs = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        outs.append(net.dropout(pooled, True, torch.Generator().manual_seed(7),
                                None))
    torch.set_rng_state(state)
    assert torch.equal(outs[0], outs[1])
    kept = outs[0] != 0
    assert 0 < int(kept.sum()) < pooled.numel()
    torch.testing.assert_close(outs[0][kept], pooled[kept] * 2)

    flax_nn = pytest.importorskip("flax.linen")
    flax_out = np.asarray(flax_nn.Dropout(0.5).apply(
        {}, jnp.asarray(pooled.numpy()), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)}))
    got = net.dropout(pooled, True, None, torch.from_numpy(flax_out != 0))
    np.testing.assert_allclose(got.numpy(), flax_out, rtol=1e-6)
    assert torch.equal(net.dropout(pooled, False, None, None), pooled)
    with pytest.raises(ValueError, match="generator"):
        net.dropout(pooled, True, None, None)


def _named(tree):
    return {k: np.asarray(v) for k, v in
            variables_to_state_dict({"params": tree}).items()}


def _adam_mu_nu(opt_state):
    adam = opt_state.inner_state[0]
    return _named(adam.mu), _named(adam.nu)


def v_bound(g, beta2):
    """How far Adam's second moment after a first step from v = 0,
    (1 - beta2)·g², may lie from the reference's when the gradient is held
    to the gradient check's own tolerance, delta = 1e-3·|g| + 1e-3·max|g|
    (rtol and atol of ``_compare_step``): |g'² - g²| <= delta·(2|g| + delta).
    Per entry of ``g`` (the reference's gradient), in float64."""
    g = np.abs(np.asarray(g, dtype=np.float64))
    delta = 1e-3 * g + 1e-3 * g.max()
    return (1 - beta2) * delta * (2 * g + delta)


def assert_v_close(got, want, bound, where):
    """Second moments ``got`` against ``want``: each entry within the
    check's own rtol 2e-3 / atol 1e-5, or within ``bound``, what the
    gradient check vouches for v (``v_bound``). A gradient that passes its
    check may still move v = (1 - beta2)·g² by more than 2e-3 of it: the
    port's own step with every input nudged by 2^-24 does (PERF.md §6,
    ROADMAP C14)."""
    gap = np.abs(got.astype(np.float64) - want)
    ok = (gap <= 1e-5 + 2e-3 * np.abs(want)) | (gap <= bound)
    if not ok.all():
        i = int(np.argmax(np.where(ok, -np.inf, gap - bound)))
        raise AssertionError(
            f"{where} (exp_avg_sq): {int((~ok).sum())} of {ok.size} entries beyond both "
            f"rtol 2e-3 / atol 1e-5 and the gradient check's bound; the worst is "
            f"{float(gap[i])} apart (v {float(want[i])}) against {float(bound[i])}")


def _compare_step(port, state, metrics, jax_metrics, label, sensitive):
    """Losses at rtol 1e-4; gradients per tensor at rtol 1e-3 and atol
    1e-3·max|g|; parameters, EMA and second moments after the step at 1e-5
    wherever |g| > 1e-6 in every step so far.

    The gradients are read from Adam's first moment: with beta1 = 0 it is
    the step's gradient. Adam's update is about lr·g/(|g| + eps) on the
    first step: where |g| is at the level of the two frameworks' rounding
    its sign, and with it a step of lr, can differ, and a small |g| held
    only to the atol moves the update by up to lr·eps/|g|. Those entries
    (``sensitive``, by parameter, accumulated over the steps) are left out
    of the parameter check."""
    for k in ("G_GAN", "G_L1", "D_real", "D_fake", "D_r1", "blur_sigma"):
        np.testing.assert_allclose(float(metrics[k]), float(jax_metrics[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=f"{label} {k}")
    nets = (("G", port.generator, port.opt_G, state.params_G, state.opt_state_G),
            ("D", port.discriminator, port.opt_D, state.params_D,
             state.opt_state_D))
    for name, net, opt, params, opt_state in nets:
        mu, nu = _adam_mu_nu(opt_state)
        want_params = _named(params)
        for key, p in net.named_parameters():
            tag = f"{name} {key}"
            where = f"{label} {tag}"
            g_want = mu[key]
            g_got = opt.state[p]["exp_avg"].numpy()
            scale = np.abs(g_want).max()
            np.testing.assert_allclose(g_got, g_want, rtol=1e-3,
                                       atol=1e-3 * scale, err_msg=where)
            big = np.abs(g_want) > 1e-6
            sensitive[tag] = big = big & sensitive.get(tag, True)
            np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy()[big],
                                       nu[key][big], rtol=2e-3, atol=1e-5,
                                       err_msg=where)
            np.testing.assert_allclose(p.detach().numpy()[big],
                                       want_params[key][big], atol=1e-5,
                                       err_msg=where)
    want_ema = _named(state.params_G_ema)
    for key, p in port.generator_ema.named_parameters():
        big = sensitive[f"G {key}"]
        np.testing.assert_allclose(p.numpy()[big], want_ema[key][big],
                                   atol=1e-5, err_msg=f"{label} G_ema {key}")


@pytest.mark.parametrize("name,overrides,r1_schedule", [
    ("two_forwards", {}, (True, True)),
    ("shared_g_fwd", {"shared_g_fwd": True}, (True, True)),
    ("lazy_r1", {"r1_interval": 2}, (True, False)),
])
def test_train_step_matches_jax(jax_state, name, overrides, r1_schedule):
    """Two steps of the port's GANModel.train_step against
    afcm_tpu's _train_step_impl from one GANTrainState, with z injected."""
    cfg = dict(STEP_CFG, **overrides)
    jmodel = jmodels.GANModel(jmodels.build_generator(dict(TINY_G)),
                              jmodels.build_discriminator(dict(TINY_D)),
                              jmodels.GANConfig(**cfg))
    net_g = build_generator(dict(TINY_G))
    port = GANModel(GANConfig(**cfg), copy.deepcopy(net_g), net_g,
                    build_discriminator(dict(TINY_D)))
    load_jax_train_state(port, jax_state)

    state = jax.tree.map(jnp.asarray, jax_state)
    key = jax.random.PRNGKey(5)           # dropout is 0: the key is unused
    checked = {}
    for step, with_r1 in enumerate(r1_schedule, start=1):
        batch = _batch(10 + step)
        z = np.random.RandomState(20 + step).randn(2, 32).astype(np.float32)
        nimg = 2.0 * step
        run = jax.jit(lambda st, b, z, n, r1=with_r1: jmodel._train_step_impl(
            st, b, z, key, key, n, with_r1=r1))
        state, jax_metrics = run(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jnp.asarray(z), jnp.asarray(nimg))
        state = jax.tree.map(np.asarray, state)
        metrics = port.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                  nimg, with_r1=with_r1, z=torch.from_numpy(z))
        if not with_r1:
            assert float(metrics["D_r1"]) == 0.0
        _compare_step(port, state, metrics, jax_metrics, f"{name} step {step}",
                      checked)
    assert port.step == 2

    # The dict that flax's msgpack_restore makes of a state loads the same.
    from flax import serialization
    fresh = GANModel(GANConfig(**cfg), build_generator(dict(TINY_G)),
                     build_generator(dict(TINY_G)),
                     build_discriminator(dict(TINY_D)))
    load_jax_train_state(fresh, serialization.to_state_dict(state))
    mu, nu = _adam_mu_nu(state.opt_state_D)
    want = _named(state.params_D)
    for key, p in fresh.discriminator.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[key])
        np.testing.assert_array_equal(fresh.opt_D.state[p]["exp_avg"].numpy(), mu[key])
        np.testing.assert_array_equal(fresh.opt_D.state[p]["exp_avg_sq"].numpy(), nu[key])
        assert int(fresh.opt_D.state[p]["step"]) == 2
    assert fresh.step == 2


def _port_params(port):
    """Per net of a port model, each parameter as numpy, by name."""
    return {name: {k: p.detach().numpy().copy() for k, p in net.named_parameters()}
            for name, net in (("G", port.generator), ("D", port.discriminator))}


def _port_arrays(port, start):
    """Per net of a stepped port model: each parameter's update from
    ``start`` (``_port_params`` before the step) and the step's gradient
    (Adam's first moment, beta1 = 0), as numpy by name."""
    params = _port_params(port)
    return {name: ({k: params[name][k] - start[name][k] for k in params[name]},
                   {k: opt.state[p]["exp_avg"].numpy() for k, p in net.named_parameters()})
            for name, net, opt in (("G", port.generator, port.opt_G),
                                   ("D", port.discriminator, port.opt_D))}


def _jax_arrays(state, start):
    """``_port_arrays`` of a ``GANTrainState`` stepped from ``start``."""
    return {name: ({k: v - _named(getattr(start, f"params_{name}"))[k]
                    for k, v in _named(getattr(state, f"params_{name}")).items()},
                   _adam_mu_nu(getattr(state, f"opt_state_{name}"))[0])
            for name in ("G", "D")}


def step_misses(got, want):
    """Per net, how far one step's parameter updates and gradients
    (``got``, by ``_port_arrays``) are from another's (``want``), against
    _compare_step's bounds, which hold the parameters after steps from one
    state: the gradients' max |got - want| over max|g| of the tensor; where
    |g| > 1e-6 the updates' entries more than 1e-5 apart (their count by
    tensor), the largest distance, the largest |g| / max|g| of the tensor
    among those entries, and the worst entry's tensor, both gradients and
    the tensor's max|g|."""
    out = {}
    for net, (params, grads) in want.items():
        got_params, got_grads = got[net]
        row = dict(grad_max_rel_err=0.0, param_misses=0, param_max_abs_err=0.0,
                   misses_max_g_rel=0.0, misses_by_tensor={}, worst=None)
        for key, g in grads.items():
            scale = max(float(np.abs(g).max()), 1e-30)
            row["grad_max_rel_err"] = max(row["grad_max_rel_err"],
                                          float(np.abs(got_grads[key] - g).max()) / scale)
            apart = np.abs(got_params[key] - params[key]) * (np.abs(g) > 1e-6)
            over = apart > 1e-5
            if float(apart.max()) > row["param_max_abs_err"]:
                i = np.unravel_index(int(apart.argmax()), apart.shape)
                row["param_max_abs_err"] = float(apart.max())
                row["worst"] = dict(tensor=key, g=float(g[i]), g_got=float(got_grads[key][i]),
                                    max_abs_g=scale)
            if over.any():
                row["param_misses"] += int(over.sum())
                row["misses_by_tensor"][key] = int(over.sum())
                row["misses_max_g_rel"] = max(row["misses_max_g_rel"],
                                              float(np.abs(g[over]).max()) / scale)
        out[net] = row
    return out


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ROADMAP C14: the shipped CMSR training config at its published widths,
# batch 2, one G forward for both phases
FULL_SIZE_ARGV = ("--config-file", os.path.join(REPO, "configs/adni/stylegan3/cmsr.yml"),
                  "loaders.batch_size", "2", "tpu.shared_g_fwd", "True")
LOSSES = ("G_GAN", "G_L1", "D_real", "D_fake", "D_r1")


def full_size_jax_step():
    """afcm_tpu's side of the full-size step: the GANTrainState it starts
    from, the batch and z (seeded numpy), one _train_step_impl under the
    highest matmul precision, and the co-modulation dropout's keep-mask,
    read off flax's nn.Dropout inside the jitted step."""
    import types

    import flax.linen as fnn
    from afcm_tpu.config import default_argument_parser as jax_config

    jmodel = jmodels.build_gan_model(jax_config(list(FULL_SIZE_ARGV)))
    cfg = jmodel.config
    assert cfg.shared_g_fwd and cfg.lambda_r1 > 0 and cfg.batch_size == 2
    batch = _batch(7, n=2, res=jmodel.generator.img_resolution)
    z = np.random.RandomState(8).randn(2, cfg.z_dim).astype(np.float32)
    nimg = 2.0
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jax.tree.map(np.asarray, jax.jit(jmodel.init_state)(
        jax.random.PRNGKey(0), jbatch))

    def step(state, batch, z, key):
        masks = []

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout):
                masks.append(out != 0)
            return out

        with fnn.intercept_methods(record):
            new, metrics = jmodel._train_step_impl(state, batch, z, key, key, nimg,
                                                   with_r1=True)
        return new, metrics, masks

    with jax.default_matmul_precision("highest"):
        new_state, metrics, masks = jax.jit(step)(
            jax.tree.map(jnp.asarray, state), jbatch, jnp.asarray(z), jax.random.PRNGKey(5))
    assert len(masks) == 1                  # one G forward serves both phases
    return types.SimpleNamespace(
        state=state, batch=batch, z=z, nimg=nimg, keep=np.array(masks[0]),
        new_state=jax.tree.map(np.asarray, new_state),
        metrics={k: float(v) for k, v in metrics.items()})


def full_size_port_step(case, nudge=0.0, seed=0):
    """The port's side: a GANModel built from the same config, loaded with
    ``case``'s starting state, its dropout given JAX's mask, one
    train_step on ``case``'s batch and z, on every core. With ``nudge``
    every weight, buffer and input is first multiplied by 1 + nudge·N(0, 1)
    (chip_smoke.py's rounding-floor nudge). Returns the model, the losses
    and its parameters before the step (``_port_params``)."""
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.models import build_gan_model
    from afcm_tpu_torch.nn.layers import dropout

    port = build_gan_model(default_argument_parser(list(FULL_SIZE_ARGV)))
    load_jax_train_state(port, case.state)
    inputs = {k: torch.from_numpy(v) for k, v in dict(case.batch, z=case.z).items()}
    if nudge:
        draws = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for net in (port.generator, port.generator_ema, port.discriminator):
                for v in [*net.parameters(), *net.buffers()]:
                    v.mul_(1 + nudge * torch.randn(v.shape, generator=draws))
            inputs = {k: v * (1 + nudge * torch.randn(v.shape, generator=draws))
                      for k, v in inputs.items()}
    synthesis = port.generator.synthesis
    keep = torch.from_numpy(case.keep)
    synthesis.dropout = lambda x, train, generator, keep_mask=None: dropout(
        x, synthesis.dropout_rate, train, generator, keep)
    z = inputs.pop("z")
    start = _port_params(port)
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)     # alone, not under xdist
    try:
        metrics = port.train_step(inputs, case.nimg, with_r1=True, z=z)
    finally:
        torch.set_num_threads(threads)
    return port, {k: float(v) for k, v in metrics.items()}, start


@pytest.mark.slow
def test_full_size_train_step_matches_jax_cpu():
    """One step of the shipped CMSR training config at full width (b2,
    float32, shared_g_fwd, R1 on) against afcm_tpu's _train_step_impl under
    the highest matmul precision, from one GANTrainState carried across by
    load_jax_train_state (ROADMAP C14). z is injected and the port's
    co-modulation dropout takes JAX's keep-mask; the StyleGAN3 G draws no
    noise. Held to _compare_step's bounds. About 15 minutes and 20 GiB on
    the CPU: not Tier-1. ``pytest -m slow -rP -k full_size_train_step``
    prints the misses; scripts/torch_full_step_parity.py prints them beside
    float32's rounding floor."""
    case = full_size_jax_step()
    port, metrics, start = full_size_port_step(case)
    print("full-size train step: losses' relative errors",
          {k: abs(metrics[k] - case.metrics[k]) / max(abs(case.metrics[k]), 1e-30)
           for k in LOSSES}, "against afcm_tpu",
          step_misses(_port_arrays(port, start), _jax_arrays(case.new_state, case.state)))
    counts, misses = _compare_full_size_step(port, case, metrics, start)
    print("full-size train step: entries by class", counts)
    print("full-size train step: failed checks", misses)
    assert not misses, misses


def _compare_full_size_step(port, case, metrics, start):
    """_compare_step's losses and gradients as they are; its parameter and
    EMA checks at 1e-5 on the entries whose gradient the gradient check
    vouches for, |g| > 1e-3·max|g| of its tensor (that check's own atol),
    and its second-moment check there as ``assert_v_close`` (rtol 2e-3 /
    atol 1e-5, or the bound the gradient check implies: the port's own
    nudged step moves one v of ``e_16x16.bias`` by 1.6%, as far as
    afcm_tpu's is from the port's; ROADMAP C14). Under that threshold the
    gradient's sign is not vouched for, and Adam's first step,
    lr·g/(|g| + eps), turns a flipped sign into a move of up to 2·lr: the
    port's own step with every input nudged by 2^-24 misses the 1e-5 check
    there too (PERF.md §6, C14). Those
    entries are held to what Adam's arithmetic guarantees: a move of at
    most lr·(1 + 1e-6), and p == p_start - lr·m̂/(√v̂ + eps) within 1e-6
    from the port's own moments, each plus half the float32 spacing at the
    stored parameter. Every check runs on every tensor; returns, per net,
    how many entries each class holds and the checks that failed."""
    misses = []

    def check(fn, *args, **kwargs):
        try:
            fn(*args, **kwargs)
        except AssertionError as exc:
            misses.append(str(exc).strip().splitlines()[:6])

    for k in ("G_GAN", "G_L1", "D_real", "D_fake", "D_r1", "blur_sigma"):
        check(np.testing.assert_allclose, float(metrics[k]), float(case.metrics[k]),
              rtol=1e-4, atol=1e-7, err_msg=f"full-size {k}")
    state = case.new_state
    want_ema = _named(state.params_G_ema)
    counts = {}
    for name, net, opt, params, opt_state in (
            ("G", port.generator, port.opt_G, state.params_G, state.opt_state_G),
            ("D", port.discriminator, port.opt_D, state.params_D, state.opt_state_D)):
        mu, nu = _adam_mu_nu(opt_state)
        want_params = _named(params)
        ema = dict(port.generator_ema.named_parameters()) if name == "G" else {}
        (group,) = opt.param_groups
        lr, eps = group["lr"], group["eps"]
        beta1, beta2 = group["betas"]
        counts[name] = {"vouched": 0, "adam_bound": 0}
        for key, p in net.named_parameters():
            where = f"full-size {name} {key}"
            g_want = mu[key]
            adam = opt.state[p]
            g_got = adam["exp_avg"].numpy()
            scale = np.abs(g_want).max()
            check(np.testing.assert_allclose, g_got, g_want, rtol=1e-3,
                  atol=1e-3 * scale, err_msg=where)
            got = p.detach().numpy()
            vouched = np.abs(g_want) > 1e-3 * scale
            check(assert_v_close, adam["exp_avg_sq"].numpy()[vouched], nu[key][vouched],
                  v_bound(g_want, beta2)[vouched], where)
            check(np.testing.assert_allclose, got[vouched], want_params[key][vouched],
                  atol=1e-5, err_msg=where)
            if key in ema:
                check(np.testing.assert_allclose, ema[key].numpy()[vouched],
                      want_ema[key][vouched], atol=1e-5, err_msg=f"{where} (G_ema)")
            rest = ~vouched
            t = int(adam["step"])
            p0 = start[name][key].astype(np.float64)[rest]
            m_hat = g_got.astype(np.float64)[rest] / (1 - beta1 ** t)
            v_hat = adam["exp_avg_sq"].numpy().astype(np.float64)[rest] / (1 - beta2 ** t)
            moved = got.astype(np.float64)[rest] - p0
            # the stored parameter is float32: rounding it adds up to half
            # its spacing (1.5e-5 at the mapping's |p| ~ 300, lr_multiplier)
            rounding = np.spacing(np.abs(got[rest])).astype(np.float64) / 2
            if not np.all(np.abs(moved) <= lr * (1 + 1e-6) + rounding):
                misses.append([f"{where}: a move beyond lr"])
            miss = np.abs(moved + lr * m_hat / (np.sqrt(v_hat) + eps))
            if not np.all(miss <= 1e-6 + rounding):
                misses.append([f"{where}: Adam's update {float(miss.max())} off"])
            counts[name]["vouched"] += int(vouched.sum())
            counts[name]["adam_bound"] += int(rest.sum())
    return counts, misses


def test_jax_train_state_converts_to_port_weights(jax_state, tmp_path):
    """scripts/jax_ckpt_to_torch.py: {tag}_state.msgpack -> {tag}_net_G.pth
    and {tag}_net_D.pth, which load strictly into the port's G and D."""
    import importlib.util
    import os
    from afcm_tpu.utils.checkpoint import save_state
    save_state(jax_state, str(tmp_path), "latest")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(repo, "scripts", "jax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    paths = script.convert_train_state(str(tmp_path), "latest")
    assert paths == [str(tmp_path / "latest_net_G.pth"),
                     str(tmp_path / "latest_net_D.pth")]
    for path, net, params in ((paths[0], build_generator(dict(TINY_G)),
                               jax_state.params_G),
                              (paths[1], build_discriminator(dict(TINY_D)),
                               jax_state.params_D)):
        net.load_state_dict(torch.load(path, weights_only=True), strict=True)
        for key, p in net.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), _named(params)[key])
    assert script.convert_train_state(str(tmp_path / "none"), "latest") == []
