"""``tpu.remat`` in the port's StyleGAN3 generator against itself and against
afcm_tpu's, on the CPU.

The port recomputes each checkpointed layer in the backward
(``torch.utils.checkpoint``, no reentry), as ``afcm_tpu`` wraps it in
``nn.remat``: the values and gradients are those without remat. The small
generator and the tolerances are tests/test_remat_bf16.py:25-100's: forward
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6, at every layer and
at ``remat_min_size`` 24 (which takes every layer of this generator) and
40 (which leaves two out); the JAX weights are carried across with
``load_jax_variables``.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu.nn import Stylegan3Generator as JaxGenerator  # noqa: E402
from afcm_tpu.utils.port import variables_to_state_dict  # noqa: E402
from afcm_tpu_torch.nn import Stylegan3Generator  # noqa: E402
from afcm_tpu_torch.ops.cuda import filtered_lrelu as k1  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_variables  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/demo/cmsr_tiny.yml")
# tests/test_remat_bf16.py:12-17
SMALL = dict(z_dim=32, c_dim=1, w_dim=32, img_resolution=32, img_channels_in=4,
             img_channels_out=1, mapping_kwargs=dict(num_layers=2))
SYNTH = dict(channel_base=1024, channel_max=32, num_layers=4, num_critical=2,
             margin_size=4, skip_resolution=16, conv_clamp=256, lrelu_upsampling=2)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    z = rng.randn(2, 32).astype(np.float32)
    c = rng.rand(2, 1).astype(np.float32)
    cond = rng.randn(2, 4, 32, 32).clip(-1, 1).astype(np.float32)
    plain = JaxGenerator(synthesis_kwargs=dict(SYNTH), **SMALL)
    variables = jax.tree.map(np.asarray, plain.init(jax.random.PRNGKey(0), z, c, cond))
    return (z, c, cond), variables


def _port(variables, **synth):
    net = Stylegan3Generator(synthesis_kwargs=dict(SYNTH, **synth), **SMALL)
    return load_jax_variables(net, variables)


def _port_grads(net, inputs, generator=None):
    z, c, cond = (torch.from_numpy(x) for x in inputs)
    out = net(z, c, cond, train=generator is not None, generator=generator)
    grads = torch.autograd.grad(torch.mean(torch.square(out)), list(net.parameters()))
    return out.detach(), dict(zip([k for k, _ in net.named_parameters()], grads))


def _jax_grads(variables, inputs, **synth):
    gen = JaxGenerator(synthesis_kwargs=dict(SYNTH, **synth), **SMALL)
    z, c, cond = inputs
    out = np.asarray(gen.apply(variables, z, c, cond))
    grads = jax.grad(lambda v: jnp.mean(jnp.square(gen.apply(v, z, c, cond))))(variables)
    named = variables_to_state_dict(jax.tree.map(np.asarray, grads))
    return out, {k: np.asarray(v) for k, v in named.items()}


@pytest.mark.parametrize("synth,rematted", [
    (dict(remat=True), 9),                        # every layer
    (dict(remat=True, remat_min_size=24), 9),     # tests/test_remat_bf16.py's gate
    (dict(remat=True, remat_min_size=40), 7),     # all but the 24^2 and 32^2 layers
])
def test_remat_matches_plain_and_jax(case, synth, rematted):
    """Forward and gradients with remat against the port without it and
    against afcm_tpu with the same remat, at the tolerances of
    tests/test_remat_bf16.py; the layers the size gate picks (toRGB among
    them), and one more K1-path call per checkpointed layer but toRGB in
    the backward (counted on the plain version's operator)."""
    inputs, variables = case
    plain = _port(variables)
    remat = _port(variables, **synth)
    layers = remat.synthesis.encoders + remat.synthesis.decoders
    assert sum(layer.remat for layer in layers) == rematted
    assert not any(layer.remat for layer in plain.synthesis.encoders + plain.synthesis.decoders)

    out_p, grads_p = _port_grads(plain, inputs)
    calls = []
    real = remat.synthesis._layer.__func__

    def counting(self, layer, *args):
        calls.append(layer.remat)
        return real(self, layer, *args)

    remat.synthesis._layer = counting.__get__(remat.synthesis)
    out_r, grads_r = _port_grads(remat, inputs)
    assert sum(calls) == rematted
    torch.testing.assert_close(out_r, out_p, **FWD_TOL)
    for k in grads_p:
        torch.testing.assert_close(grads_r[k], grads_p[k], **GRAD_TOL, msg=k)

    want_out, want_grads = _jax_grads(variables, inputs, **synth)
    np.testing.assert_allclose(out_r.numpy(), want_out, **FWD_TOL)
    for k, g in grads_r.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k],
                                   rtol=GRAD_TOL["rtol"], atol=GRAD_TOL["atol"], err_msg=k)


def test_checkpointed_layers_draw_nothing(case):
    """A checkpointed region must not draw from an explicit generator: its
    recompute would draw again (``preserve_rng_state`` saves only the
    default generators). The train-mode forward draws the co-modulation
    dropout in the head, outside every checkpointed layer: with remat at
    every layer the generator's state after forward and backward is the
    state without remat, and so are the output and gradients."""
    inputs, variables = case
    results = []
    for synth in ({}, dict(remat=True)):
        net = _port(variables, dropout_rate=0.5, **synth)
        gen = torch.Generator().manual_seed(11)
        out, grads = _port_grads(net, inputs, generator=gen)
        results.append((out, grads, gen.get_state()))
    (out_p, grads_p, state_p), (out_r, grads_r, state_r) = results
    assert torch.equal(state_p, state_r)
    assert torch.equal(out_r, out_p)
    for k in grads_p:
        torch.testing.assert_close(grads_r[k], grads_p[k], **GRAD_TOL, msg=k)
    layers = (net.synthesis.encoders + net.synthesis.decoders)
    assert all("generator" not in type(layer).forward.__code__.co_varnames for layer in layers)


def test_config_knob_reaches_the_generator(monkeypatch):
    """``tpu.remat`` / ``tpu.remat_min_size`` reach the StyleGAN3 G of the
    train model (``afcm_tpu/models/__init__.py:103-107``) and not G_ema's
    inference; the train CLI no longer refuses them, and since tensor
    parallelism was ported (ROADMAP item A12c) remat over a (2, 2) mesh
    starts its four ranks (the launch is recorded here, not run; remat over
    a model axis runs in tests/test_torch_tensor_parallel.py)."""
    from afcm_tpu_torch import train as train_cli
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.models import build_eval_model, build_gan_model
    cfg = default_argument_parser(["--config-file", CONFIG, "tpu.remat", "True",
                                   "tpu.remat_min_size", "40"])
    model = build_gan_model(cfg)
    layers = model.generator.synthesis.encoders + model.generator.synthesis.decoders
    big = [max(layer.spec.in_size, layer.spec.out_size) >= 40 for layer in layers]
    assert [layer.remat for layer in layers] == big and 0 < sum(big) < len(big)
    off = build_gan_model(default_argument_parser(["--config-file", CONFIG]))
    assert not any(layer.remat for layer in off.generator.synthesis.encoders)
    served = build_eval_model(dict(cfg.model.G))
    assert not any(layer.remat for layer in served.generator_ema.synthesis.encoders)

    class Stop(Exception):
        pass

    def no_loaders(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(train_cli, "get_train_loaders", no_loaders)
    with pytest.raises(Stop):
        train_cli.main(["--config-file", CONFIG, "--device", "cpu", "tpu.remat", "True"])
    launched = []
    monkeypatch.setattr(train_cli.parallel, "spawn",
                        lambda fn, world, args, **kw: launched.append(world))
    assert train_cli.main(["--config-file", CONFIG, "--device", "cpu", "tpu.remat", "True",
                           "tpu.mesh_shape", "[2, 2]"]) == {}
    assert launched == [4]


def test_remat_train_step_launches_the_operator_once_more_per_layer(case):
    """In a train step with a shared G forward the operator
    ``filtered_lrelu`` runs once per K1 layer in the forward and once more
    per checkpointed K1 layer in the backward; on the CPU that is its plain
    version, which the wrapper counts nowhere (K1's launch count stays 0
    here, as on the card it moves only where the kernel launches)."""
    inputs, variables = case
    net = _port(variables, remat=True)
    calls = []
    op = torch.ops.afcm_tpu_torch.filtered_lrelu.default
    with _count_op(op, calls):
        _port_grads(net, inputs)
    kernel_layers = sum(1 for layer in net.synthesis.encoders + net.synthesis.decoders
                        if not layer.spec.is_torgb)
    assert len(calls) == 2 * kernel_layers
    assert k1.launches == 0


class _count_op(torch.utils._python_dispatch.TorchDispatchMode):
    """Records each call of ``op`` below autograd."""

    def __init__(self, op, calls):
        super().__init__()
        self.op, self.calls = op, calls

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is self.op:
            self.calls.append(func)
        return func(*args, **(kwargs or {}))


def test_train_path_bounds_the_conv_workspace_on_the_card(monkeypatch):
    """ROADMAP C12's repair: at float32 on a card the train CLI's entry caps
    cuDNN's conv workspace (the legacy cuDNN interface under
    CUDNN_CONV_WSCAP_DBG) before the process's first conv; it leaves
    bfloat16 and the CPU alone; ``train.main`` applies it with the config's
    compute dtype (on the CPU here, where it sets nothing) before it trains,
    and ``train.train``, which a serving process may call too, does not."""
    from afcm_tpu_torch import train as train_cli
    for name in ("TORCH_CUDNN_V8_API_DISABLED", "CUDNN_CONV_WSCAP_DBG"):
        monkeypatch.delenv(name, raising=False)
    assert not train_cli.bound_conv_workspace(torch.device("cpu"), "float32")
    assert not train_cli.bound_conv_workspace("cuda", "bfloat16")
    assert "CUDNN_CONV_WSCAP_DBG" not in os.environ
    assert train_cli.bound_conv_workspace("cuda", "float32")
    assert os.environ["TORCH_CUDNN_V8_API_DISABLED"] == "1"
    assert os.environ["CUDNN_CONV_WSCAP_DBG"] == str(train_cli.CONV_WORKSPACE_MIB)

    calls = []
    monkeypatch.setattr(train_cli, "bound_conv_workspace", lambda *a: calls.append(a))
    monkeypatch.setattr(train_cli, "train", lambda cfg, device: calls.append("train") or {})
    train_cli.main(["--config-file", CONFIG, "--device", "cpu"])
    assert calls == [(torch.device("cpu"), "float32"), "train"]
