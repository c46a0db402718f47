"""``filter2d``, ``downsample2d`` and the discriminator's ``skip`` and
``orig`` architectures of the port against the JAX package's, on CPU.

The same numpy inputs go through both; D's weights are initialized in JAX
and carried across with ``variables_to_state_dict`` (strict). Tolerances:
the FIR ops at rtol 1e-5 / atol 1e-6 (float32 sums of a few taps in another
order); D's logits at rtol 1e-4 / atol 1e-5 and R1 at rtol 1e-4, those of
tests/test_torch_train.py's D test.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu.models import losses as jlosses  # noqa: E402
from afcm_tpu.nn import CoModDiscriminator as JaxDiscriminator  # noqa: E402
from afcm_tpu.ops import downsample2d as jax_downsample2d  # noqa: E402
from afcm_tpu.ops import filter2d as jax_filter2d  # noqa: E402
from afcm_tpu.ops import setup_filter as jax_setup_filter  # noqa: E402
from afcm_tpu_torch.models import losses  # noqa: E402
from afcm_tpu_torch.nn import CoModDiscriminator  # noqa: E402
from afcm_tpu_torch.ops import downsample2d, filter2d, setup_filter  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_variables  # noqa: E402

torch.set_num_threads(1)

FIR_TOL = dict(rtol=1e-5, atol=1e-6)
D_ARGS = dict(c_dim=1, img_resolution=32, img_channels=5, channel_base=1024,
              channel_max=32, epilogue_kwargs=dict(mbstd_group_size=2))


@pytest.mark.parametrize("taps,padding,gain,flip", [
    ([1, 3, 3, 1], 0, 1, False),
    ([1, 2, 1], 1, 2.0, False),
    ([1, 3, 3, 1], (1, 0, 2, 1), 1, True),
    ([1, 4, 6, 4, 1], 0, 1, False),
])
def test_filter2d_and_downsample2d_match_jax(taps, padding, gain, flip):
    """``afcm_tpu/ops/upfirdn2d.py:273-280`` and ``:295-303``: the padding
    arithmetic and the result, for even and odd filters, per-side padding,
    a gain and a flipped filter."""
    x = np.random.RandomState(len(taps)).randn(2, 3, 17, 20).astype(np.float32)
    f = setup_filter(taps)
    assert np.array_equal(f, np.asarray(jax_setup_filter(taps)))
    kwargs = dict(padding=padding, gain=gain, flip_filter=flip)
    for port_fn, jax_fn in ((filter2d, jax_filter2d), (downsample2d, jax_downsample2d)):
        want = np.asarray(jax_fn(jnp.asarray(x), f, **kwargs))
        got = port_fn(torch.from_numpy(x), f, **kwargs).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **FIR_TOL)
    assert filter2d(torch.from_numpy(x), f).shape == x.shape
    assert downsample2d(torch.from_numpy(x), f, down=(2, 1)).shape == (2, 3, 17, 10)


@pytest.mark.parametrize("architecture", ["skip", "orig", "resnet"])
def test_discriminator_architectures_match_jax(architecture):
    """D built directly at each architecture (neither package's builder
    selects skip or orig): its weights load strictly (the ``fromrgb`` of
    every skip block and of the epilogue among them), its logits and R1
    against JAX's."""
    rng = np.random.RandomState(4)
    img = rng.randn(2, 5, 32, 32).clip(-1, 1).astype(np.float32)
    c = rng.rand(2, 1).astype(np.float32)
    jdisc = JaxDiscriminator(architecture=architecture, **D_ARGS)
    variables = jax.tree.map(np.asarray, jdisc.init(jax.random.PRNGKey(0), img, c))
    disc = load_jax_variables(CoModDiscriminator(architecture=architecture, **D_ARGS),
                              variables)
    names = {k for k, _ in disc.named_parameters()}
    has_rgb = {f"b{r}.fromrgb.weight" for r in (32, 16, 8)} | {"b4.fromrgb.weight"}
    if architecture == "skip":
        assert has_rgb <= names and not any(".skip." in k for k in names)
    else:
        assert names & has_rgb == {"b32.fromrgb.weight"}
        assert any(".skip." in k for k in names) == (architecture == "resnet")

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdisc.apply(variables, img, c))
        want_r1 = float(jlosses.r1_penalty(lambda x: jdisc.apply(variables, x, c), img))
    x = torch.from_numpy(img).requires_grad_(True)
    got = disc(x, torch.from_numpy(c))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(losses.r1_penalty(got, x).detach()), want_r1,
                               rtol=1e-4)


def test_discriminator_refuses_an_unknown_architecture():
    with pytest.raises(ValueError, match="architecture"):
        CoModDiscriminator(architecture="dense", **D_ARGS)


def _param_grads_match(disc, jax_grads, module):
    """Each parameter's gradient of the port's backward against JAX's (the
    motion D's bounds: rtol 1e-3, atol 1e-4 * max|g|)."""
    want = dict(load_jax_variables(module, {"params": jax.tree.map(np.asarray, jax_grads)})
                .named_parameters())
    for name, p in disc.named_parameters():
        g_want = want[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=1e-3,
                                   atol=1e-4 * np.abs(g_want).max() + 1e-12, err_msg=name)


@pytest.mark.parametrize("architecture,block_kwargs", [
    ("resnet", dict(resample_filter=[1, 2, 1])),
    ("resnet", dict(activation="swish")),
    ("orig", dict(activation="relu", resample_filter=[1, 4, 6, 4, 1])),
])
def test_discriminator_block_kwargs_match_jax(architecture, block_kwargs):
    """``block_kwargs`` reaches every block (``afcm_tpu/nn/discriminator.py:
    118,143-154``): the blocks' activation and the resample filter of their
    down-convs and of the image. Logits, R1 and every parameter's gradient
    of the logits' sum against JAX's on the same weights."""
    rng = np.random.RandomState(6)
    img = rng.randn(2, 5, 32, 32).clip(-1, 1).astype(np.float32)
    c = rng.rand(2, 1).astype(np.float32)
    kwargs = dict(D_ARGS, architecture=architecture, block_kwargs=block_kwargs)
    jdisc = JaxDiscriminator(**kwargs)
    variables = jax.tree.map(np.asarray, jdisc.init(jax.random.PRNGKey(1), img, c))
    disc = load_jax_variables(CoModDiscriminator(**kwargs), variables)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdisc.apply(variables, img, c))
        want_r1 = float(jlosses.r1_penalty(lambda x: jdisc.apply(variables, x, c), img))
        grads = jax.grad(lambda p: jnp.sum(jdisc.apply({"params": p}, img, c)))(
            variables["params"])
    x = torch.from_numpy(img).requires_grad_(True)
    got = disc(x, torch.from_numpy(c))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(losses.r1_penalty(got, x).detach()), want_r1,
                               rtol=1e-4)
    disc.zero_grad()
    disc(torch.from_numpy(img), torch.from_numpy(c)).sum().backward()
    _param_grads_match(disc, grads, CoModDiscriminator(**kwargs))
    # the default block_kwargs give another D: the keys are not ignored
    plain = load_jax_variables(CoModDiscriminator(**dict(kwargs, block_kwargs=None)),
                               variables)
    assert not torch.allclose(plain(torch.from_numpy(img), torch.from_numpy(c)),
                              got.detach(), rtol=1e-3, atol=0)


@pytest.mark.parametrize("block_kwargs", [dict(conv_clamp=256), dict(kernel_size=5)])
def test_discriminator_refuses_block_kwargs_jax_refuses(block_kwargs):
    """A key the JAX D's blocks do not take, or that the D sets itself, is a
    TypeError in both packages."""
    img = np.zeros((2, 5, 32, 32), np.float32)
    c = np.zeros((2, 1), np.float32)
    with pytest.raises(TypeError):
        JaxDiscriminator(block_kwargs=block_kwargs, **D_ARGS).init(
            jax.random.PRNGKey(0), img, c)
    with pytest.raises(TypeError, match=sorted(block_kwargs)[0]):
        CoModDiscriminator(block_kwargs=block_kwargs, **D_ARGS)
