"""The port's alias-free generator against the JAX package's, on CPU.

A tiny generator (the shipped architecture's five filter variants at sizes
36-84 and 16 channels) is initialized in JAX and loaded into the port with
``load_jax_variables``; the same numpy z, c and cond go through both.
Tolerance: fp32 rtol 5e-3 / atol 2e-4, the generator contract of
docs/porting.md:30-32 and tests/test_stylegan3_parity.py:108 (observed
max |diff| 3.6e-7 on a 0.76-range output).
"""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu.models import build_generator as jax_build_generator  # noqa: E402
from afcm_tpu.nn import Stylegan3Generator as JaxGenerator  # noqa: E402
from afcm_tpu.utils.port import variables_to_state_dict  # noqa: E402
from afcm_tpu_torch.models import (CMSR_ADNI_G, build_eval_model,  # noqa: E402
                                   build_generator)
from afcm_tpu_torch.nn import Stylegan3Generator  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_variables  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(z_dim=32, c_dim=1, w_dim=32, img_resolution=64,
            img_channels_in=4, img_channels_out=1,
            mapping_kwargs=dict(num_layers=2),
            synthesis_kwargs=dict(channel_base=1024, channel_max=16,
                                  num_layers=8, num_critical=2,
                                  margin_size=10, skip_resolution=32,
                                  lrelu_upsampling=2, conv_clamp=256))
GEN_TOL = dict(rtol=5e-3, atol=2e-4)


def _inputs(batch=2, seed=0, res=64):
    rng = np.random.RandomState(seed)
    z = rng.randn(batch, 32).astype(np.float32)
    c = rng.rand(batch, 1).astype(np.float32)
    cond = rng.randn(batch, 4, res, res).clip(-1, 1).astype(np.float32)
    return z, c, cond


def _perturb_moments(tree, rng):
    """Trained-looking statistics: magnitude_ema away from its init 1, a
    nonzero w_avg — so input_gain and truncation are exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_moments(v, rng)
        elif k == "magnitude_ema":
            out[k] = np.float32(rng.uniform(0.5, 2.0))
        else:
            out[k] = rng.randn(*np.shape(v)).astype(np.float32) * 0.1
    return out


@pytest.fixture(scope="module")
def tiny():
    z, c, cond = _inputs()
    gen = JaxGenerator(**TINY)
    variables = jax.tree.map(np.asarray, gen.init(jax.random.PRNGKey(0), z, c, cond))
    variables = dict(variables)
    variables["moments"] = _perturb_moments(variables["moments"],
                                            np.random.RandomState(1))
    return gen, variables


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 4)])
def test_tiny_generator_matches_jax(tiny, psi, cutoff):
    jgen, variables = tiny
    z, c, cond = _inputs()
    want = np.asarray(jgen.apply(variables, z, c, cond, truncation_psi=psi,
                                 truncation_cutoff=cutoff))
    port = load_jax_variables(Stylegan3Generator(**TINY), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(c),
                   torch.from_numpy(cond), truncation_psi=psi,
                   truncation_cutoff=cutoff).numpy()
    assert got.shape == want.shape == (2, 1, 64, 64)
    np.testing.assert_allclose(got, want, **GEN_TOL)


def test_state_dict_names_match_jax_exactly(tiny):
    """Strict load: no missing or unexpected key, every shape equal; filter
    taps are not state."""
    _, variables = tiny
    want = variables_to_state_dict(variables)
    port = Stylegan3Generator(**TINY)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == {k: tuple(np.shape(v)) for k, v in want.items()}
    assert not any("filter" in k for k in got)
    result = port.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v
                                   in want.items()}, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_cmsr_literal_equals_shipped_config():
    """chip_smoke.py builds the shipped generator from CMSR_ADNI_G without
    yaml; it must be what the config of the ADNI CMSR model resolves to."""
    from afcm_tpu.config import default_argument_parser
    cfg = default_argument_parser(
        ["--config-file", os.path.join(REPO, "configs/adni/stylegan3/cmsr.yml")])
    as_dict = {k: dict(v) if isinstance(v, dict) else v
               for k, v in cfg.model.G.items()}
    assert as_dict == CMSR_ADNI_G


def test_full_size_generator_state_matches_jax_shapes():
    """The shipped generator's 58.5M parameters carry the JAX package's
    names and shapes (shapes from jax.eval_shape: no full-size init)."""
    jgen = jax_build_generator(dict(CMSR_ADNI_G))
    shapes = jax.eval_shape(lambda: jgen.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 512)), jnp.zeros((1, 1)),
        jnp.zeros((1, 4, 256, 256))))
    want = {k: tuple(v.shape) for k, v in variables_to_state_dict(
        jax.tree.map(lambda s: np.empty(s.shape, s.dtype), shapes)).items()}
    port = build_generator(CMSR_ADNI_G)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert sum(p.numel() for p in port.parameters()) == 58_497_071


def test_build_gan_model_eval_step(tiny):
    """eval_step: c from slice_idx, z drawn from an explicit generator."""
    jgen, variables = tiny
    _, c, cond = _inputs()
    model = build_eval_model({"netG": "stylegan3", **TINY})
    load_jax_variables(model.generator_ema, variables)
    z = torch.randn((2, 32), generator=torch.Generator().manual_seed(3))
    got = model.eval_step(torch.from_numpy(cond), torch.from_numpy(c),
                          generator=torch.Generator().manual_seed(3))
    want = np.asarray(jgen.apply(variables, z.numpy(), c, cond))
    np.testing.assert_allclose(got.numpy(), want, **GEN_TOL)


def test_jax_checkpoint_converts_to_port_weights(tiny, tmp_path):
    """scripts/jax_ckpt_to_torch.py: {tag}_net_G_ema.msgpack ->
    {tag}_net_G_ema.pth, which loads strictly and round-trips every tensor."""
    from afcm_tpu.utils.checkpoint import save_generator_only
    _, variables = tiny
    state = SimpleNamespace(params_G_ema=variables["params"],
                            moments_G_ema=variables["moments"],
                            constants_G={})
    save_generator_only(state, str(tmp_path), "latest")
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts", "jax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.convert(str(tmp_path), "latest")
    assert out == str(tmp_path / "latest_net_G_ema.pth")
    state_dict = torch.load(out, weights_only=True)
    port = Stylegan3Generator(**TINY)
    port.load_state_dict(state_dict, strict=True)
    for k, v in variables_to_state_dict(variables).items():
        np.testing.assert_array_equal(state_dict[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("size,sampling_rate,bandwidth", [(36, 16, 2), (20, 8, 3.5)])
def test_synthesis_input_matches_jax(size, sampling_rate, bandwidth):
    """SynthesisInput, upstream StyleGAN3's Fourier-feature input
    (``afcm_tpu/nn/stylegan3.py:320-372``): JAX's ``freqs``, ``phases``,
    ``weight`` and a random affine (rotation and translation) loaded into
    the port with the reference's identity ``transform``; the grids agree at
    the generator's tolerance. The port draws its own freqs and phases at
    construction from its generator, as persistent buffers."""
    from afcm_tpu.nn import SynthesisInput as JaxSynthesisInput
    from afcm_tpu_torch.nn import SynthesisInput
    from afcm_tpu_torch.utils.port import jax_state_dict
    kwargs = dict(w_dim=16, channels=24, size=size, sampling_rate=sampling_rate,
                  bandwidth=bandwidth)
    w = np.random.RandomState(2).randn(3, 16).astype(np.float32)
    jmod = JaxSynthesisInput(**kwargs)
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), w))
    variables = {k: dict(v) for k, v in variables.items()}
    variables["params"]["affine"] = dict(
        variables["params"]["affine"],
        weight=np.random.RandomState(3).randn(4, 16).astype(np.float32))
    want = np.asarray(jmod.apply(variables, w))
    port = SynthesisInput(**kwargs, generator=torch.Generator().manual_seed(0))
    assert {k for k, _ in port.named_buffers()} == {"freqs", "phases", "transform"}
    assert port.state_dict().keys() == {"freqs", "phases", "transform", "weight",
                                        "affine.weight", "affine.bias"}
    torch.testing.assert_close(port.transform, torch.eye(3))
    port.load_state_dict(dict(jax_state_dict(variables), transform=torch.eye(3)),
                         strict=True)
    got = port(torch.from_numpy(w)).detach().numpy()
    assert got.shape == want.shape == (3, 24, size, size)
    np.testing.assert_allclose(got, want, **GEN_TOL)


@pytest.mark.slow
def test_full_size_generator_matches_jax_cpu():
    """The shipped generator at full width on CPU (minutes; not Tier-1)."""
    jgen = jax_build_generator(dict(CMSR_ADNI_G))
    rng = np.random.RandomState(0)
    z = rng.randn(1, 512).astype(np.float32)
    c = rng.rand(1, 1).astype(np.float32)
    cond = rng.randn(1, 4, 256, 256).clip(-1, 1).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jgen.init)(
        jax.random.PRNGKey(0), z, c, cond))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jgen.apply)(variables, z, c, cond))
    port = load_jax_variables(build_generator(CMSR_ADNI_G), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(c),
                   torch.from_numpy(cond)).numpy()
    print(f"full-size generator: max|port - jax| {np.abs(got - want).max():.3g}, "
          f"max|jax| {np.abs(want).max():.4g}")        # shown by pytest -rP
    np.testing.assert_allclose(got, want, **GEN_TOL)
