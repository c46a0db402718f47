"""Reference AFCM checkpoints into the port (``afcm_tpu_torch.utils.port``),
against ``afcm_tpu``'s ``state_dict_to_variables`` on the CPU.

There is no reference checkpoint in the repository, so each case builds a
reference-style state_dict from a JAX network: ``afcm_tpu``'s
``variables_to_state_dict`` of its variables, plus the construction-time
buffers the reference registers and ``afcm_tpu`` drops (``_DROP_LEAVES``),
at the reference's shapes, which the port's own filter design gives. The
dict then goes two ways: through ``state_dict_to_variables`` into the JAX
forward, and through the port's converter and a strict load into the
port's forward. The outputs are held at the generator tolerance of
tests/test_torch_generator.py (rtol 5e-3, atol 2e-4).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from afcm_tpu import models as jmodels  # noqa: E402
from afcm_tpu.nn import CoModGenerator as JaxCoModGenerator  # noqa: E402
from afcm_tpu.nn import Stylegan3Generator as JaxGenerator  # noqa: E402
from afcm_tpu.nn import SynthesisInput as JaxSynthesisInput  # noqa: E402
from afcm_tpu.nn import motion as jmotion  # noqa: E402
from afcm_tpu.utils.port import (_DROP_LEAVES, state_dict_to_variables,  # noqa: E402
                                 variables_to_state_dict)
from afcm_tpu_torch.models import build_eval_model  # noqa: E402
from afcm_tpu_torch.nn import (CoModGenerator, Stylegan3Generator,  # noqa: E402
                               SynthesisInput, motion)
from afcm_tpu_torch.utils import port  # noqa: E402
from tests import test_torch_comodgan as comod  # noqa: E402
from tests import test_torch_generator as sg3  # noqa: E402
from tests import test_torch_motion as tmotion  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_TOL = dict(rtol=5e-3, atol=2e-4)


def reference_dict(module, variables):
    """The reference-style state_dict of JAX ``variables`` for the port's
    ``module``: every JAX tensor under its reference name, and each
    construction-time buffer (``_DROP_LEAVES``) the module's layers hold
    (the alias-free layers' 1-D taps, toRGB's none; the [4, 4] resample
    filters; the time encoders' tables)."""
    state = {k: np.asarray(v) for k, v in variables_to_state_dict(variables).items()}
    for name, mod in module.named_modules():
        for leaf in _DROP_LEAVES:
            value = getattr(mod, leaf, None)
            if value is not None:
                state[f"{name}.{leaf}" if name else leaf] = np.asarray(value, np.float32)
    return state


def both_ways(state, port_module, jax_apply):
    """The JAX forward on ``state_dict_to_variables(state)`` and the port's
    module after the converter and a strict load (its forward is the
    caller's)."""
    want = np.asarray(jax.jit(jax_apply)(state_dict_to_variables(state)))
    port_module.load_state_dict(port.reference_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()}), strict=True)
    return want


def test_stylegan3_reference_dict_matches_jax():
    """The tiny StyleGAN3 G (trained-looking w_avg and 0-d magnitude_ema):
    the raw reference dict fails the strict load, naming the filter
    buffers; converted, the port's output equals JAX's."""
    z, c, cond = sg3._inputs()
    jgen = JaxGenerator(**sg3.TINY)
    variables = dict(jax.tree.map(np.asarray, jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                                                  z, c, cond)))
    variables["moments"] = sg3._perturb_moments(variables["moments"],
                                                np.random.RandomState(1))
    net = Stylegan3Generator(**sg3.TINY)
    state = reference_dict(net, variables)
    dropped = {k for k in state if k.rsplit(".", 1)[-1] in _DROP_LEAVES}
    (torgb,) = [n for n, m in net.named_modules()
                if getattr(getattr(m, "spec", None), "is_torgb", False)]
    assert {"synthesis.encoder_0.up_filter", "synthesis.e_16x16.resample_filter"} <= dropped
    assert not any(k.startswith(torgb + ".") for k in dropped)      # toRGB has no taps
    assert np.ndim(state["synthesis.encoder_0.magnitude_ema"]) == 0
    with pytest.raises(RuntimeError, match="up_filter"):
        net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                            strict=True)
    want = both_ways(state, net, lambda v: jgen.apply(v, z, c, cond))
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (z, c, cond))).numpy()
    np.testing.assert_allclose(got, want, **GEN_TOL)


def test_comodgan_channel_attention_reference_dict_matches_jax():
    """A CoModGAN G with channel attention: the CALayer ``conv_du.{0,2}``
    convs as they are, the resample filters dropped, ``noise_const`` and
    ``w_avg`` kept."""
    z, c, cond, ref = comod._inputs()
    synth = dict(comod.SYNTH, channel_attention=True)
    kwargs = dict(mapping_kwargs=dict(comod.MAP), synthesis_kwargs=synth, **comod.GEN)
    jgen = JaxCoModGenerator(**kwargs)
    variables = comod._perturb(jax.tree.map(np.asarray, jax.jit(lambda: jgen.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, z, c, cond,
        ref_img=ref, noise_mode="const"))()), np.random.RandomState(9))
    net = CoModGenerator(**kwargs)
    state = reference_dict(net, variables)
    assert any(k.endswith("ca.conv_du.2.weight") for k in state)
    assert any(k.endswith("noise_const") for k in state)
    assert any(k.endswith("resample_filter") for k in state)
    want = both_ways(state, net, lambda v: jgen.apply(v, z, c, cond, ref_img=ref,
                                                      noise_mode="const"))
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (z, c, cond)), ref_img=torch.from_numpy(ref),
                  noise_mode="const").numpy()
    np.testing.assert_allclose(got, want, **GEN_TOL)


def test_styleganv_discriminator_reference_dict_matches_jax():
    """The StyleGAN-V D: the time encoder's ``fourier_coefs``
    (non-persistent in the port) dropped with the blocks' resample filters;
    the logits of both."""
    img, c, delta_t = tmotion._disc_inputs(2)
    jdisc = jmotion.StyleGANVDiscriminator(**tmotion.DISC)
    variables = tmotion._init_jax(jdisc, img, c, delta_t)
    disc = motion.StyleGANVDiscriminator(**tmotion.DISC)
    state = reference_dict(disc, variables)
    assert "time_encoder.time_encoder.fourier_coefs" in state
    want = both_ways(state, disc, lambda v: jdisc.apply(v, img, c, delta_t))
    with torch.no_grad():
        got = disc(*map(torch.from_numpy, (img, c, delta_t))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_synthesis_input_reference_dict_matches_jax():
    """``freqs``, ``phases`` and ``transform`` are kept: JAX routes them to
    its constants (and does not read ``transform``, ROADMAP C16), the port
    loads them as persistent buffers."""
    w = np.random.RandomState(5).randn(2, 16).astype(np.float32)
    kwargs = dict(w_dim=16, channels=12, size=20, sampling_rate=8, bandwidth=2)
    jmod = JaxSynthesisInput(**kwargs)
    variables = jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(2), w))
    state = dict(variables_to_state_dict(variables), transform=np.eye(3, dtype=np.float32))
    state["affine.weight"] = np.random.RandomState(6).randn(4, 16).astype(np.float32)
    assert set(port.reference_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()})) == set(state)
    net = SynthesisInput(**kwargs)
    want = both_ways(state, net, lambda v: jmod.apply(v, w))
    np.testing.assert_allclose(net(torch.from_numpy(w)).detach().numpy(), want, **GEN_TOL)


def test_unknown_key_fails_and_port_checkpoint_passes_unchanged():
    """The load stays strict: a key the port does not know fails, named in
    the error. A port checkpoint passes through the converter unchanged."""
    net = Stylegan3Generator(**sg3.TINY, generator=torch.Generator().manual_seed(0))
    own = net.state_dict()
    converted = port.reference_state_dict(own)
    assert list(converted) == list(own)
    assert all(torch.equal(converted[k], own[k]) for k in own)
    bad = dict(own, **{"synthesis.L0_36_16.bogus_buffer": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="synthesis.L0_36_16.bogus_buffer"):
        net.load_state_dict(port.reference_state_dict(bad), strict=True)


def test_cli_converts_a_reference_pth_that_evaluate_serves(tmp_path):
    """``python -m afcm_tpu_torch.utils.port SRC DST`` on a reference-style
    ``.pth`` of the tiny config's G writes ``latest_net_G_ema.pth``, which
    ``python -m afcm_tpu_torch.evaluate --device cpu`` loads strictly and
    serves; the evaluate CLI refuses the raw file, naming a filter buffer;
    a pickled module is refused."""
    pytest.importorskip("h5py")
    from afcm_tpu.config import default_argument_parser
    from afcm_tpu.data.demo import write_demo_tree
    from afcm_tpu_torch.evaluate import main as evaluate_main

    write_demo_tree(str(tmp_path / "data"), n_train=0, n_val=0, n_test=1, depth=8, size=64)
    argv = ["--config-file", os.path.join(REPO, "configs/demo/cmsr_tiny.yml"),
            "--device", "cpu", "loaders.test.file_paths", f"['{tmp_path}/data/test']",
            "checkpoints_dir", str(tmp_path / "checkpoints"), "tpu.transfer_dtype", "uint8"]
    g_cfg = dict(default_argument_parser(
        [a for a in argv if a not in ("--device", "cpu")]).model.G)
    jgen = jmodels.build_generator(dict(g_cfg))
    rng = np.random.RandomState(3)
    z = rng.randn(1, g_cfg["z_dim"]).astype(np.float32)
    cond = rng.randn(1, 4, 64, 64).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jgen.init)(
        jax.random.PRNGKey(3), z, np.zeros((1, 1), np.float32), cond))
    state = reference_dict(build_eval_model(g_cfg).generator_ema, variables)
    run_dir = tmp_path / "checkpoints" / "demo_tiny"
    run_dir.mkdir(parents=True)
    src = tmp_path / "50_net_G_ema.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, src)

    (run_dir / "latest_net_G_ema.pth").symlink_to(src)
    with pytest.raises(RuntimeError, match="up_filter"):
        evaluate_main(list(argv))
    (run_dir / "latest_net_G_ema.pth").unlink()
    port.main([str(src), str(run_dir / "latest_net_G_ema.pth")])
    result = evaluate_main(list(argv))
    assert np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])

    pickled = tmp_path / "module.pth"
    torch.save(torch.nn.Linear(2, 2), pickled)
    with pytest.raises(SystemExit, match="pickled"):
        port.main([str(pickled), str(tmp_path / "out.pth")])
