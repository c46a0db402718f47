"""The port's serving export (afcm_tpu_torch.infer.export) and the custom
operators it keeps K1 and K2 behind, on the CPU.

The counterparts of tests/test_export.py: the tiny CMSR config's generator,
initialized in JAX and carried across with ``load_jax_variables``, is
exported with ``torch.export``, saved, loaded and served. On the CPU the
operators compute their plain versions. Tolerances: the artifact against
the live eval step at atol 2e-6 (observed 0: the graph runs the same ops);
bf16 weights at > 40 dB and the bf16 fetch at 1e-2 (a bf16 step at the
output's range); the operators' gradients through the tiny generator at
1e-6 relative per tensor, in the 2-norm (the backward is the transposed FIR
passes, against autograd of the convs: float32 rounding in another order).
"""

import glob
import importlib
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu_torch.config import default_argument_parser  # noqa: E402
from afcm_tpu_torch.evaluate import detect_norm_range, pipeline_norm_range  # noqa: E402
from afcm_tpu_torch.infer import StandardPredictor  # noqa: E402
from afcm_tpu_torch.infer import export as ex  # noqa: E402
from afcm_tpu_torch.models import build_eval_model, build_generator  # noqa: E402
from afcm_tpu_torch.ops import get_conv_impl, set_conv_impl  # noqa: E402
from afcm_tpu_torch.ops.cuda import filtered_lrelu as k1  # noqa: E402
from afcm_tpu_torch.ops.filter_design import design_lowpass_filter  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_variables  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/demo/cmsr_tiny.yml")
SHAPE = (4, 64, 64)
KERNEL_LAYERS = 8        # the tiny config's 4 encoder and 4 synthesis layers but toRGB


def _cfg(*opts):
    return default_argument_parser(["--config-file", CONFIG, *opts])


@pytest.fixture(scope="module")
def tiny():
    """The tiny CMSR generator, initialized by afcm_tpu and carried across."""
    from afcm_tpu.config import setup
    from afcm_tpu.models import build_gan_model

    class Args:
        config_file, model, opts = CONFIG, None, []
    jcfg = setup(Args())
    jmodel = build_gan_model(jcfg)
    dummy = {"A": jnp.zeros((1, *SHAPE)), "B": jnp.zeros((1, 1, 64, 64)),
             "slice_idx": jnp.zeros((1, 1))}
    state = jax.tree.map(np.asarray, jmodel.init_state(jax.random.PRNGKey(0), dummy))
    cfg = _cfg()
    model = build_eval_model(dict(cfg.model.G))
    load_jax_variables(model.generator_ema, {"params": state.params_G_ema,
                                             "moments": state.moments_G_ema,
                                             "constants": state.constants_G})
    return cfg, model


def _batch(rng, n):
    a = rng.randn(n, *SHAPE).clip(-1, 1).astype(np.float32)
    return a, rng.rand(n, 1).astype(np.float32)


def test_export_roundtrip_matches_eval_step(tiny, tmp_path, rng):
    """The loaded artifact equals the live eval step for the same z stream
    (one torch.Generator seeded 7, a fresh z per batch)."""
    _, model = tiny
    exported = ex.export_eval(model, 2, SHAPE)
    path = ex.save_exported(exported, str(tmp_path / "serving.pt2"))
    assert os.path.getsize(path) > 0
    forward = ex.serving_forward(path, seed=7)
    a, s = _batch(rng, 2)
    got0, got1 = (np.asarray(forward(a, s)) for _ in range(2))

    z_rng = torch.Generator().manual_seed(7)
    for got in (got0, got1):
        z = torch.randn((2, model.z_dim), generator=z_rng)
        want = model.eval_step(torch.from_numpy(a), torch.from_numpy(s), z=z).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert np.abs(got0 - got1).max() > 0          # fresh z per batch


def test_export_uint8_ingest_and_fetch_dtype(tiny, rng):
    """uint8 ingest normalizes in the graph; the bf16 fetch rounds there."""
    _, model = tiny
    forward = ex.serving_forward(ex.export_eval(
        model, 2, SHAPE, norm_range=(0.0, 255.0), fetch_dtype="bfloat16"), seed=7)
    a_u8 = rng.randint(0, 256, (2, *SHAPE)).astype(np.uint8)
    s = rng.rand(2, 1).astype(np.float32)
    got = forward(a_u8, s)
    assert got.tensor.dtype == torch.bfloat16

    a_f = np.clip(2 * (a_u8.astype(np.float32) / 255.0) - 1, -1, 1)
    z = torch.randn((2, model.z_dim), generator=torch.Generator().manual_seed(7))
    want = model.eval_step(torch.from_numpy(a_f), torch.from_numpy(s), z=z)
    np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=0, atol=1e-2)
    with pytest.raises(TypeError, match="ingest"):
        forward(a_f, s)


def test_serving_forward_drives_predictor(tiny, tmp_path):
    """The artifact plugs into StandardPredictor as its forward."""
    pytest.importorskip("h5py")
    from afcm_tpu_torch.data import get_test_loaders
    from afcm_tpu_torch.data.demo import write_demo_tree
    _, model = tiny
    root = str(tmp_path / "demo")
    write_demo_tree(root, n_train=0, n_val=0, n_test=1, depth=8, size=64)
    cfg = _cfg("loaders.test.file_paths", f"['{root}/test']")
    exported = ex.export_eval(model, int(cfg.loaders.batch_size), SHAPE)
    predictor = StandardPredictor(ex.serving_forward(exported), str(tmp_path / "out"), cfg)
    out_path = predictor(next(iter(get_test_loaders(cfg))))
    predictor.wait_for_writes()
    assert os.path.exists(out_path)
    vol = predictor.last_prediction
    assert vol.shape == (8, 64, 64) and np.isfinite(vol).all()


def test_export_symbolic_batch(tiny, rng):
    """batch_size=None exports one artifact that serves any batch size."""
    _, model = tiny
    forward = ex.serving_forward(ex.export_eval(model, None, SHAPE))
    for n in (1, 3):
        out = np.asarray(forward(*_batch(rng, n)))
        assert out.shape == (n, 1, 64, 64) and np.isfinite(out).all()


def test_export_bf16_weights_halves_artifact(tiny, tmp_path, rng):
    """weights_dtype='bfloat16' stores the weights in bf16: the file shrinks
    below 0.65x, and the output stays > 40 dB from the float artifact's."""
    _, model = tiny
    full = ex.save_exported(ex.export_eval(model, 2, SHAPE), str(tmp_path / "f.pt2"))
    half = ex.save_exported(ex.export_eval(model, 2, SHAPE, weights_dtype="bfloat16"),
                            str(tmp_path / "h.pt2"))
    nf, nh = os.path.getsize(full), os.path.getsize(half)
    assert nh < 0.65 * nf, (nf, nh)
    a, s = _batch(rng, 2)
    want = np.asarray(ex.serving_forward(full)(a, s))
    got = np.asarray(ex.serving_forward(half)(a, s))
    mse = float(np.mean((got - want) ** 2))
    psnr = 10 * np.log10(4.0 / max(mse, 1e-20))   # data range 2
    assert psnr > 40, f"bf16-weights drift too large: {psnr:.1f} dB"


@pytest.mark.parametrize("impl", ["int8", "int8_all"])
def test_export_pins_conv_impl(tiny, rng, impl):
    """The artifact is the float model whatever the process routes, and the
    process's setting comes back after the export. (Mode 'int8' routes no
    conv of the tiny model; 'int8_all' with a floor of 16 routes them.)"""
    _, model = tiny
    a, s = _batch(rng, 2)
    z = torch.randn((2, model.z_dim), generator=torch.Generator().manual_seed(1))
    float_out = model.eval_step(torch.from_numpy(a), torch.from_numpy(s), z=z)
    set_conv_impl(impl, min_ch=16)
    try:
        int8_out = model.eval_step(torch.from_numpy(a), torch.from_numpy(s), z=z)
        assert torch.equal(int8_out, float_out) == (impl == "int8")
        exported = ex.export_eval(model, 2, SHAPE)
        assert get_conv_impl() == impl
        got = exported.module()(torch.from_numpy(a), torch.from_numpy(s), z)
    finally:
        set_conv_impl("xla", min_ch=64)
    torch.testing.assert_close(got, float_out, rtol=0, atol=2e-6)


def test_export_mesh_raises(tiny, rng):
    """Since tensor parallelism was ported (ROADMAP item A12c) exporting over
    a mesh with a model axis runs, as ``afcm_tpu/infer/export.py:117-121``
    does: the artifact is split by batch over the data axis, with whole
    weights, so a (2, 2) mesh's artifact records two devices and serves
    over them what the (2, 1) mesh's does; an artifact exported over a
    two-device data axis records that count and refuses to serve over
    another (``afcm_tpu/serve.py:43-51``)."""
    from afcm_tpu_torch.parallel import make_mesh
    _, model = tiny
    cpus = ["cpu"] * 4
    exported = ex.export_eval(model, 2, SHAPE, mesh=make_mesh((2, 1), cpus))
    over_model = ex.export_eval(model, 2, SHAPE, mesh=make_mesh((2, 2), cpus))
    assert ex.mesh_devices(over_model) == 2
    a = rng.randn(2, *SHAPE).clip(-1, 1).astype(np.float32)
    s = rng.rand(2, 1).astype(np.float32)
    got, want = (np.asarray(ex.serving_forward(e, mesh=make_mesh((2, 1), cpus))(a, s))
                 for e in (over_model, exported))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert ex.mesh_devices(exported) == 2
    for mesh in (None, make_mesh((4, 1), cpus)):
        with pytest.raises(ValueError, match="exported over 2 device"):
            ex.serving_forward(exported, mesh=mesh)
    assert ex.mesh_devices(ex.export_eval(model, 2, SHAPE)) == 1


def _tiny_run(tmp_path):
    """A demo tree with one test subject and the tiny generator's checkpoint."""
    from afcm_tpu_torch.data.demo import write_demo_tree
    write_demo_tree(str(tmp_path / "data"), n_train=0, n_val=0, n_test=1,
                    depth=8, size=64)
    argv = ["--config-file", CONFIG,
            "loaders.test.file_paths", f"['{tmp_path}/data/test']",
            "checkpoints_dir", str(tmp_path / "checkpoints")]
    model = build_eval_model(dict(_cfg().model.G),
                             generator=torch.Generator().manual_seed(0))
    run_dir = tmp_path / "checkpoints" / "demo_tiny"
    run_dir.mkdir(parents=True)
    torch.save(model.generator_ema.state_dict(), run_dir / "latest_net_G_ema.pth")
    return argv, run_dir


def test_serve_cli_artifact_matches_in_process(tmp_path, capsys):
    """The export CLI writes <run_dir>/serving.pt2 from the checkpoint; the
    serve CLI's volume from it equals its in-process volume."""
    pytest.importorskip("h5py")
    from afcm_tpu_torch import serve
    from afcm_tpu_torch.utils.nifti import read_nifti
    argv, run_dir = _tiny_run(tmp_path)
    art = ex.main(["--device", "cpu"] + argv)
    assert art == str(run_dir / "serving.pt2") and os.path.exists(art)
    assert f"{KERNEL_LAYERS} filtered_lrelu nodes" in capsys.readouterr().out
    out1 = serve.main(["--device", "cpu", "--out", str(tmp_path / "out1")] + argv)
    (run_dir / "latest_net_G_ema.pth").unlink()       # the artifact needs no checkpoint
    out2 = serve.main(["--device", "cpu", "--artifact", art,
                       "--out", str(tmp_path / "out2")] + argv)
    (f1,), (f2,) = (sorted(glob.glob(d + "/*_predictions0.nii.gz")) for d in (out1, out2))
    v1, v2 = read_nifti(f1)[0], read_nifti(f2)[0]
    assert v1.shape == (8, 64, 64)
    assert np.abs(v1 - v2).max() < 5e-6


def test_export_cli_symbolic_bf16_weights(tmp_path):
    pytest.importorskip("h5py")
    argv, run_dir = _tiny_run(tmp_path)
    art = ex.main(["--device", "cpu", "--symbolic-batch", "--weights-dtype", "bfloat16",
                   "--output", str(tmp_path / "s.pt2")] + argv)
    exported, device = ex.load_exported(art)
    assert device == "cpu" and ex.count_nodes(exported) == KERNEL_LAYERS
    assert {t.dtype for t in exported.state_dict.values()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="exported on cpu"):
        ex.serving_forward(exported, device="meta")


def test_detect_norm_range_strict_on_mixed_storage(tmp_path):
    """The ingest decision reads the stored dtypes from the h5 metadata:
    all uint8 -> uint8 ingest; any float-stored volume -> float ingest."""
    h5py = pytest.importorskip("h5py")
    from afcm_tpu_torch.data.demo import write_demo_tree
    root = str(tmp_path / "demo")
    write_demo_tree(root, n_train=0, n_val=0, n_test=2, depth=8, size=64)
    cfg = _cfg("loaders.test.file_paths", f"['{root}/test']", "tpu.transfer_dtype", "uint8")
    assert pipeline_norm_range(cfg) == (0.0, 255.0)
    assert detect_norm_range(cfg) == (0.0, 255.0)     # demo volumes are uint8
    victim = sorted(glob.glob(os.path.join(root, "test", "*.h5")))[1]
    with h5py.File(victim, "r+") as f:
        for k in list(f.keys()):
            data = f[k][()].astype(np.float32)
            del f[k]
            f[k] = data
    assert detect_norm_range(cfg) is None
    assert pipeline_norm_range(cfg) == (0.0, 255.0)   # the in-process decision
    assert detect_norm_range(_cfg()) is None          # float32 transfer


# -- the custom operators ----------------------------------------------------

GEOMETRIES = {
    "u2d2": dict(size=10, up=2, down=2, ntu=12, ntd=12, pad=(9, 8, 9, 8)),
    "u4d2": dict(size=20, up=4, down=2, ntu=24, ntd=12, pad=(-6, -9, -6, -9)),
}


def _op_args(geometry, with_bias_clamp, seed=0):
    g = GEOMETRIES[geometry]
    rng = np.random.RandomState(seed)
    fs = g["size"] * g["up"]
    fu = design_lowpass_filter(g["ntu"], cutoff=fs / 8, width=fs / 8, fs=fs)
    fd = design_lowpass_filter(g["ntd"], cutoff=fs / 8, width=fs / 8, fs=fs)
    x = torch.from_numpy(rng.randn(2, 3, g["size"], g["size"]).astype(np.float32))
    b = torch.from_numpy(rng.randn(3).astype(np.float32)) if with_bias_clamp else None
    taps_u, taps_d, *pad = k1.op_arguments(fu, fd, g["pad"], False)
    return (x, b, taps_u, taps_d, g["up"], g["down"], *pad, float(np.sqrt(2)), 0.2,
            0.5 if with_bias_clamp else None), (fu, fd, g)


@pytest.mark.parametrize("with_bias_clamp", [True, False], ids=["bias_clamp", "plain"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_operators_pass_opcheck(geometry, with_bias_clamp):
    """Schema, fake (shape) and autograd registrations of both operators,
    and their trace by AOTAutograd with dynamic shapes."""
    args, (fu, fd, g) = _op_args(geometry, with_bias_clamp)
    x = args[0].clone().requires_grad_(True)
    b = None if args[1] is None else args[1].clone().requires_grad_(True)
    torch.library.opcheck(k1.filtered_lrelu_op, (x, b) + args[2:])
    y = k1.filtered_lrelu_op(*args)
    want = k1.filtered_lrelu_plain(args[0], fu, fd, args[1], g["up"], g["down"],
                                   g["pad"], np.sqrt(2), 0.2, args[-1])
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    # first order only: the backward operator has no derivative of its own
    torch.library.opcheck(k1.filtered_lrelu_bwd_op, (args[0], args[1], dy) + args[2:])


def test_generator_gradients_through_the_operators(monkeypatch):
    """Gradients of the tiny alias-free generator through the operators
    (their registered backward) equal autograd of the plain composition."""
    gen_cfg = dict(_cfg().model.G)
    net = build_generator(gen_cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    z = torch.from_numpy(rng.randn(2, 64).astype(np.float32))
    c = torch.from_numpy(rng.rand(2, 1).astype(np.float32))
    cond = torch.from_numpy(rng.randn(2, *SHAPE).clip(-1, 1).astype(np.float32))
    weight = torch.from_numpy(rng.randn(2, 1, 64, 64).astype(np.float32))

    def grads():
        net.zero_grad(set_to_none=True)
        (net(z, c, cond) * weight).sum().backward()
        return {k: p.grad.clone() for k, p in net.named_parameters()}

    got = grads()
    # the module, not the function that afcm_tpu_torch.ops re-exports
    dispatch = importlib.import_module("afcm_tpu_torch.ops.filtered_lrelu")
    with monkeypatch.context() as mp:   # the plain composition, by autograd
        mp.setattr(dispatch, "filtered_lrelu_call", k1.filtered_lrelu_plain)
        want = grads()
    assert got.keys() == want.keys()
    for k in got:
        rel = float(torch.linalg.vector_norm(got[k] - want[k])
                    / torch.linalg.vector_norm(want[k]))
        assert rel <= 1e-6, (k, rel)


def test_exported_graph_holds_the_operator(tiny):
    """Each filtered_lrelu call of the tiny generator is one operator node;
    toRGB (elementwise) stays plain."""
    _, model = tiny
    exported = ex.export_eval(model, 2, SHAPE)
    assert ex.count_nodes(exported) == KERNEL_LAYERS
    assert ex.count_nodes(exported, "filtered_lrelu_bwd") == 0
