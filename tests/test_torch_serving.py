"""The port's serving path end to end on CPU, against the JAX package's.

An in-memory phantom subject (no h5py; afcm_tpu_torch.data.demo) is
windowed by the port's dataset and TestLoader, served through
StandardPredictor.run_pipelined once with the port's forward (afcm_tpu_torch.evaluate.make_forward_fn) and once with a
JAX forward of the same weights and the same z, and the stitched volumes
are compared at the generator tolerance (fp32 rtol 5e-3 / atol 2e-4).
tests/test_pipeline_parity.py is the model.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu_torch.infer.predictor import StandardPredictor  # noqa: E402
from afcm_tpu.nn import Stylegan3Generator as JaxGenerator  # noqa: E402
from afcm_tpu_torch.data.demo import phantom_test_loader  # noqa: E402
from afcm_tpu_torch.evaluate import (DeviceResult, make_forward_fn,  # noqa: E402
                                     serve_and_score)
from afcm_tpu_torch.models import build_eval_model  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_variables  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
HALO = (0, 8, 8)
GEN = dict(z_dim=32, c_dim=1, w_dim=32, img_resolution=64,
           img_channels_in=4, img_channels_out=1,
           mapping_kwargs=dict(num_layers=2),
           synthesis_kwargs=dict(channel_base=1024, channel_max=16,
                                 num_layers=8, num_critical=2, margin_size=10,
                                 skip_resolution=32, lrelu_upsampling=2,
                                 conv_clamp=256))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.RandomState(0)
    cond = rng.randn(1, 4, 64, 64).astype(np.float32)
    jgen = JaxGenerator(**GEN)
    variables = jax.tree.map(np.asarray, jgen.init(
        jax.random.PRNGKey(0), np.zeros((1, 32), np.float32),
        np.zeros((1, 1), np.float32), cond))
    model = build_eval_model({"netG": "stylegan3", **GEN})
    load_jax_variables(model.generator_ema, variables)
    return jgen, variables, model


def _serve(forward_fn, transfer_dtype, out_dir):
    loader = phantom_test_loader(depth=12, size=64, batch_size=BATCH,
                                 transfer_dtype=transfer_dtype)
    predictor = StandardPredictor(forward_fn, str(out_dir), None,
                                  patch_halo=HALO)
    volumes = [predictor.last_prediction
               for _ in predictor.run_pipelined([loader], depth=2)]
    predictor.wait_for_writes()
    assert len(volumes) == 1
    return volumes[0], loader


def _jax_forward(jgen, variables, eval_z, seed=0):
    """The JAX generator fed the z the port draws: the same seeded
    torch.Generator, drawn once (fixed) or per batch."""
    rng = torch.Generator().manual_seed(seed)
    fixed = {}
    apply = jax.jit(lambda z, c, a: jgen.apply(variables, z, c, a))

    def forward(a_batch, slice_idx):
        n = a_batch.shape[0]
        if eval_z == "per-batch" or n not in fixed:
            fixed[n] = torch.randn((n, GEN["z_dim"]), generator=rng).numpy()
        return apply(jnp.asarray(fixed[n]), jnp.asarray(slice_idx),
                     jnp.asarray(a_batch))
    return forward


@pytest.mark.parametrize("eval_z", ["per-batch", "fixed"])
def test_stitched_volume_matches_jax(weights, tmp_path, eval_z):
    jgen, variables, model = weights
    got, loader = _serve(make_forward_fn(model, "cpu", seed=0, eval_z=eval_z),
                         "float32", tmp_path / "port")
    want, _ = _serve(_jax_forward(jgen, variables, eval_z), "float32",
                     tmp_path / "jax")
    assert len(loader) == 3                         # 12 slices, batch 4
    assert got.shape == want.shape == (12, 64, 64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=2e-4)
    assert os.path.exists(tmp_path / "port" / "phantom_predictions0.nii.gz")


def test_uint8_and_float_ingest_agree(weights, tmp_path):
    """uint8 windows normalized on the device give the float path's volume
    (the normalization may differ by 1 ULP)."""
    _, _, model = weights
    want, _ = _serve(make_forward_fn(model, "cpu", eval_z="fixed"), "float32",
                     tmp_path / "f32")
    got, loader = _serve(make_forward_fn(model, "cpu", norm_range=(0.0, 255.0),
                                         eval_z="fixed"),
                         "uint8", tmp_path / "u8")
    assert loader.norm_range == (0.0, 255.0)        # bytes were shipped
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_serve_and_score_phantom(weights, tmp_path):
    """The evaluate CLI's serve-and-score loop on the phantom (the path
    chip_smoke.py drives on the card): one scored subject, its volume
    written, evaluate.txt appended."""
    _, _, model = weights
    loader = phantom_test_loader(depth=12, size=64, batch_size=BATCH)
    forward = make_forward_fn(model, "cpu", norm_range=loader.norm_range)
    scores = serve_and_score(forward, [loader], str(tmp_path), "t1_hr4sr",
                             patch_halo=HALO)
    (subject,) = scores["subjects"].values()
    assert subject["shape"] == (12, 64, 64) and subject["finite"]
    assert np.isfinite([scores[k] for k in ("psnr", "ssim", "psnr_slice",
                                            "ssim_slice")]).all()
    assert scores["psnr"] == subject["psnr"]
    text = (tmp_path / "evaluate.txt").read_text()
    assert "subject:phantom" in text and "^^^VALIDATION" in text
    assert (tmp_path / "phantom_predictions0.nii.gz").exists()
    assert (tmp_path / "phantom_ori.nii.gz").exists()


def test_device_result_duck_types():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = DeviceResult(t)
    out.copy_to_host_async()
    np.testing.assert_array_equal(np.asarray(out)[:1], [[0, 1, 2]])
    assert np.asarray(out, dtype=np.float64).dtype == np.float64


def test_port_imports_without_jax():
    """Every afcm_tpu_torch module, and the port's rehearsal and workspace
    scripts, import with jax, flax, optax, the JAX package afcm_tpu and PIL
    blocked (the image-folder datasets read their images with PIL, imported
    where they read one)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "blocked = ('jax', 'flax', 'optax', 'afcm_tpu', 'PIL')\n"
        "for name in blocked:\n"
        "    sys.modules[name] = None\n"
        "import afcm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    afcm_tpu_torch.__path__, 'afcm_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('evaluate', 'train', 'nn.discriminator', 'models.losses',\n"
        "             'models.train_state', 'models.schedulers',\n"
        "             'ops.conv2d_gradfix', 'utils.checkpoint', 'data.demo',\n"
        "             'ops.cuda.conv_int8', 'config.defaults', 'data.loader',\n"
        "             'infer.predictor', 'native.ops', 'utils.metrics',\n"
        "             'utils.profiling', 'serve', 'ops.cuda.probe_stream',\n"
        "             'ops.cuda.probe_int8', 'probes.fir_roofline',\n"
        "             'probes.stream_diag', 'probes.element_windows',\n"
        "             'probes.int8_matmul', 'probes.int8_kernel',\n"
        "             'infer.export', 'nn.comodgan', 'nn.ca_variants',\n"
        "             'nn.pix2pix', 'nn.motion', 'ops.grid_sample',\n"
        "             'models.pix2pix_model', 'models.template_model',\n"
        "             'data.image_datasets', 'data.template_dataset',\n"
        "             'utils.image', 'utils.easydict', 'utils.misc',\n"
        "             'utils.training_stats', 'config.compat', 'data.prepare_h5'):\n"
        "    assert 'afcm_tpu_torch.' + name in names, names\n"
        "import importlib.util\n"
        "for script in ('torch_dress_rehearsal', 'torch_conv_workspace', 'torch_ste_mutation'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        script, 'scripts/' + script + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(m.split('.')[0] in blocked\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 55


def test_evaluate_cli_writes_scores(tmp_path):
    """python -m afcm_tpu_torch.evaluate on the tiny demo config: loads
    <tag>_net_G_ema.pth strictly, serves the h5 test subject and writes
    evaluate.txt, with the float32 and with the bfloat16 fetch."""
    pytest.importorskip("h5py")
    from afcm_tpu.config import default_argument_parser
    from afcm_tpu.data.demo import write_demo_tree
    from afcm_tpu_torch.evaluate import main as evaluate_main

    write_demo_tree(str(tmp_path / "data"), n_train=0, n_val=0, n_test=1,
                    depth=8, size=64)
    argv = ["--config-file", os.path.join(REPO, "configs/demo/cmsr_tiny.yml"),
            "--device", "cpu",
            "loaders.test.file_paths", f"['{tmp_path}/data/test']",
            "checkpoints_dir", str(tmp_path / "checkpoints")]
    cfg = default_argument_parser([a for a in argv if a not in ("--device", "cpu")])
    model = build_eval_model(dict(cfg.model.G),
                             generator=torch.Generator().manual_seed(0))
    run_dir = tmp_path / "checkpoints" / "demo_tiny"
    run_dir.mkdir(parents=True)
    torch.save(model.generator_ema.state_dict(), run_dir / "latest_net_G_ema.pth")

    result = evaluate_main(argv + ["tpu.transfer_dtype", "uint8"])
    assert np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])
    text = (run_dir / "evaluate" / "evaluate.txt").read_text()
    assert "subject:subject_test_0" in text and "^^^VALIDATION" in text
    assert (run_dir / "evaluate" / "subject_test_0_predictions0.nii.gz").exists()
    # tpu.fetch_dtype bfloat16: the CLI runs and scores with the half-width
    # fetch; rounding the prediction to bf16 moves the scores only slightly
    half = evaluate_main(argv + ["tpu.transfer_dtype", "uint8",
                                 "tpu.fetch_dtype", "bfloat16"])
    assert np.isfinite(half["psnr"]) and np.isfinite(half["ssim"])
    assert abs(half["psnr"] - result["psnr"]) < 0.05
    assert abs(half["ssim"] - result["ssim"]) < 1e-3


def _tiny_cfg(*opts):
    from afcm_tpu_torch.config import default_argument_parser
    return default_argument_parser(["--config-file", os.path.join(
        REPO, "configs/demo/cmsr_tiny.yml"), *opts])


@pytest.mark.parametrize("argv", [["--num-gpus", "2"], ["tpu.mesh_shape", "[2, 2]"]])
def test_serving_refuses_a_mesh_of_more_than_one_device_naming_a12b(argv, tmp_path):
    """Since data-parallel serving was ported (ROADMAP item A12b) a mesh of
    several devices on its data axis is taken: ``--num-gpus 2`` serves from
    two replicas (two CPU devices with ``--device cpu``). Since tensor
    parallelism was ported (item A12c) a model axis is taken too: both
    serving CLIs serve ``[2, 2]`` over four gloo ranks, and the evaluate
    CLI's scores and the serve CLI's volume are one process's (rtol 2e-4,
    atol 2e-5, tests/test_parallel.py:242). Since the CoModGAN family's
    layers were made tensor-parallel (item A12d) ``configure_numerics``
    takes a model axis under the CoModGAN generator too. The default mesh
    ``[0, 1]`` is accepted."""
    from afcm_tpu_torch import serve
    from afcm_tpu_torch.evaluate import configure_numerics, prepare_mesh_state
    from afcm_tpu_torch.evaluate import main as evaluate_main
    from afcm_tpu_torch.utils.nifti import read_nifti
    cfg = _tiny_cfg(*argv)
    if cfg.tpu.mesh_shape[1] > 1:
        pytest.importorskip("h5py")
        from afcm_tpu_torch.data.demo import write_demo_tree
        assert configure_numerics(cfg) == "float32"
        assert configure_numerics(_tiny_cfg("tpu.mesh_shape", "[1, 2]", "model.name",
                                            "comodgan", "model.G.netG", "comodgan")) == "float32"
        write_demo_tree(str(tmp_path / "data"), n_train=0, n_val=0, n_test=1,
                        depth=8, size=64)
        base = ["--config-file", os.path.join(REPO, "configs/demo/cmsr_tiny.yml"),
                "--device", "cpu", "loaders.test.file_paths", f"['{tmp_path}/data/test']",
                "checkpoints_dir", str(tmp_path / "checkpoints"), "loaders.batch_size", "4"]
        run_dir = tmp_path / "checkpoints" / "demo_tiny"
        run_dir.mkdir(parents=True)
        torch.save(build_eval_model(dict(cfg.model.G), generator=torch.Generator().manual_seed(0))
                   .generator_ema.state_dict(), run_dir / "latest_net_G_ema.pth")
        one, mesh = (evaluate_main(base + extra) for extra in ([], argv))
        for key in ("psnr", "ssim", "psnr_slice", "ssim_slice"):
            assert mesh[key] == pytest.approx(one[key], rel=2e-4, abs=2e-5), key
        volumes = [np.asarray(read_nifti(serve.main(base + extra + ["--out", str(
            tmp_path / name)]) + "/subject_test_0_predictions0.nii.gz")[0])
                   for name, extra in (("one", []), ("mesh", argv))]
        np.testing.assert_allclose(volumes[1], volumes[0], rtol=2e-4, atol=2e-5)
    else:
        assert configure_numerics(cfg) == "float32"
        model = build_eval_model(dict(cfg.model.G))
        mesh = prepare_mesh_state(cfg, model, torch.device("cpu"))
        assert mesh.shape == {"data": 2, "model": 1}
    assert configure_numerics(_tiny_cfg()) == "float32"
    assert prepare_mesh_state(_tiny_cfg(), build_eval_model(dict(cfg.model.G)),
                              torch.device("cpu")) is None


def test_serving_default_mesh_is_one_card_while_training_takes_every_card(monkeypatch):
    """On a node of four cards the default mesh ``[0, 1]`` trains over all
    four (``parallel.resolve_mesh``) but serves on one
    (``evaluate.serving_mesh``); a data axis the config sets serves over
    that many cards, clamped to a divisor of the batch."""
    from afcm_tpu_torch import parallel
    from afcm_tpu_torch.evaluate import serving_mesh
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(parallel.mesh, "visible_devices", lambda: cards)
    cuda = torch.device("cuda")
    assert parallel.resolve_mesh((0, 1), 16, cuda).data_devices == cards
    assert serving_mesh((0, 1), 16, cuda) is None
    assert serving_mesh((4, 1), 16, cuda).data_devices == cards
    assert serving_mesh((3, 1), 16, cuda).data_devices == cards[:2]
    assert serving_mesh((1, 1), 16, cuda) is None


def test_serving_ignores_remat_and_says_matmul_precision_has_no_effect(capsys):
    """Serving ignores ``tpu.remat`` in both packages, so it does not raise
    here; a non-default ``tpu.matmul_precision`` gets its one line, and TF32
    follows ``tpu.compute_dtype`` alone."""
    from afcm_tpu_torch.evaluate import configure_numerics
    capsys.readouterr()
    assert configure_numerics(_tiny_cfg("tpu.remat", "True")) == "float32"
    assert "tpu.matmul_precision" not in capsys.readouterr().out
    assert configure_numerics(_tiny_cfg("tpu.matmul_precision", "high",
                                        "tpu.compute_dtype", "bfloat16")) == "bfloat16"
    said = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("tpu.matmul_precision")]
    assert len(said) == 1 and "tpu.compute_dtype alone" in said[0]
    assert torch.backends.cudnn.allow_tf32 is True       # bfloat16: TF32 on
    configure_numerics(_tiny_cfg("tpu.matmul_precision", "highest"))
    assert torch.backends.cudnn.allow_tf32 is False      # float32: off, whatever the key


def test_serving_checks_filtered_lrelu_impl_as_afcm_tpu_does(capsys):
    """ROADMAP C17: ``afcm_tpu``'s serving setup (``configure_ops`` ->
    ``set_default_impl``) asserts that ``tpu.filtered_lrelu_impl`` is
    ``xla``, ``pallas`` or ``auto``; the port's ``configure_numerics``
    raises ``ValueError`` for the same value, naming it and the three.
    ``pallas`` and ``auto`` each get one line (a CUDA tensor always takes
    K1), ``xla`` none."""
    from afcm_tpu.config import default_argument_parser as jax_parser
    from afcm_tpu.evaluate import configure_ops
    from afcm_tpu.ops.filtered_lrelu import get_default_impl
    from afcm_tpu_torch.evaluate import configure_numerics
    before = get_default_impl()
    with pytest.raises(AssertionError):
        configure_ops(jax_parser(["--config-file", os.path.join(
            REPO, "configs/demo/cmsr_tiny.yml"), "tpu.filtered_lrelu_impl", "bogus"]))
    assert get_default_impl() == before
    with pytest.raises(ValueError, match="'bogus'.*xla, pallas, auto"):
        configure_numerics(_tiny_cfg("tpu.filtered_lrelu_impl", "bogus"))
    capsys.readouterr()
    for impl, lines in (("pallas", 1), ("auto", 1), ("xla", 0)):
        configure_numerics(_tiny_cfg("tpu.filtered_lrelu_impl", impl))
        said = [line for line in capsys.readouterr().out.splitlines()
                if line.startswith("tpu.filtered_lrelu_impl")]
        assert len(said) == lines, (impl, said)
        assert all(f"filtered_lrelu_impl {impl} has no effect" in line for line in said)
