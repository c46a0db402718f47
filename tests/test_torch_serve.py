"""The port's serve entry point and profiling helpers on the CPU.

The serve loop (afcm_tpu_torch.serve.serve_subjects) runs the in-memory
phantom through the tiny generator and is held against a JAX forward of the
same weights and the same z, driven as tests/test_torch_serving.py drives it
(stitched volume at the generator tolerance, fp32 rtol 5e-3 / atol 2e-4).
``tpu.fetch_dtype bfloat16`` must give the float32 volume rounded to bf16
(full-slice patches are stitched without arithmetic, so this is exact).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu.nn import Stylegan3Generator as JaxGenerator  # noqa: E402
from afcm_tpu_torch import serve  # noqa: E402
from afcm_tpu_torch.config import default_argument_parser  # noqa: E402
from afcm_tpu_torch.data.demo import phantom_test_loader  # noqa: E402
from afcm_tpu_torch.evaluate import (fetch_dtype_or_none,  # noqa: E402
                                     make_forward_fn)
from afcm_tpu_torch.infer.predictor import StandardPredictor  # noqa: E402
from afcm_tpu_torch.models import build_eval_model  # noqa: E402
from afcm_tpu_torch.utils import profiling  # noqa: E402
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


def _loader():
    return phantom_test_loader(depth=12, size=64, batch_size=BATCH,
                               transfer_dtype="float32")


def _served(model, out_dir, **forward_kw):
    forward = make_forward_fn(model, "cpu", seed=0, **forward_kw)
    result = serve.serve_subjects(forward, [_loader()], str(out_dir), None,
                                  patch_halo=HALO, keep_volumes=True)
    (volume,) = result["volumes"].values()
    return volume, result


def test_served_volume_matches_jax(weights, tmp_path, capsys):
    jgen, variables, model = weights
    got, result = _served(model, tmp_path / "port")
    out = capsys.readouterr().out
    assert "subject:phantom  12 patches" in out and "patches/s e2e" in out
    assert (result["subjects"], result["patches"]) == (1, 12)
    assert result["patches_per_s"] > 0
    assert os.path.exists(tmp_path / "port" / "phantom_predictions0.nii.gz")

    # the JAX generator fed the z the port draws (one seeded torch.Generator,
    # a fresh z per batch), through the same predictor
    rng = torch.Generator().manual_seed(0)
    apply = jax.jit(lambda z, c, a: jgen.apply(variables, z, c, a))

    def jax_forward(a_batch, slice_idx):
        z = torch.randn((a_batch.shape[0], GEN["z_dim"]), generator=rng).numpy()
        return apply(jnp.asarray(z), jnp.asarray(slice_idx), jnp.asarray(a_batch))

    predictor = StandardPredictor(jax_forward, str(tmp_path / "jax"), None,
                                  patch_halo=HALO)
    (want,) = [predictor.last_prediction
               for _ in predictor.run_pipelined([_loader()], depth=2)]
    predictor.wait_for_writes()
    assert got.shape == want.shape == (12, 64, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=2e-4)


def test_fetch_dtype_bfloat16_rounds_on_the_device(weights, tmp_path):
    _, _, model = weights
    full, _ = _served(model, tmp_path / "f32", eval_z="fixed")
    half, _ = _served(model, tmp_path / "bf16", eval_z="fixed", fetch_dtype="bfloat16")
    want = torch.from_numpy(np.ascontiguousarray(full)).to(torch.bfloat16).float().numpy()
    assert half.dtype == np.float32 and not np.array_equal(half, full)
    np.testing.assert_array_equal(half, want)


def test_fetch_dtype_values():
    assert fetch_dtype_or_none(None) is None and fetch_dtype_or_none("float32") is None
    assert fetch_dtype_or_none("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError, match="fetch_dtype"):
        fetch_dtype_or_none("float16")


def _tiny_run(tmp_path):
    """A demo tree with one test subject and a checkpoint of the tiny config."""
    from afcm_tpu_torch.data.demo import write_demo_tree
    write_demo_tree(str(tmp_path / "data"), n_train=0, n_val=0, n_test=1,
                    depth=8, size=64)
    argv = ["--config-file", os.path.join(REPO, "configs/demo/cmsr_tiny.yml"),
            "loaders.test.file_paths", f"['{tmp_path}/data/test']",
            "checkpoints_dir", str(tmp_path / "checkpoints")]
    cfg = default_argument_parser(list(argv))
    model = build_eval_model(dict(cfg.model.G),
                             generator=torch.Generator().manual_seed(0))
    run_dir = tmp_path / "checkpoints" / "demo_tiny"
    run_dir.mkdir(parents=True)
    torch.save(model.generator_ema.state_dict(), run_dir / "latest_net_G_ema.pth")
    return argv, run_dir


def test_serve_cli_writes_the_volumes(tmp_path, capsys):
    pytest.importorskip("h5py")
    argv, run_dir = _tiny_run(tmp_path)
    out_dir = serve.main(["--device", "cpu"] + argv + ["tpu.fetch_dtype", "bfloat16"])
    assert out_dir == str(run_dir / "serve")
    assert (run_dir / "serve" / "subject_test_0_predictions0.nii.gz").exists()
    assert not (run_dir / "serve" / "evaluate.txt").exists()      # no scoring
    assert "served 1 subjects / 8 patches" in capsys.readouterr().out
    other = serve.main(["--device", "cpu", "--out", str(tmp_path / "elsewhere")] + argv)
    assert other == str(tmp_path / "elsewhere")
    assert (tmp_path / "elsewhere" / "subject_test_0_predictions0.nii.gz").exists()


def test_serve_cli_refuses_an_artifact(tmp_path, capsys):
    """--artifact serves from an exported artifact, with no checkpoint read;
    it refuses one whose ingest dtype the loader does not ship (uint8
    ingest, float32 batches), and one served on another device type."""
    pytest.importorskip("h5py")
    from afcm_tpu_torch.infer import export
    argv, run_dir = _tiny_run(tmp_path)
    model = build_eval_model(dict(default_argument_parser(argv).model.G),
                             generator=torch.Generator().manual_seed(0))
    good = export.save_exported(export.export_eval(model, 2, (4, 64, 64)),
                                str(tmp_path / "serving.pt2"))
    (run_dir / "latest_net_G_ema.pth").unlink()
    out_dir = serve.main(["--device", "cpu", "--artifact", good] + argv)
    assert (run_dir / "serve" / "subject_test_0_predictions0.nii.gz").exists()
    assert out_dir == str(run_dir / "serve")
    assert "served 1 subjects / 8 patches" in capsys.readouterr().out
    uint8 = export.save_exported(export.export_eval(model, 2, (4, 64, 64),
                                                    norm_range=(0.0, 255.0)),
                                 str(tmp_path / "uint8.pt2"))
    with pytest.raises(TypeError, match="ingest"):
        serve.main(["--device", "cpu", "--artifact", uint8] + argv)
    with pytest.raises(ValueError, match="exported on cpu"):
        export.serving_forward(good, device="meta")


def test_serve_cli_refuses_pix2pix(tmp_path):
    """The same deliberate scope error the JAX CLI gives
    (tests/test_export.py: test_serve_rejects_pix2pix)."""
    with pytest.raises(NotImplementedError, match="volumetric"):
        serve.main(["--device", "cpu", "--config-file",
                    os.path.join(REPO, "configs/demo/pix2pix_tiny.yml"),
                    "--model", "pix2pix", "checkpoints_dir", str(tmp_path)])


def test_serve_cli_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--config-file", os.path.join(REPO, "configs/demo/cmsr_tiny.yml"),
                    "checkpoints_dir", str(tmp_path)])


def test_step_timer_and_host_sync():
    profiling.host_sync({"loss": torch.zeros(2)})
    profiling.host_sync(None)
    profiling.host_sync([torch.zeros(1)])
    assert profiling.time_ms(lambda: torch.zeros(4).sum(), "cpu", iters=2, warmup=1) >= 0
    assert profiling.device_banner("cpu").startswith("device: cpu")


def test_profiled_function_and_trace(tmp_path):
    """The phase span helper (``span``) inside a ``trace``: a span of the
    port, its identifier after ``#``, lands among the trace's events."""
    def double(x):
        with profiling.span("afcm.test.double", 7):
            return x * 2

    with profiling.trace(str(tmp_path / "trace")) as prof:
        assert torch.equal(double(torch.ones(2)), torch.full((2,), 2.0))
    assert any(e.key == "afcm.test.double#7" for e in prof.key_averages())
    assert (tmp_path / "trace" / "trace.json.gz").stat().st_size > 0
    assert torch.equal(double(torch.ones(2)), torch.full((2,), 2.0))   # no profiler
