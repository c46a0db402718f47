"""The port's own copies of the host code against the JAX package's originals.

afcm_tpu_torch keeps its own config layer, data pipeline, predictor,
metrics, NIfTI I/O, native ops and weight-name translation (it imports
nothing of afcm_tpu). Each copy must behave exactly as its original: the
same inputs, made from a seed, go through both and the results are equal
(bit for bit unless a test says otherwise). Also here: the CLIs' device
default.
"""

import glob
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import afcm_tpu.config as jconfig  # noqa: E402
import afcm_tpu.data as jdata  # noqa: E402
import afcm_tpu.native as jnative  # noqa: E402
from afcm_tpu.data import demo as jdemo  # noqa: E402
from afcm_tpu.infer import predictor as jpredictor  # noqa: E402
from afcm_tpu.utils import metrics as jmetrics  # noqa: E402
from afcm_tpu.utils import nifti as jnifti  # noqa: E402
from afcm_tpu.utils import port as jport  # noqa: E402

import afcm_tpu_torch.config as tconfig  # noqa: E402
import afcm_tpu_torch.data as tdata  # noqa: E402
import afcm_tpu_torch.native as tnative  # noqa: E402
from afcm_tpu_torch.data import demo as tdemo  # noqa: E402
from afcm_tpu_torch.infer import predictor as tpredictor  # noqa: E402
from afcm_tpu_torch.native import build as tnative_build  # noqa: E402
from afcm_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from afcm_tpu_torch.utils import nifti as tnifti  # noqa: E402
from afcm_tpu_torch.utils import port as tport  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in
                 glob.glob(os.path.join(REPO, "configs", "**", "*.yml"),
                           recursive=True))
TINY = os.path.join(REPO, "configs/demo/cmsr_tiny.yml")


def test_configs_are_listed():
    assert len(CONFIGS) >= 20 and "configs/adni/stylegan3/cmsr.yml" in CONFIGS


@pytest.mark.parametrize("path", CONFIGS)
def test_config_resolves_equal(path):
    """Every shipped YAML resolves, with overrides, to the same config."""
    argv = ["--config-file", os.path.join(REPO, path), "tpu.conv_int8", "True",
            "loaders.batch_size", "3", "name", "x"]
    want, got = jconfig.default_argument_parser(argv), tconfig.default_argument_parser(argv)
    assert got.dump() == want.dump()
    assert got.tpu.conv_int8 is True and got.loaders.batch_size == 3
    assert tconfig.get_default_cfg().dump() == jconfig.get_default_cfg().dump()


def test_pop_flag_and_unknown_key():
    argv = ["--device", "cpu", "--config-file", TINY]
    assert tconfig.pop_flag(argv, "--device") == "cpu"
    assert argv == ["--config-file", TINY]
    assert tconfig.pop_flag(argv, "--device") is None
    with pytest.raises(Exception):
        tconfig.default_argument_parser(argv + ["no.such.key", "1"])


@pytest.fixture(scope="module")
def demo_tree(tmp_path_factory):
    pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("demo")
    tdemo.write_demo_tree(str(root / "port"), n_train=2, n_val=1, n_test=1,
                          depth=8, size=64)
    jdemo.write_demo_tree(str(root / "jax"), n_train=2, n_val=1, n_test=1,
                          depth=8, size=64)
    return root


def _data_cfg(module, root, extra=()):
    return module.default_argument_parser(
        ["--config-file", TINY,
         "loaders.train.file_paths", f"['{root}/train']",
         "loaders.val.file_paths", f"['{root}/val']",
         "loaders.test.file_paths", f"['{root}/test']", *extra])


def test_phantom_and_demo_tree_equal(demo_tree):
    import h5py
    want, got = jdemo.make_phantom(6, 32, seed=3), tdemo.make_phantom(6, 32, seed=3)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    files = sorted(os.path.relpath(p, demo_tree / "jax") for p in
                   glob.glob(str(demo_tree / "jax" / "*" / "*.h5")))
    assert len(files) == 4
    for rel in files:
        with h5py.File(demo_tree / "jax" / rel) as a, h5py.File(demo_tree / "port" / rel) as b:
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(b[k][()], a[k][()])


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
def test_test_loaders_give_equal_batches(demo_tree, transfer_dtype):
    extra = ("tpu.transfer_dtype", transfer_dtype)
    want = list(jdata.get_test_loaders(_data_cfg(jconfig, demo_tree / "jax", extra)))
    got = list(tdata.get_test_loaders(_data_cfg(tconfig, demo_tree / "port", extra)))
    assert len(want) == len(got) == 1
    assert got[0].norm_range == want[0].norm_range
    batches = 0
    for (a, s, idx), (ja, js, jidx) in zip(got[0], want[0]):
        assert a.dtype == ja.dtype
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(s, js)
        assert idx == jidx
        batches += 1
    assert batches == len(want[0]) == len(got[0]) > 1


def test_train_loaders_give_equal_batches(demo_tree):
    def batches(module, cfg_module, root):
        random.seed(5)
        np.random.seed(5)
        loaders = module.get_train_loaders(_data_cfg(cfg_module, root), seed=5)
        out = {k: [b for b, _ in zip(loaders[k], range(4))] for k in ("train", "val")}
        return out, {k: len(v.dataset) for k, v in loaders.items()}

    want, want_len = batches(jdata, jconfig, demo_tree / "jax")
    got, got_len = batches(tdata, tconfig, demo_tree / "port")
    assert got_len == want_len
    for split in ("train", "val"):
        assert len(got[split]) == len(want[split]) > 0
        for b, jb in zip(got[split], want[split]):
            assert b.keys() == jb.keys()
            for k in jb:
                np.testing.assert_array_equal(b[k], jb[k])


def test_loader_names_the_unported_datasets():
    for mode in ("aligned", "template"):
        with pytest.raises(NotImplementedError, match="A11"):
            tdata.create_dataset({"dataset_mode": mode, "dataroot": "x"}, "train")
    assert tdata.h5_dataset._is_standard_pipeline is not None


def test_predictor_stitches_equal_volume(tmp_path):
    """StandardPredictor over a phantom subject with a synthetic forward
    function: the same stitched volume and the same files."""
    def forward(a_batch, slice_idx):
        a = np.asarray(a_batch, np.float32)
        return np.tanh(a[:, 1:2] * 0.7 + a[:, 2:3] * 0.3 +
                       np.asarray(slice_idx, np.float32)[:, :, None, None])

    def serve(pred_module, data_module, out):
        class Subject(data_module.AbstractVolumeDataset):
            def load_volumes(self, file_path):
                return jdemo.make_phantom(depth=10, size=96, seed=2)
        ds = Subject("phantom.h5", "test",
                     {"name": "SliceBuilder", "patch_shape": [1, 64, 64],
                      "stride_shape": [1, 16, 16]},
                     {"raw": {"Normalize": {"enabled": True, "min_value": 0.0,
                                            "max_value": 255.0},
                              "ToTensor": {"enabled": True, "expand_dims": False}}},
                     raw_internal_path_in=["flair"], raw_internal_path_out=["t1_hr4sr"],
                     thickness=[5], slice_num=4, global_normalization=None)
        loader = data_module.TestLoader(ds, batch_size=5)
        predictor = pred_module.StandardPredictor(forward, str(out), None,
                                                  patch_halo=(0, 8, 8))
        volumes = [predictor.last_prediction.copy()
                   for _ in predictor.run_pipelined([loader], depth=2)]
        predictor.wait_for_writes()
        return volumes

    want = serve(jpredictor, jdata, tmp_path / "jax")
    got = serve(tpredictor, tdata, tmp_path / "port")
    assert len(got) == len(want) == 1 and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert tpredictor.subject_id("a/b/sub_1.h5") == jpredictor.subject_id("a/b/sub_1.h5")


def test_metrics_agree_exactly():
    rng = np.random.RandomState(0)
    target = np.clip(rng.rand(8, 48, 48), 0, 1)
    pred = np.clip(target + 0.05 * rng.randn(8, 48, 48), 0, 1)
    assert tmetrics.evaluate_3D(pred, target) == jmetrics.evaluate_3D(pred, target)
    assert tmetrics.evaluate_slice(pred, target) == jmetrics.evaluate_slice(pred, target)
    p2, t2 = pred[:, None].astype(np.float32), target[:, None].astype(np.float32)
    assert tmetrics.evaluate_2D(p2, t2) == jmetrics.evaluate_2D(p2, t2)
    assert tmetrics.psnr(target, pred) == jmetrics.psnr(target, pred)
    assert tmetrics.ssim(target[0], pred[0]) == jmetrics.ssim(target[0], pred[0])
    assert tmetrics.mae(pred, target) == jmetrics.mae(pred, target)


def test_native_ops_agree_exactly():
    """The port builds its own library (into afcm_tpu_torch/_build, never
    into afcm_tpu/native) and every op gives the original's result."""
    assert tnative.have_native() and jnative.have_native()
    assert os.path.dirname(tnative_build._SO).endswith(os.path.join("afcm_tpu_torch", "_build"))
    assert os.path.exists(tnative_build._SO)
    rng = np.random.RandomState(1)
    volume = (rng.rand(10, 32, 32) * 255).astype(np.uint8)
    idx = np.array([[-1, 0, 4, 8], [0, 2, 9, 12]], dtype=np.int32)
    np.testing.assert_array_equal(tnative.assemble_windows(volume, idx, 0.0, 255.0),
                                  jnative.assemble_windows(volume, idx, 0.0, 255.0))
    a, b = rng.rand(4, 40, 40), rng.rand(4, 40, 40)
    assert tnative.err_stats(a, b) == jnative.err_stats(a, b)
    args = (7, 0.01 ** 2, 0.03 ** 2, 49 / 48)
    assert tnative.ssim_mean(a[0], b[0], *args) == jnative.ssim_mean(a[0], b[0], *args)
    got, want = tnative.slice_metrics(a, b, *args), jnative.slice_metrics(a, b, *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    patches = rng.randn(4, 16, 16).astype(np.float32)
    coords = np.array([[0, 0, 0], [0, 8, 8], [1, 0, 8], [1, 18, 18]], np.int32)
    offsets = np.array([[0, 0], [2, 2], [0, 4], [2, 2]], np.int32)
    sizes = np.array([[16, 16], [12, 12], [16, 12], [14, 14]], np.int32)
    results = []
    for module in (tnative, jnative):
        pmap = np.zeros((2, 32, 32), np.float32)
        nmask = np.zeros((2, 32, 32), np.uint16)
        module.accumulate_patches(pmap, nmask, patches, coords, offsets, sizes)
        results.append((pmap, nmask))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])
    assert results[0][1].sum() > 0


def test_native_fallback_agrees(monkeypatch):
    """Without the library the numpy fall-back stays, as in the original."""
    from afcm_tpu_torch.native import ops as tops
    rng = np.random.RandomState(2)
    volume = (rng.rand(6, 16, 16) * 255).astype(np.uint8)
    idx = np.array([[1, 2, 3, 9]], dtype=np.int32)
    want = tnative.assemble_windows(volume, idx, 0.0, 255.0)
    monkeypatch.setattr(tops, "get_native", lambda: None)
    np.testing.assert_allclose(tnative.assemble_windows(volume, idx, 0.0, 255.0),
                               want, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
def test_nifti_round_trip_equal(tmp_path, dtype):
    rng = np.random.RandomState(3)
    vol = (rng.rand(5, 12, 9) * 200).astype(dtype)
    affine = np.diag([1.5, 0.9, 0.9, 1.0])
    affine[:3, 3] = [3.0, -2.0, 7.0]
    tnifti.write_nifti(str(tmp_path / "port.nii.gz"), vol, affine)
    jnifti.write_nifti(str(tmp_path / "jax.nii.gz"), vol, affine)
    for reader in (tnifti.read_nifti, jnifti.read_nifti):
        for name in ("port.nii.gz", "jax.nii.gz"):
            got, got_affine = reader(str(tmp_path / name))
            np.testing.assert_array_equal(got, vol)
            np.testing.assert_allclose(got_affine, affine, atol=1e-6)


def test_variables_to_state_dict_equal():
    rng = np.random.RandomState(4)
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    variables = {
        "params": {"mapping": {"fc0": {"weight": r(8, 4), "bias": r(8)}},
                   "synthesis": {"L0_36_16": {"weight": r(16, 8, 3, 3),
                                              "affine": {"weight": r(8, 4)}},
                                 "rcab": {"ca": {"down": {"kernel": r(8, 2), "bias": r(2)},
                                                 "up": {"kernel": r(2, 8), "bias": r(8)}},
                                          "down": {"weight": r(4, 4, 3, 3)}}}},
        "moments": {"mapping": {"w_avg": r(4)},
                    "synthesis": {"L0_36_16": {"magnitude_ema": np.float32(1.5)}}},
        "constants": {"synthesis": {"input": {"freqs": r(4, 2)}}},
    }
    want, got = jport.variables_to_state_dict(variables), tport.variables_to_state_dict(variables)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["synthesis.rcab.ca.conv_du.0.weight"].shape == (2, 8, 1, 1)


# --- 0b: the entry points run on the card unless the CPU is asked for -------

def test_resolve_device():
    from afcm_tpu_torch.evaluate import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        for asked in (None, "cuda"):
            with pytest.raises(RuntimeError, match="--device cpu"):
                resolve_device(asked)


@pytest.mark.parametrize("cli", ["evaluate", "train"])
def test_cli_without_a_card_raises_unless_cpu_is_asked(cli, tmp_path):
    """No --device and no card: the CLI raises before it reads a config or
    a checkpoint, it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device exists")
    import importlib
    main = importlib.import_module(f"afcm_tpu_torch.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config-file", TINY, "checkpoints_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
