"""The port's train CLI end to end on CPU: ``python -m afcm_tpu_torch.train``
on the tiny demo config over a synthetic h5 tree takes two steps, writes the
reference's per-network checkpoints, and ``afcm_tpu_torch.evaluate`` serves
the saved EMA generator. The phantom train loader (no h5py) feeds the same
loop."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from afcm_tpu_torch import train as train_cli  # noqa: E402
from afcm_tpu_torch.data.demo import phantom_train_loaders  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/demo/cmsr_tiny.yml")


def test_train_cli_then_evaluate(tmp_path):
    pytest.importorskip("h5py")
    from afcm_tpu.data.demo import write_demo_tree
    from afcm_tpu_torch.evaluate import main as evaluate_main

    write_demo_tree(str(tmp_path / "data"), n_train=1, n_val=1, n_test=1,
                    depth=8, size=64)
    common = ["loaders.train.file_paths", f"['{tmp_path}/data/train']",
              "loaders.val.file_paths", f"['{tmp_path}/data/val']",
              "loaders.test.file_paths", f"['{tmp_path}/data/test']",
              "checkpoints_dir", str(tmp_path / "checkpoints")]
    steps = []
    real_step = train_cli.GANModel.train_step

    def counting_step(self, *args, **kwargs):
        steps.append(kwargs.get("with_r1"))
        return real_step(self, *args, **kwargs)

    train_cli.GANModel.train_step = counting_step
    try:
        val = train_cli.main(["--config-file", CONFIG, "--device", "cpu",
                              "trainer.max_iters", "4", *common])
    finally:
        train_cli.GANModel.train_step = real_step
    assert steps == [True, True]              # 4 images at batch 2
    assert np.isfinite(val["psnr"]) and np.isfinite(val["ssim"])
    run_dir = tmp_path / "checkpoints" / "demo_tiny"
    for name in ("net_G", "net_D", "net_G_ema", "optim"):
        assert (run_dir / f"latest_{name}.pth").exists(), name

    result = evaluate_main(["--config-file", CONFIG, "--device", "cpu", *common])
    assert np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])


def test_train_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config-file", CONFIG, "--device", "cuda"])


def test_train_on_phantom_loaders_resumes(tmp_path):
    """train(loaders=...) as chip_smoke.py calls it, then a resume from the
    saved latest state continues the step count and the Adam state."""
    from afcm_tpu.config import default_argument_parser
    from afcm_tpu_torch.utils import checkpoint as ckpt

    argv = ["--config-file", CONFIG, "checkpoints_dir", str(tmp_path),
            "loss.r1_interval", "2"]
    cfg = default_argument_parser(argv)
    loaders = phantom_train_loaders(depth=8, size=64, batch_size=2)
    seen = []
    train_cli.train(cfg, max_iters=4, loaders=loaders, device="cpu",
                    on_step=lambda step, m: seen.append((step, float(m["D_r1"]))))
    assert [s for s, _ in seen] == [1, 2]
    assert seen[0][1] > 0 and seen[1][1] == 0     # lazy R1 every 2nd step

    cfg = default_argument_parser(argv + ["continue_train", "True"])
    model = train_cli.build_model(cfg)
    ckpt.load_state(model, str(tmp_path / "demo_tiny"), "latest")
    assert model.step == 2
    assert all(int(s["step"]) == 2 for s in model.opt_G.state.values())


class _Stop(Exception):
    """Raised in place of the train loop's data loading: the checks of the
    config's device knobs run before it."""


def _no_loaders(*args, **kwargs):
    raise _Stop


def test_train_refuses_remat_naming_a8(monkeypatch):
    """Since rematerialization was ported (ROADMAP item A8) ``tpu.remat True``
    is no longer refused: the run reaches its data loading as the default
    does. Since tensor parallelism was ported (item A12c) a model axis with
    remat starts one rank per device of the mesh (the launch is recorded
    here, not run); what the train CLI still refuses before any data is
    read is a model axis under the CoModGAN generator (item A12d)."""
    monkeypatch.setattr(train_cli, "get_train_loaders", _no_loaders)
    for extra in (["tpu.remat", "True", "tpu.remat_min_size", "32"], []):
        with pytest.raises(_Stop):
            train_cli.main(["--config-file", CONFIG, "--device", "cpu", *extra])
    launched = []
    monkeypatch.setattr(train_cli.parallel, "spawn",
                        lambda fn, world, args, **kw: launched.append(world))
    assert train_cli.main(["--config-file", CONFIG, "--device", "cpu", "tpu.remat", "True",
                           "tpu.mesh_shape", "[1, 2]"]) == {}
    assert launched == [2]
    with pytest.raises(NotImplementedError, match="A12d"):
        train_cli.main(["--config-file", CONFIG, "--device", "cpu", "model.name", "comodgan",
                        "model.G.netG", "comodgan", "tpu.mesh_shape", "[1, 2]"])
    assert launched == [2]


@pytest.mark.parametrize("argv", [["--num-gpus", "2"], ["tpu.mesh_shape", "[1, 2]"],
                                  ["tpu.mesh_shape", "[4, 1]"]])
def test_train_refuses_a_mesh_of_more_than_one_device_naming_a12b(monkeypatch, argv):
    """Since data-parallel training was ported (ROADMAP item A12b) a data
    axis of several devices starts one rank per device: ``--num-gpus 2``
    two, ``[4, 1]`` the largest divisor of the tiny config's batch of 2,
    with a warning (gloo ranks on the CPU; the launch is recorded here, not
    run). Since tensor parallelism was ported (item A12c) the model axis of
    ``[1, 2]`` starts one rank per device of the mesh, two, too (the ranks
    run in tests/test_torch_tensor_parallel.py). ``[1, 1]`` trains in this
    process."""
    monkeypatch.setattr(train_cli, "get_train_loaders", _no_loaders)
    launched = []
    monkeypatch.setattr(train_cli.parallel, "spawn",
                        lambda fn, world, args, **kw: launched.append((world, kw)))
    assert train_cli.main(["--config-file", CONFIG, "--device", "cpu", *argv]) == {}
    ((world, kw),) = launched
    assert world == 2 and kw["backend"] == "gloo" and kw["device_type"] == "cpu"
    with pytest.raises(_Stop):
        train_cli.main(["--config-file", CONFIG, "--device", "cpu",
                        "tpu.mesh_shape", "[1, 1]"])


def test_display_step_passes_the_target_to_ref_mapping_network(tmp_path):
    """Fault C10: the train loop's display step called ``eval_step`` without
    ``ref_img``, so a CoModGAN generator whose mapper is the
    RefMappingNetwork (it maps the target image) raised at the first display
    step. It passes the batch's first target now, as ``afcm_tpu/train.py:
    178-181`` does: the tiny CoModGAN with that mapper trains with the
    display at every step."""
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.config.config import CfgNode
    cfg = default_argument_parser(["--config-file", CONFIG, "checkpoints_dir", str(tmp_path),
                                   "model.name", "comodgan", "model.G.netG", "comodgan",
                                   "trainer.display_freq", "2"])
    cfg.defrost()       # no shipped config selects this mapper (as C9's)
    cfg.model.G.mapping_kwargs = CfgNode(dict(
        name="RefMappingNetwork", img_resolution=64, img_channels=1,
        channel_base=1024, channel_max=32))
    cfg.freeze()
    assert cfg.model.G.mapping_kwargs["name"] == "RefMappingNetwork"
    loaders = phantom_train_loaders(depth=4, size=64, batch_size=2)
    shown = []
    real_display = train_cli.Visualizer.display_current_results

    def display(self, visuals, epoch):
        shown.append(visuals["fake_B"].shape)
        return real_display(self, visuals, epoch)

    train_cli.Visualizer.display_current_results = display
    try:
        val = train_cli.train(cfg, max_iters=4, loaders=loaders, device="cpu")
    finally:
        train_cli.Visualizer.display_current_results = real_display
    assert shown == [(1, 1, 64, 64)] * 2
    assert np.isfinite(val["psnr"])


def test_train_says_matmul_precision_has_no_effect(monkeypatch, capsys):
    """A ``tpu.matmul_precision`` other than ``default`` gets one line that
    says the port sets TF32 from ``tpu.compute_dtype`` alone; TF32 stays off
    for float32. The default prints nothing of it."""
    monkeypatch.setattr(train_cli, "get_train_loaders", _no_loaders)
    for precision, lines in (("highest", 1), ("default", 0)):
        with pytest.raises(_Stop):
            train_cli.main(["--config-file", CONFIG, "--device", "cpu",
                            "tpu.matmul_precision", precision])
        said = [line for line in capsys.readouterr().out.splitlines()
                if line.startswith("tpu.matmul_precision")]
        assert len(said) == lines
        assert all("tpu.compute_dtype alone" in line for line in said)
        assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("card,dtype,capped,said", [
    (True, "float32", False, True), (True, "float32", True, False),
    (True, "bfloat16", False, False), (False, "float32", False, False)])
def test_train_says_when_float32_plans_under_the_default_workspace(
        monkeypatch, capsys, card, dtype, capped, said):
    """ROADMAP C13: ``train.train`` called in process (not through the CLI's
    entry, which caps cuDNN's workspace first) prints one line at float32 on
    a card when ``CUDNN_CONV_WSCAP_DBG`` is not set, and nothing at
    bfloat16, under the cap or on the CPU. The device check is patched to
    see a card; the run stops at its data loading."""
    monkeypatch.setattr(train_cli, "get_train_loaders", _no_loaders)
    if card:
        monkeypatch.setattr(train_cli, "resolve_device", lambda device=None: torch.device("cuda"))
    if capped:
        monkeypatch.setenv("CUDNN_CONV_WSCAP_DBG", str(train_cli.CONV_WORKSPACE_MIB))
    else:
        monkeypatch.delenv("CUDNN_CONV_WSCAP_DBG", raising=False)
    from afcm_tpu_torch.config import default_argument_parser
    cfg = default_argument_parser(["--config-file", CONFIG, "tpu.compute_dtype", dtype])
    with pytest.raises(_Stop):
        train_cli.train(cfg, device="cpu")
    lines = [line for line in capsys.readouterr().out.splitlines()
             if "default workspace" in line]
    assert len(lines) == int(said)
    assert all("train.bound_conv_workspace" in line for line in lines)
