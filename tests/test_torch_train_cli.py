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
    model = train_cli.build_gan_model(cfg)
    ckpt.load_state(model, str(tmp_path / "demo_tiny"), "latest")
    assert model.step == 2
    assert all(int(s["step"]) == 2 for s in model.opt_G.state.values())


class _Stop(Exception):
    """Raised in place of the train loop's data loading: the checks of the
    config's device knobs run before it."""


def _no_loaders(*args, **kwargs):
    raise _Stop


def test_train_refuses_remat_naming_a8(monkeypatch):
    """``tpu.remat True`` is refused before any data is read: the port's
    step keeps every activation (ROADMAP item A8), and a run that asked for
    rematerialization must not silently train without it."""
    monkeypatch.setattr(train_cli, "get_train_loaders", _no_loaders)
    with pytest.raises(NotImplementedError, match="A8"):
        train_cli.main(["--config-file", CONFIG, "--device", "cpu", "tpu.remat", "True",
                        "tpu.remat_min_size", "32"])
    with pytest.raises(_Stop):          # the default trains
        train_cli.main(["--config-file", CONFIG, "--device", "cpu"])


@pytest.mark.parametrize("argv", [["--num-gpus", "2"], ["tpu.mesh_shape", "[1, 2]"],
                                  ["tpu.mesh_shape", "[4, 1]"]])
def test_train_refuses_a_mesh_of_more_than_one_device_naming_a12b(monkeypatch, argv):
    """``--num-gpus 2`` (the mesh [2, 1]) or any mesh of more than one
    device is refused: data-parallel training is ROADMAP item A12b, and one
    card must not train in its place without a word. ``[1, 1]`` runs."""
    monkeypatch.setattr(train_cli, "get_train_loaders", _no_loaders)
    with pytest.raises(NotImplementedError, match="A12b"):
        train_cli.main(["--config-file", CONFIG, "--device", "cpu", *argv])
    with pytest.raises(_Stop):
        train_cli.main(["--config-file", CONFIG, "--device", "cpu",
                        "tpu.mesh_shape", "[1, 1]"])


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
