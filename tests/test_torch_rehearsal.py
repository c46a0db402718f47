"""The port's dress rehearsal (scripts/torch_dress_rehearsal.py): NIfTI
subjects -> ``python -m afcm_tpu_torch.data.prepare_h5`` -> evaluate the
init checkpoint -> ``python -m afcm_tpu_torch.train`` -> evaluate the best
checkpoint, on the CPU at the ``--fast`` geometry, with the gate that the
stitched volume's PSNR and SSIM both improve (the JAX rehearsal's
scripts/dress_rehearsal.py:774 lets a CoModGAN run pass on its val curve;
this one does not). The end-to-end run takes ~90 s on the CPU and is
marked slow; the gate and the refusal without a card are held in Tier-1.
"""

import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_dress_rehearsal", os.path.join(REPO, "scripts", "torch_dress_rehearsal.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_gate_fails_a_run_whose_ssim_fell_even_as_psnr_rose():
    script = _script()
    script.check_improved((12.96, 0.068), (15.26, 0.072))
    for trained in ((13.12, 0.061), (12.90, 0.070), (12.96, 0.068)):
        with pytest.raises(SystemExit, match="did not improve"):
            script.check_improved((12.96, 0.068), trained)


def test_rehearsal_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        _script().main(["--fast", "--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.slow
def test_fast_rehearsal_on_the_cpu(tmp_path):
    pytest.importorskip("h5py")
    report = _script().main(["--fast", "--device", "cpu", "--workdir", str(tmp_path)])
    assert report["trained"]["psnr"] > report["init"]["psnr"]
    assert report["trained"]["ssim"] > report["init"]["ssim"]
    assert report["steps"] == 400
