"""Evaluation entry point of the port (``afcm_tpu/evaluate.py:131-354``).

    python -m afcm_tpu_torch.evaluate --config-file configs/adni/stylegan3/cmsr.yml \
        [--device cuda] [epoch latest] [KEY VALUE ...]

Loads ``<checkpoints_dir>/<name>/<tag>_net_G_ema.pth`` (a torch state_dict
under the reference's file naming), runs the patch-stitched predictor per
test subject with the EMA generator on the device, and reports 3-D and
per-slice PSNR/SSIM into ``evaluate.txt``. The config, data pipeline,
predictor and metrics are ``afcm_tpu``'s own framework-free code.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Optional

import numpy as np
import torch

from afcm_tpu.data import get_test_loaders
from afcm_tpu.infer.predictor import StandardPredictor, subject_id
from afcm_tpu.utils.metrics import evaluate_3D, evaluate_slice
from afcm_tpu.utils.nifti import read_nifti, write_nifti

from .models import GANModel, build_eval_model


def normalize_uint8(a, lo: float, hi: float):
    """Normalize -> [-1, 1] of a uint8 batch on its device: the formula the
    host float path applies (data/h5_dataset.py AbstractVolumeDataset._norm)."""
    return torch.clamp(2 * ((a.float() - lo) / (hi - lo)) - 1, -1, 1)


class DeviceResult:
    """A forward result left on the device, with the two duck types
    ``StandardPredictor`` relies on (``infer/predictor.py:214-231``):
    ``copy_to_host_async()`` starts a non-blocking copy into pinned host
    memory and records a CUDA event; ``__array__`` waits on that event."""

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self._host: Optional[torch.Tensor] = None
        self._event: Optional[torch.cuda.Event] = None

    def copy_to_host_async(self):
        if self._host is not None:
            return
        if not self.tensor.is_cuda:
            self._host = self.tensor
            return
        self._host = torch.empty(self.tensor.shape, dtype=self.tensor.dtype,
                                 pin_memory=True)
        self._host.copy_(self.tensor, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def __array__(self, dtype=None, copy=None):
        self.copy_to_host_async()
        if self._event is not None:
            self._event.synchronize()
        arr = self._host.numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)


def make_forward_fn(model: GANModel, device, seed: int = 0, norm_range=None,
                    eval_z: str = "per-batch"):
    """(A, slice_idx) numpy batch -> ``DeviceResult`` of the EMA generator.

    ``eval_z="per-batch"`` draws a fresh z for every batch from one seeded
    ``torch.Generator`` (the reference protocol, comodgan_model.py:101-108);
    ``"fixed"`` draws z once and reuses it, i.e. one z per batch position
    for the whole run — the JAX package's behaviour, kept as it is (ROADMAP
    fault C1; fixed in both packages together). uint8 batches are normalized
    on the device with ``norm_range``."""
    if eval_z not in ("per-batch", "fixed"):
        raise ValueError(f"eval_z {eval_z!r}")
    device = torch.device(device)
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    fixed_z = {}

    def forward(a_batch, slice_idx):
        a = torch.from_numpy(np.ascontiguousarray(a_batch)).to(device)
        s = torch.from_numpy(np.asarray(slice_idx, np.float32)).to(device)
        if a.dtype == torch.uint8:
            if norm_range is None:
                raise ValueError("uint8 batches require make_forward_fn(norm_range=...)")
            a = normalize_uint8(a, float(norm_range[0]), float(norm_range[1]))
        n = a.shape[0]
        if eval_z == "fixed":
            if n not in fixed_z:
                fixed_z[n] = torch.randn((n, model.z_dim), generator=rng,
                                         device=device)
            z = fixed_z[n]
        else:
            z = torch.randn((n, model.z_dim), generator=rng, device=device)
        return DeviceResult(model.eval_step(a, s, z=z))
    return forward


def set_matmul_precision(compute_dtype: str) -> None:
    """TF32 off for cuDNN convolutions and matmuls in float32, on otherwise:
    the analog of ``tpu.matmul_precision highest`` (docs/porting.md:46-53)."""
    tf32 = compute_dtype != "float32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def configure_numerics(cfg) -> str:
    """Check the config's device knobs, set the matmul precision of
    ``tpu.compute_dtype`` and return it."""
    if getattr(cfg.tpu, "conv_int8", False):
        raise NotImplementedError("tpu.conv_int8: the int8 conv kernel is not "
                                  "ported yet (ROADMAP items B3/B4)")
    if getattr(cfg.tpu, "fetch_dtype", "float32") not in (None, "float32"):
        raise NotImplementedError("tpu.fetch_dtype bfloat16 is not ported yet "
                                  "(ROADMAP item A5)")
    compute_dtype = cfg.tpu.compute_dtype
    set_matmul_precision(compute_dtype)
    if compute_dtype == "float32":
        print("compute_dtype float32: TF32 off for cuDNN convolutions and matmuls")
    return compute_dtype


def pipeline_norm_range(cfg):
    """The Normalize range when ``tpu.transfer_dtype`` is uint8 and the test
    pipeline is the standard Normalize->ToTensor chain, else None
    (``afcm_tpu/evaluate.py:72-83``)."""
    if getattr(cfg.tpu, "transfer_dtype", "float32") != "uint8":
        return None
    from afcm_tpu.data.h5_dataset import _is_standard_pipeline
    return _is_standard_pipeline(cfg.loaders.test.transformer.raw)


def checkpoint_tag(cfg) -> str:
    return str(cfg.epoch) if cfg.epoch else "latest"


def load_generator_ema(model: GANModel, run_dir: str, tag: str):
    """Load ``<tag>_net_G_ema.pth`` strictly into the EMA generator."""
    path = os.path.join(run_dir, f"{tag}_net_G_ema.pth")
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.generator_ema.load_state_dict(state, strict=True)


def find_target_volume(ori_file_path: Optional[str], modality: str,
                       subject: str) -> Optional[np.ndarray]:
    """The registered original-resolution target of a subject, if any
    (``afcm_tpu/evaluate.py:255-270``)."""
    if ori_file_path and os.path.isdir(os.path.join(ori_file_path, subject)):
        matches = glob.glob(os.path.join(ori_file_path, subject,
                                         f"{subject}*{modality}.nii.gz"))
        if matches:
            vol, _ = read_nifti(matches[0])
            return np.asarray(vol, np.float64)
    return None


def serve_and_score(forward_fn, loaders, out_path: str, modality: str,
                    config=None, patch_halo=(0, 8, 8),
                    ori_file_path: Optional[str] = None):
    """Serve every subject of ``loaders`` through ``StandardPredictor`` with
    ``forward_fn`` and score the stitched volume against its target (the
    registered original under ``ori_file_path``, else the subject's own
    ``modality``); writes the predictions and appends one line per subject
    and the summary to ``<out_path>/evaluate.txt``
    (``afcm_tpu/evaluate.py:297-354``). Returns the mean scores and, under
    ``"subjects"``, each subject's scores, volume shape and finiteness."""
    predictor = StandardPredictor(forward_fn, out_path, config,
                                  patch_halo=patch_halo)
    subjects = {}
    with open(os.path.join(out_path, "evaluate.txt"), "a") as fw:
        # tpu.pipeline_depth batches stay in flight across subjects
        # (StandardPredictor.run_pipelined reads it from the config).
        for test_loader in predictor.run_pipelined(loaders):
            subject = subject_id(test_loader.dataset.file_path)
            volume = predictor.last_prediction
            img_data = (np.clip(volume, -1, 1) + 1) / 2

            target = find_target_volume(ori_file_path, modality, subject)
            if target is not None:
                target_data = np.clip(target, 0, 255) / 255
            else:
                target_data = test_loader.dataset.raw[modality].astype(
                    np.float64) / 255
            predictor.submit_write(
                write_nifti, os.path.join(out_path, subject + "_ori.nii.gz"),
                target_data.astype(np.float32))

            one = evaluate_3D(img_data, target_data)
            one_slice = evaluate_slice(img_data, target_data)
            subjects[subject] = {
                "psnr": one[0], "ssim": one[1], "psnr_slice": one_slice[0],
                "ssim_slice": one_slice[1], "shape": volume.shape,
                "finite": bool(np.isfinite(volume).all())}
            line = (f" subject:{subject}   psnr:{one[0]:.6}, ssim:{one[1]:.6}, "
                    f"psnr_slice:{one_slice[0]:.6}, ssim_slice:{one_slice[1]:.6}\n")
            fw.write(line)
            print(line, end="")

        c_psnr, c_ssim, c_psnr_slice, c_ssim_slice = (
            [scores[key] for scores in subjects.values()]
            for key in ("psnr", "ssim", "psnr_slice", "ssim_slice"))
        summary = (f" ^^^VALIDATION mean psnr:{np.mean(c_psnr):.6}, "
                   f"ssim:{np.mean(c_ssim):.6}, "
                   f"psnr_slice:{np.mean(c_psnr_slice):.6}, "
                   f"ssim_slice:{np.mean(c_ssim_slice):.6}\n")
        summary += (f" std   psnr:{np.std(c_psnr):.6}, ssim:{np.std(c_ssim):.6}, "
                    f"psnr_slice:{np.std(c_psnr_slice):.6}, "
                    f"ssim_slice:{np.std(c_ssim_slice):.6}\n")
        fw.write(summary)
        print(summary, end="")
    predictor.wait_for_writes()
    return {"psnr": float(np.mean(c_psnr)), "ssim": float(np.mean(c_ssim)),
            "psnr_slice": float(np.mean(c_psnr_slice)),
            "ssim_slice": float(np.mean(c_ssim_slice)), "subjects": subjects}


def main(argv=None):
    # The config layer needs yaml; only this CLI imports it.
    from afcm_tpu.config import default_argument_parser
    from afcm_tpu.config.config import pop_flag

    argv = list(sys.argv[1:] if argv is None else argv)
    device = torch.device(pop_flag(argv, "--device") or
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    cfg = default_argument_parser(argv)
    print(cfg.dump())
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    if getattr(cfg.model, "name", "stylegan3") != "stylegan3":
        raise NotImplementedError(f"model {cfg.model.name} is not ported yet "
                                  "(ROADMAP items A10-A11)")
    compute_dtype = configure_numerics(cfg)

    model = build_eval_model(dict(cfg.model.G), compute_dtype=compute_dtype)
    run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
    load_generator_ema(model, run_dir, checkpoint_tag(cfg))
    model.generator_ema.to(device)      # the weights move to the device once

    out_path = os.path.join(run_dir, "evaluate")
    os.makedirs(out_path, exist_ok=True)
    forward = make_forward_fn(model, device, norm_range=pipeline_norm_range(cfg),
                              eval_z=getattr(cfg.tpu, "eval_z", "per-batch"))
    return serve_and_score(forward, get_test_loaders(cfg), out_path,
                           cfg.loaders.raw_internal_path_out[-1], config=cfg,
                           patch_halo=cfg.predictor.patch_halo,
                           ori_file_path=cfg.loaders.test.ori_file_path)

if __name__ == "__main__":
    main()
