"""Deployment entry point of the port (``afcm_tpu/serve.py``): predict volumes
for every test subject, the evaluate flow minus scoring (no targets needed).

    python -m afcm_tpu_torch.serve --config-file configs/adni/stylegan3/cmsr.yml \
        [--device cpu] [--out DIR] [epoch latest] [KEY VALUE ...]

Serves in process: the EMA generator of ``<tag>_net_G_ema.pth`` on the
device, built by the same function as the evaluate CLI's
(``evaluate.build_serving_forward``), so the routing and precision are those
the evaluation was scored at. Subjects stream through the pipelined
predictor (``tpu.pipeline_depth``); per-subject NIfTI heads are written
write-behind. It runs on the CUDA device and raises when there is none,
unless ``--device cpu`` asks for the CPU. Serving from an exported artifact
(``--artifact``) is not ported yet: the export needs the fused
``filtered_lrelu`` kernel registered as a custom operator (ROADMAP item
A12).
"""

from __future__ import annotations

import os
import sys
import time

import torch

from .infer import get_predictor
from .infer.predictor import subject_id


def serve_subjects(forward, loaders, out_dir: str, config=None,
                   patch_halo=(0, 8, 8), predictor_name: str = "StandardPredictor",
                   keep_volumes: bool = False):
    """Serve every subject of ``loaders`` through the pipelined predictor
    with ``forward`` and write its NIfTI heads under ``out_dir``
    (``afcm_tpu/serve.py:62-78``). Returns the counts, the seconds and,
    with ``keep_volumes``, each subject's stitched volume."""
    os.makedirs(out_dir, exist_ok=True)
    predictor = get_predictor(predictor_name)(forward, out_dir, config,
                                              patch_halo=patch_halo)
    # len(dataset) counts patch windows; with overlapping strides there are
    # more patches than slices, so the rate is patches/s, not slices/s
    # (equal for the shipped full-slice 256^2 configs).
    n_subjects, n_patches, t0 = 0, 0, time.perf_counter()
    volumes = {}
    for loader in predictor.run_pipelined(loaders):
        n_subjects += 1
        n_patches += len(loader.dataset)
        subject = subject_id(loader.dataset.file_path)
        if keep_volumes:
            volumes[subject] = predictor.last_prediction
        print(f" subject:{subject}  {len(loader.dataset)} patches -> {out_dir}",
              flush=True)
    predictor.wait_for_writes()
    seconds = time.perf_counter() - t0
    print(f"served {n_subjects} subjects / {n_patches} patches in {seconds:.1f} s "
          f"({n_patches / max(seconds, 1e-9):.1f} patches/s e2e)")
    return {"subjects": n_subjects, "patches": n_patches, "seconds": seconds,
            "patches_per_s": n_patches / max(seconds, 1e-9), "out_dir": out_dir,
            "volumes": volumes}


def main(argv=None):
    # The config layer needs yaml; only the CLIs import it.
    from .config import default_argument_parser, pop_flag
    from .data import get_test_loaders
    from .evaluate import build_serving_forward, ensure_volumetric, resolve_device
    from .ops.modulated_conv import set_conv_impl

    argv = list(sys.argv[1:] if argv is None else argv)
    artifact = pop_flag(argv, "--artifact")
    out_dir = pop_flag(argv, "--out")
    device_name = pop_flag(argv, "--device")
    cfg = default_argument_parser(argv)
    ensure_volumetric(cfg, "afcm_tpu_torch.serve")
    if artifact is not None:
        raise NotImplementedError(
            "serving from an exported artifact is not ported yet (ROADMAP item "
            "A12): the export needs the filtered_lrelu kernel registered as a "
            "custom operator; serve in process, without --artifact")
    device = resolve_device(device_name)
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    try:
        forward, run_dir = build_serving_forward(cfg, device)
        out_dir = out_dir or os.path.join(run_dir, "serve")
        serve_subjects(forward, get_test_loaders(cfg), out_dir, cfg,
                       patch_halo=cfg.predictor.patch_halo,
                       predictor_name=cfg.predictor.name)
    finally:
        set_conv_impl("xla")    # the knob is this run's, not the process's
    return out_dir


if __name__ == "__main__":
    main()
