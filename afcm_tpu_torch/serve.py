"""Deployment entry point of the port (``afcm_tpu/serve.py``): predict volumes
for every test subject, the evaluate flow minus scoring (no targets needed).

    python -m afcm_tpu_torch.serve --config-file configs/adni/stylegan3/cmsr.yml \
        [--artifact serving.pt2] [--device cpu] [--out DIR] [epoch latest] [KEY VALUE ...]

Serves either in process, the default: the EMA generator of
``<tag>_net_G_ema.pth`` on the device, built by the same function as the
evaluate CLI's (``evaluate.build_serving_forward``), so the routing and
precision are those the evaluation was scored at; or from an artifact of
``afcm_tpu_torch.infer.export`` (``--artifact``), with no checkpoint read
(``afcm_tpu/serve.py:41-51``), over as many devices as it was exported
over. In process a data axis the config sets (``tpu.mesh_shape [N, 1]``,
``--num-gpus N``) holds one replica of the generator per device; the
default serves on one card (``evaluate.serving_mesh``); a model axis
(``tpu.mesh_shape [D, M]``, M > 1) serves over D·M ranks
(``evaluate.serve_over_model_axis``). Subjects stream through the pipelined
predictor (``tpu.pipeline_depth``); per-subject NIfTI heads are written
write-behind. It runs on the CUDA device and raises when there is none,
unless ``--device cpu`` asks for the CPU (an artifact serves only on the
device type it was exported on).
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
    from .evaluate import (ensure_volumetric, model_axis, resolve_device,
                           serve_over_model_axis)

    argv = list(sys.argv[1:] if argv is None else argv)
    artifact = pop_flag(argv, "--artifact")
    out_dir = pop_flag(argv, "--out")
    device_name = pop_flag(argv, "--device")
    cfg = default_argument_parser(argv)
    ensure_volumetric(cfg, "afcm_tpu_torch.serve")
    device = resolve_device(device_name)
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    # the artifact fixes the data axis it serves over, not the config
    if artifact is None and model_axis(cfg) > 1:
        return serve_over_model_axis(serve_run, (artifact, out_dir), cfg, argv, device)
    return serve_run(cfg, device, artifact, out_dir)


def serve_run(cfg, device, artifact=None, out_dir=None, server=None) -> str:
    """The serve CLI's run: the config's test subjects through the
    checkpoint's G_ema (in this process or, with a ``server``, over the
    mesh's model axis) or through an ``artifact``; returns the directory
    of the predictions."""
    from .data import get_test_loaders
    from .evaluate import build_serving_forward
    from .ops.modulated_conv import set_conv_impl

    try:
        if artifact is not None:
            from .infer.export import load_exported, mesh_devices, serving_forward
            from .parallel import resolve_mesh
            exported, _ = load_exported(artifact)
            n = mesh_devices(exported)
            forward = serving_forward(exported, device=device,
                                      mesh=resolve_mesh((n, 1), n, device))
            run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
        else:
            forward, run_dir = build_serving_forward(cfg, device, server)
        out_dir = out_dir or os.path.join(run_dir, "serve")
        serve_subjects(forward, get_test_loaders(cfg), out_dir, cfg,
                       patch_halo=cfg.predictor.patch_halo,
                       predictor_name=cfg.predictor.name)
    finally:
        set_conv_impl("xla")    # the knob is this run's, not the process's
    return out_dir


if __name__ == "__main__":
    main()
