#!/usr/bin/env python3
"""Dress rehearsal of the real-data workflow through the PyTorch port's own
CLIs, one command:

  1. synthesize NIfTI subjects at volume geometry (64 x 256^2; --fast 16 x 64^2)
  2. ``python -m afcm_tpu_torch.data.prepare_h5`` per split (NIfTI -> uint8 h5)
  3. evaluate the init checkpoint with ``python -m afcm_tpu_torch.evaluate``
  4. train on N images with ``python -m afcm_tpu_torch.train`` (the full-size
     CMSR G at bf16 with remat; --fast a tiny G)
  5. evaluate the best-SSIM checkpoint (``latest`` when no validation ran)
  6. assert that the stitched volumes' PSNR and SSIM both improved over init
     and that the run stayed in its budget

The gate is the stitched test volume's: a run whose PSNR or SSIM did not
improve fails, whatever its validation curve did (the JAX package's
rehearsal, scripts/dress_rehearsal.py, lets a CoModGAN run pass on its val
curve). Every step runs on the CUDA device, and the script raises when
none is visible, unless ``--device cpu`` asks for the CPU.

    python scripts/torch_dress_rehearsal.py [--steps 200] [--family comodgan] [--fractional]
    python scripts/torch_dress_rehearsal.py --fast --device cpu
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

MODEL_BLOCK_SG3 = """\
model:
  name: stylegan3
  combine_ab: True
  G:
    netG: 'stylegan3'
    z_dim: {z_dim}
    w_dim: {z_dim}
    c_dim: 1
    img_resolution: {res}
    img_channels_in: 4
    img_channels_out: 1
    synthesis_kwargs:
      channel_base: {channel_base}
      channel_max: {channel_max}
      num_layers: {num_layers}
      {extra_syn}
      skip_resolution: {skip_res}
      conv_clamp: 256
      lrelu_upsampling: 2
    mapping_kwargs:
      num_layers: {map_layers}
"""

# The CoModGAN generator computes in float32 whatever tpu.compute_dtype
# says, in both packages.
MODEL_BLOCK_COMOD = """\
model:
  name: comodgan
  combine_ab: True
  G:
    netG: 'comodgan'
    z_dim: {z_dim}
    w_dim: {z_dim}
    c_dim: 1
    img_resolution: {res}
    img_channels_in: 4
    img_channels_out: 1
    synthesis_kwargs:
      channel_base: {channel_base}
      channel_max: {channel_max}
      skip_resolution: {skip_res}
      conv_clamp: 256
    mapping_kwargs:
      num_layers: {map_layers}
"""

CONFIG_TMPL = """\
{model_block}\
  D:
    netD: 'comodgan'
    img_channels: 5
    c_dim: 1
    channel_base: {channel_base}
    channel_max: {channel_max}
    img_resolution: {res}
    epilogue_kwargs:
      mbstd_group_size: 2
loaders:
  batch_size: {batch}
  slice_num: 4
  thickness: [{thickness}]
  raw_internal_path_in: [flair]
  raw_internal_path_out: [t1]
  train:
    file_paths: ['{root}/h5/train']
    slice_builder:
      name: SliceBuilder
      patch_shape: [1, {res}, {res}]
      stride_shape: [1, 32, 32]
    transformer:
      raw:
        Normalize: {{enabled: True, min_value: 0.0, max_value: 255.0}}
        ToTensor: {{enabled: True, expand_dims: False}}
  val:
    file_paths: ['{root}/h5/val']
  test:
    ori_file_path: ''
    file_paths: ['{root}/h5/test']
    slice_builder:
      name: SliceBuilder
      patch_shape: [1, {res}, {res}]
      stride_shape: [1, {res}, {res}]
optimizer:
  lr_G: {lr_g}
  lr_D: {lr_d}
scheduler:
  n_epochs: 1000
  n_epochs_decay: 0
  ema: {{enabled: True, ema_kimgs: 0.5, ramp: null}}
loss:
  blur_init_sigma: 2.0
  blur_fade_kimg: {blur_fade}
  r1_interval: {r1_interval}
trainer:
  print_freq: 20
  display_freq: 100000
  save_latest_freq: {val_freq}
  save_epoch_freq: 100000
  max_iters: {steps}
tpu:
  compute_dtype: bfloat16
  transfer_dtype: uint8
  remat: {remat}
  remat_min_size: 140
predictor:
  patch_halo: [0, 0, 0]
checkpoints_dir: '{root}/checkpoints'
name: 'rehearsal'
manual_seed: 0
"""


def make_nifti_subjects(root, n_train, n_val, n_test, depth, size):
    from afcm_tpu_torch.data.demo import make_phantom
    from afcm_tpu_torch.utils.nifti import write_nifti
    seed = 100
    split_dirs = {}
    for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        split_dir = os.path.join(root, "nifti", split)
        for i in range(count):
            subject = f"sub_{split}_{i}"
            sub_dir = os.path.join(split_dir, subject)
            os.makedirs(sub_dir, exist_ok=True)
            vols = make_phantom(depth=depth, size=size, seed=seed)
            seed += 1
            for modality in ("t1", "flair"):
                write_nifti(os.path.join(sub_dir, f"{subject}_{modality}.nii.gz"),
                            vols[modality].astype(np.float32))
        split_dirs[split] = split_dir
    return split_dirs


def run_cli(args, log_path):
    """``python -m <module> <args>`` from the repository's root; its output
    goes to ``log_path``, whose end is printed when it fails."""
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.run([sys.executable, *args], stdout=log,
                              stderr=subprocess.STDOUT, cwd=REPO)
    if proc.returncode != 0:
        print(open(log_path).read()[-4000:])
        raise SystemExit(f"FAILED ({proc.returncode}): {' '.join(args)}")
    return time.time() - t0


def parse_eval(out_dir):
    txt = open(os.path.join(out_dir, "evaluate.txt")).read()
    m = re.findall(r"VALIDATION mean psnr:([\d.]+), ssim:([\d.]+)", txt)
    assert m, f"no summary line in evaluate.txt:\n{txt[-500:]}"
    return float(m[-1][0]), float(m[-1][1])


def save_init_checkpoint(config_path):
    """The config's fresh init, as the train CLI builds it (the model of
    ``models.build_model`` from ``manual_seed``), saved under tag 'init'."""
    import torch

    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.models import build_model
    from afcm_tpu_torch.utils import checkpoint as ckpt

    cfg = default_argument_parser(["--config-file", config_path])
    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.manual_seed or 0))
    run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    ckpt.save_state(model, run_dir, "init")


def assert_offgrid_slice_idx(eval_config_path):
    """The fractional leg's point: the evaluation conditions the generator
    at positions outside the training grid."""
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.data import get_test_loaders

    cfg = default_argument_parser(["--config-file", eval_config_path])
    vals = set()
    for loader in get_test_loaders(cfg):
        ds = loader.dataset
        for idx in range(len(ds)):
            _, sidx, _ = ds.get_item(idx)
            vals.add(round(float(sidx[0]), 6))
    train_grid = {0.0, 0.25, 0.5, 0.75}  # thickness {2,4} positions
    offgrid = sorted(v for v in vals if v not in train_grid)
    assert offgrid, f"no off-grid slice_idx in eval set (got {sorted(vals)})"
    expect = {round(1 / 3, 6), round(2 / 3, 6)}
    assert expect <= vals, f"thirds missing from eval set: {sorted(vals)}"
    print(f"      eval slice_idx grid {sorted(vals)}: off-grid positions "
          f"{offgrid} confirmed", flush=True)


def check_improved(init, trained):
    """The gate: the stitched volume's PSNR and SSIM (init's, then the
    trained checkpoint's) both rose."""
    (psnr0, ssim0), (psnr1, ssim1) = init, trained
    if not (psnr1 > psnr0 and ssim1 > ssim0):
        raise SystemExit(f"training did not improve the stitched volume's metrics: init "
                         f"({psnr0:.3f}, {ssim0:.4f}) -> trained ({psnr1:.3f}, {ssim1:.4f})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(REPO, "checkpoints", "torch_rehearsal"))
    ap.add_argument("--steps", type=int, default=None,
                    help="images to train on (trainer.max_iters): 200 by default, "
                         "400 with --fast, whose tiny G needs the longer run for its "
                         "stitched SSIM to pass init's")
    ap.add_argument("--budget-s", type=float, default=3600.0,
                    help="wall budget for the whole rehearsal")
    ap.add_argument("--fast", action="store_true",
                    help="tiny geometry (64^2, a small G) for a CPU run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--r1-interval", type=int, default=1)
    ap.add_argument("--fractional", action="store_true",
                    help="train at thickness {2,4}, evaluate at thickness 3: the "
                         "predictor is conditioned at off-grid thirds")
    ap.add_argument("--lr-g", type=float, default=0.0025)
    ap.add_argument("--lr-d", type=float, default=0.002)
    ap.add_argument("--family", choices=("stylegan3", "comodgan"), default="stylegan3")
    args = ap.parse_args(argv)
    if args.steps is None:
        args.steps = 400 if args.fast else 200
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("torch sees no CUDA device; pass --device cpu to rehearse "
                             "on the CPU")
    device_args = ["--device", args.device]

    root = os.path.abspath(args.workdir)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    t_start = time.time()

    if args.fast:
        geo = dict(depth=16, size=64, z_dim=64, channel_base=1024,
                   channel_max=32, num_layers=4, map_layers=2, skip_res=32,
                   batch=2, extra_syn="num_critical: 2\n      margin_size: 4",
                   remat="False")
    else:
        geo = dict(depth=64, size=256, z_dim=512, channel_base=16384,
                   channel_max=512, num_layers=14, map_layers=8,
                   skip_res=128, batch=16, extra_syn="", remat="True")

    print(f"[1/6] synthesizing NIfTI subjects under {root}/nifti", flush=True)
    splits = make_nifti_subjects(root, n_train=3, n_val=1, n_test=1,
                                 depth=geo["depth"], size=geo["size"])

    for split, src in splits.items():
        out = os.path.join(root, "h5", split)
        dt = run_cli(["-m", "afcm_tpu_torch.data.prepare_h5", "--data-path", src,
                      "--out-path", out, "--modalities", "t1", "flair",
                      "--size", str(geo["size"])],
                     os.path.join(root, f"prepare_{split}.log"))
        print(f"[2/6] prepare_h5 {split}: {dt:.1f}s", flush=True)

    config_path = os.path.join(root, "rehearsal.yml")
    block_tmpl = MODEL_BLOCK_COMOD if args.family == "comodgan" else MODEL_BLOCK_SG3
    model_block = block_tmpl.format(res=geo["size"], **{
        k: geo[k] for k in ("z_dim", "channel_base", "channel_max", "num_layers",
                            "map_layers", "skip_res", "extra_syn")
        if "{" + k + "}" in block_tmpl})
    with open(config_path, "w") as f:
        f.write(CONFIG_TMPL.format(
            root=root, steps=args.steps, val_freq=max(8, args.steps // 2),
            blur_fade=0.2, res=geo["size"], r1_interval=args.r1_interval,
            lr_g=args.lr_g, lr_d=args.lr_d, model_block=model_block,
            thickness="2, 4" if args.fractional else "4",
            **{k: geo[k] for k in ("channel_base", "channel_max", "batch", "remat")}))
    eval_config_path = config_path
    if args.fractional:
        eval_config_path = os.path.join(root, "rehearsal_eval.yml")
        with open(eval_config_path, "w") as f:
            f.write("_BASE_: 'rehearsal.yml'\nloaders:\n  thickness: [3]\n")
        assert_offgrid_slice_idx(eval_config_path)

    print("[3/6] init checkpoint + evaluate", flush=True)
    save_init_checkpoint(config_path)
    dt_ev0 = run_cli(["-m", "afcm_tpu_torch.evaluate", "--config-file", eval_config_path,
                      *device_args, "epoch", "init"], os.path.join(root, "eval_init.log"))
    eval_dir = os.path.join(root, "checkpoints", "rehearsal", "evaluate")
    psnr0, ssim0 = parse_eval(eval_dir)
    os.rename(os.path.join(eval_dir, "evaluate.txt"),
              os.path.join(eval_dir, "evaluate_init.txt"))
    print(f"      init: psnr {psnr0:.3f} ssim {ssim0:.4f} ({dt_ev0:.0f}s)", flush=True)

    print(f"[4/6] train on {args.steps} images", flush=True)
    dt_train = run_cli(["-m", "afcm_tpu_torch.train", "--config-file", config_path,
                        *device_args], os.path.join(root, "train.log"))
    print(f"      train done in {dt_train:.0f}s", flush=True)

    best = os.path.join(root, "checkpoints", "rehearsal", "best_net_G_ema.pth")
    tag = "best" if os.path.exists(best) else "latest"
    print(f"[5/6] evaluate checkpoint '{tag}'", flush=True)
    dt_ev1 = run_cli(["-m", "afcm_tpu_torch.evaluate", "--config-file", eval_config_path,
                      *device_args, "epoch", tag], os.path.join(root, "eval_best.log"))
    psnr1, ssim1 = parse_eval(eval_dir)

    wall = time.time() - t_start
    report = {"device": args.device, "family": args.family,
              "init": {"psnr": psnr0, "ssim": ssim0},
              "trained": {"psnr": psnr1, "ssim": ssim1, "tag": tag},
              "steps": args.steps,
              "seconds": {"train": round(dt_train, 1), "evaluate": round(dt_ev1, 1),
                          "total": round(wall, 1)}}
    print("[6/6] " + json.dumps(report), flush=True)
    check_improved((psnr0, ssim0), (psnr1, ssim1))
    if wall >= args.budget_s:
        raise SystemExit(f"over budget: {wall:.0f}s > {args.budget_s}s")
    print(f"REHEARSAL OK: psnr {psnr0:.2f} -> {psnr1:.2f}, ssim {ssim0:.3f} -> "
          f"{ssim1:.3f}, {wall:.0f}s total", flush=True)
    return report


if __name__ == "__main__":
    main()
