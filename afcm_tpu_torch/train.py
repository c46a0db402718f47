"""Training entry point of the port (``afcm_tpu/train.py``).

    python -m afcm_tpu_torch.train --config-file configs/adni/stylegan3/cmsr.yml \
        [--device cpu] [KEY VALUE ...]

The loop of ``afcm_tpu/train.py:76-229``: epochs with the per-epoch LR
factor, one ``GANModel.train_step`` per batch (lazy R1 chosen on the host),
periodic loss printing, periodic validation (PSNR/SSIM) with best-by-SSIM
checkpoints, ``max_iters`` (in images, as there) and, at the end,
``latest_net_G_ema.pth`` for ``afcm_tpu_torch.evaluate``. It runs on the
CUDA device and raises when there is none, unless ``--device cpu`` asks for
the CPU.
"""

from __future__ import annotations

import os
import random
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .data import get_train_loaders
from .evaluate import check_device_knobs, resolve_device, set_matmul_precision
from .models import GANModel, build_gan_model
from .models.schedulers import LRScheduler
from .utils import checkpoint as ckpt
from .utils.metrics import evaluate_2D
from .utils.visualizer import Visualizer


def _slice_idx_of(batch) -> np.ndarray:
    """slice_idx for models that consume it; zeros for datasets without a
    fractional slice position (``afcm_tpu/train.py:45-50``)."""
    if "slice_idx" in batch:
        return batch["slice_idx"]
    return np.zeros((len(batch["A"]), 1), np.float32)


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """The step's inputs of a numpy batch as tensors on ``device``."""
    arrays = {"A": batch["A"], "B": batch["B"], "slice_idx": _slice_idx_of(batch)}
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in arrays.items()}


def validate(model: GANModel, val_loader, device,
             generator: torch.Generator) -> Optional[Dict[str, float]]:
    """PSNR/SSIM of the EMA generator over the val split
    (``afcm_tpu/train.py:53-73``)."""
    c_psnr, c_ssim = [], []
    for batch in val_loader:
        inputs = to_device(batch, device)
        fake = model.eval_step(inputs["A"], inputs["slice_idx"],
                               generator=generator).cpu().numpy()
        preds = np.clip((fake[:, None] + 1) / 2, 0, 1)
        real = np.clip((batch["B"][:, None] + 1) / 2, 0, 1)
        result = evaluate_2D(preds, real)
        if result is None:
            continue
        c_psnr.append(result[0])
        c_ssim.append(result[1])
    if not c_psnr:
        return None
    return {"psnr": float(np.mean(c_psnr)), "ssim": float(np.mean(c_ssim))}


def train(cfg, max_iters: Optional[int] = None, loaders=None, device=None,
          on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None
          ) -> Dict[str, float]:
    """Train the model of ``cfg``; returns the last validation scores.

    ``loaders`` replaces ``data.get_train_loaders(cfg)`` (a
    ``{"train", "val"}`` dict, e.g. ``data.demo.phantom_train_loaders``);
    ``on_step(step, metrics)`` is called after every train step, with the
    step's losses still on the device."""
    device = resolve_device(device)
    check_device_knobs(cfg, training=True)
    set_matmul_precision(cfg.tpu.compute_dtype)
    seed = cfg.manual_seed if cfg.manual_seed is not None else 0
    random.seed(seed)
    np.random.seed(seed)
    if loaders is None:
        loaders = get_train_loaders(cfg, seed=seed)
    print(f"The number of training images = {len(loaders['train'].dataset)}")

    model = build_gan_model(cfg, generator=torch.Generator().manual_seed(seed))
    model.to(device)
    rng = torch.Generator(device=device).manual_seed(seed)

    run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
    if cfg.continue_train:
        tag = str(cfg.epoch) if cfg.epoch else "latest"
        if ckpt.checkpoint_exists(run_dir, tag):
            print(f"resuming from {run_dir}/{tag}")
            ckpt.load_state(model, run_dir, tag)

    visualizer = Visualizer(cfg)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.yml"), "w") as f:
        f.write(cfg.dump())
    batch_size = cfg.loaders.batch_size
    total_iters = 0
    opt_steps = 0
    r1_interval = int(cfg.loss.get("r1_interval", 1))
    ssim_max = 0.0
    max_iters = max_iters or (cfg.trainer.max_iters or None)
    last_val: Dict[str, float] = {}

    n_total_epochs = cfg.scheduler.n_epochs + cfg.scheduler.n_epochs_decay
    stop = False
    scheduler = LRScheduler(cfg)
    for epoch in range(cfg.scheduler.epoch_count, n_total_epochs + 1):
        epoch_start = time.time()
        # plateau watches -SSIM of the latest validation (lower is better)
        factor = scheduler.factor(epoch, -last_val["ssim"] if last_val else None)
        model.with_lr(cfg.optimizer.lr_G * factor, cfg.optimizer.lr_D * factor)
        iter_data_time = time.time()
        epoch_iter = 0

        for batch in loaders["train"]:
            iter_start = time.time()
            t_data = iter_start - iter_data_time
            total_iters += batch_size
            epoch_iter += batch_size

            # lazy R1: the host picks the steps that run the penalty
            with_r1 = r1_interval <= 1 or opt_steps % r1_interval == 0
            metrics = model.train_step(to_device(batch, device), float(total_iters),
                                       with_r1=with_r1, generator=rng)
            opt_steps += 1
            if on_step is not None:
                on_step(opt_steps, metrics)

            if total_iters % cfg.trainer.display_freq < batch_size:
                first = to_device({k: v[:1] for k, v in batch.items()}, device)
                fake = model.eval_step(first["A"], first["slice_idx"], generator=rng)
                # the center slice of the 4-slice input window (channel 1)
                a_ch = 1 if batch["A"].shape[1] > 1 else 0
                visualizer.display_current_results(
                    {"real_A": batch["A"][:1, a_ch:a_ch + 1],
                     "fake_B": fake.cpu().numpy(), "real_B": batch["B"][:1]}, epoch)

            if total_iters % cfg.trainer.print_freq < batch_size:
                values = {k: float(v) for k, v in metrics.items()}
                t_comp = (time.time() - iter_start) / batch_size
                visualizer.print_current_losses(epoch, epoch_iter, values,
                                                t_comp, t_data)

            if total_iters % cfg.trainer.save_latest_freq < batch_size:
                ckpt.save_state(model, run_dir, "latest")
                val = validate(model, loaders["val"], device, rng)
                if val:
                    last_val = val
                    visualizer.plot_val_results(val)
                    print(f" ^^^VALIDATION   psnr:{val['psnr']:.6}, "
                          f"ssim:{val['ssim']:.6}", flush=True)
                    if val["ssim"] > ssim_max:
                        ssim_max = val["ssim"]
                        ckpt.save_state(model, run_dir, "best")

            iter_data_time = time.time()
            if max_iters and total_iters >= max_iters:
                stop = True
                break

        if epoch % cfg.trainer.save_epoch_freq == 0:
            ckpt.save_state(model, run_dir, "latest")
            ckpt.save_state(model, run_dir, str(epoch))
        print(f"End of epoch {epoch} / {n_total_epochs} \t "
              f"Time Taken: {time.time() - epoch_start:.0f} sec", flush=True)
        if stop:
            break

    ckpt.save_state(model, run_dir, "latest")      # with latest_net_G_ema.pth
    final_val = validate(model, loaders["val"], device, rng) or last_val
    return final_val or {}


def main(argv=None):
    # The config layer needs yaml; only the CLIs import it.
    from .config import default_argument_parser, pop_flag

    argv = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device(pop_flag(argv, "--device"))
    cfg = default_argument_parser(argv)
    print(cfg.dump())
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    return train(cfg, device=device)


if __name__ == "__main__":
    main()
