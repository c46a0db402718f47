"""Training observability: console + CSV/JSONL sinks, optional wandb.

Replaces the reference Visualizer's visdom/HTML/wandb stack (reference:
util/visualizer.py) with dependency-free sinks: loss lines go to stdout and
``loss_log.txt`` (same line format), scalar histories to ``metrics.jsonl``,
image grids to PNG files under ``web/images`` when matplotlib is available.
wandb is used when installed and ``display.use_wandb`` is set.

The port's own copy of ``afcm_tpu/utils/visualizer.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class Visualizer:
    def __init__(self, cfg):
        self.cfg = cfg
        self.run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.log_name = os.path.join(self.run_dir, "loss_log.txt")
        self.metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self.img_dir = os.path.join(self.run_dir, "web", "images")
        with open(self.log_name, "a") as f:
            now = time.strftime("%c")
            f.write(f"================ Training Loss ({now}) ================\n")

        self.wandb_run = None
        if getattr(cfg.display, "use_wandb", False):
            try:
                import wandb
                self.wandb_run = wandb.init(
                    project=cfg.display.wandb_project_name, name=cfg.name,
                    config=cfg.to_dict()) if not wandb.run else wandb.run
            except ImportError:
                print("wandb requested but not installed; skipping")

    def reset(self):
        pass

    # -- scalars -------------------------------------------------------------

    def print_current_losses(self, epoch: int, iters: int,
                             losses: Dict[str, float], t_comp: float,
                             t_data: float):
        message = (f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, "
                   f"data: {t_data:.3f}) ")
        message += " ".join(f"{k}: {float(v):.3f}" for k, v in losses.items())
        print(message, flush=True)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")
        self._append_jsonl({"kind": "train", "epoch": epoch, "iters": iters,
                            **{k: float(v) for k, v in losses.items()}})
        if self.wandb_run:
            self.wandb_run.log(losses)

    def plot_val_results(self, results: Dict[str, float]):
        self._append_jsonl({"kind": "val",
                            **{k: float(v) for k, v in results.items()}})
        if self.wandb_run:
            self.wandb_run.log(results)

    def _append_jsonl(self, record: Dict):
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    # -- images --------------------------------------------------------------

    def display_current_results(self, visuals: Dict[str, np.ndarray],
                                epoch: int, save_result: bool = True):
        """Save a [-1,1] image grid per visual to web/images."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        os.makedirs(self.img_dir, exist_ok=True)
        n = len(visuals)
        fig, axes = plt.subplots(1, n, figsize=(3 * n, 3))
        if n == 1:
            axes = [axes]
        for ax, (name, img) in zip(axes, visuals.items()):
            img = np.asarray(img)
            if img.ndim == 4:
                img = img[0]
            if img.ndim == 3:
                img = img[0]
            ax.imshow((np.clip(img, -1, 1) + 1) / 2, cmap="gray",
                      vmin=0, vmax=1)
            ax.set_title(name)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(self.img_dir, f"epoch{epoch:03d}.png"),
                    dpi=80)
        plt.close(fig)
        if save_result:
            self._update_html_index()
        if self.wandb_run:
            try:
                import wandb
                self.wandb_run.log({name: wandb.Image(
                    (np.clip(np.asarray(img).squeeze(), -1, 1) + 1) / 2)
                    for name, img in visuals.items()})
            except Exception:
                pass

    def _update_html_index(self):
        """Regenerate the web/index.html gallery, newest epoch first
        (reference: util/visualizer.py:191-212)."""
        from .html import HTML
        web_dir = os.path.dirname(self.img_dir)
        page = HTML(web_dir, f"Experiment name = {self.cfg.name}", refresh=0)
        def _epoch_key(name):
            digits = "".join(ch for ch in name if ch.isdigit())
            return int(digits) if digits else -1
        pngs = sorted((f for f in os.listdir(self.img_dir)
                       if f.endswith(".png")), key=_epoch_key, reverse=True)
        for png in pngs:
            label = os.path.splitext(png)[0]
            page.add_header(label)
            page.add_images([png], [label], [png])
        page.save()
