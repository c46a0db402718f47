"""Training entry point of the port (``afcm_tpu/train.py``).

    python -m afcm_tpu_torch.train --config-file configs/adni/stylegan3/cmsr.yml \
        [--device cpu] [KEY VALUE ...]

The loop of ``afcm_tpu/train.py:76-229``: epochs with the per-epoch LR
factor, one ``train_step`` per batch of the model ``models.build_model``
makes of the config (a ``GANModel``, with lazy R1 chosen on the host, or the
pix2pix baseline's ``Pix2PixModel``), periodic loss printing, periodic
validation (PSNR/SSIM) with best-by-SSIM checkpoints, ``max_iters`` (in
images, as there) and, at the end, the checkpoint: for the GAN families with
``latest_net_G_ema.pth`` for ``afcm_tpu_torch.evaluate``; for pix2pix
``latest_net_G.pth``, ``latest_net_D.pth`` (their batch-norm statistics
among the buffers) and ``latest_optim.pth``. It runs on the CUDA device and
raises when there is none, unless ``--device cpu`` asks for the CPU.
``tpu.compute_dtype`` sets TF32 for every model: off at the default
``float32``, on otherwise, also for pix2pix, whose networks compute in
float32 whatever it says (as in the JAX package).

Data parallel, as ``afcm_tpu/train.py:111-120`` runs over its mesh's data
axis: ``--num-gpus N``, ``tpu.mesh_shape [N, 1]``, or the default
``[0, 1]`` on a machine with several cards starts one process per device
of the data axis (clamped to a divisor of the batch), NCCL on the cards,
gloo with ``--device cpu``; under ``torchrun`` the ranks come from
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``. ``train`` runs one rank of the
process group it finds, or runs alone when there is none: every rank
builds the same loader from the same seed and takes its contiguous slice
``[rank·b, (rank+1)·b)`` of each global batch, so the batches come in
``afcm_tpu``'s order (each rank loads the whole batch on the host);
``loaders.batch_size`` and the image count stay global. Rank 0 alone
writes ``config.yml`` and the checkpoints, shows, prints and validates;
the other ranks wait at a barrier. Every rank loads a checkpoint to resume.

Tensor parallel, as ``afcm_tpu/train.py:111-120`` shards its state over
the mesh's model axis: ``tpu.mesh_shape [D, M]`` with M > 1 starts D·M
ranks, rank r at data index ``r // M`` and model index ``r % M``
(``parallel.make_groups``); each data row takes one slice of every global
batch, and the ranks of a row hold the slices of the StyleGAN3 GAN's
sharded parameters (``GANModel.distribute``). The generator's forward
crosses the row, so under a model axis every rank displays and validates
along with rank 0, which alone prints and writes. Each rank's float32 step
is under the same cuDNN workspace cap (``bound_conv_workspace``).
"""

from __future__ import annotations

import os
import random
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import parallel
from .data import get_train_loaders
from .evaluate import (check_device_knobs, check_model_axis, model_axis,
                       resolve_device, set_matmul_precision)
from .models import GANModel, build_model
from .models.schedulers import LRScheduler
from .utils import checkpoint as ckpt
from .utils.metrics import evaluate_2D
from .utils.visualizer import Visualizer


def lr_factor(epoch: int, cfg, metric=None) -> float:
    """The per-epoch LR factor of ``cfg.scheduler`` from a fresh
    ``LRScheduler`` (``afcm_tpu/train.py:33-42``). ``plateau`` keeps state
    across epochs, which a fresh scheduler per call would drop, so it is
    refused: ``train`` keeps one scheduler for the run."""
    if cfg.scheduler.lr_policy == "plateau":
        raise ValueError(
            "lr_factor() is stateless; the 'plateau' policy needs a single "
            "persistent LRScheduler across epochs (see train())")
    return LRScheduler(cfg).factor(epoch, metric)


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


def validate(model, val_loader, device,
             generator: torch.Generator) -> Optional[Dict[str, float]]:
    """PSNR/SSIM of ``model.eval_step`` over the val split (the EMA
    generator of a ``GANModel``, pix2pix's G on its running statistics;
    ``afcm_tpu/train.py:53-73``); the target batch goes to G as
    ``ref_img``, like the reference's forward_ema
    (comodgan_model.py:114-116), for the RefMappingNetwork mapper."""
    c_psnr, c_ssim = [], []
    for batch in val_loader:
        inputs = to_device(batch, device)
        fake = model.eval_step(inputs["A"], inputs["slice_idx"], generator=generator,
                               ref_img=inputs["B"]).cpu().numpy()
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


def init_cublas(device) -> None:
    """Create cuBLAS's handles for ``device`` on this thread and on
    autograd's worker thread before the first step: ``cublasCreate``
    allocates outside the caching allocator, and at fp32 (TF32 off) the
    first step's cuDNN plans reserve nearly the whole card for their
    workspace, after which the first backward's handle does not fit
    (``CUBLAS_STATUS_ALLOC_FAILED``)."""
    device = torch.device(device)
    if device.type == "cuda":
        x = torch.ones((2, 2), device=device, requires_grad=True)
        (x @ x).sum().backward()


# cuDNN's workspace cap for the train path's float32 convolutions, in MiB
CONV_WORKSPACE_MIB = 4096


def bound_conv_workspace(device, compute_dtype: str) -> bool:
    """At float32 (TF32 off) on a card, cap the workspace of every cuDNN
    convolution this process plans at ``CONV_WORKSPACE_MIB``: PyTorch's
    legacy cuDNN interface, whose algorithm queries cuDNN bounds by
    ``CUDNN_CONV_WSCAP_DBG``. Its default interface plans each conv at first
    use with a workspace of up to the free memory: an FFT plan of the
    shipped config's 362-channel 148^2 conv took 48 GiB, so the float32
    step's peak measured that plan more than the activations, and remat,
    which runs the forward convs again inside the backward on top of the
    live activations, raised it (ROADMAP C12). At bfloat16 the default
    planning stays: its workspaces are small, and the legacy interface's
    algorithms took the bf16 step 2.3x longer. The interface is chosen when
    the process plans its first convolution, so this acts only before it,
    and the variables pass to the processes this one starts: the train
    CLI's entry (``main``) sets them, not ``train``, which may run in a
    process that serves too. Returns whether the cap was set."""
    if torch.device(device).type != "cuda" or compute_dtype != "float32":
        return False
    os.environ["TORCH_CUDNN_V8_API_DISABLED"] = "1"
    os.environ["CUDNN_CONV_WSCAP_DBG"] = str(CONV_WORKSPACE_MIB)
    return True


def note_default_workspace(device, compute_dtype: str) -> bool:
    """Print one line when the train step runs at float32 on a card whose
    process has no workspace cap (``CUDNN_CONV_WSCAP_DBG`` unset): ``train``
    called in process, not through ``main``, plans its convs under PyTorch's
    default cuDNN workspace (ROADMAP C13). Returns whether it printed."""
    if (torch.device(device).type != "cuda" or compute_dtype != "float32"
            or "CUDNN_CONV_WSCAP_DBG" in os.environ):
        return False
    print("train: float32 on a card plans each cuDNN conv under PyTorch's default "
          "workspace, up to the card's free memory (ROADMAP C12); the train CLI "
          "(python -m afcm_tpu_torch.train, train.main) caps it at "
          f"{CONV_WORKSPACE_MIB} MiB, as train.bound_conv_workspace(device, 'float32') "
          "does when called before this process's first conv", flush=True)
    return True


def train(cfg, max_iters: Optional[int] = None, loaders=None, device=None,
          on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None
          ) -> Dict[str, float]:
    """Train the model of ``cfg`` as one rank of the process group this
    process belongs to, or alone; returns the last validation scores (rank
    0's; the other ranks return ``{}``).

    ``loaders`` replaces ``data.get_train_loaders(cfg)`` (a
    ``{"train", "val"}`` dict, e.g. ``data.demo.phantom_train_loaders``);
    ``on_step(step, metrics)`` is called after every train step, with the
    step's losses (the global batch's) still on the device."""
    device = resolve_device(device)
    check_device_knobs(cfg)
    set_matmul_precision(cfg.tpu.compute_dtype)
    note_default_workspace(device, cfg.tpu.compute_dtype)
    group, model_group = parallel.make_groups(model_axis(cfg))
    lead = group is None or torch.distributed.get_rank() == 0
    batch_size = cfg.loaders.batch_size
    local_batch = parallel.local_batch_size(batch_size, group.world if group else 1)
    seed = cfg.manual_seed if cfg.manual_seed is not None else 0
    random.seed(seed)
    np.random.seed(seed)
    if loaders is None:
        loaders = get_train_loaders(cfg, seed=seed)
    print(f"The number of training images = {len(loaders['train'].dataset)}"
          + (f" (data rank {group.rank} of {group.world}, {local_batch} a step)"
             if group else "")
          + (f" (model rank {model_group.rank} of {model_group.size})"
             if model_group else ""))

    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    model.to(device)
    init_cublas(device)
    if not isinstance(model, GANModel):
        model_group = None      # pix2pix: the whole state on every rank of a row
    if model_group is not None:
        model.distribute(group, model_group)
    elif group is not None:
        model.distribute(group)
    # the ranks that run G_ema's forward: rank 0, or every rank of a row
    # when the forward crosses the row
    evaluates = lead or model_group is not None
    rng = torch.Generator(device=device).manual_seed(seed)
    # display and validation draw from their own stream: rank 0 alone runs
    # them, and the step's stream must stay the same on every rank
    vis_rng = torch.Generator(device=device).manual_seed(seed + 1)

    run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
    if cfg.continue_train:
        tag = str(cfg.epoch) if cfg.epoch else "latest"
        if ckpt.checkpoint_exists(run_dir, tag, model):
            print(f"resuming from {run_dir}/{tag}")
            ckpt.load_state(model, run_dir, tag)

    visualizer = None
    if lead:
        visualizer = Visualizer(cfg)
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.yml"), "w") as f:
            f.write(cfg.dump())
    rows = group.rows(local_batch) if group else slice(None)
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

            # lazy R1: the host picks the steps that run the penalty (the
            # GAN families; pix2pix has no R1)
            step_kwargs = {}
            if isinstance(model, GANModel):
                step_kwargs["with_r1"] = r1_interval <= 1 or opt_steps % r1_interval == 0
            local = {k: v[rows] for k, v in batch.items()}
            metrics = model.train_step(to_device(local, device), float(total_iters),
                                       generator=rng, **step_kwargs)
            opt_steps += 1
            if on_step is not None:
                on_step(opt_steps, metrics)

            if evaluates and total_iters % cfg.trainer.display_freq < batch_size:
                first = to_device({k: v[:1] for k, v in batch.items()}, device)
                # the target goes to G as ref_img, as in validate
                fake = model.eval_step(first["A"], first["slice_idx"], generator=vis_rng,
                                       ref_img=first["B"])
                # the center slice of the 4-slice input window (channel 1)
                a_ch = 1 if batch["A"].shape[1] > 1 else 0
                if lead:
                    visualizer.display_current_results(
                        {"real_A": batch["A"][:1, a_ch:a_ch + 1],
                         "fake_B": fake.cpu().numpy(), "real_B": batch["B"][:1]}, epoch)

            if lead and total_iters % cfg.trainer.print_freq < batch_size:
                values = {k: float(v) for k, v in metrics.items()}
                t_comp = (time.time() - iter_start) / batch_size
                visualizer.print_current_losses(epoch, epoch_iter, values,
                                                t_comp, t_data)

            if total_iters % cfg.trainer.save_latest_freq < batch_size:
                ckpt.save_state(model, run_dir, "latest", group)
                val = validate(model, loaders["val"], device, vis_rng) if evaluates else None
                if model_group is not None:
                    val = rank0_scores(val, group, device)
                if val:
                    last_val = val
                    if lead:
                        visualizer.plot_val_results(val)
                        print(f" ^^^VALIDATION   psnr:{val['psnr']:.6}, "
                              f"ssim:{val['ssim']:.6}", flush=True)
                    if val["ssim"] > ssim_max:
                        ssim_max = val["ssim"]
                        # over a model axis the rows gather the state with rank 0
                        ckpt.save_state(model, run_dir, "best",
                                        group if model_group is not None else None)
                if group is not None:
                    group.barrier()

            iter_data_time = time.time()
            if max_iters and total_iters >= max_iters:
                stop = True
                break

        if epoch % cfg.trainer.save_epoch_freq == 0:
            ckpt.save_state(model, run_dir, "latest", group)
            ckpt.save_state(model, run_dir, str(epoch), group)
        if lead:
            print(f"End of epoch {epoch} / {n_total_epochs} \t "
                  f"Time Taken: {time.time() - epoch_start:.0f} sec", flush=True)
        if stop:
            break

    ckpt.save_state(model, run_dir, "latest", group)   # G_ema's too but for pix2pix
    final_val = None
    if evaluates:
        final_val = validate(model, loaders["val"], device, vis_rng) or last_val
    if group is not None:
        group.barrier()
    return (final_val or {}) if lead else {}


def rank0_scores(val: Optional[Dict[str, float]], group: parallel.DataGroup,
                 device) -> Optional[Dict[str, float]]:
    """Rank 0's validation scores on every rank (rank 0's values summed
    with zeros over every rank), so that all ranks take the same checkpoint
    decision whatever their own forward rounded to."""
    lead = torch.distributed.get_rank() == 0
    values = torch.zeros(3, dtype=torch.float64, device=device)
    if lead and val:
        values[:] = torch.tensor([1.0, val["psnr"], val["ssim"]], dtype=torch.float64)
    group._all_reduce(values, "scores", torch.distributed.group.WORLD)
    flag, psnr, ssim = values.tolist()
    return {"psnr": psnr, "ssim": ssim} if flag else None


def _train_rank(rank: int, world: int, argv, device_type: str) -> None:
    """One spawned rank of ``main``: the config from the same argv, the
    rank's device (``cuda:rank`` or the CPU)."""
    from .config import default_argument_parser
    cfg = default_argument_parser(list(argv))
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    train(cfg, device=device)


def main(argv=None):
    # The config layer needs yaml; only the CLIs import it.
    from .config import default_argument_parser, pop_flag

    argv = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device(pop_flag(argv, "--device"))
    cfg = default_argument_parser(argv)
    print(cfg.dump())
    check_model_axis(cfg)
    # before this process's first conv; the ranks it starts inherit it,
    # so the cap applies to each rank
    bound_conv_workspace(device, cfg.tpu.compute_dtype)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:      # under torchrun
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        parallel.group.init_process_group(backend, "env://", int(os.environ["RANK"]),
                                          int(os.environ["WORLD_SIZE"]))
        try:
            return train(cfg, device=device)
        finally:
            torch.distributed.destroy_process_group()
    mesh = parallel.resolve_mesh(cfg.tpu.mesh_shape, cfg.loaders.batch_size, device)
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else "")
          + (f"; {mesh.devices.size} ranks ({mesh.shape['data']} x "
             f"{mesh.shape['model']}) over {backend}" if mesh else ""))
    if mesh is None:
        return train(cfg, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        parallel.spawn(_train_rank, mesh.devices.size, (argv, device.type),
                       backend=backend, init_file=os.path.join(tmp, "store"),
                       device_type=device.type)
    return {}


if __name__ == "__main__":
    main()
