#!/usr/bin/env python3
"""Data parallelism of the PyTorch port across the cards of one node.

    python scripts/torch_data_parallel.py [--world 4]
    python scripts/torch_data_parallel.py --device cpu --tiny --world 4   # gloo, CPU

Drives the port's data-parallel paths (``afcm_tpu_torch.parallel``) over W
devices joined by NCCL (gloo with ``--device cpu``) and prints the card's
name and power limit, then one JSON line per check:

1. ``step``: one fp32 train step (TF32 off) of the shipped CMSR training
   config (configs/adni/stylegan3/cmsr.yml; ``--tiny``: the demo config at
   64^2) on the phantom's first global batch of 16, split over the W ranks,
   against one process on the whole batch from the same seed and weights:
   the losses' relative errors, each net's gradient as
   ||ranks - one|| / ||one||, the collectives per step (count and bytes)
   and K1/K2 launches per rank. It fails above 1e-3.
2. ``scaling``: the train CLI's loop (``afcm_tpu_torch.train.train``) at
   ``--dtype`` with ``--batch`` samples a rank (a global batch of W x
   ``--batch``) against one process at ``--batch``: ms/step as the median of
   ``--windows`` windows of ``--steps`` steps after ``--warm`` steps, img/s
   and the scaling efficiency (img/s over W x one process's), with each
   loop's peak device memory. The cuDNN workspace policy is the train CLI's
   (``train.bound_conv_workspace``, set before the first conv, which the
   ranks inherit: a 4 GiB cap at float32, nothing at bfloat16) unless
   ``--workspace default`` keeps PyTorch's default planning.
3. ``serve``: a phantom subject served at fp32 (TF32 off) over a mesh of
   the W devices (one replica each, every batch of 16 split over them),
   and from the artifact exported over that mesh served over it, each
   volume against one device's. It fails above 1e-4 x max|one device|.
4. ``serve_rate``: ``--subjects`` phantom subjects of 96 slices served at
   ``--dtype`` through the serve loop on one device and over the mesh, at
   the default batch of 16 (a chunk of 16 / W a card) and at W x 16 (16 a
   card): slices/s of each of ``--windows`` windows, taken in turn, after
   a pass that warms each up.

Weights, data and draws come from seed 0; nothing is read from disk. A rank
that fails fails the run, and NCCL does not fall back to gloo.
``--train-only`` stops after check 2.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from afcm_tpu_torch import parallel, serve  # noqa: E402
from afcm_tpu_torch import train as train_cli  # noqa: E402
from afcm_tpu_torch.config import default_argument_parser  # noqa: E402
from afcm_tpu_torch.data.demo import phantom_test_loader, phantom_train_loaders  # noqa: E402
from afcm_tpu_torch.evaluate import make_forward_fn, set_matmul_precision  # noqa: E402
from afcm_tpu_torch.infer import export  # noqa: E402
from afcm_tpu_torch.models import build_eval_model  # noqa: E402
from afcm_tpu_torch.parallel.check import grad_errors, train_step_check  # noqa: E402

SEED = 0
STEP_BATCH = 16
RANGE = (0.0, 255.0)           # the phantom's uint8 range


def config(args, dtype, batch):
    """The training config with its periodic display, printing and saving
    off, at ``dtype`` and a global ``batch``."""
    never = str(10 ** 9)
    path = "configs/demo/cmsr_tiny.yml" if args.tiny else "configs/adni/stylegan3/cmsr.yml"
    return default_argument_parser([
        "--config-file", os.path.join(REPO, path), "tpu.compute_dtype", dtype,
        "loaders.batch_size", str(batch), "checkpoints_dir", tempfile.gettempdir(),
        "name", "data_parallel", "trainer.display_freq", never, "trainer.print_freq", never,
        "trainer.save_latest_freq", never, "trainer.save_epoch_freq", never,
        "tpu.mesh_shape", "[1, 1]"])


def one_step(args, device, group=None):
    """One fp32 step on the first global batch of STEP_BATCH (this rank's
    slice with a ``group``; ``parallel.check.train_step_check``)."""
    batch = next(iter(phantom_train_loaders(depth=2 * STEP_BATCH, size=args.size,
                                            batch_size=STEP_BATCH, seed=SEED)["train"]))
    return train_step_check(config(args, "float32", STEP_BATCH), batch, device, seed=SEED,
                            draw_seed=SEED + 1, group=group)


class Monitor:
    """on_step callback: the host clock at every step, after a synchronize."""

    def __init__(self, device):
        self.device, self.times = device, []

    def __call__(self, step, metrics):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times.append(time.perf_counter())


def train_loop(args, device, world):
    """The train CLI's loop at W x --batch; the step times of this rank."""
    steps = args.warm + args.windows * args.steps
    batch = world * args.batch
    monitor = Monitor(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    train_cli.train(config(args, args.dtype, batch), max_iters=batch * steps,
                    loaders=phantom_train_loaders(depth=2 * batch, size=args.size,
                                                  batch_size=batch, seed=SEED),
                    device=device, on_step=monitor)
    t = monitor.times[args.warm - 1:]
    windows = [1e3 * (t[(i + 1) * args.steps] - t[i * args.steps]) / args.steps
               for i in range(args.windows)]
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    return {"ms_per_step": float(np.median(windows)), "windows_ms": windows,
            "peak_mem_gib": peak}


def rank_main(rank, world, args, out_dir):
    """One rank: the step check, then the loop."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    group = parallel.DataGroup.current()
    result = {"step": one_step(args, device, group), "loop": train_loop(args, device, world)}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def serve_rate(forward, args, batch):
    """Slices/s of ``--subjects`` phantom subjects of 96 slices through the
    serve loop at ``batch``."""
    loaders = [phantom_test_loader(depth=96, size=args.size, batch_size=batch, seed=SEED + i)
               for i in range(args.subjects)]
    with tempfile.TemporaryDirectory() as out_dir:
        return serve.serve_subjects(forward, loaders, out_dir)["patches_per_s"]


def served_volume(forward, args):
    """The stitched volume of one phantom subject of 192 slices at batch 16."""
    loader = phantom_test_loader(depth=12 * STEP_BATCH, size=args.size,
                                 batch_size=STEP_BATCH, seed=SEED)
    with tempfile.TemporaryDirectory() as out_dir:
        result = serve.serve_subjects(forward, [loader], out_dir, keep_volumes=True)
    (volume,) = result["volumes"].values()
    return volume


def serve_model(args, dtype):
    """The config's EMA generator at ``dtype``, its weights from SEED, and the
    shape of a batch element."""
    set_matmul_precision(dtype)
    g = config(args, dtype, STEP_BATCH).model.G
    model = build_eval_model(dict(g), compute_dtype=dtype,
                             generator=torch.Generator().manual_seed(SEED))
    return model, (g.img_channels_in, g.img_resolution, g.img_resolution)


def check_serving(args, device, mesh):
    """Check 3: the mesh's and the mesh artifact's volumes against one
    device's at fp32, TF32 off."""
    model, shape = serve_model(args, "float32")
    model.generator_ema.to(device)
    one = served_volume(make_forward_fn(model, device, seed=SEED, norm_range=RANGE), args)
    on_mesh = served_volume(make_forward_fn(model, device, seed=SEED, norm_range=RANGE,
                                            mesh=mesh), args)
    exported = export.export_eval(model, STEP_BATCH, shape, norm_range=RANGE, mesh=mesh)
    from_artifact = served_volume(export.serving_forward(exported, seed=SEED, mesh=mesh), args)
    bound = 1e-4 * float(np.abs(one).max())
    diffs = {"mesh": float(np.abs(on_mesh - one).max()),
             "artifact": float(np.abs(from_artifact - one).max())}
    print(json.dumps({"check": "serve", "world": args.world, "compute_dtype": "float32",
                      "tf32": False, "mesh": [str(d) for d in mesh.data_devices],
                      "artifact_devices": export.mesh_devices(exported),
                      "volume": list(one.shape), "max_abs_diff_vs_one_device": diffs,
                      "bound": bound, "finite": bool(np.isfinite(on_mesh).all()
                                                     and np.isfinite(from_artifact).all())}),
          flush=True)
    if not (max(diffs.values()) <= bound and np.isfinite(on_mesh).all()
            and np.isfinite(from_artifact).all()):
        raise SystemExit(f"serving over the mesh is off one device's: {diffs} (bound {bound})")


def measure_serving(args, device, mesh):
    """Check 4: the serve loop's slices/s on one device and over the mesh."""
    model, _ = serve_model(args, args.dtype)
    model.generator_ema.to(device)
    legs = {}
    for batch in (STEP_BATCH, args.world * STEP_BATCH):
        legs[f"one_b{batch}"] = (make_forward_fn(model, device, seed=SEED, norm_range=RANGE),
                                 batch)
        legs[f"mesh_b{batch}"] = (make_forward_fn(model, device, seed=SEED, norm_range=RANGE,
                                                  mesh=mesh), batch)
    for forward, batch in legs.values():
        serve_rate(forward, args, batch)
    rates = {name: [] for name in legs}
    for _ in range(args.windows):
        for name, (forward, batch) in legs.items():
            rates[name].append(serve_rate(forward, args, batch))
    print(json.dumps({"check": "serve_rate", "world": args.world, "dtype": args.dtype,
                      "subjects": args.subjects, "slices_per_subject": 96,
                      "slices_per_s": rates,
                      "median": {k: float(np.median(v)) for k, v in rates.items()}}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true", help="the demo config at 64^2")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=16, help="samples a rank in the loop")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--subjects", type=int, default=4, help="subjects a serving window")
    ap.add_argument("--workspace", default="train", choices=["train", "default"],
                    help="cuDNN workspace policy: the train CLI's, or PyTorch's default")
    ap.add_argument("--train-only", action="store_true", help="checks 1 and 2 alone")
    args = ap.parse_args(argv)
    args.size = 64 if args.tiny else 256
    if args.device == "cuda":
        if torch.cuda.device_count() < args.world:
            raise SystemExit(f"{args.world} cards asked for, {torch.cuda.device_count()} seen")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    if args.device == "cpu":
        torch.set_num_threads(1)
    # as the train CLI's entry: before this process's first conv; the ranks
    # inherit it
    capped = args.workspace == "train" and train_cli.bound_conv_workspace(device, args.dtype)

    want = one_step(args, device)
    loop_one = train_loop(args, device, 1)
    if args.device == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parallel.spawn(rank_main, args.world, (args, tmp),
                       backend="nccl" if args.device == "cuda" else "gloo",
                       init_file=os.path.join(tmp, "store"), device_type=args.device,
                       threads=1 if args.device == "cpu" else 0, timeout_s=1800)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(args.world)]

    got = ranks[0]["step"]
    loss_rel = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
                for k, v in want["metrics"].items()}
    grad_rel = grad_errors(got["grads"], want["grads"])
    print(json.dumps({"check": "step", "world": args.world, "global_batch": STEP_BATCH,
                      "backend": "nccl" if args.device == "cuda" else "gloo",
                      "loss_rel_err": loss_rel, "grad_rel_l2_err": grad_rel,
                      "census_per_step": got["census"],
                      "launches_per_rank": [r["step"]["launches"] for r in ranks],
                      "one_process_launches": want["launches"]}), flush=True)
    one_img_s = 1e3 * args.batch / loop_one["ms_per_step"]
    many_img_s = 1e3 * args.world * args.batch / ranks[0]["loop"]["ms_per_step"]
    print(json.dumps({"check": "scaling", "world": args.world, "dtype": args.dtype,
                      "batch_per_rank": args.batch, "one_process": loop_one,
                      "rank0": ranks[0]["loop"], "img_per_s_one": one_img_s,
                      "img_per_s_world": many_img_s,
                      "efficiency": many_img_s / (args.world * one_img_s),
                      "workspace_policy": args.workspace,
                      "workspace_cap_mib": train_cli.CONV_WORKSPACE_MIB if capped else None,
                      "spawn_s": spawn_s}), flush=True)
    if max(loss_rel.values()) > 1e-3 or max(grad_rel.values()) > 1e-3:
        raise SystemExit(f"the ranks' step is off one process's: {loss_rel} {grad_rel}")
    if args.train_only:
        return 0

    devices = ([torch.device("cuda", i) for i in range(args.world)] if args.device == "cuda"
               else ["cpu"] * args.world)
    mesh = parallel.make_mesh((args.world, 1), devices)
    check_serving(args, device, mesh)
    measure_serving(args, device, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
