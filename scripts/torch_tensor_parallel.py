#!/usr/bin/env python3
"""Tensor parallelism of the PyTorch port across the cards of one node.

    python scripts/torch_tensor_parallel.py [--mesh 1,2 2,2 1,4]
    python scripts/torch_tensor_parallel.py --device cpu --tiny --mesh 1,2 2,2  # gloo, CPU

Drives the port's model axis (``afcm_tpu_torch.parallel.tensor``) over
meshes of D x M ranks joined by NCCL (gloo with ``--device cpu``), rank r
at data index r // M and model index r % M, on the shipped CMSR training
config (configs/adni/stylegan3/cmsr.yml; ``--tiny``: the demo config at
64^2), and prints the card's name and power limit, then one JSON line per
check:

1. ``step`` (per mesh): one fp32 train step (TF32 off) on the phantom's
   first global batch of 16, each data row on its slice, against one
   process (mesh 1 x 1) from the same seed and weights: the losses'
   relative errors, each net's whole gradient as ||mesh - one|| / ||one||,
   the collectives per step by purpose (count and bytes), K1/K2 launches
   and the step's peak per rank. It fails above 1e-3.
2. ``loop`` (per dtype and mesh, the one-process mesh 1 x 1 first): the
   train CLI's loop (``afcm_tpu_torch.train.train``) at a global batch of
   ``--batch``: ms/step as the median of ``--windows`` windows of
   ``--steps`` steps after ``--warm``, and each rank's peak device memory.
   At float32 every rank runs under the train CLI's cuDNN workspace cap
   (``train.bound_conv_workspace``, which the ranks inherit), at bfloat16
   under PyTorch's default planning, as the train CLI runs them.
3. ``serve_rate`` (``--serve-mesh``, default 1 x 4): ``--subjects``
   phantom subjects of 96 slices served at bf16 b16 through the serve loop
   over the mesh's ranks (``evaluate.ModelAxisServer``; rank 0 stitches),
   and on one card in this process: slices/s of each of ``--windows``
   windows after a warm pass, and the largest difference of the first
   subject's volumes.

Weights, data and draws come from seed 0; nothing is read from disk but
the random G_ema this script writes for the serving check. A rank that
fails fails the run, and NCCL does not fall back to gloo.
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
from afcm_tpu_torch.evaluate import (ModelAxisServer, make_forward_fn,  # noqa: E402
                                     set_matmul_precision)
from afcm_tpu_torch.models import build_eval_model  # noqa: E402
from afcm_tpu_torch.parallel.check import grad_errors, train_step_check  # noqa: E402

SEED = 0
STEP_BATCH = 16
SERVE_BATCH = 16
RANGE = (0.0, 255.0)           # the phantom's uint8 range
CAP_VARIABLES = ("TORCH_CUDNN_V8_API_DISABLED", "CUDNN_CONV_WSCAP_DBG")


def argv_of(args, dtype, batch, mesh, out_dir=None):
    """The training config's arguments with its periodic display, printing
    and saving off, at ``dtype``, a global ``batch`` and ``mesh``."""
    never = str(10 ** 9)
    path = "configs/demo/cmsr_tiny.yml" if args.tiny else "configs/adni/stylegan3/cmsr.yml"
    return ["--config-file", os.path.join(REPO, path), "tpu.compute_dtype", dtype,
            "loaders.batch_size", str(batch),
            "checkpoints_dir", out_dir or tempfile.gettempdir(), "name", "tensor_parallel",
            "trainer.display_freq", never, "trainer.print_freq", never,
            "trainer.save_latest_freq", never, "trainer.save_epoch_freq", never,
            "tpu.mesh_shape", f"[{mesh[0]}, {mesh[1]}]"]


def rank_device(args):
    return (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
            else torch.device("cpu"))


def rank_main(rank, world, args, mesh, dtype, out_dir):
    """One rank of a mesh: at float32 the step check, then the loop."""
    device = rank_device(args)
    group, model_group = parallel.make_groups(mesh[1])
    result = {}
    if dtype == "float32":
        batch = next(iter(phantom_train_loaders(depth=2 * STEP_BATCH, size=args.size,
                                                batch_size=STEP_BATCH, seed=SEED)["train"]))
        cfg = default_argument_parser(argv_of(args, "float32", STEP_BATCH, mesh))
        result["step"] = train_step_check(cfg, batch, device, seed=SEED, draw_seed=SEED + 1,
                                          group=group, model_group=model_group)
    steps = args.warm + args.windows * args.steps
    times = []

    def on_step(step, metrics):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter())

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    train_cli.train(default_argument_parser(argv_of(args, dtype, args.batch, mesh)),
                    max_iters=args.batch * steps,
                    loaders=phantom_train_loaders(depth=2 * args.batch, size=args.size,
                                                  batch_size=args.batch, seed=SEED),
                    device=device, on_step=on_step)
    t = times[args.warm - 1:]
    windows = [1e3 * (t[(i + 1) * args.steps] - t[i * args.steps]) / args.steps
               for i in range(args.windows)]
    result["loop"] = {"ms_per_step": float(np.median(windows)), "windows_ms": windows,
                      "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                                       if device.type == "cuda" else None)}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(args, fn, world, *fn_args):
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parallel.spawn(fn, world, (*fn_args, tmp), backend=args.backend,
                       init_file=os.path.join(tmp, "store"), device_type=args.device,
                       threads=1 if args.device == "cpu" else 0, timeout_s=args.timeout)
        seconds = time.perf_counter() - t0
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)], seconds


def serve_loaders(args):
    return [phantom_test_loader(depth=96, size=args.size, batch_size=SERVE_BATCH,
                                seed=SEED + i) for i in range(args.subjects)]


def timed_serving(forward, args):
    """A warm pass, then ``--windows`` windows: slices/s each, and the
    first subject's volume."""
    with tempfile.TemporaryDirectory() as out_dir:
        first = serve.serve_subjects(forward, serve_loaders(args), out_dir,
                                     keep_volumes=True)
        rates = [serve.serve_subjects(forward, serve_loaders(args), out_dir)["patches_per_s"]
                 for _ in range(args.windows)]
    return rates, next(iter(first["volumes"].values()))


def serve_rank(rank, world, args, argv, out_dir):
    """One rank of the serving check: rank 0 serves, the others follow."""
    server = ModelAxisServer(default_argument_parser(list(argv)), rank_device(args))
    if not server.lead:
        return server.serve()
    try:
        rates, volume = timed_serving(make_forward_fn(
            server.model, server.device, seed=SEED, norm_range=RANGE, server=server), args)
    finally:
        server.close()
    torch.save({"rates": rates, "volume": volume,
                "census": server.group.take_census()}, os.path.join(out_dir, "rank0.pt"))
    for r in range(1, world):
        torch.save({}, os.path.join(out_dir, f"rank{r}.pt"))


def measure_serving(args, mesh):
    """Check 3: serving over the mesh's ranks beside one card."""
    dtype = "bfloat16"
    with tempfile.TemporaryDirectory() as run:
        argv = argv_of(args, dtype, SERVE_BATCH, mesh, out_dir=run)
        cfg = default_argument_parser(argv)
        set_matmul_precision(dtype)
        model = build_eval_model(dict(cfg.model.G), compute_dtype=dtype,
                                 generator=torch.Generator().manual_seed(SEED))
        os.makedirs(os.path.join(run, cfg.name))
        torch.save(model.generator_ema.state_dict(),
                   os.path.join(run, cfg.name, "latest_net_G_ema.pth"))
        ranks, seconds = spawn(args, serve_rank, mesh[0] * mesh[1], args, argv)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    model.generator_ema.to(device)
    one, volume = timed_serving(make_forward_fn(model, device, seed=SEED, norm_range=RANGE),
                                args)
    got = ranks[0]
    print(json.dumps({"check": "serve_rate", "mesh": list(mesh), "dtype": dtype,
                      "batch": SERVE_BATCH, "subjects": args.subjects,
                      "slices_per_subject": 96,
                      "slices_per_s": {"one_card": one, "mesh": got["rates"]},
                      "median": {"one_card": float(np.median(one)),
                                 "mesh": float(np.median(got["rates"]))},
                      "max_abs_diff_vs_one_card": float(np.abs(got["volume"] - volume).max()),
                      "census": got["census"], "spawn_s": seconds}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", nargs="+", default=["1,2", "2,2", "1,4"],
                    help="meshes D,M to train over")
    ap.add_argument("--serve-mesh", default="1,4", help="the mesh D,M to serve over ('' skips)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true", help="the demo config at 64^2")
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=16, help="the loop's global batch")
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--subjects", type=int, default=2, help="subjects a serving window")
    ap.add_argument("--timeout", type=float, default=1200, help="seconds a spawn may take")
    args = ap.parse_args(argv)
    args.size = 64 if args.tiny else 256
    args.backend = "nccl" if args.device == "cuda" else "gloo"
    meshes = [tuple(int(v) for v in m.split(",")) for m in args.mesh]
    largest = max(d * m for d, m in meshes)
    if args.device == "cuda":
        if torch.cuda.device_count() < largest:
            raise SystemExit(f"{largest} cards asked for, {torch.cuda.device_count()} seen")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    else:
        torch.set_num_threads(1)

    for dtype in args.dtypes:
        # the train CLI's policy, which spawned ranks inherit: the cap at
        # float32 on a card, the default planning otherwise
        for name in CAP_VARIABLES:
            os.environ.pop(name, None)
        train_cli.bound_conv_workspace(args.device, dtype)
        one = None
        for mesh in [(1, 1), *meshes]:
            ranks, seconds = spawn(args, rank_main, mesh[0] * mesh[1], args, mesh, dtype)
            if "step" in ranks[0]:
                if one is None:
                    one = ranks[0]["step"]
                got = ranks[0]["step"]
                loss_rel = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
                            for k, v in one["metrics"].items()}
                grad_rel = grad_errors(got["grads"], one["grads"])
                print(json.dumps({
                    "check": "step", "mesh": list(mesh), "global_batch": STEP_BATCH,
                    "compute_dtype": "float32", "tf32": False, "backend": args.backend,
                    "loss_rel_err": loss_rel, "grad_rel_l2_err": grad_rel,
                    "census_per_step": got["census"],
                    "launches_per_rank": [r["step"]["launches"] for r in ranks],
                    "step_ms_per_rank": [r["step"]["ms"] for r in ranks],
                    "peak_gib_per_rank": [r["step"].get("peak_bytes", 0) / 2 ** 30
                                          for r in ranks]}), flush=True)
                if max(loss_rel.values()) > 1e-3 or max(grad_rel.values()) > 1e-3:
                    raise SystemExit(f"mesh {mesh}'s step is off one process's: "
                                     f"{loss_rel} {grad_rel}")
            print(json.dumps({"check": "loop", "mesh": list(mesh), "compute_dtype": dtype,
                              "global_batch": args.batch,
                              "workspace_cap": os.environ.get("CUDNN_CONV_WSCAP_DBG"),
                              "ms_per_step": ranks[0]["loop"]["ms_per_step"],
                              "windows_ms": ranks[0]["loop"]["windows_ms"],
                              "peak_gib_per_rank": [r["loop"]["peak_mem_gib"] for r in ranks],
                              "spawn_s": seconds}), flush=True)
    for name in CAP_VARIABLES:
        os.environ.pop(name, None)
    if args.serve_mesh:
        measure_serving(args, tuple(int(v) for v in args.serve_mesh.split(",")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
