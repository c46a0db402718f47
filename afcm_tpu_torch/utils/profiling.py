"""Profiling and timing helpers of the port (``afcm_tpu/utils/profiling.py``).

``profiled_function`` / ``named_scope`` put a ``torch.profiler.
record_function`` span around a call, ``trace`` captures a chrome trace of a
block, ``host_sync`` / ``StepTimer`` / ``bench_rates`` time on the host clock
around a device synchronize (the same median-of-windows rule as the JAX
package), ``cuda_ms`` / ``cuda_median_ms`` time a kernel on the card with
CUDA events and ``time_windows`` several in turns (median and spread).
``hlo_dump`` of the JAX package has no counterpart: PyTorch runs eagerly and
has no compiled program to print.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

# time_windows' device sleep before a window, per call of the window: ~0.2 ms
# at the card's clock, longer than a wrapper's host dispatch
LEAD_CYCLES_PER_CALL = 400_000


def profiled_function(fn):
    """Wrap a function in a profiler span carrying its name."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(fn.__name__):
            return fn(*args, **kwargs)
    return wrapper


named_scope = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: str = "profile_out"):
    """Capture a ``torch.profiler`` trace around a block and write it as
    ``<log_dir>/trace.json.gz`` (chrome://tracing or Perfetto). Yields the
    profiler, whose ``key_averages()`` sums the device time by kernel."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json.gz"))


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            found = _first_tensor(item)
            if found is not None:
                return found
    return getattr(x, "tensor", None)      # evaluate.DeviceResult


def host_sync(x=None) -> None:
    """Wait until the device has finished the work that produced ``x`` (a
    tensor or a nest of tensors; None waits for the current device).
    ``torch.cuda.synchronize`` is a true barrier, so no scalar is fetched as
    the JAX package does for its remote backend; a CPU tensor needs no
    wait."""
    leaf = _first_tensor(x)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    elif leaf is None and torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Host-clock step timing, stopped after a device synchronize."""

    def __init__(self):
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        host_sync(result)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return dt


def bench_rates(fn, args, iters: int = 20, repeats: int = 3):
    """Median items/sec over ``repeats`` timing windows of ``iters`` calls,
    each window closed by ``host_sync``. Returns (median_rate, last_output);
    the rate counts ``args[1].shape[0]`` items per call when there is such a
    batch dimension, else calls per second."""
    out = fn(*args)
    host_sync(out)
    batch = getattr(args[1], "shape", [1])[0] if len(args) > 1 else 1
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        host_sync(out)
        rates.append(batch / ((time.perf_counter() - t0) / iters))
    return float(np.median(rates)), out


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_median_ms(fn, repeats: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms over ``repeats`` single timed calls."""
    for _ in range(warmup):
        fn()
    return float(np.median([cuda_ms(fn, iters=1, warmup=0) for _ in range(repeats)]))


def time_ms(fn, device, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of fn() in ms: CUDA events on the card, the host clock on
    the CPU (where it times the CPU's own kernels, never a device metric)."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, iters=iters, warmup=warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def time_windows(fns, device, windows: int = 5, iters: int = 10, warmup: int = 2):
    """Median and spread of each of ``fns`` (name -> callable) in ms: every
    fn is warmed, then timed over ``windows`` windows of ``iters`` calls,
    the fns taking turns in alternating order (a b c, c b a, ...) so that a
    drifting clock falls on all of them. On the card a window is CUDA
    events around its calls, recorded behind a device sleep of ~0.2 ms a
    call during which the host enqueues all of them: the window times the
    device, not the calls' dispatch (a wrapper in Python takes tens of
    microseconds a call to enqueue, more than a short kernel runs).
    Returns {name: {"ms": median, "lo": fastest window, "hi": slowest
    window}}."""
    on_card = torch.device(device).type == "cuda"

    def window(fn):
        if not on_card:
            return time_ms(fn, device, iters, warmup=0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(iters * LEAD_CYCLES_PER_CALL)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    for fn in fns.values():
        for _ in range(warmup):
            fn()
    names, got = list(fns), {name: [] for name in fns}
    for w in range(windows):
        for name in (names if w % 2 == 0 else names[::-1]):
            got[name].append(window(fns[name]))
    return {name: {"ms": float(np.median(t)), "lo": min(t), "hi": max(t)}
            for name, t in got.items()}


def device_banner(device) -> str:
    """The first line of every probe's table: the card's name and power
    limit as nvidia-smi gives them, or the CPU."""
    import subprocess
    device = torch.device(device)
    if device.type != "cuda":
        return f"device: cpu (plain PyTorch versions; times are no device metric), torch {torch.__version__}"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else torch.cuda.get_device_name(device) + ", power limit not read"
    return f"device: {limit}; torch {torch.__version__}, CUDA {torch.version.cuda}"
