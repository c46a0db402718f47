"""Profiling and timing helpers of the port (``afcm_tpu/utils/profiling.py``).

``span`` marks a phase of the serve loop or the train step in a profiler's
trace, ``trace`` captures a chrome trace of a block, ``host_sync`` waits for
the device, ``cuda_ms`` / ``cuda_median_ms`` time a kernel on the card with
CUDA events and ``time_windows`` several in turns (median and spread).
``hlo_dump`` of the JAX package has no counterpart: PyTorch runs eagerly and
has no compiled program to print.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

# time_windows' device sleep before a window, per call of the window: ~0.2 ms
# at the card's clock, longer than a wrapper's host dispatch
LEAD_CYCLES_PER_CALL = 400_000


_NO_SPAN = contextlib.nullcontext()


def profiler_on() -> bool:
    """Whether a ``torch.profiler`` is capturing in this process."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str, ident=None):
    """A phase span: ``torch.profiler.record_function`` while a profiler
    captures, so that the phase lands on the kernels' clock in the same
    trace; otherwise a shared null context, at the cost of one flag check
    (``record_function`` alone costs microseconds with no profiler).
    ``ident`` names the request (a batch, a step) and goes into the span's
    name after ``#``, built only while capturing: readers group spans by
    the part before ``#``."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    if ident is not None:
        name = f"{name}#{ident}"
    return torch.profiler.record_function(name)


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
