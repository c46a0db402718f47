"""The port's phase spans in the traced tail, on the kernels' clock.

While a profiler captures, the port opens a ``record_function`` span at each
phase of its serve loop and train step (``afcm_tpu_torch/utils/profiling.py``
``span``): ``afcm.serve.*`` and ``afcm.train.*``, a request's identifier
after ``#`` (``afcm.serve.dispatch#s3.b7``, ``afcm.train.step#41``). Spans
are grouped by the part of their name before ``#``. From the tail's chrome
trace (``harness/trace.py`` writes it beside the run's checkpoints) this
reads:

- **idle**: each microsecond of the tail in which no kernel, memcpy or
  memset ran on the card (``trace.union`` and ``trace.gaps``), given to the
  stack of ``afcm.`` and ``portbench.`` spans that cover it on the tail's
  thread; the innermost names the phase, an empty stack is "outside";
- **launches**: kernel launches through the CUDA runtime or driver API
  (``cudaLaunchKernel*``, ``cuLaunchKernel*``) on any thread whose start
  lies inside a span (autograd enqueues the backward's kernels from its own
  thread while the main thread waits in ``backward``);
- **blocking**: the tail thread's calls that wait on the card, a
  ``cuda*Synchronize`` or a copy that returns only when done (``cudaMemcpy``,
  or an async copy to or from pageable memory, which CUDA makes
  synchronous), counted by their start.

The trace is read once a run. ``python3 -m portbench.harness.spans
<trace.json.gz>`` prints the whole split.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .trace import DEVICE_CATEGORIES, TAIL_SPAN, gaps, read_trace

PREFIXES = ("afcm.", "portbench.")
PORT_PREFIX = "afcm."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
HOST_API = ("cuda_runtime", "cuda_driver")
OUTSIDE = ()


def group(name: str) -> str:
    """A span's name without its request identifier."""
    return name.split("#", 1)[0]


def trace_path(ctx) -> Optional[str]:
    """Where ``run.py`` puts the traced tail's chrome trace: beside the
    run's checkpoints directory, named after the cell."""
    config, cell = ctx.get("config") or {}, ctx.get("cell")
    checkpoints = config.get("checkpoints_dir")
    if not checkpoints or not cell:
        return None
    return os.path.join(os.path.dirname(checkpoints), f"trace_{cell}.json.gz")


def _blocks(event: dict, pageable: set) -> bool:
    name = event["name"]
    if "Synchronize" in name:
        return True
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "Async" not in name or _correlation(event) in pageable
    return False


def _correlation(event: dict):
    return (event.get("args") or {}).get("correlation")


class Tail:
    """The reduction of a traced tail's complete events (``ph == "X"``)."""

    def __init__(self, events: List[dict]):
        tail = next((e for e in events if e["name"] == TAIL_SPAN
                     and e.get("cat") == "user_annotation"), None)
        if tail is None:
            raise ValueError(f"the trace holds no host span {TAIL_SPAN}")
        self.lo, self.hi = tail["ts"], tail["ts"] + tail["dur"]
        thread = (tail.get("pid"), tail.get("tid"))

        def in_tail(e):
            return self.lo <= e["ts"] < self.hi

        def on_thread(e):
            return (e.get("pid"), e.get("tid")) == thread

        self.spans = sorted(
            ((e["ts"], e["ts"] + e["dur"], group(e["name"])) for e in events
             if e.get("cat") == "user_annotation" and e["name"] != TAIL_SPAN
             and e["name"].startswith(PREFIXES) and on_thread(e) and in_tail(e)),
            key=lambda s: (s[0], -s[1]))
        device = [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in DEVICE_CATEGORIES
                  and e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo]
        self.idle = self._idle_by_stack(gaps(device, self.lo, self.hi))
        host_api = [e for e in events if e.get("cat") in HOST_API and in_tail(e)]
        self.launch_ts = sorted(e["ts"] for e in host_api if e["name"].startswith(LAUNCHES))
        pageable = {_correlation(e) for e in events
                    if e.get("cat") == "gpu_memcpy" and "Pageable" in e["name"]}
        self.blocking = sorted((e["ts"], e["dur"]) for e in host_api
                               if on_thread(e) and _blocks(e, pageable))
        self._blocking_ts = [ts for ts, _ in self.blocking]
        kernels = [e for e in events if e.get("cat") == "kernel" and in_tail(e)]
        self.kernels = len(kernels)
        launched = {_correlation(e) for e in host_api if e["name"].startswith(LAUNCHES)}
        self.kernels_launched = sum(_correlation(k) in launched for k in kernels)
        by_kernel = {_correlation(k) for k in kernels}
        self.other_launchers = Counter(
            e["name"] for e in host_api
            if not e["name"].startswith(LAUNCHES) and _correlation(e) in by_kernel)

    def _idle_by_stack(self, idle_gaps) -> Dict[Tuple[str, ...], float]:
        """The idle microseconds by the stack of spans that covers them."""
        points = sorted({self.lo, self.hi}
                        | {min(max(p, self.lo), self.hi)
                           for s in self.spans for p in s[:2]})
        active: List[tuple] = []         # outermost first, as self.spans is sorted
        segments = []
        k = 0
        for a, b in zip(points, points[1:]):
            active = [s for s in active if s[1] > a]
            while k < len(self.spans) and self.spans[k][0] <= a:
                if self.spans[k][1] > a:
                    active.append(self.spans[k])
                k += 1
            segments.append((a, b, tuple(s[2] for s in active)))
        out: Dict[Tuple[str, ...], float] = {}
        i = 0
        for ga, gb in idle_gaps:
            while i < len(segments) and segments[i][1] <= ga:
                i += 1
            j = i
            while j < len(segments) and segments[j][0] < gb:
                a, b, stack = segments[j]
                overlap = min(b, gb) - max(a, ga)
                if overlap > 0:
                    out[stack] = out.get(stack, 0.0) + overlap
                j += 1
        return out

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def has_port_spans(self) -> bool:
        return any(s[2].startswith(PORT_PREFIX) for s in self.spans)

    def of(self, groups: Iterable[str]) -> List[Tuple[float, float]]:
        """The tail's spans of ``groups`` as (start, end)."""
        groups = set(groups)
        return [(a, b) for a, b, name in self.spans if name in groups]

    def idle_share(self, groups: Optional[Sequence[str]] = None) -> float:
        """% of the tail the card idled inside a span of ``groups`` (at any
        depth), or with ``None`` under no span at all."""
        if groups is None:
            us = self.idle.get(OUTSIDE, 0.0)
        else:
            us = sum(v for stack, v in self.idle.items() if set(stack) & set(groups))
        return 100.0 * us / self.window_us

    def launches(self, groups: Iterable[str]) -> int:
        return sum(bisect.bisect_left(self.launch_ts, b) - bisect.bisect_left(self.launch_ts, a)
                   for a, b in self.of(groups))

    def blocked_us(self, groups: Iterable[str]) -> float:
        total = 0.0
        for a, b in self.of(groups):
            lo = bisect.bisect_left(self._blocking_ts, a)
            hi = bisect.bisect_left(self._blocking_ts, b)
            total += sum(dur for _, dur in self.blocking[lo:hi])
        return total

    def host_us(self, groups: Iterable[str]) -> float:
        return sum(b - a for a, b in self.of(groups))

    def idle_by_innermost(self) -> Dict[str, float]:
        """The idle seconds by the innermost span covering them."""
        out: Dict[str, float] = {}
        for stack, us in self.idle.items():
            label = stack[-1] if stack else "outside"
            out[label] = out.get(label, 0.0) + us / 1e6
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def tail_of(ctx) -> Optional[Tail]:
    """The run's traced tail with the port's spans in it, read once a run
    (kept in ``ctx``); None where there is no trace or the program opened no
    span in it."""
    if "port_spans" not in ctx:
        path = trace_path(ctx)
        ctx["port_spans"] = (Tail(read_trace(path)) if path and os.path.exists(path)
                             else None)
    tail = ctx["port_spans"]
    return tail if tail is not None and tail.has_port_spans() else None


def per_request(ctx, request: str, value) -> Optional[float]:
    """``value(tail)`` over the tail's count of ``request`` spans (batches,
    steps); None where there are none."""
    tail = tail_of(ctx)
    if tail is None:
        return None
    n = len(tail.of([request]))
    return value(tail) / n if n else None


def summary(tail: Tail) -> dict:
    """The whole split of a tail: idle seconds by innermost span, and per
    span group its host seconds, launches and blocked seconds."""
    groups = sorted({name for _, _, name in tail.spans})
    return {
        "window_s": tail.window_us / 1e6,
        "idle_s": sum(tail.idle.values()) / 1e6,
        "idle_by_innermost_s": tail.idle_by_innermost(),
        "groups": {g: {"spans": len(tail.of([g])), "host_s": tail.host_us([g]) / 1e6,
                       "launches": tail.launches([g]), "blocked_s": tail.blocked_us([g]) / 1e6}
                   for g in groups},
        "launches": len(tail.launch_ts), "kernels": tail.kernels,
        "kernels_launched_in_tail": tail.kernels_launched,
        "other_launchers": dict(tail.other_launchers),
    }


if __name__ == "__main__":
    for path in sys.argv[1:]:
        print(json.dumps({"trace": path, **summary(Tail(read_trace(path)))}))
