"""The traced tail of a run: ``torch.profiler`` over a few subjects or steps
after the measured window, and its reduction to the device's busy time,
the device time by kernel and the idle gaps labelled by the benchmark's own
host spans. The reduction is ``chip_smoke.py:busy_us`` and
``summarize_trace`` at commit 9498692: the union of the kernel, memcpy and
memset intervals over the traced span, all on the trace's one clock."""

from __future__ import annotations

import contextlib
import gzip
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

TAIL_SPAN = "portbench.tail"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """The benchmark's host spans (``record_function``), on only while the
    tail is traced, so the measured window runs without them."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, stop) intervals as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            if stop > out[-1][1]:
                out[-1] = (out[-1][0], stop)
        else:
            out.append((start, stop))
    return out


def busy(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, stop) intervals."""
    return sum(b - a for a, b in union(intervals))


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cursor = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < hi:
        out.append((cursor, hi))
    return out


def idle_by_span(gap: Tuple[float, float], spans: List[dict]) -> Dict[str, float]:
    """An idle gap's time split by the host spans that cover it (the
    benchmark's spans run one after another on the main thread); the rest
    is "other"."""
    out: Dict[str, float] = {}
    covered = 0.0
    for a, b, name in sorted((s["ts"], s["ts"] + s["dur"], s["name"]) for s in spans):
        overlap = min(gap[1], b) - max(gap[0], a)
        if overlap > 0:
            out[name] = out.get(name, 0.0) + overlap
            covered += overlap
    rest = (gap[1] - gap[0]) - covered
    if rest > 0:
        out["other"] = out.get("other", 0.0) + rest
    return out


def summarize(events: List[dict], span_prefix: str = "portbench.") -> Dict:
    """The reduction of a chrome trace's complete events (``ph == "X"``):
    the traced window is the tail span; device busy seconds, the device
    time by kernel name, and the idle seconds by the host span that covers
    them (summed per span name, largest first)."""
    tail = next((e for e in events if e["name"] == TAIL_SPAN
                 and e.get("cat") == "user_annotation"), None)
    if tail is None:
        raise AssertionError(f"the trace holds no host span {TAIL_SPAN}")
    lo, hi = tail["ts"], tail["ts"] + tail["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    busy_us = busy(clip(intervals, lo, hi))
    by_name: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        calls[e["name"]] = calls.get(e["name"], 0) + 1
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(span_prefix) and e["name"] != TAIL_SPAN]
    idle: Dict[str, float] = {}
    for gap in gaps(intervals, lo, hi):
        for label, us in idle_by_span(gap, spans).items():
            idle[label] = idle.get(label, 0.0) + us
    return {
        "window_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
        "kernels": {name: {"s": us / 1e6, "calls": calls[name]}
                    for name, us in by_name.items()},
        "device_ops": [[name, us / 1e6] for name, us in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[name, us / 1e6] for name, us in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def read_trace(path: str) -> List[dict]:
    with gzip.open(path, "rt") as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


@contextlib.contextmanager
def traced(out_path: str, spans: Spans, result: Dict):
    """Profile the body (CPU and CUDA activity) inside the tail span with
    the benchmark's spans on, write the gzipped chrome trace to
    ``out_path`` and put its summary in ``result["trace"]``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    spans.on = True
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(TAIL_SPAN):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    spans.on = False
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    prof.export_chrome_trace(out_path)
    result["trace"] = summarize(read_trace(out_path))


def kernel_seconds(trace: Optional[Dict], pattern: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose names hold
    ``pattern``."""
    if not trace:
        return 0.0, 0
    hits = [v for name, v in trace["kernels"].items() if pattern in name]
    return sum(v["s"] for v in hits), sum(v["calls"] for v in hits)
