"""The reduction of the port's phase spans (``harness/spans.py``) and the
metrics that read it, on synthetic chrome-trace events."""

import gzip
import json
import os

import pytest

from portbench.harness import spans
from portbench.harness.spec import metric_reader

SERVE = ["idle_outside_spans.serve", "idle_in_dispatch.serve", "dispatch_wait_ms.serve",
         "launches_per_batch.serve", "host_us_per_launch.serve"]
TRAIN = ["idle_outside_spans.train", "idle_in_update.train", "h2d_wait_ms.train",
         "launches_per_step.train"]


def ev(name, ts, dur, cat, tid=1, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur, tid=1):
    return ev(name, ts, dur, "user_annotation", tid)


def kernel(ts, dur, corr=None):
    return ev("k", ts, dur, "kernel", tid=7, corr=corr)


def serve_events():
    """A 1000 us tail: kernels over [0, 100) and [500, 1000); one batch's
    dispatch [100, 400) holding the benchmark's forward [150, 350) and the
    port's G_ema [200, 300); a span of another thread over the gap."""
    return [span("portbench.tail", 0, 1000),
            kernel(0, 100, corr=1), kernel(500, 500, corr=2),
            span("afcm.serve.dispatch#s0.b0", 100, 300),
            span("portbench.forward", 150, 200),
            span("afcm.serve.h2d", 160, 30),
            span("afcm.serve.g_ema", 200, 100),
            span("afcm.serve.load", 420, 20, tid=2),
            ev("cudaStreamSynchronize", 165, 20, "cuda_runtime"),
            ev("cudaLaunchKernel", 50, 2, "cuda_runtime", corr=1),
            ev("cudaLaunchKernel", 210, 2, "cuda_runtime", corr=2),
            ev("cuLaunchKernel", 220, 2, "cuda_driver", corr=3),
            ev("cudaLaunchKernel", 230, 2, "cuda_runtime", tid=3, corr=4),
            ev("cudaEventSynchronize", 250, 10, "cuda_runtime"),
            ev("cudaEventSynchronize", 260, 40, "cuda_runtime", tid=3)]


def test_idle_goes_to_the_innermost_span():
    tail = spans.Tail(serve_events())
    idle = tail.idle_by_innermost()
    # idle [100, 500): dispatch [100, 150) and [350, 400), the forward
    # [150, 160), [190, 200) and [300, 350), the copies [160, 190), G_ema
    # [200, 300), outside [400, 500) (the other thread's span is not the tail's)
    assert idle == pytest.approx({"afcm.serve.dispatch": 100e-6, "portbench.forward": 70e-6,
                                  "afcm.serve.h2d": 30e-6, "afcm.serve.g_ema": 100e-6,
                                  "outside": 100e-6})
    assert tail.idle_share(None) == pytest.approx(10.0)
    assert tail.idle_share(["afcm.serve.dispatch"]) == pytest.approx(30.0)
    assert tail.idle_share(["portbench.forward"]) == pytest.approx(20.0)
    assert tail.idle_share(["afcm.serve.h2d"]) == pytest.approx(3.0)


def test_launches_on_another_thread_count_inside_the_main_threads_span():
    tail = spans.Tail(serve_events())
    assert tail.launches(["afcm.serve.g_ema"]) == 3          # cudaLaunchKernel, cuLaunchKernel, thread 3
    assert tail.launches(["afcm.serve.dispatch"]) == 3
    assert tail.launches(["afcm.serve.h2d"]) == 0
    assert len(tail.launch_ts) == 4 and tail.kernels == 2 and tail.kernels_launched == 2


def test_blocking_calls_count_on_the_main_thread_and_the_hash_suffix_is_grouped():
    events = [span("portbench.tail", 0, 1000), kernel(0, 1000),
              span("afcm.train.step#1", 0, 400), span("afcm.train.h2d", 10, 100),
              span("afcm.train.step#2", 500, 400), span("afcm.train.h2d", 510, 100),
              ev("cudaMemcpyAsync", 20, 30, "cuda_runtime", corr=11),
              ev("Memcpy HtoD (Pageable -> Device)", 40, 5, "gpu_memcpy", tid=7, corr=11),
              ev("cudaMemcpyAsync", 60, 7, "cuda_runtime", corr=12),
              ev("Memcpy HtoD (Pinned -> Device)", 70, 5, "gpu_memcpy", tid=7, corr=12),
              ev("cudaStreamSynchronize", 520, 50, "cuda_runtime"),
              ev("cudaMemcpy", 580, 10, "cuda_runtime"),
              ev("cudaStreamSynchronize", 530, 70, "cuda_runtime", tid=3)]
    tail = spans.Tail(events)
    assert tail.blocked_us(["afcm.train.h2d"]) == 30 + 50 + 10
    assert len(tail.of(["afcm.train.step"])) == 2
    assert tail.blocked_us(["afcm.train.step"]) == 30 + 50 + 10
    assert tail.idle_share(None) == 0.0


def write_trace(tmp_path, cell, events):
    path = tmp_path / f"trace_{cell}.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return {"cell": cell, "config": {"checkpoints_dir": str(tmp_path / "checkpoints")},
            "trace": {"busy_s": 0.0, "window_s": 0.0}}


def test_the_trace_path_is_found_from_the_checkpoints_dir(tmp_path):
    ctx = write_trace(tmp_path, "cmsr-serve", serve_events())
    assert spans.trace_path(ctx) == os.path.join(str(tmp_path), "trace_cmsr-serve.json.gz")
    got = {name: metric_reader(name).read(ctx) for name in SERVE}
    assert got == pytest.approx({
        "idle_outside_spans.serve": 10.0, "idle_in_dispatch.serve": 30.0,
        "dispatch_wait_ms.serve": (20 + 10) / 1e3, "launches_per_batch.serve": 3,
        "host_us_per_launch.serve": (100 - 10) / 3})


def test_train_readers_on_a_traced_tail(tmp_path):
    events = [span("portbench.tail", 0, 1000), kernel(0, 100), kernel(600, 400),
              span("afcm.train.step#7", 0, 500), span("afcm.train.h2d", 0, 50),
              span("afcm.train.D.update", 100, 100), span("afcm.train.G.update", 200, 50),
              span("afcm.train.ema", 250, 100), span("portbench.on_step", 500, 20),
              ev("cudaStreamSynchronize", 10, 25, "cuda_runtime"),
              ev("cudaLaunchKernelExC", 120, 3, "cuda_runtime", tid=2),
              ev("cudaLaunchKernel", 300, 3, "cuda_runtime"),
              ev("cudaLaunchKernel", 550, 3, "cuda_runtime")]
    ctx = write_trace(tmp_path, "cmsr-train", events)
    got = {name: metric_reader(name).read(ctx) for name in TRAIN}
    # idle [100, 600): updates and EMA [100, 350), the step [350, 500),
    # on_step [500, 520), outside [520, 600)
    assert got == pytest.approx({"idle_outside_spans.train": 8.0,
                                 "idle_in_update.train": 25.0,
                                 "h2d_wait_ms.train": 0.025,
                                 "launches_per_step.train": 2})


def test_every_new_reader_returns_none_without_a_trace(tmp_path):
    no_trace = {"cell": "cmsr-serve", "trace": None, "config": {}}
    missing = {"cell": "cmsr-serve", "trace": None,
               "config": {"checkpoints_dir": str(tmp_path / "checkpoints")}}
    parent = write_trace(tmp_path, "ccsr-serve",
                         [e for e in serve_events() if not e["name"].startswith("afcm.")])
    parent_train = write_trace(tmp_path, "ccsr-train",
                               [span("portbench.tail", 0, 100), kernel(0, 50),
                                span("portbench.on_step", 60, 10)])
    for name in SERVE + TRAIN:
        read = metric_reader(name).read
        for ctx in (no_trace, missing, parent, parent_train, {}):
            assert read(ctx) is None, (name, ctx)


def test_a_traced_tiny_serve_run_reports_the_span_metrics(tmp_path):
    """The port's own spans in a traced run of the harness on the CPU: every
    serve metric but the launches' host time (the CPU launches no kernel)."""
    from portbench.tests.tiny import make_root, run_tiny
    line, _ = run_tiny(make_root(str(tmp_path)), "tiny-serve", trace=True)
    got = line["metrics"]
    assert set(SERVE) - set(got) == {"host_us_per_launch.serve"}
    assert got["launches_per_batch.serve"]["value"] == 0
    assert got["idle_outside_spans.serve"]["value"] < got["device_idle.serve"]["value"] / 10
