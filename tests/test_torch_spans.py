"""The port's phase spans (``utils/profiling.span``) on the CPU.

Under ``torch.profiler.profile`` the tiny serve path
(``configs/demo/cmsr_tiny.yml``) and the tiny GAN train loop put each phase
of the serve loop and of the train step in the chrome trace as a
``record_function`` span named ``afcm.serve.*`` / ``afcm.train.*``, a
batch's as ``#s<subject>.b<batch>`` and a step's as ``#<step>``; with no
profiler running no span enters ``record_function``; the predictor's
``timings`` and its spans come from one context per phase.
"""

import gzip
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from afcm_tpu_torch import train as train_cli  # noqa: E402
from afcm_tpu_torch.config import default_argument_parser  # noqa: E402
from afcm_tpu_torch.data.demo import (phantom_test_loader,  # noqa: E402
                                      phantom_train_loaders)
from afcm_tpu_torch.evaluate import make_forward_fn  # noqa: E402
from afcm_tpu_torch.infer import predictor as predictor_module  # noqa: E402
from afcm_tpu_torch.infer.predictor import StandardPredictor  # noqa: E402
from afcm_tpu_torch.models import build_eval_model  # noqa: E402
from afcm_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/demo/cmsr_tiny.yml")
DEPTH, BATCH = 6, 4                 # two batches a subject, the second ragged
STEP_PHASES = ["afcm.train.h2d", "afcm.train.d_fake", "afcm.train.d_loss",
               "afcm.train.r1", "afcm.train.D.backward", "afcm.train.D.update",
               "afcm.train.g_fake", "afcm.train.g_loss", "afcm.train.G.backward",
               "afcm.train.G.update", "afcm.train.ema", "afcm.train.metrics"]


def _spans(path, prefix="afcm."):
    """The trace's ``record_function`` spans under ``prefix`` as
    (name, start, end, thread), in order of start."""
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return inner[3] == outer[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def tiny_forward():
    cfg = default_argument_parser(["--config-file", CONFIG])
    model = build_eval_model(dict(cfg.model.G), generator=torch.Generator().manual_seed(0))
    norm_range = phantom_test_loader(DEPTH, 64, BATCH).norm_range
    return make_forward_fn(model, "cpu", seed=0, norm_range=norm_range)


def _serve_two_subjects(forward, out_dir):
    predictor = StandardPredictor(forward, str(out_dir), None, patch_halo=(0, 8, 8))
    loaders = [phantom_test_loader(DEPTH, 64, BATCH, seed=k) for k in range(2)]
    for _ in predictor.run_pipelined(loaders, depth=1):
        pass
    predictor.wait_for_writes()
    return predictor


def test_no_span_enters_record_function_without_a_profiler(tiny_forward, tmp_path,
                                                           monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.profiler_on()
    with profiling.span("afcm.test", 3), profiling.span("afcm.test"):
        pass
    assert profiling.span("afcm.a") is profiling.span("afcm.b", 1)     # one null context
    predictor = _serve_two_subjects(tiny_forward, tmp_path / "serve")
    assert predictor.last_prediction.shape == (DEPTH, 64, 64)
    cfg = default_argument_parser(["--config-file", CONFIG,
                                   "checkpoints_dir", str(tmp_path / "ckpt")])
    seen = []
    train_cli.train(cfg, max_iters=2, loaders=phantom_train_loaders(4, 64, 2),
                    device="cpu", on_step=lambda step, m: seen.append(step))
    assert seen == [1]


def test_serve_path_emits_every_span_nested_with_identifiers(tiny_forward, tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        _serve_two_subjects(tiny_forward, tmp_path / "serve")
    spans = _spans(tmp_path / "trace" / "trace.json.gz")
    names = [s[0] for s in spans]
    batches = ["s0.b0", "s0.b1", "s1.b0", "s1.b1"]
    for phase in ("dispatch", "fetch", "stitch"):
        assert sorted(n for n in names if n.startswith(f"afcm.serve.{phase}#")) == \
            [f"afcm.serve.{phase}#{b}" for b in batches]
    assert sorted(n for n in names if n.startswith("afcm.serve.finalize")) == \
        ["afcm.serve.finalize#s0", "afcm.serve.finalize#s1"]
    # one load a batch, one a subject's end and one that finds the stream done
    assert names.count("afcm.serve.load") == len(batches) + 2 + 1
    assert names.count("afcm.serve.h2d") == names.count("afcm.serve.g_ema") == 4
    dispatches = [s for s in spans if s[0].startswith("afcm.serve.dispatch#")]
    for leg in ("afcm.serve.h2d", "afcm.serve.g_ema"):
        legs = [s for s in spans if s[0] == leg]
        for d in dispatches:
            assert sum(_inside(s, d) for s in legs) == 1, (leg, d)
    h2d = [s for s in spans if s[0] == "afcm.serve.h2d"]
    g_ema = [s for s in spans if s[0] == "afcm.serve.g_ema"]
    assert all(a[2] <= b[1] for a, b in zip(h2d, g_ema))             # copies, then G_ema
    # a copy of FIR taps to the device (a cold weight cache) lies in G_ema's forward
    uploads = [s for s in spans if s[0] == "afcm.fir.upload"]
    assert all(any(_inside(u, g) for g in g_ema) for u in uploads)
    # the other phases hold no span of the port and lie in no other phase
    top = [s for s in spans if s[0].split("#")[0] not in ("afcm.serve.h2d",
                                                           "afcm.serve.g_ema",
                                                           "afcm.fir.upload")]
    for a, b in zip(top, top[1:]):
        assert a[2] <= b[1], (a, b)
    # a batch is dispatched before it is fetched, fetched before it is stitched
    for b in batches:
        start = {p: next(s[1] for s in spans if s[0] == f"afcm.serve.{p}#{b}")
                 for p in ("dispatch", "fetch", "stitch")}
        assert start["dispatch"] < start["fetch"] < start["stitch"]


def test_predictor_timings_count_the_phases_of_its_spans(tiny_forward, tmp_path,
                                                         monkeypatch):
    """Each phase adds one tick of a clock that ticks once a read to its
    ``timings`` key: the keys and what they count are the spans'."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(predictor_module, "time",
                        SimpleNamespace(perf_counter=lambda: float(next(ticks))))
    with profiling.trace(str(tmp_path / "trace")):
        predictor = _serve_two_subjects(tiny_forward, tmp_path / "serve")
    names = [s[0].split("#")[0] for s in _spans(tmp_path / "trace" / "trace.json.gz")]
    phase_of = {"load": "load", "dispatch": "dispatch", "fetch": "fetch",
                "stitch": "stitch", "save": "finalize"}
    assert set(predictor.timings) == set(phase_of)
    for key, phase in phase_of.items():
        assert predictor.timings[key] == names.count(f"afcm.serve.{phase}") > 0, key


def test_predictor_timings_hold_their_spans(tiny_forward, tmp_path):
    """On the host's clock each phase's seconds hold its spans' time."""
    with profiling.trace(str(tmp_path / "trace")):
        predictor = _serve_two_subjects(tiny_forward, tmp_path / "serve")
    spans = _spans(tmp_path / "trace" / "trace.json.gz")
    phase_of = {"dispatch": "dispatch", "fetch": "fetch", "stitch": "stitch",
                "save": "finalize"}
    for key, phase in phase_of.items():
        own = [s for s in spans if s[0].split("#")[0] == f"afcm.serve.{phase}"]
        span_us = sum(s[2] - s[1] for s in own)
        # the two clocks may disagree by a few microseconds a reading
        assert 0 < span_us <= 1e6 * predictor.timings[key] + 20 * len(own), key


def test_train_step_emits_each_phase_once_a_step_in_order(tmp_path):
    cfg = default_argument_parser(["--config-file", CONFIG,
                                   "checkpoints_dir", str(tmp_path / "ckpt")])
    with profiling.trace(str(tmp_path / "trace")):
        train_cli.train(cfg, max_iters=4, loaders=phantom_train_loaders(4, 64, 2),
                        device="cpu")
    spans = _spans(tmp_path / "trace" / "trace.json.gz", "afcm.train.")
    steps = [s for s in spans if s[0].startswith("afcm.train.step")]
    assert [s[0] for s in steps] == ["afcm.train.step#1", "afcm.train.step#2"]
    for step in steps:
        inside = [s for s in spans if s is not step and _inside(s, step)]
        assert [s[0] for s in inside] == STEP_PHASES, step
        for a, b in zip(inside, inside[1:]):
            assert a[2] <= b[1], (a, b)                   # one after another


def test_span_names_carry_the_request_after_the_hash():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.profiler_on()
        with profiling.span("afcm.test", 41):
            with profiling.span("afcm.test.inner"):
                np.zeros(1)
    keys = {e.key for e in prof.key_averages()}
    assert {"afcm.test#41", "afcm.test.inner"} <= keys
    assert not profiling.profiler_on()
