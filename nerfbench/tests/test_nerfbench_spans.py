"""The readers of the program's spans (``metrics/view.host_ms_per_chunk.py``,
``occupancy.sampler_host_ms.py``, ``train.draw_ms_per_step.py``,
``train.host_ms_per_step.py``) on a hand-filled tracer: the value of a made
set of spans, and None with no span, with no traced slice, or for a program
whose tracer keeps no spans."""

from types import SimpleNamespace

import pytest

from minimal_nerf_torch.utils import profiling
from nerfbench import spec

MS = 1_000_000  # nanoseconds


def span(name, start_ms, end_ms, n=1):
    return profiling.Span(name, int(start_ms * MS), int(end_ms * MS), 0, None, 0, n)


VIEW = [span("nerf.view.frame", 0, 10)] + [
    span("nerf.view.chunk", t, t + d) for t, d in ((0, 1.5), (2, 2.5), (5, 2.0))] + [
    span("nerf.occupancy.sample", 0.1, 0.4), span("nerf.occupancy.sample", 2.1, 2.3)]
TRAIN = [span("nerf.train.call", 0, 30, n=20), span("nerf.train.draw", 0, 4),
         span("nerf.train.call", 40, 46, n=1), span("nerf.train.draw", 40, 41),
         span("nerf.train.replay", 5, 6)]
# (metric, kind, spans, value)
CASES = [("view.host_ms_per_chunk", "view", VIEW, 2.0),
         ("view.host_ms_per_chunk.fast", "view", VIEW, 2.0),
         ("occupancy.sampler_host_ms.fast", "view", VIEW, 0.25),
         ("train.draw_ms_per_step", "train", TRAIN, 5 / 21),
         ("train.host_ms_per_step", "train", TRAIN, 36 / 21)]


def ctx(kind, traced=True):
    return SimpleNamespace(kind=kind, trace={"window_s": 1.0, "busy_s": 0.5} if traced else None)


@pytest.mark.parametrize("metric,kind,spans,value", CASES)
def test_reader_reduces_the_kept_spans(monkeypatch, metric, kind, spans, value):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    assert spec.metric_reader(metric)(ctx(kind)) == pytest.approx(value)


@pytest.mark.parametrize("metric,kind,spans,value", CASES)
def test_reader_reads_none_without_spans_or_trace(monkeypatch, metric, kind, spans, value):
    read = spec.metric_reader(metric)
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    assert read(ctx(kind, traced=False)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [s for s in spans if s.name.endswith(
        ("frame", "replay"))])
    assert read(ctx(kind)) is None
    monkeypatch.delattr(profiling, "spans")  # a program from before the tracer
    assert read(ctx(kind)) is None


@pytest.mark.parametrize("metric", [c[0] for c in CASES])
def test_span_metrics_are_entries_of_the_benchmark(metric):
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    assert entry["better"] == "lower"
