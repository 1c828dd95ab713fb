"""The port's tracer (``minimal_nerf_torch/utils/profiling.py``): spans off
and on, their nesting in a train step and a view sweep, their clock against
the profiler's Chrome trace, the launch counters and the replays' share.

This file imports neither JAX nor the JAX package; its ``cuda`` tests run on
a card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""

import contextlib
import json
import tempfile
import time

import pytest
import torch

from minimal_nerf_torch import views
from minimal_nerf_torch.data.procedural import make_procedural_scene
from minimal_nerf_torch.kernels import fused_raymarch, occupancy_probe, occupancy_sampler
from minimal_nerf_torch.kernels import raymarch
from minimal_nerf_torch.kernels.fused_raymarch import make_fused_render_fn
from minimal_nerf_torch.models.nerf import NeRFConfig, init_nerf_network
from minimal_nerf_torch.ops import occupancy as occ
from minimal_nerf_torch.training import loop
from minimal_nerf_torch.training.config import TrainConfig
from minimal_nerf_torch.utils import profiling

CFG = NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
# how far a kept span's start or end may lie inside its annotation's, in us;
# how far outside (the trace's rounding); sessions tried for one within
CLOCK_US, CLOCK_SLACK_US, CLOCK_SESSIONS = 100.0, 10.0, 3


@pytest.fixture(autouse=True)
def _clean_tracer():
    profiling.reset()
    yield
    profiling.reset()


def _raise(*args, **kwargs):
    raise AssertionError("called while the tracer is off")


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _tiny(occupancy: bool = False):
    """A 3-frame 10x10 procedural scene, 32 rays, 8 + 8 samples, fp32; with
    ``occupancy`` a G=8 grid updated every step (warmup over at step 1)."""
    scene = make_procedural_scene((("train", 3),), height=10, width=10, gt_samples=16,
                                  scene="object", device="cpu")[0]["train"]
    kw = dict(occupancy=True, occ_resolution=8, occ_update_every=1,
              occ_warmup_steps=1) if occupancy else {}
    tcfg = TrainConfig(num_rays=32, precision="fp32", cropping_epochs=0, **kw)
    params = init_nerf_network(torch.Generator().manual_seed(0), CFG, device="cpu")
    return scene, tcfg, params


def test_span_off_reads_no_clock_and_never_annotates(monkeypatch):
    """Off (no profiler, no ``tracing()``), ``span`` hands out one shared
    no-op context: no clock read, no ``record_function``, nothing kept."""
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _raise)
        m.setattr(time, "time_ns", _raise)
        first = profiling.span("nerf.a", 3)
        with first:
            with profiling.span("nerf.b", n=20):
                pass
        same = profiling.span("nerf.c") is first
    assert same and profiling.spans() == [] and profiling.dropped() == 0


def test_tracing_without_a_profiler_keeps_spans_unannotated(monkeypatch):
    """Inside ``tracing()`` spans are kept; with no profiler recording they
    enter no ``record_function``."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    with profiling.tracing():
        with profiling.span("nerf.outer", 7, n=2):
            with profiling.span("nerf.inner"):
                pass
    with profiling.span("nerf.after"):  # off again
        pass
    inner, outer = profiling.spans()
    assert (outer.name, outer.unit, outer.n, outer.parent) == ("nerf.outer", 7, 2, None)
    assert (inner.name, inner.unit, inner.n, inner.parent) == ("nerf.inner", 7, 1, outer.id)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.tracing():
        for i in range(5):
            with profiling.span("nerf.s", i):
                pass
    assert [s.unit for s in profiling.spans()] == [0, 1, 2] and profiling.dropped() == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("occupancy", [False, True])
def test_train_step_spans_nest_under_the_call(occupancy):
    """The eager ``make_train_step``: one ``nerf.train.call`` of the step
    holding its draw, grid update (occupancy) and body, the body holding the
    render passes and the coarse pass the sampler hook; every span carries
    the step."""
    scene, tcfg, params = _tiny(occupancy)
    occ_cfg = tcfg.occupancy_config
    step_fn = loop.make_train_step(CFG, tcfg, loop.scene_static(scene), make_fused_render_fn(),
                                   "cpu", None, occ_cfg)
    args = (params, loop.adam_init(params)) + ((occ.init_grid(occ_cfg, "cpu"),) if occupancy
                                               else ())
    with profiling.tracing():
        step_fn(*args, scene.images, scene.poses, 4, 0)
    spans = profiling.spans()
    named = _by_name(spans)
    call, = named["nerf.train.call"]
    body, = named["nerf.train.body"]
    want = {"nerf.train.call", "nerf.train.draw", "nerf.train.body", "nerf.render.coarse_pass",
            "nerf.render.union", "nerf.render.fine_pass"}
    if occupancy:
        want |= {"nerf.train.grid_update", "nerf.occupancy.sample"}
    assert set(named) == want and all(len(v) == 1 for v in named.values())
    assert (call.parent, call.unit, call.n) == (None, 4, 1)
    assert all(s.unit == 4 for s in spans)
    for name in ("nerf.train.draw", "nerf.train.body") + (
            ("nerf.train.grid_update",) if occupancy else ()):
        assert named[name][0].parent == call.id
    for name in ("nerf.render.coarse_pass", "nerf.render.union", "nerf.render.fine_pass"):
        assert named[name][0].parent == body.id
    if occupancy:
        assert named["nerf.occupancy.sample"][0].parent == named["nerf.render.coarse_pass"][0].id


def test_multi_step_spans_on_the_cpu():
    """``make_multi_step`` on the CPU: one call of ``n`` steps, its draw, and
    per step its grid update and body, each of its own step."""
    scene, tcfg, params = _tiny(occupancy=True)
    occ_cfg = tcfg.occupancy_config
    multi = loop.make_multi_step(CFG, tcfg, loop.scene_static(scene), 3, make_fused_render_fn(),
                                 "cpu", None, occ_cfg)
    with profiling.tracing():
        multi(params, loop.adam_init(params), occ.init_grid(occ_cfg, "cpu"), scene.images,
              scene.poses, 10, 0)
    named = _by_name(profiling.spans())
    call, = named["nerf.train.call"]
    assert (call.unit, call.n) == (10, 3) and named["nerf.train.draw"][0].parent == call.id
    for name in ("nerf.train.body", "nerf.train.grid_update"):
        assert [(s.unit, s.parent) for s in named[name]] == [(10, call.id), (11, call.id),
                                                              (12, call.id)]
    assert [s.unit for s in named["nerf.occupancy.sample"]] == [10, 11, 12]


def test_view_sweep_spans_carry_the_frame():
    """A sweep of two 4x4 frames in chunks of 8 rays: one ``nerf.view.frame``
    per frame (unit: its index), two ``nerf.view.chunk`` under it, the
    render passes and the sampler hook under each chunk, all of the
    frame's unit."""
    scene, tcfg, params = _tiny()
    occ_cfg = occ.OccupancyConfig(resolution=8)
    words = occ.pack_occupancy(occ.init_grid(occ_cfg, "cpu"), occ_cfg, force_all=True)
    chunk = views.make_fine_render_chunk(params, CFG, render_fn=make_fused_render_fn(),
                                         coarse_sampler=occ.make_occupancy_sampler(words,
                                                                                   occ_cfg))
    with profiling.tracing():
        frames = list(views.render_poses_batched(chunk, scene.poses[:2], 4, 4, scene.focal,
                                                 chunk=8, frames_per_dispatch=1, device="cpu"))
    assert len(frames) == 2
    spans = profiling.spans()
    named = _by_name(spans)
    assert [s.unit for s in named["nerf.view.frame"]] == [0, 1]
    ids = {s.id: s for s in spans}
    assert len(named["nerf.view.chunk"]) == 4
    for c in named["nerf.view.chunk"]:
        assert ids[c.parent].name == "nerf.view.frame" and c.unit == ids[c.parent].unit
    for name in ("nerf.render.coarse_pass", "nerf.render.union", "nerf.render.fine_pass"):
        assert len(named[name]) == 4
        assert all(ids[s.parent].name == "nerf.view.chunk" for s in named[name])
    assert [s.unit for s in named["nerf.occupancy.sample"]] == [0, 0, 1, 1]


def _clock_offsets(activities, device):
    """Spans inside a ``torch.profiler`` session against the Chrome trace's
    ``user_annotation`` events of their names: for each kept span, how far
    its start lies after its event's (``ts + baseTimeNanoseconds``) and its
    end before its event's end, in microseconds, the first span (the
    session's warm-up) left out."""
    from torch.profiler import profile

    profiling.reset()
    x = torch.ones(4096, device=device)
    with profile(activities=activities) as prof:
        with profiling.span("nerf.test.warmup"):
            pass
        for i in range(10):
            with profiling.span("nerf.test.outer", i):
                with profiling.span("nerf.test.inner"):
                    x = x * 1.0001
    with profiling.span("nerf.test.after"):  # off once the session ends
        pass
    kept = [s for s in profiling.spans() if s.name != "nerf.test.warmup"]
    assert len(kept) == 20
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    events = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("nerf.test."):
            events.setdefault(e["name"], []).append(e)
    offsets = []
    for name, spans in _by_name(kept).items():
        marks = sorted(events.get(name, []), key=lambda e: float(e["ts"]))
        assert len(marks) == len(spans), name
        for s, e in zip(sorted(spans, key=lambda s: s.start_ns), marks):
            ts = float(e["ts"]) + base_us
            offsets += [s.start_ns / 1e3 - ts, ts + float(e["dur"]) - s.end_ns / 1e3]
    return offsets


def _worst_clock_offsets(activities, device):
    """The largest offset of each session, up to CLOCK_SESSIONS of them,
    stopping at the first within CLOCK_US. In every session each kept span
    lies inside its annotation (its marks are read inside
    ``record_function``), to within CLOCK_SLACK_US of the trace's rounding.
    A host stall between a mark and the profiler's own stamp lengthens one
    annotation by itself (on an H100 host up to 443 us in 1 of 600 marks);
    a clock other than the trace's would move every mark of every
    session."""
    worst = []
    for _ in range(CLOCK_SESSIONS):
        offsets = _clock_offsets(activities, device)
        assert min(offsets) >= -CLOCK_SLACK_US
        worst.append(max(offsets))
        if worst[-1] <= CLOCK_US:
            break
    return worst


def test_spans_share_the_profiler_trace_clock():
    """While a CPU profiler records, each span is a ``user_annotation`` in
    the Chrome trace, and its kept start and end lie within CLOCK_US of the
    event's ``ts + baseTimeNanoseconds`` and end."""
    from torch.profiler import ProfilerActivity

    assert min(_worst_clock_offsets([ProfilerActivity.CPU], "cpu")) <= CLOCK_US


@pytest.mark.cuda
def test_spans_share_the_profiler_trace_clock_on_the_card():
    """The same on a card, with CUDA activity recorded beside the host's."""
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    worst = _worst_clock_offsets([ProfilerActivity.CPU, ProfilerActivity.CUDA], "cuda")
    print(f"largest offset of a span from its annotation, per session: {worst} us")
    assert min(worst) <= CLOCK_US


def test_counters_and_reset():
    """Counters are always on; ``reset()`` clears them with the spans. The
    wrappers count under their modules' names and keep no count of their
    own."""
    names = (fused_raymarch.FWD_LAUNCHES, fused_raymarch.BWD_LAUNCHES,
             fused_raymarch.WGRAD_LAUNCHES, raymarch.FWD_LAUNCHES, raymarch.BWD_LAUNCHES,
             occupancy_probe.LAUNCHES, occupancy_sampler.LAUNCHES)
    assert len(set(names)) == len(names) and all(n.endswith(".launches") for n in names)
    for module in (fused_raymarch, raymarch, occupancy_probe, occupancy_sampler):
        assert not any(hasattr(module, a) for a in ("launches", "bwd_launches",
                                                    "wgrad_launches"))
    profiling.count(names[0])
    profiling.count(names[0], 2)
    profiling.count(names[-1])
    with profiling.tracing(), profiling.span("nerf.s"):
        pass
    assert profiling.counters() == {names[0]: 3, names[-1]: 1}
    assert profiling.counter(names[0]) == 3 and profiling.counter(names[1]) == 0
    profiling.reset()
    assert profiling.counters() == {} and profiling.spans() == []


class _FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: the capture runs the body once,
    a replay runs nothing."""

    def replay(self):
        pass


def test_replays_add_the_launches_their_capture_counted(monkeypatch):
    """``_StepGraph`` (with a graph that replays nothing, so that it runs on
    the CPU): a first call of 20 steps is one eager step, the capture and
    19 replays, each replay adding the launches the capture counted; a
    second call is 20 replays. Spans: the eager body, the capture, one
    replay per replayed step."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())

    def body(params, opt_state, grid, images, poses, inp):
        profiling.count("k.launches", 2)
        profiling.count("j.launches")
        return params, opt_state, {"loss": inp["adam"].sum()}

    graph = loop._StepGraph(lambda params, grid, step, seed: None, body)
    z = lambda *shape: torch.zeros(shape)  # noqa: E731
    params, images, poses = {"w": z(2)}, z(1), z(1)
    opt = {"mu": {"w": z(2)}, "nu": {"w": z(2)}}
    inp = {"frame": z(1), "force_all": z(), "adam": z(5), "xs": z(4), "ys": z(4),
           "uniforms": {"coarse": z(4, 2), "eps": z(4, 1)}}
    with profiling.tracing():
        graph.run(params, opt, None, images, poses, list(range(20)), [inp] * 20, 0)
        assert profiling.counters() == {"k.launches": 2 * 21, "j.launches": 21,
                                        "graph.replays": 19}
        graph.run(params, opt, None, images, poses, list(range(20, 40)), [inp] * 20, 0)
    assert profiling.counters() == {"k.launches": 2 * 41, "j.launches": 41, "graph.replays": 39}
    named = _by_name(profiling.spans())
    assert [s.unit for s in named["nerf.train.body"]] == [0]
    assert [s.unit for s in named["nerf.train.capture"]] == [0]
    assert [s.unit for s in named["nerf.train.replay"]] == list(range(1, 40))
