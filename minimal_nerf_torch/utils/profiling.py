"""Tracing, launch counters, NaN hunting and step timing.

The port's counterpart of ``minimal_nerf_tpu/utils/profiling.py``, and its
one tracer:

- ``span(name, unit)``: a named span of the program's host path (the
  ``nerf.*`` spans at its layer boundaries: the train call and its draw,
  grid update, body, capture and replays; the view sweep's frame, chunk
  and graph capture; the occupancy sampler hook; the render passes). A span records
  its name, start and end, its id, its parent's id and its ``unit`` (the
  step, or the frame's index in its sweep; a child inherits its parent's),
  and ``n``, the units it covers (a call's steps). Spans are kept only
  while the tracer is on: while a ``torch.profiler`` session records, or
  inside ``tracing()``. Off, ``span`` is one flag check and a shared no-op
  context (no clock read, no allocation). While a profiler records, each
  span also enters ``torch.profiler.record_function(name)``, so that it
  shows in the trace as a ``user_annotation`` on the kernels' timeline.
  Starts and ends are ``time.time_ns()`` (CLOCK_REALTIME), the clock of the
  Chrome trace's ``ts`` plus its ``baseTimeNanoseconds``. Finished spans
  go to one bounded buffer in memory (``spans()``, ``dropped()``);
- ``count(name, n)``: always-on counters (``counters()``): the kernel
  wrappers' launches (``<kernel>.launches``; of the fused backward's, the
  bf16 ones on wgmma also ``fused_raymarch_bwd_sm90.launches``),
  ``graph.replays``, a
  replayed train step adding the launches its capture counted, and
  ``view.graph_replays``, a replayed view chunk adding them too (the view
  sweep takes its capture's counts back), both through ``CaptureCounts``;
  ``reset()`` clears the spans and the counters;
- ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block (host
  and, on a card, device activity) with the tracer on, written as one
  Chrome trace per run (``{logdir}/trace-{time}.json``, viewable in
  Perfetto or chrome://tracing);
- ``debug_mode()``: autograd's anomaly detection (a backward that makes a
  NaN raises, naming the forward operation) plus ``check_finite``, which
  raises on a non-finite loss while the mode is on: the counterpart of
  ``jax_debug_nans``;
- ``StepTimer``: steps/s and rays/s on the host clock.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

_debug = False

# finished spans kept at most (a whole run under ``--profile`` keeps its first)
MAX_SPANS = 1 << 18


class Span(NamedTuple):
    """One finished span; times in ``time.time_ns()`` nanoseconds."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    unit: Optional[int]
    n: int


_explicit = 0  # depth of ``tracing()`` blocks
_profiling = torch._C._autograd._profiler_enabled
_local = threading.local()
_ids = itertools.count(1)
_finished: List[Span] = []
_dropped = 0
_counters: Dict[str, int] = {}
_OFF = contextlib.nullcontext()


class _Open:
    """A span being timed (``span``'s context while the tracer is on)."""

    __slots__ = ("name", "unit", "n", "id", "parent", "start", "annotation")

    def __init__(self, name: str, unit: Optional[int], n: int):
        self.name, self.unit, self.n = name, unit, n

    def __enter__(self) -> "_Open":
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.unit is None and parent is not None:
            self.unit = parent.unit
        self.id = next(_ids)
        stack.append(self)
        self.annotation = None
        if _profiling():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _dropped
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _local.stack.pop()
        if len(_finished) < MAX_SPANS:
            _finished.append(Span(self.name, self.start, end, self.id, self.parent, self.unit,
                                  self.n))
        else:
            _dropped += 1


def span(name: str, unit: Optional[int] = None, n: int = 1):
    """A context timing the enclosed block as the span ``name`` of ``unit``
    (default: the enclosing span's) covering ``n`` units, while the tracer is
    on; a shared no-op context otherwise."""
    if not (_explicit or _profiling()):
        return _OFF
    return _Open(name, unit, n)


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Keep spans inside the block, with or without a profiler."""
    global _explicit
    _explicit += 1
    try:
        yield
    finally:
        _explicit -= 1


def spans() -> List[Span]:
    """The finished spans kept since the last ``reset()``, in the order they
    ended."""
    return list(_finished)


def dropped() -> int:
    """Spans finished while the buffer held ``MAX_SPANS``, not kept."""
    return _dropped


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on; per process)."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def counters() -> Dict[str, int]:
    return dict(_counters)


class CaptureCounts:
    """The counters a CUDA graph's capture raised (``capture(keep)``, a
    context around it: kept counted with ``keep``, else taken back), added
    again by ``replayed(n)`` for ``n`` replays beside the counter
    ``replays``: a capture runs the body's Python once, a replay none."""

    def __init__(self, replays: str):
        self.replays = replays
        self.launched: Dict[str, int] = {}

    @contextlib.contextmanager
    def capture(self, keep: bool) -> Iterator[None]:
        before = counters()
        yield
        self.launched = {k: v - before.get(k, 0) for k, v in _counters.items()
                         if v != before.get(k, 0)}
        if not keep:
            for name, n in self.launched.items():
                count(name, -n)

    def replayed(self, n: int = 1) -> None:
        if n:
            count(self.replays, n)
            for name, launches in self.launched.items():
                count(name, launches * n)


def reset() -> None:
    """Clear the kept spans, the dropped count and the counters."""
    global _dropped
    _finished.clear()
    _dropped = 0
    _counters.clear()


@contextlib.contextmanager
def trace(logdir) -> Iterator[None]:
    """Profile the enclosed block with ``torch.profiler`` (the CPU, and
    CUDA where a card is present), with the tracer on, and write its Chrome
    trace, which holds the program's spans, into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace-{time.strftime('%Y%m%d-%H%M%S')}.json"))


@contextlib.contextmanager
def debug_mode(nans: bool = True) -> Iterator[None]:
    """Inside, autograd detects anomalies and ``check_finite`` raises on a
    non-finite value (with ``nans``)."""
    global _debug
    saved = _debug
    with contextlib.ExitStack() as stack:
        if nans:
            stack.enter_context(torch.autograd.detect_anomaly(check_nan=True))
            _debug = True
        try:
            yield
        finally:
            _debug = saved


def debug_enabled() -> bool:
    return _debug


def check_finite(name: str, value: torch.Tensor, step: Optional[int] = None) -> None:
    """Raise ``FloatingPointError`` if ``value`` is not finite while
    ``debug_mode`` is on (a host sync; nothing happens outside the mode)."""
    if _debug and not bool(torch.isfinite(value).all()):
        at = f" at step {step}" if step is not None else ""
        raise FloatingPointError(f"non-finite {name}{at}: {value}")


class StepTimer:
    """Rolling steps/s and rays/s on the host clock (the caller synchronises
    where it needs device time)."""

    def __init__(self, rays_per_step: int):
        self.rays_per_step = rays_per_step
        self._t0: Optional[float] = None
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._steps = 0
        self._steps += n

    def rates(self) -> dict:
        if self._t0 is None or self._steps == 0:
            return {}
        dt = time.perf_counter() - self._t0
        sps = self._steps / dt
        self._t0 = time.perf_counter()
        self._steps = 0
        return {"iterations_per_sec": sps, "rays_per_sec": sps * self.rays_per_step}
