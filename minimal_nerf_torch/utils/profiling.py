"""Tracing, NaN hunting and step timing.

The port's counterpart of ``minimal_nerf_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block (host
  and, on a card, device activity), written as one Chrome trace per run
  (``{logdir}/trace-{time}.json``, viewable in Perfetto or chrome://tracing);
- ``debug_mode()``: autograd's anomaly detection (a backward that makes a
  NaN raises, naming the forward operation) plus ``check_finite``, which
  raises on a non-finite loss while the mode is on: the counterpart of
  ``jax_debug_nans``;
- ``StepTimer``: steps/s and rays/s on the host clock.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

_debug = False


@contextlib.contextmanager
def trace(logdir) -> Iterator[None]:
    """Profile the enclosed block with ``torch.profiler`` (the CPU, and
    CUDA where a card is present) and write its Chrome trace into
    ``logdir``."""
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
