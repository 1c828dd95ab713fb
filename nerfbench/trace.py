"""The device timeline of a short slice of whole steps or frames.

``profile_slice`` runs the slice under ``torch.profiler`` and reduces the
exported traces: the slice's length, the union of the device's intervals
(kernels, copies, fills) in it, each kernel name's device seconds, and the
longest idle gaps between the intervals, each named by the innermost host
event that covers its middle (``summarize``, over a slice inside one
``nerfbench.slice`` annotation).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch

SLICE = "nerfbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def _export(prof) -> List[Dict[str, Any]]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return events["traceEvents"] if isinstance(events, dict) else events


def profile_slice(run: Callable[[], None], units: int) -> Dict[str, Any]:
    """``run()`` ``units`` times under the profiler, twice.

    The first slice records the device alone (CUPTI adds little to the
    host's launches): its length on the host clock, synchronized at both
    ends, is ``window_s``, and the union of its device intervals
    ``busy_s``; ``kernel_s`` is each kernel name's device seconds. The
    second slice records the host's operations too, which slow the host, so
    only its idle gaps are kept, each named by the host event that covers
    its middle (``gaps``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = [e for e in _export(prof) if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    kernel_s = defaultdict(float)
    for e in events:
        kernel_s[e["name"]] += 1e-6 * float(e["dur"])
    busy = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            for _ in range(units):
                run()
            torch.cuda.synchronize()
    return {"window_s": window_s, "busy_s": 1e-6 * sum(b - a for a, b in busy),
            "kernel_s": dict(kernel_s), "gaps": summarize(_export(prof))["gaps"]}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """``window_s``, ``busy_s``, ``kernel_s`` (name -> device seconds inside
    the slice), ``gaps`` (``[host event name, seconds]``, longest first) of
    a Chrome trace's events (microseconds)."""
    marks = [e for e in events if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"the trace holds no {SLICE!r} annotation")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    device, kernel_s = [], defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            a, b = max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"]))
            if b > a:
                device.append((a, b))
                kernel_s[e["name"]] += 1e-6 * (b - a)
    busy = _merge(device)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and e.get("name") != SLICE]
    gaps = []
    for a, b in sorted(holes, key=lambda h: h[0] - h[1])[:10]:
        mid = 0.5 * (a + b)
        covering = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        name = min(covering, key=lambda e: float(e["dur"]))["name"] if covering else "host"
        gaps.append([name, 1e-6 * (b - a)])
    return {"window_s": 1e-6 * (hi - lo), "busy_s": 1e-6 * sum(b - a for a, b in busy),
            "kernel_s": dict(kernel_s), "gaps": gaps}


def device_seconds(summary: Dict[str, Any], names) -> float:
    """Device seconds of the kernels whose names contain any of ``names``."""
    return sum(s for k, s in summary["kernel_s"].items() if any(n in k for n in names))


def top_ops(summary: Dict[str, Any], count: int = 10) -> List[List[Any]]:
    return [[k, s] for k, s in sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:count]]
