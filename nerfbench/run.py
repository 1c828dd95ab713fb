"""Run one cell of the benchmark once.

    python3 -m nerfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. The cell
(``BENCHMARK.json``) names a configuration and a traffic (``spec.py``); the
traffic's kind drives the program (``kinds/``). One run:

1. set-up: the inputs from the seed on the card, the program built and
   warmed up, the first steps for the output check (``setup_s`` is the
   time from this module's start to the first timed unit);
2. the window: units (step calls or requests) one after the other for
   ``--seconds`` seconds of the host clock, closed by a synchronize on the
   last unit's outputs; with ``--trace 1`` a short slice of whole units
   after it under the profiler (``trace.py``);
3. the peak device memory, then the program's state dropped and the
   output check against the plain reference (``reference/``), each number
   beside its limit (``limits/<cell>.json``).

Prints one JSON line on stdout: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, each read by ``metrics/<name>.py``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``; the compared numbers are
also the last lines on stderr. Exits non-zero, printing no result, without
enough CUDA cards, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "minimal_nerf_tpu")


def log(msg: str) -> None:
    print(f"[nerfbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card(device) -> Dict[str, Any]:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": 1}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"card {out.stdout.strip().splitlines()[dev.index or 0] if out.returncode == 0 else '?'}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}


def merge(base: Dict[str, Any], over: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``base`` with ``over``'s keys replaced, nested groups merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(base.get(k, {}), v) if isinstance(v, dict) and isinstance(
            base.get(k), dict) else v
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of ``workload``; returns the result line's object.
    ``overrides`` (``{"config": {...}, "traffic": {...}}``) replaces parts of
    the cell's files, for tiny runs on the CPU."""
    import torch

    from nerfbench import spec as S
    from nerfbench import trace as T

    cell_spec = S.load_cell(workload)
    for key in ("config", "traffic"):
        cell_spec[key] = merge(cell_spec[key], (overrides or {}).get(key))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    device_info = card(dev)
    cell = S.kind(cell_spec["traffic"]["kind"]).Cell(cell_spec, seed, dev, log)
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    latencies = []
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    while True:
        t = time.perf_counter()
        cell.unit()
        latencies.append(time.perf_counter() - t)
        if time.perf_counter() - t0 >= seconds:
            break
    cell.finish()
    window_s = time.perf_counter() - t0
    units = len(latencies)
    q = statistics.quantiles(latencies, n=10) if units > 1 else latencies * 9
    log(f"{workload}: set-up {setup_s:.3f} s, window {window_s:.3f} s, {units} "
        f"{cell.unit_name}s; latency ms min {1e3 * min(latencies):.2f} p10 {1e3 * q[0]:.2f} "
        f"p50 {1e3 * q[4]:.2f} p90 {1e3 * q[8]:.2f} max {1e3 * max(latencies):.2f}")
    summary = None
    if trace:
        summary = T.profile_slice(cell.unit, cell.trace_units)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    cell.release()
    t = time.perf_counter()
    readings = cell.check()
    log(f"output check {time.perf_counter() - t:.3f} s; readings {readings}")
    limits = cell_spec["limits"]
    checks = {k: readings[k] for k in limits}
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in checks.items())
    ctx = SimpleNamespace(cell=cell_spec, kind=cell_spec["traffic"]["kind"], setup_s=setup_s,
                          window=dict(cell.work(units), units=units, seconds=window_s,
                                      latencies=latencies),
                          trace=summary,
                          traced=cell.work(cell.trace_units) if summary else None,
                          device_kind=device_info["kind"])
    metrics = {}
    for m in cell_spec["per_layer" if trace else "end_to_end"]:
        value = S.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": units, "failed": 0, "metrics": metrics,
              "device": dict(device_info, memory_peak_bytes=peak)}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": T.top_ops(summary), "idle_gaps": summary["gaps"]}
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from nerfbench import spec as S

    chips = S.load_cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch.cuda.is_available()="
            f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {found}; the benchmark runs without JAX")
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
