"""What a cell is, found by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic; their files, the cell's
limits and each metric's reader sit under this folder.

- ``configs/<config>.json``: the model and train settings and the source;
- ``traffic/<traffic>.json``: the traffic's parameters and its ``kind``,
  which names the module that drives it (``kinds/<kind>.py``);
- ``limits/<cell>.json``: each number the output check compares, and its
  limit;
- ``metrics/<metric>.py``: a reader ``read(ctx)`` of one metric (or of
  ``<metric>`` less its last ``.part``, for the same quantity in other
  cells).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Dict[str, Any] = None) -> Dict[str, Any]:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and the metrics it reports."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    return {"name": name, "chips": cell["chips"],
            "config_name": cell["config"], "traffic_name": cell["traffic"],
            "config": load_json(HERE / "configs" / f"{cell['config']}.json"),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
            "per_layer": [m for m in bench["per_layer"] if applies(m, name)]}


def kind(name: str):
    """The module that drives traffic of kind ``name``."""
    return importlib.import_module(f"nerfbench.kinds.{name}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``; a metric ``<base>.<part>``
    with no file of its own (the same quantity for other cells, under a
    bound or an end-to-end metric of its own) is read by ``<base>``'s."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        return metric_reader(name.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(f"nerfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
