"""Checkpoints in the JAX package's format, read and written exactly.

Counterpart of ``minimal_nerf_tpu/training/checkpoint.py``. A ``.ckpt`` file
is a numpy ``.npz`` holding ``leaf_0 .. leaf_{L-1}`` plus a JSON
``__header__`` (step, configs, leaf count, extra). The leaves are the JAX
``tree_flatten`` order of ``{"opt_state", "params"}``, dict keys sorted:

- ``opt_state`` of optax Adam under a schedule: the Adam count (int32
  scalar), ``mu`` and ``nu`` (each in params order), the schedule count;
- ``params``: ``coarse``/``fine`` -> ``density``, ``feature[0..2]``,
  ``rgb[0..1]``, ``trunk[0..3]``, each with ``b`` before ``w``.

A default ``full`` checkpoint therefore has 2 + 3 * 40 = 122 leaves. An
occupancy run keeps its density-EMA grid in the optimizer-state slot,
``{"occ_ema": grid, "opt": adam}``: with sorted keys the grid is leaf 0 and
the file has 123 leaves. ``save_checkpoint`` writes the train step's Adam
state (``{"count", "mu", "nu"}``, the schedule's count equal to Adam's) or,
without one, zero moments and counts; the file loads, and resumes, in the
JAX package. ``save_checkpoint_async`` copies the state to the host and
writes it on a background thread.
"""

from __future__ import annotations

import io
import json
import re
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def flatten_tree(tree) -> List[Any]:
    """Leaves of a dict/list tree in JAX ``tree_flatten`` order (sorted keys).
    Tuples are leaves (shape trees hold shapes as tuples)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten_tree(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in flatten_tree(v)]
    return [tree]


def unflatten_tree(structure, leaves: List[Any]):
    """Rebuild ``structure``'s tree from ``leaves`` in ``flatten_tree`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def state_leaves(param_leaves: List[np.ndarray], opt_state=None, grid=None) -> List[np.ndarray]:
    """The full leaf list for ``param_leaves``: the grid (if any), the Adam
    count, ``mu``, ``nu``, the schedule count, the params. Without
    ``opt_state`` (``{"count", "mu", "nu"}``) the optimizer state is zero."""
    if opt_state is None:
        count = np.zeros((), np.int32)
        mu = [np.zeros_like(p, dtype=np.float32) for p in param_leaves]
        nu = [m.copy() for m in mu]
    else:
        count = np.asarray(int(opt_state["count"]), np.int32)
        mu = [_to_numpy(m) for m in flatten_tree(opt_state["mu"])]
        nu = [_to_numpy(v) for v in flatten_tree(opt_state["nu"])]
    head = [] if grid is None else [_to_numpy(grid)]
    return head + [count] + mu + nu + [count.copy()] + list(param_leaves)


def save_checkpoint(path, params, step: int, nerf_config_dict: Dict[str, Any],
                    train_config_dict: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None, opt_state=None,
                    grid=None) -> Path:
    """Write ``params`` (a ``{"coarse", "fine"}`` tree of tensors or arrays),
    the Adam state ``opt_state`` (zeros if None) and an occupancy run's
    ``grid`` in the JAX format, atomically via a temp file."""
    path = Path(path)
    leaves = state_leaves([_to_numpy(p) for p in flatten_tree(params)], opt_state, grid)
    header = {
        "step": int(step),
        "nerf_config": nerf_config_dict,
        "train_config": train_config_dict,
        "num_leaves": len(leaves),
        "extra": extra if extra is not None else {"mode": "full"},
    }
    buf = io.BytesIO()
    np.savez(
        buf,
        __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
    )
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(buf.getvalue())
    tmp.replace(path)
    return path


def host_copy(tensors: List[Any]) -> List[np.ndarray]:
    """fp32 numpy copies of ``tensors``, those on one device fetched in ONE
    device-to-host copy (concatenated there first). The copies are complete
    when this returns."""
    out: List[Any] = [None] * len(tensors)
    by_device: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    for idx in by_device.values():
        flat = [tensors[i].detach().reshape(-1).float() for i in idx]
        host = (flat[0] if len(flat) == 1 else torch.cat(flat)).cpu().numpy()
        offsets = np.cumsum([0] + [f.numel() for f in flat])
        for j, i in enumerate(idx):
            out[i] = host[offsets[j]:offsets[j + 1]].reshape(tuple(tensors[i].shape))
    return out


_SAVE_POOL: Optional[ThreadPoolExecutor] = None
_SAVE_POOL_LOCK = threading.Lock()


def save_checkpoint_async(path, params, opt_state, step: int, nerf_config_dict: Dict[str, Any],
                          train_config_dict: Dict[str, Any],
                          extra: Optional[Dict[str, Any]] = None, grid=None) -> Future[Path]:
    """``save_checkpoint`` without waiting for the file: ``params``, the
    Adam state and ``grid`` (tensors) are copied to the host BEFORE this
    returns, since the train step updates them in place; serialisation and
    the write then run on a one-worker thread pool, so saves land in the
    order they were asked for. ``.result()`` of the returned future joins
    the write and raises if it failed."""
    global _SAVE_POOL
    with _SAVE_POOL_LOCK:
        if _SAVE_POOL is None:
            _SAVE_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
    p_leaves, mu, nu = (flatten_tree(t) for t in (params, opt_state["mu"], opt_state["nu"]))
    head = [] if grid is None else [grid]
    host = host_copy(head + p_leaves + mu + nu)
    host_grid = host[0] if head else None
    host = host[len(head):]
    n = len(p_leaves)
    host_params = unflatten_tree(params, host[:n])
    host_opt = {"count": int(opt_state["count"]),
                "mu": unflatten_tree(opt_state["mu"], host[n:2 * n]),
                "nu": unflatten_tree(opt_state["nu"], host[2 * n:])}
    return _SAVE_POOL.submit(save_checkpoint, path, host_params, step, nerf_config_dict,
                             train_config_dict, extra, host_opt, host_grid)


def _ckpt_file(path) -> Path:
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"checkpoint not found: {str(path)!r}")
    return p


def read_header(path) -> Dict[str, Any]:
    """Only the JSON header (``np.load`` reads arrays lazily)."""
    with np.load(_ckpt_file(path), allow_pickle=False) as z:
        return json.loads(bytes(z["__header__"]).decode())


def load_checkpoint(path) -> Tuple[Dict[str, Any], Dict[int, np.ndarray]]:
    """``(header, leaves_by_index)`` of a checkpoint file."""
    with np.load(_ckpt_file(path), allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        leaves = {int(k.split("_", 1)[1]): z[k] for k in z.files if k.startswith("leaf_")}
    return header, leaves


def restore_state(header, leaves: Dict[int, np.ndarray], shapes_tree, grid_shape=None):
    """``(params, opt_state, grid)`` from a checkpoint whose state is Adam +
    schedule over a params tree shaped like ``shapes_tree`` (leaves are shape
    tuples), preceded by an occupancy grid of ``grid_shape`` if one is given.

    ``params`` and ``opt_state = {"count", "mu", "nu"}`` hold numpy arrays
    in the params layout (``count`` an int); ``grid`` is None without
    ``grid_shape``. Raises ``ValueError`` on any other layout: a different
    leaf count, or a leaf whose shape does not match.
    """
    shapes = flatten_tree(shapes_tree)
    p = len(shapes)
    head = [] if grid_shape is None else [tuple(grid_shape)]
    want = head + [()] + shapes + shapes + [()] + shapes
    if header.get("num_leaves") != len(want) or sorted(leaves) != list(range(len(want))):
        raise ValueError(
            f"checkpoint has {header.get('num_leaves')} leaves; a params tree of {p} leaves "
            f"under Adam{' with an occupancy grid' if head else ''} needs {len(want)}")
    for i, shape in enumerate(want):
        if tuple(leaves[i].shape) != tuple(shape):
            raise ValueError(f"leaf {i}: saved shape {leaves[i].shape} != expected {shape}")
    h = len(head)
    tree = lambda lo: unflatten_tree(shapes_tree, [leaves[i] for i in range(lo, lo + p)])  # noqa: E731
    opt_state = {"count": int(leaves[h]), "mu": tree(h + 1), "nu": tree(h + 1 + p)}
    return tree(h + 2 + 2 * p), opt_state, (leaves[0] if head else None)


def checkpoint_name(name: str, epoch: int, step: int) -> str:
    """Reference-convention filename ``model={name}-epoch={E}-step={S}.ckpt``."""
    return f"model={name}-epoch={epoch}-step={step}.ckpt"


_CKPT_RE = re.compile(r"epoch=(\d+)-step=(\d+)\.ckpt$")


def parse_epoch_step(filename: str) -> Optional[Tuple[int, int]]:
    """``(epoch, step)`` from a checkpoint filename, else None."""
    m = _CKPT_RE.search(str(filename))
    return (int(m.group(1)), int(m.group(2))) if m else None


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """Highest-step ``*.ckpt`` in ``ckpt_dir``."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    best, best_step = None, -1
    for p in ckpt_dir.glob("*.ckpt"):
        parsed = parse_epoch_step(p.name)
        if parsed and parsed[1] > best_step:
            best, best_step = p, parsed[1]
    return best
