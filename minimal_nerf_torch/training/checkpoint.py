"""Checkpoints in the JAX package's format, read and written exactly.

Counterpart of ``minimal_nerf_tpu/training/checkpoint.py``. A ``.ckpt`` file
is a numpy ``.npz`` holding ``leaf_0 .. leaf_{L-1}`` plus a JSON
``__header__`` (step, configs, leaf count, extra). The leaves are the JAX
``tree_flatten`` order of ``{"opt_state", "params"}``, dict keys sorted:

- ``opt_state`` of optax Adam under a schedule: the Adam count (int32
  scalar), ``mu`` and ``nu`` (each in params order), the schedule count;
- ``params``: ``coarse``/``fine`` -> ``density``, ``feature[0..2]``,
  ``rgb[0..1]``, ``trunk[0..3]``, each with ``b`` before ``w``.

A default ``full`` checkpoint therefore has 2 + 3 * 40 = 122 leaves.
``save_checkpoint`` writes zero moments and zero counts (the train step's
Adam state is not saved yet); the file loads in the JAX package's
``load_state_for_inference``.
"""

from __future__ import annotations

import io
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


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


def state_leaves(param_leaves: List[np.ndarray]) -> List[np.ndarray]:
    """The full 3P+2 leaf list for ``param_leaves``, with a zero optimizer
    state (Adam count, mu, nu, schedule count)."""
    zeros = [np.zeros_like(p, dtype=np.float32) for p in param_leaves]
    count = np.zeros((), np.int32)
    return [count] + zeros + [z.copy() for z in zeros] + [count.copy()] + list(param_leaves)


def save_checkpoint(path, params, step: int, nerf_config_dict: Dict[str, Any],
                    train_config_dict: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``params`` (a ``{"coarse", "fine"}`` tree of tensors or arrays)
    in the JAX format, atomically via a temp file."""
    path = Path(path)
    params_np = [np.asarray(p.detach().float().cpu().numpy() if hasattr(p, "detach") else p,
                            dtype=np.float32) for p in flatten_tree(params)]
    leaves = state_leaves(params_np)
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


def restore_params(header, leaves: Dict[int, np.ndarray], shapes_tree):
    """The params tree from a checkpoint whose state is Adam + schedule over
    a params tree shaped like ``shapes_tree`` (leaves are shape tuples).

    Raises ``ValueError`` on any other layout: a different leaf count, or a
    leaf whose shape does not match.
    """
    shapes = flatten_tree(shapes_tree)
    p = len(shapes)
    expected = 3 * p + 2
    if header.get("num_leaves") != expected or sorted(leaves) != list(range(expected)):
        raise ValueError(
            f"checkpoint has {header.get('num_leaves')} leaves; a params tree of "
            f"{p} leaves under Adam needs {expected}")
    want = [()] + shapes + shapes + [()] + shapes
    for i, shape in enumerate(want):
        if tuple(leaves[i].shape) != tuple(shape):
            raise ValueError(f"leaf {i}: saved shape {leaves[i].shape} != expected {shape}")
    return unflatten_tree(shapes_tree, [leaves[i] for i in range(2 * p + 2, expected)])


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
