"""Data-parallel training across processes: the port's train CLI as two gloo
ranks on the CPU against one process on the same draws (mirrors
``tests/test_distributed.py``).

Every rank draws the whole step and renders its rows, so two ranks compute
the one-process step on the same draws up to the summation order: the
first step's loss within rtol 1e-6, every later one within 1% (JAX's test
allows 10%, its shards drawing their own keys). The same gate fails for an
all-reduce that does not divide by the world size or that drops rank 1's
shard. Rank 1 writes nothing. ``--data-parallel 2`` spawns the same two
ranks, and ``--steps-per-call 4`` under two ranks takes the steps of one
per call. Each rank is a subprocess with one thread
(``OMP_NUM_THREADS=1``); the runs go in parallel.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from minimal_nerf_torch.data import procedural as t_proc
from minimal_nerf_torch.parallel import distributed
from minimal_nerf_torch.training import checkpoint as t_ckpt

ROOT = Path(__file__).resolve().parents[1]
STEPS = 20
COMMON = ["--device", "cpu", "-r", "64", "--precision", "fp32"]
FULL = ["-c", "8", "-f", "8"]
TIMEOUT = 120
# a rank whose all-reduce is faulty: the sum not divided by the world size,
# or rank 1's shard dropped (zeros in its place)
FAULTY_LAUNCH = """
import sys
import torch
import torch.distributed as dist
from minimal_nerf_torch.parallel import distributed
from minimal_nerf_torch import train

FAULT = sys.argv[1]


def faulty(tensors, mesh):
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if FAULT == "drop" and mesh.rank == 1:
        flat = torch.zeros_like(flat)
    dist.all_reduce(flat)
    if FAULT == "drop":
        flat = flat / mesh.size
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return out


distributed.all_reduce_mean = faulty
train.main(sys.argv[2:])
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The in-process work on one thread (see tests/test_torch_trainer.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tree(path, frames):
    scenes, _ = t_proc.make_procedural_scene((("train", frames), ("val", 1)), height=16,
                                             width=16, gt_samples=16, device="cpu")
    return t_proc.save_scene_tree(scenes, path)


def _argv(root, name, steps, tree, *extra, log_every=1):
    return (COMMON + ["-n", name, "-s", str(steps), "-rd", str(root), "--log-every",
                      str(log_every), *extra, "full", "-b", str(tree)] + FULL)


def _start(cmd):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _ranks(root_of, argv_of, launch=("-m", "minimal_nerf_torch.train")):
    """Two ``--multihost`` ranks on a local coordinator: ``argv_of(rank)``
    their arguments, ``root_of(rank)`` their ``-rd``."""
    coord = f"127.0.0.1:{distributed.free_port()}"
    return [_start([*launch, "--multihost", "--coordinator", coord,
                    "--num-processes", "2", "--process-id", str(rank),
                    *argv_of(rank)]) for rank in (0, 1)]


def _wait(procs):
    for p in procs:
        out, _ = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, out[-3000:]


def _rows(run_dir):
    with open(run_dir / "metrics.csv", newline="") as f:
        return [r for r in csv.DictReader(f) if r.get("train_loss")]


def _leaves(run_dir):
    _, leaves = t_ckpt.load_checkpoint(t_ckpt.latest_checkpoint(run_dir / "checkpoints"))
    return [leaves[i] for i in sorted(leaves)]


def _gate(rows, want):
    """Two ranks against one process: step 1's loss within rtol 1e-6,
    every later step's within 1%."""
    got = np.array([float(r["train_loss"]) for r in rows])
    ref = np.array([float(r["train_loss"]) for r in want])
    assert len(got) == len(ref) == STEPS
    assert abs(got[0] - ref[0]) <= 1e-6 * abs(ref[0]), (got[0], ref[0])
    worst = np.max(np.abs(got[1:] - ref[1:]) / np.abs(ref[1:]))
    assert worst <= 0.01, worst


RESUME_CHECK = """
import sys
from minimal_nerf_torch.parallel import distributed, make_mesh

rank, coordinator, step = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
distributed.initialize(coordinator, 2, rank, device="cpu")
try:
    distributed.check_same_step(step, make_mesh(2, device="cpu"))
    print("same")
except RuntimeError as e:
    print(e)
finally:
    distributed.shutdown()
"""


@pytest.mark.parametrize("steps", [(30, 30), (30, 20)])
def test_ranks_resumed_at_other_steps_raise(steps):
    """``check_same_step`` across two gloo ranks: the same step passes, two
    steps raise on both ranks, naming both (JAX ``trainer.py:215-222``)."""
    coord = f"127.0.0.1:{distributed.free_port()}"
    procs = [_start(["-c", RESUME_CHECK, str(rank), coord, str(step)])
             for rank, step in enumerate(steps)]
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    for out in outs:
        if steps[0] == steps[1]:
            assert out.strip().endswith("same"), out
        else:
            assert "resume mismatch: ranks restored different steps [20, 30]" in out, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the module, started together: one process; two
    ``--multihost`` ranks (rank 1 with a root of its own); the two faulty
    all-reduces; ``--data-parallel 2``; two ranks at ``--steps-per-call``
    1 and 4 on a 4-frame tree."""
    tmp = tmp_path_factory.mktemp("dist")
    tree, tree4 = _tree(tmp / "tree", 2), _tree(tmp / "tree4", 4)
    root = lambda name, rank=0: tmp / f"{name}-{rank}"  # noqa: E731
    procs = {
        "one": [_start(["-m", "minimal_nerf_torch.train",
                        *_argv(root("one"), "one", STEPS, tree)])],
        "two": _ranks(root, lambda r: _argv(root("two", r), "two", STEPS, tree)),
        "spawned": [_start(["-m", "minimal_nerf_torch.train",
                            *_argv(root("spawned"), "spawned", STEPS, tree,
                                   "--data-parallel", "2")])],
    }
    for fault in ("divide", "drop"):
        procs[fault] = _ranks(root, lambda r, f=fault: _argv(root(f, r), f, STEPS, tree),
                              launch=("-c", FAULTY_LAUNCH, fault))
    for spc in (1, 4):
        name = f"spc{spc}"
        procs[name] = _ranks(root, lambda r, n=name, s=spc: _argv(
            root(n, r), n, 8, tree4, "--steps-per-call", str(s), log_every=4))
    for p in procs.values():
        _wait(p)
    return {"root": root, "dir": lambda name: root(name) / name}


def test_two_ranks_match_one_process(runs):
    """Two gloo ranks (``--multihost``) against one process on the same
    draws: the loss gate of the module doc, the validation at step 20 (rank
    0's, on the same parameters) within 1e-5, rank 1's root never made."""
    two, one = _rows(runs["dir"]("two")), _rows(runs["dir"]("one"))
    _gate(two, one)
    val = [[float(r["val_loss"]) for r in _csv_all(runs["dir"](n)) if r.get("val_loss")]
           for n in ("two", "one")]
    assert len(val[0]) == 1 and abs(val[0][0] - val[1][0]) <= 1e-5 * val[1][0], val
    assert not runs["root"]("two", 1).exists(), "rank 1 wrote files"
    for a, b in zip(_leaves(runs["dir"]("two")), _leaves(runs["dir"]("one"))):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


def _csv_all(run_dir):
    with open(run_dir / "metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("fault", ["divide", "drop"])
def test_faulty_all_reduce_fails_the_gate(runs, fault):
    """An all-reduce without the division by the world size, or without
    rank 1's shard, trains (and rank 1 still writes nothing) but fails the
    gate."""
    with pytest.raises(AssertionError):
        _gate(_rows(runs["dir"](fault)), _rows(runs["dir"]("one")))
    assert not runs["root"](fault, 1).exists()


def test_data_parallel_spawns_the_same_ranks(runs):
    """``--data-parallel 2 --device cpu`` spawns two gloo ranks on a local
    coordinator: the same rows (every logged value but the timings) and the
    same final checkpoint as the two ``--multihost`` ranks, bit for bit."""
    timing = {"iterations_per_sec", "rays_per_sec", "train iteration speed", "wall_seconds",
              "val_seconds", "ckpt_seconds"}
    spawned, two = _csv_all(runs["dir"]("spawned")), _csv_all(runs["dir"]("two"))
    assert len(spawned) == len(two) == STEPS + 1
    for a, b in zip(spawned, two):
        assert {k: v for k, v in a.items() if k not in timing} == \
            {k: v for k, v in b.items() if k not in timing}
    for a, b in zip(_leaves(runs["dir"]("spawned")), _leaves(runs["dir"]("two"))):
        np.testing.assert_array_equal(a, b)


def test_steps_per_call_under_two_ranks_equals_single_steps(runs):
    """Two ranks at ``--steps-per-call 4`` (one call per 4-step epoch)
    against two ranks at one step per call: the logged losses and the final
    checkpoint bit for bit."""
    rows = [[{k: r[k] for k in ("step", "train_loss", "grad_2.0_norm_total", "lr")}
             for r in _rows(runs["dir"](f"spc{s}"))] for s in (4, 1)]
    assert [r["step"] for r in rows[0]] == ["4", "8"] and rows[0] == rows[1]
    for a, b in zip(_leaves(runs["dir"]("spc4")), _leaves(runs["dir"]("spc1"))):
        np.testing.assert_array_equal(a, b)
