"""The output check's readings over many seeds in one process: the sound
program's, the control's and those of planted faults, from which each
limit in ``limits/<cell>.json`` is set.

    python3 -m nerfbench.readings --workload <cell> --side <side> --seeds 1,2,3

Sides:

- ``program``: the program as the benchmark runs it (the lower readings);
- ``control``: the reference computed in the control's precision put in
  the program's place (``reference.nerf.control_numerics``: fp8 where the
  configuration states bf16);
- ``unchanged``: the train step returns its state unchanged (Adam applies
  nothing);
- ``halfbatch``: the train step's loss and gradients over the first half of
  its rays only, the mean taken over them;
- ``answer``: the render chunk's colors altered where they are produced, in
  the first chunk of every frame.

Each seed runs the cell's set-up and, for a view cell, as many requests as
its output check compares; then the check. One JSON line per seed on
stdout, the largest reading of each number last. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Any, Dict, Iterator, Optional

import torch

SIDES = ("program", "control", "unchanged", "halfbatch", "answer")


def _half(t):
    if t is None:
        return None
    if isinstance(t, tuple):
        return tuple(_half(x) for x in t)
    return t[: t.shape[0] // 2] if torch.is_tensor(t) and t.dim() > 0 else t


@contextlib.contextmanager
def planted(side: str, chunks_per_frame: int = 1) -> Iterator[None]:
    """The fault ``side`` planted in the program while the block runs."""
    from minimal_nerf_torch import inference
    from minimal_nerf_torch.training import loop

    saved = (loop.adam_apply, loop.loss_and_grads, inference.build_render_chunk)
    if side == "unchanged":
        loop.adam_apply = lambda params, grads, state, *a, **k: dict(  # noqa: E731
            state, count=state["count"] + 1)
    elif side == "halfbatch":
        real = saved[1]

        def half_batch(params, nerf_cfg, batch, *a, uniforms=None, **k):
            n = batch["origin"].shape[0]
            batch = {key: _half(v) if torch.is_tensor(v) and v.shape[:1] == (n,) else v
                     for key, v in batch.items()}
            uniforms = None if uniforms is None else {key: _half(v) for key, v in uniforms.items()}
            return real(params, nerf_cfg, batch, *a, uniforms=uniforms, **k)

        loop.loss_and_grads = half_batch
    elif side == "answer":
        real = saved[2]

        def altered(*a, **k):
            chunk, nerf_cfg, train_cfg = real(*a, **k)
            calls = [0]

            def wrong_first_chunk(o, d, generator):
                rgb = chunk(o, d, generator)
                calls[0] += 1
                return rgb + 0.25 if (calls[0] - 1) % chunks_per_frame == 0 else rgb

            return wrong_first_chunk, nerf_cfg, train_cfg

        inference.build_render_chunk = altered
    elif side not in ("program", "control"):
        raise ValueError(f"unknown side {side!r}")
    try:
        yield
    finally:
        loop.adam_apply, loop.loss_and_grads, inference.build_render_chunk = saved


def reading(workload: str, seed: int, side: str, device="cuda",
            overrides: Optional[Dict[str, Any]] = None, log=None) -> Dict[str, float]:
    """The numbers the output check of ``workload`` compares for one seed on
    ``side``."""
    from nerfbench import spec as S
    from nerfbench.run import log as run_log, merge

    log = log or run_log
    cell_spec = S.load_cell(workload)
    for key in ("config", "traffic"):
        cell_spec[key] = merge(cell_spec[key], (overrides or {}).get(key))
    tr = cell_spec["traffic"]
    per_frame = -(-tr.get("height", 0) * tr.get("width", 0) // tr.get("chunk", 1))
    cell = S.kind(tr["kind"]).Cell(cell_spec, seed, torch.device(device), log)
    with planted(side, max(1, per_frame)):
        cell.setup()
        if tr["kind"] == "view":
            want = max(1, tr["check_points"] // (cell.pixels * cell.ppr))
            for _ in range(want):
                cell.unit()
        cell.finish()
    cell.release()
    return cell.control() if side == "control" else cell.check()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--side", choices=SIDES, required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--override", default=None,
                        help='JSON {"config": {...}, "traffic": {...}} replacing parts of the '
                             "cell's files, for a witness run on another path of the program")
    args = parser.parse_args(argv)
    overrides = json.loads(args.override) if args.override else None
    if not torch.cuda.is_available():
        print("[readings] needs a CUDA card", file=sys.stderr)
        return 2
    worst: Dict[str, float] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = reading(args.workload, seed, args.side, overrides=overrides)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v)
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "override": overrides, "numbers": numbers}), flush=True)
    print(json.dumps({"workload": args.workload, "side": args.side, "largest": worst}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
