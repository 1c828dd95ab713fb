"""Training traffic: steps of 4096 rays on a random scene, one call after
another (a closed loop), as the Trainer calls the train step.

The program's step is ``training.loop.make_train_step`` at one step per
call, else ``make_multi_step`` with the configuration's ``steps_per_call``
(one captured CUDA graph replayed per step), through
``loop.kernel_hooks(kernel)``, with the occupancy grid when the
configuration has one. Set-up builds that one object and runs its first
``check_calls`` calls from ``start_step``, keeping the state at each call's
end (``_boundary``: the call's last loss and its coarse part, the
parameters, the Adam moments and count, the grid). The window's calls
continue the same object's trajectory.

``check()`` holds those call ends against ``reference.nerf.train_steps`` on
the same weights, scene, grid and seed, in two ways (``compare``; the
cell's limits pick the numbers compared):

- followed: the reference runs on its own from the start over the first
  ``follow_steps`` steps' calls. ``loss_gap``, each call's last loss, the
  relative gap, worst call; ``moment_gap``, per leaf the gap between the
  first moment's norm after the first call (at one step per call 0.1 times
  the first gradient) and the reference's, relative to the larger of that
  norm and the median leaf's, worst leaf (``moment_gap_median``, the median
  leaf); ``moment_angle``, one minus the cosine between the whole first
  moment and the reference's; ``change_gap``, each leaf's change over the
  span, as ``moment_gap``; ``grid_gap`` (occupancy), the grid's relative L2
  gap after the span.
- forced: each checked call again, the reference starting from the
  program's state at the call's start, so that its gaps stay those of one
  call and never grow along the trajectory; where the call updates the
  grid once, the reference's samples follow the program's grid after the
  update, and its own update is held to the program's apart. Per call,
  worst call: ``forced_loss_gap`` and ``forced_coarse_gap``, the call's last
  loss and its coarse part; ``forced_moment_gap`` (worst leaf),
  ``forced_moment_gap_median`` and ``forced_moment_angle``, of what the
  call added to the first moment (``mu - b1^steps * mu_start``: at one step
  per call 0.1 times the step's gradient); ``forced_change_gap`` and
  ``forced_change_gap_median``, of each leaf's change in the call;
  ``forced_grid_gap``, of the grid's update; and
  ``forced_moment_angle_median_call``, the median call's angle, which a
  fault in every call moves and one step's tail does not. A call that
  updates the grid twice is run and not compared (the steps between its
  updates would follow the reference's own grid).

Leaves whose reference moment (or, forced, its increment) is under a
thousandth of the median leaf's are left out (under Adam a leaf with no
gradient moves by round-off).
"""

from __future__ import annotations

import gc
import math
import statistics
from typing import Any, Dict, List, Optional

import torch

from nerfbench import counts
from nerfbench.kinds import program_configs
from nerfbench.reference import nerf as R
from nerfbench.traffic import generate as gen


ADAM_B1 = R.ADAM_B1


def _clones(ts) -> List[torch.Tensor]:
    return [t.detach().clone().float() for t in ts]


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    """The cosine of two tensors in float64; 0 where either is all zero."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    den = float(torch.linalg.norm(a) * torch.linalg.norm(b))
    return float(torch.dot(a, b)) / den if den > 0 else 0.0


def _leaf_gaps(got: List[torch.Tensor], ref: List[torch.Tensor], kept=None):
    """Per leaf, the gap of the norms relative to the larger of the
    reference leaf's and the median leaf's: ``(worst, median, angle,
    kept)``, over the leaves ``kept`` (default: those whose reference norm
    is at least a thousandth of the median leaf's); the angle is one minus
    the cosine over them."""
    norms = lambda ts: [float(torch.linalg.norm(t.float())) for t in ts]  # noqa: E731
    ng, nr = norms(got), norms(ref)
    med = statistics.median(nr)
    if kept is None:
        kept = [i for i, b in enumerate(nr) if b >= 1e-3 * med]
    gaps = [abs(ng[i] - nr[i]) / max(nr[i], med) for i in kept]
    flat = lambda ts: torch.cat([ts[i].reshape(-1) for i in kept])  # noqa: E731
    return max(gaps), statistics.median(gaps), 1.0 - _cos(flat(got), flat(ref)), kept


class Cell:
    unit_name = "call"

    def __init__(self, spec: Dict[str, Any], seed: int, device, log):
        self.spec, self.seed, self.dev, self.log = spec, seed, torch.device(device), log
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.spc = self.cfg["train"]["steps_per_call"]
        self.follow_calls = math.ceil(self.traffic["follow_steps"] / self.spc)
        self.calls_checked = max(self.traffic["check_calls"], self.follow_calls)
        self.trace_units = math.ceil(self.traffic["trace_steps"] / self.spc)

    def work(self, units: int) -> Dict[str, int]:
        rays = units * self.spc * self.cfg["train"]["num_rays"]
        return {"rays": rays, "points": rays * counts.points_per_ray(self.cfg["nerf"]),
                "steps": units * self.spc}

    def setup(self) -> None:
        from minimal_nerf_torch.training import loop

        cfg, tr, dev = self.cfg, self.traffic, self.dev
        self.images, self.poses, self.focal = gen.scene(self.seed, tr, dev)
        params = gen.weights(self.seed, cfg["nerf"], tr["weights"], dev)
        self.params0 = R.map_tree(lambda t: t.detach().clone(), params)
        occ = cfg.get("occupancy")
        self.grid0 = gen.grid(self.seed, occ, tr["grid"], dev) if occ else None
        grid = None if self.grid0 is None else self.grid0.clone()
        if occ:
            self.log(f"grid: {100.0 * float((grid > 0).float().mean()):.4f}% of cells inside "
                     "the seeded object")
        nerf_cfg, train_cfg = program_configs(cfg)
        static = loop.SceneStatic(height=tr["height"], width=tr["width"], focal=self.focal,
                                  num_frames=tr["frames"])
        mlp_apply, render_fn = loop.kernel_hooks(train_cfg.kernel, dev)
        occ_cfg = train_cfg.occupancy_config
        if self.spc == 1:
            self.fn = loop.make_train_step(nerf_cfg, train_cfg, static, render_fn, dev,
                                           mlp_apply, occ_cfg)
        else:
            self.fn = loop.make_multi_step(nerf_cfg, train_cfg, static, self.spc, render_fn,
                                           dev, mlp_apply, occ_cfg)
        self.params, self.opt, self.grid = params, loop.adam_init(params), grid
        self.step = tr["start_step"]
        self.start = dict(R.adam_state(self.params0), params=_clones(R.leaves(self.params0)),
                          grid=self.grid0)
        self.observed = []
        for _ in range(self.calls_checked):
            metrics = self._call()
            self.observed.append({
                "loss": float(metrics["train_loss"]),
                "coarse": float(metrics["train_coarse_loss"]),
                "params": _clones(R.leaves(self.params)), "mu": _clones(R.leaves(self.opt["mu"])),
                "nu": _clones(R.leaves(self.opt["nu"])), "count": self.opt["count"],
                "grid": None if self.grid is None else self.grid.clone()})

    def _call(self):
        if self.grid is None:
            self.params, self.opt, metrics = self.fn(self.params, self.opt, self.images,
                                                     self.poses, self.step, self.seed)
        else:
            self.params, self.opt, self.grid, metrics = self.fn(
                self.params, self.opt, self.grid, self.images, self.poses, self.step, self.seed)
        self.step += self.spc
        return metrics

    def unit(self) -> None:
        self._call()

    def finish(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def release(self) -> None:
        self.fn = self.params = self.opt = self.grid = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def updates_in(self, k: int) -> List[int]:
        """The steps of call ``k`` that update the grid."""
        occ = self.cfg.get("occupancy")
        first = self.traffic["start_step"] + k * self.spc
        return [s for s in range(first, first + self.spc)
                if occ and s % occ["update_every"] == 0]

    def reference_call(self, numerics: R.Numerics, start: Dict[str, Any], k: int,
                       grids: Optional[Dict[int, torch.Tensor]] = None) -> Dict[str, Any]:
        """Call ``k``'s steps in the reference from the state ``start``."""
        with R.exact_float32():
            out = R.train_steps(R.unflatten(self.params0, start["params"]), self.cfg,
                                self.images, self.poses, self.focal, self.seed,
                                self.traffic["start_step"] + k * self.spc, self.spc, numerics,
                                start["grid"], self.traffic["reference_block_rays"],
                                state=start, grids=grids)
        return {"loss": out["losses"][-1], "coarse": out["coarse_losses"][-1],
                "params": out["params"], "mu": out["mu"], "nu": out["nu"],
                "count": out["count"], "grid": out["grid"], "updates": out["updates"]}

    def trajectory(self, numerics: R.Numerics, calls: int) -> List[Dict[str, Any]]:
        """The reference's own call ends over the first ``calls`` calls."""
        out, state = [], self.start
        for k in range(calls):
            state = self.reference_call(numerics, state, k)
            out.append(state)
        return out

    def compare(self, got: List[Dict[str, Any]], numerics: R.Numerics) -> Dict[str, float]:
        """The numbers of the module's doc for the call ends ``got``."""
        out = {}
        ref = self.trajectory(numerics, self.follow_calls)
        out["loss_gap"] = max(abs(g["loss"] - r["loss"]) / abs(r["loss"])
                              for g, r in zip(got, ref))
        out["moment_gap"], out["moment_gap_median"], out["moment_angle"], kept = \
            _leaf_gaps(got[0]["mu"], ref[0]["mu"])
        p0 = self.start["params"]
        change = lambda ps: [a - b for a, b in zip(ps, p0)]  # noqa: E731
        out["change_gap"] = _leaf_gaps(change(got[self.follow_calls - 1]["params"]),
                                       change(ref[-1]["params"]), kept)[0]
        if ref[-1]["grid"] is not None:
            out["grid_gap"] = float(torch.linalg.norm(got[self.follow_calls - 1]["grid"]
                                                      - ref[-1]["grid"])
                                    / torch.linalg.norm(ref[-1]["grid"]))
        self.log(f"followed: leaves {len(kept)} of {len(p0)} kept; losses at call ends: program "
                 f"{[g['loss'] for g in got[:self.follow_calls]]}, reference "
                 f"{[r['loss'] for r in ref]}")
        forced: Dict[str, List[float]] = {}
        decay = ADAM_B1 ** self.spc
        for k, g in enumerate(got):
            start = self.start if k == 0 else got[k - 1]
            ups = self.updates_in(k)
            if len(ups) > 1:
                continue
            r = self.reference_call(numerics, start, k, {ups[0]: g["grid"]} if ups else None)
            added = lambda mu: [m - decay * m0 for m, m0 in zip(mu, start["mu"])]  # noqa: E731
            moment = _leaf_gaps(added(g["mu"]), added(r["mu"]))
            moved = lambda ps: [a - b for a, b in zip(ps, start["params"])]  # noqa: E731
            changes = _leaf_gaps(moved(g["params"]), moved(r["params"]), moment[3])
            row = {"forced_loss_gap": abs(g["loss"] - r["loss"]) / abs(r["loss"]),
                   "forced_coarse_gap": abs(g["coarse"] - r["coarse"]) / abs(r["coarse"]),
                   "forced_moment_gap": moment[0], "forced_moment_gap_median": moment[1],
                   "forced_moment_angle": moment[2], "forced_change_gap": changes[0],
                   "forced_change_gap_median": changes[1]}
            if ups:
                own = r["updates"][ups[0]]
                row["forced_grid_gap"] = float(torch.linalg.norm(g["grid"] - own)
                                               / torch.linalg.norm(own))
            self.log(f"forced call {k}: loss program {g['loss']!r} reference {r['loss']!r}, "
                     f"coarse {g['coarse']!r} / {r['coarse']!r}; "
                     + ", ".join(f"{name} {v!r}" for name, v in row.items() if "loss" not in name)
                     + f"; leaves {len(moment[3])} of {len(p0)} kept")
            for name, v in row.items():
                forced.setdefault(name, []).append(v)
        out.update({name: max(vs) for name, vs in forced.items()})
        out["forced_moment_angle_median_call"] = statistics.median(forced["forced_moment_angle"])
        return out

    def check(self) -> Dict[str, float]:
        return self.compare(self.observed, R.reference_numerics(self.cfg))

    def control(self) -> Dict[str, float]:
        """The reference in the control's precision in the program's place."""
        return self.compare(self.trajectory(R.control_numerics(self.cfg), self.calls_checked),
                            R.reference_numerics(self.cfg))
