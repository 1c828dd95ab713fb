"""``python -m minimal_nerf_torch.train`` against ``train_nerf.py``: for each
command line both build the same phases and the same ``NeRFConfig`` and
``TrainConfig`` (each package's ``Trainer`` replaced by a recorder); a
two-phase run on the CPU; the flags that are not ported raise."""

import json
import math

import numpy as np
import pytest
import torch

import train_nerf
from minimal_nerf_torch import train as t_train
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import trainer as t_trainer
from minimal_nerf_torch.training.config import TrainConfig
from minimal_nerf_torch.utils import profiling
from minimal_nerf_tpu.training import trainer as j_trainer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny CPU runs take one thread: with a thread per core in every
    parallel test worker, PyTorch's threads mostly wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class _Logger:
    def close(self):
        pass


def _recorder(calls):
    class Recorder:
        def __init__(self, nerf_config, train_config, base_dir, root_dir, name="nerf",
                     resume_ckpt=None, initial_state=None, **kw):
            calls.append(dict(nerf=nerf_config.to_dict(), train=train_config.to_dict(),
                              base_dir=str(base_dir), root_dir=str(root_dir), name=name,
                              resume_ckpt=resume_ckpt, handoff=initial_state))
            self.logger = _Logger()
            self._end = train_config.max_steps

        def fit(self):
            self.final_state = ("state", self._end)

    return Recorder


@pytest.fixture
def ckpt_at_30(tmp_path):
    cfg = t_nerf.NeRFConfig(position_dim=2, direction_dim=1)
    params = t_nerf.init_nerf_network(torch.Generator().manual_seed(0), cfg, device="cpu")
    return t_ckpt.save_checkpoint(tmp_path / t_ckpt.checkpoint_name("x", 3, 30), params, 30,
                                  cfg.to_dict(), TrainConfig().to_dict())


ARGVS = {
    "plain": ["full", "-b", "B"],
    "fast": ["full", "-b", "B", "--fast"],
    "fast -c 64": ["full", "-b", "B", "--fast", "-c", "64"],
    "fast --no-occupancy": ["full", "-b", "B", "--fast", "--no-occupancy"],
    "finish-steps": ["full", "-b", "B", "--fast", "--finish-steps", "20"],
    "budget-schedule": ["full", "-b", "B", "--budget-schedule", "16+48:20,32+96:10,64+128"],
    "finetune-steps": ["-l", "CKPT", "full", "-b", "B", "--finetune-steps", "5"],
    "occupancy flags": ["full", "-b", "B", "--occupancy", "--occ-resolution", "32",
                        "--occ-bound", "2.5", "--occ-threshold", "0.05", "--occ-rel-threshold",
                        "0", "--occ-decay", "0.8", "--occ-grid-source", "both",
                        "--occ-probe-method", "gather", "--occ-update-every", "8",
                        "--occ-warmup-steps", "10", "--occ-num-bins", "32", "--occ-floor",
                        "0.1", "--occ-no-jitter"],
    "lr-floor and the rest": ["-r", "1024", "--precision", "fp32", "--seed", "3",
                              "--log-every", "10", "--val-render-every", "2", "-p", "6", "-d",
                              "3", "--kernel", "pallas", "--steps-per-call", "4", "--gpu",
                              "-l", "auto", "full", "-b", "B", "--lr-floor", "1e-5", "-nr",
                              "1", "-fr", "5", "-cr", "2", "--fine-sampling", "linterp"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_cli_builds_the_configs_and_phases_of_train_nerf(name, monkeypatch, tmp_path,
                                                        ckpt_at_30):
    argv = ["-n", "run", "-s", "50", "-rd", str(tmp_path)] + [
        {"B": str(tmp_path / "scene"), "CKPT": str(ckpt_at_30)}.get(a, a) for a in ARGVS[name]]
    j_calls, t_calls = [], []
    monkeypatch.setattr(j_trainer, "Trainer", _recorder(j_calls))
    monkeypatch.setattr(t_trainer, "Trainer", _recorder(t_calls))
    train_nerf.main(list(argv))
    t_train.main(["--device", "cpu"] + argv)
    assert t_calls == j_calls and len(t_calls) >= 1
    assert [c["handoff"] for c in t_calls[1:]] == [("state", c["train"]["max_steps"])
                                                   for c in t_calls[:-1]]
    phases = {"finish-steps": [(16, 48, 30), (64, 128, 50)],
              "budget-schedule": [(16, 48, 20), (32, 96, 30), (64, 128, 50)],
              "finetune-steps": [(64, 128, 35)]}.get(name)
    if phases:
        assert [(c["nerf"]["coarse_samples"], c["nerf"]["fine_samples"],
                 c["train"]["max_steps"]) for c in t_calls] == phases


def test_two_phase_run_on_the_cpu(fixture_scene, tmp_path):
    """``--finish-steps 2`` on the fixture tree: phase 1 at 8+8 to step 2,
    phase 2 at 8+16 on from its state in memory to step 4; both phases'
    checkpoints and one CSV history; a profiler trace of the run; NaN
    checks on."""
    argv = ["--device", "cpu", "-n", "two", "-s", "4", "-r", "32", "--precision", "fp32",
            "--log-every", "2", "-p", "4", "-d", "2", "-rd", str(tmp_path), "--profile",
            str(tmp_path / "trace"), "--debug-nans", "full", "-b", str(fixture_scene), "-c",
            "8", "-f", "8", "--finish-steps", "2", "--finish-coarse", "8", "--finish-fine",
            "16"]
    tr = t_train.main(argv)
    run = tmp_path / "two"
    assert tr.final_state[3] == 4 and tr.nerf_config.fine_samples == 16
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "model=two-epoch=0-step=2.ckpt", "model=two-epoch=1-step=4.ckpt"]
    assert t_ckpt.read_header(run / "checkpoints" / "model=two-epoch=0-step=2.ckpt")[
        "nerf_config"]["fine_samples"] == 8
    rows = (run / "metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["2", "4"]
    assert all(math.isfinite(float(v)) for r in rows[1:] for v in r.split(",")[1:])
    assert json.loads((run / "hparams.json").read_text())["fine_samples"] == "16"
    traces = list((tmp_path / "trace").glob("trace-*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(traces[0].read_text())
    assert not profiling.debug_enabled()


@pytest.mark.parametrize("extra,error,match", [
    (["--data-parallel", "2", "simple"], ValueError, "one device"),
    (["--multihost", "simple"], ValueError, "one device"),
    (["--data-parallel", "-1", "full"], ValueError, "mesh"),
    (["--multihost", "full"], ValueError, "coordinator"),
    (["--wandb", "NeRF", "full"], NotImplementedError, "wandb"),
    (["full", "--finish-steps", "2", "--budget-schedule", "16+48"], SystemExit, None),
    (["full", "--budget-schedule", "16+48:3,64+128:3"], SystemExit, None),
    (["full", "--finetune-steps", "3"], SystemExit, None),
])
def test_flags_that_are_not_ported_raise(fixture_scene, tmp_path, extra, error, match):
    argv = ["--device", "cpu", "-n", "x", "-s", "10", "-rd", str(tmp_path)] + extra
    if extra[-1] == "full" or extra[0] == "full":
        argv += ["-b", str(fixture_scene)]
    with pytest.raises(error, match=match):
        t_train.main(argv)
    assert not (tmp_path / "x" / "checkpoints").exists()


def test_cli_refuses_the_card_without_one(fixture_scene, tmp_path):
    """The default ``--device cuda`` raises without a card: the CLI never
    carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_train.main(["-n", "x", "-s", "2", "-rd", str(tmp_path), "full", "-b",
                      str(fixture_scene)])


def test_debug_mode_raises_on_a_non_finite_loss():
    profiling.check_finite("loss", torch.tensor(float("nan")))  # off: nothing happens
    with profiling.debug_mode():
        assert profiling.debug_enabled() and torch.is_anomaly_enabled()
        profiling.check_finite("loss", torch.tensor(1.0))
        with pytest.raises(FloatingPointError, match="non-finite loss at step 3"):
            profiling.check_finite("loss", torch.tensor([1.0, float("inf")]), step=3)
    assert not profiling.debug_enabled() and not torch.is_anomaly_enabled()


def test_step_timer_rates():
    timer = profiling.StepTimer(rays_per_step=4096)
    assert timer.rates() == {}
    timer.tick()
    timer.tick(2)
    rates = timer.rates()
    assert rates["rays_per_sec"] == pytest.approx(4096 * rates["iterations_per_sec"])
    assert np.isfinite(rates["iterations_per_sec"]) and timer.rates() == {}
