"""The port's Trainer and metrics logger against the JAX package's.

The JAX Trainer runs once per case (module-scoped) on the shared fixture
tree (``JAX_CASES``); the port's runs the plain version of its fused
kernels on the CPU. Small: position_dim 4, 8 + 8 samples, 32 rays, fp32,
three train frames per epoch and a validation every epoch. The eval steps
are held against JAX's in ``tests/test_torch_eval.py``.
"""

import csv
import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from minimal_nerf_torch.data.synthetic import SyntheticScene as TScene
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import metrics as t_metrics
from minimal_nerf_torch.training import trainer as t_trainer
from minimal_nerf_torch.utils import imageio as t_mio
from minimal_nerf_tpu.kernels import fused_raymarch as j_fused
from minimal_nerf_tpu.models import nerf as j_nerf
from minimal_nerf_tpu.training import checkpoint as j_ckpt
from minimal_nerf_tpu.training import config as j_config
from minimal_nerf_tpu.training import metrics as j_metrics
from minimal_nerf_tpu.training import trainer as j_trainer

NERF = dict(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
OCC = dict(occupancy=True, occ_resolution=8, occ_num_bins=16, occ_update_every=2,
           occ_warmup_steps=2)
# fixture_scene has 3 train frames: an epoch of 3 steps, a validation and a
# save at steps 3 and 6 (a val view at the first only), a save at 4
# (ckpt_every_steps), rows at 2, 4, 6, 7
TRAIN = dict(num_rays=32, max_steps=7, precision="fp32", log_every=2,
             check_val_every_n_epoch=1, ckpt_every_steps=4, val_render_every=2,
             kernel="fused")
CASES = {"uniform": {}, "occupancy": OCC}
# the JAX Trainer's runs (XLA compiles dominate their cost): occupancy as
# above through the fused render in interpret mode (its metrics.csv has
# every column of a fused run); uniform through the plain render, four
# steps and no validation (its step-4 checkpoint is the one resumed)
JAX_CASES = {"uniform": dict(kernel="xla", max_steps=4, check_val_every_n_epoch=100),
             "occupancy": OCC}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny CPU runs take one thread: with a thread per core in every
    parallel test worker, PyTorch's threads mostly wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _train_cfg(case, **kw):
    return dict(TRAIN, **CASES[case], **kw)


def _csv(path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def _ckpt_names(run_dir):
    return sorted(p.name for p in (run_dir / "checkpoints").glob("*.ckpt"))


def _t_trainer(root, case, name="t", **kw):
    train = {k: kw.pop(k) for k in list(kw) if k in TRAIN or k.startswith("occ")}
    return t_trainer.Trainer(t_nerf.NeRFConfig(**NERF),
                             t_config.TrainConfig(**_train_cfg(case, **train)),
                             kw.pop("base_dir"), root, name=name, device="cpu", **kw)


def _jax_cfg(case):
    return dict(TRAIN, **JAX_CASES[case])


@pytest.fixture(scope="module")
def jax_runs(fixture_scene, tmp_path_factory):
    """The JAX Trainer's run of each of ``JAX_CASES``: its run folder."""
    root = tmp_path_factory.mktemp("jax_runs")
    for case in JAX_CASES:
        fused = _jax_cfg(case)["kernel"] == "fused"
        j_trainer.Trainer(
            j_nerf.NeRFConfig(**NERF), j_config.TrainConfig(**_jax_cfg(case)), fixture_scene,
            root, name=case,
            render_fn=j_fused.make_fused_render_fn(ray_tile=8, interpret=True) if fused else None,
        ).fit()
    return {case: root / case for case in JAX_CASES}


@pytest.fixture(scope="module")
def torch_runs(fixture_scene, tmp_path_factory):
    """The port's unbroken run of each case: ``(run folder, final_state)``."""
    root = tmp_path_factory.mktemp("torch_runs")
    out = {}
    for case in CASES:
        tr = _t_trainer(root, case, name=case, base_dir=fixture_scene)
        tr.fit()
        out[case] = (root / case, tr.final_state)
    return out


def _assert_state_equal(a, b):
    """Two ``(params, opt_state, grid, step)`` bit for bit."""
    (pa, oa, ga, sa), (pb, ob, gb, sb) = a, b
    assert sa == sb and oa["count"] == ob["count"]
    for x, y in zip(t_ckpt.flatten_tree([pa, oa["mu"], oa["nu"]]),
                    t_ckpt.flatten_tree([pb, ob["mu"], ob["nu"]])):
        assert torch.equal(x, y)
    assert (ga is None) == (gb is None)
    if ga is not None:
        assert torch.equal(ga, gb)


# ---------------------------------------------------------------- trainer

@pytest.mark.parametrize("case", list(JAX_CASES))
def test_csv_columns_and_checkpoint_names_match_jax(jax_runs, torch_runs, tmp_path,
                                                    fixture_scene, case):
    """The same metrics.csv header (columns in order) and rows' steps, the
    same checkpoint names and the same hparams keys as the JAX Trainer's run
    of the same configs. ``chip_smoke.py``'s literals of the card runs'
    columns are the JAX fused run's (with occupancy; uniform: the same
    without ``occ_fraction``), and the port's uniform fused run has exactly
    those. The val views are PNGs of the val frames' size."""
    j_dir = jax_runs[case]
    if case == "occupancy":
        t_dir = torch_runs[case][0]
    else:
        _t_trainer(tmp_path, case, name=case, base_dir=fixture_scene, **JAX_CASES[case]).fit()
        t_dir = tmp_path / case
    j_head, j_rows = _csv(j_dir / "metrics.csv")
    t_head, t_rows = _csv(t_dir / "metrics.csv")
    assert t_head == j_head
    assert [r["step"] for r in t_rows] == [r["step"] for r in j_rows]
    assert _ckpt_names(t_dir) == _ckpt_names(j_dir)
    assert (json.loads((t_dir / "hparams.json").read_text()).keys()
            == json.loads((j_dir / "hparams.json").read_text()).keys())
    for row in t_rows:
        vals = [float(v) for v in row.values() if v != ""]
        assert all(np.isfinite(vals))
    if case == "uniform":
        assert [r["step"] for r in t_rows] == ["2", "4"] and "coarse_density_norms" in t_head
        assert _ckpt_names(t_dir) == ["model=uniform-epoch=1-step=4.ckpt"]
        return
    assert [r["step"] for r in t_rows] == ["2", "3", "4", "6", "6", "7"]
    assert _ckpt_names(t_dir) == [
        f"model={case}-epoch={e}-step={s}.ckpt" for e, s in ((1, 3), (1, 4), (2, 6), (2, 7))]
    assert t_head == chip_smoke.TRAINER_FAST_COLUMNS
    assert chip_smoke.TRAINER_COLUMNS == [c for c in j_head if c != "occ_fraction"]
    assert _csv(torch_runs["uniform"][0] / "metrics.csv")[0] == chip_smoke.TRAINER_COLUMNS
    images = [p.name for p in (t_dir / "images").iterdir()]
    for run_images in (images, [p.name for p in (j_dir / "images").iterdir()]):
        assert [n.rsplit("-", 1)[1] for n in run_images] == ["3.png"]
    for name in images:
        assert t_mio.imread(t_dir / "images" / name).shape == (64, 64, 3)


@pytest.mark.parametrize("how", ["auto", "handoff"])
@pytest.mark.parametrize("case", list(CASES))
def test_resumed_run_equals_unbroken_run(fixture_scene, torch_runs, tmp_path, case, how):
    """Four steps, then on to seven by ``resume_ckpt="auto"`` (the step-4
    checkpoint) or by ``initial_state`` (the first Trainer's
    ``final_state``): the same params, Adam state and grid as the unbroken
    run, bit for bit; the resumed run appends to the first run's CSV."""
    first = _t_trainer(tmp_path, case, base_dir=fixture_scene, max_steps=4)
    first.fit()
    if how == "auto":
        second = _t_trainer(tmp_path, case, base_dir=fixture_scene, resume_ckpt="auto")
    else:
        second = _t_trainer(tmp_path, case, base_dir=fixture_scene,
                            initial_state=first.final_state)
    second.fit()
    _assert_state_equal(second.final_state, torch_runs[case][1])
    steps = [r["step"] for r in _csv(tmp_path / "t" / "metrics.csv")[1]]
    assert steps == ["2", "3", "4", "6", "6", "7"]


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoints_resume_across_packages(jax_runs, torch_runs, fixture_scene, tmp_path,
                                            case):
    """The JAX Trainer's step-4 checkpoint resumes in the port with its
    params, Adam state and grid exactly, and the port's in the JAX Trainer;
    the port trains on from JAX's."""
    j_path = jax_runs[case] / "checkpoints" / f"model={case}-epoch=1-step=4.ckpt"
    header, leaves = j_ckpt.load_checkpoint(j_path)
    tr = _t_trainer(tmp_path, case, base_dir=fixture_scene, resume_ckpt=str(j_path))
    params, opt, step = tr.init_state()
    grid = [] if tr._grid is None else [tr._grid]
    got = grid + [torch.tensor(opt["count"])] + t_ckpt.flatten_tree([opt["mu"], opt["nu"]]) \
        + [torch.tensor(opt["count"])] + t_ckpt.flatten_tree(params)
    assert step == 4 and len(got) == header["num_leaves"] == (123 if case == "occupancy" else 122)
    for i, t in enumerate(got):
        np.testing.assert_array_equal(t.numpy(), leaves[i])
    tr.fit()
    assert tr.final_state[3] == 7

    t_path = torch_runs[case][0] / "checkpoints" / f"model={case}-epoch=1-step=4.ckpt"
    jt = j_trainer.Trainer(j_nerf.NeRFConfig(**NERF), j_config.TrainConfig(**_train_cfg(case)),
                           fixture_scene, tmp_path / "jax", name=case, resume_ckpt=str(t_path))
    j_params, j_opt, j_step = jt.init_state()
    _, t_leaves = t_ckpt.load_checkpoint(t_path)
    j_state = {"params": j_params, "opt_state": j_opt if jt._grid is None
               else {"opt": j_opt, "occ_ema": jt._grid}}
    j_leaves = jax.tree_util.tree_leaves(j_state)
    assert j_step == 4 and len(j_leaves) == len(t_leaves)
    for i, leaf in enumerate(j_leaves):
        np.testing.assert_array_equal(np.asarray(leaf), t_leaves[i])


def test_resume_at_or_past_max_steps_does_nothing(torch_runs, fixture_scene, tmp_path, capsys):
    src = torch_runs["uniform"][0] / "checkpoints" / "model=uniform-epoch=2-step=7.ckpt"
    tr = _t_trainer(tmp_path, "uniform", base_dir=fixture_scene, resume_ckpt=str(src),
                    max_steps=5)
    tr.fit()
    assert "nothing to do" in capsys.readouterr().err
    assert tr.final_state[3] == 7 and _ckpt_names(tmp_path / "t") == []


def test_in_memory_scene(fixture_scene, tmp_path):
    """A dict of in-memory scenes trains like the tree it came from."""
    scenes = {s: TScene.load(fixture_scene, s, device="cpu") for s in ("train", "val")}
    runs = []
    for i, base in enumerate((scenes, fixture_scene)):
        tr = _t_trainer(tmp_path, "uniform", name=f"r{i}", base_dir=base, max_steps=3)
        tr.fit()
        runs.append(tr.final_state)
    _assert_state_equal(*runs)


def test_validation_render_chunk_is_never_static(fixture_scene, tmp_path):
    """The validation's render chunk takes parameters that training updates
    in place: it is never a ``StaticRenderChunk`` and replays no graph."""
    from minimal_nerf_torch import views
    from minimal_nerf_torch.utils import profiling

    tr = _t_trainer(tmp_path, "occupancy", base_dir=fixture_scene, max_steps=3)
    profiling.reset()
    tr.fit()
    assert tr._val_render_chunk is not None
    assert not isinstance(tr._val_render_chunk, views.StaticRenderChunk)
    assert profiling.counter("view.graph_replays") == 0


def test_ckpt_auto_on_a_fresh_run_does_not_adopt_a_stale_csv(fixture_scene, tmp_path):
    run = tmp_path / "t"
    run.mkdir()
    (run / "metrics.csv").write_text("step,stale\n99,1.0\n")
    tr = _t_trainer(tmp_path, "uniform", base_dir=fixture_scene, resume_ckpt="auto",
                    max_steps=2)
    assert tr.resume_ckpt is None
    tr.fit()
    head, rows = _csv(run / "metrics.csv")
    assert "stale" not in head and [r["step"] for r in rows] == ["2"]


def test_failed_async_save_surfaces_at_the_next_save(fixture_scene, tmp_path, monkeypatch):
    tr = _t_trainer(tmp_path, "uniform", base_dir=fixture_scene, max_steps=2)
    params, opt, _ = tr.init_state()

    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(t_ckpt, "save_checkpoint", broken)
    path = tr.save(params, opt, 1)
    assert path.name == "model=t-epoch=0-step=1.ckpt"
    tr._pending_save.exception(timeout=30)  # the background write has failed
    monkeypatch.undo()
    with pytest.raises(OSError, match="disk full"):
        tr.save(params, opt, 2)
    assert tr.save(params, opt, 2, blocking=True).is_file()


def test_async_save_copies_the_state_before_returning(fixture_scene, tmp_path):
    """The step updates params in place: a save must hold the values of the
    moment it was asked for."""
    tr = _t_trainer(tmp_path, "occupancy", base_dir=fixture_scene)
    params, opt, _ = tr.init_state()
    before = [t.clone() for t in t_ckpt.flatten_tree(params)]
    fut = t_ckpt.save_checkpoint_async(tmp_path / "a.ckpt", params, opt, 1, {}, {},
                                       grid=tr._grid)
    for t in t_ckpt.flatten_tree(params):
        t.add_(1.0)
    tr._grid.add_(1.0)
    _, leaves = t_ckpt.load_checkpoint(fut.result(timeout=60))
    assert len(leaves) == 123 and not leaves[0].any()
    for i, t in enumerate(before):
        np.testing.assert_array_equal(leaves[len(leaves) - len(before) + i], t.numpy())


def test_metrics_logger_writes_jax_csv_text(tmp_path):
    """The same calls give the same metrics.csv text, hparams.json and
    image path as JAX's logger; resume adopts the history, a fresh logger
    removes it; wandb is refused."""
    calls = [(2, {"train_loss": 0.5, "lr": 5e-4}), (3, {"val_loss": 0.25, "val_seconds": 1.5}),
             (4, {"train_loss": 0.125, "lr": 4e-4}), (6, {"train_loss": 1 / 3})]
    image = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    texts = []
    for pkg, cls in (("jax", j_metrics.MetricsLogger), ("torch", t_metrics.MetricsLogger)):
        logger = cls(tmp_path / pkg, name="m", echo=False)
        for step, scalars in calls[:2]:
            logger.log_scalars(step, scalars)
        logger = cls(tmp_path / pkg, name="m", echo=False, resume=True)
        for step, scalars in calls[2:]:
            logger.log_scalars(step, scalars)
        logger.log_hyperparams({"a": 1, "b": None})
        path = logger.log_image("recon-val0", image, step=3)
        assert path == tmp_path / pkg / "images" / "recon-val0-3.png"
        np.testing.assert_array_equal(t_mio.imread(path), image)
        texts.append(((tmp_path / pkg / "metrics.csv").read_text(),
                      (tmp_path / pkg / "hparams.json").read_text()))
        logger.close()
    assert texts[0] == texts[1]
    t_metrics.MetricsLogger(tmp_path / "torch", echo=False, resume=False)
    assert not (tmp_path / "torch" / "metrics.csv").exists()
    with pytest.raises(NotImplementedError, match="wandb"):
        t_metrics.MetricsLogger(tmp_path / "w", wandb_project="NeRF")
    null = t_metrics.NullLogger()
    null.log_scalars(1, {"a": 1.0})
    assert null.log_image("k", image) is None and null.elapsed() == 0.0


def test_unknown_mode_is_refused(fixture_scene, tmp_path):
    """The Trainer trains "full" and "single" (JAX asserts the same two);
    any other mode, and occupancy outside "full", raise."""
    with pytest.raises(ValueError, match="simple"):
        _t_trainer(tmp_path, "uniform", base_dir=fixture_scene, mode="simple")
    with pytest.raises(ValueError, match="occupancy"):
        _t_trainer(tmp_path, "occupancy", base_dir=fixture_scene, mode="single")


def test_fetch_scalars_sorts_and_fetches_once():
    got = t_trainer.fetch_scalars({"b": torch.tensor(2.0), "a": torch.tensor(1.5),
                                   "c": torch.tensor(3, dtype=torch.int32)})
    assert list(got.items()) == [("a", 1.5), ("b", 2.0), ("c", 3.0)]

