"""The last data modules of the port against the JAX package's: the ``thin``
and ``shell`` procedural archetypes (``SphereField.random_thin``,
``random_shell``) and their trees, the reference-shaped facade
(``SyntheticDataset``, ``SyntheticDataModule``, ``getSyntheticDataloader``)
on the fixture tree, and ``load_model_for_inference`` on both modes'
checkpoints."""

import jax
import numpy as np
import pytest
import torch

from minimal_nerf_torch.data import procedural as t_proc
from minimal_nerf_torch.data import synthetic as t_syn
from minimal_nerf_torch.models import mlp as t_mlp
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import config as t_config
from minimal_nerf_torch.training import trainer as t_trainer
from minimal_nerf_tpu.data import procedural as j_proc
from minimal_nerf_tpu.data import synthetic as j_syn
from minimal_nerf_tpu.data.synthetic import SyntheticScene as JScene
from minimal_nerf_tpu.training import trainer as j_trainer

ARCHETYPES = ("random_thin", "random_shell")


@pytest.mark.parametrize("maker", ARCHETYPES)
@pytest.mark.parametrize("key", [0, 3])
def test_archetype_fields_equal_jax(maker, key):
    """Centers, radii, colors and densities equal, element for element,
    and the analytic field agrees at random points (fp32)."""
    t, j = getattr(t_proc.SphereField, maker)(key), getattr(j_proc.SphereField, maker)(key)
    for name in ("centers", "radii", "colors", "densities"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b), name
    pts = np.random.default_rng(key).uniform(-1.2, 1.2, (64, 5, 3)).astype(np.float32)
    ts, trgb = t.field(torch.from_numpy(pts))
    js, jrgb = j.field(jax.numpy.asarray(pts))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scene", ["thin", "shell"])
def test_archetype_scenes_match_jax(scene):
    """A 16x16 scene of each archetype in both packages (their own
    integration jitter, 128 samples per ray): the same poses, and the
    ground-truth frames within 8 of 255 per pixel and 1 of 255 on average
    (measured: at most 4, mean 0.15)."""
    kw = dict(split_frames=(("train", 2), ("test", 1)), height=16, width=16, gt_samples=128,
              scene=scene)
    t_scenes, t_field = t_proc.make_procedural_scene(**kw, device="cpu")
    j_scenes, j_field = j_proc.make_procedural_scene(**kw, chunk=256)
    assert np.array_equal(t_field.centers, j_field.centers)
    for split in ("train", "test"):
        t, j = t_scenes[split], j_scenes[split]
        np.testing.assert_array_equal(t.poses.numpy(), np.asarray(j.poses))
        diff = np.abs(t.images.numpy().astype(int) - np.asarray(j.images).astype(int))
        assert diff.max() <= 8 and diff.mean() <= 1, (split, diff.max(), diff.mean())
        assert t.images.numpy().max() > 0, "an empty frame shows nothing of the scene"


@pytest.mark.parametrize("scene", ["thin", "shell"])
def test_procedural_cli_writes_archetype_trees(tmp_path, scene):
    """``--scene thin`` and ``--scene shell`` write trees that the JAX
    package loads."""
    out = t_proc.main(["--out", str(tmp_path / scene), "--size", "8", "--train-frames", "2",
                       "--gt-samples", "8", "--scene", scene, "--device", "cpu"])
    for split, n in (("train", 2), ("val", 2), ("test", 4)):
        assert JScene.load(out, split).images.shape == (n, 8, 8, 3)


BATCH_KEYS = {"origin", "direc", "rgb", "xs", "ys"}


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataset_items_match_jax(fixture_scene, split):
    """``getSyntheticDataloader``'s dataset: the length, the reference's
    attributes, each item's keys, shapes and dtypes as JAX's; the frame's
    rays and image equal JAX's; the crop keeps the pixels in the center
    half; an index past the end raises ``IndexError``."""
    t = t_syn.getSyntheticDataloader(fixture_scene, split, 32, cropping=split == "train",
                                     seed=3, device="cpu")
    j = j_syn.getSyntheticDataloader(fixture_scene, split, 32, cropping=split == "train", seed=3)
    assert isinstance(t, torch.utils.data.Dataset)
    assert len(t) == len(j) and (t.H, t.W, t.focal) == (j.H, j.W, j.focal)
    for idx in range(len(t)):
        ti, ji = t[idx], j[idx]
        assert set(ti) == set(ji) == (BATCH_KEYS if split == "train" else
                                      BATCH_KEYS | {"all_origin", "all_direc", "image"})
        for k in ti:
            assert tuple(ti[k].shape) == tuple(np.asarray(ji[k]).shape), k
            assert ti[k].is_floating_point() == np.issubdtype(np.asarray(ji[k]).dtype,
                                                              np.floating), k
        if split != "train":
            for k in ("all_origin", "all_direc", "image"):
                np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]), rtol=1e-6,
                                           atol=1e-6, err_msg=k)
        else:
            for k in ("xs", "ys"):
                assert 16 <= int(ti[k].min()) and int(ti[k].max()) < 48, k
    with pytest.raises(IndexError):
        t[len(t)]
    assert not torch.equal(t[0]["xs"], t[0]["xs"]), "each item draws anew"


def test_data_module_switches_from_crop_to_full(fixture_scene):
    """``SyntheticDataModule``: the cropped train dataset until
    ``cropping_epochs``, then the full one, and the val split, as JAX's."""
    t = t_syn.SyntheticDataModule(fixture_scene, 16, cropping_epochs=2, device="cpu")
    j = j_syn.SyntheticDataModule(fixture_scene, 16, cropping_epochs=2)
    for epoch in (0, 1, 2, 5):
        t.current_epoch = j.current_epoch = epoch
        assert t.train_dataloader().cropping == j.train_dataloader().cropping == (epoch < 2)
    assert t.val_dataloader().tvt == "val" and len(t.val_dataloader()) == len(j.val_dataloader())


@pytest.mark.parametrize("mode", ["full", "single"])
def test_load_model_for_inference_reads_both_modes(tmp_path, mode):
    """The port's and JAX's ``load_model_for_inference`` on one checkpoint
    of each mode: the same leaves and configs."""
    cfg = t_nerf.NeRFConfig(position_dim=4, direction_dim=2, coarse_samples=8, fine_samples=8)
    tcfg = t_config.TrainConfig(num_rays=16, precision="fp32")
    gen = torch.Generator().manual_seed(0)
    params = (t_nerf.init_nerf_network(gen, cfg, device="cpu") if mode == "full" else
              t_mlp.init_nerf_mlp(gen, 4, 2, device="cpu"))
    path = t_ckpt.save_checkpoint(tmp_path / "m.ckpt", params, 7, cfg.to_dict(), tcfg.to_dict(),
                                  extra={"mode": mode})
    t_params, t_cfg, t_tcfg = t_trainer.load_model_for_inference(path, device="cpu")
    j_params, j_cfg, j_tcfg = j_trainer.load_model_for_inference(path)
    assert t_cfg.to_dict() == j_cfg.to_dict() == cfg.to_dict()
    assert t_tcfg.num_rays == j_tcfg.num_rays == 16 and t_tcfg == tcfg
    leaves = t_ckpt.flatten_tree(t_params)
    assert len(leaves) == (40 if mode == "full" else 20)
    for a, b, c in zip(leaves, t_ckpt.flatten_tree(jax.device_get(j_params)),
                       t_ckpt.flatten_tree(params)):
        assert torch.equal(a, c)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
