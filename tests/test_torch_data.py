"""The port's scene loader and tree writer against the JAX package's:
``SyntheticScene.load`` on the shared fixture tree (images, poses, focal
exactly equal), each package loading the other's ``save_scene_tree``
output, the frame rays, and the procedural-tree command line."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimal_nerf_torch.data import procedural as t_proc
from minimal_nerf_torch.data.synthetic import SyntheticScene as TScene
from minimal_nerf_tpu.data import procedural as j_proc
from minimal_nerf_tpu.data.synthetic import SyntheticScene as JScene


def _assert_same_scene(t, j):
    np.testing.assert_array_equal(t.images.numpy(), np.asarray(j.images))
    np.testing.assert_array_equal(t.poses.numpy(), np.asarray(j.poses))
    assert t.images.dtype == torch.uint8 and t.poses.dtype == torch.float32
    assert t.focal == j.focal and t.camera_angle_x == j.camera_angle_x
    assert (t.num_frames, t.height, t.width) == (j.num_frames, j.height, j.width)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_load_equals_jax_on_the_fixture_tree(fixture_scene, split):
    t = TScene.load(fixture_scene, split, device="cpu")
    _assert_same_scene(t, JScene.load(fixture_scene, split))
    assert t.split == split and t.base_dir == str(fixture_scene)


def test_load_refuses_the_card_without_one(fixture_scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TScene.load(fixture_scene, "train")


def test_each_package_loads_the_others_tree(tmp_path):
    """JAX's procedural tree (written through imageio) loads the same in
    the port; the port's (its own PNG encoder) loads the same in JAX; both
    trees have the same JSON."""
    j_scenes, _ = j_proc.make_procedural_scene((("train", 2), ("val", 1)), height=12, width=10,
                                               gt_samples=16, chunk=512)
    j_proc.save_scene_tree(j_scenes, tmp_path / "jax")
    t_scenes, _ = t_proc.make_procedural_scene((("train", 2), ("val", 1)), height=12, width=10,
                                               gt_samples=16, device="cpu")
    t_proc.save_scene_tree(t_scenes, tmp_path / "torch")
    for split in ("train", "val"):
        _assert_same_scene(TScene.load(tmp_path / "jax", split, device="cpu"),
                           JScene.load(tmp_path / "jax", split))
        t_loaded = TScene.load(tmp_path / "torch", split, device="cpu")
        _assert_same_scene(t_loaded, JScene.load(tmp_path / "torch", split))
        assert torch.equal(t_loaded.images, t_scenes[split].images)
        assert torch.equal(t_loaded.poses, t_scenes[split].poses)
        metas = [json.loads((tmp_path / pkg / f"transforms_{split}.json").read_text())
                 for pkg in ("jax", "torch")]
        assert [sorted(m) for m in metas] == [["camera_angle_x", "frames"]] * 2
        for fj, ft in zip(metas[0]["frames"], metas[1]["frames"]):
            assert fj["file_path"] == ft["file_path"] and sorted(fj) == sorted(ft)


def test_frame_rays_equal_jax(fixture_scene):
    t = TScene.load(fixture_scene, "val", device="cpu")
    j = JScene.load(fixture_scene, "val")
    for idx in range(t.num_frames):
        to, td = t.frame_rays(idx)
        jo, jd = j.frame_rays(idx)
        assert to.shape == (t.height, t.width, 3)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=0)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert isinstance(jo, jnp.ndarray) and jax.default_backend() == "cpu"


def test_procedural_cli_writes_a_tree(tmp_path, capsys):
    out = t_proc.main(["--out", str(tmp_path / "tree"), "--size", "8", "--train-frames", "3",
                       "--gt-samples", "8", "--scene", "object", "--device", "cpu"])
    assert "wrote procedural scene" in capsys.readouterr().out
    for split, n in (("train", 3), ("val", 2), ("test", 4)):
        scene = JScene.load(out, split)
        assert scene.images.shape == (n, 8, 8, 3)
    with pytest.raises(SystemExit):
        t_proc.main(["--out", str(tmp_path / "x"), "--scene", "cube", "--device", "cpu"])
