"""The port's ``simple`` mode (the 2-D image MLP), the NDC projection and
the ``nerf_helpers`` facade against the JAX package's: ``image_nerf_apply``
and its init layout, the photo datasets, ``photo_nerf_to_image``, one step
of ``train_simple_image`` on a fixed batch against JAX's loss, gradients and
optax's Adam, ``train simple`` through ``train.main``,
``convert_to_ndc_rays``, and a twin of ``tests/test_nerf_helpers_facade.py``.
Photos are written by the port's PNG encoder; small widths, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minimal_nerf_torch import nerf_helpers as t_helpers
from minimal_nerf_torch import train as t_train
from minimal_nerf_torch import views as t_views
from minimal_nerf_torch.data import photo as t_photo
from minimal_nerf_torch.models import image_nerf as t_img
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.ops import cameras as t_cam
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import simple as t_simple
from minimal_nerf_torch.utils import imageio as t_mio
from minimal_nerf_tpu import views as j_views
from minimal_nerf_tpu.data import photo as j_photo
from minimal_nerf_tpu.models import image_nerf as j_img
from minimal_nerf_tpu.ops import cameras as j_cam

H, W = 12, 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU work on one thread (see tests/test_torch_trainer.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def photo(tmp_path):
    """A 12x10 RGB photo of random colours, written by the port's encoder."""
    im = np.random.default_rng(0).integers(0, 256, (H, W, 3), dtype=np.uint8)
    path = tmp_path / "photo.png"
    t_mio.imwrite(path, im)
    return path, im


def _jax_params(seed, position_dim):
    return jax.device_get(j_img.init_image_nerf(jax.random.PRNGKey(seed), position_dim))


@pytest.mark.parametrize("position_dim", [0, 4])
def test_image_nerf_apply_matches_jax(position_dim):
    """The forward on shared weights within rtol 1e-5 / atol 1e-6, with and
    without the encoding; the port's init has JAX's layout and shapes, and
    ``image_params_from_jax`` refuses another layout."""
    jp = _jax_params(1, position_dim)
    x = np.random.default_rng(2).uniform(size=(37, 2)).astype(np.float32)
    want = np.asarray(j_img.image_nerf_apply(jax.tree_util.tree_map(jnp.asarray, jp),
                                             jnp.asarray(x), position_dim))
    tp = t_img.image_params_from_jax(jp, position_dim, "cpu")
    got = t_img.image_nerf_apply(tp, torch.from_numpy(x), position_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert want.std() > 1e-4
    mine = t_img.init_image_nerf(torch.Generator().manual_seed(0), position_dim, "cpu")
    assert [(tuple(l["w"].shape), tuple(l["b"].shape)) for l in mine["layers"]] == [
        (a["w"].shape, a["b"].shape) for a in jp["layers"]]
    assert len(mine["layers"]) == 9
    model = t_img.ImageNeRFModel(position_dim, params=tp, device="cpu")
    assert torch.equal(model(torch.from_numpy(x)), got)
    with pytest.raises(ValueError, match="image MLP"):
        t_img.image_params_from_jax(jp, position_dim + 1, "cpu")


def test_photo_dataset_matches_jax(photo):
    """``PhotoDataset``'s first and last pixel (``tests/test_data.py``), its
    coordinates and colours equal to JAX's, ``ValDataset``'s size, and an
    epoch of ``getPhotoDataloader`` batches covering distinct pixels."""
    path, im = photo
    tds, jds = t_photo.PhotoDataset(path), j_photo.PhotoDataset(str(path))
    coords, rgb = tds[0]
    np.testing.assert_allclose(coords, np.zeros(2))
    np.testing.assert_array_equal(rgb, im[0, 0] / np.float32(255.0))
    coords, rgb = tds[len(tds) - 1]
    np.testing.assert_allclose(coords, np.ones(2))
    assert len(tds) == len(jds) == H * W and (tds.H, tds.W, tds.C) == (H, W, 3)
    np.testing.assert_array_equal(tds.coords, jds.coords)
    np.testing.assert_array_equal(tds.rgb, jds.rgb)
    for i in (0, 7, H * W - 1):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(a, b)
    assert len(t_photo.getValDataloader(path)) == 1
    assert t_photo.ValDataset(path)[0] == (H, W)
    loader = t_photo.getPhotoDataloader(path, batch_size=32, seed=3, device="cpu")
    batches = list(loader.epoch(0))
    assert len(batches) == H * W // 32
    seen = torch.cat([c for c, _ in batches])
    assert seen.shape == (96, 2) and len({tuple(r) for r in seen.tolist()}) == 96
    again = list(loader.epoch(0))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(batches, again))
    assert not torch.equal(batches[0][0], next(iter(loader.epoch(1)))[0])
    ordered = next(tds.batches(torch.Generator(), 8, shuffle=False, device="cpu"))
    np.testing.assert_array_equal(ordered[0].numpy(), tds.coords[:8])


def test_photo_nerf_to_image_matches_jax():
    """Every pixel of a 12x10 image through the same image MLP, in 16-pixel
    chunks (a ragged last one) on both sides: within rtol 1e-5 / atol 1e-6."""
    jp = _jax_params(4, 3)
    want = j_views.photo_nerf_to_image(
        lambda c: j_img.image_nerf_apply(jax.tree_util.tree_map(jnp.asarray, jp), c, 3), H, W,
        chunk=16)
    tp = t_img.image_params_from_jax(jp, 3, "cpu")
    got = t_views.photo_nerf_to_image(lambda c: t_img.image_nerf_apply(tp, c, 3), H, W,
                                      chunk=16, device="cpu")
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_simple_step_matches_jax():
    """One step of ``train_simple_image``'s update (``simple_step``) on a
    fixed batch against JAX's (``jax.value_and_grad`` of the same MSE, then
    ``optax.adam(5e-4)``): the loss within 1e-5, every gradient within 5e-5
    of its leaf's largest, the parameters after Adam within 1e-3 lr save
    where a gradient is within 1e-6 of 0 (up to 2 lr there)."""
    pd, lr = 4, 5e-4
    jp = _jax_params(5, pd)
    rng = np.random.default_rng(6)
    coords = rng.uniform(size=(64, 2)).astype(np.float32)
    rgb = rng.uniform(size=(64, 3)).astype(np.float32)

    def loss_fn(p):
        return jnp.mean((j_img.image_nerf_apply(p, jnp.asarray(coords), pd) - rgb) ** 2)

    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    j_loss, j_grads = jax.value_and_grad(loss_fn)(j_params)
    tx = optax.adam(lr)
    updates, _ = tx.update(j_grads, tx.init(j_params), j_params)
    j_after = jax.device_get(optax.apply_updates(j_params, updates))

    tp = t_img.image_params_from_jax(jp, pd, "cpu")
    loss, grads = t_simple.simple_loss_and_grads(tp, torch.from_numpy(coords),
                                                 torch.from_numpy(rgb), pd)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    j_leaves = t_ckpt.flatten_tree(jax.device_get(j_grads))
    for a, b in zip(j_leaves, t_ckpt.flatten_tree(grads)):
        assert np.abs(b.numpy() - a).max() <= 5e-5 * np.abs(a).max()
    state, step_loss = t_simple.simple_step(tp, {"count": 0, **{
        k: t_ckpt.unflatten_tree(tp, [torch.zeros_like(t) for t in t_ckpt.flatten_tree(tp)])
        for k in ("mu", "nu")}}, torch.from_numpy(coords), torch.from_numpy(rgb), pd, lr)
    assert state["count"] == 1 and float(step_loss) == float(loss)
    for a, b, g in zip(t_ckpt.flatten_tree(j_after), t_ckpt.flatten_tree(tp), j_leaves):
        diff, near = np.abs(b.detach().numpy() - a), np.abs(g) < 1e-6
        assert diff[~near].max(initial=0) <= 1e-3 * lr
        assert diff[near].max(initial=0) <= 2 * lr


def test_train_simple_image_learns_and_logs(photo, tmp_path):
    """``train_simple_image`` on the CPU: a CSV row every ``log_every``
    steps and at the last, the reconstruction PNG at ``val_every`` and at
    the last step, and a loss that falls."""
    path, _ = photo
    params = t_simple.train_simple_image(path, tmp_path, "img", 30, position_dim=3,
                                         batch_size=64, lr=5e-3, val_every=20, log_every=10,
                                         device="cpu")
    rows = (tmp_path / "img" / "metrics.csv").read_text().splitlines()
    assert rows[0].split(",")[:2] == ["step", "train_loss"]
    losses = [float(r.split(",")[1]) for r in rows[1:]]
    assert [int(r.split(",")[0]) for r in rows[1:]] == [10, 20, 30]
    assert losses[-1] < losses[0]
    pngs = sorted(p.name for p in (tmp_path / "img" / "images").glob("*.png"))
    assert pngs == ["recon-20.png", "recon-30.png"]
    recon = t_mio.imread(tmp_path / "img" / "images" / "recon-30.png")
    assert recon.shape == (H, W, 3)
    assert len(params["layers"]) == 9


def test_train_simple_cli(photo, tmp_path):
    """``train simple`` through ``train.main`` (``tests/test_cli.py``'s
    ``test_train_simple_cli``): metrics.csv and the reconstruction PNG at
    the final step."""
    path, _ = photo
    params = t_train.main(["--device", "cpu", "-n", "simpletest", "-s", "4", "-r", "128", "-rd",
                           str(tmp_path), "-p", "3", "simple", "-i", str(path)])
    assert (tmp_path / "simpletest" / "metrics.csv").exists()
    assert [p.name for p in (tmp_path / "simpletest" / "images").glob("*.png")] == [
        "recon-4.png"]
    assert params["layers"][0]["w"].shape == (12, 256)


def test_convert_to_ndc_rays_matches_jax():
    """NDC rays of front-facing rays (o behind the camera plane, d toward
    -z) within rtol 1e-6 / atol 1e-6; the directions of unit length."""
    rng = np.random.default_rng(7)
    o = (rng.normal(size=(5, 7, 3)) * 0.2).astype(np.float32)
    d = np.concatenate([rng.normal(size=(5, 7, 2)) * 0.3, -np.ones((5, 7, 1))],
                       -1).astype(np.float32)
    want = j_cam.convert_to_ndc_rays(jnp.asarray(o), jnp.asarray(d), 30.0, 40, 30, near=1.0)
    got = t_cam.convert_to_ndc_rays(torch.from_numpy(o), torch.from_numpy(d), 30.0, 40, 30,
                                    near=1.0)
    for a, b in zip(got, want):
        assert a.shape == (5, 7, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(got[1], dim=-1).numpy(), 1.0, rtol=1e-6)


def test_facade_exports():
    """``tests/test_nerf_helpers_facade.py::test_facade_exports`` for the port."""
    for name in (
        "generate_coarse_samples", "generate_deltas",
        "calculate_unnormalized_weights", "estimate_ray_color",
        "inverse_transform_sampling", "get_rays", "pose_spherical",
        "convert_to_ndc_rays", "fix_batchify", "view_reconstruction",
        "generate_360_view_synthesis", "photo_nerf_to_image",
    ):
        assert hasattr(t_helpers, name), name
    assert t_helpers.convert_to_ndc_rays is t_cam.convert_to_ndc_rays
    assert t_helpers.photo_nerf_to_image is t_views.photo_nerf_to_image


def test_fix_batchify():
    batch = {"a": torch.ones((1, 8, 3)), "b": torch.zeros((1, 4))}
    t_helpers.fix_batchify(batch)
    assert batch["a"].shape == (8, 3)
    assert batch["b"].shape == (4,)


def test_view_reconstruction_with_model_wrapper():
    """A ``NeRFNetwork`` wrapper and a raw render chunk through the facade's
    reference-signature ``view_reconstruction``; ``torch_to_numpy`` moves a
    CHW batch to HWC and rescales."""
    net = t_nerf.NeRFNetwork(coarse_samples=4, fine_samples=4, device="cpu")
    o = torch.zeros((8, 8, 3))
    d = torch.ones((8, 8, 3))
    im = t_helpers.view_reconstruction(net, o, d, N=32)
    assert im.shape == (8, 8, 3)
    assert im.dtype == np.uint8
    chunk = t_helpers.view_reconstruction(lambda o, d, g: torch.full_like(o, 0.5), o, d, N=16)
    assert (chunk == 127).all()
    arr = t_helpers.torch_to_numpy(torch.full((2, 3, 4, 5), 0.5), is_normalized_image=True)
    assert arr.shape == (2, 4, 5, 3) and np.allclose(arr, 127.5)
