"""``python -m minimal_nerf_torch.score`` against the JAX package's
``score.py`` on the fixture tree's test split (two 64x64 frames), and the
port's batched pose sweep (``views.render_poses_batched``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import score as j_score
from minimal_nerf_torch import inference as t_inf
from minimal_nerf_torch import score as t_score
from minimal_nerf_torch import views as t_views
from minimal_nerf_torch.data.synthetic import SyntheticScene
from minimal_nerf_torch.ops import cameras as t_cam
from minimal_nerf_torch.ops import image_metrics as t_im
from minimal_nerf_torch.utils import profiling
from minimal_nerf_tpu import inference as j_inf
from minimal_nerf_tpu import views as j_views
from minimal_nerf_tpu.models.nerf import NeRFConfig, init_nerf_network
from minimal_nerf_tpu.training import checkpoint as j_ckpt
from minimal_nerf_tpu.training.config import TrainConfig
from minimal_nerf_tpu.training.loop import make_optimizer

# The two packages' fp32 rays may differ by ulps, which can move a pixel
# across a uint8 level: the frames may differ in at most FLIP_SHARE of their
# values, by one level. At this test's MSE (~8,400) such flips move PSNR by
# < 3e-4 dB and SSIM by < 1e-4; the metrics themselves agree to ~1e-15.
# Measured on this input: the frames and both scores are identical.
PSNR_ATOL, SSIM_ATOL = 1e-3, 1e-4
FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny CPU runs take one thread: with a thread per core in every
    parallel test worker, PyTorch's threads mostly wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A JAX-written checkpoint: position_dim 4, 8 + 8 samples, He-scaled
    weights and a density bias, so the frames are not flat."""
    cfg = NeRFConfig(position_dim=4, coarse_samples=8, fine_samples=8)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) * (np.sqrt(6.0) if p[-1].key == "w" else 1.0),
        jax.device_get(init_nerf_network(jax.random.PRNGKey(0), cfg)))
    for mlp in params.values():
        mlp["density"]["b"] = mlp["density"]["b"] + 0.5
    tcfg = TrainConfig(kernel="fused", precision="fp32")
    path = tmp_path_factory.mktemp("ckpt") / "model=tiny-epoch=1-step=7.ckpt"
    j_ckpt.save_checkpoint(path, params, make_optimizer(tcfg, 100).init(params), 7,
                           cfg.to_dict(), tcfg.to_dict(), extra={"mode": "full"})
    return str(path)


def _smooth(lib):
    """A draw-free render chunk, a fixed smooth function of the rays."""
    return lambda o, d, _key: 0.5 + 0.45 * lib.sin(2.0 * d + 0.7 * o)


def _capture(monkeypatch, module, frames):
    orig = module.render_poses_batched

    def capturing(*args, **kwargs):
        for frame in orig(*args, **kwargs):
            frames.append(np.asarray(frame))
            yield frame

    monkeypatch.setattr(module, "render_poses_batched", capturing)


def test_score_pipeline_matches_jax(fixture_scene, monkeypatch):
    """Both packages' scoring loops on the same draw-free render chunk: the
    same frames (apart from rare one-level flips) and the same scores."""
    monkeypatch.setattr(j_inf, "build_render_chunk",
                        lambda *a, **k: (_smooth(jnp), None, None))
    monkeypatch.setattr(t_inf, "build_render_chunk",
                        lambda *a, **k: (_smooth(torch), None, None))
    j_frames, t_frames = [], []
    _capture(monkeypatch, j_views, j_frames)
    _capture(monkeypatch, t_views, t_frames)
    want = j_score.calculate_scores("unused.ckpt", fixture_scene, 1024, frames_per_dispatch=2)
    got = t_score.calculate_scores("unused.ckpt", fixture_scene, 1024, frames_per_dispatch=2,
                                   device="cpu")
    assert len(j_frames) == len(t_frames) == 2
    for a, b in zip(j_frames, t_frames):
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= FLIP_SHARE
        assert a.std() > 0
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SSIM_ATOL)
    # on the port's own frames, the torch metrics give the numpy copy's means
    scene = SyntheticScene.load(fixture_scene, "test", device="cpu")
    gts = scene.images.numpy()
    np.testing.assert_allclose(
        got, (np.mean([t_im.peak_signal_noise_ratio(g, f) for g, f in zip(gts, t_frames)]),
              np.mean([t_im.structural_similarity(g, f) for g, f in zip(gts, t_frames)])),
        rtol=1e-12)


def test_score_equals_metrics_of_the_sweep(fixture_scene, tiny_ckpt):
    """A real checkpoint through the plain render: the score is the mean of
    the torch metrics over the frames ``render_poses_batched`` gives with
    the score's seeds, and the numpy copy's mean within 1e-9."""
    got = t_score.calculate_scores(tiny_ckpt, fixture_scene, 1024, device="cpu")
    chunk, _, _ = t_inf.build_render_chunk(tiny_ckpt, 1024, device="cpu")
    scene = SyntheticScene.load(fixture_scene, "test", device="cpu")
    frames = list(t_views.render_poses_batched(chunk, scene.poses, scene.height, scene.width,
                                               scene.focal, chunk=1024, device="cpu"))
    assert len(frames) == 2 and frames[0].std() > 0
    pairs = [(g, torch.from_numpy(f)) for g, f in zip(scene.images, frames)]
    want = [0.0, 0.0]
    for g, f in pairs:  # summed in frame order, as score.py sums them
        want = [want[0] + t_im.psnr(g, f).item(), want[1] + t_im.ssim(g, f).item()]
    assert got == (want[0] / 2, want[1] / 2)
    plain = (np.mean([t_im.peak_signal_noise_ratio(g.numpy(), f.numpy()) for g, f in pairs]),
             np.mean([t_im.structural_similarity(g.numpy(), f.numpy()) for g, f in pairs]))
    np.testing.assert_allclose(got, plain, rtol=1e-9)


def test_frames_do_not_depend_on_frames_per_dispatch(tiny_ckpt):
    """4 poses at 1, 3 (a short last batch) and 8 frames per batch, as
    numpy frames and as tensors: the same frames, seeded per frame."""
    chunk, _, _ = t_inf.build_render_chunk(tiny_ckpt, 40, kernel="fused", device="cpu")
    poses = t_cam.spherical_poses(num_poses=4)
    focal = t_cam.focal_from_angle(9, t_views.DEFAULT_CAM_ANGLE_X)
    sweep = lambda fpd, **k: list(t_views.render_poses_batched(  # noqa: E731
        chunk, poses, 10, 9, focal, chunk=40, frames_per_dispatch=fpd, device="cpu", **k))
    want = sweep(1)
    assert len(want) == 4 and all(f.shape == (10, 9, 3) and f.dtype == np.uint8 for f in want)
    assert not np.array_equal(want[0], want[1])
    for fpd in (3, 8):
        for a, b in zip(want, sweep(fpd)):
            np.testing.assert_array_equal(a, b)
        tensors = sweep(fpd, device_frames=True)
        assert all(isinstance(t, torch.Tensor) and t.dtype == torch.uint8 for t in tensors)
        for a, b in zip(want, tensors):
            np.testing.assert_array_equal(a, b.numpy())
    # frame i keeps seed mix_seed(0, i): the third pose alone renders the same
    alone = t_views.render_poses_batched(chunk, poses[2:3], 10, 9, focal, chunk=40,
                                         frame_seeds=[t_views.mix_seed(0, 2)], device="cpu")
    np.testing.assert_array_equal(next(alone), want[2])
    with pytest.raises(ValueError, match="frames_per_dispatch"):
        sweep(0)


@pytest.mark.parametrize("data_parallel, static", [(0, True), (1, True), (2, False)])
def test_only_a_one_device_render_chunk_is_static(tiny_ckpt, data_parallel, static):
    """``build_render_chunk`` marks its chunk as a ``StaticRenderChunk`` (whose
    full chunks a card sweeps as graph replays) on one device alone."""
    chunk, _, _ = t_inf.build_render_chunk(tiny_ckpt, 40, data_parallel=data_parallel,
                                           device="cpu")
    assert isinstance(chunk, t_views.StaticRenderChunk) == static


def _sweep(chunk, fpd=1, height=10, **kw):
    poses = t_cam.spherical_poses(num_poses=4)
    focal = t_cam.focal_from_angle(9, t_views.DEFAULT_CAM_ANGLE_X)
    return [np.asarray(f) for f in t_views.render_poses_batched(
        chunk, poses, height, 9, focal, chunk=40, frames_per_dispatch=fpd, device="cpu", **kw)]


@pytest.mark.parametrize("static", [False, True])
def test_the_cpu_sweeps_eagerly(tiny_ckpt, static):
    """On the CPU a marked render chunk and the one it wraps both take the
    eager loop: no graph, no replay, the same frames."""
    chunk, _, _ = t_inf.build_render_chunk(tiny_ckpt, 40, device="cpu")
    profiling.reset()
    frames = _sweep(chunk if static else chunk.render_chunk)
    assert chunk.graph is None and profiling.counter("view.graph_replays") == 0
    for a, b in zip(frames, _sweep(chunk.render_chunk)):
        np.testing.assert_array_equal(a, b)


class _ReplayingGraph:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured body
    again, its launch counts taken back (a real replay runs no Python)."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        before = profiling.counters()
        self.body()
        for name, n in profiling.counters().items():
            profiling.count(name, before.get(name, 0) - n)


@pytest.mark.parametrize("fpd, device_frames", [(1, False), (8, False), (8, True)])
def test_graph_swept_frames_equal_eager_frames(tiny_ckpt, monkeypatch, fpd, device_frames):
    """The graph sweep's logic on the CPU (a capture that runs the body, a
    replay that runs it again): 4 poses of 10x9 in chunks of 40 (two full
    chunks and a tail of 10 a frame) equal the eager loop's frames; the
    first full chunk runs eagerly, then one capture, then 7 replays; every
    chunk counts its launches once; a second sweep replays 8 and captures
    nothing, a sweep of another view size captures again."""
    monkeypatch.setattr(t_views, "_GRAPH_DEVICES", ("cpu",))
    monkeypatch.setattr(t_views._ChunkGraph, "_capture",
                        lambda self, body: (body(), _ReplayingGraph(body))[1])
    inner, _, _ = t_inf.build_render_chunk(tiny_ckpt, 40, device="cpu")

    def counted(o, d, generator):
        profiling.count("k.launches", 2)
        return inner(o, d, generator)

    want = _sweep(counted)
    chunk = t_views.StaticRenderChunk(counted)
    profiling.reset()
    with profiling.tracing():
        got = _sweep(chunk, fpd, device_frames=device_frames)
    assert profiling.counters() == {"k.launches": 2 * 3 * 4, "view.graph_replays": 7}
    assert [s.name for s in profiling.spans()].count("nerf.view.capture") == 1
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    graph = chunk.graph
    for a, b in zip(want, _sweep(chunk, fpd, device_frames=device_frames)):
        np.testing.assert_array_equal(a, b)
    assert chunk.graph is graph and profiling.counter("view.graph_replays") == 15
    for a, b in zip(_sweep(counted, height=12), _sweep(chunk, fpd, height=12)):
        np.testing.assert_array_equal(a, b)
    assert chunk.graph is not graph and chunk.graph.key[:3] == (40, 12, 9)


def test_data_parallel_raises(fixture_scene, tiny_ckpt):
    """A mesh of a negative size raises (``--data-parallel N >= 1`` scores,
    tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="negative"):
        t_score.calculate_scores(tiny_ckpt, fixture_scene, 1024, data_parallel=-1,
                                 device="cpu")
    with pytest.raises(ValueError, match="negative"):
        t_score.main(["-c", tiny_ckpt, "-b", str(fixture_scene), "--data-parallel", "-2",
                      "--device", "cpu"])


def test_default_device_is_cuda_and_raises_without_card(fixture_scene, tiny_ckpt):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_score.calculate_scores(tiny_ckpt, fixture_scene, 1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_score.main(["-c", tiny_ckpt, "-b", str(fixture_scene)])


def test_score_cli_prints_the_result_lines(fixture_scene, tiny_ckpt, capsys):
    psnr, ssim = t_score.main(["-c", tiny_ckpt, "-r", "2048", "-b", str(fixture_scene),
                               "--limit", "1", "--frames-per-dispatch", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-3:] == ["==============Calculate Scores==============",
                          f"average psnr score: {psnr}", f"average ssim score: {ssim}"]
    assert np.isfinite(psnr) and 0.0 < ssim < 1.0
