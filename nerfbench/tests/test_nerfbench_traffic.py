"""The traffic is the same for the same seed and differs across seeds."""

import pytest
import torch

from nerfbench import spec
from nerfbench.traffic import generate as gen

TRAIN = dict(spec.load_json(spec.HERE / "traffic" / "train_steps.json"), frames=3, height=8,
             width=8)
VIEW = spec.load_json(spec.HERE / "traffic" / "view_requests.json")
NERF = spec.load_json(spec.HERE / "configs" / "nerf_full_64_128.json")["nerf"]
OCC = spec.load_json(spec.HERE / "configs" / "nerf_fast_16_48.json")["occupancy"]


def inputs(seed):
    images, poses, focal = gen.scene(seed, TRAIN, "cpu")
    return {"images": images, "poses": poses, "focal": focal,
            "weights": gen.weights(seed, NERF, TRAIN["weights"], "cpu"),
            "grid": gen.grid(seed, OCC, TRAIN["grid"], "cpu"),
            "orbit": gen.orbit_poses(seed, 5, VIEW, "cpu"), "frame_seeds": gen.frame_seeds(seed, 5)}


def flat(x):
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in flat(v)]
    return [x]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_same_seed_same_inputs(seed):
    a, b = inputs(seed), inputs(seed)
    for x, y in zip(flat(a), flat(b)):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y


def test_seeds_differ_in_every_piece():
    a, b = inputs(3), inputs(4)
    for key in (k for k in a if k != "focal"):  # the camera is the traffic's, not the seed's
        xs, ys = flat(a[key]), flat(b[key])
        assert any((not torch.equal(x, y)) if torch.is_tensor(x) else x != y
                   for x, y in zip(xs, ys)), key


def test_weights_scale_and_grid_occupancy():
    w = inputs(7)["weights"]["coarse"]
    bound = TRAIN["weights"]["gain"] / 16.0  # 256 inputs
    assert 0.9 * bound < float(w["trunk"][1]["w"].abs().max()) <= bound
    grid = inputs(7)["grid"]
    share = float((grid > 0).float().mean())
    assert 0.0 < share < 0.5 and set(grid.unique().tolist()) == {0.0, TRAIN["grid"]["density"]}
