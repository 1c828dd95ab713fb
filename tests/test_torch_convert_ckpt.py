"""``python -m minimal_nerf_torch.convert_ckpt`` against the root
``convert_ckpt.py`` in both directions, on a full-width (256/128) reference
state dict built from seeded numpy values."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from minimal_nerf_torch import convert_ckpt as t_convert
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training import trainer as t_trainer
from minimal_nerf_torch.training.config import TrainConfig as TTrainConfig
from minimal_nerf_tpu.training.trainer import load_state_for_inference as j_load

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import convert_ckpt as j_convert  # noqa: E402

HPARAMS = dict(position_dim=10, direction_dim=4, coarse_samples=64, fine_samples=128,
               near=2.0, far=6.0)


def _reference_ckpt(path, seed=0):
    """A reference (PyTorch Lightning) checkpoint: ``state_dict`` with each
    Linear as ``[out, in]`` weight and bias under the reference's names."""
    rng = np.random.default_rng(seed)
    pos, dirs, width = 60, 24, 256
    shapes = {"mlp": [(pos, width)] + [(width, width)] * 3,
              "feature_fn": [(width + pos, width), (width, width), (width, width)],
              "density_fn": [(width, 1)], "rgb_fn": [(width + dirs, 128), (128, 3)]}
    state = {}
    for net in ("coarse_network", "fine_network"):
        for module, layers in shapes.items():
            for i, (n_in, n_out) in zip(range(0, 8, 2), layers):
                state[f"{net}.{module}.{i}.weight"] = torch.from_numpy(
                    rng.standard_normal((n_out, n_in)).astype(np.float32))
                state[f"{net}.{module}.{i}.bias"] = torch.from_numpy(
                    rng.standard_normal(n_out).astype(np.float32))
    torch.save({"state_dict": state, "global_step": 1234, "epoch": 12,
                "hyper_parameters": HPARAMS}, path)
    return state


def test_forward_matches_root_script(tmp_path):
    """Reference -> native: both converters' files hold the same 122 leaves
    bit for bit and the same header; JAX loads the port's file."""
    state = _reference_ckpt(tmp_path / "pl.ckpt")
    j_out, t_out = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    j_convert.convert_checkpoint(str(tmp_path / "pl.ckpt"), str(j_out))
    assert t_convert.main(["-i", str(tmp_path / "pl.ckpt"), "-o", str(t_out)]) == t_out
    j_header, j_leaves = t_ckpt.load_checkpoint(j_out)
    t_header, t_leaves = t_ckpt.load_checkpoint(t_out)
    assert len(t_leaves) == len(j_leaves) == 122 and t_header["step"] == 1234
    for i in range(122):
        assert t_leaves[i].dtype == j_leaves[i].dtype
        np.testing.assert_array_equal(t_leaves[i], j_leaves[i])
    assert ({k: v for k, v in t_header.items() if k != "extra"}
            == {k: v for k, v in j_header.items() if k != "extra"})
    # both load in the port as the same fp32 params, each the transposed weight
    t_params, cfg, _, _, step = t_trainer.load_state_for_inference(t_out, device="cpu")
    j_params, *_ = t_trainer.load_state_for_inference(j_out, device="cpu")
    for a, b in zip(t_ckpt.flatten_tree(t_params), t_ckpt.flatten_tree(j_params)):
        assert torch.equal(a, b)
    assert step == 1234 and cfg == t_nerf.NeRFConfig(**HPARAMS)
    assert torch.equal(t_params["fine"]["rgb"][0]["w"], state["fine_network.rgb_fn.0.weight"].t())
    # and JAX loads the port's file
    jp, jcfg, _, _, jstep = j_load(t_out)
    assert jstep == 1234 and jcfg.to_dict() == cfg.to_dict()
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jp)),
                    t_ckpt.flatten_tree(t_params)):
        np.testing.assert_array_equal(a, b.numpy())


def test_converted_leaves_do_not_alias_the_state():
    state = {"n.density_fn.0.weight": torch.ones(1, 4), "n.density_fn.0.bias": torch.ones(1)}
    leaf = t_convert._linear_from_torch(state, "n.density_fn.0")
    leaf["w"].add_(1.0)
    leaf["b"].add_(1.0)
    assert torch.equal(state["n.density_fn.0.weight"], torch.ones(1, 4))
    assert torch.equal(state["n.density_fn.0.bias"], torch.ones(1))


def test_reverse_matches_root_script(tmp_path):
    """Native -> reference: the port's and the root script's exports hold
    the same state dict bit for bit and the same hyper-parameters, epoch and
    step; converting the export back gives the original weights. A
    ``single`` checkpoint raises in both."""
    params = t_nerf.init_nerf_network(torch.Generator().manual_seed(3), t_nerf.NeRFConfig(),
                                      device="cpu", gain=np.sqrt(6.0))
    native = t_ckpt.save_checkpoint(
        tmp_path / t_ckpt.checkpoint_name("n", 6, 130), params, 130,
        t_nerf.NeRFConfig().to_dict(), TTrainConfig(steps_per_epoch=20).to_dict())
    j_out, t_out = tmp_path / "jax_pl.ckpt", tmp_path / "port_pl.ckpt"
    j_convert.export_checkpoint(str(native), str(j_out))
    t_convert.main(["--reverse", "-i", str(native), "-o", str(t_out)])
    want = torch.load(j_out, map_location="cpu", weights_only=False)
    got = torch.load(t_out, map_location="cpu", weights_only=False)
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    assert len(got["state_dict"]) == 40
    for k, v in want["state_dict"].items():
        assert got["state_dict"][k].dtype == v.dtype and got["state_dict"][k].is_contiguous()
        assert torch.equal(got["state_dict"][k], v)
    for key in ("hyper_parameters", "epoch", "global_step", "pytorch-lightning_version"):
        assert got[key] == want[key]
    assert (got["epoch"], got["global_step"]) == (130 // 20, 130)
    back = tmp_path / "back.ckpt"
    t_convert.convert_checkpoint(t_out, back)
    again, *_ = t_trainer.load_state_for_inference(back, device="cpu")
    for a, b in zip(t_ckpt.flatten_tree(again), t_ckpt.flatten_tree(params)):
        assert torch.equal(a, b)
    single = t_ckpt.save_checkpoint(tmp_path / "single.ckpt", params, 1,
                                    t_nerf.NeRFConfig().to_dict(), TTrainConfig().to_dict(),
                                    extra={"mode": "single"})
    with pytest.raises(ValueError, match="single"):
        j_convert.export_checkpoint(str(single), str(tmp_path / "x.ckpt"))
    with pytest.raises(ValueError, match="single"):
        t_convert.export_checkpoint(single, tmp_path / "y.ckpt")
