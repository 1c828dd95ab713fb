"""Convert checkpoints between the reference's PyTorch Lightning format and this one.

    python -m minimal_nerf_torch.convert_ckpt -i torch.ckpt -o converted.ckpt
    python -m minimal_nerf_torch.convert_ckpt --reverse -i native.ckpt -o pl.ckpt

Counterpart of the JAX package's ``convert_ckpt.py``, with its own copy of
the name map. A reference checkpoint is a ``torch.save``'d dict whose
``state_dict`` holds the two MLPs as
``{coarse,fine}_network.{mlp,feature_fn,density_fn,rgb_fn}.{i}.{weight,bias}``
(Linear layers at Sequential indices 0/2/4/6, 0/2/4, 0 and 0/2), each weight
``[out, in]``; this package's params hold ``{"w": [in, out], "b": [out]}``.

- Forward (default): a reference checkpoint -> a native one (the 122-leaf
  format that ``render`` and ``score`` read) at its ``global_step``, with a
  fresh Adam state, its ``hyper_parameters`` as the NeRF config and
  ``TrainConfig()`` defaults; every leaf's shape is checked.
- Reverse (``--reverse``): a native ``full`` checkpoint -> a dict the
  reference's ``NeRFNetwork.load_from_checkpoint`` reads (``state_dict``,
  ``hyper_parameters``, ``epoch``, ``global_step`` and a Lightning version
  stamp). No PyTorch Lightning is needed for either.

A conversion only moves weights between files, so it runs on the host and
needs no card. Every weight is copied (``.t().contiguous().clone()``): a
converted leaf never aliases the tensor it came from.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict

import torch

# Sequential indices of the Linear layers (reference nerf_model.py:331-360)
_LAYERS = (("trunk", "mlp", (0, 2, 4, 6)), ("feature", "feature_fn", (0, 2, 4)),
           ("density", "density_fn", (0,)), ("rgb", "rgb_fn", (0, 2)))


def _linear_from_torch(state: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    weight = torch.as_tensor(state[f"{prefix}.weight"]).to(torch.float32)
    bias = torch.as_tensor(state[f"{prefix}.bias"]).to(torch.float32)
    return {"w": weight.t().contiguous().clone(), "b": bias.clone()}


def convert_mlp_state(state: Dict[str, Any], net_prefix: str) -> Dict[str, Any]:
    """One reference ``NeRFModel``'s state-dict subtree -> this package's MLP tree."""
    mlp = {name: [_linear_from_torch(state, f"{net_prefix}.{module}.{i}") for i in indices]
           for name, module, indices in _LAYERS}
    mlp["density"] = mlp["density"][0]
    return mlp


def export_mlp_state(state: Dict[str, Any], net_prefix: str, mlp_params: Dict[str, Any]) -> None:
    """The inverse of ``convert_mlp_state``: write one MLP tree into ``state``
    under the reference's names."""
    for name, module, indices in _LAYERS:
        leaves = mlp_params[name] if isinstance(mlp_params[name], list) else [mlp_params[name]]
        for i, leaf in zip(indices, leaves):
            w, b = (torch.as_tensor(leaf[k]).detach().to("cpu", torch.float32) for k in "wb")
            state[f"{net_prefix}.{module}.{i}.weight"] = w.t().contiguous().clone()
            state[f"{net_prefix}.{module}.{i}.bias"] = b.clone()


def convert_checkpoint(in_path, out_path) -> Path:
    """Reference checkpoint -> native checkpoint at ``out_path``."""
    from minimal_nerf_torch.models.mlp import nerf_mlp_shapes
    from minimal_nerf_torch.models.nerf import NeRFConfig
    from minimal_nerf_torch.training import checkpoint as ckpt_lib
    from minimal_nerf_torch.training.config import TrainConfig
    from minimal_nerf_torch.training.loop import adam_init

    raw = torch.load(in_path, map_location="cpu", weights_only=False)
    state = raw["state_dict"] if "state_dict" in raw else raw
    hparams = raw.get("hyper_parameters", {}) or {}
    nerf_cfg = NeRFConfig(
        position_dim=int(hparams.get("position_dim", 10)),
        direction_dim=int(hparams.get("direction_dim", 4)),
        coarse_samples=int(hparams.get("coarse_samples", 64)),
        fine_samples=int(hparams.get("fine_samples", 128)),
        near=float(hparams.get("near", 2.0)),
        far=float(hparams.get("far", 6.0)),
    )
    params = {"coarse": convert_mlp_state(state, "coarse_network"),
              "fine": convert_mlp_state(state, "fine_network")}
    # the shapes of the tree init_nerf_network draws for this config
    shapes = nerf_mlp_shapes(nerf_cfg.position_dim, nerf_cfg.direction_dim)
    want = ckpt_lib.flatten_tree({"coarse": shapes, "fine": shapes})
    got = [tuple(t.shape) for t in ckpt_lib.flatten_tree(params)]
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            raise ValueError(f"leaf {i}: converted shape {g} != expected {w} for {nerf_cfg}")
    step = int(raw.get("global_step", 0))
    ckpt_lib.save_checkpoint(out_path, params, step, nerf_cfg.to_dict(),
                             TrainConfig().to_dict(), extra={"converted_from": str(in_path)},
                             opt_state=adam_init(params))
    print(f"wrote {out_path} (step {step})")
    return Path(out_path)


def export_checkpoint(in_path, out_path) -> Path:
    """Native ``full`` checkpoint -> reference-loadable checkpoint at ``out_path``."""
    from minimal_nerf_torch.training import checkpoint as ckpt_lib
    from minimal_nerf_torch.training.trainer import load_state_for_inference

    header = ckpt_lib.read_header(in_path)
    mode = (header.get("extra") or {}).get("mode", "full")
    if mode != "full":
        raise ValueError("only full NeRFNetwork checkpoints export to the reference format "
                         f"(got mode={mode!r})")
    params, nerf_cfg, train_cfg, _, step = load_state_for_inference(in_path, device="cpu")

    state: Dict[str, Any] = {}
    export_mlp_state(state, "coarse_network", params["coarse"])
    export_mlp_state(state, "fine_network", params["fine"])
    payload = {
        "state_dict": state,
        # NeRFNetwork.__init__'s arguments (reference nerf_model.py:63-64),
        # from which Lightning rebuilds the module
        "hyper_parameters": {
            "position_dim": nerf_cfg.position_dim,
            "direction_dim": nerf_cfg.direction_dim,
            "coarse_samples": nerf_cfg.coarse_samples,
            "fine_samples": nerf_cfg.fine_samples,
            "near": nerf_cfg.near,
            "far": nerf_cfg.far,
        },
        "epoch": step // (train_cfg.steps_per_epoch or 100),
        "global_step": step,
        # Lightning refuses a checkpoint without a version stamp (the
        # reference pins 1.5.10)
        "pytorch-lightning_version": "1.5.10",
        "exported_from": str(in_path),
    }
    torch.save(payload, out_path)
    print(f"wrote {out_path} (PL format, step {step})")
    return Path(out_path)


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(
        description="Convert checkpoints between the reference's PyTorch Lightning format "
                    "and this package's")
    parser.add_argument("-i", "--input", required=True, help="input .ckpt path")
    parser.add_argument("-o", "--output", required=True, help="output .ckpt path")
    parser.add_argument("--reverse", action="store_true",
                        help="export native -> PyTorch Lightning instead")
    args = parser.parse_args(argv)
    convert = export_checkpoint if args.reverse else convert_checkpoint
    return convert(args.input, args.output)


if __name__ == "__main__":
    main()
