"""The port imports neither JAX nor the JAX package: every module of
``minimal_nerf_torch`` and ``chip_smoke.py`` imports in a fresh interpreter
where importing either raises (the card's machine has no JAX)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "minimal_nerf_tpu"):
    sys.modules[name] = None  # import of these now raises ImportError
import minimal_nerf_torch
names = ["minimal_nerf_torch"] + [m.name for m in pkgutil.walk_packages(
    minimal_nerf_torch.__path__, "minimal_nerf_torch.")] + ["chip_smoke"]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for name in ("minimal_nerf_torch.train", "minimal_nerf_torch.training.trainer",
                 "minimal_nerf_torch.training.metrics", "minimal_nerf_torch.utils.profiling",
                 "minimal_nerf_torch.data.procedural", "minimal_nerf_torch.render",
                 "minimal_nerf_torch.kernels.fused_raymarch", "minimal_nerf_torch.score",
                 "minimal_nerf_torch.convert_ckpt", "minimal_nerf_torch.ops.image_metrics",
                 "minimal_nerf_torch.data.photo", "minimal_nerf_torch.models.image_nerf",
                 "minimal_nerf_torch.training.simple", "minimal_nerf_torch.nerf_helpers",
                 "minimal_nerf_torch.parallel.mesh", "minimal_nerf_torch.parallel.distributed",
                 "minimal_nerf_torch.bench", "chip_smoke"):
        assert name in names
    assert not any(n.startswith(("jax", "minimal_nerf_tpu")) for n in names)
