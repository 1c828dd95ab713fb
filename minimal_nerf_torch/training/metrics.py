"""Metrics logging: CSV scalars, PNG images, hyperparameters, console.

The port's own copy of ``minimal_nerf_tpu/training/metrics.py``: the same
``{run_dir}/metrics.csv`` (the reference's scalar names, one row per
``log_scalars`` call), ``{run_dir}/hparams.json`` and
``{run_dir}/images/{key}-{step}.png``, the images written by the port's own
PNG encoder (``utils/imageio.py``). The Weights & Biases mirror is not
ported: it needs a package and a network.
"""

from __future__ import annotations

import csv
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from minimal_nerf_torch.utils import imageio as mio


class MetricsLogger:
    """Append-only CSV scalar logger whose header widens as new keys come.

    With ``resume`` an existing ``metrics.csv`` is adopted, so appends
    extend its history; without it the file is removed, so a fresh run that
    reuses a name starts a clean history.
    """

    def __init__(self, run_dir, name: str = "run", echo: bool = True,
                 wandb_project: Optional[str] = None, resume: bool = True):
        if wandb_project:
            raise NotImplementedError(
                "the Weights & Biases mirror is not ported: it needs the wandb package and "
                "a network; metrics go to metrics.csv")
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        (self.run_dir / "images").mkdir(exist_ok=True)
        self.csv_path = self.run_dir / "metrics.csv"
        self.name = name
        self.echo = echo
        self._fieldnames = ["step"]
        self._rows = []
        if self.csv_path.exists():
            if resume:
                with open(self.csv_path, newline="") as f:
                    reader = csv.DictReader(f)
                    if reader.fieldnames:
                        self._fieldnames = list(reader.fieldnames)
                        self._rows = list(reader)
            else:
                self.csv_path.unlink()
        self._t0 = time.perf_counter()

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": int(step)}
        for k, v in scalars.items():
            row[k] = float(v)
        new_keys = [k for k in row if k not in self._fieldnames]
        self._rows.append(row)
        if new_keys:
            # the header widens (e.g. the first validation): rewrite once
            self._fieldnames.extend(new_keys)
            self._rewrite()
        else:
            # steady state: append, so a crash loses at most this row
            with open(self.csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)
        if self.echo:
            parts = " ".join(f"{k}={row[k]:.6g}" for k in scalars)
            print(f"[{self.name}] step {step}: {parts}", file=sys.stderr)

    def log_hyperparams(self, params: Dict) -> None:
        with open(self.run_dir / "hparams.json", "w") as f:
            json.dump({k: str(v) for k, v in dict(params).items()}, f, indent=2)

    def log_image(self, key: str, image: np.ndarray, step: Optional[int] = None) -> Path:
        suffix = f"-{step}" if step is not None else ""
        path = self.run_dir / "images" / f"{key}{suffix}.png"
        mio.imwrite(path, image)
        return path

    def _rewrite(self) -> None:
        with open(self.csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writeheader()
            writer.writerows(self._rows)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def close(self) -> None:
        """Nothing to finish (no mirror); kept so callers close any logger."""


class NullLogger:
    """A logger that writes nothing (the interface of ``MetricsLogger``)."""

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        pass

    def log_hyperparams(self, params: Dict) -> None:
        pass

    def log_image(self, key, image, step=None):
        return None

    def elapsed(self) -> float:
        return 0.0

    def close(self) -> None:
        pass
