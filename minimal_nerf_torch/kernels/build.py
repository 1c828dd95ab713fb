"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` (``-gencode arch=compute_90a,code=sm_90a``),
keyed by the content of the source and of the shared ``csrc/*.cuh`` headers,
so an edited source or header rebuilds. The build runs at
first use, never at import, and several sources build in parallel
(``build_all``). ``_build/`` is listed in ``.gitignore``. A wrapper takes
its C function through ``function``, which sets its ``argtypes`` once, and
enters ``on_device`` around the call.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[tuple, object] = {}
# the compiler's report (registers, shared memory, spills) of each build
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).is_file():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, all nvcc
    processes started together; raise with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library (built
    first if needed), its ``argtypes`` and ``restype`` set once per loaded
    library (``kernels/variants.py`` swaps libraries in ``_LIBS``)."""
    lib = load(name)
    hit = _FUNCTIONS.get((name, symbol))
    if hit is None or hit[0] is not lib:
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        hit = _FUNCTIONS[(name, symbol)] = (lib, fn)
    return hit[1]


def on_device(dev: torch.device):
    """``torch.cuda.device(dev)`` where ``dev`` is not the current CUDA
    device, else a context that does nothing: a launch on the current device
    skips switching the device twice per call."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
