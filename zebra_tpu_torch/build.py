"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds); :class:`Kernel` binds one entry point and counts its launches.
The build runs at first use into ``zebra_tpu_torch/_build/``, keyed by a
hash of the source, the shared ``*.cuh`` headers and the flags, so a fresh
checkout builds by itself and an edited source rebuilds. Nothing here runs
at import time."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: no multiply-add contraction, so each kernel rounds exactly
# like its plain PyTorch version. -Xptxas=-v only reports registers and
# shared memory (kept in the build log).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = ("santa_merge", "santa_scan")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    candidates = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)
    ]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from zebra_tpu_torch/csrc at first use"
    )


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by content."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library of ``names``, one ``nvcc`` per source,
    all started together. Returns the compiler's log per built source
    (empty for a library that was already built); raises on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


class Kernel:
    """The C entry point ``<name>`` of ``csrc/<name>.cu``: bound with ctypes
    at its first launch (building the library if needed), with a count of
    its launches. The entry point returns a ``cudaError_t``; a launch that
    was refused raises."""

    def __init__(self, name: str, argtypes: Sequence):
        self.name = name
        self.launches = 0
        self._argtypes = list(argtypes)
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.name), self.name)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
        self.launches += 1
