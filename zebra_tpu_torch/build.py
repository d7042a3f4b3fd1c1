"""Build and load the port's native code: the CUDA kernels (``csrc/*.cu``)
and the host-side wave scheduler (``csrc/wave_schedule.cc``).

Each source compiles into a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds): a ``.cu``
with ``nvcc`` for sm_90a, a ``.cc`` with the host C++ compiler.
:class:`Kernel` binds one kernel's entry point and counts its launches. The
build runs at first use into ``zebra_tpu_torch/_build/``, keyed by a hash of
the source, the shared ``*.cuh`` headers (for a ``.cu``) and the flags, so a
fresh checkout builds by itself and an edited source rebuilds. Nothing here
runs at import time."""

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
# host C++ (the wave scheduler): no CUDA, so it builds where tests run
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
SOURCES = ("santa_merge", "santa_scan", "santa_waves")
HOST_SOURCES = ("wave_schedule",)

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


def cxx_path() -> str:
    """The host C++ compiler: $CXX, then g++, then c++ on PATH."""
    for c in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if c:
            return c
    raise RuntimeError("no C++ compiler found (set CXX): the wave scheduler "
                       "is built from zebra_tpu_torch/csrc at first use")


def _recipe(name: str):
    """(compiler command, flags, sources that key the build) of
    ``csrc/<name>.cu`` or ``csrc/<name>.cc``."""
    if name in HOST_SOURCES:
        return cxx_path, CXX_FLAGS, [CSRC / f"{name}.cc"]
    return (nvcc_path, NVCC_FLAGS,
            [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")))


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` (or ``.cc``) lives, keyed by
    content."""
    _, flags, sources = _recipe(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library of ``names``, one compiler process per
    source, all started together. Returns the compiler's log per built
    source (empty for a library that was already built); raises on a
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        compiler, flags, sources = _recipe(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler(), *flags, "-o", str(tmp), str(sources[0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: {proc.args[0]} exited "
                          f"{proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cc``), built first if
    needed."""
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
