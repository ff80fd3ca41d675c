"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library is named by a content hash of its source and the compiler
flags, so an edited kernel never loads a stale build; a file lock keeps
concurrent processes from racing on one build.  Output goes to
``build/repro_torch/`` at the repository root (git-ignored).

Every C entry point takes tensor pointers as ``void*``, integer shapes
as ``int``, the current stream as ``void*`` and returns the
``cudaGetLastError()`` of its launches; :func:`check` raises on a
nonzero value.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("maecho_gram", "maecho_update", "maecho_v_update")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _paths(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(popen or None, lock file, so path, log path)``.  The lock is held
    until :func:`_finish`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, so = _paths(name)
    lock = open(BUILD_DIR / f"{name}.lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    log = so.with_suffix(".log")
    if so.exists():
        return None, lock, so, log
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), lock, so, log


def _finish(name: str, started) -> None:
    job, lock, so, log = started
    try:
        if job is not None:
            proc, tmp = job
            out, _ = proc.communicate()
            log.write_text(out)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
            os.replace(tmp, so)
    finally:
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every kernel library at once (one ``nvcc`` per source, all
    started together).  Returns ``{name: ptxas log}``."""
    started = {n: _start(n) for n in names}
    for n, st in started.items():
        _finish(n, st)
    return {n: st[3].read_text() if st[3].exists() else ""
            for n, st in started.items()}


def load(name: str, sigs: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    ``sigs`` maps each C function to ``(restype, argtypes)``: pointers
    and the stream must be ``c_void_p``, or ctypes cuts them to 32
    bits."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        for fn, (restype, argtypes) in sigs.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(cond: bool, msg: str) -> None:
    """Wrapper argument check: raise ``ValueError`` with ``msg``."""
    if not cond:
        raise ValueError(msg)


def check_f32_cuda(name: str, **tensors) -> None:
    """Every tensor given lies on one CUDA device, is float32 and is
    contiguous — what the kernels' pointer arithmetic assumes."""
    devs = {t.device for t in tensors.values()}
    require(len(devs) == 1, f"{name}: tensors on several devices {devs}")
    for k, t in tensors.items():
        require(t.is_cuda, f"{name}: {k} is not a CUDA tensor")
        require(t.dtype == torch.float32,
                f"{name}: {k} must be float32, got {t.dtype}")
        require(t.is_contiguous(), f"{name}: {k} must be contiguous")
