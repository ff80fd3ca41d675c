"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library is named by a content hash of its source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited kernel never
loads a stale build; a file lock keeps concurrent processes from
racing on one build.  Output goes to
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
SOURCES = ("maecho_gram", "maecho_update", "maecho_v_update",
           "maecho_gram_left", "maecho_update_left", "maecho_v_update_factored",
           "maecho_gram_diag", "maecho_update_diag", "maecho_v_update_diag",
           "maecho_gram_stacked", "maecho_update_stacked", "maecho_v_update_stacked",
           "maecho_gram_diag_stacked", "maecho_update_diag_stacked",
           "maecho_v_update_diag_stacked", "maecho_gram_left_stacked",
           "maecho_update_left_stacked", "maecho_v_update_factored_stacked",
           "maecho_gram_cross", "rank_downdate", "flash_attention", "decode_attention")

_libs: dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): PATH,
    then ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found (PATH, $CUDA_HOME/bin, "
                       f"/usr/local/cuda/bin): cannot build or read the CUDA kernels")


def _paths(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):    # every source may include them
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is built (named by the
    content hash of its source, the headers and the flags)."""
    return _paths(name)[1]


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
        [cuda_tool(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
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


ATTENTION_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_attention_cuda(name: str, **tensors) -> int:
    """Every tensor given lies on one CUDA device, all are float32 or all
    bfloat16 (the attention kernels compute in fp32 either way), and each
    has a contiguous last axis (the head dim; the kernels take the other
    strides).  Returns the kernels' dtype code: 0 float32, 1 bfloat16."""
    devs = {t.device for t in tensors.values()}
    require(len(devs) == 1, f"{name}: tensors on several devices {devs}")
    dtypes = {t.dtype for t in tensors.values()}
    for k, t in tensors.items():
        require(t.is_cuda, f"{name}: {k} is not a CUDA tensor")
        require(t.dtype in ATTENTION_DTYPES,
                f"{name}: {k} must be float32 or bfloat16, got {t.dtype}")
        require(t.stride(-1) == 1 or t.shape[-1] == 1,
                f"{name}: {k} must have a contiguous last axis, got strides {t.stride()}")
    require(len(dtypes) == 1, f"{name}: mixed dtypes {sorted(map(str, dtypes))}")
    return ATTENTION_DTYPES[dtypes.pop()]


def stacked_dims(name: str, W, V, P, kind: str, alpha=None) -> tuple:
    """Check a stacked leaf's shapes — W (L, out, in), V (N, L, out, in),
    P (N, L, in, in) for ``kind="full"`` or p (N, L, in) for
    ``"diag"``, and alpha (L, N) when given — and return
    ``(N, L, out, in)``."""
    require(V.dim() == 4, f"{name}: V must be (N, L, out, in), got {tuple(V.shape)}")
    N, L, out_d, in_d = V.shape
    pshape = (N, L, in_d, in_d) if kind == "full" else (N, L, in_d)
    ok = (tuple(W.shape) == (L, out_d, in_d) and tuple(P.shape) == pshape
          and (alpha is None or tuple(alpha.shape) == (L, N)))
    want = "(L, out, in), (N, L, out, in), " + (
        "(N, L, in, in)" if kind == "full" else "(N, L, in)")
    got = f"W {tuple(W.shape)}, V {tuple(V.shape)}, P {tuple(P.shape)}"
    if alpha is not None:
        want += ", (L, N)"
        got += f", alpha {tuple(alpha.shape)}"
    require(ok, f"{name}: shapes {got} do not match {want}")
    require(N >= 1 and L >= 1, f"{name}: N={N} clients and L={L} layers, need >= 1")
    return N, L, out_d, in_d


def stacked_left_dims(name: str, A, UT, W=None, V=None, alpha=None) -> tuple:
    """Check a stacked factored leaf's shapes — the compressed residual
    A (N, L, out, k), UT (N, L, k, in), and W (L, out, in), V
    (N, L, out, in), alpha (L, N) where given — and return
    ``(N, L, out, k, in)``.  L is bounded by the grid's 65 535."""
    require(A.dim() == 4 and UT.dim() == 4,
            f"{name}: A must be (N, L, out, k) and UT (N, L, k, in), got "
            f"{tuple(A.shape)}, {tuple(UT.shape)}")
    N, L, out_d, kd = A.shape
    in_d = UT.shape[3]
    ok = (tuple(UT.shape[:3]) == (N, L, kd)
          and (W is None or tuple(W.shape) == (L, out_d, in_d))
          and (V is None or tuple(V.shape) == (N, L, out_d, in_d))
          and (alpha is None or tuple(alpha.shape) == (L, N)))
    got = ", ".join(f"{k} {tuple(t.shape)}" for k, t in
                    (("A", A), ("UT", UT), ("W", W), ("V", V), ("alpha", alpha))
                    if t is not None)
    require(ok, f"{name}: shapes {got} do not match A (N, L, out, k), "
                f"UT (N, L, k, in), W (L, out, in), V (N, L, out, in), alpha (L, N)")
    require(min(N, L, kd, out_d, in_d) >= 1,
            f"{name}: N={N}, L={L}, k={kd}, out={out_d}, in={in_d}, need each >= 1")
    require(L <= 65535, f"{name}: L={L} layers exceeds the grid's limit")
    return N, L, out_d, kd, in_d
