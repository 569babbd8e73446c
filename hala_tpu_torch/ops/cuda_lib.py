"""Build, load and launch the hand-written CUDA kernels of csrc/.

The sources compile on first use, one nvcc per source started
together, and link into one shared library with a plain C interface
under `hala_tpu_torch/_build/`, loaded with ctypes (no PyTorch
headers, so a cold build takes seconds). Every C entry
launches on the stream it is given, allocates nothing, and returns
`cudaGetLastError()`; `Kernel.__call__` raises on a non-zero code.

Each `Kernel` keeps `launches`, a plain count of the times its kernel
was launched, so a run can show which kernels its main path went
through. Nothing here is touched for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libhala_kernels.so")

# sm_90a (Hopper); IEEE division and square root, and no contraction of
# a*b+c into FMA, so each kernel's float arithmetic matches its plain
# PyTorch version operation for operation.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
]

_lib = None
build_seconds: float | None = None


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME)")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def build(verbose: bool = False) -> str:
    """Compile each csrc/*.cu to an object with its own nvcc, all
    started together, then link them into LIB_PATH. Every object and
    the library are written under temporary names of their own, so two
    processes building at once share no path, and the library is
    renamed into place, so a concurrent loader never sees a partial
    file."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs, tmps = [], []
    try:
        for src in sources():
            fd, obj = tempfile.mkstemp(suffix=".o", dir=BUILD_DIR)
            os.close(fd)
            tmps.append(obj)
            cmd = [nvcc_path(), *compile_flags, "-c"]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", obj, src]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            jobs.append((cmd, obj, proc))
        errors = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}"
                )
            elif verbose and err:
                print(err)
        if errors:
            raise RuntimeError("\n".join(errors))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        tmps.append(tmp)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, LIB_PATH)
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in tmps:
            if os.path.exists(path):
                os.unlink(path)
    build_seconds = time.perf_counter() - t0
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first when missing or older
    than any source."""
    global _lib
    if _lib is None:
        newest = max(os.path.getmtime(p) for p in sources() + headers())
        if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < newest:
            build()
        _lib = ctypes.CDLL(LIB_PATH)
    return _lib


class Kernel:
    """One C entry of the library: its ctypes signature and launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0

    def __call__(self, *args) -> None:
        fn = getattr(lib(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        rc = fn(*args)
        self.launches += 1
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA launch failed with cudaError {rc}"
            )


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_cuda(name: str, tensors: dict, dtypes: dict, device) -> None:
    """Raise unless every tensor is contiguous, on `device`, of its dtype."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != dtypes.get(key, torch.float32):
            raise ValueError(f"{name}: {key} has dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


_P = ctypes.c_void_p
_I = ctypes.c_int

# csrc/intersect_bruteforce.cu
INTERSECT_BRUTEFORCE = Kernel(
    "hala_intersect_bruteforce",
    [_P] * 4 + [_I] * 4 + [_P] * 5,
)
# csrc/matrix_traverse.cu
MATRIX_TRAVERSE = Kernel(
    "hala_matrix_traverse",
    [_P] * 6 + [_I] * 3 + [_P] * 6,
)

# csrc/raster_tiled.cu
RASTER_TILED = Kernel(
    "hala_raster_tiled",
    [_P, _P, _I, _I, _I] + [_P] * 8,
)
# csrc/cull_topk.cu
CULL_TOPK = Kernel(
    "hala_cull_topk",
    [_P] * 6 + [_I] * 3 + [_P] * 3,
)
# csrc/traverse_candidates.cu
TRAVERSE_CANDIDATES = Kernel(
    "hala_traverse_candidates",
    [_P] * 9 + [_I] * 2 + [_P] * 7,
)
# csrc/cluster_stream.cu
CLUSTER_STREAM = Kernel(
    "hala_cluster_stream",
    [_P] * 8 + [_I] * 2 + [_P] * 5,
)
# csrc/grouped_walk.cu
GROUPED_WALK = Kernel(
    "hala_grouped_walk",
    [_P] * 9 + [_I] * 3 + [_P] * 6,
)
# csrc/wavefront_walk.cu
WAVEFRONT_WALK = Kernel(
    "hala_wavefront_walk",
    [_P] * 9 + [_I] * 5 + [_P] * 6,
)

KERNELS = {
    "intersect_bruteforce": INTERSECT_BRUTEFORCE,
    "matrix_traverse": MATRIX_TRAVERSE,
    "raster_tiled": RASTER_TILED,
    "cull_topk": CULL_TOPK,
    "traverse_candidates": TRAVERSE_CANDIDATES,
    "cluster_stream": CLUSTER_STREAM,
    "grouped_walk": GROUPED_WALK,
    "wavefront_walk": WAVEFRONT_WALK,
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
