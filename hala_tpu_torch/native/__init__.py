"""Native (C++) binned-SAH partition and meshlet clustering, via ctypes.

`meshopt.cpp` beside this file (the package's own copy of the JAX
package's source) is built on first use with `g++ -O2 -shared` into
`hala_tpu_torch/_build/`. Two routines are bound: the SAH leaf
partition the upload path runs, and the meshlet clustering of the
mesh-shader raster mode. Without a C++ toolchain `ops/sahbuild.py` and
`ops/meshlets.py` take their numpy/Python paths.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile

import numpy as np

logger = logging.getLogger("hala_tpu_torch.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "meshopt.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD_DIR, "libhala_native.so")

_lib = None
_load_failed = False


class _MeshletOut(ctypes.Structure):
    _fields_ = [
        ("center", ctypes.c_float * 3),
        ("radius", ctypes.c_float),
        ("cone_apex", ctypes.c_float * 3),
        ("cone_cutoff", ctypes.c_float),
        ("cone_axis", ctypes.c_float * 3),
        ("num_vertices", ctypes.c_int32),
        ("offset_vertices", ctypes.c_int32),
        ("num_primitives", ctypes.c_int32),
        ("offset_primitives", ctypes.c_int32),
    ]


def _build() -> bool:
    """Compile to a temporary name and rename into place, so concurrent
    test workers never load a half-written library."""
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("Native build failed (%s); using Python fallback.", e)
        return False


def get_lib():
    """The loaded ctypes library, or None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not os.path.exists(_SRC):
        _load_failed = True
        return None
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as e:
        logger.warning("Native load failed (%s); using Python fallback.", e)
        _load_failed = True
        return None
    lib.hala_build_meshlets.restype = ctypes.c_int32
    lib.hala_build_meshlets.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(_MeshletOut),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.hala_sah_slots.restype = ctypes.c_int64
    lib.hala_sah_slots.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def sah_leaves_native(t_lo: np.ndarray, t_hi: np.ndarray,
                      leaf_size: int, bins: int):
    """C++ binned-SAH leaf partition (ops/sahbuild.sah_leaves
    contract: DFS near-child-first leaf list). Returns
    (order (N,) int64 — concatenated leaf triangle indices,
    leaf_sizes (L,) int32), or None when the native library is
    unavailable. The numpy ufunc.at build is ~20x slower at scene
    scale, so the uploader prefers this path."""
    lib = get_lib()
    if lib is None or bins > 48:
        return None
    lo = np.ascontiguousarray(t_lo, np.float32)
    hi = np.ascontiguousarray(t_hi, np.float32)
    n = lo.shape[0]
    order = np.empty(n, np.int64)
    sizes = np.empty(max(n, 1), np.int32)
    n_leaves = lib.hala_sah_slots(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n),
        ctypes.c_int32(leaf_size),
        ctypes.c_int32(bins),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n_leaves < 0:  # C side rejected the parameters
        return None
    return order, sizes[:n_leaves].copy()


def build_meshlets_native(
    indices: np.ndarray,
    positions: np.ndarray,
    max_vertices: int,
    max_triangles: int,
):
    """C++ meshlet build. Returns (meshlets list, vertices u32, packed
    primitives u32) matching ops.meshlets.build_meshlets, or None when
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..scene.meshlet import Meshlet

    idx = np.ascontiguousarray(indices, np.uint32)
    pos = np.ascontiguousarray(positions, np.float32)
    num_tris = len(idx) // 3
    out = (_MeshletOut * max(num_tris, 1))()
    mv = np.empty(len(idx), np.uint32)
    mp = np.empty(num_tris, np.uint32)
    n = lib.hala_build_meshlets(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(idx)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(pos)),
        ctypes.c_int32(max_vertices),
        ctypes.c_int32(max_triangles),
        out,
        mv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        mp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    meshlets = []
    v_total = p_total = 0
    for i in range(n):
        m = out[i]
        meshlets.append(
            Meshlet(
                center=np.array(m.center, np.float32),
                radius=float(m.radius),
                cone_apex=np.array(m.cone_apex, np.float32),
                cone_cutoff=float(m.cone_cutoff),
                cone_axis=np.array(m.cone_axis, np.float32),
                num_of_vertices=m.num_vertices,
                offset_of_vertices=m.offset_vertices,
                num_of_primitives=m.num_primitives,
                offset_of_primitives=m.offset_primitives,
            )
        )
        v_total = max(v_total, m.offset_vertices + m.num_vertices)
        p_total = max(p_total, m.offset_primitives + m.num_primitives)
    return meshlets, mv[:v_total].copy(), mp[:p_total].copy()
