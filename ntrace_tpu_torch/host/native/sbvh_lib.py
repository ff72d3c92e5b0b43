"""Build + ctypes binding for the native SBVH/binned-SAH builder.

Same lazy g++ compile-cache pattern as native/build.py (the CudaCompiler
analogue). The reference's SplitBVHBuilder is C++; this is its native
counterpart for the offline-quality builds where per-node numpy overhead
dominates the Python builder (San Miguel-scale SBVH).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "sbvh.cpp"
_lib = None
_tried = False


def _cache_dir() -> Path:
    """The port's git-ignored build directory, ntrace_tpu_torch/_build/."""
    d = Path(__file__).resolve().parents[2] / "_build"
    d.mkdir(parents=True, exist_ok=True)
    return d


class _SbvhResult(ctypes.Structure):
    _fields_ = [
        ("child", ctypes.POINTER(ctypes.c_int32)),
        ("child_lo", ctypes.POINTER(ctypes.c_float)),
        ("child_hi", ctypes.POINTER(ctypes.c_float)),
        ("n_inner", ctypes.c_int64),
        ("leaf_first", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_count", ctypes.POINTER(ctypes.c_int32)),
        ("n_leaves", ctypes.c_int64),
        ("tri_order", ctypes.POINTER(ctypes.c_int32)),
        ("n_order", ctypes.c_int64),
        ("n_refs", ctypes.c_int64),
        ("unsplit", ctypes.c_int64),
        ("root", ctypes.c_int32),
        ("error", ctypes.c_char_p),
    ]


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        src = _SRC.read_bytes()
        key = hashlib.sha1(src + b"v1").hexdigest()[:16]
        so = _cache_dir() / f"libsbvh_{key}.so"
        if not so.exists():
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=300,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.sbvh_build.restype = ctypes.POINTER(_SbvhResult)
        lib.sbvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.sbvh_result_free.restype = None
        lib.sbvh_result_free.argtypes = [ctypes.POINTER(_SbvhResult)]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def native_sbvh_available() -> bool:
    return _load() is not None


def native_sbvh_build(ref_lo: np.ndarray, ref_hi: np.ndarray, cfg):
    """Run the native builder over per-triangle boxes.

    Returns (child (I,2) i32, child_lo (I,2,3) f32, child_hi, leaf_first,
    leaf_count, tri_order, n_refs, unsplit, root) or raises RuntimeError.
    root < 0 means the whole input collapsed to a single leaf (caller
    falls back like the Python builder does).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native sbvh unavailable")
    lo = np.ascontiguousarray(ref_lo, np.float32)
    hi = np.ascontiguousarray(ref_hi, np.float32)
    n = lo.shape[0]
    ptr = lib.sbvh_build(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        int(cfg.builder == "sbvh"), int(cfg.sbvh_unsplit),
        int(cfg.object_sweep),
        int(cfg.num_object_bins), int(cfg.num_spatial_bins),
        float(cfg.sah_node_cost), float(cfg.sah_tri_cost),
        float(cfg.sbvh_alpha),
        int(cfg.min_leaf_size), int(cfg.max_leaf_size), int(cfg.max_depth),
    )
    if not ptr:
        raise RuntimeError("sbvh_build: allocation failure")
    d = ptr.contents
    try:
        if d.error:
            raise RuntimeError(d.error.decode())
        ni, nl, no = int(d.n_inner), int(d.n_leaves), int(d.n_order)
        if ni == 0:
            # single-leaf tree: no inner rows to view (the C buffers are
            # 1-element placeholders; a (1, 2, 3) view would over-read)
            child = np.zeros((0, 2), np.int32)
            clo = np.zeros((0, 2, 3), np.float32)
            chi = np.zeros((0, 2, 3), np.float32)
        else:
            child = np.ctypeslib.as_array(d.child, shape=(ni, 2)).copy()
            clo = np.ctypeslib.as_array(d.child_lo, shape=(ni, 2, 3)).copy()
            chi = np.ctypeslib.as_array(d.child_hi, shape=(ni, 2, 3)).copy()
        lf = np.ctypeslib.as_array(d.leaf_first, shape=(max(nl, 1),)).copy()[:nl]
        lc = np.ctypeslib.as_array(d.leaf_count, shape=(max(nl, 1),)).copy()[:nl]
        order = np.ctypeslib.as_array(d.tri_order, shape=(max(no, 1),)).copy()[:no]
        return (child, clo, chi, lf, lc, order,
                int(d.n_refs), int(d.unsplit), int(d.root))
    finally:
        lib.sbvh_result_free(ptr)
