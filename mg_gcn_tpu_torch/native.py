"""ctypes bindings of the port's host-preprocessing library,
``csrc/host/mggcn_host.cpp`` (port of ``mg_gcn_tpu/native.py``).

The library builds at first use with ``g++ -O3 -fopenmp -shared -fPIC``
into ``mg_gcn_tpu_torch/_build/``, its file name keyed by a hash of the
source and the flags and written under a temporary name, then renamed into
place, so processes that build at once never load a half-written file (as
``_build.py`` does for the kernels). Without a compiler, or with
``MG_GCN_NO_NATIVE=1``, :func:`available` is False and ``sparse`` computes
in numpy: the results are element-equal either way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

import numpy as np

from .formats import CSRData

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "host", "mggcn_host.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
# no -march=native and no contraction: the float arithmetic stays numpy's
FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> str:
    """The library's path, hashed over the source and the flags."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"libmggcn_host-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        r = subprocess.run([cxx, *FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        print(f"mggcn native build failed:\n{r.stderr}", file=sys.stderr)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, out)
    return True


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        c = ctypes.c_int64
        lib.mggcn_expand_rows.argtypes = [c, _i64p, _i32p]
        lib.mggcn_normalize.argtypes = [c, c, _i64p, _i32p, _f32p, _f32p, ctypes.c_int, _f64p]
        lib.mggcn_transpose.argtypes = [c, c, c, _i64p, _i32p, _f32p, _i64p, _i32p, _f32p]
        lib.mggcn_comm_volume.argtypes = [c, c, _i64p, _i64p, _i32p, _u8p, c, _i64p]
        for fn in (lib.mggcn_expand_rows, lib.mggcn_normalize, lib.mggcn_transpose, lib.mggcn_comm_volume):
            fn.restype = None
        lib.mggcn_num_threads.argtypes = []
        lib.mggcn_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be);
    False under ``MG_GCN_NO_NATIVE``, read at every call."""
    if os.environ.get("MG_GCN_NO_NATIVE"):
        return False
    return _load() is not None


def num_threads() -> int:
    """The OpenMP workers the library runs on."""
    return int(_load().mggcn_num_threads())


def _prep(csr: CSRData):
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(csr.indices, dtype=np.int32)
    data = np.ascontiguousarray(csr.data, dtype=np.float32)
    return indptr, indices, data


def expand_rows(csr: CSRData) -> np.ndarray:
    """int32 row id of every entry."""
    rows = np.empty(csr.nnz, np.int32)
    _load().mggcn_expand_rows(csr.nrows, _prep(csr)[0], rows)
    return rows


def normalize(csr: CSRData, axis: bool) -> np.ndarray:
    """The normalized data array (same index structure)."""
    indptr, indices, data = _prep(csr)
    out = np.empty_like(data)
    scratch = np.zeros(csr.ncols if axis else 1, np.float64)
    _load().mggcn_normalize(csr.nrows, csr.ncols, indptr, indices, data, out, 1 if axis else 0, scratch)
    return out


def transpose(csr: CSRData) -> CSRData:
    indptr, indices, data = _prep(csr)
    t_indptr = np.empty(csr.ncols + 1, np.int64)
    t_indices = np.empty(csr.nnz, np.int32)
    t_data = np.empty(csr.nnz, np.float32)
    _load().mggcn_transpose(csr.nrows, csr.ncols, csr.nnz, indptr, indices, data, t_indptr, t_indices, t_data)
    return CSRData(indptr=t_indptr, indices=t_indices, data=t_data, shape=(csr.ncols, csr.nrows))


def comm_volume(csr: CSRData, part: np.ndarray) -> np.ndarray:
    indptr, indices, _ = _prep(csr)
    P = len(part) - 1
    marks = np.zeros(P * csr.ncols, np.uint8)
    vol = np.zeros(P * P, np.int64)
    _load().mggcn_comm_volume(csr.nrows, P, np.ascontiguousarray(part, np.int64), indptr, indices, marks,
                              csr.ncols, vol)
    return vol.reshape(P, P)
