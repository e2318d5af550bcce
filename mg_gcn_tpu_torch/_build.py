"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles with ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds) under
``mg_gcn_tpu_torch/_build/``; sources may include the ``csrc/*.cuh``
headers. A library's file name carries a hash of its source, the headers
and the flags, so a changed source is never served by a stale library,
and it is written under a temporary name and renamed into place, so two
processes building at once never load a half-written file.
:func:`build_all` starts one ``nvcc`` per missing library and waits for all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = {
    "spmm_pattern": "spmm_pattern.cu",
    "spmm_edges": "spmm_edges.cu",
    "spmm_gather": "spmm_gather.cu",
    "sddmm": "sddmm.cu",
    "spmm_pattern_sparse": "spmm_pattern_sparse.cu",
    "spmm_tiled": "spmm_tiled.cu",
    "spmm_pattern_ring": "spmm_pattern_ring.cu",
    "edge_softmax": "edge_softmax.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, returned as the log
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, /usr/local/cuda/bin, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> str:
    """The library's path, hashed over its source, every ``csrc/*.cuh``
    header (a source may include any of them) and the flags."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> dict[str, tuple[float, str]]:
    """Compile every library that is not built yet, all ``nvcc`` processes at
    once. Returns {name: (seconds, compiler log)} for what it built."""
    todo = {n: library_path(n) for n in SOURCES if not os.path.exists(library_path(n))}
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    cc = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    done, failed = {}, []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, todo[name])
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built first if it is missing."""
    with _lock:
        if name not in _libs:
            build_all()
            _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]
