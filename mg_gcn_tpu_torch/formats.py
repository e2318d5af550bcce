"""Binary graph/matrix formats compatible with the reference framework.

Port of ``mg_gcn_tpu/formats.py`` (numpy only, no framework dependency):

* **PIGO-CSR-v2** sparse format: an 11-byte ASCII magic ``PIGO-CSR-v2``, two
  uint8 width descriptors (bytes per vertex / edge index), then ``N``,
  ``nnz``, ``nrows``, ``ncols`` as uint32/uint64 by those widths, followed by
  ``indptr`` (N+1), ``indices`` (nnz) and float32 ``data`` (nnz).
* **Raw dense format**: the shape as uint32 values (one per dimension), then
  the row-major payload in the element dtype.

``ensure_pigo_transpose`` writes the transposed ``graph_t.bin`` that prep
leaves beside a dataset. The header-only ``GraphHeader``, slab reads and
mmap loading belong to a later distributed slice (ROADMAP queue 1 item 9g).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np

PIGO_MAGIC = b"PIGO-CSR-v2"


@dataclass
class CSRData:
    """A host-side CSR matrix: plain numpy arrays.

    ``shape`` is (nrows, ncols); ``indptr`` has nrows+1 entries.
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @staticmethod
    def from_scipy(m) -> "CSRData":
        m = m.tocsr()
        return CSRData(
            indptr=np.asarray(m.indptr),
            indices=np.asarray(m.indices),
            data=np.asarray(m.data, dtype=np.float32),
            shape=(int(m.shape[0]), int(m.shape[1])),
        )

    def to_scipy(self):
        from scipy.sparse import csr_matrix

        return csr_matrix((self.data, self.indices, self.indptr), shape=self.shape)

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()


def _index_dtype(width: int):
    if width == 4:
        return np.uint32
    if width == 8:
        return np.uint64
    raise ValueError(f"unsupported PIGO index width: {width}")


def read_pigo_csr(path: str | os.PathLike) -> CSRData:
    """Read a PIGO-CSR-v2 ``graph.bin`` file (reference matrix.hpp:224-234)."""
    buf = np.fromfile(path, dtype=np.uint8)
    magic = buf[: len(PIGO_MAGIC)].tobytes()
    if magic != PIGO_MAGIC:
        raise ValueError(f"{path}: bad magic {magic!r}, expected {PIGO_MAGIC!r}")
    off = len(PIGO_MAGIC)
    vdt, edt = _index_dtype(int(buf[off])), _index_dtype(int(buf[off + 1]))
    off += 2

    def take(dtype, count):
        nonlocal off
        nbytes = np.dtype(dtype).itemsize * count
        if off + nbytes > buf.shape[0]:
            raise ValueError(f"{path}: truncated file")
        arr = buf[off : off + nbytes].view(dtype)
        off += nbytes
        return arr

    n = int(take(vdt, 1)[0])
    nnz = int(take(edt, 1)[0])
    nrows = int(take(vdt, 1)[0])
    ncols = int(take(vdt, 1)[0])
    indptr = take(vdt, n + 1).astype(np.int64)
    indices = take(edt, nnz).astype(np.int32)
    data = take(np.float32, nnz).copy()
    if off != buf.shape[0]:
        raise ValueError(f"{path}: trailing bytes ({buf.shape[0] - off})")
    if n != nrows:
        raise ValueError(f"{path}: N ({n}) != nrows ({nrows})")
    return CSRData(indptr=indptr, indices=indices, data=data, shape=(nrows, ncols))


def write_pigo_csr(path: str | os.PathLike, csr: CSRData) -> None:
    """Write PIGO-CSR-v2, byte-compatible with the reference prep.py:46-62
    (and with ``mg_gcn_tpu.formats.write_pigo_csr``): both the nnz and the
    nrows/ncols header fields follow the row count's width decision, and
    shape[0] is written twice, as the reference serializer does."""
    n, _ = csr.shape
    vwidth = 4 if n < 2**32 - 1 else 8
    ewidth = 4 if csr.nnz < 2**32 - 1 else 8
    if vwidth == 4 and csr.nnz >= 2**32 - 1:
        # indptr takes the VERTEX width but holds edge offsets: refuse
        # rather than wrap
        raise ValueError(
            f"nnz {csr.nnz} overflows the 4-byte indptr width the PIGO "
            "format derives from n; this graph cannot be written losslessly"
        )
    vdt, edt = _index_dtype(vwidth), _index_dtype(ewidth)
    with open(path, "wb") as f:
        f.write(PIGO_MAGIC)
        np.array([vwidth, ewidth], dtype=np.uint8).tofile(f)
        np.array([n], dtype=vdt).tofile(f)
        np.array([csr.nnz], dtype=edt).tofile(f)
        np.array([n, n], dtype=vdt).tofile(f)
        csr.indptr.astype(vdt).tofile(f)
        csr.indices.astype(edt).tofile(f)
        csr.data.astype(np.float32).tofile(f)


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            digest.update(block)
    return digest.hexdigest()


def ensure_pigo_transpose(directory: str | os.PathLike) -> str:
    """``graph_t.bin`` next to ``graph.bin``: the transposed orientation that
    per-process slab builds read. Returns its path.

    The transpose is kept only when it was built from the ``graph.bin``
    that is there now: ``graph_t.bin.sha256`` holds the SHA-256 of the
    ``graph.bin`` it was built from, and any other content (a rewritten
    graph, whatever its mtime; a transpose with no digest) rebuilds it.
    Both files are written under temporary names and renamed into place,
    the digest last, so a reader never pairs a partial transpose with it.
    """
    d = os.fspath(directory)
    gpath = os.path.join(d, "graph.bin")
    tpath = os.path.join(d, "graph_t.bin")
    spath = tpath + ".sha256"
    want = _sha256(gpath)
    if os.path.exists(tpath) and os.path.exists(spath):
        with open(spath) as f:
            if f.read().strip() == want:
                return tpath
    from .sparse import transpose  # deferred: sparse imports formats

    tmp = f"{tpath}.{os.getpid()}.tmp"
    write_pigo_csr(tmp, transpose(read_pigo_csr(gpath)))
    os.replace(tmp, tpath)
    with open(f"{spath}.{os.getpid()}.tmp", "w") as f:
        f.write(want + "\n")
    os.replace(f"{spath}.{os.getpid()}.tmp", spath)
    return tpath


def read_dense(path: str | os.PathLike, dtype=np.float32, ndim: int = 2) -> np.ndarray:
    """Read the raw dense format (reference matrix.hpp:486-492)."""
    with open(path, "rb") as f:
        shape = np.fromfile(f, dtype=np.uint32, count=ndim).astype(np.int64)
        payload = np.fromfile(f, dtype=dtype)
    expected = int(np.prod(shape))
    if payload.shape[0] != expected:
        raise ValueError(
            f"{path}: payload has {payload.shape[0]} elements, shape "
            f"{tuple(shape)} wants {expected}"
        )
    return payload.reshape(tuple(shape))


def write_dense(path: str | os.PathLike, arr: np.ndarray, dtype=None) -> None:
    """Write the raw dense format (reference prep.py:67-76)."""
    arr = np.ascontiguousarray(arr, dtype=dtype)
    with open(path, "wb") as f:
        np.array(arr.shape, dtype=np.uint32).tofile(f)
        arr.tofile(f)


@dataclass
class Dataset:
    """A training dataset directory: graph + features + labels + set masks
    (``graph.bin``, ``features.bin``, ``labels.bin`` int32 column,
    ``sets.bin`` int32 column with 0=train, 1=val, 2=test; main.cpp:82-85).
    """

    graph: CSRData
    features: np.ndarray
    labels: np.ndarray
    sets: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.graph.nrows

    @property
    def num_features(self) -> int:
        return int(self.features.shape[1])

    @property
    def num_labels(self) -> int:
        # Reference derivation: 1 + max(Y) (main.cpp:88)
        return int(1 + self.labels.max())

    @staticmethod
    def load(directory: str | os.PathLike) -> "Dataset":
        d = os.fspath(directory)
        return Dataset(
            graph=read_pigo_csr(os.path.join(d, "graph.bin")),
            features=read_dense(os.path.join(d, "features.bin"), np.float32),
            labels=read_dense(os.path.join(d, "labels.bin"), np.int32),
            sets=read_dense(os.path.join(d, "sets.bin"), np.int32),
        )

    def save(self, directory: str | os.PathLike) -> None:
        d = os.fspath(directory)
        os.makedirs(d, exist_ok=True)
        write_pigo_csr(os.path.join(d, "graph.bin"), self.graph)
        write_dense(os.path.join(d, "features.bin"), self.features, np.float32)
        write_dense(os.path.join(d, "labels.bin"), self.labels.reshape(-1, 1), np.uint32)
        write_dense(os.path.join(d, "sets.bin"), self.sets.reshape(-1, 1), np.uint32)
