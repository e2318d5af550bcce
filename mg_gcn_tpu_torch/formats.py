"""Binary graph/matrix formats compatible with the reference framework.

Port of ``mg_gcn_tpu/formats.py`` (numpy only, no framework dependency):

* **PIGO-CSR-v2** sparse format: an 11-byte ASCII magic ``PIGO-CSR-v2``, two
  uint8 width descriptors (bytes per vertex / edge index), then ``N``,
  ``nnz``, ``nrows``, ``ncols`` as uint32/uint64 by those widths, followed by
  ``indptr`` (N+1), ``indices`` (nnz) and float32 ``data`` (nnz).
* **Raw dense format**: the shape as uint32 values (one per dimension), then
  the row-major payload in the element dtype.

``ensure_pigo_transpose`` writes the transposed ``graph_t.bin`` that prep
leaves beside a dataset, and ``check_pigo_transpose`` only checks it. The
multi-process path reads no whole graph: ``GraphHeader`` (from
``read_pigo_header``) keeps the graph on disk, ``read_pigo_csr_slab`` reads
one row slab, ``read_pigo_row_sums`` streams the row sums, and
``read_dense(mmap=True)`` maps the features (``Dataset.load(directory,
mmap_features, graph_mode)``).
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


def _pigo_layout(mm: np.ndarray, path) -> tuple:
    """(vertex dtype, edge dtype, n, nnz, ncols, indptr offset) of a
    PIGO-CSR file mapped as bytes, its magic checked."""
    magic = mm[: len(PIGO_MAGIC)].tobytes()
    if magic != PIGO_MAGIC:
        raise ValueError(f"{path}: bad magic {magic!r}, expected {PIGO_MAGIC!r}")
    off = len(PIGO_MAGIC)
    vdt, edt = _index_dtype(int(mm[off])), _index_dtype(int(mm[off + 1]))
    vsz, esz = np.dtype(vdt).itemsize, np.dtype(edt).itemsize
    off += 2
    n = int(np.frombuffer(mm[off : off + vsz], vdt)[0])
    nnz = int(np.frombuffer(mm[off + vsz : off + vsz + esz], edt)[0])
    ncols = int(np.frombuffer(mm[off + 2 * vsz + esz : off + 3 * vsz + esz], vdt)[0])
    return vdt, edt, n, nnz, ncols, off + 3 * vsz + esz  # past n, nnz, nrows, ncols


def read_pigo_csr_slab(path: str | os.PathLike, r0: int, r1: int) -> CSRData:
    """Rows [r0, r1) of a PIGO-CSR-v2 file, read through a memory map: the
    bytes of that row slab only. Returns a CSRData of shape (r1 - r0,
    ncols) with global column ids and its indptr rebased to 0."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    vdt, edt, n, nnz, ncols, ip_off = _pigo_layout(mm, path)
    if not (0 <= r0 <= r1 <= n):
        raise ValueError(f"slab [{r0}, {r1}) out of range for n={n}")
    vsz, esz = np.dtype(vdt).itemsize, np.dtype(edt).itemsize
    ind_off = ip_off + vsz * (n + 1)
    dat_off = ind_off + esz * nnz
    indptr = np.array(mm[ip_off + vsz * r0 : ip_off + vsz * (r1 + 1)].view(vdt), dtype=np.int64)
    e0, e1 = int(indptr[0]), int(indptr[-1])
    indices = np.array(mm[ind_off + esz * e0 : ind_off + esz * e1].view(edt), dtype=np.int32)
    data = np.array(mm[dat_off + 4 * e0 : dat_off + 4 * e1].view(np.float32))
    return CSRData(indptr=indptr - e0, indices=indices, data=data, shape=(r1 - r0, ncols))


@dataclass(frozen=True)
class GraphHeader:
    """A graph that stays on disk: its shape, entry count and path. The
    multi-process path (``Dataset.load(..., graph_mode="header")``) reads
    only row slabs of it (``parallel.dist_halo.DistHaloPair.from_pigo``)."""

    nrows: int
    ncols: int
    nnz: int
    path: str


def read_pigo_header(path: str | os.PathLike) -> GraphHeader:
    """(nrows, ncols, nnz) from a PIGO-CSR header, no entry read."""
    with open(path, "rb") as f:
        head = f.read(len(PIGO_MAGIC) + 2 + 4 * 8)
    if head[: len(PIGO_MAGIC)] != PIGO_MAGIC:
        raise ValueError(f"{path}: bad magic {head[: len(PIGO_MAGIC)]!r}, expected {PIGO_MAGIC!r}")
    vdt = _index_dtype(head[len(PIGO_MAGIC)])
    edt = _index_dtype(head[len(PIGO_MAGIC) + 1])
    vsz, esz = np.dtype(vdt).itemsize, np.dtype(edt).itemsize
    off = len(PIGO_MAGIC) + 2

    def take(dt, sz, at):
        return int(np.frombuffer(head[at : at + sz], dt)[0])

    nnz = take(edt, esz, off + vsz)
    nrows = take(vdt, vsz, off + vsz + esz)
    ncols = take(vdt, vsz, off + 2 * vsz + esz)
    return GraphHeader(nrows=nrows, ncols=ncols, nnz=nnz, path=os.fspath(path))


def read_pigo_nrows(path: str | os.PathLike) -> int:
    """The row count from a PIGO-CSR header (magic checked, no entry read)."""
    return read_pigo_header(path).nrows


def read_pigo_indptr_at(path: str | os.PathLike, rows) -> np.ndarray:
    """The indptr values at ``rows``, read off the file (one word each)."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    vdt, _, _, _, _, ip_off = _pigo_layout(mm, path)
    vsz = np.dtype(vdt).itemsize
    return np.array([int(np.frombuffer(mm[ip_off + vsz * r : ip_off + vsz * (r + 1)], vdt)[0]) for r in rows],
                    dtype=np.int64)


def read_pigo_row_sums(path: str | os.PathLike, chunk_rows: int = 1 << 22) -> np.ndarray:
    """Each row's value sum, float64[n], streamed through a memory map
    ``chunk_rows`` rows at a time: the whole value array is never in memory.
    On ``graph_t.bin`` these are the column sums of A, GCN's in-degree
    diagonal (matrix.hpp:340-390), summed in float64 as
    ``sparse.normalize`` sums them."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    vdt, edt, n, nnz, _, ip_off = _pigo_layout(mm, path)
    vsz, esz = np.dtype(vdt).itemsize, np.dtype(edt).itemsize
    dat_off = ip_off + vsz * (n + 1) + esz * nnz
    out = np.zeros(n, np.float64)
    for r0 in range(0, n, chunk_rows):
        r1 = min(r0 + chunk_rows, n)
        ptr = np.array(mm[ip_off + vsz * r0 : ip_off + vsz * (r1 + 1)].view(vdt), dtype=np.int64)
        e0, e1 = int(ptr[0]), int(ptr[-1])
        if e1 == e0:
            continue
        # a trailing 0 keeps reduceat's start of an empty last row in range
        data = np.concatenate([mm[dat_off + 4 * e0 : dat_off + 4 * e1].view(np.float32).astype(np.float64), [0.0]])
        sums = np.add.reduceat(data, ptr[:-1] - e0)
        out[r0:r1] = np.where(np.diff(ptr) > 0, sums, 0.0)
    return out


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


def check_pigo_transpose(directory: str | os.PathLike) -> str:
    """The path of ``graph_t.bin`` when it is there and was built from the
    ``graph.bin`` that is there now (its ``.sha256``, as
    :func:`ensure_pigo_transpose` writes it); else ValueError naming the
    function that writes it. Never transposes: the multi-process path checks
    with this, so that no process holds the whole graph."""
    d = os.fspath(directory)
    tpath = os.path.join(d, "graph_t.bin")
    spath = tpath + ".sha256"
    fix = (f"run mg_gcn_tpu_torch.formats.ensure_pigo_transpose({d!r}) (or prep, which writes it) once before a"
           " multi-process run")
    if not os.path.exists(tpath):
        raise ValueError(f"{tpath} is missing: {fix}")
    if not os.path.exists(spath):
        raise ValueError(f"{tpath} has no {os.path.basename(spath)}, so it cannot be matched to graph.bin: {fix}")
    with open(spath) as f:
        if f.read().strip() != _sha256(os.path.join(d, "graph.bin")):
            raise ValueError(f"{tpath} was built from another graph.bin: {fix}")
    return tpath


def read_dense(path: str | os.PathLike, dtype=np.float32, ndim: int = 2, mmap: bool = False) -> np.ndarray:
    """Read the raw dense format (reference matrix.hpp:486-492).

    ``mmap=True`` returns a read-only ``np.memmap`` of the payload, its size
    checked against the file's length first: rows are paged in as they are
    read, so a caller that slices one partition's rows at a time
    (``parallel.multihost.shard_put``) never holds the whole matrix."""
    with open(path, "rb") as f:
        shape = np.fromfile(f, dtype=np.uint32, count=ndim).astype(np.int64)
    expected = int(np.prod(shape))
    if mmap:
        # a memmap of the header's shape would not notice a short file
        avail = (os.path.getsize(path) - 4 * ndim) // np.dtype(dtype).itemsize
        if avail != expected:
            raise ValueError(f"{path}: payload has {avail} elements, shape {tuple(shape)} wants {expected}")
        return np.memmap(path, dtype=dtype, mode="r", offset=4 * ndim, shape=tuple(shape))
    with open(path, "rb") as f:
        f.seek(4 * ndim)
        payload = np.fromfile(f, dtype=dtype)
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

    graph: CSRData | GraphHeader
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
    def load(directory: str | os.PathLike, mmap_features: bool = False, graph_mode: str = "full") -> "Dataset":
        """``mmap_features`` maps ``features.bin`` (``read_dense(mmap=True)``);
        ``graph_mode="header"`` keeps the graph on disk as a
        :class:`GraphHeader`, for the multi-process path, whose processes
        read only their own row slabs."""
        d = os.fspath(directory)
        gpath = os.path.join(d, "graph.bin")
        if graph_mode not in ("full", "header"):
            raise ValueError(f"unknown graph_mode {graph_mode!r}")
        return Dataset(
            graph=read_pigo_csr(gpath) if graph_mode == "full" else read_pigo_header(gpath),
            features=read_dense(os.path.join(d, "features.bin"), np.float32, mmap=mmap_features),
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
