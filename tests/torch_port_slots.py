"""The JAX package's edge-tile slot layout in CSR entry order, for the
tests that hold the port's attention stack against the JAX package: the JAX
ops return one value a slot, the port's one value a CSR entry."""

import numpy as np

from mg_gcn_tpu.ops import spmm_edges as jse


def slot_coords(jmat):
    """(valid, row, col) of every slot of a JAX EdgeTileMat, vectorized
    (the decode of ``tests/test_edge_attention.py:50-72``; int8-mode words
    carry the weight above bit 17, masked by RL_MASK)."""
    idx = np.asarray(jmat.idx)
    meta = np.asarray(jmat.meta).astype(np.int64)
    chi = np.asarray(jmat.chi).reshape(-1).astype(np.int64)
    step = np.repeat(np.arange(meta.size), jse.CPS)
    tr = (meta >> (jmat.tcw_bits + 1))[step][:, None]
    tcw = ((meta >> 1) & ((1 << jmat.tcw_bits) - 1))[step][:, None]
    v = (idx & jse.IDX_MASK).astype(np.int64)
    row = tr * jmat.br + ((v >> 7) & jse.RL_MASK)
    col = tcw * jse.BCW + chi[:, None] * jse.BC + (v & (jse.BC - 1))
    return ((idx >> 30) & 1) == 1, row, col


def _csr_keys(csr):
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), np.diff(csr.indptr))
    return rows * csr.ncols + csr.indices


def slots_to_csr_order(jmat, csr, slots) -> np.ndarray:
    """The value of each CSR entry's slot. Duplicate (row, col) entries
    each have a slot; their values are equal in every function compared
    here (they depend on (row, col) only), so any of them serves."""
    valid, row, col = slot_coords(jmat)
    key = (row * csr.ncols + col)[valid]
    vals = np.asarray(slots, np.float32)[valid]
    order = np.argsort(key, kind="stable")
    pos = np.searchsorted(key[order], _csr_keys(csr))
    assert np.array_equal(key[order][pos], _csr_keys(csr)), "a CSR entry has no slot"
    return vals[order][pos]


def csr_to_slots(jmat, csr, values) -> np.ndarray:
    """Slot-layout array (zeros on padding) holding each CSR entry's value,
    for a CSR without duplicate entries."""
    valid, row, col = slot_coords(jmat)
    keys = _csr_keys(csr)
    order = np.argsort(keys)
    out = np.zeros(valid.shape, np.float32)
    pos = np.searchsorted(keys[order], (row * csr.ncols + col)[valid])
    out[valid] = np.asarray(values, np.float32)[order][pos]
    return out
