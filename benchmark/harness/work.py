"""The work an epoch must do, counted from a configuration's shapes and the
graph's size, never from the engine that runs it, and the least time that
work could take on the chip.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 989 TFLOP/s in bf16 and fp16 on the tensor cores, 495 in TF32,
67 TFLOP/s in float32 outside them, 1,979 TOP/s in int8, 3.35 TB/s of HBM.

A sparse product C = A·B of width d over a binary graph of nnz entries
counts 2·nnz·d operations and the least bytes a CSR needs for it: a 4-byte
column index an entry, an 8-byte offset a row, the dense operand read once
and the output written once in the operand's dtype. Its least time is the larger of the operations
over the peak of that dtype and the bytes over the HBM rate. A dense product
(m × k)·(k × n) counts 2·m·k·n operations at the peak of the dense dtype.
Elementwise work is not counted, so a share of this least time is a floor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12, "int8": 1979e12}
HBM_BYTES_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


@dataclass(frozen=True)
class Product:
    """One sparse product of width ``d`` over an (n_rows × n_cols) graph."""

    n_rows: int
    n_cols: int
    nnz: int
    d: int
    dtype: str

    @property
    def flops(self) -> float:
        return 2.0 * self.nnz * self.d

    @property
    def bytes(self) -> float:
        b = DTYPE_BYTES[self.dtype]
        csr = 4.0 * self.nnz + 8.0 * (self.n_rows + 1)
        return csr + b * self.d * (self.n_cols + self.n_rows)

    def least_s(self, cards: int = 1) -> float:
        return max(self.flops / (PEAK_FLOPS[self.dtype] * cards), self.bytes / (HBM_BYTES_S * cards))


@dataclass(frozen=True)
class Gemm:
    """One dense product (m × k)·(k × n)."""

    m: int
    k: int
    n: int
    dtype: str

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n

    def least_s(self, cards: int = 1) -> float:
        return self.flops / (PEAK_FLOPS[self.dtype] * cards)


@dataclass
class Work:
    """An epoch's products and dense products, on ``cards`` cards whose
    peaks add up."""

    products: list = field(default_factory=list)
    gemms: list = field(default_factory=list)
    cards: int = 1

    @property
    def products_least_s(self) -> float:
        return sum(p.least_s(self.cards) for p in self.products)

    @property
    def gemms_least_s(self) -> float:
        return sum(g.least_s(self.cards) for g in self.gemms)

    @property
    def least_s(self) -> float:
        return self.products_least_s + self.gemms_least_s


def dense_dtype(config: dict) -> str:
    """The peak the dense layers run at: float32 outside the tensor cores
    unless the configuration allows TF32."""
    dt = config["dense_dtype"]
    return "tf32" if dt == "float32" and config.get("tf32") else dt
