from .matmul import LIBRARY, matmul, matmul_grid, matmul_plain
from .ops import mm
from .ref import matmul_ref

__all__ = ["LIBRARY", "matmul", "matmul_grid", "matmul_plain", "matmul_ref",
           "mm"]
