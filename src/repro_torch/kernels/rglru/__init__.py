from .ops import rglru
from .patterns import register
from .ref import rglru_ref
from .rglru import (LIBRARY, rglru_scan, rglru_scan_autograd,
                    rglru_scan_backward, rglru_scan_plain)

__all__ = ["LIBRARY", "register", "rglru", "rglru_ref", "rglru_scan",
           "rglru_scan_autograd", "rglru_scan_backward", "rglru_scan_plain"]
