from .ops import ssd_states
from .patterns import register
from .ref import ssd_chunk_scan_ref
from .ssd import (LIBRARY, ssd_chunk_scan, ssd_chunk_scan_autograd,
                  ssd_chunk_scan_backward, ssd_chunk_scan_backward_plain,
                  ssd_chunk_scan_plain)

__all__ = ["LIBRARY", "register", "ssd_chunk_scan", "ssd_chunk_scan_autograd",
           "ssd_chunk_scan_backward", "ssd_chunk_scan_backward_plain",
           "ssd_chunk_scan_plain", "ssd_chunk_scan_ref", "ssd_states"]
