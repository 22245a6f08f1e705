"""The arithmetic every cell is measured with: the card's datasheet peaks
and a kernel's share of its roofline (recall is counted by the reference,
``reference.judge``).

A frozen copy, so that a change to the program cannot move the yardstick:
the peaks are NVIDIA's H100 SXM5 80GB datasheet figures at 700 W (the
same the port's ``kernels/build.py`` quotes).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

# the datasheet peaks by card name: device memory rate, f32 outside the
# tensor cores (the kernels here accumulate in f32 on the CUDA cores)
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12},
}
DEFAULT_PEAKS = PEAKS["NVIDIA H100 80GB HBM3"]


def peaks_for(kind: str) -> Dict[str, float]:
    return PEAKS.get(kind, DEFAULT_PEAKS)


def bound_s(nbytes: float, flops: float, peaks: Dict[str, float]) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and f32 operations over the f32 rate."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["f32_flops_per_s"])


def roofline_share(works: Iterable[tuple], device_s: float,
                   peaks: Dict[str, float]) -> Optional[float]:
    """Percent: the summed bound of every call (``(flops, bytes)`` each)
    over the kernel's device seconds.  None when there is nothing to read
    (no call, or no device time in the trace)."""
    works = list(works)
    if not works or not device_s or device_s <= 0:
        return None
    total = sum(bound_s(b, f, peaks) for f, b in works)
    return 100.0 * total / device_s
