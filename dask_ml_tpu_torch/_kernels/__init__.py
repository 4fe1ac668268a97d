"""Hand-written CUDA kernels of the port and their launch counters.

Each wrapper adds one to its entry of :data:`launches` (through
:func:`count`, under a lock: the search driver launches from several
threads) where it launches its kernel, and nowhere else, so a run can
show that a path really went through the kernels: set the counts to 0
with :func:`reset_launches` just before the path and read them just
after.
"""

from __future__ import annotations

import threading

_F32_KERNELS = ("lloyd_iter", "fused_argmin_min", "fused_rowwise_min",
                "fused_argmin_weight", "fused_argmin_min2",
                "fused_argmin_min_sketched", "spmv", "spmv_l2",
                "spmv_pullback", "spmv_pullback_l2")

#: launches per kernel wrapper (K1: lloyd_iter; K2-K5: fused distance;
#: the sketched assignment is K2 with a caller-supplied |x|²; K6: spmv and
#: spmv_pullback with the d-vector in shared memory, spmv_l2 and
#: spmv_pullback_l2 with it in L2). Each has a ``_bf16`` twin, counted
#: where the wrapper launches the kernel's bf16 case (bf16 X or values)
launches = {name + suffix: 0 for name in _F32_KERNELS
            for suffix in ("", "_bf16")}


_launches_lock = threading.Lock()


def count(name: str) -> None:
    """Add one launch of ``name``."""
    with _launches_lock:
        launches[name] += 1


def reset_launches() -> None:
    with _launches_lock:
        for k in launches:
            launches[k] = 0


def use_cuda(kernel: str, t) -> bool:
    """The dispatch rule of every kernel wrapper: ``"auto"`` launches the
    kernel for a CUDA tensor ``t`` and takes the plain version for a CPU
    one, ``"cuda"`` insists on the kernel, ``"torch"`` takes the plain
    version wherever ``t`` lies."""
    if kernel not in ("auto", "cuda", "torch"):
        raise ValueError(f"kernel must be auto|cuda|torch, got {kernel!r}")
    if kernel == "torch":
        return False
    if t.is_cuda:
        return True
    if kernel == "cuda":
        raise ValueError(
            f"kernel='cuda' needs CUDA tensors; the input lies on {t.device}")
    return False
