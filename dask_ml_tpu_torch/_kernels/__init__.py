"""Hand-written CUDA kernels of the port and their launch counters.

Each wrapper adds one to its entry of :data:`launches` where it launches
its kernel, and nowhere else, so a run can show that a path really went
through the kernels: set the counts to 0 with :func:`reset_launches` just
before the path and read them just after.
"""

from __future__ import annotations

#: launches per kernel wrapper (K1: lloyd_iter; K2-K5: fused distance;
#: the sketched assignment is K2 with a caller-supplied |x|²)
launches = {
    "lloyd_iter": 0,
    "fused_argmin_min": 0,
    "fused_rowwise_min": 0,
    "fused_argmin_weight": 0,
    "fused_argmin_min2": 0,
    "fused_argmin_min_sketched": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
