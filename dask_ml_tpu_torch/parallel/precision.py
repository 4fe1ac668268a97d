"""Compensated summation of the PyTorch port (the ``neumaier_add`` step
of ``dask_ml_tpu/parallel/precision.py``; the rest of the precision tier
is not ported)."""

from __future__ import annotations

import torch


def neumaier_add(total, comp, x):
    """One compensated-summation step, ``(total, comp) += x``, with the
    rounding error kept in ``comp`` (Neumaier's variant of Kahan's, which
    stays right when ``|x| > |total|``). The running sum is
    ``total + comp``: add them once, at the end of the chain. Elementwise,
    so one step serves a scalar, the column sums and the streamed Gram."""
    t = total + x
    comp = comp + torch.where(torch.abs(total) >= torch.abs(x),
                              (total - t) + x, (x - t) + total)
    return t, comp
