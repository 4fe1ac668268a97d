"""Array logging and the profiling alias of the PyTorch port (the
counterpart of ``dask_ml_tpu/utils/_log.py``).

:func:`log_array` writes one line per array: shape, dtype, bytes and where
it lies (a ``torch.Tensor``'s device, else the host; for a rank's block of
a sharded array, the mesh axes, the rank and its rows). :func:`profile_phase`
is an alias of :func:`~dask_ml_tpu_torch.parallel.telemetry.span` with a
logger: a profiler range, a DEBUG line of the phase's wall time, and with
``DASK_ML_TPU_PROFILE_DIR`` set a ``torch.profiler`` capture of the
outermost phase written into that directory.
"""

from __future__ import annotations

import logging

__all__ = ["format_bytes", "log_array", "profile_phase"]

PROFILE_DIR_ENV = "DASK_ML_TPU_PROFILE_DIR"


def format_bytes(n: int) -> str:
    """1234 → '1.23 kB'."""
    if n > 1e9:
        return "%0.2f GB" % (n / 1e9)
    if n > 1e6:
        return "%0.2f MB" % (n / 1e6)
    if n > 1e3:
        return "%0.2f kB" % (n / 1e3)
    return "%d B" % n


def _placement(x, mesh=None, rows=None) -> str:
    """Where an array lies: a tensor's device, else the host; on a mesh of
    more than one rank also the mesh axes, this rank and its slice of
    rows ``[start, stop)``."""
    dev = getattr(x, "device", None)
    if dev is None:
        values = getattr(x, "values", None)  # a SparseRows container
        dev = getattr(values, "device", None)
    where = str(dev) if dev is not None else "host"
    if mesh is not None and mesh.size > 1:
        axes = ", ".join(f"{a}={s}" for a, s in mesh.shape.items())
        where += f" mesh({axes}) rank {mesh.rank}"
        if rows is not None:
            where += f" rows [{rows[0]}, {rows[1]})"
    return where


def _itemsize(dtype) -> int:
    """Bytes per element of a numpy or torch dtype (bfloat16 included,
    which numpy does not know)."""
    size = getattr(dtype, "itemsize", None)
    if isinstance(size, int):
        return size
    try:
        import numpy as np

        return int(np.dtype(dtype).itemsize)
    except TypeError:
        return 4


def log_array(logger: logging.Logger, name: str, x,
              level: int = logging.INFO, mesh=None, rows=None) -> None:
    """One line: name, shape, dtype, bytes, placement (with ``mesh``, the
    mesh axes, this rank and its ``rows``)."""
    if not logger.isEnabledFor(level):
        return
    shape = tuple(getattr(x, "shape", ()))
    dtype = getattr(x, "dtype", None)
    nbytes = getattr(x, "nbytes", None)
    if nbytes is None and hasattr(x, "nnz") and hasattr(x, "data"):
        # scipy sparse: the bytes held (data, indices, indptr), never the
        # dense n·d·itemsize the shape would give
        nbytes = int(getattr(x.data, "nbytes", 0))
        for attr in ("indices", "indptr", "row", "col", "offsets"):
            arr = getattr(x, attr, None)
            if arr is not None:
                nbytes += int(getattr(arr, "nbytes", 0))
    if nbytes is None and dtype is not None:
        size = 1
        for s in shape:
            size *= int(s)
        nbytes = size * _itemsize(dtype)
    logger.log(
        level, "%s: shape=%s dtype=%s %s on %s",
        name, shape, dtype,
        format_bytes(int(nbytes)) if nbytes is not None else "?",
        _placement(x, mesh, rows),
    )


def profile_phase(logger: logging.Logger, name: str):
    """Alias of ``telemetry.span(name, logger=logger)``: the phase's
    profiler range and DEBUG wall-time line whatever the ``telemetry``
    knob, a span in the ring when it is on."""
    from dask_ml_tpu_torch.parallel.telemetry import span

    return span(name, logger=logger)
