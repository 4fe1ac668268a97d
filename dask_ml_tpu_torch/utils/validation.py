"""Input validation and random-number handling for the PyTorch port
(counterpart of ``dask_ml_tpu/utils/validation.py``).

Validation runs on the host array before staging: the staging layer owns
the one host→device copy. Randomness is an explicit ``torch.Generator`` on
the configured device in place of a ``jax.random`` key. The two generators
give different numbers from the same seed (threefry against Philox), so
tests that compare the port with the JAX package hand both the same numpy
inputs and hold randomized paths to quality and determinism instead.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.config import resolve_device


def check_array(X):
    """Validate a dense input and return it as float32, ready to stage.

    Host inputs (numpy, lists) are validated in numpy and returned as a
    host ``np.ndarray``; a ``torch.Tensor`` (a ``device_outputs`` pipeline)
    is validated where it lies and returned as a tensor. Integer, bool and
    float64 inputs are converted to float32; NaN or infinity raises.
    DataFrames and scipy sparse matrices are rejected: the port's kernels
    take dense row-major float32 only."""
    if hasattr(X, "iloc"):
        raise TypeError(
            "DataFrame inputs are not supported here; pass .values")
    if hasattr(X, "tocsr") or hasattr(X, "indptr"):
        raise TypeError(
            "sparse input is not supported by the port's dense kernels; "
            "densify with .toarray()")
    is_tensor = isinstance(X, torch.Tensor)
    arr = X if is_tensor else np.asarray(X)
    if arr.ndim != 2:
        raise ValueError(
            f"Expected 2D array, got {arr.ndim}D array of shape "
            f"{tuple(arr.shape)}")
    if arr.shape[0] < 1:
        raise ValueError("Found array with 0 samples; at least 1 is needed")
    if is_tensor:
        if arr.is_complex():
            raise ValueError(f"Unsupported dtype {arr.dtype}")
        arr = arr.to(torch.float32)
        if not bool(torch.isfinite(arr).all()):
            raise ValueError("Input contains NaN or infinity")
        return arr
    if arr.dtype.kind not in "fiub":
        raise ValueError(f"Unsupported dtype {arr.dtype}")
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    if not bool(np.isfinite(arr).all()):
        raise ValueError("Input contains NaN or infinity")
    return arr


def check_random_state(seed=None, device=None) -> torch.Generator:
    """Coerce ``seed`` into a ``torch.Generator`` on the configured device
    (or ``device``): an int seeds it, ``None`` draws a fresh seed, a numpy
    ``RandomState`` supplies one, and a ``torch.Generator`` passes
    through."""
    if isinstance(seed, torch.Generator):
        return seed
    dev = resolve_device(device)
    if seed is None:
        value = int(np.random.SeedSequence().entropy % (2**63))
    elif isinstance(seed, (int, np.integer)):
        value = int(seed)
    elif isinstance(seed, np.random.RandomState):
        value = int(seed.randint(0, 2**31 - 1))
    else:
        raise TypeError(f"Cannot coerce {type(seed)!r} into a torch.Generator")
    g = torch.Generator(device=dev)
    g.manual_seed(value)
    return g
