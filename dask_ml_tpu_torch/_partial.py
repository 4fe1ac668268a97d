"""The deprecated ``Partial*`` estimators' base of the PyTorch port
(counterpart of ``dask_ml_tpu/_partial.py``), with the functional
:func:`fit` and :func:`predict`.

A ``Partial*`` class is a scikit-learn estimator subclassed with
:class:`_BigPartialFitMixin`, whose ``fit`` feeds row blocks to
``partial_fit`` through :func:`dask_ml_tpu_torch.wrappers.fit`; keyword
arguments named in ``_init_kwargs`` (``classes``) are taken at
construction and handed to every ``partial_fit`` call. They are host
estimators, as in the JAX package, and need scikit-learn; this module
does not import it.
"""

from __future__ import annotations

import warnings

import numpy as np

from dask_ml_tpu_torch import wrappers
from dask_ml_tpu_torch.wrappers import DEFAULT_BLOCK_SIZE, fit  # noqa: F401


class _BigPartialFitMixin:
    """``fit`` as a chain of ``partial_fit`` over row blocks."""

    _init_kwargs: list = []  # taken at __init__, handed to partial_fit
    _fit_kwargs: list = []   # taken at fit, handed to partial_fit

    def __init__(self, **kwargs):
        missing = set(self._init_kwargs) - set(kwargs)
        if missing:
            raise TypeError(
                f"{type(self).__name__} requires the keyword arguments "
                f"{sorted(missing)} at construction (forwarded to each "
                f"partial_fit call)")
        for kwarg in self._init_kwargs:
            setattr(self, kwarg, kwargs.pop(kwarg))
        warnings.warn(
            f"'{type(self).__name__}' is deprecated, use "
            f"'dask_ml_tpu_torch.wrappers.Incremental("
            f"{self._base().__name__}(...))' instead", FutureWarning)
        super().__init__(**kwargs)

    @classmethod
    def _base(cls):
        """The estimator class this one wraps: the first base that is not
        the mixin's and has a parameter protocol."""
        return next(b for b in cls.__mro__
                    if not issubclass(b, _BigPartialFitMixin)
                    and hasattr(b, "_get_param_names"))

    @classmethod
    def _get_param_names(cls):
        """The wrapped estimator's parameters and the extra init kwargs
        (only the first base's: scikit-learn's internal bases take
        parameters that the public class refuses)."""
        return sorted(set(cls._init_kwargs)
                      | set(cls._base()._get_param_names()))

    def fit(self, X, y=None, block_size: int = DEFAULT_BLOCK_SIZE):
        kwargs = {k: getattr(self, k) for k in self._init_kwargs}
        for k in self._fit_kwargs:
            if hasattr(self, k):
                kwargs[k] = getattr(self, k)
        wrappers.fit(self, X, y, block_size=block_size, **kwargs)
        return self


def _copy_partial_doc(cls):
    """Prefix the wrapped estimator's docstring with the deprecation
    note."""
    base = cls._base()
    cls.__doc__ = (
        f"Deprecated blockwise ``fit``-via-``partial_fit`` wrapper around "
        f"``{base.__module__}.{base.__name__}``; use "
        f"``dask_ml_tpu_torch.wrappers.Incremental`` instead.\n\n"
        + (base.__doc__ or ""))
    return cls


def predict(model, x, block_size: int = DEFAULT_BLOCK_SIZE):
    """``model.predict`` over row blocks of ``x``, concatenated (the host
    loop; :class:`~dask_ml_tpu_torch.wrappers.ParallelPostFit` is the
    parallel one)."""
    if getattr(x, "ndim", 2) != 2:
        raise ValueError("predict expects a 2-D input")
    n = int(x.shape[0])
    parts = [model.predict(x[i:i + block_size])
             for i in range(0, n, block_size)]
    if not parts:
        # zero rows: let the model shape and type the empty output, else
        # a bare empty array for models that refuse an empty batch
        try:
            return np.asarray(model.predict(x[:0]))
        except Exception:
            return np.empty((0,))
    return np.concatenate([np.asarray(p) for p in parts])
