"""Estimator base classes of the PyTorch port.

The parameter protocol of scikit-learn's ``BaseEstimator`` (``get_params``
/ ``set_params`` over the constructor's arguments, which is what
``sklearn.base.clone`` and the search tools call) and ``TransformerMixin``,
kept here so that the port runs where scikit-learn is not installed, as on
the card's machine.
"""

from __future__ import annotations

import inspect


class BaseEstimator:
    """Parameters are the constructor's keyword arguments, stored as
    attributes of the same name."""

    @classmethod
    def _get_param_names(cls) -> list:
        sig = inspect.signature(cls.__init__)
        return sorted(
            p.name for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL,
                                                   p.VAR_KEYWORD))

    def get_params(self, deep: bool = True) -> dict:
        return {k: getattr(self, k) for k in self._get_param_names()}

    def set_params(self, **params):
        valid = self._get_param_names()
        for k, v in params.items():
            if k not in valid:
                raise ValueError(
                    f"Invalid parameter {k!r} for estimator "
                    f"{type(self).__name__}; valid: {valid}")
            setattr(self, k, v)
        return self

    def __repr__(self) -> str:
        sig = inspect.signature(type(self).__init__)
        changed = []
        for k in self._get_param_names():
            default = sig.parameters[k].default
            v = getattr(self, k)
            if not (v is default or (isinstance(v, (int, float, str))
                                     and v == default)):
                changed.append(f"{k}={v!r}")
        return f"{type(self).__name__}({', '.join(changed)})"


class TransformerMixin:
    def fit_transform(self, X, y=None, **fit_params):
        return self.fit(X, y, **fit_params).transform(X)
