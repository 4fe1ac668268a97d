"""Estimator base classes of the PyTorch port.

The parameter protocol of scikit-learn's ``BaseEstimator`` (``get_params``
/ ``set_params`` over the constructor's arguments, nested
``estimator__<param>`` names included, which is what ``clone`` and the
search tools call), ``TransformerMixin``, :func:`clone` and
:func:`is_classifier`, kept here so that the port runs where scikit-learn
is not installed, as on the card's machine.
"""

from __future__ import annotations

import copy
import inspect


def clone(estimator):
    """A new unfitted estimator with the same parameters: the class called
    with ``get_params(deep=False)``, each parameter that is an estimator
    (or a list, tuple or set of them) cloned in turn, any other parameter
    deep-copied. Works on scikit-learn estimators too."""
    if isinstance(estimator, (list, tuple, set, frozenset)):
        return type(estimator)(clone(e) for e in estimator)
    if not hasattr(estimator, "get_params") or isinstance(estimator, type):
        return copy.deepcopy(estimator)
    params = {k: clone(v)
              for k, v in estimator.get_params(deep=False).items()}
    return type(estimator)(**params)


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
        """The constructor's parameters; with ``deep``, also every
        parameter of a parameter that is an estimator, as
        ``<name>__<param>``."""
        out = {}
        for k in self._get_param_names():
            v = getattr(self, k)
            if deep and hasattr(v, "get_params") and not isinstance(v, type):
                out.update((f"{k}__{sk}", sv)
                           for sk, sv in v.get_params(deep=True).items())
            out[k] = v
        return out

    def set_params(self, **params):
        """Set parameters by name; ``<name>__<param>`` sets ``param`` on
        the estimator held as ``name``."""
        valid = self._get_param_names()
        nested: dict = {}
        for k, v in params.items():
            name, sep, sub = k.partition("__")
            if name not in valid:
                raise ValueError(
                    f"Invalid parameter {name!r} for estimator "
                    f"{type(self).__name__}; valid: {valid}")
            if sep:
                nested.setdefault(name, {})[sub] = v
            else:
                setattr(self, name, v)
        for name, sub_params in nested.items():
            getattr(self, name).set_params(**sub_params)
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


def is_classifier(estimator) -> bool:
    """scikit-learn's test: the estimator's tags (or its
    ``_estimator_type``) say "classifier"; a pipeline is a classifier
    when its last step is. The port's estimators, like the JAX
    package's, declare no type, so they are not classifiers here."""
    steps = getattr(estimator, "steps", None)
    if isinstance(steps, list) and steps:
        return is_classifier(steps[-1][1])
    try:
        return estimator.__sklearn_tags__().estimator_type == "classifier"
    except Exception:
        return getattr(estimator, "_estimator_type", None) == "classifier"
