"""Pipelines of the PyTorch port: :class:`Pipeline`, :class:`FeatureUnion`
and :func:`make_pipeline`, with scikit-learn's surface.

The card's machine has no scikit-learn, so the port carries the parts of
``sklearn.pipeline`` that the search driver and users compose estimators
with, as ``base.py`` carries ``BaseEstimator``: ``steps`` and
``named_steps``, ``"passthrough"`` and ``None`` stages (and ``"drop"`` in
a union), ``transformer_weights``, nested ``<step>__<param>`` names in
``get_params`` / ``set_params`` and ``fit`` parameters. Stage outputs may
be numpy arrays or device tensors (under ``device_outputs``): a union
concatenates tensors with ``torch.cat`` on their device.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from dask_ml_tpu_torch.base import BaseEstimator


def _is_identity(step) -> bool:
    return step is None or (isinstance(step, str)
                            and step in ("passthrough", "drop"))


class _Bunch(dict):
    """A dict whose keys read as attributes (``named_steps.pca``)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e


class _Composition(BaseEstimator):
    """``get_params`` / ``set_params`` over a list of named estimators held
    in the attribute ``_attr`` (``steps`` or ``transformer_list``)."""

    _attr = ""

    def get_params(self, deep: bool = True) -> dict:
        out = super().get_params(deep=False)
        if not deep:
            return out
        items = getattr(self, self._attr)
        out.update(items)
        for name, est in items:
            if hasattr(est, "get_params") and not isinstance(est, type):
                for k, v in est.get_params(deep=True).items():
                    out[f"{name}__{k}"] = v
        return out

    def set_params(self, **params):
        if self._attr in params:
            setattr(self, self._attr, params.pop(self._attr))
        items = list(getattr(self, self._attr))
        names = [n for n, _ in items]
        for key in list(params):
            if "__" not in key and key in names:
                items[names.index(key)] = (key, params.pop(key))
        setattr(self, self._attr, items)
        nested: dict = {}
        own: dict = {}
        for key, value in params.items():
            name, sep, sub = key.partition("__")
            if sep and name in names:
                nested.setdefault(name, {})[sub] = value
            else:
                own[key] = value
        if own:
            super().set_params(**own)
        for name, sub_params in nested.items():
            est = dict(items)[name]
            est.set_params(**sub_params)
        return self

    def _validate_names(self, names) -> None:
        if len(set(names)) != len(names):
            raise ValueError(f"Names provided are not unique: {names!r}")
        bad = [n for n in names if "__" in n]
        if bad:
            raise ValueError(
                f"Estimator names must not contain __: got {bad!r}")
        own = set(self._get_param_names())
        clash = sorted(own.intersection(names))
        if clash:
            raise ValueError(
                f"Estimator names conflict with constructor arguments: "
                f"{clash!r}")


def _split_fit_params(names, fit_params) -> dict:
    out = {name: {} for name in names}
    for key, value in fit_params.items():
        name, sep, sub = key.partition("__")
        if not sep or name not in out:
            raise ValueError(
                f"Pipeline.fit does not accept the {key!r} parameter; pass "
                "parameters to a step as <step>__<parameter>")
        out[name][sub] = value
    return out


class Pipeline(_Composition):
    """A chain of transformers ending in any estimator.

    Parameters
    ----------
    steps : list of (name, estimator) tuples; a step may be
        ``"passthrough"`` or ``None`` (the identity).
    memory : accepted for signature parity; nothing is cached.
    verbose : bool, accepted for signature parity.
    """

    _attr = "steps"

    def __init__(self, steps, memory=None, verbose=False):
        self.steps = steps
        self.memory = memory
        self.verbose = verbose

    @property
    def named_steps(self):
        return _Bunch(self.steps)

    @property
    def _final_estimator(self):
        est = self.steps[-1][1]
        return "passthrough" if est is None else est

    def __len__(self) -> int:
        return len(self.steps)

    def __getitem__(self, ind):
        if isinstance(ind, slice):
            if ind.step not in (None, 1):
                raise ValueError("Pipeline slicing only supports a step of 1")
            return type(self)(self.steps[ind], memory=self.memory,
                              verbose=self.verbose)
        if isinstance(ind, str):
            return self.named_steps[ind]
        return self.steps[ind][1]

    def _validate_steps(self) -> None:
        names = [n for n, _ in self.steps]
        self._validate_names(names)
        for name, t in self.steps[:-1]:
            if _is_identity(t):
                continue
            if not (hasattr(t, "fit") or hasattr(t, "fit_transform")) \
                    or not hasattr(t, "transform"):
                raise TypeError(
                    f"All intermediate steps should be transformers and "
                    f"implement fit and transform or be 'passthrough'; "
                    f"{name!r} ({t!r}) does not")
        last = self._final_estimator
        if not _is_identity(last) and not hasattr(last, "fit"):
            raise TypeError(
                f"Last step of Pipeline should implement fit or be "
                f"'passthrough'; got {last!r}")

    def _fit_prefix(self, X, y, params):
        Xt = X
        for name, t in self.steps[:-1]:
            if _is_identity(t):
                continue
            if hasattr(t, "fit_transform"):
                Xt = t.fit_transform(Xt, y, **params[name])
            else:
                Xt = t.fit(Xt, y, **params[name]).transform(Xt)
        return Xt

    def fit(self, X, y=None, **fit_params):
        self._validate_steps()
        params = _split_fit_params([n for n, _ in self.steps], fit_params)
        Xt = self._fit_prefix(X, y, params)
        name, last = self.steps[-1]
        if not _is_identity(last):
            last.fit(Xt, y, **params[name])
        return self

    def fit_transform(self, X, y=None, **fit_params):
        self._validate_steps()
        params = _split_fit_params([n for n, _ in self.steps], fit_params)
        Xt = self._fit_prefix(X, y, params)
        name, last = self.steps[-1]
        if _is_identity(last):
            return Xt
        if hasattr(last, "fit_transform"):
            return last.fit_transform(Xt, y, **params[name])
        return last.fit(Xt, y, **params[name]).transform(Xt)

    def _transform_prefix(self, X):
        Xt = X
        for _, t in self.steps[:-1]:
            if not _is_identity(t):
                Xt = t.transform(Xt)
        return Xt

    def _final(self, method: str):
        last = self._final_estimator
        if _is_identity(last) or not hasattr(last, method):
            raise AttributeError(
                f"the final step of this Pipeline has no {method!r}")
        return getattr(last, method)

    def predict(self, X, **params):
        return self._final("predict")(self._transform_prefix(X), **params)

    def predict_proba(self, X):
        return self._final("predict_proba")(self._transform_prefix(X))

    def predict_log_proba(self, X):
        return self._final("predict_log_proba")(self._transform_prefix(X))

    def decision_function(self, X):
        return self._final("decision_function")(self._transform_prefix(X))

    def score(self, X, y=None, sample_weight=None):
        kw = {} if sample_weight is None else {"sample_weight": sample_weight}
        return self._final("score")(self._transform_prefix(X), y, **kw)

    def transform(self, X):
        Xt = self._transform_prefix(X)
        last = self._final_estimator
        return Xt if _is_identity(last) else last.transform(Xt)

    def inverse_transform(self, X):
        Xt = X
        for _, t in reversed(self.steps):
            if not _is_identity(t):
                Xt = t.inverse_transform(Xt)
        return Xt

    @property
    def classes_(self):
        return self.steps[-1][1].classes_


def _hstack(parts, n_rows: int):
    """Horizontal concatenation of a union's outputs: ``torch.cat`` on the
    first tensor's device when any output is a tensor, scipy's ``hstack``
    when any is sparse, else numpy's."""
    if not parts:
        return np.zeros((n_rows, 0))
    import torch

    if any(isinstance(p, torch.Tensor) for p in parts):
        dev = next(p.device for p in parts if isinstance(p, torch.Tensor))
        return torch.cat([torch.as_tensor(np.asarray(p) if not isinstance(
            p, torch.Tensor) else p, device=dev).to(torch.float32)
            for p in parts], dim=1)
    from scipy import sparse

    if any(sparse.issparse(p) for p in parts):
        return sparse.hstack(parts).tocsr()
    return np.hstack([np.asarray(p) for p in parts])


def union_concat(parts, weights, n_rows: int):
    """Weighted horizontal concatenation of ``(name, output)`` pairs, as
    :meth:`FeatureUnion.transform` makes it."""
    arrays = []
    for name, Xt in parts:
        w = (weights or {}).get(name)
        arrays.append(Xt if w is None else Xt * w)
    return _hstack(arrays, n_rows)


def _n_rows(X) -> int:
    shape = getattr(X, "shape", None)
    return int(shape[0]) if shape is not None else len(X)


class FeatureUnion(_Composition):
    """Concatenates the outputs of several transformers fitted on the same
    input. A member may be ``"drop"``/``None`` (left out) or
    ``"passthrough"`` (the input unchanged); ``transformer_weights``
    multiplies a member's output by its weight."""

    _attr = "transformer_list"

    def __init__(self, transformer_list, n_jobs=None,
                 transformer_weights=None, verbose=False,
                 verbose_feature_names_out=True):
        self.transformer_list = transformer_list
        self.n_jobs = n_jobs
        self.transformer_weights = transformer_weights
        self.verbose = verbose
        self.verbose_feature_names_out = verbose_feature_names_out

    @property
    def named_transformers(self):
        return _Bunch(self.transformer_list)

    def _members(self):
        self._validate_names([n for n, _ in self.transformer_list])
        return [(n, t) for n, t in self.transformer_list
                if not (t is None or t == "drop")]

    def fit(self, X, y=None, **fit_params):
        for _, t in self._members():
            if t != "passthrough":
                t.fit(X, y, **fit_params)
        return self

    def transform(self, X):
        parts = [(n, X if t == "passthrough" else t.transform(X))
                 for n, t in self._members()]
        return union_concat(parts, self.transformer_weights, _n_rows(X))

    def fit_transform(self, X, y=None, **fit_params):
        parts = []
        for n, t in self._members():
            if t == "passthrough":
                parts.append((n, X))
            elif hasattr(t, "fit_transform"):
                parts.append((n, t.fit_transform(X, y, **fit_params)))
            else:
                parts.append((n, t.fit(X, y, **fit_params).transform(X)))
        return union_concat(parts, self.transformer_weights, _n_rows(X))


def _name_estimators(estimators):
    """scikit-learn's names: the lower-cased class name, with ``-1``,
    ``-2`` … where two steps share one."""
    names = [
        est if isinstance(est, str) else type(est).__name__.lower()
        for est in estimators
    ]
    counts = Counter(names)
    seen: dict = {}
    out = []
    for name, est in zip(names, estimators):
        if counts[name] > 1:
            seen[name] = seen.get(name, 0) + 1
            name = f"{name}-{seen[name]}"
        out.append((name, est))
    return out


def make_pipeline(*steps, memory=None, verbose=False):
    """A :class:`Pipeline` whose step names are made from the classes."""
    return Pipeline(_name_estimators(steps), memory=memory, verbose=verbose)


__all__ = ["FeatureUnion", "Pipeline", "make_pipeline"]
