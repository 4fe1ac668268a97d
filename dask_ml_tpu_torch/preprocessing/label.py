"""LabelEncoder of the PyTorch port (counterpart of
``dask_ml_tpu/preprocessing/label.py``). Label vocabularies are host
metadata (they may be strings), so it runs in numpy on the host."""

from __future__ import annotations

import numpy as np

from dask_ml_tpu_torch.base import BaseEstimator


class LabelEncoder(BaseEstimator):
    """Encode labels as integers ``0 .. n_classes - 1`` in sorted order
    (scikit-learn's surface). Attribute: ``classes_``."""

    def fit(self, y):
        self.classes_ = np.unique(np.asarray(y))
        return self

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def _check_fitted(self):
        if not hasattr(self, "classes_"):
            raise AttributeError(
                "This LabelEncoder instance is not fitted yet; call fit "
                "first")

    def transform(self, y):
        self._check_fitted()
        y = np.asarray(y)
        diff = np.setdiff1d(y, self.classes_)
        if diff.size:
            raise ValueError(f"y contains previously unseen labels: {diff}")
        return np.searchsorted(self.classes_, y)

    def inverse_transform(self, y):
        self._check_fitted()
        return self.classes_[np.asarray(y)]


__all__ = ["LabelEncoder"]
