"""Cross-validation splitting of the PyTorch port (counterpart of
``dask_ml_tpu/model_selection/_split.py``).

Index generation is host numpy work, done once a search. The splitters
keep the JAX package's algorithms index for index: :class:`ShuffleSplit`
permutes each block of rows locally with per-block seeds and offsets the
result into global row ids (``blockwise=True``), or the whole row range
(``blockwise=False``); :class:`KFold` takes contiguous folds. The
blocks are the mesh's data shards, as in the JAX package:
``n_blocks=None`` means ``n_data_shards`` of
:func:`~dask_ml_tpu_torch.parallel.mesh.collective_mesh` (one block on one
device, or in a world of one rank).

:func:`check_cv` resolves an int for a classifier with categorical ``y``
to :class:`StratifiedKFold`, the port's copy of scikit-learn's (the same
folds, index for index), since the card's machine has no scikit-learn.
"""

from __future__ import annotations

import numbers
import warnings
from typing import Optional

import numpy as np

from dask_ml_tpu_torch.model_selection._params import check_random_state


class BaseCrossValidator:
    """scikit-learn's splitter protocol: ``split(X, y, groups)`` yields
    ``(train_idx, test_idx)`` from ``_iter_test_masks`` (by default from
    ``_iter_test_indices``); ``get_n_splits``."""

    def split(self, X, y=None, groups=None):
        indices = np.arange(_num_samples(X))
        for test_mask in self._iter_test_masks(X, y, groups):
            yield indices[np.logical_not(test_mask)], indices[test_mask]

    def _iter_test_masks(self, X=None, y=None, groups=None):
        for test_index in self._iter_test_indices(X, y, groups):
            mask = np.zeros(_num_samples(X), dtype=bool)
            mask[test_index] = True
            yield mask

    def _iter_test_indices(self, X=None, y=None, groups=None):
        raise NotImplementedError

    def get_n_splits(self, X=None, y=None, groups=None):
        raise NotImplementedError


def _num_samples(X) -> int:
    shape = getattr(X, "shape", None)
    if shape is not None and len(shape) >= 1:
        return int(shape[0])
    return len(X)


def _check_blockwise_sizes(test_size, train_size):
    """Blockwise splits take float fractions only: integer sizes cannot be
    honored exactly when each block is split locally."""
    if test_size is None and train_size is None:
        test_size = 0.1
    for name, value in (("test_size", test_size), ("train_size", train_size)):
        if value is not None and not isinstance(value, numbers.Real):
            raise ValueError(f"{name} must be a float fraction, got {value!r}")
        if value is not None and isinstance(value, numbers.Integral):
            raise ValueError(
                f"{name} must be a float fraction for blockwise splits; got "
                f"int {value!r}")
        if value is not None and not 0 < value < 1:
            raise ValueError(f"{name} must be in (0, 1), got {value!r}")
    if test_size is None:
        test_size = 1.0 - train_size
    if train_size is None:
        train_size = 1.0 - test_size
    if test_size + train_size > 1 + 1e-9:
        raise ValueError(
            f"test_size + train_size = {test_size + train_size} > 1")
    return float(test_size), float(train_size)


def _block_sizes(n: int, n_blocks: int) -> list:
    """``n`` rows in ``n_blocks`` near-equal contiguous blocks (the longer
    blocks first)."""
    n_blocks = max(1, min(n_blocks, n))
    base, extra = divmod(n, n_blocks)
    return [base + (1 if i < extra else 0) for i in range(n_blocks)]


def _generate_idx(n: int, seed: int, n_train: int, n_test: int):
    """Permute ``arange(n)``: the first ``n_train`` are train, the last
    ``n_test`` test."""
    idx = np.random.RandomState(seed).permutation(n)
    return idx[:n_train], idx[n - n_test:]


class ShuffleSplit(BaseCrossValidator):
    """Random-permutation CV that splits each block of rows locally.

    Parameters
    ----------
    n_splits : int, default 10
    test_size, train_size : float fractions (the blockwise restriction)
    blockwise : bool, default True — permute within blocks; False permutes
        the whole row range.
    n_blocks : int or None — number of blocks; None means the data-shard
        count of the collective mesh (1 on one device).
    random_state : int or None
    """

    def __init__(self, n_splits: int = 10, test_size=None, train_size=None,
                 blockwise: bool = True, n_blocks: Optional[int] = None,
                 random_state=None):
        self.n_splits = n_splits
        self.test_size = test_size
        self.train_size = train_size
        self.blockwise = blockwise
        self.n_blocks = n_blocks
        self.random_state = random_state

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits

    def split(self, X, y=None, groups=None):
        n = _num_samples(X)
        test_size, train_size = _check_blockwise_sizes(self.test_size,
                                                       self.train_size)
        rng = np.random.RandomState(self.random_state)
        for _ in range(self.n_splits):
            if self.blockwise:
                yield self._split_blockwise(n, test_size, train_size, rng)
            else:
                yield self._split_global(n, test_size, train_size, rng)

    def _split_blockwise(self, n, test_size, train_size, rng):
        from dask_ml_tpu_torch.parallel import mesh as mesh_lib

        n_blocks = self.n_blocks or mesh_lib.n_data_shards(
            mesh_lib.collective_mesh())
        sizes = _block_sizes(n, n_blocks)
        seeds = rng.randint(0, 2**31 - 1, size=len(sizes))
        trains, tests = [], []
        offset = 0
        for size, seed in zip(sizes, seeds):
            tr, te = _generate_idx(size, int(seed), int(size * train_size),
                                   int(size * test_size))
            trains.append(offset + np.sort(tr))
            tests.append(offset + np.sort(te))
            offset += size
        return np.concatenate(trains), np.concatenate(tests)

    def _split_global(self, n, test_size, train_size, rng):
        tr, te = _generate_idx(n, int(rng.randint(0, 2**31 - 1)),
                               int(n * train_size), int(n * test_size))
        return np.sort(tr), np.sort(te)


class KFold(BaseCrossValidator):
    """K contiguous folds over the sample axis; with ``shuffle=True`` the
    row order is permuted first."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False,
                 random_state=None):
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits

    def split(self, X, y=None, groups=None):
        n = _num_samples(X)
        if self.n_splits < 2:
            raise ValueError("n_splits must be >= 2")
        if self.n_splits > n:
            raise ValueError(
                f"n_splits={self.n_splits} greater than n_samples={n}")
        order = (np.random.RandomState(self.random_state).permutation(n)
                 if self.shuffle else np.arange(n))
        offset = 0
        for size in _block_sizes(n, self.n_splits):
            test = order[offset:offset + size]
            train = np.concatenate([order[:offset], order[offset + size:]])
            yield np.sort(train), np.sort(test)
            offset += size


def type_of_target(y) -> str:
    """The part of scikit-learn's ``type_of_target`` the splitters need:
    "binary" or "multiclass" for 1-D discrete labels (at most two values,
    or integer-valued / non-float labels), "continuous" for non-integral
    floats, "unknown" otherwise."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim != 1 or y.size == 0:
        return "unknown"
    if y.dtype.kind == "f" and np.any(y != y.astype(int)):
        return "continuous"
    if y.dtype.kind not in "biufUSO":
        return "unknown"
    return "multiclass" if len(np.unique(y)) > 2 else "binary"


class StratifiedKFold(BaseCrossValidator):
    """scikit-learn's stratified K folds, index for index: each class is
    dealt to the folds round robin over the sorted labels and assigned in
    blocks in order of first appearance (shuffled per class with
    ``shuffle=True``)."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False,
                 random_state=None):
        if not isinstance(n_splits, numbers.Integral):
            raise ValueError(
                f"The number of folds must be of Integral type. {n_splits} "
                f"of type {type(n_splits)} was passed.")
        if int(n_splits) <= 1:
            raise ValueError(
                "k-fold cross-validation requires at least one train/test "
                f"split by setting n_splits=2 or more, got "
                f"n_splits={n_splits}.")
        if not isinstance(shuffle, bool):
            raise TypeError(f"shuffle must be True or False; got {shuffle}")
        if not shuffle and random_state is not None:
            raise ValueError(
                "Setting a random_state has no effect since shuffle is "
                "False. You should leave random_state to its default "
                "(None), or set shuffle=True.")
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits

    def split(self, X, y, groups=None):
        n = _num_samples(X)
        if self.n_splits > n:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} "
                f"greater than the number of samples: n_samples={n}.")
        return super().split(X, y, groups)

    def _make_test_folds(self, X, y):
        rng = check_random_state(self.random_state)
        y = np.asarray(y)
        kind = type_of_target(y)
        if kind not in ("binary", "multiclass"):
            raise ValueError(
                f"Supported target types are: ('binary', 'multiclass'). "
                f"Got {kind!r} instead.")
        y = y.ravel()
        _, y_idx, y_inv = np.unique(y, return_index=True,
                                    return_inverse=True)
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(
                f"n_splits={self.n_splits} cannot be greater than the "
                "number of members in each class.")
        if self.n_splits > np.min(y_counts):
            warnings.warn(
                f"The least populated class in y has only "
                f"{np.min(y_counts)} members, which is less than "
                f"n_splits={self.n_splits}.", UserWarning)
        y_order = np.sort(y_encoded)
        allocation = np.asarray([
            np.bincount(y_order[i::self.n_splits], minlength=n_classes)
            for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(
                allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def _iter_test_masks(self, X=None, y=None, groups=None):
        test_folds = self._make_test_folds(X, y)
        for i in range(self.n_splits):
            yield test_folds == i


class _CVIterableWrapper(BaseCrossValidator):
    """Explicit ``(train_idx, test_idx)`` pairs as a splitter."""

    def __init__(self, cv):
        self.cv = list(cv)

    def get_n_splits(self, X=None, y=None, groups=None):
        return len(self.cv)

    def split(self, X=None, y=None, groups=None):
        for train, test in self.cv:
            yield np.asarray(train), np.asarray(test)


def check_cv(cv=None, y=None, classifier: bool = False):
    """Resolve ``cv`` into a splitter: None → 5; an int → :class:`KFold`,
    or :class:`StratifiedKFold` when ``classifier`` and ``y`` is binary or
    multiclass; a splitter passes through; an iterable of ``(train,
    test)`` pairs is wrapped."""
    if cv is None:
        cv = 5
    if isinstance(cv, numbers.Integral):
        if classifier and y is not None and type_of_target(y) in (
                "binary", "multiclass"):
            return StratifiedKFold(n_splits=int(cv))
        return KFold(n_splits=int(cv))
    if hasattr(cv, "split") and hasattr(cv, "get_n_splits"):
        return cv
    if hasattr(cv, "__iter__") and not isinstance(cv, str):
        return _CVIterableWrapper(cv)
    raise ValueError(f"Cannot interpret cv={cv!r}")


def compute_n_splits(cv, X=None, y=None, groups=None) -> int:
    """Number of splits of a splitter."""
    return cv.get_n_splits(X, y, groups)


def train_test_split(*arrays, test_size=None, train_size=None,
                     random_state=None, shuffle: bool = True,
                     blockwise: bool = True, **options):
    """Split arrays into random train and test subsets with
    :class:`ShuffleSplit`'s indices (one block). All arrays share axis-0
    length; the result is ``[a_train, a_test, b_train, b_test, ...]``."""
    if not arrays:
        raise ValueError("At least one array required as input")
    if options:
        raise TypeError(f"Unexpected options {sorted(options)}")
    if not shuffle:
        raise NotImplementedError(
            "shuffle=False is not implemented (the reference has the same "
            "restriction)")
    n = _num_samples(arrays[0])
    for a in arrays:
        if _num_samples(a) != n:
            raise ValueError(
                f"Input arrays have inconsistent lengths: "
                f"{_num_samples(a)} != {n}")
    splitter = ShuffleSplit(n_splits=1, test_size=test_size,
                            train_size=train_size, blockwise=blockwise,
                            random_state=random_state)
    train_idx, test_idx = next(splitter.split(arrays[0]))
    out = []
    for a in arrays:
        if hasattr(a, "iloc"):
            out += [a.iloc[train_idx], a.iloc[test_idx]]
        elif hasattr(a, "tocsr"):
            a = a.tocsr()
            out += [a[train_idx], a[test_idx]]
        else:  # arrays and tensors index in place
            a = a if hasattr(a, "shape") else np.asarray(a)
            out += [a[train_idx], a[test_idx]]
    return out
