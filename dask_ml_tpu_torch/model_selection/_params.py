"""Parameter grids and samplers of the PyTorch port: scikit-learn's
``ParameterGrid`` and ``ParameterSampler``, candidate for candidate.

The card's machine has no scikit-learn, so the search driver carries its
own. :class:`ParameterSampler` draws from a numpy ``RandomState`` in the
order scikit-learn draws, so a ``random_state`` gives scikit-learn's
candidates: for all-list grids :func:`sample_without_replacement` picks
the method scikit-learn's ``auto`` picks for the ratio of ``n_iter`` to
the grid size (a permutation, tracking selection or reservoir sampling,
each consuming the generator its own way); with any ``rvs`` distribution
each candidate draws a grid, then each key in sorted order.
"""

from __future__ import annotations

import numbers
import operator
import warnings
from collections.abc import Iterable, Mapping, Sequence
from functools import reduce
from itertools import product

import numpy as np


def check_random_state(seed):
    """scikit-learn's rule: None → numpy's global ``RandomState``, an int
    → a new ``RandomState(seed)``, a ``RandomState`` passes through."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(
        f"{seed!r} cannot be used to seed a numpy.random.RandomState "
        "instance")


def sample_without_replacement(n_population: int, n_samples: int,
                               random_state=None):
    """``n_samples`` distinct integers of ``[0, n_population)``, drawn as
    scikit-learn's ``sample_without_replacement(method="auto")`` draws
    them: a permutation's head when 0.01 < ratio < 0.99, else tracking
    selection (ratio < 0.2) or reservoir sampling."""
    if n_population < 0:
        raise ValueError(
            f"n_population should be greater than 0, got {n_population}.")
    if n_samples > n_population:
        raise ValueError(
            f"n_population should be greater or equal than n_samples, got "
            f"n_samples > n_population ({n_samples} > {n_population})")
    rng = check_random_state(random_state)
    ratio = n_samples / n_population if n_population != 0 else 1.0
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    out = np.empty(n_samples, dtype=int)
    if ratio < 0.2:  # tracking selection
        selected = set()
        for i in range(n_samples):
            j = rng.randint(n_population)
            while j in selected:
                j = rng.randint(n_population)
            selected.add(j)
            out[i] = j
        return out
    # reservoir sampling
    out[:] = np.arange(n_samples)
    for i in range(n_samples, n_population):
        j = rng.randint(0, i + 1)
        if j < n_samples:
            out[j] = i
    return out


class ParameterGrid:
    """The points of a grid (a dict of value lists, or a list of such
    dicts), in scikit-learn's order: keys sorted, the last key cycling
    fastest; indexable without listing the grid."""

    def __init__(self, param_grid):
        if not isinstance(param_grid, (Mapping, Iterable)):
            raise TypeError(
                f"Parameter grid should be a dict or a list, got: "
                f"{param_grid!r} of type {type(param_grid).__name__}")
        if isinstance(param_grid, Mapping):
            param_grid = [param_grid]
        for grid in param_grid:
            if not isinstance(grid, dict):
                raise TypeError(f"Parameter grid is not a dict ({grid!r})")
            for key, value in grid.items():
                if isinstance(value, np.ndarray) and value.ndim > 1:
                    raise ValueError(
                        f"Parameter array for {key!r} should be "
                        f"one-dimensional, got: {value!r} with shape "
                        f"{value.shape}")
                if isinstance(value, str) or not isinstance(
                        value, (np.ndarray, Sequence)):
                    raise TypeError(
                        f"Parameter grid for parameter {key!r} needs to be "
                        f"a list or a numpy array, but got {value!r} (of "
                        f"type {type(value).__name__}) instead. Single "
                        "values need to be wrapped in a list with one "
                        "element.")
                if len(value) == 0:
                    raise ValueError(
                        f"Parameter grid for parameter {key!r} need to be "
                        f"a non-empty sequence, got: {value!r}")
        self.param_grid = param_grid

    def __iter__(self):
        for p in self.param_grid:
            items = sorted(p.items())
            if not items:
                yield {}
            else:
                keys, values = zip(*items)
                for v in product(*values):
                    yield dict(zip(keys, v))

    def __len__(self) -> int:
        prod = lambda xs: reduce(operator.mul, xs, 1)  # noqa: E731
        return sum(prod(len(v) for v in p.values()) if p else 1
                   for p in self.param_grid)

    def __getitem__(self, ind):
        for sub_grid in self.param_grid:
            if not sub_grid:
                if ind == 0:
                    return {}
                ind -= 1
                continue
            keys, values_lists = zip(*sorted(sub_grid.items())[::-1])
            sizes = [len(v) for v in values_lists]
            total = int(np.prod(sizes))
            if ind >= total:
                ind -= total
            else:
                out = {}
                for key, v_list, n in zip(keys, values_lists, sizes):
                    ind, offset = divmod(ind, n)
                    out[key] = v_list[offset]
                return out
        raise IndexError("ParameterGrid index out of range")


class ParameterSampler:
    """``n_iter`` candidates drawn from distributions (objects with
    ``rvs``) or lists: without replacement when every value is a list,
    else with replacement, exactly as scikit-learn's sampler draws them
    from the same ``random_state``."""

    def __init__(self, param_distributions, n_iter, *, random_state=None):
        if not isinstance(param_distributions, (Mapping, Iterable)):
            raise TypeError(
                f"Parameter distribution is not a dict or a list, got: "
                f"{param_distributions!r} of type "
                f"{type(param_distributions).__name__}")
        if isinstance(param_distributions, Mapping):
            param_distributions = [param_distributions]
        for dist in param_distributions:
            if not isinstance(dist, dict):
                raise TypeError(
                    f"Parameter distribution is not a dict ({dist!r})")
            for key in dist:
                if not isinstance(dist[key], Iterable) and not hasattr(
                        dist[key], "rvs"):
                    raise TypeError(
                        f"Parameter grid for parameter {key!r} is not "
                        f"iterable or a distribution (value={dist[key]})")
        self.n_iter = n_iter
        self.random_state = random_state
        self.param_distributions = param_distributions

    def _is_all_lists(self) -> bool:
        return all(all(not hasattr(v, "rvs") for v in dist.values())
                   for dist in self.param_distributions)

    def __iter__(self):
        rng = check_random_state(self.random_state)
        if self._is_all_lists():
            grid = ParameterGrid(self.param_distributions)
            grid_size = len(grid)
            n_iter = self.n_iter
            if grid_size < n_iter:
                warnings.warn(
                    f"The total space of parameters {grid_size} is smaller "
                    f"than n_iter={self.n_iter}. Running {grid_size} "
                    "iterations. For exhaustive searches, use "
                    "GridSearchCV.", UserWarning)
                n_iter = grid_size
            for i in sample_without_replacement(grid_size, n_iter,
                                                random_state=rng):
                yield grid[i]
        else:
            for _ in range(self.n_iter):
                dist = rng.choice(self.param_distributions)
                params = {}
                for k, v in sorted(dist.items()):
                    if hasattr(v, "rvs"):
                        params[k] = v.rvs(random_state=rng)
                    else:
                        params[k] = v[rng.randint(len(v))]
                yield params

    def __len__(self) -> int:
        if self._is_all_lists():
            return min(self.n_iter,
                       len(ParameterGrid(self.param_distributions)))
        return self.n_iter
