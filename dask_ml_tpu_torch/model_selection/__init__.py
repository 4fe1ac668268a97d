"""Hyper-parameter search and CV splitting of the PyTorch port
(counterpart of ``dask_ml_tpu/model_selection``). The incremental
searchers (``HyperbandSearchCV``, ``SuccessiveHalvingSearchCV``) are not
ported yet: they raise on access, naming the ROADMAP item that ports
them."""

from dask_ml_tpu_torch.model_selection._params import (
    ParameterGrid,
    ParameterSampler,
)
from dask_ml_tpu_torch.model_selection._search import (
    BaseSearchCV,
    GridSearchCV,
    RandomizedSearchCV,
    TPUBaseSearchCV,
)
from dask_ml_tpu_torch.model_selection._split import (
    BaseCrossValidator,
    KFold,
    ShuffleSplit,
    StratifiedKFold,
    check_cv,
    compute_n_splits,
    train_test_split,
)

_NOT_PORTED = ("HyperbandSearchCV", "SuccessiveHalvingSearchCV")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet: the incremental "
            "searchers of dask_ml_tpu/model_selection/_incremental.py come "
            "with ROADMAP Queue A item 7 (the next slice of the port)")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BaseCrossValidator",
    "BaseSearchCV",
    "GridSearchCV",
    "KFold",
    "ParameterGrid",
    "ParameterSampler",
    "RandomizedSearchCV",
    "ShuffleSplit",
    "StratifiedKFold",
    "TPUBaseSearchCV",
    "check_cv",
    "compute_n_splits",
    "train_test_split",
]
