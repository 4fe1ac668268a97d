"""Hyper-parameter search and CV splitting of the PyTorch port
(counterpart of ``dask_ml_tpu/model_selection``): the grid and random
searches, and the incremental ones over ``partial_fit`` estimators
(``SuccessiveHalvingSearchCV``, ``HyperbandSearchCV``)."""

from dask_ml_tpu_torch.model_selection._incremental import (
    HyperbandSearchCV,
    SuccessiveHalvingSearchCV,
)
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

__all__ = [
    "BaseCrossValidator",
    "BaseSearchCV",
    "GridSearchCV",
    "HyperbandSearchCV",
    "KFold",
    "ParameterGrid",
    "ParameterSampler",
    "RandomizedSearchCV",
    "ShuffleSplit",
    "StratifiedKFold",
    "SuccessiveHalvingSearchCV",
    "TPUBaseSearchCV",
    "check_cv",
    "compute_n_splits",
    "train_test_split",
]
