"""Generalized linear models of the PyTorch port, and the deprecated
``Partial*`` estimators. Those subclass scikit-learn's and import it, so
they load on first access (module ``__getattr__``): the package imports
where scikit-learn is not installed, as on the card's machine."""

from dask_ml_tpu_torch.linear_model.glm import (
    LinearRegression,
    LogisticRegression,
    PoissonRegression,
)

#: Partial* name -> the module that defines it
_PARTIAL = {
    "PartialSGDClassifier": "stochastic_gradient",
    "PartialSGDRegressor": "stochastic_gradient",
    "PartialPerceptron": "perceptron",
    "PartialPassiveAggressiveClassifier": "passive_aggressive",
    "PartialPassiveAggressiveRegressor": "passive_aggressive",
}

__all__ = ["LinearRegression", "LogisticRegression", "PoissonRegression",
           *_PARTIAL]


def __getattr__(name):
    if name in _PARTIAL:
        import importlib

        module = importlib.import_module(f"{__name__}.{_PARTIAL[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
