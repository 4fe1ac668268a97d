"""Preprocessing of the PyTorch port (counterpart of
``dask_ml_tpu/preprocessing``): the device scalers (``StandardScaler``,
dense and sparse, ``MinMaxScaler``, ``RobustScaler``,
``QuantileTransformer``), the host encoders (``OneHotEncoder``, which
emits the sparse container, and the DataFrame encoders ``Categorizer``,
``DummyEncoder`` and ``OrdinalEncoder``, which import pandas on use) and
``LabelEncoder``."""

from dask_ml_tpu_torch.preprocessing.data import (  # noqa: F401
    Categorizer,
    DummyEncoder,
    MinMaxScaler,
    OneHotEncoder,
    OrdinalEncoder,
    QuantileTransformer,
    RobustScaler,
    StandardScaler,
)
from dask_ml_tpu_torch.preprocessing.label import LabelEncoder  # noqa: F401

__all__ = [
    "StandardScaler",
    "MinMaxScaler",
    "RobustScaler",
    "QuantileTransformer",
    "Categorizer",
    "DummyEncoder",
    "OneHotEncoder",
    "OrdinalEncoder",
    "LabelEncoder",
]
