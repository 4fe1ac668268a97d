"""Preprocessing of the PyTorch port (counterpart of
``dask_ml_tpu/preprocessing``): :class:`StandardScaler`. The other scalers
and the encoders are not ported yet (ROADMAP Queue A item 8)."""

from dask_ml_tpu_torch.preprocessing.data import StandardScaler

__all__ = ["StandardScaler"]
