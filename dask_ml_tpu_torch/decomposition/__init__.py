"""Matrix decompositions of the PyTorch port on tall-skinny data."""

from dask_ml_tpu_torch.decomposition.pca import PCA
from dask_ml_tpu_torch.decomposition.truncated_svd import TruncatedSVD

__all__ = ["PCA", "TruncatedSVD"]
