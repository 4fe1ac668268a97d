"""Staging, streaming and fault tolerance of the PyTorch port (single
device)."""

from dask_ml_tpu_torch.parallel.faults import (  # noqa: F401
    BlockFetchError,
    FaultInjector,
    GracefulDrain,
    Preempted,
    RetryPolicy,
    ScanCheckpoint,
)
from dask_ml_tpu_torch.parallel.shapes import pad_tail  # noqa: F401
from dask_ml_tpu_torch.parallel.stream import (  # noqa: F401
    HostBlockSource,
    prefetched_scan,
)
