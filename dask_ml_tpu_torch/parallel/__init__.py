"""Staging, streaming, fault tolerance, telemetry and the in-process
serving tier of the PyTorch port."""

from dask_ml_tpu_torch.parallel.faults import (  # noqa: F401
    BlockFetchError,
    FaultInjector,
    GracefulDrain,
    Preempted,
    RetryPolicy,
    ScanCheckpoint,
)
from dask_ml_tpu_torch.parallel.shapes import (  # noqa: F401
    PadPolicy,
    compile_stats,
    pad_tail,
    reset_compile_stats,
    track_compiles,
)
from dask_ml_tpu_torch.parallel.telemetry import (  # noqa: F401
    MetricsRegistry,
    export_chrome_trace,
    render_report,
    reset_telemetry,
    span,
    telemetry_report,
)
from dask_ml_tpu_torch.parallel.stream import (  # noqa: F401
    HostBlockSource,
    prefetched_scan,
)
from dask_ml_tpu_torch.parallel.serving import (  # noqa: F401
    DeadlineExceeded,
    ModelRegistry,
    ServingClosed,
    ServingLoop,
    ServingQueueFull,
    ServingStopped,
)
from dask_ml_tpu_torch.parallel.fleet import (  # noqa: F401
    FleetTimeoutError,
    ServingFleet,
)
