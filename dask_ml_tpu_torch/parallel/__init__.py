"""The multi-device substrate (the mesh over ``torch.distributed``
process groups, the hierarchical collectives and their traffic ledger,
the runtime), staging, streaming, fault tolerance, telemetry, the serving
tier, its wire and process fleet on one box or across machines
(chunk-addressed snapshots, the SLO autoscaler) and the elastic
multi-host data plane, of the PyTorch port."""

from dask_ml_tpu_torch.parallel.mesh import (  # noqa: F401
    CHIP_AXIS,
    DATA_AXIS,
    MODEL_AXIS,
    POD_AXIS,
    data_axes,
    data_pspec,
    data_sharding,
    default_mesh,
    feature_sharding,
    is_hierarchical,
    make_2d_mesh,
    make_mesh,
    n_data_shards,
    n_model_shards,
    replicated_sharding,
    use_mesh,
)
from dask_ml_tpu_torch.parallel.hierarchy import (  # noqa: F401
    TrafficLedger,
    hpmean,
    hpsum,
    hpsum_scatter,
    ledger,
    ledger_snapshot,
    make_hierarchical_mesh,
    reset_ledger,
)
from dask_ml_tpu_torch.parallel.sharding import (  # noqa: F401
    DeviceData,
    pad_rows,
    prepare_data,
    shard_2d,
    shard_rows,
    unpad_rows,
)

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
    active_policy,
    bucket_rows,
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
from dask_ml_tpu_torch.parallel.fleet import (  # noqa: F401
    FleetClient,
    FleetServer,
    RetryBudget,
)
from dask_ml_tpu_torch.parallel.elastic import (  # noqa: F401
    BlockPlan,
    ElasticRun,
    FileHeartbeat,
    SimulatedHostDeath,
)
from dask_ml_tpu_torch.parallel.launcher import (  # noqa: F401
    ExecLauncher,
    Launcher,
    LocalLauncher,
    MachineSpec,
    plan_placement,
)
from dask_ml_tpu_torch.parallel.shm import (  # noqa: F401
    ShmClient,
    ShmServer,
    list_segments,
)
from dask_ml_tpu_torch.parallel.replica import ReplicaHost  # noqa: F401
from dask_ml_tpu_torch.parallel.procfleet import ProcessFleet  # noqa: F401
from dask_ml_tpu_torch.parallel.snapshots import (  # noqa: F401
    ChunkCache,
    SnapshotCorruptError,
    SnapshotServer,
    SnapshotTransferError,
    fetch_snapshot,
    manifest_of,
)
from dask_ml_tpu_torch.parallel.autoscaler import (  # noqa: F401
    SLO,
    Autoscaler,
)
