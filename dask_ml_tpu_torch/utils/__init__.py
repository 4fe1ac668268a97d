"""Validation, random-number and small helpers of the PyTorch port
(counterpart of ``dask_ml_tpu/utils``)."""

from dask_ml_tpu_torch.utils._log import (  # noqa: F401
    format_bytes,
    log_array,
    profile_phase,
)
from dask_ml_tpu_torch.utils._utils import (  # noqa: F401
    check_chunks,
    copy_learned_attributes,
    handle_zeros_in_scale,
    slice_columns,
)
from dask_ml_tpu_torch.utils.testing import assert_estimator_equal  # noqa: F401
from dask_ml_tpu_torch.utils.validation import (  # noqa: F401
    check_array,
    check_random_state,
    check_random_state_np,
    row_norms,
    svd_flip,
)
