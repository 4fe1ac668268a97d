"""Test helpers of the PyTorch port (counterpart of
``dask_ml_tpu/utils/testing.py``): :func:`assert_estimator_equal`, the
differential check that two fitted estimators agree on every learned
attribute."""

from __future__ import annotations

import numpy as np
import torch


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _assert_eq(a, b, name: str, rtol: float, atol: float):
    a, b = _to_host(a), _to_host(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(
            np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64),
            rtol=rtol, atol=atol, err_msg=f"attribute {name!r} differs")
    elif isinstance(a, (float, np.floating)) or isinstance(
            b, (float, np.floating)):
        np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=atol,
                                   err_msg=f"attribute {name!r} differs")
    elif isinstance(a, dict):
        assert set(a) == set(b), f"attribute {name!r}: dict keys differ"
        for k in a:
            _assert_eq(a[k], b[k], f"{name}[{k!r}]", rtol, atol)
    else:
        assert a == b, f"attribute {name!r}: {a!r} != {b!r}"


def assert_estimator_equal(left, right, exclude=(), rtol: float = 1e-4,
                           atol: float = 1e-4):
    """Assert that two fitted estimators have the same learned attributes
    (public names ending in ``_``) and that each pair agrees: arrays and
    floats within ``rtol``/``atol``, dicts key by key, anything else by
    equality. Tensors are compared on the host."""
    exclude = set([exclude] if isinstance(exclude, str) else exclude)

    def learned(est):
        return {a for a in dir(est)
                if a.endswith("_") and not a.startswith("_")} - exclude

    left_attrs, right_attrs = learned(left), learned(right)
    assert left_attrs == right_attrs, (
        f"Estimators have different fitted attributes: "
        f"only-left={sorted(left_attrs - right_attrs)} "
        f"only-right={sorted(right_attrs - left_attrs)}")
    for attr in sorted(left_attrs):
        _assert_eq(getattr(left, attr), getattr(right, attr), attr, rtol,
                   atol)
