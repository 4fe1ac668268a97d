"""The port's single-device remainder held against the JAX package, on the
CPU: ``interop`` (``to_numpy``, ``to_torch``, ``export_learned_attrs``)
and its ``joblib`` / ``xgboost`` / ``tensorflow`` shims,
``naive_bayes.logsumexp`` (rtol 1e-6 against the JAX one on seeded numpy
input), ``config.get_option``, ``utils.validation.staging_dtype``, the
``pad_policy`` and ``compilation_cache`` knobs with
``parallel.shapes.active_policy`` / ``bucket_rows`` (the JAX rounding,
integer for integer) / ``enable_persistent_cache``, the search's test
doubles (``model_selection.utils_test``) inside a port ``GridSearchCV``,
and ``_entry.entry()``.
"""

import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.config import get_config, get_option, set_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


def test_to_numpy_takes_tensors_staged_data_and_arrays():
    from dask_ml_tpu_torch.interop import to_numpy
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    X = np.random.RandomState(0).randn(37, 5).astype(np.float32)
    t = torch.as_tensor(X)
    out = to_numpy(t)
    assert isinstance(out, np.ndarray) and np.array_equal(out, X)
    assert np.array_equal(to_numpy(t, n_valid=10), X[:10])
    assert np.array_equal(to_numpy(X, n_valid=7), X[:7])
    assert np.array_equal(to_numpy(X.tolist()), X)
    data = prepare_data(X)
    staged = to_numpy(data)
    assert staged.shape == (37, 5) and np.array_equal(staged, X)
    # numpy has no bf16: a bf16 tensor comes out as its float32 values
    b = t.to(torch.bfloat16)
    got = to_numpy(b)
    assert got.dtype == np.float32
    assert np.array_equal(got, b.float().numpy())


def test_to_numpy_drops_rows_past_n_as_the_jax_package_does():
    """A staged dataset's rows past ``n`` are dropped by ``to_numpy``; the
    JAX staging pads rows for its mesh, the port's pads none, and both
    give back exactly the source rows."""
    from dask_ml_tpu.interop import to_numpy as jax_to_numpy
    from dask_ml_tpu.parallel.sharding import prepare_data as jax_prepare
    from dask_ml_tpu_torch.interop import to_numpy
    from dask_ml_tpu_torch.parallel.sharding import DeviceData, prepare_data

    X = np.random.RandomState(1).randn(45, 3).astype(np.float32)
    jax_out = jax_to_numpy(jax_prepare(X))
    assert np.array_equal(to_numpy(prepare_data(X)), jax_out)
    # a staged tensor longer than n: only the first n rows come back
    padded = DeviceData(X=torch.as_tensor(np.vstack([X, np.zeros((3, 3),
                                                                  np.float32)])),
                        weights=torch.ones(48), n=45, n_features=3)
    assert np.array_equal(to_numpy(padded), X)


def test_to_torch_lands_on_the_configured_device_as_a_copy():
    from dask_ml_tpu_torch.interop import to_torch

    X = np.arange(12, dtype=np.float32).reshape(4, 3)
    t = to_torch(X)
    assert t.device.type == "cpu" and t.dtype == torch.float32
    t[0, 0] = 99.0
    assert X[0, 0] == 0.0  # a copy
    assert torch.equal(to_torch(X, n_valid=2), torch.as_tensor(X[:2]))
    src = torch.as_tensor(X)
    u = to_torch(src, device="cpu")
    u[1, 1] = -1.0
    assert src[1, 1] == 4.0
    # the port's default device is the card: without one it raises
    # rather than carrying on on the CPU
    with config_context(device="cuda"):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                to_torch(X)


def test_export_learned_attrs_of_a_fitted_estimator():
    from dask_ml_tpu.cluster import KMeans as JKMeans
    from dask_ml_tpu.interop import export_learned_attrs as jax_export
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.interop import export_learned_attrs

    X = np.random.RandomState(2).randn(120, 4).astype(np.float32)
    init = X[:3].copy()
    est = KMeans(n_clusters=3, init=init, max_iter=20).fit(X)
    est._private_ = "hidden"  # private names never export
    got = export_learned_attrs(est)
    want = jax_export(JKMeans(n_clusters=3, init=init, max_iter=20).fit(X))
    assert "_private_" not in got
    for name in ("cluster_centers_", "labels_", "inertia_", "n_iter_"):
        assert name in got and name in want, name
        assert isinstance(got[name], np.ndarray), name
    assert got["labels_"].dtype == want["labels_"].dtype
    np.testing.assert_allclose(got["cluster_centers_"],
                               want["cluster_centers_"], rtol=1e-5,
                               atol=1e-6)
    assert np.array_equal(got["labels_"], want["labels_"])
    # a tensor attribute comes to the host
    est.extra_ = torch.ones(2, dtype=torch.bfloat16)
    assert export_learned_attrs(est)["extra_"].dtype == np.float32


@pytest.mark.parametrize("shim", ["joblib", "xgboost", "tensorflow"])
def test_shims_reexport_interop(shim):
    import importlib

    from dask_ml_tpu_torch import interop

    mod = importlib.import_module(f"dask_ml_tpu_torch.{shim}")
    assert mod.to_numpy is interop.to_numpy
    assert mod.export_learned_attrs is interop.export_learned_attrs
    jax_mod = importlib.import_module(f"dask_ml_tpu.{shim}")
    assert {n for n in ("to_numpy", "export_learned_attrs")
            if hasattr(jax_mod, n)} == {"to_numpy", "export_learned_attrs"}


def test_shims_import_no_foreign_runtime():
    """The shims import neither xgboost, tensorflow nor joblib's backend
    machinery: with those made unimportable they still import."""
    code = ("import sys\n"
            "for m in ('xgboost', 'tensorflow', 'joblib'):\n"
            "    sys.modules[m] = None\n"
            "import dask_ml_tpu_torch.joblib, dask_ml_tpu_torch.xgboost\n"
            "import dask_ml_tpu_torch.tensorflow\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


# ---------------------------------------------------------------------------
# logsumexp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, 1, -1, None])
@pytest.mark.parametrize("shape", [(5, 7), (64, 3)])
def test_logsumexp_equals_the_jax_one(axis, shape):
    from dask_ml_tpu.naive_bayes import logsumexp as jax_logsumexp
    from dask_ml_tpu_torch.naive_bayes import logsumexp

    a = np.random.default_rng([7, shape[0]]).standard_normal(shape) * 30.0
    got = logsumexp(a, axis=axis)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = np.asarray(jax_logsumexp(a, axis=axis))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_logsumexp_default_axis_and_scipy():
    from scipy.special import logsumexp as sp

    from dask_ml_tpu_torch.naive_bayes import logsumexp

    a = np.random.RandomState(0).randn(5, 7)
    np.testing.assert_allclose(logsumexp(a).numpy(), sp(a, axis=0),
                               rtol=1e-5)
    # a tensor is reduced where it lies, in its dtype
    t = torch.as_tensor(a)
    out = logsumexp(t, axis=1)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), sp(a, axis=1), rtol=1e-12)


# ---------------------------------------------------------------------------
# config knobs, staging_dtype, bucket_rows
# ---------------------------------------------------------------------------


def test_get_option_reads_the_effective_config():
    assert get_option("device") == "cpu"
    with config_context(device_outputs=True):
        assert get_option("device_outputs") is True
    assert get_option("device_outputs") is False
    for name in get_config():
        assert get_option(name) == get_config()[name]
    with pytest.raises(KeyError):
        get_option("no_such_option")


def test_config_keys_include_the_jax_packages():
    from dask_ml_tpu import config as jax_config

    # every JAX knob is a port knob
    assert set(jax_config._DEFAULTS) - set(get_config()) == set()
    for k in ("pad_policy", "compilation_cache", "precision", "telemetry",
              "device_outputs", "dtype", "mesh"):
        assert get_config()[k] == jax_config._DEFAULTS[k] or k == "dtype"


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64, np.uint8,
                                   np.uint32, np.bool_, np.float64,
                                   np.float32])
def test_staging_dtype_equals_the_jax_policy(dtype):
    import jax
    import jax.numpy as jnp

    from dask_ml_tpu.utils.validation import staging_dtype as jax_staging
    from dask_ml_tpu_torch.utils.validation import staging_dtype

    assert not jax.config.jax_enable_x64
    want = jax_staging(dtype)
    got = staging_dtype(dtype)
    if want is None:
        assert got is None
    else:
        assert want == jnp.float32 and got == torch.float32


def test_staging_dtype_port_deviations():
    from dask_ml_tpu_torch.utils.validation import check_array, staging_dtype

    # the port stages float32 only: float16 converts (the JAX policy keeps
    # it), and check_array applies exactly this
    assert staging_dtype(np.float16) == torch.float32
    assert check_array(np.ones((3, 2), np.float16)).dtype == np.float32
    with pytest.raises(ValueError):
        staging_dtype(np.complex64)


@pytest.mark.parametrize("policy", ["auto", None, "custom"])
def test_bucket_rows_equals_the_jax_package(policy):
    from dask_ml_tpu.parallel import shapes as jax_shapes
    from dask_ml_tpu_torch.parallel import shapes

    if policy == "custom":
        port_p = shapes.PadPolicy(waste_cap=0.25, min_rows=16)
        jax_p = jax_shapes.PadPolicy(waste_cap=0.25, min_rows=16)
    elif policy == "auto":
        port_p, jax_p = shapes.DEFAULT_POLICY, jax_shapes.DEFAULT_POLICY
    else:
        port_p = jax_p = None
    ns = list(range(0, 300)) + [511, 512, 513, 1000, 4095, 4096, 4097,
                                65_537, 1_000_000, 4_898_431]
    for align in (1, 2, 3, 8, 64):
        for n in ns:
            assert shapes.bucket_rows(n, align=align, policy=port_p) == \
                jax_shapes.bucket_rows(n, align=align, policy=jax_p,
                                       record=False), (n, align)


def test_pad_policy_knob_resolves_as_in_the_jax_package():
    from dask_ml_tpu.config import config_context as jax_context
    from dask_ml_tpu.parallel import shapes as jax_shapes
    from dask_ml_tpu_torch.parallel import shapes

    assert shapes.active_policy() is shapes.DEFAULT_POLICY
    with config_context(pad_policy=None):
        assert shapes.active_policy() is None
        assert shapes.bucket_rows(1000, align=8) == 1000
    custom = shapes.PadPolicy(waste_cap=0.5, min_rows=8)
    with config_context(pad_policy=custom):
        assert shapes.active_policy() is custom
        got = [shapes.bucket_rows(n, align=4) for n in range(1, 200)]
    with jax_context(pad_policy=jax_shapes.PadPolicy(waste_cap=0.5,
                                                     min_rows=8)):
        want = [jax_shapes.bucket_rows(n, align=4, record=False)
                for n in range(1, 200)]
    assert got == want
    with pytest.raises(ValueError, match="pad_policy"):
        with config_context(pad_policy="sometimes"):
            pass


def test_pad_policy_changes_no_fit():
    """The port's staging pads nothing, so a fit is the same bits under
    every policy (the deviation README.md records)."""
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    X = np.random.RandomState(3).randn(333, 4).astype(np.float32)
    fits = []
    for policy in ("auto", None):
        with config_context(pad_policy=policy):
            assert prepare_data(X).X.shape[0] == 333
            km = KMeans(n_clusters=3, init=X[:3].copy(), max_iter=10).fit(X)
            fits.append((km.cluster_centers_, km.labels_))
    assert np.array_equal(fits[0][0], fits[1][0])
    assert np.array_equal(fits[0][1], fits[1][1])


def test_compilation_cache_knob(tmp_path):
    from dask_ml_tpu_torch.parallel import shapes

    path = tmp_path / "cache" / "nested"
    assert get_option("compilation_cache") is None
    try:
        set_config(compilation_cache=str(path))
        assert os.path.isdir(path)
        assert get_option("compilation_cache") == str(path)
        # process-wide only: a scope may restate it, never change it
        with config_context(compilation_cache=str(path)):
            assert get_option("compilation_cache") == str(path)
        with pytest.raises(ValueError, match="process-wide"):
            with config_context(compilation_cache=str(tmp_path / "other")):
                pass
        # a worker re-entering its caller's whole configuration
        with config_context(**get_config()):
            assert get_option("device") == "cpu"
    finally:
        set_config(compilation_cache=None)
    assert get_option("compilation_cache") is None
    shapes.enable_persistent_cache(None)  # turning it off touches nothing


# ---------------------------------------------------------------------------
# the search's test doubles inside a port GridSearchCV
# ---------------------------------------------------------------------------


def _clf_data():
    X = np.random.RandomState(0).randn(60, 3)
    y = np.r_[np.zeros(30), np.ones(30)].astype(int)
    return X, y


def test_doubles_are_port_estimators():
    from dask_ml_tpu_torch.base import BaseEstimator, clone, is_classifier
    from dask_ml_tpu_torch.model_selection import utils_test as ut

    for cls in (ut.MockClassifier, ut.FailingClassifier,
                ut.CheckXClassifier, ut.CheckingClassifier):
        est = cls()
        assert isinstance(est, BaseEstimator) and is_classifier(est)
        assert type(clone(est)) is cls
        assert pickle.loads(pickle.dumps(est)).get_params() == \
            est.get_params()
    for cls in (ut.ScalingTransformer, ut.CountingTransformer,
                ut.FailingTransformer):
        assert not is_classifier(cls())
    m = ut.MockClassifier(foo_param=3)
    assert clone(m).get_params() == {"foo_param": 3}
    assert m.set_params(foo_param=1) is m and m.foo_param == 1


def test_doubles_in_a_grid_search_match_the_jax_package():
    from dask_ml_tpu.model_selection import GridSearchCV as JGridSearchCV
    from dask_ml_tpu.model_selection import utils_test as jut
    from dask_ml_tpu_torch.model_selection import GridSearchCV
    from dask_ml_tpu_torch.model_selection import utils_test as ut

    X, y = _clf_data()
    grid = {"foo_param": [0, 1, 2, 3]}
    gs = GridSearchCV(ut.MockClassifier(), grid, cv=3).fit(X, y)
    jgs = JGridSearchCV(jut.MockClassifier(), grid, cv=3).fit(X, y)
    assert gs.best_params_ == jgs.best_params_ == {"foo_param": 2}
    assert np.array_equal(gs.cv_results_["mean_test_score"],
                          jgs.cv_results_["mean_test_score"])
    assert np.array_equal(gs.cv_results_["rank_test_score"],
                          jgs.cv_results_["rank_test_score"])
    assert isinstance(gs.best_estimator_, ut.MockClassifier)


def test_failing_double_takes_the_error_score():
    from dask_ml_tpu_torch.model_selection import GridSearchCV
    from dask_ml_tpu_torch.model_selection.methods import FitFailedWarning
    from dask_ml_tpu_torch.model_selection.utils_test import FailingClassifier

    X, y = _clf_data()
    grid = {"parameter": [0, 1, FailingClassifier.FAILING_PARAMETER]}
    gs = GridSearchCV(FailingClassifier(), grid, cv=3, error_score=-999.0,
                      refit=False, return_train_score=True)
    with pytest.warns(FitFailedWarning):
        gs.fit(X, y)
    res = gs.cv_results_
    for i in range(3):
        assert res[f"split{i}_test_score"][2] == -999.0
        assert res[f"split{i}_train_score"][2] == -999.0
    assert (res["mean_test_score"][:2] != -999.0).all()
    with pytest.raises(ValueError, match="Failing classifier failed"):
        GridSearchCV(FailingClassifier(),
                     {"parameter": [FailingClassifier.FAILING_PARAMETER]},
                     cv=3, error_score="raise", refit=False).fit(X, y)


def test_counting_double_shares_the_pipeline_prefix():
    from dask_ml_tpu_torch.model_selection import GridSearchCV
    from dask_ml_tpu_torch.model_selection.utils_test import (
        CheckingClassifier,
        CountingTransformer,
        MockClassifier,
    )
    from dask_ml_tpu_torch.pipeline import Pipeline

    X, y = _clf_data()
    CountingTransformer.reset()
    pipe = Pipeline([("tf", CountingTransformer(factor=2.0)),
                     ("clf", MockClassifier())])
    GridSearchCV(pipe, {"clf__foo_param": [0, 1, 2, 3]}, cv=3,
                 refit=False, n_jobs=4).fit(X, y)
    # four candidates share one transformer: one fit a split, not twelve
    assert CountingTransformer.n_fits == 3
    CountingTransformer.reset()
    GridSearchCV(pipe, {"tf__factor": [1.0, 2.0],
                        "clf__foo_param": [0, 2]}, cv=3, refit=False,
                 n_jobs=4).fit(X, y)
    assert CountingTransformer.n_fits == 6
    # the data reaching the last stage is the scaled data, unaltered
    checking = Pipeline([("tf", CountingTransformer(factor=2.0)),
                         ("clf", CheckingClassifier(
                             check_X=lambda Z: np.all(np.abs(Z) <= 2 * np.abs(
                                 X).max())))])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        GridSearchCV(checking, {"clf__foo_param": [0, 2]}, cv=3).fit(X, y)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_entry_runs_the_assignment_step():
    import jax.numpy as jnp

    from dask_ml_tpu.models.kmeans import predict_labels as jax_predict
    from dask_ml_tpu_torch._entry import entry

    fn, args = entry()
    assert all(a.device.type == "cpu" for a in args)
    labels = fn(*args)
    assert labels.shape == (1024,) and labels.dtype == torch.int32
    want = np.asarray(jax_predict(jnp.asarray(args[0].numpy()),
                                  jnp.asarray(args[1].numpy())))
    assert np.array_equal(labels.numpy(), want)
