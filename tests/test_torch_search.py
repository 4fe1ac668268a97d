"""The PyTorch port's model selection held against the JAX package and
scikit-learn, on the CPU.

The port runs under ``config_context(device="cpu")``. Tolerances and their
reasons:

- splits, folds, tokens, ``cv_results_`` assembly and sampled candidates
  are host integer and numpy work: equal index for index, key for key;
  the JAX ``ShuffleSplit`` defaults to the mesh's data shards and the
  port's to one block, so ``n_blocks`` is passed to both;
- ``StratifiedKFold`` and ``ParameterSampler`` are the port's copies of
  scikit-learn's: the same folds and candidates from the same seed;
- ``batched_lloyd_cells`` from the same init rows (the JAX draw handed in
  as ``idx0``): the same ``n_iter`` and inertia within rtol 1e-5 on blobs
  with no near ties (the two sum in other orders);
- the GLM path and scores: the same ``n_iter``, coefficients and scores
  within rtol 1e-4 (L-BFGS over the same objective in two frameworks);
- a whole ``GridSearchCV`` over deterministic stages (StandardScaler,
  PCA ``svd_solver="full"``, L-BFGS LogisticRegression): the same
  candidates and ranks, scores within rtol 1e-4. KMeans's random init
  draws from ``torch.Generator`` (the JAX package from ``jax.random``), so
  search-level KMeans is held as the port's batched path against its own
  per-cell path, which must agree bit for bit.
"""

import functools
import pickle

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.cluster import KMeans as JKMeans  # noqa: F401
from dask_ml_tpu.decomposition import PCA as JPCA
from dask_ml_tpu.linear_model import LogisticRegression as JLogReg
from dask_ml_tpu.model_selection import GridSearchCV as JGridSearchCV
from dask_ml_tpu.model_selection import _split as jsplit
from dask_ml_tpu.model_selection import methods as jmethods
from dask_ml_tpu.model_selection._tokenize import tokenize as jtokenize
from dask_ml_tpu.models import glm as jglm
from dask_ml_tpu.models import kmeans as jkm
from dask_ml_tpu.parallel.sharding import prepare_data as jprepare
from dask_ml_tpu.preprocessing import StandardScaler as JScaler
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.checkpoint import CellJournal
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.decomposition import PCA
from dask_ml_tpu_torch.linear_model import LinearRegression, LogisticRegression
from dask_ml_tpu_torch.model_selection import (GridSearchCV, KFold,
                                               ParameterGrid,
                                               ParameterSampler,
                                               RandomizedSearchCV,
                                               ShuffleSplit, StratifiedKFold,
                                               _search, check_cv,
                                               compute_n_splits, methods,
                                               train_test_split)
from dask_ml_tpu_torch.model_selection._params import \
    sample_without_replacement
from dask_ml_tpu_torch.model_selection._tokenize import tokenize
from dask_ml_tpu_torch.models import glm as tglm
from dask_ml_tpu_torch.models import kmeans as tkm
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.sharding import prepare_data, staging_memo
from dask_ml_tpu_torch.pipeline import FeatureUnion, Pipeline, make_pipeline
from dask_ml_tpu_torch.preprocessing import StandardScaler


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _X(n=400, d=12, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) @ np.diag(np.linspace(2, 0.5, d))).astype(
        np.float32)


def _blobs(n=600, d=6, k=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-8, 8, (k, d))
    return (centers[rng.randint(0, k, n)]
            + 0.5 * rng.randn(n, d)).astype(np.float32)


def _km_pipe(max_iter=10):
    return Pipeline([
        ("scale", StandardScaler()),
        ("pca", PCA(n_components=5, random_state=0)),
        ("km", KMeans(init="random", n_clusters=2, max_iter=max_iter,
                      random_state=0)),
    ])


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blockwise", [True, False])
@pytest.mark.parametrize("n,n_blocks", [(101, 1), (100, 3), (257, 8)])
def test_shuffle_split_index_for_index(n, n_blocks, blockwise):
    X = np.zeros((n, 2))
    kw = dict(n_splits=3, test_size=0.25, blockwise=blockwise,
              n_blocks=n_blocks, random_state=7)
    got = list(ShuffleSplit(**kw).split(X))
    want = list(jsplit.ShuffleSplit(**kw).split(X))
    assert len(got) == len(want) == 3
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    # the port's default is one block
    one = list(ShuffleSplit(n_splits=1, random_state=7).split(X))
    ref = list(jsplit.ShuffleSplit(n_splits=1, n_blocks=1,
                                   random_state=7).split(X))
    np.testing.assert_array_equal(one[0][0], ref[0][0])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n,k", [(10, 2), (103, 5)])
def test_kfold_index_for_index(n, k, shuffle):
    X = np.zeros((n, 1))
    kw = dict(n_splits=k, shuffle=shuffle,
              random_state=3 if shuffle else None)
    for (a, b), (c, d) in zip(KFold(**kw).split(X),
                              jsplit.KFold(**kw).split(X)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert compute_n_splits(KFold(k)) == jsplit.compute_n_splits(
        jsplit.KFold(k)) == k


def test_split_errors_match():
    X = np.zeros((5, 1))
    for bad in (dict(test_size=2), dict(test_size=1.5),
                dict(test_size=0.6, train_size=0.6)):
        with pytest.raises(ValueError):
            list(ShuffleSplit(n_blocks=1, **bad).split(X))
        with pytest.raises(ValueError):
            list(jsplit.ShuffleSplit(n_blocks=1, **bad).split(X))
    with pytest.raises(ValueError):
        list(KFold(6).split(X))
    with pytest.raises(NotImplementedError):
        train_test_split(X, shuffle=False)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("labels", [
    np.array([0, 1] * 30 + [1] * 7),
    np.array(list("abcab") * 9 + ["c"] * 4),
    np.array([3, 1, 2, 1, 3, 3, 2, 1, 1, 3] * 5),
])
def test_stratified_kfold_is_sklearns(labels, shuffle):
    from sklearn.model_selection import StratifiedKFold as SkSKF

    X = np.zeros((len(labels), 2))
    kw = dict(n_splits=3, shuffle=shuffle,
              random_state=11 if shuffle else None)
    got = list(StratifiedKFold(**kw).split(X, labels))
    want = list(SkSKF(**kw).split(X, labels))
    assert len(got) == len(want) == 3
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_check_cv_dispatch_and_stratified_errors():
    from sklearn.model_selection import StratifiedKFold as SkSKF

    y = np.array([0, 1, 1, 0, 1, 0, 0, 1, 1, 1])
    X = np.zeros((10, 1))
    cv = check_cv(2, y, classifier=True)
    assert isinstance(cv, StratifiedKFold)
    for (a, b), (c, d) in zip(cv.split(X, y), SkSKF(2).split(X, y)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert isinstance(check_cv(3, y, classifier=False), KFold)
    assert isinstance(check_cv(3, y.astype(float) + 0.5, classifier=True),
                      KFold)
    assert isinstance(check_cv(None), KFold) and check_cv(None).n_splits == 5
    pairs = [(np.arange(5), np.arange(5, 10))]
    wrapped = check_cv(pairs)
    assert wrapped.get_n_splits() == 1
    np.testing.assert_array_equal(next(wrapped.split(X))[1], pairs[0][1])
    with pytest.raises(ValueError, match="cannot be greater"):
        list(StratifiedKFold(3).split(np.zeros((6, 1)), [0, 0, 1, 1, 2, 2]))
    with pytest.raises(ValueError, match="Supported target types"):
        list(StratifiedKFold(2).split(X, np.linspace(0, 1, 10)))
    with pytest.raises(ValueError, match="random_state"):
        StratifiedKFold(2, random_state=0)


def test_train_test_split_matches_jax():
    X = np.arange(200, dtype=np.float32).reshape(100, 2)
    y = np.arange(100)
    got = train_test_split(X, y, test_size=0.2, random_state=4)
    want = jsplit.train_test_split(X, y, test_size=0.2, random_state=4,
                                   blockwise=False)
    for a, b in zip(got, want):
        # one block blockwise is the global permutation of a seeded block
        assert a.shape == np.asarray(b).shape
    ref = list(jsplit.ShuffleSplit(n_splits=1, test_size=0.2, n_blocks=1,
                                   random_state=4).split(X))[0]
    np.testing.assert_array_equal(got[0], X[ref[0]])
    np.testing.assert_array_equal(got[3], y[ref[1]])
    Xt = torch.as_tensor(X)
    tt = train_test_split(Xt, test_size=0.2, random_state=4)
    assert torch.equal(tt[0], Xt[ref[0]])


# ---------------------------------------------------------------------------
# tokens, candidates, results
# ---------------------------------------------------------------------------


def _scorer(est, X, y):
    return 1.0


@pytest.mark.parametrize("value", [
    3, 2.5, "x", None, True, [1, "a", (2, 3.0)], {"b": [1, 2], "a": None},
    np.arange(6, dtype=np.float32).reshape(2, 3), np.array(["p", "q"]),
    lambda e, X, y: 0.0, _scorer, functools.partial(_scorer, y=1),
    {"C": 0.1, "solver": "lbfgs"}, (np.float64(1.5), np.int32(4)),
])
def test_tokenize_equals_jax(value):
    assert tokenize("k", value, 7) == jtokenize("k", value, 7)


def test_tokenize_tensors_hash_as_their_host_bytes():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert tokenize(torch.as_tensor(a)) == tokenize(a) == jtokenize(a)
    assert tokenize(a) != tokenize(a + 1)


def test_parameter_grid_is_sklearns():
    from sklearn.model_selection import ParameterGrid as SkGrid

    grids = [{"a": [1, 2], "b": ["x", "y", "z"]},
             [{"k": ["lin"]}, {"k": ["rbf"], "g": [1, 10]}, {}]]
    for g in grids:
        ours, theirs = ParameterGrid(g), SkGrid(g)
        assert list(ours) == list(theirs) and len(ours) == len(theirs)
        assert [ours[i] for i in range(len(ours))] == list(theirs)
    for bad in ({"a": 1}, {"a": []}, {"a": "abc"},
                {"a": np.zeros((2, 2))}):
        with pytest.raises((TypeError, ValueError)):
            ParameterGrid(bad)


@pytest.mark.parametrize("n_iter", [1, 3, 30, 300, 595, 600])
def test_parameter_sampler_lists_is_sklearns(n_iter):
    """All-list grids sample without replacement: each n_iter here lands in
    another of scikit-learn's methods (tracking selection, permutation,
    reservoir sampling)."""
    from sklearn.model_selection import ParameterSampler as SkSampler

    grid = {"a": list(range(20)), "b": list(range(30))}
    for seed in (0, 5):
        assert (list(ParameterSampler(grid, n_iter, random_state=seed))
                == list(SkSampler(grid, n_iter, random_state=seed)))


def test_parameter_sampler_distributions_is_sklearns():
    from sklearn.model_selection import ParameterSampler as SkSampler

    dists = [{"C": st.loguniform(1e-3, 1e2), "solver": ["lbfgs", "newton"],
              "k": st.randint(2, 9)},
             [{"a": st.uniform(0, 1)}, {"b": st.expon(), "c": [1, 2]}]]
    for d in dists:
        got = list(ParameterSampler(d, 25, random_state=3))
        want = list(SkSampler(d, 25, random_state=3))
        assert got == want
    with pytest.warns(UserWarning, match="smaller than n_iter"):
        assert len(list(ParameterSampler({"a": [1, 2]}, 5))) == 2
    assert len(ParameterSampler({"a": st.uniform()}, 7)) == 7


def test_sample_without_replacement_is_sklearns():
    from sklearn.utils.random import sample_without_replacement as sk

    for n_pop, n in [(1000, 3), (1000, 150), (1000, 500), (1000, 995),
                     (50, 50), (10, 0)]:
        np.testing.assert_array_equal(
            sample_without_replacement(n_pop, n, random_state=9),
            sk(n_pop, n, random_state=9))


def test_create_cv_results_equals_jax():
    rng = np.random.RandomState(2)
    params = [{"a": 1}, {"a": 2, "b": "x"}, {"b": "y"}]
    scores = [({"score": float(rng.rand()), "acc": float(rng.rand())},
               {"score": float(rng.rand()), "acc": float(rng.rand())},
               float(rng.rand()), float(rng.rand()))
              for _ in range(3 * 2)]
    for multimetric in (False, True):
        sc = scores if multimetric else [
            ({"score": t["score"]}, {"score": r["score"]}, f, s)
            for t, r, f, s in scores]
        w = rng.randint(1, 5, (3, 2)).astype(float)
        got = methods.create_cv_results(sc, params, 2, "raise", w,
                                        multimetric, True)
        want = jmethods.create_cv_results(sc, params, 2, "raise", w,
                                          multimetric, True)
        assert sorted(got) == sorted(want)
        for k in got:
            if k == "params":
                assert got[k] == want[k]
            elif isinstance(got[k], np.ma.MaskedArray):
                np.testing.assert_array_equal(got[k].mask, want[k].mask)
                assert list(got[k].filled(None)) == list(
                    want[k].filled(None))
            else:
                np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the batched programs against the JAX package's
# ---------------------------------------------------------------------------


def test_batched_lloyd_cells_equals_jax_from_the_same_init():
    X = _blobs(n=500, d=6, k=4, seed=3)
    Xtr, Xte = X[:300], X[300:]
    members = [(k, t) for k in (2, 3, 5) for t in (1e-6, 1e-3, 1e-1)]
    key = jax.random.PRNGKey(4)
    jn, jtrain, jevals = jkm.batched_lloyd_cells(
        jprepare(Xtr), members, [jprepare(Xte)], max_iter=8, key=key)
    idx0 = np.asarray(jax.random.permutation(key, 300))[:5]
    tn, ttrain, tevals = tkm.batched_lloyd_cells(
        prepare_data(Xtr), members, [prepare_data(Xte)], max_iter=8,
        idx0=idx0)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(ttrain.numpy(), np.asarray(jtrain),
                               rtol=1e-5)
    np.testing.assert_allclose(tevals[0].numpy(), np.asarray(jevals[0]),
                               rtol=1e-5)


def test_batched_lloyd_member_is_a_standalone_fit():
    """A member equals ``KMeans(init="random", random_state=s)`` fit alone:
    the same n_iter, the same score, bit for bit."""
    X = _blobs(n=400, d=5, k=3, seed=8)
    members = [(2, 1e-4), (3, 1e-2), (4, 1e-6)]
    out = KMeans(init="random", max_iter=9, random_state=5)\
        ._batched_fit_score(X[:200], None,
                            [{"n_clusters": k, "tol": t}
                             for k, t in members], [(X[200:], None)])
    for m, (k, t) in enumerate(members):
        one = KMeans(n_clusters=k, tol=t, init="random", max_iter=9,
                     random_state=5).fit(X[:200])
        assert int(out["n_iter"][m]) == one.n_iter_
        assert float(out["scores"][0][m]) == one.score(X[200:])


@pytest.mark.parametrize("solver", ["lbfgs", "newton"])
def test_batched_glm_path_and_scores_equal_jax(solver):
    rng = np.random.RandomState(5)
    X = rng.randn(160, 5).astype(np.float32)
    beta = rng.randn(5).astype(np.float32)
    y = (X @ beta + 0.5 * rng.randn(160) > 0).astype(np.float32)
    Xi = np.hstack([X, np.ones((160, 1), np.float32)])
    mask = np.ones(6, np.float32)
    mask[-1] = 0.0
    lam = [1.0 / c for c in (0.1, 1.0, 10.0)]
    kw = dict(solver=solver, family="logistic", regularizer="l2",
              max_iter=100, tol=1e-5)
    jb, jn = jglm.batched_glm_path(
        jnp.asarray(Xi), jnp.asarray(y), jnp.ones(160), jnp.zeros(6),
        jnp.asarray(mask), jnp.asarray(lam, jnp.float32), **kw)
    tb, tn = tglm.batched_glm_path(
        torch.as_tensor(Xi), torch.as_tensor(y), torch.ones(160),
        torch.zeros(6), torch.as_tensor(mask), lam, **kw)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4,
                               atol=1e-4)
    ye = y.copy()
    ye[:5] = -1.0  # labels the training fold never saw
    js = jglm.batched_eval_scores(jnp.asarray(Xi), jnp.asarray(ye),
                                  jnp.ones(160), jb, family="logistic")
    ts = tglm.batched_eval_scores(torch.as_tensor(Xi), torch.as_tensor(ye),
                                  torch.ones(160), tb, family="logistic")
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4)
    yr = (X @ beta).astype(np.float32)
    np.testing.assert_allclose(
        tglm.batched_eval_scores(torch.as_tensor(Xi), torch.as_tensor(yr),
                                 torch.ones(160), tb,
                                 family="normal").numpy(),
        np.asarray(jglm.batched_eval_scores(
            jnp.asarray(Xi), jnp.asarray(yr), jnp.ones(160), jb,
            family="normal")), rtol=1e-4)


def test_batched_eval_scores_on_a_container_is_the_dense_score():
    from dask_ml_tpu_torch.ops.sparse import ell_from_dense

    rng = np.random.RandomState(6)
    X = (rng.randn(80, 7) * (rng.rand(80, 7) < 0.4)).astype(np.float32)
    A = ell_from_dense(X)
    A = type(A)(torch.as_tensor(A.values), torch.as_tensor(A.cols), A.d)
    betas = torch.as_tensor(rng.randn(3, 7).astype(np.float32))
    y = torch.as_tensor((rng.rand(80) > 0.5).astype(np.float32))
    w = torch.ones(80)
    np.testing.assert_allclose(
        tglm.batched_eval_scores(A, y, w, betas, family="logistic").numpy(),
        tglm.batched_eval_scores(torch.as_tensor(X), y, w, betas,
                                 family="logistic").numpy(), rtol=1e-6)


def test_grid_search_pipeline_equals_jax_search():
    """StandardScaler → PCA(full) → L-BFGS LogisticRegression over the same
    grid and folds in both packages: the same candidates and ranks, the
    scores within rtol 1e-4."""
    from sklearn.pipeline import Pipeline as SkPipeline

    rng = np.random.RandomState(12)
    X = rng.randn(240, 8).astype(np.float32)
    y = (X[:, :3].sum(1) + 0.7 * rng.randn(240) > 0).astype(int)
    grid = {"pca__n_components": [3, 6], "lr__C": [0.05, 1.0, 20.0]}
    ours = GridSearchCV(Pipeline([
        ("scale", StandardScaler()), ("pca", PCA(svd_solver="full")),
        ("lr", LogisticRegression(solver="lbfgs", max_iter=50))]),
        grid, cv=3, n_jobs=2).fit(X, y)
    theirs = JGridSearchCV(SkPipeline([
        ("scale", JScaler()), ("pca", JPCA(svd_solver="full")),
        ("lr", JLogReg(solver="lbfgs", max_iter=50))]),
        grid, cv=3, n_jobs=1).fit(X, y)
    assert ours.cv_results_["params"] == theirs.cv_results_["params"]
    assert ours.n_batched_cells_ == theirs.n_batched_cells_ == 18
    np.testing.assert_array_equal(ours.cv_results_["rank_test_score"],
                                  theirs.cv_results_["rank_test_score"])
    for key in ("mean_test_score", "mean_train_score", "split0_test_score"):
        np.testing.assert_allclose(ours.cv_results_[key],
                                   theirs.cv_results_[key], rtol=1e-4)
    assert ours.best_params_ == theirs.best_params_
    np.testing.assert_allclose(ours.best_estimator_.predict_proba(X),
                               theirs.best_estimator_.predict_proba(X),
                               rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the port's batched path against its per-cell path
# ---------------------------------------------------------------------------


def _per_cell_scorer(est, X, y=None):
    return est.score(X) if y is None else est.score(X, y)


def test_batched_pipeline_matches_per_cell_path():
    """The batched groups reproduce the per-cell path's test scores bit for
    bit (the same init rows, stopping rule and scoring); a non-passthrough
    scorer forces the per-cell path. Train scores within rtol 1e-5: the
    group scores the prefix's ``fit_transform`` output (PCA's U·S), a
    per-cell score transforms the train rows again."""
    X = _X()
    grid = {"km__n_clusters": [2, 3, 4], "km__tol": [1e-6, 1e-3, 1e-1]}
    gs = GridSearchCV(_km_pipe(), grid, cv=2, refit=False, n_jobs=1).fit(X)
    assert gs.n_batched_cells_ == 18
    oracle = GridSearchCV(_km_pipe(), grid, cv=2, refit=False, n_jobs=3,
                          scoring=_per_cell_scorer).fit(X)
    assert oracle.n_batched_cells_ == 0
    for key in ("split0_test_score", "split1_test_score",
                "rank_test_score"):
        np.testing.assert_array_equal(gs.cv_results_[key],
                                      oracle.cv_results_[key])
    np.testing.assert_allclose(gs.cv_results_["mean_train_score"],
                               oracle.cv_results_["mean_train_score"],
                               rtol=1e-5)


def test_batched_plain_estimator_and_fallbacks():
    X = _X()
    grid = {"n_clusters": [2, 3], "tol": [1e-4, 1e-2]}
    gs = GridSearchCV(KMeans(init="random", max_iter=8, random_state=0),
                      grid, cv=2, refit=False, n_jobs=1).fit(X)
    assert gs.n_batched_cells_ == 8
    # a non-batchable init: per cell
    g2 = GridSearchCV(KMeans(max_iter=8, random_state=0),
                      {"n_clusters": [2, 3]}, cv=2, refit=False,
                      n_jobs=1).fit(X)
    assert g2.n_batched_cells_ == 0
    # a non-batchable param in the grid makes static groups
    g3 = GridSearchCV(KMeans(max_iter=8, random_state=0),
                      {"n_clusters": [2, 3], "init": ["random"]},
                      cv=2, refit=False, n_jobs=1).fit(X)
    assert g3.n_batched_cells_ == 4
    # fit_params disable batching
    g4 = GridSearchCV(KMeans(init="random", max_iter=8, random_state=0),
                      {"n_clusters": [2, 3]}, cv=2, refit=False, n_jobs=1)
    g4.fit(X, sample_weight=np.ones(len(X)))
    assert g4.n_batched_cells_ == 0


def test_batched_declines_at_runtime_and_for_k_beyond_n():
    X = _X(n=60, d=30)
    declined = GridSearchCV(
        KMeans(init="random", max_iter=5000, random_state=0, tol=1e-2),
        {"n_clusters": [2, 3], "tol": [1e-2, 1e-1]},
        cv=2, refit=False, n_jobs=1).fit(X)
    assert declined.n_batched_cells_ == 0
    assert np.isfinite(declined.cv_results_["mean_test_score"]).all()
    # k > the smallest train split: that member alone runs per cell and
    # fails under error_score
    with pytest.warns(methods.FitFailedWarning):
        gs = GridSearchCV(KMeans(init="random", max_iter=5, random_state=0),
                          {"n_clusters": [2, 3, 45]}, cv=2, refit=False,
                          error_score=-1.0, n_jobs=1).fit(X)
    assert gs.n_batched_cells_ == 4
    np.testing.assert_array_equal(gs.cv_results_["split0_test_score"][2],
                                  -1.0)


def test_batched_glm_c_grid_matches_per_cell():
    rng = np.random.RandomState(0)
    X = rng.randn(240, 6).astype(np.float32)
    beta = rng.randn(6).astype(np.float32)
    y_clf = np.array(["neg", "pos"])[(X @ beta > 0).astype(int)]
    y_reg = (X @ beta + 0.1 * rng.randn(240)).astype(np.float32)
    grid = {"C": [0.01, 0.1, 1.0, 10.0]}
    for est, yv in ((LogisticRegression(solver="lbfgs", max_iter=80), y_clf),
                    (LinearRegression(solver="lbfgs", max_iter=80), y_reg)):
        gs = GridSearchCV(est, grid, cv=2, refit=False, n_jobs=1).fit(X, yv)
        assert gs.n_batched_cells_ == 8, type(est).__name__
        oracle = GridSearchCV(est, grid, cv=2, refit=False, n_jobs=1,
                              scoring=_per_cell_scorer).fit(X, yv)
        assert oracle.n_batched_cells_ == 0
        np.testing.assert_allclose(gs.cv_results_["mean_test_score"],
                                   oracle.cv_results_["mean_test_score"],
                                   rtol=1e-6)
        np.testing.assert_allclose(gs.cv_results_["mean_train_score"],
                                   oracle.cv_results_["mean_train_score"],
                                   rtol=1e-6)


def test_batched_glm_coefficients_are_the_single_fits():
    rng = np.random.RandomState(4)
    X = rng.randn(150, 5).astype(np.float32)
    y = (X[:, 0] - X[:, 1] > 0).astype(int)
    members = [{"C": c} for c in (0.1, 1.0, 10.0)]
    out = LogisticRegression(solver="lbfgs", max_iter=40)._batched_fit_score(
        X, y, members, [(X, y)])
    for m, p in enumerate(members):
        one = LogisticRegression(solver="lbfgs", max_iter=40, **p).fit(X, y)
        assert torch.equal(out["coef"][m], torch.as_tensor(one._coef))
        assert int(out["n_iter"][m]) == one.n_iter_


def test_batched_glm_declines_admm_multiclass_and_invalid_c():
    rng = np.random.RandomState(1)
    X = rng.randn(120, 4).astype(np.float32)
    gs = GridSearchCV(LogisticRegression(solver="admm", max_iter=20),
                      {"C": [1.0, 0.1]}, cv=2, refit=False,
                      n_jobs=1).fit(X, (X[:, 0] > 0).astype(int))
    assert gs.n_batched_cells_ == 0
    gs3 = GridSearchCV(LogisticRegression(solver="lbfgs", max_iter=40),
                       {"C": [1.0, 0.1]}, cv=2, refit=False,
                       n_jobs=1).fit(X, np.array([0, 1, 2] * 40))
    assert gs3.n_batched_cells_ == 0
    assert np.isfinite(gs3.cv_results_["mean_test_score"]).all()
    # C = 0 can't form a lamduh: that member runs per cell and fails alone
    with pytest.warns(methods.FitFailedWarning):
        gs0 = GridSearchCV(LogisticRegression(solver="lbfgs", max_iter=20),
                           {"C": [0.0, 1.0, 2.0]}, cv=2, refit=False,
                           error_score=np.nan,
                           n_jobs=1).fit(X, (X[:, 0] > 0).astype(int))
    assert gs0.n_batched_cells_ == 4
    assert np.isnan(gs0.cv_results_["mean_test_score"][0])
    est = LogisticRegression(solver="lbfgs")
    assert not est._supports_batched({"solver_kwargs": {"m": 3}})
    assert not est._supports_batched({"checkpoint": "x"})
    assert est._batchable_member_ok({"C": 2.0, "solver": "newton"}, None)
    assert not est._batchable_member_ok({"C": float("inf")}, None)
    assert not est._batchable_member_ok({"C": "abc"}, None)
    np.testing.assert_array_equal(
        LogisticRegression().fit(X, (X[:, 0] > 0).astype(int))
        ._encode_eval_y(np.array([1, 0, 7])), [1.0, 0.0, -1.0])


# ---------------------------------------------------------------------------
# the driver's semantics
# ---------------------------------------------------------------------------


class _Boom(LogisticRegression):
    def fit(self, X, y=None, sample_weight=None):
        if self.C == 13.0:
            raise RuntimeError("boom")
        return super().fit(X, y, sample_weight)


def test_error_score_semantics():
    rng = np.random.RandomState(2)
    X = rng.randn(80, 3).astype(np.float32)
    y = (X[:, 0] > 0).astype(int)
    # a named scorer keeps the cells off the batched path, so fit runs
    with pytest.raises(RuntimeError, match="boom"):
        GridSearchCV(_Boom(solver="newton", max_iter=10), {"C": [1.0, 13.0]},
                     cv=2, n_jobs=1, scoring="accuracy").fit(X, y)
    with pytest.warns(methods.FitFailedWarning):
        gs = GridSearchCV(_Boom(solver="newton", max_iter=10),
                          {"C": [1.0, 13.0]}, cv=2, error_score=-7.0,
                          scoring="accuracy", refit=False,
                          n_jobs=1).fit(X, y)
    np.testing.assert_array_equal(gs.cv_results_["split1_test_score"][1],
                                  -7.0)
    with pytest.raises(ValueError, match="error_score"):
        GridSearchCV(LogisticRegression(), {"C": [1.0]},
                     error_score="nope").fit(X, y)


def test_multimetric_and_refit():
    rng = np.random.RandomState(3)
    X = rng.randn(90, 3).astype(np.float32)
    y = (X[:, 0] + 0.2 * rng.randn(90) > 0).astype(int)
    gs = GridSearchCV(LogisticRegression(solver="lbfgs", max_iter=30),
                      {"C": [0.1, 10.0]}, cv=3, n_jobs=2,
                      scoring=["accuracy", "neg_log_loss"],
                      refit="accuracy").fit(X, y)
    assert gs.multimetric_ and gs.n_batched_cells_ == 0
    for key in ("mean_test_accuracy", "rank_test_neg_log_loss",
                "mean_train_neg_log_loss"):
        assert key in gs.cv_results_
    assert gs.best_params_ == gs.cv_results_["params"][
        int(np.argmin(gs.cv_results_["rank_test_accuracy"]))]
    assert gs.score(X, y) == pytest.approx(gs.best_estimator_.score(X, y))
    with pytest.raises(ValueError, match="refit"):
        GridSearchCV(LogisticRegression(), {"C": [1.0]},
                     scoring=["accuracy", "r2"], refit=True).fit(X, y)
    with pytest.raises(ValueError, match="Duplicate"):
        GridSearchCV(LogisticRegression(), {"C": [1.0]},
                     scoring=["accuracy", "accuracy"]).fit(X, y)
    no = GridSearchCV(LogisticRegression(), {"C": [1.0]}, cv=2,
                      refit=False).fit(X, y)
    with pytest.raises(AttributeError, match="refit=False"):
        no.predict(X)


def test_duplicate_candidates_and_prefixes_are_shared():
    X = _X(n=200, d=8)
    grid = [{"pca__n_components": [3], "km__n_clusters": [2, 3]},
            {"pca__n_components": [3], "km__n_clusters": [2, 3]}]
    gs = GridSearchCV(_km_pipe(), grid, cv=2, refit=False,
                      scoring=_per_cell_scorer, n_jobs=4).fit(X)
    r = gs.cv_results_
    np.testing.assert_array_equal(r["split0_test_score"][:2],
                                  r["split0_test_score"][2:])
    report = gs.shared_fit_report()
    # one scaler and one PCA fit a split serve all 4 candidates
    assert report.count("fit_transform:StandardScaler") == 2
    assert "distinct computations" in report
    # each distinct terminal fit ran once: 2 k values x 2 splits
    labels = [m["label"] for m in gs._shared_fit_graph.values()]
    assert labels.count("fit:KMeans") == 4


def test_cell_journal_resume(tmp_path):
    path = str(tmp_path / "cells.journal")
    X = _X(n=200, d=8)
    grid = {"pca__n_components": [3, 4], "km__n_clusters": [2, 3]}
    first = GridSearchCV(_km_pipe(), grid, cv=2, refit=False, n_jobs=2,
                         checkpoint=path).fit(X)
    assert first.n_resumed_cells_ == 0
    j = CellJournal(path)
    assert len(j.load()) == 8 and j.n_restored == 8
    again = GridSearchCV(_km_pipe(), grid, cv=2, refit=False, n_jobs=2,
                         checkpoint=path).fit(X)
    assert again.n_resumed_cells_ == 8
    np.testing.assert_array_equal(first.cv_results_["mean_test_score"],
                                  again.cv_results_["mean_test_score"])
    # a torn tail is dropped, the intact records are kept
    with open(path, "ab") as f:
        f.write(pickle.dumps(("x", (1, 2)))[:-3])
    assert len(CellJournal(path).load()) == 8
    # other data: nothing matches
    other = GridSearchCV(_km_pipe(), grid, cv=2, refit=False, n_jobs=1,
                         checkpoint=path).fit(X + 1)
    assert other.n_resumed_cells_ == 0
    jj = CellJournal(str(tmp_path / "sub" / "j"))
    jj.append("k", (1,))
    assert jj.n_appended == 1 and CellJournal(jj.path).load() == {"k": (1,)}


def test_cell_timeout_and_telemetry_counters():
    import time as _time

    class Slow(LogisticRegression):
        def fit(self, X, y=None, sample_weight=None):
            if self.C == 5.0:
                _time.sleep(2.0)
            return super().fit(X, y, sample_weight)

    rng = np.random.RandomState(5)
    X = rng.randn(60, 3).astype(np.float32)
    y = (X[:, 0] > 0).astype(int)
    telemetry.reset_counters()
    with config_context(telemetry=True), pytest.warns(
            methods.FitFailedWarning):
        gs = GridSearchCV(Slow(solver="newton", max_iter=5),
                          {"C": [1.0, 5.0]}, cv=[(np.arange(30),
                                                  np.arange(30, 60))],
                          scoring="accuracy", refit=False, error_score=0.0,
                          cell_timeout=0.5, n_jobs=1).fit(X, y)
    assert gs.n_cell_timeouts_ == 1
    assert telemetry.counters()["search.cell_timeouts"] == 1
    assert "search.cell_timeouts" in gs.shared_fit_report()
    assert gs.cv_results_["split0_test_score"][1] == 0.0


def test_randomized_search_draws_sklearns_candidates():
    from sklearn.model_selection import ParameterSampler as SkSampler

    X = _X(n=200, d=8)
    dists = {"km__n_clusters": [2, 3, 4, 5], "km__tol": st.loguniform(1e-5,
                                                                     1e-1)}
    rs = RandomizedSearchCV(_km_pipe(), dists, n_iter=5, random_state=3,
                            cv=2, refit=False, n_jobs=2).fit(X)
    assert rs.cv_results_["params"] == list(SkSampler(dists, 5,
                                                      random_state=3))
    assert rs.n_batched_cells_ == 10


def test_device_slices_are_uploaded_once_and_trusted():
    X = _X(n=100, d=4)
    splits = list(KFold(2).split(X))
    cache = _search.CVCache(splits, X, None, device_slices=True)
    assert cache.planned_buckets() == [50]
    with staging_memo() as memo:
        a = cache.extract(0, train=True)
        b = cache.extract(1, train=False)
        assert isinstance(a, torch.Tensor) and memo.is_trusted(a)
        assert cache.extract(0, train=True) is a
        np.testing.assert_array_equal(b.numpy(), X[splits[1][1]])
    bad = X.copy()
    bad[3, 1] = np.nan
    with staging_memo() as memo:
        c = _search.CVCache(splits, bad, None, device_slices=True)
        assert not memo.is_trusted(c.extract(0, train=True))
    assert not _search.CVCache(splits, X.tolist(), None,
                               device_slices=False).device_slices


def test_all_stages_device_native_and_max_jobs():
    from sklearn.preprocessing import StandardScaler as SkScaler

    assert _search._all_stages_device_native(_km_pipe())
    assert not _search._all_stages_device_native(
        Pipeline([("s", SkScaler()), ("km", KMeans())]))
    assert not _search._all_stages_device_native(JScaler())
    # the pool keeps the size asked for: no cap on the port's devices
    assert _search._normalize_n_jobs(8) == 8
    assert _search._normalize_n_jobs(None) == 1
    with pytest.raises(ValueError, match="n_jobs"):
        _search._normalize_n_jobs(0)


def test_sklearn_pipelines_are_expanded():
    from sklearn.pipeline import Pipeline as SkPipeline

    X = _X(n=200, d=8)
    grid = {"km__n_clusters": [2, 3], "km__tol": [1e-4, 1e-2]}
    sk = GridSearchCV(SkPipeline(_km_pipe().steps), grid, cv=2,
                      refit=False, n_jobs=1).fit(X)
    ours = GridSearchCV(_km_pipe(), grid, cv=2, refit=False,
                        n_jobs=1).fit(X)
    assert sk.n_batched_cells_ == ours.n_batched_cells_ == 8
    np.testing.assert_array_equal(sk.cv_results_["mean_test_score"],
                                  ours.cv_results_["mean_test_score"])


def test_visualize_needs_graphviz(monkeypatch):
    import sys

    X = _X(n=100, d=4)
    gs = GridSearchCV(KMeans(init="random", max_iter=3, random_state=0),
                      {"n_clusters": [2, 3]}, cv=2, refit=False).fit(X)
    monkeypatch.setitem(sys.modules, "graphviz", None)
    with pytest.raises(ImportError, match="graphviz"):
        gs.visualize()
    with pytest.raises(AttributeError):
        GridSearchCV(KMeans(), {}).shared_fit_report()


def test_package_surface_and_incremental_searchers_raise():
    import dask_ml_tpu_torch.model_selection as ms
    from dask_ml_tpu_torch.model_selection import _incremental

    # ported since the incremental slice: the names resolve to the classes
    for name in ("HyperbandSearchCV", "SuccessiveHalvingSearchCV"):
        assert getattr(ms, name) is getattr(_incremental, name)
        assert name in ms.__all__
    with pytest.raises(AttributeError):
        ms.NoSuchThing  # noqa: B018
    assert ms.TPUBaseSearchCV is ms.BaseSearchCV
    sig = ["estimator", "param_grid", "scoring", "iid", "refit", "cv",
           "error_score", "return_train_score", "scheduler", "n_jobs",
           "cache_cv", "checkpoint", "cell_retries", "cell_timeout"]
    assert sorted(GridSearchCV._get_param_names()) == sorted(sig)
    assert sorted(RandomizedSearchCV._get_param_names()) == sorted(
        [s for s in sig if s != "param_grid"]
        + ["param_distributions", "n_iter", "random_state"])


# ---------------------------------------------------------------------------
# StandardScaler and the pipelines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True),
                                                (True, False)])
def test_standard_scaler_equals_jax(with_mean, with_std):
    rng = np.random.RandomState(7)
    X = (rng.randn(90, 5) * [1, 10, 0.1, 3, 0] + [0, 5, -2, 1, 4]).astype(
        np.float32)
    ours = StandardScaler(with_mean=with_mean, with_std=with_std).fit(X)
    theirs = JScaler(with_mean=with_mean, with_std=with_std).fit(X)
    for attr in ("mean_", "var_", "scale_"):
        a, b = getattr(ours, attr), getattr(theirs, attr)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
    assert ours.n_samples_seen_ == theirs.n_samples_seen_ == 90
    Xt = ours.transform(X)
    np.testing.assert_allclose(Xt, np.asarray(theirs.transform(X)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.inverse_transform(Xt), X, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours.fit_transform(X), Xt)


def test_standard_scaler_refusals_and_device_outputs():
    import scipy.sparse as sp

    X = np.random.RandomState(0).randn(20, 3).astype(np.float32)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        StandardScaler().fit(sp.csr_matrix(X))
    with pytest.raises(NotImplementedError):
        StandardScaler().partial_fit(X)
    with pytest.raises(AttributeError):
        StandardScaler().transform(X)
    with config_context(device_outputs=True):
        s = StandardScaler().fit(X)
        out = s.transform(X)
    assert isinstance(s.mean_, torch.Tensor) and isinstance(out,
                                                            torch.Tensor)
    np.testing.assert_allclose(out.numpy(), StandardScaler().fit_transform(X),
                               rtol=1e-6)


def test_pipeline_params_match_sklearn():
    from sklearn.pipeline import Pipeline as SkPipeline

    steps = [("scale", StandardScaler()), ("pca", PCA(n_components=2)),
             ("km", KMeans(n_clusters=3))]
    ours, theirs = Pipeline(steps), SkPipeline(steps)
    assert set(ours.get_params(deep=True)) == set(
        theirs.get_params(deep=True)) - {"transform_input"}
    ours.set_params(km__n_clusters=5, pca=PCA(n_components=3))
    assert ours.named_steps.km.n_clusters == 5
    assert ours.named_steps["pca"].n_components == 3
    assert ours[:2].steps[1][0] == "pca" and ours["km"] is ours[-1]
    with pytest.raises(ValueError):
        Pipeline([("a", StandardScaler()), ("a", PCA())]).fit(_X(n=20))
    with pytest.raises(ValueError):
        Pipeline([("a__b", StandardScaler()), ("c", PCA())]).fit(_X(n=20))
    with pytest.raises(TypeError):
        Pipeline([("a", KMeans.__call__), ("c", PCA())]).fit(_X(n=20))
    names = [n for n, _ in make_pipeline(StandardScaler(), StandardScaler(),
                                         PCA()).steps]
    from sklearn.pipeline import make_pipeline as sk_make

    assert names == [n for n, _ in sk_make(StandardScaler(),
                                           StandardScaler(), PCA()).steps]


def test_pipeline_passthrough_union_and_fit_params():
    X = _X(n=120, d=6)
    pipe = Pipeline([("scale", "passthrough"), ("pca", PCA(n_components=3)),
                     ("last", None)])
    out = pipe.fit_transform(X)
    np.testing.assert_allclose(out, PCA(n_components=3).fit_transform(X),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pipe.transform(X), out, rtol=1e-4,
                               atol=1e-4)
    union = FeatureUnion([("a", PCA(n_components=2)), ("b", "passthrough"),
                          ("c", "drop")],
                         transformer_weights={"a": 2.0})
    U = union.fit_transform(X)
    assert U.shape == (120, 8)
    np.testing.assert_allclose(U[:, 2:], X)
    np.testing.assert_allclose(U[:, :2], 2.0 * PCA(
        n_components=2).fit_transform(X), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(union.transform(X), U, rtol=1e-4,
                               atol=1e-4)
    assert union.get_params()["a__n_components"] == 2
    with config_context(device_outputs=True):
        Ut = union.fit_transform(X)
    assert isinstance(Ut, torch.Tensor) and Ut.shape == (120, 8)
    km = Pipeline([("s", StandardScaler()), ("km", KMeans(
        n_clusters=2, init="random", random_state=0))])
    w = np.ones(120)
    km.fit(X, km__sample_weight=w)
    with pytest.raises(ValueError, match="<step>__<parameter>"):
        km.fit(X, sample_weight=w)


def test_union_grid_search_shares_members():
    X = _X(n=160, d=6)
    union = FeatureUnion([("p2", PCA(n_components=2)),
                          ("p3", PCA(n_components=3))])
    pipe = Pipeline([("u", union), ("km", KMeans(init="random",
                                                 random_state=0,
                                                 max_iter=5))])
    grid = {"u__transformer_weights": [None, {"p2": 2.0}],
            "km__n_clusters": [2, 3]}
    gs = GridSearchCV(pipe, grid, cv=2, refit=True, n_jobs=2).fit(X)
    labels = [m["label"] for m in gs._shared_fit_graph.values()]
    # each member fits once a split, whatever the weights
    assert labels.count("fit_transform:PCA") == 4
    assert np.isfinite(gs.cv_results_["mean_test_score"]).all()
    assert gs.best_estimator_.predict(X).shape == (160,)
