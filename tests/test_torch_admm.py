"""The PyTorch port's consensus ADMM and softmax GLMs held against the JAX
package, on the CPU.

The JAX ``admm`` runs one consensus block per device of an explicit
S-device mesh; the port's ``admm(n_shards=S)`` runs S contiguous row
blocks on one device, so the two take the same trajectory. Tolerances are
those of ``tests/test_torch_glm.py``: coefficients and the stacked
per-block state within rtol 1e-4 / atol 1e-5 and the same ``n_iter`` (the
two packages sum in other orders, and an iterative solver carries the
ulps forward); facade probabilities within rtol 1e-5 (softmax ones also
within 1e-8 absolute, see ``PROBA_TOL``). A resumed port run
equals the uninterrupted one bit for bit: the same operations run in the
same order.
"""

import numpy as np
import pytest
import scipy.sparse as scipy_sparse
import torch

import jax.numpy as jnp

from dask_ml_tpu import linear_model as jlm
from dask_ml_tpu.interop import export_learned_attrs
from dask_ml_tpu.models import glm as jcore
from dask_ml_tpu.ops import sparse as jsps
from dask_ml_tpu.parallel import mesh as mesh_lib
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import linear_model as tlm
from dask_ml_tpu_torch.convert import glm_from_numpy
from dask_ml_tpu_torch.models import glm as tcore
from dask_ml_tpu_torch.ops import sparse as tsps

COEF_TOL = dict(rtol=1e-4, atol=1e-5)
#: softmax probabilities: rtol 1e-5, and below 1e-8 absolute (where a
#: probability of 1e-5 meets logits that agree to 1e-5) no relative test
PROBA_TOL = dict(rtol=1e-5, atol=1e-8)


@pytest.fixture(autouse=True)
def on_cpu():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with config_context(device="cpu"):
        yield
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(prec)


def _problem(seed=0, n=1024, d=8, density=1.0):
    """A design with the intercept column, its penalty mask, unit
    weights and targets for the three families."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    if density < 1.0:
        X *= rng.uniform(size=(n, d)) < density
    beta = rng.standard_normal(d).astype(np.float32)
    eta = X @ beta
    ys = {"logistic": (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(
              np.float32),
          "normal": (eta + 0.3 * rng.standard_normal(n)).astype(np.float32),
          "poisson": rng.poisson(np.exp(0.3 * eta)).astype(np.float32)}
    Xi = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
    mask = np.ones(d + 1, np.float32)
    mask[-1] = 0.0
    return Xi, ys, mask, np.ones(n, np.float32)


def _jax_admm(Xi, y, w, mask, S, **kw):
    z, n, (_, x, u), done = jcore.admm(
        jnp.asarray(Xi), jnp.asarray(y), jnp.asarray(w),
        jnp.zeros(Xi.shape[1]), jnp.asarray(mask),
        mesh_lib.make_mesh(n_devices=S), return_state=True, **kw)
    return [np.asarray(a) for a in (z, x, u)], int(n), bool(done)


def _port_admm(X, y, w, mask, S, **kw):
    z, n, (_, x, u), done = tcore.admm(
        X, torch.as_tensor(y), torch.as_tensor(w),
        torch.zeros(int(X.shape[1])), torch.as_tensor(mask), n_shards=S,
        return_state=True, **kw)
    return [a.numpy() for a in (z, x, u)], n, done


# (S, family, penalty, extra solver kwargs): every S of the mesh, each
# family and penalty; rho = 0.1 makes the logistic runs converge within
# max_iter, rho = 1 (the default) leaves some at max_iter
ADMM_CASES = [
    (1, "logistic", "l2", {"rho": 0.1}),
    (2, "logistic", "l1", {"rho": 0.1}),
    (8, "logistic", "l2", {}),
    (1, "normal", "l1", {}),
    (2, "normal", "l2", {}),
    (8, "poisson", "l1", {}),
    (1, "poisson", "l2", {"rho": 0.1}),
]


@pytest.mark.parametrize("S,family,penalty,extra", ADMM_CASES,
                         ids=[f"S{c[0]}-{c[1]}-{c[2]}" for c in ADMM_CASES])
def test_admm_matches_jax(S, family, penalty, extra):
    Xi, ys, mask, w = _problem()
    kw = dict(family=family, regularizer=penalty, lamduh=1.0, max_iter=40,
              **extra)
    want, nj, dj = _jax_admm(Xi, ys[family], w, mask, S, **kw)
    got, nt, dt = _port_admm(torch.as_tensor(Xi), ys[family], w, mask, S,
                             **kw)
    assert (nt, dt) == (nj, dj)
    assert got[1].shape == got[2].shape == (S, Xi.shape[1])
    for g, j in zip(got, want):
        np.testing.assert_allclose(g, j, **COEF_TOL)


def test_admm_converges_and_stops_where_jax_does():
    """A case that stops by Boyd's rule well inside max_iter: both stop
    at the same iteration with done set."""
    Xi, ys, mask, w = _problem(1)
    kw = dict(family="normal", regularizer="l2", lamduh=1.0, max_iter=100)
    want, nj, dj = _jax_admm(Xi, ys["normal"], w, mask, 2, **kw)
    got, nt, dt = _port_admm(torch.as_tensor(Xi), ys["normal"], w, mask, 2,
                             **kw)
    assert dj and dt and nt == nj < 100
    np.testing.assert_allclose(got[0], want[0], **COEF_TOL)


def test_admm_resume_and_shard_count_refusal():
    Xi, ys, mask, w = _problem(2, n=512)
    X, y = torch.as_tensor(Xi), torch.as_tensor(ys["logistic"])
    args = (X, y, torch.as_tensor(w), torch.zeros(Xi.shape[1]),
            torch.as_tensor(mask))
    kw = dict(n_shards=4, lamduh=1.0, rho=0.1)
    z20, n20, s20, _ = tcore.admm(*args, max_iter=20, return_state=True,
                                  **kw)
    _, n10, s10, done10 = tcore.admm(*args, max_iter=10, return_state=True,
                                     **kw)
    assert n10 == 10 and not done10
    z, n, s, _ = tcore.admm(*args, max_iter=10, state=s10,
                            return_state=True, **kw)
    assert n10 + n == n20
    for a, b in zip(s, s20):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shard"):
        tcore.admm(*args, max_iter=1, state=s10, n_shards=2, lamduh=1.0)
    with pytest.raises(ValueError, match="multiple of n_shards"):
        tcore.admm(*args, n_shards=3)


@pytest.mark.parametrize("S", [1, 2])
def test_sparse_admm_matches_jax_dense(S):
    """The container through the port's ADMM (its matvec, pullback and
    weighted Gram) against the JAX ADMM on the densified rows (the JAX
    package's own sparse ADMM does not run inside its shard_map)."""
    Xi, ys, mask, w = _problem(3, n=768, d=12, density=0.3)
    kw = dict(family="logistic", regularizer="l2", lamduh=1.0, rho=0.1,
              max_iter=30)
    want, nj, dj = _jax_admm(Xi, ys["logistic"], w, mask, S, **kw)
    A = tsps.ell_from_csr(scipy_sparse.csr_matrix(Xi))
    got, nt, dt = _port_admm(A.to("cpu"), ys["logistic"], w, mask, S, **kw)
    assert (nt, dt) == (nj, dj)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g, j, **COEF_TOL)


def test_admm_hands_its_kernel_to_the_sparse_seams(monkeypatch):
    Xi, ys, mask, w = _problem(4, n=64, d=5, density=0.5)
    A = tsps.ell_from_csr(scipy_sparse.csr_matrix(Xi)).to("cpu")
    seen = []
    for name in ("matvec", "pullback"):
        plain = getattr(tsps, name)

        def spy(A, v, *, kernel="auto", _plain=plain, _name=name):
            seen.append((_name, kernel))
            return _plain(A, v, kernel=kernel)

        monkeypatch.setattr(tsps, name, spy)
    tcore.admm(A, torch.as_tensor(ys["logistic"]), torch.as_tensor(w),
               torch.zeros(6), torch.as_tensor(mask), max_iter=1,
               inner_max_iter=1, kernel="torch")
    assert {k for _, k in seen} == {"torch"}
    assert {n for n, _ in seen} == {"matvec", "pullback"}


def _multiclass(seed=5, n=960, d=6, K=3):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    B = rng.standard_normal((d, K)).astype(np.float32)
    logits = X @ B
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    y = np.array([rng.choice(K, p=pi) for pi in p])
    Xi = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
    mask = np.ones(d + 1, np.float32)
    mask[-1] = 0.0
    return X, Xi, y, mask


@pytest.mark.parametrize("K", [3, 4])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_multinomial_lbfgs_matches_jax(sparse, K):
    _, Xi, y, mask = _multiclass(6 + K, K=K)
    if sparse:
        Xi = Xi * (np.random.RandomState(K).uniform(size=Xi.shape) < 0.5)
        Xi[:, -1] = 1.0
        A = tsps.ell_from_csr(scipy_sparse.csr_matrix(Xi))
        Xj = jsps.SparseRows(jnp.asarray(A.values), jnp.asarray(A.cols), A.d)
        Xt = A.to("cpu")
    else:
        Xj, Xt = jnp.asarray(Xi), torch.as_tensor(Xi)
    n, d = Xi.shape
    yf, w = y.astype(np.float32), np.ones(n, np.float32)
    kw = dict(n_classes=K, regularizer="l2", lamduh=1.0, max_iter=40)
    Bj, nj = jcore.multinomial_lbfgs(Xj, jnp.asarray(yf), jnp.asarray(w),
                                     jnp.zeros((d, K)), jnp.asarray(mask),
                                     **kw)
    Bt, nt = tcore.multinomial_lbfgs(Xt, torch.as_tensor(yf),
                                     torch.as_tensor(w), torch.zeros((d, K)),
                                     torch.as_tensor(mask), **kw)
    assert Bt.shape == (d, K) and nt == int(nj)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), **COEF_TOL)


def test_multinomial_lbfgs_resume():
    _, Xi, y, mask = _multiclass(7)
    n, d = Xi.shape
    args = (torch.as_tensor(Xi), torch.as_tensor(y.astype(np.float32)),
            torch.ones(n), torch.zeros((d, 3)), torch.as_tensor(mask))
    B12, n12, _, _ = tcore.multinomial_lbfgs(
        *args, n_classes=3, lamduh=1.0, max_iter=12, tol=0.0,
        return_state=True)
    _, n6, s6, _ = tcore.multinomial_lbfgs(
        *args, n_classes=3, lamduh=1.0, max_iter=6, tol=0.0,
        return_state=True)
    B, n, _, _ = tcore.multinomial_lbfgs(
        *args, n_classes=3, lamduh=1.0, max_iter=6, tol=0.0, state=s6,
        return_state=True)
    assert n6 + n == n12 == 12
    assert torch.equal(B, B12)


@pytest.mark.parametrize("S", [1, 4])
def test_admm_multinomial_matches_jax(S):
    _, Xi, y, mask = _multiclass(8, n=640, d=5, K=3)
    n, d = Xi.shape
    yf, w = y.astype(np.float32), np.ones(n, np.float32)
    kw = dict(n_classes=3, regularizer="l2", lamduh=1.0, rho=0.1,
              max_iter=25)
    zj, nj, (_, xj, uj), dj = jcore.admm_multinomial(
        jnp.asarray(Xi), jnp.asarray(yf), jnp.asarray(w), jnp.zeros((d, 3)),
        jnp.asarray(mask), mesh_lib.make_mesh(n_devices=S),
        return_state=True, **kw)
    zt, nt, (_, xt, ut), dt = tcore.admm_multinomial(
        torch.as_tensor(Xi), torch.as_tensor(yf), torch.as_tensor(w),
        torch.zeros((d, 3)), torch.as_tensor(mask), n_shards=S,
        return_state=True, **kw)
    assert (nt, dt) == (int(nj), bool(dj))
    assert xt.shape == ut.shape == (S, d, 3)
    for g, j in ((zt, zj), (xt, xj), (ut, uj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **COEF_TOL)


def test_multinomial_hessian_matches_einsum_order():
    """The chunked Hessian equals the JAX package's einsum
    ``"ij,ick,il->jclk"`` flattened feature-major, also when the rows
    span several chunks."""
    rng = np.random.RandomState(9)
    S, nb, d, K = 2, 50, 4, 3
    X = torch.as_tensor(rng.standard_normal((S, nb, d)).astype(np.float32))
    P = torch.softmax(torch.as_tensor(
        rng.standard_normal((S, nb, K)).astype(np.float32)), dim=2)
    w = torch.as_tensor(rng.uniform(size=(S, nb)).astype(np.float32))
    old = tcore._MN_HESS_BUDGET
    try:
        tcore._MN_HESS_BUDGET = 7 * S * K * K * d  # 7-row chunks
        H = tcore._multinomial_hessian(X, P, w, torch.tensor(3.0))
    finally:
        tcore._MN_HESS_BUDGET = old
    for s in range(S):
        M = (P[s][:, :, None] * torch.eye(K) - P[s][:, :, None]
             * P[s][:, None, :]) * w[s][:, None, None]
        want = torch.einsum("ij,ick,il->jclk", X[s], M, X[s]) / 3.0
        np.testing.assert_allclose(H[s].numpy(),
                                   want.reshape(d * K, d * K).numpy(),
                                   rtol=1e-5, atol=1e-6)


def _check_fit(je, te):
    assert te.n_iter_ == je.n_iter_
    np.testing.assert_allclose(te.coef_, np.asarray(je.coef_), **COEF_TOL)
    np.testing.assert_allclose(te.intercept_, np.asarray(je.intercept_),
                               **COEF_TOL)


def test_default_logistic_regression_matches_jax():
    """``LogisticRegression()`` with every default (ADMM, rho 1, 100
    iterations) against the JAX facade on a one-device mesh."""
    Xi, ys, _, _ = _problem(10, n=600, d=6)
    X, y = Xi[:, :-1], np.where(ys["logistic"] > 0, "b", "a")
    with mesh_lib.use_mesh(mesh_lib.make_mesh(n_devices=1)):
        je = jlm.LogisticRegression().fit(X, y)
    te = tlm.LogisticRegression().fit(X, y)
    _check_fit(je, te)
    assert set(te.fit_phase_seconds_) == {"stage", "solve"}
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    np.testing.assert_allclose(te.predict_proba(X), je.predict_proba(X),
                               rtol=1e-5)


def test_admm_facades_match_jax():
    """Linear and Poisson regression and OVR logistic regression through
    solver='admm', against the JAX facades on a one-device mesh."""
    Xi, ys, _, _ = _problem(11, n=500, d=5)
    X = Xi[:, :-1]
    y3 = np.random.RandomState(11).randint(0, 3, 500)
    with mesh_lib.use_mesh(mesh_lib.make_mesh(n_devices=1)):
        for name, y in (("LinearRegression", ys["normal"]),
                        ("PoissonRegression", ys["poisson"]),
                        ("LogisticRegression", y3)):
            kw = dict(solver="admm", max_iter=30,
                      solver_kwargs={"rho": 0.1})
            je = getattr(jlm, name)(**kw).fit(X, y)
            te = getattr(tlm, name)(**kw).fit(X, y)
            _check_fit(je, te)


@pytest.mark.parametrize("solver", ["lbfgs", "admm", "newton"])
def test_multinomial_facade_matches_jax(solver):
    X, _, y, _ = _multiclass(12, n=720, d=5, K=3)
    labels = np.array(["x", "y", "z"])[y]
    kw = dict(solver=solver, multiclass="multinomial", max_iter=30)
    if solver == "admm":
        kw["solver_kwargs"] = {"rho": 0.1}
    with mesh_lib.use_mesh(mesh_lib.make_mesh(n_devices=1)):
        je = jlm.LogisticRegression(**kw).fit(X, labels)
    te = tlm.LogisticRegression(**kw).fit(X, labels)
    assert te.coef_.shape == (3, 5) and te.intercept_.shape == (3,)
    _check_fit(je, te)
    np.testing.assert_array_equal(te.classes_, ["x", "y", "z"])
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    np.testing.assert_allclose(te.predict_proba(X), je.predict_proba(X),
                               **PROBA_TOL)
    np.testing.assert_allclose(te.decision_function(X),
                               je.decision_function(X), **COEF_TOL)


def test_sparse_multinomial_facade():
    """L-BFGS takes sparse input (CSR) and matches the JAX facade; ADMM
    refuses it with the JAX package's words."""
    X, _, y, _ = _multiclass(13, n=480, d=6, K=3)
    X = X * (np.random.RandomState(13).uniform(size=X.shape) < 0.5)
    csr = scipy_sparse.csr_matrix(X.astype(np.float32))
    kw = dict(solver="lbfgs", multiclass="multinomial", max_iter=25)
    je = jlm.LogisticRegression(**kw).fit(csr, y)
    te = tlm.LogisticRegression(**kw).fit(csr, y)
    _check_fit(je, te)
    np.testing.assert_allclose(te.predict_proba(csr), je.predict_proba(csr),
                               **PROBA_TOL)
    for est in (jlm.LogisticRegression(multiclass="multinomial"),
                tlm.LogisticRegression(multiclass="multinomial")):
        with pytest.raises(ValueError, match="multinomial ADMM does not "
                                             "support sparse inputs"):
            est.fit(csr, y)


def test_glm_from_numpy_multinomial_predicts_like_jax():
    X, _, y, _ = _multiclass(14, n=300, d=4, K=4)
    je = jlm.LogisticRegression(solver="lbfgs", multiclass="multinomial",
                                max_iter=20).fit(X, y)
    te = glm_from_numpy(export_learned_attrs(je), "logistic",
                        multiclass="multinomial")
    assert te.coef_.shape == (4, 4) and te.n_iter_ == je.n_iter_
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    np.testing.assert_allclose(te.predict_proba(X), je.predict_proba(X),
                               **PROBA_TOL)
    assert te.score(X, y) == pytest.approx(je.score(X, y))
