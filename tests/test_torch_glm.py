"""The PyTorch port's GLMs held against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through
``dask_ml_tpu.models.glm`` / ``dask_ml_tpu.linear_model`` and through
their port counterparts under ``config_context(device="cpu")``, where the
sparse matvec runs its plain version. Tolerances and their reasons:

- solver outputs (each of gradient descent, Newton, L-BFGS and proximal
  gradient, for the logistic, normal and Poisson families, dense and
  sparse): ``coef`` within rtol 1e-4 / atol 1e-5 and the same ``n_iter``.
  The two packages compute the same objective and gradient in f32 but
  sum in other orders (XLA's reductions against PyTorch's), and an
  iterative solver carries those ulps forward;
- the facades on top: the same coefficient tolerance, identical labels,
  probabilities within rtol 1e-5, scores and deviances within rtol 1e-5;
- the sparse-against-dense pin inside the port is bit for bit: one
  Newton step from 0 at a power-of-two n on integer data keeps every
  quantity the step uses exactly representable.
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
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import linear_model as tlm
from dask_ml_tpu_torch.convert import glm_from_numpy
from dask_ml_tpu_torch.metrics import (accuracy_score, mean_absolute_error,
                                       mean_squared_error, r2_score)
from dask_ml_tpu_torch.models import glm as tcore
from dask_ml_tpu_torch.ops import sparse as tsps

COEF_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU, and full f32 products in the dense seam's torch.matmul
    (stated, as on the card, rather than assumed)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with config_context(device="cpu"):
        yield
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(prec)


def _problem(seed=0, n=200, d=12):
    """A sparse-ish float design with targets for the three families."""
    rng = np.random.RandomState(seed)
    dense = (rng.standard_normal((n, d))
             * (rng.uniform(size=(n, d)) < 0.4)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    eta = dense @ beta
    ys = {"logistic": (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(
              np.float32),
          "normal": (eta + 0.3 * rng.standard_normal(n)).astype(np.float32),
          "poisson": rng.poisson(np.exp(0.3 * eta)).astype(np.float32)}
    return dense, ys


SOLVER_KW = {
    "gradient_descent": {},
    "newton": {},
    "lbfgs": {"regularizer": "l2", "lamduh": 1.0},
    "proximal_grad": {"regularizer": "l1", "lamduh": 1.0},
}


def _f64_margin(X, y, w, beta, z, family, tt):
    """``f(z) − model`` in float64 (numpy) for the dense design ``X``:
    the smooth mean loss of the three families, the gradient at ``beta``
    and ISTA's quadratic model ``f(beta) + g·dz + |dz|²/(2·tt)``."""
    X, y, w = (np.asarray(a, np.float64) for a in (X, y, w))
    beta, z = np.asarray(beta, np.float64), np.asarray(z, np.float64)

    def loss_grad(b):
        eta = X @ b
        if family == "logistic":
            ell, dl = np.logaddexp(eta, 0) - y * eta, 1 / (1 + np.exp(-eta))
            dl = dl - y
        elif family == "normal":
            ell, dl = 0.5 * (eta - y) ** 2, eta - y
        else:
            ell, dl = np.exp(eta) - y * eta, np.exp(eta) - y
        sw = max(w.sum(), 1.0)
        return (w * ell).sum() / sw, X.T @ (w * dl) / sw

    f0, g = loss_grad(beta)
    dz = z - beta
    return loss_grad(z)[0] - (f0 + g @ dz + dz @ dz / (2.0 * tt))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
@pytest.mark.parametrize("solver", list(SOLVER_KW))
def test_solver_matches_jax(solver, family, sparse, monkeypatch):
    """The port against the JAX package from the same start: the same
    ``n_iter`` and coefficients within ``COEF_TOL``.

    ISTA (``proximal_grad``) halves its step ``t`` while ``f(z)`` exceeds
    the quadratic model, a test that can land within f32 rounding of its
    threshold; it stops after the first step with ``max|Δβ| ≤
    tol·max|β|`` (``β`` the iterate the step starts from). Where the two
    ``n_iter`` differ, the runs must part at one iteration and for that
    reason. The iterates of both runs (the JAX package's through its
    jitted loop cut at ``max_iter = i``) agree within ``COEF_TOL`` up to
    iteration ``p − 1`` and part at ``p``, the last iteration of the run
    that stops first (``F``); the other (``O``) stops one later. At ``p``
    the two steps differ by a factor of 2 (one run took ``t``, the other
    ``2t``: one test decided the other way), and the port's test at the
    larger ``t`` is decided by rounding: its float64 margin ``f(z) −
    model`` lies closer to the threshold than the port's f32 value of it
    lies to the float64 one. The coefficient bound then follows from this
    one-step offset and the stopping rule: from the same iterate, ``O``'s
    doubled step puts it one ``F``-step ahead, ``β_O(p) = β_F(p) +
    Δ_F(p)`` (checked within ``COEF_TOL``), with ``max|Δ_F(p)| ≤
    tol·max|β_F(p−1)|`` since ``F`` stopped there; ``O``'s last step
    obeys ``max|Δ_O(p+1)| ≤ tol·max|β_O(p)|``. Hence ``max|β_O(p+1) −
    β_F(p)| ≤ tol·(max|β_F(p−1)| + max|β_O(p)|)`` beyond the rounding
    that ``COEF_TOL`` allows: the coefficients are held to ``COEF_TOL``
    with that sum added to its ``atol``."""
    dense, ys = _problem()
    n, d = dense.shape
    Xi = np.concatenate([dense, np.ones((n, 1), np.float32)], axis=1)
    mask = np.ones(d + 1, np.float32)
    mask[-1] = 0.0
    w = np.ones(n, np.float32)
    y = ys[family]
    if sparse:
        A = tsps.ell_from_csr(scipy_sparse.csr_matrix(Xi))
        Xj = jsps.SparseRows(jnp.asarray(A.values), jnp.asarray(A.cols), A.d)
        Xt = A.to("cpu")
    else:
        Xj, Xt = jnp.asarray(Xi), torch.as_tensor(Xi)
    kw = dict(family=family, max_iter=25, tol=1e-4, **SOLVER_KW[solver])
    bj, nj = getattr(jcore, solver)(Xj, jnp.asarray(y), jnp.asarray(w),
                                    jnp.zeros(d + 1), jnp.asarray(mask), **kw)
    checks, check = [], tcore._model_check

    def traced_check(fsmooth, prox, beta, f0, g, tt):
        fz, quad = check(fsmooth, prox, beta, f0, g, tt)
        z = prox(beta - tt * g, tt)
        b = beta.numpy().copy()
        # a new iterate starts a new iteration (each iteration tests once
        # at least, from the iterate its step starts from)
        it = (0 if not checks else checks[-1][0]
              + (not np.array_equal(checks[-1][1], b)))
        checks.append((it, b, float(tt), float(fz - quad),
                       _f64_margin(Xi, y, w, b, z.numpy(), family,
                                   float(tt))))
        return fz, quad

    monkeypatch.setattr(tcore, "_model_check", traced_check)
    bt, nt = tcore.solve(solver, Xt, torch.as_tensor(y), torch.as_tensor(w),
                         torch.zeros(d + 1), torch.as_tensor(mask), **kw)
    assert bt.dtype == torch.float32 and isinstance(nt, int)
    if nt == int(nj):
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), **COEF_TOL)
        return
    assert solver == "proximal_grad" and abs(nt - int(nj)) == 1
    # each run's iterate after i iterations
    port = {c[0]: c[1] for c in checks}
    port[nt] = bt.numpy()
    p = min(nt, int(nj))

    def jax_after(i):
        return np.asarray(getattr(jcore, solver)(
            Xj, jnp.asarray(y), jnp.asarray(w), jnp.zeros(d + 1),
            jnp.asarray(mask), **dict(kw, max_iter=i))[0])

    jax_it = {i: jax_after(i) for i in range(1, p + 1)}
    parts = [i for i in range(1, p + 1)
             if not np.allclose(port[i], jax_it[i], **COEF_TOL)]
    assert parts and parts[0] == p, (parts, p)
    start = port[p - 1]
    # the steps at p: t and 2t from the same iterate
    ratio = (np.abs(jax_it[p] - jax_it.get(p - 1, start)).max()
             / np.abs(port[p] - start).max())
    assert abs(abs(np.log2(ratio)) - 1) < 0.05, ratio
    t_port = [c[2] for c in checks if c[0] == p - 1][-1]
    # the test decided by rounding: the port's at the larger step
    t_big = t_port * (2.0 if ratio > 1 else 1.0)
    decided = [c for c in checks if c[0] == p - 1 and c[2] == t_big]
    assert decided, (t_port, ratio)
    _, _, _, margin32, margin64 = decided[0]
    assert abs(margin64 - 1e-12) <= abs(margin32 - margin64), decided[0]
    if nt == p:  # the port stops first
        first, step, ahead = start, port[p] - start, jax_it[p]
        assert np.allclose(ahead, port[p] + step, **COEF_TOL)
    else:
        first = jax_it.get(p - 1, start)
        step, ahead = jax_it[p] - first, port[p]
        assert np.allclose(ahead, jax_it[p] + step, **COEF_TOL)
    offset = kw["tol"] * (np.abs(first).max() + np.abs(ahead).max())
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj),
                               rtol=COEF_TOL["rtol"],
                               atol=COEF_TOL["atol"] + offset)


def test_seams_match_jax():
    dense, _ = _problem(1, 40, 7)
    rng = np.random.RandomState(1)
    v = rng.standard_normal(7).astype(np.float32)
    r = rng.standard_normal(40).astype(np.float32)
    h = rng.uniform(size=40).astype(np.float32)
    A = tsps.ell_from_csr(scipy_sparse.csr_matrix(dense))
    Aj = jsps.SparseRows(jnp.asarray(A.values), jnp.asarray(A.cols), A.d)
    for Xt, Xj in ((torch.as_tensor(dense), jnp.asarray(dense)),
                   (A.to("cpu"), Aj)):
        for got, want in (
                (tcore._data_matvec(Xt, torch.as_tensor(v)),
                 jcore._data_matvec(Xj, jnp.asarray(v))),
                (tcore._data_pullback(Xt, torch.as_tensor(r)),
                 jcore._data_pullback(Xj, jnp.asarray(r))),
                (tcore._weighted_gram(Xt, torch.as_tensor(h)),
                 jcore._weighted_gram(Xj, jnp.asarray(h)))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_data_pullback_passes_its_kernel_on(monkeypatch):
    """``_data_pullback`` hands its ``kernel`` to the container's
    pullback, so a solver run with ``kernel="torch"`` launches nothing;
    the dense seam ignores it."""
    dense, _ = _problem(2, 30, 6)
    r = torch.as_tensor(np.random.RandomState(2).standard_normal(30).astype(
        np.float32))
    Xt = tsps.ell_from_csr(scipy_sparse.csr_matrix(dense)).to("cpu")
    seen = []
    plain = tsps.pullback

    def spy(A, r, *, kernel="auto"):
        seen.append(kernel)
        return plain(A, r, kernel=kernel)

    monkeypatch.setattr(tsps, "pullback", spy)
    want = torch.as_tensor(dense).T @ r
    for kernel in ("torch", "auto"):
        got = tcore._data_pullback(Xt, r, kernel=kernel)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert seen == ["torch", "auto"]
    with pytest.raises(ValueError, match="CUDA"):
        tcore._data_pullback(Xt, r, kernel="cuda")
    got = tcore._data_pullback(torch.as_tensor(dense), r, kernel="torch")
    assert torch.equal(got, want) and len(seen) == 3


def test_families_and_penalties_match_jax():
    rng = np.random.RandomState(2)
    eta = np.concatenate([rng.standard_normal(50) * 10,
                          [-40.0, 40.0, 0.0]]).astype(np.float32)
    y = rng.poisson(2.0, eta.shape).astype(np.float32)
    for name, (loss, hess) in tcore.FAMILIES.items():
        jl, jh = jcore.FAMILIES[name]
        for t, j in ((loss, jl), (hess, jh)):
            np.testing.assert_allclose(
                t(torch.as_tensor(eta), torch.as_tensor(y)).numpy(),
                np.asarray(j(jnp.asarray(eta), jnp.asarray(y))), rtol=1e-6)
    b = np.array([-2.0, -0.5, 0.0, 0.25, 3.0], np.float32)
    for name, (value, prox) in tcore.REGULARIZERS.items():
        jv, jp = jcore.REGULARIZERS[name]
        np.testing.assert_allclose(float(value(torch.as_tensor(b))),
                                   float(jv(jnp.asarray(b))), rtol=1e-6)
        np.testing.assert_allclose(
            prox(torch.as_tensor(b), torch.tensor(0.7)).numpy(),
            np.asarray(jp(jnp.asarray(b), 0.7)), rtol=1e-6)
    # the l1 subgradient at 0 is +1, as JAX differentiates |x|
    b0 = torch.zeros(3, requires_grad=True)
    tcore._l1_value(b0).backward()
    assert torch.equal(b0.grad, torch.ones(3))
    with pytest.raises(ValueError, match="regularizer"):
        tcore._penalty("l3")


def test_lbfgs_resume_takes_the_same_trajectory():
    dense, ys = _problem(3)
    X = torch.as_tensor(dense)
    args = (X, torch.as_tensor(ys["logistic"]), torch.ones(200),
            torch.zeros(12), torch.ones(12))
    kw = dict(lamduh=1.0, tol=0.0)
    b7, n7 = tcore.lbfgs(*args, max_iter=7, **kw)
    b3, n3, state, done = tcore.lbfgs(*args, max_iter=3, return_state=True,
                                      **kw)
    assert n3 == 3 and done is False and state[6].dtype == torch.int32
    b4, n4 = tcore.lbfgs(*args, max_iter=4, state=state, **kw)
    assert n4 == 4 and torch.equal(b4, b7)


def test_host_reads_one_per_loop_test():
    """The loop test before the first iteration reads nothing; each later
    one reads the device's stopping flag once; each Armijo test once."""
    dense, ys = _problem(4)
    args = (torch.as_tensor(dense), torch.as_tensor(ys["normal"]),
            torch.ones(200), torch.zeros(12), torch.ones(12))
    tcore.reset_host_reads()
    _, n = tcore.lbfgs(*args, max_iter=1, lamduh=1.0)
    assert n == 1 and tcore.host_reads["n"] == 1  # the first step holds
    tcore.reset_host_reads()
    _, n = tcore.gradient_descent(*args, max_iter=5, tol=0.0)
    assert n == 5 and tcore.host_reads["n"] >= 4 + 5


def test_newton_one_step_sparse_equals_dense_bit_for_bit():
    """The JAX package's coef_bit_identity_small gate inside the port: at a
    power-of-two n on integer data every quantity of one Newton step from
    0 is exactly representable, so the container and the dense fit give
    the same coefficients bit for bit."""
    for seed in range(3):
        rng = np.random.RandomState(seed)
        dense = (rng.randint(-3, 4, (128, 10))
                 * (rng.uniform(size=(128, 10)) < 0.3)).astype(np.float32)
        dense[2] = 0.0
        beta = rng.standard_normal(10).astype(np.float32)
        y = (dense @ beta > 0).astype(np.int32)
        ed = tlm.LogisticRegression(solver="newton", max_iter=1).fit(dense, y)
        es = tlm.LogisticRegression(solver="newton", max_iter=1).fit(
            scipy_sparse.csr_matrix(dense), y)
        np.testing.assert_array_equal(es.coef_, ed.coef_)
        assert float(es.intercept_) == float(ed.intercept_)


def _inputs(dense, kind):
    if kind == "numpy":
        return dense, dense
    csr = scipy_sparse.csr_matrix(dense)
    if kind == "csr":
        return csr, csr
    return jsps.ell_from_csr(csr), tsps.ell_from_csr(csr)


def _check_fit(je, te):
    assert te.n_iter_ == je.n_iter_
    np.testing.assert_allclose(te.coef_, np.asarray(je.coef_), **COEF_TOL)
    np.testing.assert_allclose(te.intercept_, np.asarray(je.intercept_),
                               **COEF_TOL)


@pytest.mark.parametrize("kind", ["numpy", "csr", "rows"])
def test_logistic_facade_matches_jax(kind):
    dense, ys = _problem(5)
    y = np.where(ys["logistic"] > 0, 7, 5)
    Xj, Xt = _inputs(dense, kind)
    je = jlm.LogisticRegression(solver="lbfgs", max_iter=30).fit(Xj, y)
    te = tlm.LogisticRegression(solver="lbfgs", max_iter=30).fit(Xt, y)
    np.testing.assert_array_equal(te.classes_, [5, 7])
    _check_fit(je, te)
    np.testing.assert_array_equal(te.predict(Xt), je.predict(Xj))
    np.testing.assert_allclose(te.predict_proba(Xt),
                               np.asarray(je.predict_proba(Xj)), rtol=1e-5)
    np.testing.assert_allclose(te.decision_function(Xt),
                               np.asarray(je.decision_function(Xj)),
                               rtol=1e-4, atol=1e-5)
    assert te.score(Xt, y) == pytest.approx(je.score(Xj, y), rel=1e-6)


@pytest.mark.parametrize("kind", ["numpy", "csr"])
def test_logistic_ovr_facade_matches_jax(kind):
    dense, _ = _problem(6, 240, 8)
    y = np.random.RandomState(6).randint(0, 3, 240)
    y[dense[:, 0] > 0.5] = 2
    Xj, Xt = _inputs(dense, kind)
    je = jlm.LogisticRegression(solver="lbfgs", max_iter=30).fit(Xj, y)
    te = tlm.LogisticRegression(solver="lbfgs", max_iter=30).fit(Xt, y)
    assert te.coef_.shape == (3, 8) and te.intercept_.shape == (3,)
    _check_fit(je, te)
    np.testing.assert_array_equal(te.predict(Xt), je.predict(Xj))
    np.testing.assert_allclose(te.predict_proba(Xt),
                               np.asarray(je.predict_proba(Xj)), rtol=1e-5)


@pytest.mark.parametrize("kind", ["numpy", "csr", "rows"])
def test_linear_and_poisson_facades_match_jax(kind):
    dense, ys = _problem(7)
    Xj, Xt = _inputs(dense, kind)
    for jcls, tcls, y, solver in (
            (jlm.LinearRegression, tlm.LinearRegression, ys["normal"],
             "lbfgs"),
            (jlm.PoissonRegression, tlm.PoissonRegression, ys["poisson"],
             "newton")):
        je = jcls(solver=solver, max_iter=30).fit(Xj, y)
        te = tcls(solver=solver, max_iter=30).fit(Xt, y)
        _check_fit(je, te)
        np.testing.assert_allclose(te.predict(Xt), np.asarray(je.predict(Xj)),
                                   rtol=1e-4, atol=1e-5)
        if tcls is tlm.LinearRegression:
            assert te.score(Xt, y) == pytest.approx(je.score(Xj, y),
                                                    rel=1e-5)
        else:
            assert te.get_deviance(Xt, y) == pytest.approx(
                je.get_deviance(Xj, y), rel=1e-5)


def test_sample_weight_and_no_intercept():
    dense, ys = _problem(8)
    w = np.random.RandomState(8).uniform(0.5, 2.0, 200).astype(np.float32)
    kw = dict(solver="lbfgs", max_iter=30, fit_intercept=False)
    je = jlm.LinearRegression(**kw).fit(dense, ys["normal"], sample_weight=w)
    te = tlm.LinearRegression(**kw).fit(dense, ys["normal"], sample_weight=w)
    assert not hasattr(te, "intercept_")
    np.testing.assert_allclose(te.coef_, np.asarray(je.coef_), **COEF_TOL)


@pytest.mark.parametrize("family,multiclass", [("logistic", "ovr"),
                                               ("normal", "ovr"),
                                               ("poisson", "ovr")])
def test_glm_from_numpy_predicts_like_jax(family, multiclass):
    dense, ys = _problem(9)
    cls = {"logistic": "LogisticRegression", "normal": "LinearRegression",
           "poisson": "PoissonRegression"}[family]
    y = ys[family] if family != "logistic" else np.where(
        ys["logistic"] > 0, 1, -1)
    je = getattr(jlm, cls)(solver="lbfgs", max_iter=20).fit(dense, y)
    te = glm_from_numpy(export_learned_attrs(je), family)
    assert type(te).__name__ == cls and te.n_iter_ == je.n_iter_
    csr = scipy_sparse.csr_matrix(dense)
    for X in (dense, csr):
        np.testing.assert_allclose(te.decision_function(X)
                                   if family == "logistic"
                                   else te._decision_function(X),
                                   np.asarray(je._decision_function(dense)),
                                   rtol=1e-5, atol=1e-5)
    if family == "logistic":
        np.testing.assert_array_equal(te.predict(csr), je.predict(dense))
        np.testing.assert_allclose(te.predict_proba(dense),
                                   je.predict_proba(dense), rtol=1e-5)
        assert te.score(dense, y) == pytest.approx(je.score(dense, y))
    else:
        np.testing.assert_allclose(te.predict(dense), je.predict(dense),
                                   rtol=1e-5, atol=1e-5)


def test_glm_from_numpy_ovr_and_bad_input():
    dense, _ = _problem(10, 150, 6)
    y = np.random.RandomState(10).randint(0, 3, 150)
    je = jlm.LogisticRegression(solver="lbfgs", max_iter=10).fit(dense, y)
    te = glm_from_numpy(export_learned_attrs(je), "logistic")
    np.testing.assert_array_equal(te.predict(dense), je.predict(dense))
    attrs = export_learned_attrs(je)
    with pytest.raises(ValueError, match="family"):
        glm_from_numpy(attrs, "gamma")
    with pytest.raises(ValueError, match="classes_"):
        glm_from_numpy({k: v for k, v in attrs.items() if k != "classes_"},
                       "logistic")
    with pytest.raises(ValueError, match="intercept_"):
        glm_from_numpy(dict(attrs, intercept_=np.zeros(2)), "logistic")


def test_facade_refusals():
    dense, ys = _problem(11, 60, 4)
    y = ys["logistic"]
    # the default solver (admm) and multinomial fits with more than two
    # classes fit now (tests/test_torch_admm.py holds them to JAX); a
    # sparse multinomial ADMM fit is refused
    assert tlm.LogisticRegression().fit(dense, y).n_iter_ >= 1
    est = tlm.LogisticRegression(solver="lbfgs", multiclass="multinomial")
    assert est.fit(dense, np.arange(60) % 3).coef_.shape == (3, 4)
    with pytest.raises(ValueError, match="multinomial ADMM"):
        tlm.LogisticRegression(multiclass="multinomial").fit(
            scipy_sparse.csr_matrix(dense), np.arange(60) % 3)
    # checkpoint= is ported: the chunked, snapshotted fit is the plain fit
    # (tests/test_torch_streaming_tier.py holds it to JAX and resumes it)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ck = tlm.LogisticRegression(solver="lbfgs", checkpoint=f"{tmp}/x",
                                    checkpoint_every=3).fit(dense, y)
    plain = tlm.LogisticRegression(solver="lbfgs").fit(dense, y)
    np.testing.assert_array_equal(ck.coef_, plain.coef_)
    with pytest.raises(ValueError, match="solver='admm'"):
        tlm.LogisticRegression(solver="lbfgs").fit_blocks(
            lambda b: None, 2, 60, 4)
    with pytest.raises(ValueError, match="'solver' must be"):
        tlm.LogisticRegression(solver="sgd").fit(dense, y)
    with pytest.raises(ValueError, match="multiclass"):
        tlm.LogisticRegression(solver="lbfgs", multiclass="x").fit(dense, y)
    with pytest.raises(ValueError, match="at least 2 classes"):
        tlm.LogisticRegression(solver="lbfgs").fit(dense, np.zeros(60))
    with pytest.raises(ValueError, match="y >= 0"):
        tlm.PoissonRegression(solver="lbfgs").fit(dense, -np.ones(60))
    # a binary multinomial fit is the binary fit
    a = tlm.LogisticRegression(solver="lbfgs", multiclass="multinomial").fit(
        dense, y)
    b = tlm.LogisticRegression(solver="lbfgs").fit(dense, y)
    np.testing.assert_array_equal(a.coef_, b.coef_)
    assert tlm.LogisticRegression(C=2.0).get_params()["C"] == 2.0


def test_metrics_match_jax():
    from dask_ml_tpu import metrics as jm

    rng = np.random.RandomState(12)
    a, b = rng.standard_normal(50), rng.standard_normal(50)
    w = rng.uniform(size=50)
    for t, j in ((mean_squared_error, jm.mean_squared_error),
                 (mean_absolute_error, jm.mean_absolute_error),
                 (r2_score, jm.r2_score)):
        assert t(a, b) == pytest.approx(j(a, b), rel=1e-5)
        assert t(a, b, sample_weight=w) == pytest.approx(
            j(a, b, sample_weight=w), rel=1e-5)
    la, lb = rng.randint(0, 3, 50), rng.randint(0, 3, 50)
    assert accuracy_score(la, lb) == pytest.approx(jm.accuracy_score(la, lb))
    assert accuracy_score(la, lb, normalize=False, sample_weight=w) == \
        pytest.approx(jm.accuracy_score(la, lb, normalize=False,
                                        sample_weight=w), rel=1e-5)
    assert accuracy_score(np.array(["a", "b"]), np.array(["a", "a"])) == 0.5
    with pytest.raises(TypeError):
        accuracy_score(np.array(["1"]), np.array([1]))
    with pytest.raises(ValueError, match="uniform_average"):
        r2_score(a, b, multioutput="raw_values")


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("width", [6, 14])
def test_predict_refuses_another_feature_count(width, fit_intercept):
    """A model fitted on 10 columns refuses CSR and dense rows of any
    other width at predict time (the JAX package answers silently there,
    from the wrong columns: a reference caveat, not held here)."""
    dense, ys = _problem(3, 80, 10)
    est = tlm.LogisticRegression(solver="lbfgs", max_iter=5,
                                 fit_intercept=fit_intercept).fit(
        scipy_sparse.csr_matrix(dense), ys["logistic"])
    assert est.n_features_in_ == 10
    rng = np.random.RandomState(width)
    other = (rng.standard_normal((30, width))
             * (rng.uniform(size=(30, width)) < 0.4)).astype(np.float32)
    for X in (scipy_sparse.csr_matrix(other), other):
        for method in (est.predict, est.predict_proba,
                       est.decision_function):
            with pytest.raises(ValueError, match="fitted with 10"):
                method(X)
    assert est.predict(dense[:30]).shape == (30,)
    assert est.predict(scipy_sparse.csr_matrix(dense[:30])).shape == (30,)


def test_converted_glm_refuses_another_feature_count():
    est = glm_from_numpy({"coef_": np.ones(5, np.float32),
                          "intercept_": np.float32(0.5)}, "normal")
    assert est.n_features_in_ == 5
    with pytest.raises(ValueError, match="fitted with 5"):
        est.predict(np.ones((3, 4), np.float32))
    assert est.predict(np.ones((3, 5), np.float32)).shape == (3,)
