"""GLM functional core of the PyTorch port (counterpart of
``dask_ml_tpu/models/glm.py``): families, regularizers, the four smooth
solvers (gradient descent, Newton, L-BFGS, proximal gradient), consensus
ADMM over S row blocks, the softmax solvers (``multinomial_lbfgs``,
``admm_multinomial``), streamed ADMM, the streaming proximal-SGD steps
(``make_sgd_step``, ``make_batched_sgd_epoch``), and the search driver's
regularization path (``batched_glm_path``, ``batched_eval_scores``).

Objective convention, as in the JAX package: with per-row weights ``w``
and ``SW = Σ w``, every solver minimizes

    f(beta) = (1/SW)·Σ w_i·ℓ(x_i·beta, y_i) + (lamduh/SW)·P(beta ⊙ mask)

where ``mask`` excludes the intercept column from the penalty. Values and
gradients come from autograd (``torch.autograd.grad`` of the objective),
as they come from ``jax.value_and_grad`` there. The data enters through
three seams that dispatch by input type: a dense tensor goes to
``torch.matmul``; a :class:`~dask_ml_tpu_torch.ops.sparse.SparseRows`
container to ``ops/sparse`` — its matvec is the K6 kernel on the card,
and its backward K6's pullback kernel. Each solver's run is one
:func:`~dask_ml_tpu_torch.ops.sparse.reuse_scope`: where no cluster
holds the d-vector, a container takes the panel route once its calls
have paid for its panel-major copy, and the copy goes when the run ends.

The JAX package runs each solver, and each Armijo backtracking, as an
on-device ``while_loop``. Here they are Python loops that read one scalar
from the device per loop test (the stopping flag, the Armijo test) and
nothing else: the L-BFGS history update stays on the device as
``torch.where`` over the buffers. :data:`host_reads` counts those reads.
Solver state stays float32 and Python float literals never promote it.

**Over a mesh of ranks** (``mesh=``, a :class:`~dask_ml_tpu_torch.
parallel.mesh.Mesh` over a ``torch.distributed`` world), ``X``, ``y`` and
``w`` are this rank's block of the rows and every rank holds the whole
coefficient vector. The smooth solvers evaluate the rank's data loss, take
its gradient with respect to the linear predictor by autograd, pull it
back through the rank's rows (K6 and its backward for a container), and
only then sum the value, the gradient and Newton's Gram over the data
shards (:class:`_Shards`): ``torch.distributed`` has no autograd, and the
penalty, replicated, is added once after the sum. Every flag the host
reads is computed from summed values, so every rank takes every branch
together and issues the same collectives in the same order. On a
``("data", "model")`` mesh with X's columns split over ``model`` the
matvec sums its column blocks' partials over ``model``, and the gradient
and the Gram gather their column blocks. :func:`admm` and
:func:`admm_multinomial` give each rank one consensus block. A world of one
rank with no process group runs the single-device code.
"""

from __future__ import annotations

import math

import torch

from dask_ml_tpu_torch.ops import sparse as sparse_ops
from dask_ml_tpu_torch.parallel import hierarchy as hier
from dask_ml_tpu_torch.parallel import mesh as mesh_lib
from dask_ml_tpu_torch.parallel import precision as px
from dask_ml_tpu_torch.parallel import telemetry

# ---------------------------------------------------------------------------
# Families: pointwise loss ℓ(eta, y) and curvature h(eta, y) = ∂²ℓ/∂eta²
# ---------------------------------------------------------------------------

_ETA_MAX = 30.0  # clip for exp() links; exp(30) ~ 1e13 stays finite in f32


def _logistic_loss(eta, y):
    # softplus(eta) - y·eta, softplus as jax.nn.softplus writes it:
    # logaddexp(eta, 0) (torch's softplus turns into the identity above 20)
    return torch.logaddexp(eta, torch.zeros_like(eta)) - y * eta


def _logistic_hess(eta, y):
    p = torch.sigmoid(eta)
    return p * (1.0 - p)


def _normal_loss(eta, y):
    return 0.5 * (eta - y) ** 2


def _normal_hess(eta, y):
    return torch.ones_like(eta)


def _poisson_loss(eta, y):
    eta = torch.clamp(eta, -_ETA_MAX, _ETA_MAX)
    return torch.exp(eta) - y * eta


def _poisson_hess(eta, y):
    return torch.exp(torch.clamp(eta, -_ETA_MAX, _ETA_MAX))


FAMILIES = {
    "logistic": (_logistic_loss, _logistic_hess),
    "normal": (_normal_loss, _normal_hess),
    "poisson": (_poisson_loss, _poisson_hess),
}


# ---------------------------------------------------------------------------
# Regularizers: value P(b) and prox_{t·P}(v)
# ---------------------------------------------------------------------------


def _l2_value(b):
    return 0.5 * torch.sum(b * b)


def _l2_prox(v, t):
    return v / (1.0 + t)


def _l1_value(b):
    # |b| written as a select so that its gradient at 0 is +1, as JAX's
    # abs differentiates (torch.abs gives 0 there)
    return torch.sum(torch.where(b >= 0, b, -b))


def _soft_threshold(v, t):
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


def _en_value(b, weight=0.5):
    return weight * _l1_value(b) + (1.0 - weight) * _l2_value(b)


def _en_prox(v, t, weight=0.5):
    return _soft_threshold(v, weight * t) / (1.0 + (1.0 - weight) * t)


REGULARIZERS = {
    "l2": (_l2_value, _l2_prox),
    "l1": (_l1_value, _soft_threshold),
    "elastic_net": (_en_value, _en_prox),
}


def _penalty(regularizer):
    if regularizer not in REGULARIZERS:
        raise ValueError(
            f"regularizer must be one of {sorted(REGULARIZERS)}, "
            f"got {regularizer!r}")
    return REGULARIZERS[regularizer]


def _make_objective(family, regularizer, smooth_penalty: bool,
                    kernel: str = "auto"):
    """Weighted-sum objective ``f(beta, X, y, w, lam_eff, mask)``.
    ``smooth_penalty=True`` folds lam·P into the differentiated objective
    (GD / Newton / L-BFGS); ``False`` leaves P to a prox step."""
    loss_fn, _ = FAMILIES[family]
    pen_value, _ = _penalty(regularizer)

    def objective(beta, X, y, w, lam_eff, mask):
        eta = _data_matvec(X, beta, kernel=kernel)
        f = torch.sum(w * loss_fn(eta, y))
        if smooth_penalty:
            f = f + lam_eff * pen_value(beta * mask)
        return f

    return objective


def _state_dtype(X):
    """Optimizer-state dtype for data of X's dtype: at least float32, the
    one rule of :func:`~dask_ml_tpu_torch.parallel.precision.state_dtype`
    (bf16 data keeps f32 carries)."""
    return px.state_dtype(X.dtype)


# ---------------------------------------------------------------------------
# The three seams that touch the data
# ---------------------------------------------------------------------------


def _data_matvec(X, v, kernel: str = "auto"):
    """``X @ v`` (n,) in the state dtype: :func:`~dask_ml_tpu_torch.
    parallel.precision.pmatmul` for a dense tensor (v rounded to X's
    dtype, f32 accumulation: for f32 data the plain ``torch.matmul``), the
    K6 SpMV (``kernel`` as in :func:`~dask_ml_tpu_torch.ops.sparse.matvec`)
    for a container."""
    if isinstance(X, sparse_ops.SparseRows):
        return sparse_ops.matvec(X, v, kernel=kernel)
    return px.pmatmul(X, v, accum=px.state_dtype(X.dtype))


def _data_pullback(X, r, kernel: str = "auto"):
    """``X.T @ r`` (d,): the gradient pullback; for a container K6's
    backward or the plain scatter-add over the stored column indices
    (``kernel`` as in :func:`~dask_ml_tpu_torch.ops.sparse.pullback`). The
    cotangent ``r`` stays f32 on bf16 data, dense or sparse (the cotangent
    rule of :mod:`~dask_ml_tpu_torch.parallel.precision`)."""
    if isinstance(X, sparse_ops.SparseRows):
        return sparse_ops.pullback(X, r, kernel=kernel)
    return px.pullback_matmul(X.T, r)


def _weighted_gram(X, h):
    """GLM curvature ``X.T @ diag(h) @ X`` (d, d), the Hessian build of
    Newton; for a container a chunked scatter-add of per-row outer
    products."""
    if isinstance(X, sparse_ops.SparseRows):
        return sparse_ops.weighted_gram(X, h)
    # h applied first, the product rounded back to X's dtype: both
    # operands are bf16 for bf16 data, the Hessian f32 (the JAX package's)
    Xh = (h[:, None] * X).to(X.dtype)
    return px.pmatmul(X.T, Xh, accum=px.state_dtype(X.dtype))


def _mesh_or_none(mesh):
    """``mesh`` when its collectives run (a process group, or more than one
    rank), else None: a world of one rank with no process group runs the
    single-device code and records nothing."""
    return None if mesh is None else mesh_lib.collective_mesh(mesh)


class _Shards:
    """The data seams of a fit over a mesh of ranks. ``X`` is this rank's
    block of the rows (a dense tensor or a container); on a mesh with a
    ``model`` axis a dense block narrower than the coefficients is its
    column slice (``prepare_data(shard_features=True)``). Each reduction
    over the data shards is one :func:`~dask_ml_tpu_torch.parallel.
    hierarchy.hpsum` under its ledger op: ``glm.value``, ``glm.grad`` and
    ``glm.gram`` for dense rows (the JAX package's reductions there are
    GSPMD's and have no name), ``sparse.pullback`` and ``sparse.gram`` for
    a container (through :func:`~dask_ml_tpu_torch.ops.sparse.metered`).
    The model axis adds ``glm.matvec`` (the partial predictors summed over
    the column blocks), ``glm.pullback`` (the gradient's column blocks
    gathered) and ``glm.gram.gather``. :data:`mesh_evals` counts the
    evaluations."""

    def __init__(self, X, mesh, d: int, kernel: str = "auto"):
        self.X, self.mesh, self.kernel = X, mesh, kernel
        self.sparse = isinstance(X, sparse_ops.SparseRows)
        self.accum = _state_dtype(X)
        self.cols = None
        width = int(X.shape[1])
        if not self.sparse and width != int(d):
            m = mesh_lib.n_model_shards(mesh)
            if width * m != int(d):
                raise ValueError(
                    f"a block of {width} columns holds neither the whole "
                    f"{d} coefficients nor a {m}-th of them")
            lo = mesh_lib.model_index(mesh) * width
            self.cols = slice(lo, lo + width)

    def sum(self, t, op: str):
        """``t`` summed over the data shards."""
        return hier.hpsum(t, self.mesh, op=op)

    def matvec(self, v):
        """The rank's rows times ``v`` (d,) or (d, K)."""
        X = self.X
        if self.sparse:
            return (sparse_ops.matvec(X, v, kernel=self.kernel)
                    if v.ndim == 1 else sparse_ops.matmat(X, v))
        if self.cols is None:
            return px.pmatmul(X, v, accum=self.accum)
        return hier.mpsum(px.pmatmul(X, v[self.cols], accum=self.accum),
                          self.mesh, op="glm.matvec")

    def pullback(self, r):
        """``Xᵀ r`` over every rank's rows, (d,) or (d, K)."""
        X = self.X
        if self.sparse:
            with sparse_ops.metered(self.mesh):
                return (sparse_ops.pullback(X, r, kernel=self.kernel)
                        if r.ndim == 1 else sparse_ops.pullback_mat(X, r))
        g = self.sum(px.pullback_matmul(X.T, r), "glm.grad")
        if self.cols is not None:
            g = hier.mpgather(g, self.mesh, op="glm.pullback")
        return g

    def gram(self, h):
        """``Xᵀ diag(h) X`` over every rank's rows, (d, d). On a column
        slice the cross-column blocks need the other slices: the rank's
        weighted rows are gathered over ``model``, its rows of the Gram
        summed over the data shards, then gathered over ``model``."""
        mesh_evals["gram"] += 1
        X = self.X
        if self.sparse:
            with sparse_ops.metered(self.mesh):
                return sparse_ops.weighted_gram(X, h)
        if self.cols is None:
            return self.sum(_weighted_gram(X, h), "glm.gram")
        Xh = hier.mpgather((h[:, None] * X).to(X.dtype), self.mesh,
                           op="glm.gram.gather", axis=1)
        rows = self.sum(px.pmatmul(X.T, Xh, accum=self.accum), "glm.gram")
        return hier.mpgather(rows, self.mesh, op="glm.gram.gather", axis=0)


#: evaluations of the fits over a mesh: the objective's value (each one
#: sums once over the data shards), its gradient and Newton's Gram; set
#: to 0 by :func:`reset_host_reads`
mesh_evals = {"value": 0, "grad": 0, "gram": 0}


def _mesh_objective(sh, y, w, loss, pen, shape=None):
    """``(obj, value_and_grad, SW)`` of a fit over a mesh: ``loss(eta,
    y)`` the rows' loss (summed with the weights ``w``), ``pen(b)`` the
    replicated penalty term (None for none), ``shape`` the coefficients'
    shape where ``b`` is flattened ((d, K) for softmax). The rank's value
    and its cotangent with respect to the predictor come from autograd,
    the pullback through the rank's rows follows, and the sums over the
    data shards come after the graph, with the penalty added once."""
    sw = torch.clamp(sh.sum(torch.sum(w), "glm.sw"), min=1.0)

    def predictor(b):
        return sh.matvec(b if shape is None else b.reshape(shape))

    def obj(b):
        mesh_evals["value"] += 1
        f = sh.sum(torch.sum(w * loss(predictor(b), y)), "glm.value")
        if pen is not None:
            f = f + pen(b)
        return f / sw

    def value_and_grad(b):
        mesh_evals["value"] += 1
        mesh_evals["grad"] += 1
        eta = predictor(b)
        with torch.enable_grad():
            e = eta.detach().requires_grad_(True)
            f = torch.sum(w * loss(e, y))
            (r,) = torch.autograd.grad(f, e)
        f = sh.sum(f.detach(), "glm.value")
        g = sh.pullback(r).reshape(b.shape)
        if pen is not None:
            with torch.enable_grad():
                bb = b.detach().requires_grad_(True)
                p = pen(bb)
                (gp,) = torch.autograd.grad(p, bb)
            f, g = f + p.detach(), g + gp
        return f / sw, g / sw

    return obj, value_and_grad, sw


def _problem(X, y, w, beta0, mask, *, family, regularizer, lamduh,
             smooth_penalty, kernel, mesh):
    """What a smooth solver iterates on: ``(obj, value_and_grad, state
    dtype, SW, lam_eff, beta0 in the state dtype, matvec, gram)``, over
    the mesh when ``mesh`` reduces (:class:`_Shards`), else on the whole
    data (the single-device seams)."""
    mesh = _mesh_or_none(mesh)
    if mesh is None:
        obj, vg, sdt, sw, lam_eff, beta = _setup(
            X, w, beta0, lamduh,
            _make_objective(family, regularizer, smooth_penalty, kernel), y,
            mask)
        return (obj, vg, sdt, sw, lam_eff, beta,
                lambda b: _data_matvec(X, b, kernel=kernel),
                lambda h: _weighted_gram(X, h))
    loss_fn, _ = FAMILIES[family]
    pen_value, _ = _penalty(regularizer)
    sdt = _state_dtype(X)
    lam_eff = torch.tensor(lamduh, dtype=sdt, device=w.device)
    sh = _Shards(X, mesh, int(beta0.shape[0]), kernel)
    pen = ((lambda b: lam_eff * pen_value(b * mask)) if smooth_penalty
           else None)
    obj, vg, sw = _mesh_objective(sh, y, w, loss_fn, pen)
    return obj, vg, sdt, sw, lam_eff, beta0.to(sdt), sh.matvec, sh.gram


# ---------------------------------------------------------------------------
# Host reads and autograd plumbing
# ---------------------------------------------------------------------------

#: device scalars the solvers have read on the host, one per loop test
#: (``host_reads["n"]``), and the Newton steps of ADMM's batched local
#: solves (``host_reads["newton_steps"]``, one per step of the batch
#: whatever the number of blocks still active); set to 0 by
#: :func:`reset_host_reads`
host_reads = {"n": 0, "newton_steps": 0}


def reset_host_reads() -> None:
    for counts in (host_reads, mesh_evals):
        for k in counts:
            counts[k] = 0


def _read(flag) -> bool:
    host_reads["n"] += 1
    return bool(flag)


def _value_and_grad(obj):
    def value_and_grad(b):
        with torch.enable_grad():
            b = b.detach().requires_grad_(True)
            f = obj(b)
            (g,) = torch.autograd.grad(f, b)
        return f.detach(), g

    return value_and_grad


def _setup(X, w, beta0, lamduh, objective, y, mask):
    """(objective / SW, its value_and_grad, state dtype, SW, lam_eff,
    beta0 in the state dtype)."""
    sdt = _state_dtype(X)
    sw = torch.clamp(torch.sum(w), min=1.0)
    lam_eff = torch.tensor(lamduh, dtype=sdt, device=w.device)

    def obj(b):
        return objective(b, X, y, w, lam_eff, mask) / sw

    return obj, _value_and_grad(obj), sdt, sw, lam_eff, beta0.to(sdt)


# ---------------------------------------------------------------------------
# Shared line search: Armijo backtracking
# ---------------------------------------------------------------------------


def _backtrack(obj, beta, f0, g, direction, t0, c=1e-4, shrink=0.5,
               max_back=30):
    """Backtracking line search. Returns (t, f_new, n_backtracks); one host
    read per test of the Armijo condition."""
    gd = torch.dot(g, direction)
    t = t0
    f_new = obj(beta + t * direction)
    j = 0
    while j < max_back and _read((f_new > f0 + c * t * gd)
                                 | ~torch.isfinite(f_new)):
        t = t * shrink
        f_new = obj(beta + t * direction)
        j += 1
    return t, f_new, j


def _keep_going(it: int, max_iter: int, done) -> bool:
    """The solvers' loop test: the iteration budget on the host, then one
    read of the device's stopping flag (none before the first
    iteration)."""
    return it < max_iter and (done is None or not _read(done))


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


@sparse_ops.reuse_scope()
@torch.no_grad()
def gradient_descent(X, y, w, beta0, mask, *, family="logistic",
                     regularizer="l2", lamduh=0.0, max_iter=100, tol=1e-4,
                     kernel="auto", mesh=None):
    """Batch gradient descent with Armijo backtracking and step growth (the
    facade passes ``lamduh=0``, as the reference strips the regularizer
    for this solver). ``mesh``: the rows are this rank's block (module
    docstring). Returns (beta, n_iter)."""
    obj, vg, sdt, _, _, beta, _, _ = _problem(
        X, y, w, beta0, mask, family=family, regularizer=regularizer,
        lamduh=lamduh, smooth_penalty=True, kernel=kernel, mesh=mesh)
    t_prev = torch.tensor(1.0, dtype=sdt, device=beta.device)
    it, done = 0, None
    while _keep_going(it, max_iter, done):
        f0, g = vg(beta)
        t, f_new, _ = _backtrack(obj, beta, f0, g, -g, t_prev)
        beta = beta - t * g
        # relative-improvement stopping rule, like dask-glm's GD
        done = torch.abs(f0 - f_new) <= tol * torch.clamp(torch.abs(f0),
                                                          min=1e-10)
        t_prev = torch.clamp(t * 4.0, max=1e3)
        it += 1
    return beta, it


@sparse_ops.reuse_scope()
@torch.no_grad()
def newton(X, y, w, beta0, mask, *, family="logistic", regularizer="l2",
           lamduh=0.0, max_iter=50, tol=1e-4, kernel="auto", mesh=None):
    """Damped Newton: GLM Hessian ``X.T @ (w·h · X) / SW``, dense solve,
    Armijo backtracking. ``mesh``: the rows are this rank's block (module
    docstring). Returns (beta, n_iter)."""
    _, hess_fn = FAMILIES[family]
    obj, vg, sdt, sw, lam_eff, beta, matvec, gram = _problem(
        X, y, w, beta0, mask, family=family, regularizer=regularizer,
        lamduh=lamduh, smooth_penalty=True, kernel=kernel, mesh=mesh)
    one = torch.tensor(1.0, dtype=sdt, device=beta.device)
    it, done = 0, None
    while _keep_going(it, max_iter, done):
        eta = matvec(beta)
        f0, g = vg(beta)
        h = w * hess_fn(eta, y)
        H = gram(h) / sw
        # smooth-l2 curvature on the penalized coords plus a tiny ridge so
        # the solve never blows up on collinear features
        H = H + torch.diag(lam_eff / sw * mask + 1e-8)
        direction = -torch.linalg.solve(H, g)
        t, _, _ = _backtrack(obj, beta, f0, g, direction, one)
        step = t * direction
        beta = beta + step
        # step size OR gradient norm: on rank-deficient designs the
        # gradient reaches the f32 noise floor on a flat manifold
        done = ((torch.sqrt(torch.sum(step * step)) < tol)
                | (torch.max(torch.abs(g)) < tol))
        it += 1
    return beta, it


def _lbfgs_direction(g, S, Y, rho, count, head, m):
    """Two-loop recursion over the circular (m, d) history, newest pair
    first. The buffers are gathered once into newest-first order; entries
    beyond ``count`` (device scalars, like ``head``) contribute exactly 0
    through ``torch.where``, so nothing is read on the host."""
    slots = torch.arange(m, device=g.device)
    order = torch.remainder(head - 1 - slots, m)
    S_o, Y_o, rho_o = S[order], Y[order], rho[order]
    valid = slots < count
    q = g
    alpha = []
    for j in range(m):
        a = torch.where(valid[j], rho_o[j] * torch.dot(S_o[j], q), 0.0)
        q = q - a * Y_o[j]
        alpha.append(a)
    ys = torch.dot(S_o[0], Y_o[0])
    yy = torch.dot(Y_o[0], Y_o[0])
    gamma = torch.where(count > 0, ys / torch.clamp(yy, min=1e-30), 1.0)
    r = gamma * q
    for j in reversed(range(m)):  # oldest valid pair first
        b = rho_o[j] * torch.dot(Y_o[j], r)
        r = r + torch.where(valid[j], alpha[j] - b, 0.0) * S_o[j]
    return r


def _lbfgs_loop(obj, value_and_grad, carry0, max_iter, tol, m):
    """The L-BFGS loop: direction safeguard, Armijo backtracking,
    curvature-pair update, gradient / relative-improvement stopping.
    ``carry0 = (b, g, f, S, Y, rho, count, head)``; returns (carry,
    iterations, done) with ``done`` the device stopping flag of the last
    iteration (None if none ran)."""
    b, g, f, S, Y, rho, count, head = carry0
    slots = torch.arange(m, device=b.device)
    it, done = 0, None
    while _keep_going(it, max_iter, done):
        direction = -_lbfgs_direction(g, S, Y, rho, count, head, m)
        # fall back to steepest descent if the history produced a
        # non-descent direction (right after a skipped update)
        direction = torch.where(torch.dot(g, direction) < 0, direction, -g)
        t0 = torch.where(count > 0, 1.0,
                         1.0 / torch.clamp(torch.linalg.norm(g), min=1.0))
        t, _, _ = _backtrack(obj, b, f, g, direction, t0)
        b_new = b + t * direction
        f_new, g_new = value_and_grad(b_new)
        s = b_new - b
        yv = g_new - g
        sy = torch.dot(s, yv)
        ok = sy > 1e-10
        at_head = ok & (slots == head)
        S = torch.where(at_head[:, None], s[None, :], S)
        Y = torch.where(at_head[:, None], yv[None, :], Y)
        rho = torch.where(at_head, 1.0 / torch.clamp(sy, min=1e-30), rho)
        head = torch.where(ok, torch.remainder(head + 1, m), head)
        count = torch.where(ok, torch.clamp(count + 1, max=m), count)
        rel = torch.abs(f - f_new) <= tol * torch.clamp(torch.abs(f_new),
                                                        min=1e-10)
        done = (torch.max(torch.abs(g_new)) < tol) | rel
        b, g, f = b_new, g_new, f_new
        it += 1
    return (b, g, f, S, Y, rho, count, head), it, done


@sparse_ops.reuse_scope()
@torch.no_grad()
def lbfgs(X, y, w, beta0, mask, *, family="logistic", regularizer="l2",
          lamduh=0.0, max_iter=100, tol=1e-4, m=10, state=None,
          return_state=False, kernel="auto", mesh=None):
    """L-BFGS with an m-pair circular history kept on the device. An l1
    penalty is handled by subgradient, as in dask-glm.

    ``state`` is the full carry ``(beta, g, f, S, Y, rho, count, head)``
    of a previous call with ``return_state=True``; resuming from it keeps
    the curvature history, so a chunked run takes the same trajectory as
    one call. ``n_iter`` counts this call's iterations. With
    ``return_state=True`` the return is ``(beta, n_iter, state, done)``,
    ``done`` the loop's own convergence flag; else ``(beta, n_iter)``.
    ``mesh``: the rows are this rank's block (module docstring); the carry
    is replicated."""
    obj, vg, sdt, _, _, beta0, _, _ = _problem(
        X, y, w, beta0, mask, family=family, regularizer=regularizer,
        lamduh=lamduh, smooth_penalty=True, kernel=kernel, mesh=mesh)
    dev = beta0.device
    if state is None:
        d = int(beta0.shape[0])
        f0, g0 = vg(beta0)
        carry0 = (beta0, g0, f0,
                  torch.zeros((m, d), dtype=sdt, device=dev),
                  torch.zeros((m, d), dtype=sdt, device=dev),
                  torch.zeros((m,), dtype=sdt, device=dev),
                  torch.zeros((), dtype=torch.int32, device=dev),
                  torch.zeros((), dtype=torch.int32, device=dev))
    else:
        carry0 = tuple(torch.as_tensor(s, device=dev) for s in state)
    carry, n_iter, done = _lbfgs_loop(obj, vg, carry0, max_iter, tol, m)
    if return_state:
        return carry[0], n_iter, carry, done is not None and bool(done)
    return carry[0], n_iter


@torch.no_grad()
def _model_check(fsmooth, prox, beta, f0, g, tt):
    """ISTA's backtracking operands at ``z = prox(beta − tt·g, tt)``: the
    smooth objective ``f(z)`` and its quadratic model ``f0 + g·dz +
    |dz|²/(2·tt)``. :func:`proximal_grad` halves ``tt`` while ``f(z)``
    exceeds the model by more than 1e-12."""
    z = prox(beta - tt * g, tt)
    dz = z - beta
    return fsmooth(z), f0 + torch.dot(g, dz) + torch.sum(dz * dz) / (2.0 * tt)


@sparse_ops.reuse_scope()
def proximal_grad(X, y, w, beta0, mask, *, family="logistic",
                  regularizer="l1", lamduh=0.0, max_iter=100, tol=1e-4,
                  kernel="auto", mesh=None):
    """Proximal gradient (ISTA) with backtracking on the quadratic model;
    the prox acts only on the penalized coords (``mask``). ``mesh``: the
    rows are this rank's block (module docstring). Returns (beta,
    n_iter)."""
    _, pen_prox = _penalty(regularizer)
    fsmooth, vg, sdt, sw, lam_eff, beta, _, _ = _problem(
        X, y, w, beta0, mask, family=family, regularizer=regularizer,
        lamduh=lamduh, smooth_penalty=False, kernel=kernel, mesh=mesh)
    lam_eff = lam_eff / sw

    def prox(v, t):
        return torch.where(mask > 0, pen_prox(v, t * lam_eff), v)

    def model_fails(beta, f0, g, tt):
        fz, quad = _model_check(fsmooth, prox, beta, f0, g, tt)
        return fz > quad + 1e-12

    t = torch.tensor(1.0, dtype=sdt, device=beta.device)
    it, done = 0, None
    while _keep_going(it, max_iter, done):
        f0, g = vg(beta)
        j = 0
        while j < 30 and _read(model_fails(beta, f0, g, t)):
            t = t * 0.5
            j += 1
        beta_new = prox(beta - t * g, t)
        step = torch.max(torch.abs(beta_new - beta))
        done = step <= tol * torch.clamp(torch.max(torch.abs(beta)),
                                         min=1e-10)
        beta = beta_new
        t = torch.clamp(t * 2.0, max=1e3)
        it += 1
    return beta, it


# ---------------------------------------------------------------------------
# Consensus ADMM over S row blocks
# ---------------------------------------------------------------------------


def _row_blocks(X, n_shards: int):
    """X cut into ``n_shards`` contiguous row blocks of equal size: a
    ``(S, n/S, d)`` view of a dense tensor, or a list of S container
    slices (views of its leaves)."""
    n = int(X.shape[0])
    if n_shards < 1 or n % n_shards:
        raise ValueError(
            f"ADMM cuts the {n} rows into n_shards={n_shards} blocks of "
            "equal size; n must be a multiple of n_shards")
    nb = n // n_shards
    if isinstance(X, sparse_ops.SparseRows):
        return [X[s * nb:(s + 1) * nb] for s in range(n_shards)]
    return X.reshape(n_shards, nb, int(X.shape[1]))


def _blocks_matvec(Xb, x, kernel):
    """Each block times its own coefficients: (S, n/S)."""
    if isinstance(Xb, list):
        return torch.stack([_data_matvec(A, x[s], kernel=kernel)
                            for s, A in enumerate(Xb)])
    return px.pmatmul(Xb, x[:, :, None])[:, :, 0]


def _blocks_pullback(Xb, r, kernel):
    """Each block's ``X_s.T @ r_s``: (S, d)."""
    if isinstance(Xb, list):
        return torch.stack([_data_pullback(A, r[s], kernel=kernel)
                            for s, A in enumerate(Xb)])
    return px.pullback_matmul(Xb.transpose(1, 2), r[:, :, None])[:, :, 0]


def _blocks_gram(Xb, h):
    """Each block's ``X_s.T @ diag(h_s) @ X_s``: (S, d, d), one product a
    block: on the card a batched product of S (d, n/S) × (n/S, d) pairs
    is slower than S single products, whose long sums cuBLAS splits."""
    return torch.stack([_weighted_gram(Xs, h[s]) for s, Xs in enumerate(Xb)])


def _pointwise_grad(loss_fn, eta, y):
    """dℓ/deta at every entry: the gradient of the summed loss, which is
    elementwise (the JAX package takes ``jax.grad`` of the same sum)."""
    with torch.enable_grad():
        e = eta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(loss_fn(e, y)), e)
    return g


def _admm_scalars(sdt, dev, *values):
    return [torch.tensor(v, dtype=sdt, device=dev) for v in values]


def _admm_state(state, start, shape, sdt, dev, what):
    """``(z, x, u)`` to start from: the given state (x and u checked
    against ``shape``) or ``start`` broadcast over the blocks and u = 0."""
    if state is None:
        start = start.to(sdt)
        return (start, start.expand(shape).clone(),
                torch.zeros(shape, dtype=sdt, device=dev))
    z0, x0, u0 = (torch.as_tensor(s, device=dev).to(sdt) for s in state)
    if tuple(x0.shape) != shape or tuple(u0.shape) != shape:
        raise ValueError(
            f"{what} state has per-shard x/u of shape {tuple(x0.shape)}, but "
            f"this problem has {shape[0]} data shards (expected {shape}); "
            "ADMM consensus state cannot move between different shard "
            "counts")
    return z0, x0, u0


def _consensus(z, x, u, mask, pen_prox, lam_eff, rho, abstol, reltol,
               mesh=None):
    """One consensus step after the local solves ``x`` (one row a block):
    the z-consensus under the penalty mask, the dual update and Boyd's
    stopping rule with its S-dependent scalings. Returns (z_new, u_new,
    done). Over a ``mesh`` each rank holds its own blocks and the sums over
    blocks are :func:`~dask_ml_tpu_torch.parallel.hierarchy.hpsum`s under
    the JAX package's ops: ``glm.admm.consensus`` for Σ(x + u), and
    ``glm.admm.residuals`` for the three squared norms, summed as one
    (3,) vector (the JAX package's three scalar sums, the same bytes)."""
    S = int(x.shape[0])
    if mesh is not None:
        S *= mesh_lib.n_data_shards(mesh)
    size = x[0].numel()
    maskb = mask.reshape(mask.shape + (1,) * (z.ndim - 1))
    t = lam_eff / (rho * S)
    xu = torch.sum(x + u, dim=0)
    if mesh is not None:
        xu = hier.hpsum(xu, mesh, op="glm.admm.consensus")
    zbar = xu / S
    z_new = torch.where(maskb > 0, pen_prox(zbar, t), zbar)
    u = u + x - z_new
    sums = (torch.sum((x - z_new) ** 2), torch.sum(x * x), torch.sum(u * u))
    if mesh is not None:
        sums = hier.hpsum(torch.stack(sums), mesh, op="glm.admm.residuals")
    pri = torch.sqrt(sums[0])
    dual = rho * math.sqrt(S) * torch.linalg.norm((z_new - z).reshape(-1))
    eps_pri = (math.sqrt(S * size) * abstol
               + reltol * torch.maximum(
                   torch.sqrt(sums[1]),
                   math.sqrt(S) * torch.linalg.norm(z_new.reshape(-1))))
    eps_dual = (math.sqrt(S * size) * abstol
                + reltol * rho * torch.sqrt(sums[2]))
    return z_new, u, (pri < eps_pri) & (dual < eps_dual)


def _admm_loop(local_solve, z, x, u, mask, pen_prox, lam_eff, rho, abstol,
               reltol, max_iter, mesh=None):
    """The consensus iterations shared by :func:`admm` and
    :func:`admm_multinomial`: the local prox solves, then
    :func:`_consensus`. Returns (z, x, u, n_iter, done)."""
    it, done = 0, None
    while _keep_going(it, max_iter, done):
        x = local_solve(x, z, u)
        z, u, done = _consensus(z, x, u, mask, pen_prox, lam_eff, rho,
                                abstol, reltol, mesh=mesh)
        it += 1
    return z, x, u, it, done


def _admm_blocks(state, start, shape, sdt, dev, what, mesh):
    """``(z, x, u)`` to start from, with x and u this process's blocks:
    all ``shape[0]`` of them on one device; over a mesh the rank's own row
    of a state stacked over every data shard (the JAX layout), which is
    checked against the shard count."""
    if mesh is None:
        return _admm_state(state, start, shape, sdt, dev, what)
    S = mesh_lib.n_data_shards(mesh)
    z, x, u = _admm_state(state, start, (S,) + shape[1:], sdt, dev, what)
    i = mesh_lib.data_index(mesh)
    return z, x[i:i + 1].contiguous(), u[i:i + 1].contiguous()


def _admm_result(z, n_iter, x, u, done, return_state, mesh):
    """The ADMM return: over a mesh the state's x and u gathered from every
    rank into the stacked (S, ...) JAX layout (op ``glm.admm.state``)."""
    if not return_state:
        return z, n_iter
    if mesh is not None:
        x = hier.gather_blocks(x, mesh, op="glm.admm.state")
        u = hier.gather_blocks(u, mesh, op="glm.admm.state")
    return z, n_iter, (z, x, u), done is not None and bool(done)


def _batched_newton(grad_fn, step_fn, x, inner_tol, inner_max_iter):
    """S undamped Newton solves run as one batch. A block stops on its
    own ``max|g_s| <= inner_tol`` (as each shard's loop does in the JAX
    package) and keeps its x from then on; the loop runs until no block is
    active or ``inner_max_iter``, one host read per test."""
    g, aux = grad_fn(x)
    flat = tuple(range(1, g.ndim))

    def still(gg):
        return torch.amax(torch.abs(gg), dim=flat) > inner_tol

    active = still(g)
    it = 0
    while it < inner_max_iter and _read(torch.any(active)):
        host_reads["newton_steps"] += 1
        x_new = x - step_fn(g, aux)
        g_new, aux_new = grad_fn(x_new)
        keep = active.reshape((-1,) + (1,) * (x.ndim - 1))
        x = torch.where(keep, x_new, x)
        g = torch.where(keep, g_new, g)
        aux = torch.where(active.reshape((-1,) + (1,) * (aux.ndim - 1)),
                          aux_new, aux)
        active = active & still(g)
        it += 1
    return x


@sparse_ops.reuse_scope()
@torch.no_grad()
def admm(X, y, w, beta0, mask, mesh=None, *, n_shards=1,
         family="logistic", regularizer="l2", lamduh=0.0, rho=1.0,
         max_iter=250, abstol=1e-4, reltol=1e-2, inner_max_iter=20,
         inner_tol=1e-8, state=None, return_state=False, kernel="auto"):
    """Consensus ADMM (Boyd et al. §7.1.1) over ``n_shards`` contiguous row
    blocks of equal size, which stand in for the JAX package's data shards:
    its trajectory depends on S (the z-prox takes t = λ/(ρS) and the
    stopping residuals scale with S), so ``admm(..., n_shards=S)`` follows
    the JAX ``admm`` on an S-device mesh.

    Each outer iteration solves the S local prox problems
    ``argmin_x f_s(x) + (ρ/2)‖x − z + u_s‖²`` (``f_s`` the block's
    weighted loss over the whole problem's Σw) as one batch of undamped
    Newton steps: the (S, d, d) Hessian stacked from each block's
    :func:`_weighted_gram`, one batched ``torch.linalg.solve``. Then the z-consensus under the penalty mask,
    the dual update and Boyd's primal/dual residual test. Defaults are
    dask-glm's (ρ = 1, abstol 1e-4, reltol 1e-2, 250 iterations).

    ``state = (z, x, u)`` with x and u stacked ``(S, d)`` resumes a
    previous ``return_state=True`` call where it stopped; a state of
    another S raises ``ValueError``. ``n_iter`` counts this call's
    iterations; ``return_state=True`` returns ``(z, n_iter, state,
    done)``, else ``(z, n_iter)``. ``kernel`` reaches the container's
    matvec and pullback (K6 and its backward on the card).

    Over a ``mesh`` (``n_shards`` is then the mesh's data shard count)
    each rank is one consensus block: X, y and w are its rows, it keeps
    its own x and u, solves its prox problem alone, and reduces only Σw
    (op ``glm.admm.sw``), the consensus and the residuals
    (:func:`_consensus`). ``state`` and the returned state stack x and u
    over every shard, the JAX layout; the returned one is gathered from
    every rank (op ``glm.admm.state``)."""
    loss_fn, hess_fn = FAMILIES[family]
    _, pen_prox = _penalty(regularizer)
    mesh = _mesh_or_none(mesh)
    sdt = _state_dtype(X)
    dev = w.device
    d = int(X.shape[1])
    S = 1 if mesh is not None else n_shards
    Xb = _row_blocks(X, S)
    yb, wb = y.reshape(S, -1), w.reshape(S, -1)
    sw = torch.sum(w)
    if mesh is not None:
        sw = hier.hpsum(sw, mesh, op="glm.admm.sw")
    sw = torch.clamp(sw, min=1.0)
    lamduh, rho, abstol, reltol, inner_tol = _admm_scalars(
        sdt, dev, lamduh, rho, abstol, reltol, inner_tol)
    lam_eff = lamduh / sw
    eye = torch.eye(d, dtype=sdt, device=dev)
    z, x, u = _admm_blocks(state, beta0, (S, d), sdt, dev, "ADMM", mesh)

    def local_solve(x, z, u):
        def grad_eta(xx):
            # one data pass gives the gradient and the linear predictor
            # that the Hessian's weights need
            eta = _blocks_matvec(Xb, xx, kernel)
            r = wb * _pointwise_grad(loss_fn, eta, yb)
            g = _blocks_pullback(Xb, r, kernel) / sw + rho * (xx - z + u)
            return g, eta

        def step(g, eta):
            H = _blocks_gram(Xb, wb * hess_fn(eta, yb)) / sw + rho * eye
            return torch.linalg.solve(H, g)

        return _batched_newton(grad_eta, step, x, inner_tol,
                               int(inner_max_iter))

    z, x, u, n_iter, done = _admm_loop(local_solve, z, x, u, mask, pen_prox,
                                       lam_eff, rho, abstol, reltol,
                                       int(max_iter), mesh=mesh)
    return _admm_result(z, n_iter, x, u, done, return_state, mesh)


#: the refusal of a sparse softmax ADMM fit, in the JAX facade's words
SPARSE_MULTINOMIAL_ADMM = (
    "multinomial ADMM does not support sparse inputs: its local Newton "
    "builds the (dK x dK) Hessian from dense rows. Use solver='lbfgs' (the "
    "softmax objective routes through the sparse gather-matmat kernels), "
    "or multiclass='ovr'")

#: rows × K² × d entries of the multinomial Hessian's per-chunk operand
_MN_HESS_BUDGET = 1 << 26


def _multinomial_hessian(Xb, P, wb, sw):
    """``H_s = Σ_i w_i · x_i x_iᵀ ⊗ (diag p_i − p_i p_iᵀ) / SW`` for every
    block, (S, dK, dK). Indexed ``[(j, c), (l, k)]``: both axes flatten
    feature-major, as ``g.reshape(dK)`` does (another order permutes the
    columns and Newton diverges). Built over row chunks as one batched
    product ``X_cᵀ @ W_c`` with ``W_c[i, c, l, k] = w_i M_i[c, k] x_il``,
    so no (n, d, K, K) intermediate exists."""
    S, nb, d = Xb.shape
    K = int(P.shape[2])
    H = torch.zeros((S, d, K * d * K), dtype=P.dtype, device=P.device)
    eye = torch.eye(K, dtype=P.dtype, device=P.device)
    rows = max(1, _MN_HESS_BUDGET // (S * K * K * d))
    for a in range(0, nb, rows):
        Pc, Xc = P[:, a:a + rows], Xb[:, a:a + rows]
        M = (Pc[..., :, None] * eye - Pc[..., :, None] * Pc[..., None, :])
        M = M * wb[:, a:a + rows, None, None]
        W = M[:, :, :, None, :] * Xc[:, :, None, :, None]  # (S, r, c, l, k)
        H += px.pmatmul(Xc.transpose(1, 2), W.reshape(S, -1, K * d * K))
    return H.view(S, d * K, d * K) / sw


@torch.no_grad()
def admm_multinomial(X, y_idx, w, B0, mask, mesh=None, *, n_classes,
                     n_shards=1, regularizer="l2", lamduh=0.0, rho=1.0,
                     max_iter=250, abstol=1e-4, reltol=1e-2,
                     inner_max_iter=20, inner_tol=1e-8, state=None,
                     return_state=False):
    """Consensus ADMM for softmax logistic regression: :func:`admm` with
    (d, K) coefficient matrices per block (the JAX ``admm_multinomial``).
    Each local prox solve is a batch of Newton steps on the full
    ρ-regularized (dK × dK) Hessian (:func:`_multinomial_hessian`). Dense
    input only. Same state and ``mesh`` contract as :func:`admm`, with x
    and u stacked ``(S, d, K)``. Returns ``(B (d, K), n_iter)``."""
    if isinstance(X, sparse_ops.SparseRows):
        raise ValueError(SPARSE_MULTINOMIAL_ADMM)
    _, pen_prox = _penalty(regularizer)
    mesh = _mesh_or_none(mesh)
    sdt = _state_dtype(X)
    dev = w.device
    d, K = int(X.shape[1]), int(n_classes)
    S = 1 if mesh is not None else n_shards
    Xb = _row_blocks(X, S)
    wb = w.reshape(S, -1)
    Yoh = torch.nn.functional.one_hot(y_idx.to(torch.int64), K).to(sdt)
    Yoh = Yoh.reshape(S, -1, K)
    sw = torch.sum(w)
    if mesh is not None:
        sw = hier.hpsum(sw, mesh, op="glm.admm.sw")
    sw = torch.clamp(sw, min=1.0)
    lamduh, rho, abstol, reltol, inner_tol = _admm_scalars(
        sdt, dev, lamduh, rho, abstol, reltol, inner_tol)
    lam_eff = lamduh / sw
    eye = torch.eye(d * K, dtype=sdt, device=dev)
    z, x, u = _admm_blocks(state, B0, (S, d, K), sdt, dev,
                           "multinomial ADMM", mesh)

    def local_solve(x, z, u):
        def grad_probs(B):
            P = torch.softmax(px.pmatmul(Xb, B), dim=2)
            g = px.pullback_matmul(Xb.transpose(1, 2),
                                   wb[:, :, None] * (P - Yoh))
            return g / sw + rho * (B - z + u), P

        def step(g, P):
            H = _multinomial_hessian(Xb, P, wb, sw) + rho * eye
            return torch.linalg.solve(H, g.reshape(S, d * K)).view(S, d, K)

        return _batched_newton(grad_probs, step, x, inner_tol,
                               int(inner_max_iter))

    z, x, u, n_iter, done = _admm_loop(local_solve, z, x, u, mask, pen_prox,
                                       lam_eff, rho, abstol, reltol,
                                       int(max_iter), mesh=mesh)
    return _admm_result(z, n_iter, x, u, done, return_state, mesh)


@torch.no_grad()
def multinomial_lbfgs(X, y_idx, w, B0, mask, *, n_classes, regularizer="l2",
                      lamduh=0.0, max_iter=200, tol=1e-4, m=10, state=None,
                      return_state=False, mesh=None):
    """Softmax (multinomial) logistic regression by L-BFGS on the flattened
    (d·K) coefficient vector: :func:`_lbfgs_loop` over the weighted softmax
    cross-entropy (the JAX ``multinomial_lbfgs``). ``y_idx`` holds float
    class indices 0..K-1; ``mask`` (d,) is the per-feature penalty mask,
    broadcast over the classes. A container's logits go through
    :func:`~dask_ml_tpu_torch.ops.sparse.matmat` (its gradient through
    autograd's scatter-add). Returns ``(B (d, K), n_iter)``; ``state`` /
    ``return_state`` as in :func:`lbfgs`, over the flattened carry.
    ``mesh``: the rows are this rank's block, reduced as the binary
    solvers' (module docstring)."""
    d, K = int(X.shape[1]), int(n_classes)
    sdt = _state_dtype(X)
    pen_value, _ = _penalty(regularizer)
    lam_eff = torch.tensor(lamduh, dtype=sdt, device=w.device)
    Yoh = torch.nn.functional.one_hot(y_idx.to(torch.int64), K).to(sdt)
    mesh = _mesh_or_none(mesh)

    def pen(bflat):
        return lam_eff * pen_value(
            (bflat.reshape(d, K) * mask[:, None]).reshape(-1))

    if mesh is None:
        sw = torch.clamp(torch.sum(w), min=1.0)

        def obj(bflat):
            B = bflat.reshape(d, K)
            if isinstance(X, sparse_ops.SparseRows):
                logits = sparse_ops.matmat(X, B)
            else:
                logits = px.pmatmul(X, B)
            lse = torch.logsumexp(logits, dim=1)
            nll = torch.sum(w * (lse - torch.sum(Yoh * logits, dim=1)))
            return (nll + pen(bflat)) / sw

        vg = _value_and_grad(obj)
    else:
        def nll(logits, yoh):
            lse = torch.logsumexp(logits, dim=1)
            return lse - torch.sum(yoh * logits, dim=1)

        obj, vg, _ = _mesh_objective(_Shards(X, mesh, d), Yoh, w, nll, pen,
                                     shape=(d, K))
    dK = d * K
    dev = w.device
    if state is None:
        b0 = B0.to(sdt).reshape(dK)
        f0, g0 = vg(b0)
        carry0 = (b0, g0, f0,
                  torch.zeros((m, dK), dtype=sdt, device=dev),
                  torch.zeros((m, dK), dtype=sdt, device=dev),
                  torch.zeros((m,), dtype=sdt, device=dev),
                  torch.zeros((), dtype=torch.int32, device=dev),
                  torch.zeros((), dtype=torch.int32, device=dev))
    else:
        carry0 = tuple(torch.as_tensor(s, device=dev) for s in state)
    carry, n_iter, done = _lbfgs_loop(obj, vg, carry0, max_iter, tol, m)
    B = carry[0].reshape(d, K)
    if return_state:
        return B, n_iter, carry, done is not None and bool(done)
    return B, n_iter


# ---------------------------------------------------------------------------
# Batched regularization-path solves (the search driver's fast path)
# ---------------------------------------------------------------------------

_PATH_SOLVERS = ("gradient_descent", "newton", "lbfgs", "proximal_grad")


def batched_glm_path(X, y, w, beta0, mask, lamduh_arr, *, solver, family,
                     regularizer, max_iter, tol, mesh=None):
    """Solve the same GLM problem for a vector of regularization strengths
    (the JAX ``batched_glm_path``): the members are solved one after
    another through the same solver function with ``lamduh`` the
    member's value, so each member's result is the single fit's result
    bit for bit — the JAX program's ``vmap`` lanes stop contributing once
    they converge, which gives each lane the single fit's result too. The
    port's solvers are Python loops with a host read a loop test, so they
    cannot share one batched loop yet (a batched ``(M, d)`` solve is a
    ROADMAP speed item). The data is staged once for all members. ADMM is
    excluded, as in the JAX package. Over ``mesh`` X, y and w are this
    rank's block and each member's solve sums over the ranks, as the
    single fit over the mesh does. Returns ``(betas (M, d), n_iters (M,)
    int32)`` on the device."""
    if solver not in _PATH_SOLVERS:
        raise ValueError(
            f"batched_glm_path takes a solver of {_PATH_SOLVERS}; got "
            f"{solver!r}")
    fn = _SOLVERS[solver]
    betas, n_iters = [], []
    for lam in lamduh_arr:
        beta, n_iter = fn(X, y, w, beta0, mask, family=family,
                          regularizer=regularizer, lamduh=float(lam),
                          max_iter=max_iter, tol=tol, mesh=mesh)
        betas.append(beta)
        n_iters.append(int(n_iter))
    return (torch.stack(betas),
            torch.tensor(n_iters, dtype=torch.int32, device=beta0.device))


def batched_eval_scores(E, y, w, betas, *, family, mesh=None):
    """Default scores of a coefficient batch on one eval set, weighted:
    accuracy for logistic (``eta > 0`` against the {0, 1} targets; a
    target of −1, a label the training fold never saw, never matches),
    R² for normal. One ``(nE, M)`` product: the gather-matmat for a
    container, ``torch.matmul`` for dense data. ``betas`` is (M, d);
    returns (M,) on the device, with no host read. Over ``mesh`` E, y and
    w are this rank's block: the weighted sums go through ``hpsum`` (op
    ``glm.batched.eval``; R² sums the mean first, then the squares)."""
    def total(t):
        return t if mesh is None else hier.hpsum(t, mesh,
                                                 op="glm.batched.eval")

    if isinstance(E, sparse_ops.SparseRows):
        eta = sparse_ops.matmat(E, betas.T)
    else:
        eta = px.pmatmul(E, betas.T)
    if family == "logistic":
        hit = ((eta > 0).to(torch.float32) == y[:, None]).to(torch.float32)
        sums = total(torch.cat([torch.sum(hit * w[:, None], dim=0),
                                torch.sum(w)[None]]))
        return sums[:-1] / torch.clamp(sums[-1], min=1e-12)
    resid = y[:, None] - eta
    sums = total(torch.cat([torch.sum(resid * resid * w[:, None], dim=0),
                            torch.sum(y * w)[None], torch.sum(w)[None]]))
    ss_res = sums[:-2]
    sw = torch.clamp(sums[-1], min=1e-12)
    ybar = sums[-2] / sw
    ss_tot = torch.clamp(total(torch.sum((y - ybar) ** 2 * w)), min=1e-30)
    return 1.0 - ss_res / ss_tot


# ---------------------------------------------------------------------------
# Larger than the card's memory: streamed consensus ADMM over row blocks
# ---------------------------------------------------------------------------


def _streamed_block_newton(X_b, y_b, w_b, x, z, u, rho, inner_tol, sw_total,
                           *, family, inner_max_iter, kernel="auto"):
    """One block's local prox solve, ``argmin_x f_b(x) + (ρ/2)‖x − z +
    u‖²`` by undamped Newton steps (the step of :func:`admm`'s batch for
    one block), stopping on ``max|g| <= inner_tol`` or after
    ``inner_max_iter`` steps, one host read per test. The single
    implementation of both block-source modes of :func:`admm_streamed`."""
    loss_fn, hess_fn = FAMILIES[family]
    eye = torch.eye(int(z.shape[0]), dtype=x.dtype, device=x.device)

    def grad_eta(xx):
        eta = _data_matvec(X_b, xx, kernel=kernel)
        r = w_b * _pointwise_grad(loss_fn, eta, y_b)
        g = (_data_pullback(X_b, r, kernel=kernel) / sw_total
             + rho * (xx - z + u))
        return g, eta

    g, eta = grad_eta(x)
    it = 0
    while it < inner_max_iter and _read(torch.max(torch.abs(g)) > inner_tol):
        host_reads["newton_steps"] += 1
        H = _weighted_gram(X_b, w_b * hess_fn(eta, y_b)) / sw_total + rho * eye
        x = x - torch.linalg.solve(H, g)
        g, eta = grad_eta(x)
        it += 1
    return x


def _block_prox(blk, b, z, x, u, scal, *, family, inner_max_iter,
                transform, kernel):
    """Block ``b``'s prox solve from its block tuple: the source's
    transform (the facade's intercept append), then
    :func:`_streamed_block_newton` against the block's rows of x and u."""
    if transform is not None:
        blk = transform(blk)
    X_b, y_b, w_b = blk
    return _streamed_block_newton(
        X_b, y_b, w_b, x[b], z, u[b], scal["rho"], scal["inner_tol"],
        scal["sw_total"], family=family, inner_max_iter=inner_max_iter,
        kernel=kernel)


def _streamed_consensus(z, x, u, mask, pen_prox, scal):
    return _consensus(z, x, u, mask, pen_prox,
                      scal["lamduh"] / scal["sw_total"], scal["rho"],
                      scal["abstol"], scal["reltol"])


def _admm_streamed_host(source, z, x, u, mask, pen_prox, scal, *, check_done,
                        family, max_iter, inner_max_iter, kernel,
                        scan_checkpoint=None):
    """The host-driven outer loop over a ``HostBlockSource``: block
    ``b+1``'s copy (across an epoch boundary, block 0 of the next outer
    iteration) runs while block ``b``'s prox solve does.

    With ``scan_checkpoint`` the loop is preemption-safe: the scan carry
    is the epoch-start ``(z, x, u)`` and its outs are the per-block
    solutions, so a snapshot after any block replays the rest of that
    epoch and the remaining ones bit for bit. A snapshot at the path
    resumes here; it is deleted on completion."""
    from dask_ml_tpu_torch.checkpoint import leaf_tensor
    from dask_ml_tpu_torch.parallel.stream import prefetched_scan

    dev = source.device
    n_blocks = int(x.shape[0])
    done = None
    n_iter = 0
    start_epoch, start_block, outs0 = 0, 0, None
    if scan_checkpoint is not None:
        snap = scan_checkpoint.load()
        if snap is not None:
            carry, outs0, start_block, start_epoch = snap
            z, x, u = (leaf_tensor(t, dev) for t in carry)
            outs0 = [leaf_tensor(o, dev) for o in outs0]
            n_iter = start_epoch

    def step(carry, b, blk):
        z, x, u = carry
        return carry, _block_prox(
            blk, b, z, x, u, scal, family=family,
            inner_max_iter=inner_max_iter, transform=source.transform,
            kernel=kernel)

    for it in range(start_epoch, max_iter):
        first = it == start_epoch
        with telemetry.span("glm.admm.epoch", epoch=it, blocks=n_blocks):
            _, xs = prefetched_scan(
                step, (z, x, u), source, wrap=it + 1 < max_iter,
                checkpoint=scan_checkpoint, epoch=it,
                start_block=start_block if first else 0,
                outs=outs0 if first else None)
            x = torch.stack(xs)
            z, u, done = _streamed_consensus(z, x, u, mask, pen_prox, scal)
        n_iter = it + 1
        if check_done and _read(done):
            break
    source.discard_inflight()
    if scan_checkpoint is not None:
        scan_checkpoint.delete()
    return z, n_iter, x, u, done


@sparse_ops.reuse_scope()
@torch.no_grad()
def admm_streamed(block_fn, n_blocks, d, sw_total, mask=None, *,
                  family="logistic", regularizer="l2", lamduh=0.0, rho=1.0,
                  max_iter=250, abstol=1e-4, reltol=1e-2, inner_max_iter=20,
                  inner_tol=1e-8, state=None, return_state=False,
                  dtype=torch.float32, checkpoint_path=None,
                  checkpoint_every=None, elastic=None, kernel="auto",
                  device=None):
    """Consensus ADMM over data larger than the card's memory (the JAX
    ``admm_streamed``).

    Each outer iteration solves the local prox problem of each of
    ``n_blocks`` row blocks in turn, one block resident at a time, then
    takes the consensus step of :func:`admm` with blocks standing in for
    shards: B streamed blocks follow ``admm(..., n_shards=B)`` on the same
    rows. ``block_fn`` is either

    - a callable ``block_fn(b) -> (X_b, y_b, w_b)`` making block ``b`` on
      the device (regenerated from a seed, or sliced from a resident
      tensor), or
    - a :class:`~dask_ml_tpu_torch.parallel.stream.HostBlockSource`, whose
      copies of block ``b+1`` overlap block ``b``'s solve.

    Both modes run one per-block function (:func:`_block_prox`), so the
    same block contents give the same bits. ``sw_total`` is the total
    sample weight over all blocks (n for unit weights); it fixes the
    objective's 1/SW normalization without a pre-pass. ``dtype`` names the
    block dtype; the state (z, x, u) is at least float32. ``kernel``
    reaches a container's matvec and pullback. The state and scalars live
    on the source's device, or on ``device`` (default: the configured
    one) for a callable.

    Returns ``(z, n_iter)``; with ``return_state=True``
    ``(z, n_iter, (z, x, u), done)``, x and u stacked ``(n_blocks, d)``,
    the contract of :func:`admm`; ``state`` resumes such a carry.

    ``checkpoint_path`` (source mode only) makes the fit preemption-safe:
    every ``checkpoint_every`` blocks (default: once an outer iteration)
    the scan state is saved, SIGTERM/SIGINT drain (finish the block, save,
    raise :class:`~dask_ml_tpu_torch.parallel.faults.Preempted`), and a
    rerun with the same path resumes from the last complete block on a
    bit-identical trajectory; the snapshot is deleted on completion. Its
    binding is the JAX package's, so either package resumes the other's
    snapshot. A callable refuses ``checkpoint_path`` (chunk it through
    ``state=`` instead).

    ``elastic`` (an :class:`~dask_ml_tpu_torch.parallel.elastic.ElasticRun`,
    source mode only) spreads each epoch over a fleet of processes: this
    host consumes its shard of the run's seeded block permutation,
    publishes each block's result to the shared directory, and survivors
    re-deal a lost host's missing blocks. The trajectory equals the
    single-host run bit for bit whatever the roster did
    (:func:`~dask_ml_tpu_torch.parallel.elastic.elastic_admm_host`). With
    ``checkpoint_path`` a resume replays the snapshot's own shuffled
    sequence; an elastic snapshot is refused by a resume without
    ``elastic=`` and the other way round."""
    from dask_ml_tpu_torch.config import resolve_device
    from dask_ml_tpu_torch.parallel.faults import scan_checkpoint_scope
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    host = isinstance(block_fn, HostBlockSource)
    if host and block_fn.n_blocks != int(n_blocks):
        raise ValueError(
            f"n_blocks={n_blocks} does not match the HostBlockSource's "
            f"{block_fn.n_blocks} blocks")
    if not host and checkpoint_path is not None:
        raise ValueError(
            "checkpoint_path= requires a HostBlockSource: a callable "
            "block_fn is chunked through state=/return_state instead (see "
            "checkpoint.solve_checkpointed)")
    if not host and elastic is not None:
        raise ValueError(
            "elastic= requires a HostBlockSource: the elastic data plane "
            "shards the ingestion of host blocks across processes, and a "
            "callable block_fn has no host blocks to shard")
    _, pen_prox = _penalty(regularizer)
    dev = block_fn.device if host else resolve_device(device)
    sdt = px.state_dtype(dtype)
    shape = (int(n_blocks), int(d))
    if state is None:
        z = torch.zeros(int(d), dtype=sdt, device=dev)
        x = torch.zeros(shape, dtype=sdt, device=dev)
        u = torch.zeros(shape, dtype=sdt, device=dev)
    else:
        z, x, u = (torch.as_tensor(s, device=dev).to(sdt) for s in state)
        if tuple(x.shape) != shape or tuple(u.shape) != shape:
            raise ValueError(
                f"streamed ADMM state has x/u of shapes {tuple(x.shape)}/"
                f"{tuple(u.shape)}, expected {shape}; consensus state "
                "cannot move between runs with different block counts")
    mask = (torch.ones(int(d), dtype=sdt, device=dev) if mask is None
            else torch.as_tensor(mask, device=dev).to(sdt))
    scal = dict(zip(("lamduh", "rho", "abstol", "reltol", "inner_tol",
                     "sw_total"),
                    _admm_scalars(sdt, dev, lamduh, rho, abstol, reltol,
                                  inner_tol, sw_total)))
    kw = dict(family=family, inner_max_iter=int(inner_max_iter),
              kernel=kernel)
    with telemetry.span("glm.admm.streamed", blocks=int(n_blocks),
                        d=int(d), family=family):
        if host:
            with scan_checkpoint_scope(
                    checkpoint_path,
                    every=(int(n_blocks) if checkpoint_every is None
                           else int(checkpoint_every)),
                    bind={"what": "admm_streamed", "n_blocks": int(n_blocks),
                          "d": int(d), "family": family,
                          "regularizer": regularizer,
                          # an elastic snapshot holds positions in a
                          # shuffled sequence: resuming it as a plain scan
                          # (or the other way round) must be refused
                          "elastic": elastic is not None,
                          "params": repr((float(lamduh), float(rho),
                                          float(abstol), float(reltol),
                                          float(inner_tol), float(sw_total),
                                          int(inner_max_iter)))}
            ) as scan_ckpt:
                host_kw = dict(
                    check_done=float(abstol) != 0.0 or float(reltol) != 0.0,
                    max_iter=int(max_iter), scan_checkpoint=scan_ckpt, **kw)
                if elastic is not None:
                    from dask_ml_tpu_torch.parallel.elastic import \
                        elastic_admm_host

                    z, n_iter, x, u, done = elastic_admm_host(
                        elastic, block_fn, z, x, u, mask, pen_prox, scal,
                        regularizer=regularizer, **host_kw)
                else:
                    z, n_iter, x, u, done = _admm_streamed_host(
                        block_fn, z, x, u, mask, pen_prox, scal, **host_kw)
        else:
            n_iter, done = 0, None
            while _keep_going(n_iter, int(max_iter), done):
                x = torch.stack([
                    _block_prox(block_fn(b), b, z, x, u, scal,
                                transform=None, **kw)
                    for b in range(int(n_blocks))])
                z, u, done = _streamed_consensus(z, x, u, mask, pen_prox,
                                                 scal)
                n_iter += 1
    if return_state:
        return z, n_iter, (z, x, u), done is not None and bool(done)
    return z, n_iter


# ---------------------------------------------------------------------------
# Streaming (incremental) training: one proximal-SGD step per row block
# ---------------------------------------------------------------------------


def add_intercept(X):
    """Append a ones column to a dense tensor, or the intercept as one
    extra slot per row (column ``d``, value 1) to a container."""
    if isinstance(X, sparse_ops.SparseRows):
        return sparse_ops.add_intercept_ell(X)
    return torch.cat([X, X.new_ones((X.shape[0], 1))], dim=1)


def make_sgd_step(family="logistic", regularizer="l2", lamduh=0.0,
                  eta0=0.1, power_t=0.5, fit_intercept=True,
                  n_classes=None, kernel: str = "auto"):
    """The streaming GLM step (the JAX ``make_sgd_step``):
    ``step(state, (x, y, w)) -> state`` with ``state = (beta, t)``, ``t`` a
    float32 scalar tensor. One proximal-SGD update per block: the gradient
    of the weighted-mean family loss on the block (autograd), the step size
    ``eta0 / (1 + t)**power_t``, then the regularizer's prox on the
    penalized coordinates (the intercept takes the plain step).

    Blocks arrive without the ones column: with ``fit_intercept`` the step
    appends it (``beta``'s last coordinate is the intercept). ``w`` is the
    per-row weight, 0 on the padding of a remainder block. A dense block's
    predictor is ``torch.matmul``; a container's is
    :func:`~dask_ml_tpu_torch.ops.sparse.matvec` (``kernel`` as there), so
    on the card its forward launches K6 and its gradient the pullback
    kernel. ``n_classes >= 3`` (logistic only) switches to softmax:
    ``beta`` is (width, K), ``y`` holds float class indices, the intercept
    row is not penalized."""
    multinomial = n_classes is not None and n_classes >= 3
    if multinomial and family != "logistic":
        raise ValueError("n_classes >= 3 requires family='logistic'")
    loss_fn, _ = FAMILIES[family]
    _, pen_prox = _penalty(regularizer)

    def step(state, blk):
        beta, t = state
        x, y, w = blk
        if fit_intercept:
            x = add_intercept(x)
        wsum = torch.clamp(torch.sum(w), min=1e-12)
        if multinomial:
            yoh = torch.nn.functional.one_hot(y.to(torch.int64),
                                              n_classes).to(torch.float32)

            def block_loss(B):
                logits = (sparse_ops.matmat(x, B)
                          if isinstance(x, sparse_ops.SparseRows)
                          else px.pmatmul(x, B))
                lse = torch.logsumexp(logits, dim=1)
                return torch.sum(
                    w * (lse - torch.sum(yoh * logits, dim=1))) / wsum
        else:
            def block_loss(b):
                return torch.sum(
                    w * loss_fn(_data_matvec(x, b, kernel=kernel), y)) / wsum

        _, g = _value_and_grad(block_loss)(beta)
        lr = eta0 / (1.0 + t) ** power_t
        cand = beta - lr * g
        prox = pen_prox(cand, lr * lamduh)
        if fit_intercept:
            cand = torch.cat([prox[:-1], cand[-1:]])
        else:
            cand = prox
        return cand, t + 1.0

    return step


#: one (step, single-block apply) pair per hyperparameter point
_STREAM_CACHE: dict = {}


def get_stream_step(family="logistic", regularizer="l2", lamduh=0.0,
                    eta0=0.1, power_t=0.5, fit_intercept=True,
                    n_classes=None):
    """Cached :func:`make_sgd_step` and ``apply_one(state, x, y, w)``,
    the step on one block without autograd history (the JAX package's
    jitted single-block apply)."""
    key = (family, regularizer, float(lamduh), float(eta0), float(power_t),
           bool(fit_intercept),
           None if n_classes is None else int(n_classes))
    if key not in _STREAM_CACHE:
        step = make_sgd_step(family=family, regularizer=regularizer,
                             lamduh=lamduh, eta0=eta0, power_t=power_t,
                             fit_intercept=fit_intercept,
                             n_classes=n_classes)

        @torch.no_grad()
        def apply_one(state, x, y, w, step=step):
            return step(state, (x, y, w))

        _STREAM_CACHE[key] = (step, apply_one)
    return _STREAM_CACHE[key]


def make_batched_sgd_epoch(family="logistic", regularizer="l2",
                           fit_intercept=True):
    """M hyperparameter members through one data epoch (the JAX
    ``make_batched_sgd_epoch``):
    ``epoch(betas, ts, lam, eta0, power_t, live, Xb, yb, wb, order)``.

    ``betas`` (M, width) and ``ts``, ``lam``, ``eta0``, ``power_t``,
    ``live`` (M,) tensors; ``Xb`` (B, bs, width) dense blocks with the
    intercept column already appended, ``yb`` and ``wb`` (B, bs); the
    blocks are visited in ``order`` (a sequence of block indices; a tensor
    of them is read to the host once). Each block is one batched product
    ``x @ betas.T`` for every member, then each member's proximal-SGD
    update; members with ``live`` False keep their state. Returns
    ``(betas, ts)``."""
    loss_fn, _ = FAMILIES[family]
    _, pen_prox = _penalty(regularizer)

    @torch.no_grad()
    def epoch(betas, ts, lam, eta0, power_t, live, Xb, yb, wb, order):
        if isinstance(order, torch.Tensor):
            order = order.cpu()
        keep = live[:, None]
        for b in [int(i) for i in order]:
            x, y, w = Xb[b], yb[b], wb[b]
            wsum = torch.clamp(torch.sum(w), min=1e-12)

            def block_loss(B):
                eta = px.pmatmul(x, B.T)  # (bs, M): every member at once
                return torch.sum(w[:, None] * loss_fn(eta, y[:, None])) / wsum

            _, g = _value_and_grad(block_loss)(betas)
            lr = (eta0 / (1.0 + ts) ** power_t)[:, None]
            cand = betas - lr * g
            prox = pen_prox(cand, lr * lam[:, None])
            if fit_intercept:
                cand = torch.cat([prox[:, :-1], cand[:, -1:]], dim=1)
            else:
                cand = prox
            betas = torch.where(keep, cand, betas)
            ts = torch.where(live, ts + 1.0, ts)
        return betas, ts

    return epoch


#: one batched epoch per (family, regularizer, fit_intercept)
_BATCHED_STREAM_CACHE: dict = {}


def get_batched_sgd_epoch(family="logistic", regularizer="l2",
                          fit_intercept=True):
    """Cached :func:`make_batched_sgd_epoch`."""
    key = (family, regularizer, bool(fit_intercept))
    if key not in _BATCHED_STREAM_CACHE:
        _BATCHED_STREAM_CACHE[key] = make_batched_sgd_epoch(
            family=family, regularizer=regularizer,
            fit_intercept=fit_intercept)
    return _BATCHED_STREAM_CACHE[key]


SOLVERS = ("admm", "gradient_descent", "newton", "lbfgs", "proximal_grad")

_SOLVERS = {
    "admm": admm,
    "gradient_descent": gradient_descent,
    "newton": newton,
    "lbfgs": lbfgs,
    "proximal_grad": proximal_grad,
}


def solver_fn(solver):
    """The solver function named ``solver``."""
    if solver not in SOLVERS:
        raise ValueError(
            f"'solver' must be one of {set(SOLVERS)}. Got {solver!r} instead")
    return _SOLVERS[solver]


def solve(solver, X, y, w, beta0, mask, mesh=None, **kwargs):
    """Solver dispatch (the analogue of ``dask_glm.algorithms._solvers``).
    ``mesh`` reaches every solver: over a mesh of ranks the rows are this
    rank's block (module docstring)."""
    return solver_fn(solver)(X, y, w, beta0, mask, mesh=mesh, **kwargs)
