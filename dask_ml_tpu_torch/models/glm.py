"""GLM functional core of the PyTorch port (counterpart of
``dask_ml_tpu/models/glm.py``): families, regularizers and the four smooth
solvers (gradient descent, Newton, L-BFGS, proximal gradient).

Objective convention, as in the JAX package: with per-row weights ``w``
and ``SW = Σ w``, every solver minimizes

    f(beta) = (1/SW)·Σ w_i·ℓ(x_i·beta, y_i) + (lamduh/SW)·P(beta ⊙ mask)

where ``mask`` excludes the intercept column from the penalty. Values and
gradients come from autograd (``torch.autograd.grad`` of the objective),
as they come from ``jax.value_and_grad`` there. The data enters through
three seams that dispatch by input type: a dense tensor goes to
``torch.matmul``; a :class:`~dask_ml_tpu_torch.ops.sparse.SparseRows`
container to ``ops/sparse`` — its matvec is the K6 kernel on the card,
and its backward K6's pullback kernel.

The JAX package runs each solver, and each Armijo backtracking, as an
on-device ``while_loop``. Here they are Python loops that read one scalar
from the device per loop test (the stopping flag, the Armijo test) and
nothing else: the L-BFGS history update stays on the device as
``torch.where`` over the buffers. :data:`host_reads` counts those reads.
Solver state stays float32 and Python float literals never promote it.
"""

from __future__ import annotations

import torch

from dask_ml_tpu_torch.ops import sparse as sparse_ops

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
    """Optimizer-state dtype for data of X's dtype: at least float32."""
    return torch.promote_types(X.dtype, torch.float32)


# ---------------------------------------------------------------------------
# The three seams that touch the data
# ---------------------------------------------------------------------------


def _data_matvec(X, v, kernel: str = "auto"):
    """``X @ v`` (n,): ``torch.matmul`` for a dense tensor, the K6 SpMV
    (``kernel`` as in :func:`~dask_ml_tpu_torch.ops.sparse.matvec`) for a
    container."""
    if isinstance(X, sparse_ops.SparseRows):
        return sparse_ops.matvec(X, v, kernel=kernel)
    return torch.matmul(X, v.to(X.dtype))


def _data_pullback(X, r, kernel: str = "auto"):
    """``X.T @ r`` (d,): the gradient pullback; for a container K6's
    backward or the plain scatter-add over the stored column indices
    (``kernel`` as in :func:`~dask_ml_tpu_torch.ops.sparse.pullback`)."""
    if isinstance(X, sparse_ops.SparseRows):
        return sparse_ops.pullback(X, r, kernel=kernel)
    return torch.matmul(X.T, r.to(X.dtype))


def _weighted_gram(X, h):
    """GLM curvature ``X.T @ diag(h) @ X`` (d, d), the Hessian build of
    Newton; for a container a chunked scatter-add of per-row outer
    products."""
    if isinstance(X, sparse_ops.SparseRows):
        return sparse_ops.weighted_gram(X, h)
    Xh = (h[:, None] * X).to(X.dtype)
    return torch.matmul(X.T, Xh)


# ---------------------------------------------------------------------------
# Host reads and autograd plumbing
# ---------------------------------------------------------------------------

#: device scalars the solvers have read on the host, one per loop test
#: (``host_reads["n"]``); set to 0 by :func:`reset_host_reads`
host_reads = {"n": 0}


def reset_host_reads() -> None:
    host_reads["n"] = 0


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


@torch.no_grad()
def gradient_descent(X, y, w, beta0, mask, *, family="logistic",
                     regularizer="l2", lamduh=0.0, max_iter=100, tol=1e-4,
                     kernel="auto"):
    """Batch gradient descent with Armijo backtracking and step growth (the
    facade passes ``lamduh=0``, as the reference strips the regularizer
    for this solver). Returns (beta, n_iter)."""
    obj, vg, sdt, _, _, beta = _setup(
        X, w, beta0, lamduh,
        _make_objective(family, regularizer, True, kernel), y, mask)
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


@torch.no_grad()
def newton(X, y, w, beta0, mask, *, family="logistic", regularizer="l2",
           lamduh=0.0, max_iter=50, tol=1e-4, kernel="auto"):
    """Damped Newton: GLM Hessian ``X.T @ (w·h · X) / SW``, dense solve,
    Armijo backtracking. Returns (beta, n_iter)."""
    _, hess_fn = FAMILIES[family]
    obj, vg, sdt, sw, lam_eff, beta = _setup(
        X, w, beta0, lamduh,
        _make_objective(family, regularizer, True, kernel), y, mask)
    one = torch.tensor(1.0, dtype=sdt, device=beta.device)
    it, done = 0, None
    while _keep_going(it, max_iter, done):
        eta = _data_matvec(X, beta, kernel=kernel)
        f0, g = vg(beta)
        h = w * hess_fn(eta, y)
        H = _weighted_gram(X, h) / sw
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


@torch.no_grad()
def lbfgs(X, y, w, beta0, mask, *, family="logistic", regularizer="l2",
          lamduh=0.0, max_iter=100, tol=1e-4, m=10, state=None,
          return_state=False, kernel="auto"):
    """L-BFGS with an m-pair circular history kept on the device. An l1
    penalty is handled by subgradient, as in dask-glm.

    ``state`` is the full carry ``(beta, g, f, S, Y, rho, count, head)``
    of a previous call with ``return_state=True``; resuming from it keeps
    the curvature history, so a chunked run takes the same trajectory as
    one call. ``n_iter`` counts this call's iterations. With
    ``return_state=True`` the return is ``(beta, n_iter, state, done)``,
    ``done`` the loop's own convergence flag; else ``(beta, n_iter)``."""
    obj, vg, sdt, _, _, beta0 = _setup(
        X, w, beta0, lamduh,
        _make_objective(family, regularizer, True, kernel), y, mask)
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
def proximal_grad(X, y, w, beta0, mask, *, family="logistic",
                  regularizer="l1", lamduh=0.0, max_iter=100, tol=1e-4,
                  kernel="auto"):
    """Proximal gradient (ISTA) with backtracking on the quadratic model;
    the prox acts only on the penalized coords (``mask``). Returns (beta,
    n_iter)."""
    _, pen_prox = _penalty(regularizer)
    fsmooth, vg, sdt, sw, lam_eff, beta = _setup(
        X, w, beta0, lamduh,
        _make_objective(family, regularizer, False, kernel), y, mask)
    lam_eff = lam_eff / sw

    def prox(v, t):
        return torch.where(mask > 0, pen_prox(v, t * lam_eff), v)

    def model_fails(beta, f0, g, tt):
        z = prox(beta - tt * g, tt)
        dz = z - beta
        quad = f0 + torch.dot(g, dz) + torch.sum(dz * dz) / (2.0 * tt)
        return fsmooth(z) > quad + 1e-12

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


SOLVERS = ("admm", "gradient_descent", "newton", "lbfgs", "proximal_grad")

_SMOOTH = {
    "gradient_descent": gradient_descent,
    "newton": newton,
    "lbfgs": lbfgs,
    "proximal_grad": proximal_grad,
}


def solver_fn(solver):
    """The solver function named ``solver``; ADMM is not ported yet and
    raises."""
    if solver not in SOLVERS:
        raise ValueError(
            f"'solver' must be one of {set(SOLVERS)}. Got {solver!r} instead")
    if solver == "admm":
        raise NotImplementedError(
            "solver='admm' is not ported to the PyTorch package yet; use "
            "solver='lbfgs' (or 'newton', 'gradient_descent', "
            "'proximal_grad')")
    return _SMOOTH[solver]


def solve(solver, X, y, w, beta0, mask, **kwargs):
    """Solver dispatch (the analogue of ``dask_glm.algorithms._solvers``)."""
    return solver_fn(solver)(X, y, w, beta0, mask, **kwargs)
