"""Tall-skinny linear algebra of the PyTorch port (counterpart of
``dask_ml_tpu/ops/linalg.py``): thin QR, thin SVD and randomized SVD on
one device.

- :func:`tsqr` — CholeskyQR2 (two rounds of Gram → Cholesky → triangular
  solve, every FLOP a matrix product or a triangular solve) with an
  orthogonality guard: when ``‖QᵀQ − I‖_max`` reaches
  :data:`_CHOLQR_ORTHO_TOL` the Gram has squared away too much of the
  condition number and Householder QR (``torch.linalg.qr``) runs instead;
  with fewer rows than columns Householder runs at once. The JAX package
  makes that choice on the device with ``lax.cond``; here it is one host
  read of the error, counted in :data:`tsqr_counts`.
- :func:`tsvd` — SVD of the small R (cuSOLVER's gesvd on the card), then
  ``U = Q @ U_r``.
- :func:`svd_compressed` — the Halko/Martinsson/Tropp range finder with
  QR-stabilized power iterations, ``B = QᵀX`` and a small SVD.
- :func:`svd_flip` — the sign convention of the outputs.

Over a mesh of ranks (``mesh=``) X is this rank's block of the rows
(every block the same shape) and Q and U come back as the rank's block:

- CholeskyQR2's Grams, and the guard's ``QᵀQ``, are
  :func:`~dask_ml_tpu_torch.parallel.hierarchy.hpsum`s (ledger ops
  ``tsqr.gram`` and ``tsqr.guard``), so the host reads the guard of the
  whole Q and every rank takes the same branch;
- the Householder fallback is the JAX package's tree: each rank's QR, the
  R factors gathered (``tsqr.gather``), the QR of the stack, and each
  rank's Q patched with its slice of the small Q; on a ``("pod",
  "chip")`` mesh the tree has the middle level: the chip group's factors
  first, then one factor a pod. Ranks with fewer rows than columns take
  it at once;
- :func:`svd_compressed` draws Ω whole, the same on every rank given the
  same generator seed, and sums its Grams (``tsqr.gram``), the power
  iterations' ``XᵀQ`` (``svd_compressed.xtq``) and ``QᵀX``
  (``svd_compressed.qtx``) over the ranks.

Rows of weight 0 (padding) are zeroed when ``weights`` is given, so they
drop out of every product. :func:`tsqr` and :func:`tsvd` take float32.
:func:`svd_compressed` takes float32 or bfloat16 X and a
``compute_dtype`` for its sketch (the precision policy's ``"sketch"``
dtype by default): every product that touches X is formed from operands
of that dtype and accumulated in f32
(:func:`~dask_ml_tpu_torch.parallel.precision.pmatmul`), while the
CholeskyQR2 repair and the small SVD stay f32. On the card these are
cuBLAS and cuSOLVER calls, as they are XLA calls outside any Pallas kernel
in the JAX package.
"""

from __future__ import annotations

import torch

from dask_ml_tpu_torch.parallel import hierarchy as hier
from dask_ml_tpu_torch.parallel import mesh as mesh_lib
from dask_ml_tpu_torch.parallel import precision as px
from dask_ml_tpu_torch.utils.validation import check_random_state, svd_flip

__all__ = ["tsqr", "tsvd", "svd_compressed", "svd_flip"]

#: largest ‖QᵀQ − I‖_max accepted from CholeskyQR2. Well-conditioned f32
#: inputs land near 1e-6; the error grows like cond(X)²·eps, so beyond
#: this the Gram lost real information and Householder must run.
_CHOLQR_ORTHO_TOL = 1e-3

#: the tsqr guard's host reads, and the branch each tsqr call took
#: (``householder`` counts the static n < d choice too); set to 0 by
#: :func:`reset_tsqr_counts`
tsqr_counts = {"host_reads": 0, "cholqr2": 0, "householder": 0}


def reset_tsqr_counts() -> None:
    for k in tsqr_counts:
        tsqr_counts[k] = 0


def _mask_padding_rows(X, weights):
    """Zero the rows of weight 0, so that the factorizations see them as
    exact zeros whatever the caller left there."""
    return X * (weights > 0).to(X.dtype)[:, None]


def _cholesky_qr2(Y, mesh=None):
    """Orthonormalize a tall-skinny Y by CholeskyQR2. Returns (Q, R, ok),
    ``ok`` False where a Cholesky factorization failed (the JAX package's
    Cholesky gives NaN there; ``torch.linalg.cholesky`` would raise). A
    relative ridge on the Gram plus an absolute floor keep it positive
    definite in f32, also for an all-zero Y, whose singular values then
    come out exactly 0. Over ``mesh`` Y is the rank's block of rows and
    each Gram is summed over the ranks (op ``tsqr.gram``)."""
    def one(Yc):
        G = Yc.T @ Yc
        if mesh is not None:
            G = hier.hpsum(G, mesh, op="tsqr.gram")
        ell = G.shape[0]
        ridge = (1e-6 * torch.trace(G) / ell
                 + torch.finfo(G.dtype).tiny * 1e6)
        G = G + ridge * torch.eye(ell, dtype=G.dtype, device=G.device)
        L, info = torch.linalg.cholesky_ex(G)
        Qc = torch.linalg.solve_triangular(L.T, Yc, upper=True, left=False)
        return Qc, L.T, info == 0

    Q1, R1, ok1 = one(Y)
    Q2, R2, ok2 = one(Q1)
    return Q2, R2 @ R1, ok1 & ok2


def _svd(A):
    """Thin SVD of a small factor. On the card through cuSOLVER's gesvd:
    ``torch.linalg.svd``'s default CUDA driver (gesvdj, Jacobi) leaves
    float32 singular vectors orthogonal to only ~1e-3 at d = 1000
    (``chip_smoke.py`` prints both). gesvd takes m ≥ n, so a wide A is
    factored through its transpose."""
    if not A.is_cuda:
        return torch.linalg.svd(A, full_matrices=False)
    if A.shape[0] < A.shape[1]:
        V, S, Ut = torch.linalg.svd(A.T, full_matrices=False,
                                    driver="gesvd")
        return Ut.T, S, V.T
    return torch.linalg.svd(A, full_matrices=False, driver="gesvd")


def _householder(X, mesh=None):
    """Householder QR: one ``torch.linalg.qr`` on one device; over a mesh
    the JAX package's gather tree (:func:`_householder_tree`)."""
    tsqr_counts["householder"] += 1
    if mesh is None:
        return torch.linalg.qr(X, mode="reduced")
    return _householder_tree(X, mesh)


def _stacked_qr(Q, R, mesh, axis, op="tsqr.gather"):
    """One level of the tree: the R factors of every rank along ``axis``
    gathered, the QR of the stack, and the rank's Q patched with its
    slice of the small Q. Returns (Q, R)."""
    k = int(R.shape[0])
    Q2, R2 = torch.linalg.qr(hier.axis_gather(R, mesh, axis, op=op),
                             mode="reduced")
    i = mesh.coord(axis)
    return Q @ Q2[i * k:(i + 1) * k], R2


def _householder_tree(X, mesh):
    """The Householder tsqr over a mesh (the JAX ``_tsqr_householder_
    impl``): each rank's QR, then the stacked QR of the data group's R
    factors, or on a ``("pod", "chip")`` mesh of the chip group's and then
    of one factor a pod."""
    Q, R = torch.linalg.qr(X, mode="reduced")
    if mesh_lib.is_hierarchical(mesh):
        Q, R = _stacked_qr(Q, R, mesh, mesh_lib.CHIP_AXIS)
        return _stacked_qr(Q, R, mesh, mesh_lib.POD_AXIS)
    return _stacked_qr(Q, R, mesh, mesh_lib.DATA_AXIS)


def _check_f32(X):
    if X.dtype != torch.float32:
        raise ValueError(
            f"the port's linear algebra takes float32; got {X.dtype}")


def tsqr(X, mesh=None, weights=None):
    """Thin QR of a tall-skinny (n, d) float32 tensor: ``(Q (n, min(n, d)),
    R (min(n, d), d))``. CholeskyQR2 when its ``‖QᵀQ − I‖_max`` is below
    :data:`_CHOLQR_ORTHO_TOL`, else Householder; Householder at once when
    n < d. R's diagonal is positive on the fast path and of either sign on
    the fallback: only :func:`svd_flip`'d results compare across the two.
    ``weights`` zeroes the rows of weight 0. Over ``mesh`` X is this
    rank's block of the rows, Q comes back as the rank's block and R the
    same on every rank; a rank block of fewer rows than columns takes the
    Householder tree at once (module docstring)."""
    _check_f32(X)
    if weights is not None:
        X = _mask_padding_rows(X, weights)
    mesh = None if mesh is None else mesh_lib.collective_mesh(mesh)
    n, d = X.shape
    if n < d:
        return _householder(X, mesh)
    Q, R, ok = _cholesky_qr2(X, mesh)
    QtQ = Q.T @ Q
    if mesh is not None:
        QtQ = hier.hpsum(QtQ, mesh, op="tsqr.guard")
    err = torch.max(torch.abs(
        QtQ - torch.eye(d, dtype=Q.dtype, device=Q.device)))
    tsqr_counts["host_reads"] += 1
    if bool(ok & (err < _CHOLQR_ORTHO_TOL)):
        tsqr_counts["cholqr2"] += 1
        return Q, R
    return _householder(X, mesh)


def tsvd(X, mesh=None, weights=None):
    """Thin SVD through :func:`tsqr`: ``(U, S, Vt)`` with the SVD of the
    small R and ``U = Q @ U_r`` (over ``mesh``, the rank's block of U)."""
    Q, R = tsqr(X, weights=weights, mesh=mesh)
    Ur, S, Vt = _svd(R)
    return Q @ Ur, S, Vt


def svd_compressed(X, k: int, n_power_iter: int = 0, generator=None,
                   n_oversamples: int = 10, mesh=None, weights=None,
                   compute_dtype="policy", omega=None):
    """Randomized truncated SVD (Halko et al. 2009): ``(U (n, k), S (k,),
    Vt (k, d))``. The test matrix Ω (d, ℓ), ℓ = min(k + n_oversamples, d),
    is ``omega`` when given (the tests hand over the JAX package's draw),
    else standard normal from ``generator`` (default: seed 0 on X's
    device). The sketch ``X @ Ω`` and each power iteration's ``X @ W`` are
    orthonormalized by CholeskyQR2 without a guard (each round repairs the
    last), ``Xᵀ @ Q`` by Householder.

    ``compute_dtype`` is the operand dtype of every product that touches
    X (the sketch ``X @ Ω``, the power iterations, ``Qᵀ @ X``), each
    accumulated in f32; Ω is drawn in f32 and rounded to it. The default
    ``"policy"`` takes the active precision policy's ``"sketch"`` dtype
    (then its compute dtype); ``None`` follows X's dtype. X may be
    float32 or bfloat16; the repair, the small SVD and the outputs stay
    f32. Over ``mesh`` X is this rank's block of the rows and U the
    rank's block (module docstring); hand every rank the same generator
    seed or ``omega``."""
    if isinstance(compute_dtype, str) and compute_dtype == "policy":
        compute_dtype = px.resolve().compute_for("sketch")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"svd_compressed takes float32 or bfloat16 X; got {X.dtype}")
    cd = X.dtype if compute_dtype is None else px.as_dtype(compute_dtype)
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"compute_dtype={compute_dtype!r}: the sketch computes in "
            "float32 or bfloat16")
    if weights is not None:
        X = _mask_padding_rows(X, weights)
    d = int(X.shape[1])
    ell = min(int(k) + int(n_oversamples), d)
    if omega is None:
        gen = (generator if generator is not None
               else check_random_state(0, device=X.device))
        omega = torch.randn((d, ell), generator=gen, device=X.device,
                            dtype=torch.float32)
    else:
        omega = torch.as_tensor(omega, device=X.device).to(torch.float32)
        if tuple(omega.shape) != (d, ell):
            raise ValueError(
                f"omega must be ({d}, {ell}); got {tuple(omega.shape)}")
    mesh = None if mesh is None else mesh_lib.collective_mesh(mesh)

    def summed(t, op):
        return t if mesh is None else hier.hpsum(t, mesh, op=op)

    Xc = X.to(cd)
    Q, _, _ = _cholesky_qr2(px.pmatmul(Xc, omega), mesh)
    for _ in range(int(n_power_iter)):
        W, _ = torch.linalg.qr(
            summed(px.pmatmul(Xc.T, Q), "svd_compressed.xtq"),
            mode="reduced")
        Q, _, _ = _cholesky_qr2(px.pmatmul(Xc, W), mesh)
    Ub, S, Vt = _svd(summed(px.pmatmul(Q.T, Xc, compute=cd),
                            "svd_compressed.qtx"))
    U = Q @ Ub
    return U[:, :k], S[:k], Vt[:k]
