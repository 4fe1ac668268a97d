"""Learned fast-transform operator family for sketched k-means, PyTorch
port (counterpart of ``dask_ml_tpu/ops/fast_transform.py``; QuicK-means,
Giffon et al., arxiv 1908.08713).

The dense centers C (k, d) are replaced by ``C ≈ G · Wᵀ``: W is a product
of Givens butterfly sweeps interleaved with fixed lane permutations
(orthogonal by construction) and G a k-row sketch on one shared support
of p ≪ d transform columns. Because W is orthogonal,
``‖x − Wᵀg‖² = ‖Wx − g‖²``, so assignment runs over the p support columns
of the transformed data. One sweep is log₂(d_pad) levels; level ℓ pairs
lanes at stride 2^ℓ inside groups of 2·stride and rotates each pair by
its own angle.

The JAX package derives sweep r's permutation from
``jax.random.permutation(PRNGKey(r), d_pad)``, bits PyTorch cannot
reproduce. Here the permutations are explicit state of
:class:`FastTransform`: a (n_sweeps, d_pad) int64 table whose row 0 is the
identity (sweep 0 has no permutation). :func:`palm4msa_fit` draws the
table from a ``torch.Generator`` unless the caller passes one, which is
how the tests hand the port the JAX package's own permutations.

Everything here is plain PyTorch; the factor fits and applications run
at :func:`~dask_ml_tpu_torch.parallel.precision.fast_transform_dtype`
(float32 for float32 and bf16 data alike: never below f32), and the
applications cast back to the data's dtype so the staging wire is kept.
No kernel runs in this module.
"""

from __future__ import annotations

import torch


def _pad_dim(d: int) -> int:
    """Smallest power of two ≥ d (min 2): the butterfly levels need a
    power-of-two lane count; extra columns are zero-padded."""
    return max(2, 1 << (int(d) - 1).bit_length())


def _n_levels(d_pad: int) -> int:
    return d_pad.bit_length() - 1


class FastTransform:
    """A product of Givens butterfly sweeps over ``d_pad`` lanes with a
    fixed permutation in front of every sweep after the first, acting on
    row vectors: ``z = ft_apply(ft, x)`` computes ``x · Wᵀ`` level by
    level. ``angles`` is the (n_sweeps · log₂(d_pad), d_pad // 2) trainable
    array (row ℓ rotates every lane pair at stride ``2^(ℓ mod
    log₂ d_pad)``); ``perms`` the (n_sweeps, d_pad) permutation table, row
    0 the identity. ``perms`` may be None only for a transform that is
    never replayed (a model carried over from the JAX package, which
    predicts through its materialized staging slice); replaying one with
    more than one sweep raises. Tensors or numpy arrays; the functions
    below move them to the data's device."""

    def __init__(self, angles, d: int, d_pad: int, perms=None):
        self.angles = angles
        self.d = int(d)
        self.d_pad = int(d_pad)
        self.perms = perms

    @property
    def levels(self) -> int:
        return int(self.angles.shape[0])

    @property
    def n_sweeps(self) -> int:
        return self.levels // _n_levels(self.d_pad)


def identity(d: int) -> FastTransform:
    """The one-sweep zero-angle transform: ``ft_apply`` is then the exact
    identity on the first d columns (cos 0 = 1 and sin 0 = 0 exactly)."""
    dp = _pad_dim(d)
    return FastTransform(
        torch.zeros((_n_levels(dp), dp // 2), dtype=torch.float32), d, dp,
        torch.arange(dp)[None, :])


def _draw_perms(n_sweeps: int, d_pad: int, generator=None, device=None):
    """A (n_sweeps, d_pad) int64 permutation table, row 0 the identity and
    every later row a uniform random permutation from ``generator`` (on
    the generator's device when one is given)."""
    if generator is not None:
        device = generator.device
    perms = torch.empty((n_sweeps, d_pad), dtype=torch.long, device=device)
    for r in range(n_sweeps):
        perms[r] = (torch.arange(d_pad, device=device) if r == 0 else
                    torch.randperm(d_pad, generator=generator, device=device))
    return perms


def _rotate_level(Z, theta, stride: int):
    """One butterfly factor: pair lanes (i, i + stride) inside groups of
    2·stride and rotate each pair by its own angle."""
    n, dp = Z.shape
    g = dp // (2 * stride)
    Zr = Z.reshape(n, g, 2, stride)
    th = theta.reshape(1, g, stride).to(Z.dtype)
    c, s = torch.cos(th), torch.sin(th)
    a, b = Zr[:, :, 0, :], Zr[:, :, 1, :]
    return torch.stack([c * a - s * b, s * a + c * b], dim=2).reshape(n, dp)


def _tables(ft: FastTransform, device):
    angles = torch.as_tensor(ft.angles, device=device).to(torch.float32)
    if ft.n_sweeps > 1 and ft.perms is None:
        raise ValueError(
            "this FastTransform carries no permutation table (a model "
            "converted from the JAX package), so its ladder cannot be "
            "replayed; predict through its staging slice instead")
    perms = (None if ft.perms is None
             else torch.as_tensor(ft.perms, device=device).to(torch.long))
    return angles, perms


def _apply_levels(Z, angles, perms, d_pad: int, transpose: bool):
    """Shared forward/transpose ladder: the transpose of the orthogonal
    product is its inverse — the same factors with negated angles in
    reverse order and inverse permutations."""
    L = _n_levels(d_pad)
    n_sweeps = int(angles.shape[0]) // L
    if transpose:
        for r in range(n_sweeps - 1, -1, -1):
            for lvl in range(L - 1, -1, -1):
                Z = _rotate_level(Z, -angles[r * L + lvl], 1 << lvl)
            if r > 0:
                Z = Z[:, torch.argsort(perms[r])]
    else:
        for r in range(n_sweeps):
            if r > 0:
                Z = Z[:, perms[r]]
            for lvl in range(L):
                Z = _rotate_level(Z, angles[r * L + lvl], 1 << lvl)
    return Z


def _pad_cols(X, d_pad: int):
    d = X.shape[1]
    if d == d_pad:
        return X
    return torch.nn.functional.pad(X, (0, d_pad - d))


def ft_apply(ft: FastTransform, X):
    """``X (n, d) → Z (n, d_pad)``: zero-pad to the butterfly width and run
    the factor ladder at ``fast_transform_dtype`` (f32 floor), then cast
    back to X's dtype."""
    from dask_ml_tpu_torch.parallel.precision import fast_transform_dtype

    angles, perms = _tables(ft, X.device)
    ct = fast_transform_dtype(X.dtype)
    Z = _pad_cols(X, ft.d_pad).to(ct)
    return _apply_levels(Z, angles, perms, ft.d_pad,
                         transpose=False).to(X.dtype)


def ft_apply_t(ft: FastTransform, Z):
    """``Z (n, d_pad) → (n, d_pad)`` through the transpose ladder (the
    inverse: ``ft_apply_t(ft, ft_apply(ft, X))`` recovers X up to
    roundoff). Data-space rows are ``[:, :ft.d]``."""
    from dask_ml_tpu_torch.parallel.precision import fast_transform_dtype

    angles, perms = _tables(ft, Z.device)
    ct = fast_transform_dtype(Z.dtype)
    return _apply_levels(Z.to(ct), angles, perms, ft.d_pad,
                         transpose=True).to(Z.dtype)


def _top_columns(energy, p: int):
    """The p columns of largest energy, sorted ascending. Equal energies
    go to the lower index first, as ``jax.lax.top_k`` does."""
    order = torch.sort(energy, descending=True, stable=True).indices
    return torch.sort(order[:p]).values


def sketch_project(ft: FastTransform, centers, p: int):
    """The exact sketch prox for a fixed transform: transform the centers
    and keep the p columns of largest total energy. Returns ``(support
    (p,) int64 sorted distinct, vals (k, p) f32)``."""
    T = ft_apply(ft, centers.to(torch.float32))
    support = _top_columns((T * T).sum(dim=0), min(int(p), ft.d_pad))
    return support, T[:, support]


def support_matrix(ft: FastTransform, support):
    """Dense (d, p) slice ``Wᵀ[:d, support]``: ``(X − μ) @ support_matrix``
    gives the support-restricted transform coordinates in one matmul (the
    production staging path; the ladder runs once, on the identity)."""
    dev = (ft.angles.device if isinstance(ft.angles, torch.Tensor)
           else torch.device("cpu"))
    angles, perms = _tables(ft, dev)
    E = torch.eye(ft.d_pad, dtype=torch.float32, device=dev)
    Wt = _apply_levels(E, angles, perms, ft.d_pad, transpose=False)
    return Wt[:ft.d][:, torch.as_tensor(support, device=dev).to(torch.long)]


def reconstruct(ft: FastTransform, vals, support):
    """Dense data-space centers ``Ĉ = G · Wᵀ`` (k, d) from a sketch:
    scatter onto the support, run the transpose ladder, drop padding."""
    k = vals.shape[0]
    G = torch.zeros((k, ft.d_pad), dtype=torch.float32, device=vals.device)
    G[:, torch.as_tensor(support, device=vals.device).to(torch.long)] = \
        vals.to(torch.float32)
    return ft_apply_t(ft, G)[:, :ft.d]


def sketch_loss(ft: FastTransform, centers, support):
    """Squared reconstruction error of the support-restricted sketch: by
    orthogonality, the off-support column energy of the transformed
    centers."""
    T = ft_apply(ft, centers.to(torch.float32))
    keep = torch.zeros(ft.d_pad, dtype=torch.float32, device=T.device)
    keep[torch.as_tensor(support, device=T.device).to(torch.long)] = 1.0
    off = T * (1.0 - keep)[None, :]
    return (off * off).sum()


def palm4msa_fit(centers, p: int, *, n_iter: int = 8, perms=None,
                 generator=None):
    """Fit ``(transform, support, vals, loss)`` to dense centers (k, d) by
    the closed-form palm4MSA alternation of the JAX package: ``n_iter``
    permutation-interleaved Jacobi sweeps (each level's angle is the 2×2
    energy concentrator ``θ = −½·atan2(2·S_ab, S_aa − S_bb)``), the exact
    top-p prox, and a best-prefix monotone accept, so the fit never ends
    worse than the identity. ``perms`` is the (n_iter, d_pad) permutation
    table (row 0 the identity); None draws one from ``generator``.
    Returns ``(FastTransform, support (p,) int64, vals (k, p) f32, loss
    0-d f32)``. Callers should center the rows they sketch."""
    d = int(centers.shape[1])
    dp = _pad_dim(d)
    L = _n_levels(dp)
    Cp = _pad_cols(torch.as_tensor(centers).to(torch.float32), dp)
    dev = Cp.device
    k = Cp.shape[0]
    p = min(int(p), dp)
    n_sweeps = int(n_iter)
    if perms is None:
        perms = _draw_perms(n_sweeps, dp, generator=generator, device=dev)
    perms = torch.as_tensor(perms).to(device=dev, dtype=torch.long)
    if tuple(perms.shape) != (n_sweeps, dp):
        raise ValueError(f"perms must be ({n_sweeps}, {dp}); got "
                         f"{tuple(perms.shape)}")

    def off_top_energy(T):
        en = (T * T).sum(dim=0)
        return en.sum() - torch.topk(en, p).values.sum()

    T = Cp
    losses = [off_top_energy(T)]
    rows = []
    for r in range(n_sweeps):
        if r > 0:
            T = T[:, perms[r]]
        for lvl in range(L):
            stride = 1 << lvl
            g = dp // (2 * stride)
            Tr = T.reshape(k, g, 2, stride)
            a, b = Tr[:, :, 0, :], Tr[:, :, 1, :]
            Saa = (a * a).sum(dim=0)
            Sbb = (b * b).sum(dim=0)
            Sab = (a * b).sum(dim=0)
            th = (-0.5 * torch.atan2(2.0 * Sab, Saa - Sbb)).reshape(-1)
            rows.append(th)
            T = _rotate_level(T, th, stride)
        losses.append(off_top_energy(T))
    # keep the best prefix of sweeps (the first minimum: ties fall back to
    # the earlier state, ultimately the identity); clamp the f32
    # sum-minus-top-k at 0 so a tiny negative cannot steal that tie
    best = torch.argmin(torch.clamp(torch.stack(losses), min=0.0))
    if rows:
        keep = (torch.arange(n_sweeps * L, device=dev) // L) < best
        angles = torch.stack(rows) * keep[:, None].to(torch.float32)
    else:
        angles = torch.zeros((0, dp // 2), dtype=torch.float32, device=dev)
    T2 = _apply_levels(Cp, angles, perms, dp, transpose=False)
    en = (T2 * T2).sum(dim=0)
    support = _top_columns(en, p)
    vals = T2[:, support]
    loss = torch.clamp(en.sum() - en[support].sum(), min=0.0)
    return FastTransform(angles, d, dp, perms), support, vals, loss
