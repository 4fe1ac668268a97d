"""Synthetic datasets of the PyTorch port (counterpart of
``dask_ml_tpu/datasets.py``).

The dense generators (:func:`make_blobs`, :func:`make_regression`,
:func:`make_classification`, :func:`make_counts`) draw on the configured
device (``config.device``, "cuda" by default) from one
``torch.Generator`` seeded by ``random_state`` and return tensors there:
the same seed gives the same bits, but not the JAX package's numbers
(Philox is not threefry), so they are held to the JAX tests' properties.

``mesh=`` takes a port :class:`~dask_ml_tpu_torch.parallel.mesh.Mesh`
(anything else is refused, as the JAX generators refuse what is not a
JAX mesh). The port's convention over a world of ranks is that every rank
holds the same whole input and staging takes its block of rows
(``prepare_data(mesh=)``), so every rank draws the same whole arrays on
its own device from the same seed: the bits do not depend on the world
size. ``random_state=None`` takes rank 0's fresh seed on every rank.
``make_regression(effective_rank=)`` orthonormalizes its Gaussian basis
with :func:`~dask_ml_tpu_torch.ops.linalg.tsqr` over the ranks (each
rank its block of rows, then the blocks gathered), as the JAX generator
runs its distributed tsqr.

:func:`make_sparse_classification` is the JAX package's generator, copied,
in numpy: each row draws its content from a counter-seeded chunk
(``np.random.default_rng([seed, 1, chunk_id])``), so the port rebuilds
bit for bit the rows the JAX package makes from the same seed, whatever
the blocking.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.ops.sparse import SparseRows
from dask_ml_tpu_torch.parallel.mesh import Mesh, is_sharded
from dask_ml_tpu_torch.utils.validation import check_random_state


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a dask_ml_tpu_torch.parallel.mesh.Mesh, got "
            f"{type(mesh).__name__}")


def _generator(random_state, mesh):
    """(generator, device): the configured device, or over ``mesh`` this
    rank's, and a generator seeded the same on every rank."""
    _check_mesh(mesh)
    if mesh is None:
        dev = resolve_device()
        return check_random_state(random_state, device=dev), dev
    dev = resolve_device(mesh.device)
    if mesh.distributed:
        from dask_ml_tpu_torch.decomposition.pca import shared_generator

        return shared_generator(random_state, mesh, dev), dev
    return check_random_state(random_state, device=dev), dev


def _orthonormal_rows(G, mesh):
    """Q of the thin QR of the Gaussian draw ``G`` (n, r), whole on every
    rank: over a sharded ``mesh`` each rank orthonormalizes its block with
    the ranks' :func:`~dask_ml_tpu_torch.ops.linalg.tsqr` and the blocks
    are gathered (op ``datasets.tsqr``)."""
    from dask_ml_tpu_torch.ops.linalg import tsqr

    if mesh is None or not mesh.distributed:
        return tsqr(G)[0]
    if not is_sharded(mesh):
        return tsqr(G, mesh=mesh)[0]
    from dask_ml_tpu_torch.parallel.hierarchy import gather_blocks
    from dask_ml_tpu_torch.parallel.sharding import shard_rows

    block, n = shard_rows(G, mesh, torch.float32, device=G.device)
    Q, _ = tsqr(block, mesh=mesh)
    return gather_blocks(Q, mesh, op="datasets.tsqr")[:n]


def _informative_beta(gen, dev, n_features: int, n_informative: int,
                      scale: float):
    """A coefficient vector: ``(U[0, 1) − 1) · scale`` on ``n_informative``
    random features, 0 elsewhere."""
    informative = torch.randperm(n_features, generator=gen,
                                 device=dev)[:n_informative]
    full = (torch.rand(n_features, generator=gen, device=dev) - 1.0) * scale
    beta = torch.zeros(n_features, dtype=torch.float32, device=dev)
    beta[informative] = full[informative]
    return beta


def make_blobs(
    n_samples: int = 100,
    n_features: int = 2,
    centers: Union[int, np.ndarray, None] = None,
    cluster_std: float = 1.0,
    center_box: tuple = (-10.0, 10.0),
    shuffle: bool = True,
    random_state=None,
    mesh=None,
    return_centers: bool = False,
):
    """Isotropic Gaussian blobs for clustering. Each row's cluster is
    drawn independently, so the rows need no shuffle (``shuffle`` is
    accepted for parity). Returns ``(X, y[, centers])``: float32 rows and
    int32 labels on the device."""
    gen, dev = _generator(random_state, mesh)
    if centers is None:
        centers = 3
    if isinstance(centers, (int, np.integer)):
        lo, hi = center_box
        centers_t = (torch.rand((int(centers), n_features), generator=gen,
                                device=dev) * (hi - lo) + lo)
    else:
        centers_t = torch.as_tensor(np.asarray(centers, np.float32),
                                    device=dev)
    labels = torch.randint(0, centers_t.shape[0], (n_samples,),
                           generator=gen, device=dev)
    noise = torch.randn((n_samples, n_features), generator=gen, device=dev)
    X = centers_t[labels] + cluster_std * noise
    y = labels.to(torch.int32)
    if return_centers:
        return X, y, centers_t
    return X, y


def make_regression(
    n_samples: int = 100,
    n_features: int = 100,
    n_informative: int = 10,
    n_targets: int = 1,
    bias: float = 0.0,
    effective_rank: Optional[int] = None,
    tail_strength: float = 0.5,
    noise: float = 0.0,
    shuffle: bool = True,
    coef: bool = False,
    random_state=None,
    mesh=None,
):
    """A random linear regression problem: ``y = X @ coef + bias`` (+
    Gaussian noise), ``coef`` 100·U[0, 1) on ``n_informative`` random
    features. With ``effective_rank`` the design is scikit-learn's
    ``make_low_rank_matrix``: ``X = (Q · s) @ Vᵀ``, Q an orthonormal
    (n, r) basis from the port's :func:`~dask_ml_tpu_torch.ops.linalg.
    tsqr` of a Gaussian draw, V another from a QR of a (d, r) one, and s
    the bell-curve and tail singular profile (over ``mesh``, tsqr over the
    ranks' blocks of the draw). Returns ``(X, y[, coef])`` on the
    device."""
    gen, dev = _generator(random_state, mesh)
    tshape = (n_features,) if n_targets == 1 else (n_features, n_targets)
    informative = torch.randperm(n_features, generator=gen,
                                 device=dev)[:n_informative]
    cvals = 100.0 * torch.rand((n_informative,) + tshape[1:],
                               generator=gen, device=dev)
    ground_truth = torch.zeros(tshape, dtype=torch.float32, device=dev)
    ground_truth[informative] = cvals
    if effective_rank is None:
        X = torch.randn((n_samples, n_features), generator=gen, device=dev)
    else:
        r = min(n_samples, n_features)
        Q = _orthonormal_rows(
            torch.randn((n_samples, r), generator=gen, device=dev), mesh)
        V, _ = torch.linalg.qr(torch.randn((n_features, r), generator=gen,
                                           device=dev))
        sind = torch.arange(r, dtype=torch.float32,
                            device=dev) / effective_rank
        s = ((1.0 - tail_strength) * torch.exp(-(sind ** 2))
             + tail_strength * torch.exp(-0.1 * sind))
        X = (Q * s) @ V.T
    y = X @ ground_truth + bias
    if noise > 0.0:
        y = y + noise * torch.randn(y.shape, generator=gen, device=dev)
    if coef:
        return X, y, ground_truth
    return X, y


def make_classification(
    n_samples: int = 100,
    n_features: int = 20,
    n_informative: int = 2,
    scale: float = 1.0,
    random_state=None,
    mesh=None,
    return_coef: bool = False,
):
    """Binary classification through a logistic link: Gaussian rows,
    ``y ~ Bernoulli(sigmoid(X @ beta))`` with ``beta`` on
    ``n_informative`` random features. Returns ``(X, y[, beta])`` on the
    device, ``y`` int32."""
    gen, dev = _generator(random_state, mesh)
    beta = _informative_beta(gen, dev, n_features, n_informative, scale)
    X = torch.randn((n_samples, n_features), generator=gen, device=dev)
    u = torch.rand(n_samples, generator=gen, device=dev)
    y = (u < torch.sigmoid(X @ beta)).to(torch.int32)
    if return_coef:
        return X, y, beta
    return X, y


def make_counts(
    n_samples: int = 1000,
    n_features: int = 100,
    n_informative: int = 2,
    scale: float = 1.0,
    random_state=None,
    mesh=None,
):
    """Poisson counts for GLMs: ``y ~ Poisson(exp(X @ beta))`` with
    ``beta`` on ``n_informative`` random features. Returns ``(X, y)`` on
    the device, ``y`` int32."""
    gen, dev = _generator(random_state, mesh)
    beta = _informative_beta(gen, dev, n_features, n_informative, scale)
    X = torch.randn((n_samples, n_features), generator=gen, device=dev)
    y = torch.poisson(torch.exp(X @ beta), generator=gen).to(torch.int32)
    return X, y


class SparseClassificationBlocks:
    """Block-wise view of a :func:`make_sparse_classification` problem:
    ``blocks(b)`` makes only block ``b`` as host ``(SparseRows, y, w)``;
    :meth:`materialize` writes every row into arrays allocated once.

    Row ``i`` comes from the fixed-size seeding chunk that holds it, so it
    is the same whatever the blocking, in any process."""

    #: rows per seeding chunk — the blocking-independent generation unit
    CHUNK = 4096

    def __init__(self, n_samples, n_features, k, coef, seed, n_blocks):
        self.n_samples = int(n_samples)
        self.n_features = int(n_features)
        self.k = int(k)
        self.coef = coef
        self.seed = int(seed)
        self.n_blocks = int(n_blocks)
        self.block_rows = -(-self.n_samples // self.n_blocks)

    def _chunk(self, cid: int):
        """One seeding chunk: (cols, vals, y) for rows
        ``[cid*CHUNK, min((cid+1)*CHUNK, n))``."""
        rows = min(self.CHUNK, self.n_samples - cid * self.CHUNK)
        rng = np.random.default_rng([self.seed, 1, int(cid)])
        cols = rng.integers(0, self.n_features, size=(rows, self.k),
                            dtype=np.int32)
        vals = rng.standard_normal((rows, self.k), dtype=np.float32)
        eta = (vals * self.coef[cols]).sum(axis=1)
        y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-eta))).astype(
            np.float32)
        return cols, vals, y

    def _fill(self, start: int, stop: int, vals, cols, y) -> None:
        """Write rows ``[start, stop)`` into the given arrays (row 0 of
        each array is row ``start``)."""
        for cid in range(start // self.CHUNK, -(-stop // self.CHUNK)):
            c0 = cid * self.CHUNK
            c, v, t = self._chunk(cid)
            lo, hi = max(start - c0, 0), min(stop - c0, c.shape[0])
            at = c0 + lo - start
            cols[at:at + hi - lo] = c[lo:hi]
            vals[at:at + hi - lo] = v[lo:hi]
            y[at:at + hi - lo] = t[lo:hi]

    def _rows(self, start: int, stop: int):
        n = stop - start
        vals = np.empty((n, self.k), np.float32)
        cols = np.empty((n, self.k), np.int32)
        y = np.empty(n, np.float32)
        self._fill(start, stop, vals, cols, y)
        return (SparseRows(vals, cols, self.n_features), y,
                np.ones(n, np.float32))

    def __call__(self, b: int):
        if not 0 <= b < self.n_blocks:
            raise IndexError(f"block {b} out of range [0, {self.n_blocks})")
        start = b * self.block_rows
        return self._rows(start, min(start + self.block_rows,
                                     self.n_samples))

    def materialize(self):
        """Every row as ``(SparseRows, y, w)`` in arrays allocated once:
        the host holds one copy of the container (8 GB for the 1e7 × 1e5,
        100-nonzero flagship) and no list of chunks to concatenate."""
        return self._rows(0, self.n_samples)


def make_sparse_classification(
    n_samples: int = 100,
    n_features: int = 1000,
    density: float = 0.01,
    n_informative: Optional[int] = None,
    random_state: int = 0,
    n_blocks: Optional[int] = None,
    return_coef: bool = False,
    mesh=None,
):
    """Binary classification with a sparse design: each row holds exactly
    ``k = round(density * n_features)`` nonzeros (uniform column draws,
    N(0,1) values, duplicates legal and summing), labels from a logistic
    link over a coefficient vector with ``n_informative`` (default d/10)
    nonzero entries.

    Returns ``(X, y)`` with ``X`` a host :class:`SparseRows`, or with
    ``n_blocks=`` a :class:`SparseClassificationBlocks` loader that makes
    blocks on demand. ``random_state`` must be an integer seed. ``mesh``
    (a port :class:`~dask_ml_tpu_torch.parallel.mesh.Mesh`) changes
    nothing: every rank makes the same host rows, and staging over the
    mesh (``prepare_data`` / ``shard_sparse_rows``) takes its block."""
    _check_mesh(mesh)
    if not isinstance(random_state, (int, np.integer)):
        raise TypeError(
            "make_sparse_classification requires an INTEGER random_state: "
            "blocks regenerate from counter-based seeds so any process "
            "can rebuild any block bit-identically")
    seed = int(random_state)
    d = int(n_features)
    k = max(1, int(round(float(density) * d)))
    if n_informative is None:
        n_informative = max(1, d // 10)
    rng = np.random.default_rng([seed, 0])
    idx = rng.choice(d, size=min(int(n_informative), d), replace=False)
    coef = np.zeros(d, np.float32)
    coef[idx] = rng.standard_normal(len(idx), dtype=np.float32)
    blocks = SparseClassificationBlocks(n_samples, d, k, coef, seed,
                                        n_blocks or 1)
    if n_blocks is not None:
        return (blocks, coef) if return_coef else blocks
    X, y, _ = blocks.materialize()
    return (X, y, coef) if return_coef else (X, y)
