"""PCA over data larger than the card's memory: streamed moments
(counterpart of ``dask_ml_tpu/decomposition/streaming.py``).

One pass over row blocks accumulates the weighted count, the column sums
and the Gram matrix (4 MB at d = 1,000); an eigendecomposition of the
d × d covariance then gives the components. Peak device memory is one
block plus the Gram and its compensation term.

``block_fn`` is a callable ``block_fn(b) -> (X_b, w_b)`` making block
``b`` on the device (regenerated from a seed, or sliced from a resident
tensor), or a :class:`~dask_ml_tpu_torch.parallel.stream.HostBlockSource`
streaming host blocks, block ``b+1``'s copy overlapping block ``b``'s
Gram. Both run :func:`_accumulate_block`, so both give the same moments
from the same blocks. The Gram squares the condition number: tiny
trailing eigenvalues carry ~cond²·eps relative error; the top components
of tall-skinny data match the in-memory solver.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.precision import neumaier_add

__all__ = ["streamed_moments", "pca_fit_blocks"]

#: carry layout version of the moment pass: (sw, s, cs, G, cG)
_CARRY_V = 2


def _accumulate_block(carry, X_b, w_b):
    """One block's moment update, the single implementation of both
    block-source modes. The column sums and the Gram carry Neumaier
    compensation terms, which hold a long chain of block sums at O(eps)
    where a plain float32 running sum drifts like O(n_blocks·eps)."""
    sw, s, cs, G, cG = carry
    Xf = X_b.to(torch.float32)
    Xw = Xf * w_b[:, None]
    sw = sw + torch.sum(w_b)
    s, cs = neumaier_add(s, cs, torch.sum(Xw, dim=0))
    G, cG = neumaier_add(G, cG, Xw.T @ Xf)
    return sw, s, cs, G, cG


def _moments_init(d: int, device):
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return z(), z(d), z(d), z(d, d), z(d, d)


def _moments_finalize(carry):
    """``(sw, s, G)`` with the compensation folded in."""
    sw, s, cs, G, cG = carry
    return sw, s + cs, G + cG


def _streamed_moments_host(source, checkpoint_path=None,
                           checkpoint_every=None):
    """The pass over a ``HostBlockSource`` (depth ``source.prefetch``).
    With ``checkpoint_path`` it is preemption-safe: the carry is the
    accumulators, so a snapshot after block b resumes at block b+1 with
    bit-identical sums."""
    from dask_ml_tpu_torch.checkpoint import leaf_tensor
    from dask_ml_tpu_torch.parallel.faults import scan_checkpoint_scope
    from dask_ml_tpu_torch.parallel.stream import prefetched_scan

    d = int(source.out_struct[0].shape[1])
    transform = source.transform

    def step(carry, b, blk):
        if transform is not None:
            blk = transform(blk)
        X_b, w_b = blk
        return _accumulate_block(carry, X_b, w_b), None

    carry0, start_block = _moments_init(d, source.device), 0
    with telemetry.span("pca.streamed-moments", n_blocks=source.n_blocks,
                        d=d):
        with scan_checkpoint_scope(
                checkpoint_path,
                every=(source.n_blocks if checkpoint_every is None
                       else int(checkpoint_every)),
                bind={"what": "streamed_moments",
                      "n_blocks": source.n_blocks, "d": d,
                      "elastic": False, "carry_v": _CARRY_V}) as scan_ckpt:
            if scan_ckpt is not None:
                snap = scan_ckpt.load()
                if snap is not None:
                    carry, _outs, start_block, _epoch = snap
                    carry0 = tuple(leaf_tensor(t, source.device)
                                   for t in carry)
            carry, _ = prefetched_scan(step, carry0, source,
                                       checkpoint=scan_ckpt,
                                       start_block=start_block)
        if scan_ckpt is not None:
            scan_ckpt.delete()
        return _moments_finalize(carry)


def streamed_moments(*, block_fn, n_blocks, checkpoint_path=None,
                     checkpoint_every=None, elastic=None):
    """One pass over all blocks: ``(sw, sums, gram)`` = Σw, Σ w·x (d,),
    Σ w·xxᵀ (d, d), float32 with compensated accumulation across blocks,
    on the device. ``block_fn`` is a callable making block ``b`` on the
    device or a :class:`~dask_ml_tpu_torch.parallel.stream.HostBlockSource`.

    ``checkpoint_path`` / ``checkpoint_every`` (source mode only) make the
    pass preemption-safe: a snapshot every k blocks (default: at the end),
    a SIGTERM drains, a rerun resumes from the last complete block.
    ``elastic=`` (the multi-host tier) is not ported and raises."""
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    if elastic is not None:
        raise NotImplementedError(
            "elastic= belongs to the elastic multi-host tier, ROADMAP "
            "Queue A item 10, which the port does not have yet")
    if isinstance(block_fn, HostBlockSource):
        if block_fn.n_blocks != int(n_blocks):
            raise ValueError(
                f"n_blocks={n_blocks} does not match the HostBlockSource's "
                f"{block_fn.n_blocks} blocks")
        return _streamed_moments_host(block_fn, checkpoint_path,
                                      checkpoint_every)
    if checkpoint_path is not None:
        raise ValueError(
            "checkpoint_path= requires a HostBlockSource: a callable "
            "block_fn has no resumable scan here, as in the JAX package")
    carry = None
    with telemetry.span("pca.streamed-moments", n_blocks=int(n_blocks)):
        for b in range(int(n_blocks)):
            X_b, w_b = block_fn(b)
            if carry is None:
                carry = _moments_init(int(X_b.shape[1]), X_b.device)
            carry = _accumulate_block(carry, X_b, w_b)
            del X_b, w_b
    return _moments_finalize(carry)


def _pca_from_moments(sw, s, G):
    """Mean, eigenvalues (descending, clipped at 0) and components (rows,
    the svd_flip sign rule: each component's largest-|coefficient| entry
    is positive) of the weighted covariance."""
    mean = s / torch.clamp(sw, min=1.0)
    denom = torch.clamp(sw - 1.0, min=1.0)
    cov = (G - sw * torch.outer(mean, mean)) / denom
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    evals = torch.flip(evals, (0,))
    comps = torch.flip(evecs, (1,)).T
    idx = torch.argmax(torch.abs(comps), dim=1)
    signs = torch.sign(comps[torch.arange(comps.shape[0],
                                          device=comps.device), idx])
    comps = comps * torch.where(signs == 0, 1.0, signs)[:, None]
    return mean, torch.clamp(evals, min=0.0), comps


def pca_fit_blocks(block_fn, n_blocks, n_components, pca=None,
                   checkpoint_path=None, checkpoint_every=None,
                   elastic=None):
    """A :class:`~dask_ml_tpu_torch.decomposition.PCA` fitted from
    streamed blocks (``pca``, when given, is the estimator to fill):
    ``components_``, ``explained_variance_`` and the rest from the
    streamed covariance, usable like an in-memory fit. Checkpointing as
    in :func:`streamed_moments`."""
    from dask_ml_tpu_torch.decomposition import PCA

    sw, s, G = streamed_moments(block_fn=block_fn, n_blocks=int(n_blocks),
                                checkpoint_path=checkpoint_path,
                                checkpoint_every=checkpoint_every,
                                elastic=elastic)
    mean, evals, comps = _pca_from_moments(sw, s, G)
    mean, evals, comps, sw = (t.cpu().numpy()
                              for t in (mean, evals, comps, sw))

    n = int(round(float(sw)))
    d = comps.shape[1]
    k = int(n_components)
    est = pca if pca is not None else PCA(n_components=k)
    est.n_components_ = k
    est.n_samples_ = n
    est.n_features_ = d
    est.mean_ = mean
    est.components_ = comps[:k]
    est.explained_variance_ = evals[:k]
    total_var = float(evals.sum())
    est.explained_variance_ratio_ = est.explained_variance_ / max(
        total_var, np.finfo(np.float32).tiny)
    est.singular_values_ = np.sqrt(
        np.maximum(est.explained_variance_ * max(n - 1, 1), 0.0))
    est.noise_variance_ = float(evals[k:].mean()) if k < min(n, d) else 0.0
    return est
