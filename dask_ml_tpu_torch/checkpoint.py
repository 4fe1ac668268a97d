"""Checkpoint and resume of long fits in the PyTorch port (counterpart of
``dask_ml_tpu/checkpoint.py``).

- :func:`save_pytree` / :func:`load_pytree` — atomic snapshots of a tree
  of tuples, lists and dicts whose leaves are turned into numpy arrays
  first, so no torch object is pickled: a snapshot written on the card
  loads on a machine without CUDA, and in the JAX package. The file is the
  JAX package's ``DMLTCKPT1`` frame (length and sha256 of the pickled
  payload), and either package reads what the other wrote.
- :func:`solve_checkpointed` — a GLM solver run as chunks of iterations
  with its whole carry saved between chunks; a rerun at the same path
  resumes from the last chunk on the same trajectory.
  :func:`problem_fingerprint` binds a snapshot to its problem: three
  reductions per array on the device, read in one host transfer. Its
  float32 sums differ from the JAX package's, so these snapshots are bound
  to the package that wrote them (a ``ScanCheckpoint`` snapshot is not).
- :class:`CellJournal` — the search driver's append-only journal of
  finished cells, read back on a resume.

:data:`io_counts` counts snapshot saves and loads with their bytes and
wall seconds, for the smoke run's report.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Optional

import numpy as np

logger = logging.getLogger(__name__)

_SNAPSHOT_MAGIC = b"DMLTCKPT1\n"

#: snapshot saves and loads of this process: counts, bytes, wall seconds;
#: set to 0 by :func:`reset_io_counts`
io_counts = {"saves": 0, "save_bytes": 0, "save_seconds": 0.0,
             "loads": 0, "load_bytes": 0, "load_seconds": 0.0}


def reset_io_counts() -> None:
    for k in io_counts:
        io_counts[k] = 0


class CheckpointCorruptError(RuntimeError):
    """A snapshot file exists but fails its integrity check (a torn write,
    truncation, bit rot): raised instead of resuming garbage; delete the
    file to restart clean."""


# ---------------------------------------------------------------------------
# atomic snapshots
# ---------------------------------------------------------------------------


#: the tag of a bfloat16 leaf in a snapshot: numpy has no bfloat16, so
#: such a tensor is kept as ``{BF16_TAG: its uint16 bits}``
BF16_TAG = "__dml_bfloat16_bits__"


def _to_host(tree):
    """Every leaf as numpy: tensors are read to the host (one transfer
    each), Python scalars become 0-d arrays, as the JAX package's
    ``np.asarray(jax.device_get(leaf))`` makes them; a bfloat16 tensor
    becomes ``{BF16_TAG: uint16 bits}``, which :func:`leaf_tensor` turns
    back into the same bits. Tuples, lists and dicts keep their
    structure; ``None`` stays. (Solver state is at least f32 by
    ``precision.state_dtype``; the tag is for bf16 data in a tree.)"""
    import torch

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {BF16_TAG: t.view(torch.int16).numpy().view(np.uint16)}
        return t.numpy()
    return np.asarray(tree)


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Atomically write ``(tree, meta)`` to ``path``: the tree is read to
    numpy, pickled, framed, written to a temporary file in the same
    directory, fsynced, then moved over ``path`` with ``os.replace``; a
    kill mid-save leaves the previous snapshot intact."""
    from dask_ml_tpu_torch.parallel import framing

    t0 = time.perf_counter()
    payload = {"tree": _to_host(tree), "meta": meta or {}}
    body = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    frame = framing.encode_frame(body, magic=_SNAPSHOT_MAGIC)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise
    io_counts["saves"] += 1
    io_counts["save_bytes"] += len(frame)
    io_counts["save_seconds"] += time.perf_counter() - t0
    logger.info("checkpoint saved: %s (meta=%s)", path, meta)


def leaf_tensor(leaf, device):
    """A loaded snapshot leaf as a tensor of its own on ``device``: a copy,
    since the arrays of a snapshot the JAX package wrote unpickle
    read-only. A bfloat16 leaf (``{BF16_TAG: bits}``) comes back with its
    bits."""
    import torch

    if isinstance(leaf, dict) and set(leaf) == {BF16_TAG}:
        bits = np.ascontiguousarray(leaf[BF16_TAG]).view(np.int16)
        return torch.tensor(bits, device=device).view(torch.bfloat16)
    return torch.tensor(np.asarray(leaf), device=device)


def load_pytree(path: str):
    """Load a :func:`save_pytree` snapshot: ``(tree, meta)`` with numpy
    leaves, or ``None`` if the file does not exist. A snapshot cut at any
    byte or with any byte altered raises :class:`CheckpointCorruptError`.
    Unpickle only snapshots this program wrote: unpickling runs code."""
    from dask_ml_tpu_torch.parallel import framing

    if not os.path.exists(path):
        return None
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        data = f.read()
    try:
        body = framing.decode_frame(data, magic=_SNAPSHOT_MAGIC)
    except framing.FrameError as e:
        raise CheckpointCorruptError(
            f"checkpoint {path}: {e} — the snapshot is torn or corrupt; "
            "delete it to restart from scratch") from e
    payload = pickle.loads(body)
    if not (isinstance(payload, dict) and "tree" in payload
            and "meta" in payload):
        raise CheckpointCorruptError(
            f"checkpoint {path}: payload is not a snapshot (corrupt or "
            "foreign file); delete it to restart from scratch")
    io_counts["loads"] += 1
    io_counts["load_bytes"] += len(data)
    io_counts["load_seconds"] += time.perf_counter() - t0
    logger.info("checkpoint loaded: %s (meta=%s)", path, payload["meta"])
    return payload["tree"], payload["meta"]


# ---------------------------------------------------------------------------
# chunked solver driver
# ---------------------------------------------------------------------------

#: solvers whose whole optimizer carry goes through the snapshot (a resume
#: takes the identical trajectory). The others restart each chunk from the
#: latest beta: exact for Newton (its carry is beta), correct but with a
#: reset step size for gradient_descent and proximal_grad.
STATEFUL_SOLVERS = ("lbfgs", "admm", "multinomial_lbfgs",
                    "admm_multinomial")

_MULTINOMIAL = ("multinomial_lbfgs", "admm_multinomial")


def _moment_leaves(a):
    """The tensors of one fingerprinted argument: a container's two
    leaves, a tensor itself, nothing for ``None``."""
    from dask_ml_tpu_torch.ops.sparse import SparseRows

    if a is None:
        return []
    if isinstance(a, SparseRows):
        return [a.values, a.cols]
    return [a]


def _all_moments(arrays):
    """Three float32 reductions per array (sum, sum of squares, sum of
    |x| over every 7th entry of the last axis), all stacked on the device
    and read in one host transfer. No squared or upcast copy of the
    input is made."""
    import torch

    vals = []
    for a in arrays:
        for t in _moment_leaves(a):
            t = torch.as_tensor(t)
            tf = t if t.dtype == torch.float32 else t.to(torch.float32)
            vals += [tf.sum(), torch.linalg.vector_norm(tf) ** 2,
                     torch.linalg.vector_norm(tf[..., ::7], 1)]
    if not vals:
        return []
    return [float(v) for v in torch.stack(vals).cpu().numpy()]


def problem_fingerprint(solver, X, y, w, beta0, mask, **kwargs) -> str:
    """A content fingerprint binding a snapshot to its fit problem: the
    moments of :func:`_all_moments` over X, y, w, beta0 and the mask, the
    shapes and dtype, and every hyperparameter. Another dataset, weights,
    warm start or solver setting changes it with overwhelming
    probability, so a mismatched resume is refused."""
    mom = _all_moments([X, y, w, beta0, mask])
    h = hashlib.sha256()
    for part in (
        solver,
        tuple(getattr(X, "shape", ())), str(getattr(X, "dtype", "")),
        tuple(getattr(y, "shape", ())) if y is not None else None,
        *mom,
        sorted((k, repr(v)) for k, v in kwargs.items()),
    ):
        h.update(repr(part).encode())
    return h.hexdigest()[:32]


def solve_checkpointed(solver: str, X, y, w, beta0, mask, *, path: str,
                       chunk_iters: int = 50, max_iter: int = 250,
                       save_every_chunks: int = 1, n_shards: int = 1,
                       fingerprint: str = None, preloaded_snapshot=None,
                       **kwargs):
    """Run a GLM solver of :mod:`dask_ml_tpu_torch.models.glm` as
    resumable chunks of at most ``chunk_iters`` iterations, the carry
    saved to ``path`` after every ``save_every_chunks`` chunks. A snapshot
    at ``path`` for the same problem (solver and fingerprint) resumes the
    fit; one of another problem raises.

    ``n_shards`` reaches ``admm`` and ``admm_multinomial`` (the port has
    no mesh: the consensus blocks are row blocks on one device). The
    multinomial pseudo-solvers take ``beta0`` of shape (d, K) and
    ``n_classes`` in ``kwargs``.

    Returns ``(beta, total_iters)``, the iterations counted over every run
    that contributed. The stateful solvers stop on their own done flag;
    the others when a chunk uses fewer iterations than its budget. The
    snapshot is kept at the end with ``meta['converged']``; a converged
    snapshot returns its beta at once. ``fingerprint`` and
    ``preloaded_snapshot`` skip the device reductions and the file read
    when the caller has them."""
    from dask_ml_tpu_torch.models import glm as glm_core

    if solver not in glm_core.SOLVERS and solver not in _MULTINOMIAL:
        raise ValueError(f"unknown solver {solver!r}")
    if solver in ("admm", "admm_multinomial"):
        kwargs["n_shards"] = int(n_shards)
    if fingerprint is None:
        fingerprint = problem_fingerprint(solver, X, y, w, beta0, mask,
                                          **kwargs)
    dev = beta0.device

    state = None
    iters_done = 0
    beta = beta0
    snap = (preloaded_snapshot if preloaded_snapshot is not None
            else load_pytree(path))
    if snap is not None:
        tree, meta = snap
        if meta.get("solver") != solver:
            raise ValueError(
                f"checkpoint {path} was written by solver "
                f"{meta.get('solver')!r}, not {solver!r}")
        if meta.get("fingerprint") != fingerprint:
            raise ValueError(
                f"checkpoint {path} was written for a different problem "
                "(data/weights/hyperparameters changed); delete it or use "
                "a distinct path per fit")
        beta = leaf_tensor(tree["beta"], dev)
        if meta.get("converged"):
            return beta, int(meta["iters_done"])
        if tree["state"] is not None:
            state = tuple(leaf_tensor(s, dev) for s in tree["state"])
        iters_done = int(meta["iters_done"])

    stateful = solver in STATEFUL_SOLVERS

    def snapshot(converged):
        save_pytree(
            path,
            {"beta": beta, "state": state if stateful else None},
            meta={"solver": solver, "fingerprint": fingerprint,
                  "iters_done": iters_done, "converged": converged})

    chunks_since_save = 0
    while iters_done < max_iter:
        budget = min(chunk_iters, max_iter - iters_done)
        if solver == "admm":
            beta, n_it, state, converged = glm_core.admm(
                X, y, w, beta, mask, max_iter=budget, state=state,
                return_state=True, **kwargs)
        elif solver == "lbfgs":
            beta, n_it, state, converged = glm_core.lbfgs(
                X, y, w, beta, mask, max_iter=budget, state=state,
                return_state=True, **kwargs)
        elif solver == "multinomial_lbfgs":
            beta, n_it, state, converged = glm_core.multinomial_lbfgs(
                X, y, w, beta, mask, max_iter=budget, state=state,
                return_state=True, **kwargs)
        elif solver == "admm_multinomial":
            beta, n_it, state, converged = glm_core.admm_multinomial(
                X, y, w, beta, mask, max_iter=budget, state=state,
                return_state=True, **kwargs)
        else:
            # the carry-light solvers restart from beta each chunk
            beta, n_it = glm_core.solve(solver, X, y, w, beta, mask,
                                        max_iter=budget, **kwargs)
            converged = int(n_it) < budget
        iters_done += int(n_it)
        chunks_since_save += 1
        if converged or chunks_since_save >= save_every_chunks:
            snapshot(converged)
            chunks_since_save = 0
        if converged:
            return beta, iters_done
    if chunks_since_save:
        # stopped at max_iter between scheduled saves: keep the tail so a
        # resume with a larger budget does not redo it
        snapshot(False)
    return beta, iters_done


# ---------------------------------------------------------------------------
# search-cell journal
# ---------------------------------------------------------------------------


class CellJournal:
    """Append-only journal of completed (candidate, split) search cells
    (the JAX package's ``CellJournal``).

    Records are pickle frames ``(key, result)`` appended under a lock and
    fsynced; the reader consumes frames until EOF and drops a torn final
    frame (the one a kill can leave), so a resume never trips on a partial
    write. Keys are content-addressed by the search driver (estimator
    config, candidate params, the split's indices, the data's content and
    the scoring), which makes the journal self-invalidating: change any of
    them and the old records no longer match. ``n_appended`` and
    ``n_restored`` count the records written and read through this handle
    (mirrored to the ``checkpoint.cells_journaled`` /
    ``checkpoint.cells_restored`` telemetry counters).
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self.n_appended = 0
        self.n_restored = 0
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)

    def load(self) -> dict:
        done: dict = {}
        if not os.path.exists(self.path):
            return done
        with open(self.path, "rb") as f:
            while True:
                try:
                    key, result = pickle.load(f)
                except EOFError:
                    break
                except (pickle.UnpicklingError, AttributeError, ValueError,
                        IndexError):
                    logger.warning("search checkpoint %s: dropping torn "
                                   "trailing record", self.path)
                    break
                done[key] = result
        if done:
            logger.info("search checkpoint %s: restored %d completed cells",
                        self.path, len(done))
            self.n_restored += len(done)
            from dask_ml_tpu_torch.parallel import telemetry

            telemetry.counter("checkpoint.cells_restored").inc(len(done))
        return done

    def append(self, key: str, result) -> None:
        with self._lock:
            with open(self.path, "ab") as f:
                pickle.dump((key, result), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            self.n_appended += 1
        from dask_ml_tpu_torch.parallel import telemetry

        telemetry.counter("checkpoint.cells_journaled").inc()
