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
  :func:`problem_fingerprint` binds a snapshot to its problem: the JAX
  package's three reductions per array (sum, sum of squares, Σ|x| over
  every 7th entry of the last axis) on the device, read in one host
  transfer. Its float32 sums are the JAX package's where they are exact
  (integer-valued data), so either package resumes the other's snapshot
  there; on float data their last bits follow the summation order.
  Over a mesh of ranks (``mesh=``) every rank sums its block's moments
  and the partial moments are added over the ranks; only rank 0 writes
  the snapshot.
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


def _moments(t, row0: int = 0, col0: int = 0) -> list:
    """The three float32 reductions of one tensor: its sum, its sum of
    squares (a dot product: no squared copy) and Σ|x| over every 7th
    entry of the last axis counted from the global index 0 (``row0`` /
    ``col0``: this block's first row / column of that axis)."""
    import torch

    t = torch.as_tensor(t)
    tf = t if t.dtype == torch.float32 else t.to(torch.float32)
    flat = tf.reshape(-1)
    first = (-(col0 if tf.ndim > 1 else row0)) % 7
    return [tf.sum(), torch.dot(flat, flat),
            torch.linalg.vector_norm(tf[..., first::7], 1)]


def _all_moments(arrays, mesh=None, col0=None):
    """The moments of each argument as one tuple an argument (``(0.0,)``
    for ``None``), all stacked on the device and read in one host
    transfer. Over ``mesh`` the first three arguments (X, y, w) are this
    rank's block of rows, summed over the data shards (op
    ``checkpoint.fingerprint``); with ``col0`` X is the column slice from
    global column ``col0`` on, summed over ``model`` too. The rest are
    replicated."""
    import torch

    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib

    row0 = 0
    if mesh is not None and arrays[0] is not None:
        row0 = mesh_lib.data_index(mesh) * int(arrays[0].shape[0])
    parts = []
    for i, a in enumerate(arrays):
        leaves = _moment_leaves(a)
        sharded = mesh is not None and i < 3
        vals = [v for t in leaves
                for v in _moments(t, row0 if sharded else 0,
                                  (col0 or 0) if i == 0 else 0)]
        v = torch.stack(vals) if vals else None
        if v is not None and sharded:
            v = hier.hpsum(v, mesh, op="checkpoint.fingerprint")
            if i == 0 and col0 is not None:
                v = hier.mpsum(v, mesh, op="checkpoint.fingerprint")
        parts.append(v)
    present = [v for v in parts if v is not None]
    host = (torch.cat(present).cpu().numpy() if present
            else np.zeros(0, np.float32))
    out, at = [], 0
    for v in parts:
        if v is None:
            out.append((0.0,))
        else:
            out.append(tuple(float(x) for x in host[at:at + v.numel()]))
            at += v.numel()
    return out


def problem_fingerprint(solver, X, y, w, beta0, mask, mesh=None,
                        **kwargs) -> str:
    """A content fingerprint binding a snapshot to its fit problem: the
    moments of :func:`_all_moments` over X, y, w, beta0 and the mask, the
    shapes and dtype, and every hyperparameter. Another dataset, weights,
    warm start or solver setting changes it with overwhelming
    probability, so a mismatched resume is refused.

    Over a ``mesh`` of ranks the arguments are this rank's blocks of the
    problem as staged (padding included): the moments are summed over the
    ranks and the shapes are the whole problem's, so every rank gets the
    fingerprint of the whole staged problem, which is the JAX package's
    on the matching mesh where the sums are exact."""
    from dask_ml_tpu_torch.ops.sparse import SparseRows
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib

    mesh = None if mesh is None else mesh_lib.collective_mesh(mesh)
    x_shape = tuple(getattr(X, "shape", ()))
    y_shape = tuple(getattr(y, "shape", ())) if y is not None else None
    col0 = None
    if mesh is not None:
        S = mesh_lib.n_data_shards(mesh)
        x_shape = (x_shape[0] * S,) + x_shape[1:]
        if y_shape is not None:
            y_shape = (y_shape[0] * S,) + y_shape[1:]
        if not isinstance(X, SparseRows) and x_shape[1] != beta0.shape[0]:
            # a dense column slice (the tensor-parallel staging)
            col0 = mesh_lib.model_index(mesh) * x_shape[1]
            x_shape = (x_shape[0], int(beta0.shape[0]))
    mom = _all_moments([X, y, w, beta0, mask], mesh, col0)
    h = hashlib.sha256()
    for part in (
        solver,
        x_shape, str(getattr(X, "dtype", "")).replace("torch.", ""),
        y_shape,
        *mom,
        sorted((k, repr(v)) for k, v in kwargs.items()),
    ):
        h.update(repr(part).encode())
    return h.hexdigest()[:32]


def _is_writer(mesh) -> bool:
    """Whether this process writes the snapshot: always on one device,
    global rank 0 over a mesh."""
    return mesh is None or mesh.rank == int(mesh.devices.reshape(-1)[0])


def _wait_for_writer(mesh, device) -> None:
    """Every rank waits until the writer has saved: one
    :func:`~dask_ml_tpu_torch.parallel.hierarchy.hpsum` of one word over
    the mesh (op ``checkpoint.barrier``), read on the host."""
    if mesh is None:
        return
    import torch

    from dask_ml_tpu_torch.parallel import hierarchy as hier

    flag = torch.ones((), dtype=torch.float32, device=device)
    float(hier.hpsum(flag, mesh, op="checkpoint.barrier"))


def solve_checkpointed(solver: str, X, y, w, beta0, mask, mesh=None, *,
                       path: str, chunk_iters: int = 50, max_iter: int = 250,
                       save_every_chunks: int = 1, n_shards: int = 1,
                       fingerprint: str = None, preloaded_snapshot=None,
                       **kwargs):
    """Run a GLM solver of :mod:`dask_ml_tpu_torch.models.glm` as
    resumable chunks of at most ``chunk_iters`` iterations, the carry
    saved to ``path`` after every ``save_every_chunks`` chunks. A snapshot
    at ``path`` for the same problem (solver and fingerprint) resumes the
    fit; one of another problem raises.

    ``n_shards`` reaches ``admm`` and ``admm_multinomial`` on one device
    (the consensus blocks are row blocks there). Over a ``mesh`` of ranks
    X, y and w are this rank's blocks, every solver runs over the mesh,
    the ADMM carry is saved in the JAX layout (x and u stacked over every
    data shard) and a resume hands each rank its row, so either package
    resumes the other's snapshot; only global rank 0 writes, and every
    rank waits at a barrier until it has. The multinomial pseudo-solvers
    take ``beta0`` of shape (d, K) and ``n_classes`` in ``kwargs``.

    Returns ``(beta, total_iters)``, the iterations counted over every run
    that contributed. The stateful solvers stop on their own done flag;
    the others when a chunk uses fewer iterations than its budget. The
    snapshot is kept at the end with ``meta['converged']``; a converged
    snapshot returns its beta at once. ``fingerprint`` and
    ``preloaded_snapshot`` skip the device reductions and the file read
    when the caller has them."""
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib

    if solver not in glm_core.SOLVERS and solver not in _MULTINOMIAL:
        raise ValueError(f"unknown solver {solver!r}")
    mesh = None if mesh is None else mesh_lib.collective_mesh(mesh)
    if solver in ("admm", "admm_multinomial") and mesh is None:
        kwargs["n_shards"] = int(n_shards)
    if fingerprint is None:
        fingerprint = problem_fingerprint(solver, X, y, w, beta0, mask,
                                          mesh=mesh, **kwargs)
    if mesh is not None:
        kwargs["mesh"] = mesh
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
        if _is_writer(mesh):
            save_pytree(
                path,
                {"beta": beta, "state": state if stateful else None},
                meta={"solver": solver, "fingerprint": fingerprint,
                      "iters_done": iters_done, "converged": converged})
        _wait_for_writer(mesh, dev)

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
