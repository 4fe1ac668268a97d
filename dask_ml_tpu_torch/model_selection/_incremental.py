"""Successive halving and Hyperband over ``partial_fit`` estimators, in
the PyTorch port (counterpart of
``dask_ml_tpu/model_selection/_incremental.py``).

The grid and random search (``_search.py``) fits every candidate to
the end. This module spends the budget on survivors:

- **rungs are epochs over seeded blocks**: the training rows are split
  once into ``n_blocks`` equal blocks; a rung advances every surviving
  candidate ``partial_fit``-wise through its epochs, each epoch visiting
  the blocks in a :class:`~dask_ml_tpu_torch.parallel.elastic.BlockPlan`
  order, a pure function of (seed, epoch): the JAX package's order.
- **promotion is host arithmetic over journaled scores**: each
  (candidate, rung) result, the holdout score and the candidate's
  estimator pickled with its state on the host, is one content-addressed
  :class:`~dask_ml_tpu_torch.checkpoint.CellJournal` record. The top
  ``1/aggressiveness`` by (score, lowest id) go on with ``aggressiveness``
  times the epochs. A rung is a pure function of (the previous record,
  the seeded epoch orders), so a search resumed from the journal
  repeats the remaining rungs bit for bit, and a journal written on the
  card resumes on the CPU and the other way round.
- **one batched rung a bracket**: when every candidate of a bracket is
  the same streaming GLM at other (``C``, ``eta0``, ``power_t``), the
  rung runs all of them at once through
  :func:`dask_ml_tpu_torch.models.glm.get_batched_sgd_epoch`, with
  per-member hyperparameter tensors and an alive-mask: the blocks are
  staged on the device once a fit as one ``(n_blocks, rows, width)``
  stack, a promotion changes the mask and never a shape, nothing inside
  the rung reads the host (:func:`batched_rung`), and the rung's scores
  and states come back in one copy. Other estimators (``MiniBatchKMeans``)
  run one ``partial_fit`` a block a candidate.
- **multi-host**: with ``elastic=`` an
  :class:`~dask_ml_tpu_torch.parallel.elastic.ElasticRun`, a rung's
  candidates become the blocks of an elastic epoch: each host computes its
  contiguous share, publishes each record atomically, and
  ``collect_epoch`` re-deals the candidates of dead hosts (and, with
  ``speculate_after``, of slow ones). A candidate's rung is a pure
  function of its previous record and the seeds, so whichever host
  computes it publishes the same bytes: a host killed mid-bracket drops no
  candidate and changes no bit.

Deviations from the JAX package:

- The JAX rungs record their XLA compiles (``track_compiles``); the port
  compiles nothing at run time but its CUDA kernels, so
  ``rung_compile_stats_`` records each rung's ``nvcc`` builds
  (``_kernels.build.builds``, 0 after a bracket's first rung on a warm
  process) and its kernel launches (``_kernels.launches``).
- The report appends ``telemetry.render_counters()`` (the port's
  telemetry keeps counters and profiler ranges, no span ring).

Timeouts differ from the synchronous search's by design: a candidate
whose rung exceeds ``cell_timeout`` keeps its last completed rung's
score and is stopped; the timed-out rung is never journaled.
"""

from __future__ import annotations

import io
import logging
import pickle
import time
from typing import Optional

import numpy as np
import torch

from dask_ml_tpu_torch import config as config_lib
from dask_ml_tpu_torch.base import BaseEstimator, clone
from dask_ml_tpu_torch.model_selection._params import (
    ParameterGrid,
    ParameterSampler,
)
from dask_ml_tpu_torch.model_selection._search import (
    _content_array,
    _index,
    _n_rows,
    _scoring_identity,
    run_with_soft_deadline,
)
from dask_ml_tpu_torch.model_selection._tokenize import tokenize
from dask_ml_tpu_torch.parallel import telemetry

logger = logging.getLogger(__name__)

__all__ = ["SuccessiveHalvingSearchCV", "HyperbandSearchCV",
           "bracket_rungs", "hyperband_brackets", "batched_rung"]


# ---------------------------------------------------------------------------
# bracket arithmetic (pure, host-side)
# ---------------------------------------------------------------------------


def bracket_rungs(n0: int, r0: int, eta: int,
                  max_epochs: Optional[int] = None) -> list:
    """The successive-halving schedule of one bracket:
    ``[(rung, n_alive, cumulative_epochs)]``.

    Rung k holds ``n_k`` candidates trained to ``r_k`` epochs in all;
    promotion keeps ``max(1, n_k // eta)`` of them and multiplies the
    budget by ``eta`` (capped at ``max_epochs``). With ``max_epochs``
    set, a lone survivor still trains on to the cap; without it the
    bracket ends at the first rung a single candidate survives.
    """
    eta = int(eta)
    if eta < 2:
        raise ValueError(f"aggressiveness must be >= 2, got {eta}")
    cap = None if max_epochs is None else int(max_epochs)
    n, r, k = int(n0), int(r0), 0
    if cap is not None:
        r = min(r, cap)
    out = []
    while True:
        out.append((k, n, r))
        if (n == 1 and (cap is None or r >= cap)) or (
                cap is not None and r >= cap):
            return out
        n = max(1, n // eta)
        r = r * eta if cap is None else min(r * eta, cap)
        k += 1


def hyperband_brackets(max_epochs: int, eta: int) -> list:
    """The Hyperband bracket set ``[(s, n0, r0)]``, most exploratory
    first: ``s_max = floor(log_eta(max_epochs))`` brackets trading
    initial candidates against initial epochs at about equal total
    budget (Li et al., arxiv 1603.06560)."""
    eta = int(eta)
    R = int(max_epochs)
    if eta < 2:
        raise ValueError(f"aggressiveness must be >= 2, got {eta}")
    if R < 1:
        raise ValueError(f"max_epochs must be >= 1, got {R}")
    s_max = int(np.floor(np.log(R) / np.log(eta)))
    out = []
    for s in range(s_max, -1, -1):
        n0 = int(np.ceil((s_max + 1) / (s + 1) * eta ** s))
        r0 = max(1, int(R * eta ** -s))
        out.append((s, n0, r0))
    return out


class _RungTimeout(Exception):
    """Internal: a candidate's rung exceeded the soft deadline."""

    def __init__(self, cid: int):
        super().__init__(f"candidate {cid} rung timed out")
        self.cid = cid


def _record_to_tree(rec: Optional[dict]) -> dict:
    """A rung record as a numpy tree for elastic publication. ``None`` (a
    timed-out candidate) publishes a sentinel, so no host's rung waits on
    a candidate already degraded."""
    if rec is None:
        return {"timeout": np.int64(1)}
    return {
        "score": np.float64(rec["score"]),
        "blob": np.frombuffer(rec["blob"], dtype=np.uint8).copy(),
        "n_epochs": np.int64(rec["n_epochs"]),
        "pf_calls": np.int64(rec["pf_calls"]),
        "fit_seconds": np.float64(rec["fit_seconds"]),
        "score_seconds": np.float64(rec["score_seconds"]),
    }


def _tree_to_record(tree: dict) -> Optional[dict]:
    if "timeout" in tree:
        return None
    return {
        "score": float(tree["score"]),
        "blob": np.asarray(tree["blob"], dtype=np.uint8).tobytes(),
        "n_epochs": int(tree["n_epochs"]),
        "pf_calls": int(tree["pf_calls"]),
        "fit_seconds": float(tree["fit_seconds"]),
        "score_seconds": float(tree["score_seconds"]),
    }


class _HostPickler(pickle.Pickler):
    """Pickles every tensor from the host, so a record written on the card
    unpickles where there is none."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return torch.as_tensor, (obj.detach().cpu(),)
        return NotImplemented


def _host_pickle(obj) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _kernel_counts():
    """(nvcc builds so far, launches by kernel) of this process."""
    from dask_ml_tpu_torch import _kernels
    from dask_ml_tpu_torch._kernels import build

    return build.builds["nvcc"], dict(_kernels.launches)


# ---------------------------------------------------------------------------
# the batched rung (device work only)
# ---------------------------------------------------------------------------


def _stage_batched(Xb, yb, X_val, y_val, fit_intercept: bool, dev) -> dict:
    """The blocks as one ``(n_blocks, rows, width)`` stack on ``dev`` (the
    intercept column appended there), their encoded targets, unit
    weights and the encoded holdout: staged once a fit."""
    Xt = torch.as_tensor(Xb).to(device=dev, dtype=torch.float32)
    Ev = torch.as_tensor(X_val).to(device=dev, dtype=torch.float32)
    if fit_intercept:
        Xt = torch.cat([Xt, Xt.new_ones(Xt.shape[:2] + (1,))], dim=2)
        Ev = torch.cat([Ev, Ev.new_ones((Ev.shape[0], 1))], dim=1)
    yt = torch.as_tensor(np.asarray(yb, np.float32), device=dev)
    yv = torch.as_tensor(np.asarray(y_val, np.float32), device=dev)
    return {"Xb": Xt.contiguous(), "yb": yt, "wb": torch.ones_like(yt),
            "Ev": Ev.contiguous(), "yv": yv, "wv": torch.ones_like(yv),
            "width": int(Xt.shape[2])}


def batched_rung(epoch_fn, stage: dict, betas, ts, lam, eta0, power_t,
                 live, orders, family: str):
    """One bracket's rung on the device: every member through the epochs
    whose block orders are ``orders`` (host lists), then every member's
    holdout score. Members with ``live`` False keep their state. Nothing
    here reads the host. Returns one ``(M, width + 2)`` tensor: the
    score, the coefficients and the step count of each member, which the
    caller copies to the host at once."""
    from dask_ml_tpu_torch.models import glm as glm_core

    for order in orders:
        betas, ts = epoch_fn(betas, ts, lam, eta0, power_t, live,
                             stage["Xb"], stage["yb"], stage["wb"], order)
    scores = glm_core.batched_eval_scores(
        stage["Ev"], stage["yv"], stage["wv"], betas, family=family)
    return torch.cat([scores[:, None], betas, ts[:, None]], dim=1)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


class BaseIncrementalSearchCV(BaseEstimator):
    """Shared machinery of the incremental (``partial_fit``) searches;
    subclasses define the bracket set (:meth:`_brackets`) and their
    constructor surface. See the module docstring."""

    # -- subclass surface -------------------------------------------------

    def _brackets(self) -> list:
        raise NotImplementedError  # pragma: no cover - abstract

    def _draw_candidates(self, bracket: int, n0: int) -> list:
        """The bracket's parameter draw: the full grid when
        ``n_initial_parameters='grid'``, else a seeded
        ``ParameterSampler`` draw (a seed a bracket, so Hyperband's
        brackets explore different points)."""
        if getattr(self, "n_initial_parameters", None) == "grid":
            return list(ParameterGrid(self.parameters))
        return list(ParameterSampler(
            self.parameters, n0,
            random_state=int(self.random_state) + 1000 * int(bracket)))

    # -- scoring ----------------------------------------------------------

    def _score_estimator(self, est, X_val, y_val) -> float:
        if callable(self.scoring):
            return float(self.scoring(est, X_val, y_val))
        if self.scoring not in (None, "passthrough"):
            raise ValueError(
                "incremental search supports scoring=None (the "
                "estimator's own score) or a callable(est, X, y); got "
                f"{self.scoring!r}")
        if y_val is None:
            return float(est.score(X_val))
        return float(est.score(X_val, y_val))

    # -- batched path (one rung a bracket) ----------------------------------

    def _plan_batched(self, est, params_list, X, y_train, classes):
        """The batched rung's plan, or ``None`` (one ``partial_fit`` a
        block a candidate) unless every candidate of the bracket is the
        same dense streaming GLM at other (lamduh, eta0, power_t): the
        only settings :func:`batched_rung` takes per member."""
        from dask_ml_tpu_torch.parallel.sharding import is_sparse_input

        if not getattr(self, "batched_rungs", True):
            return None
        if self.scoring not in (None, "passthrough"):
            return None
        if not hasattr(est, "_sgd_config"):
            return None
        if getattr(est, "family", None) not in ("logistic", "normal"):
            return None
        if y_train is None or is_sparse_input(X):
            return None
        cfgs = []
        for p in params_list:
            if not set(p) <= {"C", "solver_kwargs"}:
                return None
            sk = p.get("solver_kwargs")
            if sk is not None and not set(sk) <= {"eta0", "power_t"}:
                return None
            try:
                cfgs.append(clone(est).set_params(**p)._sgd_config())
            except (TypeError, ValueError, ZeroDivisionError):
                return None
        base = [(c["family"], c["regularizer"], c["fit_intercept"],
                 c.get("n_classes")) for c in cfgs]
        if len(set(base)) != 1 or base[0][3] is not None:
            return None
        # the encoding reference: pins the class set (binary only: the
        # softmax stream state is (width, K), outside the batched rung)
        # and owns _encode_eval_y for the holdout
        ref = clone(est)
        try:
            y_enc = ref._encode_y_partial(np.asarray(y_train), classes)
        except ValueError:
            return None
        if len(getattr(ref, "_pf_classes", [0, 1])) > 2:
            return None
        fam, reg, fi, _ = base[0]
        return {"ref": ref, "y_enc": y_enc,
                "lam": np.asarray([c["lamduh"] for c in cfgs], np.float32),
                "eta0": np.asarray([c["eta0"] for c in cfgs], np.float32),
                "power_t": np.asarray([c["power_t"] for c in cfgs],
                                      np.float32),
                "family": fam, "regularizer": reg,
                "fit_intercept": bool(fi)}

    # -- fit --------------------------------------------------------------

    def fit(self, X, y=None, classes=None, **fit_params):
        if fit_params:
            raise ValueError(
                "incremental search streams raw blocks through "
                f"partial_fit; fit_params {sorted(fit_params)} are not "
                "supported")
        from dask_ml_tpu_torch.parallel.elastic import BlockPlan

        t_fit0 = time.time()
        est = self.estimator
        eta = int(self.aggressiveness)
        if eta < 2:
            raise ValueError(
                f"aggressiveness must be >= 2, got {self.aggressiveness}")
        caller_cfg = dict(config_lib.get_config())
        run = self.elastic

        # -- seeded holdout split and block partition ---------------------
        n = _n_rows(X)
        rng = np.random.RandomState(self.random_state)
        perm = rng.permutation(n)
        n_test = max(1, int(round(float(self.test_size) * n)))
        if n_test >= n:
            raise ValueError(
                f"test_size={self.test_size} leaves no training rows "
                f"(n={n})")
        test_idx = np.sort(perm[:n_test])
        train_pool = perm[n_test:]
        n_blocks = max(1, min(int(self.n_blocks), len(train_pool)))
        n_used = (len(train_pool) // n_blocks) * n_blocks
        train_idx = train_pool[:n_used]  # tail trim: equal block shapes
        block_rows = np.split(train_idx, n_blocks)
        data_plan = BlockPlan(n_blocks, seed=int(self.shuffle_seed),
                              shuffle=True)
        blocks: dict = {}  # the generic path's blocks, cut on first use

        def block(b):
            if b not in blocks:
                blocks[b] = (_index(X, block_rows[b]),
                             None if y is None else _index(y, block_rows[b]))
            return blocks[b]

        y_train = None if y is None else _index(y, train_idx)
        X_val = _index(X, test_idx)
        y_val = None if y is None else _index(y, test_idx)

        # -- brackets and candidates --------------------------------------
        brackets = self._brackets()
        cand_params: list = []      # cid -> params dict
        cand_bracket: list = []     # cid -> bracket id s
        cand_model_id: list = []
        bracket_cids: dict = {}     # s -> [cid]
        for s, n0, _r0 in brackets:
            cids = []
            for i, p in enumerate(self._draw_candidates(s, n0)):
                cid = len(cand_params)
                cand_params.append(p)
                cand_bracket.append(s)
                cand_model_id.append(f"bracket={s}-{i}")
                cids.append(cid)
            bracket_cids[s] = cids

        # -- journal (content-addressed resume) ---------------------------
        journal = None
        done: dict = {}
        scoring_id = _scoring_identity(self.scoring)
        if self.checkpoint:
            from dask_ml_tpu_torch.checkpoint import CellJournal

            # one journal a rank under a roster: processes must not
            # interleave appends in one file, and a host's own journal is
            # enough to resume it (the published blocks cover the rest)
            path = (f"{self.checkpoint}.r{run.rank}" if run is not None
                    else self.checkpoint)
            journal = CellJournal(path)
            done = journal.load()
        est_token = tokenize(
            type(est), est.get_params(deep=True), _content_array(X),
            _content_array(y), classes if classes is None
            else _content_array(classes))

        def rung_key(cid, rung, cum):
            return tokenize(
                "rung", est_token, cand_params[cid], cand_bracket[cid],
                rung, cum, n_blocks, int(self.shuffle_seed), scoring_id,
                _content_array(test_idx))

        if run is not None:
            run.bind_problem(
                "asha", token=est_token, grid=tokenize(cand_params),
                eta=eta, n_blocks=n_blocks, seed=int(self.shuffle_seed),
                scoring=scoring_id)
        elastic_before = ((run.blocks_rebalanced, run.blocks_speculated)
                          if run is not None else (0, 0))

        # -- fit-wide state -----------------------------------------------
        records: dict = {}      # cid -> latest completed-rung record
        cand_rung: dict = {}    # cid -> last completed rung index
        cand_status: dict = {}
        history: list = []
        rung_table: list = []
        self.n_rungs_completed_ = 0
        self.n_promotions_ = 0
        self.n_candidates_stopped_ = 0
        self.n_rung_timeouts_ = 0
        self.n_rung_retries_ = 0
        self.n_resumed_rungs_ = 0
        self.n_plateau_stops_ = 0
        self.rung_compile_stats_ = []
        budget_spent = 0

        # plateau stop (patience): a candidate whose journaled rung scores
        # improve by less than tol for `patience` scored rungs in a row
        # stops, even where its rank would promote it
        patience_n = getattr(self, "patience", None)
        patience_n = None if patience_n is None else int(patience_n)
        if patience_n is not None and patience_n < 1:
            raise ValueError(f"patience must be >= 1, got {patience_n}")
        plateau_tol = float(getattr(self, "tol", 1e-3) or 0.0)
        plateau_best: dict = {}    # cid -> best score seen (ratchet)
        plateau_streak: dict = {}  # cid -> consecutive sub-tol rungs

        cap = getattr(self, "max_epochs", None)
        cap = None if cap is None else int(cap)
        deepest = 0

        # one batched plan a bracket (its width is the bracket's n0: a
        # promotion changes the alive-mask, never a shape); the device
        # stack is staged once and shared by every bracket
        bplans: dict = {}
        bstage: dict = {}

        def batched_stage(bplan):
            if not bstage:
                rows = train_idx.reshape(n_blocks, -1)
                if isinstance(X, torch.Tensor):
                    Xb = X[torch.as_tensor(rows, device=X.device)]
                    Ev = X[torch.as_tensor(test_idx, device=X.device)]
                else:
                    Xb, Ev = np.asarray(X)[rows], np.asarray(X_val)
                bstage.update(_stage_batched(
                    Xb, np.asarray(bplan["y_enc"]).reshape(n_blocks, -1),
                    Ev, bplan["ref"]._encode_eval_y(np.asarray(y_val)),
                    bplan["fit_intercept"], config_lib.resolve_device()))
            return bstage

        def train_generic_one(cid, prev_cum, cum):
            """One candidate's rung: restore (or build) the estimator,
            stream (cum - prev_cum) seeded epochs of partial_fit blocks,
            score on the holdout. Pure in (previous record, epoch
            seeds)."""
            prev = records.get(cid)
            t0 = time.time()
            if prev is None:
                m = clone(est).set_params(**cand_params[cid])
            else:
                m = pickle.loads(prev["blob"])
            calls = 0
            for e in range(prev_cum, cum):
                for b in data_plan.epoch_order(e):
                    Xb_, yb_ = block(b)
                    if yb_ is None:
                        m.partial_fit(Xb_)
                    elif classes is not None:
                        m.partial_fit(Xb_, yb_, classes=classes)
                    else:
                        m.partial_fit(Xb_, yb_)
                    calls += 1
            t1 = time.time()
            score = self._score_estimator(m, X_val, y_val)
            return {
                "score": score, "blob": _host_pickle(m),
                "n_epochs": cum,
                "pf_calls": (0 if prev is None else prev["pf_calls"])
                + calls,
                "fit_seconds": t1 - t0, "score_seconds": time.time() - t1,
            }

        def train_batched_all(s, bplan, need, prev_cum, cum):
            """The whole bracket's rung as one batched run: stacked (M,
            width) states advance through the seeded epochs with per-member
            hyperparameters and an alive-mask, every lane is scored on
            the holdout, and one copy brings scores and states back;
            estimators are built only for ``need``."""
            from dask_ml_tpu_torch.models import glm as glm_core

            stage = batched_stage(bplan)
            dev = stage["Xb"].device
            cids = bracket_cids[s]
            M, width = len(cids), stage["width"]
            betas = np.zeros((M, width), np.float32)
            ts = np.zeros((M,), np.float32)
            live = np.zeros((M,), bool)
            for j, cid in enumerate(cids):
                live[j] = cid in need
                prev = records.get(cid)
                if prev is not None:
                    beta, t = pickle.loads(prev["blob"])._pf_state
                    betas[j], ts[j] = beta, t
            t0 = time.time()
            ep_fn = glm_core.get_batched_sgd_epoch(
                bplan["family"], bplan["regularizer"],
                bplan["fit_intercept"])

            def dev_t(a):
                return torch.as_tensor(a, device=dev)

            packed = batched_rung(
                ep_fn, stage, dev_t(betas), dev_t(ts), dev_t(bplan["lam"]),
                dev_t(bplan["eta0"]), dev_t(bplan["power_t"]),
                dev_t(live), [data_plan.epoch_order(e)
                              for e in range(prev_cum, cum)],
                bplan["family"]).cpu().numpy()
            t1 = time.time()
            scores, nb, nt = packed[:, 0], packed[:, 1:-1], packed[:, -1]
            n_need = max(len(need), 1)
            out = {}
            pf = getattr(bplan["ref"], "_pf_classes", None)
            for j, cid in enumerate(cids):
                if cid not in need:
                    continue
                m = clone(est).set_params(**cand_params[cid])
                if pf is not None:
                    m._pf_classes = np.asarray(pf)
                    m.classes_ = np.asarray(pf)
                m._store_pf_state((torch.from_numpy(nb[j].copy()),
                                   float(nt[j])))
                prev = records.get(cid)
                out[cid] = {
                    "score": float(scores[j]), "blob": _host_pickle(m),
                    "n_epochs": cum,
                    "pf_calls": (0 if prev is None else prev["pf_calls"])
                    + (cum - prev_cum) * n_blocks,
                    # the run's device time and its one copy, shared out
                    "fit_seconds": (t1 - t0) / n_need,
                    "score_seconds": 0.0,
                }
            return out

        def run_rung(s, rung, uid, alive, prev_cum, cum):
            """Compute or restore every alive candidate's rung record:
            ``{cid: record}``, a timed-out candidate mapping to None."""
            keys = {cid: rung_key(cid, rung, cum) for cid in alive}
            restored = {cid: done[k] for cid, k in keys.items()
                        if k in done}
            self.n_resumed_rungs_ += len(restored)
            need = [cid for cid in alive if cid not in restored]
            bplan = bplans.get(s)
            bmemo: dict = {}

            def make_record(cid):
                """One candidate's record: the unit the elastic plane
                deals, and the local path's too. A batched bracket trains
                every needed candidate at its first call."""
                if cid in restored:
                    return restored[cid]
                if bplan is not None:
                    if not bmemo:
                        bmemo.update(train_batched_all(
                            s, bplan, set(need), prev_cum, cum))
                    return bmemo[cid]
                return self._generic_with_retries(
                    lambda: train_generic_one(cid, prev_cum, cum),
                    caller_cfg, f"asha-rung-{s}-{rung}-{cid}", cid, rung)

            if run is None:
                results = {}
                for cid in alive:
                    try:
                        results[cid] = make_record(cid)
                    except _RungTimeout:
                        results[cid] = None
            else:
                results = self._rung_elastic(run, uid, list(alive),
                                             make_record)
            if journal is not None:
                for cid in alive:
                    rec = results.get(cid)
                    k = keys[cid]
                    # timeouts are never journaled: a resume retries them
                    if rec is not None and k not in done:
                        journal.append(k, rec)
                        done[k] = rec
            return results

        # -- bracket loop -------------------------------------------------
        for s, n0, r0 in brackets:
            cids0 = bracket_cids[s]
            bplan = self._plan_batched(
                est, [cand_params[c] for c in cids0], X, y_train, classes)
            if bplan is not None:
                bplans[s] = bplan
            alive = list(cids0)
            for cid in alive:
                cand_status[cid] = "running"
            rung, prev_cum = 0, 0
            cum = r0 if cap is None else min(r0, cap)
            with telemetry.span("search.bracket", bracket=s,
                                candidates=n0, r0=r0):
                while True:
                    uid = 1000 * (s + 1) + rung
                    builds0, launches0 = _kernel_counts()
                    with telemetry.span("search.rung", bracket=s,
                                        rung=rung, candidates=len(alive)):
                        results = run_rung(s, rung, uid, alive, prev_cum,
                                           cum)
                    builds1, launches1 = _kernel_counts()
                    self.rung_compile_stats_.append({
                        "bracket": s, "rung": rung,
                        "candidates": len(alive),
                        "n_builds": builds1 - builds0,
                        "launches": {k: v - launches0.get(k, 0)
                                     for k, v in launches1.items()
                                     if v != launches0.get(k, 0)},
                    })
                    self.n_rungs_completed_ += 1
                    telemetry.counter("search.rungs_completed").inc()
                    budget_spent += (cum - prev_cum) * len(alive)
                    deepest = max(deepest, cum)
                    timeouts = [cid for cid in alive
                                if results.get(cid) is None]
                    for cid in timeouts:
                        # degrade, don't delete: the candidate keeps its
                        # last completed rung's score
                        self.n_rung_timeouts_ += 1
                        telemetry.counter("search.rung_timeouts").inc()
                        cand_status[cid] = "stopped (rung timeout)"
                        logger.warning(
                            "asha: candidate %d timed out at bracket %d "
                            "rung %d; keeping its rung-%d score", cid, s,
                            rung, rung - 1)
                    survivors = [cid for cid in alive
                                 if results.get(cid) is not None]
                    for cid in survivors:
                        records[cid] = results[cid]
                        cand_rung[cid] = rung
                        history.append({
                            "model_id": cand_model_id[cid],
                            "bracket": s, "rung": rung,
                            "n_epochs": cum,
                            "score": results[cid]["score"],
                            "partial_fit_calls": results[cid]["pf_calls"],
                            "elapsed_wall_time": time.time() - t_fit0,
                        })
                    survivors.sort(
                        key=lambda cid: (-records[cid]["score"], cid))
                    final = (len(survivors) <= 1
                             and (cap is None or cum >= cap)) or (
                                 cap is not None and cum >= cap)
                    plateaued: list = []
                    if patience_n is not None and not final:
                        keep = []
                        for cid in survivors:
                            sc = records[cid]["score"]
                            best = plateau_best.get(cid)
                            if best is None or sc > best + plateau_tol:
                                plateau_best[cid] = (
                                    sc if best is None else max(sc, best))
                                plateau_streak[cid] = 0
                                keep.append(cid)
                                continue
                            plateau_streak[cid] = (
                                plateau_streak.get(cid, 0) + 1)
                            if plateau_streak[cid] >= patience_n:
                                plateaued.append(cid)
                                cand_status[cid] = "stopped (plateau)"
                            else:
                                keep.append(cid)
                        survivors = keep
                        if plateaued:
                            self.n_plateau_stops_ += len(plateaued)
                            telemetry.counter(
                                "search.plateau_stops").inc(len(plateaued))
                    if final:
                        promoted, stopped = survivors, []
                    else:
                        n_next = max(1, len(survivors) // eta)
                        promoted = survivors[:n_next]
                        stopped = survivors[n_next:]
                    for cid in stopped:
                        cand_status[cid] = "stopped"
                    self.n_promotions_ += 0 if final else len(promoted)
                    if not final and promoted:
                        telemetry.counter("search.promotions").inc(
                            len(promoted))
                    n_stop = len(stopped) + len(timeouts) + len(plateaued)
                    if n_stop:
                        self.n_candidates_stopped_ += n_stop
                        telemetry.counter(
                            "search.candidates_stopped").inc(n_stop)
                    rung_table.append({
                        "bracket": s, "rung": rung, "n_epochs": cum,
                        "alive": len(alive),
                        "scored": len(survivors) + len(plateaued),
                        "promoted": 0 if final else len(promoted),
                        "stopped": len(stopped), "timeouts": len(timeouts),
                        "plateau": len(plateaued), "final": bool(final),
                    })
                    if final:
                        for cid in promoted:
                            cand_status[cid] = "stopped"
                        if promoted:
                            cand_status[promoted[0]] = "best in bracket"
                        break
                    if not promoted:
                        break  # every candidate timed out
                    alive = promoted
                    rung += 1
                    prev_cum = cum
                    cum = cum * eta if cap is None else min(cum * eta, cap)

        if not records:
            raise RuntimeError(
                "incremental search finished with no scored candidate "
                "(every rung-0 candidate timed out)")

        self._build_results(
            cand_params, cand_bracket, cand_model_id, cand_rung,
            cand_status, records, history, rung_table, brackets,
            budget_spent, deepest)
        if run is not None:
            self.n_blocks_rebalanced_ = (run.blocks_rebalanced
                                         - elastic_before[0])
            self.n_blocks_speculated_ = (run.blocks_speculated
                                         - elastic_before[1])
        return self

    def _generic_with_retries(self, train, caller_cfg, name, cid, rung):
        """One candidate's rung through ``train()`` under the soft deadline
        ``cell_timeout``, retried up to ``cell_retries`` times on an
        error. Raises :class:`_RungTimeout` when the deadline passes."""
        last_err = None
        for _attempt in range(int(self.cell_retries) + 1):
            try:
                value, timed_out = run_with_soft_deadline(
                    train, self.cell_timeout, caller_cfg=caller_cfg,
                    name=name)
            except Exception as e:  # retried, then re-raised
                last_err = e
                self.n_rung_retries_ += 1
                telemetry.counter("search.rung_retries").inc()
                logger.warning(
                    "asha: candidate %d rung %d attempt failed (%s); "
                    "retrying", cid, rung, e)
                continue
            if timed_out:
                raise _RungTimeout(cid)
            return value
        raise last_err

    # -- elastic rung -----------------------------------------------------

    def _rung_elastic(self, run, uid, cids, make_record) -> dict:
        """One rung over the elastic plane: the rung's candidates are the
        epoch's blocks, in identity order (the data epochs inside each
        candidate are the shuffled ones), dealt contiguously over the live
        roster; ``collect_epoch`` re-deals the candidates of dead (and,
        with ``speculate_after``, slow) hosts. The first publication
        wins: any host computes the same bytes."""
        from dask_ml_tpu_torch.parallel.elastic import (BlockPlan,
                                                        _epoch_assignment)

        order = list(range(len(cids)))
        plan = BlockPlan(len(order), seed=0, shuffle=False)
        owner = _epoch_assignment(run, order)

        def compute_publish(grab):
            for b in grab:
                try:
                    rec = make_record(cids[b])
                except _RungTimeout:
                    rec = None
                run.publish(uid, b, _record_to_tree(rec))
                run.beat()
                run.maybe_die(b, uid)

        have = run.published(uid)
        compute_publish([b for b in order
                         if owner.get(b) == run.rank and b not in have])
        out = run.collect_epoch(plan, uid, order, owner, compute_publish)
        return {cids[b]: _tree_to_record(out[b]) for b in order}

    # -- cv_results_ ------------------------------------------------------

    def _build_results(self, cand_params, cand_bracket, cand_model_id,
                       cand_rung, cand_status, records, history,
                       rung_table, brackets, budget_spent, deepest):
        n_models = len(cand_params)
        scores = np.full(n_models, np.nan)
        n_epochs = np.zeros(n_models, np.int64)
        pf_calls = np.zeros(n_models, np.int64)
        rung_arr = np.full(n_models, -1, np.int64)
        fit_t = np.zeros(n_models)
        score_t = np.zeros(n_models)
        for cid, rec in records.items():
            scores[cid] = rec["score"]
            n_epochs[cid] = rec["n_epochs"]
            pf_calls[cid] = rec["pf_calls"]
            rung_arr[cid] = cand_rung[cid]
            fit_t[cid] = rec["fit_seconds"] / max(rec["n_epochs"], 1)
            score_t[cid] = rec["score_seconds"]
        order = sorted(
            range(n_models),
            key=lambda c: (-(scores[c] if np.isfinite(scores[c])
                             else -np.inf), c))
        rank = np.zeros(n_models, np.int32)
        for pos, cid in enumerate(order):
            if pos > 0 and scores[cid] == scores[order[pos - 1]]:
                rank[cid] = rank[order[pos - 1]]
            else:
                rank[cid] = pos + 1
        keys = sorted({k for p in cand_params for k in p})
        results = {
            "params": np.asarray(cand_params, dtype=object),
            "model_id": np.asarray(cand_model_id, dtype=object),
            "bracket_": np.asarray(cand_bracket, np.int64),
            "rung_": rung_arr,
            "n_epochs_": n_epochs,
            "partial_fit_calls": pf_calls,
            "test_score": scores,
            "rank_test_score": rank,
            "mean_partial_fit_time": fit_t,
            "mean_score_time": score_t,
            "status": np.asarray(
                [cand_status.get(c, "running") for c in range(n_models)],
                dtype=object),
        }
        for k in keys:
            results[f"param_{k}"] = np.asarray(
                [p.get(k, np.nan) for p in cand_params], dtype=object)
        self.cv_results_ = results
        self.history_ = history
        self.rung_table_ = rung_table
        best = order[0]
        self.best_index_ = int(best)
        self.best_score_ = float(scores[best])
        self.best_params_ = cand_params[best]
        self.best_estimator_ = pickle.loads(records[best]["blob"])
        self.multimetric_ = False
        self.scorer_ = self.scoring
        self.n_splits_ = 1
        sync = n_models * deepest
        self.budget_spent_ = int(budget_spent)
        self.budget_synchronous_ = int(sync)
        self.n_blocks_rebalanced_ = 0
        self.n_blocks_speculated_ = 0
        self.metadata_ = {
            "n_models": n_models,
            "partial_fit_calls": int(pf_calls.sum()),
            "fit_epochs": int(budget_spent),
            "fit_epochs_synchronous": int(sync),
            "brackets": [
                {"bracket": s, "n_models": n0, "r0": r0,
                 "rungs": bracket_rungs(
                     n0, r0, int(self.aggressiveness),
                     getattr(self, "max_epochs", None))}
                for s, n0, r0 in brackets
            ],
        }

    # -- introspection ----------------------------------------------------

    def shared_fit_report(self) -> str:
        """The rung table (candidates alive / promoted / stopped a rung)
        and the fit-epoch budget against the synchronous grid's."""
        if not hasattr(self, "rung_table_"):
            raise AttributeError("Not fitted; call fit first")
        md = self.metadata_
        pct = 100.0 * md["fit_epochs"] / max(
            md["fit_epochs_synchronous"], 1)
        lines = [
            (f"{md['n_models']} candidates over "
             f"{self.n_rungs_completed_} rungs: "
             f"{md['fit_epochs']} fit-epochs spent vs "
             f"{md['fit_epochs_synchronous']} synchronous-equivalent "
             f"({pct:.0f}%)"),
            "",
            (f"{'bracket':>7} {'rung':>4} {'epochs':>6} {'alive':>5} "
             f"{'promoted':>8} {'stopped':>7} {'timeouts':>8} "
             f"{'plateau':>7}"),
        ]
        for row in self.rung_table_:
            lines.append(
                f"{row['bracket']:>7} {row['rung']:>4} "
                f"{row['n_epochs']:>6} {row['alive']:>5} "
                f"{row['promoted']:>8} {row['stopped']:>7} "
                f"{row['timeouts']:>8} {row.get('plateau', 0):>7}")
        extras = []
        if self.n_blocks_rebalanced_ or self.n_blocks_speculated_:
            extras.append(
                f"{self.n_blocks_rebalanced_} candidate-rung(s) re-dealt "
                f"from lost hosts, {self.n_blocks_speculated_} "
                "speculatively re-dealt from stragglers")
        if self.n_resumed_rungs_:
            extras.append(
                f"{self.n_resumed_rungs_} candidate-rung(s) restored "
                "from the journal")
        if self.n_rung_retries_ or self.n_rung_timeouts_:
            extras.append(
                f"{self.n_rung_retries_} rung retr"
                f"{'y' if self.n_rung_retries_ == 1 else 'ies'}, "
                f"{self.n_rung_timeouts_} rung timeout"
                f"{'' if self.n_rung_timeouts_ == 1 else 's'} "
                "(degraded to last completed rung)")
        if getattr(self, "n_plateau_stops_", 0):
            extras.append(
                f"{self.n_plateau_stops_} candidate"
                f"{'' if self.n_plateau_stops_ == 1 else 's'} "
                f"plateau-stopped (< {getattr(self, 'tol', 1e-3)} score "
                f"improvement for {getattr(self, 'patience', '?')} "
                "rungs)")
        if extras:
            lines += [""] + extras
        if telemetry.enabled() or telemetry.counters():
            lines += ["", telemetry.render_counters()]
        return "\n".join(lines)

    # -- post-fit delegation ----------------------------------------------

    def _check_is_fitted(self):
        if not hasattr(self, "best_estimator_"):
            raise AttributeError("Not fitted; call fit first")

    @property
    def classes_(self):
        self._check_is_fitted()
        return self.best_estimator_.classes_

    def predict(self, X):
        self._check_is_fitted()
        return self.best_estimator_.predict(X)

    def predict_proba(self, X):
        self._check_is_fitted()
        return self.best_estimator_.predict_proba(X)

    def decision_function(self, X):
        self._check_is_fitted()
        return self.best_estimator_.decision_function(X)

    def transform(self, X):
        self._check_is_fitted()
        return self.best_estimator_.transform(X)

    def score(self, X, y=None):
        self._check_is_fitted()
        return self._score_estimator(self.best_estimator_, X, y)


class SuccessiveHalvingSearchCV(BaseIncrementalSearchCV):
    """Asynchronous successive halving (ASHA) over ``partial_fit``
    estimators: one bracket of :func:`bracket_rungs`.

    ``n_initial_parameters`` is the rung-0 candidate count drawn from
    ``parameters`` with a seeded ``ParameterSampler``, or ``'grid'`` for
    the full ``ParameterGrid``. ``n_initial_epochs`` is the rung-0
    budget; each promotion keeps the top ``1/aggressiveness`` of the
    scored candidates and multiplies the epochs by ``aggressiveness``, up
    to ``max_epochs``.

    ``patience`` (optional) adds a plateau stop: a candidate whose rung
    score improves by less than ``tol`` for ``patience`` rungs in a row
    is stopped even where it would be promoted (``n_plateau_stops_``,
    the ``plateau`` column of ``rung_table_``). ``elastic`` (an
    :class:`~dask_ml_tpu_torch.parallel.elastic.ElasticRun`) spreads each
    rung's candidates over a fleet of processes (see the module
    docstring; ``n_blocks_rebalanced_`` / ``n_blocks_speculated_`` count
    the re-deals); see :class:`HyperbandSearchCV` for the multi-bracket
    sweep.
    """

    def __init__(self, estimator, parameters, *,
                 n_initial_parameters=10, n_initial_epochs=1,
                 aggressiveness=3, max_epochs=None, test_size=0.2,
                 n_blocks=4, shuffle_seed=0, random_state=0,
                 scoring=None, checkpoint=None, cell_timeout=None,
                 cell_retries=0, elastic=None, batched_rungs=True,
                 patience=None, tol=1e-3):
        self.estimator = estimator
        self.parameters = parameters
        self.n_initial_parameters = n_initial_parameters
        self.n_initial_epochs = n_initial_epochs
        self.aggressiveness = aggressiveness
        self.max_epochs = max_epochs
        self.test_size = test_size
        self.n_blocks = n_blocks
        self.shuffle_seed = shuffle_seed
        self.random_state = random_state
        self.scoring = scoring
        self.checkpoint = checkpoint
        self.cell_timeout = cell_timeout
        self.cell_retries = cell_retries
        self.elastic = elastic
        self.batched_rungs = batched_rungs
        self.patience = patience
        self.tol = tol

    def _brackets(self) -> list:
        if self.n_initial_parameters == "grid":
            n0 = len(list(ParameterGrid(self.parameters)))
        else:
            n0 = int(self.n_initial_parameters)
        return [(0, n0, int(self.n_initial_epochs))]


class HyperbandSearchCV(BaseIncrementalSearchCV):
    """Hyperband: every :func:`hyperband_brackets` bracket of
    :class:`SuccessiveHalvingSearchCV`, from the most exploratory (many
    candidates, one epoch) to the least (few candidates, ``max_epochs``
    each), sharing the blocks, the journal and, a bracket, one batched
    rung. ``cv_results_`` spans all brackets (``bracket_`` column);
    ``best_*`` is the argmax over every candidate's last score."""

    def __init__(self, estimator, parameters, *, max_epochs=27,
                 aggressiveness=3, test_size=0.2, n_blocks=4,
                 shuffle_seed=0, random_state=0, scoring=None,
                 checkpoint=None, cell_timeout=None, cell_retries=0,
                 elastic=None, batched_rungs=True, patience=None,
                 tol=1e-3):
        self.estimator = estimator
        self.parameters = parameters
        self.max_epochs = max_epochs
        self.aggressiveness = aggressiveness
        self.test_size = test_size
        self.n_blocks = n_blocks
        self.shuffle_seed = shuffle_seed
        self.random_state = random_state
        self.scoring = scoring
        self.checkpoint = checkpoint
        self.cell_timeout = cell_timeout
        self.cell_retries = cell_retries
        self.elastic = elastic
        self.batched_rungs = batched_rungs
        self.patience = patience
        self.tol = tol

    def _brackets(self) -> list:
        return hyperband_brackets(int(self.max_epochs),
                                  int(self.aggressiveness))
