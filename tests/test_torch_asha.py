"""The PyTorch port's successive halving and Hyperband held against the
JAX package, on the CPU.

Both packages get the same numpy problem, drawn from one seed. What is
pinned, and with what tolerance:

- the bracket arithmetic and the seeded block orders are equal;
- on a regression problem whose R² scores are at least 5e-4 apart (no
  tie within the tolerance), both searches, batched and one candidate at
  a time, give the same rung table, the same promotions, the same
  ``best_params_`` and the same ``cv_results_`` keys, with scores within
  rtol 1e-4 (the GLM parity of the streaming step: the two packages sum
  the block gradients in other orders);
- the port's own contracts: the batched rung equals the generic path
  (scores atol 1e-6, coefficients rtol 1e-5), a journal resume repeats
  every score and state bit for bit, a failed rung is never journaled, a
  rung timeout keeps the last completed rung's score, plateau stops,
  and MiniBatchKMeans on the generic path;
- the elastic candidate plane (``elastic=``, the JAX ``tests/test_asha.py``
  cases on threads sharing a workdir): a world of one and two hosts give
  the non-elastic search's scores and states bit for bit, a host killed
  mid-bracket drops no candidate and changes no bit, a stalled peer's
  candidate is speculatively recomputed, and rosters of one and two give
  the same ``cv_results_``.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest

from dask_ml_tpu import linear_model as jlm
from dask_ml_tpu import model_selection as jms
from dask_ml_tpu.model_selection import _incremental as jinc
from dask_ml_tpu.parallel.elastic import BlockPlan as JBlockPlan
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import linear_model as tlm
from dask_ml_tpu_torch.checkpoint import CellJournal
from dask_ml_tpu_torch.cluster import MiniBatchKMeans
from dask_ml_tpu_torch.model_selection import (
    HyperbandSearchCV,
    SuccessiveHalvingSearchCV,
)
from dask_ml_tpu_torch.model_selection import _incremental as tinc
from dask_ml_tpu_torch.parallel.elastic import (
    BlockPlan,
    ElasticRun,
    SimulatedHostDeath,
)
from dask_ml_tpu_torch.parallel.faults import FaultInjector

SEED = 0
SCORE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _problem(n=600, d=5, seed=0):
    """The JAX tests' binary problem."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = np.arange(1, d + 1, dtype=np.float64) * (-1.0) ** np.arange(d)
    y = (X @ w + 0.3 * rng.randn(n) > 0).astype(np.int64)
    return X, y


def _reg_problem(n=600, d=5, seed=0):
    """A regression problem: R² scores do not tie across the grids."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ np.linspace(-2, 2, d) + 0.5 * rng.randn(n)).astype(np.float32)
    return X, y


GRID = {"C": [0.01, 0.1, 1.0, 10.0],
        "solver_kwargs": [{"eta0": 0.5}, {"eta0": 1.0}]}
KW = dict(n_initial_parameters="grid", n_initial_epochs=1,
          aggressiveness=2, max_epochs=8, n_blocks=4, random_state=SEED)
REG_GRID = {"C": [0.03, 0.1, 0.3, 1.0, 3.0],
            "solver_kwargs": [{"eta0": 0.05}, {"eta0": 0.2}]}
HB_KW = dict(max_epochs=9, aggressiveness=3, n_blocks=4,
             random_state=SEED)


def _est():
    return tlm.LogisticRegression(solver="gradient_descent")


# ---------------------------------------------------------------------------
# bracket arithmetic and block orders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(16, 1, 4, 16), (9, 1, 3, None),
                                  (2, 1, 3, 27), (2, 1, 3, None),
                                  (27, 1, 3, 27), (10, 2, 2, 20),
                                  (1, 5, 3, 4), (100, 1, 5, None)])
def test_bracket_rungs_match_jax(args):
    assert tinc.bracket_rungs(*args) == jinc.bracket_rungs(*args)


@pytest.mark.parametrize("args", [(27, 3), (9, 3), (1, 3), (16, 4),
                                  (81, 3), (100, 2)])
def test_hyperband_brackets_match_jax(args):
    assert tinc.hyperband_brackets(*args) == jinc.hyperband_brackets(*args)


def test_bracket_validation():
    with pytest.raises(ValueError, match="aggressiveness"):
        tinc.bracket_rungs(4, 1, 1, None)
    with pytest.raises(ValueError, match="aggressiveness"):
        tinc.hyperband_brackets(9, 1)
    with pytest.raises(ValueError, match="max_epochs"):
        tinc.hyperband_brackets(0, 3)


@pytest.mark.parametrize("seed,n_blocks", [(0, 4), (7, 8), (123, 5),
                                           (2**31 + 5, 13)])
def test_block_plan_epoch_order_matches_jax(seed, n_blocks):
    ours = BlockPlan(n_blocks, seed=seed)
    theirs = JBlockPlan(n_blocks, seed=seed)
    for e in (0, 1, 2, 17, 2**32 + 3):
        assert ours.epoch_order(e) == theirs.epoch_order(e)
    assert BlockPlan(n_blocks, shuffle=False).epoch_order(3) == list(
        range(n_blocks))


def test_block_plan_validation_and_identity_order():
    with pytest.raises(ValueError):
        BlockPlan(0)
    plan = BlockPlan(6, seed=9, shuffle=False)
    assert plan.epoch_order(4) == JBlockPlan(6, seed=9,
                                             shuffle=False).epoch_order(4)


# ---------------------------------------------------------------------------
# the searches against the JAX package
# ---------------------------------------------------------------------------


def _assert_same_search(ours, theirs):
    assert ours.rung_table_ == theirs.rung_table_
    assert ([(h["model_id"], h["rung"], h["n_epochs"],
              h["partial_fit_calls"]) for h in ours.history_]
            == [(h["model_id"], h["rung"], h["n_epochs"],
                 h["partial_fit_calls"]) for h in theirs.history_])
    assert ours.best_params_ == theirs.best_params_
    assert ours.best_index_ == theirs.best_index_
    assert list(ours.cv_results_) == list(theirs.cv_results_)
    np.testing.assert_allclose(ours.cv_results_["test_score"],
                               theirs.cv_results_["test_score"],
                               rtol=SCORE_RTOL)
    for k in ("bracket_", "rung_", "n_epochs_", "partial_fit_calls",
              "rank_test_score"):
        np.testing.assert_array_equal(ours.cv_results_[k],
                                      theirs.cv_results_[k])
    assert list(ours.cv_results_["status"]) == list(
        theirs.cv_results_["status"])
    assert ours.budget_spent_ == theirs.budget_spent_
    assert ours.budget_synchronous_ == theirs.budget_synchronous_
    assert ours.metadata_ == theirs.metadata_


def _scores_apart(search, gap=5e-4):
    s = np.sort(np.asarray([h["score"] for h in search.history_
                            if h["rung"] == 0]))
    return np.diff(s).min() > gap


@pytest.mark.parametrize("batched", [True, False])
def test_successive_halving_matches_jax(batched):
    X, y = _reg_problem()
    kw = dict(KW, batched_rungs=batched)
    ours = SuccessiveHalvingSearchCV(
        tlm.LinearRegression(solver="lbfgs"), REG_GRID, **kw).fit(X, y)
    theirs = jms.SuccessiveHalvingSearchCV(
        jlm.LinearRegression(solver="lbfgs"), REG_GRID, **kw).fit(X, y)
    assert _scores_apart(theirs)
    _assert_same_search(ours, theirs)
    # 10 candidates, eta 2, r0 1, R 8: 10@1 -> 5@2 -> 2@4 -> 1@8
    assert [(r["alive"], r["n_epochs"]) for r in ours.rung_table_] == [
        (10, 1), (5, 2), (2, 4), (1, 8)]


@pytest.mark.parametrize("batched", [True, False])
def test_hyperband_matches_jax(batched):
    X, y = _reg_problem(seed=1)
    ours = HyperbandSearchCV(tlm.LinearRegression(solver="lbfgs"),
                             REG_GRID, batched_rungs=batched,
                             **HB_KW).fit(X, y)
    theirs = jms.HyperbandSearchCV(jlm.LinearRegression(solver="lbfgs"),
                                   REG_GRID, batched_rungs=batched,
                                   **HB_KW).fit(X, y)
    _assert_same_search(ours, theirs)
    assert set(ours.cv_results_["bracket_"]) == {0, 1, 2}


def test_search_follows_hand_computed_schedule_as_jax():
    X, y = _problem()
    sh = SuccessiveHalvingSearchCV(_est(), GRID, **KW).fit(X, y)
    ref = jms.SuccessiveHalvingSearchCV(
        jlm.LogisticRegression(solver="gradient_descent"), GRID,
        **KW).fit(X, y)
    got = [(r["rung"], r["alive"], r["n_epochs"]) for r in sh.rung_table_]
    assert got == [(0, 8, 1), (1, 4, 2), (2, 2, 4), (3, 1, 8)]
    assert [r["promoted"] for r in sh.rung_table_] == [4, 2, 1, 0]
    assert sh.budget_spent_ == ref.budget_spent_ == 20
    assert sh.budget_synchronous_ == 64
    assert sh.metadata_ == ref.metadata_
    np.testing.assert_allclose(sh.cv_results_["test_score"],
                               ref.cv_results_["test_score"],
                               rtol=SCORE_RTOL)


def test_promotion_picks_top_scores_with_id_tiebreak():
    X, y = _problem()
    sh = SuccessiveHalvingSearchCV(_est(), GRID, **KW).fit(X, y)
    r0 = [h for h in sh.history_ if h["rung"] == 0]
    r1_ids = {h["model_id"] for h in sh.history_ if h["rung"] == 1}
    order = sorted(r0, key=lambda h: (-h["score"],
                                      int(h["model_id"].split("-")[-1])))
    assert {h["model_id"] for h in order[:4]} == r1_ids


# ---------------------------------------------------------------------------
# the batched rung
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", ["logistic", "linear"])
def test_batched_rungs_equal_generic_path(make):
    if make == "logistic":
        X, y = _problem()
        est, grid = _est(), GRID
    else:
        X, y = _reg_problem()
        est, grid = tlm.LinearRegression(solver="lbfgs"), REG_GRID
    a = SuccessiveHalvingSearchCV(est, grid, **KW).fit(X, y)
    b = SuccessiveHalvingSearchCV(est, grid, batched_rungs=False,
                                  **KW).fit(X, y)
    assert len(a.rung_compile_stats_) == len(b.rung_compile_stats_)
    np.testing.assert_allclose(a.cv_results_["test_score"],
                               b.cv_results_["test_score"], rtol=0,
                               atol=1e-6)
    for k in ("rung_", "n_epochs_", "partial_fit_calls"):
        np.testing.assert_array_equal(a.cv_results_[k], b.cv_results_[k])
    assert a.best_params_ == b.best_params_
    np.testing.assert_allclose(a.best_estimator_.coef_,
                               b.best_estimator_.coef_, rtol=1e-5,
                               atol=1e-6)
    assert a.best_estimator_.n_iter_ == b.best_estimator_.n_iter_


def test_rung_stats_record_builds_and_launches():
    """The compile gate's counterpart: no kernel build in any rung (the
    CPU builds none at all) and, on CPU tensors, no kernel launch."""
    X, y = _problem()
    hb = HyperbandSearchCV(_est(), GRID, **HB_KW).fit(X, y)
    per_bracket = {}
    for row in hb.rung_compile_stats_:
        assert set(row) == {"bracket", "rung", "candidates", "n_builds",
                            "launches"}
        assert row["n_builds"] == 0 and row["launches"] == {}
        per_bracket.setdefault(row["bracket"], []).append(row["rung"])
    assert set(per_bracket) == {0, 1, 2}
    assert sum(len(r) > 1 for r in per_bracket.values()) >= 2


def test_batched_rung_is_one_call_a_rung(monkeypatch):
    """Each batched rung runs ``batched_rung`` once for its whole
    bracket, and what it returns is what the search records."""
    X, y = _reg_problem()
    calls = []
    orig = tinc.batched_rung

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(out.clone())
        return out

    monkeypatch.setattr(tinc, "batched_rung", spy)
    sh = SuccessiveHalvingSearchCV(tlm.LinearRegression(solver="lbfgs"),
                                   REG_GRID, **KW).fit(X, y)
    assert len(calls) == len(sh.rung_table_) == 4
    assert all(c.shape == (10, X.shape[1] + 1 + 2) for c in calls)
    rung0 = [h["score"] for h in sh.history_ if h["rung"] == 0]
    np.testing.assert_array_equal(
        np.asarray(rung0, np.float64),
        calls[0][:, 0].numpy().astype(np.float64))


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


def test_journal_resume_mid_bracket_bit_identical(tmp_path):
    X, y = _problem()
    ck = os.fspath(tmp_path / "asha.journal")
    a = SuccessiveHalvingSearchCV(_est(), GRID, checkpoint=ck,
                                  **KW).fit(X, y)
    full = list(CellJournal(ck).load().items())
    assert len(full) == 8 + 4 + 2 + 1
    ck2 = os.fspath(tmp_path / "resume.journal")
    j2 = CellJournal(ck2)
    for k, v in full[:10]:  # ends mid-bracket: rung 1 half journaled
        j2.append(k, v)
    b = SuccessiveHalvingSearchCV(_est(), GRID, checkpoint=ck2,
                                  **KW).fit(X, y)
    assert b.n_resumed_rungs_ == 10
    np.testing.assert_array_equal(a.cv_results_["test_score"],
                                  b.cv_results_["test_score"])
    assert a.best_params_ == b.best_params_
    assert (pickle.dumps(a.best_estimator_._pf_state)
            == pickle.dumps(b.best_estimator_._pf_state))
    assert set(CellJournal(ck2).load()) == set(dict(full))
    assert "restored from the journal" in b.shared_fit_report()


@pytest.mark.parametrize("batched", [True, False])
def test_journal_resume_is_bitwise_on_both_paths(tmp_path, batched):
    X, y = _reg_problem()
    ck = os.fspath(tmp_path / "j")
    kw = dict(HB_KW, batched_rungs=batched, checkpoint=ck)
    a = HyperbandSearchCV(tlm.LinearRegression(solver="lbfgs"), REG_GRID,
                          **kw).fit(X, y)
    records = list(CellJournal(ck).load().items())
    ck2 = os.fspath(tmp_path / "j2")
    j2 = CellJournal(ck2)
    for k, v in records[:len(records) // 2]:
        j2.append(k, v)
    b = HyperbandSearchCV(tlm.LinearRegression(solver="lbfgs"), REG_GRID,
                          **dict(kw, checkpoint=ck2)).fit(X, y)
    assert b.n_resumed_rungs_ == len(records) // 2
    np.testing.assert_array_equal(a.cv_results_["test_score"],
                                  b.cv_results_["test_score"])
    assert ([h["score"] for h in a.history_]
            == [h["score"] for h in b.history_])
    np.testing.assert_array_equal(a.best_estimator_._coef,
                                  b.best_estimator_._coef)


def test_journal_keys_self_invalidate_on_data_change(tmp_path):
    X, y = _problem()
    ck = os.fspath(tmp_path / "asha.journal")
    SuccessiveHalvingSearchCV(_est(), GRID, checkpoint=ck, **KW).fit(X, y)
    X2 = X.copy()
    X2[0, 0] += 1.0
    b = SuccessiveHalvingSearchCV(_est(), GRID, checkpoint=ck,
                                  **KW).fit(X2, y)
    assert b.n_resumed_rungs_ == 0


class _Flaky(tlm.LogisticRegression):
    """Raises once (module level: rung records pickle the estimator)."""

    fails: list = []

    def partial_fit(self, X, y=None, classes=None, sample_weight=None):
        if _Flaky.fails:
            _Flaky.fails.pop()
            raise RuntimeError("injected")
        return super().partial_fit(X, y, classes=classes,
                                   sample_weight=sample_weight)


def test_failed_rung_is_never_journaled(tmp_path):
    X, y = _problem()
    _Flaky.fails = [1]
    ck = os.fspath(tmp_path / "flaky.journal")
    sh = SuccessiveHalvingSearchCV(
        _Flaky(solver="gradient_descent"), GRID, checkpoint=ck,
        cell_retries=1, batched_rungs=False, **KW).fit(X, y)
    assert sh.n_rung_retries_ == 1
    ref = SuccessiveHalvingSearchCV(_est(), GRID, batched_rungs=False,
                                    **KW).fit(X, y)
    np.testing.assert_array_equal(sh.cv_results_["test_score"],
                                  ref.cv_results_["test_score"])
    # one record a completed (candidate, rung): the failed attempt left none
    assert len(CellJournal(ck).load()) == 8 + 4 + 2 + 1
    _Flaky.fails = [1]
    with pytest.raises(RuntimeError, match="injected"):
        SuccessiveHalvingSearchCV(_Flaky(solver="gradient_descent"), GRID,
                                  batched_rungs=False, **KW).fit(X, y)


class _SlowAfterRung0(tlm.LogisticRegression):
    """Fast through the 4 blocks of rung 0, then stalls."""

    def partial_fit(self, X, y=None, classes=None, sample_weight=None):
        if getattr(self, "_seen", 0) >= 4:
            time.sleep(3.0)
        self._seen = getattr(self, "_seen", 0) + 1
        return super().partial_fit(X, y, classes=classes,
                                   sample_weight=sample_weight)


def test_rung_timeout_keeps_last_completed_rung_score(tmp_path):
    """The port's documented behaviour: a candidate whose rung passes the
    deadline keeps its rung-0 score and record, is stopped, and the
    timed-out rung is never journaled."""
    X, y = _problem(n=400)
    ck = os.fspath(tmp_path / "timeout.journal")
    sh = SuccessiveHalvingSearchCV(
        _SlowAfterRung0(solver="gradient_descent"), {"C": [0.1, 1.0]},
        n_initial_parameters="grid", n_initial_epochs=1,
        aggressiveness=2, max_epochs=4, n_blocks=4, random_state=SEED,
        cell_timeout=1.5, batched_rungs=False, checkpoint=ck).fit(X, y)
    assert sh.n_rung_timeouts_ == 1
    assert np.isfinite(sh.cv_results_["test_score"]).all()
    assert list(sh.cv_results_["status"]).count(
        "stopped (rung timeout)") == 1
    assert list(sh.cv_results_["n_epochs_"]) == [1, 1]
    assert list(sh.cv_results_["rung_"]) == [0, 0]
    rung0 = {h["model_id"]: h["score"] for h in sh.history_
             if h["rung"] == 0}
    for mid, score in zip(sh.cv_results_["model_id"],
                          sh.cv_results_["test_score"]):
        assert score == rung0[mid]
    assert [r["timeouts"] for r in sh.rung_table_] == [0, 1]
    assert len(CellJournal(ck).load()) == 2  # rung 0 only
    assert "1 rung timeout" in sh.shared_fit_report()


# ---------------------------------------------------------------------------
# plateau stops, options and surfaces
# ---------------------------------------------------------------------------


def test_plateau_stop_counts_status_and_rung_table():
    X, y = _problem()
    sh = SuccessiveHalvingSearchCV(_est(), GRID, patience=1, tol=1.0,
                                   **KW).fit(X, y)
    assert sh.n_plateau_stops_ == 4
    assert [r["plateau"] for r in sh.rung_table_] == [0, 4]
    assert sh.rung_table_[1]["scored"] == 4
    assert list(sh.cv_results_["status"]).count("stopped (plateau)") == 4
    assert sh.n_candidates_stopped_ == 4 + 4
    assert "4 candidates plateau-stopped" in sh.shared_fit_report()
    assert np.isfinite(sh.best_score_)


def test_plateau_disabled_matches_default_bit_identical():
    X, y = _problem()
    ref = SuccessiveHalvingSearchCV(_est(), GRID, **KW).fit(X, y)
    for kw in ({"patience": None}, {"patience": 100, "tol": 1e-3}):
        sh = SuccessiveHalvingSearchCV(_est(), GRID, **kw, **KW).fit(X, y)
        assert sh.n_plateau_stops_ == 0
        np.testing.assert_array_equal(sh.cv_results_["test_score"],
                                      ref.cv_results_["test_score"])
    with pytest.raises(ValueError, match="patience"):
        SuccessiveHalvingSearchCV(_est(), GRID, patience=0,
                                  **KW).fit(X, y)


def test_options_that_raise():
    X, y = _problem()
    with pytest.raises(ValueError, match="fit_params"):
        SuccessiveHalvingSearchCV(_est(), GRID, **KW).fit(
            X, y, sample_weight=np.ones(len(y)))
    with pytest.raises(ValueError, match="aggressiveness"):
        SuccessiveHalvingSearchCV(_est(), GRID,
                                  **dict(KW, aggressiveness=1)).fit(X, y)
    with pytest.raises(ValueError, match="test_size"):
        SuccessiveHalvingSearchCV(_est(), GRID, test_size=1.0,
                                  **KW).fit(X, y)
    with pytest.raises(ValueError, match="scoring"):
        SuccessiveHalvingSearchCV(_est(), GRID, scoring="accuracy",
                                  batched_rungs=False, **KW).fit(X, y)
    with pytest.raises(AttributeError, match="fit"):
        SuccessiveHalvingSearchCV(_est(), GRID, **KW).shared_fit_report()
    with pytest.raises(AttributeError, match="fit"):
        SuccessiveHalvingSearchCV(_est(), GRID, **KW).predict(X)


# ---------------------------------------------------------------------------
# elastic: the kill drill, determinism across rosters, speculation
# ---------------------------------------------------------------------------


def _host(out, rank, wd, X, y, injector=None, speculate_after=None,
          heartbeat_timeout=2.0, batched=True):
    def go():
        with config_context(device="cpu"):
            run = ElasticRun(wd, rank=rank, world=2, poll_interval=0.05,
                             heartbeat_timeout=heartbeat_timeout,
                             fault_injector=injector,
                             speculate_after=speculate_after)
            sh = SuccessiveHalvingSearchCV(_est(), GRID, elastic=run,
                                           batched_rungs=batched, **KW)
            try:
                sh.fit(X, y)
                out[rank] = sh
            except SimulatedHostDeath:
                out[rank] = "died"

    t = threading.Thread(target=go, daemon=True)
    t.start()
    return t


def _join(*threads):
    for t in threads:
        t.join(120)
        assert not t.is_alive(), "elastic search deadlocked"


def _same_search(a, b):
    np.testing.assert_array_equal(a.cv_results_["test_score"],
                                  b.cv_results_["test_score"])
    assert a.best_params_ == b.best_params_
    assert (pickle.dumps(a.best_estimator_._pf_state)
            == pickle.dumps(b.best_estimator_._pf_state))


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "generic"])
def test_elastic_world1_matches_nonelastic_bit_identical(tmp_path, batched):
    X, y = _problem()
    ref = SuccessiveHalvingSearchCV(_est(), GRID, batched_rungs=batched,
                                    **KW).fit(X, y)
    run = ElasticRun(tmp_path, rank=0, world=1)
    sh = SuccessiveHalvingSearchCV(_est(), GRID, elastic=run,
                                   batched_rungs=batched, **KW).fit(X, y)
    _same_search(sh, ref)
    assert sh.n_blocks_rebalanced_ == sh.n_blocks_speculated_ == 0


def test_two_hosts_match_single_host_and_each_other(tmp_path):
    X, y = _problem()
    ref = SuccessiveHalvingSearchCV(_est(), GRID, **KW).fit(X, y)
    out = {}
    _join(*[_host(out, r, tmp_path, X, y) for r in (0, 1)])
    for r in (0, 1):
        assert out[r] != "died"
        _same_search(out[r], ref)


def test_kill_one_host_mid_bracket_drops_zero_candidates(tmp_path):
    X, y = _problem()
    ref = SuccessiveHalvingSearchCV(_est(), GRID, **KW).fit(X, y)
    out = {}
    # rung 1 of bracket 0 publishes under uid 1001; rank 1 owns the upper
    # candidate shard {2, 3} of its 4 alive: it dies after block 2
    inj = FaultInjector().die_at(2, epoch=1001)
    t0 = _host(out, 0, tmp_path, X, y)
    t1 = _host(out, 1, tmp_path, X, y, injector=inj)
    _join(t0, t1)
    assert out[1] == "died"
    sh = out[0]
    assert sh.n_blocks_rebalanced_ >= 1
    assert np.isfinite(sh.cv_results_["test_score"]).all()
    _same_search(sh, ref)
    assert "re-dealt from lost hosts" in sh.shared_fit_report()


def test_speculative_redeal_of_straggler_blocks(tmp_path):
    """A healthy but stalled peer's block is recomputed by an idle host;
    the owner's later publication changes nothing (the first one wins)."""
    run = ElasticRun(tmp_path, rank=0, world=2, poll_interval=0.05,
                     heartbeat_timeout=30.0, speculate_after=0.3)
    peer = ElasticRun(tmp_path, rank=1, world=2, poll_interval=0.05,
                      heartbeat_timeout=30.0)
    run.bind_problem("spec", x=1)
    peer.bind_problem("spec", x=1)
    order = [0, 1, 2, 3]
    plan = BlockPlan(4, seed=0, shuffle=False)
    owner = {0: 0, 1: 0, 2: 1, 3: 1}

    def make(b):
        return {"v": np.full(3, 10.0 * b)}

    stop = threading.Event()

    def slow_peer():
        peer.publish(7, 2, make(2))
        peer.beat()
        while not stop.is_set():  # a healthy heartbeat, block 3 stalled
            peer.beat()
            time.sleep(0.05)

    t = threading.Thread(target=slow_peer, daemon=True)
    t.start()
    try:
        def compute_publish(blocks):
            for b in blocks:
                run.publish(7, b, make(b))
                run.beat()

        compute_publish([0, 1])
        got = run.collect_epoch(plan, 7, order, owner, compute_publish)
    finally:
        stop.set()
        t.join(5)
    assert not t.is_alive()
    assert run.blocks_speculated == 1
    assert run.blocks_rebalanced == 0  # nobody died
    for b in order:
        np.testing.assert_array_equal(got[b]["v"], np.full(3, 10.0 * b))


def test_seeded_determinism_across_rosters(tmp_path):
    """Rosters of one and two give the same cv_results_: the candidate deal
    changes who computes, never what."""
    X, y = _problem()
    run1 = ElasticRun(tmp_path / "w1", rank=0, world=1)
    a = SuccessiveHalvingSearchCV(_est(), GRID, elastic=run1,
                                  **KW).fit(X, y)
    out = {}
    _join(*[_host(out, r, tmp_path / "w2", X, y) for r in (0, 1)])
    b = out[0]
    np.testing.assert_array_equal(a.cv_results_["test_score"],
                                  b.cv_results_["test_score"])
    for k in ("rung_", "n_epochs_", "partial_fit_calls",
              "rank_test_score"):
        np.testing.assert_array_equal(a.cv_results_[k], b.cv_results_[k])
    assert [h["score"] for h in a.history_] == [h["score"]
                                                for h in b.history_]


def test_elastic_journal_is_one_file_a_rank(tmp_path):
    X, y = _problem()
    run = ElasticRun(tmp_path / "wd", rank=0, world=1)
    ck = str(tmp_path / "journal")
    sh = SuccessiveHalvingSearchCV(_est(), GRID, elastic=run, checkpoint=ck,
                                   **KW).fit(X, y)
    assert os.path.exists(ck + ".r0") and not os.path.exists(ck)
    again = SuccessiveHalvingSearchCV(
        _est(), GRID, elastic=ElasticRun(tmp_path / "wd2", rank=0, world=1),
        checkpoint=ck, **KW).fit(X, y)
    # every candidate-rung of the rerun comes from rank 0's journal
    assert again.n_resumed_rungs_ == len(again.history_) > 0
    _same_search(sh, again)


def test_params_match_jax():
    assert sorted(SuccessiveHalvingSearchCV._get_param_names()) == sorted(
        jms.SuccessiveHalvingSearchCV._get_param_names())
    assert sorted(HyperbandSearchCV._get_param_names()) == sorted(
        jms.HyperbandSearchCV._get_param_names())


def test_callable_scoring_rides_generic_path():
    X, y = _problem()

    def neg_mse(est, Xv, yv):
        return -float(np.mean((est.predict_proba(Xv) - yv) ** 2))

    sh = SuccessiveHalvingSearchCV(_est(), GRID, scoring=neg_mse,
                                   **KW).fit(X, y)
    assert np.isfinite(sh.cv_results_["test_score"]).all()
    assert sh.score(X, y) == neg_mse(sh.best_estimator_, X, y)


def test_randomized_candidates_match_jax():
    """``n_initial_parameters`` as a count draws the JAX package's
    candidates (a seed a bracket)."""
    X, y = _reg_problem()
    dist = {"C": [0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0],
            "solver_kwargs": [{"eta0": 0.05}, {"eta0": 0.1},
                              {"eta0": 0.2}]}
    kw = dict(n_initial_parameters=6, n_initial_epochs=1,
              aggressiveness=3, max_epochs=3, n_blocks=3, random_state=4)
    ours = SuccessiveHalvingSearchCV(tlm.LinearRegression(solver="lbfgs"),
                                     dist, **kw).fit(X, y)
    theirs = jms.SuccessiveHalvingSearchCV(
        jlm.LinearRegression(solver="lbfgs"), dist, **kw).fit(X, y)
    assert list(ours.cv_results_["params"]) == list(
        theirs.cv_results_["params"])
    np.testing.assert_allclose(ours.cv_results_["test_score"],
                               theirs.cv_results_["test_score"],
                               rtol=SCORE_RTOL)


def test_cv_results_hyperband_metadata_shape():
    X, y = _problem()
    hb = HyperbandSearchCV(_est(), GRID, **HB_KW).fit(X, y)
    cv = hb.cv_results_
    n = hb.metadata_["n_models"]
    for col in ("params", "model_id", "bracket_", "rung_", "n_epochs_",
                "partial_fit_calls", "test_score", "rank_test_score",
                "mean_partial_fit_time", "mean_score_time", "status",
                "param_C", "param_solver_kwargs"):
        assert len(cv[col]) == n, col
    assert cv["model_id"][0].startswith("bracket=")
    assert cv["rank_test_score"][hb.best_index_] == 1
    assert hb.best_score_ == max(cv["test_score"])
    assert hb.metadata_["partial_fit_calls"] == cv["partial_fit_calls"].sum()
    assert [b["bracket"] for b in hb.metadata_["brackets"]] == [2, 1, 0]
    assert hb.predict(X[:3]).shape == (3,)
    assert hb.predict_proba(X[:3]).shape == (3,)
    assert hb.decision_function(X[:3]).shape == (3,)
    np.testing.assert_array_equal(hb.classes_, [0, 1])
    assert np.isfinite(hb.score(X, y))


def test_shared_fit_report_rung_table_and_budget():
    X, y = _problem()
    sh = SuccessiveHalvingSearchCV(_est(), GRID, **KW).fit(X, y)
    rep = sh.shared_fit_report()
    assert "20 fit-epochs spent vs 64 synchronous-equivalent" in rep
    assert "bracket" in rep and "promoted" in rep and "timeouts" in rep
    assert len([ln for ln in rep.splitlines()
                if ln.strip().startswith("0 ")]) == 4


def test_search_telemetry_counters():
    from dask_ml_tpu_torch.parallel import telemetry

    X, y = _problem()
    telemetry.reset_counters()
    try:
        with config_context(telemetry=True):
            sh = SuccessiveHalvingSearchCV(_est(), GRID, **KW).fit(X, y)
        counters = telemetry.counters()
        assert counters.get("search.rungs_completed") == 4
        assert counters.get("search.promotions") == 7
        assert counters.get("search.candidates_stopped") == 7
        assert "search.rungs_completed" in sh.shared_fit_report()
    finally:
        telemetry.reset_counters()


def test_mini_batch_kmeans_rides_generic_path():
    rng = np.random.RandomState(1)
    X = np.concatenate(
        [rng.randn(150, 4) + c for c in (0.0, 6.0, 12.0)]).astype(np.float32)
    sh = SuccessiveHalvingSearchCV(
        MiniBatchKMeans(n_clusters=3, random_state=0),
        {"batch_size": [64, 128], "oversampling_factor": [2, 8]},
        n_initial_parameters="grid", n_initial_epochs=1,
        aggressiveness=2, max_epochs=4, n_blocks=3,
        random_state=SEED).fit(X)
    assert np.isfinite(sh.cv_results_["test_score"]).all()
    assert isinstance(sh.best_estimator_, MiniBatchKMeans)
    assert np.isfinite(sh.score(X))
    # one partial_fit a block an epoch, each one mini-batch step
    assert sh.best_estimator_.n_iter_ == sh.cv_results_[
        "partial_fit_calls"][sh.best_index_]
    assert max(sh.cv_results_["partial_fit_calls"]) == 4 * 3
    assert sh.transform(X[:5]).shape == (5, 3)
