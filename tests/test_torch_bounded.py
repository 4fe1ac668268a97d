"""The PyTorch port's bounded Lloyd loop held against its own oracle and
against the JAX package, on the CPU.

The port runs under ``config_context(device="cpu")``, where the
argmin_min2 wrapper runs its plain version. Contracts and tolerances:

- the bounded loop is bit-identical to the port's plain ``lloyd_loop``
  from the same ``init``: centers, ``n_iter`` and ``shift``; its inertia
  equals ``compute_inertia`` of the oracle's centers and its labels
  ``predict_labels`` (pruning removes only work whose outcome the bounds
  prove); ``prune=False`` returns the same tuple;
- against the JAX package's ``lloyd_loop_bounded(kernel="xla")``, both
  with ``_FUSED_BLK`` shrunk to 128 so small inputs span many skip
  groups: the same ``n_iter``, labels and per-iteration ``rows_skipped``,
  centers within rtol 1e-5 (the two sum the M-step in different orders);
- after every iteration, upper bound ≥ true distance ≥ group lower bound,
  against float64 numpy distances;
- the estimator: ``algorithm="bounded"`` against ``"full"`` is
  bit-identical on integer-valued data, and on float data gives the same
  ``n_iter_`` and ``labels_`` with centers within rtol 1e-6 (the full loop
  reduces its M-step in the single-pass form's order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.models import kmeans as jcore
from dask_ml_tpu.ops import fused_distance as jfd
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.ops import fused_distance as tfd


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture
def small_blocks():
    """Skip groups of 128 rows in both packages (the JAX package bakes the
    group size into traced programs, so its caches are cleared around)."""
    old = jfd._FUSED_BLK, tfd._FUSED_BLK
    jfd._FUSED_BLK = tfd._FUSED_BLK = 128
    jax.clear_caches()
    yield
    jfd._FUSED_BLK, tfd._FUSED_BLK = old
    jax.clear_caches()


def _kdd_shaped(n, d, seed, kt=9):
    """KDD-character data: imbalanced cluster mass and per-feature scales
    spanning orders of magnitude (the JAX bounded tests' recipe)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(kt, d) * np.exp(rng.randn(1, d) * 1.2)
    p = np.exp(-0.4 * np.arange(kt))
    ids = rng.choice(kt, size=n, p=p / p.sum())
    return (centers[ids] + rng.randn(n, d) * 0.3).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _init(X, k, seed):
    rng = np.random.RandomState(seed)
    return X[np.sort(rng.choice(X.shape[0], k, replace=False))].copy()


@pytest.mark.parametrize("k,groups,seed", [(6, "auto", 4), (12, 3, 1)])
def test_bounded_matches_plain_loop_bitexact(k, groups, seed, small_blocks):
    X = _kdd_shaped(4000, 7, seed=seed, kt=k)
    Xt, w = _t(X), torch.ones(4000)
    c0 = _t(_init(X, k, 0))
    co, _, no, so = core.lloyd_loop(Xt, w, c0, 1e-6, max_iter=40)
    cb, ib, nb, sb, lb, stats = core.lloyd_loop_bounded(
        Xt, w, c0, 1e-6, max_iter=40, groups=groups)
    assert torch.equal(co, cb)
    assert no == nb and float(so) == float(sb)
    assert float(ib) == float(core.compute_inertia(Xt, w, co))
    assert torch.equal(lb, core.predict_labels(Xt, co))
    held = stats["bounds_held"][:nb]
    assert int(held[-1]) > 0.8 * 4000
    assert int(stats["rows_skipped"][:nb].sum()) > 0
    assert int(stats["rows_skipped"][nb:].abs().sum()) == 0


def test_bounded_prune_off_is_identical(small_blocks):
    X = _kdd_shaped(3000, 5, seed=4)
    Xt, w = _t(X), torch.ones(3000)
    c0 = _t(_init(X, 6, 2))
    a = core.lloyd_loop_bounded(Xt, w, c0, 0.0, max_iter=15, prune=True)
    b = core.lloyd_loop_bounded(Xt, w, c0, 0.0, max_iter=15, prune=False)
    assert torch.equal(a[0], b[0]) and float(a[1]) == float(b[1])
    assert a[2] == b[2] == 15
    assert torch.equal(a[4], b[4])
    assert int(b[5]["rows_skipped"].sum()) == 0
    assert int(a[5]["rows_skipped"].sum()) > 0


def _fragile_groups(X, w, c0, tol, trace, its):
    """(its,) int: at each iteration, the ``_FUSED_BLK``-row groups whose
    skip decision the other package's rounding may flip. A group is
    skipped when every weighted row has ``ub < min lb``. The two packages
    hold the same labels, so their ``ub`` and ``min lb`` differ only
    through the values they were built from, each of which is measured
    here in float64 along the port's trajectory:

    - the centers: the JAX loop's after each iteration (``max_iter = t``)
      against the port's (``trace["centers"]``), ``Δc_t`` the largest
      distance between the two;
    - the seeds: at its last evaluation a row's bounds were ``(1 ± s)·
      sqrt(d ± slack)`` of each package's own ``argmin_min2`` against its
      own centers (the JAX package's XLA function on the JAX centers);
      the slack terms differ by at most 2⁻²³ of themselves;
    - every movement ``|c_new − c_old|`` differs by at most ``Δc_new +
      Δc_old`` (triangle inequality) plus each package's rounding of it,
      2⁻²³·(D + 2) of the movement; ``ub`` takes one movement an
      iteration, ``min lb`` one.

    A row's ``ub − min lb`` then differs by at most its seeds' difference
    plus twice the movement terms since that evaluation, times ``1 + s``.
    A group is fragile when some weighted row lies within that of its
    threshold; elsewhere the decisions must agree."""
    D = X.shape[1]
    blk = tfd._FUSED_BLK
    pad = -X.shape[0] % blk
    X64 = np.pad(X.astype(np.float64), ((0, pad), (0, 0)))
    x2 = (X64 * X64).sum(1)
    u, s = 2.0 ** -23, core._BOUND_SLACK
    cp = [np.asarray(c0)] + list(trace["centers"])
    cj = [np.asarray(c0)]
    for t in range(1, its + 1):
        cj.append(np.asarray(jcore.lloyd_loop_bounded(
            *map(jnp.asarray, (X, w, c0)), jnp.asarray(tol), max_iter=t,
            kernel="xla")[0]))
    dc = [np.linalg.norm(a.astype(np.float64) - b, axis=1).max()
          for a, b in zip(cp, cj)]
    Xp = np.pad(X, ((0, pad), (0, 0)))

    def seeds(c, own):
        _, d1, d2 = own(c)
        c2 = float((c.astype(np.float64) ** 2).sum(1).max())
        sl = core._BOUND_EPS_ABS * (x2 + c2)
        d1, d2 = np.asarray(d1, np.float64), np.asarray(d2, np.float64)
        return (np.sqrt(d1 + sl), np.sqrt(np.clip(d2 - sl, 0, None)),
                np.sqrt(u * sl))

    seed_gap = np.zeros(len(x2))
    moved = np.zeros(len(x2))
    fragile = []
    for t in range(its):
        ub, lbmin, w_pos = trace["need"][t]
        if t:
            step = np.linalg.norm(cp[t].astype(np.float64) - cp[t - 1],
                                  axis=1).max()
            moved += 2 * (dc[t] + dc[t - 1] + u * (D + 2) * step)
        eps = (seed_gap + moved) * (1 + s)
        near = (np.abs(ub - lbmin) <= eps) & (eps > 0) & w_pos
        fragile.append(int(near.reshape(-1, blk).any(1).sum()))
        ev = np.repeat((w_pos & (ub >= lbmin)).reshape(-1, blk).any(1), blk)
        pu, pl, ps = seeds(cp[t], lambda c: tfd.fused_argmin_min2(
            torch.from_numpy(Xp), torch.from_numpy(np.asarray(c))))
        ju, jl, js = seeds(cj[t], lambda c: jfd.fused_argmin_min2(
            jnp.asarray(Xp), jnp.asarray(c), kernel="xla"))
        gap = np.maximum(np.abs(pu - ju), np.abs(pl - jl)) + ps + js
        seed_gap = np.where(ev, gap, seed_gap)
        moved = np.where(ev, 0.0, moved)
    return np.array(fragile)


@pytest.mark.parametrize("k,seed,iseed,weighted", [(6, 3, 1, False),
                                                   (6, 3, 1, True),
                                                   (5, 1, 0, False),
                                                   (8, 4, 1, False)])
def test_bounded_matches_jax_xla(k, seed, iseed, weighted, small_blocks,
                                 monkeypatch):
    """Held against the JAX package's XLA bounded loop from the same init
    (not its interpret-mode Pallas loop, a known failing reference). The
    two packages round the scores and the M-step in different orders, so
    a row within a few ulps of a tie or of its bound may go another way.
    On these seeds (k true clusters, k fitted) no label does: ``n_iter``
    and the labels are equal, the centers within rtol 1e-5. The skip
    decisions are equal at every iteration but those where a group lies
    within the float64 bound of :func:`_fragile_groups` of its threshold;
    there the counts differ by at most that many groups."""
    n = 4000
    X = _kdd_shaped(n, 7, seed=seed, kt=k)
    w = (np.random.RandomState(5).uniform(0.5, 2.0, n).astype(np.float32)
         if weighted else np.ones(n, np.float32))
    c0 = _init(X, k, iseed)
    tol = np.float32(1e-6)
    trace = {"need": [], "centers": []}
    need, move = core._bounded_need, core._bounded_move

    def traced_need(ub, lb, w_pos, *, prune):
        lbmin = lb.min(dim=1).values
        trace["need"].append((ub.double().numpy(), lbmin.double().numpy(),
                              w_pos.numpy()))
        return need(ub, lb, w_pos, prune=prune)

    def traced_move(ub, lb, labels, centers, new_centers, gid, G):
        trace["centers"].append(new_centers.numpy().copy())
        return move(ub, lb, labels, centers, new_centers, gid, G)

    monkeypatch.setattr(core, "_bounded_need", traced_need)
    monkeypatch.setattr(core, "_bounded_move", traced_move)
    jc, jin, jn, _, jl, jst = jcore.lloyd_loop_bounded(
        *map(jnp.asarray, (X, w, c0)), jnp.asarray(tol), max_iter=60,
        kernel="xla")
    tc, tin, tn, _, tl, tst = core.lloyd_loop_bounded(
        _t(X), _t(w), _t(c0), tol, max_iter=60)
    assert tn == int(jn) and tn > 5
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-5)
    got = tst["rows_skipped"][:tn].numpy()
    want = np.asarray(jst["rows_skipped"])[:tn]
    if not np.array_equal(got, want):
        its = int(np.nonzero(got != want)[0].max()) + 1
        fragile = _fragile_groups(X, w, c0, tol, trace, its)
        gap = np.abs(got[:its] - want[:its])
        assert (gap <= fragile * tfd._FUSED_BLK).all(), (gap, fragile)
    assert int(tst["rows_skipped"][:tn].sum()) > 0


def test_bound_invariants_vs_float64(small_blocks):
    """After every iteration: ub ≥ d(x, c_label) and, per group g,
    lb_g ≤ min over the group's other centers, in float64."""
    n, d, k, G = 1200, 6, 12, 3
    X = _kdd_shaped(n, d, seed=5)
    Xt, w = _t(X), torch.ones(n)
    centers = _t(_init(X, k, 3))
    Gn, size = core._bounded_groups(k, G)
    gid = torch.arange(k) // size
    X_pad, w_pad = core._pad_rows_to_blocks(Xt, w)
    x2 = (X_pad * X_pad).sum(dim=1)
    _, labels, ub, lb, _, _, _, _ = core._bounded_init_state(
        centers, X_pad.shape[0], Gn, 12)
    gnp = gid.numpy()
    for _ in range(12):
        labels, ub, lb, _, _ = core._bounded_assign(
            X_pad, x2, centers, labels, ub, lb, w_pad > 0, kernel="auto",
            prune=True)
        new, _ = core._m_step(Xt, w, labels[:n], centers)
        ub, lb = core._bounded_move(ub, lb, labels, centers, new, gid, Gn)
        centers = new
        C = centers.numpy().astype(np.float64)
        lab = labels[:n].numpy()
        D = np.sqrt(((X.astype(np.float64)[:, None, :] - C[None]) ** 2)
                    .sum(-1))
        assert (ub[:n].numpy() >= D[np.arange(n), lab] * (1 - 1e-6)
                - 1e-6).all()
        for g in range(Gn):
            Dg = D[:, gnp == g].copy()
            own = gnp[lab] == g
            Dg[own, lab[own] - np.flatnonzero(gnp == g)[0]] = np.inf
            assert (lb[:n, g].numpy() <= Dg.min(axis=1) * (1 + 1e-6)
                    + 1e-6).all()


@pytest.mark.parametrize("k,groups", [(8, "auto"), (100, "auto"), (8, 4),
                                      (8, 100), (1, "auto"), (23, 3)])
def test_bounded_groups_rule_matches_jax(k, groups):
    assert core._bounded_groups(k, groups) == jcore._bounded_groups(k, groups)


def test_bounded_auto_rule_and_arguments():
    assert core._bounded_auto_wins(1 << 16, 4, 41)
    assert not core._bounded_auto_wins((1 << 16) - 1, 8, 41)
    assert not core._bounded_auto_wins(1 << 20, 3, 41)
    X, w, c0 = torch.zeros(10, 2), torch.ones(10), torch.zeros(2, 2)
    # bounds are never below float32 (precision.lloyd_bounds_dtype's rule)
    with pytest.raises(ValueError, match="float32"):
        core.lloyd_loop_bounded(X, w, c0, 0.0, max_iter=1,
                                bounds_dtype=torch.bfloat16)
    assert core.lloyd_loop_bounded(X, w, c0, 0.0, max_iter=1,
                                   bounds_dtype=torch.float64)[2] == 1
    with pytest.raises(ValueError, match="kernel"):
        core.lloyd_loop_bounded(X, w, c0, 0.0, max_iter=1, kernel="xla")
    with pytest.raises(ValueError, match="cuda"):
        core.lloyd_loop_bounded(X, w, c0, 0.0, max_iter=1, kernel="cuda")


class _Stop(Exception):
    pass


def _interrupt_chunk(monkeypatch, at: int):
    """Make the ``at``-th call of ``_bounded_chunk`` raise before it runs:
    a kill during that chunk, after the previous chunk's snapshot."""
    calls = []
    orig = core._bounded_chunk

    def chunk(*a, **k):
        calls.append(1)
        if len(calls) == at:
            raise _Stop
        return orig(*a, **k)

    monkeypatch.setattr(core, "_bounded_chunk", chunk)
    return calls


@pytest.mark.parametrize("tol,chunk", [(0.0, 7), (1e-6, 4)],
                         ids=["tol0-chunk7", "tol1e-6-chunk4"])
def test_bounded_resumable_interrupted_matches_one_shot(
        tmp_path, monkeypatch, small_blocks, tol, chunk):
    """Interrupted in its second chunk and resumed, the resumable loop
    returns the one-shot loop's tuple bit for bit (centers, inertia,
    n_iter, shift, labels and the per-iteration counts), and deletes its
    snapshot."""
    X = _kdd_shaped(3000, 6, seed=2, kt=6)
    Xt, w = _t(X), torch.ones(3000)
    c0 = _t(_init(X, 6, 1))
    one = core.lloyd_loop_bounded(Xt, w, c0, tol, max_iter=20)
    path = str(tmp_path / "bounded.ckpt")
    _interrupt_chunk(monkeypatch, 2)
    with pytest.raises(_Stop):
        core.lloyd_bounded_resumable(Xt, w, c0, tol, max_iter=20,
                                     path=path, chunk_iters=chunk)
    monkeypatch.undo()
    import os

    assert os.path.exists(path)
    res = core.lloyd_bounded_resumable(Xt, w, c0, tol, max_iter=20,
                                       path=path, chunk_iters=chunk)
    assert not os.path.exists(path)
    assert torch.equal(one[0], res[0]) and float(one[1]) == float(res[1])
    assert one[2] == res[2] and float(one[3]) == float(res[3])
    assert torch.equal(one[4], res[4])
    for key in ("rows_skipped", "bounds_held"):
        assert torch.equal(one[5][key], res[5][key])
    if tol == 0.0:
        assert res[2] == 20 and int(res[5]["rows_skipped"].sum()) > 0


def test_bounded_resumable_refuses_another_carry_version(
        tmp_path, monkeypatch, small_blocks):
    X = _kdd_shaped(2000, 5, seed=3, kt=5)
    Xt, w = _t(X), torch.ones(2000)
    c0 = _t(_init(X, 5, 0))
    path = str(tmp_path / "bounded.ckpt")
    _interrupt_chunk(monkeypatch, 2)
    with pytest.raises(_Stop):
        core.lloyd_bounded_resumable(Xt, w, c0, 0.0, max_iter=10,
                                     path=path, chunk_iters=3)
    monkeypatch.undo()
    monkeypatch.setattr(core, "BOUNDED_CARRY_VERSION",
                        core.BOUNDED_CARRY_VERSION + 1)
    with pytest.raises(ValueError, match="carry_version"):
        core.lloyd_bounded_resumable(Xt, w, c0, 0.0, max_iter=10,
                                     path=path, chunk_iters=3)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="max_iter"):
        core.lloyd_bounded_resumable(Xt, w, c0, 0.0, max_iter=12,
                                     path=path, chunk_iters=3)


def test_bounded_resumable_matches_jax(tmp_path, small_blocks):
    """The resumable loop against the JAX package's, each run in one go
    from the same init: the same n_iter, labels and skip counts, centers
    within rtol 1e-5 (as the one-shot loops are held above)."""
    n, k = 4000, 6
    X = _kdd_shaped(n, 7, seed=3, kt=k)
    w = np.ones(n, np.float32)
    c0 = _init(X, k, 1)
    tol = np.float32(1e-6)
    jc, jin, jn, _, jl, jst = jcore.lloyd_bounded_resumable(
        *map(jnp.asarray, (X, w, c0)), jnp.asarray(tol), max_iter=30,
        path=str(tmp_path / "j.ckpt"), chunk_iters=5, kernel="xla")
    tc, tin, tn, _, tl, tst = core.lloyd_bounded_resumable(
        _t(X), _t(w), _t(c0), tol, max_iter=30,
        path=str(tmp_path / "t.ckpt"), chunk_iters=5)
    assert tn == int(jn) > 5
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-5)
    np.testing.assert_array_equal(tst["rows_skipped"][:tn].numpy(),
                                  np.asarray(jst["rows_skipped"])[:tn])


def test_pad_rows_to_blocks(small_blocks):
    X, w = torch.ones(130, 3), torch.ones(130)
    Xp, wp = core._pad_rows_to_blocks(X, w)
    assert Xp.shape == (256, 3) and (Xp[130:] == 0).all()
    assert (wp[130:] == 0).all() and (wp[:130] == 1).all()
    assert core._pad_rows_to_blocks(Xp, wp)[0] is Xp


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


def test_estimator_bounded_matches_full_int_valued():
    """Integer-valued data: every product and sum is exact, so the bounded
    fit equals the full fit bit for bit (k-means|| init included)."""
    rng = np.random.RandomState(8)
    C = rng.randint(-40, 40, (5, 6))
    X = (C[rng.randint(0, 5, 3000)] + rng.randint(-3, 4, (3000, 6))
         ).astype(np.float32)
    a = KMeans(n_clusters=5, random_state=0, algorithm="full").fit(X)
    b = KMeans(n_clusters=5, random_state=0, algorithm="bounded").fit(X)
    np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)
    np.testing.assert_array_equal(a.labels_, b.labels_)
    assert a.inertia_ == b.inertia_ and a.n_iter_ == b.n_iter_
    assert not hasattr(a, "lloyd_pruning_")


def test_estimator_bounded_matches_full_float():
    X = _kdd_shaped(6000, 8, seed=9)
    init = _init(X, 6, 4)
    a = KMeans(n_clusters=6, init=init, algorithm="full", tol=1e-6).fit(X)
    b = KMeans(n_clusters=6, init=init, algorithm="elkan", tol=1e-6).fit(X)
    assert a.n_iter_ == b.n_iter_ > 2
    np.testing.assert_array_equal(a.labels_, b.labels_)
    np.testing.assert_allclose(b.cluster_centers_, a.cluster_centers_,
                               rtol=1e-6, atol=1e-6)
    p = b.lloyd_pruning_
    assert p["rows_considered"] == b.n_iter_ * 6000
    assert len(p["pruned_fraction_per_iter"]) == b.n_iter_
    assert p["distances_avoided"] == p["rows_skipped"] * 6
    assert (np.asarray(p["bound_held_fraction_per_iter"])
            >= np.asarray(p["pruned_fraction_per_iter"]) - 1e-9).all()


def test_estimator_pruning_counts_positive_weight_rows():
    X = _kdd_shaped(3000, 5, seed=10)
    sw = np.ones(3000, np.float32)
    sw[:1000] = 0.0
    km = KMeans(n_clusters=4, random_state=0, algorithm="bounded").fit(
        X, sample_weight=sw)
    p = km.lloyd_pruning_
    assert p["rows_considered"] == km.n_iter_ * 2000
    assert all(0.0 <= f <= 1.0 for f in p["bound_held_fraction_per_iter"])
