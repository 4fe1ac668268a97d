"""tsqr, tsvd, ``svd_compressed``, PCA and TruncatedSVD over a mesh of
ranks (the port's ``torch.distributed`` worlds) held against the JAX
package's meshes, on the CPU.

Each world is spawned once for the module (gloo, a ``file://`` store in
``tmp_path``, one ``.npz`` and one ledger ``.json`` a rank); the JAX side
runs here on the matching slice of the 8 virtual devices. Staging runs
with ``pad_policy=None``: 403 rows pad to a multiple of the shard count,
with zero rows of weight 0 that the factorizations mask.

Tolerances are those of ``tests/test_torch_decomposition.py``: factors and
singular values within rtol 1e-4 (atol 1e-5 times the factor's scale),
estimator attributes within rtol 1e-4, after ``svd_flip`` wherever a
factorization's signs are free. CholeskyQR2 gives R a positive diagonal
in both packages, so the fast path's gathered Q and R compare as they
are. The Householder fallback (an input of condition number 1e6, and
ranks of fewer rows than columns) is held by ``X = QR``, by Q's
orthogonality and by the SVD after the flip. Randomized paths take the
JAX package's own test matrix Ω (the facades' ``svd_compressed`` is handed
it in the world). Every rank reads the same guard, so every rank takes
the same branch (``tsqr_counts``). The ledger holds ``tsqr.gram`` /
``tsqr.guard`` at ``collective_bytes`` of a (d, d) f32 operand and
``tsqr.gather`` at the JAX package's single-axis gather charge.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dask_ml_tpu import config as jconfig
from dask_ml_tpu import decomposition as jdec
from dask_ml_tpu.ops import linalg as jlinalg
from dask_ml_tpu.parallel import hierarchy as jhier
from dask_ml_tpu.parallel import mesh as jmesh
from dask_ml_tpu.parallel.sharding import prepare_data as jprepare
from dask_ml_tpu.utils.validation import check_random_state as jrandom
from dask_ml_tpu.utils.validation import svd_flip as jsvd_flip
from dask_ml_tpu_torch.parallel import hierarchy as hier
from dask_ml_tpu_torch.parallel import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 420
N, D = 403, 12
N_SHORT = 30
TOL = dict(rtol=1e-4, atol=1e-5)

LAYOUTS = [(1, "flat"), (2, "flat"), (3, "flat"), (3, "hier"),
           (4, "flat"), (4, "hier"), (4, "model")]
ROW_LAYOUTS = [(w, lay) for w, lay in LAYOUTS if lay != "model"]
INPUTS = ("fast", "ill", "short")

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    world, rank, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    from dask_ml_tpu_torch.config import set_config
    set_config(device="cpu", pad_policy=None)
    from dask_ml_tpu_torch.parallel import runtime
    runtime.initialize(backend="gloo", init_method="file://" + store,
                       num_processes=world, process_id=rank)
    from dask_ml_tpu_torch.decomposition import PCA, TruncatedSVD
    from dask_ml_tpu_torch.ops import linalg
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    data = np.load(os.path.join(out, "data.npz"))
    omega = torch.as_tensor(data["omega"])
    sketch = linalg.svd_compressed

    def with_jax_omega(*args, **kw):
        # the facades' range finder on the JAX package's test matrix
        kw["omega"] = omega
        return sketch(*args, **kw)

    res, led = {}, {}
    meshes = {"flat": mesh_lib.make_mesh()}
    if world > 2:
        meshes["hier"] = hier.make_hierarchical_mesh(
            2 if world % 2 == 0 else 1)
    if world == 4:
        meshes["model"] = mesh_lib.make_2d_mesh(2, 2)
    for lay, m in meshes.items():
        for name in ("fast", "ill", "short"):
            d = prepare_data(data[name], mesh=m)
            hier.reset_ledger()
            linalg.reset_tsqr_counts()
            Q, R = linalg.tsqr(d.X, weights=d.weights, mesh=m)
            led[f"{lay}-{name}"] = {"ledger": hier.ledger_snapshot(),
                                    "counts": dict(linalg.tsqr_counts)}
            res[f"{lay}-{name}-Q"], res[f"{lay}-{name}-R"] = (Q.numpy(),
                                                            R.numpy())
            U, S, Vt = linalg.tsvd(d.X, weights=d.weights, mesh=m)
            U, Vt = linalg.svd_flip(U, Vt)
            res[f"{lay}-{name}-U"], res[f"{lay}-{name}-S"] = (U.numpy(),
                                                            S.numpy())
            res[f"{lay}-{name}-Vt"] = Vt.numpy()
        d = prepare_data(data["fast"], mesh=m)
        for p in (0, 2):
            hier.reset_ledger()
            U, S, Vt = linalg.svd_compressed(d.X, 8, p, weights=d.weights,
                                             omega=omega, mesh=m)
            led[f"{lay}-sc{p}"] = {"ledger": hier.ledger_snapshot()}
            U, Vt = linalg.svd_flip(U, Vt)
            res[f"{lay}-sc{p}-U"], res[f"{lay}-sc{p}-S"] = U.numpy(), S.numpy()
            res[f"{lay}-sc{p}-Vt"] = Vt.numpy()
        linalg.svd_compressed = with_jax_omega
        X = data["pca"]
        with mesh_lib.use_mesh(m):
            for tag, est in (
                    ("pca-full", PCA(5, svd_solver="full")),
                    ("pca-rand", PCA(4, svd_solver="randomized",
                                     iterated_power=2, random_state=0)),
                    ("tsvd-tsqr", TruncatedSVD(4)),
                    ("tsvd-rand", TruncatedSVD(4, algorithm="randomized",
                                               random_state=0))):
                hier.reset_ledger()
                Z = est.fit_transform(X)
                led[f"{lay}-{tag}"] = {"ledger": hier.ledger_snapshot()}
                res[f"{lay}-{tag}-Z"] = np.asarray(Z)
                res[f"{lay}-{tag}-T"] = np.asarray(est.transform(X[:40]))
                for attr in ("components_", "explained_variance_",
                             "explained_variance_ratio_",
                             "singular_values_", "mean_",
                             "noise_variance_"):
                    if hasattr(est, attr):
                        res[f"{lay}-{tag}-{attr}"] = np.asarray(
                            getattr(est, attr))
            seeded = PCA(4, svd_solver="randomized", iterated_power=2)
            linalg.svd_compressed = sketch
            seeded.fit(X)
            res[f"{lay}-seedless"] = seeded.components_
        linalg.svd_compressed = sketch
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    with open(os.path.join(out, "ledger%d.json" % rank), "w") as f:
        json.dump(led, f)
    runtime.shutdown()
""")


def _low_rank(seed, n, d, rank=6, noise=0.1, shift=0.0):
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((n, rank)).astype(np.float32)
    B = rng.standard_normal((rank, d)).astype(np.float32)
    return (A @ B + noise * rng.standard_normal((n, d)) + shift).astype(
        np.float32)


def _ill_conditioned(seed=3, n=N, d=D, cond=1e6):
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, d)))
    V, _ = np.linalg.qr(rng.standard_normal((d, d)))
    s = np.logspace(0, -np.log10(cond), d)
    return ((U * s) @ V.T).astype(np.float32)


def _omega():
    """The JAX facades' test matrix at d = 12: the sketch rank rounds up
    to 32 and is capped at d, so ℓ = d."""
    return np.array(jax.random.normal(jrandom(0), (D, D), jnp.float32))


@pytest.fixture(scope="module")
def inputs():
    return {"fast": _low_rank(2, N, D), "ill": _ill_conditioned(),
            "short": _low_rank(4, N_SHORT, D),
            "pca": _low_rank(9, N, D, rank=5, shift=3.0),
            "omega": _omega()}


def _jax_mesh(world, layout):
    devs = jax.devices()[:world]
    if layout == "flat":
        return jmesh.make_mesh(devices=devs)
    if layout == "hier":
        return jhier.make_hierarchical_mesh(2 if world % 2 == 0 else 1,
                                            devices=devs)
    return jmesh.make_2d_mesh(2, 2, devices=devs)


def _port_mesh(world, layout):
    devs = range(world)
    if layout == "flat":
        return mesh_lib.make_mesh(devices=devs)
    if layout == "hier":
        return hier.make_hierarchical_mesh(2 if world % 2 == 0 else 1,
                                           devices=devs)
    return mesh_lib.make_2d_mesh(2, 2, devices=devs)


def _ids(pairs):
    return [f"w{w}-{lay}" for w, lay in pairs]


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    procs = {}
    for world in sorted({w for w, _ in LAYOUTS}):
        out = tmp_path_factory.mktemp(f"linalg-world{world}")
        np.savez(out / "data.npz", **inputs)
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs[world] = (out, [
            subprocess.Popen(
                [sys.executable, "-c", WORKER, str(world), str(r),
                 str(out / "store"), str(out)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            for r in range(world)])
    deadline = time.monotonic() + SPAWN_TIMEOUT
    results, errors = {}, []
    for world, (out, ps) in procs.items():
        for r, p in enumerate(ps):
            try:
                _, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
                errors.append(f"world {world} rank {r} timed out: {err}")
                continue
            if p.returncode:
                errors.append(f"world {world} rank {r}: {err[-3000:]}")
        if not errors:
            results[world] = [
                (dict(np.load(out / f"rank{r}.npz")),
                 json.loads((out / f"ledger{r}.json").read_text()))
                for r in range(len(ps))]
    assert not errors, "\n".join(errors)
    return results


def _n(name):
    return N_SHORT if name == "short" else N


def _gathered(ranks, key, layout, n):
    """A rank-block result gathered in data-shard order (the model
    layout: the ranks of model shard 0)."""
    step = 2 if layout == "model" else 1
    return np.concatenate([ranks[r][0][key]
                           for r in range(0, len(ranks), step)])[:n]


def _close(got, want, scale=None, **tol):
    tol = tol or TOL
    if scale is not None:
        tol = dict(tol, atol=tol["atol"] * scale)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def jax_results(inputs):
    out = {}
    with jconfig.config_context(pad_policy=None):
        for world, lay in LAYOUTS:
            jm = _jax_mesh(world, lay)
            for name in INPUTS:
                jd = jprepare(inputs[name], mesh=jm)
                out[(world, lay, name, "qr")] = jlinalg.tsqr(
                    jd.X, mesh=jm, weights=jd.weights)
                U, S, Vt = jlinalg.tsvd(jd.X, mesh=jm, weights=jd.weights)
                out[(world, lay, name, "svd")] = jsvd_flip(U, Vt) + (S,)
            jd = jprepare(inputs["fast"], mesh=jm)
            for p in (0, 2):
                U, S, Vt = jlinalg.svd_compressed(
                    jd.X, 8, p, key=jrandom(0), mesh=jm, weights=jd.weights,
                    compute_dtype=None)
                out[(world, lay, f"sc{p}")] = jsvd_flip(U, Vt) + (S,)
            with jmesh.use_mesh(jm):
                for tag, est in (
                        ("pca-full", jdec.PCA(5, svd_solver="full")),
                        ("pca-rand", jdec.PCA(4, svd_solver="randomized",
                                              iterated_power=2,
                                              random_state=0)),
                        ("tsvd-tsqr", jdec.TruncatedSVD(4)),
                        ("tsvd-rand", jdec.TruncatedSVD(
                            4, algorithm="randomized", random_state=0))):
                    Z = np.asarray(est.fit_transform(inputs["pca"]))
                    out[(world, lay, tag)] = (
                        est, Z, np.asarray(est.transform(inputs["pca"][:40])))
    return out


# ---------------------------------------------------------------------------
# tsqr and tsvd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
def test_tsqr_fast_path_q_and_r_match_jax(inputs, worlds, jax_results,
                                          world, layout):
    Qj, Rj = jax_results[(world, layout, "fast", "qr")]
    ranks = worlds[world]
    Q = _gathered(ranks, f"{layout}-fast-Q", layout, N)
    _close(Q, np.asarray(Qj)[:N])
    for arrays, ledgers in ranks:
        _close(arrays[f"{layout}-fast-R"], Rj, scale=float(np.abs(Rj).max()))
        assert ledgers[f"{layout}-fast"]["counts"] == {
            "host_reads": 1, "cholqr2": 1, "householder": 0}
    np.testing.assert_allclose(Q @ ranks[0][0][f"{layout}-fast-R"],
                               inputs["fast"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
@pytest.mark.parametrize("name", ["ill", "short"])
def test_tsqr_householder_tree(inputs, worlds, world, layout, name):
    """The fallback: forced by the guard on an ill-conditioned input, or
    at once where a rank holds fewer rows than columns. Every rank takes
    the same branch; Q is orthonormal and ``X = QR``."""
    n = _n(name)
    S = mesh_lib.n_data_shards(_port_mesh(world, layout))
    short = -(-n // S) < D
    ranks = worlds[world]
    Q = _gathered(ranks, f"{layout}-{name}-Q", layout, n)
    R = ranks[0][0][f"{layout}-{name}-R"]
    want = ({"host_reads": 0, "cholqr2": 0, "householder": 1} if short
            else {"host_reads": 1, "cholqr2": int(name == "short"),
                  "householder": int(name == "ill")})
    for arrays, ledgers in ranks:
        assert ledgers[f"{layout}-{name}"]["counts"] == want
        assert np.array_equal(arrays[f"{layout}-{name}-R"], R)
    k = Q.shape[1]
    assert np.abs(Q.T @ Q - np.eye(k)).max() < 1e-5
    np.testing.assert_allclose(Q @ R, inputs[name], atol=1e-5)


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
@pytest.mark.parametrize("name", INPUTS)
def test_tsvd_matches_jax(worlds, jax_results, world, layout, name):
    Uj, Vj, Sj = jax_results[(world, layout, name, "svd")]
    n = _n(name)
    ranks = worlds[world]
    U = _gathered(ranks, f"{layout}-{name}-U", layout, n)
    # the leading, well separated directions: the ill-conditioned input's
    # smallest singular values carry f32 rounding of the whole matrix
    lead = 4 if name == "ill" else 6
    _close(U[:, :lead], np.asarray(Uj)[:n, :lead])
    for arrays, _ in ranks:
        _close(arrays[f"{layout}-{name}-S"], Sj, scale=float(Sj[0]))
        _close(arrays[f"{layout}-{name}-Vt"][:lead], np.asarray(Vj)[:lead])


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
@pytest.mark.parametrize("p", [0, 2])
def test_svd_compressed_with_jax_omega_matches_jax(worlds, jax_results,
                                                   world, layout, p):
    Uj, Vj, Sj = jax_results[(world, layout, f"sc{p}")]
    ranks = worlds[world]
    U = _gathered(ranks, f"{layout}-sc{p}-U", layout, N)
    _close(U[:, :6], np.asarray(Uj)[:N, :6])
    for arrays, _ in ranks:
        _close(arrays[f"{layout}-sc{p}-S"], Sj, scale=float(Sj[0]))
        _close(arrays[f"{layout}-sc{p}-Vt"][:6], np.asarray(Vj)[:6])


# ---------------------------------------------------------------------------
# PCA and TruncatedSVD
# ---------------------------------------------------------------------------

PCA_TAGS = ["pca-full", "pca-rand", "tsvd-tsqr", "tsvd-rand"]


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
@pytest.mark.parametrize("tag", PCA_TAGS)
def test_decomposition_matches_the_jax_facade(worlds, jax_results, world,
                                              layout, tag):
    est, Zj, Tj = jax_results[(world, layout, tag)]
    k = 4
    for arrays, _ in worlds[world]:
        for attr in ("components_", "explained_variance_",
                     "explained_variance_ratio_", "singular_values_",
                     "mean_", "noise_variance_"):
            key = f"{layout}-{tag}-{attr}"
            if key not in arrays:
                continue
            want = np.asarray(getattr(est, attr))
            got = arrays[key]
            if attr == "components_":
                want, got = want[:k], got[:k]
            _close(got, want, scale=float(np.abs(want).max()))
        Z = arrays[f"{layout}-{tag}-Z"]
        assert Z.shape == (N, est.n_components_ if tag.startswith("pca")
                           else 4)
        _close(Z[:, :k], Zj[:, :k], scale=float(np.abs(Zj).max()))
        _close(arrays[f"{layout}-{tag}-T"][:, :k], Tj[:, :k],
               scale=float(np.abs(Tj).max()))


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
def test_seedless_randomized_pca_draws_one_omega(worlds, world, layout):
    """``random_state=None``: rank 0's seed reaches every rank, so the
    ranks factor with one test matrix and hold one model."""
    first = worlds[world][0][0][f"{layout}-seedless"]
    for arrays, _ in worlds[world]:
        assert np.array_equal(arrays[f"{layout}-seedless"], first)


def test_every_rank_holds_the_same_results(worlds):
    for world, ranks in worlds.items():
        for key, v in ranks[0][0].items():
            if key.endswith(("-Q", "-U")):
                continue  # a rank's block
            for arrays, _ in ranks[1:]:
                assert np.array_equal(arrays[key], v), (world, key)


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


def _jax_axis_charge(jm, axis, nbytes):
    jhier.reset_ledger()
    jhier.record_axis_collective("tsqr.gather", jm, axis, nbytes)
    return jhier.ledger_snapshot()["ops"]["tsqr.gather"]


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
@pytest.mark.parametrize("name", INPUTS)
def test_tsqr_ledger(worlds, world, layout, name):
    m, jm = _port_mesh(world, layout), _jax_mesh(world, layout)
    gram = hier.collective_bytes(m, D * D * 4)
    assert gram == jhier.collective_bytes(jm, D * D * 4)
    n = _n(name)
    S = mesh_lib.n_data_shards(m)
    n_loc = -(-n // S)
    for arrays, ledgers in worlds[world]:
        entry = ledgers[f"{layout}-{name}"]
        snap, counts = entry["ledger"], entry["counts"]
        reads = counts["host_reads"]
        assert snap["ops"].get("tsqr.gram", {}) == (
            {ax: 2 * b for ax, b in gram.items()} if reads else {})
        assert snap["ops"].get("tsqr.guard", {}) == (gram if reads else {})
        if not counts["householder"]:
            assert "tsqr.gather" not in snap["ops"]
            continue
        k1 = min(n_loc, D)
        if mesh_lib.is_hierarchical(m):
            k2 = min(m.shape["chip"] * k1, D)
            want = dict(_jax_axis_charge(jm, "chip", k1 * D * 4))
            want.update(_jax_axis_charge(jm, "pod", k2 * D * 4))
        else:
            want = _jax_axis_charge(jm, "data", k1 * D * 4)
        assert snap["ops"]["tsqr.gather"] == want
        if world == 1:
            assert set(snap["bytes"].values()) == {0}


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
def test_svd_compressed_ledger(worlds, world, layout):
    """Two ``tsqr.gram``s a CholeskyQR2, one ``svd_compressed.xtq`` a power
    iteration, one ``svd_compressed.qtx``."""
    m = _port_mesh(world, layout)
    ell = D
    for _, ledgers in worlds[world]:
        for p in (0, 2):
            snap = ledgers[f"{layout}-sc{p}"]["ledger"]
            cb = hier.collective_bytes(m, ell * ell * 4)
            assert snap["ops"]["tsqr.gram"] == {
                ax: 2 * (p + 1) * b for ax, b in cb.items()}
            assert snap["ops"]["svd_compressed.qtx"] == hier.collective_bytes(
                m, ell * D * 4)
            assert snap["ops"].get("svd_compressed.xtq", {}) == (
                {ax: p * b for ax, b in hier.collective_bytes(
                    m, D * ell * 4).items()} if p else {})


def test_pca_model_layout_gathers_the_columns(worlds):
    m = _port_mesh(4, "model")
    n_loc = -(-N // 2)
    for _, ledgers in worlds[4]:
        snap = ledgers["model-pca-full"]["ledger"]
        assert snap["ops"]["pca.colgather"] == {
            "model": (2 - 1) * n_loc * (D // 2) * 4 * 2}
        assert snap["ops"]["pca.mean"] == hier.collective_bytes(
            m, (D + 1) * 4)
