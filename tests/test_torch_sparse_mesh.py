"""Sparse staging and the sparse GLM solvers over a mesh of ranks (the
port's ``torch.distributed`` worlds) held against the JAX package, on the
CPU.

Each world is spawned once for the module (gloo, a ``file://`` store in
``tmp_path``, one ``.npz`` and one ledger ``.json`` a rank); the JAX side
runs here on the matching slice of the 8 virtual devices. Staging runs
with ``pad_policy=None``: 403 rows pad to a multiple of the shard count.

- ``shard_sparse_rows`` / ``prepare_data(mesh=)`` on a scipy matrix and on
  a host container: each rank's block equals the JAX shard slot for slot,
  and a rank slices only its own rows out of the host container (its
  leaves record every index they are read with).
- The sparse smooth solvers (L-BFGS, Newton, gradient descent, softmax
  L-BFGS) in a world: within rtol 1e-4 / atol 1e-5 of the JAX solver on
  the same mesh with the same ``n_iter`` (the sums over the ranks add in
  another order), and of the port's one-device fit. On the CPU the
  contractions run their plain versions; the card runs K6 and its
  pullback on every rank's block (``chip_smoke.py``, step 21).
- Sparse ADMM: the JAX sparse ADMM on a mesh is red in its own suite, so
  the world of S ranks is held to the JAX dense ADMM on the densified
  data and to the port's own one-device ``n_shards=S`` fit (rtol 1e-5 /
  atol 1e-6, the same ``n_iter``). Its (d, d) Gram keeps d small.
- The ledger: ``sparse.pullback`` a gradient at ``collective_bytes`` of the
  (d,) — softmax: (d, K) — f32 output, ``sparse.gram`` a Newton step at
  the (d, d) one, held to the formula and to the evaluations; a world of
  one records 0 bytes.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu import config as jconfig
from dask_ml_tpu import linear_model as jlm
from dask_ml_tpu.models import glm as jcore
from dask_ml_tpu.parallel import hierarchy as jhier
from dask_ml_tpu.parallel import mesh as jmesh
from dask_ml_tpu.parallel import sharding as jsharding
from dask_ml_tpu.parallel.sharding import prepare_data as jprepare
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.models import glm as tcore
from dask_ml_tpu_torch.ops import sparse as tsps
from dask_ml_tpu_torch.parallel import hierarchy as hier
from dask_ml_tpu_torch.parallel import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 420

N, D = 403, 10
D1 = D + 1
K = 3
COEF_TOL = dict(rtol=1e-4, atol=1e-5)
ADMM_TOL = dict(rtol=1e-5, atol=1e-6)

LAYOUTS = [(1, "flat"), (2, "flat"), (3, "flat"), (3, "hier"),
           (4, "flat"), (4, "hier"), (4, "model")]
ROW_LAYOUTS = [(w, lay) for w, lay in LAYOUTS if lay != "model"]
SOLVERS = {"lbfgs": {"regularizer": "l2", "lamduh": 1.0},
           "newton": {},
           "gradient_descent": {}}
ADMM_KW = dict(family="logistic", regularizer="l2", lamduh=1.0, rho=0.1,
               max_iter=60)

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import scipy.sparse as sp
    import torch

    torch.set_num_threads(1)
    world, rank, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    from dask_ml_tpu_torch.config import set_config
    set_config(device="cpu", pad_policy=None)
    from dask_ml_tpu_torch.parallel import runtime
    runtime.initialize(backend="gloo", init_method="file://" + store,
                       num_processes=world, process_id=rank)
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models import glm as core
    from dask_ml_tpu_torch.ops import sparse as sparse_ops
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import (prepare_data,
                                                     shard_sparse_rows)

    class Watched(np.ndarray):
        # a host leaf that records every index it is read with
        seen = []

        def __getitem__(self, key):
            Watched.seen.append(repr(key))
            return np.asarray(self)[key]

    data = np.load(os.path.join(out, "data.npz"))
    cases = json.loads(open(os.path.join(out, "cases.json")).read())
    csr = sp.csr_matrix((data["csr_data"], data["csr_indices"],
                         data["csr_indptr"]), shape=tuple(data["csr_shape"]))
    Ai = sp.csr_matrix((data["ai_data"], data["ai_indices"],
                        data["ai_indptr"]), shape=tuple(data["ai_shape"]))
    res, led = {}, {}
    meshes = {"flat": mesh_lib.make_mesh()}
    if world > 2:
        meshes["hier"] = hier.make_hierarchical_mesh(
            2 if world % 2 == 0 else 1)
    if world == 4:
        meshes["model"] = mesh_lib.make_2d_mesh(2, 2)

    def run(tag, fn):
        hier.reset_ledger()
        core.reset_host_reads()
        value = fn()
        led[tag] = {"ledger": hier.ledger_snapshot(),
                    "evals": dict(core.mesh_evals)}
        return value

    mask = torch.as_tensor(data["mask"])
    for lay, m in meshes.items():
        block, n = shard_sparse_rows(csr, m)
        res[lay + "-csr-values"] = block.values.numpy()
        res[lay + "-csr-cols"] = block.cols.numpy()
        host = sparse_ops.ell_from_csr(csr)
        host = sparse_ops.SparseRows(host.values.view(Watched),
                                     host.cols.view(Watched), host.d)
        Watched.seen.clear()
        block, _ = shard_sparse_rows(host, m, torch.bfloat16)
        res[lay + "-host-values"] = block.values.float().numpy()
        res[lay + "-host-cols"] = block.cols.numpy()
        led[lay + "-host-seen"] = list(Watched.seen)
        d = prepare_data(csr, y=data["y"], sample_weight=data["w"], mesh=m,
                         shard_features=True, append_ones=True)
        res[lay + "-prep-values"] = d.X.values.numpy()
        res[lay + "-prep-cols"] = d.X.cols.numpy()
        res[lay + "-prep-w"] = d.weights.numpy()
        res[lay + "-prep-meta"] = np.array([d.n, d.n_padded, d.row_offset,
                                            d.n_features, d.X.d])
        if lay == "model":
            continue
        d = prepare_data(Ai, y=data["y"], mesh=m)
        for solver, kw in cases["solvers"].items():
            b, it = run(f"{lay}-{solver}", lambda: core.solve(
                solver, d.X, d.y, d.weights, torch.zeros(d.X.d), mask,
                mesh=m, family="logistic", max_iter=25, tol=1e-4, **kw))
            res[f"{lay}-{solver}"] = b.numpy()
            res[f"{lay}-{solver}_n"] = np.array(it)
        d3 = prepare_data(Ai, y=data["y3"], mesh=m)
        B, it = run(f"{lay}-mn", lambda: core.multinomial_lbfgs(
            d3.X, d3.y, d3.weights, torch.zeros((d3.X.d, 3)), mask,
            n_classes=3, lamduh=1.0, max_iter=30, mesh=m))
        res[f"{lay}-mn"], res[f"{lay}-mn_n"] = B.numpy(), np.array(it)
        z, it = run(f"{lay}-admm", lambda: core.admm(
            d.X, d.y, d.weights, torch.zeros(d.X.d), mask, mesh=m,
            **cases["admm"]))
        res[f"{lay}-admm"], res[f"{lay}-admm_n"] = z.numpy(), np.array(it)
        with mesh_lib.use_mesh(m):
            est = run(f"{lay}-facade", lambda: LogisticRegression(
                solver="lbfgs", max_iter=30).fit(csr, data["yb"]))
        res[f"{lay}-facade"] = np.append(est.coef_, est.intercept_)
        res[f"{lay}-facade_n"] = np.array(est.n_iter_)
        res[f"{lay}-facade_p"] = est.predict(csr[:60])
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    with open(os.path.join(out, "ledger%d.json" % rank), "w") as f:
        json.dump(led, f)
    runtime.shutdown()
""")


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    dense = (rng.standard_normal((N, D))
             * (rng.uniform(size=(N, D)) < 0.3)).astype(np.float32)
    dense[5] = 0.0  # an empty row
    beta = rng.standard_normal(D).astype(np.float32)
    eta = dense @ beta
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-eta))).astype(np.float32)
    csr = sp.csr_matrix(dense)
    Xi = np.concatenate([dense, np.ones((N, 1), np.float32)], axis=1)
    Ai = sp.csr_matrix(Xi)
    mask = np.ones(D1, np.float32)
    mask[-1] = 0.0
    return {"dense": dense, "Xi": Xi, "y": y,
            "yb": np.where(y > 0, 3, 1),
            "y3": np.argmax(dense[:, :3] + 0.4 * rng.standard_normal(
                (N, 3)), axis=1).astype(np.float32),
            "w": rng.uniform(0.5, 1.5, N).astype(np.float32), "mask": mask,
            "csr_data": csr.data, "csr_indices": csr.indices,
            "csr_indptr": csr.indptr, "csr_shape": np.array(csr.shape),
            "ai_data": Ai.data, "ai_indices": Ai.indices,
            "ai_indptr": Ai.indptr, "ai_shape": np.array(Ai.shape)}


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
def inputs():
    return _problem()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    procs = {}
    cases = {"solvers": SOLVERS, "admm": ADMM_KW}
    for world in sorted({w for w, _ in LAYOUTS}):
        out = tmp_path_factory.mktemp(f"sparse-world{world}")
        np.savez(out / "data.npz", **inputs)
        (out / "cases.json").write_text(json.dumps(cases))
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


def _shard(arr, dev):
    return np.asarray(next(s for s in arr.addressable_shards
                           if s.device == dev).data)


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
def test_shard_sparse_rows_blocks_are_the_jax_shards(inputs, worlds, world,
                                                     layout):
    csr = sp.csr_matrix(inputs["dense"])
    jm = _jax_mesh(world, layout)
    with jconfig.config_context(pad_policy=None):
        js, n = jsharding.shard_sparse_rows(csr, jm)
        jb, _ = jsharding.shard_sparse_rows(csr, jm, jnp.bfloat16)
        jd = jprepare(csr, y=inputs["y"], sample_weight=inputs["w"],
                      mesh=jm, shard_features=True, append_ones=True)
    assert n == N
    for r, (arrays, ledgers) in enumerate(worlds[world]):
        dev = jax.devices()[r]
        for pre, jsr in (("csr", js), ("host", jb), ("prep", jd.X)):
            assert np.array_equal(arrays[f"{layout}-{pre}-values"],
                                  _shard(jsr.values, dev).astype(np.float32))
            assert np.array_equal(arrays[f"{layout}-{pre}-cols"],
                                  _shard(jsr.cols, dev))
        assert np.array_equal(arrays[f"{layout}-prep-w"],
                              _shard(jd.weights, dev))
        n_, n_pad, off, nf, d = arrays[f"{layout}-prep-meta"]
        assert (n_, n_pad, nf, d) == (N, jd.n_padded, D1, D1)
        assert off == _shard_index(jd.X.values, dev)


def _shard_index(arr, dev):
    return next(s for s in arr.addressable_shards
                if s.device == dev).index[0].start or 0


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
def test_a_rank_reads_only_its_rows_of_the_host_container(worlds, world,
                                                          layout):
    from dask_ml_tpu_torch.parallel.mesh import Mesh, data_sharding

    m = _port_mesh(world, layout)
    n_pad = -(-N // mesh_lib.n_data_shards(m)) * mesh_lib.n_data_shards(m)
    for r, (arrays, ledgers) in enumerate(worlds[world]):
        rows = data_sharding(Mesh(m.devices, m.axis_names, rank=r)).rows(
            n_pad)
        want = repr(slice(rows.start, min(rows.stop, N)))
        assert ledgers[f"{layout}-host-seen"] == [want, want]
        assert arrays[f"{layout}-host-values"].shape[0] == n_pad // \
            mesh_lib.n_data_shards(m)


# ---------------------------------------------------------------------------
# the sparse solvers in a world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_fits(inputs):
    out = {}
    Ai = sp.csr_matrix(inputs["Xi"])
    mask = jnp.asarray(inputs["mask"])
    with jconfig.config_context(pad_policy=None):
        for world, lay in ROW_LAYOUTS:
            jm = _jax_mesh(world, lay)
            jd = jprepare(Ai, y=inputs["y"], mesh=jm, y_dtype=jnp.float32)
            for solver, kw in SOLVERS.items():
                out[(world, lay, solver)] = getattr(jcore, solver)(
                    jd.X, jd.y, jd.weights, jnp.zeros(D1), mask,
                    family="logistic", max_iter=25, tol=1e-4, **kw)
            j3 = jprepare(Ai, y=inputs["y3"], mesh=jm, y_dtype=jnp.float32)
            out[(world, lay, "mn")] = jcore.multinomial_lbfgs(
                j3.X, j3.y, j3.weights, jnp.zeros((D1, K)), mask,
                n_classes=K, lamduh=1.0, max_iter=30)
            jdd = jprepare(inputs["Xi"], y=inputs["y"], mesh=jm,
                           y_dtype=jnp.float32)
            out[(world, lay, "admm")] = jcore.admm(
                jdd.X, jdd.y, jdd.weights, jnp.zeros(D1), mask, jm,
                **ADMM_KW)
            if lay == "flat":
                with jmesh.use_mesh(jm):
                    est = jlm.LogisticRegression(solver="lbfgs", max_iter=30)
                    est.fit(sp.csr_matrix(inputs["dense"]), inputs["yb"])
                out[(world, lay, "facade")] = (
                    np.append(est.coef_, est.intercept_), est.n_iter_,
                    np.asarray(est.predict(sp.csr_matrix(
                        inputs["dense"][:60]))))
    return out


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_sparse_solver_matches_jax(worlds, jax_fits, world, layout, solver):
    bj, nj = jax_fits[(world, layout, solver)]
    for arrays, _ in worlds[world]:
        assert int(arrays[f"{layout}-{solver}_n"]) == int(nj)
        np.testing.assert_allclose(arrays[f"{layout}-{solver}"],
                                   np.asarray(bj), **COEF_TOL)


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_sparse_solver_close_to_one_device(inputs, worlds, world, layout,
                                           solver):
    A = tsps.ell_from_csr(sp.csr_matrix(inputs["Xi"]))
    with config_context(device="cpu"):
        b, n = tcore.solve(solver, A.to("cpu"), torch.as_tensor(inputs["y"]),
                           torch.ones(N), torch.zeros(D1),
                           torch.as_tensor(inputs["mask"]),
                           family="logistic", max_iter=25, tol=1e-4,
                           **SOLVERS[solver])
    for arrays, _ in worlds[world]:
        assert int(arrays[f"{layout}-{solver}_n"]) == n
        np.testing.assert_allclose(arrays[f"{layout}-{solver}"], b.numpy(),
                                   **COEF_TOL)


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
def test_sparse_multinomial_lbfgs_matches_jax(worlds, jax_fits, world,
                                              layout):
    Bj, nj = jax_fits[(world, layout, "mn")]
    for arrays, _ in worlds[world]:
        assert int(arrays[f"{layout}-mn_n"]) == int(nj)
        np.testing.assert_allclose(arrays[f"{layout}-mn"], np.asarray(Bj),
                                   **COEF_TOL)


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
def test_sparse_admm_against_dense_jax_and_one_device(inputs, worlds,
                                                      jax_fits, world,
                                                      layout):
    zj, nj = jax_fits[(world, layout, "admm")]
    pad = (-N) % world
    Xp = np.concatenate([inputs["Xi"], np.zeros((pad, D1), np.float32)])
    yp = np.concatenate([inputs["y"], np.zeros(pad, np.float32)])
    wp = np.concatenate([np.ones(N, np.float32), np.zeros(pad, np.float32)])
    with config_context(device="cpu"):
        zs, ns = tcore.admm(tsps.ell_from_csr(sp.csr_matrix(Xp)).to("cpu"),
                            torch.as_tensor(yp), torch.as_tensor(wp),
                            torch.zeros(D1), torch.as_tensor(inputs["mask"]),
                            n_shards=world, **ADMM_KW)
    assert ns == int(nj)
    np.testing.assert_allclose(zs.numpy(), np.asarray(zj), **ADMM_TOL)
    for arrays, _ in worlds[world]:
        assert int(arrays[f"{layout}-admm_n"]) == ns
        np.testing.assert_allclose(arrays[f"{layout}-admm"], zs.numpy(),
                                   **ADMM_TOL)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_sparse_facade_matches_the_jax_facade(worlds, jax_fits, world):
    cj, nj, pj = jax_fits[(world, "flat", "facade")]
    for arrays, _ in worlds[world]:
        assert int(arrays["flat-facade_n"]) == int(nj)
        np.testing.assert_allclose(arrays["flat-facade"], cj, **COEF_TOL)
        assert np.array_equal(arrays["flat-facade_p"], pj)


def test_every_rank_holds_the_same_fit(worlds):
    for world, ranks in worlds.items():
        for key, v in ranks[0][0].items():
            if "-csr-" in key or "-host-" in key or "-prep-" in key:
                continue
            for arrays, _ in ranks[1:]:
                assert np.array_equal(arrays[key], v), (world, key)


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


def _calls(snap, m, op):
    got = {snap["calls"].get(f"{ax}/{op}", 0)
           for ax in hier.collective_bytes(m, 4)}
    assert len(got) == 1, got
    return got.pop()


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
@pytest.mark.parametrize("tag,width", [("lbfgs", 1), ("newton", 1),
                                       ("gradient_descent", 1), ("mn", K)])
def test_sparse_ledger_is_the_formula(worlds, world, layout, tag, width):
    m = _port_mesh(world, layout)
    jm = _jax_mesh(world, layout)
    for _, ledgers in worlds[world]:
        snap, ev = (ledgers[f"{layout}-{tag}"]["ledger"],
                    ledgers[f"{layout}-{tag}"]["evals"])
        nbytes = D1 * width * 4
        assert hier.collective_bytes(m, nbytes) == \
            jhier.collective_bytes(jm, nbytes)
        assert _calls(snap, m, "sparse.pullback") == ev["grad"] >= 1
        assert snap["ops"]["sparse.pullback"] == {
            ax: b * ev["grad"]
            for ax, b in hier.collective_bytes(m, nbytes).items()}
        assert _calls(snap, m, "glm.value") == ev["value"]
        assert _calls(snap, m, "sparse.gram") == ev["gram"]
        if ev["gram"]:
            assert snap["ops"]["sparse.gram"] == {
                ax: b * ev["gram"]
                for ax, b in hier.collective_bytes(m, D1 * D1 * 4).items()}
        assert "glm.grad" not in snap["ops"]
        if world == 1:
            assert set(snap["bytes"].values()) == {0}


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
def test_sparse_admm_reduces_only_the_consensus(worlds, world, layout):
    """ADMM's local solves contract each rank's own rows: no
    ``sparse.pullback`` crosses the ranks, only the consensus sums."""
    for arrays, ledgers in worlds[world]:
        snap = ledgers[f"{layout}-admm"]["ledger"]
        assert set(snap["ops"]) == {"glm.admm.sw", "glm.admm.consensus",
                                    "glm.admm.residuals"}
