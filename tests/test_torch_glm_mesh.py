"""The GLM solvers and facades over a mesh of ranks (the port's
``torch.distributed`` worlds) held against the JAX package's meshes, on
the CPU.

Each world is spawned once for the module: ``N`` processes join one gloo
world through a ``file://`` store in ``tmp_path`` and run every case of
:data:`WORKER` on their blocks of the same data, one ``.npz`` and one
ledger ``.json`` a rank. The JAX side runs here on the matching slice of
the 8 virtual devices (flat, hierarchical ``(p, c)``, ``("data",
"model")`` 2 × 2 and ``("pod", "chip", "model")`` 1 × 2 × 2). Staging runs
with ``pad_policy=None``: 403 rows pad to a multiple of the shard count.

Tolerances and their reasons:

- the smooth solvers (gradient descent, Newton, L-BFGS, proximal
  gradient, softmax L-BFGS): within rtol 1e-4 / atol 1e-5 of the JAX
  solver on the same mesh, with the same ``n_iter`` (the sums over the
  ranks add the blocks' partials in another order than XLA's, and an
  iterative solver carries the ulps forward; ``tests/test_torch_glm.py``'s
  tolerance);
- ADMM: the world of S ranks, the port's one-device ``n_shards=S`` fit on
  the same padded rows and the JAX fit on S devices within rtol 1e-5 /
  atol 1e-6 of each other, with the same ``n_iter``;
- the model layouts split the predictor's sum over column blocks: rtol
  1e-4 / atol 1e-5 and the same ``n_iter``;
- every rank holds the same coefficients bit for bit: every value the
  ranks iterate on is a sum every rank receives whole;
- a checkpointed fit interrupted and resumed in a world of 2 equals the
  uninterrupted one bit for bit; a snapshot of either package resumed in
  the other within rtol 1e-5 of that package's uninterrupted fit, with the
  same iteration count; the fingerprint of integer-valued data equals the
  JAX one (every sum of its moments is exact).

The ledger holds each op's bytes a call to ``collective_bytes`` of the JAX
operand and its calls to the evaluations the solvers count
(``models.glm.mesh_evals``). JAX's model-axis collective test is red in
its own suite and is not a reference here.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu import checkpoint as jck
from dask_ml_tpu import config as jconfig
from dask_ml_tpu import linear_model as jlm
from dask_ml_tpu.models import glm as jcore
from dask_ml_tpu.parallel import hierarchy as jhier
from dask_ml_tpu.parallel import mesh as jmesh
from dask_ml_tpu.parallel.sharding import prepare_data as jprepare
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.models import glm as tcore
from dask_ml_tpu_torch.parallel import hierarchy as hier
from dask_ml_tpu_torch.parallel import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 420

N, D = 403, 6
D1 = D + 1
K = 3
COEF_TOL = dict(rtol=1e-4, atol=1e-5)
ADMM_TOL = dict(rtol=1e-5, atol=1e-6)

#: (world, layout) pairs the worlds run
LAYOUTS = [(1, "flat"), (2, "flat"), (3, "flat"), (3, "hier"),
           (4, "flat"), (4, "hier"), (4, "model"), (4, "hmodel")]
ROW_LAYOUTS = [(w, lay) for w, lay in LAYOUTS if lay in ("flat", "hier")]
MODEL_LAYOUTS = [(4, "model"), (4, "hmodel")]

#: (solver, family, solver kwargs) of the core smooth-solver cases, on
#: the problem of ``tests/test_torch_glm.py`` (:func:`_core_problem`),
#: whose one-device parity test pins the same ``n_iter``
SOLVER_CASES = {
    "gradient_descent": ("normal", {}),
    "newton": ("logistic", {}),
    "lbfgs": ("logistic", {"regularizer": "l2", "lamduh": 1.0}),
    # ISTA stops on a step-size test that the Poisson case meets within
    # f32 noise: the JAX package's own n_iter there moves with the mesh
    "proximal_grad": ("normal", {"regularizer": "l1", "lamduh": 1.0}),
}
NC, DC = 200, 12
ADMM_KW = dict(family="logistic", regularizer="l2", lamduh=1.0, rho=0.1,
               max_iter=60)
CK_KW = dict(family="logistic", regularizer="l2", lamduh=1.0, rho=0.1)

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
    from dask_ml_tpu_torch import checkpoint as ck
    from dask_ml_tpu_torch.linear_model import (LinearRegression,
                                                LogisticRegression,
                                                PoissonRegression)
    from dask_ml_tpu_torch.models import glm as core
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    data = np.load(os.path.join(out, "data.npz"))
    cases = json.loads(open(os.path.join(out, "cases.json")).read())
    res, led = {}, {}
    meshes = {"flat": mesh_lib.make_mesh()}
    if world > 1 and world != 2:
        meshes["hier"] = hier.make_hierarchical_mesh(
            2 if world % 2 == 0 else 1)
    if world == 4:
        meshes["model"] = mesh_lib.make_2d_mesh(2, 2)
        meshes["hmodel"] = hier.make_hierarchical_mesh(1, 2,
                                                       model_parallel=2)

    def run(tag, fn):
        hier.reset_ledger()
        core.reset_host_reads()
        value = fn()
        led[tag] = {"ledger": hier.ledger_snapshot(),
                    "evals": dict(core.mesh_evals)}
        return value

    Xi, X, mask = data["Xi"], data["X"], torch.as_tensor(data["mask"])
    D1 = Xi.shape[1]
    for lay, m in meshes.items():
        if lay in ("model", "hmodel"):
            d = prepare_data(Xi, y=data["y_logistic"], mesh=m,
                             shard_features=True)
            width = d.X.shape[1] * mesh_lib.n_model_shards(m)
            maskp = torch.zeros(width)
            maskp[:D1 - 1] = 1.0
            for solver in ("newton", "lbfgs"):
                b, it = run(f"{lay}-core-{solver}", lambda: core.solve(
                    solver, d.X, d.y, d.weights, torch.zeros(width), maskp,
                    mesh=m, family="logistic", lamduh=0.1, tol=1e-6,
                    max_iter=50))
                res[f"{lay}-core-{solver}"] = b.numpy()
                res[f"{lay}-core-{solver}_n"] = np.array(it)
            with mesh_lib.use_mesh(m):
                res[f"{lay}-batched-declined"] = np.array(
                    LogisticRegression(solver="lbfgs")._batched_fit_score(
                        X, data["yb"], [{"C": 1.0}], []) is NotImplemented)
                for solver in ("newton", "admm"):
                    est = run(f"{lay}-facade-{solver}",
                              lambda: LogisticRegression(
                                  solver=solver, C=2.0, max_iter=40,
                                  tol=1e-6).fit(X, data["yb"]))
                    res[f"{lay}-facade-{solver}"] = np.append(
                        est.coef_, est.intercept_)
                    res[f"{lay}-facade-{solver}_n"] = np.array(est.n_iter_)
            continue
        for solver, (family, kw) in cases["solvers"].items():
            d = prepare_data(data["core_X"], y=data["core_" + family],
                             mesh=m)
            b, it = run(f"{lay}-{solver}", lambda: core.solve(
                solver, d.X, d.y, d.weights, torch.zeros(d.X.shape[1]),
                torch.as_tensor(data["core_mask"]), mesh=m, family=family,
                max_iter=25, tol=1e-4, **kw))
            res[f"{lay}-{solver}"] = b.numpy()
            res[f"{lay}-{solver}_n"] = np.array(it)
        d = prepare_data(Xi, y=data["y3"], mesh=m)
        B, it = run(f"{lay}-mn-lbfgs", lambda: core.multinomial_lbfgs(
            d.X, d.y, d.weights, torch.zeros((D1, 3)), mask, n_classes=3,
            lamduh=1.0, max_iter=30, mesh=m))
        res[f"{lay}-mn-lbfgs"], res[f"{lay}-mn-lbfgs_n"] = B.numpy(), it
        d = prepare_data(Xi, y=data["y_logistic"], mesh=m)
        z, it, (_, x, u), done = run(f"{lay}-admm", lambda: core.admm(
            d.X, d.y, d.weights, torch.zeros(D1), mask, mesh=m,
            return_state=True, **cases["admm"]))
        for key, v in (("z", z), ("x", x), ("u", u)):
            res[f"{lay}-admm-{key}"] = v.numpy()
        res[f"{lay}-admm_n"] = np.array(it)
        if lay == "flat":
            d = prepare_data(Xi, y=data["y3"], mesh=m)
            B, it = run("flat-mn-admm", lambda: core.admm_multinomial(
                d.X, d.y, d.weights, torch.zeros((D1, 3)), mask,
                n_classes=3, lamduh=1.0, rho=0.1, max_iter=30, mesh=m))
            res["flat-mn-admm"], res["flat-mn-admm_n"] = B.numpy(), it
            try:
                core.admm(d.X, d.y, d.weights, torch.zeros(D1), mask,
                          mesh=m, state=(torch.zeros(D1),
                                         torch.zeros((world + 1, D1)),
                                         torch.zeros((world + 1, D1))))
            except ValueError as e:
                res["admm_state_refused"] = np.array("shard" in str(e))
        with mesh_lib.use_mesh(m):
            got = LogisticRegression(solver="lbfgs")._batched_fit_score(
                X, data["yb"], [{"C": 1.0}, {"C": 0.5}], [])
            res[f"{lay}-batched-coef"] = got["coef"].numpy()
            one = LogisticRegression(solver="lbfgs").fit(X, data["yb"])
            res[f"{lay}-batched-single"] = np.append(one.coef_,
                                                     one.intercept_)
            for tag, make, y in (
                    ("lr-lbfgs", lambda: LogisticRegression(
                        solver="lbfgs", max_iter=30), data["yb"]),
                    ("lr-admm", lambda: LogisticRegression(max_iter=30),
                     data["yb"]),
                    ("lr-ovr", lambda: LogisticRegression(
                        solver="newton", max_iter=20), data["y3"]),
                    ("lr-mn", lambda: LogisticRegression(
                        solver="lbfgs", multiclass="multinomial",
                        max_iter=30), data["y3"]),
                    ("linear-newton", lambda: LinearRegression(
                        solver="newton", max_iter=20), data["y_normal"])):
                est = run(f"{lay}-{tag}", lambda: make().fit(X, y))
                res[f"{lay}-{tag}"] = np.append(
                    np.asarray(est.coef_).ravel(),
                    np.asarray(est.intercept_).ravel())
                res[f"{lay}-{tag}_n"] = np.array(est.n_iter_)
                res[f"{lay}-{tag}_p"] = est.predict(X[:50])
    if world == 2:
        m = meshes["flat"]
        d = prepare_data(data["Xc"], y=data["yc"], mesh=m)
        args = (d.X, d.y, d.weights, torch.zeros(D1), mask)
        res["ck-fingerprint"] = np.array(ck.problem_fingerprint(
            "admm", *args, mesh=m, **cases["ck"]))
        for tag, runs in (("full", (20,)), ("part", (8, 20)),
                          ("port8", (8,)), ("jax8", (20,))):
            for max_iter in runs:
                z, it = ck.solve_checkpointed(
                    "admm", *args, m, path=os.path.join(out, "ck-" + tag),
                    chunk_iters=4, max_iter=max_iter, **cases["ck"])
            res["ck-" + tag] = z.numpy()
            res["ck-" + tag + "_n"] = np.array(it)
        prefix = os.path.join(out, "lr")
        for tag, ckpt in (("plain", None), ("ckpt", prefix)):
            est = LogisticRegression(solver="lbfgs", max_iter=30,
                                     checkpoint=ckpt, checkpoint_every=4)
            est.fit(X, data["yb"])
            res["facade-" + tag] = np.append(est.coef_, est.intercept_)
            res["facade-" + tag + "_n"] = np.array(est.n_iter_)
        res["facade-snapshots"] = np.array(sorted(
            f for f in os.listdir(out) if f.startswith("lr.")))
        for tag, make, y in (
                ("poisson", lambda: PoissonRegression(solver="lbfgs",
                                                      max_iter=30),
                 data["y_poisson"]),):
            est = make().fit(X, y)
            res["facade-" + tag] = np.append(est.coef_, est.intercept_)
            res["facade-" + tag + "_n"] = np.array(est.n_iter_)
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    with open(os.path.join(out, "ledger%d.json" % rank), "w") as f:
        json.dump(led, f)
    runtime.shutdown()
""")


def _core_problem(seed=0, n=NC, d=DC):
    """``tests/test_torch_glm.py``'s problem: a sparse-ish float design
    with the intercept column and targets for the three families."""
    rng = np.random.RandomState(seed)
    dense = (rng.standard_normal((n, d))
             * (rng.uniform(size=(n, d)) < 0.4)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    eta = dense @ beta
    mask = np.ones(d + 1, np.float32)
    mask[-1] = 0.0
    return {
        "core_X": np.concatenate([dense, np.ones((n, 1), np.float32)], 1),
        "core_mask": mask,
        "core_logistic": (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))
                          ).astype(np.float32),
        "core_normal": (eta + 0.3 * rng.standard_normal(n)).astype(
            np.float32),
        "core_poisson": rng.poisson(np.exp(0.3 * eta)).astype(np.float32)}


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    beta = rng.standard_normal(D).astype(np.float32)
    eta = X @ beta
    out = {"X": X,
           "Xi": np.concatenate([X, np.ones((N, 1), np.float32)], axis=1),
           "y_logistic": (rng.uniform(size=N) < 1 / (1 + np.exp(-eta))
                          ).astype(np.float32),
           "y_normal": (eta + 0.3 * rng.standard_normal(N)).astype(
               np.float32),
           "y_poisson": rng.poisson(np.exp(0.3 * eta)).astype(np.float32),
           "y3": np.argmax(X[:, :3] + 0.5 * rng.standard_normal((N, 3)),
                           axis=1).astype(np.float32)}
    out["yb"] = np.where(out["y_logistic"] > 0, 7, 5)
    mask = np.ones(D1, np.float32)
    mask[-1] = 0.0
    out["mask"] = mask
    # the checkpoint problem: integer-valued, so that every moment of the
    # fingerprint is an exact sum
    Xc = rng.randint(-3, 4, (300, D)).astype(np.float32)
    out["Xc"] = np.concatenate([Xc, np.ones((300, 1), np.float32)], axis=1)
    out["yc"] = (Xc[:, 0] + Xc[:, 1] + rng.randint(-2, 3, 300) > 0).astype(
        np.float32)
    out.update(_core_problem())
    return out


def _jax_mesh(world, layout):
    devs = jax.devices()[:world]
    if layout == "flat":
        return jmesh.make_mesh(devices=devs)
    if layout == "hier":
        return jhier.make_hierarchical_mesh(2 if world % 2 == 0 else 1,
                                            devices=devs)
    if layout == "model":
        return jmesh.make_2d_mesh(2, 2, devices=devs)
    return jhier.make_hierarchical_mesh(1, 2, devices=devs, model_parallel=2)


def _port_mesh(world, layout):
    devs = range(world)
    if layout == "flat":
        return mesh_lib.make_mesh(devices=devs)
    if layout == "hier":
        return hier.make_hierarchical_mesh(2 if world % 2 == 0 else 1,
                                           devices=devs)
    if layout == "model":
        return mesh_lib.make_2d_mesh(2, 2, devices=devs)
    return hier.make_hierarchical_mesh(1, 2, devices=devs, model_parallel=2)


def _jax_ck(data, max_iter, path=None):
    """The JAX package's checkpointed ADMM on 2 virtual devices."""
    jm = jmesh.make_mesh(devices=jax.devices()[:2])
    with jconfig.config_context(pad_policy=None):
        jd = jprepare(data["Xc"], y=data["yc"], mesh=jm,
                      y_dtype=jnp.float32)
        args = (jd.X, jd.y, jd.weights, jnp.zeros(D1),
                jnp.asarray(data["mask"]))
        fp = jck.problem_fingerprint("admm", *args, **CK_KW)
        if path is None:
            return fp
        z, it = jck.solve_checkpointed("admm", *args, jm, path=path,
                                       chunk_iters=4, max_iter=max_iter,
                                       **CK_KW)
    return np.asarray(z), int(it)


@pytest.fixture(scope="module")
def inputs():
    return _problem()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """Every world spawned at once, each rank's outputs loaded: {world:
    [(arrays, ledgers) per rank]}. The world of 2 resumes a JAX snapshot
    of 8 iterations written here first."""
    procs = {}
    cases = {"solvers": {s: list(v) for s, v in SOLVER_CASES.items()},
             "admm": ADMM_KW, "ck": CK_KW}
    for world in sorted({w for w, _ in LAYOUTS} | {2}):
        out = tmp_path_factory.mktemp(f"glm-world{world}")
        np.savez(out / "data.npz", **inputs)
        (out / "cases.json").write_text(json.dumps(cases))
        if world == 2:
            _jax_ck(inputs, 8, str(out / "ck-jax8"))
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
            results[world] = {
                "out": out,
                "ranks": [(dict(np.load(out / f"rank{r}.npz")),
                           json.loads((out / f"ledger{r}.json").read_text()))
                          for r in range(len(ps))]}
    assert not errors, "\n".join(errors)
    return results


@pytest.fixture(scope="module")
def jax_fits(inputs):
    """The JAX package's solvers on each matching mesh."""
    out = {}
    Xi, mask = inputs["Xi"], jnp.asarray(inputs["mask"])
    with jconfig.config_context(pad_policy=None):
        for world, lay in ROW_LAYOUTS:
            jm = _jax_mesh(world, lay)
            for solver, (family, kw) in SOLVER_CASES.items():
                jd = jprepare(inputs["core_X"], y=inputs["core_" + family],
                              mesh=jm, y_dtype=jnp.float32)
                out[(world, lay, solver)] = getattr(jcore, solver)(
                    jd.X, jd.y, jd.weights, jnp.zeros(DC + 1),
                    jnp.asarray(inputs["core_mask"]), family=family,
                    max_iter=25, tol=1e-4, **kw)
            jd = jprepare(Xi, y=inputs["y3"], mesh=jm, y_dtype=jnp.float32)
            out[(world, lay, "mn-lbfgs")] = jcore.multinomial_lbfgs(
                jd.X, jd.y, jd.weights, jnp.zeros((D1, K)), mask,
                n_classes=K, lamduh=1.0, max_iter=30)
            if lay == "flat":
                out[(world, lay, "mn-admm")] = jcore.admm_multinomial(
                    jd.X, jd.y, jd.weights, jnp.zeros((D1, K)), mask, jm,
                    n_classes=K, lamduh=1.0, rho=0.1, max_iter=30)
            jd = jprepare(Xi, y=inputs["y_logistic"], mesh=jm,
                          y_dtype=jnp.float32)
            out[(world, lay, "admm")] = jcore.admm(
                jd.X, jd.y, jd.weights, jnp.zeros(D1), mask, jm,
                return_state=True, **ADMM_KW)
        for world, lay in MODEL_LAYOUTS:
            jm = _jax_mesh(world, lay)
            jd = jprepare(Xi, y=inputs["y_logistic"], mesh=jm,
                          y_dtype=jnp.float32, shard_features=True)
            width = int(jd.X.shape[1])
            maskp = jnp.zeros(width).at[:D].set(1.0)
            for solver in ("newton", "lbfgs"):
                out[(world, lay, "core-" + solver)] = getattr(
                    jcore, solver)(jd.X, jd.y, jd.weights, jnp.zeros(width),
                                   maskp, family="logistic", lamduh=0.1,
                                   tol=1e-6, max_iter=50)
    return out


@pytest.fixture(scope="module")
def jax_facades(inputs):
    out = {}
    X = inputs["X"]
    with jconfig.config_context(pad_policy=None):
        for world, lay in LAYOUTS:
            if lay not in ("flat", "model", "hmodel") or world == 3:
                continue
            with jmesh.use_mesh(_jax_mesh(world, lay)):
                if lay == "flat":
                    cases = {
                        "lr-lbfgs": (jlm.LogisticRegression(
                            solver="lbfgs", max_iter=30), inputs["yb"]),
                        "lr-admm": (jlm.LogisticRegression(max_iter=30),
                                    inputs["yb"]),
                        "linear-newton": (jlm.LinearRegression(
                            solver="newton", max_iter=20),
                            inputs["y_normal"])}
                else:
                    cases = {f"facade-{s}": (jlm.LogisticRegression(
                        solver=s, C=2.0, max_iter=40, tol=1e-6),
                        inputs["yb"]) for s in ("newton", "admm")}
                for tag, (est, y) in cases.items():
                    est.fit(X, y)
                    out[(world, lay, tag)] = (
                        np.append(est.coef_, est.intercept_), est.n_iter_,
                        np.asarray(est.predict(X[:50])))
    return out


@pytest.fixture(scope="module")
def single(inputs):
    """The port's one-device fits, in this process."""
    from dask_ml_tpu_torch.linear_model import (LinearRegression,
                                                LogisticRegression)

    X = inputs["X"]
    out = {}
    with config_context(device="cpu"):
        for tag, est, y in (
                ("lr-lbfgs", LogisticRegression(solver="lbfgs", max_iter=30),
                 inputs["yb"]),
                ("lr-ovr", LogisticRegression(solver="newton", max_iter=20),
                 inputs["y3"]),
                ("lr-mn", LogisticRegression(solver="lbfgs",
                                             multiclass="multinomial",
                                             max_iter=30), inputs["y3"]),
                ("linear-newton", LinearRegression(solver="newton",
                                                   max_iter=20),
                 inputs["y_normal"])):
            est.fit(X, y)
            out[tag] = (np.append(np.asarray(est.coef_).ravel(),
                                  np.asarray(est.intercept_).ravel()),
                        est.n_iter_, est.predict(X[:50]))
    return out


def _ids(pairs):
    return [f"w{w}-{lay}" for w, lay in pairs]


def _padded(inputs, world, key):
    """``inputs[key]`` padded with zero rows to a multiple of ``world``."""
    a = inputs[key]
    pad = (-len(a)) % world
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


# ---------------------------------------------------------------------------
# the core solvers against the JAX package's on the matching mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
@pytest.mark.parametrize("solver", list(SOLVER_CASES))
def test_smooth_solver_matches_jax(worlds, jax_fits, world, layout, solver):
    bj, nj = jax_fits[(world, layout, solver)]
    for arrays, _ in worlds[world]["ranks"]:
        assert int(arrays[f"{layout}-{solver}_n"]) == int(nj)
        np.testing.assert_allclose(arrays[f"{layout}-{solver}"],
                                   np.asarray(bj), **COEF_TOL)


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
def test_multinomial_lbfgs_matches_jax(worlds, jax_fits, world, layout):
    Bj, nj = jax_fits[(world, layout, "mn-lbfgs")]
    for arrays, _ in worlds[world]["ranks"]:
        assert int(arrays[f"{layout}-mn-lbfgs_n"]) == int(nj)
        np.testing.assert_allclose(arrays[f"{layout}-mn-lbfgs"],
                                   np.asarray(Bj), **COEF_TOL)


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
def test_admm_world_single_device_and_jax_agree(inputs, worlds, jax_fits,
                                                world, layout):
    """A world of S ranks, the port's ``n_shards=S`` fit on one device
    and the JAX fit on S devices: the same consensus, the same
    ``n_iter``."""
    zj, nj, (_, xj, uj), _ = jax_fits[(world, layout, "admm")]
    Xp, yp = _padded(inputs, world, "Xi"), _padded(inputs, world,
                                                   "y_logistic")
    wp = np.zeros(len(Xp), np.float32)
    wp[:N] = 1.0
    with config_context(device="cpu"):
        zs, ns, (_, xs, us), _ = tcore.admm(
            torch.as_tensor(Xp), torch.as_tensor(yp), torch.as_tensor(wp),
            torch.zeros(D1), torch.as_tensor(inputs["mask"]),
            n_shards=world, return_state=True, **ADMM_KW)
    assert ns == int(nj)
    np.testing.assert_allclose(zs.numpy(), np.asarray(zj), **ADMM_TOL)
    for arrays, _ in worlds[world]["ranks"]:
        assert int(arrays[f"{layout}-admm_n"]) == ns
        np.testing.assert_allclose(arrays[f"{layout}-admm-z"], zs.numpy(),
                                   **ADMM_TOL)
        np.testing.assert_allclose(arrays[f"{layout}-admm-x"], xs.numpy(),
                                   **ADMM_TOL)
        np.testing.assert_allclose(arrays[f"{layout}-admm-u"], np.asarray(uj),
                                   **ADMM_TOL)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_admm_multinomial_matches_jax(worlds, jax_fits, world):
    Bj, nj = jax_fits[(world, "flat", "mn-admm")]
    for arrays, _ in worlds[world]["ranks"]:
        assert int(arrays["flat-mn-admm_n"]) == int(nj)
        np.testing.assert_allclose(arrays["flat-mn-admm"], np.asarray(Bj),
                                   **ADMM_TOL)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_admm_state_of_another_shard_count_raises(worlds, world):
    for arrays, _ in worlds[world]["ranks"]:
        assert bool(arrays["admm_state_refused"])


# ---------------------------------------------------------------------------
# the facades
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("tag", ["lr-lbfgs", "lr-admm", "linear-newton"])
def test_facade_matches_the_jax_facade(worlds, jax_facades, world, tag):
    cj, nj, pj = jax_facades[(world, "flat", tag)]
    for arrays, _ in worlds[world]["ranks"]:
        assert int(arrays[f"flat-{tag}_n"]) == int(nj)
        np.testing.assert_allclose(arrays[f"flat-{tag}"], cj, **COEF_TOL)
        if tag != "linear-newton":
            assert np.array_equal(arrays[f"flat-{tag}_p"], pj)


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
@pytest.mark.parametrize("tag", ["lr-lbfgs", "lr-ovr", "lr-mn",
                                 "linear-newton"])
def test_facade_close_to_the_single_device_fit(worlds, single, world, layout,
                                               tag):
    cs, ns, ps = single[tag]
    for arrays, _ in worlds[world]["ranks"]:
        assert int(arrays[f"{layout}-{tag}_n"]) == ns
        np.testing.assert_allclose(arrays[f"{layout}-{tag}"], cs, **COEF_TOL)
        if tag != "linear-newton":
            assert np.array_equal(arrays[f"{layout}-{tag}_p"], ps)


@pytest.mark.parametrize("world,layout", MODEL_LAYOUTS,
                         ids=_ids(MODEL_LAYOUTS))
@pytest.mark.parametrize("solver", ["newton", "lbfgs"])
def test_core_solver_on_the_model_axis_matches_jax(worlds, jax_fits, world,
                                                   layout, solver):
    bj, nj = jax_fits[(world, layout, "core-" + solver)]
    for arrays, _ in worlds[world]["ranks"]:
        got = arrays[f"{layout}-core-{solver}"]
        assert int(arrays[f"{layout}-core-{solver}_n"]) == int(nj)
        np.testing.assert_allclose(got, np.asarray(bj), **COEF_TOL)
        assert not got[D1:].any()  # the padding columns stay at 0


@pytest.mark.parametrize("world,layout", MODEL_LAYOUTS,
                         ids=_ids(MODEL_LAYOUTS))
@pytest.mark.parametrize("solver", ["newton", "admm"])
def test_facade_on_the_model_axis_matches_jax(worlds, jax_facades, world,
                                              layout, solver):
    """Newton splits X's columns over ``model``; ADMM falls back to the
    data-parallel layout, as the JAX facade does."""
    cj, nj, _ = jax_facades[(world, layout, f"facade-{solver}")]
    for arrays, _ in worlds[world]["ranks"]:
        assert int(arrays[f"{layout}-facade-{solver}_n"]) == int(nj)
        np.testing.assert_allclose(arrays[f"{layout}-facade-{solver}"], cj,
                                   **COEF_TOL)


@pytest.mark.parametrize("world,layout", LAYOUTS, ids=_ids(LAYOUTS))
def test_batched_search_path_stages_the_whole_data(inputs, worlds, world,
                                                  layout):
    """The search's batched GLM path stages each rank's block over the
    mesh (it staged the whole data on every rank until the rest of Queue A
    item 10b landed): its member at C = 1 is the facade's fit over the
    same mesh bit for bit, and every member is the one-device member
    within the smooth solvers' tolerance. It declines on a ``model``
    axis, as the JAX package's does."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    with config_context(device="cpu"):
        want = LogisticRegression(solver="lbfgs")._batched_fit_score(
            inputs["X"], inputs["yb"], [{"C": 1.0}, {"C": 0.5}], [])
    for arrays, _ in worlds[world]["ranks"]:
        if layout in ("model", "hmodel"):
            assert bool(arrays[f"{layout}-batched-declined"])
        else:
            coef = arrays[f"{layout}-batched-coef"]
            assert np.array_equal(coef[0], arrays[f"{layout}-batched-single"])
            np.testing.assert_allclose(coef, want["coef"].numpy(),
                                       **COEF_TOL)


def test_every_rank_holds_the_same_model(worlds):
    for world, got in worlds.items():
        ranks = got["ranks"]
        for key, v in ranks[0][0].items():
            for arrays, _ in ranks[1:]:
                assert np.array_equal(arrays[key], v), (world, key)


# ---------------------------------------------------------------------------
# the traffic ledger
# ---------------------------------------------------------------------------


def _want(m, nbytes, calls):
    if not calls:
        return {}
    return {ax: b * calls for ax, b in hier.collective_bytes(m,
                                                             nbytes).items()}


def _check_op(snap, m, op, nbytes, calls):
    assert snap["ops"].get(op, {}) == _want(m, nbytes, calls), op
    for ax in hier.collective_bytes(m, nbytes):
        assert snap["calls"].get(f"{ax}/{op}", 0) == calls, op


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
@pytest.mark.parametrize("solver", list(SOLVER_CASES))
def test_ledger_of_the_smooth_solvers(worlds, world, layout, solver):
    """``glm.sw`` once, ``glm.value`` a value, ``glm.grad`` a gradient,
    ``glm.gram`` a Newton step, each at the bytes of its operand."""
    m = _port_mesh(world, layout)
    for _, ledgers in worlds[world]["ranks"]:
        entry = ledgers[f"{layout}-{solver}"]
        snap, ev = entry["ledger"], entry["evals"]
        assert ev["value"] >= ev["grad"] >= 1
        _check_op(snap, m, "glm.sw", 4, 1)
        _check_op(snap, m, "glm.value", 4, ev["value"])
        _check_op(snap, m, "glm.grad", (DC + 1) * 4, ev["grad"])
        _check_op(snap, m, "glm.gram", (DC + 1) ** 2 * 4, ev["gram"])
        assert (ev["gram"] > 0) == (solver == "newton")
        if world == 1:
            assert set(snap["bytes"].values()) == {0}


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS, ids=_ids(ROW_LAYOUTS))
def test_ledger_of_admm(worlds, world, layout):
    """Per outer iteration one ``glm.admm.consensus`` of (d,) and the
    JAX package's three scalar ``glm.admm.residuals`` as one (3,) sum."""
    m = _port_mesh(world, layout)
    for arrays, ledgers in worlds[world]["ranks"]:
        snap = ledgers[f"{layout}-admm"]["ledger"]
        it = int(arrays[f"{layout}-admm_n"])
        _check_op(snap, m, "glm.admm.sw", 4, 1)
        _check_op(snap, m, "glm.admm.consensus", D1 * 4, it)
        _check_op(snap, m, "glm.admm.residuals", 3 * 4, it)
        want = {ax: 3 * 4 * it * b // 4 for ax, b in
                jhier.collective_bytes(_jax_mesh(world, layout), 4).items()}
        assert snap["ops"]["glm.admm.residuals"] == want


@pytest.mark.parametrize("world,layout", MODEL_LAYOUTS,
                         ids=_ids(MODEL_LAYOUTS))
def test_ledger_of_the_model_axis(worlds, world, layout):
    """Newton on the model axis: ``glm.matvec`` at the JAX package's
    bytes, ``(m - 1)`` times the padded rows' f32 predictor a call, on the
    ``model`` axis only; the gradient's and the Gram's column blocks
    gathered (the weighted rows, then the Gram's rows); the gradient's
    data sum at the data-parallel bytes of the whole width."""
    m = _port_mesh(world, layout)
    nm, nd = mesh_lib.n_model_shards(m), mesh_lib.n_data_shards(m)
    n_pad = -(-N // nd) * nd
    width = 8
    for _, ledgers in worlds[world]["ranks"]:
        entry = ledgers[f"{layout}-core-newton"]
        snap, ev = entry["ledger"], entry["evals"]
        calls = snap["calls"]["model/glm.matvec"]
        assert calls == ev["value"] + ev["gram"]
        assert snap["ops"]["glm.matvec"] == {"model": calls * (nm - 1)
                                             * n_pad * 4}
        loc = width // nm
        # a model-axis gather forwards m - 1 blocks a data coordinate
        assert snap["ops"]["glm.pullback"] == {
            "model": ev["grad"] * (nm - 1) * loc * 4 * nd}
        assert snap["ops"]["glm.gram.gather"] == {"model": ev["gram"] * (
            nm - 1) * (n_pad * loc + nd * loc * width) * 4}
        grad = {ax: b for ax, b in snap["ops"]["glm.grad"].items()}
        assert grad == _want(m, width // nm * 4, ev["grad"])


# ---------------------------------------------------------------------------
# checkpoints over a mesh
# ---------------------------------------------------------------------------


def test_interrupted_and_resumed_equals_uninterrupted(worlds):
    for arrays, _ in worlds[2]["ranks"]:
        assert np.array_equal(arrays["ck-part"], arrays["ck-full"])
        assert int(arrays["ck-part_n"]) == int(arrays["ck-full_n"])


def test_checkpointed_facade_equals_the_plain_fit(worlds):
    """``LogisticRegression(checkpoint=)`` in a world of 2: chunks of 4
    L-BFGS iterations with the carry saved by rank 0 alone take the
    uninterrupted trajectory; one snapshot for the problem."""
    assert len(worlds[2]["ranks"][0][0]["facade-snapshots"]) == 1
    for arrays, _ in worlds[2]["ranks"]:
        assert np.array_equal(arrays["facade-ckpt"], arrays["facade-plain"])
        assert int(arrays["facade-ckpt_n"]) == int(arrays["facade-plain_n"])


def test_poisson_facade_in_a_world_matches_jax(worlds, inputs):
    jm = jmesh.make_mesh(devices=jax.devices()[:2])
    with jconfig.config_context(pad_policy=None), jmesh.use_mesh(jm):
        je = jlm.PoissonRegression(solver="lbfgs", max_iter=30).fit(
            inputs["X"], inputs["y_poisson"])
    want = np.append(je.coef_, je.intercept_)
    for arrays, _ in worlds[2]["ranks"]:
        assert int(arrays["facade-poisson_n"]) == int(je.n_iter_)
        np.testing.assert_allclose(arrays["facade-poisson"], want,
                                   **COEF_TOL)


def test_fingerprint_equals_the_jax_one(worlds, inputs):
    want = _jax_ck(inputs, None)
    for arrays, _ in worlds[2]["ranks"]:
        assert str(arrays["ck-fingerprint"]) == want


def test_snapshots_resume_across_the_packages(worlds, inputs, tmp_path):
    """The port's 8-iteration snapshot (written by rank 0 alone) resumes
    in the JAX package on 2 devices, and the JAX package's in the world of
    2; either lands on its package's uninterrupted fit."""
    import shutil

    out = worlds[2]["out"]
    zj, nj = _jax_ck(inputs, 20, str(tmp_path / "jax-full"))
    shutil.copy(out / "ck-port8", tmp_path / "port8")
    zr, nr = _jax_ck(inputs, 20, str(tmp_path / "port8"))
    assert nr == nj
    np.testing.assert_allclose(zr, zj, **ADMM_TOL)
    for arrays, _ in worlds[2]["ranks"]:
        assert int(arrays["ck-jax8_n"]) == int(arrays["ck-full_n"])
        np.testing.assert_allclose(arrays["ck-jax8"], arrays["ck-full"],
                                   **ADMM_TOL)
        np.testing.assert_allclose(arrays["ck-full"], zj, **ADMM_TOL)
