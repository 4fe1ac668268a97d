"""The serving loop and fleet over a mesh of ranks, on the CPU.

Worlds of 1, 3 and 4 gloo ranks (flat, and two pods of two at world 4)
register the same fitted models on every rank: a KMeans fitted from an
explicit init on integer-valued blobs, a sketched KMeans (its predict is
K2-x), and a LogisticRegression. Each layout starts
``ServingLoop(mesh=)`` on every rank; the leader (rank 0) takes 8 client
threads' requests of 1 to 250 rows, pads each batch to a bucket aligned to
the shard count, and every rank runs its row block; the followers stop
when the leader's stop reaches them. Then ``ServingFleet(meshes=)`` runs
two replicas, each on its own mesh (world 4: ranks 0–1 and 2–3; world 3:
rank 0 and ranks 1–2, so one replica's group is its mesh plus the leader,
which runs no block of it; world 1: rank 0 twice), with the router and
every queue on rank 0. Last, on the flat mesh, the last rank's runner
raises once, and the leader hot-swaps "km" (and adds a model under a name
that sorts before it) while requests are queued; a fleet over the
replicas' meshes swaps "km" too. Tolerances and their reasons:

- the K2 families are served through the same kernels the direct
  ``predict`` runs, row for row, so a served result equals the direct
  call (made before the loop started, over the same mesh) bit for bit,
  and equals the world-1 result; the GLM's ``predict_proba`` is a product
  whose algorithm may follow the row count (the serving tier's caveat):
  within 1e-5;
- the JAX package's ``ServingLoop(mesh=)`` on the matching virtual mesh,
  serving its KMeans fitted from the same init (the loops agree bit for
  bit on integer data, ``test_torch_kmeans_mesh.py``), answers the same
  requests with the same labels.
"""

import numpy as np
import pytest

import torch_worlds

N, D, K = 1203, 5, 4
SIZES = (1, 7, 31, 33, 64, 100, 129, 250)
MODELS = ("km", "sk", "lr")
CLIENTS, PER_CLIENT = 8, 6

BODY = """
import threading
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.parallel.fleet import ServingFleet
from dask_ml_tpu_torch.parallel.serving import ModelRegistry, ServingLoop

SIZES, MODELS = @SIZES@, @MODELS@
CLIENTS, PER_CLIENT = @CLIENTS@, @PER_CLIENT@
Xi, Xq = data["Xi"], data["Xq"]
km = KMeans(n_clusters=@K@, init=data["c0"], max_iter=20).fit(Xi)
sk = KMeans(n_clusters=8, algorithm="sketched", sketch_cols=2,
            random_state=0, max_iter=20).fit(data["Xs"])
lr = LogisticRegression(solver="lbfgs", max_iter=30).fit(Xi, data["y"])
# the swapped-in version: the same clusters under other labels
km2 = KMeans(n_clusters=@K@, init=data["c0"][::-1].copy(),
             max_iter=20).fit(Xi)
direct = {"km": km.predict(Xq), "sk": sk.predict(data["Xsq"]),
          "lr": lr.predict_proba(Xq), "km2": km2.predict(Xq)}
for name, pred in direct.items():
    res["direct-" + name] = np.asarray(pred)
info["sk-cols"] = int(sk.sketch_vals_.shape[1])


def plan():
    for c in range(CLIENTS):
        for j in range(PER_CLIENT):
            size = SIZES[(c + j) % len(SIZES)]
            model = MODELS[(c + 2 * j) % len(MODELS)]
            pool = data["Xsq"] if model == "sk" else Xq
            lo = (c * 37 + j * 53) % (len(pool) - size)
            yield c, j, model, lo, size, pool


def drive(server, tag):
    got = {}

    def client(c):
        futs = []
        for cc, j, model, lo, size, pool in plan():
            if cc != c:
                continue
            method = "predict_proba" if model == "lr" else "predict"
            futs.append(((c, j), server.submit(model, pool[lo:lo + size],
                                               method=method)))
        for key, f in futs:
            got[key] = f.result(120)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (c, j), pred in got.items():
        res[f"{tag}-{c}-{j}"] = np.asarray(pred)


reg = ModelRegistry()
for name, est in (("km", km), ("sk", sk), ("lr", lr)):
    reg.register(name, est)
for lay, m in layouts(world).items():
    loop = ServingLoop(reg, mesh=m, coalesce_window_s=0.002,
                       name="loop-" + lay).start()
    loop.warmup()
    info[lay + "-role"] = loop.role
    if loop.role == "leader":
        drive(loop, lay)
    loop.stop(timeout=300)
    info[lay + "-batches"] = loop.n_batches
    info[lay + "-stopped"] = bool(loop.stopped)
replicas = {1: [[0], [0]], 3: [[0], [1, 2]], 4: [[0, 1], [2, 3]]}[world]
meshes = [mesh_lib.make_mesh(devices=r) for r in replicas]
fleet = ServingFleet(reg, meshes=meshes, coalesce_window_s=0.002).start()
info["fleet-leads"] = fleet.leads
if fleet.leads:
    fleet.warmup()
    drive(fleet, "fleet")
    info["fleet-served"] = [int(rep.loop.n_batches)
                            for rep in fleet._replicas]
fleet.stop(timeout=300)
info["fleet-follower-batches"] = [int(lp.n_batches)
                                  for lp in fleet._follower_loops]

# a one-shot runner fault on the last rank (a follower; the leader alone
# at world 1), then hot swaps mid-traffic, on the flat mesh
from dask_ml_tpu_torch.parallel import serving as serving_lib

if rank == world - 1:
    build, armed = serving_lib._build_runners, [True]

    def one_fault(est, methods=None):
        runners = build(est, methods)
        for r in runners.values():
            def once(Xs, run=r.run):
                if armed[0]:
                    armed[0] = False
                    raise RuntimeError("injected fault")
                return run(Xs)
            r.run = once
        return runners

    serving_lib._build_runners = one_fault
reg2 = ModelRegistry()
reg2.register("km", km)
loop = ServingLoop(reg2, mesh=layouts(world)["flat"], coalesce_window_s=0.0,
                   name="swap").start()
if loop.role == "leader":
    try:
        loop.submit("km", Xq[:40]).result(120)
        info["fault"] = ""
    except serving_lib.ServingError as e:
        info["fault"] = str(e)
    res["swap-after-fault"] = loop.submit("km", Xq[:100]).result(120)
    before = [loop.submit("km", Xq[i:i + 60]) for i in range(0, 480, 60)]
    reg2.publish("aa", lr)  # a name sorted before "km"
    reg2.publish("km", km2)
    after = [loop.submit("km", Xq[i:i + 60]) for i in range(0, 480, 60)]
    res["swap-aa"] = loop.submit("aa", Xq[:50],
                                 method="predict_proba").result(120)
    res["swap-during"] = np.stack([f.result(120) for f in before])
    res["swap-after"] = np.stack([f.result(120) for f in after])
loop.stop(timeout=300)
info["swap-fatal"] = repr(loop.fatal) if loop.fatal is not None else ""
fleet = ServingFleet(reg, meshes=meshes, coalesce_window_s=0.002,
                     name="swapfleet").start()
if fleet.leads:
    fleet.swap("km", km2)
    res["fleet-swap"] = np.stack([fleet.submit("km", Xq[i:i + 60])
                                  .result(120) for i in range(0, 480, 60)])
fleet.stop(timeout=300)
""".replace("@SIZES@", repr(SIZES)).replace("@MODELS@", repr(MODELS)).replace(
    "@CLIENTS@", str(CLIENTS)).replace("@PER_CLIENT@", str(PER_CLIENT)).replace(
    "@K@", str(K))

CASES = torch_worlds.cases()


def _ids(cases):
    return [f"w{w}-{lay}" for w, lay in cases]


def _plan(inputs):
    for c in range(CLIENTS):
        for j in range(PER_CLIENT):
            size = SIZES[(c + j) % len(SIZES)]
            model = MODELS[(c + 2 * j) % len(MODELS)]
            pool = inputs["Xsq"] if model == "sk" else inputs["Xq"]
            lo = (c * 37 + j * 53) % (len(pool) - size)
            yield c, j, model, lo, size


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(3)
    centers = rng.uniform(-10, 10, (K, D))
    y = rng.randint(0, K, N)
    Xi = np.rint(centers[y] + 0.8 * rng.randn(N, D)).astype(np.float32)
    c0 = Xi[[int(np.flatnonzero(y == j)[0]) for j in range(K)]]
    Cs = rng.randn(8, 12) * 6.0
    ys = rng.randint(0, 8, 1600)
    Xs = (Cs[ys] + rng.randn(1600, 12)).astype(np.float32)
    return {"Xi": Xi, "y": (y % 2).astype(np.int64), "c0": c0,
            "Xq": Xi[:600] + np.float32(0.25), "Xs": Xs, "Xsq": Xs[:600]}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    return torch_worlds.spawn_worlds(BODY, inputs, tmp_path_factory)


def _served_equals_direct(arrays, tag, inputs):
    for c, j, model, lo, size in _plan(inputs):
        got = arrays[f"{tag}-{c}-{j}"]
        want = arrays["direct-" + model][lo:lo + size]
        if model == "lr":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert got.dtype == np.int32 and np.array_equal(got, want), \
                (tag, c, j, model)


def test_the_sketched_model_serves_through_its_sketch(worlds):
    """2p ≤ d and k ≥ 8: served and direct labels are K2-x's."""
    assert worlds[1][0][1]["sk-cols"] * 2 <= 12


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_served_equals_direct_over_the_mesh(worlds, inputs, world, layout):
    arrays, info = worlds[world][0]
    assert info[f"{layout}-role"] == "leader"
    _served_equals_direct(arrays, layout, inputs)
    one = worlds[1][0][0]
    for model in ("km", "sk"):
        assert np.array_equal(arrays["direct-" + model],
                              one["direct-" + model])


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_followers_run_their_blocks_until_the_leader_stops(worlds, world,
                                                           layout):
    leader_batches = worlds[world][0][1][f"{layout}-batches"]
    assert leader_batches >= 1
    for _, info in worlds[world][1:]:
        assert info[f"{layout}-role"] == "follower"
        assert info[f"{layout}-stopped"]
        # every device batch reached every follower (host batches: none)
        assert info[f"{layout}-batches"] == leader_batches


@pytest.mark.parametrize("world", [1, 3, 4])
def test_fleet_over_meshes(worlds, inputs, world):
    ranks = worlds[world]
    arrays, info = ranks[0]
    assert info["fleet-leads"]
    _served_equals_direct(arrays, "fleet", inputs)
    assert sum(info["fleet-served"]) >= 1
    for _, other in ranks[1:]:
        assert not other["fleet-leads"]
        assert len(other["fleet-follower-batches"]) == 1
    if world > 1:
        served_by_followers = [b for _, other in ranks[1:]
                               for b in other["fleet-follower-batches"]]
        assert max(served_by_followers) >= 1


@pytest.mark.parametrize("world", [1, 3, 4])
def test_a_failed_block_fails_one_batch_and_the_next_is_served(worlds,
                                                                world):
    """A runner that raises on one rank (the last) gives that batch's
    request the rank's error; the next batch is answered, and no rank's
    loop died."""
    ranks = worlds[world]
    arrays, info = ranks[0]
    assert info["fault"] == f"rank {world - 1}: RuntimeError: injected fault"
    assert np.array_equal(arrays["swap-after-fault"],
                          arrays["direct-km"][:100])
    for _, other in ranks:
        assert other["swap-fatal"] == ""


@pytest.mark.parametrize("world", [1, 3, 4])
def test_a_hot_swap_over_the_mesh_serves_the_new_version(worlds, world):
    """Requests dispatched after ``publish`` returns get the new version
    from every rank's block (bit for bit its direct ``predict``); those
    queued before get the old or the new one, never a mix; a new name
    that sorts before the old one is served as itself. The fleet's
    ``swap`` reaches every replica's ranks the same way."""
    arrays = worlds[world][0][0]
    old, new = arrays["direct-km"], arrays["direct-km2"]
    assert not np.array_equal(old[:480], new[:480])
    for i, got in enumerate(arrays["swap-during"]):
        rows = slice(60 * i, 60 * i + 60)
        assert np.array_equal(got, old[rows]) or np.array_equal(got,
                                                                new[rows])
    for key in ("swap-after", "fleet-swap"):
        assert np.array_equal(arrays[key].reshape(-1), new[:480]), key
    np.testing.assert_allclose(arrays["swap-aa"], arrays["direct-lr"][:50],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_against_the_jax_serving_loop_on_the_matching_mesh(worlds, inputs,
                                                           world, layout):
    from dask_ml_tpu import config as jconfig
    from dask_ml_tpu.cluster import KMeans as JKMeans
    from dask_ml_tpu.parallel.serving import ModelRegistry as JRegistry
    from dask_ml_tpu.parallel.serving import ServingLoop as JLoop

    arrays = worlds[world][0][0]
    jm = torch_worlds.jax_mesh(world, layout)
    with jconfig.config_context(pad_policy=None):
        est = JKMeans(n_clusters=K, init=inputs["c0"], max_iter=20).fit(
            inputs["Xi"])
        reg = JRegistry()
        reg.register("km", est)
        with JLoop(reg, mesh=jm, coalesce_window_s=0.0) as loop:
            for c, j, model, lo, size in _plan(inputs):
                if model != "km":
                    continue
                got = loop.submit("km", inputs["Xq"][lo:lo + size]).result(60)
                assert np.array_equal(arrays[f"{layout}-{c}-{j}"],
                                      np.asarray(got))
