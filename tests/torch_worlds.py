"""Spawning the port's ``torch.distributed`` worlds for the CPU mesh tests.

A test module hands :func:`spawn_worlds` the body of a worker script and
the arrays every rank loads. Every rank of every world starts at once, as
``python -c``: it joins a gloo world through a ``file://`` store in the
world's temporary directory (device "cpu", ``pad_policy=None``, one
thread), runs the body, and writes ``rank<r>.npz`` (the body's ``res``
dict of arrays) and ``rank<r>.json`` (its ``info`` dict). The body sees
``world``, ``rank``, ``out`` (the directory), ``data`` (the loaded
arrays), ``res``, ``info`` and ``layouts(world)``: the meshes of the
world, built in one order on every rank: ``flat`` always, ``hier`` (two
pods of two ranks) at world 4.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PREAMBLE = textwrap.dedent("""
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
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib

    def layouts(world):
        meshes = {"flat": mesh_lib.make_mesh()}
        if world == 4:
            meshes["hier"] = hier.make_hierarchical_mesh(2)
        return meshes

    data = dict(np.load(os.path.join(out, "data.npz")))
    res, info = {}, {}
""")

POSTAMBLE = textwrap.dedent("""
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
        json.dump(info, f)
    runtime.shutdown()
""")


def spawn_worlds(body: str, inputs: dict, tmp_path_factory,
                 worlds=(1, 3, 4), timeout: float = 240.0) -> dict:
    """Run ``body`` on every rank of every world at once; returns
    ``{world: [(arrays, info) for each rank]}``, or fails with every
    rank's error."""
    script = PREAMBLE + textwrap.dedent(body) + POSTAMBLE
    procs = {}
    for world in worlds:
        out = tmp_path_factory.mktemp(f"world{world}")
        np.savez(out / "data.npz", **inputs)
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs[world] = (out, [
            subprocess.Popen(
                [sys.executable, "-c", script, str(world), str(r),
                 str(out / "store"), str(out)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            for r in range(world)])
    deadline = time.monotonic() + timeout
    results, errors = {}, []
    for world, (out, ps) in procs.items():
        for r, p in enumerate(ps):
            try:
                _, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
                errors.append(f"world {world} rank {r} timed out: "
                              f"{err[-3000:]}")
                continue
            if p.returncode:
                errors.append(f"world {world} rank {r}: {err[-3000:]}")
        if not errors:
            results[world] = [
                (dict(np.load(out / f"rank{r}.npz")),
                 json.loads((out / f"rank{r}.json").read_text()))
                for r in range(len(ps))]
    assert not errors, "\n".join(errors)
    return results


def jax_mesh(world: int, layout: str):
    """The JAX package's mesh matching a port layout, on the first
    ``world`` virtual CPU devices."""
    import jax

    from dask_ml_tpu.parallel import hierarchy as jhier
    from dask_ml_tpu.parallel import mesh as jmesh

    devs = jax.devices()[:world]
    if layout == "flat":
        return jmesh.make_mesh(devices=devs)
    return jhier.make_hierarchical_mesh(2, devices=devs)


def port_mesh(world: int, layout: str):
    """A port layout as a mesh without a world (its shape and ledger
    charges only)."""
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib

    if layout == "flat":
        return mesh_lib.make_mesh(devices=range(world))
    return hier.make_hierarchical_mesh(2, devices=range(world))


def cases(worlds=(1, 3, 4)) -> list:
    """The (world, layout) pairs the worlds run."""
    return [(w, "flat") for w in worlds] + ([(4, "hier")] if 4 in worlds
                                            else [])
