"""A/B timings of the port on one CUDA card, between two checkouts in one
call, so that both read the same card at the same power limit.

    python3 chip_ab.py PARENT_DIR

runs each measurement below in a process of its own, in the order parent,
this checkout, this checkout, parent, and prints one JSON line per run
and a summary line with the card's name and power limit:

- ``softmax-fit``: ``LogisticRegression(multiclass="multinomial",
  solver="lbfgs", max_iter=3)`` on a host container of 500,000 rows
  (``make_sparse_classification(500_000, 1e5, 0.001, 42)``: the sparse GLM
  cell's width, 100 slots a row) with 4 classes; the min of three fits
  after one warm-up fit;
- ``softmax-grad``: one forward and backward of ``ops.sparse.matmat`` on
  that container staged on the card, ``B`` of shape (d, 4): CUDA events,
  the median of 20 after 3 warm-up calls, forward alone beside it.

With ``--search`` it also times, in this checkout only, the sparse search
(3 C × cv 2 of ``LogisticRegression(solver="lbfgs", max_iter=3)`` on that
container as CSR) with the GLM's batched group and with every cell run on
its own, in the order group, per cell, per cell, group, with the largest
gap between the two paths' scores and whether their ranks agree.

With ``--spmv-bf16`` it measures, in place of the softmax runs, the
sparse kernels at the sparse GLM cell: the container of
``make_sparse_classification(1e7, 1e5, 0.001, 42)`` with its intercept
slot (n 1e7, k 101, d 100,001), drawn once on the host and staged on the
card by each run, with bf16 values (the precision phase's container) and
with f32 values. Each run times, with CUDA events (the median of 20 after
3 warm-up calls), K6-bf16 and K6-b-bf16 and f32 K6 and K6-b on their
plans, and records the bits of both pullbacks (sha256) and the bf16
forward's largest gap to its plain version. Where the checkout's
``_pullback_cuda`` takes ``walk=``, it also times the bf16 pullback's
walks (the tiles and the TMA-multicast ring) in a cluster of 2 at the
cell and in a cluster of 4 on the cell's values with columns drawn
uniformly over d = 150,001, and checks each pullback's bits against the
L2 route's. The summary puts each side's fastest run beside the other's,
says whether the two sides' pullbacks gave the same bits, and names the
kernels whose SASS (``cuobjdump -sass`` of each side's ``spmv`` library)
is the same on both sides and those whose SASS differs. The container is
drawn into a directory under the temporary directory (``TMPDIR``), about
8 GB, removed when the runs end, whatever their outcome.

    python3 chip_ab.py PARENT_DIR --spmv-bf16

``--tree DIR`` (used by the runs above) measures one checkout in this
process. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

N, D, DENSITY, SEED, CLASSES = 500_000, 100_000, 0.001, 42, 4
#: the sparse GLM cell (chip_smoke.py's GLM_N, GLM_D, GLM_DENSITY)
CELL_N = 10_000_000
#: H100 SXM device memory rate (the kernels' bytes bound)
PEAK_BYTES_PER_S = 3.35e12
#: the width at which the bf16 pullback runs in a cluster of 4 (k = 101)
D_CLUSTER4 = 150_001
FITS, ITERS, WARMUP = 3, 20, 3
SEARCH_CS = [0.1, 1.0, 10.0]
HERE = os.path.dirname(os.path.abspath(__file__))


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def container():
    from dask_ml_tpu_torch.datasets import make_sparse_classification

    return make_sparse_classification(N, D, DENSITY, random_state=SEED)


def cuda_ms(fn) -> float:
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def one_tree(tree: str) -> dict:
    """The softmax fit and gradient timings of the checkout at ``tree``."""
    _import_tree(tree)
    import numpy as np
    import torch

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops.sparse import SparseRows, matmat

    Xs, _ = container()
    y = np.random.default_rng([SEED, 19]).integers(0, CLASSES, N)
    A = SparseRows(Xs.values, Xs.cols, Xs.d)

    def fit():
        est = LogisticRegression(multiclass="multinomial", solver="lbfgs",
                                 max_iter=3).fit(A, y)
        torch.cuda.synchronize()
        return est

    first = fit()
    fits = []
    for _ in range(FITS):
        t0 = time.perf_counter()
        fit()
        fits.append(time.perf_counter() - t0)
    dev = torch.device("cuda", 0)
    Ad = SparseRows(torch.as_tensor(Xs.values, device=dev),
                    torch.as_tensor(Xs.cols, device=dev), Xs.d)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    B = torch.randn(Xs.d, CLASSES, generator=g, device=dev,
                    requires_grad=True)
    G = torch.randn(N, CLASSES, generator=g, device=dev)
    fwd_ms = cuda_ms(lambda: matmat(Ad, B.detach()))
    grad_ms = cuda_ms(lambda: torch.autograd.grad(matmat(Ad, B), B, G))
    grads = [torch.autograd.grad(matmat(Ad, B), B, G)[0] for _ in range(3)]
    return {"tree": tree, "n": N, "k": int(Xs.k), "d": int(Xs.d),
            "classes": CLASSES, "fit_s": min(fits), "fit_runs_s": fits,
            "n_iter": int(np.max(first.n_iter_)),
            "matmat_fwd_ms": fwd_ms, "matmat_fwd_bwd_ms": grad_ms,
            "grad_repeats_bits": all(torch.equal(grads[0], q)
                                     for q in grads[1:])}


def spmv_cell(datadir: str) -> None:
    """The sparse GLM cell's host container and labels, drawn once, as
    ``.npy`` files under ``datadir``."""
    import numpy as np

    from dask_ml_tpu_torch.datasets import make_sparse_classification

    X, y = make_sparse_classification(CELL_N, D, DENSITY, random_state=SEED)
    np.save(os.path.join(datadir, "values.npy"), X.values)
    np.save(os.path.join(datadir, "cols.npy"), X.cols)
    np.save(os.path.join(datadir, "y.npy"), y.astype(np.float32))


def staged_cell(datadir: str, dev):
    """(bf16 values, f32 values, cols, y) on ``dev``: the cell's container
    with its intercept slot (value 1 at column d), copied in row chunks."""
    import numpy as np
    import torch

    vals = np.load(os.path.join(datadir, "values.npy"), mmap_mode="r")
    cols = np.load(os.path.join(datadir, "cols.npy"), mmap_mode="r")
    n, k = vals.shape
    v32 = torch.ones((n, k + 1), dtype=torch.float32, device=dev)
    c = torch.full((n, k + 1), D, dtype=torch.int32, device=dev)
    step = 1 << 20
    for s in range(0, n, step):
        v32[s:s + step, :k] = torch.from_numpy(
            np.ascontiguousarray(vals[s:s + step])).to(dev)
        c[s:s + step, :k] = torch.from_numpy(
            np.ascontiguousarray(cols[s:s + step])).to(dev)
    y = torch.as_tensor(np.load(os.path.join(datadir, "y.npy")), device=dev)
    return v32.to(torch.bfloat16), v32, c, y


def spmv_tree(tree: str, datadir: str) -> dict:
    """K6 and K6-b, bf16 and f32, at the cell in the checkout at ``tree``."""
    import hashlib
    import inspect

    import torch

    sps = _import_tree(tree).ops.sparse
    dev = torch.device("cuda", 0)
    v16, v32, cols, y = staged_cell(datadir, dev)
    n, k = v16.shape
    d = D + 1
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    v = torch.randn(d, generator=g, device=dev) * 0.05
    # the cotangent of the logistic loss at v, through the plain forward
    # (the same code in every checkout, so every run pulls back the same r)
    r = (torch.sigmoid(sps._spmv_ref(v16, cols, v)) - y) / n

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    takes_dtype = "dtype" in inspect.signature(sps.dvector_plan).parameters
    out = {"tree": tree, "n": n, "k": k, "d": d, "ms": {}, "plan": {}}
    for name, vals in (("K6-bf16", v16), ("K6", v32)):
        kw = {"dtype": vals.dtype} if takes_dtype else {}
        out["plan"][name] = sps.dvector_plan(n, k, d, **kw)
        out["ms"][name] = cuda_ms(lambda: sps._spmv_cuda(vals, cols, v))
    for name, vals in (("K6-b-bf16", v16), ("K6-b", v32)):
        out["plan"][name] = sps.dvector_plan(n, k, d, pullback=True)
        out["ms"][name] = cuda_ms(lambda: sps._pullback_cuda(vals, cols, r,
                                                             d))
        out[f"sha_{name}"] = sha(sps._pullback_cuda(vals, cols, r, d))
    fk = sps._spmv_cuda(v16, cols, v)
    fp = sps._spmv_ref(v16, cols, v)
    out["K6-bf16_max_abs_err"] = float((fk - fp).abs().max())
    scale = sps._spmv_ref(v16.abs(), cols, v.to(torch.bfloat16).float().abs())
    out["K6-bf16_within_rounding_bound"] = bool(
        ((fk - fp).abs() <= k * 2.0 ** -23 * scale + 1e-30).all())
    out["bound_ms"] = {
        "bf16": (n * k * 6 + 4 * (d + n)) / PEAK_BYTES_PER_S * 1e3,
        "f32": (n * k * 8 + 4 * (d + n)) / PEAK_BYTES_PER_S * 1e3}
    if "walk" in inspect.signature(sps._pullback_cuda).parameters:
        out["walks_ms"], out["walks_equal_l2"], out["walk_on_path"] = (
            {}, {}, {})
        g.manual_seed(SEED + 4)
        cols4 = torch.randint(0, D_CLUSTER4, (n, k), generator=g,
                              device=dev, dtype=torch.int32)
        for c, cc, dd in ((2, cols, d), (4, cols4, D_CLUSTER4)):
            l2 = sps._pullback_cuda(v16, cc, r, dd, cluster=0)
            out["walk_on_path"][f"c{c}"] = sps._pullback_walk(v16, cc, r, dd,
                                                              c)
            for walk in ("tiles", "ring"):
                call = (lambda: sps._pullback_cuda(v16, cc, r, dd, cluster=c,
                                                   walk=walk))
                out["walks_ms"][f"c{c}-{walk}"] = cuda_ms(call)
                out["walks_equal_l2"][f"c{c}-{walk}"] = bool(
                    torch.equal(call(), l2))
            del l2
        del cols4
    return out


def _import_tree(tree: str):
    """The port of the checkout at ``tree`` (and not another's)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import dask_ml_tpu_torch
    import dask_ml_tpu_torch.ops.sparse  # noqa: F401

    root = os.path.dirname(os.path.dirname(
        os.path.abspath(dask_ml_tpu_torch.__file__)))
    if root != os.path.abspath(tree):
        raise RuntimeError(f"imported the port from {root}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    return dask_ml_tpu_torch


def sass_functions(tree: str) -> dict:
    """The SASS of every kernel of the newest ``spmv`` library built in the
    checkout at ``tree``, by mangled name (the anonymous namespace's hash,
    which nvcc draws from the source, taken out of names and text)."""
    import glob
    import re

    libs = glob.glob(os.path.join(tree, "dask_ml_tpu_torch", "_kernels",
                                  "_build", "spmv-*.so"))
    if not libs:
        return {}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = max(libs, key=os.path.getmtime)
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {f: "\n".join(body) for f, body in funcs.items()}


def sass_compare(parent: str, change: str) -> dict:
    """The kernels of both sides' ``spmv`` libraries whose SASS is the same,
    those whose SASS differs, and those of one side only."""
    a, b = sass_functions(parent), sass_functions(change)
    common = sorted(set(a) & set(b))
    return {"same": [f for f in common if a[f] == b[f]],
            "differs": [f for f in common if a[f] != b[f]],
            "parent_only": sorted(set(a) - set(b)),
            "change_only": sorted(set(b) - set(a))}


def spmv_summary(side: dict) -> dict:
    """Each side's fastest run a kernel and walk, the bits against the
    parent's."""
    summary = {}
    for name, rs in side.items():
        summary[name] = {key: min(r["ms"][key] for r in rs)
                         for key in rs[0]["ms"]}
        walks = [r["walks_ms"] for r in rs if "walks_ms" in r]
        if walks:
            summary[name + "_walks"] = {key: min(w[key] for w in walks)
                                        for key in walks[0]}
            summary[name + "_walks_equal_l2"] = all(
                all(r["walks_equal_l2"].values()) for r in rs)
    for key in ("sha_K6-b-bf16", "sha_K6-b"):
        summary[key + "_same_bits"] = len(
            {r[key] for rs in side.values() for r in rs}) == 1
    summary["change_walk_on_path"] = side["change"][0].get("walk_on_path")
    summary["change_plan"] = side["change"][0]["plan"]
    summary["parent_plan"] = side["parent"][0]["plan"]
    summary["bound_ms"] = side["change"][0]["bound_ms"]
    return summary


def search_ab() -> dict:
    """The sparse search with the GLM's batched group and per cell."""
    import numpy as np
    import scipy.sparse as scipy_sparse
    import torch

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.model_selection import GridSearchCV

    Xs, y = container()
    rows = np.repeat(np.arange(N, dtype=np.int64), Xs.k)
    csr = scipy_sparse.coo_matrix(
        (Xs.values.ravel(), (rows, Xs.cols.ravel().astype(np.int64))),
        shape=(N, Xs.d)).tocsr()
    csr.sum_duplicates()
    grouped = LogisticRegression._supports_batched

    def run(batched: bool):
        LogisticRegression._supports_batched = (
            grouped if batched else lambda self, params: False)
        try:
            t0 = time.perf_counter()
            gs = GridSearchCV(
                LogisticRegression(solver="lbfgs", max_iter=3),
                {"C": SEARCH_CS}, cv=2, refit=False, iid=False,
                return_train_score=False).fit(csr, y)
            torch.cuda.synchronize()
            return gs, time.perf_counter() - t0
        finally:
            LogisticRegression._supports_batched = grouped

    run(True)  # warm-up: the kernels' first launches
    out = {"group_s": [], "per_cell_s": []}
    results = {}
    for batched in (True, False, False, True):
        gs, sec = run(batched)
        out["group_s" if batched else "per_cell_s"].append(sec)
        results[batched] = gs
        if batched:
            out["n_batched_cells"] = int(gs.n_batched_cells_)
    # the group scores accuracy in f32 on the card, a cell in f64 on the
    # host: the scores agree to f32 rounding, the ranks exactly
    a, b = results[True].cv_results_, results[False].cv_results_
    gap = max(float(np.max(np.abs(np.asarray(a[key]) - np.asarray(b[key]))))
              for key in a if key.endswith("test_score")
              and not key.startswith("rank"))
    out["max_score_gap"] = gap
    out["same_ranks"] = bool(np.array_equal(a["rank_test_score"],
                                            b["rank_test_score"]))
    out.update({"n": N, "points": len(SEARCH_CS), "cv": 2,
                "group_min_s": min(out["group_s"]),
                "per_cell_min_s": min(out["per_cell_s"])})
    return out


def run_trees(parent: str, extra: list):
    """One ``--tree`` run each of parent, this checkout, this checkout,
    parent, in that order; their results, or None if one failed."""
    runs = []
    for tree in (parent, HERE, HERE, parent):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree] + extra, capture_output=True,
                           text=True, timeout=900)
        sys.stderr.write(p.stderr[-4000:])
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode != 0 or not lines:
            print(f"chip_ab: the run on {tree} failed (rc {p.returncode})",
                  file=sys.stderr)
            return None
        runs.append(json.loads(lines[-1][3:]))
        print(lines[-1], flush=True)
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--tree"]:
        res = (spmv_tree(args[1], args[3]) if args[2:3] == ["--spmv-bf16"]
               else one_tree(args[1]))
        print("AB " + json.dumps(res), flush=True)
        return 0
    if not args or args[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(args[0])
    if "--spmv-bf16" in args:
        import tempfile

        sys.path.insert(0, HERE)
        datadir = tempfile.mkdtemp(prefix="chip_ab_cell_")
        try:
            spmv_cell(datadir)
            runs = run_trees(parent, ["--spmv-bf16", datadir])
        finally:
            shutil.rmtree(datadir, ignore_errors=True)
        if runs is None:
            return 1
        side = {"parent": [r for r in runs if r["tree"] == parent],
                "change": [r for r in runs if r["tree"] == HERE]}
        summary = spmv_summary(side)
        summary["sass"] = sass_compare(parent, HERE)
        print("SUMMARY " + json.dumps(summary), flush=True)
        print(smi(), flush=True)
        return 0
    runs = run_trees(parent, [])
    if runs is None:
        return 1
    side = {"parent": [r for r in runs if r["tree"] == parent],
            "change": [r for r in runs if r["tree"] == HERE]}
    summary = {name: {key: min(r[key] for r in rs) for key in (
        "fit_s", "matmat_fwd_ms", "matmat_fwd_bwd_ms")}
        for name, rs in side.items()}
    summary["change_grad_repeats_bits"] = all(
        r["grad_repeats_bits"] for r in side["change"])
    if "--search" in args:
        sys.path.insert(0, HERE)
        summary["search"] = search_ab()
    print("SUMMARY " + json.dumps(summary), flush=True)
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
