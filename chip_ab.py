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

``--tree DIR`` (used by the runs above) measures one checkout in this
process. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

N, D, DENSITY, SEED, CLASSES = 500_000, 100_000, 0.001, 42, 4
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
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import dask_ml_tpu_torch
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops.sparse import SparseRows, matmat

    root = os.path.dirname(os.path.dirname(
        os.path.abspath(dask_ml_tpu_torch.__file__)))
    if root != os.path.abspath(tree):
        raise RuntimeError(f"imported the port from {root}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--tree"]:
        print("AB " + json.dumps(one_tree(args[1])), flush=True)
        return 0
    if not args or args[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(args[0])
    runs = []
    for tree in (parent, HERE, HERE, parent):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree], capture_output=True, text=True,
                           timeout=900)
        sys.stderr.write(p.stderr[-4000:])
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode != 0 or not lines:
            print(f"chip_ab: the run on {tree} failed (rc {p.returncode})",
                  file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1][3:]))
        print(lines[-1], flush=True)
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
