#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (name, device count, ``nvidia-smi`` name and power
   limit);
2. builds the port's CUDA kernels from ``dask_ml_tpu_torch/_kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. holds each kernel against its plain PyTorch version on the card, at
   edge shapes (ragged n, n = 1, m = 1, ties, masks, all-masked, a
   ``row_need`` that skips some groups) and at the shapes of the main path;
4. drives the first path through the estimator a user would call:
   ``KMeans(n_clusters=8, init="k-means||").fit(X).predict(X)`` on
   1,000,000 × 50 float32 blobs with 8 well-separated centers made with
   numpy from a fixed seed, and checks the adjusted Rand index against
   the true labels (≥ 0.99), that each kernel of the path was launched,
   and that the kernel path and the plain path give identical labels from
   the fitted centers;
5. drives the bounded path,
   ``KMeans(n_clusters=8, init="k-means||", algorithm="bounded").fit(X)
   .predict(X)``, on KDD-Cup'99-shaped data at full size (4,898,431 × 41
   float32, the JAX bench's synthetic recipe drawn with numpy), then the
   same data through ``algorithm="full"`` and ``algorithm="sketched"``:
   each path's own kernels must launch; the bounded loop must be
   bit-identical to the plain two-pass loop from the same init; bounded
   and full must agree on ``n_iter_`` and ``labels_`` with centers within
   rtol 1e-6; a ``tol=0`` 20-iteration bounded run must skip rows; and
   the sketched fit must meet the quality gate (inertia ratio ≤ 1.05,
   ARI ≥ 0.9 against the exact fit) at the JAX drill's quality shape;
6. times each kernel with CUDA events next to its bound and its plain
   version.

Any failed phase raises, so the script exits non-zero and prints no
result. Without a CUDA card it exits non-zero at once. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N, D, K = 1_000_000, 50, 8
SEED = 0
# the KDD-Cup'99-shaped cell: full size, nothing cut
KDD_N, KDD_D, KDD_TRUE_K = 4_898_431, 41, 23
# the JAX sketch drill's quality shape (65,536 × 41, k = 23, p = 36)
Q_N, Q_K, Q_P, Q_ITERS = 65_536, 23, 36, 16
# H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# where the TPU kernel each CUDA kernel replaces is defined
REPLACES = {
    "lloyd_iter": "dask_ml_tpu/models/kmeans.py:186",
    "fused_argmin_min": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_rowwise_min": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_argmin_weight": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_argmin_min2": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_argmin_min_sketched": "dask_ml_tpu/ops/fused_distance.py:378",
}
#: the kernels each path must launch
PATH_KERNELS = {
    "full": ("lloyd_iter", "fused_argmin_min", "fused_rowwise_min",
             "fused_argmin_weight"),
    "bounded": ("fused_argmin_min2", "fused_argmin_min", "fused_rowwise_min",
                "fused_argmin_weight"),
    "sketched": ("fused_argmin_min2", "fused_argmin_min_sketched",
                 "fused_argmin_min", "fused_rowwise_min",
                 "fused_argmin_weight"),
}
SOURCES = {
    "lloyd_iter": "dask_ml_tpu_torch/_kernels/csrc/lloyd.cu",
    "fused_argmin_min": "dask_ml_tpu_torch/_kernels/csrc/fused_distance.cu",
    "fused_rowwise_min": "dask_ml_tpu_torch/_kernels/csrc/fused_distance.cu",
    "fused_argmin_weight":
        "dask_ml_tpu_torch/_kernels/csrc/fused_distance.cu",
    "fused_argmin_min2": "dask_ml_tpu_torch/_kernels/csrc/fused_distance.cu",
    "fused_argmin_min_sketched":
        "dask_ml_tpu_torch/_kernels/csrc/fused_distance.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ari(a, b) -> float:
    """Adjusted Rand index of two labelings (Hubert & Arabie)."""
    a = np.unique(np.asarray(a), return_inverse=True)[1]
    b = np.unique(np.asarray(b), return_inverse=True)[1]
    table = np.zeros((a.max() + 1, b.max() + 1), dtype=np.int64)
    np.add.at(table, (a, b), 1)

    def pairs(x):
        x = x.astype(np.float64)
        return (x * (x - 1) / 2).sum()

    sum_comb = pairs(table)
    sa, sb = pairs(table.sum(1)), pairs(table.sum(0))
    expected = sa * sb / pairs(np.array([len(a)]))
    top = (sa + sb) / 2
    return float((sum_comb - expected) / (top - expected))


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------


class Mismatch(AssertionError):
    pass


def expect(cond, what: str) -> None:
    if not cond:
        raise Mismatch(what)


def near_tie_ok(X, Y, mask, got, want, scale_eps=1e-5):
    """Rows whose argmins differ must be near-ties: the plain scores of the
    two picks agree within 1e-5 of the operands' magnitude
    (|x|² + max|y|²) — the f32 cancellation floor of |y|² − 2x·y."""
    from dask_ml_tpu_torch.ops.fused_distance import _row_sumsq, _scores_ref

    bad = (got != want).nonzero().squeeze(1)
    if bad.numel() == 0:
        return 0
    s = _scores_ref(X[bad], Y, mask)
    gs = s.gather(1, got[bad].long()[:, None])[:, 0]
    ws = s.gather(1, want[bad].long()[:, None])[:, 0]
    scale = _row_sumsq(X[bad]) + _row_sumsq(Y).max()
    expect(bool(((gs - ws).abs() <= scale_eps * scale).all()),
           f"{bad.numel()} argmin mismatches that are not near-ties")
    return int(bad.numel())


def close_values(got, want, X, Y, exact: bool, what: str):
    """Exact on integer-valued data; else rtol 1e-5 plus an absolute term
    of 1e-5·(|x|² + max|y|²), the cancellation floor of the min value."""
    import torch

    from dask_ml_tpu_torch.ops.fused_distance import _row_sumsq

    if exact:
        expect(torch.equal(got, want), f"{what}: not bit-identical")
        return 0.0
    fin = torch.isfinite(want)
    expect(torch.equal(fin, torch.isfinite(got)), f"{what}: inf pattern")
    err = (got[fin] - want[fin]).abs()
    scale = (_row_sumsq(X) + _row_sumsq(Y).max())[fin]
    expect(bool((err <= 1e-5 * want[fin].abs() + 1e-5 * scale).all()),
           f"{what}: max abs err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def check_fused(tag, X, Y, mask=None, w=None, need=None, exact=True):
    """Run K2, K3 (with and without row_need) and K4 through the public
    entries with kernel='cuda' and kernel='torch'; return max abs errors."""
    import torch

    from dask_ml_tpu_torch.ops import fused_distance as fd

    errs = {}
    if w is None:
        w = torch.ones(X.shape[0], device=X.device)
    ka, kmn = fd.fused_argmin_min(X, Y, mask, kernel="cuda")
    ra, rmn = fd.fused_argmin_min(X, Y, mask, kernel="torch")
    expect(ka.dtype == torch.int32, "argmin dtype")
    if exact:
        expect(torch.equal(ka, ra), f"{tag} argmin_min: argmin differs")
    else:
        near_tie_ok(X, Y, mask, ka, ra)
    errs["fused_argmin_min"] = close_values(kmn, rmn, X, Y, exact,
                                            f"{tag} argmin_min value")
    kmin = fd.fused_rowwise_min(X, Y, mask, kernel="cuda")
    rmin = fd.fused_rowwise_min(X, Y, mask, kernel="torch")
    e1 = close_values(kmin, rmin, X, Y, exact, f"{tag} min")
    e2 = 0.0
    if need is not None:
        kmin = fd.fused_rowwise_min(X, Y, mask, kernel="cuda", row_need=need)
        rmin = fd.fused_rowwise_min(X, Y, mask, kernel="torch",
                                    row_need=need)
        e2 = close_values(kmin, rmin, X, Y, exact, f"{tag} min row_need")
        ev = fd.row_block_evaluated(need)
        expect(bool(torch.isinf(kmin[~ev]).all()), f"{tag} skipped != inf")
    errs["fused_rowwise_min"] = max(e1, e2)
    kia, kcw = fd.fused_argmin_weight(X, w, Y, mask, kernel="cuda")
    ria, rcw = fd.fused_argmin_weight(X, w, Y, mask, kernel="torch")
    if exact:
        expect(torch.equal(kia, ria), f"{tag} argmin_weight: argmin")
        expect(torch.equal(kcw, rcw), f"{tag} argmin_weight: cw")
        errs["fused_argmin_weight"] = 0.0
    else:
        nbad = near_tie_ok(X, Y, mask, kia, ria)
        # unit weights: cw are exact integer counts; each near-tie moves
        # one unit between two targets
        err = float((kcw - rcw).abs().max())
        expect(float((kcw - rcw).abs().sum()) <= 2 * nbad * float(w.max()),
               f"{tag} argmin_weight: cw err {err}")
        errs["fused_argmin_weight"] = err
    # the kernel is bit-reproducible from run to run
    kia2, kcw2 = fd.fused_argmin_weight(X, w, Y, mask, kernel="cuda")
    expect(torch.equal(kcw, kcw2) and torch.equal(kia, kia2),
           f"{tag} argmin_weight not reproducible")
    return errs


def check_min2_sketched(tag, X, Y, mask=None, need=None, exact=True):
    """K5 (argmin_min2, with and without row_need) and the sketched
    assignment (K2 with an external |x|², with and without row_need)
    through the public entries, kernel='cuda' against kernel='torch';
    and K5 against K2 kernel to kernel (one score loop: the same argmins
    and minima bit for bit). Returns max abs errors."""
    import torch

    from dask_ml_tpu_torch.ops import fused_distance as fd

    errs = {"fused_argmin_min2": 0.0, "fused_argmin_min_sketched": 0.0}
    n = X.shape[0]
    g = torch.Generator(device=X.device)
    g.manual_seed(n)
    # integer off-support energy on top of the rows' own |x|²
    x2 = fd._row_sumsq(X) + torch.randint(0, 9, (n,), generator=g,
                                          device=X.device).float()
    for rn in (None, need) if need is not None else (None,):
        sfx = "" if rn is None else " row_need"
        k = fd.fused_argmin_min2(X, Y, mask, kernel="cuda", row_need=rn)
        r = fd.fused_argmin_min2(X, Y, mask, kernel="torch", row_need=rn)
        expect(k[0].dtype == torch.int32, "min2 argmin dtype")
        if exact:
            expect(torch.equal(k[0], r[0]), f"{tag} min2{sfx}: argmin")
        else:
            near_tie_ok(X, Y, mask, k[0], r[0])
        for i in (1, 2):
            e = close_values(k[i], r[i], X, Y, exact,
                             f"{tag} min2{sfx} value {i}")
            errs["fused_argmin_min2"] = max(errs["fused_argmin_min2"], e)
        ks = fd.fused_argmin_min_sketched(X, Y, mask=mask, x2=x2,
                                          kernel="cuda", row_need=rn)
        rs = fd.fused_argmin_min_sketched(X, Y, mask=mask, x2=x2,
                                          kernel="torch", row_need=rn)
        if exact:
            expect(torch.equal(ks[0], rs[0]), f"{tag} sketched{sfx}: argmin")
        else:
            near_tie_ok(X, Y, mask, ks[0], rs[0])
        e = close_values(ks[1], rs[1], X, Y, exact, f"{tag} sketched{sfx}")
        errs["fused_argmin_min_sketched"] = max(
            errs["fused_argmin_min_sketched"], e)
        if rn is not None:
            ev = fd.row_block_evaluated(rn)
            expect(bool((k[0][~ev] == 0).all() and (k[1][~ev] == 0).all()
                        and (k[2][~ev] == 0).all()
                        and (ks[0][~ev] == 0).all()
                        and (ks[1][~ev] == 0).all()),
                   f"{tag}: skipped rows are not zeros")
        else:
            ka, kmn = fd.fused_argmin_min(X, Y, mask, kernel="cuda")
            expect(torch.equal(ka, k[0]) and torch.equal(kmn, k[1]),
                   f"{tag}: K5 and K2 kernels differ")
            expect(torch.equal(ks[0], ka), f"{tag}: sketched argmin != K2")
    return errs


def check_lloyd(tag, X, w, C, exact: bool):
    import torch

    from dask_ml_tpu_torch.models import kmeans as core

    ks, kc, ki = core._lloyd_stats_cuda(X, w, C)
    rs, rc, ri = core._lloyd_stats_ref(X, w, C)
    ks2, kc2, ki2 = core._lloyd_stats_cuda(X, w, C)
    expect(torch.equal(ks, ks2) and torch.equal(ki, ki2),
           f"{tag} lloyd not reproducible")
    if exact:
        expect(torch.equal(ks, rs) and torch.equal(kc, rc)
               and torch.equal(ki, ri), f"{tag} lloyd: not bit-identical")
        return 0.0
    expect(torch.equal(kc, rc), f"{tag} lloyd counts differ")
    err = float((ks - rs).abs().max())
    expect(bool(torch.allclose(ks, rs, rtol=1e-5, atol=1e-5 * float(
        rs.abs().max()))), f"{tag} lloyd sums: max abs err {err}")
    expect(abs(float(ki) - float(ri)) <= 1e-5 * abs(float(ri)),
           f"{tag} lloyd inertia {float(ki)} vs {float(ri)}")
    return max(err, abs(float(ki) - float(ri)))


def edge_cases(dev):
    """Integer-valued inputs: every product and sum is exact, so the
    kernels must match their plain versions bit for bit."""
    import torch

    from dask_ml_tpu_torch.ops import fused_distance as fd

    rng = np.random.default_rng(1)

    def ints(shape, lo=-8, hi=8):
        return torch.as_tensor(rng.integers(lo, hi, shape),
                               dtype=torch.float32, device=dev)

    errs = {}

    def merge(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    for n, m, d in [(1, 1, 1), (129, 7, 3), (1000, 37, 13), (3001, 80, 50),
                    (5000, 329, 50), (2048, 40, 130), (777, 33, 64)]:
        X, Y = ints((n, d)), ints((m, d))
        w = ints((n,), 0, 5)
        mask = torch.as_tensor(rng.random(m) > 0.3, device=dev)
        merge(check_fused(f"n{n} m{m} d{d}", X, Y, mask, w))
        merge(check_fused(f"n{n} m{m} d{d} nomask", X, Y, None, w))
    # ties: duplicate targets, rows exactly on them -> lowest index wins
    Yb = ints((9, 5), -4, 4)
    Y = torch.cat([Yb, Yb])
    X = torch.cat([Yb, Yb, Yb])
    ka, _ = fd.fused_argmin_min(X, Y, kernel="cuda")
    expect(int(ka.max()) < 9, "ties do not go to the lowest index")
    merge(check_fused("ties", X, Y))
    # all masked: argmin 0, min +inf, cw 0
    X, Y, w = ints((300, 3)), ints((8, 3)), ints((300,), 0, 5)
    mask = torch.zeros(8, dtype=torch.bool, device=dev)
    a, mn = fd.fused_argmin_min(X, Y, mask, kernel="cuda")
    expect(bool((a == 0).all()) and bool(torch.isinf(mn).all()),
           "all-masked argmin_min")
    _, cw = fd.fused_argmin_weight(X, w, Y, mask, kernel="cuda")
    expect(bool((cw == 0).all()), "all-masked cw")
    merge(check_fused("all-masked", X, Y, mask, w))
    # row_need that skips some 1024-row groups, ragged tail
    n = 5 * fd._FUSED_BLK + 77
    X, Y = ints((n, 50)), ints((80, 50))
    need = torch.zeros(n, dtype=torch.bool, device=dev)
    need[5] = need[2 * fd._FUSED_BLK + 9] = need[n - 1] = True
    ev = fd.row_block_evaluated(need)
    expect(bool(ev.any()) and not bool(ev.all()), "row_need skips nothing")
    merge(check_fused("row_need", X, Y, None, None, need=need))
    # K5, K2 with row_need (K2-n) and K2 with an external |x|² (K2-x):
    # ragged n, d = 130 across feature chunks, masks, groups skipped
    for n, m, d in [(1, 1, 1), (129, 7, 3), (1000, 37, 13), (3001, 8, 50),
                    (2048, 40, 130), (5 * fd._FUSED_BLK + 77, 80, 41)]:
        X, Y = ints((n, d)), ints((m, d))
        mask = torch.as_tensor(rng.random(m) > 0.3, device=dev)
        need = torch.zeros(n, dtype=torch.bool, device=dev)
        need[::2 * fd._FUSED_BLK + 1] = True
        merge(check_min2_sketched(f"n{n} m{m} d{d}", X, Y, mask, need))
        merge(check_min2_sketched(f"n{n} m{m} d{d} nomask", X, Y, None,
                                  need))
    # ties with duplicate targets: the lowest index wins and the duplicate
    # is the runner-up, second == best
    X = torch.cat([Yb, Yb, Yb])
    a2, b2, s2 = fd.fused_argmin_min2(X, torch.cat([Yb, Yb]), kernel="cuda")
    expect(int(a2.max()) < 9 and torch.equal(b2, s2),
           "min2 ties: the duplicate is not the runner-up")
    merge(check_min2_sketched("min2 ties", X, torch.cat([Yb, Yb])))
    # m = 1, or one valid target: second-best +inf
    X, Y = ints((300, 5)), ints((8, 5))
    _, b1, s1 = fd.fused_argmin_min2(X, Y[:1], kernel="cuda")
    expect(bool(torch.isfinite(b1).all() and torch.isinf(s1).all()),
           "min2 m=1: second-best is not +inf")
    merge(check_min2_sketched("min2 m=1", X, Y[:1]))
    one = torch.zeros(8, dtype=torch.bool, device=dev)
    one[3] = True
    a1, _, s1 = fd.fused_argmin_min2(X, Y, one, kernel="cuda")
    expect(bool((a1 == 3).all() and torch.isinf(s1).all()),
           "min2 one valid target")
    # all masked: (0, +inf, +inf), and the sketched (0, +inf)
    none = torch.zeros(8, dtype=torch.bool, device=dev)
    a0, b0, s0 = fd.fused_argmin_min2(X, Y, none, kernel="cuda")
    sa, sm = fd.fused_argmin_min_sketched(X, Y, mask=none,
                                          x2=torch.zeros(300, device=dev),
                                          kernel="cuda")
    expect(bool((a0 == 0).all() and torch.isinf(b0).all()
                and torch.isinf(s0).all() and (sa == 0).all()
                and torch.isinf(sm).all()), "min2/sketched all-masked")
    merge(check_min2_sketched("min2 all-masked", X, Y, none))
    # a row_need that skips nothing, and one that skips everything
    n = 3 * fd._FUSED_BLK + 5
    X, Y = ints((n, 41)), ints((8, 41))
    full = fd.fused_argmin_min2(X, Y, kernel="cuda")
    alln = fd.fused_argmin_min2(X, Y, kernel="cuda",
                                row_need=torch.ones(n, dtype=torch.bool,
                                                    device=dev))
    expect(all(torch.equal(a, b) for a, b in zip(full, alln)),
           "min2 all-needed != unskipped")
    nothing = fd.fused_argmin_min2(X, Y, kernel="cuda",
                                   row_need=torch.zeros(n, dtype=torch.bool,
                                                        device=dev))
    expect(all(bool((t == 0).all()) for t in nothing), "min2 none-needed")
    # the Lloyd kernel: ragged n, weights, empty clusters, k beyond 8
    from dask_ml_tpu_torch.models import kmeans as core

    for n, k, d in [(1, 1, 1), (1000, 8, 50), (10_000, 13, 7),
                    (70_001, 3, 2)]:
        X = ints((n, d), -4, 4)
        w = ints((n,), 0, 3)
        C = ints((k, d), -4, 4)
        e = check_lloyd(f"lloyd n{n} k{k} d{d}", X, w, C, exact=True)
        errs["lloyd_iter"] = max(errs.get("lloyd_iter", 0.0), e)
    # beyond the single-pass kernel's shared-memory bound 'auto' runs the
    # two-pass form and 'cuda' raises
    Cbig = ints((64, 600), -4, 4)
    expect(not core._lloyd_cuda_supported(64, 600), "bound not enforced")
    try:
        core._lloyd_stats_cuda(ints((100, 600)), ints((100,), 0, 3), Cbig)
    except ValueError:
        pass
    else:
        raise Mismatch("kernel='cuda' beyond the bound did not raise")
    return errs


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def init_phase_seconds(X, w):
    """Wall seconds of each k-means|| phase at the main path's shape, run
    one by one with a device sync after each (the fit runs them back to
    back)."""
    import torch

    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.utils.validation import check_random_state

    cfg = core._init_scalable_config(X.shape[0], K, 2.0, None)
    gen = check_random_state(SEED, device=X.device)
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return res

    tol = timed("tol", lambda: core.scaled_tolerance(X, w, 1e-4))
    cand, mind0, _, n_rounds = timed("seed", lambda: core._init_seed_phase(
        X, w, gen, max_rounds=cfg["max_rounds"], max_cand=cfg["max_cand"]))
    cand, n_cand, _, skip, total = timed(
        "rounds", lambda: core._init_rounds_phase(
            X, w, cfg["l"], cand, mind0, n_rounds, gen,
            max_cand=cfg["max_cand"], cap=cfg["cap"]))
    n_cand = int(n_cand)
    cand, n_cand, cw = timed("weights", lambda: core._init_weights_phase(
        X, w, cand, n_cand, gen, n_clusters=K, max_cand=cfg["max_cand"]))
    timed("finish", lambda: core._init_finish_phase(
        cand, cw, tol, gen, n_clusters=K, n_trials=cfg["n_trials"],
        finish_iters=100))
    out.update(n_rounds=n_rounds, n_cand=n_cand,
               round_skip_ratio=float(skip) / max(float(total), 1.0))
    return out


def fused_call(fdl, stream, X, Y, epi, w=None, gneed=None, x2=None):
    """A closure that launches ``dml_fused_distance`` once on buffers
    allocated here (the closure keeps them alive)."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import fused_distance as fd

    dev = X.device
    n, d = X.shape
    m = Y.shape[0]
    y2 = fd._row_sumsq(Y).contiguous()
    maskf = torch.ones(m, device=dev)
    am = torch.empty(n, dtype=torch.int32, device=dev)
    mn = torch.empty(n, dtype=torch.float32, device=dev)
    mn2 = torch.empty(n, dtype=torch.float32, device=dev)
    part = torch.empty((m, -(-n // fdl.dml_fused_rows_per_block())),
                       device=dev)
    cw = torch.empty(m, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def call():
        build.check(fdl.dml_fused_distance(
            epi, X.data_ptr(), Y.data_ptr(), y2.data_ptr(), maskf.data_ptr(),
            ptr(gneed), fd._FUSED_BLK, ptr(x2), ptr(w), n, m, d,
            am.data_ptr(), mn.data_ptr(), mn2.data_ptr(), part.data_ptr(),
            cw.data_ptr(), stream), "timing")

    return call


def time_kernels(X, w):
    """Each kernel's own launch (the C entry point, buffers allocated
    once) timed with CUDA events at the main path's shapes, beside its
    plain version and its bound."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.ops import fused_distance as fd

    dev = X.device
    n, d = X.shape
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    pick = torch.randperm(n, generator=g, device=dev)
    fdl = build.load("fused_distance")
    stream = build.stream_of(X)
    rows = []

    def fused_args(epi, m, with_w=False):
        Y = X[pick[:m]].contiguous()
        return Y, fused_call(fdl, stream, X, Y, epi,
                             w=w if with_w else None)

    specs = [
        # name, epilogue, m, plain, bytes, flops
        ("fused_argmin_min", 1, K,
         lambda Y: fd._argmin_min_ref(X, Y, None),
         lambda m: 4 * (n * d + m * d + 2 * n), lambda m: 2 * n * m * d),
        ("fused_rowwise_min", 0, 80,
         lambda Y: fd._min_ref(X, Y, None),
         lambda m: 4 * (n * d + m * d + n), lambda m: 2 * n * m * d),
        ("fused_argmin_weight", 2, 329,
         lambda Y: fd._argmin_weight_ref(X, w, Y, None),
         lambda m: 4 * (n * d + n + m * d + n + m),
         lambda m: 2 * n * m * d),
    ]
    for name, epi, m, plain, nbytes, flops in specs:
        Y, call = fused_args(epi, m, with_w=(epi == 2))
        ms = cuda_ms(call)
        plain_ms = cuda_ms(lambda: plain(Y), iters=5, warmup=1)
        b, by = bound(nbytes(m), flops(m))
        rows.append(dict(name=name, m=m, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by))
    # K1: one Lloyd iteration at k = 8
    ll = build.load("lloyd")
    C = X[pick[:K]].contiguous()
    P = K * (d + 1) + 1
    part = torch.empty(ll.dml_lloyd_max_partials() * P, device=dev)
    out = torch.empty(P, device=dev)
    call = lambda: build.check(ll.dml_lloyd_iter(  # noqa: E731
        X.data_ptr(), w.data_ptr(), C.data_ptr(), n, K, d, part.data_ptr(),
        out.data_ptr(), stream), "timing")
    ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: core._lloyd_stats_ref(X, w, C), iters=5,
                       warmup=1)
    b, by = bound(4 * (n * d + n + K * d + P), 2 * n * K * d + 2 * n * d)
    rows.insert(0, dict(name="lloyd_iter", m=K, ms=ms, plain_ms=plain_ms,
                        bound_ms=b, bound_by=by))
    for r in rows:
        r["shape"] = {"n": n, "m": r.pop("m"), "d": d}
    return rows


def kernel_rows(rows, launches, errs):
    """The ``kernels`` JSON line's entries: each timed row with its route,
    source, the TPU kernel it replaces, its launches on its path and its
    largest error against the plain version."""
    return [{
        "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
        "replaces": REPLACES[r["name"]],
        "launches": int(launches[r["name"]]),
        "max_abs_err": float(errs.get(r["name"], 0.0)),
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None,
        **{k: v for k, v in r.items()
           if k not in ("name", "ms", "plain_ms", "bound_ms", "bound_by")},
    } for r in rows]


def expect_launches(path: str, launches: dict) -> None:
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    expect(not missing,
           f"the {path} path never launched {missing}: {launches}")


def drive(fn):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; returns (result, wall seconds, launches)."""
    import torch

    from dask_ml_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return out, sec, dict(_kernels.launches)


def path_line(path: str, sec: float, n_iter, launches: dict, **extra):
    log("PATH " + json.dumps({"path": path, "seconds": sec,
                              "n_iter": n_iter, "launches": launches,
                              **extra}))


# ---------------------------------------------------------------------------
# the KDD-Cup'99-shaped cell
# ---------------------------------------------------------------------------


def kdd_data(n: int, d: int, seed: int, kt: int = KDD_TRUE_K):
    """The JAX bench's KDD-Cup'99 stand-in (bench.py ``_load_kdd``,
    ``_bounds_synth``) drawn with numpy: ``kt`` centers N(0,1)·exp(N(0,1)
    ·1.5) per feature, cluster ids drawn with logits −0.45·i, noise
    0.3·N(0,1)·exp(N(0,1)·0.5) per feature."""
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((kt, d))
               * np.exp(rng.standard_normal((1, d)) * 1.5)).astype(np.float32)
    p = np.exp(-0.45 * np.arange(kt))
    ids = rng.choice(kt, size=n, p=p / p.sum())
    scale = (0.3 * np.exp(rng.standard_normal((1, d)) * 0.5)).astype(
        np.float32)
    X = rng.standard_normal((n, d), dtype=np.float32)
    X *= scale
    X += centers[ids]
    return X


def bounded_late_need(X, w, c0, iters: int):
    """Drive the bounded loop's body ``iters`` times at tol 0 through the
    core's own steps; return the padded X, the row_need of the last
    iteration and the per-iteration rows skipped (held against
    ``lloyd_loop_bounded``'s own counts by the caller)."""
    import torch

    from dask_ml_tpu_torch.models import kmeans as core

    n, k = X.shape[0], c0.shape[0]
    G, size = core._bounded_groups(k, "auto")
    gid = torch.arange(k, device=X.device) // size
    X_pad, w_pad = core._pad_rows_to_blocks(X, w)
    w_pos = w_pad > 0
    x2 = (X_pad * X_pad).sum(dim=1)
    centers, labels, ub, lb, _, _ = core._bounded_init_state(
        c0, X_pad.shape[0], G, iters)
    skipped = []
    for _ in range(iters):
        need = core._bounded_need(ub, lb, w_pos, prune=True)
        labels, ub, lb, sk, _ = core._bounded_assign(
            X_pad, x2, centers, labels, ub, lb, w_pos, kernel="cuda",
            prune=True)
        new, _ = core._m_step(X, w, labels[:n], centers)
        ub, lb = core._bounded_move(ub, lb, labels, centers, new, gid, G)
        centers = new
        skipped.append(int(sk))
    return X_pad, need, skipped


def device_profile(fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler with
    CUDA activity), the host wall time of the call and the device's busy
    share of it; None when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the operator events
        # on the host carry their kernels' time again
        if e.device_type != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append({"kernel": e.key[:90], "device_ms": us / 1e3,
                         "calls": e.count})
    if not rows:
        return None
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_share": busy / wall_ms, "top": rows[:12]}


def kdd_cell(dev, errs):
    """The bounded, full and sketched paths on the KDD-shaped cell, their
    checks, and the K5 / K2-x timings at its shapes. Returns (timed
    rows, launches by kernel for the kernels line, summary)."""
    import torch

    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.ops import fused_distance as fd
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.utils.validation import check_random_state

    t0 = time.perf_counter()
    X = kdd_data(KDD_N, KDD_D, SEED)
    log(f"KDD-shaped data {X.shape} made in {time.perf_counter() - t0:.2f} s")
    summary = {"n": KDD_N, "d": KDD_D, "k": K}

    def fit(algorithm, **kw):
        return lambda: KMeans(n_clusters=K, init="k-means||",
                              oversampling_factor=2, algorithm=algorithm,
                              random_state=SEED, **kw).fit(X)

    # -- the main path of this slice: bounded fit + predict ---------------
    def bounded_fit_predict():
        km = fit("bounded")()
        return km, km.predict(X)

    (kmb, pred_b), sec_b, l_b = drive(bounded_fit_predict)
    expect_launches("bounded", l_b)
    expect(l_b["lloyd_iter"] == 0, "the bounded path ran the Lloyd kernel")
    expect(np.array_equal(pred_b, kmb.labels_), "bounded predict != labels_")
    expect(np.isfinite(kmb.cluster_centers_).all()
           and kmb.cluster_centers_.shape == (K, KDD_D), "bad centers")
    prn = kmb.lloyd_pruning_
    expect(prn["rows_skipped"] > 0, "the bounded fit skipped no rows")
    path_line("bounded", sec_b, kmb.n_iter_, l_b,
              phases=kmb.fit_phase_seconds_, inertia=kmb.inertia_,
              rows_skipped=prn["rows_skipped"],
              pruned_fraction_per_iter=prn["pruned_fraction_per_iter"],
              bound_held_fraction_per_iter=prn[
                  "bound_held_fraction_per_iter"])
    # -- the same data through algorithm="full" (K1) ------------------------
    (kmf, pred_f), sec_f, l_f = drive(
        lambda: (lambda km: (km, km.predict(X)))(fit("full")()))
    expect_launches("full", l_f)
    expect(l_f["fused_argmin_min2"] == 0, "the full path ran argmin_min2")
    path_line("full", sec_f, kmf.n_iter_, l_f, phases=kmf.fit_phase_seconds_,
              inertia=kmf.inertia_)
    cb, cf = kmb.cluster_centers_, kmf.cluster_centers_
    center_diff = float(np.abs(cb - cf).max())
    n_label_diff = int((kmb.labels_ != kmf.labels_).sum())
    log(f"bounded vs full: n_iter {kmb.n_iter_} / {kmf.n_iter_}, labels "
        f"differ on {n_label_diff} rows, centers max abs diff "
        f"{center_diff:.3e} (max |c| {float(np.abs(cf).max()):.3e})")
    summary.update(bounded_vs_full_center_max_abs_diff=center_diff,
                   bounded_vs_full_label_diff=n_label_diff)
    expect(kmb.n_iter_ == kmf.n_iter_ and n_label_diff == 0
           and np.allclose(cb, cf, rtol=1e-6, atol=1e-6),
           "bounded and full fits disagree")

    # -- the loop against its oracle on the card, from the fit's init -----
    data = prepare_data(X, device=dev)
    Xd, wd = data.X, data.weights
    c0 = core.k_init(Xd, wd, data.n, K, check_random_state(SEED, device=dev),
                     init="k-means||", oversampling_factor=2)
    tol = core.scaled_tolerance(Xd, wd, 1e-4)
    co, _, no, so = core.lloyd_loop(Xd, wd, c0, tol, max_iter=300,
                                    kernel="cuda")
    res = core.lloyd_loop_bounded(Xd, wd, c0, tol, max_iter=300,
                                  kernel="cuda")
    cbd, ibd, nbd, sbd, lbd, _ = res
    expect(torch.equal(co, cbd) and no == nbd and float(so) == float(sbd),
           "bounded loop != two-pass loop from the same init")
    expect(float(ibd) == float(core.compute_inertia(Xd, wd, co,
                                                    kernel="cuda")),
           "bounded inertia != compute_inertia of the oracle's centers")
    expect(torch.equal(lbd, core.predict_labels(Xd, co, kernel="cuda")),
           "bounded labels != predict_labels of the oracle's centers")
    off = core.lloyd_loop_bounded(Xd, wd, c0, tol, max_iter=300,
                                  kernel="cuda", prune=False)
    expect(all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(res[:5], off[:5])),
           "prune=False gives another tuple")
    expect(np.array_equal(cbd.cpu().numpy(), kmb.cluster_centers_)
           and nbd == kmb.n_iter_, "the estimator's loop is not the loop")
    log(f"loop-level oracle on the card: bounded == two-pass Lloyd bit for "
        f"bit ({nbd} iterations); prune=False identical")

    # -- tol = 0, 20 iterations from the fit's init ------------------------
    iters = 20
    r20, sec20, _ = drive(lambda: core.lloyd_loop_bounded(
        Xd, wd, c0, 0.0, max_iter=iters))
    skip20 = r20[5]["rows_skipped"][:iters].cpu().numpy()
    held20 = r20[5]["bounds_held"][:iters].cpu().numpy()
    expect(int(skip20.sum()) > 0, "tol=0 run skipped no rows")
    _, full20_s, _ = drive(lambda: core.lloyd_loop_fused(
        Xd, wd, c0, 0.0, max_iter=iters))
    X_pad, need, skipped = bounded_late_need(Xd, wd, c0, iters)
    expect(skipped == [int(v) for v in skip20],
           "the loop body driven by hand skips other rows than the loop")
    late_eval = float(fd.row_block_evaluated(need).float().mean())
    summary.update(
        tol0_pruned_fraction_per_iter=[float(v) / KDD_N for v in skip20],
        tol0_bound_held_fraction_per_iter=[float(v) / KDD_N for v in held20],
        tol0_bounded_ms_per_iter=sec20 * 1e3 / iters,
        tol0_full_ms_per_iter=full20_s * 1e3 / iters,
        late_iter_evaluated_fraction=late_eval)
    log(f"tol=0, {iters} iterations: pruned fraction per iteration "
        f"{[round(v, 4) for v in summary['tol0_pruned_fraction_per_iter']]}"
        f"; bounded {sec20 * 1e3 / iters:.3f} ms/iter, full "
        f"{full20_s * 1e3 / iters:.3f} ms/iter")

    # -- sketched fit, then predict ----------------------------------------
    sk, sec_s, l_s = drive(fit("sketched"))
    expect_launches("sketched", l_s)
    pred_s, sec_sp, l_sp = drive(lambda: sk.predict(X))
    expect(l_sp["fused_argmin_min_sketched"] == 1
           and sum(l_sp.values()) == 1,
           f"sketched predict did not run the sketched kernel alone: {l_sp}")
    expect(np.array_equal(pred_s, sk.labels_), "sketched predict != labels_")
    p = sk.sketch_vals_.shape[1]
    expect(p == max(4, KDD_D // 4) and core.sketched_assign_wins(
        KDD_N, K, KDD_D, p), "the sketched cell does not assign by sketch")
    Wp, offs, vals, csk = sk._sketch_args(dev)
    Zp = Xd @ Wp - offs[None, :]
    lk = core.predict_labels_sketched(Xd, Wp, offs, vals, csk, kernel="cuda")
    lp = core.predict_labels_sketched(Xd, Wp, offs, vals, csk,
                                      kernel="torch")
    n_ties = near_tie_ok(Zp, vals, None, lk, lp)
    ratio = sk.inertia_ / kmb.inertia_
    sk_ari = ari(kmb.labels_, sk.labels_)
    path_line("sketched", sec_s, sk.n_iter_, l_s,
              phases=sk.fit_phase_seconds_, inertia=sk.inertia_, p=p,
              inertia_ratio_vs_exact=ratio, ari_vs_exact=sk_ari,
              predict_seconds=sec_sp, predict_launches=l_sp,
              kernel_vs_plain_near_ties=n_ties)
    summary.update(sketched_inertia_ratio=ratio, sketched_ari=sk_ari)

    # -- the quality gate at the JAX drill's shape -------------------------
    Xq = kdd_data(Q_N, KDD_D, 99)
    ex = KMeans(n_clusters=Q_K, random_state=11, max_iter=100).fit(Xq)
    sq = KMeans(n_clusters=Q_K, random_state=11, max_iter=100,
                algorithm="sketched", sketch_cols=Q_P,
                sketch_iters=Q_ITERS).fit(Xq)
    q_ratio = sq.inertia_ / ex.inertia_
    q_ari = ari(ex.labels_, sq.labels_)
    log(f"sketched quality gate ({Q_N} x {KDD_D}, k={Q_K}, p={Q_P}): "
        f"inertia ratio {q_ratio:.5f}, ARI {q_ari:.4f}")
    expect(q_ratio <= 1.05 and q_ari >= 0.9, "sketched quality gate failed")
    summary.update(quality_inertia_ratio=q_ratio, quality_ari=q_ari)

    # -- kernel against plain version at the cell's shapes ------------------
    C = torch.as_tensor(kmb.cluster_centers_, device=dev)
    for tag, Xk, Yk, nk in (("KDD K5/K2-x d=41", X_pad, C, need),
                            ("KDD sketched d=10", Zp, vals, None)):
        for key, v in check_min2_sketched(tag, Xk, Yk, None, nk,
                                          exact=False).items():
            errs[key] = max(errs.get(key, 0.0), v)
    torch.cuda.synchronize()
    log("KDD-shape comparisons: K5 and K2-x within tolerance")

    # -- timing at the cell's shapes ----------------------------------------
    from dask_ml_tpu_torch._kernels import build

    fdl = build.load("fused_distance")
    stream = build.stream_of(Xd)
    npad, d = X_pad.shape
    gflags = fd._group_need(need).to(torch.uint8).contiguous()
    gall = torch.ones_like(gflags)
    rows = []
    k5_full = cuda_ms(fused_call(fdl, stream, X_pad, C, 3, gneed=gall))
    k5_late = cuda_ms(fused_call(fdl, stream, X_pad, C, 3, gneed=gflags))
    all_need = torch.ones(npad, dtype=torch.bool, device=dev)
    plain_full = cuda_ms(lambda: fd.fused_argmin_min2(
        X_pad, C, kernel="torch", row_need=all_need), iters=5, warmup=1)
    plain_late = cuda_ms(lambda: fd.fused_argmin_min2(
        X_pad, C, kernel="torch", row_need=need), iters=5, warmup=1)
    b_full, by_full = bound(4 * (npad * d + 3 * npad), 2 * npad * K * d)
    ne = late_eval * npad
    b_late, by_late = bound(4 * (ne * d + 3 * npad), 2 * ne * K * d)
    rows.append(dict(name="fused_argmin_min2", ms=k5_full,
                     plain_ms=plain_full, bound_ms=b_full, bound_by=by_full,
                     shape={"n": npad, "m": K, "d": d},
                     late_need={"evaluated_fraction": late_eval,
                                "ms": k5_late, "plain_ms": plain_late,
                                "bound_ms": b_late, "bound_by": by_late}))
    n, pk = Zp.shape
    Zc = Zp.contiguous()
    zero = torch.zeros(n, device=dev)
    k2x = cuda_ms(fused_call(fdl, stream, Zc, vals, 1, x2=zero))
    plain_k2x = cuda_ms(lambda: fd._argmin_min_sk_ref(Zc, vals, zero, None),
                        iters=5, warmup=1)
    b, by = bound(4 * (n * pk + 3 * n), 2 * n * K * pk)
    # K2-n: the same call with the late iteration's need (cut to n rows)
    need_n = need[:n]
    k2n = cuda_ms(fused_call(fdl, stream, Zc, vals, 1, x2=zero,
                             gneed=fd._group_need(need_n).to(torch.uint8)))
    plain_k2n = cuda_ms(lambda: fd.fused_argmin_min_sketched(
        Zc, vals, x2=zero, kernel="torch", row_need=need_n), iters=5,
        warmup=1)
    ev_n = float(fd.row_block_evaluated(need_n).float().mean())
    b_n, by_n = bound(4 * (ev_n * n * pk + 3 * n), 2 * ev_n * n * K * pk)
    rows.append(dict(name="fused_argmin_min_sketched", ms=k2x,
                     plain_ms=plain_k2x, bound_ms=b, bound_by=by,
                     shape={"n": n, "m": K, "d": pk},
                     row_need={"evaluated_fraction": ev_n, "ms": k2n,
                               "plain_ms": plain_k2n, "bound_ms": b_n,
                               "bound_by": by_n}))
    # -- where the time goes in a steady tol=0 loop (20 iterations) --------
    for name, fn in (("bounded", lambda: core.lloyd_loop_bounded(
            Xd, wd, c0, 0.0, max_iter=iters)),
                     ("full", lambda: core.lloyd_loop_fused(
                         Xd, wd, c0, 0.0, max_iter=iters))):
        prof = device_profile(fn)
        summary[f"profile_{name}_tol0_{iters}_iters"] = prof
        log(f"PROFILE {name} " + json.dumps(prof))
    launches = {"fused_argmin_min2": l_b["fused_argmin_min2"],
                "fused_argmin_min_sketched":
                    l_s["fused_argmin_min_sketched"]
                    + l_sp["fused_argmin_min_sketched"]}
    return rows, launches, summary


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    # full f32 products everywhere, stated rather than assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_name_power()
    log(f"card: {kind} (count {count}); nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    errs = edge_cases(dev)
    torch.cuda.synchronize()
    log(f"edge cases: all kernels match their plain versions "
        f"({time.perf_counter() - t0:.2f} s)")

    rng = np.random.default_rng(SEED)
    true_centers = rng.uniform(-10, 10, (K, D)).astype(np.float32)
    y_true = rng.integers(0, K, N)
    X = true_centers[y_true] + rng.standard_normal((N, D), dtype=np.float32)

    # -- the first path (algorithm="full"), through the estimator -------
    def full_fit_predict():
        km = KMeans(n_clusters=K, init="k-means||", oversampling_factor=2,
                    random_state=SEED).fit(X)
        return km, km.predict(X)

    (km, pred), fit_predict_s, launches = drive(full_fit_predict)
    log(f"blobs path: fit+predict {fit_predict_s:.3f} s, n_iter "
        f"{km.n_iter_}, phases {km.fit_phase_seconds_}, launches {launches}")
    path_line("blobs-full", fit_predict_s, km.n_iter_, launches,
              phases=km.fit_phase_seconds_)
    expect_launches("full", launches)
    expect(pred.dtype == np.int32 and km.labels_.dtype == np.int32,
           "labels are not int32")
    expect(np.array_equal(pred, km.labels_), "predict(X) != labels_")
    score = ari(y_true, pred)
    expect(score >= 0.99, f"ARI {score} < 0.99")
    expect(np.isfinite(km.cluster_centers_).all()
           and km.cluster_centers_.shape == (K, D), "bad centers")
    # the same fit again, warm: its time, and determinism under the seed
    t0 = time.perf_counter()
    warm = KMeans(n_clusters=K, init="k-means||", oversampling_factor=2,
                  random_state=SEED).fit(X)
    warm.predict(X)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    expect(np.array_equal(warm.cluster_centers_, km.cluster_centers_)
           and np.array_equal(warm.labels_, km.labels_),
           "two fits with the same seed differ")
    log(f"warm fit+predict {warm_s:.3f} s, phases "
        f"{warm.fit_phase_seconds_}; identical to the first fit")

    # kernel path against plain path from the fitted centers
    km2 = KMeans(n_clusters=K, init=km.cluster_centers_).fit(X)
    data = prepare_data(X, device=dev)
    tol = core.scaled_tolerance(data.X, data.weights, 1e-4)
    c0 = torch.as_tensor(km.cluster_centers_, device=dev)
    cp, _, it_p, _ = core.lloyd_loop_fused(data.X, data.weights, c0, tol,
                                           max_iter=300, kernel="torch")
    lp = core.predict_labels(data.X, cp, kernel="torch").cpu().numpy()
    expect(np.array_equal(km2.labels_, lp),
           "kernel path and plain path label the data differently")
    log(f"init=fitted centers: kernel and plain paths agree "
        f"(n_iter {km2.n_iter_} / {it_p})")

    # real-shape comparisons on the main path's data
    Xd, wd = data.X, data.weights
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    pick = torch.randperm(N, generator=g, device=dev)
    for name, m in (("K2/K3/K4 m=8", K), ("K3 m=80", 80),
                    ("K4 m=329", 329)):
        Y = Xd[pick[:m]]
        mask = torch.ones(m, dtype=torch.bool, device=dev)
        if m != K:  # candidate buffers: the later slots unfilled
            mask[m // 2:] = False
        e = check_fused(name, Xd, Y, mask, wd, exact=False)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    e = check_lloyd("K1 full shape", Xd, wd, c0, exact=False)
    errs["lloyd_iter"] = max(errs.get("lloyd_iter", 0.0), e)
    torch.cuda.synchronize()
    log("full-shape comparisons: all kernels within tolerance")

    phases = init_phase_seconds(Xd, wd)
    log("INIT_PHASES " + json.dumps(phases))
    rows = kernel_rows(time_kernels(Xd, wd), launches, errs)
    # one Lloyd iteration as the loop runs it: the kernel, the M-step
    # finalization and the host read of `shift`; tol 0 runs every iteration
    loop_iters = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core.lloyd_loop_fused(Xd, wd, c0, 0.0, max_iter=loop_iters)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / loop_iters
    for r in rows:
        log(f"  {r['name']:22s} {r['ms']:.4f} ms  bound {r['bound_ms']:.4f}"
            f" ms ({r['bound_by']})  plain {r['plain_ms']:.4f} ms  "
            f"launches {r['launches']}")
    fit = {"n": N, "d": D, "k": K, "fit_predict_s": fit_predict_s,
           "n_iter": km.n_iter_, "init_s": km.fit_phase_seconds_["init"],
           "lloyd_s": km.fit_phase_seconds_["lloyd"],
           "warm_fit_predict_s": warm_s,
           "warm_init_s": warm.fit_phase_seconds_["init"],
           "warm_lloyd_s": warm.fit_phase_seconds_["lloyd"],
           "lloyd_loop_ms_per_iter": loop_ms, "ari": score,
           "inertia": km.inertia_, "launches": launches}
    log("FIT " + json.dumps(fit))
    del data, Xd, wd, X
    torch.cuda.empty_cache()

    kdd_rows, kdd_launches, kdd = kdd_cell(dev, errs)
    rows += kernel_rows(kdd_rows, kdd_launches, errs)
    for r in rows[-2:]:
        log(f"  {r['name']:26s} {r['ms']:.4f} ms  bound {r['bound_ms']:.4f}"
            f" ms ({r['bound_by']})  plain {r['plain_ms']:.4f} ms  "
            f"launches {r['launches']}")
    for name, opt in (("fused_argmin_min2", rows[-2]["late_need"]),
                      ("fused_argmin_min_sketched", rows[-1]["row_need"])):
        log(f"  {name} with a late iteration's need "
            f"({opt['evaluated_fraction']:.4f} of groups evaluated): "
            f"{opt['ms']:.4f} ms  bound {opt['bound_ms']:.4f} ms  plain "
            f"{opt['plain_ms']:.4f} ms")
    log("KDD " + json.dumps(kdd))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
