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
4. drives the main path through the estimator a user would call:
   ``KMeans(n_clusters=8, init="k-means||").fit(X).predict(X)`` on
   1,000,000 × 50 float32 blobs with 8 well-separated centers made with
   numpy from a fixed seed, and checks the adjusted Rand index against
   the true labels (≥ 0.99), that every kernel was launched, and that the
   kernel path and the plain path give identical labels from the fitted
   centers;
5. times each kernel with CUDA events next to its bound and its plain
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
# H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# where the TPU kernel each CUDA kernel replaces is defined
REPLACES = {
    "lloyd_iter": "dask_ml_tpu/models/kmeans.py:186",
    "fused_argmin_min": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_rowwise_min": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_argmin_weight": "dask_ml_tpu/ops/fused_distance.py:378",
}
SOURCES = {
    "lloyd_iter": "dask_ml_tpu_torch/_kernels/csrc/lloyd.cu",
    "fused_argmin_min": "dask_ml_tpu_torch/_kernels/csrc/fused_distance.cu",
    "fused_rowwise_min": "dask_ml_tpu_torch/_kernels/csrc/fused_distance.cu",
    "fused_argmin_weight":
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


def time_kernels(X, w, launches, errs):
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
        y2 = fd._row_sumsq(Y).contiguous()
        maskf = torch.ones(m, device=dev)
        am = torch.empty(n, dtype=torch.int32, device=dev)
        mn = torch.empty(n, dtype=torch.float32, device=dev)
        nb = -(-n // fdl.dml_fused_rows_per_block())
        part = torch.empty((m, nb), device=dev)
        cw = torch.empty(m, device=dev)
        keep = (Y, y2, maskf, am, mn, part, cw)
        call = lambda: build.check(fdl.dml_fused_distance(  # noqa: E731
            epi, X.data_ptr(), Y.data_ptr(), y2.data_ptr(), maskf.data_ptr(),
            None, fd._FUSED_BLK, w.data_ptr() if with_w else None, n, m, d,
            am.data_ptr(), mn.data_ptr(), part.data_ptr(), cw.data_ptr(),
            stream), "timing")
        return Y, keep, call

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
        Y, keep, call = fused_args(epi, m, with_w=(epi == 2))
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
    out_rows = []
    for r in rows:
        out_rows.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": REPLACES[r["name"]],
            "launches": int(launches[r["name"]]),
            "max_abs_err": float(errs.get(r["name"], 0.0)),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": {"n": n, "m": r["m"], "d": d},
        })
    return out_rows


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from dask_ml_tpu_torch import _kernels
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

    # -- the main path, through the estimator --------------------------
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    km = KMeans(n_clusters=K, init="k-means||", oversampling_factor=2,
                random_state=SEED).fit(X)
    pred = km.predict(X)
    torch.cuda.synchronize()
    fit_predict_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    log(f"main path: fit+predict {fit_predict_s:.3f} s, n_iter "
        f"{km.n_iter_}, phases {km.fit_phase_seconds_}, launches {launches}")
    expect(all(v > 0 for v in launches.values()),
           f"a kernel of the main path was never launched: {launches}")
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
    rows = time_kernels(Xd, wd, launches, errs)
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
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
