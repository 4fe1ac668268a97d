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

With ``--fused-bf16`` it measures, in place of the softmax runs, the
fused distance kernels on bf16 X: K3-bf16 (m 80, every slot valid),
K3-p-bf16 (the k-means|| rounds' mask, the first 16 of 80 valid) and
K4-bf16 (m 329) on 1e6 × 50 blobs, and K3-kdd-bf16, K3-p-kdd-bf16 and
K4-kdd-bf16 on 4,898,431 × 41 (8 blobs each, drawn on the card from a
seed, targets picked among the rows), each through the C entry on buffers
allocated once, with CUDA events (the median of 20 after 3 warm-ups);
as controls bf16 K2 and K5 (m 8), f32 K3 and K4 on the blobs widened,
the cuBLAS bf16 GEMM of the score matrix alone at m 80 and 329, and one
copy of the blobs' X (its bytes read and written once: the card's rate). Each run
records two launches' outputs of the bf16 K3 and K4 (sha256, ``cw``
included), to show the bits repeat. The summary puts each side's fastest
run beside the other's, says whether the change's bf16 K3, K3-p and K4
beat the parent in every run, and names the kernels whose SASS
(``cuobjdump -sass`` of each side's ``fused_distance`` library) is the same
on both sides and those whose SASS differs.

    python3 chip_ab.py PARENT_DIR --fused-bf16

With ``--fused-ablations`` (no parent) it times, in this checkout only,
K3-bf16, K3-p-bf16 and K4-bf16 at the blobs' shape through variants of
``csrc/fused_distance.cu`` built side by side into a directory under
``TMPDIR`` (removed at the end): the source as it is, and with the fold of
the scores, the products, or the repack, |x|², products and fold all left
out (the bare ring), each variant's registers and spills from
``-Xptxas -v``. The variants compute wrong answers: they show where the
time goes, and the port never loads them.

    python3 chip_ab.py --fused-ablations

With ``--kmeans-bf16`` it measures, in place of the softmax runs, the
bf16 kernels of the Lloyd loops: K5-bf16 (``argmin_min2``, m 8) at the
KDD-shaped cell padded to whole 1,024-row groups (4,898,816 × 41) with
every group evaluated and with 0.1 % of the groups evaluated (the row need
of a late bounded iteration), K5-bf16 and K2-bf16 at the blobs (1e6 × 50,
m 8, and K2-bf16 at m 80, the next tile shape), K1-bf16 (one Lloyd
iteration, k 8) at the blobs and at the KDD-shaped cell (4,898,431 × 41);
as controls the f32 K1, K2 and K5 on the blobs widened, and one copy of
the blobs' X. X is 8 blobs drawn on the card from a seed, the targets and
centers picked among its rows; each kernel runs through its C entry on
buffers allocated once, timed with CUDA events (the median of 20 after 3
warm-ups), and each run records two launches' outputs (sha256) of every
kernel, to show the bits repeat and that both sides give the same bits.
The summary puts each side's fastest run beside the other's, gives the
change's fastest over the parent's, says whether the change beat the
parent in every run for K5-bf16 at the KDD cell (all groups and 0.1 %),
K2-bf16 and K1-bf16 at both shapes, and names the kernels whose SASS
(``cuobjdump -sass`` of each side's ``fused_distance`` and ``lloyd``
libraries) is the same on both sides and those whose SASS differs.

    python3 chip_ab.py PARENT_DIR --kmeans-bf16

With ``--lloyd-ablations`` (no parent) it times, in this checkout only,
K1-bf16 at the blobs and at the KDD-shaped cell through variants of
``csrc/lloyd.cu`` built side by side into a directory under ``TMPDIR``
(removed at the end): the source as it is, without the E-step's scores
(the products with the centers left out), without the M-step, the bare
ring (no E-step reads or scores, no M-step: the copies, the waits and
the block barrier), and without the copies (the compute alone, on
whatever the stages hold), with and without the M-step; two rounds, each
variant's registers and spills of ``lloyd_ring_kernel`` from ``-Xptxas
-v``. The variants compute wrong answers; the port never loads them.

    python3 chip_ab.py --lloyd-ablations

With ``--spmv-small`` it measures, in place of the softmax runs, K6 and
K6-b at the shapes the paths launch them at (``SPMV_SHAPES``: the served
sparse request, an elastic block, the one-hot pipeline's container, a
search fold, an incremental block), at the largest container of the
served width that the plan sends to L2 (262 tiles) and at the sparse GLM
cell (n 1e7, k 101, d 100,001), with f32 and with bf16 values, each
container drawn on the card from a seed (integer values, uniform columns,
the intercept's slot on column d - 1), the same in every run. Each run
times each kernel on its plan back to back (CUDA events around 200 calls,
after 20: the rate a caller that launches one call after another sees;
three rounds over all the calls, the fastest a call), its device time
(``torch.profiler``, every kernel of a call summed), and as the yardstick
cuSPARSE's SpMV through ``torch.mv`` on the f32 CSR view (transposed for
K6-b), the same two ways, and at the shapes of up to 125,000 rows the
forward on L2 and on one block, each named; it checks each output against
the plain version bit for bit and records its sha256. The summary puts
each side's fastest run beside the other's, says at which shapes the
change's K6 was faster than cuSPARSE in every one of its runs, whether
both sides' outputs have the same bits, and compares the SASS of both
sides' ``spmv`` libraries.

    python3 chip_ab.py PARENT_DIR --spmv-small

With ``--sketched`` it measures, in place of the softmax runs, f32 K2-x
(the sketched assignment: ``argmin_min`` with the caller's |x|², m 8, p
10) at the KDD sketched shape (4,898,431 rows) and at the served batch
(2,048 rows) through the C entry, back to back and by device time as
above, with the sha256 of its outputs on float data. The summary puts
each side's fastest run beside the other's, says whether the change was
faster in every run and whether both sides gave the same bits (the
parent's route is the f32 tile kernel, so this holds the span route to
its bits), and compares the SASS of both sides' ``fused_distance``
libraries.

    python3 chip_ab.py PARENT_DIR --sketched

With ``--spmv-wide`` it measures, in place of the softmax runs, K6 and
K6-b where the d-vector fits no cluster (``SPMV_WIDE_SHAPES``: the sparse
GLM cell's rows over the hashed width d = 2^20 + 1, and over d = 150,001,
beyond the f32 forward's cluster of 2), f32 and bf16 values, each
container drawn on the card from a seed (N(0, 1) values, uniform
columns, the intercept's slot of ones on column d - 1), the same in every
run. Each run times each direction on the route its checkout's plan takes
(the parent's: L2) back to back (CUDA events around up to 200 calls,
after up to 20) and by device time (``torch.profiler``), its first call on
a fresh copy of the values (host clock around the call and a
synchronize: the change's panel-major layout is built there, and the
pullback's values bound), records the sha256 of both pullbacks (the
fixed point gives every route the same bits) and the forward's largest
gap to the plain version; cuSPARSE's f32 SpMV through ``torch.mv`` on
the CSR view (transposed for K6-b), and where the checkout has the panel
route, both routes named in the same run and, at ``SPMV_WIDE_SWEEP_N``
rows of each container, both routes' steady and first calls (where the
route starts to pay). The summary puts each side's runs beside the
other's, the bound (8 bytes a slot), says whether the change's plan beat
the parent's in every run and whether both sides' pullbacks have the same
bits, and compares the SASS of both sides' ``spmv`` libraries.

    python3 chip_ab.py PARENT_DIR --spmv-wide

Each run names its plan's route (the change's: ``dvector_route``, the
route a call takes once the container's panel-major layout is held) and
times the layout's build alone (``ops.sparse._panel_layout`` between two
synchronizes, twice: the first of a process grows the allocator's pool)
at every shape of the sweep and at the wide shapes.

With ``--glm-wide`` it measures, in place of the softmax runs, the
``glm-wide`` path end to end: ``LogisticRegression(solver="lbfgs",
max_iter=m, tol=0)`` fit on ``make_sparse_classification(1e6, 2^20,
100 / 2^20, 42)`` (k = 100 + the intercept, d = 2^20 + 1) and its score
on the first 262,144 rows, for m in ``GLM_WIDE_ITERS``, host seconds
around fit and score between two synchronizes, three rounds after a
warm-up fit. Where the checkout has the panel route each round also runs
the same fit with L2 forced (no route past a cluster but L2) and with
the layout built at the first call (its build counted as free), beside
the route the solvers take; each fit's launches by counter, ``n_iter_``,
the coefficients' sha256 and the device memory still allocated after it.

    python3 chip_ab.py PARENT_DIR --glm-wide

``--tree DIR`` (used by the runs above) measures one checkout in this
process. Exits non-zero without a CUDA card."""

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
#: the fused distance cells: blobs and KDD-shaped (n, d), 8 blobs each;
#: the k-means|| buffers (round slots, valid slots of a round, weighted
#: candidates) and k
FUSED_CELLS = (("", 1_000_000, 50), ("-kdd", 4_898_431, 41))
ROUND_CAP, ROUND_COUNT, WEIGHT_CAND, K8 = 80, 16, 329, 8
#: H100 SXM dense bf16 and f32 (outside the tensor cores) rates
PEAK_BF16, PEAK_F32 = 989e12, 67e12
#: the KDD-shaped cell's rows, and the share of 1,024-row groups a late
#: bounded iteration evaluates
KDD_N, LATE_SHARE = 4_898_431, 0.001
#: the width at which the bf16 pullback runs in a cluster of 4 (k = 101)
D_CLUSTER4 = 150_001
FITS, ITERS, WARMUP = 3, 20, 3
#: K6's shapes on the paths (name, n, k, d), the last container at the
#: served width whose one-block grid has fewer blocks than the card has
#: SMs (262 tiles of 204 rows), and the sparse GLM cell's
SPMV_SHAPES = (("served", 2_048, 10, 100), ("edge", 53_448, 10, 100),
               ("elastic", 125_000, 21, 1_001),
               ("onehot", 1_000_000, 26, 26_001),
               ("search-fold", 250_000, 101, 100_001),
               ("incremental", 1_000_000, 101, 100_001),
               ("flagship", 10_000_000, 101, 100_001))
#: the shapes (n at most this) at which both forward routes are timed
SPMV_ROUTES_MAX_N = 125_000
#: the wide shapes (name, n, k, d): the cell's rows over the hashed width
#: (2^20 + 1 with the intercept) and over a width beyond the f32 forward's
#: cluster of 2; the rows of the panel route's sweep
SPMV_WIDE_SHAPES = (("hashed", 10_000_000, 101, 1_048_577),
                    ("beyond-c2", 10_000_000, 101, 150_001))
SPMV_WIDE_SWEEP_N = (20_000, 60_000, 125_000, 160_000, 500_000, 1_000_000)
#: the glm-wide path's data (n, n_features, density) and its fits' lengths
GLM_WIDE = (1_000_000, 2 ** 20, 100 / 2 ** 20)
GLM_WIDE_ITERS = (3, 30, 100)
#: K2-x's shapes (name, n, m, p): the KDD sketched cell and a served batch
SKETCHED_SHAPES = (("kdd", 4_898_431, 8, 10), ("served", 2_048, 8, 10))
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


def _calls_for(fn, most: int, seconds: float = 0.25) -> int:
    """How many calls of ``fn`` fill about ``seconds`` (at most ``most``,
    at least 3): a slow yardstick (cuSPARSE's transposed SpMV at the cell,
    ~0.3 s) is timed over fewer calls."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(3, min(most, int(seconds / max(time.perf_counter() - t0,
                                              1e-6))))


def stream_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """``fn``'s time a call over up to ``iters`` calls back to back (CUDA
    events around the loop, after up to ``warmup`` calls)."""
    import torch

    iters = _calls_for(fn, iters)
    for _ in range(min(warmup, iters)):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, calls: int = 20) -> float:
    """The device time of one call of ``fn``: every kernel it launches,
    summed over ``calls`` calls under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = _calls_for(fn, calls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        total += t if t is not None else e.cuda_time_total
    return total / calls / 1e3


def spmv_small_tree(tree: str) -> dict:
    """K6 and K6-b at every shape of ``SPMV_SHAPES``, f32 and bf16, in the
    checkout at ``tree``."""
    import hashlib

    import torch

    sps = _import_tree(tree).ops.sparse
    dev = torch.device("cuda", 0)

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    out = {"tree": tree, "ms": {}, "device_ms": {}, "sha": {}, "plain": {},
           "plan": {}}
    for name, n, k, d in SPMV_SHAPES:
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        cols = torch.randint(0, d, (n, k), dtype=torch.int32, generator=g,
                             device=dev)
        cols[:, -1] = d - 1
        v32 = torch.randint(-4, 4, (n, k), generator=g, device=dev).float()
        v = torch.randint(-4, 4, (d,), generator=g, device=dev).float()
        r = torch.randint(-4, 4, (n,), generator=g, device=dev).float()
        crow = torch.arange(0, n * k + 1, k, dtype=torch.int32, device=dev)
        csr = torch.sparse_csr_tensor(crow, cols.view(-1), v32.view(-1),
                                      size=(n, d), check_invariants=False)
        calls = {"cusparse": lambda: torch.mv(csr, v),
                 "cusparse-t": lambda: torch.mv(csr.t(), r)}
        for tag, vals in (("f32", v32), ("bf16", v32.to(torch.bfloat16))):
            calls[f"K6-{tag}"] = (lambda vals=vals:
                                  sps._spmv_cuda(vals, cols, v))
            calls[f"K6-b-{tag}"] = (lambda vals=vals:
                                    sps._pullback_cuda(vals, cols, r, d))
            out["plan"][f"{name}/K6-{tag}"] = sps.dvector_plan(
                n, k, d, dtype=vals.dtype)
            out["plain"][f"{name}/K6-{tag}"] = bool(torch.equal(
                calls[f"K6-{tag}"](), sps._spmv_ref(vals, cols, v)))
            out["plain"][f"{name}/K6-b-{tag}"] = bool(torch.equal(
                calls[f"K6-b-{tag}"](), sps._pullback_ref(vals, cols, r, d)))
            if n <= SPMV_ROUTES_MAX_N:
                # both forward routes, named, in the same run
                for route, c in (("l2", 0), ("c1", 1)):
                    calls[f"K6-{tag}-{route}"] = (
                        lambda vals=vals, c=c: sps._spmv_cuda(vals, cols, v,
                                                              cluster=c))
        # three rounds over every call, the fastest a call: at the small
        # shapes the host sets the pace, and its speed drifts within a run
        for _ in range(3):
            for key, fn in calls.items():
                t = stream_ms(fn)
                out["ms"][f"{name}/{key}"] = min(
                    t, out["ms"].get(f"{name}/{key}", t))
        for key, fn in calls.items():
            out["device_ms"][f"{name}/{key}"] = device_ms(fn)
            if key.startswith("K6"):
                out["sha"][f"{name}/{key}"] = sha(fn())
        del cols, v32, v, r, crow, csr, calls
        torch.cuda.empty_cache()
    return out


def spmv_small_summary(side: dict) -> dict:
    """Each side's fastest run of every timing; where the change's K6
    beat cuSPARSE in every run (time and device time); whether both
    sides' outputs have the same bits and equal the plain versions."""
    summary = {}
    for name, rs in side.items():
        summary[name] = {key: {"ms": min(r["ms"][key] for r in rs),
                               "device_ms": min(r["device_ms"][key]
                                                for r in rs)}
                         for key in rs[0]["ms"]}
    ch = side["change"]
    beats = {}
    for shape in {key.split("/")[0] for key in ch[0]["ms"]}:
        for kern, lib in (("K6-f32", "cusparse"), ("K6-bf16", "cusparse"),
                          ("K6-b-f32", "cusparse-t"),
                          ("K6-b-bf16", "cusparse-t")):
            a, b = f"{shape}/{kern}", f"{shape}/{lib}"
            beats[a] = {m: all(r[m][a] < r[m][b] for r in ch)
                        for m in ("ms", "device_ms")}
    summary["change_beats_library_every_run"] = beats
    # the plan's choice at the short containers: L2 against one block,
    # within each of the change's runs
    summary["change_l2_beats_one_block_every_run"] = {
        key[:-3]: {m: all(r[m][key] < r[m][key[:-3] + "-c1"] for r in ch)
                   for m in ("ms", "device_ms")}
        for key in ch[0]["ms"] if key.endswith("-l2")}
    runs = side["change"] + side["parent"]
    summary["same_bits_both_sides"] = {
        key: len({r["sha"][key] for r in runs}) == 1
        for key in ch[0]["sha"]}
    summary["change_equals_plain"] = all(all(r["plain"].values())
                                         for r in ch)
    summary["change_plan"] = ch[0]["plan"]
    summary["parent_plan"] = side["parent"][0]["plan"]
    return summary


def first_call_s(fn, values) -> float:
    """Host seconds of ``fn(fresh)`` and a synchronize, ``fresh`` a new
    copy of ``values``: nothing is kept on it yet (the values bound, the
    panel-major layout)."""
    import torch

    fresh = values.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(fresh)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def spmv_wide_tree(tree: str) -> dict:
    """K6 and K6-b at ``SPMV_WIDE_SHAPES``, f32 and bf16, in the checkout
    at ``tree``."""
    import hashlib

    import torch

    sps = _import_tree(tree).ops.sparse
    panel = getattr(sps, "PANEL", None)
    dev = torch.device("cuda", 0)

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    out = {"tree": tree, "ms": {}, "device_ms": {}, "first_s": {},
           "sha": {}, "plain_gap": {}, "plan": {}, "bound_ms": {},
           "build_s": {}}
    plan_of = sps.dvector_route if panel is not None else sps.dvector_plan

    def build_s(vals, cols, d):
        """Host seconds of the layout's build, twice."""
        if panel is None:
            return None
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lay = sps._panel_layout(vals, cols, d)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del lay
        return times
    for name, n, k, d in SPMV_WIDE_SHAPES:
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        cols = torch.randint(0, d - 1, (n, k), dtype=torch.int32,
                             generator=g, device=dev)
        cols[:, -1] = d - 1
        v32 = torch.randn((n, k), generator=g, device=dev)
        v32[:, -1] = 1.0
        v = torch.randn(d, generator=g, device=dev) * 0.05
        r = torch.randn(n, generator=g, device=dev) / n
        out["bound_ms"][name] = (4 * (2 * n * k + n + d)
                                 / PEAK_BYTES_PER_S * 1e3)
        crow = torch.arange(0, n * k + 1, k, dtype=torch.int32, device=dev)
        csr = torch.sparse_csr_tensor(crow, cols.view(-1), v32.view(-1),
                                      size=(n, d), check_invariants=False)
        calls = {"cusparse": lambda: torch.mv(csr, v),
                 "cusparse-t": lambda: torch.mv(csr.t(), r)}
        for tag in ("f32", "bf16"):
            vals = v32 if tag == "f32" else v32.to(torch.bfloat16)
            cf = plan_of(n, k, d, dtype=vals.dtype)
            cb = plan_of(n, k, d, pullback=True, dtype=vals.dtype)
            out["plan"][f"{name}/K6-{tag}"] = cf
            out["plan"][f"{name}/K6-b-{tag}"] = cb
            out["build_s"][f"{name}/{tag}"] = build_s(vals, cols, d)
            out["first_s"][f"{name}/K6-{tag}"] = first_call_s(
                lambda x, cf=cf: sps._spmv_cuda(x, cols, v, cluster=cf),
                vals)
            out["first_s"][f"{name}/K6-b-{tag}"] = first_call_s(
                lambda x, cb=cb: sps._pullback_cuda(x, cols, r, d,
                                                    cluster=cb), vals)
            f = sps._spmv_cuda(vals, cols, v, cluster=cf)
            out["plain_gap"][f"{name}/K6-{tag}"] = float(
                (f - sps._spmv_ref(vals, cols, v)).abs().max())
            out["sha"][f"{name}/K6-b-{tag}"] = sha(
                sps._pullback_cuda(vals, cols, r, d, cluster=cb))
            del f
            calls[f"K6-{tag}"] = (lambda vals=vals, cf=cf:
                                  sps._spmv_cuda(vals, cols, v, cluster=cf))
            calls[f"K6-b-{tag}"] = (lambda vals=vals, cb=cb:
                                    sps._pullback_cuda(vals, cols, r, d,
                                                       cluster=cb))
            if panel is not None:  # both routes named, in this run
                for route, c in (("l2", 0), ("panel", panel)):
                    calls[f"K6-{tag}-{route}"] = (
                        lambda vals=vals, c=c: sps._spmv_cuda(
                            vals, cols, v, cluster=c))
                    calls[f"K6-b-{tag}-{route}"] = (
                        lambda vals=vals, c=c: sps._pullback_cuda(
                            vals, cols, r, d, cluster=c))
        for key, fn in calls.items():
            out["ms"][f"{name}/{key}"] = stream_ms(fn)
            out["device_ms"][f"{name}/{key}"] = device_ms(fn)
        del calls, csr, crow
        torch.cuda.empty_cache()
        if panel is not None:
            # where the panel route starts to pay: fewer rows of the same
            # container, each slice a container of its own
            for m in SPMV_WIDE_SWEEP_N:
                vs, cs, rs = v32[:m], cols[:m], r[:m].contiguous()
                out["build_s"][f"{name}@{m}/f32"] = build_s(vs, cs, d)
                for route, c in (("l2", 0), ("panel", panel)):
                    key = f"{name}@{m}/K6-f32-{route}"
                    out["first_s"][key] = first_call_s(
                        lambda x, c=c: sps._spmv_cuda(x, cs, v, cluster=c),
                        vs)
                    out["ms"][key] = stream_ms(
                        lambda c=c: sps._spmv_cuda(vs, cs, v, cluster=c))
                    key = f"{name}@{m}/K6-b-f32-{route}"
                    out["first_s"][key] = first_call_s(
                        lambda x, c=c: sps._pullback_cuda(x, cs, rs, d,
                                                          cluster=c), vs)
                    out["ms"][key] = stream_ms(
                        lambda c=c: sps._pullback_cuda(vs, cs, rs, d,
                                                       cluster=c))
                del vs, cs, rs
                torch.cuda.empty_cache()
        del cols, v32, v, r
        torch.cuda.empty_cache()
    return out


def spmv_wide_summary(side: dict) -> dict:
    """Each side's runs of every timing beside the other's, the fastest a
    side; whether the change's plan beat the parent's in every run;
    whether both sides' pullbacks have the same bits."""
    summary = {"bound_ms": side["change"][0]["bound_ms"]}
    for name, rs in side.items():
        summary[name] = {
            key: {"ms": [r["ms"][key] for r in rs],
                  "device_ms": [r["device_ms"][key] for r in rs],
                  "min_ms": min(r["ms"][key] for r in rs)}
            for key in rs[0]["ms"] if key in rs[0]["device_ms"]}
        summary[name + "_first_s"] = {
            key: [r["first_s"][key] for r in rs] for key in rs[0]["first_s"]}
        summary[name + "_sweep_ms"] = {
            key: [r["ms"][key] for r in rs] for key in rs[0]["ms"]
            if "@" in key}
        summary[name + "_plan"] = rs[0]["plan"]
        summary[name + "_build_s"] = {
            key: [r["build_s"][key] for r in rs] for key in rs[0]["build_s"]}
        summary[name + "_plain_gap"] = rs[0]["plain_gap"]
    pa, ch = side["parent"], side["change"]
    summary["change_plan_faster_every_run"] = {
        key: all(c["ms"][key] < p["ms"][key] for c in ch for p in pa)
        for key in pa[0]["ms"] if key.split("/")[1].startswith("K6")}
    summary["same_pullback_bits_both_sides"] = {
        key: len({r["sha"][key] for r in pa + ch}) == 1
        for key in ch[0]["sha"]}
    return summary


def glm_wide_tree(tree: str) -> dict:
    """The glm-wide path end to end (``GLM_WIDE``, ``GLM_WIDE_ITERS``) in
    the checkout at ``tree``: fit and score walls on the route the solvers
    take and, where the checkout has the panel route, with L2 forced and
    with the layout built at the first call."""
    import hashlib

    import numpy as np
    import torch

    pkg = _import_tree(tree)
    import dask_ml_tpu_torch.datasets  # noqa: F401
    import dask_ml_tpu_torch.linear_model  # noqa: F401

    sps = pkg.ops.sparse
    policies = {"route": {}}
    if hasattr(sps, "PANEL"):
        policies["l2"] = {"_PANEL_MIN_SLOTS": {False: 1 << 62, True: 1 << 62}}
        policies["eager"] = {"_PANEL_BUILD_S": (0.0, 0.0)}
    n, width, density = GLM_WIDE
    t0 = time.perf_counter()
    X, y = pkg.datasets.make_sparse_classification(n, width, density,
                                                   random_state=42)
    out = {"tree": tree, "generation_s": time.perf_counter() - t0,
           "policies": list(policies), "runs": []}
    Xs, ys = X[:262_144], y[:262_144]

    def fit(m, patch):
        saved = {key: getattr(sps, key) for key in patch}
        for key, val in patch.items():
            setattr(sps, key, val)
        try:
            torch.cuda.synchronize()
            pkg._kernels.reset_launches()
            t0 = time.perf_counter()
            est = pkg.linear_model.LogisticRegression(
                solver="lbfgs", max_iter=m, tol=0.0).fit(X, y)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            acc = est.score(Xs, ys)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            for key, val in saved.items():
                setattr(sps, key, val)
        return {"fit_s": t1 - t0, "score_s": t2 - t1, "wall_s": t2 - t0,
                "n_iter": int(est.n_iter_), "accuracy": float(acc),
                "launches": {key: c for key, c in
                             pkg._kernels.launches.items() if c},
                "coef_sha": hashlib.sha256(
                    np.ascontiguousarray(est.coef_).tobytes()).hexdigest()[
                        :16],
                "allocated_after": torch.cuda.memory_allocated()}

    for patch in policies.values():
        fit(1, patch)  # builds the libraries and warms the allocator
    for rnd in range(3):
        for m in GLM_WIDE_ITERS:
            for name, patch in policies.items():
                out["runs"].append({"round": rnd, "max_iter": m,
                                    "policy": name, **fit(m, patch)})
    return out


def glm_wide_summary(side: dict) -> dict:
    """Each side's walls (fit + score) by policy and fit length, every
    round of every run, and the launches of each."""
    summary = {}
    for name, rs in side.items():
        walls, launches = {}, {}
        for r in rs:
            for run in r["runs"]:
                key = f"{run['policy']}/max_iter={run['max_iter']}"
                walls.setdefault(key, []).append(run["wall_s"])
                launches[key] = run["launches"]
        summary[name] = {key: {"wall_s": w, "min_s": min(w),
                               "launches": launches[key]}
                         for key, w in walls.items()}
    return summary


def sketched_tree(tree: str) -> dict:
    """f32 K2-x at ``SKETCHED_SHAPES`` in the checkout at ``tree``."""
    import hashlib

    import torch

    _import_tree(tree)
    from dask_ml_tpu_torch._kernels import build

    lib = build.load("fused_distance")
    dev = torch.device("cuda", 0)
    out = {"tree": tree, "ms": {}, "device_ms": {}, "sha": {}}
    for name, n, m, p in SKETCHED_SHAPES:
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        Z = torch.randn((n, p), generator=g, device=dev)
        Y = torch.randn((m, p), generator=g, device=dev)
        x2 = torch.rand(n, generator=g, device=dev) * 4 * p
        key = f"{name}/K2-x"
        call, outs = fused_call(lib, Z, Y, 1, x2=x2)
        out["ms"][key] = stream_ms(call, 100, 10)
        out["device_ms"][key] = device_ms(call)
        call()
        torch.cuda.synchronize()
        out["sha"][key] = hashlib.sha256(
            outs["am"].cpu().numpy().tobytes()
            + outs["min"].cpu().numpy().tobytes()).hexdigest()[:16]
        out["bound_ms"] = out.get("bound_ms", {})
        out["bound_ms"][name] = 4 * (n * p + 3 * n) / PEAK_BYTES_PER_S * 1e3
        del Z, Y, x2
        torch.cuda.empty_cache()
    return out


def sketched_summary(side: dict) -> dict:
    summary = {}
    for name, rs in side.items():
        summary[name] = {key: {"ms": min(r["ms"][key] for r in rs),
                               "device_ms": min(r["device_ms"][key]
                                                for r in rs)}
                         for key in rs[0]["ms"]}
    pa, ch = side["parent"], side["change"]
    summary["change_faster_every_run"] = {
        shape: all(c["ms"][f"{shape}/K2-x"] < p["ms"][f"{shape}/K2-x"]
                   for c in ch for p in pa)
        for shape, *_ in SKETCHED_SHAPES}
    summary["same_bits_both_sides"] = {
        shape: len({r["sha"][f"{shape}/K2-x"] for r in pa + ch}) == 1
        for shape, *_ in SKETCHED_SHAPES}
    summary["bound_ms"] = ch[0]["bound_ms"]
    return summary


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


def fused_call(lib, X, Y, epi, mask=None, w=None, gneed=None, x2=None):
    """(a closure that launches ``dml_fused_distance`` once on buffers
    allocated here, its output buffers): Y rounded to X's dtype and held
    in f32, |y|² from Y, as the wrapper hands them over; ``gneed`` the
    uint8 flags of the row need's groups, or None; ``x2`` the caller's
    |x|² (K2-x), or None."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import fused_distance as fd

    dev = X.device
    n, d = X.shape
    m = Y.shape[0]
    y2 = fd._row_sumsq(Y).contiguous()
    Yk = Y.to(X.dtype).to(torch.float32).contiguous()
    maskf = (torch.ones(m, device=dev) if mask is None
             else mask.to(torch.float32).contiguous())
    am = torch.zeros(n, dtype=torch.int32, device=dev)
    mn = torch.zeros(n, device=dev)
    mn2 = torch.zeros(n, device=dev)
    part = torch.empty((m, -(-n // lib.dml_fused_rows_per_block())),
                       device=dev)
    cw = torch.zeros(m, device=dev)
    wp = None if w is None else w.data_ptr()
    gp = None if gneed is None else gneed.data_ptr()
    xp = None if x2 is None else x2.data_ptr()
    stream = build.stream_of(X)

    def call():
        build.check(lib.dml_fused_distance(
            epi, X.data_ptr(), int(X.dtype == torch.bfloat16), Yk.data_ptr(),
            y2.data_ptr(), maskf.data_ptr(), gp, fd._FUSED_BLK, xp, wp,
            n, m, d, am.data_ptr(), mn.data_ptr(), mn2.data_ptr(),
            part.data_ptr(), cw.data_ptr(), stream), "fused timing")

    return call, {"am": am, "min": mn, "min2": mn2, "cw": cw}


def lloyd_call(lib, X, w, C):
    """(a closure that launches ``dml_lloyd_iter`` once on buffers allocated
    here, its output): the centers rounded to X's dtype and held in f32,
    |c|² from C, as the wrapper hands them over."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import fused_distance as fd

    n, d = X.shape
    k = C.shape[0]
    c2 = fd._row_sumsq(C).contiguous()
    Ck = C.to(X.dtype).to(torch.float32).contiguous()
    P = k * (d + 1) + 1
    part = torch.empty(lib.dml_lloyd_max_partials() * P, device=X.device)
    out = torch.empty(P, device=X.device)
    stream = build.stream_of(X)

    def call():
        build.check(lib.dml_lloyd_iter(
            X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(),
            Ck.data_ptr(), c2.data_ptr(), n, k, d, part.data_ptr(),
            out.data_ptr(), stream), "lloyd timing")

    return call, out


def blob_rows(n, d, seed, dev):
    """n rows of 8 blobs in d features, drawn on the card, in bf16."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    centers = 4.0 * torch.randn(K8, d, generator=g, device=dev)
    lab = torch.randint(0, K8, (n,), generator=g, device=dev)
    return (centers[lab] + torch.randn(n, d, generator=g, device=dev)
            ).to(torch.bfloat16)


def kmeans_tree(tree: str) -> dict:
    """The bf16 kernels of the Lloyd loops (and the f32 controls) at the
    blobs and KDD-shaped cells in the checkout at ``tree``."""
    import hashlib

    import torch

    _import_tree(tree)
    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import fused_distance as fd

    fdl, ll = build.load("fused_distance"), build.load("lloyd")
    dev = torch.device("cuda", 0)
    out = {"tree": tree, "ms": {}, "bound_ms": {}, "sha": {}}

    def run(name, call, bufs, nbytes):
        out["ms"][name] = cuda_ms(call)
        out["bound_ms"][name] = nbytes / PEAK_BYTES_PER_S * 1e3
        shas = []
        for _ in range(2):
            call()
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for t in bufs:
                h.update(t.cpu().numpy().tobytes())
            shas.append(h.hexdigest()[:16])
        out["sha"][name] = shas

    def fused(name, X, m, epi, gneed=None, share=1.0):
        n, d = X.shape
        pick = torch.randperm(n, generator=g, device=dev)[:m]
        Y = X[pick].float()
        call, bufs = fused_call(fdl, X, Y, epi, gneed=gneed)
        keys = ("am", "min", "min2") if epi == 3 else ("am", "min")
        nout = len(keys)
        run(name, call, [bufs[k] for k in keys],
            X.element_size() * share * n * d + 4 * (m * d + nout * n))

    def lloyd(name, X):
        n, d = X.shape
        pick = torch.randperm(n, generator=g, device=dev)[:K8]
        w = torch.ones(n, device=dev)
        call, res = lloyd_call(ll, X, w, X[pick].float())
        run(name, call, [res],
            X.element_size() * n * d + 4 * (n + K8 * d + K8 * (d + 1) + 1))

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    # the KDD-shaped cell: K1 on its rows, K5 on them padded to whole
    # groups (the bounded loop's padding), every group or 0.1 % of them
    Xk = blob_rows(KDD_N, 41, SEED + KDD_N, dev)
    lloyd("K1-kdd-bf16", Xk)
    ng = -(-KDD_N // fd._FUSED_BLK)
    Xp = torch.cat([Xk, Xk.new_zeros((ng * fd._FUSED_BLK - KDD_N, 41))])
    del Xk
    fused("K5-kdd-bf16", Xp, K8, 3,
          gneed=torch.ones(ng, dtype=torch.uint8, device=dev))
    late = torch.zeros(ng, dtype=torch.uint8, device=dev)
    nl = max(1, round(LATE_SHARE * ng))
    late[torch.randperm(ng, generator=g, device=dev)[:nl]] = 1
    fused("K5-kdd-bf16 0.1%", Xp, K8, 3, gneed=late, share=nl / ng)
    del Xp
    torch.cuda.empty_cache()
    # the blobs, and the f32 controls on them widened
    Xb = blob_rows(1_000_000, 50, SEED + 1_000_000, dev)
    lloyd("K1-bf16", Xb)
    fused("K2-bf16", Xb, K8, 1)
    fused("K5-bf16", Xb, K8, 3)
    fused("K2-bf16 m=80", Xb, ROUND_CAP, 1)
    Xw = Xb.float()
    lloyd("K1", Xw)
    fused("K2", Xw, K8, 1)
    fused("K5", Xw, K8, 3)
    dst = torch.empty_like(Xb)
    out["ms"]["copy X"] = cuda_ms(lambda: dst.copy_(Xb))
    out["bound_ms"]["copy X"] = 2 * 2 * Xb.numel() / PEAK_BYTES_PER_S * 1e3
    return out


#: the timings the change must win in every run
KMEANS_CLAIMED = ("K5-kdd-bf16", "K5-kdd-bf16 0.1%", "K2-bf16", "K1-bf16",
                  "K1-kdd-bf16")


def kmeans_summary(side: dict) -> dict:
    """Each side's fastest run a kernel, the change's fastest over the
    parent's, whether the change beat the parent in every run, whether
    each side's two launches gave the same bits and both sides the same."""
    summary = {name: {key: min(r["ms"][key] for r in rs)
                      for key in rs[0]["ms"]}
               for name, rs in side.items()}
    summary["change_over_parent"] = {
        k: summary["change"][k] / summary["parent"][k]
        for k in summary["change"] if k in summary["parent"]}
    summary["faster_every_run"] = {
        k: max(r["ms"][k] for r in side["change"])
        < min(r["ms"][k] for r in side["parent"]) for k in KMEANS_CLAIMED}
    summary["bits_repeat"] = {
        name: all(all(len(set(v)) == 1 for v in r["sha"].values())
                  for r in rs) for name, rs in side.items()}
    summary["same_bits_both_sides"] = {
        k: len({r["sha"][k][0] for rs in side.values() for r in rs}) == 1
        for k in side["change"][0]["sha"]}
    summary["bound_ms"] = side["change"][0]["bound_ms"]
    return summary


def fused_tree(tree: str) -> dict:
    """The fused distance kernels on bf16 X (and the controls) at the
    blobs and KDD-shaped cells in the checkout at ``tree``."""
    import hashlib

    import torch

    _import_tree(tree)
    from dask_ml_tpu_torch._kernels import build

    lib = build.load("fused_distance")
    dev = torch.device("cuda", 0)
    out = {"tree": tree, "ms": {}, "bound_ms": {}, "sha": {}}

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def bound(X, m_valid, m, epi):
        n, d = X.shape
        nbytes = X.element_size() * n * d + 4 * (m * d + n)
        if epi == 2:
            nbytes += 4 * (n + m)
        peak = PEAK_BF16 if X.dtype == torch.bfloat16 else PEAK_F32
        return max(nbytes / PEAK_BYTES_PER_S,
                   2.0 * n * m_valid * d / peak) * 1e3

    for tag, n, d in FUSED_CELLS:
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + n)
        centers = 4.0 * torch.randn(K8, d, generator=g, device=dev)
        lab = torch.randint(0, K8, (n,), generator=g, device=dev)
        X16 = (centers[lab] + torch.randn(n, d, generator=g, device=dev)
               ).to(torch.bfloat16)
        del lab
        w = torch.ones(n, device=dev)
        pick = torch.randperm(n, generator=g, device=dev)
        cases = [(f"K3{tag}-bf16", X16, 0, ROUND_CAP, ROUND_CAP),
                 (f"K3-p{tag}-bf16", X16, 0, ROUND_CAP, ROUND_COUNT),
                 (f"K4{tag}-bf16", X16, 2, WEIGHT_CAND, WEIGHT_CAND)]
        if not tag:
            Xw = X16.float()
            cases += [("K2-bf16", X16, 1, K8, K8), ("K5-bf16", X16, 3, K8, K8),
                      ("K3", Xw, 0, ROUND_CAP, ROUND_CAP),
                      ("K4", Xw, 2, WEIGHT_CAND, WEIGHT_CAND)]
        for name, X, epi, m, valid in cases:
            Y = X16[pick[:m]].float()
            mask = torch.arange(m, device=dev) < valid
            call, bufs = fused_call(lib, X, Y, epi, mask,
                                    w if epi == 2 else None)
            out["ms"][name] = cuda_ms(call)
            out["bound_ms"][name] = bound(X, valid, m, epi)
            if X.dtype == torch.bfloat16 and epi in (0, 2):
                keys = ("min",) if epi == 0 else ("am", "cw")
                shas = []
                for _ in range(2):
                    call()
                    torch.cuda.synchronize()
                    shas.append(sha(*(bufs[k] for k in keys)))
                out["sha"][name] = shas
            del call, bufs
        if not tag:
            for m in (ROUND_CAP, WEIGHT_CAND):
                Yb = X16[pick[:m]]
                out["ms"][f"gemm m={m}"] = cuda_ms(
                    lambda: torch.mm(X16, Yb.T))
            # the card's rate for X's bytes: one copy reads and writes them
            dst = torch.empty_like(X16)
            out["ms"]["copy X"] = cuda_ms(lambda: dst.copy_(X16))
            del Xw, dst
        del X16, w, pick
        torch.cuda.empty_cache()
    return out


#: source edits of the ablations (each must match the source once)
_NO_FOLD = [('  asm("mma.sync', '  asm volatile("mma.sync'),
            ("    if (merge)\n      merge_ns<IDX>(ns, acc, y2s + tc * NC * 8,",
             "    if (false)\n      merge_ns<IDX>(ns, acc, y2s + tc * NC * 8,")]
_NO_PRODUCTS = [('  static_assert(NS % 2 == 0 && NS <= NC, "pairs of target tiles");',
                 '  static_assert(NS % 2 == 0 && NS <= NC, "pairs of target tiles");'
                 '\n  return;')]
_NO_REPACK = [("  const int c8 = lane & 7;\n  if (c8 >= 2 * ksc) return;\n"
               "#pragma unroll\n  for (int q = 0; q < 8; ++q) {",
               "  return;\n  const int c8 = lane & 7;\n#pragma unroll\n"
               "  for (int q = 0; q < 8; ++q) {"),
              ("own_x2 ? x2_chain(As, warp * 32 + lane, d, 0.f) : 0.f", "0.f")]
ABLATIONS = {"source": [], "no fold": _NO_FOLD, "no products": _NO_PRODUCTS,
             "bare ring": _NO_FOLD + _NO_PRODUCTS + _NO_REPACK}


def fused_ablations() -> dict:
    """K3-bf16, K3-p-bf16 and K4-bf16 at the blobs through each variant of
    ``ABLATIONS``, two rounds, with each variant's ptxas report."""
    import ctypes
    import re
    import tempfile

    import torch

    _import_tree(HERE)
    from dask_ml_tpu_torch._kernels import build

    src = open(os.path.join(HERE, "dask_ml_tpu_torch", "_kernels", "csrc",
                            "fused_distance.cu")).read()
    tmp = tempfile.mkdtemp(prefix="chip_ab_ablations_")
    out = {"ptxas": {}, "ms": {}}
    try:
        procs = {}
        for name, edits in ABLATIONS.items():
            text = src
            for a, b in edits:
                if text.count(a) != 1:
                    raise RuntimeError(f"ablation {name!r}: edit not found")
                text = text.replace(a, b)
            stem = os.path.join(tmp, name.replace(" ", "_"))
            open(stem + ".cu", "w").write(text)
            procs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"ablation {name!r} failed to build")
            out["ptxas"][name] = re.findall(
                r"fused_mma_kernelILi(\d)E.*?\n.*?(\d+ bytes spill stores)"
                r".*?\n.*?Used (\d+) registers", log)
        dev = torch.device("cuda", 0)
        n, d = FUSED_CELLS[0][1:]
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + n)
        centers = 4.0 * torch.randn(K8, d, generator=g, device=dev)
        X16 = (centers[torch.randint(0, K8, (n,), generator=g, device=dev)]
               + torch.randn(n, d, generator=g, device=dev)
               ).to(torch.bfloat16)
        w = torch.ones(n, device=dev)
        argt, rest = build.SIGNATURES["fused_distance"]["dml_fused_distance"]
        for _ in range(2):
            for name in ABLATIONS:
                lib = ctypes.CDLL(os.path.join(
                    tmp, name.replace(" ", "_") + ".so"))
                lib.dml_fused_distance.argtypes = argt
                lib.dml_fused_distance.restype = rest
                lib.dml_fused_rows_per_block.restype = ctypes.c_int
                row = out["ms"].setdefault(name, {})
                for key, epi, m, valid in (
                        ("K3-bf16", 0, ROUND_CAP, ROUND_CAP),
                        ("K3-p-bf16", 0, ROUND_CAP, ROUND_COUNT),
                        ("K4-bf16", 2, WEIGHT_CAND, WEIGHT_CAND)):
                    mask = torch.arange(m, device=dev) < valid
                    call, _ = fused_call(lib, X16, X16[:m].float(), epi, mask,
                                         w if epi == 2 else None)
                    row.setdefault(key, []).append(cuda_ms(call))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


#: source edits of the K1-bf16 ablations (each must match the source once)
_NO_SCORES = [("        fma8(a, xv, ct + f * KC);\n", "")]
_NO_MSTEP = [("        for (unsigned m = wd[g * KC + j]; m != 0u;",
              "        for (unsigned m = 0u; m != 0u;")]
_NO_EREADS = [("      for (int f = 0; f < d; ++f) {\n"
               "        const float xv = __uint_as_float(",
               "      for (int f = 0; f < 0; ++f) {\n"
               "        const float xv = __uint_as_float(")]
_NO_COPIES = [("      mbar_expect_tx(full + s, (unsigned)(hi - lo));\n"
                "      if (hi > lo)\n",
                "      mbar_expect_tx(full + s, 0u);\n"
                "      if (false)\n")]
LLOYD_ABLATIONS = {"source": [], "no E-step scores": _NO_SCORES,
                   "no M-step": _NO_MSTEP,
                   "bare ring": _NO_SCORES + _NO_MSTEP + _NO_EREADS,
                   "no copies": _NO_COPIES,
                   "no copies or M-step": _NO_COPIES + _NO_MSTEP}


def lloyd_ablations() -> dict:
    """K1-bf16 at the blobs and the KDD-shaped cell through each variant
    of ``LLOYD_ABLATIONS``, two rounds, with each variant's ptxas report
    of ``lloyd_ring_kernel``."""
    import ctypes
    import re
    import tempfile

    import torch

    _import_tree(HERE)
    from dask_ml_tpu_torch._kernels import build

    src = open(os.path.join(HERE, "dask_ml_tpu_torch", "_kernels", "csrc",
                            "lloyd.cu")).read()
    tmp = tempfile.mkdtemp(prefix="chip_ab_lloyd_")
    out = {"ptxas": {}, "ms": {}}
    try:
        procs = {}
        for name, edits in LLOYD_ABLATIONS.items():
            text = src
            for a, b in edits:
                if text.count(a) != 1:
                    raise RuntimeError(f"ablation {name!r}: edit not found")
                text = text.replace(a, b)
            stem = os.path.join(tmp, name.replace(" ", "_"))
            open(stem + ".cu", "w").write(text)
            procs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"ablation {name!r} failed to build: "
                                   f"{log[-2000:]}")
            out["ptxas"][name] = re.findall(
                r"lloyd_ring_kernel.*?\n.*?(\d+ bytes spill stores)"
                r".*?\n.*?Used (\d+) registers", log)
        dev = torch.device("cuda", 0)
        cells = {"K1-bf16": blob_rows(1_000_000, 50, SEED + 1_000_000, dev),
                 "K1-kdd-bf16": blob_rows(KDD_N, 41, SEED + KDD_N, dev)}
        argt, rest = build.SIGNATURES["lloyd"]["dml_lloyd_iter"]
        for _ in range(2):
            for name in LLOYD_ABLATIONS:
                lib = ctypes.CDLL(os.path.join(
                    tmp, name.replace(" ", "_") + ".so"))
                lib.dml_lloyd_iter.argtypes = argt
                lib.dml_lloyd_iter.restype = rest
                lib.dml_lloyd_max_partials.restype = ctypes.c_int
                row = out["ms"].setdefault(name, {})
                for key, X in cells.items():
                    w = torch.ones(X.shape[0], device=dev)
                    call, _ = lloyd_call(lib, X, w, X[:K8].float())
                    row.setdefault(key, []).append(cuda_ms(call))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def fused_summary(side: dict) -> dict:
    """Each side's fastest run a kernel, whether the change's bf16 K3, K3-p
    and K4 (both cells) beat the parent in every run, and whether each
    side's two launches gave the same bits."""
    summary = {name: {key: min(r["ms"][key] for r in rs)
                      for key in rs[0]["ms"]}
               for name, rs in side.items()}
    claimed = [k for k in side["change"][0]["ms"]
               if k.startswith(("K3", "K4")) and k.endswith("-bf16")]
    summary["faster_every_run"] = {
        k: max(r["ms"][k] for r in side["change"])
        < min(r["ms"][k] for r in side["parent"]) for k in claimed}
    summary["bits_repeat"] = {
        name: all(all(len(set(v)) == 1 for v in r["sha"].values())
                  for r in rs) for name, rs in side.items()}
    summary["bound_ms"] = side["change"][0]["bound_ms"]
    return summary


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


def sass_functions(tree: str, lib: str = "spmv") -> dict:
    """The SASS of every kernel of the newest ``lib`` library built in the
    checkout at ``tree``, by mangled name (the anonymous namespace's hash,
    which nvcc draws from the source, taken out of names and text, and
    each line's runs of blanks made one: ``cuobjdump`` pads the columns to
    the library's longest instruction)."""
    import glob
    import re

    libs = glob.glob(os.path.join(tree, "dask_ml_tpu_torch", "_kernels",
                                  "_build", f"{lib}-*.so"))
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
            funcs[name].append(" ".join(line.split()))
    return {f: "\n".join(body) for f, body in funcs.items()}


def sass_compare(parent: str, change: str, lib: str = "spmv") -> dict:
    """The kernels of both sides' ``lib`` libraries whose SASS is the same,
    those whose SASS differs, and those of one side only."""
    a, b = sass_functions(parent, lib), sass_functions(change, lib)
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
        if args[2:3] == ["--spmv-bf16"]:
            res = spmv_tree(args[1], args[3])
        elif args[2:3] == ["--fused-bf16"]:
            res = fused_tree(args[1])
        elif args[2:3] == ["--kmeans-bf16"]:
            res = kmeans_tree(args[1])
        elif args[2:3] == ["--spmv-small"]:
            res = spmv_small_tree(args[1])
        elif args[2:3] == ["--sketched"]:
            res = sketched_tree(args[1])
        elif args[2:3] == ["--spmv-wide"]:
            res = spmv_wide_tree(args[1])
        elif args[2:3] == ["--glm-wide"]:
            res = glm_wide_tree(args[1])
        else:
            res = one_tree(args[1])
        print("AB " + json.dumps(res), flush=True)
        return 0
    if args[:1] == ["--fused-ablations"]:
        print("ABLATIONS " + json.dumps(fused_ablations()), flush=True)
        print(smi(), flush=True)
        return 0
    if args[:1] == ["--lloyd-ablations"]:
        print("ABLATIONS " + json.dumps(lloyd_ablations()), flush=True)
        print(smi(), flush=True)
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
    for flag, summarize, lib in (("--spmv-small", spmv_small_summary, "spmv"),
                                 ("--spmv-wide", spmv_wide_summary, "spmv"),
                                 ("--glm-wide", glm_wide_summary, "spmv"),
                                 ("--sketched", sketched_summary,
                                  "fused_distance")):
        if flag not in args:
            continue
        runs = run_trees(parent, [flag])
        if runs is None:
            return 1
        side = {"parent": [r for r in runs if r["tree"] == parent],
                "change": [r for r in runs if r["tree"] == HERE]}
        summary = summarize(side)
        summary["sass"] = sass_compare(parent, HERE, lib)
        print("SUMMARY " + json.dumps(summary), flush=True)
        print(smi(), flush=True)
        return 0
    if "--kmeans-bf16" in args:
        runs = run_trees(parent, ["--kmeans-bf16"])
        if runs is None:
            return 1
        side = {"parent": [r for r in runs if r["tree"] == parent],
                "change": [r for r in runs if r["tree"] == HERE]}
        summary = kmeans_summary(side)
        summary["sass"] = {lib: sass_compare(parent, HERE, lib)
                           for lib in ("fused_distance", "lloyd")}
        print("SUMMARY " + json.dumps(summary), flush=True)
        print(smi(), flush=True)
        return 0
    if "--fused-bf16" in args:
        runs = run_trees(parent, ["--fused-bf16"])
        if runs is None:
            return 1
        side = {"parent": [r for r in runs if r["tree"] == parent],
                "change": [r for r in runs if r["tree"] == HERE]}
        summary = fused_summary(side)
        summary["sass"] = sass_compare(parent, HERE, "fused_distance")
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
