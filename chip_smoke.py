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
6. holds the SpMV kernels (K6: ``v`` in a block's or a cluster's shared
   memory, and ``v`` in L2), the pullback kernels (K6's backward: ``g`` in
   shared memory, and device atomics) and the autograd gradient against
   their plain versions bit for bit on integer data: at edge shapes
   (n = 1, ragged n, k in {1, 3, 32, 101, 128}, duplicate columns,
   value-0 padded slots, empty rows, one hot column, every row on one
   column) through every cluster size that fits, and at a d on each side
   of every boundary of ``ops.sparse.dvector_plan`` (one block, clusters
   of 2, 4 and 8, and beyond) through the route the plan picks; on float
   data each pullback route repeats its bits over 5 calls and gives the
   bits of every other route;
7. drives the sparse GLM path at the JAX package's flagship sparse
   problem: ``LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)``
   on ``make_sparse_classification(10_000_000, 100_000, 0.001,
   random_state=42)`` (100 nonzeros a row), then ``score`` on the first
   262,144 rows: K6 must launch in both and its backward in the fit,
   ``n_iter_`` must be 3, the accuracy above 0.55; from each carry of the
   fit, one L-BFGS step through the kernels and one through the plain
   versions must give the same coefficients bit for bit, and the whole
   plain fit must give coefficients within 1e-3 normwise (``index_add_``'s
   float atomics make each plain fit differ from a rerun of itself: the
   spread is printed) and the same labels wherever the coefficient gap
   cannot carry a score across 0; a second kernel-path fit must give the
   same coefficients bit for bit (the pullback adds fixed-point
   integers);
8. holds both forwards and both pullbacks against their plain versions at
   the full container within their rounding bounds (each pullback route
   repeating its bits over 5 calls, both giving the same bits), and
   times each kernel (the pullback also its once-per-container pass over
   the values)
   with CUDA events next to its bound and its plain version (K3 also at
   the k-means|| rounds' mask, K3 and K4 also at the KDD cell's shape and
   next to cuBLAS's product of the score matrix as a yardstick; K1 also at
   the KDD cell's shape, each K1 row beside the two-pass form (K2 and a
   one-hot matmul), which it must beat, and with its counts held to the
   bincount of K2's labels from the same centers; K6 also
   next to cuSPARSE through ``torch.sparse``, on the same slots folded
   onto 1,024 columns, and on 40,000 columns through one block and
   clusters of 2, 4 and 8; one L-BFGS iteration, with a device profile of
   it), and prints the k-means|| phase times of both KMeans cells
   (``models.kmeans.measure_init_phases``); then K6 and K6-b at every
   path's shape (``SPMV_PATH_SHAPES``: the served request, an elastic
   block, the one-hot pipeline, a search fold, an incremental block) on
   integer values, bit for bit with their plain versions and repeating,
   each with its time, its device time (``torch.profiler``), its bound,
   its plain version's time and cuSPARSE's (``torch.mv`` on the CSR
   view, transposed for K6-b), under the ``spmv`` and ``spmv_pullback``
   rows as ``path_shapes`` (the served request's forward gathers from
   L2: ``spmv_l2``, which the serving phase's sparse request launches).

9. drives the solvers of the GLM facades beyond L-BFGS and the
   decompositions, each data set drawn with numpy from the seed:
   consensus ADMM at the JAX GLM bench's shape (10,000,000 × 100 float32,
   ``make_classification``'s recipe): the core ``admm`` as that bench
   calls it at S = 1 and 8, then ``LogisticRegression().fit(X, y)`` with
   every default and ``score`` (accuracy within 0.002 of L-BFGS's), and
   the same facade under solver settings that converge at this cell
   (``n_iter_`` below ``max_iter``, objective within 1e-3 of L-BFGS's);
   softmax fits over the same rows (L-BFGS with K = 10: coefficients
   correlated ≥ 0.99 with the true ones; ADMM on the first 1,000,000 rows
   with K = 4: objective within 1e-3 of L-BFGS's); sparse ADMM on
   ``make_sparse_classification(1e6, 1000, 0.02)`` (K6 and its backward
   must launch; one outer iteration through the kernels within 1e-5
   normwise of the plain one); PCA and TruncatedSVD at the JAX PCA bench's
   shape (500,000 × 1,000, rank 64 plus noise, k = 100), both solvers
   each: the tsqr path must take CholeskyQR2 and give singular values
   within rtol 1e-4 of float64 ones, the randomized ones within 1e-3 over
   the top 64 with components aligned ≥ 0.999, ``transform`` equal to
   ``fit_transform`` within 1e-4 of its scale; tsqr must fall back to
   Householder on a cond-1e6 input with ‖QᵀQ − I‖ < 1e-5.

10. drives the streaming and fault tier (``STREAM``), on the host arrays
   the cells above drew: streamed consensus ADMM at BASELINE config 3's
   published 1e8 × 100 (40 blocks of 2,500,000 rows made on the card one
   at a time, 10 outer iterations; cos(z, w_true) ≥ 0.99, held-out
   accuracy within 0.002 of w_true's, peak memory under three blocks);
   the dense ADMM cell's arrays streamed from the host in 8 blocks
   (prefetch 2 and 0 in turns: the same bits, prefetch 2 not slower; the
   callable mode the same bits; ``admm(n_shards=8)`` within 1e-5; a
   preemption resumed bit for bit; injected read and copy faults under a
   ``RetryPolicy`` the same bits and bytes; ``fit_blocks`` preempted and
   resumed bit for bit; the card's pinned and pageable copy rates and a
   device profile of one epoch); the sparse ADMM container in 4 blocks
   (K6 and its backward; ``admm(n_shards=4)`` and the plain step within
   1e-5; four uninterrupted runs and the resume of a preempted one bit
   for bit);
   streamed PCA at BASELINE config 2's 1e7 × 1,000 (variances within
   5e-3 of the scales², the mean within 1e-2); the PCA cell's arrays
   streamed (moments within 1e-5 of float64, the top 64 components
   aligned ≥ 0.999 with the in-memory PCA, variances within 1e-4, the
   resume bit for bit); ``lloyd_bounded_resumable`` at the KDD shape
   interrupted in its second chunk and resumed (the one-shot loop's
   tuple bit for bit, rows still skipped after the resume, a bumped
   carry version refused); a checkpointed L-BFGS facade interrupted
   after its second save and resumed bit for bit.
11. drives the incremental tier (``INCREMENTAL``): BASELINE config 4 at
   its published size (2,000,000 × 100 by ``make_classification``'s
   recipe, ``Incremental(LogisticRegression(C=100, solver_kwargs=
   {"eta0": 0.5}), block_size=100_000).fit``: 20 blocks; equal bit for
   bit to ``wrappers.fit`` and to a ``partial_fit`` loop, the chain on
   staged X under the sync debug mode "error", held-out accuracy beside
   the batch L-BFGS fit's); the flagship sparse container through
   ``wrappers.fit(LogisticRegression(solver="lbfgs"), X, y,
   block_size=1_000_000)`` (K6 and the pullback once a block, two runs
   bit for bit, staging against step seconds a block, the last step
   within 1e-5 of the plain step with a float64 pullback); softmax
   ``partial_fit`` with K = 10 over 10 blocks; a batched epoch of 8
   members (each within 1e-6 of its own chain); and
   ``ParallelPostFit(...).predict`` rows a second for KMeans (K2) and
   the sparse GLM (K6), labels equal to the estimator's own. The softmax
   chain runs twice, to the same bits.
12. drives the search tier (``SEARCH``): ``metrics.
   pairwise_distances_argmin_min`` through K2 against its plain version;
   BASELINE config 5 at its published size (20,000 × 100, the 500-point
   ``GridSearchCV`` over the port's ``Pipeline`` of ``StandardScaler``,
   ``PCA`` and ``KMeans(init="random", max_iter=10)``, cv 2, 8 jobs:
   every cell through the batched path, K1 on every trajectory step, the
   groups' scores fetched in one copy, six members equal to per-cell
   fits, n_iter exactly and scores within 1e-6, each one's group replayed
   under the sync debug mode "error"; cold and warm seconds, host syncs a
   sweep, a device profile); the JAX package's sparse search (3 C × cv 2
   over 500,000 rows of the sparse cell's container: K6 and its backward,
   coefficients equal to per-cell fits bit for bit, two searches bit for
   bit); and a sparse softmax fit twice, bit for bit.
13. drives the successive-halving tier (``ASHA``): the JAX package's
   successive-halving drill at its own size (200,000 × 20 from
   RandomState(99), the 16-point grid of ``C`` × ``eta0``,
   aggressiveness 4, 16 epochs, 8 blocks,
   ``LogisticRegression(solver="gradient_descent")``): the synchronous
   reference's winner at ≤ 1/5 of its budget, the batched rungs equal to
   one ``partial_fit`` a block a candidate (scores atol 1e-6, the
   winner's coefficients rtol 1e-5), no kernel build after rung 0, no
   host read inside a rung (sync debug mode "error"), a journal cut
   mid-bracket resumed bit for bit; ``HyperbandSearchCV(MiniBatchKMeans(
   n_clusters=8))`` over init and its seed on the blobs (K2 in every
   rung, the winner's ARI ≥ 0.99, two searches bit for bit);
   ``MiniBatchKMeans(n_clusters=8).fit(X).predict(X)`` on the blobs (ARI
   ≥ 0.99, labels equal to the plain version's from the fitted centers,
   two fits bit for bit, K2 at a mini-batch's shape and one Sculley
   update through it against their plain versions, steps a second and
   the busy share of the step loop);
   ``HyperbandSearchCV(LogisticRegression())`` over BASELINE config 4's
   data through the GLM's batched ``partial_fit`` rungs, max_epochs 27 (no
   kernel of the repo runs there: cuBLAS and PyTorch's own kernels; no
   host read inside a rung, host syncs a search); ``cluster.k_means(X,
   8)`` equal to the ``KMeans`` fit bit for bit, ``compute_inertia`` and
   ``evaluate_cost`` within rtol 1e-5 of its inertia, ``init_scalable``
   on K3 and K4, the k-means|| phases; ``GaussianNB`` on config 4's data
   against a float64 fit; ``make_blobs`` and ``make_classification`` at
   1,000,000 × 50 on the card, one seed twice to the same bits.
14. drives the precision tier (``PRECISION``): the bf16 kernels at edge
   shapes (K1–K5 and K6 / K6-b bit for bit against their plain versions
   on integer X with targets, centers and vectors that bf16 rounds; K1–K5
   bit for bit against the f32 kernels on X widened, on integer and on
   float data; ties, an all-masked Y, the near-duplicate-centers pin);
   ``precision-blobs``: the blobs through ``KMeans(init="k-means||")
   .fit(X).predict(X)`` under ``precision="bf16"`` (K3 and K4 in the
   init, K1 in the loop, K2 in predict, all on bf16 X; ARI ≥ 0.99, the
   fit's centers within 1e-2 of the f32 fit's inertia on the f32 data,
   ``inertia_`` the rounded rows' SSE plus the score convention's term);
   ``precision-kdd``: the KDD cell through ``"bounded"`` and ``"full"``
   in bf16 (the bounded loop equal to the two-pass loop bit for bit,
   bounds f32); ``precision-sparse-glm``: the sparse cell's host
   container staged with bf16 values, ``LogisticRegression(solver=
   "lbfgs", max_iter=3)`` (K6 and K6-b in bf16; accuracy above 0.55,
   coefficients within 5e-2 of the f32 fit, a second fit the same bits,
   each step through the kernels equal to the plain step);
   ``precision-dense-glm``: ``LogisticRegression(solver="lbfgs")`` on a
   dense 1e7 × 100 X drawn on the card, f32 and bf16 in turns (no kernel
   of the repo: bf16-in / f32-out GEMMs; coefficients within 5e-2 of
   the f32 fit, each contraction timed beside f32); and
   ``precision-stream``: the host-streamed ADMM and PCA of step 10 on
   the bf16 wire (wire ≤ logical / 1.8, coefficients within 5e-2 and the
   top explained variances within 2e-2 of the f32 runs, preemption and
   resume bit for bit, GB/s of wire and logical bytes); then the bf16
   rows of the kernels line.
15. drives the Nyström estimators (``NYSTROM``): ``spectral``, the JAX
   bench's cell (1,000,000 × 50 blobs, 8 centers, cluster_std 1, seed 0,
   drawn and standardized on the card; ``SpectralClustering(n_clusters=8,
   n_components=200, gamma=None, random_state=0, kmeans_params={"init":
   "random"})`` cold and warm, the Nyström seconds apart from the inner
   KMeans', a device profile of the warm fit; that init often starts two
   centers in one blob, so its ARI is printed, and the gates are held on
   the estimator's default inner init, k-means||: ARI ≥ 0.99, ``predict(X) == labels_``, K1-K4 launched; the
   kernel and plain routes from one embedding and the fitted centers
   label it alike; K1-K4 against their plain versions on the embedding);
   ``kernel-kmeans-xor``, the JAX drill's XOR at 1,000,000 rows
   (``KernelKMeans(n_clusters=2, n_components=128, affinity="polynomial",
   degree=2, coef0=1.0, gamma=0.5, random_state=5)``: ARI ≥ 0.9, the
   dense KMeans control < 0.5, ``predict(X) == labels_``, K1-K4 launched
   and held against their plain versions on the feature rows).
16. drives the preprocessing (``PREPROCESS``): ``sparse-scaler``,
   ``StandardScaler(with_mean=False)`` on the flagship container of step
   7 (the raw container's duplicate columns refused, then summed on the
   card; two fits the same bits, three pullbacks through K6-b, a device
   profile of a fit, ``var_`` within 1e-5 of float64 column variances
   (float64 sums on the card), K6-b's stored counts equal to the plain
   pullback's, the
   transform equal to the plain gather); ``onehot-pipeline``, OneHotEncoder → StandardScaler(with_mean=
   False) → LogisticRegression(solver="lbfgs", max_iter=3) on 1,000,000
   rows of 26 categorical columns of 1,000 categories (K6 and K6-b
   launch, peak memory under 3× the container's bytes); and
   ``dense-scalers``: MinMaxScaler, RobustScaler and QuantileTransformer
   (uniform and normal) on the blobs against float64 references, their
   inverse round trips, and their seconds. The ``kernels`` line gains
   ``launches_nystrom`` and ``launches_preprocess`` on the rows these
   paths launch.

17. drives the serving tier (``SERVING``): KMeans(n_clusters=8) and
   MiniBatchKMeans on the blobs, a sketched KMeans at the KDD width (41
   columns, k 8) on 1,000,000 rows of its recipe, SpectralClustering at
   the spectral cell, LogisticRegression at d = 100 on 1,000,000 rows and
   PCA(n_components=100) at d = 1,000 on 200,000 rows, all on one
   ``ServingLoop(max_batch_rows=2048)``, warmed; then ``serving-identity``
   (requests on each side of every bucket boundary: the K2 families equal
   their direct predict bit for bit, the GEMM runners within 1e-5 of the
   request's largest value, labels equal beyond that margin; every batch
   the K2 runners served held against K2's plain version on the same
   padded batch, up to near-ties, K2-x likewise), ``serving-steady`` (32
   closed-loop clients × 64 requests of the JAX drill's sizes plus 512
   and 2048, deadlines on a quarter: no build and no library load after
   the warmup, no error but deadline sheds; QPS, p50/p99, rows a batch,
   K2 launches, beside the same trace as direct calls), ``serving-fleet``
   (``ServingFleet(n_replicas=2)`` on the card, half the trace, replica
   r1 killed after 20 batches and r0 a straggler: every request resolves
   once, reroutes counted, nothing pending after the drain) and
   ``serving-sparse`` (a sparse request through
   ``ParallelPostFit(serving=loop)`` takes the direct path, K6, held bit
   for bit against ``_spmv_ref`` on integer values). K2, K2-x and K6 are
   timed at the serving shapes (``serving_shape`` on their rows); the
   ``kernels`` line gains ``launches_serving``.

18. drives the wire and the process fleet (``WIRE``) on step 17's fitted
   models: ``wire-crc`` (the CRC-32C engine is the port's C library, equal
   to the plain table on 1 MiB of seeded bytes and on ragged tails of
   0-17 bytes; GB/s of it, of the table and of sha256), ``wire-identity``
   (a ``FleetServer`` in front of a ``ServingLoop(max_batch_rows=2048)``,
   one client over the shared-memory ring and one over TCP, requests on
   each side of every bucket boundary: the K2 families equal their direct
   predict bit for bit over both, the GEMM runners within 1e-5; the served
   K2 batches held against the plain version), ``wire-steady`` (step 17's
   trace in process, over the ring, over TCP and over a ring four times
   as large: QPS, p50/p99, ``wire.bytes{transport=}``,
   ``wire.hash_seconds{algo=}``; no build and no library load after the
   warmup), ``wire-links`` (the process fleet's drill traffic over the
   ring as the router links a replica, and over TCP, in turns) and
   ``proc-fleet``
   (``ProcessFleet(n_replicas=2, device="cuda")``: each child's pid,
   ``cuda:0`` on the card's name, no build, its start phases; a closed
   loop of the K2 families with replica p1 SIGKILLed by its plan: nothing
   dropped or resolved twice, every answer bit for bit, the respawn loads
   nothing after its warmup; a hedging A/B on one seeded trace with p0 a
   straggler: hedged p99 below unhedged; each child counts its launches
   from the end of its warmup, none before the drill, K2 in p0's drill and
   in every child's share of the A/B, the respawned p1's included;
   SIGTERM exits 0; no segment left). The ``kernels`` line gains
   ``launches_wire`` and ``launches_proc`` (the live children's launches
   after their warmups, through the drill and the A/B; the killed
   incarnation's die with it).

19. drives the cross-machine fleet (``MACHINES``), the JAX drill
   ``bench.py`` ``bench_fleet_machines`` on the one card: step 17's K2
   families (KMeans, the sketched KMeans, MiniBatchKMeans,
   SpectralClustering) registered once in the router; two loopback
   "machines" ``m0`` and ``m1`` (isolated workdirs, their own processes);
   ``ProcessFleet(machines=..., n_replicas=2, device="cuda")`` with
   4,096-byte snapshot chunks and 8 clients × 24 requests a burst.
   ``machines-cold`` (each machine's first replica fetches the whole
   registry, ``bytes_fetched == bytes_total``; every child on ``cuda:0``
   under the card's name, no build, no launch before traffic),
   ``machines-burst`` (the ``Autoscaler`` with the JAX drill's SLO calls
   ``scale_up(1)``; the new replica lands on a warm machine and fetches 0
   bytes), ``machines-quiet`` (it drains the extra slot: a tombstone and
   exit 0, no death and no respawn), ``machines-loss``
   (``kill_machine("m1")`` at a third of fresh traffic:
   ``machine_deaths == 1``, no request dropped or resolved twice, the lost
   slot respawns on ``m0`` fetching 0 bytes) and ``machines-steady`` (every
   live child: no build or load after its warmup, K2 launched since it;
   every served answer equal to the direct call bit for bit; K2 and K2-x
   held against their plain versions at the requests' shapes; SIGTERM
   exits 0 everywhere, no shm segment and no temporary file left in the
   machines' workdirs). A ``MACHINES`` line carries each phase's seconds,
   QPS and p99, every fetch's bytes, each child's seconds to ready and the
   autoscaler's actions; the ``kernels`` line gains ``launches_machines``.

20. drives KMeans over a mesh of ranks (``MESH``): the world's rank
   processes start here from a fork server that imported torch and the
   port once (:func:`rank_context`), each joins
   with ``runtime.initialize(backend=..., init_method="file://...")`` on
   ``cuda:0``, draws the blobs of step 4 from seed 0 and an integer-valued
   copy (``np.rint``, weights 1), and stages its block: NCCL at world 1
   (flat); gloo at world 2 (flat, hierarchical 1 × 2: NCCL refuses two
   ranks on one card, which the world-2 ranks show first) and world 4
   (flat, hierarchical 2 × 2, ``("data", "model")`` 2 × 2 with the
   feature-sharded loop, ``"full"`` only). After one warmup fit each
   layout fits ``algorithm="full"`` (K1) and ``"bounded"`` (K5) on both
   copies, then ``predict`` (K2); the init runs K3 and K4. Gates, on
   every rank: on integer data each fit equals this process's
   single-device fit bit for bit in centers, labels, ``n_iter_`` and
   inertia (the model layout within rtol 1e-5, labels equal); on float
   data ARI ≥ 0.99 against it and inertia within rtol 1e-5; K1 ``n_iter_``
   times (full), K5 ``n_iter_`` times (bounded), K3 as often as the
   single-device init (once a round), K4 once, K2 at ``predict``; no build
   or library load after the warmup; the traffic ledger's
   ``kmeans.mstep`` equal to ``collective_bytes(mesh, (k·d + k + 1)·4)``
   (``(k·d + k)·4`` bounded) per axis times ``n_iter_``, 3 (2) calls an
   iteration, the degenerate pod stage 0 bytes. A ``MESH`` line a world
   and layout: fit walls, init seconds, Lloyd ms an iteration at tol 0,
   the ms of one ``hpsum`` of the M-step operands, the ledger's bytes per
   axis and each rank's K1–K5 launches; the ``kernels`` line gains
   ``launches_mesh``.

21. drives the GLMs, tsqr and PCA over a mesh of ranks (``MESHGLM``).
   This process draws the sparse flagship (step 8's container), the ADMM
   bench's 1e7 × 100 and the PCA bench's 500,000 × 1,000 once, saves
   them to a temporary directory, and fits the single-device references
   on the card (the sparse L-BFGS, the core ADMM at ``n_shards`` = each
   world's shard count on the rows padded as the mesh pads them, Newton
   on the first 1e6 ADMM rows, ``PCA(100)`` full and randomized,
   ``TruncatedSVD(100)``). Step 20's worlds of 1 and 4 follow (the model
   layout for Newton and PCA only; world 2's flat layout is world 4's
   too, and was cut for the run's time); each rank maps the files and
   stages only its
   rows. On every rank: ``LogisticRegression(solver="lbfgs",
   max_iter=3)`` on the mapped container (K6 / K6-b on the rank's block,
   one K6 a value and one K6-b a gradient), then K6 and K6-b on an
   integer-valued copy of the block against their plain versions bit for
   bit, and 5 warm evaluations timed; the core ``admm(mesh=)`` for 10
   outer iterations (rtol 1e-5 / atol 1e-6 of the ``n_shards=S``
   reference, the same ``n_iter``); Newton (rtol 1e-4 / atol 1e-5; on the
   model layout X's columns split over ``model``); PCA and TruncatedSVD
   (singular values and variance ratios within rtol 1e-4, the 64 signal
   directions' span within 1e-4). Gates besides: every rank the same
   model bit for bit, the ledger equal to ``collective_bytes`` of each
   op's operand times its calls, no build or load after the warmup, NCCL
   refusing two ranks on one card. A ``MESHGLM`` line a world, layout and
   cell: fit walls, ``n_iter``, ms an evaluation / outer iteration /
   iteration, the ms of one ``hpsum`` of the cell's largest reduced
   operand, the ledger's bytes by op, each rank's K6 / K6-b launches by
   route, the largest gap to the single-device fit; the ``kernels`` line
   gains ``launches_meshglm``.

22. drives the elastic multi-host tier (``ELASTIC``): hosts are real
   processes (:func:`elastic_host`, from the fork server of step 20, rank
   and world from ``DASK_ML_TPU_PROCESS_ID`` /
   ``DASK_ML_TPU_NUM_PROCESSES``) sharing card 0 and a workdir, each
   loading the kernel libraries this process built and mapping the arrays
   it saved. ``elastic-admm-sparse``: ``admm_streamed`` on step 10's
   sparse container (1e6 × 1,000, k 20, the intercept appended) in 8
   blocks shuffled by seed 11, 3 outer iterations at abstol = reltol = 0,
   a 4 s heartbeat timeout: non-elastic and ``ElasticRun(world=1)`` here,
   a preemption mid-shuffled-epoch resumed here, then two processes clean,
   two with rank 1 SIGKILLed right after its first publication of epoch 1
   and two with rank 1 drained by SIGTERM (a checkpointed scan: it leaves
   a tombstone and ``Preempted``). Every surviving rank's (z, x, u) equals
   the non-elastic fit bit for bit; the SIGKILL survivor counts one lost
   host and re-deals 1–7 blocks; the drained rank's tombstone is seen
   before the timeout; the ledger's ``glm.admm.consensus`` equals the
   bytes of the blocks other hosts published. ``elastic-moments``:
   ``streamed_moments`` and ``pca_fit_blocks(elastic=)`` on the PCA cell
   in 8 blocks, world 1 here, two processes clean and with a SIGKILL: the
   same bits in every roster, within rtol 1e-5 normwise of the non-elastic
   moments and of float64, variances within 1e-4 and the top 64
   components aligned ≥ 0.999 with the in-memory PCA (no kernel of the
   repo: a cuBLAS Gram). ``elastic-search``: successive halving over
   ``MiniBatchKMeans(n_clusters=8)`` on the blobs, world 1 here, two
   processes clean and with rank 1 SIGKILLed in rung 0: no candidate
   dropped, ``cv_results_``' scores and ``best_params_`` those of the
   world-1 run. In every process K6 / K6-b (ADMM) or K2 (search) launch,
   are held bit for bit against their plain versions on integer-valued
   data after the libraries load, and nothing builds or loads after that.
   An ``ELASTIC`` line a cell and run (walls, each rank's blocks computed
   / rebalanced / speculated, ``stream.bytes{host=}``, launches by route,
   the detection latency and the recovery overhead against the clean
   pair); the ``kernels`` line gains ``launches_elastic``.
23. **The last ``mesh=`` paths over a world of ranks** (``MESHREST``):
   NCCL 1 and gloo 4 (flat and 2 × 2; a gloo world of 2 ran flat only,
   as world 4 does, and was cut for the run's time), each world started
   once on card 0, run every cell on the flat layout and the datasets,
   kernel k-means and mini-batch cells on the 2 × 2 one:
   ``meshrest-datasets`` (``make_blobs(1e6, 50, 8,
   seed 0, mesh=)``: every rank the world-1 bits, by sha256),
   ``meshrest-spectral`` (the NYSTROM cell: ARI 1.0 against the
   single-device fit, ``predict(X) == labels_``),
   ``meshrest-kernel-kmeans-xor`` (the XOR cell: ARI ≥ 0.9, the ledger's
   ``kernel.gram.colsum`` equal to the formula), ``meshrest-search``
   (config 5's pipeline search at 150 of its 500 members: scores within
   rtol 2e-3 of the single-device sweep, which its PCA stage's spectrum
   sets, and the same ``best_params_``; its KMeans grid on the integer
   copy: test scores bit for bit; every cell in a group),
   ``meshrest-sketched`` (the KDD-shaped sketched fit: inertia ratio to
   the exact bounded fit ≤ 1.05, labels those of the world-1 sketched fit
   but on near ties, ``predict == labels_``), ``meshrest-minibatch``
   (``MiniBatchKMeans(8)`` on the integer copy of the blobs, one epoch:
   the single-device centers, counts and labels bit for bit) and
   ``meshrest-serving`` (``ServingLoop(mesh=)``, the minibatch (K2) and
   sketched (K2-x) models, 8 clients: every answer the direct
   ``predict``'s bit for bit; then a hot swap of the minibatch model,
   every later answer the new version's). On every rank each kernel a
   cell launched, on either layout, is held bit for bit against its plain
   version on an integer copy of that rank's block, and nothing builds or
   loads after the warmup. A ``MESHREST`` line a world, layout and cell; the ``kernels``
   line gains ``launches_meshrest``.

``python3 chip_smoke.py --spmv-only`` runs steps 1, 2, 6 and 8 alone, on a
container of the sparse cell's shape drawn on the card, and K6 / K6-b at
each path's shape (``SPMV_PATH_SHAPES``);
``--glm-pca-only`` runs steps 1, 2 and 9 alone; ``--stream-only`` steps 1,
2 and 10, drawing its own host arrays; ``--incremental-only`` steps 1, 2
and 11; ``--search-only`` steps 1, 2 and 12; ``--asha-only`` steps 1, 2
and 13; ``--precision-only`` steps 1, 2 and 14; ``--nystrom-only``
steps 1, 2 and 15; ``--preprocess-only`` steps 1, 2 and 16;
``--serving-only`` steps 1, 2 and 17, with a ``kernels`` line of K2, K2-x
and K6 at the serving shapes; ``--wire-only`` steps 1, 2 and 18, with a
``kernels`` line of K2 and K2-x; ``--machines-only`` steps 1, 2 and 19,
with a ``kernels`` line of K2 and K2-x; ``--mesh-only`` steps 1, 2 and
20; ``--glm-mesh-only`` steps 1, 2 and 21; ``--elastic-only`` steps 1, 2
and 22; ``--mesh-rest-only`` steps 1, 2 and 23.

Any failed phase raises, so the script exits non-zero and prints no
result. Without a CUDA card it exits non-zero at once. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
# the sparse GLM cell: the JAX bench's flagship sparse problem
# (bench.py bench_sparse), nothing cut
GLM_N, GLM_D, GLM_DENSITY, GLM_ITERS = 10_000_000, 100_000, 0.001, 3
GLM_SCORE_N = 262_144
# kernel fit against plain fit, normwise: the plain pullback's float
# atomics make a 3-iteration fit differ from a rerun of itself by up to 1e-4
# (the intercept's gradient sums 1e7 products into one address)
GLM_FIT_RTOL = 1e-3
# the JAX drill's train-sample accuracy of that fit (SPARSE_r01.json
# lbfgs_fit): a quality to print beside the port's, not a speed
JAX_GLM_ACCURACY = 0.8211
# the JAX GLM bench's ADMM problem (bench.py ADMM, bench_admm): 1e7 x 100
# float32 from make_classification(n_informative=100, scale=2.0), nothing
# cut; the core admm at S = 1 and 8 for 10 outer iterations
ADMM_N, ADMM_D, ADMM_OUTER, ADMM_SHARDS = 10_000_000, 100, 10, (1, 8)
# the solver settings under which the logistic ADMM fit converges at that
# cell: there the mean loss's curvature along the coefficients is ~1e-3,
# so at the default rho = 1 a consensus step shrinks the error by only
# ~1/(1 + 1e-3) and 100 iterations stop far from the optimum
ADMM_CONVERGING = {"rho": 0.003, "abstol": 1e-6, "reltol": 1e-4}
# the facade's ADMM fit against L-BFGS at that cell: objective (relative)
# and training accuracy
ADMM_OBJ_RTOL, ADMM_ACC_TOL = 1e-3, 0.002
# softmax labels over the same X: K classes from N(0, MN_SCALE²) true
# coefficients; multinomial ADMM on the first MN_ADMM_N rows with K = 4
# (each Newton step's Hessian costs n·d²·K² FMAs: the depth is cut there)
MN_K, MN_SCALE, MN_CORR = 10, 0.1, 0.99
MN_ADMM_N, MN_ADMM_K = 1_000_000, 4
# the sparse ADMM path: make_sparse_classification(1e6, 1000, 0.02, 0)
# (k = 20, d = 1001 with the intercept) through LogisticRegression(
# solver="admm"), depth cut to 3 outer iterations (each takes ~13 Newton
# steps whose Hessian is a scatter of nnz·k products)
SPADMM_N, SPADMM_D, SPADMM_DENSITY, SPADMM_ITERS = 1_000_000, 1_000, 0.02, 3
SPADMM_RTOL = 1e-5
# the JAX PCA bench's problem (bench.py PCA, bench_pca): 500,000 x 1,000
# float32, a rank-64 signal plus 0.1 noise, k = 100, nothing cut
PCA_N, PCA_D, PCA_RANK, PCA_K = 500_000, 1_000, 64, 100
PCA_CHECK_ROWS = 262_144
# K6 edge shapes (n, k, d): n = 1, a ragged n, k = 1 and the intercept's
# odd k = 101, the cell's d = 100,001 and a d = 7 where every column is hot,
# a k beyond the shared-memory kernels' tile and a d beyond every cluster
SPMV_EDGE_SHAPES = [(1, 1, 7), (1, 101, 100_001), (1_000_003, 101, 100_001),
                    (1_000_003, 1, 7), (5000, 1, 7), (4097, 3, 7),
                    (777, 17, 100_001), (2048, 64, 7), (33, 101, 7),
                    (100_000, 2, 100_001), (40_001, 32, 30_011),
                    (9_999, 128, 250_007), (301, 1030, 5_003),
                    (1_001, 512, 9_001), (1_001, 513, 9_001),
                    (70_001, 101, 500_009)]
# widths of the boundary shapes, and the slots a boundary container holds
# (enough for dvector_plan to fill shared memory at every cluster size)
SPMV_BOUNDARY_KS = (1, 3, 32, 101, 128)
SPMV_BOUNDARY_SLOTS = 8_000_000
# the one-block against cluster comparison: the cell's slots folded onto
# this many columns, which fit one block's shared memory
FOLD_D = 40_000
# wider models for the K6-only run: d beyond a cluster of 2 and of 4
# (what the plan's cluster limits rest on)
SPMV_WIDE_DS = (150_001, 300_001)
# the k-means|| shapes K3 and K4 run at (k = 8, oversampling 2, so l = 16):
# the rounds' candidate buffer of cap slots, of which a round usually fills
# the first l, and the weights' buffer of max_cand slots
ROUND_CAP, ROUND_COUNT, WEIGHT_CAND = 80, 16, 329
# the streaming tier (STREAM): BASELINE configs 3 and 2 at their published
# sizes, 40 row blocks of 1 GB made on the card one at a time
# (bench.py bench_admm_blueprint / bench_pca_blueprint), nothing cut
BP_ADMM_N, BP_ADMM_D, BP_ADMM_BLOCKS, BP_ADMM_OUTER = 100_000_000, 100, 40, 10
BP_PCA_N, BP_PCA_D, BP_PCA_BLOCKS, BP_PCA_K = 10_000_000, 1_000, 40, 100
# host-resident streams: the dense ADMM and PCA cells' arrays in 8 blocks
# (the JAX bench sizes these rows to its link; fixed here), 3 outer
# iterations; the sparse ADMM cell's container in 4 blocks
HOST_BLOCKS, HOST_OUTER, SPSTREAM_BLOCKS = 8, 3, 4
# the resumable bounded loop at the KDD shape: tol 0, 20 iterations in
# chunks of 7; the checkpointed L-BFGS facade: 6 iterations in chunks of 2
RESUME_ITERS, RESUME_CHUNK = 20, 7
CKPT_LBFGS_ITERS, CKPT_LBFGS_EVERY = 6, 2
# gates: the blueprint fit's direction and held-out accuracy, the streamed
# PCA's variances and mean, host-streamed moments against float64
BP_COS, BP_ACC_TOL, BP_EV_RTOL, BP_MEAN_TOL = 0.99, 0.002, 5e-3, 1e-2
STREAM_RTOL, MOMENT_RTOL, EV_RTOL, ALIGN = 1e-5, 1e-5, 1e-4, 0.999
# calls of the pullback on one float input that must give the same bits
PULLBACK_REPEATS = 5
# the incremental tier (INCREMENTAL): BASELINE config 4 at its published
# size (bench.py INC, bench_incremental: 2e6 x 100 in blocks of 100,000,
# lambda = 0.01, eta0 = 0.5), nothing cut, and INC_HOLDOUT rows of the same
# model held out; the sparse chain: the flagship container in blocks of
# 1e6 rows; softmax streaming over the first 1e6 rows with K = 10; a
# batched epoch of 8 members
INC_N, INC_D, INC_BLOCK, INC_HOLDOUT = 2_000_000, 100, 100_000, 200_000
INC_C, INC_ETA0 = 100.0, 0.5
INC_SPARSE_BLOCK, INC_RTOL = 1_000_000, 1e-5
INC_MN_N, INC_MN_K = 1_000_000, 10
INC_MEMBERS, BATCHED_RTOL = 8, 1e-6
# the search tier (SEARCH): BASELINE config 5 at its published size
# (bench.py GRID :146, bench_gridsearch :801), nothing cut: 20,000 x 100,
# X = randn @ diag(linspace(2, 0.5, 100)) from RandomState(0), the
# StandardScaler -> PCA -> KMeans(init="random", max_iter=10) grid of
# 5 x 10 x 10 points, cv 2, n_jobs 8; SEARCH_SAMPLED members held to
# per-cell fits of the pipeline; the JAX bench's sparse search
# (bench.py :5466-5478) over the first SEARCH_SPARSE_N rows of the sparse
# GLM cell's container; a sparse softmax fit on SOFTMAX_N of its rows with
# SOFTMAX_K classes, twice
SEARCH_N, SEARCH_D, SEARCH_CV, SEARCH_JOBS = 20_000, 100, 2, 8
SEARCH_GRID = {"pca__n_components": [5, 10, 15, 20, 25],
               "km__n_clusters": list(range(2, 12)),
               "km__tol": list(np.logspace(-6, -2, 10))}
SEARCH_MAX_ITER, SEARCH_SAMPLED, SEARCH_RTOL = 10, 6, 1e-6
SEARCH_SPARSE_N, SEARCH_CS = 500_000, [0.1, 1.0, 10.0]
SOFTMAX_N, SOFTMAX_K = 500_000, 4
# the successive-halving tier (ASHA): the JAX package's drill at its own
# size (bench.py _ASHA, _asha_problem, _asha_search :1565-1611), nothing
# cut: 200,000 x 20 from RandomState(99)'s KDD-character recipe, the
# 16-point grid, aggressiveness 4, 16 epochs, 8 blocks; its journal cut
# after ASHA_RESUME_AT of its 21 records (mid rung 1) and resumed
ASHA_N, ASHA_D, ASHA_BLOCKS, ASHA_EPOCHS, ASHA_ETA = 200_000, 20, 8, 16, 4
ASHA_GRID = {"C": [1e-3, 1e-2, 1e-1, 1.0],
             "solver_kwargs": [{"eta0": 0.05}, {"eta0": 0.2},
                               {"eta0": 0.5}, {"eta0": 1.0}]}
ASHA_SCORE_ATOL, ASHA_COEF_RTOL, ASHA_RESUME_AT = 1e-6, 1e-5, 18
# Hyperband over MiniBatchKMeans(n_clusters=8) on the blobs (init and the
# init's seed searched: settings partial_fit reads, 10 distinct candidates;
# batch_size is not one, since a partial_fit takes its whole block as the
# batch; 8 blocks of 100,000 rows, max_epochs 9, aggressiveness 3);
# Hyperband over BASELINE config 4's data (the INCREMENTAL cell's 2e6 x 100)
# through the GLM's batched partial_fit rungs, max_epochs 27, 16 blocks of
# 100,000 rows (config 4's block size)
HB_MB_GRID = {"init": ["k-means||", "random"],
              "random_state": [SEED + i for i in range(5)]}
HB_MB_EPOCHS, HB_MB_ETA, HB_MB_BLOCKS = 9, 3, 8
HB_GLM_GRID = {"C": [1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0],
               "solver_kwargs": [{"eta0": e}
                                 for e in (0.05, 0.1, 0.2, 0.5, 1.0)]}
HB_GLM_EPOCHS, HB_GLM_ETA, HB_GLM_BLOCKS = 27, 3, 16
# MiniBatchKMeans' own fit: the steps profiled for the busy share
MB_PROFILED_STEPS = 2_000
# GaussianNB on config 4's data against a float64 fit: moments within
# NB_RTOL (plus NB_RTOL of each feature's standard deviation), labels
# equal wherever the float64 log-likelihoods of the two classes differ by
# more than NB_MARGIN
NB_RTOL, NB_MARGIN = 1e-4, 1e-3
# the dense generators at the blobs' size
GEN_N, GEN_D = 1_000_000, 50
# the JAX bench's spectral cell (bench_spectral): 1e6 × 50 blobs, 8
# centers, 200 landmarks
SPEC_N, SPEC_D, SPEC_K, SPEC_L = 1_000_000, 50, 8, 200
# the JAX drill's XOR kernel k-means at its documented row knob SKETCH_KN
XOR_N = 1_000_000
# the one-hot pipeline: rows, categorical columns (Criteo's 26), categories
ONEHOT_N, ONEHOT_COLS, ONEHOT_CATS = 1_000_000, 26, 1_000
# the scalers against float64: var_ (sparse) and each dense transform and
# round trip
SCALER_RTOL = 1e-5
# QuantileTransformer's normal output: the grid steps of u near 1 (2^-24
# each, normal_ppf_step / normal_round_trip_step) allowed beyond
# SCALER_RTOL, forward and round trip. On the blobs the H100 used 0.391
# and 1.084 (seed 0): the gates leave 5.1x and 2.8x of headroom
NORMAL_PPF_STEPS, NORMAL_ROUND_TRIP_STEPS = 2, 3
# H100 SXM data sheet: HBM3 bandwidth, the f32 rate outside the tensor
# cores, and the dense bf16 tensor-core rate (products of two bf16
# operands accumulated in f32, without sparsity)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
# where the TPU kernel each CUDA kernel replaces is defined
REPLACES = {
    "lloyd_iter": "dask_ml_tpu/models/kmeans.py:186",
    "fused_argmin_min": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_rowwise_min": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_argmin_weight": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_argmin_min2": "dask_ml_tpu/ops/fused_distance.py:378",
    "fused_argmin_min_sketched": "dask_ml_tpu/ops/fused_distance.py:378",
    "spmv": "dask_ml_tpu/ops/sparse.py:512",
    "spmv_l2": "dask_ml_tpu/ops/sparse.py:512",
    # the custom VJP's backward, left to XLA's segment_sum there
    "spmv_pullback": "dask_ml_tpu/ops/sparse.py:560",
    "spmv_pullback_l2": "dask_ml_tpu/ops/sparse.py:560",
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
    "glm-sparse-fit": ("spmv", "spmv_pullback"),
    "glm-sparse-score": ("spmv",),
    "glm-sparse-admm": ("spmv", "spmv_pullback"),
    "admm-streamed-sparse": ("spmv", "spmv_pullback"),
    "lloyd-bounded-resumable": ("fused_argmin_min2", "fused_argmin_min"),
    "incremental-sparse": ("spmv", "spmv_pullback"),
    "parallel-post-fit-kmeans": ("fused_argmin_min",),
    "parallel-post-fit-glm": ("spmv",),
    "minibatch": ("fused_argmin_min", "fused_rowwise_min",
                  "fused_argmin_weight"),
    "minibatch-hyperband": ("fused_argmin_min", "fused_rowwise_min",
                            "fused_argmin_weight"),
    "k-means-fn": ("lloyd_iter", "fused_argmin_min", "fused_rowwise_min",
                   "fused_argmin_weight"),
    "init-scalable": ("fused_rowwise_min", "fused_argmin_weight"),
    "precision-blobs": ("lloyd_iter_bf16", "fused_argmin_min_bf16",
                        "fused_rowwise_min_bf16", "fused_argmin_weight_bf16"),
    "precision-kdd-bounded": ("fused_argmin_min2_bf16",
                              "fused_argmin_min_bf16",
                              "fused_rowwise_min_bf16",
                              "fused_argmin_weight_bf16"),
    "precision-kdd-full": ("lloyd_iter_bf16", "fused_argmin_min_bf16",
                           "fused_rowwise_min_bf16",
                           "fused_argmin_weight_bf16"),
    "precision-sparse-glm": ("spmv_bf16", "spmv_pullback_bf16"),
    "spectral-random": ("lloyd_iter", "fused_argmin_min"),
    "spectral": ("lloyd_iter", "fused_argmin_min", "fused_rowwise_min",
                 "fused_argmin_weight"),
    "spectral-predict": ("fused_argmin_min",),
    "kernel-kmeans-xor": ("lloyd_iter", "fused_argmin_min",
                          "fused_rowwise_min", "fused_argmin_weight"),
    "kernel-kmeans-predict": ("fused_argmin_min",),
    "sparse-scaler-fit": ("spmv_pullback",),
    "onehot-pipeline": ("spmv", "spmv_pullback"),
    "serving-identity": ("fused_argmin_min", "fused_argmin_min_sketched"),
    "serving-steady": ("fused_argmin_min", "fused_argmin_min_sketched"),
    "serving-fleet": ("fused_argmin_min", "fused_argmin_min_sketched"),
    "serving-sparse": ("spmv_l2",),
    "wire-identity": ("fused_argmin_min", "fused_argmin_min_sketched"),
    "wire-steady": ("fused_argmin_min", "fused_argmin_min_sketched"),
    "wire-links": ("fused_argmin_min", "fused_argmin_min_sketched"),
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
    "spmv": "dask_ml_tpu_torch/_kernels/csrc/spmv.cu",
    "spmv_l2": "dask_ml_tpu_torch/_kernels/csrc/spmv.cu",
    "spmv_pullback": "dask_ml_tpu_torch/_kernels/csrc/spmv.cu",
    "spmv_pullback_l2": "dask_ml_tpu_torch/_kernels/csrc/spmv.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


#: host data sets already drawn, by name: the STREAM phase streams the
#: arrays the earlier cells drew instead of drawing them again
_DRAWN: dict = {}


def drawn(name: str, make):
    """``make()``'s result, drawn once per run and kept under ``name``
    (callers read it and never write to it); the draw's seconds logged."""
    if name not in _DRAWN:
        t0 = time.perf_counter()
        _DRAWN[name] = make()
        log(f"DRAWN {name} in {time.perf_counter() - t0:.1f} s")
    return _DRAWN[name]


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


def expect_repeats(what: str, call, first) -> None:
    """``call()`` gives ``first``'s bits PULLBACK_REPEATS - 1 times more."""
    import torch

    for i in range(PULLBACK_REPEATS - 1):
        expect(torch.equal(call(), first),
               f"{what}: call {i + 2} does not repeat the bits of the first")


def near_tie_ok(X, Y, mask, got, want, scale_eps=1e-5, slack=None):
    """Rows whose argmins differ must be near-ties: the plain scores of the
    two picks agree within 1e-5 of the operands' magnitude
    (|x|² + max|y|²) — the f32 cancellation floor of |y|² − 2x·y — plus
    ``slack(rows)`` where given (a row's further reach, a function of the
    mismatched rows)."""
    from dask_ml_tpu_torch.ops.fused_distance import _row_sumsq, _scores_ref

    bad = (got != want).nonzero().squeeze(1)
    if bad.numel() == 0:
        return 0
    s = _scores_ref(X[bad], Y, mask)
    gs = s.gather(1, got[bad].long()[:, None])[:, 0]
    ws = s.gather(1, want[bad].long()[:, None])[:, 0]
    reach = scale_eps * (_row_sumsq(X[bad]) + _row_sumsq(Y).max())
    if slack is not None:
        reach = reach + slack(X[bad])
    expect(bool(((gs - ws).abs() <= reach).all()),
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
    """K1 against its plain version: bit for bit on integer data, else
    the same counts and sums and inertia within rtol 1e-5; it repeats its
    own bits, and with unit weights its counts are the bincount of K2's
    labels from the same centers (the same score loop and |c|²)."""
    import torch

    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.ops import fused_distance as fd

    ks, kc, ki = core._lloyd_stats_cuda(X, w, C)
    labels, _ = fd.fused_argmin_min(X, C, kernel="cuda")
    unit = bool((w == 1).all())
    if unit:
        expect(torch.equal(kc, torch.bincount(
            labels.long(), minlength=C.shape[0]).to(kc.dtype)),
            f"{tag} lloyd counts != the bincount of K2's labels")
    rs, rc, ri = core._lloyd_stats_ref(X, w, C)
    ks2, kc2, ki2 = core._lloyd_stats_cuda(X, w, C)
    expect(torch.equal(ks, ks2) and torch.equal(kc, kc2)
           and torch.equal(ki, ki2), f"{tag} lloyd not reproducible")
    if exact:
        expect(torch.equal(ks, rs) and torch.equal(kc, rc)
               and torch.equal(ki, ri), f"{tag} lloyd: not bit-identical")
        return 0.0
    if unit:
        # K1's labels are K2's (checked above); the plain version's scores
        # round otherwise, so its labels may differ from K2's only on
        # near-ties, each moving one unit between two counts
        c2 = (C * C).sum(dim=1)
        Cc = C.to(X.dtype).to(torch.float32)
        plain_labels = (c2[:, None] - 2.0 * (Cc @ X.to(torch.float32).T)
                        ).argmin(dim=0)
        n_ties = near_tie_ok(X, C, None, labels,
                             plain_labels.to(labels.dtype))
        same = float((kc - rc).abs().sum()) <= 2 * n_ties
    else:
        same = torch.equal(kc, rc)
    expect(same, f"{tag} lloyd counts differ")
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
    # the k-means|| rounds' prefix masks over an 80-slot buffer, a lone
    # valid target in the last tile, and ties that straddle two threads'
    # targets and a target tile boundary (the lowest index wins)
    X, w = ints((3001, 50)), ints((3001,), 0, 5)
    Y = ints((ROUND_CAP, 50))
    iota = torch.arange(ROUND_CAP, device=dev)
    for count in (0, 1, 15, 16, 17, 31, 32, 33, 79, 80):
        merge(check_fused(f"m80 first {count}", X, Y, iota < count, w))
    Y = ints((WEIGHT_CAND, 50))
    lone = torch.zeros(WEIGHT_CAND, dtype=torch.bool, device=dev)
    lone[-1] = True
    merge(check_fused("m329 lone valid target", X, Y, lone, w))
    merge(check_min2_sketched("m329 lone valid target", X, Y, lone))
    Y = ints((ROUND_CAP, 50))
    Y[[7, 8, 31, 32, 33, 63, 64, 79]] = Y[5].clone()
    X = torch.cat([Y[5:6].expand(200, 50), ints((801, 50))])
    merge(check_fused("ties across tiles", X, Y, None, w[:1001]))
    merge(check_min2_sketched("ties across tiles", X, Y))
    a2, b2, s2 = fd.fused_argmin_min2(X, Y, iota != 5, kernel="cuda")
    expect(bool((a2[:200] == 7).all() and torch.equal(b2[:200], s2[:200])),
           "ties across tiles: not the lowest index, or the tie is not the "
           "second-best")
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
    # the Lloyd kernel: ragged n, weights, empty clusters, k beyond 8;
    # d % 4 != 0 (a 4-byte tail), 16-byte row reads (d % 4 == 0), k = 8
    # and 9 (the register variant's edge), its widest d and the next, the
    # largest d the kernel's first design took at k = 8, and X not 16-byte
    # aligned
    from dask_ml_tpu_torch.models import kmeans as core

    for n, k, d, off in [(1, 1, 1, 0), (1000, 8, 50, 0), (10_000, 13, 7, 0),
                         (70_001, 3, 2, 0), (3001, 8, 41, 0),
                         (20_001, 8, 52, 0), (1000, 8, 64, 0),
                         (4099, 8, 50, 0), (4099, 9, 50, 0),
                         (2000, 8, 110, 0), (2000, 8, 111, 0),
                         (257, 8, 397, 0), (3001, 8, 52, 1)]:
        X = ints((n * d + off,), -4, 4)[off:].view(n, d)
        w = ints((n,), 0, 3)
        C = ints((k, d), -4, 4)
        e = check_lloyd(f"lloyd n{n} k{k} d{d} offset {off}", X, w, C,
                        exact=True)
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


def ell_ints(rng, n, k, d, dev, lo=-8, hi=8):
    """An integer-valued container with every awkward slot: duplicate
    columns in a row (they sum), one hot column shared by every row, and
    value-0 padded slots at column 0."""
    import torch

    from dask_ml_tpu_torch.ops import sparse as sps

    cols = rng.integers(0, d, (n, k)).astype(np.int32)
    vals = rng.integers(lo, hi, (n, k)).astype(np.float32)
    if k >= 2:
        cols[:, 1] = cols[:, 0]
    if k >= 3:
        cols[:, 2] = d - 1
    if k >= 4:
        cols[:, -1] = 0
        vals[:, -1] = 0.0
    return sps.SparseRows(torch.as_tensor(vals, device=dev),
                          torch.as_tensor(cols, device=dev), d)


def fitting_routes(k, d, pullback):
    """Every route the wrappers can be told to take for this shape: L2
    (cluster 0) and each cluster size the direction is built for whose
    shared memory holds the d-vector."""
    from dask_ml_tpu_torch.ops import sparse as sps

    return [0] + [c for c in sps._PLAN_CLUSTERS[pullback]
                  if sps._fits(k, d, c, pullback)]


def check_spmv_int(tag, A, v, r, routes_f, routes_b):
    """Both directions of K6 on an integer-valued container, through the
    named routes (a cluster size; None: the plan's), bit for
    bit against the plain versions; the forward twice for its own bits."""
    import torch

    from dask_ml_tpu_torch.ops import sparse as sps

    want = sps._spmv_ref(A.values, A.cols, v) if routes_f else None
    for c in routes_f:
        got = sps._spmv_cuda(A.values, A.cols, v, cluster=c)
        expect(torch.equal(got, want),
               f"K6 {tag} cluster {c}: not bit-identical to the plain "
               f"version")
        expect(torch.equal(got, sps._spmv_cuda(A.values, A.cols, v,
                                               cluster=c)),
               f"K6 {tag} cluster {c}: not reproducible")
    want = (sps._pullback_ref(A.values, A.cols, r, A.d) if routes_b
            else None)
    for c in routes_b:
        got = sps._pullback_cuda(A.values, A.cols, r, A.d, cluster=c)
        expect(torch.equal(got, want),
               f"K6 pullback {tag} cluster {c}: not bit-identical to the "
               f"plain version")
    if routes_b:
        # float data: each route repeats its bits, and every route gives
        # the bits of the first
        vf = A.values * 0.3 + 0.01 * (A.values != 0)
        rf = r * 0.7071 + 0.1234
        first = sps._pullback_cuda(vf, A.cols, rf, A.d, cluster=routes_b[0])
        for c in routes_b:
            got = sps._pullback_cuda(vf, A.cols, rf, A.d, cluster=c)
            expect(torch.equal(got, first),
                   f"K6 pullback {tag} cluster {c}: float data, not the "
                   f"bits of cluster {routes_b[0]}")
            expect_repeats(f"K6 pullback {tag} cluster {c}, float data",
                           lambda c=c: sps._pullback_cuda(
                               vf, A.cols, rf, A.d, cluster=c), got)


def spmv_edge_cases(dev):
    """K6's forward and pullback kernels against their plain versions, bit
    for bit on integer data (every product and partial sum is an exact
    integer, so every order of summation gives the same bits), the
    forward also run to run: the edge shapes through every route that
    fits, the plan's boundaries through the route the plan picks; then
    the autograd gradient through the kernels against the plain
    version's."""
    import torch

    from dask_ml_tpu_torch import _kernels
    from dask_ml_tpu_torch.ops import sparse as sps

    rng = np.random.default_rng(3)

    def vec(m, lo=-4, hi=4):
        return torch.as_tensor(rng.integers(lo, hi, m), dtype=torch.float32,
                               device=dev)

    for n, k, d in SPMV_EDGE_SHAPES:
        A = ell_ints(rng, n, k, d, dev)
        check_spmv_int(f"n{n} k{k} d{d}", A, vec(d), vec(n),
                       fitting_routes(k, d, False),
                       fitting_routes(k, d, True))
    # rows of zeros (value-0 slots on column 0), and every row on one column
    for n, k, d in [(3001, 5, 777), (2049, 101, 100_001)]:
        A = ell_ints(rng, n, k, d, dev)
        A.values[::3] = 0.0
        A.cols[::3] = 0
        check_spmv_int(f"empty rows n{n} k{k} d{d}", A, vec(d), vec(n),
                       fitting_routes(k, d, False),
                       fitting_routes(k, d, True))
        A.cols[:] = d // 2
        check_spmv_int(f"one column n{n} k{k} d{d}", A, vec(d), vec(n),
                       fitting_routes(k, d, False),
                       fitting_routes(k, d, True))
    # a container that starts 4 bytes off a 16-byte boundary: the kernels
    # read it slot by slot
    A = ell_ints(rng, 5001, 101, 60_001, dev)
    off = [torch.empty(A.values.numel() + 1, dtype=t.dtype, device=dev)[1:]
           .view(A.values.shape).copy_(t) for t in (A.values, A.cols)]
    expect(off[0].data_ptr() % 16 == 4, "the offset container is aligned")
    check_spmv_int("unaligned", sps.SparseRows(off[0], off[1], A.d),
                   vec(A.d), vec(5001), fitting_routes(101, A.d, False),
                   fitting_routes(101, A.d, True))
    # a d on each side of every boundary of the plan, drawn on the card
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    n_boundary = 0
    for k in SPMV_BOUNDARY_KS:
        n = -(-SPMV_BOUNDARY_SLOTS // k) + 3
        for pull in (False, True):
            besides = 0 if pull else 8 * sps._GROUPS * sps._tile_rows(k) * k
            picks = sps._PLAN_CLUSTERS[pull]
            for i, c in enumerate(picks):
                fits = c * ((sps._SMEM_BLOCK_BYTES - besides) // 4)
                beyond = (picks + (0,))[i + 1]
                for d, route in ((fits, c), (fits + 1, beyond)):
                    expect(sps.dvector_plan(n, k, d, pullback=pull) == route,
                           f"plan(n{n}, k{k}, d{d}, pullback={pull}) is "
                           f"not {route}")
                    cols = torch.randint(0, d, (n, k), dtype=torch.int32,
                                         generator=g, device=dev)
                    if k > 1:  # a hot column, as the intercept is
                        cols[:, -1] = d - 1
                    # |product| <= 8, 2 on average: the hot column's sums
                    # stay below 2^24 in whatever order they are added
                    vals = torch.randint(-4, 4, (n, k), generator=g,
                                         device=dev).float()
                    A = sps.SparseRows(vals, cols, d)
                    x = torch.randint(-2, 2, (n if pull else d,),
                                      generator=g, device=dev).float()
                    _kernels.reset_launches()
                    check_spmv_int(f"boundary n{n} k{k} d{d}", A,
                                   None if pull else x, x if pull else None,
                                   [] if pull else [None],
                                   [None] if pull else [])
                    name = ("spmv_pullback" if pull else "spmv") + (
                        "" if route else "_l2")
                    expect(_kernels.launches[name] >= 1,
                           f"boundary n{n} k{k} d{d}: {name} did not run: "
                           f"{_kernels.launches}")
                    n_boundary += 1
    log(f"K6 boundaries: {n_boundary} shapes, each through the plan's route")
    for n, k, d in [(64, 101, 7), (257, 101, 100_001), (1000, 1, 50),
                    (3001, 5, 100_001), (200_003, 101, 100_001)]:
        A = ell_ints(rng, n, k, d, dev, -1, 2)
        v0 = vec(d, -1, 2)
        grads = []
        for kernel in ("cuda", "torch"):
            vals = A.values.clone().requires_grad_(True)
            v = v0.clone().requires_grad_(True)
            out = sps.matvec(sps.SparseRows(vals, A.cols, d), v,
                             kernel=kernel)
            (out ** 2).sum().backward()
            grads.append((v.grad, vals.grad))
        expect(torch.equal(grads[0][0], grads[1][0])
               and torch.equal(grads[0][1], grads[1][1]),
               f"K6 gradient n{n} k{k} d{d}: kernel and plain differ")
    return 0.0


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


def bound(nbytes: float, flops: float, operand=None):
    """The least time in ms for ``nbytes`` of traffic and ``flops``
    operations on ``operand``-typed inputs: products of bf16 operands at
    the bf16 tensor-core rate, anything else at the f32 rate."""
    peak = (PEAK_BF16_FLOP_PER_S if str(operand) == "torch.bfloat16"
            else PEAK_F32_FLOP_PER_S)
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def init_phase_seconds(X, w):
    """The k-means|| phases at the main path's shape through
    ``models.kmeans.measure_init_phases``: each phase alone, warmed once
    and timed with a device sync after it (the fit runs them back to
    back)."""
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.utils.validation import check_random_state

    return core.measure_init_phases(
        X, w, K, check_random_state(SEED, device=X.device),
        oversampling_factor=2.0)


def fused_call(fdl, stream, X, Y, epi, w=None, gneed=None, x2=None,
               mask=None):
    """A closure that launches ``dml_fused_distance`` once on buffers
    allocated here (the closure keeps them alive); every target valid
    unless ``mask`` says otherwise."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import fused_distance as fd

    dev = X.device
    n, d = X.shape
    m = Y.shape[0]
    y2 = fd._row_sumsq(Y).contiguous()
    # a bf16 X takes the targets rounded to bf16 (held in f32), |y|² from
    # the originals, as the wrapper hands them over
    Y = Y.to(X.dtype).to(torch.float32).contiguous()
    maskf = (torch.ones(m, device=dev) if mask is None
             else mask.to(torch.float32).contiguous())
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
            epi, X.data_ptr(), int(X.dtype == torch.bfloat16), Y.data_ptr(),
            y2.data_ptr(), maskf.data_ptr(),
            ptr(gneed), fd._FUSED_BLK, ptr(x2), ptr(w), n, m, d,
            am.data_ptr(), mn.data_ptr(), mn2.data_ptr(), part.data_ptr(),
            cw.data_ptr(), stream), "timing")

    return call


def score_kernel_rows(fdl, stream, X, w, pick):
    """K3 at the k-means|| rounds' shape (every slot of the candidate
    buffer valid, and the first ``ROUND_COUNT`` valid as a round leaves
    them) and K4 at the weights' shape, each timed with CUDA events beside
    its plain version and its bound, and beside cuBLAS's f32 product of
    the score matrix alone (``gemm_ms``: a yardstick, since no single call
    computes either function, and the port never calls it)."""
    import torch

    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.ops import fused_distance as fd

    n, d = X.shape
    xb = X.element_size()
    cfg = core._init_scalable_config(n, K, 2.0, None)
    expect(cfg["cap"] == ROUND_CAP and cfg["max_cand"] == WEIGHT_CAND,
           f"the k-means|| buffers are not the timed shapes: {cfg}")
    rows = []
    for name, epi, m in (("fused_rowwise_min", 0, ROUND_CAP),
                         ("fused_argmin_weight", 2, WEIGHT_CAND)):
        Y = X[pick[:m]].contiguous()
        if epi == 0:
            plain = lambda mask: fd._min_ref(X, Y, mask)  # noqa: E731
            nbytes = xb * n * d + 4 * (m * d + n)
        else:
            plain = lambda mask: fd._argmin_weight_ref(  # noqa: E731
                X, w, Y, mask)
            nbytes = xb * n * d + 4 * (n + m * d + n + m)
        b, by = bound(nbytes, 2 * n * m * d, X.dtype)
        row = dict(name=name,
                   ms=cuda_ms(fused_call(fdl, stream, X, Y, epi,
                                         w=w if epi == 2 else None)),
                   plain_ms=cuda_ms(lambda: plain(None), iters=5, warmup=1),
                   bound_ms=b, bound_by=by,
                   gemm_ms=cuda_ms(lambda: torch.mm(X, Y.to(X.dtype).T),
                                   iters=10, warmup=2),
                   shape={"n": n, "m": m, "d": d})
        if epi == 0:
            prefix = torch.arange(m, device=X.device) < ROUND_COUNT
            b, by = bound(nbytes, 2 * n * ROUND_COUNT * d, X.dtype)
            row["path_mask"] = dict(
                valid=ROUND_COUNT,
                ms=cuda_ms(fused_call(fdl, stream, X, Y, 0, mask=prefix)),
                plain_ms=cuda_ms(lambda: plain(prefix), iters=5, warmup=1),
                bound_ms=b, bound_by=by)
        rows.append(row)
    return rows


def time_kernels(X, w):
    """Each kernel's own launch (the C entry point, buffers allocated
    once) timed with CUDA events at the main path's shapes, beside its
    plain version and its bound."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import fused_distance as fd

    dev = X.device
    n, d = X.shape
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    pick = torch.randperm(n, generator=g, device=dev)
    fdl = build.load("fused_distance")
    stream = build.stream_of(X)
    # K2 at k = 8
    Y = X[pick[:K]].float().contiguous()
    b, by = bound(X.element_size() * n * d + 4 * (K * d + 2 * n),
                  2 * n * K * d, X.dtype)
    rows = [dict(name="fused_argmin_min", ms=cuda_ms(fused_call(
        fdl, stream, X, Y, 1)), plain_ms=cuda_ms(
        lambda: fd._argmin_min_ref(X, Y, None), iters=5, warmup=1),
        bound_ms=b, bound_by=by, shape={"n": n, "m": K, "d": d})]
    rows += score_kernel_rows(fdl, stream, X, w, pick)
    rows.insert(0, lloyd_row(X, w, X[pick[:K]].float().contiguous()))
    return rows


def lloyd_row(X, w, C):
    """K1, one Lloyd iteration (both launches), timed with CUDA events
    beside its plain version, its bound and the two-pass form the card
    takes beyond the kernel's bound (K2 + a one-hot matmul, ``two_pass_ms``:
    a yardstick, not a library call)."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.ops import fused_distance as fd

    n, d = X.shape
    k = C.shape[0]
    ll = build.load("lloyd")
    c2 = fd._row_sumsq(C).contiguous()
    # a bf16 X takes the centers rounded to bf16 (held in f32)
    Ck = C.to(X.dtype).to(torch.float32).contiguous()
    P = k * (d + 1) + 1
    part = torch.empty(ll.dml_lloyd_max_partials() * P, device=X.device)
    out = torch.empty(P, device=X.device)
    stream = build.stream_of(X)
    call = lambda: build.check(ll.dml_lloyd_iter(  # noqa: E731
        X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(),
        Ck.data_ptr(), c2.data_ptr(), n, k, d, part.data_ptr(),
        out.data_ptr(), stream), "timing")
    b, by = bound(X.element_size() * n * d + 4 * (n + k * d + P),
                  2 * n * k * d + 2 * n * d, X.dtype)
    ms = cuda_ms(call)
    return dict(name="lloyd_iter", ms=ms,
                plain_ms=cuda_ms(lambda: core._lloyd_stats_ref(X, w, C),
                                 iters=5, warmup=1),
                bound_ms=b, bound_by=by,
                two_pass_ms=cuda_ms(
                    lambda: core._lloyd_stats_two_pass(X, w, C), iters=10,
                    warmup=2),
                shape={"n": n, "m": k, "d": d})


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
        "library_ms": r.get("library_ms"),
        **{k: v for k, v in r.items()
           if k not in ("name", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")},
    } for r in rows]


def log_score_extras(r, tag: str) -> None:
    """The K3/K4 timing row's extras: its shape, cuBLAS's product beside
    it, and K3 at the rounds' mask."""
    if not r or "gemm_ms" not in r:
        return
    log(f"    {tag} {r['shape']}: {r['ms']:.4f} ms  bound {r['bound_ms']:.4f}"
        f" ms  plain {r['plain_ms']:.4f} ms  gemm {r['gemm_ms']:.4f} ms")
    pm = r.get("path_mask")
    if pm:
        log(f"    {tag} first {pm['valid']} valid: {pm['ms']:.4f} ms  bound "
            f"{pm['bound_ms']:.4f} ms ({pm['bound_by']})  plain "
            f"{pm['plain_ms']:.4f} ms")


def log_two_pass(rows, tag: str) -> None:
    """K1's rows beside the two-pass form; K1 must be no slower."""
    for r in rows:
        if "two_pass_ms" in r:
            log(f"    {tag} lloyd_iter {r['shape']}: {r['ms']:.4f} ms  "
                f"two-pass {r['two_pass_ms']:.4f} ms")
            expect(r["ms"] <= r["two_pass_ms"],
                   f"{tag}: K1 is slower than the two-pass form")


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
    centers, labels, ub, lb = core._bounded_init_state(
        c0, X_pad.shape[0], G, iters)[:4]
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
    X = drawn("kdd", lambda: kdd_data(KDD_N, KDD_D, SEED))
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
    # the MESHREST phase holds its worlds to these two fits
    drawn("kdd_fits", lambda: {"bounded_inertia": float(kmb.inertia_),
                               "sketched": sk})
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
    e = check_lloyd("K1 KDD shape", Xd, wd, C, exact=False)
    errs["lloyd_iter"] = max(errs.get("lloyd_iter", 0.0), e)
    torch.cuda.synchronize()
    log("KDD-shape comparisons: K5, K2-x and K1 within tolerance")

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
    k2x_device = device_ms(fused_call(fdl, stream, Zc, vals, 1, x2=zero))
    # the span kernel's argmins against f32 K2's (the tile kernel, which
    # takes the argmin on the same scores before adding its own |x|^2)
    span = fd._fused_cuda(Zc, vals, None, "argmin_min",
                          x2=fd._row_sumsq(Zc))
    tile = fd._fused_cuda(Zc, vals, None, "argmin_min")
    expect(torch.equal(span[0], tile[0]),
           "K2-x: the span kernel's argmins are not the tile kernel's")
    del span, tile
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
                     device_ms=k2x_device,
                     plain_ms=plain_k2x, bound_ms=b, bound_by=by,
                     shape={"n": n, "m": K, "d": pk},
                     row_need={"evaluated_fraction": ev_n, "ms": k2n,
                               "plain_ms": plain_k2n, "bound_ms": b_n,
                               "bound_by": by_n}))
    rows.append(lloyd_row(Xd, wd, C))
    # -- K3 and K4 at the cell's shape, and the k-means|| phases ------------
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    pick = torch.randperm(Xd.shape[0], generator=g, device=dev)
    summary["score_kernels"] = score_kernel_rows(fdl, stream, Xd, wd, pick)
    del pick
    phases = init_phase_seconds(Xd, wd)
    summary["init_phases"] = phases
    log("INIT_PHASES kdd " + json.dumps(phases))
    # -- where the time goes in a steady tol=0 loop (20 iterations) --------
    for name, fn in (("bounded", lambda: core.lloyd_loop_bounded(
            Xd, wd, c0, 0.0, max_iter=iters)),
                     ("full", lambda: core.lloyd_loop_fused(
                         Xd, wd, c0, 0.0, max_iter=iters))):
        prof = device_profile(fn)
        summary[f"profile_{name}_tol0_{iters}_iters"] = prof
        log(f"PROFILE {name} " + json.dumps(prof))
    launches = {"lloyd_iter": l_f["lloyd_iter"],
                "fused_argmin_min2": l_b["fused_argmin_min2"],
                "fused_argmin_min_sketched":
                    l_s["fused_argmin_min_sketched"]
                    + l_sp["fused_argmin_min_sketched"]}
    return rows, launches, summary


# ---------------------------------------------------------------------------
# the sparse GLM cell
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_pullback_in_f64():
    """The plain pullback with its products and its scatter-add in float64
    (rounded to f32 once, at the end): the plain path without the rounding
    of its own 1e7-long chains of f32 atomics, for the whole-fit check."""
    import torch

    from dask_ml_tpu_torch.ops import sparse as sps

    def in_f64(values, cols, r, d):
        prods = values.double() * r.double()[:, None]
        out = torch.zeros(d, dtype=torch.float64, device=values.device)
        return out.index_add_(0, cols.reshape(-1), prods.reshape(-1)).float()

    plain = sps._pullback_ref
    sps._pullback_ref = in_f64
    try:
        yield
    finally:
        sps._pullback_ref = plain


def glm_plain_check(est, X, y, Xs, dev):
    """The kernel path against the plain path (plain SpMV, ``index_add_``
    pullback: ``kernel="torch"`` launches no kernel of the port) on the
    card, with the facade's staging and arguments (``models.glm.lbfgs``),
    in two parts.

    Step by step, out of the pullback's reach: from each carry of a
    kernel-path run (the first made once, so both share its gradient),
    one iteration through K6 and one through the plain SpMV must make
    the same Armijo tests and the same new coefficients bit for bit,
    since everything the step is made of is in the carry, and objective
    values within K6's rounding: each score moves by at most
    k·2^-23·Σ|a·β|, the logistic loss is 1-Lipschitz in the score, and
    1e-6·|f| covers the two length-n sums' rounding.

    The whole fit: the same ``n_iter`` and coefficients within
    ``GLM_FIT_RTOL``, normwise, of the plain path with its pullback
    accumulated in float64. The f32 plain path is no yardstick for a
    whole fit: ``index_add_`` adds the intercept's 1e7 products one by
    one into one f32 address, each a few ulps of the running sum, so
    its intercept gradient is about 1e-3 off at this fit's residuals
    (4.7 % where the residuals are all ±0.5 / n with a 1 : 3 label
    split and every add rounds the same way), the kernel's (chains of
    n / 66 adds, then 66 in fixed order) 1e-6 (3e-4). That fit is made
    too, twice, and its gap and its spread are printed (``index_add_``'s
    float atomics add in a different order each run). The kernel fit is
    made again and must repeat its bits: its pullback adds fixed-point
    integers. Labels on the score rows may differ only where the
    coefficient gap can carry the plain score across 0. Returns (staged
    container, its y and w, the f64-accumulated plain coefficients, the
    stats)."""
    import torch

    from dask_ml_tpu_torch import _kernels
    from dask_ml_tpu_torch.linear_model.glm import (add_intercept,
                                                    labels_from_proba,
                                                    proba_from_eta)
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.ops import sparse as sps
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    data = prepare_data(X, y=y, device=dev)
    Xd = add_intercept(data.X)
    data.X = None
    n, k = Xd.values.shape
    d = Xd.d
    mask = torch.ones(d, device=dev)
    mask[-1] = 0.0
    b0 = torch.zeros(d, device=dev)
    sw = float(torch.clamp(data.weights.sum(), min=1.0))
    absA = sps.SparseRows(Xd.values.abs(), Xd.cols, d)

    def lbfgs(kernel, **kw):
        return glm_core.lbfgs(Xd, data.y, data.weights, b0, mask,
                              lamduh=1.0 / est.C, tol=est.tol, kernel=kernel,
                              **kw)

    # -- step by step from a shared carry -----------------------------------
    _, _, state, _ = lbfgs("cuda", max_iter=0, return_state=True)
    f_gaps = []
    for it in range(GLM_ITERS):
        out = {}
        for kernel in ("cuda", "torch"):
            glm_core.reset_host_reads()
            _, _, carry, _ = lbfgs(kernel, max_iter=1, state=state,
                                   return_state=True)
            out[kernel] = (carry, glm_core.host_reads["n"])
        (ck, reads_k), (cp, reads_p) = out["cuda"], out["torch"]
        expect(reads_k == reads_p, f"step {it}: kernel path made {reads_k} "
               f"host reads, plain path {reads_p}")
        expect(torch.equal(ck[0], cp[0]),
               f"step {it}: kernel and plain steps differ")
        fk, fp = float(ck[2]), float(cp[2])
        scale = sps.matvec(absA, ck[0].abs(), kernel="torch")
        f_tol = (k * 2.0 ** -23 * float((data.weights * scale).sum()) / sw
                 + 1e-6 * abs(fp))
        expect(abs(fk - fp) <= f_tol, f"step {it}: objective {fk} (kernel) "
               f"against {fp} (plain), beyond {f_tol}")
        f_gaps.append(abs(fk - fp))
        state = ck
        del scale, out, cp
    # -- the whole fit, and the plain fit against itself ---------------------
    _kernels.reset_launches()
    with plain_pullback_in_f64():
        plain, n_plain = lbfgs("torch", max_iter=GLM_ITERS)
    plain32, n_plain32 = lbfgs("torch", max_iter=GLM_ITERS)
    again, _ = lbfgs("torch", max_iter=GLM_ITERS)
    expect(not any(_kernels.launches.values()),
           f"the plain path launched a kernel: {_kernels.launches}")
    expect(n_plain == est.n_iter_ and n_plain32 == est.n_iter_,
           f"plain path n_iter {n_plain}, {n_plain32}")
    coef_p = plain.cpu().numpy()
    coef_32 = plain32.cpu().numpy()
    norm_p = float(np.linalg.norm(coef_p))
    gap = float(np.linalg.norm(est._coef - coef_p)) / norm_p
    gap_32 = float(np.linalg.norm(coef_32 - coef_p)) / norm_p
    gap_k32 = float(np.linalg.norm(est._coef - coef_32)) / norm_p
    spread = float(np.linalg.norm(again.cpu().numpy() - coef_32)) / norm_p
    again, _ = lbfgs("cuda", max_iter=GLM_ITERS)
    spread_k = float(np.linalg.norm(again.cpu().numpy() - est._coef)) / norm_p
    spread_k_max = float(np.abs(again.cpu().numpy() - est._coef).max())
    expect(np.array_equal(again.cpu().numpy(), est._coef),
           f"two kernel-path fits differ: {spread_k} normwise, max abs "
           f"{spread_k_max}")
    expect(gap <= GLM_FIT_RTOL,
           f"kernel and plain (f64-accumulated pullback) coefficients "
           f"differ: {gap} normwise, max abs "
           f"{float(np.abs(est._coef - coef_p).max())}; the f32 plain fit "
           f"is {gap_32} from that reference and {spread} from a rerun of "
           f"itself")
    del absA, again, plain32
    As = add_intercept(Xs.to(dev))
    eta_p = sps.matvec(As, plain, kernel="torch")
    pred_p = labels_from_proba(
        proba_from_eta(eta_p.cpu().numpy(), est.multiclass), est.classes_)
    pred_k = est.predict(Xs)
    bad = np.flatnonzero(pred_k != pred_p)
    if bad.size:
        # |eta_k - eta_p| <= Σ|a|·|β_k - β_p| plus both scores' rounding;
        # sigmoid rounds to 0.5 for |eta| < 2^-23
        coef_k = torch.as_tensor(est._coef, device=dev)
        absS = sps.SparseRows(As.values.abs(), As.cols, As.d)
        reach = (sps.matvec(absS, (coef_k - plain).abs(), kernel="torch")
                 + As.k * 2.0 ** -23 * sps.matvec(
                     absS, coef_k.abs() + plain.abs(), kernel="torch")
                 + 2.0 ** -22)
        far = eta_p.abs() > reach
        expect(not bool(far[torch.as_tensor(bad, device=dev)].any()),
               f"{bad.size} labels differ, some beyond the coefficient gap")
    stats = {"coef_gap_normwise": gap,
             "plain_f32_gap_to_f64_plain_normwise": gap_32,
             "kernel_gap_to_plain_f32_normwise": gap_k32,
             "plain_self_spread_normwise": spread,
             "kernel_self_spread_normwise": spread_k,
             "kernel_self_spread_max_abs": spread_k_max,
             "coef_gap_max_abs": float(np.abs(est._coef - coef_p).max()),
             "step_objective_gaps": f_gaps, "label_flips": int(bad.size)}
    return Xd, data.y, data.weights, plain, stats


def pullback_library_ms(vals, cols, r, d, want):
    """One PyTorch call for ``A.T @ r`` on the same slots: cuSPARSE's SpMV
    on the transposed CSR view through ``torch.mv``, held to 1e-2 normwise
    of the plain version (both sum up to 1e7 f32 terms a column in an
    order of their own)."""
    import torch

    n, k = vals.shape
    torch.cuda.empty_cache()
    crow = torch.arange(0, n * k + 1, k, dtype=torch.int32,
                        device=vals.device)
    csr = torch.sparse_csr_tensor(crow, cols.view(-1), vals.view(-1),
                                  size=(n, d), check_invariants=False)
    got = torch.mv(csr.t(), r)
    torch.cuda.synchronize()
    gap = float((got - want).norm() / want.norm())
    expect(gap <= 1e-2, f"torch.mv on the transposed CSR view is {gap} "
           f"normwise from the plain pullback")
    log(f"pullback library: torch.mv on the transposed CSR view, "
        f"{gap:.3e} normwise from the plain version")
    return cuda_ms(lambda: torch.mv(csr.t(), r), iters=3, warmup=0)


def pullback_accuracy(vals, cols, d, r, routes):
    """Each pullback (the plain version, and the kernel through each of
    ``routes``) against a float64 scatter-add of float64 products: the
    relative error of the last column (the intercept's, which every row
    adds to) and the normwise error of the others. The bound between two
    f32 orders of summation is no gate on that column (1e7 terms: about
    the column's own size), so these are: every kernel's other columns
    within 1e-5 normwise of the float64 sums, and its last column within
    1e-3 of them and, where the plain version is beyond 1e-5, no further
    than that (the plain version's float atomics read 1e-3 to 5e-2 on an
    H100; below 1e-5 both are at the rounding of r itself)."""
    import torch

    from dask_ml_tpu_torch.ops import sparse as sps

    ref = torch.zeros(d, dtype=torch.float64, device=vals.device).index_add_(
        0, cols.view(-1), (vals.double() * r.double()[:, None]).view(-1))
    got = {"plain": sps._pullback_ref(vals, cols, r, d)}
    for name, c in routes:
        got[name] = sps._pullback_cuda(vals, cols, r, d, cluster=c)
    out = {}
    for name, g in got.items():
        e = g.double() - ref
        out[name] = {
            "last_column_rel_err": float(e[-1].abs() / ref[-1].abs()),
            "other_columns_normwise_err": float(e[:-1].norm()
                                                / ref[:-1].norm())}
    for name, c in routes:
        last = out[name]["last_column_rel_err"]
        others = out[name]["other_columns_normwise_err"]
        expect(others <= 1e-5, f"{name}: columns before the last are "
               f"{others} normwise from their float64 sums")
        expect(last <= 1e-3 and last <= max(
            1e-5, out["plain"]["last_column_rel_err"]),
               f"{name}: the last column is {last} from its float64 sum "
               f"(the plain version: "
               f"{out['plain']['last_column_rel_err']})")
    return out


def spmv_at_container(Xd, v, r, errs, r_first=None):
    """K6's four kernels at one full container on float data: each against
    its plain version within its rounding bound, the forwards run to run,
    the pullbacks also against a float64 reference (at ``r`` and, where
    given, at ``r_first``, the residual of a fit's first gradient), then
    their timings, bounds and yardsticks. Returns (rows for the kernels
    line, summary)."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import sparse as sps

    vals, cols, d = Xd.values, Xd.cols, Xd.d
    n, k = vals.shape
    plan_f = sps.dvector_plan(n, k, d)
    plan_b = sps.dvector_plan(n, k, d, pullback=True)
    summary = {"plan": {"spmv": plan_f, "spmv_pullback": plan_b}}

    # -- forward, float data: the kernel and the plain version each sum k
    # f32 products in their own order, so each is within (k - 1)·2^-24·Σ|a·v|
    # of the exact sum; together k·2^-23·Σ|a·v|
    out_p = sps._spmv_ref(vals, cols, v)
    scale = sps._spmv_ref(vals.abs(), cols, v.abs())
    for name, c in (("spmv", plan_f), ("spmv_l2", 0)):
        out_k = sps._spmv_cuda(vals, cols, v, cluster=c)
        err = (out_k - out_p).abs()
        expect(bool((err <= k * 2.0 ** -23 * scale).all()),
               f"{name} at the full container: max abs err "
               f"{float(err.max())}")
        expect(torch.equal(out_k, sps._spmv_cuda(vals, cols, v, cluster=c)),
               f"{name} at the full container does not repeat its bits")
        errs[name] = max(errs.get(name, 0.0), float(err.max()))
    del out_p, scale, err
    # -- pullback, float data: a column that count_c slots add to, summed
    # in any two orders, differs by at most count_c·2^-23·Σ|a·r| (the
    # scale: a pullback of absolute values; the count: one of ones). That
    # holds the 100 or so terms of an ordinary column; the intercept's
    # column is held by pullback_accuracy below
    g_p = sps._pullback_ref(vals, cols, r, d)
    g_scale = sps._pullback_ref(vals.abs(), cols, r.abs(), d)
    count = sps._pullback_ref((vals != 0).float(), cols,
                              torch.ones_like(r), d)
    first = None
    for name, c in (("spmv_pullback", plan_b), ("spmv_pullback_l2", 0)):
        g_k = sps._pullback_cuda(vals, cols, r, d, cluster=c)
        err = (g_k - g_p).abs()
        expect(bool((err <= count * 2.0 ** -23 * g_scale).all()),
               f"{name} at the full container: max abs err "
               f"{float(err.max())}")
        errs[name] = max(errs.get(name, 0.0), float(err.max()))
        expect_repeats(name, lambda c=c: sps._pullback_cuda(
            vals, cols, r, d, cluster=c), g_k)
        first = g_k if first is None else first
        expect(torch.equal(g_k, first),
               f"{name} at the full container: not the bits of the "
               f"cluster route")
    summary["pullback_repeats"] = PULLBACK_REPEATS
    del g_scale, count, err, g_k, first
    torch.cuda.empty_cache()
    routes = (("spmv_pullback", plan_b), ("spmv_pullback_l2", 0))
    summary["pullback_vs_f64"] = {"r": pullback_accuracy(vals, cols, d, r,
                                                         routes)}
    if r_first is not None:
        summary["pullback_vs_f64"]["r_first"] = pullback_accuracy(
            vals, cols, d, r_first, routes)
    torch.cuda.empty_cache()

    # -- timing ---------------------------------------------------------------
    def fwd(c, cols_=cols, v_=v):
        return lambda: sps._spmv_cuda(vals, cols_, v_, cluster=c)

    def pull(c, cols_=cols, d_=d):
        return lambda: sps._pullback_cuda(vals, cols_, r, d_, cluster=c)

    # what the card's memory gives a plain read of half the container:
    # one library reduction over the values, nothing gathered
    read_ms = cuda_ms(lambda: vals.sum(), iters=5, warmup=1)

    ms = cuda_ms(fwd(plan_f))
    l2_ms = cuda_ms(fwd(0))
    plain_ms = cuda_ms(lambda: sps._spmv_ref(vals, cols, v), iters=5,
                       warmup=1)
    b, by = bound(4 * (2 * n * k + n + d), 2 * n * k)
    # the yardstick: cuSPARSE's CSR SpMV on the same slots, through
    # torch.sparse (the port never calls it)
    crow = torch.arange(0, n * k + 1, k, dtype=torch.int32,
                        device=vals.device)
    csr = torch.sparse_csr_tensor(crow, cols.view(-1), vals.view(-1),
                                  size=(n, d), check_invariants=False)
    library_ms = cuda_ms(lambda: torch.mv(csr, v), iters=10, warmup=2)
    summary["library_vs_kernel_max_abs_diff"] = float(
        (torch.mv(csr, v) - sps._spmv_cuda(vals, cols, v, cluster=plan_f))
        .abs().max())
    del csr, crow
    pb_ms = cuda_ms(pull(plan_b), iters=10)
    # the first call on a container also reduces max |values| (kept on the
    # tensor): that pass alone
    lib = build.load("spmv")
    bound_word = torch.empty(1, dtype=torch.int32, device=vals.device)
    values_bound_ms = cuda_ms(lambda: lib.dml_spmv_absmax(
        vals.data_ptr(), 0, vals.numel(), bound_word.data_ptr(),
        build.stream_of(vals)), iters=5, warmup=1)
    pb_l2_ms = cuda_ms(pull(0), iters=5, warmup=1)
    pb_plain_ms = cuda_ms(lambda: sps._pullback_ref(vals, cols, r, d),
                          iters=5, warmup=1)
    pb_library_ms = pullback_library_ms(vals, cols, r, d, g_p)
    del g_p
    torch.cuda.empty_cache()
    # the gather's share: the same slots folded onto 1,024 columns, so that
    # v (4 KB) stays in each SM's L1 under the L2 kernel; then onto FOLD_D
    # columns, which one block's shared memory holds: one block against
    # the clusters each direction is built for, where every block inspects
    # every slot of its cluster. The bytes streamed are the same in every
    # case.
    cols_f = torch.remainder(cols, 1024)
    probe_ms = cuda_ms(fwd(0, cols_f, v[:1024].contiguous()))
    fold_d = min(FOLD_D, d)
    torch.remainder(cols, fold_d, out=cols_f)
    v_f = v[:fold_d].contiguous()
    folded = {"d": fold_d, "spmv_l2_ms": cuda_ms(fwd(0, cols_f, v_f)),
              "spmv_pullback_l2_ms": cuda_ms(pull(0, cols_f, fold_d),
                                             iters=5, warmup=1)}
    for c in sps._PLAN_CLUSTERS[False]:
        folded[f"spmv_cluster{c}_ms"] = cuda_ms(fwd(c, cols_f, v_f),
                                                iters=10)
    for c in sps._PLAN_CLUSTERS[True]:
        folded[f"spmv_pullback_cluster{c}_ms"] = cuda_ms(
            pull(c, cols_f, fold_d), iters=5, warmup=1)
    # the pullback without its hot address: the last slot of every row
    # (the intercept's column d - 1) sent to random columns instead
    cols_f.copy_(cols)
    cols_f[:, -1] = torch.randint(0, d, (n,), dtype=torch.int32,
                                  device=vals.device)
    no_hot = {"spmv_pullback_ms": cuda_ms(pull(plan_b, cols_f), iters=10),
              "spmv_pullback_l2_ms": cuda_ms(pull(0, cols_f), iters=5,
                                             warmup=1)}
    del cols_f
    torch.cuda.empty_cache()
    shape = {"n": n, "k": k, "d": d}
    rows = [
        dict(name="spmv", ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
             library_ms=library_ms, shape=shape, cluster=plan_f,
             gather_probe={"d": 1024, "spmv_l2_ms": probe_ms},
             folded=folded, values_sum_ms=read_ms),
        dict(name="spmv_l2", ms=l2_ms, plain_ms=plain_ms, bound_ms=b,
             bound_by=by, library_ms=library_ms, shape=shape),
        dict(name="spmv_pullback", ms=pb_ms, plain_ms=pb_plain_ms,
             bound_ms=b, bound_by=by, library_ms=pb_library_ms, shape=shape,
             cluster=plan_b, without_hot_column=no_hot,
             values_bound_ms=values_bound_ms),
        dict(name="spmv_pullback_l2", ms=pb_l2_ms, plain_ms=pb_plain_ms,
             bound_ms=b, bound_by=by, library_ms=pb_library_ms,
             shape=shape),
    ]
    return rows, summary


def log_spmv_rows(rows):
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"  {r['name']:26s} {r['ms']:.4f} ms  bound {r['bound_ms']:.4f}"
            f" ms ({r['bound_by']})  plain {r['plain_ms']:.4f} ms  library "
            f"{lib}  launches {r.get('launches', 0)}")
    log("  K6 folded and probed: " + json.dumps(
        {"values_sum_ms": rows[0]["values_sum_ms"],
         "gather_probe": rows[0]["gather_probe"], "folded": rows[0]["folded"],
         "pullback_without_hot_column": rows[2]["without_hot_column"],
         "pullback_values_bound_ms": rows[2]["values_bound_ms"]}))


#: K6 and K6-b at the shape each path launches them at (n, k, d): the
#: served sparse request (SRV_SPARSE_N rows at SRV_GLM_D, density 0.1),
#: an elastic block, the one-hot pipeline's container (ONEHOT_COLS
#: categorical columns of ONEHOT_CATS, with the intercept), a search fold
#: of the sparse GLM data and an incremental block of it
SPMV_PATH_SHAPES = (("served", 2_048, 10, 100),
                    ("elastic", 125_000, 21, 1_001),
                    ("onehot", 1_000_000, 26, 26_001),
                    ("search-fold", 250_000, 101, 100_001),
                    ("incremental", 1_000_000, 101, 100_001))


def device_ms(fn, calls: int = 20) -> float:
    """The device time of one call of ``fn``: every kernel it launches
    (memsets included), summed over ``calls`` calls under
    ``torch.profiler`` and divided by them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        total_us += t if t is not None else e.cuda_time_total
    expect(total_us > 0, "torch.profiler saw no device time")
    return total_us / calls / 1e3


def spmv_path_rows(dev, errs):
    """K6 and K6-b at every path's shape (SPMV_PATH_SHAPES), on integer
    values drawn on the card: each through the plan's route bit for bit
    against its plain version and repeating its bits, then its time
    (back-to-back calls, CUDA events), its device time (torch.profiler),
    its bound, its plain version's time and cuSPARSE's through
    ``torch.mv`` on the CSR view (transposed for K6-b). Returns a row a
    shape and direction."""
    import torch

    from dask_ml_tpu_torch.ops import sparse as sps

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    out = []
    for path, n, k, d in SPMV_PATH_SHAPES:
        cols = torch.randint(0, d, (n, k), dtype=torch.int32, generator=g,
                             device=dev)
        cols[:, -1] = d - 1  # the intercept's column
        vals = torch.randint(-4, 4, (n, k), generator=g,
                             device=dev).float()
        v = torch.randint(-4, 4, (d,), generator=g, device=dev).float()
        r = torch.randint(-4, 4, (n,), generator=g, device=dev).float()
        crow = torch.arange(0, n * k + 1, k, dtype=torch.int32, device=dev)
        csr = torch.sparse_csr_tensor(crow, cols.view(-1), vals.view(-1),
                                      size=(n, d), check_invariants=False)
        b, by = bound(4 * (2 * n * k + n + d), 2 * n * k)
        for pull in (False, True):
            plan = sps.dvector_plan(n, k, d, pullback=pull)
            if pull:
                name = ("spmv_pullback", "spmv_pullback_l2")[plan == 0]

                def kern():
                    return sps._pullback_cuda(vals, cols, r, d, cluster=plan)

                def plain():
                    return sps._pullback_ref(vals, cols, r, d)

                def library():
                    return torch.mv(csr.t(), r)
            else:
                name = "spmv" if plan else "spmv_l2"

                def kern():
                    return sps._spmv_cuda(vals, cols, v, cluster=plan)

                def plain():
                    return sps._spmv_ref(vals, cols, v)

                def library():
                    return torch.mv(csr, v)
            got = kern()
            expect(torch.equal(got, plain()),
                   f"{name} at the {path} shape: not the plain version's "
                   f"bits on integer data")
            expect_repeats(f"{name} at the {path} shape", kern, got)
            errs[name] = max(errs.get(name, 0.0),
                             float((got - plain()).abs().max()))
            row = dict(path=path, name=name, route=plan,
                       shape={"n": n, "k": k, "d": d},
                       ms=cuda_ms(kern, iters=200, warmup=20),
                       device_ms=device_ms(kern), bound_ms=b, bound_by=by,
                       plain_ms=cuda_ms(plain, iters=10, warmup=2),
                       # cuSPARSE's transposed SpMV takes ms at the larger
                       # shapes: fewer calls
                       library_ms=cuda_ms(library, iters=10 if pull else 200,
                                          warmup=2 if pull else 20),
                       library_device_ms=device_ms(library,
                                                   calls=5 if pull else 20))
            log(f"  {name:18s} {path:12s} {row['ms']:.4f} ms  device "
                f"{row['device_ms']:.4f} ms  bound {b:.4f} ms  plain "
                f"{row['plain_ms']:.4f} ms  library {row['library_ms']:.4f} "
                f"ms (device {row['library_device_ms']:.4f})")
            out.append(row)
        del cols, vals, v, r, crow, csr
        torch.cuda.empty_cache()
    return out


def sparse_glm_data():
    """The JAX bench's flagship sparse problem, drawn on the host."""
    from dask_ml_tpu_torch.datasets import make_sparse_classification

    return make_sparse_classification(GLM_N, GLM_D, GLM_DENSITY,
                                      random_state=42)


#: the kernel rows glm_cell times: K6 and K6-b on each route
GLM_CELL_K6 = ("spmv", "spmv_l2", "spmv_pullback", "spmv_pullback_l2")


def glm_cell(dev, errs):
    """The sparse GLM path at the JAX package's flagship sparse problem,
    its checks, and K6's timings at its container. Returns (timed rows,
    launches by kernel for the kernels line, summary)."""
    import torch

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.ops import sparse as sps

    t0 = time.perf_counter()
    X, y = drawn("sparse_glm", sparse_glm_data)
    gen_s = time.perf_counter() - t0
    log(f"sparse data {X.shape}, k = {X.k}, {X.nbytes / 1e9:.2f} GB made in "
        f"{gen_s:.2f} s")
    summary = {"n": GLM_N, "d": GLM_D, "nnz_per_row": X.k,
               "host_generation_s": gen_s}

    # -- the main path of this slice: L-BFGS fit, then score ---------------
    glm_core.reset_host_reads()
    est, fit_s, l_fit = drive(lambda: LogisticRegression(
        solver="lbfgs", max_iter=GLM_ITERS).fit(X, y))
    reads = glm_core.host_reads["n"]
    expect_launches("glm-sparse-fit", l_fit)
    expect(est.n_iter_ == GLM_ITERS, f"n_iter_ {est.n_iter_}")
    expect(np.isfinite(est.coef_).all() and est.coef_.shape == (GLM_D,),
           "bad coefficients")
    Xs, ys = X[:GLM_SCORE_N], y[:GLM_SCORE_N]
    acc, score_s, l_score = drive(lambda: est.score(Xs, ys))
    expect_launches("glm-sparse-score", l_score)
    log(f"sparse L-BFGS accuracy on the first {GLM_SCORE_N} rows: {acc:.4f} "
        f"(the JAX drill's record: {JAX_GLM_ACCURACY})")
    expect(acc > 0.55, f"accuracy {acc} <= 0.55")
    # the same rows and the same algorithm as the JAX drill: its accuracy
    expect(abs(acc - JAX_GLM_ACCURACY) <= 1e-3,
           f"accuracy {acc} is not within 0.001 of {JAX_GLM_ACCURACY}")
    # value and gradient at the start, then per iteration one trial step
    # and one value and gradient: 7 forwards and 4 pullbacks; score is one
    expect(l_fit["spmv"] == 2 * GLM_ITERS + 1 and l_score["spmv"] == 1
           and l_fit["spmv_pullback"] >= GLM_ITERS + 1,
           f"launches of the fit {l_fit} and of the score {l_score}")
    path_line("glm-sparse-lbfgs", fit_s, est.n_iter_, l_fit,
              phases={**est.fit_phase_seconds_, "score": score_s},
              score_launches=l_score, host_reads=reads,
              host_reads_per_iter=reads / est.n_iter_, accuracy=acc,
              jax_record_accuracy=JAX_GLM_ACCURACY)
    summary.update(fit_s=fit_s, phases=est.fit_phase_seconds_,
                   score_s=score_s, accuracy=acc, n_iter=est.n_iter_,
                   host_reads=reads)

    # -- the plain path on the card ------------------------------------------
    Xd, yd, wd, plain, agree = glm_plain_check(est, X, y, Xs, dev)
    log(f"kernel and plain L-BFGS agree: each step bit for bit, objective "
        f"gaps {agree['step_objective_gaps']}; whole fit "
        f"{agree['coef_gap_normwise']:.3e} normwise from the plain path "
        f"with an f64-accumulated pullback (the f32 plain fit "
        f"{agree['plain_f32_gap_to_f64_plain_normwise']:.3e} from it and "
        f"{agree['plain_self_spread_normwise']:.3e} from a rerun of itself, "
        f"the kernel fit {agree['kernel_self_spread_normwise']:.3e} from a "
        f"rerun of itself); "
        f"{agree['label_flips']} labels of {GLM_SCORE_N} within the gap")
    summary["kernel_vs_plain"] = agree
    del X, Xs

    # -- the four kernels at the full container, and their timings ---------
    v = plain.contiguous()
    r = (torch.sigmoid(sps._spmv_cuda(Xd.values, Xd.cols, v)) - yd) / float(
        Xd.values.shape[0])
    # the fit's first residual: beta = 0, every probability 0.5
    rows, at_full = spmv_at_container(Xd, v, r, errs,
                                      r_first=(0.5 - yd) / float(
                                          Xd.values.shape[0]))
    summary.update(at_full)
    del r

    # -- one L-BFGS iteration as the loop runs it ----------------------------
    d = Xd.d
    mask = torch.ones(d, device=dev)
    mask[-1] = 0.0
    b0 = torch.zeros(d, device=dev)
    _, _, carry, _ = glm_core.lbfgs(Xd, yd, wd, b0, mask, lamduh=1.0,
                                    max_iter=GLM_ITERS, return_state=True)

    def one_iter():
        return glm_core.lbfgs(Xd, yd, wd, b0, mask, lamduh=1.0, max_iter=1,
                              state=carry)

    one_iter()
    torch.cuda.synchronize()
    glm_core.reset_host_reads()
    t0 = time.perf_counter()
    one_iter()
    torch.cuda.synchronize()
    iter_ms = (time.perf_counter() - t0) * 1e3
    summary.update(lbfgs_iter_ms=iter_ms,
                   lbfgs_iter_host_reads=glm_core.host_reads["n"])
    prof = device_profile(one_iter)
    summary["profile_lbfgs_iter"] = prof
    log("PROFILE glm-lbfgs-iter " + json.dumps(prof))
    expect(prof is not None and not any("indexFunc" in t["kernel"]
                                        for t in prof["top"]),
           "an index_add_ kernel ran in the kernel path's L-BFGS iteration")
    log(f"one L-BFGS iteration as the loop runs it: {iter_ms:.3f} ms")
    rows[0].update(launches_fit=l_fit["spmv"],
                   launches_score=l_score["spmv"])
    launches = {name: l_fit[name] + l_score[name]
                for name in ("spmv", "spmv_l2", "spmv_pullback",
                             "spmv_pullback_l2")}
    return rows, launches, summary


def spmv_only(dev, errs):
    """K6's edge cases and its kernels at a container of the sparse cell's
    shape drawn on the card (N(0,1) values, uniform columns, the
    intercept's slot of ones on column d - 1), without the GLM."""
    import torch

    from dask_ml_tpu_torch.ops import sparse as sps

    spmv_edge_cases(dev)
    torch.cuda.synchronize()
    log("K6 edge cases: every kernel matches its plain version")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    n, k, d = GLM_N, int(GLM_D * GLM_DENSITY) + 1, GLM_D + 1
    vals = torch.randn((n, k), generator=g, device=dev)
    cols = torch.randint(0, d - 1, (n, k), dtype=torch.int32, generator=g,
                         device=dev)
    vals[:, -1] = 1.0
    cols[:, -1] = d - 1
    v = torch.randn(d, generator=g, device=dev) * 0.05
    r = torch.randn(n, generator=g, device=dev) / n
    y = (torch.rand(n, generator=g, device=dev) < 0.25).float()
    rows, summary = spmv_at_container(sps.SparseRows(vals, cols, d), v, r,
                                      errs, r_first=(0.5 - y) / n)
    # wider models on the same slots: where does the pullback's cluster
    # of 4 stand against device atomics, and what does the forward's L2
    # kernel take there?
    summary["wide"] = {}
    for d2 in SPMV_WIDE_DS:
        cols.random_(0, d2 - 1, generator=g)
        cols[:, -1] = d2 - 1
        v2 = torch.randn(d2, generator=g, device=dev) * 0.05
        times = {}
        for pull in (False, True):
            for c in fitting_routes(k, d2, pull)[:2]:  # L2, and the smallest cluster that fits
                fn = ((lambda c=c: sps._pullback_cuda(vals, cols, r, d2,
                                                      cluster=c)) if pull
                      else (lambda c=c: sps._spmv_cuda(vals, cols, v2,
                                                       cluster=c)))
                name = ("spmv_pullback" if pull else "spmv") + (
                    f"_cluster{c}" if c else "_l2")
                times[name + "_ms"] = cuda_ms(fn, iters=5, warmup=1)
                if pull:
                    expect_repeats(f"{name} at d = {d2}", fn, fn())
        summary["wide"][str(d2)] = times
    return kernel_rows(rows, {row["name"]: 0 for row in rows}, errs), summary


# ---------------------------------------------------------------------------
# the GLM solvers beyond L-BFGS and the decompositions
# ---------------------------------------------------------------------------


def normal_f32(shape, seed, chunks: int = 64):
    """N(0, 1) float32 of ``shape`` drawn with numpy in row chunks, each
    from its own child of ``SeedSequence(seed)``, filled by 8 threads
    (numpy releases the interpreter lock while it fills): the same numbers
    whatever the number of threads."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty(shape, np.float32)
    rows = out.reshape(shape[0], -1)
    bounds = np.linspace(0, shape[0], chunks + 1).astype(np.int64)
    seeds = np.random.SeedSequence(seed).spawn(chunks)

    def fill(i):
        np.random.default_rng(seeds[i]).standard_normal(
            out=rows[bounds[i]:bounds[i + 1]], dtype=np.float32)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, range(chunks)))
    return out


def admm_data(seed: int):
    """The JAX package's ``make_classification(ADMM_N, ADMM_D,
    n_informative=ADMM_D, scale=2.0)`` recipe drawn with numpy: N(0, 1)
    features, coefficients uniform on (-2, 0), labels Bernoulli of the
    sigmoid."""
    rng = np.random.default_rng([seed, 7])
    X = normal_f32((ADMM_N, ADMM_D), [seed, 7])
    beta = (rng.random(ADMM_D, dtype=np.float32) - 1.0) * 2.0
    z = X @ beta
    u = rng.random(ADMM_N, dtype=np.float32)
    y = (u < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    return X, y


def softmax_labels(X, B, rng):
    """Class labels drawn from the softmax of ``X @ B``."""
    L = X @ B
    L -= L.max(axis=1, keepdims=True)
    np.exp(L, out=L)
    np.cumsum(L, axis=1, out=L)
    u = rng.random(X.shape[0], dtype=np.float32) * L[:, -1]
    return np.minimum((L < u[:, None]).sum(axis=1), B.shape[1] - 1)


def logistic_objective(Xd, yd, coef, intercept, lamduh=1.0):
    """The facade's penalized objective (the mean loss plus λ/n·½‖coef‖²,
    the intercept unpenalized) and the training accuracy of a fitted
    binary model, on the card, summed in float64."""
    import torch

    c = torch.as_tensor(coef, device=Xd.device)
    eta = Xd @ c + float(intercept)
    loss = torch.logaddexp(eta, torch.zeros_like(eta)) - yd * eta
    n = Xd.shape[0]
    f = (loss.double().sum() + lamduh * 0.5 * (c.double() ** 2).sum()) / n
    acc = ((eta > 0).to(yd.dtype) == yd).double().mean()
    return float(f), float(acc)


def softmax_objective(Xd, yd, coef, intercept, lamduh=1.0):
    """The multinomial facade's penalized objective, as above."""
    import torch

    C = torch.as_tensor(coef, device=Xd.device)
    logits = Xd @ C.T + torch.as_tensor(intercept, device=Xd.device)
    nll = (torch.logsumexp(logits, dim=1)
           - logits.gather(1, yd.long()[:, None])[:, 0])
    n = Xd.shape[0]
    return float((nll.double().sum()
                  + lamduh * 0.5 * (C.double() ** 2).sum()) / n)


def class_centered_corr(coef, B):
    """Correlation of fitted (K, d) and true (d, K) coefficients, each
    centered over the classes (softmax leaves a shift free)."""
    a = coef - coef.mean(axis=0)
    b = B.T - B.T.mean(axis=0)
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def dense_admm_cell(dev):
    """Consensus ADMM at the JAX GLM bench's shape: the core solver as
    that bench calls it, at S = 1 and 8; ``LogisticRegression()`` with
    its defaults, then ``score``; the same facade under settings that
    converge, against L-BFGS; the softmax fits over the same X."""
    import torch

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models import glm as glm_core

    t0 = time.perf_counter()
    X, y = drawn("admm", lambda: admm_data(SEED))
    gen_s = time.perf_counter() - t0
    log(f"ADMM data {X.shape} made in {gen_s:.2f} s")
    out = {"n": ADMM_N, "d": ADMM_D, "host_generation_s": gen_s}
    Xd = torch.from_numpy(X).to(dev)
    yd = torch.from_numpy(y).to(dev)
    w = torch.ones(ADMM_N, device=dev)
    mask = torch.ones(ADMM_D, device=dev)
    b0 = torch.zeros(ADMM_D, device=dev)

    def core(S, iters, **kw):
        return glm_core.admm(Xd, yd, w, b0, mask, n_shards=S, lamduh=1.0,
                             max_iter=iters, abstol=0.0, reltol=0.0, **kw)

    core(1, 1)  # cuBLAS and cuSOLVER handles, allocator
    for S in ADMM_SHARDS:
        glm_core.reset_host_reads()
        (z, n_iter), sec, l_core = drive(lambda: core(S, ADMM_OUTER))
        steps = glm_core.host_reads["newton_steps"]
        expect(n_iter == ADMM_OUTER and bool(torch.isfinite(z).all()),
               f"core admm S={S}: n_iter {n_iter}")
        out[f"core_S{S}"] = {"seconds": sec,
                             "ms_per_outer_iter": sec * 1e3 / n_iter,
                             "newton_steps": steps,
                             "ms_per_newton_step": sec * 1e3 / steps,
                             "host_reads": glm_core.host_reads["n"]}
        path_line(f"admm-core-S{S}", sec, n_iter, l_core,
                  **out[f"core_S{S}"])
    out["profile_outer_iter_S1"] = prof = device_profile(lambda: core(1, 1))
    log("PROFILE admm-outer-iter " + json.dumps(prof))

    # -- the facade with every default, as a user calls it -----------------
    def default_fit_score():
        est = LogisticRegression().fit(X, y)
        return est, est.score(X, y)

    (est, acc_score), sec, l_def = drive(default_fit_score)
    expect(est.coef_.shape == (ADMM_D,) and np.isfinite(est.coef_).all(),
           "default LogisticRegression: bad coefficients")
    ref = LogisticRegression(solver="lbfgs", max_iter=500,
                             tol=1e-7).fit(Xd, y)
    conv = LogisticRegression(solver_kwargs=ADMM_CONVERGING).fit(Xd, y)
    f_ref, a_ref = logistic_objective(Xd, yd, ref.coef_, ref.intercept_)
    f_def, a_def = logistic_objective(Xd, yd, est.coef_, est.intercept_)
    f_conv, a_conv = logistic_objective(Xd, yd, conv.coef_,
                                        conv.intercept_)
    fit = {"phases": est.fit_phase_seconds_, "score": acc_score, "accuracy": a_def,
           "objective_gap": (f_def - f_ref) / f_ref,
           "lbfgs": {"n_iter": ref.n_iter_, "objective": f_ref,
                     "accuracy": a_ref, "phases": ref.fit_phase_seconds_},
           "converging": {"solver_kwargs": ADMM_CONVERGING,
                          "n_iter": conv.n_iter_,
                          "objective_gap": (f_conv - f_ref) / f_ref,
                          "accuracy": a_conv,
                          "phases": conv.fit_phase_seconds_}}
    path_line("glm-admm-default", sec, est.n_iter_, l_def, **fit)
    out["facade"] = dict(fit, n_iter=est.n_iter_)
    log(f"LogisticRegression() at {ADMM_N} x {ADMM_D}: n_iter_ "
        f"{est.n_iter_}, objective {fit['objective_gap']:.3e} above "
        f"L-BFGS's, accuracy {a_def:.5f} (L-BFGS {a_ref:.5f}); with "
        f"{ADMM_CONVERGING}: n_iter_ {conv.n_iter_}, objective "
        f"{fit['converging']['objective_gap']:.3e} above L-BFGS's")
    expect(abs(a_def - a_ref) <= ADMM_ACC_TOL,
           f"default ADMM accuracy {a_def} against L-BFGS {a_ref}")
    expect(conv.n_iter_ < conv.max_iter,
           f"ADMM with {ADMM_CONVERGING} did not converge")
    expect(abs(f_conv - f_ref) <= ADMM_OBJ_RTOL * f_ref
           and abs(a_conv - a_ref) <= ADMM_ACC_TOL,
           f"converged ADMM objective {f_conv} / accuracy {a_conv} against "
           f"L-BFGS {f_ref} / {a_ref}")
    del est, ref, conv

    # -- softmax: L-BFGS over every row, ADMM over the first rows ----------
    rng = np.random.default_rng([SEED, 8])
    B = (rng.standard_normal((ADMM_D, MN_K)) * MN_SCALE).astype(np.float32)
    t0 = time.perf_counter()
    yk = softmax_labels(X, B, rng)
    log(f"softmax labels (K = {MN_K}) drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    mn, sec, l_mn = drive(lambda: LogisticRegression(
        solver="lbfgs", multiclass="multinomial").fit(Xd, yk))
    corr = class_centered_corr(mn.coef_, B)
    path_line("glm-multinomial-lbfgs", sec, mn.n_iter_, l_mn,
              phases=mn.fit_phase_seconds_, k=MN_K, coef_corr=corr)
    expect(mn.coef_.shape == (MN_K, ADMM_D) and corr >= MN_CORR,
           f"multinomial L-BFGS coefficients correlate {corr} < {MN_CORR}")
    B4 = (rng.standard_normal((ADMM_D, MN_ADMM_K)) * MN_SCALE).astype(
        np.float32)
    y4 = softmax_labels(X[:MN_ADMM_N], B4, rng)
    X1 = Xd[:MN_ADMM_N]
    ma, sec, l_ma = drive(lambda: LogisticRegression(
        multiclass="multinomial").fit(X1, y4))
    ml = LogisticRegression(solver="lbfgs",
                            multiclass="multinomial").fit(X1, y4)
    y4d = torch.as_tensor(y4, device=dev)
    f_a = softmax_objective(X1, y4d, ma.coef_, ma.intercept_)
    f_l = softmax_objective(X1, y4d, ml.coef_, ml.intercept_)
    path_line("glm-multinomial-admm", sec, ma.n_iter_, l_ma,
              phases=ma.fit_phase_seconds_, n=MN_ADMM_N, k=MN_ADMM_K,
              objective_gap=(f_a - f_l) / f_l, lbfgs_n_iter=ml.n_iter_,
              coef_corr=class_centered_corr(ma.coef_, B4))
    expect(abs(f_a - f_l) <= ADMM_OBJ_RTOL * f_l,
           f"multinomial ADMM objective {f_a} against L-BFGS {f_l}")
    out["multinomial"] = {"lbfgs_s": sec, "coef_corr": corr,
                          "admm_objective_gap": (f_a - f_l) / f_l}
    return out


def sparse_admm_cell(dev):
    """``LogisticRegression(solver="admm")`` on a sparse container: K6
    and its backward must launch; one outer iteration from a shared state
    through the kernels and through the plain versions must agree."""
    import torch

    from dask_ml_tpu_torch.datasets import make_sparse_classification
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.linear_model.glm import add_intercept
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    X, y = drawn("sparse_admm", lambda: make_sparse_classification(
        SPADMM_N, SPADMM_D, SPADMM_DENSITY, random_state=0))

    def fit_score():
        est = LogisticRegression(solver="admm",
                                 max_iter=SPADMM_ITERS).fit(X, y)
        return est, est.score(X, y)

    glm_core.reset_host_reads()
    (est, acc), sec, launches = drive(fit_score)
    expect_launches("glm-sparse-admm", launches)
    expect(est.n_iter_ == SPADMM_ITERS and np.isfinite(est.coef_).all(),
           f"sparse ADMM: n_iter_ {est.n_iter_}")
    summary = {"n": SPADMM_N, "d": SPADMM_D, "k": X.k,
               "phases": est.fit_phase_seconds_, "accuracy": acc,
               "newton_steps": glm_core.host_reads["newton_steps"],
               "host_reads": glm_core.host_reads["n"]}
    path_line("glm-sparse-admm", sec, est.n_iter_, launches, **summary)

    data = prepare_data(X, y=y)
    Xs = add_intercept(data.X)
    mask = torch.ones(Xs.d, device=dev)
    mask[-1] = 0.0
    b0 = torch.zeros(Xs.d, device=dev)
    args = (Xs, data.y, data.weights, b0, mask)
    _, _, state, _ = glm_core.admm(*args, lamduh=1.0, max_iter=2,
                                   return_state=True)

    def one(kernel):
        return glm_core.admm(*args, lamduh=1.0, max_iter=1, state=state,
                             kernel=kernel)[0]

    zc, zc2, zt, zt2 = one("cuda"), one("cuda"), one("torch"), one("torch")

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    agree = {"kernel_vs_plain_normwise": rel(zc, zt),
             "kernel_self_spread": rel(zc2, zc),
             "plain_self_spread": rel(zt2, zt)}
    log(f"sparse ADMM, one outer iteration from a shared state: kernel "
        f"{agree['kernel_vs_plain_normwise']:.3e} normwise from plain "
        f"(spreads: kernel {agree['kernel_self_spread']:.3e}, plain "
        f"{agree['plain_self_spread']:.3e})")
    expect(agree["kernel_vs_plain_normwise"] <= SPADMM_RTOL,
           f"sparse ADMM kernel against plain: {agree}")
    summary.update(agree)
    return launches, summary


def pca_data(seed: int):
    """The JAX PCA bench's problem drawn with numpy: a rank-PCA_RANK
    product of N(0, 1) factors plus 0.1·N(0, 1) noise."""
    A = normal_f32((PCA_N, PCA_RANK), [seed, 9, 0])
    B = normal_f32((PCA_RANK, PCA_D), [seed, 9, 1])
    X = A @ B
    noise = normal_f32((PCA_N, PCA_D), [seed, 9, 2])
    noise *= 0.1
    X += noise
    return X


def ill_conditioned(rng, n=4096, d=64, cond=1e6):
    U, _ = np.linalg.qr(rng.standard_normal((n, d)))
    V, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return ((U * np.logspace(0, -np.log10(cond), d)) @ V.T).astype(
        np.float32)


def pca_cell(dev):
    """PCA and TruncatedSVD at the JAX PCA bench's shape, both solvers
    each, against float64 singular values on the card; tsqr's fallback on
    an ill-conditioned input."""
    import torch

    from dask_ml_tpu_torch.decomposition import PCA, TruncatedSVD
    from dask_ml_tpu_torch.ops import linalg

    t0 = time.perf_counter()
    X = drawn("pca", lambda: pca_data(SEED))
    out = {"n": PCA_N, "d": PCA_D, "k": PCA_K,
           "host_generation_s": time.perf_counter() - t0}
    log(f"PCA data {X.shape} made in {out['host_generation_s']:.2f} s")

    def run(name, fn):
        linalg.reset_tsqr_counts()
        res, sec, launches = drive(fn)
        out[name] = {"seconds": sec, "tsqr": dict(linalg.tsqr_counts)}
        path_line(name, sec, None, launches, tsqr=out[name]["tsqr"])
        return res

    rand = run("pca-randomized", lambda: PCA(
        PCA_K, svd_solver="randomized", iterated_power=2,
        random_state=0).fit(X))
    full = PCA(PCA_K, svd_solver="full")
    Zf = run("pca-full", lambda: full.fit_transform(X))
    expect(out["pca-full"]["tsqr"] == {"host_reads": 1, "cholqr2": 1,
                                       "householder": 0},
           f"the tsqr path did not take CholeskyQR2: {out['pca-full']}")
    tsvd_t = run("tsvd-tsqr", lambda: TruncatedSVD(
        PCA_K, algorithm="tsqr").fit(X))
    tsvd_r = run("tsvd-randomized", lambda: TruncatedSVD(
        PCA_K, algorithm="randomized", random_state=0).fit(X))

    # float64 singular values of the centered X on the card: the R of its
    # Householder QR, then the SVD of that (d, d) factor
    Xt = torch.from_numpy(X).to(dev).double()
    Xt -= Xt.mean(dim=0)
    s64 = torch.linalg.svdvals(torch.linalg.qr(Xt, mode="r")[1])
    s64 = s64[:PCA_K].cpu().numpy()
    # why tsvd names cuSOLVER's gesvd: the f32 tsqr R of the same X through
    # torch.linalg.svd's default CUDA driver (gesvdj) and through gesvd
    Xt = Xt.float()
    _, R = linalg.tsqr(Xt)
    del Xt
    eye = torch.eye(PCA_D, device=dev)
    drivers = {}
    for drv in (None, "gesvd"):
        _, S, Vt = torch.linalg.svd(R, full_matrices=False, driver=drv)
        S = S[:PCA_K].cpu().numpy()
        drivers[drv or "default"] = {
            "sv_rel_err_vs_f64": float(np.max(np.abs(S - s64) / s64)),
            "vt_orthogonality": float(torch.abs(Vt @ Vt.T - eye).max()),
            "ms": cuda_ms(lambda: torch.linalg.svd(
                R, full_matrices=False, driver=drv), iters=2, warmup=1)}
    out["svd_drivers"] = drivers
    log("svd of the tsqr R, by cuSOLVER driver: " + json.dumps(drivers))
    del R
    torch.cuda.empty_cache()
    top = PCA_RANK
    full_rel = float(np.max(np.abs(full.singular_values_ - s64) / s64))
    rand_rel = float(np.max(np.abs(rand.singular_values_[:top] - s64[:top])
                            / s64[:top]))
    align = float(np.abs(np.diag(
        rand.components_[:top] @ full.components_[:top].T)).min())
    svd_rel = float(np.max(np.abs(tsvd_r.singular_values_[:top]
                                  - tsvd_t.singular_values_[:top])
                           / tsvd_t.singular_values_[:top]))
    svd_align = float(np.abs(np.diag(
        tsvd_r.components_[:top] @ tsvd_t.components_[:top].T)).min())
    Zt = full.transform(X[:PCA_CHECK_ROWS])
    scale = float(np.abs(Zf).max())
    tr_err = float(np.abs(Zt - Zf[:PCA_CHECK_ROWS]).max()) / scale
    rZ = rand.transform(X[:PCA_CHECK_ROWS])
    out["gates"] = gates = {
        "full_sv_rel_err_vs_f64": full_rel,
        "randomized_top64_sv_rel_err": rand_rel,
        "randomized_top64_min_alignment": align,
        "tsvd_randomized_vs_tsqr_top64_sv_rel": svd_rel,
        "tsvd_randomized_vs_tsqr_top64_alignment": svd_align,
        "full_transform_vs_fit_transform_rel": tr_err,
        "randomized_transform_vs_exact_rel": float(
            np.abs(np.abs(rZ[:, :top]) - np.abs(Zt[:, :top])).max())
        / scale}
    log("PCA gates " + json.dumps(gates))
    expect(np.isfinite(Zf).all() and Zf.shape == (PCA_N, PCA_K),
           "PCA fit_transform: bad output")
    expect(full_rel <= 1e-4, f"tsqr singular values {full_rel} from f64")
    expect(rand_rel <= 1e-3 and align >= 0.999,
           f"randomized PCA: singular values {rand_rel}, alignment {align}")
    expect(svd_rel <= 1e-3 and svd_align >= 0.999,
           f"randomized TruncatedSVD: {svd_rel}, alignment {svd_align}")
    expect(tr_err <= 1e-4, f"transform != fit_transform: {tr_err}")

    Xd = torch.as_tensor(X, device=dev)
    prof = device_profile(lambda: linalg.tsvd(Xd))
    del Xd
    out["profile_tsvd"] = prof
    log("PROFILE pca-tsvd " + json.dumps(prof))

    # the fallback on the card: cond 1e6 breaks CholeskyQR2's guard
    Xi = torch.as_tensor(ill_conditioned(np.random.default_rng(SEED)),
                         device=dev)
    linalg.reset_tsqr_counts()
    Q, R = linalg.tsqr(Xi)
    ortho = float(torch.abs(Q.T @ Q - torch.eye(Q.shape[1],
                                                device=dev)).max())
    recon = float(torch.abs(Q @ R - Xi).max())
    out["fallback"] = {"tsqr": dict(linalg.tsqr_counts),
                       "orthogonality": ortho, "reconstruction": recon}
    log(f"tsqr on a cond-1e6 input: {out['fallback']}")
    expect(linalg.tsqr_counts["householder"] == 1 and ortho < 1e-5
           and recon < 1e-5,
           f"tsqr fallback on the card: {out['fallback']}")
    return out


def glm_pca_cells(dev):
    """The four paths of the GLM-and-decomposition slice. Returns the
    sparse ADMM path's launches and a summary."""
    import torch

    t0 = time.perf_counter()
    dense = dense_admm_cell(dev)
    torch.cuda.empty_cache()
    launches, sparse = sparse_admm_cell(dev)
    torch.cuda.empty_cache()
    pca = pca_cell(dev)
    torch.cuda.empty_cache()
    summary = {"admm": dense, "sparse_admm": sparse, "pca": pca,
               "seconds": time.perf_counter() - t0}
    log("GLM_PCA " + json.dumps(summary))
    return launches, summary


# ---------------------------------------------------------------------------
# STREAM: the streaming and fault tier
# ---------------------------------------------------------------------------


class Interrupt(Exception):
    """Raised by a patched function to stand in for a kill mid-run."""


@contextlib.contextmanager
def interrupt_on(module, name: str, at: int, after: bool = False):
    """Patch ``module.name`` so that its ``at``-th call raises
    :class:`Interrupt`: before the call runs, or ``after`` it (a save
    that completes, then the kill)."""
    orig = getattr(module, name)
    calls = []

    def patched(*a, **k):
        calls.append(1)
        if len(calls) == at and not after:
            raise Interrupt(name)
        out = orig(*a, **k)
        if len(calls) == at:
            raise Interrupt(name)
        return out

    setattr(module, name, patched)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def block_seed(seed: int, b: int) -> int:
    """The ``torch.Generator`` seed of block ``b`` of a run seeded
    ``seed``."""
    return int(np.random.SeedSequence([seed, b]).generate_state(1)[0])


def rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    import torch

    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def states_equal(a, b) -> bool:
    import torch

    return all(torch.equal(s, t) for s, t in zip(a, b))


def h2d_rates(dev, nbytes: int = 1 << 30) -> dict:
    """GB/s of one ``copy_`` of ``nbytes`` host→device between CUDA events,
    from pinned and from pageable memory (each buffer written first, so no
    page is faulted in during the copy)."""
    import torch

    n = nbytes // 4
    out = torch.empty(n, device=dev)
    rates = {}
    for name, pin in (("pinned", True), ("pageable", False)):
        host = torch.ones(n, pin_memory=pin)
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out.copy_(host, non_blocking=pin)
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3)
        rates[f"{name}_gbps"] = nbytes / best / 1e9
        del host
    return rates


def stream_admm_blueprint(dev):
    """BASELINE config 3 at 1e8 × 100: 40 blocks of 2,500,000 rows made on
    the card by ``block_fn(b)`` (bench_admm_blueprint's recipe), 10 outer
    iterations of streamed ADMM, one block resident at a time."""
    import torch

    from dask_ml_tpu_torch.models import glm as glm_core

    n, d, B = BP_ADMM_N, BP_ADMM_D, BP_ADMM_BLOCKS
    rows = n // B
    w_true = torch.as_tensor(
        np.random.RandomState(3).randn(d).astype(np.float32), device=dev)

    def block_fn(b):
        g = torch.Generator(device=dev)
        g.manual_seed(block_seed(SEED, b))
        X = torch.randn((rows, d), generator=g, device=dev).mul_(2.0)
        eta = X @ w_true + torch.randn(rows, generator=g, device=dev)
        return X, (eta > 0).to(torch.float32), torch.ones(rows, device=dev)

    gen_ms = cuda_ms(lambda: block_fn(0), iters=3, warmup=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    glm_core.reset_host_reads()
    (z, n_iter), sec, launches = drive(lambda: glm_core.admm_streamed(
        block_fn, B, d, float(n), family="logistic", regularizer="l2",
        lamduh=1.0, max_iter=BP_ADMM_OUTER, abstol=0.0, reltol=0.0))
    peak = torch.cuda.max_memory_allocated() - base
    steps = glm_core.host_reads["newton_steps"]
    cos = float(torch.dot(z, w_true) / (torch.linalg.norm(z)
                                        * torch.linalg.norm(w_true)))
    Xh, yh, _ = block_fn(B)  # a 41st block, never fitted
    acc = float(((Xh @ z > 0).float() == yh).float().mean())
    acc_true = float(((Xh @ w_true > 0).float() == yh).float().mean())
    del Xh, yh
    out = {"n": n, "d": d, "blocks": B,
           "s_per_outer_iter": sec / n_iter,
           "ms_per_block": sec * 1e3 / (n_iter * B),
           "newton_steps": steps, "ms_per_newton_step": sec * 1e3 / steps,
           "block_generation_ms": gen_ms, "peak_memory_bytes": peak,
           "cos_z_w_true": cos, "heldout_accuracy": acc,
           "heldout_accuracy_w_true": acc_true,
           "effective_gbps": n * (d + 2) * 4 * n_iter / sec / 1e9}
    path_line("admm-streamed-blueprint", sec, n_iter, launches, **out)
    expect(n_iter == BP_ADMM_OUTER and bool(torch.isfinite(z).all()),
           f"blueprint ADMM: n_iter {n_iter}")
    expect(cos >= BP_COS, f"blueprint ADMM: cos(z, w_true) {cos}")
    expect(abs(acc - acc_true) <= BP_ACC_TOL,
           f"blueprint ADMM: held-out accuracy {acc} against w_true's "
           f"{acc_true}")
    expect(peak < 3 * rows * d * 4,
           f"blueprint ADMM held {peak} bytes: more than one block")
    return dict(out, n_iter=n_iter)


def stream_admm_host(dev, X, y, tmp):
    """The dense ADMM cell's arrays streamed from the host in 8 blocks:
    prefetch 2 against 0, the callable mode, the in-memory admm, a
    preemption and its resume, injected faults under a RetryPolicy, and
    the facade's ``fit_blocks`` preempted and resumed."""
    import torch

    from dask_ml_tpu_torch import checkpoint as ckpt
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel.faults import (FaultInjector, Preempted,
                                                   RetryPolicy)
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    base = torch.cuda.memory_allocated()
    n, d = X.shape
    B = HOST_BLOCKS
    w = np.ones(n, np.float32)
    kw = dict(family="logistic", regularizer="l2", lamduh=1.0, abstol=0.0,
              reltol=0.0, max_iter=HOST_OUTER, return_state=True)
    t0 = time.perf_counter()
    src2 = HostBlockSource((X, y, w), B, prefetch=2)
    register_s = time.perf_counter() - t0
    src0 = HostBlockSource((X, y, w), B, prefetch=0)
    out = {"n": n, "d": d, "blocks": B, "outer": HOST_OUTER,
           "register_s": register_s, **h2d_rates(dev)}

    def run(src, **extra):
        src.reset_stats()
        return glm_core.admm_streamed(src, B, d, float(n), **dict(kw,
                                                                  **extra))

    run(src2, max_iter=1)  # handles, allocator, first copies
    times = {2: [], 0: []}
    states = {}
    launches = None
    for depth in (2, 0, 0, 2):  # in turns, within this call
        src = src2 if depth == 2 else src0
        (_, n_iter, st, _), sec, launches = drive(lambda: run(src))
        times[depth].append(sec)
        states.setdefault(depth, []).append(st)
        out[f"bytes_prefetch{depth}"] = src.bytes_streamed
    t2, t0_ = min(times[2]), min(times[0])
    nbytes = out["bytes_prefetch2"]
    out.update(seconds_prefetch2=times[2], seconds_prefetch0=times[0],
               gbps_prefetch2=nbytes / t2 / 1e9,
               gbps_prefetch0=nbytes / t0_ / 1e9,
               overlap_speedup=t0_ / t2)
    ref = states[2][0]
    expect(all(states_equal(ref, st) for st in states[2] + states[0]),
           "host-streamed ADMM: prefetch 2 and prefetch 0 differ")
    expect(t2 <= t0_, f"prefetch 2 ({t2} s) slower than prefetch 0 "
           f"({t0_} s)")
    expect(out["bytes_prefetch0"] == nbytes == HOST_OUTER * (X.nbytes
                                                             + y.nbytes
                                                             + w.nbytes),
           f"bytes streamed {out['bytes_prefetch0']} / {nbytes}")
    # one block's copy from the registered arrays, alone
    blk_bytes = nbytes // (HOST_OUTER * B)
    out["registered_block_copy_gbps"] = blk_bytes / (cuda_ms(
        lambda: src2.take(3), iters=4, warmup=1) / 1e3) / 1e9
    out["profile_epoch_prefetch2"] = prof = device_profile(
        lambda: run(src2, max_iter=1))
    log("PROFILE admm-streamed-host-epoch " + json.dumps(prof))

    # the callable mode over the same rows resident on the card, and the
    # in-memory admm over them as 8 row blocks
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    wd = torch.ones(n, device=dev)
    rows = n // B

    def block_fn(b):
        s = slice(b * rows, (b + 1) * rows)
        return Xd[s].clone(), yd[s].clone(), wd[s].clone()

    _, n_c, st_c, _ = glm_core.admm_streamed(block_fn, B, d, float(n), **kw)
    _, n_m, st_m, _ = glm_core.admm(Xd, yd, wd, torch.zeros(d, device=dev),
                                    torch.ones(d, device=dev), n_shards=B,
                                    **kw)
    del Xd, yd, wd
    torch.cuda.empty_cache()
    out["callable_equal"] = states_equal(ref, st_c)
    out["in_memory_rel"] = rel(ref[0], st_m[0])
    expect(out["callable_equal"] and n_c == HOST_OUTER,
           "host-streamed ADMM: the callable mode differs")
    expect(out["in_memory_rel"] <= STREAM_RTOL and n_m == HOST_OUTER,
           f"host-streamed ADMM against admm(n_shards={B}): "
           f"{out['in_memory_rel']}, n_iter {n_m}")

    # preemption at block 5 of epoch 1, then the resume
    path = f"{tmp}/admm-host.ckpt"
    ckpt.reset_io_counts()
    inj = FaultInjector().preempt_at(5, epoch=1)
    try:
        run(HostBlockSource((X, y, w), B, fault_injector=inj),
            checkpoint_path=path)
        raise Mismatch("the injected preemption did not stop the fit")
    except Preempted:
        pass
    import os

    expect(os.path.exists(path), "no snapshot after the preemption")
    _, n_r, st_r, _ = run(src2, checkpoint_path=path)
    io = dict(ckpt.io_counts)
    out["snapshot"] = {
        "saves": io["saves"], "save_s": io["save_seconds"] / io["saves"],
        "save_bytes": io["save_bytes"] / io["saves"],
        "load_s": io["load_seconds"] / max(io["loads"], 1),
        "load_bytes": io["load_bytes"] / max(io["loads"], 1)}
    expect(states_equal(ref, st_r) and n_r == HOST_OUTER,
           "host-streamed ADMM: the resumed state differs")
    expect(not os.path.exists(path), "the snapshot was not deleted")

    # injected read and copy faults under a retry policy
    pol = RetryPolicy(max_retries=3)
    inj = FaultInjector().fail_load(2, times=2).fail_transfer(6)
    src_f = HostBlockSource((X, y, w), B, retry_policy=pol,
                            fault_injector=inj)
    _, _, st_f, _ = run(src_f)
    out["retries"] = pol.stats()
    expect(states_equal(ref, st_f) and pol.giveups == 0
           and pol.retries == 3 and src_f.bytes_streamed == nbytes,
           f"faults under RetryPolicy: {pol.stats()}, bytes "
           f"{src_f.bytes_streamed}")

    # the facade: fit_blocks preempted, resumed, against an uninterrupted
    # fit_blocks
    skw = {"abstol": 0.0, "reltol": 0.0}
    clean = LogisticRegression(solver="admm", max_iter=HOST_OUTER,
                               solver_kwargs=skw)
    (_, sec_f, _) = drive(lambda: clean.fit_blocks(src2, B, n, d))
    prefix = f"{tmp}/facade"
    inj = FaultInjector().preempt_at(5, epoch=1)
    try:
        LogisticRegression(solver="admm", max_iter=HOST_OUTER,
                           solver_kwargs=skw, checkpoint=prefix,
                           checkpoint_every=B).fit_blocks(
            HostBlockSource((X, y, w), B, fault_injector=inj), B, n, d)
        raise Mismatch("the injected preemption did not stop fit_blocks")
    except Preempted:
        pass
    resumed = LogisticRegression(solver="admm", max_iter=HOST_OUTER,
                                 solver_kwargs=skw, checkpoint=prefix,
                                 checkpoint_every=B).fit_blocks(src2, B, n,
                                                                d)
    out["fit_blocks_s"] = sec_f
    expect(np.array_equal(resumed.coef_, clean.coef_)
           and resumed.intercept_ == clean.intercept_
           and resumed.n_iter_ == clean.n_iter_,
           "fit_blocks: the resumed coefficients differ")
    src2.close()
    src0.close()
    # the whole path's peak above what was resident before it, its
    # comparison runs included
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
    path_line("admm-streamed-host", t2, HOST_OUTER, launches, **out)
    log(f"host-streamed ADMM: {out['gbps_prefetch2']:.2f} GB/s at prefetch "
        f"2, {out['gbps_prefetch0']:.2f} at 0 (overlap "
        f"{out['overlap_speedup']:.3f}x); H2D one copy_ of 1 GB: pinned "
        f"{out['pinned_gbps']:.2f}, pageable {out['pageable_gbps']:.2f}, a "
        f"registered block {out['registered_block_copy_gbps']:.2f} GB/s")
    return out


def stream_admm_sparse(dev, Xs, y, tmp):
    """The sparse ADMM cell's container streamed in 4 blocks through
    ``fit_blocks`` with the intercept; against admm(n_shards=4); one outer
    iteration through the kernels against the plain one; four runs equal
    bit for bit, and a preemption resumed to the same bits."""
    import torch

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.linear_model.glm import (_intercept_block,
                                                    add_intercept)
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel.faults import FaultInjector, Preempted
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    base = torch.cuda.memory_allocated()
    n, d = Xs.shape
    B, iters = SPSTREAM_BLOCKS, SPADMM_ITERS
    w = np.ones(n, np.float32)
    src = HostBlockSource((Xs, y, w), B)
    skw = {"abstol": 0.0, "reltol": 0.0}
    glm_core.reset_host_reads()
    est, sec, launches = drive(lambda: LogisticRegression(
        solver="admm", max_iter=iters, solver_kwargs=skw).fit_blocks(
            src, B, n, d))
    expect_launches("admm-streamed-sparse", launches)
    data = prepare_data(Xs, y=y)
    Xi = add_intercept(data.X)
    mask = torch.ones(d + 1, device=dev)
    mask[-1] = 0.0
    kw = dict(lamduh=1.0, abstol=0.0, reltol=0.0, return_state=True)
    z_m, n_m, st_m, _ = glm_core.admm(Xi, data.y, data.weights,
                                      torch.zeros(d + 1, device=dev), mask,
                                      n_shards=B, max_iter=iters, **kw)
    coef = torch.as_tensor(est._coef, device=dev)
    out = {"n": n, "d": d, "k": Xs.k, "blocks": B,
           "newton_steps": glm_core.host_reads["newton_steps"],
           "in_memory_rel": rel(coef, z_m)}
    expect(est.n_iter_ == n_m == iters and out["in_memory_rel"]
           <= STREAM_RTOL, f"sparse streamed ADMM against admm: {out}")

    srci = src.with_transform(_intercept_block)

    def run(max_iter=iters, source=srci, **extra):
        return glm_core.admm_streamed(source, B, d + 1, float(n), mask,
                                      max_iter=max_iter, **kw, **extra)

    # one outer iteration from a shared state, kernels against plain
    _, _, st2, _ = glm_core.admm(Xi, data.y, data.weights,
                                 torch.zeros(d + 1, device=dev), mask,
                                 n_shards=B, max_iter=2, **kw)
    del Xi, data
    zk = run(1, state=st2, kernel="cuda")[0]
    zt = run(1, state=st2, kernel="torch")[0]
    out["kernel_vs_plain_step_rel"] = rel(zk, zt)
    expect(out["kernel_vs_plain_step_rel"] <= STREAM_RTOL,
           f"sparse streamed step: kernel vs plain {out}")

    # the run-to-run spread (0: the pullback adds fixed-point integers),
    # then a preemption and its resume, bit for bit
    runs = [run()[2] for _ in range(4)]
    spread = max(rel(a[0], b[0]) for i, a in enumerate(runs)
                 for b in runs[i + 1:])
    path = f"{tmp}/admm-sparse.ckpt"
    inj = FaultInjector().preempt_at(2, epoch=1)
    try:
        run(source=HostBlockSource((Xs, y, w), B, fault_injector=inj)
            .with_transform(_intercept_block), checkpoint_path=path)
        raise Mismatch("the injected preemption did not stop the fit")
    except Preempted:
        pass
    res = run(checkpoint_path=path)[2]
    dist = [rel(res[0], r[0]) for r in runs]
    out.update(run_to_run_spread=spread, resumed_vs_runs=dist)
    expect(spread == 0.0 and all(states_equal(r, runs[0]) for r in runs),
           f"sparse streamed ADMM: four runs differ (spread {spread})")
    expect(states_equal(res, runs[0]),
           f"sparse streamed ADMM: the resumed fit differs from the "
           f"uninterrupted one ({dist})")
    src.close()
    # the whole path's peak above what was resident before it, its
    # comparison runs included
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
    path_line("admm-streamed-sparse", sec, est.n_iter_, launches, **out)
    return launches, out


def stream_pca_blueprint(dev):
    """BASELINE config 2 at 1e7 × 1,000: 40 blocks of 250,000 rows made on
    the card (bench_pca_blueprint's recipe) through
    ``pca_fit_blocks(n_components=100)``."""
    import torch

    from dask_ml_tpu_torch.decomposition.streaming import pca_fit_blocks

    n, d, B = BP_PCA_N, BP_PCA_D, BP_PCA_BLOCKS
    rows = n // B
    scale = torch.linspace(3.0, 0.3, d, device=dev)

    def block_fn(b):
        g = torch.Generator(device=dev)
        g.manual_seed(block_seed(SEED + 1, b))
        X = torch.randn((rows, d), generator=g, device=dev).mul_(scale)
        return X.add_(1.0), torch.ones(rows, device=dev)

    Xb, wb = block_fn(0)
    gram_ms = cuda_ms(lambda: (Xb * wb[:, None]).T @ Xb, iters=5)
    cov = torch.cov(Xb[:20_000].T)
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(cov), iters=3, warmup=1)
    del Xb, wb, cov
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    est, sec, launches = drive(lambda: pca_fit_blocks(block_fn, B,
                                                      BP_PCA_K))
    peak = torch.cuda.max_memory_allocated() - base
    want = np.sort((np.linspace(3.0, 0.3, d) ** 2))[::-1][:BP_PCA_K]
    ev_rel = float(np.max(np.abs(est.explained_variance_ - want) / want))
    mean_err = float(np.max(np.abs(est.mean_ - 1.0)))
    gram_bound, _ = bound(rows * (d + 1) * 4 + d * d * 4, 2.0 * rows * d * d)
    out = {"n": n, "d": d, "blocks": B, "k": BP_PCA_K,
           "ms_per_block": sec * 1e3 / B, "gram_ms": gram_ms,
           "eigh_ms": eigh_ms,
           "gram_bound_ms": gram_bound, "peak_memory_bytes": peak,
           "explained_variance_rel_err": ev_rel, "mean_max_err": mean_err}
    path_line("pca-streamed-blueprint", sec, None, launches, **out)
    expect(ev_rel <= BP_EV_RTOL and mean_err <= BP_MEAN_TOL,
           f"blueprint PCA: variances {ev_rel}, mean {mean_err}")
    expect(peak < 3 * rows * d * 4,
           f"blueprint PCA held {peak} bytes: more than one block")
    return out


def stream_pca_host(dev, X, tmp):
    """The PCA cell's 500,000 × 1,000 streamed from the host in 8 blocks:
    moments against float64 ones, the fit against the in-memory PCA, and
    the moment pass preempted and resumed."""
    import torch

    from dask_ml_tpu_torch.decomposition import PCA
    from dask_ml_tpu_torch.decomposition.streaming import (pca_fit_blocks,
                                                           streamed_moments)
    from dask_ml_tpu_torch.parallel.faults import FaultInjector, Preempted
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    base = torch.cuda.memory_allocated()
    n, d = X.shape
    B = HOST_BLOCKS
    w = np.ones(n, np.float32)
    src = HostBlockSource((X, w), B)
    moments, sec, launches = drive(lambda: streamed_moments(
        block_fn=src, n_blocks=B))
    nbytes = src.bytes_streamed
    Xd = torch.from_numpy(X).to(dev).double()  # the yardstick, not a path
    want = (torch.tensor(float(n), dtype=torch.float64, device=dev),
            Xd.sum(0), Xd.T @ Xd)
    del Xd
    torch.cuda.empty_cache()
    m_rel = [rel(a.double(), b) for a, b in zip(moments, want)]
    est = pca_fit_blocks(src, B, PCA_K)
    mem = PCA(PCA_K, svd_solver="full").fit(X)
    top = PCA_RANK
    align = float(np.abs(np.sum(est.components_[:top]
                                * mem.components_[:top], axis=1)).min())
    ev = np.abs(est.explained_variance_ - mem.explained_variance_) \
        / mem.explained_variance_
    path = f"{tmp}/moments.ckpt"
    inj = FaultInjector().preempt_at(3)
    try:
        streamed_moments(block_fn=HostBlockSource((X, w), B,
                                                  fault_injector=inj),
                         n_blocks=B, checkpoint_path=path,
                         checkpoint_every=2)
        raise Mismatch("the injected preemption did not stop the pass")
    except Preempted:
        pass
    resumed = streamed_moments(block_fn=src, n_blocks=B,
                               checkpoint_path=path)
    out = {"n": n, "d": d, "blocks": B,
           "effective_gbps": nbytes / sec / 1e9,
           "moments_rel_vs_f64": m_rel, "top64_min_alignment": align,
           "top64_explained_variance_rel": float(ev[:top].max()),
           "all_explained_variance_rel": float(ev.max()),
           "resumed_equal": states_equal(moments, resumed)}
    src.close()
    # the whole path's peak above what was resident before it, its
    # comparison runs included
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
    path_line("pca-streamed-host", sec, None, launches, **out)
    expect(max(m_rel) <= MOMENT_RTOL, f"streamed moments vs float64 {m_rel}")
    expect(align >= ALIGN and out["top64_explained_variance_rel"] <= EV_RTOL,
           f"streamed PCA against in-memory PCA: {out}")
    expect(out["resumed_equal"], "streamed moments: the resume differs")
    return out


def stream_lloyd_resumable(dev, X, tmp):
    """The KDD-shaped cell through ``lloyd_bounded_resumable`` (tol 0, 20
    iterations, chunks of 7), interrupted in its second chunk and resumed,
    against the one-shot ``lloyd_loop_bounded``."""
    import os

    import torch

    from dask_ml_tpu_torch import checkpoint as ckpt
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.utils.validation import check_random_state

    base = torch.cuda.memory_allocated()
    data = prepare_data(X, device=dev)
    Xd, wd = data.X, data.weights
    c0 = core.k_init(Xd, wd, data.n, K, check_random_state(SEED, device=dev),
                     init="k-means||", oversampling_factor=2)
    one, sec_one, _ = drive(lambda: core.lloyd_loop_bounded(
        Xd, wd, c0, 0.0, max_iter=RESUME_ITERS))
    path = f"{tmp}/bounded.ckpt"

    def resumable():
        return core.lloyd_bounded_resumable(
            Xd, wd, c0, 0.0, max_iter=RESUME_ITERS, path=path,
            chunk_iters=RESUME_CHUNK)

    try:
        with interrupt_on(core, "_bounded_chunk", 2):
            resumable()
        raise Mismatch("the interrupt did not stop the loop")
    except Interrupt:
        pass
    expect(os.path.exists(path), "no snapshot after the first chunk")
    chunk_s = []
    orig = core._bounded_chunk

    def timed_chunk(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.current_stream().synchronize()
        chunk_s.append(time.perf_counter() - t0)
        return out

    ckpt.reset_io_counts()
    core._bounded_chunk = timed_chunk
    try:
        res, sec, launches = drive(resumable)
    finally:
        core._bounded_chunk = orig
    io = dict(ckpt.io_counts)
    same = (torch.equal(one[0], res[0]) and float(one[1]) == float(res[1])
            and one[2] == res[2] and float(one[3]) == float(res[3])
            and torch.equal(one[4], res[4])
            and torch.equal(one[5]["rows_skipped"], res[5]["rows_skipped"]))
    out = {"n": int(Xd.shape[0]), "d": int(Xd.shape[1]), "k": K,
           "max_iter": RESUME_ITERS, "chunk_iters": RESUME_CHUNK,
           "one_shot_s": sec_one, "chunk_s": chunk_s,
           "snapshot_save_s": io["save_seconds"] / max(io["saves"], 1),
           "snapshot_bytes": io["save_bytes"] / max(io["saves"], 1),
           "snapshot_load_s": io["load_seconds"] / max(io["loads"], 1),
           "rows_skipped": int(res[5]["rows_skipped"].sum()),
           "rows_skipped_after_resume": int(
               res[5]["rows_skipped"][RESUME_CHUNK:].sum()),
           "equal_to_one_shot": same}
    # the whole path's peak above what was resident before it, its
    # comparison runs included
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
    path_line("lloyd-bounded-resumable", sec, res[2], launches, **out)
    expect(same, "resumed bounded Lloyd differs from the one-shot loop")
    expect(out["rows_skipped_after_resume"] > 0,
           "the resumed loop skipped no rows: its bounds were lost")
    expect_launches("lloyd-bounded-resumable", launches)
    expect(launches["fused_argmin_min"] == 1,
           f"the resumed loop's final assignment: {launches}")
    expect(not os.path.exists(path), "the snapshot was not deleted")
    try:
        with interrupt_on(core, "_bounded_chunk", 2):
            resumable()
    except Interrupt:
        pass
    core.BOUNDED_CARRY_VERSION += 1
    try:
        resumable()
        raise Mismatch("a snapshot of another carry version was resumed")
    except ValueError:
        pass
    finally:
        core.BOUNDED_CARRY_VERSION -= 1
        os.unlink(path)
    return launches, out


def stream_glm_checkpoint(dev, X, y, tmp):
    """``LogisticRegression(solver="lbfgs", max_iter=6, checkpoint=...,
    checkpoint_every=2)`` on the dense ADMM cell's 1e7 × 100, interrupted
    after its second chunk's save and resumed, against the uninterrupted
    fit."""
    import torch

    from dask_ml_tpu_torch import checkpoint as ckpt
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    base = torch.cuda.memory_allocated()
    Xd = torch.from_numpy(X).to(dev)
    kw = dict(solver="lbfgs", max_iter=CKPT_LBFGS_ITERS, tol=1e-12)
    plain = LogisticRegression(**kw).fit(Xd, y)
    ck = dict(kw, checkpoint=f"{tmp}/lbfgs",
              checkpoint_every=CKPT_LBFGS_EVERY)
    try:
        with interrupt_on(ckpt, "save_pytree", 2, after=True):
            LogisticRegression(**ck).fit(Xd, y)
        raise Mismatch("the interrupt did not stop the fit")
    except Interrupt:
        pass
    ckpt.reset_io_counts()
    resumed, sec, launches = drive(lambda: LogisticRegression(**ck).fit(Xd,
                                                                        y))
    io = dict(ckpt.io_counts)
    same = (np.array_equal(resumed.coef_, plain.coef_)
            and resumed.intercept_ == plain.intercept_
            and resumed.n_iter_ == plain.n_iter_)
    out = {"equal_to_uninterrupted": same,
           "phases": resumed.fit_phase_seconds_, "snapshot": io}
    # the whole path's peak above what was resident before it, its
    # comparison runs included
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
    path_line("glm-checkpoint-lbfgs", sec, resumed.n_iter_, launches, **out)
    expect(same and resumed.n_iter_ == CKPT_LBFGS_ITERS,
           f"checkpointed L-BFGS: resumed differs ({out})")
    return out


def stream_cells(dev):
    """The STREAM phase: the seven paths of the streaming and fault tier,
    on the arrays the earlier cells drew (drawn here under
    ``--stream-only``). Returns the launches of the paths that run the
    repo's kernels and a summary."""
    import shutil
    import tempfile

    import torch

    from dask_ml_tpu_torch.datasets import make_sparse_classification

    t0 = time.perf_counter()
    Xa, ya = drawn("admm", lambda: admm_data(SEED))
    Xs, ys = drawn("sparse_admm", lambda: make_sparse_classification(
        SPADMM_N, SPADMM_D, SPADMM_DENSITY, random_state=0))
    Xp = drawn("pca", lambda: pca_data(SEED))
    Xk = drawn("kdd", lambda: kdd_data(KDD_N, KDD_D, SEED))
    log(f"STREAM host data ready in {time.perf_counter() - t0:.2f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    t0 = time.perf_counter()

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    try:
        fresh()
        out = {"admm_blueprint": stream_admm_blueprint(dev)}
        fresh()
        out["admm_host"] = stream_admm_host(dev, Xa, ya, tmp)
        fresh()
        sparse_launches, out["admm_sparse"] = stream_admm_sparse(
            dev, Xs, ys, tmp)
        fresh()
        out["pca_blueprint"] = stream_pca_blueprint(dev)
        fresh()
        out["pca_host"] = stream_pca_host(dev, Xp, tmp)
        fresh()
        lloyd_launches, out["lloyd_resumable"] = stream_lloyd_resumable(
            dev, Xk, tmp)
        fresh()
        out["glm_checkpoint"] = stream_glm_checkpoint(dev, Xa, ya, tmp)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log("STREAM " + json.dumps(out))
    return {"admm-streamed-sparse": sparse_launches,
            "lloyd-bounded-resumable": lloyd_launches}, out


# ---------------------------------------------------------------------------
# INCREMENTAL: streaming SGD, the wrappers and blockwise predict
# ---------------------------------------------------------------------------


def inc_data(seed: int):
    """BASELINE config 4's data: ``make_classification(INC_N, INC_D,
    n_informative=INC_D, scale=2.0)``'s recipe (bench.py
    bench_incremental) drawn with numpy, and INC_HOLDOUT more rows of the
    same model held out. Returns (X, y, X_held, y_held)."""
    n = INC_N + INC_HOLDOUT
    rng = np.random.default_rng([seed, 11])
    X = normal_f32((n, INC_D), [seed, 11])
    beta = (rng.random(INC_D, dtype=np.float32) - 1.0) * 2.0
    u = rng.random(n, dtype=np.float32)
    y = (u < 1.0 / (1.0 + np.exp(-(X @ beta)))).astype(np.int64)
    return X[:INC_N], y[:INC_N], X[INC_N:], y[INC_N:]


def blobs_data(seed: int):
    """The first path's blobs: N x D float32 around K uniform centers."""
    rng = np.random.default_rng(seed)
    true_centers = rng.uniform(-10, 10, (K, D)).astype(np.float32)
    y_true = rng.integers(0, K, N)
    X = true_centers[y_true] + rng.standard_normal((N, D), dtype=np.float32)
    return X, y_true


def coef_equal(a, b) -> bool:
    return np.array_equal(np.asarray(a._coef), np.asarray(b._coef))


def incremental_dense(dev):
    """``incremental-dense``: BASELINE config 4 at its published size through
    ``Incremental``, against ``wrappers.fit`` and a hand-written
    ``partial_fit`` loop (bit for bit), the chain alone on staged X under
    the sync debug mode "error" (no host read between blocks), and a
    held-out accuracy beside the batch L-BFGS fit's."""
    import torch

    from dask_ml_tpu_torch import wrappers
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models import glm as glm_core

    X, y, Xh, yh = drawn("inc", lambda: inc_data(SEED))
    kw = dict(C=INC_C, solver_kwargs={"eta0": INC_ETA0})
    n_blocks = -(-INC_N // INC_BLOCK)

    def incremental():
        return wrappers.Incremental(LogisticRegression(**kw),
                                    block_size=INC_BLOCK).fit(X, y)

    glm_core.reset_host_reads()
    inc, sec, launches = drive(incremental)
    reads = glm_core.host_reads["n"]
    expect(inc.n_iter_ == n_blocks, f"n_iter_ {inc.n_iter_} != {n_blocks}")
    expect(reads == 0, f"the chain made {reads} host reads")
    expect(np.isfinite(inc.coef_).all() and inc.coef_.shape == (INC_D,),
           "bad coefficients")
    _, warm_s, _ = drive(incremental)
    fitted, fit_s, _ = drive(lambda: wrappers.fit(
        LogisticRegression(**kw), X, y, block_size=INC_BLOCK))
    loop = LogisticRegression(**kw)
    for i in range(0, INC_N, INC_BLOCK):
        loop.partial_fit(X[i:i + INC_BLOCK], y[i:i + INC_BLOCK])
    expect(coef_equal(inc.estimator_, fitted)
           and coef_equal(inc.estimator_, loop),
           "Incremental, wrappers.fit and the partial_fit loop differ")
    # the chain alone, X staged first: nothing in it may wait for the card
    step, state, y_enc = LogisticRegression(**kw)._incremental_begin(X, y)
    Xd = torch.as_tensor(X, device=dev)
    yd = torch.as_tensor(y_enc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out = wrappers.incremental_scan(step, state, Xd, yd,
                                        block_size=INC_BLOCK)
        queued_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    expect(np.array_equal(out[0].cpu().numpy(), inc.estimator_._coef),
           "the chain on staged X differs from Incremental's")
    chain_ms = cuda_ms(lambda: wrappers.incremental_scan(
        step, state, Xd, yd, block_size=INC_BLOCK), iters=5, warmup=1)
    del Xd, yd, out
    acc = inc.score(Xh, yh)
    batch, batch_s, _ = drive(lambda: LogisticRegression(
        solver="lbfgs", C=INC_C).fit(X, y))
    acc_batch = batch.score(Xh, yh)
    out = {"n": INC_N, "d": INC_D, "block": INC_BLOCK, "blocks": n_blocks,
           "wall_s": sec, "warm_wall_s": warm_s, "rows_per_s": INC_N / sec,
           "warm_rows_per_s": INC_N / warm_s, "wrappers_fit_s": fit_s,
           "chain_on_staged_x_s": chain_s, "chain_queued_s": queued_s,
           "chain_ms": chain_ms, "step_ms": chain_ms / n_blocks,
           "host_reads": reads, "heldout_accuracy": acc,
           "batch_lbfgs_heldout_accuracy": acc_batch,
           "batch_lbfgs_s": batch_s, "batch_lbfgs_n_iter": batch.n_iter_}
    path_line("incremental-dense", sec, inc.n_iter_, launches, **out)
    return out


def incremental_sparse(dev):
    """``incremental-sparse``: the flagship container in blocks of
    INC_SPARSE_BLOCK rows through ``wrappers.fit`` (one ``partial_fit`` a
    block: K6 and the pullback once each); a second run, each block's
    staging and step timed apart, to the same bits; the last step through
    the kernels against the same step with the plain SpMV and a float64
    pullback, within INC_RTOL normwise. Returns (launches, the fitted
    estimator, summary)."""
    import torch

    from dask_ml_tpu_torch import wrappers
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.utils.validation import check_array

    Xs, ys = drawn("sparse_glm", sparse_glm_data)
    n_blocks = -(-GLM_N // INC_SPARSE_BLOCK)
    est, sec, launches = drive(lambda: wrappers.fit(
        LogisticRegression(solver="lbfgs"), Xs, ys,
        block_size=INC_SPARSE_BLOCK))
    expect_launches("incremental-sparse", launches)
    expect(launches["spmv"] == n_blocks and launches["spmv_pullback"]
           == n_blocks, f"not one K6 and one pullback a block: {launches}")
    expect(est.n_iter_ == n_blocks and np.isfinite(est.coef_).all(),
           f"sparse chain: n_iter_ {est.n_iter_}")
    # the same chain, partial_fit's body by hand, staging and step timed
    again = LogisticRegression(solver="lbfgs")
    _, apply_one = glm_core.get_stream_step(**again._sgd_config())
    stage_s, step_s = [], []
    for i in range(0, GLM_N, INC_SPARSE_BLOCK):
        t0 = time.perf_counter()
        Xb = check_array(Xs[i:i + INC_SPARSE_BLOCK], accept_sparse=True)
        y_enc = again._encode_y_partial(ys[i:i + INC_SPARSE_BLOCK])
        state = again._pf_state_device(int(Xb.shape[1]))
        data = prepare_data(Xb, y=y_enc, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new = apply_one(state, data.X, data.y, data.weights)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        stage_s.append(t1 - t0)
        again._store_pf_state(new)
    expect(coef_equal(est, again),
           "two runs of the sparse chain give other coefficients")
    # the last step: kernels against the plain SpMV and a float64 pullback
    cfg = again._sgd_config()
    cfg.pop("n_classes", None)
    got = glm_core.make_sgd_step(**cfg, kernel="cuda")(
        state, (data.X, data.y, data.weights))[0]
    with plain_pullback_in_f64():
        want = glm_core.make_sgd_step(**cfg, kernel="torch")(
            state, (data.X, data.y, data.weights))[0]
    step_rel = rel(got, want)
    expect(step_rel <= INC_RTOL, f"sparse step: kernels {step_rel} "
           f"normwise from the plain float64-pullback step")
    out = {"n": GLM_N, "d": GLM_D, "k": Xs.k, "block": INC_SPARSE_BLOCK,
           "blocks": n_blocks, "wall_s": sec, "rows_per_s": GLM_N / sec,
           "stage_s_per_block": float(np.mean(stage_s)),
           "step_s_per_block": float(np.mean(step_s)),
           "stage_s": stage_s, "step_s": step_s,
           "kernel_vs_plain_f64_step_rel": step_rel}
    path_line("incremental-sparse", sec, est.n_iter_, launches, **out)
    return launches, est, out


def incremental_multinomial(dev):
    """``incremental-multinomial``: softmax streaming, K = INC_MN_K classes
    on the first INC_MN_N rows of config 4's X, ten ``partial_fit`` blocks
    with ``classes=`` given; a second chain gives the same bits."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    X, _, Xh, _ = drawn("inc", lambda: inc_data(SEED))
    rng = np.random.default_rng([SEED, 13])
    B = rng.standard_normal((INC_D, INC_MN_K)).astype(np.float32) * 0.3
    y = softmax_labels(X[:INC_MN_N], B, rng)
    yh = softmax_labels(Xh, B, rng)
    classes = np.arange(INC_MN_K)
    block = INC_MN_N // 10

    def chain():
        est = LogisticRegression(multiclass="multinomial",
                                 solver_kwargs={"eta0": INC_ETA0})
        for i in range(0, INC_MN_N, block):
            est.partial_fit(X[i:i + block], y[i:i + block], classes=classes)
        return est

    est, sec, launches = drive(chain)
    expect(coef_equal(est, chain()),
           "two softmax partial_fit chains give other coefficients")
    expect(est.coef_.shape == (INC_MN_K, INC_D)
           and np.isfinite(est.coef_).all() and np.isfinite(
               est.intercept_).all(), "bad softmax coefficients")
    expect(np.array_equal(est.classes_, classes) and est.n_iter_ == 10,
           f"classes_ {est.classes_}, n_iter_ {est.n_iter_}")
    out = {"n": INC_MN_N, "k": INC_MN_K, "blocks": 10, "wall_s": sec,
           "heldout_accuracy": est.score(Xh, yh)}
    path_line("incremental-multinomial", sec, est.n_iter_, launches, **out)
    return out


def batched_epoch(dev):
    """``batched-sgd-epoch``: INC_MEMBERS hyperparameter members through
    one epoch of config 4's blocks in one batched program, each member
    within BATCHED_RTOL (relative, normwise) of its own single-member
    epoch."""
    import torch

    from dask_ml_tpu_torch.models import glm as glm_core

    X, y, _, _ = drawn("inc", lambda: inc_data(SEED))
    n_blocks = INC_N // INC_BLOCK
    Xd = torch.as_tensor(X, device=dev)
    Xb = torch.cat([Xd, Xd.new_ones((INC_N, 1))], 1).view(
        n_blocks, INC_BLOCK, INC_D + 1)
    del Xd
    yb = torch.as_tensor(y, dtype=torch.float32, device=dev).view(
        n_blocks, INC_BLOCK)
    wb = torch.ones_like(yb)
    M = INC_MEMBERS
    f32 = dict(dtype=torch.float32, device=dev)
    lam = torch.logspace(-4, 0, M, **f32)
    eta0 = torch.linspace(0.05, 0.5, M, **f32)
    power_t = torch.tensor([0.25, 0.5] * (M // 2), **f32)
    live = torch.ones(M, dtype=torch.bool, device=dev)
    order = np.random.default_rng([SEED, 17]).permutation(n_blocks)
    betas0 = torch.zeros((M, INC_D + 1), **f32)
    ts0 = torch.zeros(M, **f32)
    epoch = glm_core.get_batched_sgd_epoch("logistic", "l2", True)

    def run():
        return epoch(betas0, ts0, lam, eta0, power_t, live, Xb, yb, wb,
                     order)

    (betas, ts), sec, launches = drive(run)
    expect(bool((ts == n_blocks).all()) and bool(torch.isfinite(
        betas).all()), "batched epoch: bad state")
    gaps = []
    for m in range(M):
        one = epoch(betas0[m:m + 1], ts0[m:m + 1], lam[m:m + 1],
                    eta0[m:m + 1], power_t[m:m + 1], live[m:m + 1], Xb, yb,
                    wb, order)[0][0]
        gaps.append(rel(betas[m], one))
    expect(max(gaps) <= BATCHED_RTOL, f"batched members against their own "
           f"chains: {gaps}")
    epoch_ms = cuda_ms(run, iters=3, warmup=1)
    out = {"members": M, "blocks": n_blocks, "block": INC_BLOCK,
           "epoch_ms": epoch_ms, "member_vs_own_chain_rel": gaps}
    path_line("batched-sgd-epoch", sec, n_blocks, launches, **out)
    del Xb, yb, wb
    return out


def parallel_post_fit(dev, sparse_est):
    """``parallel-post-fit``: ``ParallelPostFit.predict`` of a fitted KMeans
    on the blobs (K2) and of the sparse chain's GLM on GLM_SCORE_N rows
    (K6): labels equal to the estimator's own ``predict``, rows a second.
    Returns launches by path and a summary."""
    from dask_ml_tpu_torch import wrappers
    from dask_ml_tpu_torch.cluster import KMeans

    Xb, _ = drawn("blobs", lambda: blobs_data(SEED))
    km = KMeans(n_clusters=K, init="k-means||", oversampling_factor=2,
                random_state=SEED).fit(Xb)
    ppf = wrappers.ParallelPostFit(km)
    ppf.predict(Xb)  # warm
    labels, sec_k, l_k = drive(lambda: ppf.predict(Xb))
    expect_launches("parallel-post-fit-kmeans", l_k)
    expect(np.array_equal(labels, km.predict(Xb)),
           "ParallelPostFit(KMeans).predict differs from KMeans.predict")
    Xs, _ = drawn("sparse_glm", sparse_glm_data)
    Xq = Xs[:GLM_SCORE_N]
    ppf = wrappers.ParallelPostFit(sparse_est)
    ppf.predict(Xq)  # warm
    labels, sec_g, l_g = drive(lambda: ppf.predict(Xq))
    expect_launches("parallel-post-fit-glm", l_g)
    expect(np.array_equal(labels, sparse_est.predict(Xq)),
           "ParallelPostFit(GLM).predict differs from its predict")
    out = {"kmeans": {"n": N, "d": D, "s": sec_k, "rows_per_s": N / sec_k},
           "sparse_glm": {"n": GLM_SCORE_N, "d": GLM_D, "s": sec_g,
                          "rows_per_s": GLM_SCORE_N / sec_g}}
    path_line("parallel-post-fit-kmeans", sec_k, None, l_k, **out["kmeans"])
    path_line("parallel-post-fit-glm", sec_g, None, l_g, **out["sparse_glm"])
    return {"parallel-post-fit-kmeans": l_k, "parallel-post-fit-glm": l_g}, out


def incremental_cells(dev):
    """The INCREMENTAL phase. Returns the launches of the paths that run
    the repo's kernels and a summary."""
    import torch

    t0 = time.perf_counter()
    out = {"dense": incremental_dense(dev)}
    torch.cuda.empty_cache()
    sparse_launches, est, out["sparse"] = incremental_sparse(dev)
    torch.cuda.empty_cache()
    out["multinomial"] = incremental_multinomial(dev)
    torch.cuda.empty_cache()
    out["batched_epoch"] = batched_epoch(dev)
    torch.cuda.empty_cache()
    launches, out["parallel_post_fit"] = parallel_post_fit(dev, est)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("INCREMENTAL " + json.dumps(out))
    return {"incremental-sparse": sparse_launches, **launches}, out


# ---------------------------------------------------------------------------
# the search tier (SEARCH)
# ---------------------------------------------------------------------------


def search_data(seed: int):
    """BASELINE config 5's data, as bench.py draws it."""
    rng = np.random.RandomState(seed)
    return (rng.randn(SEARCH_N, SEARCH_D)
            @ np.diag(np.linspace(2, 0.5, SEARCH_D))).astype(np.float32)


def make_search_pipe():
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.decomposition import PCA
    from dask_ml_tpu_torch.pipeline import Pipeline
    from dask_ml_tpu_torch.preprocessing import StandardScaler

    return Pipeline([
        ("scale", StandardScaler()),
        ("pca", PCA(random_state=SEED)),
        ("km", KMeans(init="random", max_iter=SEARCH_MAX_ITER,
                      random_state=SEED)),
    ])


def host_syncs(fn):
    """``fn()`` under the sync debug mode "warn": returns (its result, the
    number of synchronizing CUDA calls it made, from every thread)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchronizing" in str(w.message) for w in caught)
    return out, n


def group_without_syncs(est, Xt, Xe, members):
    """One batched group's fit+score (``est._batched_fit_score``) on
    trusted device inputs under the sync debug mode "error": any host
    read inside the group raises."""
    import torch

    from dask_ml_tpu_torch.parallel.sharding import staging_memo

    with staging_memo() as memo:
        memo.trust(Xt)
        memo.trust(Xe)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = est._batched_fit_score(Xt, None, members, [(Xe, None)])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out


def search_plain_checks(dev, X, splits, errs):
    """K1 and K2 held to their plain versions at the shapes config 5 gives
    them. For each PCA width, split 0's train and test sets are staged
    through the pipeline's prefix (10,000 × d), and the init rows are the
    group's own draw. Every step of every trajectory (k = 2..11) is held
    to the plain Lloyd step from the same centers (``check_lloyd``), and
    the scoring at each trajectory's last centers to its plain version
    (``check_fused``). Then the whole group through K1 and K2 and through
    its plain version give every member the same n_iter. The eval
    inertias of the two groups are recorded, not gated: a near-tie label
    flip at one step moves the later centers of that trajectory. Updates
    ``errs``; returns a summary."""
    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.utils.validation import check_random_state

    tr, te = splits[0]
    Xd = torch.as_tensor(X, device=dev)
    ks = SEARCH_GRID["km__n_clusters"]
    pairs = [(k, t) for k in ks for t in SEARCH_GRID["km__tol"]]
    out = {"steps_checked": 0, "eval_max_rel_gap": 0.0, "widths": []}
    for width in SEARCH_GRID["pca__n_components"]:
        with config_context(device_outputs=True):
            prefix = make_search_pipe()[:2].set_params(
                pca__n_components=width)
            Xt = prefix.fit_transform(Xd[torch.as_tensor(tr, device=dev)])
            Xe = prefix.transform(Xd[torch.as_tensor(te, device=dev)])
        data = prepare_data(Xt, device=dev)
        ev = prepare_data(Xe, device=dev)
        gen = check_random_state(SEED, device=dev)
        idx0 = torch.randperm(data.n, generator=gen, device=dev)[:max(ks)]
        for k in ks:
            C = torch.index_select(data.X, 0, torch.sort(idx0[:k]).values)
            for t in range(SEARCH_MAX_ITER):
                e = check_lloyd(f"search d={width} k={k} step {t}", data.X,
                                data.weights, C, exact=False)
                errs["lloyd_iter"] = max(errs.get("lloyd_iter", 0.0), e)
                sums, counts, _ = core._lloyd_stats_cuda(data.X,
                                                         data.weights, C)
                C = core._new_centers(sums, counts, C)
                out["steps_checked"] += 1
            for name, e in check_fused(f"search eval d={width} k={k}", ev.X,
                                       C, w=ev.weights, exact=False).items():
                errs[name] = max(errs.get(name, 0.0), e)
        n_k, _, (ev_k,) = core.batched_lloyd_cells(
            data, pairs, [ev], max_iter=SEARCH_MAX_ITER, idx0=idx0,
            kernel="cuda")
        n_p, _, (ev_p,) = core.batched_lloyd_cells(
            data, pairs, [ev], max_iter=SEARCH_MAX_ITER, idx0=idx0,
            kernel="torch")
        expect(torch.equal(n_k, n_p), f"search d={width}: the group's n_iter "
               f"through K1/K2 {n_k.tolist()} and through the plain version "
               f"{n_p.tolist()}")
        gap = float(((ev_k - ev_p).abs() / ev_p.abs()).max())
        out["eval_max_rel_gap"] = max(out["eval_max_rel_gap"], gap)
        out["widths"].append({"d": width, "n_train": data.n, "n_eval": ev.n,
                              "eval_max_rel_gap": gap})
    return out


def search_pipeline(dev, errs):
    """``search-pipeline``: BASELINE config 5 through the port's
    ``GridSearchCV`` over its own ``Pipeline``. Gates: every cell took the
    batched path; K1 ran every trajectory step; one bulk fetch of the
    groups' scores and no other read of them; sampled members equal
    per-cell fits (n_iter exactly, score within SEARCH_RTOL); one group
    replayed under the sync debug mode "error" with the search's scores;
    K1 and K2 held to their plain versions at the path's own shapes
    (:func:`search_plain_checks`, which updates ``errs``). Returns
    (launches, summary)."""
    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.model_selection import GridSearchCV, KFold
    from dask_ml_tpu_torch.model_selection import _search

    X = drawn("search", lambda: search_data(SEED))

    def run():
        return GridSearchCV(make_search_pipe(), SEARCH_GRID, cv=SEARCH_CV,
                            refit=False, iid=False, return_train_score=False,
                            n_jobs=SEARCH_JOBS).fit(X)

    _search.reset_fetch_counts()
    gs, cold_s, launches = drive(run)
    fetches = dict(_search.fetch_counts)
    n_points = len(gs.cv_results_["params"])
    widths = len(SEARCH_GRID["pca__n_components"])
    uks = len(SEARCH_GRID["km__n_clusters"])
    expect(n_points == 500 and gs.n_batched_cells_ == n_points * SEARCH_CV,
           f"n_batched_cells_ {gs.n_batched_cells_} of {n_points} points")
    want_k1 = widths * SEARCH_CV * uks * SEARCH_MAX_ITER
    expect(launches["lloyd_iter"] == want_k1,
           f"K1 ran {launches['lloyd_iter']} trajectory steps, not {want_k1}")
    expect(launches["fused_argmin_min"] >= n_points * SEARCH_CV,
           f"K2 scored {launches['fused_argmin_min']} members")
    expect(fetches == {"bulk": 1, "cell": 0},
           f"group outputs fetched as {fetches}, not in one bulk copy")
    scores = np.asarray(gs.cv_results_["mean_test_score"])
    expect(np.isfinite(scores).all() and (scores < 0).all(),
           "config 5: bad scores")
    warm = []
    for _ in range(2):
        _, sec, _ = drive(run)
        warm.append(sec)
    _, syncs = host_syncs(run)
    prof = device_profile(run)

    # sampled members, spread over the groups, against per-cell fits
    splits = list(KFold(SEARCH_CV).split(X))
    params = gs.cv_results_["params"]
    picks = np.linspace(0, n_points - 1, SEARCH_SAMPLED).astype(int)
    sampled = []
    for j, ci in enumerate(picks):
        si = j % SEARCH_CV
        tr, te = splits[si]
        pipe = make_search_pipe().set_params(**params[ci])
        pipe.fit(X[tr])
        sampled.append({"candidate": int(ci), "split": si,
                        "n_iter": int(pipe.named_steps["km"].n_iter_),
                        "score": float(pipe.score(X[te])),
                        "search_score": float(gs.cv_results_[
                            f"split{si}_test_score"][ci])})
    # each sampled member's group replayed: the prefix on the device, then
    # the group under the sync debug mode "error"
    Xd = torch.as_tensor(X, device=dev)
    for row in sampled:
        p = params[row["candidate"]]
        tr, te = splits[row["split"]]
        with config_context(device_outputs=True):
            prefix = make_search_pipe()[:2].set_params(
                pca__n_components=p["pca__n_components"])
            Xt = prefix.fit_transform(Xd[torch.as_tensor(tr, device=dev)])
            Xe = prefix.transform(Xd[torch.as_tensor(te, device=dev)])
        members = [{"n_clusters": q["km__n_clusters"], "tol": q["km__tol"]}
                   for q in params
                   if q["pca__n_components"] == p["pca__n_components"]]
        mi = members.index({"n_clusters": p["km__n_clusters"],
                            "tol": p["km__tol"]})
        out = group_without_syncs(make_search_pipe().named_steps["km"], Xt,
                                  Xe, members)
        row["group_n_iter"] = int(out["n_iter"][mi])
        row["group_score"] = float(out["scores"][0][mi])
        expect(row["group_n_iter"] == row["n_iter"],
               f"member {row['candidate']}: n_iter {row['group_n_iter']} "
               f"in its group, {row['n_iter']} per cell")
        for key in ("search_score", "group_score"):
            gap = abs(row[key] - row["score"]) / abs(row["score"])
            expect(gap <= SEARCH_RTOL, f"member {row['candidate']}: {key} "
                   f"{row[key]} against the per-cell {row['score']}")
    del Xd
    plain = search_plain_checks(dev, X, splits, errs)
    out = {"n": SEARCH_N, "d": SEARCH_D, "points": n_points,
           "cv": SEARCH_CV, "n_jobs": SEARCH_JOBS, "cold_s": cold_s,
           "warm_s": min(warm), "warm_runs_s": warm,
           "n_batched_cells": int(gs.n_batched_cells_),
           "n_shared_fits": int(gs.n_shared_fits_),
           "n_device_stagings": int(gs.n_device_stagings_),
           "k1_launches": int(launches["lloyd_iter"]),
           "host_syncs_per_sweep": syncs, "fetches": fetches,
           "device_profile": prof, "sampled": sampled,
           "plain_checks": plain,
           "best_mean_test_score": float(scores.max())}
    path_line("search-pipeline", cold_s, None, launches, **out)
    return launches, out


def sparse_rows_csr(Xs, n: int):
    """The first ``n`` rows of a host container as scipy CSR."""
    import scipy.sparse as scipy_sparse

    vals, cols = Xs.values[:n], Xs.cols[:n]
    rows = np.repeat(np.arange(n, dtype=np.int64), Xs.k)
    csr = scipy_sparse.coo_matrix(
        (vals.ravel(), (rows, cols.ravel().astype(np.int64))),
        shape=(n, Xs.d)).tocsr()
    csr.sum_duplicates()
    return csr


def search_sparse_glm(dev):
    """``search-sparse-glm``: the JAX package's sparse search, 3 C values
    × cv 2 over the first SEARCH_SPARSE_N rows of the sparse GLM cell's
    container as CSR. Gates: every cell batched; K6 and its backward ran;
    each member's coefficients equal a per-cell fit's bit for bit and its
    scores the search's; two searches give the same cv_results_ bit for
    bit. Returns (launches, summary)."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.model_selection import GridSearchCV, KFold

    Xs, ys = drawn("sparse_glm", sparse_glm_data)
    csr = sparse_rows_csr(Xs, SEARCH_SPARSE_N)
    y = ys[:SEARCH_SPARSE_N]

    def run():
        return GridSearchCV(
            LogisticRegression(solver="lbfgs", max_iter=GLM_ITERS),
            {"C": SEARCH_CS}, cv=2, refit=False, iid=False,
            return_train_score=False).fit(csr, y)

    gs, sec, launches = drive(run)
    expect(gs.n_batched_cells_ == 2 * len(SEARCH_CS),
           f"n_batched_cells_ {gs.n_batched_cells_}")
    expect(launches["spmv"] > 0 and launches["spmv_pullback"] > 0,
           f"the sparse search ran no K6 / pullback: {launches}")
    again, sec2, _ = drive(run)
    for key, v in gs.cv_results_.items():
        if "time" in key or key == "params":
            continue
        a, b = np.asarray(v), np.asarray(again.cv_results_[key])
        expect(np.array_equal(a, b), f"two sparse searches differ at {key}")
    members = [{"C": c} for c in SEARCH_CS]
    coef_equal_all, gaps = True, []
    for si, (tr, te) in enumerate(KFold(2).split(csr)):
        Xtr, Xte = csr[tr], csr[te]
        group = LogisticRegression(
            solver="lbfgs", max_iter=GLM_ITERS)._batched_fit_score(
                Xtr, y[tr], members, [(Xte, y[te])])
        coefs = group["coef"].cpu().numpy()
        gscores = group["scores"][0].cpu().numpy()
        for mi, c in enumerate(SEARCH_CS):
            one = LogisticRegression(solver="lbfgs", max_iter=GLM_ITERS,
                                     C=c).fit(Xtr, y[tr])
            coef_equal_all &= bool(np.array_equal(coefs[mi], one._coef))
            search_score = gs.cv_results_[f"split{si}_test_score"][mi]
            expect(float(gscores[mi]) == float(search_score),
                   f"C={c}, split {si}: the group's score {gscores[mi]} is "
                   f"not the search's {search_score}")
            gaps.append(abs(float(one.score(Xte, y[te])) - search_score))
    expect(coef_equal_all, "a member's coefficients differ from a per-cell "
           "fit's")
    expect(max(gaps) <= SEARCH_RTOL, f"per-cell scores {gaps} from the "
           "search's")
    out = {"n": SEARCH_SPARSE_N, "d": int(Xs.d), "k": int(Xs.k),
           "points": len(SEARCH_CS), "cv": 2, "cold_s": sec, "again_s": sec2,
           "n_batched_cells": int(gs.n_batched_cells_),
           "n_device_stagings": int(gs.n_device_stagings_),
           "mean_test_score": [float(v) for v in
                               gs.cv_results_["mean_test_score"]],
           "per_cell_score_gaps": gaps}
    path_line("search-sparse-glm", sec, None, launches, **out)
    return launches, out


def sparse_softmax_bits(dev):
    """``glm-sparse-softmax``: ``multinomial_lbfgs`` on SOFTMAX_N rows of
    the sparse GLM cell's container with SOFTMAX_K classes, twice: the
    softmax gradient (``pullback_mat``, fixed point) repeats its bits, so
    the two fits are equal bit for bit."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops.sparse import SparseRows

    Xs, _ = drawn("sparse_glm", sparse_glm_data)
    A = SparseRows(Xs.values[:SOFTMAX_N], Xs.cols[:SOFTMAX_N], Xs.d)
    y = np.random.default_rng([SEED, 19]).integers(0, SOFTMAX_K, SOFTMAX_N)

    def fit():
        return LogisticRegression(multiclass="multinomial", solver="lbfgs",
                                  max_iter=GLM_ITERS).fit(A, y)

    first, sec, launches = drive(fit)
    second = fit()
    expect(first._coef.shape == (SOFTMAX_K, Xs.d + 1)
           and np.isfinite(first._coef).all(), "bad softmax coefficients")
    expect(coef_equal(first, second),
           "two sparse softmax fits give other coefficients")
    out = {"n": SOFTMAX_N, "k_classes": SOFTMAX_K, "d": int(Xs.d),
           "seconds": sec, "bit_for_bit_twice": True}
    path_line("glm-sparse-softmax", sec, first.n_iter_, launches, **out)
    return out


def pairwise_argmin_min(dev):
    """``pairwise-argmin-min``: ``metrics.pairwise_distances_argmin_min``
    (K2 and a sqrt) on config 5's X against 11 of its rows, held to the
    plain version: the same indices away from near ties, squared
    distances within ``close_values``' bound."""
    import torch

    from dask_ml_tpu_torch.metrics import pairwise_distances_argmin_min

    X = drawn("search", lambda: search_data(SEED))
    Xd = torch.as_tensor(X, device=dev)
    Y = Xd[:: SEARCH_N // 11][:11]
    (idx, dist), sec, launches = drive(
        lambda: pairwise_distances_argmin_min(Xd, Y))
    expect(launches["fused_argmin_min"] == 1, f"K2 launches {launches}")
    pidx, pdist = pairwise_distances_argmin_min(Xd, Y, kernel="torch")
    ties = near_tie_ok(Xd, Y, None, idx, pidx)
    err = close_values(dist * dist, pdist * pdist, Xd, Y, False,
                       "pairwise_distances_argmin_min (squared)")
    out = {"n": SEARCH_N, "m": 11, "d": SEARCH_D, "seconds": sec,
           "near_tie_mismatches": ties, "max_abs_err_sq": err}
    path_line("pairwise-argmin-min", sec, None, launches, **out)
    return launches, out


def search_cells(dev, errs):
    """The SEARCH phase. Returns the launches of its paths and a summary;
    its comparisons with the plain versions update ``errs``."""
    import torch

    t0 = time.perf_counter()
    launches, out = {}, {}
    launches["pairwise-argmin-min"], out["pairwise"] = pairwise_argmin_min(
        dev)
    launches["search-pipeline"], out["pipeline"] = search_pipeline(dev,
                                                                   errs)
    torch.cuda.empty_cache()
    launches["search-sparse-glm"], out["sparse_glm"] = search_sparse_glm(
        dev)
    torch.cuda.empty_cache()
    out["sparse_softmax"] = sparse_softmax_bits(dev)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("SEARCH " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# the successive-halving tier (ASHA)
# ---------------------------------------------------------------------------


def asha_problem():
    """The JAX drill's problem (bench.py ``_asha_problem``): 23 imbalanced
    clusters with a per-feature scale spread, labelled dominant cluster
    against the rest, from RandomState(99)."""
    rng = np.random.RandomState(99)
    n_clusters = 23
    centers = rng.randn(n_clusters, ASHA_D) * np.exp(rng.randn(1, ASHA_D))
    logits = -0.45 * np.arange(n_clusters)
    p = np.exp(logits) / np.exp(logits).sum()
    ids = rng.choice(n_clusters, size=ASHA_N, p=p)
    X = (centers[ids] + 0.3 * rng.randn(ASHA_N, ASHA_D)).astype(np.float32)
    return X, (ids == 0).astype(np.int64)


@contextlib.contextmanager
def rungs_without_host_reads(calls: list):
    """Every batched rung (``_incremental.batched_rung``) run under the
    sync debug mode "error": a host read inside a rung raises. Each rung
    appends to ``calls``."""
    import torch

    from dask_ml_tpu_torch.model_selection import _incremental as inc

    orig = inc.batched_rung

    def guarded(*a, **k):
        calls.append(1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    inc.batched_rung = guarded
    try:
        yield
    finally:
        inc.batched_rung = orig


def asha_drill(dev):
    """``asha-drill``: the JAX package's successive-halving drill at its own
    size. Gates: the synchronous reference's winner at ≤ 1/5 of its
    budget; the batched rungs equal to one ``partial_fit`` a block a
    candidate (scores atol 1e-6, the winner's coefficients rtol 1e-5); no
    kernel build after rung 0; no host read inside a rung; a journal cut
    mid-bracket resumes to the same scores and winner bit for bit."""
    import os
    import pickle
    import shutil
    import tempfile

    from dask_ml_tpu_torch.checkpoint import CellJournal
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.model_selection import SuccessiveHalvingSearchCV

    X, y = drawn("asha", asha_problem)

    def search(sync=False, **kw):
        return SuccessiveHalvingSearchCV(
            LogisticRegression(solver="gradient_descent"), ASHA_GRID,
            n_initial_parameters="grid",
            n_initial_epochs=ASHA_EPOCHS if sync else 1,
            aggressiveness=ASHA_ETA, max_epochs=ASHA_EPOCHS,
            n_blocks=ASHA_BLOCKS, random_state=0, shuffle_seed=0, **kw)

    rung_calls: list = []
    with rungs_without_host_reads(rung_calls):
        sh, cold_s, launches = drive(lambda: search().fit(X, y))
        _, warm_s, _ = drive(lambda: search().fit(X, y))
        ref, ref_s, _ = drive(lambda: search(sync=True).fit(X, y))
    expect(len(rung_calls) == 2 * len(sh.rung_table_) + 1,
           f"{len(rung_calls)} batched rungs for {len(sh.rung_table_)} "
           "rungs a search: a rung left the batched path")
    expect(sh.best_params_ == ref.best_params_,
           f"ASHA's winner {sh.best_params_} is not the synchronous "
           f"grid's {ref.best_params_}")
    expect(5 * sh.budget_spent_ <= ref.budget_spent_,
           f"budget {sh.budget_spent_} > 1/5 of {ref.budget_spent_}")
    late = [r for r in sh.rung_compile_stats_ if r["rung"] > 0]
    expect(all(r["n_builds"] == 0 for r in late),
           f"kernel builds after rung 0: {sh.rung_compile_stats_}")
    gen, gen_s, _ = drive(lambda: search(batched_rungs=False).fit(X, y))
    score_gap = float(np.abs(sh.cv_results_["test_score"]
                             - gen.cv_results_["test_score"]).max())
    coef_gap = float(np.abs(sh.best_estimator_.coef_
                            - gen.best_estimator_.coef_).max()
                     / np.abs(gen.best_estimator_.coef_).max())
    expect(score_gap <= ASHA_SCORE_ATOL,
           f"batched and generic rung scores differ by {score_gap}")
    expect(sh.best_params_ == gen.best_params_
           and coef_gap <= ASHA_COEF_RTOL,
           f"batched winner {sh.best_params_} against generic "
           f"{gen.best_params_}, coefficients {coef_gap} apart")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_asha_")
    try:
        ck = os.path.join(tmp, "asha.journal")
        full = search(checkpoint=ck).fit(X, y)
        records = list(CellJournal(ck).load().items())
        ck2 = os.path.join(tmp, "cut.journal")
        cut = CellJournal(ck2)
        for key, rec in records[:ASHA_RESUME_AT]:
            cut.append(key, rec)
        resumed, resume_s, _ = drive(
            lambda: search(checkpoint=ck2).fit(X, y))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    expect(resumed.n_resumed_rungs_ == ASHA_RESUME_AT,
           f"resumed {resumed.n_resumed_rungs_} of {ASHA_RESUME_AT}")
    expect(np.array_equal(full.cv_results_["test_score"],
                          resumed.cv_results_["test_score"])
           and np.array_equal(full.cv_results_["test_score"],
                              sh.cv_results_["test_score"])
           and full.best_params_ == resumed.best_params_
           and pickle.dumps(full.best_estimator_._pf_state)
           == pickle.dumps(resumed.best_estimator_._pf_state),
           "the resumed search differs from the uninterrupted one")
    out = {"n": ASHA_N, "d": ASHA_D, "candidates": len(sh.cv_results_[
        "params"]), "rung_table": sh.rung_table_, "cold_s": cold_s,
           "warm_s": warm_s, "sync_reference_s": ref_s,
           "generic_s": gen_s, "resume_s": resume_s,
           "budget_spent": sh.budget_spent_,
           "budget_sync_reference": ref.budget_spent_,
           "best_params": sh.best_params_, "best_score": sh.best_score_,
           "sync_best_score": ref.best_score_,
           "batched_vs_generic_score_gap": score_gap,
           "batched_vs_generic_coef_rel": coef_gap,
           "journal_records": len(records),
           "resumed_rungs": resumed.n_resumed_rungs_,
           "rung_builds": [r["n_builds"] for r in sh.rung_compile_stats_],
           "host_reads_in_rungs": 0}
    path_line("asha-drill", cold_s, len(sh.rung_table_), launches, **out)
    return out


def minibatch_hyperband(dev):
    """``minibatch-hyperband``: ``HyperbandSearchCV(MiniBatchKMeans(
    n_clusters=8))`` over init and its seed on the blobs, scoring the
    estimator's own ``score``. Gates: K2 in every rung; the winner's ARI
    against the true labels ≥ 0.99; a second search from the same seeds
    gives the same ``cv_results_`` bit for bit."""
    from dask_ml_tpu_torch.cluster import MiniBatchKMeans
    from dask_ml_tpu_torch.model_selection import HyperbandSearchCV

    X, y_true = drawn("blobs", lambda: blobs_data(SEED))

    def run():
        return HyperbandSearchCV(
            MiniBatchKMeans(n_clusters=K), HB_MB_GRID,
            max_epochs=HB_MB_EPOCHS, aggressiveness=HB_MB_ETA,
            n_blocks=HB_MB_BLOCKS, random_state=SEED).fit(X)

    hb, sec, launches = drive(run)
    expect_launches("minibatch-hyperband", launches)
    no_k2 = [(r["bracket"], r["rung"]) for r in hb.rung_compile_stats_
             if not r["launches"].get("fused_argmin_min")]
    expect(not no_k2, f"rungs without a K2 launch: {no_k2}")
    win_ari = ari(y_true, hb.best_estimator_.predict(X))
    expect(win_ari >= 0.99, f"the winner's ARI {win_ari} < 0.99")
    again, sec2, _ = drive(run)
    expect(all(np.array_equal(hb.cv_results_[k], again.cv_results_[k])
               for k in ("test_score", "rung_", "n_epochs_",
                         "partial_fit_calls"))
           and [h["score"] for h in hb.history_]
           == [h["score"] for h in again.history_],
           "two Hyperband searches from the same seeds differ")
    out = {"n": N, "d": D, "k": K, "blocks": HB_MB_BLOCKS,
           "brackets": [(b["bracket"], b["n_models"], b["r0"])
                        for b in hb.metadata_["brackets"]],
           "rungs": len(hb.rung_table_), "s": sec, "again_s": sec2,
           "best_params": hb.best_params_, "best_score": hb.best_score_,
           "winner_ari": win_ari, "budget_spent": hb.budget_spent_,
           "k2_per_rung": [r["launches"].get("fused_argmin_min", 0)
                           for r in hb.rung_compile_stats_]}
    path_line("minibatch-hyperband", sec, len(hb.rung_table_), launches,
              **out)
    return launches, out


def minibatch_fit_predict(dev, errs):
    """``minibatch``: ``MiniBatchKMeans(n_clusters=8).fit(X).predict(X)`` on
    the blobs. Gates: ARI ≥ 0.99; labels equal to the plain version's from
    the fitted centers; two fits bit for bit; K2 at a mini-batch's shape,
    and one Sculley update through it, against their plain versions.
    Prints steps a second and the device's busy share over the step
    loop."""
    import torch

    from dask_ml_tpu_torch.cluster import MiniBatchKMeans
    from dask_ml_tpu_torch.cluster import minibatch as mb_mod
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    X, y_true = drawn("blobs", lambda: blobs_data(SEED))

    def fit_predict():
        mb = MiniBatchKMeans(n_clusters=K, random_state=SEED).fit(X)
        return mb, mb.predict(X)

    (mb, pred), sec, launches = drive(fit_predict)
    expect_launches("minibatch", launches)
    expect(launches["fused_argmin_min"] >= mb.n_iter_,
           f"K2 launched {launches['fused_argmin_min']} times for "
           f"{mb.n_iter_} steps")
    score = ari(y_true, pred)
    expect(score >= 0.99, f"MiniBatchKMeans ARI {score} < 0.99")
    (mb2, pred2), sec2, _ = drive(fit_predict)
    expect(np.array_equal(mb.cluster_centers_, mb2.cluster_centers_)
           and np.array_equal(mb.counts_, mb2.counts_)
           and np.array_equal(pred, pred2),
           "two MiniBatchKMeans fits from one seed differ")
    data = prepare_data(X, device=dev)
    Xd, wd = data.X, data.weights
    C = torch.as_tensor(mb.cluster_centers_, device=dev)
    plain = core.predict_labels(Xd, C, kernel="torch").cpu().numpy()
    expect(np.array_equal(pred, plain),
           "kernel path and plain path label the data differently")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    bs = 1024
    idx = torch.randint(0, N, (mb.n_iter_, bs), generator=g, device=dev)
    e = check_fused("K2 a mini-batch", Xd[idx[0]], C, exact=False)
    errs["fused_argmin_min"] = max(errs.get("fused_argmin_min", 0.0),
                                   e["fused_argmin_min"])
    c0 = C.clone()
    v0 = torch.zeros(K, device=dev)
    got, want = (mb_mod._minibatch_update(Xd[idx[0]], wd[idx[0]], c0, v0,
                                          kernel=kn)
                 for kn in ("cuda", "torch"))
    expect(torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
           and torch.allclose(got[0], want[0], rtol=1e-6, atol=1e-6),
           "a Sculley update through K2 differs from the plain update")
    mb_mod._minibatch_steps(Xd, wd, c0, v0, idx[:100])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mb_mod._minibatch_steps(Xd, wd, c0, v0, idx)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    prof = device_profile(lambda: mb_mod._minibatch_steps(
        Xd, wd, c0, v0, idx[:MB_PROFILED_STEPS]))
    step_ms = cuda_ms(lambda: mb_mod._minibatch_update(
        Xd[idx[0]], wd[idx[0]], c0, v0), iters=200, warmup=10)
    del data, Xd, wd, idx
    out = {"n": N, "d": D, "k": K, "batch": bs, "steps": mb.n_iter_,
           "fit_predict_s": sec, "again_s": sec2, "ari": score,
           "inertia": mb.inertia_, "step_loop_s": loop_s,
           "steps_per_s": mb.n_iter_ / loop_s,
           "update_ms_cuda_events": step_ms,
           "busy_share": None if prof is None else prof["busy_share"],
           "device_profile": prof}
    path_line("minibatch", sec, mb.n_iter_, launches, **out)
    return launches, out


def hyperband_config4(dev):
    """``hyperband-config4``: ``HyperbandSearchCV(LogisticRegression())``
    over BASELINE config 4's data through the GLM's batched partial_fit
    rungs, max_epochs 27. Gates: every rung batched with no host read
    inside it; no kernel of the repo launched (the path is cuBLAS and
    PyTorch's own kernels). Prints brackets, rungs, seconds and the host
    syncs of a whole search (sync debug mode "warn")."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.model_selection import HyperbandSearchCV

    X, y, _, _ = drawn("inc", lambda: inc_data(SEED))

    def run():
        return HyperbandSearchCV(
            LogisticRegression(), HB_GLM_GRID, max_epochs=HB_GLM_EPOCHS,
            aggressiveness=HB_GLM_ETA, n_blocks=HB_GLM_BLOCKS,
            random_state=SEED).fit(X, y)

    calls: list = []
    with rungs_without_host_reads(calls):
        hb, sec, launches = drive(run)
    expect(len(calls) == len(hb.rung_table_),
           f"{len(calls)} batched rungs of {len(hb.rung_table_)}")
    expect(not any(launches.values()),
           f"config 4's Hyperband launched a kernel of the repo: {launches}")
    t0 = time.perf_counter()
    hb2, syncs = host_syncs(run)
    sec2 = time.perf_counter() - t0
    expect(np.array_equal(hb.cv_results_["test_score"],
                          hb2.cv_results_["test_score"]),
           "two config 4 Hyperband searches differ")
    out = {"n": INC_N, "d": INC_D, "blocks": HB_GLM_BLOCKS,
           "max_epochs": HB_GLM_EPOCHS,
           "brackets": [(b["bracket"], b["n_models"], b["r0"])
                        for b in hb.metadata_["brackets"]],
           "rungs": len(hb.rung_table_),
           "candidates": hb.metadata_["n_models"], "s": sec,
           "again_under_warn_s": sec2, "host_syncs_per_search": syncs,
           "host_reads_in_rungs": 0, "budget_spent": hb.budget_spent_,
           "budget_synchronous": hb.budget_synchronous_,
           "best_params": hb.best_params_, "best_score": hb.best_score_,
           "kernels_of_the_repo": "none expected: cuBLAS and PyTorch"}
    path_line("hyperband-config4", sec, len(hb.rung_table_), launches,
              **out)
    return out


def k_means_fn(dev):
    """``k-means-fn``: ``cluster.k_means(X, 8)`` on the blobs. Gates: the
    ``KMeans`` fit's centers, labels and inertia bit for bit;
    ``compute_inertia`` and ``evaluate_cost`` within rtol 1e-5 of
    ``inertia_``; ``init_scalable`` launches K3 and K4. Prints the
    k-means|| phases from ``measure_init_phases``."""
    from dask_ml_tpu_torch import cluster
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    X, _ = drawn("blobs", lambda: blobs_data(SEED))
    res, sec, launches = drive(lambda: cluster.k_means(
        X, K, random_state=SEED, return_n_iter=True))
    expect_launches("k-means-fn", launches)
    km = cluster.KMeans(n_clusters=K, random_state=SEED).fit(X)
    expect(np.array_equal(res[0], km.cluster_centers_)
           and np.array_equal(res[1], km.labels_)
           and res[2] == km.inertia_ and res[3] == km.n_iter_,
           "k_means differs from KMeans(random_state=same).fit(X)")
    ci = cluster.compute_inertia(X, km.labels_, km.cluster_centers_)
    ec = cluster.evaluate_cost(X, km.cluster_centers_)
    for name, v in (("compute_inertia", ci), ("evaluate_cost", ec)):
        expect(abs(v - km.inertia_) <= 1e-5 * abs(km.inertia_),
               f"{name} {v} against inertia_ {km.inertia_}")
    c, init_s, l_init = drive(lambda: cluster.init_scalable(
        X, K, random_state=SEED))
    expect_launches("init-scalable", l_init)
    expect(c.shape == (K, D) and np.isfinite(c).all(), "init_scalable")
    data = prepare_data(X, device=dev)
    phases = init_phase_seconds(data.X, data.weights)
    del data
    log("INIT_PHASES k-means-fn " + json.dumps(phases))
    out = {"n": N, "d": D, "k": K, "s": sec, "inertia": float(res[2]), "compute_inertia": ci,
           "evaluate_cost": ec, "init_scalable_s": init_s,
           "init_scalable_launches": l_init, "init_phases": phases}
    path_line("k-means-fn", sec, int(res[3]), launches, **out)
    return {"k-means-fn": launches, "init-scalable": l_init}, out


def gaussian_nb_cell(dev):
    """``gaussian-nb``: ``GaussianNB().fit(X, y).predict(X)`` on config 4's
    data. Gates: ``theta_`` and ``var_`` within NB_RTOL of a float64 fit
    on the host (plus NB_RTOL of each feature's standard deviation: f32
    moments over 2e6 rows); labels equal to the float64 fit's wherever its
    two classes' log-likelihoods differ by more than NB_MARGIN."""
    from dask_ml_tpu_torch.naive_bayes import GaussianNB

    X, y, _, _ = drawn("inc", lambda: inc_data(SEED))

    def fit_predict():
        nb = GaussianNB().fit(X, y)
        return nb, nb.predict(X)

    (nb, pred), sec, launches = drive(fit_predict)
    classes = np.unique(y)
    theta = np.stack([X[y == c].mean(0, dtype=np.float64) for c in classes])
    var = np.stack([X[y == c].var(0, dtype=np.float64) for c in classes])
    eps = 1e-9 * X.var(0, dtype=np.float64).max()
    var = var + eps
    prior = np.array([(y == c).mean() for c in classes])
    std = np.sqrt(var)
    th_err = float((np.abs(nb.theta_ - theta) / (np.abs(theta) + std)).max())
    var_err = float((np.abs(nb.var_ - var) / var).max())
    expect(th_err <= NB_RTOL and var_err <= NB_RTOL,
           f"GaussianNB moments off the float64 fit: theta {th_err}, "
           f"var {var_err}")
    jll = np.empty((len(X), len(classes)))
    for j in range(len(classes)):
        for lo in range(0, len(X), 250_000):
            xb = X[lo:lo + 250_000].astype(np.float64)
            jll[lo:lo + 250_000, j] = (
                np.log(prior[j]) - 0.5 * np.sum(np.log(2 * np.pi * var[j]))
                - 0.5 * np.sum((xb - theta[j]) ** 2 / var[j], axis=1))
    want = classes[np.argmax(jll, axis=1)]
    top2 = np.sort(jll, axis=1)
    clear = (top2[:, -1] - top2[:, -2]) > NB_MARGIN
    differ = int((pred[clear] != want[clear]).sum())
    expect(differ == 0, f"{differ} clear-margin labels differ from the "
           "float64 fit")
    out = {"n": INC_N, "d": INC_D, "fit_predict_s": sec,
           "theta_err": th_err, "var_err": var_err,
           "labels_within_margin": int((~clear).sum()),
           "labels_differ_within_margin": int(
               (pred[~clear] != want[~clear]).sum()),
           "accuracy": float((pred == y).mean())}
    path_line("gaussian-nb", sec, None, launches, **out)
    return out


def generators_cell(dev):
    """``generators``: ``make_blobs`` and ``make_classification`` at
    1,000,000 × 50 on the card, the same seed twice to the same bits."""
    import torch

    from dask_ml_tpu_torch import datasets

    out = {}
    for name, make in (
            ("make_blobs", lambda: datasets.make_blobs(
                GEN_N, GEN_D, centers=K, random_state=SEED)),
            ("make_classification", lambda: datasets.make_classification(
                GEN_N, GEN_D, n_informative=GEN_D, random_state=SEED))):
        a, sec, _ = drive(make)
        b, sec2, _ = drive(make)
        expect(a[0].is_cuda and tuple(a[0].shape) == (GEN_N, GEN_D),
               f"{name}: not a ({GEN_N}, {GEN_D}) tensor on the card")
        expect(all(torch.equal(ta, tb) for ta, tb in zip(a, b)),
               f"{name}: one seed gave two results")
        out[name] = {"s": sec, "again_s": sec2}
        del a, b
    path_line("generators", sum(v["s"] for v in out.values()), None,
              {}, **out)
    return out


def asha_cells(dev, errs):
    """The ASHA phase (step 13). Returns the launches of its paths that
    run the repo's kernels and a summary; the mini-batch shape's K2 check
    updates ``errs``."""
    import torch

    t0 = time.perf_counter()
    launches, out = {}, {}
    out["drill"] = asha_drill(dev)
    torch.cuda.empty_cache()
    launches["minibatch-hyperband"], out["minibatch_hyperband"] = \
        minibatch_hyperband(dev)
    torch.cuda.empty_cache()
    launches["minibatch"], out["minibatch"] = minibatch_fit_predict(dev,
                                                                   errs)
    torch.cuda.empty_cache()
    out["hyperband_config4"] = hyperband_config4(dev)
    torch.cuda.empty_cache()
    fn_launches, out["k_means_fn"] = k_means_fn(dev)
    launches.update(fn_launches)
    torch.cuda.empty_cache()
    out["gaussian_nb"] = gaussian_nb_cell(dev)
    out["generators"] = generators_cell(dev)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("ASHA " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# NYSTROM: SpectralClustering and KernelKMeans
# ---------------------------------------------------------------------------


def nystrom_blobs(dev):
    """The JAX bench's spectral cell's data (bench_spectral): make_blobs at
    SPEC_N × SPEC_D, SPEC_K centers, cluster_std 1, seed 0, drawn on the
    card with the port's generator and standardized there."""
    import torch

    from dask_ml_tpu_torch import config_context, datasets

    with config_context(device=dev):
        X, y = datasets.make_blobs(n_samples=SPEC_N, n_features=SPEC_D,
                                   centers=SPEC_K, cluster_std=1.0,
                                   random_state=SEED)
    X = (X - X.mean(0)) / torch.clamp(X.std(0), min=1e-6)
    return X.contiguous(), y.cpu().numpy()


def spectral_cell(dev, errs):
    """``spectral``: the JAX bench's cell (``SpectralClustering(n_clusters=
    8, n_components=200, gamma=None, random_state=0, kmeans_params={"init":
    "random"})``) cold and warm on the card-resident blobs, its Nyström
    seconds apart from the inner KMeans'; the same estimator with its
    default inner init (k-means||) gated on ARI ≥ 0.99, predict(X) ==
    labels_ and K1-K4 launched; the kernel and plain (kernel="torch")
    Lloyd routes on one embedding give the same labels up to near-ties
    from a shared explicit init (SPEC_K rows of the embedding drawn from
    SEED), and the same labels from the fitted centers; K1-K4 against
    their plain versions at the embedding's shape."""
    import torch

    from dask_ml_tpu_torch.cluster import SpectralClustering
    from dask_ml_tpu_torch.models import kmeans as core

    t0 = time.perf_counter()
    X, y = nystrom_blobs(dev)
    torch.cuda.synchronize()
    out = {"n": SPEC_N, "d": SPEC_D, "k": SPEC_K, "l": SPEC_L,
           "generate_s": time.perf_counter() - t0}
    launches = {}

    def bench_fit():
        return SpectralClustering(
            n_clusters=SPEC_K, n_components=SPEC_L, gamma=None,
            random_state=SEED, kmeans_params={"init": "random"}).fit(X)

    for tag in ("cold", "warm"):
        sc, sec, l_fit = drive(bench_fit)
        out[f"bench_{tag}_s"] = sec
        out[f"bench_{tag}_phases"] = sc.fit_phase_seconds_
        log(f"spectral, the bench's config, {tag}: {sec:.3f} s (spectral-"
            f"nystrom {sc.fit_phase_seconds_['nystrom']:.3f} s, inner "
            f"KMeans {sc.fit_phase_seconds_['kmeans']:.3f} s)")
    launches["spectral-random"] = l_fit
    expect_launches("spectral-random", l_fit)
    prof = device_profile(bench_fit)
    log("PROFILE spectral-warm " + json.dumps(prof))
    out["profile"] = prof and {k: prof[k] for k in ("wall_ms",
                                                    "device_busy_ms",
                                                    "busy_share")}
    # init="random" takes 8 random rows of the embedding, often two in one
    # blob: a local minimum of Lloyd, so this fit's ARI is reported only
    out["bench_ari"] = ari(y, sc.labels_)
    path_line("spectral-random", sec, sc.assign_labels_.n_iter_, l_fit,
              phases=sc.fit_phase_seconds_, ari=out["bench_ari"])

    sc, fit_s, l_fit = drive(lambda: SpectralClustering(
        n_clusters=SPEC_K, n_components=SPEC_L, gamma=None,
        random_state=SEED).fit(X))
    launches["spectral"] = l_fit
    expect_launches("spectral", l_fit)
    score = ari(y, sc.labels_)
    expect(score >= 0.99, f"spectral ARI {score} < 0.99")
    expect(sc.labels_.dtype == np.int32 and sc.eigenvalues_.shape
           == (SPEC_K,) and np.isfinite(sc.eigenvalues_).all(),
           "spectral: labels or eigenvalues")
    pred, pred_s, l_pred = drive(lambda: sc.predict(X))
    launches["spectral-predict"] = l_pred
    expect_launches("spectral-predict", l_pred)
    expect(np.array_equal(pred, sc.labels_), "spectral predict(X) != labels_")
    path_line("spectral", fit_s, sc.assign_labels_.n_iter_, l_fit,
              phases=sc.fit_phase_seconds_, ari=score,
              predict_s=pred_s, predict_launches=l_pred)
    out.update(fit_s=fit_s, phases=sc.fit_phase_seconds_, ari=score,
               n_iter=sc.assign_labels_.n_iter_, predict_s=pred_s,
               eigenvalues=sc.eigenvalues_.tolist())

    # the kernel route against the plain route from one embedding: first
    # from one shared explicit init, SPEC_K rows of the embedding drawn
    # from SEED (labels equal up to near-ties), then from the fitted
    # centers (labels equal)
    U = sc._extend_rows(X)
    del X
    w = torch.ones(SPEC_N, device=dev)
    tol = core.scaled_tolerance(U, w, 1e-4)
    pick = np.random.RandomState(SEED).choice(SPEC_N, SPEC_K, replace=False)
    out["plain_route"] = {}
    for case, c0 in (
            ("shared_init", U[torch.as_tensor(pick, device=dev)].clone()),
            ("fitted_centers", torch.as_tensor(
                sc.assign_labels_.cluster_centers_, device=dev))):
        ck, _, it_k, _ = core.lloyd_loop_fused(U, w, c0, tol, max_iter=300)
        cp, _, it_p, _ = core.lloyd_loop_fused(U, w, c0, tol, max_iter=300,
                                               kernel="torch")
        lk = core.predict_labels(U, ck)
        lp = core.predict_labels(U, cp, kernel="torch")
        # a row's scores under the two routes' centers differ by at most
        # δ(x) = max_j ||ck_j|² − |cp_j|²| + 2|x|·|ck_j − cp_j|, so its pick
        # under cp is within 2δ(x) of its best under ck
        dc = (ck - cp).norm(dim=1)
        dn = ((ck * ck).sum(1) - (cp * cp).sum(1)).abs()

        def reach(rows):
            x = rows.norm(dim=1)[:, None]
            return 2.0 * (dn[None, :] + 2.0 * x * dc[None, :]).amax(1)

        n_ties = near_tie_ok(U, ck, None, lk, lp, slack=reach)
        if case == "fitted_centers":
            expect(n_ties == 0, "spectral: kernel and plain routes label "
                   "the embedding differently from the fitted centers")
        out["plain_route"][case] = {
            "n_iter": [int(it_k), int(it_p)], "near_ties": n_ties,
            "max_center_gap": float(dc.max()),
            "ari": ari(lk.cpu().numpy(), lp.cpu().numpy())}
        log(f"spectral: kernel and plain routes from the {case}: n_iter "
            f"{int(it_k)} / {int(it_p)}, {n_ties} labels differ, each a "
            f"near-tie; centers within {float(dc.max()):.3e}")
    C = torch.as_tensor(sc.assign_labels_.cluster_centers_, device=dev)
    for k, v in check_fused("spectral embedding", U, C, w=w,
                            exact=False).items():
        errs[k] = max(errs.get(k, 0.0), v)
    errs["lloyd_iter"] = max(errs.get("lloyd_iter", 0.0), check_lloyd(
        "spectral embedding", U, w, C, exact=False))
    return launches, out


def xor_data(n: int, seed: int = 0):
    """The JAX drill's XOR recipe (bench.py --sketch, step 3): four
    gaussian blobs at (±2, ±2), class = sign(x1·x2)."""
    rng = np.random.RandomState(seed)
    signs = rng.randint(0, 2, (n, 2)) * 2 - 1
    X = (signs * 2.0 + rng.randn(n, 2) * 0.6).astype(np.float32)
    return X, (signs[:, 0] * signs[:, 1] > 0).astype(np.int32)


def kernel_kmeans_cell(dev, errs):
    """``kernel-kmeans-xor``: the JAX drill's KernelKMeans on XOR at its
    documented knob SKETCH_KN = XOR_N rows: ARI ≥ 0.9, the dense KMeans
    control < 0.5, predict(X) == labels_, K1-K4 launched; K1-K4 against
    their plain versions at the feature rows' shape."""
    import torch

    from dask_ml_tpu_torch.cluster import KernelKMeans, KMeans

    X, y = xor_data(XOR_N)
    kk, fit_s, l_fit = drive(lambda: KernelKMeans(
        n_clusters=2, n_components=128, affinity="polynomial", degree=2,
        coef0=1.0, gamma=0.5, random_state=5).fit(X))
    expect_launches("kernel-kmeans-xor", l_fit)
    score = ari(y, kk.labels_)
    expect(score >= 0.9, f"kernel k-means XOR ARI {score} < 0.9")
    control = ari(y, KMeans(n_clusters=2, random_state=3).fit(X).labels_)
    expect(control < 0.5, f"dense KMeans control ARI {control} >= 0.5")
    pred, pred_s, l_pred = drive(lambda: kk.predict(X))
    expect_launches("kernel-kmeans-predict", l_pred)
    expect(np.array_equal(pred, kk.labels_),
           "kernel k-means predict(X) != labels_")
    path_line("kernel-kmeans-xor", fit_s, kk.n_iter_, l_fit, ari=score,
              dense_control_ari=control, predict_s=pred_s,
              predict_launches=l_pred)
    # the feature rows the inner KMeans clustered, and K1-K4 on them
    Phi = kk._extend_rows(torch.as_tensor(X, device=dev))
    w = torch.ones(XOR_N, device=dev)
    Cc = torch.as_tensor(kk.cluster_centers_, device=dev)
    for k, v in check_fused("XOR features", Phi, Cc, w=w,
                            exact=False).items():
        errs[k] = max(errs.get(k, 0.0), v)
    errs["lloyd_iter"] = max(errs.get("lloyd_iter", 0.0), check_lloyd(
        "XOR features", Phi, w, Cc, exact=False))
    return {"kernel-kmeans-xor": l_fit, "kernel-kmeans-predict": l_pred}, {
        "n": XOR_N, "fit_s": fit_s, "ari": score, "dense_control_ari":
        control, "n_iter": kk.n_iter_, "inertia": kk.inertia_,
        "predict_s": pred_s}


def nystrom_cells(dev, errs):
    """The NYSTROM phase (step 15): ``spectral`` and
    ``kernel-kmeans-xor``. Returns the launches of its paths and a
    summary."""
    import torch

    t0 = time.perf_counter()
    launches, out = {}, {}
    launches_s, out["spectral"] = spectral_cell(dev, errs)
    launches.update(launches_s)
    torch.cuda.empty_cache()
    launches_k, out["kernel_kmeans_xor"] = kernel_kmeans_cell(dev, errs)
    launches.update(launches_k)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("NYSTROM " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# PREPROCESS: the sparse StandardScaler on K6-b, a one-hot pipeline, the
# dense scalers
# ---------------------------------------------------------------------------


def canonical_rows(A, chunk: int = 1_000_000):
    """A device container with each row's duplicate columns summed into one
    slot (what scipy's ``csr.sum_duplicates()`` does): sort each row's
    stored columns, add the values of a run of equal columns into its
    first slot, leave the rest inert ``(col 0, value 0)``. Row chunks bound
    the sort's int64 indices."""
    import torch

    from dask_ml_tpu_torch.ops.sparse import SparseRows

    n, k = A.values.shape
    vals = torch.empty_like(A.values)
    cols = torch.empty_like(A.cols)
    sentinel = -1 - torch.arange(k, dtype=A.cols.dtype,
                                 device=A.cols.device)[None, :]
    for s in range(0, n, chunk):
        v = A.values[s:s + chunk]
        key = torch.where(v != 0, A.cols[s:s + chunk], sentinel)
        key, order = torch.sort(key, dim=1)
        v = v.gather(1, order)
        start = torch.ones_like(key, dtype=torch.bool)
        start[:, 1:] = key[:, 1:] != key[:, :-1]
        run = start.to(torch.int64).cumsum(1) - 1
        vals[s:s + chunk] = torch.zeros_like(v).scatter_add_(1, run, v)
        cols[s:s + chunk] = torch.zeros_like(key).scatter_(
            1, run, key.clamp(min=0))
    return SparseRows(vals, cols, A.d)


def float64_column_var(A, chunk: int = 100_000_000):
    """Float64 column variances of a device container of unit weights:
    ``E[x²] − mean²`` from two float64 scatter-adds of the slots on the
    card, in chunks (``index_add_``, not the port's fixed-point pullback:
    its order varies, its rounding is float64's)."""
    import torch

    vals = A.values.reshape(-1)
    cols = A.cols.reshape(-1)
    s1 = torch.zeros(A.d, dtype=torch.float64, device=vals.device)
    s2 = torch.zeros_like(s1)
    for i in range(0, vals.numel(), chunk):
        v = vals[i:i + chunk].to(torch.float64)
        c = cols[i:i + chunk].long()
        s1.index_add_(0, c, v)
        s2.index_add_(0, c, v * v)
    n = A.values.shape[0]
    mean = s1 / n
    return (s2 / n - mean * mean).cpu().numpy()


def sparse_scaler_cell(dev):
    """``sparse-scaler``: ``StandardScaler(with_mean=False)`` on the flagship
    container. Its generator draws a duplicate column in about 5 % of the
    rows, which the scaler refuses (as the JAX one does): the cell shows
    the refusal, sums the duplicates on the card (``canonical_rows``, what
    the refusal asks for) and fits the canonical container twice (three
    pullbacks through K6-b; the same bits), holds ``var_`` within
    SCALER_RTOL of float64 column variances (summed on the card), K6-b's
    stored counts to the plain pullback bit for bit, and the transform to
    the plain gather bit for bit."""
    import torch

    from dask_ml_tpu_torch.ops import sparse as sps
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.preprocessing import StandardScaler
    from dask_ml_tpu_torch.utils.validation import check_array

    Xh, _ = drawn("sparse_glm", sparse_glm_data)
    t0 = time.perf_counter()
    raw = prepare_data(check_array(Xh, accept_sparse=True), device=dev).X
    torch.cuda.synchronize()
    out = {"n": GLM_N, "d": GLM_D, "k": raw.k,
           "stage_s": time.perf_counter() - t0}
    dup, dup_s, _ = drive(lambda: bool(sps.has_duplicate_slots(raw)))
    expect(dup, "the flagship container has no duplicate slots")
    try:
        StandardScaler(with_mean=False).fit(raw)
    except ValueError as e:
        expect("twice" in str(e), f"unexpected refusal: {e}")
    else:
        raise Mismatch("the scaler fitted a container with duplicate slots")
    A, canon_s, _ = drive(lambda: canonical_rows(raw))
    del raw
    torch.cuda.empty_cache()
    expect(not bool(sps.has_duplicate_slots(A)), "duplicates left")
    out.update(duplicate_check_s=dup_s, canonicalize_s=canon_s)

    sc, fit_s, l_fit = drive(lambda: StandardScaler(with_mean=False).fit(A))
    expect_launches("sparse-scaler-fit", l_fit)
    expect(l_fit["spmv_pullback"] + l_fit["spmv_pullback_l2"] == 3,
           f"the moments took {l_fit}, not three pullbacks")
    again = StandardScaler(with_mean=False).fit(A)
    expect(np.array_equal(sc.var_, again.var_)
           and np.array_equal(sc.scale_, again.scale_),
           "two sparse scaler fits differ")
    prof = device_profile(lambda: StandardScaler(with_mean=False).fit(A))
    log("PROFILE sparse-scaler-fit " + json.dumps(prof))
    out["profile"] = prof and {k: prof[k] for k in ("wall_ms",
                                                    "device_busy_ms",
                                                    "busy_share")}
    t0 = time.perf_counter()
    ref = float64_column_var(A)
    ref_s = time.perf_counter() - t0
    err = float(np.max(np.abs(sc.var_ - ref)
                       / np.maximum(np.abs(ref), 1e-30)))
    expect(err <= SCALER_RTOL, f"var_ rtol {err} > {SCALER_RTOL}")
    # K6-b's weighted stored counts against the plain pullback: 0/1
    # values of unit weight, so exact
    w = torch.ones(GLM_N, device=dev)
    stored = (A.values != 0).to(torch.float32)
    k_nnz = sps.pullback(sps.SparseRows(stored, A.cols, A.d), w)
    p_nnz = sps._pullback_ref(stored, A.cols, w, A.d)
    expect(torch.equal(k_nnz, p_nnz), "K6-b stored counts != plain")
    del stored
    Z, tr_s, _ = drive(lambda: sc.transform(A))
    inv = 1.0 / torch.as_tensor(sc.scale_, device=dev)
    plain = A.values * torch.index_select(inv, 0, A.cols.view(-1)).view(
        A.values.shape)
    expect(isinstance(Z, sps.SparseRows) and Z.cols is A.cols
           and torch.equal(Z.values, plain),
           "the sparse transform is not the plain gather bit for bit")
    del Z, plain
    path_line("sparse-scaler", fit_s, None, l_fit, transform_s=tr_s,
              var_rtol=err, reference_s=ref_s)
    out.update(fit_s=fit_s, transform_s=tr_s, var_rtol=err,
               reference_s=ref_s)
    return l_fit, out


def onehot_data(seed: int):
    """ONEHOT_N rows of ONEHOT_COLS integer categorical columns of
    ONEHOT_CATS categories each, and labels from a planted logistic model
    of one weight a category."""
    rng = np.random.default_rng([seed, 13])
    X = rng.integers(0, ONEHOT_CATS, (ONEHOT_N, ONEHOT_COLS)).astype(
        np.int32)
    beta = rng.standard_normal((ONEHOT_COLS, ONEHOT_CATS)) * 0.5
    logit = beta[np.arange(ONEHOT_COLS)[None, :], X].sum(1)
    y = (rng.random(ONEHOT_N) < 1.0 / (1.0 + np.exp(-logit))).astype(
        np.int64)
    return X, y


def check_onehot_kernels(dev, pipe, X, y, errs):
    """K6 and K6-b at the one-hot pipeline's shape (n, ONEHOT_COLS + 1
    slots with the intercept's, d = categories + 1: the GLM's operand),
    against their plain versions on the same inputs: on the encoded 0/1
    container with an integer vector and cotangent, bit for bit through
    every route that fits (``check_spmv_int``); then on the operands the
    GLM ran (the scaled container, the fitted coefficients, the loss's
    cotangent at them), the forward within k·2^-23·Σ|a||v| of the plain
    version (each side rounds k products and k − 1 partial sums, 2^-24
    each), the pullback within 2^-22·Σ|a||r| of the sum in float64 (the
    kernel rounds each f32 product and the fixed-point sum once, 2^-24
    each; a factor 2 for the products' quantization). Folds the errors
    into ``errs``."""
    import torch

    from dask_ml_tpu_torch.linear_model.glm import add_intercept
    from dask_ml_tpu_torch.ops import sparse as sps
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.utils.validation import check_array

    enc, scaler, lr = (s for _, s in pipe.steps)
    oh = enc.transform(X)
    A = add_intercept(prepare_data(check_array(oh, accept_sparse=True),
                                   device=dev).X)
    n, k, d = A.values.shape[0], A.k, A.d
    expect(bool(((A.values == 0) | (A.values == 1)).all()),
           "the encoded container is not 0/1")
    rng = np.random.default_rng([SEED, 26])
    v = torch.as_tensor(rng.integers(-4, 4, d), dtype=torch.float32,
                        device=dev)
    r = torch.as_tensor(rng.integers(-2, 2, n), dtype=torch.float32,
                        device=dev)
    check_spmv_int(f"one-hot n{n} k{k} d{d}", A, v, r,
                   fitting_routes(k, d, False), fitting_routes(k, d, True))
    del A, v, r
    A = add_intercept(scaler.transform(oh))
    absA = sps.SparseRows(A.values.abs(), A.cols, A.d)
    coef = torch.as_tensor(lr._coef, dtype=torch.float32, device=dev)
    eta = sps.matvec(A, coef, kernel="cuda")
    want = sps._spmv_ref(A.values, A.cols, coef)
    reach = k * 2.0 ** -23 * sps._spmv_ref(absA.values, A.cols, coef.abs())
    f_err = float((eta - want).abs().max())
    f_share = float(((eta - want).abs() / reach).max())
    expect(f_share <= 1.0, f"K6 one-hot, the GLM's operands: max abs err "
           f"{f_err}, {f_share} of its bound")
    yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
    res = torch.sigmoid(want) - yd
    g = sps._pullback_cuda(A.values, A.cols, res, d)

    def pullback64(values, r):
        prods = values.double() * r.double()[:, None]
        return torch.zeros(d, dtype=torch.float64, device=dev).index_add_(
            0, A.cols.reshape(-1), prods.reshape(-1))

    g64 = pullback64(A.values, res)
    reach = 2.0 ** -22 * pullback64(absA.values, res.abs())
    b_err = float((g.double() - g64).abs().max())
    b_share = float(((g.double() - g64).abs() / reach).max())
    expect(b_share <= 1.0, f"K6 pullback one-hot, the GLM's cotangent: max "
           f"abs err {b_err}, {b_share} of its bound")
    log(f"K6 / K6-b at the one-hot shape n{n} k{k} d{d}: 0/1 data bit for "
        f"bit through every route; the GLM's operands: forward {f_err:.3e} "
        f"({f_share:.4f} of its bound), pullback {b_err:.3e} from float64 "
        f"({b_share:.4f} of its bound)")
    errs["spmv"] = max(errs.get("spmv", 0.0), f_err)
    errs["spmv_pullback"] = max(errs.get("spmv_pullback", 0.0), b_err)
    return {"shape": {"n": n, "k": k, "d": d}, "glm_forward_err": f_err,
            "glm_forward_share": f_share, "glm_pullback_err": b_err,
            "glm_pullback_share": b_share}


def onehot_pipeline_cell(dev, errs):
    """``onehot-pipeline``: OneHotEncoder → StandardScaler(with_mean=False)
    → LogisticRegression(solver="lbfgs", max_iter=3) on ONEHOT_N rows of
    ONEHOT_COLS categorical columns: K6 and K6-b launch, the card's peak
    memory over the pipeline stays under 3× the container's bytes (no
    dense (n, d) tensor), and both kernels hold against their plain
    versions at this path's shape (``check_onehot_kernels``)."""
    import torch

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.pipeline import make_pipeline
    from dask_ml_tpu_torch.preprocessing import OneHotEncoder, StandardScaler

    X, y = onehot_data(SEED)
    pipe = make_pipeline(OneHotEncoder(), StandardScaler(with_mean=False),
                         LogisticRegression(solver="lbfgs", max_iter=3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    _, fit_s, l_fit = drive(lambda: pipe.fit(X, y))
    peak = torch.cuda.max_memory_allocated(dev) - base
    oh = pipe.steps[0][1].transform(X[:1])
    cbytes = ONEHOT_N * ONEHOT_COLS * (oh.values.itemsize
                                       + oh.cols.itemsize)
    expect_launches("onehot-pipeline", l_fit)
    expect(peak < 3 * cbytes, f"one-hot pipeline peak {peak} B >= 3 x the "
           f"container's {cbytes} B")
    acc = float(pipe.score(X[:200_000], y[:200_000]))
    expect(acc > 0.55, f"one-hot pipeline accuracy {acc} <= 0.55")
    path_line("onehot-pipeline", fit_s, pipe.steps[-1][1].n_iter_, l_fit,
              peak_bytes=peak, container_bytes=cbytes, accuracy=acc)
    kernels = check_onehot_kernels(dev, pipe, X, y, errs)
    return l_fit, {"n": ONEHOT_N, "columns": ONEHOT_COLS,
                   "categories": ONEHOT_CATS, "fit_s": fit_s,
                   "peak_bytes": peak, "container_bytes": cbytes,
                   "accuracy": acc, "kernels": kernels}


def rel_err(got, ref) -> float:
    """max |got − ref| / max |ref|."""
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref))
                 / max(np.max(np.abs(ref)), 1e-30))


def percentile_reference(X, q):
    """Column percentiles as ``preprocessing.data.percentiles`` defines
    them (jax's linear rule with its index ``q · ((n − 1) / 100)`` formed
    in f32), the blend of the two order statistics in float64."""
    Xs = np.sort(X.astype(np.float64), axis=0)
    n = X.shape[0]
    step = np.float32((np.float32(n) - np.float32(1)) / np.float32(100))
    pos = (np.asarray(q, np.float32) * step).astype(np.float64)
    lo, hi = np.floor(pos), np.ceil(pos)
    w = (pos - lo)[:, None]
    return (Xs[lo.astype(np.int64)] * (1.0 - w)
            + Xs[hi.astype(np.int64)] * w)


def quantile_reference(X64, q, refs, normal: bool):
    """QuantileTransformer's forward map in float64: numpy's interp, the
    two-sided mean, the extreme-quantile overrides, ``ndtri`` clipped."""
    from scipy.special import ndtri

    out = np.empty_like(X64)
    clip = float(ndtri(1e-7 - np.spacing(1)))
    for j in range(X64.shape[1]):
        x, qj = X64[:, j], q[:, j]
        u = 0.5 * (np.interp(x, qj, refs)
                   - np.interp(-x, -qj[::-1], -refs[::-1]))
        if normal:
            u = np.where(x + 1e-7 > qj[-1], 1.0, u)
            u = np.where(x - 1e-7 < qj[0], 0.0, u)
            u = np.clip(ndtri(u), clip, -clip)
        else:
            u = np.where(x == qj[-1], 1.0, u)
            u = np.where(x == qj[0], 0.0, u)
        out[:, j] = u
    return out


def normal_ppf_step(R):
    """The f32 conditioning of the normal output: ``u`` near 1 is held in
    f32 to 2^-24 (its spacing there), and ``ppf`` multiplies an error in
    ``u`` by ``1 / φ(ppf(u))``, so one grid step of ``u`` moves an output
    ``R`` by ``2^-24 / φ(R)`` (≈ 1.2e-3 at R = 4.25, 1.5e-7 at R = 0)."""
    phi = np.exp(-0.5 * R * R) / np.sqrt(2.0 * np.pi)
    return 2.0 ** -24 / phi


def normal_round_trip_step(X64, q):
    """The f32 conditioning of the normal output's round trip: ``ndtr`` of
    an upper-tail output lands on f32's grid near 1 (spacing 2^-24), and
    the inverse interpolation multiplies an error in ``u`` by the slope of
    its bin, ``(q[k] − q[k−1]) · (n_quantiles − 1)``: one grid step of
    ``u`` moves an element by that slope times 2^-24."""
    step = np.empty_like(X64)
    m = q.shape[0]
    for j in range(X64.shape[1]):
        k = np.clip(np.searchsorted(q[:, j], X64[:, j]), 1, m - 1)
        step[:, j] = (q[k, j] - q[k - 1, j]) * (m - 1) * 2.0 ** -24
    return step


def grid_steps_used(err, floor, step) -> float:
    """The most grid steps of ``u`` that an error beyond ``floor`` needs:
    max over elements of max(0, err − floor) / step."""
    return float(np.max(np.maximum(err - floor, 0.0) / step))


def dense_scalers_cell(dev):
    """``dense-scalers``: MinMaxScaler, RobustScaler and QuantileTransformer
    (uniform and normal, 1,000 quantiles) on the blobs cell's 1,000,000 ×
    50 staged on the card, each against a float64 numpy reference of the
    same formulas (``percentile_reference``: the quantiles' index as the
    port and jax form it; max |error| ≤ SCALER_RTOL of the reference's
    largest magnitude; the normal output also NORMAL_PPF_STEPS grid steps
    of ``normal_ppf_step``, its f32 conditioning in the upper tail), the
    inverse transform back to X within SCALER_RTOL of X's largest
    magnitude (the normal output's also NORMAL_ROUND_TRIP_STEPS of
    ``normal_round_trip_step``); the seconds of each fit and transform,
    each error's largest share of its tolerance, and the grid steps the
    normal output used."""
    import torch

    from dask_ml_tpu_torch.preprocessing import (MinMaxScaler,
                                                 QuantileTransformer,
                                                 RobustScaler)

    X, _ = drawn("blobs", lambda: blobs_data(SEED))
    Xd = torch.as_tensor(X, device=dev)
    X64 = X.astype(np.float64)
    out = {}
    lo, hi = X64.min(0), X64.max(0)
    qs = percentile_reference(X, [25.0, 50.0, 75.0])
    refs = np.linspace(0, 1, 1000)
    qq = percentile_reference(X, refs * 100.0)
    cases = (
        ("minmax", MinMaxScaler, lambda: (X64 - lo) / (hi - lo), False),
        ("robust", RobustScaler, lambda: (X64 - qs[1]) / (qs[2] - qs[0]),
         False),
        ("quantile-uniform", lambda: QuantileTransformer(n_quantiles=1000),
         lambda: quantile_reference(X64, qq, refs, False), False),
        ("quantile-normal", lambda: QuantileTransformer(
            n_quantiles=1000, output_distribution="normal"),
         lambda: quantile_reference(X64, qq, refs, True), True))
    for name, make, reference, normal in cases:
        est, fit_s, _ = drive(lambda: make().fit(Xd))
        Z, tr_s, _ = drive(lambda: est.transform(Xd))
        back, inv_s, _ = drive(lambda: est.inverse_transform(Z))
        R = reference()
        err = rel_err(Z, R)
        round_trip = rel_err(back, X64)
        e_fwd, e_back = np.abs(Z - R), np.abs(back - X64)
        floor_fwd = SCALER_RTOL * np.max(np.abs(R))
        floor_back = SCALER_RTOL * np.max(np.abs(X64))
        tol_fwd, tol_back = floor_fwd, floor_back
        cell = {}
        if normal:
            s_fwd, s_back = normal_ppf_step(R), normal_round_trip_step(X64,
                                                                      qq)
            tol_fwd = tol_fwd + NORMAL_PPF_STEPS * s_fwd
            tol_back = tol_back + NORMAL_ROUND_TRIP_STEPS * s_back
            cell.update(
                ppf_steps_used=grid_steps_used(e_fwd, floor_fwd, s_fwd),
                round_trip_steps_used=grid_steps_used(e_back, floor_back,
                                                      s_back))
        share_fwd = float(np.max(e_fwd / tol_fwd))
        share_back = float(np.max(e_back / tol_back))
        log(f"dense scaler {name}: fit {fit_s:.4f} s, transform {tr_s:.4f}"
            f" s, inverse {inv_s:.4f} s; error {err:.3e} (at most "
            f"{share_fwd:.4f} of its tolerance), round trip {round_trip:.3e}"
            f" (at most {share_back:.4f}); {cell}")
        expect(share_fwd <= 1.0, f"{name}: error {err} against float64, "
               f"{share_fwd} of its tolerance")
        expect(share_back <= 1.0, f"{name}: inverse round trip "
               f"{round_trip}, {share_back} of its tolerance")
        out[name] = {"fit_s": fit_s, "transform_s": tr_s,
                     "inverse_s": inv_s, "rel_err": err,
                     "round_trip": round_trip, "error_share": share_fwd,
                     "round_trip_share": share_back, **cell}
    path_line("dense-scalers", sum(v["fit_s"] + v["transform_s"]
                                   for v in out.values()), None, {},
              cells=out)
    return out


def preprocess_cells(dev, errs):
    """The PREPROCESS phase (step 16): ``sparse-scaler``,
    ``onehot-pipeline``, ``dense-scalers``. Returns the launches of the
    paths that run the repo's kernels and a summary; the kernels' errors
    against their plain versions go into ``errs``."""
    import torch

    t0 = time.perf_counter()
    launches, out = {}, {}
    launches["sparse-scaler-fit"], out["sparse_scaler"] = \
        sparse_scaler_cell(dev)
    torch.cuda.empty_cache()
    launches["onehot-pipeline"], out["onehot_pipeline"] = \
        onehot_pipeline_cell(dev, errs)
    torch.cuda.empty_cache()
    out["dense_scalers"] = dense_scalers_cell(dev)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("PREPROCESS " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# PRECISION: the bf16 cases of K1-K6 under the mixed-precision policy
# ---------------------------------------------------------------------------

#: the bf16 rows of the kernels line: row name -> (its launch counter, the
#: f32 kernel whose source and TPU kernel it shares)
BF16_ROWS = {
    "K1-bf16": ("lloyd_iter_bf16", "lloyd_iter"),
    "K1-kdd-bf16": ("lloyd_iter_bf16", "lloyd_iter"),
    "K2-bf16": ("fused_argmin_min_bf16", "fused_argmin_min"),
    "K3-bf16": ("fused_rowwise_min_bf16", "fused_rowwise_min"),
    "K3-p-bf16": ("fused_rowwise_min_bf16", "fused_rowwise_min"),
    "K4-bf16": ("fused_argmin_weight_bf16", "fused_argmin_weight"),
    "K5-bf16": ("fused_argmin_min2_bf16", "fused_argmin_min2"),
    "K6-bf16": ("spmv_bf16", "spmv"),
    "K6-b-bf16": ("spmv_pullback_bf16", "spmv_pullback"),
}
# the JAX package's precision gates against the f32 run (bench.py
# --precision, docs/precision.md): coefficients, explained variance and
# inertia; the streamed wire must be at least 1.8x narrower than logical
P_COEF_RTOL, P_VAR_RTOL, P_INERTIA_RTOL, P_WIRE = 5e-2, 2e-2, 1e-2, 1.8
# precision-dense-glm: L-BFGS iterations of each fit
DG_ITERS = 10
# the share of the 1,024-row groups a late bounded iteration evaluates
# (K5-bf16's row-need timing at the KDD cell)
LATE_SHARE = 0.001
# bf16 kernel shapes (n, m, d) of the edge checks: n = 1, m = 1, ragged n,
# every tile of K2-K5 (m <= 8, <= 128, beyond) and the cells' d
FUSED_BF16_SHAPES = [(1, 1, 1), (533, 37, 13), (129, 7, 3), (2000, 329, 50),
                     (300, 40, 130), (4097, 8, 41), (3001, 80, 50)]
# K3 and K4 on a view at an odd element offset: the cells' d, the rounds'
# and the weights' m
FUSED_BF16_VIEWS = [(3001, 80, 50), (4097, 329, 41)]
# K1: (n, k, d, offset in elements): the register and shared-memory
# variants, rows of 100 and 82 bytes, X only 2-byte aligned
LLOYD_BF16_SHAPES = [(1, 1, 1, 0), (533, 4, 7, 0), (4099, 8, 41, 0),
                     (4099, 9, 50, 0), (2000, 8, 110, 0), (257, 8, 397, 0),
                     (3001, 8, 50, 3)]
# K6 and K6-b: (n, k, d, pullback) through every route that fits
SPMV_BF16_SHAPES = [(1, 1, 7, False), (1, 101, 100_001, True),
                    (5000, 1, 7, False), (4097, 3, 7, True),
                    (777, 17, 100_001, False), (80_003, 101, 100_001, False),
                    (80_003, 101, 100_001, True), (40_001, 32, 30_011, True),
                    (9_999, 128, 250_007, False), (301, 513, 5_003, True)]


def f32_fused_direct(X, Yr, y2, mask, epi, need=None, x2=None, w=None):
    """The f32 fused kernel through its C entry on X (f32), the targets as
    given (already rounded) and the |y|² given (of the original targets):
    the function the bf16 kernel must equal on ``X.float()``."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import fused_distance as fd

    lib = build.load("fused_distance")
    n, d = X.shape
    m = Yr.shape[0]
    dev = X.device
    maskf = (torch.ones(m, device=dev) if mask is None
             else mask.to(torch.float32).contiguous())
    am = torch.empty(n, dtype=torch.int32, device=dev)
    mn = torch.empty(n, device=dev)
    mn2 = torch.empty(n, device=dev)
    part = torch.empty((m, -(-n // lib.dml_fused_rows_per_block())),
                       device=dev)
    cw = torch.empty(m, device=dev)
    gneed = (None if need is None
             else fd._group_need(need).to(torch.uint8).contiguous())

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.check(lib.dml_fused_distance(
        fd._EPILOGUES[epi][0], X.data_ptr(), 0, Yr.data_ptr(), y2.data_ptr(),
        maskf.data_ptr(), ptr(gneed), fd._FUSED_BLK, ptr(x2), ptr(w), n, m,
        d, am.data_ptr(), mn.data_ptr(), mn2.data_ptr(), part.data_ptr(),
        cw.data_ptr(), build.stream_of(X)), "f32 fused kernel")
    return {"min": (mn,), "argmin_min": (am, mn), "argmin_weight": (am, cw),
            "argmin_min2": (am, mn, mn2)}[epi]


def f32_lloyd_direct(Xw, w, C):
    """The f32 K1 through its C entry on X widened, the centers rounded to
    bf16 and |c|² of the f32 centers."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import fused_distance as fd

    lib = build.load("lloyd")
    n, d = Xw.shape
    k = C.shape[0]
    Cr = C.to(torch.bfloat16).to(torch.float32).contiguous()
    c2 = fd._row_sumsq(C).contiguous()
    P = k * (d + 1) + 1
    part = torch.empty(lib.dml_lloyd_max_partials() * P, device=Xw.device)
    out = torch.empty(P, device=Xw.device)
    build.check(lib.dml_lloyd_iter(
        Xw.data_ptr(), 0, w.data_ptr(), Cr.data_ptr(), c2.data_ptr(), n, k,
        d, part.data_ptr(), out.data_ptr(), build.stream_of(Xw)), "f32 K1")
    acc = out[:-1].view(k, d + 1)
    return acc[:, :d], acc[:, d], out[-1]


def score_bound_gates(tag, X16, Y, mask, w, need, got_min, got_idx, got_cw,
                      plain_idx):
    """The float-data gates of the tensor-core kernels (bf16 ``min`` and
    ``argmin_weight``), in row chunks: each evaluated min within
    ``_score_bound`` of the float64 min of the same rounded operands (a
    skipped group's rows +inf); each argmin the plain version's but on
    near-ties (``_near_ties``); ``cw`` within rtol 1e-6 of the float64 sum
    of w over the kernel's own labels. Returns (the largest error as a
    share of its row's bound, near-tie rows)."""
    import torch

    from dask_ml_tpu_torch.ops import fused_distance as fd

    n = X16.shape[0]
    ev = (torch.ones(n, dtype=torch.bool, device=X16.device) if need is None
          else fd.row_block_evaluated(need))
    share, ties = 0.0, 0
    for s in range(0, n, 1 << 18):
        rows = slice(s, s + (1 << 18))
        Xc, evc = X16[rows], ev[rows]
        b = fd._score_bound(Xc, Y)
        want = torch.clamp(fd._scores_f64(Xc, Y, mask).min(dim=1).values
                           + (Xc.double() ** 2).sum(1), min=0.0)
        err = (got_min[rows].double() - want).abs()
        if bool(evc.any()):
            share = max(share, float((err[evc] / b[evc]).max()))
        expect(share <= 1.0, f"bf16 min {tag}: beyond the score bound (the "
               f"largest error {share} of its row's bound)")
        expect(bool(torch.isinf(got_min[rows][~evc]).all()),
               f"bf16 min {tag}: a skipped group's row is not +inf")
        near = fd._near_ties(Xc, Y, mask)
        ties += int(near.sum())
        expect(torch.equal(got_idx[rows][~near], plain_idx[rows][~near]),
               f"bf16 argmin_weight {tag}: argmins differ from the plain "
               f"version's off the near-ties")
    ref = torch.zeros(Y.shape[0], dtype=torch.float64, device=X16.device)
    ref.index_add_(0, got_idx.long(), w.double())
    if mask is not None:
        ref[~mask.to(torch.bool)] = 0.0
    expect(bool(((got_cw.double() - ref).abs() <= 1e-6 * ref.abs()).all()),
           f"bf16 argmin_weight {tag}: cw beyond rtol 1e-6 of float64")
    return share, ties


def bf16_fused_against(tag, X16, Y, mask, w, need, x2, exact):
    """Every epilogue of the bf16 fused kernel (the sketched K2 with an
    external |x|² too) against the f32 kernel on X widened: bit for bit on
    integer X (``exact``, then also against the plain version, bit for
    bit), and on float data bit for bit for ``argmin_min``,
    ``argmin_min2`` and the sketched K2, whose score loop is the f32
    kernel's. On float data the tensor-core ``min`` and
    ``argmin_weight`` sum in their own order and are held to the rounding
    bound instead (:func:`score_bound_gates`). ``cw`` and the minima
    repeat their bits from launch to launch. Returns the bound gates'
    (share, near-ties) on float data, else None."""
    import torch

    from dask_ml_tpu_torch.ops import fused_distance as fd

    Yr = Y.to(torch.bfloat16).to(torch.float32).contiguous()
    y2 = fd._row_sumsq(Y).contiguous()
    Xw = X16.float().contiguous()
    calls = {
        "min": lambda k: (fd.fused_rowwise_min(X16, Y, mask, kernel=k,
                                               row_need=need),),
        "argmin_min": lambda k: fd.fused_argmin_min(X16, Y, mask, kernel=k),
        "argmin_weight": lambda k: fd.fused_argmin_weight(X16, w, Y, mask,
                                                          kernel=k),
        "argmin_min2": lambda k: fd.fused_argmin_min2(X16, Y, mask, kernel=k,
                                                      row_need=need),
        "sketched": lambda k: fd.fused_argmin_min_sketched(
            X16, Y, mask=mask, x2=x2, kernel=k, row_need=need)}
    got = {epi: call("cuda") for epi, call in calls.items()}
    for epi in ("min", "argmin_weight"):
        for i, a in enumerate(got[epi]):
            expect_repeats(f"bf16 {epi} {tag} output {i}",
                           lambda epi=epi, i=i: calls[epi]("cuda")[i], a)
    for epi, call in calls.items():
        if not exact and epi in ("min", "argmin_weight"):
            continue
        direct = f32_fused_direct(
            Xw, Yr, y2, mask, "argmin_min" if epi == "sketched" else epi,
            need=need if epi in ("min", "argmin_min2", "sketched") else None,
            x2=x2 if epi == "sketched" else None,
            w=w if epi == "argmin_weight" else None)
        for a, c in zip(got[epi], direct):
            expect(torch.equal(a, c), f"bf16 {epi} {tag}: not the f32 "
                   f"kernel's bits on X widened")
        if exact:
            for a, b in zip(got[epi], call("torch")):
                expect(torch.equal(a, b),
                       f"bf16 {epi} {tag}: not bit-identical to the plain "
                       f"version")
    if exact:
        return None
    idx, cw = got["argmin_weight"]
    return score_bound_gates(tag, X16, Y, mask, w, need, got["min"][0], idx,
                             cw, calls["argmin_weight"]("torch")[0])


def precision_kernel_checks(dev):
    """The bf16 kernels at edge shapes: K2-K5 and K1 bit for bit against
    their plain versions on integer X with targets and centers on a 1/256
    grid that bf16 rounds (every product and sum exact), and against the
    f32 kernel on X widened on integer and float data; ties and an
    all-masked Y; K6 and K6-b bit for bit through every route that fits,
    the pullback's routes also on float data; the near-duplicate-centers
    pin (tests/test_precision.py) through K2."""
    import torch

    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.ops import fused_distance as fd
    from dask_ml_tpu_torch.ops import sparse as sps

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)

    def ints(shape, lo=-8, hi=8):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    def grid(shape):
        return torch.randint(-512, 512, shape, generator=g,
                             device=dev).float() / 256.0

    for n, m, d in FUSED_BF16_SHAPES:
        X16 = ints((n, d)).to(torch.bfloat16)
        mask = torch.rand(m, generator=g, device=dev) > 0.3
        mask[0] = True
        need = torch.rand(n, generator=g, device=dev) > 0.7
        bf16_fused_against(f"{(n, m, d)}", X16, grid((m, d)), mask,
                           ints((n,), 0, 5), need, ints((n,), 0, 9),
                           exact=True)
        # float data: the f32 kernel's bits on X widened (K2, K5), the
        # rounding bound (K3, K4)
        Xf = torch.randn((n, d), generator=g, device=dev)
        bf16_fused_against(f"{(n, m, d)} float", Xf.to(torch.bfloat16),
                           torch.randn((m, d), generator=g, device=dev),
                           mask, torch.rand(n, generator=g, device=dev),
                           need, (Xf * Xf).sum(1), exact=False)
    # X as a view at an odd element offset: no row 16-byte aligned, the
    # first not even 4-byte aligned (the tensor-core kernels' plain head)
    for n, m, d in FUSED_BF16_VIEWS:
        mask = torch.rand(m, generator=g, device=dev) > 0.3
        mask[0] = True
        need = torch.rand(n, generator=g, device=dev) > 0.7
        X16 = ints((n * d + 3,)).to(torch.bfloat16)[3:].view(n, d)
        expect(X16.data_ptr() % 4 == 2, "the offset view is 4-byte aligned")
        bf16_fused_against(f"{(n, m, d)} view", X16, grid((m, d)), mask,
                           ints((n,), 0, 5), need, ints((n,), 0, 9),
                           exact=True)
        Xf = torch.randn((n * d + 1,), generator=g, device=dev)
        bf16_fused_against(f"{(n, m, d)} float view",
                           Xf.to(torch.bfloat16)[1:].view(n, d),
                           torch.randn((m, d), generator=g, device=dev),
                           mask, torch.rand(n, generator=g, device=dev),
                           need, torch.rand(n, generator=g, device=dev),
                           exact=False)
    # ties: every target twice, every row on a duplicate; all masked
    Yb = grid((9, 5))
    Y = torch.cat([Yb, Yb])
    X16 = torch.cat([Yb, Yb, Yb]).to(torch.bfloat16)
    ka, _ = fd.fused_argmin_min(X16, Y, kernel="cuda")
    ra, _ = fd.fused_argmin_min(X16, Y, kernel="torch")
    expect(torch.equal(ka, ra) and int(ka.max()) < 9,
           "bf16 ties do not break to the lowest index")
    none = torch.zeros(18, dtype=torch.bool, device=dev)
    am, mn = fd.fused_argmin_min(X16, Y, none, kernel="cuda")
    expect(bool((am == 0).all() and torch.isinf(mn).all()),
           "bf16 all-masked: not (0, inf)")
    # the near-duplicate pin: |y|² from the original Y breaks the tie
    base = torch.zeros(8, device=dev)
    base[0] = 8.0
    plus = base.clone()
    plus[0] = 8.01
    idx, mind = fd.fused_argmin_min(base.repeat(16, 1).to(torch.bfloat16),
                                    torch.stack([plus, base]), kernel="cuda")
    expect(idx.tolist() == [1] * 16 and float(mind.max()) <= 1e-2,
           f"bf16 near-duplicate centers: argmin {idx.tolist()}")
    # K1
    for n, k, d, off in LLOYD_BF16_SHAPES:
        X16 = ints((n * d + off,), -4, 4).to(torch.bfloat16)[off:].view(n, d)
        w = ints((n,), 0, 3)
        C = grid((k, d))
        expect(core._lloyd_cuda_supported(k, d, torch.bfloat16),
               f"bf16 K1 refuses {(k, d)}")
        got = core._lloyd_stats_cuda(X16, w, C)
        want = core._lloyd_stats_ref(X16, w, C)
        direct = f32_lloyd_direct(X16.float().contiguous(), w, C)
        tag = f"bf16 K1 {(n, k, d, off)}"
        expect(all(torch.equal(a, b) for a, b in zip(got, direct)),
               f"{tag}: not the f32 kernel's bits on X widened")
        expect(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
               f"{tag}: sums or counts not bit-identical to the plain "
               f"version")
        # |c|² of 1/256-grid centers is fractional at large d: the row
        # minima are, and the two sum them in other orders
        expect(abs(float(got[2]) - float(want[2]))
               <= 1e-6 * abs(float(want[2])), f"{tag}: inertia")
        Xf = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
        wf = torch.rand(n, generator=g, device=dev)
        Cf = torch.randn((k, d), generator=g, device=dev)
        expect(all(torch.equal(a, b) for a, b in zip(
            core._lloyd_stats_cuda(Xf, wf, Cf),
            f32_lloyd_direct(Xf.float().contiguous(), wf, Cf))),
            f"{tag} float: not the f32 kernel's bits on X widened")
    # K6 and K6-b
    rng = np.random.default_rng(SEED + 12)
    for n, k, d, pullback in SPMV_BF16_SHAPES:
        A = ell_ints(rng, n, k, d, dev, -4, 4)
        vals = A.values.to(torch.bfloat16)
        x = grid((n if pullback else d,))
        for c in [None] + fitting_routes(k, d, pullback):
            if pullback:
                got = sps._pullback_cuda(vals, A.cols, x, d, cluster=c)
                want = sps._pullback_ref(vals, A.cols, x, d)
            else:
                got = sps._spmv_cuda(vals, A.cols, x, cluster=c)
                want = sps._spmv_ref(vals, A.cols, x)
            expect(torch.equal(got, want),
                   f"bf16 K6{'-b' if pullback else ''} {(n, k, d)} route "
                   f"{c}: not bit-identical to the plain version")
        if pullback:
            vf = (A.values * 0.3 + 0.01 * (A.values != 0)).to(torch.bfloat16)
            rf = x * 0.7071 + 0.1234
            routes = fitting_routes(k, d, True)
            first = sps._pullback_cuda(vf, A.cols, rf, d, cluster=routes[0])
            for c in routes:
                got = sps._pullback_cuda(vf, A.cols, rf, d, cluster=c)
                expect(torch.equal(got, first),
                       f"bf16 K6-b {(n, k, d)} route {c}: float data, not "
                       f"the bits of route {routes[0]}")
                expect_repeats(f"bf16 K6-b {(n, k, d)} route {c}",
                               lambda c=c: sps._pullback_cuda(
                                   vf, A.cols, rf, d, cluster=c), got)
    torch.cuda.synchronize()


def with_launches(rows, launches):
    """Each row's launches on its own path (the counter of its bf16
    kernel in ``launches``, the path's counts)."""
    for r in rows:
        r["path_launches"] = int(launches[BF16_ROWS[r["name"]][0]])
    return rows


def bf16_rows(rows, errs):
    """The kernels line's bf16 entries: each timed row under its row name,
    with the source and TPU kernel of its f32 kernel, its launches on its
    PRECISION path and its largest error against the plain version."""
    out = []
    for r in rows:
        counter, f32 = BF16_ROWS[r["name"]]
        out.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[f32],
            "replaces": REPLACES[f32], "launches": r.pop("path_launches"),
            "counter": counter,
            "max_abs_err": float(errs.get(r["name"], 0.0)),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            **{k: v for k, v in r.items()
               if k not in ("name", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}})
    return out


def rename_rows(rows, names):
    """Timed rows of the f32 helpers under their bf16 row names (K3's
    rounds' mask becomes a row of its own)."""
    out = []
    for r in rows:
        pm = r.pop("path_mask", None)
        r["name"] = names[r["name"]]
        out.append(r)
        if pm is not None:
            out.append(dict(name="K3-p-bf16", ms=pm["ms"],
                            plain_ms=pm["plain_ms"], bound_ms=pm["bound_ms"],
                            bound_by=pm["bound_by"], valid=pm["valid"],
                            gemm_ms=r.get("gemm_ms"), shape=r["shape"]))
    return out


def inertia_split(X, C, labels):
    """(exact SSE of the rows rounded to bf16 against the fitted centers
    rounded to bf16, the score convention's term Σ (|c|² − |ĉ|²) over each
    row's center), float64 on the card: a bf16 fit's ``inertia_`` is their
    sum, as the kernels' scores take |c|² from the f32 centers."""
    import torch

    Cd = torch.as_tensor(C, device=X.device)
    Cr = Cd.to(torch.bfloat16).double()
    lab = torch.as_tensor(labels, device=X.device).long()
    term = ((Cd.double() ** 2).sum(1) - (Cr ** 2).sum(1))[lab].sum()
    sse = torch.zeros((), dtype=torch.float64, device=X.device)
    for s in range(0, X.shape[0], 1 << 18):
        xs = X[s:s + (1 << 18)].to(torch.bfloat16).double()
        sse += ((xs - Cr[lab[s:s + (1 << 18)]]) ** 2).sum()
    return float(sse), float(term)


def precision_blobs(dev, errs, f32_inertia=None):
    """``precision-blobs``: ``KMeans(init="k-means||").fit(X).predict(X)``
    on the blobs under ``precision="bf16"`` (K3 and K4 in the init, K1 in
    the Lloyd loop, K2 in predict, all on bf16 X). Gates: ARI ≥ 0.99
    against the truth; the bf16 fit's centers scored on the f32 data
    within 1e-2 of the f32 fit's inertia; its ``inertia_`` the exact SSE
    of the rounded rows plus the score convention's term (within 1e-5);
    the kernel's labels from the fitted centers the plain version's, but
    for near-ties. Then the kernels at the full shape on float data
    against the plain versions (tolerances of the f32 checks) and against
    the f32 kernels on X widened (bit for bit), and their timings."""
    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.ops import fused_distance as fd
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    X, y_true = drawn("blobs", lambda: blobs_data(SEED))
    kw = dict(n_clusters=K, init="k-means||", oversampling_factor=2,
              random_state=SEED)
    if f32_inertia is None:
        f32_inertia = KMeans(**kw).fit(X).inertia_

    def fit_predict():
        km = KMeans(**kw).fit(X)
        return km, km.predict(X)

    with config_context(precision="bf16"):
        (km, pred), sec, launches = drive(fit_predict)
        data = prepare_data(X, device=dev)
    X16, w = data.X, data.weights
    expect(X16.dtype == torch.bfloat16, f"staged {X16.dtype}, not bf16")
    expect_launches("precision-blobs", launches)
    expect(np.array_equal(pred, km.labels_), "bf16 predict(X) != labels_")
    score = ari(y_true, pred)
    Xd = torch.from_numpy(X).to(dev)
    C = torch.as_tensor(km.cluster_centers_, device=dev)
    _, mind = fd.fused_argmin_min(Xd, C, kernel="cuda")
    quality = float(mind.double().sum())  # the fit's centers, f32 data
    sse, term = inertia_split(Xd, km.cluster_centers_, km.labels_)
    del Xd
    lk = core.predict_labels(X16, C, kernel="cuda")
    lp = core.predict_labels(X16, C, kernel="torch")
    ties = near_tie_ok(X16, C, None, lk, lp)
    out = {"n": N, "d": D, "k": K, "seconds": sec, "ari": score,
           "inertia_bf16": km.inertia_,
           "inertia_f32": f32_inertia,
           "inertia_rel_delta": (km.inertia_ - f32_inertia) / f32_inertia,
           "centers_inertia_on_f32_data": quality,
           "centers_rel_delta": (quality - f32_inertia) / f32_inertia,
           "sse_of_rounded_rows": sse, "score_convention_term": term,
           "kernel_vs_plain_label_near_ties": ties,
           "phases": km.fit_phase_seconds_}
    path_line("precision-blobs", sec, km.n_iter_, launches, **out)
    out["n_iter"] = km.n_iter_
    expect(score >= 0.99, f"bf16 blobs ARI {score} < 0.99")
    expect(abs(out["centers_rel_delta"]) <= P_INERTIA_RTOL,
           f"bf16 blobs: the fit's centers cost {quality} on the data, "
           f"the f32 fit's {f32_inertia}")
    # rtol 1e-5: each row's minimum is |c|² − 2x·c + |x|² in f32, terms
    # ≈ 35 times the distance at this cell, and 1e6 of them are summed
    expect(abs(km.inertia_ - (sse + term)) <= 1e-5 * f32_inertia,
           f"bf16 blobs inertia_ {km.inertia_} is not the rounded rows' SSE "
           f"{sse} plus the convention's term {term}")
    # the kernels at the full shape, float data
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 13)
    pick = torch.randperm(N, generator=g, device=dev)
    for name, m, valid in (("K2/K3/K4 m=8", K, K),
                           ("K3 m=80, the rounds' mask", ROUND_CAP,
                            ROUND_COUNT),
                           ("K4 m=329", WEIGHT_CAND, WEIGHT_CAND // 2)):
        Y = X16[pick[:m]].float()
        mask = torch.arange(m, device=dev) < valid
        for k, v in check_fused("bf16 " + name, X16, Y, mask, w,
                                exact=False).items():
            row = {"fused_argmin_min": "K2-bf16",
                   "fused_rowwise_min": "K3-bf16",
                   "fused_argmin_weight": "K4-bf16"}[k]
            errs[row] = max(errs.get(row, 0.0), v)
        need = torch.rand(N, generator=g, device=dev) > 0.5
        share, ties = bf16_fused_against(
            "blobs " + name, X16, Y, mask, w, need,
            torch.rand(N, generator=g, device=dev), exact=False)
        out.setdefault("score_bound", {})[name] = {
            "max_share_of_bound": share, "near_tie_rows": ties}
    errs["K1-bf16"] = check_lloyd("bf16 K1 blobs", X16, w, C, exact=False)
    expect(all(torch.equal(a, b) for a, b in zip(
        core._lloyd_stats_cuda(X16, w, C),
        f32_lloyd_direct(X16.float().contiguous(), w, C))),
        "bf16 K1 at the blobs: not the f32 kernel's bits on X widened")
    rows = rename_rows(time_kernels(X16, w), {
        "lloyd_iter": "K1-bf16", "fused_argmin_min": "K2-bf16",
        "fused_rowwise_min": "K3-bf16", "fused_argmin_weight": "K4-bf16"})
    return with_launches(rows, launches), out


def precision_kdd(dev, errs):
    """``precision-kdd``: the KDD-shaped cell through ``algorithm=
    "bounded"`` (K5) and ``"full"`` (K1) under ``precision="bf16"``, the
    bounds f32 (``lloyd_bounds_dtype``); the bounded loop against the
    two-pass loop from the same init on bf16 X, bit for bit; K5 and K1 at
    the cell's shape against their plain versions and the f32 kernels on
    X widened; their timings."""
    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.ops import fused_distance as fd
    from dask_ml_tpu_torch.parallel.precision import lloyd_bounds_dtype
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.utils.validation import check_random_state

    X = drawn("kdd", lambda: kdd_data(KDD_N, KDD_D, SEED))

    def fit_predict(algorithm):
        km = KMeans(n_clusters=K, init="k-means||", oversampling_factor=2,
                    algorithm=algorithm, random_state=SEED).fit(X)
        return km, km.predict(X)

    out = {"n": KDD_N, "d": KDD_D, "k": K}
    with config_context(precision="bf16"):
        (kmb, pb), sec_b, l_b = drive(lambda: fit_predict("bounded"))
        (kmf, pf), sec_f, l_f = drive(lambda: fit_predict("full"))
        data = prepare_data(X, device=dev)
        bdt = lloyd_bounds_dtype(data.X.dtype)
    expect(bdt == torch.float32, f"bf16 bounds dtype {bdt}")
    Xd, wd = data.X, data.weights
    expect(Xd.dtype == torch.bfloat16, "the KDD data did not stage bf16")
    expect_launches("precision-kdd-bounded", l_b)
    expect_launches("precision-kdd-full", l_f)
    expect(l_b["lloyd_iter_bf16"] == 0, "the bounded path ran K1")
    expect(np.array_equal(pb, kmb.labels_) and np.array_equal(pf, kmf.labels_),
           "bf16 KDD predict != labels_")
    for name, km, sec, ll in (("precision-kdd-bounded", kmb, sec_b, l_b),
                              ("precision-kdd-full", kmf, sec_f, l_f)):
        path_line(name, sec, km.n_iter_, ll, inertia=km.inertia_,
                  phases=km.fit_phase_seconds_)
    out.update(bounded_s=sec_b, full_s=sec_f, bounded_n_iter=kmb.n_iter_,
               full_n_iter=kmf.n_iter_,
               bounded_vs_full_label_diff=int((kmb.labels_
                                               != kmf.labels_).sum()),
               bounded_vs_full_center_max_abs_diff=float(np.abs(
                   kmb.cluster_centers_ - kmf.cluster_centers_).max()),
               rows_skipped=kmb.lloyd_pruning_["rows_skipped"])
    # the loop against its oracle on bf16 X, bounds f32
    c0 = core.k_init(Xd, wd, data.n, K, check_random_state(SEED, device=dev),
                     init="k-means||", oversampling_factor=2)
    tol = core.scaled_tolerance(Xd, wd, 1e-4)
    co, _, no, so = core.lloyd_loop(Xd, wd, c0, tol, max_iter=300,
                                    kernel="cuda")
    cb, ib, nb, sb, lb, st = core.lloyd_loop_bounded(
        Xd, wd, c0, tol, max_iter=300, kernel="cuda", bounds_dtype=bdt)
    expect(torch.equal(co, cb) and no == nb and float(so) == float(sb),
           "bf16: bounded loop != two-pass loop from the same init")
    expect(torch.equal(lb, core.predict_labels(Xd, co, kernel="cuda")),
           "bf16: bounded labels != predict_labels of the oracle's centers")
    out.update(oracle_n_iter=nb,
               oracle_rows_skipped=int(st["rows_skipped"].sum()))
    log(f"bf16 KDD: bounded loop == two-pass loop bit for bit ({nb} "
        f"iterations, bounds {bdt})")
    # K5 and K1 at the cell's shape
    C = torch.as_tensor(kmb.cluster_centers_, device=dev)
    X_pad, w_pad = core._pad_rows_to_blocks(Xd, wd)
    e = check_min2_sketched("bf16 KDD K5", X_pad, C, None, None, exact=False)
    errs["K5-bf16"] = e["fused_argmin_min2"]
    need = torch.rand(X_pad.shape[0], device=dev) > 0.5
    bf16_fused_against("KDD", X_pad, C, None, w_pad, need,
                       torch.rand(X_pad.shape[0], device=dev), exact=False)
    errs["K1-kdd-bf16"] = check_lloyd("bf16 K1 KDD", Xd, wd, C, exact=False)
    expect(all(torch.equal(a, b) for a, b in zip(
        core._lloyd_stats_cuda(Xd, wd, C),
        f32_lloyd_direct(Xd.float().contiguous(), wd, C))),
        "bf16 K1 at the KDD shape: not the f32 kernel's bits on X widened")
    fdl = build.load("fused_distance")
    stream = build.stream_of(Xd)
    npad, d = X_pad.shape
    gall = torch.ones(-(-npad // fd._FUSED_BLK), dtype=torch.uint8,
                      device=dev)
    all_need = torch.ones(npad, dtype=torch.bool, device=dev)
    b, by = bound(2 * npad * d + 4 * (K * d + 3 * npad), 2 * npad * K * d,
                  X_pad.dtype)
    # a late bounded iteration's row need: 0.1 % of the groups (drawn from
    # a seed), the kernel against the f32 kernel on X widened, bit for bit
    ng = gall.numel()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    nl = max(1, round(LATE_SHARE * ng))
    late = torch.zeros(ng, dtype=torch.uint8, device=dev)
    late[torch.randperm(ng, generator=gen, device=dev)[:nl]] = 1
    late_rows = late.bool().repeat_interleave(fd._FUSED_BLK)[:npad]
    got = fd.fused_argmin_min2(X_pad, C, kernel="cuda", row_need=late_rows)
    want = f32_fused_direct(X_pad.float().contiguous(),
                            C.to(torch.bfloat16).float().contiguous(),
                            fd._row_sumsq(C).contiguous(), None,
                            "argmin_min2", need=late_rows)
    expect(all(torch.equal(g_, w_) for g_, w_ in zip(got, want)),
           "bf16 K5 with 0.1 % of the groups: not the f32 kernel's bits")
    del got, want
    ne = nl * fd._FUSED_BLK
    b_l, by_l = bound(2 * ne * d + 4 * (K * d + 3 * npad), 2 * ne * K * d,
                      X_pad.dtype)
    rows = [dict(name="K5-bf16",
                 ms=cuda_ms(fused_call(fdl, stream, X_pad, C, 3, gneed=gall)),
                 plain_ms=cuda_ms(lambda: fd.fused_argmin_min2(
                     X_pad, C, kernel="torch", row_need=all_need), iters=5,
                     warmup=1),
                 bound_ms=b, bound_by=by, shape={"n": npad, "m": K, "d": d},
                 late_need={
                     "evaluated_fraction": nl / ng,
                     "ms": cuda_ms(fused_call(fdl, stream, X_pad, C, 3,
                                              gneed=late)),
                     "plain_ms": cuda_ms(lambda: fd.fused_argmin_min2(
                         X_pad, C, kernel="torch", row_need=late_rows),
                         iters=5, warmup=1),
                     "bound_ms": b_l, "bound_by": by_l})]
    r1 = lloyd_row(Xd, wd, C)
    r1["name"] = "K1-kdd-bf16"
    return with_launches([r1], l_f) + with_launches(rows, l_b), out


def precision_sparse_glm(dev, errs):
    """``precision-sparse-glm``: the sparse cell's host container (drawn
    once) staged with bf16 values under ``precision="bf16"``, then
    ``LogisticRegression(solver="lbfgs", max_iter=3)`` and ``score``: K6
    and K6-b in bf16. Gates: accuracy above 0.55; coefficients within
    5e-2 of the f32 fit; a second fit the same bits; one L-BFGS step
    through the kernels and through the plain versions from a shared
    carry, the same coefficients bit for bit. Then K6 and K6-b at the
    full container against their plain versions, and their timings."""
    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.linear_model.glm import add_intercept
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.ops import sparse as sps
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    X, y = drawn("sparse_glm", sparse_glm_data)
    f32 = LogisticRegression(solver="lbfgs", max_iter=GLM_ITERS).fit(X, y)
    Xs, ys = X[:GLM_SCORE_N], y[:GLM_SCORE_N]
    with config_context(precision="bf16"):
        est, sec, l_fit = drive(lambda: LogisticRegression(
            solver="lbfgs", max_iter=GLM_ITERS).fit(X, y))
        acc, score_s, l_score = drive(lambda: est.score(Xs, ys))
        again = LogisticRegression(solver="lbfgs",
                                   max_iter=GLM_ITERS).fit(X, y)
        data = prepare_data(X, y=y, device=dev)
    expect_launches("precision-sparse-glm", l_fit)
    expect(l_score["spmv_bf16"] + l_score["spmv_l2_bf16"] == 1,
           f"bf16 score launches {l_score}")
    coef_rel = float(np.linalg.norm(est._coef - f32._coef)
                     / np.linalg.norm(f32._coef))
    out = {"n": GLM_N, "d": GLM_D, "seconds": sec, "score_s": score_s,
           "accuracy": acc,
           "accuracy_f32": f32.score(Xs, ys), "coef_rel_vs_f32": coef_rel,
           "second_fit_equal": bool(np.array_equal(again._coef, est._coef)),
           "phases": est.fit_phase_seconds_}
    expect(acc > 0.55, f"bf16 sparse accuracy {acc}")
    expect(coef_rel <= P_COEF_RTOL, f"bf16 sparse coefficients {coef_rel} "
           f"from the f32 fit's")
    expect(out["second_fit_equal"], "two bf16 sparse fits differ")
    Xd = add_intercept(data.X)
    data.X = None
    expect(Xd.values.dtype == torch.bfloat16 and Xd.cols.dtype == torch.int32,
           f"staged {Xd.values.dtype} values, {Xd.cols.dtype} cols")
    d = Xd.d
    mask = torch.ones(d, device=dev)
    mask[-1] = 0.0
    b0 = torch.zeros(d, device=dev)

    def lbfgs(kernel, **kw):
        return glm_core.lbfgs(Xd, data.y, data.weights, b0, mask,
                              lamduh=1.0 / est.C, tol=est.tol, kernel=kernel,
                              **kw)

    _, _, state, _ = lbfgs("cuda", max_iter=0, return_state=True)
    for it in range(GLM_ITERS):
        steps = [lbfgs(kn, max_iter=1, state=state, return_state=True)[2]
                 for kn in ("cuda", "torch")]
        expect(torch.equal(steps[0][0], steps[1][0]),
               f"bf16 sparse step {it}: kernel and plain steps differ")
        state = steps[0]
    out["steps_equal"] = GLM_ITERS
    path_line("precision-sparse-glm", sec, est.n_iter_, l_fit,
              score_launches=l_score, **out)
    out["n_iter"] = est.n_iter_
    # the two kernels at the full container
    n, k = Xd.values.shape
    v = torch.as_tensor(est._coef, device=dev)
    r = (torch.sigmoid(sps._spmv_cuda(Xd.values, Xd.cols, v)) - data.y) / n
    fk = sps._spmv_cuda(Xd.values, Xd.cols, v)
    fp = sps._spmv_ref(Xd.values, Xd.cols, v)
    errs["K6-bf16"] = float((fk - fp).abs().max())
    scale = sps.matvec(sps.SparseRows(Xd.values.abs(), Xd.cols, d),
                       v.to(torch.bfloat16).float().abs(), kernel="torch")
    expect(bool(((fk - fp).abs() <= k * 2.0 ** -23 * scale + 1e-30).all()),
           "bf16 K6 at the container: beyond its rounding bound")
    gk = sps._pullback_cuda(Xd.values, Xd.cols, r, d)
    gp = sps._pullback_ref(Xd.values, Xd.cols, r, d)
    errs["K6-b-bf16"] = float((gk - gp).abs().max())
    # the function summed in float64: the bf16 values times the f32 r
    g64 = torch.zeros(d, dtype=torch.float64, device=dev)
    for s in range(0, n, 1 << 20):
        prods = (Xd.values[s:s + (1 << 20)].double()
                 * r[s:s + (1 << 20), None].double())
        g64.index_add_(0, Xd.cols[s:s + (1 << 20)].reshape(-1),
                       prods.reshape(-1))
    # the gates of the f32 pullback (pullback_accuracy): the columns before
    # the intercept's within 1e-5 normwise, the intercept's within 1e-3
    acc_k = {"other_columns_normwise_err": rel(gk[:-1], g64[:-1]),
             "last_column_rel_err": float((gk[-1].double() - g64[-1]).abs()
                                          / g64[-1].abs())}
    acc_p = {"other_columns_normwise_err": rel(gp[:-1], g64[:-1]),
             "last_column_rel_err": float((gp[-1].double() - g64[-1]).abs()
                                          / g64[-1].abs())}
    out.update(pullback_vs_f64=acc_k, plain_pullback_vs_f64=acc_p)
    expect(acc_k["other_columns_normwise_err"] <= 1e-5
           and acc_k["last_column_rel_err"] <= 1e-3,
           f"bf16 K6-b at the container against the float64 sum of its "
           f"rounded products: {acc_k}")
    expect_repeats("bf16 K6-b at the container",
                   lambda: sps._pullback_cuda(Xd.values, Xd.cols, r, d), gk)
    nbytes = n * k * (2 + 4) + 4 * (d + n)
    b, by = bound(nbytes, 2 * n * k, Xd.values.dtype)
    rows = [dict(name="K6-bf16",
                 ms=cuda_ms(lambda: sps._spmv_cuda(Xd.values, Xd.cols, v),
                            iters=10, warmup=2),
                 plain_ms=cuda_ms(lambda: sps._spmv_ref(Xd.values, Xd.cols,
                                                        v), iters=3, warmup=1),
                 bound_ms=b, bound_by=by,
                 cluster=sps.dvector_plan(n, k, d, dtype=Xd.values.dtype),
                 shape={"n": n, "k": k, "d": d}),
            dict(name="K6-b-bf16",
                 ms=cuda_ms(lambda: sps._pullback_cuda(Xd.values, Xd.cols, r,
                                                       d), iters=10,
                            warmup=2),
                 plain_ms=cuda_ms(lambda: sps._pullback_ref(
                     Xd.values, Xd.cols, r, d), iters=3, warmup=1),
                 bound_ms=b, bound_by=by,
                 cluster=sps.dvector_plan(n, k, d, pullback=True),
                 walk=sps._pullback_walk(
                     Xd.values, Xd.cols, r, d,
                     sps.dvector_plan(n, k, d, pullback=True)),
                 shape={"n": n, "k": k, "d": d})]
    log("    K6 bf16 library: none (cuSPARSE's bf16 SpMV through torch.mv "
        "returns bf16, not the f32 sums of the kernel)")
    del Xd, data, r, fk, fp, gk, gp, g64, scale
    launches = {key: l_fit[key] + l_score[key] for key in l_fit}
    return (with_launches(rows[:1], launches)
            + with_launches(rows[1:], l_fit)), out


def precision_dense_glm(dev):
    """``precision-dense-glm``: ``LogisticRegression(solver="lbfgs",
    max_iter=DG_ITERS)`` on a dense X at the dense GLM bench's shape,
    drawn on the card, in f32 and in bf16 (X staged in bf16 once, as
    ``prepare_data`` stages it), fitted in turns (f32, bf16, bf16, f32).
    No kernel of the repo runs: every contraction is ``pmatmul`` (one
    bf16-in / f32-out GEMM) or ``pullback_matmul`` (the f32 cotangent
    split into three bf16 columns). Gates: bf16 coefficients finite and
    within 5e-2 of the f32 fit's. The two contractions are timed alone
    with CUDA events beside the f32 product and the widened form (the
    bf16 X copied to f32, then the f32 product)."""
    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.parallel import precision as px

    n, d = ADMM_N, ADMM_D
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)
    X = torch.randn(n, d, generator=g, device=dev)
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    yd = (torch.rand(n, generator=g, device=dev)
          < torch.sigmoid(X @ beta)).to(torch.float32)
    y = yd.cpu().numpy()  # the facade encodes labels on the host
    X16 = X.to(torch.bfloat16)
    kw = dict(solver="lbfgs", max_iter=DG_ITERS)

    def fit(prec, Xs):
        with config_context(precision=prec):
            return LogisticRegression(**kw).fit(Xs, y)

    fit("f32", X)
    fit("bf16", X16)
    runs = {"f32": [], "bf16": []}
    fits = {}
    for prec, Xs in (("f32", X), ("bf16", X16), ("bf16", X16),
                     ("f32", X)):
        fits[prec], sec, _ = drive(lambda: fit(prec, Xs))
        runs[prec].append(sec)
    c32 = np.r_[fits["f32"].coef_, fits["f32"].intercept_]
    c16 = np.r_[fits["bf16"].coef_, fits["bf16"].intercept_]
    rel = float(np.linalg.norm(c16 - c32) / np.linalg.norm(c32))
    expect(np.isfinite(c16).all() and rel <= P_COEF_RTOL,
           f"dense bf16 L-BFGS coefficients {rel} from the f32 fit's")
    v = beta.contiguous()
    r = (torch.sigmoid(X @ beta) - yd).contiguous()
    r2 = r[:, None]
    contractions = {
        "matvec": {"f32_ms": cuda_ms(lambda: X @ v),
                   "bf16_ms": cuda_ms(lambda: px.pmatmul(X16, v)),
                   "widened_ms": cuda_ms(lambda: X16.float() @ v.to(
                       torch.bfloat16).float())},
        "pullback": {"f32_ms": cuda_ms(lambda: X.T @ r),
                     "bf16_ms": cuda_ms(lambda: px.pullback_matmul(X16.T,
                                                                   r2)),
                     "widened_ms": cuda_ms(lambda: X16.float().T @ r)}}
    out = {"n": n, "d": d, "max_iter": DG_ITERS,
           "f32_seconds": runs["f32"], "bf16_seconds": runs["bf16"],
           "f32_n_iter": int(fits["f32"].n_iter_),
           "coef_rel_to_f32": rel, "contractions": contractions}
    path_line("precision-dense-glm", sum(runs["bf16"]) / 2,
              int(fits["bf16"].n_iter_), {}, **out)
    del X, X16, yd, r, r2
    return [], out


def wire_block_breakdown(blk, dev, reps: int = 3):
    """Host-clock ms (the least of ``reps``) of the steps one bf16 wire
    block takes in ``cast_wire(pin=True)`` and its copy, on one X block:
    the whole cast, its parts (a pinned buffer's allocation, the cast
    into it, the cast into pageable memory alone), the bf16 block's copy
    to the card, and the f32 block's copy from page-locked memory."""
    import torch

    from dask_ml_tpu_torch.parallel import precision as px

    t = torch.from_numpy(blk)
    pinned = torch.empty(t.shape, dtype=torch.bfloat16, pin_memory=True)
    f32_pinned = t.pin_memory()

    def best(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    out = {"block_bytes_f32": t.numel() * 4,
           "cast_wire_pinned": best(lambda: px.cast_wire(
               (blk,), torch.bfloat16, pin=True)),
           "pinned_alloc": best(lambda: torch.empty(
               t.shape, dtype=torch.bfloat16, pin_memory=True)),
           "cast_into_pinned": best(lambda: pinned.copy_(t)),
           "cast_pageable": best(lambda: t.to(torch.bfloat16)),
           "h2d_bf16_pinned": best(lambda: pinned.to(dev,
                                                     non_blocking=True)),
           "h2d_f32_pinned": best(lambda: f32_pinned.to(
               dev, non_blocking=True))}
    del pinned, f32_pinned
    return out


def wire_host_profile(run, top: int = 8):
    """One run of ``run`` under ``torch.profiler`` with the telemetry
    spans on: its wall ms, the host ms inside the ``stream.transfer``
    spans (the wire cast and the copies' issue), the ATen operators' self
    host ms and calls in all, the device's busy ms (kernels and copies),
    and the ``top`` ATen operators by self host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dask_ml_tpu_torch import config_context

    with config_context(telemetry=True), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    spans = [e for e in ev if e.key.startswith("stream.transfer")]
    aten = [e for e in ev if e.key.startswith("aten::")]
    ops = sorted(aten, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:top]
    busy = sum((getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
               for e in ev if e.device_type == DeviceType.CUDA) / 1e3
    return {"wall_ms": wall, "transfer_spans": sum(e.count for e in spans),
            "transfer_host_ms": sum(e.cpu_time_total for e in spans) / 1e3,
            "aten_self_host_ms": sum(e.self_cpu_time_total
                                     for e in aten) / 1e3,
            "aten_calls": sum(e.count for e in aten),
            "device_busy_ms": busy,
            "top_self_host_ms": {e.key: e.self_cpu_time_total / 1e3
                                 for e in ops}}


def precision_stream(dev, tmp):
    """``precision-stream``: step 10's host-streamed ADMM (the dense ADMM
    cell's arrays in 8 blocks) and streamed PCA (the PCA cell's arrays)
    under the bf16 wire, each beside its f32 run. Gates: wire bytes ≤
    logical / 1.8; ADMM coefficients within 5e-2 and the top explained
    variances within 2e-2 of the f32 runs; the moments of the bf16 blocks
    within 1e-5 of their float64 moments (compensated sums); a bf16 ADMM
    run preempted and resumed, and a bf16 moment pass preempted and
    resumed, bit for bit. GB/s as both wire and logical bytes, and the
    host-side steps of one ADMM wire block (:func:`wire_block_breakdown`)
    and a profile of one f32 and one bf16 ADMM run
    (:func:`wire_host_profile`)."""
    import os

    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.decomposition.streaming import (pca_fit_blocks,
                                                           streamed_moments)
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel.faults import FaultInjector, Preempted
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    Xa, ya = drawn("admm", lambda: admm_data(SEED))
    Xp = drawn("pca", lambda: pca_data(SEED))
    B = HOST_BLOCKS
    out = {}
    # -- ADMM --------------------------------------------------------------
    n, d = Xa.shape
    w = np.ones(n, np.float32)
    kw = dict(family="logistic", regularizer="l2", lamduh=1.0, abstol=0.0,
              reltol=0.0, max_iter=HOST_OUTER, return_state=True)
    src32 = HostBlockSource((Xa, ya, w), B, storage_dtype=None)
    with config_context(precision="bf16"):
        src16 = HostBlockSource((Xa, ya, w), B)
    expect(src16.storage_dtype == torch.bfloat16, "the wire is not bf16")
    runs = {}
    steps = {}
    for name, src in (("f32", src32), ("bf16", src16), ("bf16", src16),
                      ("f32", src32)):
        src.reset_stats()
        glm_core.reset_host_reads()
        (_, it, st, _), sec, _ = drive(lambda: glm_core.admm_streamed(
            src, B, d, float(n), **kw))
        steps[name] = glm_core.host_reads["newton_steps"]
        runs.setdefault(name, []).append(
            (sec, st, src.bytes_streamed, src.logical_bytes_streamed))
    (s32, st32, w32, _), (s16, st16, w16, l16) = (
        min(runs["f32"], key=lambda t: t[0]),
        min(runs["bf16"], key=lambda t: t[0]))
    expect(all(states_equal(st16, t[1]) for t in runs["bf16"]),
           "two bf16 streamed ADMM runs differ")
    for a in st16:
        expect(a.dtype == torch.float32, f"bf16 ADMM state {a.dtype}")
    admm = {"n": n, "d": d, "blocks": B, "outer": HOST_OUTER,
            "seconds_f32": s32, "seconds_bf16": s16,
            "wire_bytes_f32": w32, "wire_bytes_bf16": w16,
            "logical_bytes_bf16": l16, "wire_reduction": l16 / w16,
            "wire_gbps_f32": w32 / s32 / 1e9,
            "wire_gbps_bf16": w16 / s16 / 1e9,
            "logical_gbps_bf16": l16 / s16 / 1e9,
            "coef_rel_vs_f32": rel(st16[0], st32[0]),
            "newton_steps_f32": steps["f32"],
            "newton_steps_bf16": steps["bf16"]}
    admm["wire_block_ms"] = wire_block_breakdown(Xa[:n // B], dev)
    for name, src in (("f32", src32), ("bf16", src16)):
        admm[f"profile_{name}"] = wire_host_profile(
            lambda: glm_core.admm_streamed(src, B, d, float(n), **kw))
    expect(l16 / w16 >= P_WIRE, f"bf16 ADMM wire reduction {l16 / w16}")
    expect(admm["coef_rel_vs_f32"] <= P_COEF_RTOL,
           f"bf16 ADMM coefficients {admm['coef_rel_vs_f32']} from f32")
    path = f"{tmp}/admm-bf16.ckpt"
    inj = FaultInjector().preempt_at(5, epoch=1)
    with config_context(precision="bf16"):
        try:
            glm_core.admm_streamed(HostBlockSource((Xa, ya, w), B,
                                                   fault_injector=inj),
                                   B, d, float(n), checkpoint_path=path,
                                   **kw)
            raise Mismatch("the injected preemption did not stop the fit")
        except Preempted:
            pass
    expect(os.path.exists(path), "no bf16 snapshot after the preemption")
    _, _, st_r, _ = glm_core.admm_streamed(src16, B, d, float(n),
                                           checkpoint_path=path, **kw)
    admm["resumed_equal"] = states_equal(st16, st_r)
    expect(admm["resumed_equal"], "bf16 streamed ADMM: the resume differs")
    path_line("precision-stream-admm", s16, HOST_OUTER, {}, **admm)
    out["admm"] = admm
    src32.close()
    src16.close()
    torch.cuda.empty_cache()
    # -- PCA ---------------------------------------------------------------
    n, d = Xp.shape
    w = np.ones(n, np.float32)
    src32 = HostBlockSource((Xp, w), B, storage_dtype=None)
    with config_context(precision="bf16"):
        src16 = HostBlockSource((Xp, w), B)
    m32, s32, _ = drive(lambda: streamed_moments(block_fn=src32,
                                                 n_blocks=B))
    w32 = src32.bytes_streamed
    src16.reset_stats()
    m16, s16, _ = drive(lambda: streamed_moments(block_fn=src16,
                                                 n_blocks=B))
    w16, l16 = src16.bytes_streamed, src16.logical_bytes_streamed
    Xr = torch.from_numpy(Xp).to(dev).to(torch.bfloat16).double()
    want = (torch.tensor(float(n), dtype=torch.float64, device=dev),
            Xr.sum(0), Xr.T @ Xr)
    del Xr
    torch.cuda.empty_cache()
    m_rel = [rel(a.double(), b) for a, b in zip(m16, want)]
    e32 = pca_fit_blocks(src32, B, PCA_K)
    e16 = pca_fit_blocks(src16, B, PCA_K)
    ev = (np.abs(e16.explained_variance_ - e32.explained_variance_)
          / e32.explained_variance_)
    pth = f"{tmp}/moments-bf16.ckpt"
    inj = FaultInjector().preempt_at(3)
    with config_context(precision="bf16"):
        try:
            streamed_moments(block_fn=HostBlockSource(
                (Xp, w), B, fault_injector=inj), n_blocks=B,
                checkpoint_path=pth, checkpoint_every=2)
            raise Mismatch("the injected preemption did not stop the pass")
        except Preempted:
            pass
    resumed = streamed_moments(block_fn=src16, n_blocks=B,
                               checkpoint_path=pth)
    pca = {"n": n, "d": d, "blocks": B, "seconds_f32": s32,
           "seconds_bf16": s16, "wire_bytes_f32": w32,
           "wire_bytes_bf16": w16, "logical_bytes_bf16": l16,
           "wire_reduction": l16 / w16, "wire_gbps_f32": w32 / s32 / 1e9,
           "wire_gbps_bf16": w16 / s16 / 1e9,
           "logical_gbps_bf16": l16 / s16 / 1e9,
           "moments_rel_vs_f64_of_rounded": m_rel,
           "top64_explained_variance_rel": float(ev[:PCA_RANK].max()),
           "all_explained_variance_rel": float(ev.max()),
           "resumed_equal": states_equal(m16, resumed)}
    path_line("precision-stream-pca", s16, None, {}, **pca)
    expect(l16 / w16 >= P_WIRE, f"bf16 PCA wire reduction {l16 / w16}")
    expect(max(m_rel) <= MOMENT_RTOL, f"bf16 streamed moments {m_rel}")
    expect(pca["top64_explained_variance_rel"] <= P_VAR_RTOL,
           "bf16 streamed PCA variances "
           f"{pca['top64_explained_variance_rel']}")
    expect(pca["resumed_equal"], "bf16 streamed moments: the resume differs")
    out["pca"] = pca
    src32.close()
    src16.close()
    return out


def precision_cells(dev, f32_inertia=None):
    """The PRECISION phase: the bf16 kernel checks, then the four cells
    (``precision-blobs``, ``precision-kdd``, ``precision-sparse-glm``,
    ``precision-stream``), each path's launches reset just before it and
    read just after. Returns (the kernels line's bf16 rows, summary)."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    precision_kernel_checks(dev)
    log(f"PRECISION kernel checks: bf16 K1-K6 match their plain versions "
        f"on integer data, K1, K2 and K5 the f32 kernels on X widened on "
        f"any data, the tensor-core K3 and K4 within the score bound on "
        f"float data ({time.perf_counter() - t0:.2f} s)")
    errs = {}
    summary = {}
    rows = []
    for name, cell in (("blobs", lambda: precision_blobs(dev, errs,
                                                         f32_inertia)),
                       ("kdd", lambda: precision_kdd(dev, errs)),
                       ("sparse_glm", lambda: precision_sparse_glm(dev,
                                                                   errs)),
                       ("dense_glm", lambda: precision_dense_glm(dev))):
        torch.cuda.empty_cache()
        r, summary[name] = cell()
        rows += r
    tmp = tempfile.mkdtemp(prefix="chip_smoke_precision_")
    try:
        torch.cuda.empty_cache()
        summary["stream"] = precision_stream(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = bf16_rows(rows, errs)
    missing = [r["name"] for r in rows if r["launches"] == 0]
    expect(not missing, f"bf16 rows never launched on their paths: "
           f"{missing}")
    for r in rows:
        log(f"  {r['name']:12s} {r['ms']:.4f} ms  bound {r['bound_ms']:.4f}"
            f" ms ({r['bound_by']})  plain {r['plain_ms']:.4f} ms  "
            f"launches {r['launches']}  max_abs_err {r['max_abs_err']:.3e}")
    summary["seconds"] = time.perf_counter() - t0
    log("PRECISION " + json.dumps(summary))
    return rows, summary



# ---------------------------------------------------------------------------
# the serving tier (SERVING)
# ---------------------------------------------------------------------------

# the serving step: the loop's batch budget, the models' row counts, the
# request sizes of the JAX serving drill (bench.py bench_serving) and two
# larger ones, the closed-loop clients, the identity sizes on each side of
# every bucket boundary
SRV_MAX_ROWS = 2048
SRV_FIT_N, SRV_PCA_N, SRV_PCA_D, SRV_PCA_K = 1_000_000, 200_000, 1_000, 100
SRV_GLM_D, SRV_KDD_K = 100, 8
SRV_SIZES = (1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 512, 2048)
SRV_CLIENTS, SRV_REQUESTS = 32, 64
SRV_DEADLINE_S = 0.5
SRV_IDENTITY = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                511, 512, 513, 1023, 1024, 1025, 2047, 2048)
SRV_POOL = 65_536
# the GEMM runners (GLM, PCA) against their direct calls: a served row may
# take another cuBLAS algorithm than the direct call's (the row count
# differs), so values are held within this share of the request's largest
# value, and labels wherever the margin exceeds it
SRV_GEMM_RTOL = 1e-5
# the fleet: replicas on the one card, the kill and the straggler
SRV_KILL_AFTER, SRV_STRAGGLE_S, SRV_STRAGGLE_EVERY = 20, 0.005, 10
# the sparse request of the fallback: rows and density at the GLM's width
SRV_SPARSE_N, SRV_SPARSE_DENSITY = 2048, 0.1


def serving_models(dev):
    """The fitted models of the serving step and their request pools,
    fitted once a run: the wire step (18) serves the models step 17
    fitted."""
    return drawn("serving models", lambda: fit_serving_models(dev))


def fit_serving_models(dev):
    """The fitted models of the serving step, each at full model width,
    and the host rows its requests are cut from. Returns ({name: est},
    {name: host rows})."""
    import torch

    from dask_ml_tpu_torch.cluster import (KMeans, MiniBatchKMeans,
                                           SpectralClustering)
    from dask_ml_tpu_torch.decomposition import PCA
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    Xb, _ = drawn("blobs", lambda: blobs_data(SEED))
    Xk = kdd_data(SRV_FIT_N, KDD_D, SEED)
    Xg = normal_f32((SRV_FIT_N, SRV_GLM_D), [SEED, 31])
    beta = np.random.default_rng([SEED, 32]).standard_normal(
        SRV_GLM_D).astype(np.float32)
    u = np.random.default_rng([SEED, 33]).random(SRV_FIT_N,
                                                 dtype=np.float32)
    yg = (u < 1.0 / (1.0 + np.exp(-(Xg @ beta) / np.sqrt(SRV_GLM_D)))
          ).astype(np.int64)
    Xs, _ = nystrom_blobs(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 34)
    # low rank plus noise, drawn on the card: 2e5 x 1,000
    Xp = (torch.randn(SRV_PCA_N, 64, generator=g, device=dev)
          @ torch.randn(64, SRV_PCA_D, generator=g, device=dev)
          + 0.1 * torch.randn(SRV_PCA_N, SRV_PCA_D, generator=g,
                              device=dev))
    t0 = time.perf_counter()
    models = {
        "kmeans": KMeans(n_clusters=K, random_state=SEED).fit(Xb),
        "sketched": KMeans(n_clusters=SRV_KDD_K, algorithm="sketched",
                           random_state=SEED).fit(Xk),
        "minibatch": MiniBatchKMeans(n_clusters=K,
                                     random_state=SEED).fit(Xb),
        "spectral": SpectralClustering(n_clusters=SPEC_K,
                                       n_components=SPEC_L, gamma=None,
                                       random_state=SEED).fit(Xs),
        "logistic": LogisticRegression(solver="lbfgs", max_iter=20).fit(
            Xg, yg),
        "pca": PCA(n_components=SRV_PCA_K, random_state=SEED).fit(Xp),
    }
    torch.cuda.synchronize()
    log(f"serving models fitted in {time.perf_counter() - t0:.2f} s")
    # copies, so the pools keep none of the large arrays alive
    pools = {"kmeans": Xb[:SRV_POOL].copy(), "sketched": Xk[:SRV_POOL].copy(),
             "spectral": Xs[:SRV_POOL].cpu().numpy(),
             "logistic": Xg[:SRV_POOL].copy(),
             "pca": Xp[:SRV_POOL].cpu().numpy()}
    pools["minibatch"] = pools["kmeans"]
    del Xk, Xg, Xs, Xp
    return models, pools


#: (model, method) pairs the traffic draws from
SRV_PAIRS = (("kmeans", "predict"), ("sketched", "predict"),
             ("minibatch", "predict"), ("spectral", "predict"),
             ("logistic", "predict"), ("logistic", "predict_proba"),
             ("pca", "transform"))
SRV_K2 = ("kmeans", "sketched", "minibatch", "spectral")


def served_against_direct(name, method, est, X, got, gemm):
    """A served result against the direct call: bit for bit for the K2
    families; for the GEMM runners, values within SRV_GEMM_RTOL of the
    request's largest and labels where the margin exceeds it. Adds to
    ``gemm`` the largest error and the rows whose bits differ."""
    want = getattr(est, method)(X)
    expect(got.dtype == want.dtype and got.shape == want.shape,
           f"{name}.{method}: served {got.dtype}{got.shape}, direct "
           f"{want.dtype}{want.shape}")
    if name in SRV_K2:
        expect(np.array_equal(got, want),
               f"{name}.{method} n={len(X)}: served labels differ from "
               f"direct")
        return
    key = f"{name}.{method}"
    rec = gemm.setdefault(key, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                "rows_not_bitwise": 0, "rows": 0,
                                "label_rows_in_margin": 0})
    rec["rows"] += len(X)
    if method == "predict":
        proba = est.predict_proba(X)
        margin = np.abs(proba - 0.5) if proba.ndim == 1 else -np.diff(
            np.sort(proba, axis=1)[:, -2:], axis=1)[:, 0]
        sure = margin > SRV_GEMM_RTOL
        rec["label_rows_in_margin"] += int((~sure).sum())
        rec["rows_not_bitwise"] += int((got != want).sum())
        expect(np.array_equal(got[sure], want[sure]),
               f"{key} n={len(X)}: labels differ outside the margin")
        return
    err = np.abs(got.astype(np.float64) - want)
    rows_diff = (got != want).reshape(len(X), -1).any(axis=1)
    rec["rows_not_bitwise"] += int(rows_diff.sum())
    rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
    scale = float(np.abs(want).max())
    rec["max_rel_err"] = max(rec["max_rel_err"],
                             float(err.max()) / max(scale, 1.0))
    expect(float(err.max()) <= SRV_GEMM_RTOL * max(scale, 1.0),
           f"{key} n={len(X)}: max abs err {float(err.max())} beyond "
           f"{SRV_GEMM_RTOL} of {scale}")


def check_served_batches(models, captured, errs):
    """Every batch the K2 runners served during the identity phase,
    against K2's plain version on the same padded batch: labels equal up
    to near-ties, min values within close_values' tolerance; K2-x the
    same on the sketched model's restricted rows. Returns the batches
    checked and the near-ties seen."""
    import torch

    from dask_ml_tpu_torch.ops import fused_distance as fd

    n_batches = ties = 0
    for name, batches in captured.items():
        est = models[name]
        for Xs, out in batches:
            got = torch.as_tensor(out, device=Xs.device)
            if name == "sketched":
                Wp, off, vals, _ = est._sketch_args(Xs.device)
                Z = (Xs @ Wp - off[None, :]).contiguous()
                zero = torch.zeros(Z.shape[0], device=Xs.device)
                ka, kmn = fd.fused_argmin_min_sketched(Z, vals, x2=zero,
                                                       kernel="cuda")
                ra, rmn = fd.fused_argmin_min_sketched(Z, vals, x2=zero,
                                                       kernel="torch")
                X_, Y_, kname = Z, vals, "fused_argmin_min_sketched"
            else:
                if name == "spectral":
                    X_ = est._extend_rows(Xs)
                    C = est.assign_labels_.cluster_centers_
                else:
                    X_, C = Xs, est.cluster_centers_
                Y_ = torch.as_tensor(C, dtype=torch.float32,
                                     device=Xs.device)
                ka, kmn = fd.fused_argmin_min(X_, Y_, kernel="cuda")
                ra, rmn = fd.fused_argmin_min(X_, Y_, kernel="torch")
                kname = "fused_argmin_min"
            if name in ("kmeans", "minibatch"):
                # the batch itself was K2's input: the same launch again
                expect(torch.equal(got, ka.to(got.dtype)),
                       f"{name}: a served batch is not K2's labels")
            # the sketched and landmark runners compute K2's input with a
            # GEMM first, recomputed here: held against plain up to ties
            ties += near_tie_ok(X_, Y_, None, got.to(ra.dtype), ra)
            near_tie_ok(X_, Y_, None, ka, ra)
            e = close_values(kmn, rmn, X_, Y_, False,
                             f"{name} served batch min value")
            errs[kname] = max(errs.get(kname, 0.0), e)
            n_batches += 1
    return n_batches, ties


def _trace(pools, n_requests, seed):
    """The traffic: each request a (model, method) pair, a size from
    SRV_SIZES, an offset into the model's pool, and a deadline on a
    quarter of them, all drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_requests):
        name, method = SRV_PAIRS[int(rng.integers(len(SRV_PAIRS)))]
        n = int(SRV_SIZES[int(rng.integers(len(SRV_SIZES)))])
        off = int(rng.integers(0, SRV_POOL - n + 1))
        deadline = SRV_DEADLINE_S if rng.random() < 0.25 else None
        out.append((name, method, pools[name][off:off + n], deadline))
    return out


def closed_loop(trace, clients, send):
    """``clients`` threads, each sending its share of ``trace`` one
    request at a time through ``send(request) -> result``; returns (wall
    seconds, client latencies in seconds, results by trace index,
    deadline sheds)."""
    import threading

    from dask_ml_tpu_torch.parallel.serving import DeadlineExceeded

    results = [None] * len(trace)
    lat = [0.0] * len(trace)
    shed = [0]
    errors = []
    lock = threading.Lock()
    barrier = threading.Barrier(clients + 1)

    def client(c):
        try:
            barrier.wait(120)
            for i in range(c, len(trace), clients):
                t0 = time.perf_counter()
                try:
                    results[i] = send(trace[i])
                except DeadlineExceeded:
                    with lock:
                        shed[0] += 1
                lat[i] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    barrier.wait(120)
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
        expect(not t.is_alive(), "a client thread did not finish")
    wall = time.perf_counter() - t0
    expect(not errors, f"client errors: {errors[:3]}")
    return wall, lat, results, shed[0]


def latency_summary(wall, lat, n):
    q = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    return {"requests": n, "seconds": wall, "qps": n / wall,
            "p50_ms": float(q[0]), "p99_ms": float(q[1])}


def serving_sparse(dev, loop, est, errs):
    """The sparse fallback: one request on a make_sparse_classification
    container of the GLM's width through ParallelPostFit(serving=loop)
    takes the direct path (K6), equal to the direct predict; K6 against
    _spmv_ref on an integer copy of that container, bit for bit, and on
    its float values within the rounding bound."""
    import torch

    from dask_ml_tpu_torch import wrappers
    from dask_ml_tpu_torch.datasets import make_sparse_classification
    from dask_ml_tpu_torch.ops import sparse as sps

    Xh, _ = make_sparse_classification(
        n_samples=SRV_SPARSE_N, n_features=SRV_GLM_D,
        density=SRV_SPARSE_DENSITY, random_state=SEED)
    ppf = wrappers.ParallelPostFit(est, serving=loop)
    submitted = loop.n_submitted
    labels, sec, launches = drive(lambda: ppf.predict(Xh))
    expect_launches("serving-sparse", launches)
    expect(loop.n_submitted == submitted,
           "the sparse request reached the serving loop")
    expect(np.array_equal(labels, est.predict(Xh)),
           "ParallelPostFit(serving=).predict on sparse rows differs from "
           "the direct predict")
    vals = torch.as_tensor(np.asarray(Xh.values), device=dev)
    cols = torch.as_tensor(np.asarray(Xh.cols), device=dev)
    A = sps.SparseRows(torch.round(vals * 4.0), cols, Xh.d)
    n, k = vals.shape
    rng = np.random.default_rng([SEED, 35])
    v = torch.as_tensor(rng.integers(-8, 8, Xh.d), dtype=torch.float32,
                        device=dev)
    r = torch.as_tensor(rng.integers(-8, 8, n), dtype=torch.float32,
                        device=dev)
    check_spmv_int("serving request", A, v, r,
                   fitting_routes(k, Xh.d, False), [])
    vf = torch.as_tensor(rng.standard_normal(Xh.d), dtype=torch.float32,
                         device=dev)
    plan = sps.dvector_plan(n, k, Xh.d)
    out_k = sps._spmv_cuda(vals, cols, vf, cluster=plan)
    out_p = sps._spmv_ref(vals, cols, vf)
    scale = sps._spmv_ref(vals.abs(), cols, vf.abs())
    err = (out_k - out_p).abs()
    expect(bool((err <= k * 2.0 ** -23 * scale).all()),
           f"K6 at the serving request: max abs err {float(err.max())}")
    name = "spmv" if plan else "spmv_l2"
    errs[name] = max(errs.get(name, 0.0), float(err.max()))
    out = {"n": n, "k": k, "d": Xh.d, "seconds": sec}
    path_line("serving-sparse", sec, None, launches, **out)
    return launches, out


def serving_kernel_rows(dev, models, pools, sparse_shape):
    """K2, K2-x and K6 timed at the serving shapes (a full 2048-row batch
    of the blobs, of the sketched model's restricted rows, and the sparse
    request), beside their plain versions and bounds."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.ops import fused_distance as fd
    from dask_ml_tpu_torch.ops import sparse as sps

    fdl = build.load("fused_distance")
    X = torch.as_tensor(pools["kmeans"][:SRV_MAX_ROWS], device=dev)
    stream = build.stream_of(X)
    n, d = X.shape
    Y = torch.as_tensor(models["kmeans"].cluster_centers_, device=dev)
    b, by = bound(4 * (n * d + K * d + 2 * n), 2 * n * K * d)
    rows = [dict(name="fused_argmin_min",
                 ms=cuda_ms(fused_call(fdl, stream, X, Y, 1)),
                 plain_ms=cuda_ms(lambda: fd._argmin_min_ref(X, Y, None),
                                  iters=10, warmup=2),
                 bound_ms=b, bound_by=by, library_ms=None,
                 shape={"n": n, "m": K, "d": d})]
    sk = models["sketched"]
    Xk = torch.as_tensor(pools["sketched"][:SRV_MAX_ROWS], device=dev)
    Wp, off, vals, _ = sk._sketch_args(dev)
    Z = (Xk @ Wp - off[None, :]).contiguous()
    zero = torch.zeros(Z.shape[0], device=dev)
    n, p = Z.shape
    m = vals.shape[0]
    b, by = bound(4 * (n * p + m * p + 3 * n), 2 * n * m * p)
    rows.append(dict(
        name="fused_argmin_min_sketched",
        ms=cuda_ms(fused_call(fdl, stream, Z, vals, 1, x2=zero)),
        plain_ms=cuda_ms(lambda: fd._argmin_min_sk_ref(Z, vals, zero, None),
                         iters=10, warmup=2),
        bound_ms=b, bound_by=by, library_ms=None,
        shape={"n": n, "m": m, "d": p}))
    if sparse_shape is None:
        return rows
    A, v = sparse_shape
    n, k = A.values.shape
    plan = sps.dvector_plan(n, k, A.d)
    b, by = bound(4 * (2 * n * k + n + A.d), 2 * n * k)
    crow = torch.arange(0, n * k + 1, k, dtype=torch.int32, device=dev)
    csr = torch.sparse_csr_tensor(crow, A.cols.view(-1), A.values.view(-1),
                                  size=(n, A.d), check_invariants=False)

    # (the device times at this shape are spmv_path_rows' "served" row:
    # here, after the serving cells, torch.profiler recorded no kernel)
    rows.append(dict(
        name="spmv" if plan else "spmv_l2",
        ms=cuda_ms(lambda: sps._spmv_cuda(A.values, A.cols, v,
                                          cluster=plan), iters=200,
                   warmup=20),
        plain_ms=cuda_ms(lambda: sps._spmv_ref(A.values, A.cols, v),
                         iters=10, warmup=2),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.mv(csr, v), iters=200, warmup=20),
        shape={"n": n, "k": k, "d": A.d}, cluster=plan))
    return rows


def serving_cells(dev, errs):
    """The SERVING phase (step 17): the fitted models on one
    ServingLoop(max_batch_rows=2048), warmed; then identity, steady
    traffic, the fleet and the sparse fallback. Returns (launches by path,
    summary, kernel rows at the serving shapes)."""
    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.ops import sparse as sps
    from dask_ml_tpu_torch.parallel import telemetry
    from dask_ml_tpu_torch.parallel.faults import FaultInjector
    from dask_ml_tpu_torch.parallel.fleet import ServingFleet
    from dask_ml_tpu_torch.parallel.serving import ModelRegistry, ServingLoop
    from dask_ml_tpu_torch.parallel.shapes import track_compiles

    t_all = time.perf_counter()
    models, pools = serving_models(dev)
    reg = ModelRegistry()
    for name, est in models.items():
        reg.register(name, est)
    summary = {"models": {n: type(e).__name__ for n, e in models.items()}}
    launches = {}
    telemetry.reset_telemetry()
    with config_context(telemetry=True):
        loop = ServingLoop(reg, max_batch_rows=SRV_MAX_ROWS).start()
    try:
        t0 = time.perf_counter()
        summary["warmup"] = loop.warmup()
        summary["warmup"]["seconds"] = time.perf_counter() - t0
        log(f"serving warmup: {summary['warmup']}")
        with track_compiles() as after_warmup:
            # -- 1. identity ------------------------------------------------
            captured = {name: [] for name in SRV_K2}
            saved = {}
            for name in SRV_K2:
                runner = reg.get(name).runners["predict"]
                saved[name] = runner.run

                def run(Xs, _orig=runner.run, _name=name):
                    out = _orig(Xs)
                    captured[_name].append((Xs.clone(), out))
                    return out

                runner.run = run

            def identity():
                futs = []
                for name, method in SRV_PAIRS:
                    for n in SRV_IDENTITY:
                        futs.append((name, method, n, loop.submit(
                            name, pools[name][:n], method=method)))
                return [(name, method, n, f.result(120))
                        for name, method, n, f in futs]

            served, sec, l_id = drive(identity)
            for name in SRV_K2:
                reg.get(name).runners["predict"].run = saved[name]
            expect_launches("serving-identity", l_id)
            launches["serving-identity"] = l_id
            gemm = {}
            for name, method, n, got in served:
                served_against_direct(name, method, models[name],
                                      pools[name][:n], got, gemm)
            n_checked, ties = check_served_batches(models, captured, errs)
            del captured
            summary["identity"] = {"requests": len(served), "seconds": sec,
                                   "k2_batches_checked": n_checked,
                                   "near_ties": ties, "gemm": gemm}
            path_line("serving-identity", sec, None, l_id,
                      **summary["identity"])

            # -- 2. steady traffic ------------------------------------------
            trace = _trace(pools, SRV_CLIENTS * SRV_REQUESTS, SEED)
            telemetry.reset_telemetry()
            before = dict(loop.stats())

            def send_loop(req):
                name, method, X, deadline = req
                return loop.submit(name, X, method=method,
                                   deadline=deadline).result(120)

            (wall, lat, results, shed), sec, l_st = drive(
                lambda: closed_loop(trace, SRV_CLIENTS, send_loop))
            expect_launches("serving-steady", l_st)
            launches["serving-steady"] = l_st
            for (name, method, X, _), got in zip(trace, results):
                if got is not None:
                    served_against_direct(name, method, models[name], X,
                                          got, gemm)
            after = loop.stats()
            batches = after["batches"] - before["batches"]
            rows = after["rows_served"] - before["rows_served"]
            expect(after["errors"] == before["errors"],
                   "steady traffic: a request failed")
            hist = telemetry.metrics().snapshot()["histograms"]
            req_hist = {k: {q: v[q] for q in ("count", "p50", "p99")}
                        for k, v in hist.items()
                        if k.startswith("serving.request_seconds")}
            steady = latency_summary(wall, lat, len(trace))
            steady.update(shed=shed, batches=batches,
                          rows_per_batch=rows / max(batches, 1),
                          k2_launches=l_st["fused_argmin_min"],
                          k2x_launches=l_st["fused_argmin_min_sketched"],
                          loop_request_seconds=req_hist,
                          loop_batch_seconds={
                              q: hist["serving.batch_seconds"][q]
                              for q in ("count", "mean", "p50", "p99")})
            # the device's share of a steady window: a quarter of the
            # trace, profiled
            steady["profile"] = device_profile(lambda: closed_loop(
                trace[:len(trace) // 4], SRV_CLIENTS, send_loop))
            log("PROFILE serving-steady " + json.dumps(steady["profile"]))

            def send_direct(req):
                name, method, X, _ = req
                return getattr(models[name], method)(X)

            (dwall, dlat, _, _), _, _ = drive(
                lambda: closed_loop(trace, SRV_CLIENTS, send_direct))
            steady["direct"] = latency_summary(dwall, dlat, len(trace))
            steady["speedup_qps"] = steady["qps"] / steady["direct"]["qps"]
            summary["steady"] = steady
            log(f"serving steady: {steady['qps']:.1f} QPS, p50 "
                f"{steady['p50_ms']:.2f} ms, p99 {steady['p99_ms']:.2f} ms, "
                f"{steady['rows_per_batch']:.1f} rows/batch, {shed} shed; "
                f"direct {steady['direct']['qps']:.1f} QPS (x"
                f"{steady['speedup_qps']:.2f})")
            path_line("serving-steady", sec, None, l_st, **steady)

            # -- 3. the fleet ------------------------------------------------
            fi = (FaultInjector()
                  .kill_replica("fleet-r1", after_batches=SRV_KILL_AFTER)
                  .straggle_replica("fleet-r0", SRV_STRAGGLE_S,
                                    every=SRV_STRAGGLE_EVERY))
            fleet = ServingFleet(reg, n_replicas=2,
                                 max_batch_rows=SRV_MAX_ROWS,
                                 fault_injector=fi,
                                 heartbeat_timeout_s=5.0).start()
            try:
                expect([r.device for r in fleet._replicas]
                       == [torch.device("cuda", 0)] * 2,
                       "the fleet's replicas are not both on cuda:0")
                fleet.warmup()
                half = trace[:len(trace) // 2]
                futs_seen = []

                def send_fleet(req):
                    name, method, X, deadline = req
                    f = fleet.submit(name, X, method=method,
                                     deadline=deadline)
                    futs_seen.append(f)
                    return f.result(120)

                (fwall, flat, fres, fshed), sec, l_fl = drive(
                    lambda: closed_loop(half, SRV_CLIENTS, send_fleet))
            finally:
                fleet.stop(drain=True)
            expect_launches("serving-fleet", l_fl)
            launches["serving-fleet"] = l_fl
            fst = fleet.stats()
            expect(fi.injected["replica_kill"] == 1,
                   "the replica kill never fired")
            expect(fst["reroutes"] >= 1, "the kill rerouted nothing")
            expect(fst["inflight"] == 0 and all(f.done() for f in futs_seen),
                   "a fleet future is left pending after the drain")
            expect(sum(r is not None for r in fres) + fshed == len(half),
                   "a fleet request resolved other than once")
            for (name, method, X, _), got in zip(half, fres):
                if got is not None:
                    served_against_direct(name, method, models[name], X,
                                          got, gemm)
            summary["fleet"] = dict(
                latency_summary(fwall, flat, len(half)), shed=fshed,
                reroutes=fst["reroutes"], replica_deaths=fst[
                    "replica_deaths"], straggles=fi.injected["straggle"],
                replicas={k: {q: v[q] for q in ("batches", "rows_served",
                                                 "errors")}
                          for k, v in fst["replicas"].items()})
            log(f"serving fleet: {summary['fleet']}")
            path_line("serving-fleet", sec, None, l_fl, **summary["fleet"])
        expect(after_warmup["n_compiles"] == 0
               and after_warmup["n_loads"] == 0,
               f"kernels built or loaded after the warmup: {after_warmup}")
        summary["after_warmup"] = after_warmup

        # -- 4. the sparse fallback (the direct path: K6) --------------------
        l_sp, summary["sparse"] = serving_sparse(dev, loop,
                                                 models["logistic"], errs)
        launches["serving-sparse"] = l_sp
    finally:
        loop.stop()
        telemetry.reset_telemetry()
    from dask_ml_tpu_torch.datasets import make_sparse_classification

    Xh, _ = make_sparse_classification(
        n_samples=SRV_SPARSE_N, n_features=SRV_GLM_D,
        density=SRV_SPARSE_DENSITY, random_state=SEED)
    A = sps.SparseRows(torch.as_tensor(np.asarray(Xh.values), device=dev),
                       torch.as_tensor(np.asarray(Xh.cols), device=dev),
                       Xh.d)
    v = torch.as_tensor(np.random.default_rng([SEED, 36]).standard_normal(
        Xh.d), dtype=torch.float32, device=dev)
    rows = serving_kernel_rows(dev, models, pools, (A, v))
    summary["seconds"] = time.perf_counter() - t_all
    log("SERVING " + json.dumps(summary))
    return launches, summary, rows


# ---------------------------------------------------------------------------
# the wire and the process fleet (WIRE)
# ---------------------------------------------------------------------------

# the CRC-32C check: 1 MiB of seeded bytes and ragged tails against the
# plain table; rates on WIRE_RATE_BYTES (the plain table on 64 KiB)
WIRE_CRC_BYTES, WIRE_RATE_BYTES, WIRE_PURE_BYTES = 1 << 20, 256 << 20, 64 << 10
# the wire clients' ring: a 2048 x 1000 f32 PCA request (8.2 MB) must fit
# a record, which holds half a ring
WIRE_RING_BYTES = 16 << 20
# the ring-capacity arm of wire-steady: the same trace through a ring four
# times as large (the 8.2 MB PCA records no longer fill it two at a time)
WIRE_WIDE_RING_BYTES = 64 << 20
# the process fleet: the kill plan's request count on replica p1, the
# straggler on p0 (seconds, every n-th batch), the drill's closed loop
# (K2 families only: they hold bit for bit) and the hedging A/B's
# sequential requests on one seeded trace
PROC_KILL_AFTER = 40
PROC_STRAGGLE_S, PROC_STRAGGLE_EVERY = 0.2, 4
PROC_CLIENTS, PROC_REQUESTS = 16, 32
PROC_AB_REQUESTS = 80
PROC_WAIT = 180.0


def k2_trace(pools, n_requests, seed):
    """The process fleet's traffic: the K2 families only (they hold bit
    for bit), a size from SRV_SIZES and an offset into the model's pool,
    drawn from ``seed``; no deadlines."""
    k2 = [p for p in SRV_PAIRS if p[0] in SRV_K2]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_requests):
        name, method = k2[int(rng.integers(len(k2)))]
        n = int(SRV_SIZES[int(rng.integers(len(SRV_SIZES)))])
        off = int(rng.integers(0, SRV_POOL - n + 1))
        out.append((name, method, pools[name][off:off + n], None))
    return out


def gbps(fn, nbytes: int, reps: int = 3) -> float:
    """GB/s of ``fn()`` over ``nbytes``, best of ``reps``."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return nbytes / best / 1e9


def wire_crc() -> dict:
    """``wire-crc``: the engine is the port's C library; its digest equals
    the plain table's on 1 MiB of seeded bytes and on ragged, unaligned
    tails of 0-17 bytes; GB/s of the C engine, the plain table (64 KiB)
    and hashlib.sha256."""
    import hashlib

    from dask_ml_tpu_torch.parallel import framing

    engine = framing.crc32c_engine()
    expect(engine == "port-c", f"crc32c engine is {engine!r}")
    data = np.random.default_rng([SEED, 40]).integers(
        0, 256, WIRE_RATE_BYTES, dtype=np.uint8)
    mib = data[:WIRE_CRC_BYTES]
    expect(framing.crc32c(mib) == framing.crc32c(mib, engine="pure-python"),
           "crc32c: the C engine and the table differ on 1 MiB")
    expect(framing.crc32c(b"123456789") == 0xE3069283,
           "crc32c: wrong known answer")
    for n in range(18):
        for off in range(8):
            tail = mib[off:off + n]
            expect(framing.crc32c(tail)
                   == framing.crc32c(tail, engine="pure-python"),
                   f"crc32c: tail of {n} bytes at offset {off} differs")
    buf = data.tobytes()
    out = {"engine": engine,
           "c_gbps": gbps(lambda: framing.crc32c(buf), len(buf)),
           "pure_gbps": gbps(lambda: framing.crc32c(
               buf[:WIRE_PURE_BYTES], engine="pure-python"),
               WIRE_PURE_BYTES, reps=1),
           "sha256_gbps": gbps(lambda: hashlib.sha256(buf).digest(),
                               len(buf))}
    log(f"wire-crc: {out}")
    return out


def wire_counters() -> dict:
    """The wire's telemetry: ``wire.bytes{transport=}`` and
    ``wire.hash_seconds{algo=}`` (count, sum, p50, p99)."""
    from dask_ml_tpu_torch.parallel import telemetry

    snap = telemetry.metrics().snapshot()
    out = {k: v for k, v in snap["counters"].items()
           if k.startswith("wire.bytes")}
    for k, v in snap["histograms"].items():
        if k.startswith("wire.hash_seconds"):
            out[k] = {q: v[q] for q in ("count", "sum", "p50", "p99")
                      if q in v}
    return out


def wire_serving(dev, models, pools, errs):
    """``wire-identity`` and ``wire-steady``: a FleetServer in front of a
    ServingLoop(max_batch_rows=2048) on ``dev``, one client over the shm
    ring and one over TCP. Returns (launches by path, summary)."""
    from dask_ml_tpu_torch import config as config_lib
    from dask_ml_tpu_torch.parallel import telemetry
    from dask_ml_tpu_torch.parallel.fleet import FleetClient, FleetServer
    from dask_ml_tpu_torch.parallel.serving import ModelRegistry, ServingLoop
    from dask_ml_tpu_torch.parallel.shapes import track_compiles

    reg = ModelRegistry()
    for name, est in models.items():
        reg.register(name, est)
    launches, summary = {}, {}
    # process-wide, so the server's connection threads mirror too
    config_lib.set_config(telemetry=True)
    telemetry.reset_telemetry()
    loop = ServingLoop(reg, max_batch_rows=SRV_MAX_ROWS, device=dev).start()
    server = cs = ct = cw = cl = None
    try:
        t0 = time.perf_counter()
        summary["warmup"] = loop.warmup()
        summary["warmup"]["seconds"] = time.perf_counter() - t0
        server = FleetServer(loop).start()
        cs = FleetClient(server.address, shm_ring_bytes=WIRE_RING_BYTES,
                         request_timeout=120.0)
        ct = FleetClient(server.address, shm=False, request_timeout=120.0)
        # the capacity arm's client, and one as the process fleet's router
        # links its replicas (the default ring)
        cw = FleetClient(server.address,
                         shm_ring_bytes=WIRE_WIDE_RING_BYTES,
                         request_timeout=120.0)
        cl = FleetClient(server.address, request_timeout=120.0)
        expect(all(c.shm_segment for c in (cs, cw, cl))
               and server.n_shm_conns == 3,
               "a shm client did not upgrade to the ring")
        expect(ct.shm_segment is None, "the TCP client upgraded to the ring")
        with track_compiles() as after_warmup:
            # -- identity: each side of every bucket boundary, both wires
            captured = {name: [] for name in SRV_K2}
            saved = {}
            for name in SRV_K2:
                runner = reg.get(name).runners["predict"]
                saved[name] = runner.run

                def run(Xs, _orig=runner.run, _name=name):
                    out = _orig(Xs)
                    captured[_name].append((Xs.clone(), out))
                    return out

                runner.run = run

            def identity():
                futs = []
                for name, method in SRV_PAIRS:
                    for n in SRV_IDENTITY:
                        X = pools[name][:n]
                        futs.append((name, method, n,
                                     cs.submit(name, X, method=method),
                                     ct.submit(name, X, method=method)))
                return [(name, method, n, fs.result(120), ft.result(120))
                        for name, method, n, fs, ft in futs]

            served, sec, l_id = drive(identity)
            for name in SRV_K2:
                reg.get(name).runners["predict"].run = saved[name]
            expect_launches("wire-identity", l_id)
            launches["wire-identity"] = l_id
            gemm = {}
            for name, method, n, got_s, got_t in served:
                X = pools[name][:n]
                served_against_direct(name, method, models[name], X, got_s,
                                      gemm)
                served_against_direct(name, method, models[name], X, got_t,
                                      gemm)
                if name in SRV_K2:
                    expect(np.array_equal(got_s, got_t),
                           f"{name} n={n}: shm and TCP answers differ")
            n_checked, ties = check_served_batches(models, captured, errs)
            del captured
            summary["identity"] = {
                "requests": 2 * len(served), "seconds": sec,
                "k2_bitwise_shm_and_tcp": True,
                "k2_batches_checked": n_checked, "near_ties": ties,
                "gemm": gemm}
            path_line("wire-identity", sec, None, l_id,
                      **summary["identity"])

            # -- steady: step 17's trace in process, over shm, over TCP
            trace = _trace(pools, SRV_CLIENTS * SRV_REQUESTS, SEED)

            def via(send_one):
                def send(req):
                    name, method, X, deadline = req
                    return send_one(name, X, method, deadline)
                return send

            sends = {
                "in_process": via(lambda n, X, m, dl: loop.submit(
                    n, X, method=m, deadline=dl).result(120)),
                "shm": via(lambda n, X, m, dl: cs.call(
                    n, X, method=m, deadline=dl, timeout=120)),
                "tcp": via(lambda n, X, m, dl: ct.call(
                    n, X, method=m, deadline=dl, timeout=120)),
                "shm_wide": via(lambda n, X, m, dl: cw.call(
                    n, X, method=m, deadline=dl, timeout=120)),
            }
            steady = {}
            for key, send in sends.items():
                telemetry.reset_telemetry()
                (wall, lat, results, shed), sec, l_st = drive(
                    lambda: closed_loop(trace, SRV_CLIENTS, send))
                expect_launches("wire-steady", l_st)
                for (name, method, X, _), got in zip(trace, results):
                    if got is not None:
                        served_against_direct(name, method, models[name],
                                              X, got, gemm)
                rec = latency_summary(wall, lat, len(trace))
                rec.update(shed=shed, k2_launches=l_st["fused_argmin_min"],
                           k2x_launches=l_st["fused_argmin_min_sketched"],
                           wire=wire_counters())
                steady[key] = rec
                launches[f"wire-steady-{key}"] = l_st
                log(f"wire-steady {key}: {rec['qps']:.1f} QPS, p50 "
                    f"{rec['p50_ms']:.2f} ms, p99 {rec['p99_ms']:.2f} ms, "
                    f"{shed} shed; {rec['wire']}")
            steady["shm_over_tcp_qps"] = steady["shm"]["qps"] / \
                steady["tcp"]["qps"]
            steady["shm_over_in_process_qps"] = steady["shm"]["qps"] / \
                steady["in_process"]["qps"]
            steady["shm_wide_over_tcp_qps"] = steady["shm_wide"]["qps"] / \
                steady["tcp"]["qps"]
            summary["steady"] = steady
            path_line("wire-steady", sum(
                v["seconds"] for k, v in steady.items() if isinstance(v, dict)
            ), None, launches["wire-steady-shm"], **steady)

            # -- the router's links: the process fleet's drill traffic
            # (K2 families, 16 clients) over the default ring and over
            # TCP, in turns
            links = {"shm": [], "tcp": []}
            k2 = k2_trace(pools, PROC_CLIENTS * PROC_REQUESTS, [SEED, 41])
            for key in ("shm", "tcp", "shm", "tcp"):
                c = cl if key == "shm" else ct

                def send(req, _c=c):
                    name, method, X, _ = req
                    return _c.call(name, X, method=method, timeout=120)

                (wall, lat, results, _), sec, l_ln = drive(
                    lambda: closed_loop(k2, PROC_CLIENTS, send))
                expect_launches("wire-links", l_ln)
                for (name, method, X, _), got in zip(k2, results):
                    expect(np.array_equal(got, getattr(models[name],
                                                       method)(X)),
                           f"wire-links {name}: an answer differs")
                links[key].append(latency_summary(wall, lat, len(k2)))
                launches[f"wire-links-{key}-{len(links[key])}"] = l_ln
            links["shm_over_tcp_qps"] = [
                a["qps"] / b["qps"] for a, b in zip(links["shm"],
                                                    links["tcp"])]
            summary["links"] = links
            log(f"wire-links: {json.dumps(links)}")
        expect(after_warmup["n_compiles"] == 0
               and after_warmup["n_loads"] == 0,
               f"kernels built or loaded after the warmup: {after_warmup}")
        summary["after_warmup"] = after_warmup
    finally:
        for c in (cs, ct, cw, cl):
            if c is not None:
                c.close()
        if server is not None:
            server.stop()
        loop.stop()
        config_lib.set_config(telemetry=False)
        telemetry.reset_telemetry()
    return launches, summary


def proc_fleet(dev, models, pools):
    """``proc-fleet``: ProcessFleet(n_replicas=2) on the card's device
    type; the children's stats (pid, device, builds) and start phases; a
    closed loop of the K2 families with replica p1 SIGKILLed by its plan
    (every request once, bit for bit, the respawn loading nothing after
    its warmup); a hedging A/B on one seeded trace with p0 a straggler;
    SIGTERM everywhere; no segment left. Returns (the launches the live
    children counted from the end of their warmups, through the drill
    and the A/B, summed; summary)."""
    import os

    from dask_ml_tpu_torch.parallel import shm as shm_lib
    from dask_ml_tpu_torch.parallel.procfleet import ProcessFleet

    K2 = "fused_argmin_min"
    summary = {}
    device = "cuda" if dev.type == "cuda" else "cpu"
    kind = None
    if dev.type == "cuda":
        import torch

        kind = torch.cuda.get_device_name(0)
    fleet = ProcessFleet(
        n_replicas=2, device=device, max_batch_rows=SRV_MAX_ROWS,
        name="wire", request_timeout_s=120.0, spawn_timeout_s=PROC_WAIT,
        heartbeat_timeout_s=5.0, hedge_min_s=0.02,
        kill_after_requests={1: PROC_KILL_AFTER},
        straggle={0: (PROC_STRAGGLE_S, PROC_STRAGGLE_EVERY)})
    for name, est in models.items():
        fleet.register(name, est)
    t0 = time.perf_counter()
    fleet.start()
    summary["start_s"] = time.perf_counter() - t0
    try:
        st = fleet.stats()
        summary["children"] = {
            name: {"pid": r["pid"], "start_s": r["start_s"],
                   "phases": r["phases"], "warmup": r["warmup"]}
            for name, r in st["replicas"].items()}
        log(f"proc-fleet start {summary['start_s']:.2f} s: "
            f"{summary['children']}")
        remote = fleet.remote_stats(timeout=60)
        for name, r in remote.items():
            expect(r["pid"] != os.getpid(), f"{name} runs in the parent")
            want_dev = "cuda:0" if device == "cuda" else "cpu"
            expect(r["device"] == want_dev,
                   f"{name} serves on {r['device']}, not {want_dev}")
            if kind is not None:
                expect(r["device_name"] == kind,
                       f"{name} is on {r['device_name']}, not {kind}")
            expect(r["n_builds"] == 0, f"{name} built {r['n_builds']} "
                   "libraries: a child must only load them")
            # the children count their launches from the end of their
            # warmup: 0 just before the drill
            expect(not r["steady_launches"], f"{name} launched "
                   f"{r['steady_launches']} after its warmup, before "
                   "any traffic")
        pids0 = {name: r["pid"] for name, r in remote.items()}
        expect(len(set(pids0.values())) == 2, "the children share a pid")

        # -- the drill: the kill plan fires on p1 under traffic
        trace = k2_trace(pools, PROC_CLIENTS * PROC_REQUESTS, [SEED, 41])
        fleet.hedge = True
        before = fleet.n_results

        def send(req):
            name, method, X, _ = req
            return fleet.submit(name, X, method=method).result(PROC_WAIT)

        (wall, lat, results, _), sec, _ = drive(
            lambda: closed_loop(trace, PROC_CLIENTS, send))
        for (name, method, X, _), got in zip(trace, results):
            expect(got is not None, "a fleet request was dropped")
            expect(np.array_equal(got, getattr(models[name], method)(X)),
                   f"proc-fleet {name}: a served answer differs from "
                   "direct")
        resolved = fleet.n_results - before
        expect(resolved == len(trace),
               f"{resolved} first resolutions for {len(trace)} requests")
        drill = latency_summary(wall, lat, len(trace))
        end = time.monotonic() + PROC_WAIT
        while fleet.replicas_up() < 2 and time.monotonic() < end:
            time.sleep(0.05)
        expect(fleet.replicas_up() == 2, "p1 did not respawn")
        st = fleet.stats()
        p1 = st["replicas"]["wire-p1"]
        expect(st["replica_deaths"] == 1 and st["respawns"] == 1,
               f"deaths {st['replica_deaths']}, respawns {st['respawns']}")
        expect(p1["past_exits"] == [[pids0["wire-p1"], -9]],
               f"p1's killed incarnation: {p1['past_exits']}")
        # K2 in the drill: the launches each live child counted since
        # its warmup (p0: the drill's; the respawned p1: its replays'
        # and any traffic after its warmup). The killed incarnation's
        # count dies with it.
        mid = fleet.remote_stats(timeout=60)
        drill_launches = {name: r["steady_launches"]
                          for name, r in mid.items()}
        if device == "cuda":
            expect(drill_launches["wire-p0"].get(K2, 0) > 0,
                   f"p0 launched no K2 in the drill: {drill_launches}")
        drill.update(seconds=sec, dropped=0, double_resolved=0,
                     reroutes=st["reroutes"], hedged=st["hedged"],
                     hedge_wins=st["hedge_wins"],
                     respawn_start_s=p1["start_s"],
                     respawn_phases=p1["phases"])
        summary["drill"] = drill
        log(f"proc-fleet drill: {drill}")

        # -- hedging A/B: one seeded trace, sequential, p0 straggles
        ab_trace = trace[:PROC_AB_REQUESTS]
        p99 = {}
        for hedge in (False, True):
            fleet.hedge = hedge
            # each arm starts from the same router state: no latency
            # history, so p0 is not already routed around
            fleet.reset_latency_history()
            lat = []
            for name, method, X, _ in ab_trace:
                t1 = time.perf_counter()
                got = fleet.call(name, X, method=method, timeout=PROC_WAIT)
                lat.append(time.perf_counter() - t1)
                expect(np.array_equal(got, getattr(models[name], method)(X)),
                       f"hedging A/B {name}: an answer differs")
            q = np.percentile(np.asarray(lat) * 1e3, [50, 99])
            p99["hedged" if hedge else "unhedged"] = {
                "p50_ms": float(q[0]), "p99_ms": float(q[1])}
        expect(p99["hedged"]["p99_ms"] < p99["unhedged"]["p99_ms"],
               f"hedged p99 not below unhedged: {p99}")
        summary["hedging"] = p99
        log(f"proc-fleet hedging A/B: {p99}")

        remote = fleet.remote_stats(timeout=60)
        launches = {K2: 0, "fused_argmin_min_sketched": 0}
        ab_launches = {}
        for name, r in remote.items():
            expect(r["pid"] == mid[name]["pid"],
                   f"{name} changed its pid in the hedging A/B")
            expect(r["steady_compiles"] == 0,
                   f"{name} built or loaded after its warmup: {r}")
            expect(r["n_builds"] == 0, f"{name} built a library")
            ab_launches[name] = {
                k: v - drill_launches[name].get(k, 0)
                for k, v in r["steady_launches"].items()}
            if device == "cuda":
                # the respawned p1 too: its traffic ran the kernel
                expect(ab_launches[name].get(K2, 0) > 0,
                       f"{name} launched no K2 in the hedging A/B: "
                       f"{ab_launches[name]}")
            # the drill's and the A/B's launches of the live children
            for k in launches:
                launches[k] += int(r["steady_launches"].get(k, 0))
        expect(remote["wire-p1"]["pid"] != pids0["wire-p1"],
               "p1 kept its pid")
        summary["launches"] = {"drill": drill_launches,
                               "hedging": ab_launches}
        summary["children_after"] = {
            name: {k: r[k] for k in ("pid", "device", "device_name",
                                     "launches", "steady_launches",
                                     "n_builds", "n_loads", "steady_loads")}
            for name, r in remote.items()}
        links = {name: r["segment"]
                 for name, r in fleet.stats()["replicas"].items()}
        summary["links"] = links
        expect(all(links.values()),
               f"a router link is not on the ring: {links}")
    finally:
        fleet.stop(timeout=60)
    codes = {name: r["returncode"]
             for name, r in fleet.stats()["replicas"].items()}
    expect(all(c == 0 for c in codes.values()),
           f"a replica did not drain to exit 0 on SIGTERM: {codes}")
    left = shm_lib.list_segments()
    expect(not left, f"shm segments left after stop(): {left}")
    summary["exit_codes"] = codes
    summary["killed_exit"] = -9
    summary["segments_left"] = 0
    return launches, summary


def wire_cells(dev, errs):
    """The WIRE phase (step 18) on step 17's fitted models. Returns
    (launches by wire path, launches summed over the process fleet's
    children, summary)."""
    t_all = time.perf_counter()
    models, pools = serving_models(dev)
    summary = {"crc": wire_crc()}
    launches, summary["serving"] = wire_serving(dev, models, pools, errs)
    proc_launches, summary["proc"] = proc_fleet(dev, models, pools)
    summary["seconds"] = time.perf_counter() - t_all
    log("WIRE " + json.dumps(summary))
    return launches, proc_launches, summary


# the cross-machine drill (bench.py bench_fleet_machines, :4210-4213 and
# :4298): 2 replicas over 2 machines, 8 clients x 24 requests a burst,
# 4,096-byte snapshot chunks; the SLO breaches on queue depth alone
MACH_REPLICAS, MACH_CLIENTS, MACH_REQUESTS = 2, 8, 24
MACH_CHUNK_BYTES = 4096
MACH_SLO = dict(target_p99_s=float("inf"), max_queue_depth=3.0,
                max_shed_per_s=0.0)
MACH_SCALER = dict(min_replicas=MACH_REPLICAS,
                   max_replicas=MACH_REPLICAS + 1, interval_s=0.1,
                   breach_ticks=2, quiet_ticks=5, scale_up_cooldown_s=1.0,
                   scale_down_cooldown_s=2.0)
# a fresh child on the card takes 10-20 s to ready (PERF.md §5): the waits for
# the scale-up and the respawn hold that several times over
MACH_WAIT = 180.0


def machines_check_kernels(dev, models, pools, errs):
    """K2 and K2-x against their plain versions at the shapes the
    machines' requests give them: one request of each size of SRV_SIZES
    a K2 family, its direct predict taken as the served answer (the drill
    holds served == direct bit for bit). Returns the batches checked and
    the near-ties seen."""
    import torch

    captured = {}
    for name in SRV_K2:
        captured[name] = []
        for n in SRV_SIZES:
            X = pools[name][:n]
            captured[name].append((torch.as_tensor(X, device=dev),
                                   models[name].predict(X)))
    return check_served_batches(models, captured, errs)


def machines_closed_loop(fleet, trace, models):
    """One closed loop of ``trace`` through ``fleet`` by MACH_CLIENTS
    clients: every request resolves, every answer equal to the direct call
    bit for bit. Returns (latency summary, first resolutions the router
    counted)."""
    before = fleet.n_results

    def send(req):
        name, method, X, _ = req
        return fleet.submit(name, X, method=method).result(MACH_WAIT)

    wall, lat, results, _ = closed_loop(trace, MACH_CLIENTS, send)
    for (name, method, X, _), got in zip(trace, results):
        expect(got is not None, "a machines-fleet request was dropped")
        expect(np.array_equal(got, getattr(models[name], method)(X)),
               f"machines {name}: a served answer differs from direct")
    return latency_summary(wall, lat, len(trace)), fleet.n_results - before


def machines_wait(what: str, cond) -> float:
    """Poll ``cond()`` every 50 ms for up to MACH_WAIT seconds; fails
    naming ``what``. Returns the seconds waited."""
    t0 = time.monotonic()
    while not cond():
        expect(time.monotonic() - t0 < MACH_WAIT, f"{what} within "
               f"{MACH_WAIT} s")
        time.sleep(0.05)
    return time.monotonic() - t0


def machines_cells(dev, errs):
    """The MACHINES phase (step 19) on step 17's K2 families. Returns
    (the launches the live children counted since their warmups, summed,
    summary)."""
    import os
    import shutil
    import tempfile

    from dask_ml_tpu_torch.parallel import shm as shm_lib
    from dask_ml_tpu_torch.parallel.autoscaler import SLO, Autoscaler
    from dask_ml_tpu_torch.parallel.faults import FaultInjector
    from dask_ml_tpu_torch.parallel.launcher import MachineSpec
    from dask_ml_tpu_torch.parallel.procfleet import ProcessFleet

    K2, K2X = "fused_argmin_min", "fused_argmin_min_sketched"
    t_all = time.perf_counter()
    all_models, pools = serving_models(dev)
    models = {name: all_models[name] for name in SRV_K2}
    n_batches, ties = machines_check_kernels(dev, models, pools, errs)
    device = "cuda" if dev.type == "cuda" else "cpu"
    kind = None
    if dev.type == "cuda":
        import torch

        kind = torch.cuda.get_device_name(0)
    summary = {"smi": smi_name_power(), "models": sorted(models),
               "kernel_checks": {"batches": n_batches, "near_ties": ties}}
    phases = summary["phases"] = {}
    n_trace = MACH_CLIENTS * MACH_REQUESTS
    base = tempfile.mkdtemp(prefix="chip_smoke_machines_")
    machines = [MachineSpec(name=m, workdir=os.path.join(base, m))
                for m in ("m0", "m1")]
    inj = FaultInjector()
    fleet = ProcessFleet(
        n_replicas=MACH_REPLICAS, device=device, name="mach",
        workdir=os.path.join(base, "router"), machines=machines,
        fault_injector=inj, snapshot_chunk_bytes=MACH_CHUNK_BYTES,
        max_batch_rows=SRV_MAX_ROWS, request_timeout_s=MACH_WAIT,
        spawn_timeout_s=MACH_WAIT, heartbeat_timeout_s=5.0)
    for name, est in models.items():
        fleet.register(name, est)
    scaler = None
    try:
        # -- machines-cold: each machine's first replica fetches it all
        t0 = time.perf_counter()
        fleet.start()
        st = fleet.stats()
        phases["cold"] = {"seconds": time.perf_counter() - t0}
        fetches = {name: r["snapshot_fetch"]
                   for name, r in st["replicas"].items()}
        full = st["snapshot_server"]
        expect({m: len(r["replicas"]) for m, r in st["machines"].items()}
               == {"m0": 1, "m1": 1},
               f"placement over the machines: {st['machines']}")
        total = None
        for name, fs in fetches.items():
            expect(fs is not None, f"{name} reports no snapshot fetch")
            total = fs["bytes_total"] if total is None else total
            expect(fs["bytes_fetched"] == fs["bytes_total"] == total
                   and fs["chunks_total"] >= 2,
                   f"{name}'s cold fetch is not the whole registry: {fs}")
        expect(full["bytes_sent"] == MACH_REPLICAS * total,
               f"the snapshot server sent {full['bytes_sent']} bytes for "
               f"{MACH_REPLICAS} cold fetches of {total}")
        phases["cold"].update(
            registry_bytes=total, chunks=fetches[next(iter(fetches))][
                "chunks_total"],
            fetches={name: fs["bytes_fetched"]
                     for name, fs in fetches.items()},
            ready_s={name: r["start_s"] for name, r in st["replicas"].items()},
            child_phases={name: r["phases"]
                          for name, r in st["replicas"].items()})
        remote = fleet.remote_stats(timeout=60)
        for name, r in remote.items():
            expect(r["pid"] != os.getpid(), f"{name} runs in the router")
            want_dev = "cuda:0" if device == "cuda" else "cpu"
            expect(r["device"] == want_dev,
                   f"{name} serves on {r['device']}, not {want_dev}")
            if kind is not None:
                expect(r["device_name"] == kind,
                       f"{name} is on {r['device_name']}, not {kind}")
            expect(r["n_builds"] == 0, f"{name} built a library")
            expect(not r["steady_launches"], f"{name} launched "
                   f"{r['steady_launches']} after its warmup, before "
                   "any traffic")
        log(f"machines-cold: {phases['cold']}")

        # -- machines-burst: the autoscaler scales up on a warm machine
        deaths0, respawns0 = st["replica_deaths"], st["respawns"]
        scaler = Autoscaler(fleet, SLO(**MACH_SLO), **MACH_SCALER)
        t0 = time.perf_counter()
        scaler.start()
        bursts, burst_lat, seed = 0, [], 0
        while scaler.n_scale_ups < 1 or fleet.replicas_up() \
                < MACH_REPLICAS + 1:
            expect(time.perf_counter() - t0 < MACH_WAIT,
                   "the autoscaler did not scale up under the burst")
            trace = k2_trace(pools, n_trace, [SEED, 50, seed])
            seed += 1
            lat, first = machines_closed_loop(fleet, trace, models)
            expect(first == len(trace), f"burst: {first} first "
                   f"resolutions for {len(trace)} requests")
            bursts += 1
            burst_lat.append(lat)
        st = fleet.stats()
        new = [name for name, r in st["replicas"].items()
               if name not in fetches]
        expect(len(new) == 1, f"the burst added {new}")
        nf = st["replicas"][new[0]]["snapshot_fetch"]
        expect(nf["bytes_fetched"] == 0
               and nf["chunks_cached"] == nf["chunks_total"],
               f"the scale-up fetched {nf['bytes_fetched']} bytes: {nf}")
        phases["burst"] = {
            "seconds": time.perf_counter() - t0, "bursts": bursts,
            "traffic": burst_lat, "scaled_up": new[0],
            "machine": st["replicas"][new[0]]["machine"],
            "fetch_bytes": nf["bytes_fetched"],
            "ready_s": st["replicas"][new[0]]["start_s"],
            "child_phases": st["replicas"][new[0]]["phases"]}
        log(f"machines-burst: {phases['burst']}")

        # -- machines-quiet: the autoscaler drains the extra slot
        t0 = time.perf_counter()
        machines_wait("the autoscaler's drain",
                      lambda: scaler.n_scale_downs >= 1
                      and fleet.stats()["drains"] >= 1)
        scaler.stop()
        machines_wait("the drained child's exit",
                      lambda: fleet.stats()["replicas"][new[0]]["returncode"]
                      is not None)
        st = fleet.stats()
        expect(st["replicas"][new[0]]["retired"]
               and st["replicas"][new[0]]["returncode"] == 0,
               f"the drained slot: {st['replicas'][new[0]]}")
        expect(st["replica_deaths"] == deaths0
               and st["respawns"] == respawns0,
               f"the drain moved the death ({st['replica_deaths']}) or "
               f"respawn ({st['respawns']}) counter")
        expect(fleet.replicas_up() == MACH_REPLICAS,
               f"{fleet.replicas_up()} replicas up after the drain")
        phases["quiet"] = {"seconds": time.perf_counter() - t0,
                           "drained": new[0], "exit_code": 0}
        summary["autoscaler"] = {
            **scaler.stats(),
            "decisions": [{k: v for k, v in d.items() if k != "signals"}
                          for d in scaler.decisions]}
        expect(scaler.n_scale_ups == 1 and scaler.n_scale_downs == 1,
               f"autoscaler actions: {summary['autoscaler']}")
        log(f"machines-quiet: {phases['quiet']}; autoscaler "
            f"{summary['autoscaler']}")

        # -- machines-loss: m1 dies at a third of fresh traffic
        t0 = time.perf_counter()
        on_m1 = st["machines"]["m1"]["replicas"]
        hedged0, wins0 = st["hedged"], st["hedge_wins"]
        reroutes0 = st["reroutes"]
        inj.kill_machine("m1", after_results=fleet.n_results + n_trace // 3)
        trace = k2_trace(pools, n_trace, [SEED, 51])
        lat, first = machines_closed_loop(fleet, trace, models)
        expect(first == len(trace), f"machine loss: {first} first "
               f"resolutions for {len(trace)} requests")
        machines_wait("the lost slot's respawn",
                      lambda: fleet.replicas_up() >= MACH_REPLICAS
                      and fleet.stats()["respawns"] > respawns0)
        st = fleet.stats()
        expect(st["machine_deaths"] == 1 and st["machines"]["m1"]["down"]
               and inj.injected["machine_kill"] == 1,
               f"machine deaths {st['machine_deaths']}, m1 "
               f"{st['machines']['m1']}")
        live = {name: r for name, r in st["replicas"].items()
                if not r["dead"] and not r["retired"]}
        expect({r["machine"] for r in live.values()} == {"m0"},
               f"live replicas after the loss: {live}")
        respawned = {name: r for name, r in live.items() if r["gen"] > 1}
        expect(set(respawned) == set(on_m1),
               f"respawned {sorted(respawned)}, lost {on_m1}")
        for name, r in respawned.items():
            expect(r["snapshot_fetch"]["bytes_fetched"] == 0,
                   f"{name}'s respawn fetched "
                   f"{r['snapshot_fetch']['bytes_fetched']} bytes")
            expect(r["past_exits"][-1][1] == -9,
                   f"{name}'s killed incarnation: {r['past_exits']}")
        phases["loss"] = {
            "seconds": time.perf_counter() - t0, "traffic": lat,
            "machine_deaths": st["machine_deaths"],
            "replica_deaths": st["replica_deaths"] - deaths0,
            "reroutes": st["reroutes"] - reroutes0,
            "hedged": st["hedged"] - hedged0,
            "hedge_wins": st["hedge_wins"] - wins0, "dropped": 0,
            "double_resolved": 0,
            "respawned": {name: {"machine": r["machine"],
                                 "fetch_bytes":
                                     r["snapshot_fetch"]["bytes_fetched"],
                                 "ready_s": r["start_s"],
                                 "child_phases": r["phases"]}
                          for name, r in respawned.items()}}
        log(f"machines-loss: {phases['loss']}")

        # -- machines-steady: the rejoined fleet
        t0 = time.perf_counter()
        trace = k2_trace(pools, n_trace, [SEED, 52])
        lat, first = machines_closed_loop(fleet, trace, models)
        expect(first == len(trace), "steady: a request resolved twice")
        remote = fleet.remote_stats(timeout=60)
        launches = {K2: 0, K2X: 0}
        children = {}
        for name, r in remote.items():
            expect("error" not in r, f"{name}: {r}")
            expect(r["steady_compiles"] == 0,
                   f"{name} built or loaded after its warmup: {r}")
            expect(r["n_builds"] == 0, f"{name} built a library")
            if device == "cuda":
                expect(r["device"] == "cuda:0"
                       and r["device_name"] == kind,
                       f"{name} on {r['device']} {r['device_name']}")
                expect(r["steady_launches"].get(K2, 0) > 0,
                       f"{name} launched no K2 since its warmup: "
                       f"{r['steady_launches']}")
            for k in launches:
                launches[k] += int(r["steady_launches"].get(k, 0))
            children[name] = {k: r[k] for k in (
                "pid", "device", "device_name", "steady_launches",
                "n_builds", "n_loads", "steady_loads", "snapshot_fetch")}
        if device == "cuda":
            expect(launches[K2X] > 0, "no child launched K2-x since its "
                   f"warmup: {launches}")
        phases["steady"] = {"seconds": time.perf_counter() - t0,
                            "traffic": lat}
        summary["children"] = children
        summary["launches"] = launches
        summary["snapshot_server"] = st["snapshot_server"]
        log(f"machines-steady: {phases['steady']}")
    finally:
        if scaler is not None:
            scaler.stop()
        fleet.stop(timeout=60)
    codes = {name: r["returncode"]
             for name, r in fleet.stats()["replicas"].items()}
    expect(all(c == 0 for c in codes.values()),
           f"a replica did not drain to exit 0 on SIGTERM: {codes}")
    left = shm_lib.list_segments()
    expect(not left, f"shm segments left after stop(): {left}")
    stray = [os.path.join(d, f) for m in machines
             for d, _, files in os.walk(m.workdir) for f in files
             if f.endswith((".tmp", ".lock"))]
    expect(not stray, f"temporary files left in the workdirs: {stray}")
    shutil.rmtree(base, ignore_errors=True)
    summary["exit_codes"] = codes
    summary["seconds"] = time.perf_counter() - t_all
    log("MACHINES " + json.dumps(summary))
    return launches, summary


# ---------------------------------------------------------------------------
# KMeans over a mesh of ranks (MESH, step 20)
# ---------------------------------------------------------------------------

#: what a MESH phase's rank and an ELASTIC host process import, loaded
#: once by the fork server they start from
RANK_PRELOAD = ("__main__", "torch", "dask_ml_tpu_torch.cluster",
                "dask_ml_tpu_torch.decomposition",
                "dask_ml_tpu_torch.linear_model",
                "dask_ml_tpu_torch.model_selection",
                "dask_ml_tpu_torch.parallel.elastic",
                "dask_ml_tpu_torch.parallel.hierarchy",
                "dask_ml_tpu_torch.parallel.runtime")


def rank_context(start: bool = False):
    """The ``multiprocessing`` context that the MESH phases' ranks and the
    ELASTIC host processes start from: a fork server that imported
    :data:`RANK_PRELOAD` once, so that a rank starts in a fraction of a
    second (a spawned one spent 10–13 s importing torch and the port on
    the card's host, each world and pair again). The server never touches
    the card: every rank initializes CUDA itself, as a spawned one did.
    With ``start`` the server starts now, in the background; it ends when
    this process does."""
    import multiprocessing
    from multiprocessing import forkserver

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(list(RANK_PRELOAD))
    if start:
        forkserver.ensure_running()
    return ctx


#: (backend, world size, layouts): NCCL takes a card a rank, so on one card
#: it runs a world of 1; the worlds of 2 and 4 share card 0 over gloo
MESH_WORLDS = (("nccl", 1, ("flat",)), ("gloo", 2, ("flat", "hier")),
               ("gloo", 4, ("flat", "hier", "model")))
MESH_KERNELS = ("lloyd_iter", "fused_argmin_min", "fused_rowwise_min",
                "fused_argmin_weight", "fused_argmin_min2")
MESH_TIMEOUT = 300
MESH_LOOP_ITERS = 20


def mesh_layouts(world: int, names):
    """The meshes of a world, built in one order on every rank."""
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib

    make = {"flat": lambda: mesh_lib.make_mesh(),
            "hier": lambda: hier.make_hierarchical_mesh(
                2 if world == 4 else 1),
            "model": lambda: mesh_lib.make_2d_mesh(2, 2)}
    return {name: make[name]() for name in names}


def mesh_fit(m, X, algo: str, dev):
    """One fit over ``m`` with the launch counts and the ledger set to 0
    just before, then ``predict`` with the counts set to 0 again; the
    model layout runs the feature-sharded loop from the k-means|| init the
    facade draws, and its labels are the predict. Returns (centers,
    labels, n_iter, inertia, phases, fit launches, ledger, wall, predict,
    predict's K2 launches)."""
    import torch

    from dask_ml_tpu_torch import _kernels
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.utils.validation import check_random_state

    torch.cuda.synchronize()
    _kernels.reset_launches()
    hier.reset_ledger()
    t0 = time.perf_counter()
    with mesh_lib.use_mesh(m):
        if not mesh_lib.has_model_axis(m):
            km = KMeans(n_clusters=K, init="k-means||",
                        oversampling_factor=2, random_state=SEED,
                        algorithm=algo).fit(X)
            out = (km.cluster_centers_, km.labels_, km.n_iter_,
                   km.inertia_, km.fit_phase_seconds_)
        else:
            data = prepare_data(X, device=dev, mesh=m)
            c0 = core.k_init(data.X, data.weights, data.n, K,
                             check_random_state(SEED, device=dev),
                             oversampling_factor=2, mesh=m)
            torch.cuda.synchronize()
            t_init = time.perf_counter()
            tol = core.scaled_tolerance(data.X, data.weights, 1e-4, mesh=m)
            feat = prepare_data(X, device=dev, mesh=m, shard_features=True)
            pad = feat.X.shape[1] * mesh_lib.n_model_shards(m) - D
            c0 = torch.cat([c0, c0.new_zeros((K, pad))], dim=1)
            centers, _, n_iter, _ = core.lloyd_loop_fused(
                feat.X, feat.weights, c0, tol, max_iter=300, mesh=m,
                shard_features=True)
            centers = centers[:, :D].contiguous()
            inertia = core.compute_inertia(data.X, data.weights, centers,
                                           mesh=m, n_valid=data.n)
            labels = core.predict_labels(data.X, centers, mesh=m,
                                         n_valid=data.n)
            torch.cuda.synchronize()
            out = (centers.cpu().numpy(), labels.cpu().numpy(), n_iter,
                   float(inertia),
                   {"init": t_init - t0,
                    "lloyd": time.perf_counter() - t_init})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: int(_kernels.launches[k]) for k in MESH_KERNELS}
    ledger = hier.ledger_snapshot()
    if mesh_lib.has_model_axis(m):
        return out + (launches, ledger, wall, out[1],
                      launches["fused_argmin_min"])
    _kernels.reset_launches()
    with mesh_lib.use_mesh(m):
        pred = km.predict(X)
    return out + (launches, ledger, wall, pred,
                  int(_kernels.launches["fused_argmin_min"]))


def mesh_timings(m, X, dev) -> dict:
    """Lloyd ms an iteration at tol 0 on this rank's block (the feature-
    sharded loop on a model axis), and the ms of one ``hpsum`` of the
    M-step operands (sums (k, d), counts (k,), inertia)."""
    import torch

    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    model = mesh_lib.has_model_axis(m)
    data = prepare_data(X, device=dev, mesh=m, shard_features=model)
    c0 = torch.as_tensor(X[:K * 997:997], device=dev)
    if model:
        pad = data.X.shape[1] * mesh_lib.n_model_shards(m) - D
        c0 = torch.cat([c0, c0.new_zeros((K, pad))], dim=1)
    ops = (torch.zeros((K, D), device=dev), torch.zeros(K, device=dev),
           torch.zeros((), device=dev))
    for _ in range(3):
        for t in ops:
            hier.hpsum(t, m, op="mesh.timing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_LOOP_ITERS):
        for t in ops:
            hier.hpsum(t, m, op="mesh.timing")
    torch.cuda.synchronize()
    hpsum_ms = (time.perf_counter() - t0) * 1e3 / MESH_LOOP_ITERS
    core.lloyd_loop_fused(data.X, data.weights, c0, 0.0, max_iter=2,
                          mesh=m, shard_features=model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, it, _ = core.lloyd_loop_fused(
        data.X, data.weights, c0, 0.0, max_iter=MESH_LOOP_ITERS, mesh=m,
        shard_features=model)
    torch.cuda.synchronize()
    return {"lloyd_ms_per_iter": (time.perf_counter() - t0) * 1e3 / it,
            "hpsum_mstep_ms": hpsum_ms, "rows_here": int(data.X.shape[0])}


def mesh_rank(backend: str, world: int, rank: int, tmp: str, layouts):
    """One rank of a MESH world (run in a spawned process): join the world
    on card 0, fit every layout, hold each fit to the single-device fit of
    the parent, write this rank's report to ``tmp``."""
    import os
    import traceback

    report = {"rank": rank, "errors": [], "fits": {}, "timings": {}}
    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        from dask_ml_tpu_torch.parallel import hierarchy as hier
        from dask_ml_tpu_torch.parallel import runtime, shapes

        store = os.path.join(tmp, f"store-{backend}-{world}")
        if world > 1:
            # NCCL refuses two ranks on one card: initialize says so
            try:
                runtime.initialize(backend="nccl",
                                   init_method="file://" + store + "-nccl",
                                   num_processes=world, process_id=rank,
                                   local_device_ids=[0])
                report["errors"].append(
                    "runtime.initialize accepted nccl with two ranks on "
                    "one card")
                runtime.shutdown()
            except RuntimeError as e:
                report["nccl_refused"] = str(e)
        runtime.initialize(backend=backend, init_method="file://" + store,
                           num_processes=world, process_id=rank,
                           local_device_ids=[0])
        dev = runtime.device()
        meshes = mesh_layouts(world, layouts)
        Xf, _ = blobs_data(SEED)
        Xi = np.rint(Xf)
        ref = np.load(os.path.join(tmp, "ref.npz"))
        ref_k3 = json.loads(open(os.path.join(tmp, "ref.json")).read())
        mesh_fit(meshes["flat"], Xf, "full", dev)  # warmup: loads kernels
        st0 = shapes.compile_stats()
        for name, m in meshes.items():
            algos = ("full",) if name == "model" else ("full", "bounded")
            for kind, X in (("int", Xi), ("float", Xf)):
                for algo in algos:
                    tag = f"{name}-{kind}-{algo}"
                    (c, lab, n_it, inertia, ph, launches, led, wall,
                     pred, pred_k2) = mesh_fit(m, X, algo, dev)
                    rc, rl = ref[f"{kind}-{algo}-c"], ref[f"{kind}-{algo}-l"]
                    rn = int(ref[f"{kind}-{algo}-n"])
                    ri = float(ref[f"{kind}-{algo}-i"])
                    err = []
                    if kind == "int" and name != "model":
                        if not (np.array_equal(c, rc)
                                and np.array_equal(lab, rl)
                                and np.array_equal(pred, rl)
                                and n_it == rn and inertia == ri):
                            err.append(
                                f"{tag}: not the single-device fit bit for "
                                f"bit (n_iter {n_it}/{rn}, inertia "
                                f"{inertia!r}/{ri!r}, centers equal "
                                f"{np.array_equal(c, rc)}, labels equal "
                                f"{np.array_equal(lab, rl)})")
                    elif kind == "int":
                        if not (np.array_equal(lab, rl)
                                and np.allclose(c, rc, rtol=1e-5, atol=1e-5)
                                and abs(inertia - ri) <= 1e-5 * abs(ri)):
                            err.append(f"{tag}: labels differ or centers/"
                                       "inertia beyond rtol 1e-5")
                    else:
                        a = ari(rl, lab)
                        if a < 0.99 or abs(inertia - ri) > 1e-5 * abs(ri):
                            err.append(f"{tag}: ARI {a}, inertia {inertia}"
                                       f" against {ri}")
                    k1, k2, k3, k4, k5 = (launches[k] for k in MESH_KERNELS)
                    want_k1 = n_it if (algo == "full" and name != "model") \
                        else 0
                    want_k5 = n_it if algo == "bounded" else 0
                    if (k1, k5, k4) != (want_k1, want_k5, 1) \
                            or k3 != ref_k3[f"{kind}-{algo}"] or k3 < 1 \
                            or k2 < 1 or pred_k2 < 1:
                        err.append(f"{tag}: launches {launches}, predict "
                                   f"K2 {pred_k2} (K1 {want_k1}, K5 "
                                   f"{want_k5}, K3 {ref_k3}, K4 1)")
                    ops = K * D + K + (1 if algo == "full" else 0)
                    calls = 3 if algo == "full" else 2
                    model_m = m if name != "model" else None
                    if model_m is not None:
                        want = {ax: b * n_it for ax, b in
                                hier.collective_bytes(m, ops * 4).items()}
                        got = led["ops"].get("kmeans.mstep", {})
                        got_calls = {ax: led["calls"].get(
                            f"{ax}/kmeans.mstep", 0) for ax in want}
                        if got != want or set(got_calls.values()) != {
                                calls * n_it}:
                            err.append(f"{tag}: ledger {got} {got_calls}, "
                                       f"want {want}, {calls}×{n_it}")
                        if name == "hier" and m.shape["pod"] == 1 \
                                and got.get("pod") != 0:
                            err.append(f"{tag}: pod stage moved bytes")
                    report["errors"] += err
                    report["fits"][tag] = {
                        "n_iter": int(n_it), "inertia": float(inertia),
                        "wall_s": wall, "init_s": ph["init"],
                        "lloyd_s": ph["lloyd"], "launches": launches,
                        "predict_k2": pred_k2,
                        "ledger_bytes": led["bytes"]}
            report["timings"][name] = mesh_timings(m, Xf, dev)
        st1 = shapes.compile_stats()
        for key in ("n_compiles", "n_loads"):
            if st1[key] != st0[key]:
                report["errors"].append(
                    f"{key} {st0[key]} -> {st1[key]} after the warmup")
        runtime.shutdown()
    except BaseException:
        report["errors"].append(traceback.format_exc())
    with open(os.path.join(tmp, f"rank-{backend}-{world}-{rank}.json"),
              "w") as f:
        json.dump(report, f)


def mesh_cells(dev):
    """The MESH phase (step 20). Returns ({world-layout-fit: [each rank's
    K1–K5 launches]}, summary)."""
    import os
    import shutil
    import tempfile

    import torch

    from dask_ml_tpu_torch.cluster import KMeans

    t_all = time.perf_counter()
    Xf, _ = drawn("blobs", lambda: blobs_data(SEED))
    Xi = np.rint(Xf)
    tmp = tempfile.mkdtemp(prefix="dmlt_mesh_")
    ref, ref_k3, single = {}, {}, {}
    for kind, X in (("int", Xi), ("float", Xf)):
        for algo in ("full", "bounded"):
            km, sec, launches = drive(lambda: KMeans(
                n_clusters=K, init="k-means||", oversampling_factor=2,
                random_state=SEED, algorithm=algo).fit(X))
            ref[f"{kind}-{algo}-c"] = km.cluster_centers_
            ref[f"{kind}-{algo}-l"] = km.labels_
            ref[f"{kind}-{algo}-n"] = np.array(km.n_iter_)
            ref[f"{kind}-{algo}-i"] = np.array(km.inertia_)
            ref_k3[f"{kind}-{algo}"] = int(launches["fused_rowwise_min"])
            single[f"{kind}-{algo}"] = {
                "wall_s": sec, "n_iter": km.n_iter_,
                "init_s": km.fit_phase_seconds_["init"],
                "lloyd_s": km.fit_phase_seconds_["lloyd"]}
    np.savez(os.path.join(tmp, "ref.npz"), **ref)
    with open(os.path.join(tmp, "ref.json"), "w") as f:
        json.dump(ref_k3, f)
    log("MESH single-device " + json.dumps(single))
    del Xi
    torch.cuda.empty_cache()
    ctx = rank_context()
    launches_by_fit, summary = {}, {"single": single, "worlds": []}
    try:
        for backend, world, layouts in MESH_WORLDS:
            t0 = time.perf_counter()
            procs = [ctx.Process(target=mesh_rank,
                                 args=(backend, world, r, tmp, layouts))
                     for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + MESH_TIMEOUT
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
            expect(not hung, f"MESH {backend} world {world}: ranks {hung} "
                   f"still running after {MESH_TIMEOUT} s")
            reports = []
            for r, p in enumerate(procs):
                path = os.path.join(tmp, f"rank-{backend}-{world}-{r}.json")
                expect(p.exitcode == 0 and os.path.exists(path),
                       f"MESH {backend} world {world} rank {r} exited "
                       f"{p.exitcode} without a report")
                with open(path) as f:
                    reports.append(json.load(f))
            errors = [e for rep in reports for e in rep["errors"]]
            expect(not errors, f"MESH {backend} world {world}: "
                   + " | ".join(errors))
            if world > 1:
                expect(all("distinct card" in rep.get("nccl_refused", "")
                           for rep in reports),
                       "nccl was not refused for two ranks on one card")
            sec = time.perf_counter() - t0
            for layout in layouts:
                fits = {tag[len(layout) + 1:]: [rep["fits"][tag]
                                                for rep in reports]
                        for tag in reports[0]["fits"]
                        if tag.startswith(layout + "-")}
                for tag, per_rank in fits.items():
                    launches_by_fit[f"{backend}-w{world}-{layout}-{tag}"] = [
                        f["launches"] for f in per_rank]
                line = {
                    "backend": backend, "world": world, "layout": layout,
                    "world_seconds": sec,
                    "fits": {tag: {k: per_rank[0][k] for k in (
                        "n_iter", "wall_s", "init_s", "lloyd_s",
                        "ledger_bytes")} for tag, per_rank in fits.items()},
                    "lloyd_ms_per_iter": [rep["timings"][layout][
                        "lloyd_ms_per_iter"] for rep in reports],
                    "hpsum_mstep_ms": [rep["timings"][layout][
                        "hpsum_mstep_ms"] for rep in reports],
                    "rows_a_rank": reports[0]["timings"][layout][
                        "rows_here"],
                    "launches": {tag: [[f["launches"][k] for k in
                                        MESH_KERNELS] + [f["predict_k2"]]
                                       for f in per_rank]
                                 for tag, per_rank in fits.items()}}
                log("MESH " + json.dumps(line))
                summary["worlds"].append(line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t_all
    log(f"MESH phase: {summary['seconds']:.1f} s")
    return launches_by_fit, summary


# ---------------------------------------------------------------------------
# The GLMs, tsqr and PCA over a mesh of ranks (MESHGLM, step 21)
# ---------------------------------------------------------------------------

#: (backend, world size, layouts), as MESH_WORLDS: NCCL at world 1, gloo
#: for the ranks that share card 0 (a world of 2 ran the flat layout only,
#: which world 4 runs too: cut for the run's time, PERF.md §4)
MESHGLM_WORLDS = (("nccl", 1, ("flat",)),
                  ("gloo", 4, ("flat", "hier", "model")))
#: the cells of each layout: the model layout splits dense X's columns,
#: which Newton's and PCA's fits do (ADMM and sparse input stay
#: data-parallel there, as in the JAX package)
MESHGLM_CELLS = {"flat": ("sparse-lbfgs", "admm", "newton", "pca"),
                 "hier": ("sparse-lbfgs", "admm", "newton", "pca"),
                 "model": ("newton", "pca")}
MESHGLM_TIMEOUT = 600
#: Newton's rows: the first 1e6 rows of the ADMM problem
MESHGLM_NEWTON_N = 1_000_000
MESHGLM_HPSUM_REPS = 10
#: warm value-and-gradient evaluations timed on the sparse cell's block
MESHGLM_EVALS = 5
#: the CPU tests' tolerances: the smooth solvers' coefficients, ADMM's
MESHGLM_COEF_TOL = dict(rtol=1e-4, atol=1e-5)
MESHGLM_ADMM_TOL = dict(rtol=1e-5, atol=1e-6)
#: PCA: singular values and variance ratios within rtol 1e-4, the signal
#: directions' span within 1e-4 of the single-device one (the noise
#: directions beyond the rank crowd and turn with any rounding)
MESHGLM_PCA_RTOL = 1e-4
MESHGLM_PCAS = ("pca-full", "pca-rand", "tsvd")
SPMV_NAMES = ("spmv", "spmv_l2", "spmv_pullback", "spmv_pullback_l2")


def meshglm_pca(tag: str):
    from dask_ml_tpu_torch.decomposition import PCA, TruncatedSVD

    if tag == "pca-full":
        return PCA(PCA_K, svd_solver="full")
    if tag == "pca-rand":
        return PCA(PCA_K, svd_solver="randomized", random_state=SEED)
    return TruncatedSVD(PCA_K)


def meshglm_refs(dev, Xs, ys, Xa, ya, Xp):
    """The single-device fits on the card each rank is held to: the sparse
    L-BFGS fit, the core ADMM with ``n_shards`` = each world's shard count
    on the rows padded as the mesh pads them (the default bucket, the same
    for every world here), Newton on the first rows, PCA and
    TruncatedSVD."""
    import torch

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel import shapes

    ref, single = {}, {}
    est, sec, _ = drive(lambda: LogisticRegression(
        solver="lbfgs", max_iter=GLM_ITERS).fit(Xs, ys))
    ref["sparse-lbfgs-coef"] = np.append(est.coef_, est.intercept_)
    ref["sparse-lbfgs-n"] = np.array(est.n_iter_)
    single["sparse-lbfgs"] = {"wall_s": sec, "n_iter": est.n_iter_,
                              "phases": est.fit_phase_seconds_}
    del est
    torch.cuda.empty_cache()
    n_pad = shapes.bucket_rows(ADMM_N)
    Xd = torch.zeros((n_pad, ADMM_D), device=dev)
    Xd[:ADMM_N] = torch.from_numpy(Xa).to(dev)
    yd = torch.zeros(n_pad, device=dev)
    yd[:ADMM_N] = torch.from_numpy(ya).to(dev)
    wd = torch.zeros(n_pad, device=dev)
    wd[:ADMM_N] = 1.0
    mask = torch.ones(ADMM_D, device=dev)
    b0 = torch.zeros(ADMM_D, device=dev)
    for S in sorted({w for _, w, _ in MESHGLM_WORLDS}):
        expect(shapes.bucket_rows(ADMM_N, align=S) == n_pad,
               f"the padded rows differ at {S} shards")
        (z, it), sec, _ = drive(lambda: glm_core.admm(
            Xd, yd, wd, b0, mask, n_shards=S, lamduh=1.0,
            max_iter=ADMM_OUTER, abstol=0.0, reltol=0.0))
        ref[f"admm-S{S}-z"], ref[f"admm-S{S}-n"] = z.cpu().numpy(), it
        single[f"admm-S{S}"] = {"wall_s": sec, "n_iter": it,
                                "ms_per_outer_iter": sec * 1e3 / it}
    del Xd, yd, wd
    torch.cuda.empty_cache()
    est, sec, _ = drive(lambda: LogisticRegression(solver="newton").fit(
        Xa[:MESHGLM_NEWTON_N], ya[:MESHGLM_NEWTON_N]))
    ref["newton-coef"] = np.append(est.coef_, est.intercept_)
    single["newton"] = {"wall_s": sec, "n_iter": est.n_iter_}
    for tag in MESHGLM_PCAS:
        est, sec, _ = drive(lambda: meshglm_pca(tag).fit(Xp))
        for attr in ("components_", "singular_values_",
                     "explained_variance_ratio_"):
            ref[f"{tag}-{attr}"] = np.asarray(getattr(est, attr))
        single[tag] = {"wall_s": sec}
    torch.cuda.empty_cache()
    return ref, single


def meshglm_hpsum_ms(m, shape, dev) -> float:
    """The ms of one ``hpsum`` of a ``shape`` f32 operand over ``m``."""
    import torch

    from dask_ml_tpu_torch.parallel import hierarchy as hier

    t = torch.zeros(shape, device=dev)
    for _ in range(2):
        hier.hpsum(t, m, op="meshglm.timing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESHGLM_HPSUM_REPS):
        hier.hpsum(t, m, op="meshglm.timing")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / MESHGLM_HPSUM_REPS


def meshglm_sync(m, dev) -> None:
    """Every rank of ``m`` leaves together: one ``hpsum`` of a word, read
    on the host, so that a timed fit does not count the wait for the
    slowest rank's previous cell."""
    import torch

    from dask_ml_tpu_torch.parallel import hierarchy as hier

    float(hier.hpsum(torch.ones((), device=dev), m, op="meshglm.sync"))


def meshglm_ledger_errors(tag, led, m, want) -> list:
    """``want``: {op: (operand bytes, calls)} against the ledger's bytes
    per axis and calls."""
    from dask_ml_tpu_torch.parallel import hierarchy as hier

    errs = []
    for op, (nbytes, calls) in want.items():
        per = hier.collective_bytes(m, nbytes)
        got = led["ops"].get(op, {})
        exp = {ax: b * calls for ax, b in per.items()} if calls else {}
        got_calls = {led["calls"].get(f"{ax}/{op}", 0) for ax in per}
        if got != exp or (calls and got_calls != {calls}):
            errs.append(f"{tag}: ledger {op} {got} in {got_calls} calls, "
                        f"want {exp} in {calls}")
    return errs


def meshglm_sparse(m, data, ref, dev):
    """The flagship's L-BFGS fit over ``m``: each rank stages its rows of
    the mapped container and launches K6 / K6-b on its block; then K6 and
    K6-b on an integer-valued copy of the block against their plain
    versions, bit for bit."""
    import torch

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.models.glm import add_intercept
    from dask_ml_tpu_torch.ops import sparse as sps
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    X = sps.SparseRows(data["sparse_values"], data["sparse_cols"], GLM_D)
    y = data["sparse_y"]
    meshglm_sync(m, dev)
    glm_core.reset_host_reads()
    hier.reset_ledger()
    with mesh_lib.use_mesh(m):
        est, wall, launches = drive(lambda: LogisticRegression(
            solver="lbfgs", max_iter=GLM_ITERS).fit(X, y))
    ev, led = dict(glm_core.mesh_evals), hier.ledger_snapshot()
    coef = np.append(est.coef_, est.intercept_)
    want = ref["sparse-lbfgs-coef"]
    errs = []
    if est.n_iter_ != int(ref["sparse-lbfgs-n"]) or not np.allclose(
            coef, want, **MESHGLM_COEF_TOL):
        errs.append(f"sparse-lbfgs: n_iter {est.n_iter_}, coefficients "
                    f"{np.abs(coef - want).max()} from the single-device "
                    "fit")
    d = GLM_D + 1
    errs += meshglm_ledger_errors("sparse-lbfgs", led, m, {
        "glm.sw": (4, 1), "glm.value": (4, ev["value"]),
        "sparse.pullback": (d * 4, ev["grad"])})
    k6 = launches["spmv"] + launches["spmv_l2"]
    k6b = launches["spmv_pullback"] + launches["spmv_pullback_l2"]
    if k6 != ev["value"] or k6b != ev["grad"] or not ev["grad"]:
        errs.append(f"sparse-lbfgs: K6 {k6} and K6-b {k6b} launches for "
                    f"{ev['value']} values and {ev['grad']} gradients")
    staged = prepare_data(X, y=y, mesh=m, device=dev)
    A = add_intercept(staged.X)
    n_loc, k = A.values.shape
    plan = (sps.dvector_plan(n_loc, k, d),
            sps.dvector_plan(n_loc, k, d, pullback=True))
    # a value and a gradient as the fit evaluates them, warm: K6, K6-b and
    # two sums over the ranks, at the fitted coefficients
    _, vg, _ = glm_core._mesh_objective(
        glm_core._Shards(A, m, d), staged.y, staged.weights,
        glm_core.FAMILIES["logistic"][0], None)
    b = torch.as_tensor(coef, device=dev)
    vg(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESHGLM_EVALS):
        vg(b)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3 / MESHGLM_EVALS
    del staged
    rng = np.random.default_rng([SEED, 21, int(m.rank)])
    Ai = sps.SparseRows(torch.round(A.values), A.cols, d)
    del A
    v = torch.as_tensor(rng.integers(-4, 4, d), dtype=torch.float32,
                        device=dev)
    r = torch.as_tensor(rng.integers(-1, 2, n_loc), dtype=torch.float32,
                        device=dev)
    try:
        check_spmv_int(f"rank block n{n_loc} k{k} d{d}", Ai, v, r, [None],
                       [None])
    except Mismatch as e:
        errs.append(str(e))
    del Ai
    torch.cuda.empty_cache()
    out = {"wall_s": wall, "n_iter": est.n_iter_,
           "solve_s": est.fit_phase_seconds_["solve"],
           "ms_per_eval": eval_ms, "evals": ev,
           "hpsum_ms": meshglm_hpsum_ms(m, (d,), dev), "hpsum_shape": [d],
           "ledger_bytes": led["ops"],
           "launches": {n: int(launches[n]) for n in SPMV_NAMES},
           "routes": {"forward_cluster": plan[0],
                      "pullback_cluster": plan[1]},
           "rows_here": n_loc, "slots": k,
           "gap": float(np.abs(coef - want).max())}
    return out, errs, {"coef": coef}


def meshglm_admm(m, data, ref, dev):
    """The JAX bench's ADMM (``bench_admm``: 10 outer iterations, every
    one run) over ``m``, one consensus block a rank, against the core
    ``n_shards=S`` fit on one device."""
    import torch

    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    S = mesh_lib.n_data_shards(m)
    dd = prepare_data(data["admm_X"], y=data["admm_y"], mesh=m, device=dev)
    mask = torch.ones(ADMM_D, device=dev)
    b0 = torch.zeros(ADMM_D, device=dev)
    meshglm_sync(m, dev)
    glm_core.reset_host_reads()
    hier.reset_ledger()
    (z, it), wall, _ = drive(lambda: glm_core.admm(
        dd.X, dd.y, dd.weights, b0, mask, mesh=m, lamduh=1.0,
        max_iter=ADMM_OUTER, abstol=0.0, reltol=0.0))
    led = hier.ledger_snapshot()
    z = z.cpu().numpy()
    want = ref[f"admm-S{S}-z"]
    errs = []
    if it != int(ref[f"admm-S{S}-n"]) or not np.allclose(
            z, want, **MESHGLM_ADMM_TOL):
        errs.append(f"admm: n_iter {it}, z {np.abs(z - want).max()} from "
                    f"the single-device n_shards={S} fit")
    errs += meshglm_ledger_errors("admm", led, m, {
        "glm.admm.sw": (4, 1), "glm.admm.consensus": (ADMM_D * 4, it),
        "glm.admm.residuals": (3 * 4, it)})
    out = {"wall_s": wall, "n_iter": it, "ms_per_outer_iter": wall * 1e3
           / it, "newton_steps": glm_core.host_reads["newton_steps"],
           "hpsum_ms": meshglm_hpsum_ms(m, (ADMM_D,), dev),
           "hpsum_shape": [ADMM_D], "ledger_bytes": led["ops"],
           "rows_here": int(dd.X.shape[0]),
           "gap": float(np.abs(z - want).max())}
    return out, errs, {"z": z}


def meshglm_newton(m, data, ref, dev):
    """``LogisticRegression(solver="newton")`` on the first rows of the
    ADMM problem over ``m``: on the model layout X's columns split over
    ``model``."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel import shapes

    X = data["admm_X"][:MESHGLM_NEWTON_N]
    y = data["admm_y"][:MESHGLM_NEWTON_N]
    meshglm_sync(m, dev)
    glm_core.reset_host_reads()
    hier.reset_ledger()
    with mesh_lib.use_mesh(m):
        est, wall, _ = drive(lambda: LogisticRegression(
            solver="newton").fit(X, y))
    ev, led = dict(glm_core.mesh_evals), hier.ledger_snapshot()
    coef = np.append(est.coef_, est.intercept_)
    want = ref["newton-coef"]
    errs = []
    if not np.allclose(coef, want, **MESHGLM_COEF_TOL):
        errs.append(f"newton: coefficients {np.abs(coef - want).max()} "
                    "from the single-device fit")
    d = ADMM_D + 1
    nm, nd = mesh_lib.n_model_shards(m), mesh_lib.n_data_shards(m)
    if nm > 1:
        width = -(-d // nm) * nm
        n_pad = shapes.bucket_rows(MESHGLM_NEWTON_N, align=nd)
        calls = led["calls"].get("model/glm.matvec", 0)
        matvec = led["ops"].get("glm.matvec")
        if calls != ev["value"] + ev["gram"] or matvec != {
                "model": calls * (nm - 1) * n_pad * 4}:
            errs.append(f"newton: ledger glm.matvec {matvec} in {calls} "
                        "calls")
        errs += meshglm_ledger_errors("newton", led, m, {
            "glm.grad": (width // nm * 4, ev["grad"])})
        shape = (width // nm, width)
    else:
        errs += meshglm_ledger_errors("newton", led, m, {
            "glm.value": (4, ev["value"]), "glm.grad": (d * 4, ev["grad"]),
            "glm.gram": (d * d * 4, ev["gram"])})
        shape = (d, d)
    out = {"wall_s": wall, "n_iter": est.n_iter_,
           "ms_per_iter": est.fit_phase_seconds_["solve"] * 1e3
           / max(est.n_iter_, 1), "evals": ev,
           "hpsum_ms": meshglm_hpsum_ms(m, shape, dev),
           "hpsum_shape": list(shape), "ledger_bytes": led["ops"],
           "gap": float(np.abs(coef - want).max())}
    return out, errs, {"coef": coef}


def meshglm_pcas(m, data, ref, dev):
    """PCA(100) full and randomized and TruncatedSVD(100) at the JAX PCA
    bench's matrix over ``m`` (on the model layout X's columns are staged
    split over ``model`` and gathered for the factorization)."""
    import torch

    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib

    X = data["pca_X"]
    errs, out, arrays = [], {}, {}
    for tag in MESHGLM_PCAS:
        meshglm_sync(m, dev)
        hier.reset_ledger()
        with mesh_lib.use_mesh(m):
            est, wall, _ = drive(lambda: meshglm_pca(tag).fit(X))
        led = hier.ledger_snapshot()
        sv, svr = est.singular_values_, ref[f"{tag}-singular_values_"]
        evr = est.explained_variance_ratio_
        evr_r = ref[f"{tag}-explained_variance_ratio_"]
        C, Cr = est.components_, ref[f"{tag}-components_"]
        span = float(np.linalg.svd(
            C[:PCA_RANK].astype(np.float64)
            @ Cr[:PCA_RANK].astype(np.float64).T,
            compute_uv=False).min())
        gap = float(np.abs(sv - svr).max() / svr[0])
        if gap > MESHGLM_PCA_RTOL or not np.allclose(
                evr, evr_r, rtol=MESHGLM_PCA_RTOL,
                atol=MESHGLM_PCA_RTOL * evr_r[0]) \
                or span < 1.0 - MESHGLM_PCA_RTOL:
            errs.append(f"{tag}: singular values {gap} of the largest from "
                        f"the single-device fit's, signal span cosine "
                        f"{span}")
        if tag != "pca-rand":
            errs += meshglm_ledger_errors(tag, led, m, {
                "tsqr.gram": (PCA_D * PCA_D * 4, 2),
                "tsqr.guard": (PCA_D * PCA_D * 4, 1)})
        out[tag] = {"wall_s": wall, "sv_gap": gap, "signal_span": span,
                    "ledger_bytes": led["ops"]}
        arrays[tag] = est.components_
    out["hpsum_ms"] = meshglm_hpsum_ms(m, (PCA_D, PCA_D), dev)
    out["hpsum_shape"] = [PCA_D, PCA_D]
    torch.cuda.empty_cache()
    return out, errs, arrays


MESHGLM_RUN = {"sparse-lbfgs": meshglm_sparse, "admm": meshglm_admm,
               "newton": meshglm_newton, "pca": meshglm_pcas}


def meshglm_rank(backend: str, world: int, rank: int, tmp: str, layouts):
    """One rank of a MESHGLM world (run in a spawned process): join the
    world on card 0, map the parent's arrays, run every cell of every
    layout on this rank's rows, hold each to the single-device fit, write
    this rank's report and models to ``tmp``."""
    import os
    import traceback

    report = {"rank": rank, "errors": [], "cells": {}}
    models = {}
    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        from dask_ml_tpu_torch.ops import sparse as sps
        from dask_ml_tpu_torch.parallel import runtime, shapes

        store = os.path.join(tmp, f"store-{backend}-{world}")
        if world > 1:
            # NCCL refuses two ranks on one card: initialize says so
            try:
                runtime.initialize(backend="nccl",
                                   init_method="file://" + store + "-nccl",
                                   num_processes=world, process_id=rank,
                                   local_device_ids=[0])
                report["errors"].append(
                    "runtime.initialize accepted nccl with two ranks on "
                    "one card")
                runtime.shutdown()
            except RuntimeError as e:
                report["nccl_refused"] = str(e)
        runtime.initialize(backend=backend, init_method="file://" + store,
                           num_processes=world, process_id=rank,
                           local_device_ids=[0])
        dev = runtime.device()
        meshes = mesh_layouts(world, layouts)
        data = {name: np.load(os.path.join(tmp, name + ".npy"),
                              mmap_mode="r")
                for name in ("sparse_values", "sparse_cols", "sparse_y",
                             "admm_X", "admm_y", "pca_X")}
        ref = dict(np.load(os.path.join(tmp, "ref.npz")))
        # warmup: K6 and K6-b once, which loads their library
        A = ell_ints(np.random.default_rng([SEED, 21]), 64, 4, 9, dev)
        sps._spmv_cuda(A.values, A.cols, torch.ones(9, device=dev))
        sps._pullback_cuda(A.values, A.cols, torch.ones(64, device=dev), 9)
        torch.cuda.synchronize()
        st0 = shapes.compile_stats()
        for name, m in meshes.items():
            for cell in MESHGLM_CELLS[name]:
                out, errs, arrays = MESHGLM_RUN[cell](m, data, ref, dev)
                report["cells"][f"{name}-{cell}"] = out
                report["errors"] += [f"{name}: {e}" for e in errs]
                models.update({f"{name}-{cell}-{k}": v
                               for k, v in arrays.items()})
                torch.cuda.empty_cache()
        st1 = shapes.compile_stats()
        for key in ("n_compiles", "n_loads"):
            if st1[key] != st0[key]:
                report["errors"].append(
                    f"{key} {st0[key]} -> {st1[key]} after the warmup")
        runtime.shutdown()
    except BaseException:
        report["errors"].append(traceback.format_exc())
    np.savez(os.path.join(tmp, f"models-{backend}-{world}-{rank}.npz"),
             **models)
    with open(os.path.join(tmp, f"rank-{backend}-{world}-{rank}.json"),
              "w") as f:
        json.dump(report, f)


def meshglm_line(per) -> dict:
    """A MESHGLM line's numbers from the ranks' reports of one cell: what
    differs between ranks as a list a rank, rank 0's ledger (every rank
    records the mesh-wide bytes), the largest gap to the single-device
    fit."""
    if "pca-full" in per[0]:
        return {"hpsum_ms": [c["hpsum_ms"] for c in per],
                "hpsum_shape": per[0]["hpsum_shape"],
                **{tag: {"wall_s": [c[tag]["wall_s"] for c in per],
                         "sv_gap": max(c[tag]["sv_gap"] for c in per),
                         "signal_span": min(c[tag]["signal_span"]
                                            for c in per),
                         "ledger_bytes": per[0][tag]["ledger_bytes"]}
                   for tag in MESHGLM_PCAS}}
    lists = ("wall_s", "ms_per_eval", "ms_per_outer_iter", "ms_per_iter",
             "hpsum_ms", "launches", "newton_steps", "rows_here")
    out = {k: [c[k] for c in per] for k in lists if k in per[0]}
    out.update({k: per[0][k] for k in ("n_iter", "evals", "hpsum_shape",
                                       "routes", "slots", "ledger_bytes")
                if k in per[0]})
    out["gap"] = max(c["gap"] for c in per)
    return out


def meshglm_cells(dev):
    """The MESHGLM phase (step 21). Returns ({world-layout-cell: [each
    rank's K6 / K6-b launches]}, summary)."""
    import os
    import shutil
    import tempfile

    import torch

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    Xs, ys = drawn("sparse_glm", sparse_glm_data)
    Xa, ya = drawn("admm", lambda: admm_data(SEED))
    Xp = drawn("pca", lambda: pca_data(SEED))
    draw_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="dmlt_meshglm_")
    launches_by_cell, summary = {}, {"worlds": []}
    try:
        t0 = time.perf_counter()
        # drawn once: every rank maps these files and copies its rows
        for name, a in (("sparse_values", Xs.values),
                        ("sparse_cols", Xs.cols), ("sparse_y", ys),
                        ("admm_X", Xa), ("admm_y", ya), ("pca_X", Xp)):
            np.save(os.path.join(tmp, name + ".npy"), a)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref, single = meshglm_refs(dev, Xs, ys, Xa, ya, Xp)
        np.savez(os.path.join(tmp, "ref.npz"), **ref)
        summary.update(draw_s=draw_s, save_s=save_s,
                       single_device_s=time.perf_counter() - t0,
                       single=single)
        log("MESHGLM single-device " + json.dumps(
            {"draw_s": draw_s, "save_s": save_s, **single}))
        torch.cuda.empty_cache()
        ctx = rank_context()
        for backend, world, layouts in MESHGLM_WORLDS:
            t0 = time.perf_counter()
            procs = [ctx.Process(target=meshglm_rank,
                                 args=(backend, world, r, tmp, layouts))
                     for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + MESHGLM_TIMEOUT
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
            expect(not hung, f"MESHGLM {backend} world {world}: ranks "
                   f"{hung} still running after {MESHGLM_TIMEOUT} s")
            reports, models = [], []
            for r, p in enumerate(procs):
                path = os.path.join(tmp, f"rank-{backend}-{world}-{r}.json")
                expect(p.exitcode == 0 and os.path.exists(path),
                       f"MESHGLM {backend} world {world} rank {r} exited "
                       f"{p.exitcode} without a report")
                with open(path) as f:
                    reports.append(json.load(f))
                models.append(dict(np.load(os.path.join(
                    tmp, f"models-{backend}-{world}-{r}.npz"))))
            errors = [e for rep in reports for e in rep["errors"]]
            expect(not errors, f"MESHGLM {backend} world {world}: "
                   + " | ".join(errors))
            for key, v in models[0].items():
                expect(all(np.array_equal(mo[key], v) for mo in models[1:]),
                       f"MESHGLM {backend} world {world}: {key} differs "
                       "between ranks")
            if world > 1:
                expect(all("distinct card" in rep.get("nccl_refused", "")
                           for rep in reports),
                       "nccl was not refused for two ranks on one card")
            sec = time.perf_counter() - t0
            for layout in layouts:
                for cell in MESHGLM_CELLS[layout]:
                    per = [rep["cells"][f"{layout}-{cell}"]
                           for rep in reports]
                    line = {"backend": backend, "world": world,
                            "layout": layout, "cell": f"meshglm-{cell}",
                            "world_seconds": sec,
                            **meshglm_line(per)}
                    log("MESHGLM " + json.dumps(line))
                    summary["worlds"].append(line)
                    if cell == "sparse-lbfgs":
                        launches_by_cell[
                            f"{backend}-w{world}-{layout}-{cell}"] = [
                            c["launches"] for c in per]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t_all
    log(f"MESHGLM phase: {summary['seconds']:.1f} s")
    return launches_by_cell, summary


# ---------------------------------------------------------------------------
# ELASTIC: the elastic multi-host tier, hosts as real processes on card 0
# ---------------------------------------------------------------------------

#: the sparse ADMM cell's container (step 10's) in 8 blocks, shuffled by
#: seed 11, 3 outer iterations at abstol = reltol = 0; the PCA cell in 8
#: blocks; heartbeats time out after 4 s
ELASTIC_BLOCKS, ELASTIC_SEED, ELASTIC_OUTER = 8, 11, 3
ELASTIC_HB_TIMEOUT = 4.0
#: the seconds a pair of host processes may take, and the trigger's poll
ELASTIC_WAIT, ELASTIC_POLL = 300.0, 0.005
#: the search: successive halving over MiniBatchKMeans(n_clusters=8) on
#: the blobs of step 4, the 10 candidates of HB_MB_GRID
ELASTIC_SH = dict(n_initial_parameters="grid", n_initial_epochs=1,
                  aggressiveness=3, max_epochs=9, n_blocks=8,
                  random_state=SEED)
#: the pairs of host processes: (run, modes, trigger). A trigger (mode,
#: epoch, signal) signals rank 1 right after its first publication of that
#: epoch is seen in the workdir (a rung's uid for the search)
ELASTIC_PAIRS = (("two-clean", "admm,moments,search", None),
                 ("two-kill", "admm", ("admm", 1, "SIGKILL")),
                 ("two-drain", "admm-drain", ("admm-drain", 1, "SIGTERM")),
                 ("two-kill-moments", "moments", ("moments", 0, "SIGKILL")),
                 ("two-kill-search", "search", ("search", 1000, "SIGKILL")))
ELASTIC_K6 = ("spmv", "spmv_l2", "spmv_pullback", "spmv_pullback_l2")


def write_json(path: str, obj) -> None:
    """``obj`` as JSON at ``path``, written whole (temporary file and
    rename), so a reader never sees half of it."""
    import os

    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def elastic_bytes(rank: int):
    """This process's ``stream.bytes{host=<rank>}`` counter."""
    from dask_ml_tpu_torch.parallel import telemetry

    return telemetry.counters().get(f"stream.bytes{{host={rank}}}", 0)


def elastic_counts() -> dict:
    """This process's launches by kernel and its compile counts."""
    from dask_ml_tpu_torch import _kernels
    from dask_ml_tpu_torch.parallel import shapes

    return {"launches": dict(_kernels.launches),
            "compile": {k: shapes.compile_stats()[k]
                        for k in ("n_compiles", "n_loads")}}


def elastic_run(workdir: str, progress=None, **kw):
    """An ``ElasticRun`` (rank and world from the process's environment)
    that also records when this host first saw a peer lost, the lost
    peer's heartbeat age then (under the timeout: a tombstone was seen),
    and how many blocks it published; with ``progress``, each publication
    first writes the counts so far there (they outlive a killed host, and
    a watcher that sees the block sees them too)."""
    from dask_ml_tpu_torch.parallel.elastic import ElasticRun

    class TimedRun(ElasticRun):
        t_lost = None
        lost_age = None
        n_published = 0

        def lost_hosts(self):
            lost = super().lost_hosts()
            if lost and self.t_lost is None:
                self.t_lost = time.time()
                ages = [self._live.age(f"host{r}") for r in lost]
                self.lost_age = max((a for a in ages if a is not None),
                                    default=None)
            return lost

        def publish(self, epoch, block, tree):
            self.n_published += 1
            if progress is not None:
                write_json(progress, {
                    "t": time.time(), "published": self.n_published,
                    "stream_bytes": elastic_bytes(self.rank),
                    **elastic_counts()})
            super().publish(epoch, block, tree)

    return TimedRun(workdir, shuffle_seed=ELASTIC_SEED,
                    heartbeat_timeout=ELASTIC_HB_TIMEOUT, **kw)


def elastic_host_stats(run) -> dict:
    return {"rank": run.rank, "computed": run.n_published,
            "rebalanced": run.blocks_rebalanced,
            "speculated": run.blocks_speculated,
            "hosts_lost": run.hosts_lost, "t_lost": run.t_lost,
            "lost_age": run.lost_age}


def elastic_sparse_source(data_dir: str):
    """The sparse ADMM cell's blocks read from the mapped files (a copy of
    each block's rows), as a host source with the facade's intercept."""
    import os

    from dask_ml_tpu_torch.linear_model.glm import _intercept_block
    from dask_ml_tpu_torch.ops.sparse import SparseRows
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    vals, cols, y = (np.load(os.path.join(data_dir, f"sp_{k}.npy"),
                             mmap_mode="r") for k in ("values", "cols", "y"))
    rows = SPADMM_N // ELASTIC_BLOCKS
    w = np.ones(rows, np.float32)

    def load(b):
        s = slice(b * rows, (b + 1) * rows)
        return (SparseRows(np.array(vals[s]), np.array(cols[s]), SPADMM_D),
                np.array(y[s]), w)

    return HostBlockSource(loader=load, n_blocks=ELASTIC_BLOCKS
                           ).with_transform(_intercept_block)


def elastic_admm(data_dir: str, run=None, **extra):
    """The streamed sparse ADMM of the cell (the core ``admm_streamed``
    under the facade's intercept, mask and settings); ``run`` makes it
    elastic. Returns ((z, x, u) as numpy, n_iter, source)."""
    import torch

    from dask_ml_tpu_torch.models import glm as glm_core

    d = SPADMM_D + 1
    src = elastic_sparse_source(data_dir)
    mask = torch.ones(d, device=src.device)
    mask[-1] = 0.0
    _, n_iter, state, _ = glm_core.admm_streamed(
        src, ELASTIC_BLOCKS, d, float(SPADMM_N), mask, lamduh=1.0,
        max_iter=ELASTIC_OUTER, abstol=0.0, reltol=0.0, return_state=True,
        elastic=run, **extra)
    return tuple(t.cpu().numpy() for t in state), n_iter, src


def elastic_pca_source(data_dir: str):
    import os

    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    X = np.load(os.path.join(data_dir, "pca_X.npy"), mmap_mode="r")
    rows = PCA_N // ELASTIC_BLOCKS
    w = np.ones(rows, np.float32)
    return HostBlockSource(
        loader=lambda b: (np.array(X[b * rows:(b + 1) * rows]), w),
        n_blocks=ELASTIC_BLOCKS)


def elastic_moments(data_dir: str, run=None):
    """``streamed_moments`` and ``pca_fit_blocks`` of the PCA cell (the
    second reads the blocks the first published)."""
    from dask_ml_tpu_torch.decomposition.streaming import (pca_fit_blocks,
                                                           streamed_moments)

    src = elastic_pca_source(data_dir)
    m = streamed_moments(block_fn=src, n_blocks=ELASTIC_BLOCKS,
                         elastic=run)
    est = pca_fit_blocks(elastic_pca_source(data_dir), ELASTIC_BLOCKS,
                         PCA_K, elastic=run)
    return tuple(t.cpu().numpy() for t in m), est, src


def elastic_search(run=None):
    """Successive halving over MiniBatchKMeans on the blobs (drawn here
    from the seed)."""
    from dask_ml_tpu_torch.cluster import MiniBatchKMeans
    from dask_ml_tpu_torch.model_selection import SuccessiveHalvingSearchCV

    X, _ = drawn("blobs", lambda: blobs_data(SEED))
    return SuccessiveHalvingSearchCV(MiniBatchKMeans(n_clusters=K),
                                     HB_MB_GRID, elastic=run,
                                     **ELASTIC_SH).fit(X)


def elastic_consensus_bytes(run) -> int:
    """The bytes of the blocks other hosts published in each epoch of the
    elastic ADMM, read from the published files' ``by``: what the
    consensus imported."""
    import glob
    import os

    from dask_ml_tpu_torch.checkpoint import load_pytree

    total = 0
    for path in glob.glob(os.path.join(run.workdir, run._ns, "blocks",
                                       "e*", "b*.ckpt")):
        tree, meta = load_pytree(path)
        if meta["by"] != run.rank:
            total += int(np.asarray(tree).nbytes)
    return total


def elastic_mode(mode: str, data_dir: str, workdir: str, dev) -> dict:
    """One mode of a host process; the counts start at 0 here."""
    import os

    import torch

    from dask_ml_tpu_torch import _kernels, config_context
    from dask_ml_tpu_torch.parallel import hierarchy, runtime
    from dask_ml_tpu_torch.parallel.faults import Preempted

    rank = runtime.process_rank()
    run = elastic_run(os.path.join(workdir, mode), progress=os.path.join(
        workdir, f"{mode}-r{rank}-progress.json"))
    out = {"outcome": "done"}
    hierarchy.reset_ledger()
    b0 = elastic_bytes(rank)
    with config_context(telemetry=True):
        _kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            if mode.startswith("admm"):
                extra = {}
                if mode == "admm-drain":
                    extra = dict(checkpoint_path=os.path.join(
                        workdir, f"admm-r{rank}.ckpt"), checkpoint_every=1)
                state, n_iter, _ = elastic_admm(data_dir, run, **extra)
                np.savez(os.path.join(workdir, f"{mode}-r{rank}.npz"),
                         z=state[0], x=state[1], u=state[2])
                out.update(n_iter=n_iter, ledger=hierarchy.ledger_snapshot()
                           ["ops"].get("glm.admm.consensus", {}),
                           foreign_bytes=elastic_consensus_bytes(run))
            elif mode == "moments":
                m, est, _ = elastic_moments(data_dir, run)
                np.savez(os.path.join(workdir, f"{mode}-r{rank}.npz"),
                         sw=m[0], s=m[1], G=m[2],
                         components=est.components_,
                         variance=est.explained_variance_)
            else:
                sh = elastic_search(run)
                np.savez(os.path.join(workdir, f"{mode}-r{rank}.npz"),
                         score=sh.cv_results_["test_score"])
                out.update(best_params=sh.best_params_,
                           rebalanced_in_stats=sh.n_blocks_rebalanced_)
        except Preempted as e:
            out.update(outcome="preempted", message=str(e))
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["stream_bytes"] = elastic_bytes(rank) - b0
    out["launches"] = dict(_kernels.launches)
    out.update(elastic_host_stats(run))
    return out


def elastic_warmup(dev, data_dir: str, modes) -> dict:
    """Load every kernel library, then hold the kernels of the modes
    against their plain versions: K6 and K6-b bit for bit on an
    integer-valued copy of block 0 (the ADMM modes), K2 bit for bit on
    integer-valued rows of the blobs' shape (the search)."""
    import torch

    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.linear_model.glm import add_intercept
    from dask_ml_tpu_torch.ops import fused_distance as fd
    from dask_ml_tpu_torch.ops import sparse as sps

    for name in build.SIGNATURES:
        build.load(name)
    out = {"builds_nvcc": int(build.builds["nvcc"]), "checks": []}
    rng = np.random.default_rng([SEED, 22])
    if any(m.startswith("admm") for m in modes):
        blk = elastic_sparse_source(data_dir).host_block(0)[0]
        A = add_intercept(sps.SparseRows(
            torch.round(torch.as_tensor(blk.values, device=dev) * 4),
            torch.as_tensor(blk.cols, device=dev), SPADMM_D))
        n, k = A.values.shape
        v = torch.as_tensor(rng.integers(-4, 4, A.d), dtype=torch.float32,
                            device=dev)
        r = torch.as_tensor(rng.integers(-1, 2, n), dtype=torch.float32,
                            device=dev)
        check_spmv_int(f"elastic block 0 n{n} k{k} d{A.d}", A, v, r, [None],
                       [None])
        out["checks"].append(f"K6 and K6-b at ({n}, {k}, {A.d})")
    if "search" in modes:
        Xi = torch.as_tensor(rng.integers(-8, 8, (100_000, D)),
                             dtype=torch.float32, device=dev)
        Y = Xi[:K].clone()
        ka, km = fd.fused_argmin_min(Xi, Y, None, kernel="cuda")
        ra, rm = fd.fused_argmin_min(Xi, Y, None, kernel="torch")
        expect(torch.equal(ka, ra) and torch.equal(km, rm),
               "K2 in a host process: not bit-identical to the plain "
               "version")
        out["checks"].append(f"K2 at (100000, {K}, {D})")
    torch.cuda.synchronize()
    out.update(elastic_counts())
    return out


def elastic_host(rank: int, data_dir: str, workdir: str, modes: str,
                 log_path: str) -> None:
    """An ELASTIC host process (started from :func:`rank_context`): rank
    ``rank`` of 2, its output to ``log_path``; exits with
    :func:`elastic_worker`'s code."""
    import os

    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    os.environ.update(DASK_ML_TPU_PROCESS_ID=str(rank),
                      DASK_ML_TPU_NUM_PROCESSES="2")
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(elastic_worker(data_dir, workdir, modes))


def elastic_worker(data_dir: str, workdir: str, modes: str) -> int:
    """A host process of the ELASTIC phase (rank and world from
    ``DASK_ML_TPU_PROCESS_ID`` / ``DASK_ML_TPU_NUM_PROCESSES``): warm up
    on card 0, run each mode, write ``r<rank>-warm.json`` and
    ``r<rank>.json`` to ``workdir``."""
    import os
    import traceback

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from dask_ml_tpu_torch._kernels import build
    from dask_ml_tpu_torch.config import resolve_device
    from dask_ml_tpu_torch.parallel import runtime, shapes

    rank = runtime.process_rank()
    report = {"rank": rank, "pid": os.getpid(), "errors": [], "modes": {}}
    try:
        dev = resolve_device()  # card 0: no other is visible here
        modes = modes.split(",")
        warm = elastic_warmup(dev, data_dir, modes)
        write_json(os.path.join(workdir, f"r{rank}-warm.json"), warm)
        st0 = shapes.compile_stats()
        for mode in modes:
            report["modes"][mode] = elastic_mode(mode, data_dir, workdir,
                                                 dev)
        st1 = shapes.compile_stats()
        report["builds_nvcc"] = int(build.builds["nvcc"])
        for key in ("n_compiles", "n_loads"):
            if st1[key] != st0[key]:
                report["errors"].append(
                    f"{key} {st0[key]} -> {st1[key]} after the warmup")
    except BaseException:
        report["errors"].append(traceback.format_exc())
    write_json(os.path.join(workdir, f"r{rank}.json"), report)
    return 1 if report["errors"] else 0


def elastic_pair(data_dir: str, tmp: str, name: str, modes: str, trigger):
    """Two host processes on card 0 running ``modes``; with a trigger,
    rank 1 gets its signal right after its first publication of the
    trigger's epoch shows in the workdir. Returns (reports, warm reports,
    rank 1's last progress, the signal's time)."""
    import glob
    import os
    import signal

    from dask_ml_tpu_torch.parallel.elastic import BlockPlan

    wd = os.path.join(tmp, name)
    os.makedirs(wd)
    ctx = rank_context()
    procs = [ctx.Process(target=elastic_host, args=(
        r, data_dir, wd, modes, os.path.join(wd, f"r{r}.log")))
        for r in range(2)]
    for p in procs:
        p.start()
    t_signal = None
    deadline = time.monotonic() + ELASTIC_WAIT
    try:
        if trigger is not None:
            mode, epoch, sig = trigger
            if mode == "search":
                # the rung's candidates in identity order, all at rung 0
                order = list(range(int(np.prod(
                    [len(v) for v in HB_MB_GRID.values()]))))
            else:
                order = BlockPlan(ELASTIC_BLOCKS, seed=ELASTIC_SEED
                                  ).epoch_order(epoch)
            mine = set(BlockPlan.shard(order, 1, [0, 1]))
            pattern = os.path.join(wd, mode, "*", "blocks",
                                   f"e{epoch:04d}", "b*.ckpt")
            while t_signal is None:
                seen = {int(os.path.basename(p)[1:-5])
                        for p in glob.glob(pattern)}
                if seen & mine:
                    os.kill(procs[1].pid, getattr(signal, sig))
                    t_signal = time.time()
                    break
                expect(procs[1].is_alive() and time.monotonic()
                       < deadline, f"ELASTIC {name}: rank 1 ended or timed "
                       f"out before its first publication of epoch {epoch}")
                time.sleep(ELASTIC_POLL)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
        expect(not any(p.is_alive() for p in procs),
               f"ELASTIC {name}: host processes still running after "
               f"{ELASTIC_WAIT} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)

    def read(path):
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def tail(r):
        path = os.path.join(wd, f"r{r}.log")
        if not os.path.exists(path):
            return "(no log)"
        with open(path) as f:
            return f.read()[-3000:]

    reports = [read(os.path.join(wd, f"r{r}.json")) for r in range(2)]
    warms = [read(os.path.join(wd, f"r{r}-warm.json")) for r in range(2)]
    for r in range(2):
        expect(warms[r] is not None, f"ELASTIC {name}: rank {r} did not "
               f"warm up:\n{tail(r)}")
        expect(warms[r]["builds_nvcc"] == 0,
               f"ELASTIC {name}: rank {r} built a kernel")
    killed = trigger is not None and trigger[2] == "SIGKILL"
    expect(procs[0].exitcode == 0 and reports[0] is not None
           and not reports[0]["errors"], f"ELASTIC {name}: rank 0 exited "
           f"{procs[0].exitcode}: {reports[0] and reports[0]['errors']}"
           f"\n{tail(0)}")
    if killed:
        expect(procs[1].exitcode == -signal.SIGKILL and reports[1] is None,
               f"ELASTIC {name}: rank 1 exited {procs[1].exitcode}, not "
               "by the SIGKILL")
    else:
        expect(procs[1].exitcode == 0 and reports[1] is not None
               and not reports[1]["errors"], f"ELASTIC {name}: rank 1 "
               f"exited {procs[1].exitcode}: "
               f"{reports[1] and reports[1]['errors']}\n{tail(1)}")
    progress = None
    if trigger is not None:
        progress = read(os.path.join(wd, f"{trigger[0]}-r1-progress.json"))
    return reports, warms, progress, t_signal


def elastic_line(cell: str, run: str, per: list, **extra) -> dict:
    line = {"cell": cell, "run": run,
            "walls_s": [p and p["wall_s"] for p in per],
            "computed": [p and p["computed"] for p in per],
            "rebalanced": [p and p["rebalanced"] for p in per],
            "speculated": [p and p["speculated"] for p in per],
            "hosts_lost": [p and p["hosts_lost"] for p in per],
            "stream_bytes_by_host": {str(i): p["stream_bytes"]
                                     for i, p in enumerate(per) if p},
            **extra}
    log("ELASTIC " + json.dumps(line))
    return line


def elastic_cells(dev):
    """The ELASTIC phase (step 22). Returns ({cell/run: [each rank's
    launches]}, summary)."""
    import glob
    import os
    import shutil
    import tempfile

    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.datasets import make_sparse_classification
    from dask_ml_tpu_torch.decomposition import PCA
    from dask_ml_tpu_torch.decomposition.streaming import streamed_moments
    from dask_ml_tpu_torch.parallel.elastic import BlockPlan
    from dask_ml_tpu_torch.parallel.faults import FaultInjector, Preempted

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    Xs, ys = drawn("sparse_admm", lambda: make_sparse_classification(
        SPADMM_N, SPADMM_D, SPADMM_DENSITY, random_state=0))
    Xp = drawn("pca", lambda: pca_data(SEED))
    drawn("blobs", lambda: blobs_data(SEED))
    draw_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="dmlt_elastic_")
    launches, lines = {}, []
    summary = {"draw_s": draw_s}
    try:
        t0 = time.perf_counter()
        for name, a in (("sp_values", Xs.values), ("sp_cols", Xs.cols),
                        ("sp_y", ys), ("pca_X", Xp)):
            np.save(os.path.join(tmp, name + ".npy"), a)
        summary["save_s"] = time.perf_counter() - t0

        # -- in this process: the references, world 1, the resume --------
        (ref, n_ref, _), wall_ref, l_ref = drive(lambda: elastic_admm(tmp))
        expect(n_ref == ELASTIC_OUTER, f"ADMM n_iter {n_ref}")
        w1 = elastic_run(os.path.join(tmp, "w1-admm"), rank=0, world=1)
        b0 = elastic_bytes(0)
        with config_context(telemetry=True):
            (got, _, _), wall_w1, l_w1 = drive(lambda: elastic_admm(tmp, w1))
        bytes_w1 = elastic_bytes(0) - b0
        expect(all(np.array_equal(a, b) for a, b in zip(got, ref)),
               "ELASTIC admm: world 1 differs from the non-elastic fit")
        order1 = BlockPlan(ELASTIC_BLOCKS, seed=ELASTIC_SEED).epoch_order(1)
        ck = os.path.join(tmp, "w1-admm.ckpt")
        pre = elastic_run(os.path.join(tmp, "w1-resume"), rank=0, world=1)
        inj = FaultInjector().preempt_at(order1[ELASTIC_BLOCKS // 2],
                                         epoch=1)
        src = elastic_sparse_source(tmp)
        src.fault_injector = inj
        try:
            from dask_ml_tpu_torch.models import glm as glm_core

            mask = torch.ones(SPADMM_D + 1, device=dev)
            mask[-1] = 0.0
            glm_core.admm_streamed(
                src, ELASTIC_BLOCKS, SPADMM_D + 1, float(SPADMM_N), mask,
                lamduh=1.0, max_iter=ELASTIC_OUTER, abstol=0.0, reltol=0.0,
                elastic=pre, checkpoint_path=ck, checkpoint_every=1)
            raise Mismatch("ELASTIC admm: the injected preemption did not "
                           "stop the fit")
        except Preempted:
            pass
        resumed = elastic_run(os.path.join(tmp, "w1-resume"), rank=0,
                              world=1)
        (res, _, _), wall_res, _ = drive(lambda: elastic_admm(
            tmp, resumed, checkpoint_path=ck))
        expect(all(np.array_equal(a, b) for a, b in zip(res, ref)),
               "ELASTIC admm: the resumed fit differs from the "
               "non-elastic fit")
        expect(not os.path.exists(ck), "ELASTIC admm: the snapshot stayed")
        lines.append(elastic_line(
            "elastic-admm-sparse", "world-1", [{
                **elastic_host_stats(w1), "wall_s": wall_w1,
                "stream_bytes": bytes_w1}],
            nonelastic_wall_s=wall_ref, resume_wall_s=wall_res,
            launches=[{k: l_w1[k] for k in ELASTIC_K6}],
            nonelastic_launches={k: l_ref[k] for k in ELASTIC_K6}))
        launches["elastic-admm-sparse/world-1"] = [
            {k: l_w1[k] for k in ELASTIC_K6}]

        m_plain, wall_mp, _ = drive(lambda: streamed_moments(
            block_fn=elastic_pca_source(tmp), n_blocks=ELASTIC_BLOCKS))
        m_plain = tuple(t.cpu().numpy() for t in m_plain)
        wm = elastic_run(os.path.join(tmp, "w1-moments"), rank=0, world=1)
        b0 = elastic_bytes(0)
        with config_context(telemetry=True):
            (m_w1, est_w1, _), wall_m1, _ = drive(lambda: elastic_moments(
                tmp, wm))
        bytes_m1 = elastic_bytes(0) - b0
        Xd = torch.from_numpy(Xp).to(dev).double()
        want = (float(PCA_N), Xd.sum(0).cpu().numpy(),
                (Xd.T @ Xd).cpu().numpy())
        del Xd
        torch.cuda.empty_cache()
        mem = PCA(PCA_K, svd_solver="full").fit(Xp)

        def rel_np(a, b):
            a = np.ravel(np.asarray(a, np.float64))
            b = np.ravel(np.asarray(b, np.float64))
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))

        m_gap = {"vs_plain": [rel_np(a, b) for a, b in zip(m_w1, m_plain)],
                 "vs_f64": [rel_np(a, b) for a, b in zip(m_w1, want)]}
        align = float(np.abs(np.sum(est_w1.components_[:PCA_RANK]
                                    * mem.components_[:PCA_RANK],
                                    axis=1)).min())
        ev = float((np.abs(est_w1.explained_variance_[:PCA_RANK]
                           - mem.explained_variance_[:PCA_RANK])
                    / mem.explained_variance_[:PCA_RANK]).max())
        expect(max(m_gap["vs_plain"] + m_gap["vs_f64"]) <= MOMENT_RTOL
               and align >= ALIGN and ev <= EV_RTOL,
               f"ELASTIC moments: {m_gap}, alignment {align}, variances "
               f"{ev}")
        lines.append(elastic_line(
            "elastic-moments", "world-1", [{
                **elastic_host_stats(wm), "wall_s": wall_m1,
                "stream_bytes": bytes_m1}],
            nonelastic_wall_s=wall_mp, moments_rel=m_gap,
            top64_min_alignment=align, top64_variance_rel=ev,
            kernels="none of the repo's: the block Gram is cuBLAS"))

        ws = elastic_run(os.path.join(tmp, "w1-search"), rank=0, world=1)
        sh_w1, wall_s1, l_s1 = drive(lambda: elastic_search(ws))
        expect(np.isfinite(sh_w1.cv_results_["test_score"]).all()
               and l_s1["fused_argmin_min"] > 0,
               "ELASTIC search: world 1 dropped a candidate or ran no K2")
        lines.append(elastic_line(
            "elastic-search", "world-1", [{
                **elastic_host_stats(ws), "wall_s": wall_s1,
                "stream_bytes": 0}],
            launches=[{"fused_argmin_min": l_s1["fused_argmin_min"]}],
            best_params=sh_w1.best_params_))
        launches["elastic-search/world-1"] = [
            {"fused_argmin_min": l_s1["fused_argmin_min"]}]
        summary["in_process_s"] = time.perf_counter() - t0

        # -- the pairs of host processes ------------------------------------
        clean_wall = {}
        for run_name, modes, trigger in ELASTIC_PAIRS:
            t0 = time.perf_counter()
            reports, warms, progress, t_sig = elastic_pair(
                tmp, tmp, run_name, modes, trigger)
            pair_s = time.perf_counter() - t0
            wd = os.path.join(tmp, run_name)
            for mode in modes.split(","):
                per = [rep and rep["modes"][mode] for rep in reports]
                dead = trigger is not None and trigger[2] == "SIGKILL"
                survivors = [p for p in per if p]
                if mode == "admm-drain":
                    survivors = [per[0]]
                    expect(per[1]["outcome"] == "preempted",
                           f"ELASTIC drain: rank 1 {per[1]['outcome']}")
                    expect(glob.glob(os.path.join(wd, mode, "*", "dead",
                                                  "host1")),
                           "ELASTIC drain: rank 1 left no tombstone")
                for p in survivors:
                    r = p["rank"]
                    got = np.load(os.path.join(wd, f"{mode}-r{r}.npz"))
                    if mode.startswith("admm"):
                        expect(all(np.array_equal(got[k], v) for k, v in
                                   zip("zxu", ref)), f"ELASTIC {run_name} "
                               f"rank {r}: (z, x, u) differs from the "
                               "single-host fit")
                        expect(p["ledger"] == {"pod": p["foreign_bytes"]},
                               f"ELASTIC {run_name} rank {r}: ledger "
                               f"{p['ledger']}, foreign blocks "
                               f"{p['foreign_bytes']} B")
                        k6 = p["launches"]["spmv"] + p["launches"]["spmv_l2"]
                        k6b = (p["launches"]["spmv_pullback"]
                               + p["launches"]["spmv_pullback_l2"])
                        expect(k6 > 0 and k6b > 0, f"ELASTIC {run_name} "
                               f"rank {r}: K6 {k6}, K6-b {k6b} launches")
                    elif mode == "moments":
                        expect(all(np.array_equal(got[k], v) for k, v in
                                   zip(("sw", "s", "G"), m_w1)),
                               f"ELASTIC {run_name} rank {r}: moments "
                               "differ from the world-1 run")
                        expect(np.array_equal(got["components"],
                                              est_w1.components_),
                               f"ELASTIC {run_name} rank {r}: components "
                               "differ from the world-1 run")
                    else:
                        expect(np.array_equal(
                            got["score"], sh_w1.cv_results_["test_score"])
                               and p["best_params"] == sh_w1.best_params_,
                               f"ELASTIC {run_name} rank {r}: scores or "
                               "best_params_ differ from the world-1 run")
                        expect(p["launches"]["fused_argmin_min"] > 0,
                               f"ELASTIC {run_name} rank {r}: no K2")
                extra = {"pair_s": pair_s}
                rank_launches = [p and p["launches"] for p in per]
                if dead:
                    expect(progress is not None, f"ELASTIC {run_name}: "
                           "rank 1 left no progress")
                    rank_launches[1] = progress["launches"]
                    expect(progress["compile"] == warms[1]["compile"],
                           f"ELASTIC {run_name}: rank 1 built or loaded "
                           f"after its warmup: {warms[1]['compile']} -> "
                           f"{progress['compile']}")
                    per[1] = {"rank": 1, "wall_s": None,
                              "computed": progress["published"],
                              "rebalanced": None, "speculated": None,
                              "hosts_lost": None,
                              "stream_bytes": progress["stream_bytes"]}
                    s0 = per[0]
                    expect(s0["hosts_lost"] == 1 and 1 <= s0["rebalanced"]
                           < (len(sh_w1.cv_results_["test_score"])
                              if mode == "search" else ELASTIC_BLOCKS),
                           f"ELASTIC {run_name}: survivor {s0}")
                    extra.update(detection_latency_s=s0["t_lost"] - t_sig,
                                 recovery_overhead=(
                                     s0["wall_s"] / clean_wall[mode]
                                     if mode in clean_wall else None))
                elif trigger is not None:
                    s0 = per[0]
                    expect(s0["hosts_lost"] == 1 and s0["lost_age"]
                           is not None and s0["lost_age"]
                           < ELASTIC_HB_TIMEOUT, f"ELASTIC {run_name}: "
                           f"the survivor waited out the timeout: {s0}")
                    extra.update(detection_latency_s=s0["t_lost"] - t_sig,
                                 heartbeat_age_at_detection_s=s0[
                                     "lost_age"],
                                 recovery_overhead=s0["wall_s"]
                                 / clean_wall["admm"])
                else:
                    clean_wall[mode] = max(p["wall_s"] for p in per)
                for r, l in enumerate(rank_launches):
                    expect(l is not None, f"ELASTIC {run_name}: no launch "
                           f"counts from rank {r}")
                    if mode.startswith("admm"):
                        expect(l["spmv"] + l["spmv_l2"] > 0
                               and l["spmv_pullback"]
                               + l["spmv_pullback_l2"] > 0,
                               f"ELASTIC {run_name} rank {r}: K6 / K6-b "
                               "not launched")
                    if mode == "search":
                        expect(l["fused_argmin_min"] > 0,
                               f"ELASTIC {run_name} rank {r}: K2 not "
                               "launched")
                cell = {"admm": "elastic-admm-sparse",
                        "admm-drain": "elastic-admm-sparse",
                        "moments": "elastic-moments",
                        "search": "elastic-search"}[mode]
                names = ELASTIC_K6 if mode.startswith("admm") else (
                    ("fused_argmin_min",) if mode == "search" else ())
                if names:
                    extra["launches"] = [{k: l[k] for k in names}
                                         for l in rank_launches]
                    launches[f"{cell}/{run_name}"] = extra["launches"]
                else:
                    extra["kernels"] = ("none of the repo's: the block Gram "
                                        "is cuBLAS")
                extra["warmup_checks"] = [w["checks"] for w in warms]
                lines.append(elastic_line(cell, run_name, per, **extra))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary["lines"] = lines
    summary["seconds"] = time.perf_counter() - t_all
    log(f"ELASTIC phase: {summary['seconds']:.1f} s")
    return launches, summary


# ---------------------------------------------------------------------------
# The last mesh= paths over a world of ranks (MESHREST, step 23)
# ---------------------------------------------------------------------------

#: (backend, world size, layouts), as MESH_WORLDS: NCCL at world 1, gloo
#: for four ranks sharing card 0; "hier" is 2 × 2 (world 2's 1 × 2, whose
#: pod stage is empty, left to MESH: a depth cut; a world of 2 on the flat
#: layout, which world 4 runs too, cut for the run's time, PERF.md §4)
MESHREST_WORLDS = (("nccl", 1, ("flat",)), ("gloo", 4, ("flat", "hier")))
#: every cell runs on the flat layout; the hierarchical layouts run the
#: cells whose collectives change with the layout's two stages (a depth
#: cut for the phase's time, PERF.md §4)
MESHREST_CELLS = ("datasets", "spectral", "kernel-kmeans-xor", "search",
                  "sketched", "minibatch", "serving")
MESHREST_HIER_CELLS = ("datasets", "kernel-kmeans-xor", "minibatch")
#: MiniBatchKMeans cut to one epoch (977 steps at batch 1,024); the
#: serving cell's clients and requests a client
MESHREST_MB_EPOCHS = 1
MESHREST_CLIENTS, MESHREST_REQUESTS = 8, 16
MESHREST_POOL = 65_536
MESHREST_TIMEOUT = 600
#: the sketched labels against the world-1 sketched fit: a mismatched row
#: must score its two labels within this share of the operands'
#: magnitude under the rank's own sketch (a near tie)
MESHREST_TIE_EPS = 1e-4
#: config 5's pipeline search over the ranks against the single-device
#: sweep: its PCA stage sums its Gram over the ranks, and the data's
#: spectrum (singular values about 1 % apart) turns the components by
#: ≈ 2e-4 of the data's scale between two summation orders, which moves a
#: member's inertia by up to ≈ 1e-3: rtol 2e-3 (the line records each
#: score's largest relative error). The KMeans grid on the integer copy
#: has no such stage: its test scores bit for bit.
MESHREST_SEARCH_RTOL = 2e-3
MESHREST_KERNELS = ("lloyd_iter", "fused_argmin_min", "fused_rowwise_min",
                    "fused_argmin_weight", "fused_argmin_min2",
                    "fused_argmin_min_sketched")


def meshrest_sha(*arrays) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


#: config 5's grid with fewer members (a depth cut: three of its five PCA
#: widths, every k, five of its ten tolerances; 150 candidates)
MESHREST_SEARCH_GRID = {
    "pca__n_components": SEARCH_GRID["pca__n_components"][::2],
    "km__n_clusters": SEARCH_GRID["km__n_clusters"],
    "km__tol": SEARCH_GRID["km__tol"][::2]}


def meshrest_searches(X):
    """Config 5's pipeline search on ``X``, and its KMeans grid alone on
    the integer copy of ``X``; returns the two fitted searches."""
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.model_selection import GridSearchCV

    pipe = GridSearchCV(make_search_pipe(), MESHREST_SEARCH_GRID,
                        cv=SEARCH_CV, n_jobs=SEARCH_JOBS).fit(X)
    km = GridSearchCV(KMeans(init="random", max_iter=SEARCH_MAX_ITER,
                             random_state=SEED),
                      {"n_clusters": MESHREST_SEARCH_GRID["km__n_clusters"],
                       "tol": MESHREST_SEARCH_GRID["km__tol"]},
                      cv=SEARCH_CV, n_jobs=SEARCH_JOBS).fit(np.rint(X))
    return pipe, km


def meshrest_sketched_fit(X):
    from dask_ml_tpu_torch.cluster import KMeans

    return KMeans(n_clusters=K, init="k-means||", oversampling_factor=2,
                  algorithm="sketched", random_state=SEED).fit(X)


def meshrest_xor_fit(X):
    from dask_ml_tpu_torch.cluster import KernelKMeans

    return KernelKMeans(n_clusters=2, n_components=128, affinity="polynomial",
                        degree=2, coef0=1.0, gamma=0.5,
                        random_state=5).fit(X)


def meshrest_spectral_fit(X):
    from dask_ml_tpu_torch.cluster import SpectralClustering

    return SpectralClustering(n_clusters=SPEC_K, n_components=SPEC_L,
                              gamma=None, random_state=SEED).fit(X)


def meshrest_refs(dev, tmp: str) -> dict:
    """The single-device fits the worlds are held to, on the card (every
    X drawn on the card from a seed, or with numpy; the KDD rows saved to
    ``tmp`` for the ranks to map). Returns the summary's numbers."""
    import os

    import torch

    from dask_ml_tpu_torch import datasets
    from dask_ml_tpu_torch.cluster import KMeans, MiniBatchKMeans

    ref, info, secs = {}, {}, {}
    t0 = time.perf_counter()
    X, y = datasets.make_blobs(N, D, centers=K, random_state=SEED)
    info["blobs_sha"] = meshrest_sha(X.cpu().numpy(), y.cpu().numpy())
    Xi = torch.round(X)
    mb = MiniBatchKMeans(n_clusters=K, random_state=SEED,
                         max_iter=MESHREST_MB_EPOCHS).fit(Xi)
    ref["mb_centers"], ref["mb_labels"] = mb.cluster_centers_, mb.labels_
    ref["mb_counts"] = mb.counts_
    secs["minibatch"] = time.perf_counter() - t0
    del X, Xi
    t0 = time.perf_counter()
    Xs, _ = nystrom_blobs(dev)
    ref["spectral_labels"] = meshrest_spectral_fit(Xs).labels_
    del Xs
    secs["spectral"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xx, yx = xor_data(XOR_N)
    ref["xor_labels"] = meshrest_xor_fit(Xx).labels_
    secs["kernel-kmeans-xor"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe, km = meshrest_searches(search_data(SEED))
    for tag, gs in (("pipe", pipe), ("int", km)):
        for key in ("mean_test_score", "mean_train_score",
                    "split0_test_score", "split1_test_score"):
            ref[f"search_{tag}_{key}"] = np.asarray(gs.cv_results_[key])
        info[f"search_{tag}_best"] = {k: (v.item() if hasattr(v, "item")
                                          else v)
                                      for k, v in gs.best_params_.items()}
    secs["search"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xk = drawn("kdd", lambda: kdd_data(KDD_N, KDD_D, SEED))
    np.save(os.path.join(tmp, "kdd.npy"), Xk)

    def kdd_fits():  # the KDD cell's bounded and sketched fits, if it ran
        exact = KMeans(n_clusters=K, init="k-means||", oversampling_factor=2,
                       algorithm="bounded", random_state=SEED).fit(Xk)
        return {"bounded_inertia": float(exact.inertia_),
                "sketched": meshrest_sketched_fit(Xk)}

    fits = drawn("kdd_fits", kdd_fits)
    ref["sk_labels"] = fits["sketched"].labels_
    info["exact_inertia"] = fits["bounded_inertia"]
    info["sk_inertia"] = float(fits["sketched"].inertia_)
    secs["sketched"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    np.savez(os.path.join(tmp, "ref.npz"), **ref)
    with open(os.path.join(tmp, "ref.json"), "w") as f:
        json.dump(info, f)
    return {"seconds": secs, "sk_inertia_ratio_single":
            info["sk_inertia"] / info["exact_inertia"]}


def meshrest_int_copy(X):
    """An integer-valued copy of a block: rounded after scaling its
    largest magnitude to 2, so the values are -2..2 and every per-row
    score, every count and every column sum of a block below 2**22 rows
    is exact in f32."""
    import torch

    Xf = X.to(torch.float32)
    top = float(Xf.abs().max()) if Xf.numel() else 1.0
    return torch.round(Xf * (2.0 / max(top, 1e-12))).contiguous()


def meshrest_kernel_checks(tag, X, launched: dict) -> list:
    """The kernels ``launched`` held bit for bit against their plain
    versions on an integer copy of this rank's block ``X``: K1 from K
    rows of it (on the whole block its sums and counts bit for bit and
    its inertia, a sum of the block's integer costs in another order
    than the plain version's, within rtol 1e-6; bit for bit, inertia
    included, on the first rows whose costs sum below 2**24), K2 / K3 /
    K4 against 80 rows of it with the rounds' mask (the first 16 valid),
    K5 and K2-x against K rows of it. Returns the kernels checked."""
    import torch

    from dask_ml_tpu_torch.models import kmeans as core

    Xi = meshrest_int_copy(X)
    n, d = Xi.shape
    checked = []
    if launched.get("lloyd_iter", 0):
        C = Xi[:K].clone()
        w = torch.ones(n, device=Xi.device)
        # a row's cost is at most d·4² with values in -2..2
        head = min(n, max(K, (1 << 24) // (16 * d)))
        check_lloyd(f"{tag} K1 on {head} rows", Xi[:head].contiguous(),
                    w[:head], C, exact=True)
        ks, kc, ki = core._lloyd_stats_cuda(Xi, w, C)
        rs, rc, ri = core._lloyd_stats_ref(Xi, w, C)
        expect(torch.equal(ks, rs) and torch.equal(kc, rc)
               and abs(float(ki) - float(ri)) <= 1e-6 * abs(float(ri)),
               f"{tag} K1 on the block: sums or counts not bit-identical, "
               f"or inertia {float(ki)} vs {float(ri)}")
        checked.append("lloyd_iter")
    if any(launched.get(k, 0) for k in ("fused_argmin_min",
                                        "fused_rowwise_min",
                                        "fused_argmin_weight")):
        m = min(ROUND_CAP, n)
        mask = torch.arange(m, device=Xi.device) < min(ROUND_COUNT, m)
        check_fused(f"{tag} K2-K4", Xi, Xi[:m].clone(), mask, exact=True)
        checked += [k for k in ("fused_argmin_min", "fused_rowwise_min",
                                "fused_argmin_weight") if launched.get(k)]
    if launched.get("fused_argmin_min2", 0) or launched.get(
            "fused_argmin_min_sketched", 0):
        check_min2_sketched(f"{tag} K5/K2-x", Xi, Xi[:K].clone(),
                            exact=True)
        checked += [k for k in ("fused_argmin_min2",
                                "fused_argmin_min_sketched")
                    if launched.get(k)]
    torch.cuda.synchronize()
    return checked


def meshrest_run(cell, m, dev, tmp, ref, info, state):
    """Run ``cell`` over ``m`` on this rank with the launch counts set to
    0 just before and read just after; gate it. Returns (the cell's
    block of data for the kernel checks, its launches, its wall, its
    numbers, errors)."""
    import os

    import torch

    from dask_ml_tpu_torch import _kernels, datasets
    from dask_ml_tpu_torch.cluster import MiniBatchKMeans
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    block, out, err = None, {}, []
    torch.cuda.synchronize()
    _kernels.reset_launches()
    hier.reset_ledger()
    t0 = time.perf_counter()
    with mesh_lib.use_mesh(m):
        if cell == "datasets":
            X, y = datasets.make_blobs(N, D, centers=K, random_state=SEED,
                                       mesh=m)
            sha = meshrest_sha(X.cpu().numpy(), y.cpu().numpy())
            if sha != info["blobs_sha"]:
                err.append("meshrest-datasets: the rank's blobs are not "
                           "the world-1 bits")
            state["blobs"] = X
            block = prepare_data(X, mesh=m).X
        elif cell == "spectral":
            Xs, ys = nystrom_blobs(dev)
            sc = meshrest_spectral_fit(Xs)
            a = ari(ref["spectral_labels"], sc.labels_)
            pred = sc.predict(Xs)
            if a != 1.0 or not np.array_equal(pred, sc.labels_):
                err.append(f"meshrest-spectral: ARI {a} against the "
                           "single-device fit, or predict(X) != labels_")
            out = {"ari_vs_single": a, "ari_vs_truth": ari(ys,
                                                               sc.labels_)}
            block = sc._extend_rows(prepare_data(Xs, mesh=m).X)
        elif cell == "kernel-kmeans-xor":
            Xx, yx = xor_data(XOR_N)
            kk = meshrest_xor_fit(Xx)
            led = hier.ledger_snapshot()["ops"].get("kernel.gram.colsum",
                                                    {})
            want = (hier.collective_bytes(m, 128 * 4)
                    if mesh_lib.is_sharded(m) else {})
            if mesh_lib.is_sharded(m) and led != want:
                err.append(f"meshrest-kernel-kmeans-xor: ledger {led}, "
                           f"formula {want}")
            a = ari(yx, kk.labels_)
            if a < 0.9 or not np.array_equal(kk.predict(Xx), kk.labels_):
                err.append(f"meshrest-kernel-kmeans-xor: ARI {a} < 0.9 or "
                           "predict(X) != labels_")
            out = {"ari": a, "ari_vs_single": ari(ref["xor_labels"],
                                                      kk.labels_),
                       "ledger_colsum": led}
            block = kk._extend_rows(prepare_data(Xx, mesh=m).X)
        elif cell == "search":
            X = search_data(SEED)
            pipe, km = meshrest_searches(X)
            for tag, gs in (("pipe", pipe), ("int", km)):
                for key in ("mean_test_score", "mean_train_score",
                            "split0_test_score", "split1_test_score"):
                    got = np.asarray(gs.cv_results_[key])
                    want = ref[f"search_{tag}_{key}"]
                    if tag == "int" and "test" in key:
                        ok = np.array_equal(got, want)
                    else:
                        ok = np.allclose(got, want, atol=0, rtol=(
                            1e-5 if tag == "int" else MESHREST_SEARCH_RTOL))
                    out[f"{tag}_{key}_max_rel_err"] = float(np.max(
                        np.abs(got - want) / np.abs(want)))
                    if not ok:
                        err.append(f"meshrest-search {tag} {key}: max rel "
                                   f"err {np.max(np.abs(got - want) / np.abs(want))}")
                best = {k: (v.item() if hasattr(v, "item") else v)
                        for k, v in gs.best_params_.items()}
                if best != info[f"search_{tag}_best"]:
                    err.append(f"meshrest-search {tag}: best_params_ {best}")
                out[f"{tag}_batched_cells"] = int(gs.n_batched_cells_)
                if gs.n_batched_cells_ != len(gs.cv_results_["params"]) \
                        * SEARCH_CV:
                    err.append(f"meshrest-search {tag}: a cell ran outside "
                               "its group")
            block = prepare_data(np.rint(X[:X.shape[0] // SEARCH_CV]),
                                     mesh=m).X
        elif cell == "sketched":
            Xk = np.load(os.path.join(tmp, "kdd.npy"), mmap_mode="r")
            sk = meshrest_sketched_fit(Xk)
            ratio = sk.inertia_ / info["exact_inertia"]
            data = prepare_data(Xk, mesh=m)
            Wp, off, vals, _ = sk._sketch_args(dev)
            Zp = data.X @ Wp - off[None, :]
            bad = np.flatnonzero(sk.labels_ != ref["sk_labels"])
            ties_ok = True
            if bad.size:
                Zb = torch.as_tensor(np.asarray(Xk[bad]), device=dev) @ Wp \
                    - off[None, :]
                s = (vals * vals).sum(1)[None, :] - 2.0 * Zb @ vals.T
                lab = torch.as_tensor(sk.labels_[bad], device=dev).long()
                lab1 = torch.as_tensor(ref["sk_labels"][bad],
                                       device=dev).long()
                gap = (s.gather(1, lab[:, None]) - s.gather(
                    1, lab1[:, None]))[:, 0].abs()
                reach = MESHREST_TIE_EPS * ((Zb * Zb).sum(1)
                                            + (vals * vals).sum(1).max())
                ties_ok = bool((gap <= reach).all())
            pred = sk.predict(Xk)
            if ratio > 1.05 or not ties_ok \
                    or not np.array_equal(pred, sk.labels_):
                err.append(f"meshrest-sketched: inertia ratio {ratio}, "
                           f"{bad.size} labels off the world-1 fit (near "
                           f"ties: {ties_ok}), or predict != labels_")
            out = {"inertia_ratio": ratio, "n_iter": int(sk.n_iter_),
                       "labels_off_world1": int(bad.size)}
            state["sketched"] = sk
            state["kdd"] = Xk
            block = Zp
        elif cell == "minibatch":
            Xi = torch.round(state["blobs"])
            mb = MiniBatchKMeans(n_clusters=K, random_state=SEED,
                                 max_iter=MESHREST_MB_EPOCHS).fit(Xi)
            if not (np.array_equal(mb.cluster_centers_, ref["mb_centers"])
                    and np.array_equal(mb.labels_, ref["mb_labels"])
                    and np.array_equal(mb.counts_, ref["mb_counts"])):
                err.append("meshrest-minibatch: not the single-device "
                           "centers, counts and labels bit for bit")
            out = {"n_steps": int(mb.n_iter_)}
            state["minibatch"] = mb
            state["blobs_int"] = Xi
            block = prepare_data(Xi, mesh=m).X
        elif cell == "serving":
            out, e = meshrest_serving(m, state)
            err += e
            block = state["serving_block"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: int(_kernels.launches[k]) for k in MESHREST_KERNELS}
    out["ledger_bytes"] = hier.ledger_snapshot()["bytes"]
    return block, launches, wall, out, err


def meshrest_serving(m, state):
    """``ServingLoop(mesh=)`` over the minibatch model (K2) and the
    sketched model (K2-x) with MESHREST_CLIENTS clients on the leader:
    every answer is the direct ``predict``'s bit for bit. Then the leader
    hot-swaps "mb" for a copy with its centers in reverse order: every
    answer after the swap is that version's direct ``predict``. Returns
    (its numbers, errors)."""
    import copy
    import threading

    import torch

    from dask_ml_tpu_torch.parallel.mesh import data_sharding
    from dask_ml_tpu_torch.parallel.serving import ModelRegistry, ServingLoop

    mb, sk = state["minibatch"], state["sketched"]
    pools = {"mb": state["blobs_int"][:MESHREST_POOL].cpu().numpy(),
             "sk": np.asarray(state["kdd"][:MESHREST_POOL])}
    direct = {"mb": mb.predict(pools["mb"]), "sk": sk.predict(pools["sk"])}
    mb2 = copy.deepcopy(mb)
    mb2.cluster_centers_ = np.ascontiguousarray(mb.cluster_centers_[::-1])
    direct["mb2"] = mb2.predict(pools["mb"])
    reg = ModelRegistry()
    reg.register("mb", mb)
    reg.register("sk", sk)
    err = []
    loop = ServingLoop(reg, mesh=m).start()
    warm = loop.warmup()
    rng = np.random.default_rng([SEED, 23])
    plan = [[(("mb", "sk")[(c + j) % 2],
              int(rng.integers(0, MESHREST_POOL - 2048)),
              int(SRV_SIZES[int(rng.integers(0, len(SRV_SIZES)))]))
             for j in range(MESHREST_REQUESTS)]
            for c in range(MESHREST_CLIENTS)]
    out = {"warmup": warm, "role": loop.role}
    if loop.role == "leader":
        bad, lat = [], []

        def client(reqs):
            for name, lo, size in reqs:
                t = time.perf_counter()
                got = loop.submit(name, pools[name][lo:lo + size]).result(
                    120)
                lat.append(time.perf_counter() - t)
                if not np.array_equal(got, direct[name][lo:lo + size]):
                    bad.append((name, lo, size))

        threads = [threading.Thread(target=client, args=(reqs,))
                   for reqs in plan]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        n = MESHREST_CLIENTS * MESHREST_REQUESTS
        if bad or len(lat) != n:
            err.append(f"meshrest-serving: {len(bad)} answers not the "
                       f"direct predict's, {n - len(lat)} unanswered")
        out.update(requests=n, requests_per_s=n / wall,
                   p50_ms=float(np.percentile(lat, 50)) * 1e3,
                   p99_ms=float(np.percentile(lat, 99)) * 1e3)
        reg.publish("mb", mb2)
        swapped = [(lo, size, loop.submit("mb", pools["mb"][lo:lo + size]))
                   for _, lo, size in plan[0]]
        stale = sum(not np.array_equal(f.result(120),
                                       direct["mb2"][lo:lo + size])
                    for lo, size, f in swapped)
        if stale:
            err.append(f"meshrest-serving: {stale} of {len(swapped)} "
                       "answers after the hot swap not the new version's")
        out["swap_requests"] = len(swapped)
    loop.stop(timeout=120)
    out["batches"] = int(loop.n_batches)
    if not loop.stopped:
        err.append("meshrest-serving: the loop did not stop")
    rows = data_sharding(m).rows(2048)
    state["serving_block"] = torch.as_tensor(
        pools["mb"][:2048][rows], device=state["blobs_int"].device)
    return out, err


def meshrest_rank(backend: str, world: int, rank: int, tmp: str, layouts):
    """One rank of a MESHREST world (a spawned process): join the world on
    card 0, run every cell of every layout, hold each cell's kernels to
    their plain versions on an integer copy of this rank's block, write
    this rank's report to ``tmp``."""
    import os
    import traceback

    report = {"rank": rank, "errors": [], "cells": {}}
    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        from dask_ml_tpu_torch._kernels import build
        from dask_ml_tpu_torch.parallel import runtime, shapes

        runtime.initialize(backend=backend,
                           init_method="file://" + os.path.join(
                               tmp, f"store-{backend}-{world}"),
                           num_processes=world, process_id=rank,
                           local_device_ids=[0])
        dev = runtime.device()
        for name in build.SIGNATURES:
            build.load(name)
        ref = dict(np.load(os.path.join(tmp, "ref.npz")))
        with open(os.path.join(tmp, "ref.json")) as f:
            info = json.load(f)
        meshes = mesh_layouts(world, layouts)
        st0 = shapes.compile_stats()
        state = {}
        for name, m in meshes.items():
            cells = (MESHREST_CELLS if name == "flat"
                     else MESHREST_HIER_CELLS)
            for cell in cells:
                block, launches, wall, out, err = meshrest_run(
                    cell, m, dev, tmp, ref, info, state)
                report["errors"] += err
                checked = meshrest_kernel_checks(
                    f"meshrest-{name}-{cell} rank {rank}", block, launches)
                report["cells"][f"{name}-{cell}"] = {
                    "wall_s": wall, "launches": launches,
                    "checked": checked, "block_shape": list(block.shape),
                    **out}
                del block
                torch.cuda.empty_cache()
        st1 = shapes.compile_stats()
        for key in ("n_compiles", "n_loads"):
            if st1[key] != st0[key]:
                report["errors"].append(
                    f"{key} {st0[key]} -> {st1[key]} after the warmup")
        runtime.shutdown()
    except BaseException:
        report["errors"].append(traceback.format_exc())
    with open(os.path.join(tmp, f"rank-{backend}-{world}-{rank}.json"),
              "w") as f:
        json.dump(report, f)


def meshrest_cells(dev):
    """The MESHREST phase (step 23). Returns ({world-layout-cell: [each
    rank's launches of K1–K5 and K2-x]}, summary)."""
    import os
    import shutil
    import tempfile

    import torch

    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dmlt_meshrest_")
    launches_by_cell, summary = {}, {"worlds": []}
    try:
        summary["single"] = meshrest_refs(dev, tmp)
        log("MESHREST single-device " + json.dumps(summary["single"]))
        torch.cuda.empty_cache()
        ctx = rank_context()
        for backend, world, layouts in MESHREST_WORLDS:
            t0 = time.perf_counter()
            procs = [ctx.Process(target=meshrest_rank,
                                 args=(backend, world, r, tmp, layouts))
                     for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + MESHREST_TIMEOUT
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
            expect(not hung, f"MESHREST {backend} world {world}: ranks "
                   f"{hung} still running after {MESHREST_TIMEOUT} s")
            reports = []
            for r, p in enumerate(procs):
                path = os.path.join(tmp, f"rank-{backend}-{world}-{r}.json")
                expect(p.exitcode == 0 and os.path.exists(path),
                       f"MESHREST {backend} world {world} rank {r} exited "
                       f"{p.exitcode} without a report")
                with open(path) as f:
                    reports.append(json.load(f))
            errors = [e for rep in reports for e in rep["errors"]]
            expect(not errors, f"MESHREST {backend} world {world}: "
                   + " | ".join(errors))
            sec = time.perf_counter() - t0
            for key in reports[0]["cells"]:
                layout, cell = key.split("-", 1)
                per = [rep["cells"][key] for rep in reports]
                for c in per:
                    missing = [k for k, v in c["launches"].items()
                               if v and k not in c["checked"]]
                    expect(not missing, f"MESHREST {key}: launched "
                           f"{missing} unchecked")
                launched = [c["launches"] for c in per]
                expect(any(sum(l.values()) for l in launched)
                       or cell == "datasets",
                       f"MESHREST {backend} world {world} {key}: no kernel "
                       "launched")
                launches_by_cell[f"{backend}-w{world}-{key}"] = launched
                line = {"backend": backend, "world": world,
                        "layout": layout, "cell": f"meshrest-{cell}",
                        "world_seconds": sec,
                        "wall_s": [c["wall_s"] for c in per],
                        "launches": launched,
                        "block_shape": per[0]["block_shape"],
                        **{k: v for k, v in per[0].items()
                           if k not in ("wall_s", "launches", "checked",
                                        "block_shape")}}
                log("MESHREST " + json.dumps(line))
                summary["worlds"].append(line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t_all
    log(f"MESHREST phase: {summary['seconds']:.1f} s")
    return launches_by_cell, summary


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

    if "--glm-pca-only" in sys.argv[1:]:
        glm_pca_cells(dev)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--stream-only" in sys.argv[1:]:
        stream_cells(dev)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--incremental-only" in sys.argv[1:]:
        incremental_cells(dev)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--search-only" in sys.argv[1:]:
        search_errs = {}
        search_cells(dev, search_errs)
        log("SEARCH max_abs_err " + json.dumps(search_errs))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--asha-only" in sys.argv[1:]:
        asha_errs = {}
        asha_cells(dev, asha_errs)
        log("ASHA max_abs_err " + json.dumps(asha_errs))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--precision-only" in sys.argv[1:]:
        rows, _ = precision_cells(dev)
        print(json.dumps({"kernels": rows}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--nystrom-only" in sys.argv[1:]:
        nys_errs = {}
        nystrom_cells(dev, nys_errs)
        log("NYSTROM max_abs_err " + json.dumps(nys_errs))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--preprocess-only" in sys.argv[1:]:
        pre_errs = {}
        preprocess_cells(dev, pre_errs)
        log("PREPROCESS max_abs_err " + json.dumps(pre_errs))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--serving-only" in sys.argv[1:]:
        srv_errs = {}
        srv_launches, _, srv_rows = serving_cells(dev, srv_errs)
        total = {k: sum(l[k] for l in srv_launches.values())
                 for k in srv_launches["serving-steady"]}
        rows = kernel_rows(srv_rows, total, srv_errs)
        for r in rows:
            r["launches_serving"] = {
                path: int(l[r["name"]]) for path, l in srv_launches.items()
                if l.get(r["name"])}
        log("SERVING max_abs_err " + json.dumps(srv_errs))
        print(json.dumps({"kernels": rows}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--wire-only" in sys.argv[1:]:
        wire_errs = {}
        wire_launches, proc_launches, _ = wire_cells(dev, wire_errs)
        models, pools = serving_models(dev)
        total = {k: sum(l[k] for l in wire_launches.values())
                 for k in wire_launches["wire-identity"]}
        rows = kernel_rows(serving_kernel_rows(dev, models, pools, None),
                           total, wire_errs)
        for r in rows:
            r["launches_wire"] = {
                path: int(l[r["name"]]) for path, l in wire_launches.items()
                if l.get(r["name"])}
            r["launches_proc"] = int(proc_launches.get(r["name"], 0))
        log("WIRE max_abs_err " + json.dumps(wire_errs))
        print(json.dumps({"kernels": rows}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--machines-only" in sys.argv[1:]:
        mach_errs = {}
        mach_launches, _ = machines_cells(dev, mach_errs)
        models, pools = serving_models(dev)
        rows = kernel_rows(serving_kernel_rows(dev, models, pools, None),
                           mach_launches, mach_errs)
        for r in rows:
            r["launches_machines"] = int(mach_launches[r["name"]])
        log("MACHINES max_abs_err " + json.dumps(mach_errs))
        print(json.dumps({"kernels": rows}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--mesh-only" in sys.argv[1:]:
        mesh_cells(dev)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--glm-mesh-only" in sys.argv[1:]:
        meshglm_cells(dev)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--elastic-only" in sys.argv[1:]:
        elastic_cells(dev)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--mesh-rest-only" in sys.argv[1:]:
        meshrest_cells(dev)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    if "--spmv-only" in sys.argv[1:]:
        errs = {}
        rows, summary = spmv_only(dev, errs)
        log_spmv_rows(rows)
        log("SPMV " + json.dumps(summary))
        log("K6 and K6-b at each path's shape:")
        path_rows = spmv_path_rows(dev, errs)
        for r in rows:
            if r["name"] in ("spmv", "spmv_pullback"):
                r["path_shapes"] = [
                    p for p in path_rows if p["name"].startswith(
                        "spmv_pullback") == (r["name"] == "spmv_pullback")]
        print(json.dumps({"kernels": rows}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    # the MESH and ELASTIC phases' ranks fork from this server; it imports
    # torch and the port while the phases before them run
    rank_context(start=True)
    #: wall seconds of each phase of the full run, logged as each ends
    laps = {}
    lap_t0 = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = round(now - lap_t0[0], 1)
        lap_t0[0] = now
        log("PHASE_SECONDS " + json.dumps(laps))

    t0 = time.perf_counter()
    errs = edge_cases(dev)
    errs["spmv"] = spmv_edge_cases(dev)
    torch.cuda.synchronize()
    log(f"edge cases: all kernels match their plain versions "
        f"({time.perf_counter() - t0:.2f} s)")

    X, y_true = drawn("blobs", lambda: blobs_data(SEED))

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
    # integer-valued rows of the same shape: bit for bit at the rounds'
    # and the weights' masks
    Xi = torch.randint(-8, 8, (N, D), generator=g, device=dev).float()
    for name, m, valid, X_, exact in (
            ("K2/K3/K4 m=8", K, K, Xd, False),
            ("K3 m=80", ROUND_CAP, ROUND_CAP // 2, Xd, False),
            ("K3 m=80, the rounds' mask", ROUND_CAP, ROUND_COUNT, Xd, False),
            ("K4 m=329", WEIGHT_CAND, WEIGHT_CAND // 2, Xd, False),
            ("K3 m=80, the rounds' mask, integers", ROUND_CAP, ROUND_COUNT,
             Xi, True),
            ("K4 m=329, 321 valid, integers", WEIGHT_CAND, 321, Xi, True)):
        Y = X_[pick[:m]]
        mask = torch.arange(m, device=dev) < valid  # unfilled later slots
        e = check_fused(name, X_, Y, mask, wd, exact=exact)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    del Xi
    e = check_lloyd("K1 full shape", Xd, wd, c0, exact=False)
    errs["lloyd_iter"] = max(errs.get("lloyd_iter", 0.0), e)
    torch.cuda.synchronize()
    log("full-shape comparisons: all kernels within tolerance")

    phases = init_phase_seconds(Xd, wd)
    log("INIT_PHASES blobs " + json.dumps(phases))
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
        log_score_extras(r, "blobs")
    log_two_pass(rows, "blobs")
    fit = {"n": N, "d": D, "k": K, "fit_predict_s": fit_predict_s,
           "n_iter": km.n_iter_, "init_s": km.fit_phase_seconds_["init"],
           "lloyd_s": km.fit_phase_seconds_["lloyd"],
           "warm_fit_predict_s": warm_s,
           "warm_init_s": warm.fit_phase_seconds_["init"],
           "warm_lloyd_s": warm.fit_phase_seconds_["lloyd"],
           "lloyd_loop_ms_per_iter": loop_ms, "ari": score,
           "inertia": km.inertia_, "launches": launches}
    log("FIT " + json.dumps(fit))
    blobs_inertia = km.inertia_
    del data, Xd, wd, X
    torch.cuda.empty_cache()
    lap("edge_blobs")

    kdd_rows, kdd_launches, kdd = kdd_cell(dev, errs)
    # K3 and K4 at the KDD cell's shape ride on their blobs rows
    for r in rows:
        for sr in kdd["score_kernels"]:
            if sr["name"] == r["name"]:
                r["kdd_shape"] = {k: v for k, v in sr.items() if k != "name"}
        log_score_extras(r.get("kdd_shape"), "KDD")
    kdd_rows = kernel_rows(kdd_rows, kdd_launches, errs)
    rows += kdd_rows
    for r in kdd_rows:
        log(f"  {r['name']:26s} {r['ms']:.4f} ms  bound {r['bound_ms']:.4f}"
            f" ms ({r['bound_by']})  plain {r['plain_ms']:.4f} ms  "
            f"launches {r['launches']}")
    log_two_pass(kdd_rows, "KDD")
    by_name = {r["name"]: r for r in kdd_rows}
    for name, opt in (("fused_argmin_min2",
                       by_name["fused_argmin_min2"]["late_need"]),
                      ("fused_argmin_min_sketched",
                       by_name["fused_argmin_min_sketched"]["row_need"])):
        log(f"  {name} with a late iteration's need "
            f"({opt['evaluated_fraction']:.4f} of groups evaluated): "
            f"{opt['ms']:.4f} ms  bound {opt['bound_ms']:.4f} ms  plain "
            f"{opt['plain_ms']:.4f} ms")
    log("KDD " + json.dumps(kdd))
    torch.cuda.empty_cache()
    lap("kdd")

    glm_rows, glm_launches, glm = glm_cell(dev, errs)
    rows += kernel_rows(glm_rows, glm_launches, errs)
    log_spmv_rows(rows[-4:])
    log("GLM " + json.dumps(glm))
    torch.cuda.empty_cache()
    lap("glm")

    log("K6 and K6-b at each path's shape:")
    path_rows = spmv_path_rows(dev, errs)
    for r in rows:
        if r["name"] in ("spmv", "spmv_pullback"):
            r["path_shapes"] = [
                p for p in path_rows if p["name"].startswith("spmv_pullback")
                == (r["name"] == "spmv_pullback")]
    torch.cuda.empty_cache()
    lap("spmv_paths")

    admm_launches, _ = glm_pca_cells(dev)
    for r in rows:
        if r["name"] in GLM_CELL_K6:
            r["launches_sparse_admm"] = int(admm_launches[r["name"]])
    torch.cuda.empty_cache()
    lap("glm_pca")

    stream_launches, _ = stream_cells(dev)
    for r in rows:
        r["launches_stream"] = {
            path: int(l[r["name"]]) for path, l in stream_launches.items()
            if l.get(r["name"])}
    torch.cuda.empty_cache()
    lap("stream")

    inc_launches, _ = incremental_cells(dev)
    for r in rows:
        if r["name"] in ("spmv", "spmv_pullback", "fused_argmin_min"):
            r["launches_incremental"] = {
                path: int(l[r["name"]]) for path, l in inc_launches.items()
                if l.get(r["name"])}
    torch.cuda.empty_cache()
    lap("incremental")

    search_errs = {}
    search_launches, _ = search_cells(dev, search_errs)
    for r in rows:
        if r["name"] in ("lloyd_iter", "fused_argmin_min",
                         "fused_rowwise_min", "spmv", "spmv_pullback"):
            r["launches_search"] = {
                path: int(l[r["name"]]) for path, l in search_launches.items()}
        if r["name"] in search_errs:
            r["max_abs_err_search"] = search_errs[r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], search_errs[r["name"]])
    torch.cuda.empty_cache()
    lap("search")

    asha_errs = {}
    asha_launches, _ = asha_cells(dev, asha_errs)
    for r in rows:
        if r["name"] in ("lloyd_iter", "fused_argmin_min",
                         "fused_rowwise_min", "fused_argmin_weight"):
            r["launches_asha"] = {
                path: int(l[r["name"]]) for path, l in asha_launches.items()}
        if r["name"] in asha_errs:
            r["max_abs_err_asha"] = asha_errs[r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], asha_errs[r["name"]])
    torch.cuda.empty_cache()
    lap("asha")

    nys_errs = {}
    nys_launches, _ = nystrom_cells(dev, nys_errs)
    pre_errs = {}
    pre_launches, _ = preprocess_cells(dev, pre_errs)
    for r in rows:
        for key, launched in (("launches_nystrom", nys_launches),
                              ("launches_preprocess", pre_launches)):
            got = {path: int(l[r["name"]]) for path, l in launched.items()
                   if l.get(r["name"])}
            if got:
                r[key] = got
        for key, found in (("max_abs_err_nystrom", nys_errs),
                           ("max_abs_err_preprocess", pre_errs)):
            if r["name"] in found:
                r[key] = found[r["name"]]
                r["max_abs_err"] = max(r["max_abs_err"], found[r["name"]])
    torch.cuda.empty_cache()
    lap("nystrom_preprocess")

    srv_errs = {}
    srv_launches, _, srv_rows = serving_cells(dev, srv_errs)
    srv_by_name = {r["name"]: r for r in srv_rows}
    for r in rows:
        got = {path: int(l[r["name"]]) for path, l in srv_launches.items()
               if l.get(r["name"])}
        if got:
            r["launches_serving"] = got
        if r["name"] in srv_errs:
            r["max_abs_err_serving"] = srv_errs[r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], srv_errs[r["name"]])
        timed = srv_by_name.pop(r["name"], None)
        if timed is not None:
            r["serving_shape"] = {k: v for k, v in timed.items()
                                  if k != "name"}
    torch.cuda.empty_cache()
    lap("serving")

    wire_errs = {}
    wire_launches, proc_launches, _ = wire_cells(dev, wire_errs)
    for r in rows:
        got = {path: int(l[r["name"]]) for path, l in wire_launches.items()
               if l.get(r["name"])}
        if got:
            r["launches_wire"] = got
        if r["name"] in proc_launches:
            r["launches_proc"] = int(proc_launches[r["name"]])
        if r["name"] in wire_errs:
            r["max_abs_err_wire"] = wire_errs[r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], wire_errs[r["name"]])
    torch.cuda.empty_cache()
    lap("wire")

    mach_errs = {}
    mach_launches, _ = machines_cells(dev, mach_errs)
    for r in rows:
        if r["name"] in mach_launches:
            r["launches_machines"] = int(mach_launches[r["name"]])
        if r["name"] in mach_errs:
            r["max_abs_err_machines"] = mach_errs[r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], mach_errs[r["name"]])
    torch.cuda.empty_cache()
    lap("machines")

    mesh_launches, _ = mesh_cells(dev)
    for r in rows:
        got = {fit: [per[r["name"]] for per in ranks]
               for fit, ranks in mesh_launches.items()
               if r["name"] in ranks[0]}
        if got:
            r["launches_mesh"] = got
    torch.cuda.empty_cache()
    lap("mesh")

    meshglm_launches, _ = meshglm_cells(dev)
    for r in rows:
        got = {cell: [per[r["name"]] for per in ranks]
               for cell, ranks in meshglm_launches.items()
               if r["name"] in ranks[0]}
        if got:
            r["launches_meshglm"] = got
    torch.cuda.empty_cache()
    lap("meshglm")

    elastic_launches, _ = elastic_cells(dev)
    for r in rows:
        got = {cell: [per[r["name"]] for per in ranks]
               for cell, ranks in elastic_launches.items()
               if r["name"] in ranks[0]}
        if got:
            r["launches_elastic"] = got
    torch.cuda.empty_cache()
    lap("elastic")

    meshrest_launches, _ = meshrest_cells(dev)
    for r in rows:
        got = {cell: [per[r["name"]] for per in ranks]
               for cell, ranks in meshrest_launches.items()
               if r["name"] in ranks[0]}
        if got:
            r["launches_meshrest"] = got
    torch.cuda.empty_cache()
    lap("meshrest")

    bf16, _ = precision_cells(dev, f32_inertia=blobs_inertia)
    rows += bf16
    lap("precision")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
