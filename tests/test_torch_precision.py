"""The PyTorch port's mixed-precision tier held against the JAX package's
``tests/test_precision.py``, test by test, on the CPU.

Each test here is the counterpart of the JAX test of the same name where
the module is ported: the policy, the state floor, ``pdot``, the
compensated sums, the wire cast, the streamed ADMM and moment gates, the
checkpoint resume, the solver gates, the KMeans and PCA gates, the
near-duplicate centers and the staging. The accuracy gates are the JAX
package's own tolerances against the f32 run (coefficients rtol 5e-2,
proximal gradient 1.5e-1, explained variance 2e-2, inertia 1e-2,
iteration counts within 5), and where the JAX result is cheap to compute
the port's bf16 result is also held to the JAX package's bf16 result
within the same tolerance. A JAX test that needs an 8-device mesh is held
by the port's single-device path (``admm(n_shards=S)`` runs S row blocks).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.parallel import precision as jpx
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.ops.sparse import SparseRows
from dask_ml_tpu_torch.parallel import precision as px
from dask_ml_tpu_torch.parallel.stream import HostBlockSource

COEF_RTOL = 5e-2
PROX_COEF_RTOL = 1.5e-1
VAR_RTOL = 2e-2
INERTIA_RTOL = 1e-2
ITER_SLACK = 5


@pytest.fixture(autouse=True)
def on_cpu():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with config_context(device="cpu"):
        yield
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(prec)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


# ---------------------------------------------------------------------------
# policy object + resolution
# ---------------------------------------------------------------------------


def test_policy_resolution_knob():
    # "auto" is F32 on the card and on the CPU (the port has no TPU); the
    # JAX package's "auto" on its CPU test backend agrees
    assert px.resolve() is px.F32
    assert jpx.resolve() is jpx.F32
    with config_context(precision=None):
        assert px.resolve() is px.F32
    with config_context(precision="bf16"):
        assert px.resolve() is px.BF16
    with config_context(precision="bfloat16"):
        assert px.resolve() is px.BF16
    with config_context(precision="f32"):
        assert px.resolve() is px.F32
    custom = px.PrecisionPolicy(storage=torch.bfloat16)
    with config_context(precision=custom):
        assert px.resolve() is custom
    with config_context(precision="bogus"):
        with pytest.raises(ValueError, match="precision"):
            px.resolve()


def test_policy_overrides_and_hashability():
    p = px.PrecisionPolicy(compute=torch.bfloat16,
                           overrides={"sketch": torch.float32})
    assert p.compute_for("sketch") == torch.float32
    assert p.compute_for("anything-else") == torch.bfloat16
    assert p.compute_for() == torch.bfloat16
    hash(p)
    assert p == px.PrecisionPolicy(compute="bfloat16",
                                   overrides={"sketch": "float32"})
    assert p.signature() == px.PrecisionPolicy(
        compute=torch.bfloat16,
        overrides=[("sketch", torch.float32)]).signature()
    assert px.BF16.storage_dtype() == torch.bfloat16
    assert px.F32.storage_dtype() is None
    assert px.F32.storage_dtype(torch.float32) == torch.float32
    assert px.BF16.signature() != px.F32.signature()


@pytest.mark.parametrize("data,accum", [
    ("bfloat16", None), ("float16", None), ("float32", None),
    ("float64", None), ("float32", "float64"), ("bfloat16", "bfloat16")])
def test_state_dtype_floor(data, accum):
    """The one state rule, dtype for dtype the JAX package's: never below
    f32; an accum can raise the floor and never lower it."""
    kw = {} if accum is None else {"accum": accum}
    jkw = {} if accum is None else {"accum": jnp.dtype(accum)}
    got = px.state_dtype(data, **kw)
    want = jpx.state_dtype(jnp.dtype(data), **jkw)
    assert str(got).replace("torch.", "") == jnp.dtype(want).name
    assert px.PrecisionPolicy().state_dtype(torch.bfloat16) == torch.float32
    assert px.lloyd_bounds_dtype(torch.bfloat16, px.BF16) == torch.float32
    assert px.lloyd_bounds_dtype(torch.bfloat16, px.PrecisionPolicy(
        overrides={"lloyd_bounds": torch.bfloat16})) == torch.float32
    assert px.lloyd_bounds_dtype(torch.float32, px.PrecisionPolicy(
        overrides={"lloyd_bounds": torch.float64})) == torch.float64
    assert px.fast_transform_dtype(torch.bfloat16, px.BF16) == torch.float32


def test_pdot_bf16_operands_f32_accumulation():
    """bf16 operands, f32 result, f32 accumulation: [1024, 1, −1024] sums
    to exactly 1, where bf16 accumulation (spacing 8 at 1024) loses it;
    and on integer data the JAX ``pmatmul`` / ``pdot``, bit for bit."""
    X = torch.tensor([[1024.0, 1.0, -1024.0]]).to(torch.bfloat16)
    v = torch.ones(3)
    out = px.pmatmul(X, v)
    assert out.dtype == torch.float32 and out.tolist() == [1.0]
    assert torch.matmul(X, v.to(torch.bfloat16)).dtype == torch.bfloat16
    g = px.pdot(X, torch.ones(1), (([0], [0]), ([], [])))
    assert g.dtype == torch.float32 and tuple(g.shape) == (3,)
    # lax.dot_general's dimension numbers, batch axes included
    rng = np.random.RandomState(1)
    a = rng.randint(-8, 8, (4, 2, 3)).astype(np.float32)
    b = rng.randint(-8, 8, (2, 5, 4)).astype(np.float32)
    dn = (((0,), (2,)), ((1,), (0,)))
    np.testing.assert_array_equal(
        px.pdot(torch.from_numpy(a), torch.from_numpy(b), dn).numpy(),
        np.asarray(jpx.pdot(jnp.asarray(a), jnp.asarray(b), dn)))
    rng = np.random.RandomState(0)
    A = rng.randint(-8, 8, (33, 7)).astype(np.float32)
    b = (rng.randint(-512, 512, 7) / 256.0).astype(np.float32)
    got = px.pmatmul(torch.from_numpy(A).to(torch.bfloat16),
                     torch.from_numpy(b))
    want = jpx.pmatmul(jnp.asarray(A, jnp.bfloat16), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # f32 data: the plain product, bit for bit
    Af = torch.from_numpy(rng.randn(40, 6).astype(np.float32))
    bf = torch.from_numpy(rng.randn(6).astype(np.float32))
    assert torch.equal(px.pmatmul(Af, bf), Af @ bf)


def test_bf16_pullback_keeps_the_cotangent_f32():
    """The cotangent rule, one for the dense and the sparse pullback and
    for autograd through ``pmatmul``: on bf16 data the cotangent ``r``
    stays f32. On a logistic cotangent σ(η) − y at a small η (what a
    fit's first steps see), each port pullback is within 1e-6 normwise of
    the float64 ``Xᵀ r`` (measured ≈ 4e-7), and autograd's gradient is
    the dense pullback's bits. The JAX package's dense bf16 pullback is
    ``Xᵀ bf16(r)`` bit for bit (its ``pdot`` rounds ``r``), equal bit for
    bit to the port's pullback of the rounded ``r`` (integer X: every
    product and sum exact), and it departs from ``Xᵀ r`` by more than
    1e-3 normwise (measured ≈ 3.0e-3): the η part of ``r`` is below
    bf16's resolution at ±½."""
    from dask_ml_tpu.models import glm as jglm
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.ops import sparse as sps

    rng = np.random.RandomState(0)
    n, d = 256, 8
    X = rng.randint(-8, 8, (n, d)).astype(np.float32)
    beta = (1e-3 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    r = (1 / (1 + np.exp(-(X @ beta))) - y).astype(np.float32)
    exact = X.astype(np.float64).T @ r.astype(np.float64)
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    rt = torch.from_numpy(r)
    dense = glm_core._data_pullback(Xb, rt)
    A = SparseRows(Xb, torch.arange(d, dtype=torch.int32).repeat(n, 1), d)
    sparse = sps.pullback(A, rt, kernel="torch")
    b = torch.from_numpy(beta).requires_grad_(True)
    (auto,) = torch.autograd.grad((px.pmatmul(Xb, b) * rt).sum(), b)
    for got in (dense, sparse, auto):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), exact) <= 1e-6
    assert torch.equal(auto, dense)
    jd = np.asarray(jglm._data_pullback(jnp.asarray(X, jnp.bfloat16),
                                        jnp.asarray(r)))
    rr = rt.to(torch.bfloat16)
    np.testing.assert_array_equal(
        jd, (X.astype(np.float64).T @ rr.double().numpy()).astype(
            np.float32))
    np.testing.assert_array_equal(
        jd, glm_core._data_pullback(Xb, rr.float()).numpy())
    assert _rel(jd, exact) > 1e-3


def test_neumaier_sum_beats_sequential_f32():
    v = torch.tensor([1e8] + [0.25] * 4096, dtype=torch.float32)
    seq = torch.zeros((), dtype=torch.float32)
    for x in v:
        seq = seq + x
    comp = float(px.neumaier_sum(v))
    assert float(seq) == 1e8
    assert abs(comp - (1e8 + 0.25 * 4096)) <= 16.0
    assert comp == float(jpx.neumaier_sum(jnp.asarray(v.numpy())))
    M = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert torch.equal(px.neumaier_sum(M, axis=0), M.sum(0))
    assert torch.equal(px.neumaier_sum(M, axis=1), M.sum(1))


# ---------------------------------------------------------------------------
# the streamed tier's wire cast
# ---------------------------------------------------------------------------


def _stream_data(n=512, d=64, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w_true = np.random.RandomState(3).randn(d).astype(np.float32)
    y = (X @ w_true + rng.standard_normal(n).astype(np.float32)
         > 0).astype(np.float32)
    w = np.ones(n, np.float32)
    return X, y, w


def test_wire_cast_halves_stream_bytes():
    X, y, w = _stream_data()
    with config_context(precision="bf16"):
        src = HostBlockSource((X, y, w), n_blocks=4)
    assert src.storage_dtype == torch.bfloat16
    blk = src.take(0)
    assert blk[0].dtype == torch.bfloat16
    assert blk[1].dtype == torch.float32 and blk[2].dtype == torch.float32
    assert src.out_struct[0].dtype == torch.bfloat16
    per_block_wire = X.nbytes // 4 // 2 + y.nbytes // 4 + w.nbytes // 4
    per_block_logical = (X.nbytes + y.nbytes + w.nbytes) // 4
    assert src.bytes_streamed == per_block_wire
    assert src.logical_bytes_streamed == per_block_logical
    assert src.host_block(1)[0].dtype == np.float32
    src.start(1)
    src.discard_inflight()
    assert src.bytes_streamed == per_block_wire
    assert src.logical_bytes_streamed == per_block_logical
    src.reset_stats()
    assert src.bytes_streamed == 0 and src.logical_bytes_streamed == 0
    src32 = HostBlockSource((X, y, w), n_blocks=4, storage_dtype=None)
    src32.take(0)
    assert src32.bytes_streamed == src32.logical_bytes_streamed


def test_wire_cast_never_upcasts():
    X = np.random.RandomState(0).standard_normal((8, 4)).astype(np.float16)
    out = px.cast_wire((X,), torch.bfloat16)
    assert out[0].dtype == np.float16  # narrower than the wire: kept
    # a sparse element narrows its values and never its columns; 1-D
    # leaves stay exact; None is a no-op
    vals = np.ones((5, 3), np.float32)
    cols = np.zeros((5, 3), np.int32)
    w = np.ones(5, np.float32)
    A, w2 = px.cast_wire((SparseRows(vals, cols, 4), w), torch.bfloat16)
    assert A.values.dtype == torch.bfloat16 and A.cols is cols
    assert w2 is w
    blk = (vals, w)
    assert px.cast_wire(blk, None) == blk


def test_wire_cast_matches_jnp_bfloat16_bitwise():
    """torch's host cast (a CPU tensor's ``.to(torch.bfloat16)``) against
    the JAX package's (``ndarray.astype(jnp.bfloat16)``), bit for bit on a
    seeded array with ties, ±0, denormals, ±inf and NaN."""
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    ties = (rng.randint(0, 2**16, 512).astype(np.uint32) << 16) | 0x8000
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                        1.17549435e-38, 3.4028235e38, -3.4028235e38,
                        1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8],
                       np.float32).view(np.uint32)
    x = np.concatenate([bits, ties, special]).view(np.float32).reshape(-1, 4)
    (got,) = px.cast_wire((x,), torch.bfloat16)
    want = x.astype(jnp.bfloat16)
    g = got.view(torch.int16).numpy().view(np.uint16)
    wv = want.view(np.uint16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(g[~nan], wv[~nan])
    assert np.isnan(got.float().numpy()[nan]).all()
    assert nan.sum() > 0 and (g[~nan] & 0x7F80 == 0).any()  # denormals


# ---------------------------------------------------------------------------
# streamed ADMM: wire reduction + accuracy gate + state floor
# ---------------------------------------------------------------------------

ADMM_KW = dict(family="logistic", regularizer="l2", lamduh=1.0,
               max_iter=4, abstol=0.0, reltol=0.0)


def test_streamed_admm_bf16_gate():
    from dask_ml_tpu.models import glm as jglm
    from dask_ml_tpu.parallel.stream import HostBlockSource as JSource
    from dask_ml_tpu_torch.models import glm as glm_core

    X, y, w = _stream_data()
    n, d = X.shape
    src32 = HostBlockSource((X, y, w), n_blocks=4, storage_dtype=None)
    z32, it32 = glm_core.admm_streamed(src32, 4, d, float(n), **ADMM_KW)
    with config_context(precision="bf16"):
        src16 = HostBlockSource((X, y, w), n_blocks=4)
    z16, it16, (zs, xs, us), _ = glm_core.admm_streamed(
        src16, 4, d, float(n), return_state=True, **ADMM_KW)
    assert src16.bytes_streamed < src32.bytes_streamed
    assert src16.logical_bytes_streamed / src16.bytes_streamed >= 1.8
    for a in (z16, zs, xs, us):
        assert a.dtype == torch.float32
    assert _rel(z16, z32) <= COEF_RTOL
    assert abs(int(it16) - int(it32)) <= ITER_SLACK
    with jconfig.config_context(precision="bf16"):
        jsrc = JSource((X, y, w), n_blocks=4)
    jz, _ = jglm.admm_streamed(jsrc, 4, d, float(n), **ADMM_KW)
    assert _rel(z16, jz) <= COEF_RTOL


def test_streamed_admm_dtype_param_state_floor():
    """``dtype=bfloat16`` (the block dtype) never puts the consensus carry
    in bf16: the blocks come from a callable as bf16 tensors."""
    from dask_ml_tpu_torch.models import glm as glm_core

    X, y, w = _stream_data(n=256, d=8)
    Xb = torch.from_numpy(X).to(torch.bfloat16)

    def block(b):
        s = slice(64 * b, 64 * (b + 1))
        return Xb[s], torch.from_numpy(y[s]), torch.from_numpy(w[s])

    z, _, (zs, xs, us), _ = glm_core.admm_streamed(
        block, 4, 8, 256.0, dtype=torch.bfloat16, return_state=True,
        **ADMM_KW)
    for a in (z, zs, xs, us):
        assert a.dtype == torch.float32


def test_scan_checkpoint_bf16_resume_bit_identical(tmp_path):
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel.faults import FaultInjector, Preempted

    X, y, w = _stream_data()
    n, d = X.shape
    ckpt = str(tmp_path / "bf16.ckpt")
    with config_context(precision="bf16"):
        _, _, clean, _ = glm_core.admm_streamed(
            HostBlockSource((X, y, w), n_blocks=4), 4, d, float(n),
            return_state=True, **ADMM_KW)
        inj = FaultInjector().preempt_at(block=2, epoch=2)
        with pytest.raises(Preempted):
            glm_core.admm_streamed(
                HostBlockSource((X, y, w), n_blocks=4, fault_injector=inj),
                4, d, float(n), checkpoint_path=ckpt, **ADMM_KW)
        _, _, resumed, _ = glm_core.admm_streamed(
            HostBlockSource((X, y, w), n_blocks=4), 4, d, float(n),
            checkpoint_path=ckpt, return_state=True, **ADMM_KW)
    for a, b in zip(clean, resumed):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


def test_checkpoint_keeps_bf16_leaves_bit_for_bit(tmp_path):
    """A bf16 leaf (numpy has none) is saved as its uint16 bits with a tag
    and restored with the same bits."""
    from dask_ml_tpu_torch import checkpoint

    t = torch.from_numpy(np.random.RandomState(1).randn(7, 3).astype(
        np.float32)).to(torch.bfloat16)
    path = str(tmp_path / "t.ckpt")
    checkpoint.save_pytree(path, {"a": t, "b": torch.ones(2)})
    tree, _ = checkpoint.load_pytree(path)
    back = checkpoint.leaf_tensor(tree["a"], "cpu")
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    assert checkpoint.leaf_tensor(tree["b"], "cpu").dtype == torch.float32


# ---------------------------------------------------------------------------
# per-solver accuracy gates (bf16 data against the f32 baseline)
# ---------------------------------------------------------------------------


def _glm_problem(n=512, d=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w_true = np.random.RandomState(1).randn(d).astype(np.float32)
    y = (X @ w_true + 0.5 * rng.standard_normal(n).astype(np.float32)
         > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("solver", ["lbfgs", "newton", "gradient_descent",
                                    "proximal_grad"])
def test_glm_solver_bf16_accuracy_gate(solver):
    from dask_ml_tpu.models import glm as jglm
    from dask_ml_tpu_torch.models import glm as glm_core

    X, y = _glm_problem()
    d = X.shape[1]
    w = torch.ones(X.shape[0])
    beta0, mask = torch.zeros(d), torch.ones(d)
    kw = dict(family="logistic", regularizer="l2", lamduh=1.0, max_iter=100)
    if solver == "proximal_grad":
        kw.update(tol=0.0, max_iter=50)
    fn = getattr(glm_core, solver)
    b32, it32 = fn(torch.from_numpy(X), torch.from_numpy(y), w, beta0, mask,
                   **kw)
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    b16, it16 = fn(Xb, torch.from_numpy(y), w, beta0, mask, **kw)
    assert b16.dtype == torch.float32
    tol = PROX_COEF_RTOL if solver == "proximal_grad" else COEF_RTOL
    assert _rel(b16, b32) <= tol, (solver, _rel(b16, b32))
    assert abs(int(it16) - int(it32)) <= ITER_SLACK
    jb16, _ = getattr(jglm, solver)(
        jnp.asarray(X, jnp.bfloat16), jnp.asarray(y),
        jnp.ones(X.shape[0], jnp.float32), jnp.zeros(d, jnp.float32),
        jnp.ones(d, jnp.float32), **kw)
    assert _rel(b16, jb16) <= tol


@pytest.mark.parametrize("S", [1, 2, 8])
def test_glm_admm_bf16_accuracy_gate(S):
    """The JAX test runs on an 8-device mesh; the port's ``admm`` runs S
    row blocks on one device (the same trajectory as an S-device mesh)."""
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    X, y = _glm_problem()
    d = X.shape[1]
    kw = dict(family="logistic", regularizer="l2", lamduh=1.0, max_iter=20,
              abstol=0.0, reltol=0.0, n_shards=S)
    outs = {}
    for name, prec in (("f32", "f32"), ("bf16", "bf16")):
        with config_context(precision=prec):
            data = prepare_data(X, y=y)
        assert data.X.dtype == (torch.bfloat16 if name == "bf16"
                                else torch.float32)
        z, it = glm_core.admm(data.X, data.y, data.weights, torch.zeros(d),
                              torch.ones(d), **kw)
        assert z.dtype == torch.float32
        outs[name] = (z, int(it))
    assert _rel(outs["bf16"][0], outs["f32"][0]) <= COEF_RTOL
    assert abs(outs["bf16"][1] - outs["f32"][1]) <= ITER_SLACK
    # the JAX package's bf16 fit on an S-device mesh (the same row split)
    from dask_ml_tpu.models import glm as jglm
    from dask_ml_tpu.parallel import mesh as mesh_lib
    from dask_ml_tpu.parallel.sharding import prepare_data as jprepare

    mesh = mesh_lib.make_mesh(n_devices=S)
    jdata = jprepare(X, y=y, mesh=mesh, dtype=jnp.bfloat16,
                     y_dtype=jnp.float32)
    jkw = {k: v for k, v in kw.items() if k != "n_shards"}
    jz, jit = jglm.admm(jdata.X, jdata.y, jdata.weights,
                        jnp.zeros(d, jnp.float32), jnp.ones(d, jnp.float32),
                        mesh, **jkw)
    assert _rel(outs["bf16"][0], jz) <= COEF_RTOL
    assert abs(outs["bf16"][1] - int(jit)) <= ITER_SLACK


def _match_rows(A, B):
    """``B``'s rows in the order of their nearest rows of ``A`` (each of
    A's rows takes a different one)."""
    idx = np.argmin(((A[:, None, :] - B[None, :, :]) ** 2).sum(2), axis=1)
    assert sorted(idx.tolist()) == list(range(len(B)))
    return B[idx]


def test_kmeans_bf16_accuracy_gate():
    """Well-separated blobs under the bf16 policy. Labels agree, the
    iteration counts within the slack, and the bf16 fit's centers are as
    good as the f32 fit's: their f32 inertia within 1e-2. ``inertia_`` of
    the bf16 fit itself carries the kernels' score convention (|c|² from
    the f32 centers, the product from the bf16-rounded ones), so it
    differs from the f32 inertia by the rounding term Σ w (|c|² − |ĉ|²)
    over each row's center; that term is checked to rtol 1e-3 of the
    inertia."""
    from dask_ml_tpu_torch.cluster import KMeans

    rng = np.random.RandomState(0)
    centers = np.array([[8.0, 0, 0], [-8, 8, 0], [0, -8, 8]], np.float32)
    X = np.concatenate([
        c + rng.standard_normal((120, 3)).astype(np.float32)
        for c in centers])
    kw = dict(n_clusters=3, init="k-means||", random_state=0, max_iter=50)
    a = KMeans(**kw).fit(X)
    with config_context(precision="bf16"):
        b = KMeans(**kw).fit(X)
    assert b.cluster_centers_.dtype == np.float32
    assert float(np.mean(a.labels_ == b.labels_)) >= 0.98
    assert abs(int(a.n_iter_) - int(b.n_iter_)) <= ITER_SLACK
    quality = -b.score(X)  # the bf16 fit's centers, scored in f32
    assert abs(quality - a.inertia_) / a.inertia_ <= INERTIA_RTOL
    C = b.cluster_centers_
    Cr = torch.from_numpy(C).to(torch.bfloat16).float().numpy()
    term = ((C * C).sum(1) - (Cr * Cr).sum(1))[b.labels_].sum()
    Xr = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
    exact = ((Xr - Cr[b.labels_]) ** 2).sum()
    assert abs(b.inertia_ - (exact + term)) <= 1e-3 * a.inertia_
    # the JAX package's bf16 fit on the same data (its XLA route, which
    # rounds the M-step's sums to bf16; the port sums in f32): inertia_
    # within 1e-2 and the centers, matched, within 1e-2 normwise
    from dask_ml_tpu.cluster import KMeans as JKMeans

    with jconfig.config_context(precision="bf16"):
        j = JKMeans(**kw).fit(X)
    assert abs(b.inertia_ - float(j.inertia_)) / float(j.inertia_) \
        <= INERTIA_RTOL
    Cj = _match_rows(C, np.asarray(j.cluster_centers_))
    assert _rel(C, Cj) <= INERTIA_RTOL


def _low_rank(n, d, r, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((n, r)).astype(np.float32)
    B = rng.standard_normal((r, d)).astype(np.float32)
    return A @ B + 0.05 * rng.standard_normal((n, d)).astype(np.float32)


def test_pca_bf16_sketch_accuracy_gate():
    """The JAX test runs on an 8-device mesh; here one device. A bf16
    sketch with the f32 CholeskyQR2 repair: singular values within the
    gate of the f32 sketch; the outputs f32."""
    from dask_ml_tpu_torch.ops import linalg

    X = torch.from_numpy(_low_rank(1024, 32, 8))
    w = torch.ones(1024)
    _, S32, _ = linalg.svd_compressed(X, 6, n_power_iter=2, weights=w,
                                      compute_dtype=None)
    _, S16, _ = linalg.svd_compressed(X, 6, n_power_iter=2, weights=w,
                                      compute_dtype=torch.bfloat16)
    assert S16.dtype == torch.float32
    np.testing.assert_allclose(S16.numpy(), S32.numpy(), rtol=VAR_RTOL)
    with config_context(precision="bf16"):
        _, Sp, _ = linalg.svd_compressed(X, 6, n_power_iter=2, weights=w)
    assert torch.equal(Sp, S16)  # "policy" takes the sketch dtype
    _, Sb, _ = linalg.svd_compressed(X.to(torch.bfloat16), 6,
                                     n_power_iter=2, weights=w)
    np.testing.assert_allclose(Sb.numpy(), S32.numpy(), rtol=VAR_RTOL)
    # the JAX package's bf16 sketch from its default key, and the port's
    # from the same Ω (JAX's draw, bf16): singular values within the gate
    import jax

    from dask_ml_tpu.ops import linalg as jlinalg

    omega = jax.random.normal(jax.random.key(0), (32, 16), jnp.bfloat16)
    _, Sj, _ = jlinalg.svd_compressed(jnp.asarray(X.numpy()), 6,
                                      n_power_iter=2,
                                      weights=jnp.asarray(w.numpy()),
                                      compute_dtype=jnp.bfloat16)
    _, So, _ = linalg.svd_compressed(
        X, 6, n_power_iter=2, weights=w, compute_dtype=torch.bfloat16,
        omega=np.asarray(omega, np.float32))
    np.testing.assert_allclose(So.numpy(), np.asarray(Sj), rtol=VAR_RTOL)


def test_pca_estimator_bf16_policy_gate():
    from dask_ml_tpu.decomposition import PCA as JPCA
    from dask_ml_tpu_torch.decomposition import PCA

    X = _low_rank(2048, 24, 6)
    kw = dict(n_components=4, svd_solver="randomized", iterated_power=2,
              random_state=0)
    a = PCA(**kw).fit(X)
    with config_context(precision="bf16"):
        b = PCA(**kw).fit(X)
        Z = b.transform(X)
    assert Z.dtype == np.float32
    np.testing.assert_allclose(b.explained_variance_ratio_,
                               a.explained_variance_ratio_, atol=VAR_RTOL)
    with jconfig.config_context(precision="bf16"):
        j = JPCA(**kw).fit(X)
    np.testing.assert_allclose(b.explained_variance_ratio_,
                               j.explained_variance_ratio_, atol=VAR_RTOL)


def test_streamed_moments_bf16_gate():
    from dask_ml_tpu_torch.decomposition.streaming import streamed_moments

    rng = np.random.RandomState(0)
    X = rng.standard_normal((1024, 16)).astype(np.float32) + 1.0
    w = np.ones(1024, np.float32)
    sw32, s32, G32 = streamed_moments(
        block_fn=HostBlockSource((X, w), 8, storage_dtype=None), n_blocks=8)
    with config_context(precision="bf16"):
        src = HostBlockSource((X, w), 8)
    sw16, s16, G16 = streamed_moments(block_fn=src, n_blocks=8)
    assert float(sw16) == float(sw32)
    np.testing.assert_allclose(s16.numpy(), s32.numpy(), rtol=2e-2,
                               atol=2e-1)
    np.testing.assert_allclose(G16.numpy(), G32.numpy(), rtol=2e-2,
                               atol=2.0)
    # the moments of the bf16-rounded blocks, compensated: exact sums of
    # the rounded values within f32 rounding of the total (rtol 1e-6)
    Xr = torch.from_numpy(X).to(torch.bfloat16).double().numpy()
    np.testing.assert_allclose(s16.numpy(), Xr.sum(0), rtol=1e-6)
    np.testing.assert_allclose(G16.numpy(), Xr.T @ Xr, rtol=1e-6)
    # the JAX package's bf16 moments over the same blocks: within the same
    # rtol 1e-6 of the port's
    from dask_ml_tpu.decomposition.streaming import (
        streamed_moments as jmoments)
    from dask_ml_tpu.parallel.stream import HostBlockSource as JSource

    with jconfig.config_context(precision="bf16"):
        jsrc = JSource((X, w), 8)
    jsw, js, jG = jmoments(block_fn=jsrc, n_blocks=8)
    assert float(jsw) == float(sw16)
    np.testing.assert_allclose(s16.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(G16.numpy(), np.asarray(jG), rtol=1e-6)


# ---------------------------------------------------------------------------
# fused-distance |y|²: near-duplicate centers
# ---------------------------------------------------------------------------


def test_fused_bf16_near_duplicate_centers():
    """Two centers closer than bf16 resolution collapse in the bf16 copy of
    Y; only |y|² from the ORIGINAL Y breaks the tie toward the true
    nearest (row 1), as in the JAX package."""
    from dask_ml_tpu.ops import fused_distance as jfd
    from dask_ml_tpu_torch.ops.fused_distance import fused_argmin_min

    d = 8
    base = np.zeros(d, np.float32)
    base[0] = 8.0
    plus = base.copy()
    plus[0] = 8.01
    Y = np.stack([plus, base])
    X = torch.from_numpy(np.tile(base, (16, 1))).to(torch.bfloat16)
    idx, mind = fused_argmin_min(X, torch.from_numpy(Y))
    assert idx.tolist() == [1] * 16
    assert float(mind.max()) <= 1e-2
    jidx, jmind = jfd.fused_argmin_min(
        jnp.asarray(np.tile(base, (16, 1)), jnp.bfloat16), jnp.asarray(Y),
        kernel="pallas")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mind.numpy(), np.asarray(jmind))


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


def test_prepare_data_stages_policy_storage():
    from dask_ml_tpu_torch.parallel.sharding import (prepare_data,
                                                     staging_memo)

    X = np.random.RandomState(0).standard_normal((64, 4)).astype(np.float32)
    y = np.zeros(64, np.float32)
    with config_context(precision="bf16"):
        data = prepare_data(X, y=y)
        assert data.X.dtype == torch.bfloat16
        assert data.y.dtype == torch.float32
        assert data.weights.dtype == torch.float32
        with config_context(dtype=torch.float32):
            assert prepare_data(X).X.dtype == torch.float32
    with config_context(dtype=torch.bfloat16):
        assert prepare_data(X).X.dtype == torch.bfloat16
    assert prepare_data(X).X.dtype == torch.float32
    # the memo keys on the staging dtype and the policy's signature
    with staging_memo() as memo:
        a = prepare_data(X).X
        with config_context(precision="bf16"):
            b = prepare_data(X).X
            assert prepare_data(X).X is b
        assert prepare_data(X).X is a
        assert memo.n_stagings == 2
