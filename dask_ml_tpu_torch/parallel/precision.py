"""Mixed-precision execution policy of the PyTorch port: bf16 on the wire
and in device memory, f32 accumulation (counterpart of
``dask_ml_tpu/parallel/precision.py``).

- :class:`PrecisionPolicy` names the three dtypes that matter:
  ``storage`` (what big arrays weigh on the wire and in device memory),
  ``compute`` (what matmul operands are rounded to) and ``accum`` (what
  contractions and solver state accumulate in, never below f32), plus
  per-op ``overrides``.
- The thread-local ``precision`` config knob
  (:mod:`dask_ml_tpu_torch.config`) selects the active policy through
  :func:`resolve`. ``"auto"`` resolves to :data:`F32` on the card and on
  the CPU: the JAX package's ``"auto"`` is bf16 only on a TPU backend,
  and the port has none. bf16 runs only when the caller asks for it
  (``"bf16"``, a policy, or ``dtype=torch.bfloat16``).
- :func:`pdot` / :func:`pmatmul` round both operands to the compute dtype
  and return the f32 product. On the card :func:`pmatmul` is one
  bf16-in / f32-out cuBLAS GEMM (``torch.mm`` / ``torch.bmm`` with
  ``out_dtype=torch.float32``), which reads X at 2 bytes an element;
  elsewhere the operands are widened to f32 before a plain f32 matmul.
  A product of two bf16 values is exact in f32, so both compute the same
  function up to the order of the sums (TF32 off, PyTorch's default). A
  bare ``torch.matmul`` on bf16 tensors returns bf16, which is not.
- The cotangent rule: a gradient's cotangent is solver state and is never
  rounded below f32. :func:`pullback_matmul` forms ``Xᵀ @ r`` from bf16 X
  and the f32 ``r`` at f32 accuracy, and the gradient of :func:`pmatmul`
  with respect to either operand goes through it (the operands' rounding
  passes the gradient straight through). The sparse pullbacks
  (``ops.sparse``) keep the same rule. The JAX package rounds ``r`` to
  bf16, which on a logistic cotangent ``σ(η) − y`` loses what η adds to
  ±½.
- :func:`neumaier_add` / :func:`neumaier_sum` are compensated sums for
  long chains over low-precision inputs (the streamed moments).
- :func:`cast_wire` narrows a host block to the wire dtype in torch
  (numpy has no bfloat16): a CPU tensor's ``.to(torch.bfloat16)``, which
  rounds to nearest even.

The policy acts where data is staged (``prepare_data``), streamed
(``HostBlockSource``) and sketched (the PCA range finder); everything
downstream follows the dtype the data arrives in. Solver state is
:func:`state_dtype` of the data dtype: at least f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "PrecisionPolicy",
    "F32",
    "BF16",
    "resolve",
    "state_dtype",
    "lloyd_bounds_dtype",
    "fast_transform_dtype",
    "pdot",
    "pmatmul",
    "pullback_matmul",
    "neumaier_add",
    "neumaier_sum",
    "cast_wire",
    "staging_wire_dtype",
]

#: dtypes that never hold solver state (the floor of :func:`state_dtype`)
_LOW_PRECISION = (torch.bfloat16, torch.float16)

_NAMES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float16": torch.float16, "float32": torch.float32,
          "f32": torch.float32, "float64": torch.float64}


def as_dtype(dt) -> Optional[torch.dtype]:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name
    (``"bfloat16"``, ``"float32"``, …); ``None`` stays ``None``."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    name = getattr(dt, "name", None) or getattr(dt, "__name__", None) \
        or str(dt)
    if name in _NAMES:
        return _NAMES[name]
    return torch.from_numpy(np.empty(0, np.dtype(dt))).dtype


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """The three dtypes of a mixed-precision run, plus per-op overrides.

    - ``storage`` — the dtype big arrays are staged and streamed in;
      ``None`` keeps the input dtype.
    - ``compute`` — the dtype matmul operands are rounded to; ``None``
      follows the data array's dtype.
    - ``accum`` — the dtype contractions accumulate in and state lives in,
      floored at float32 (:func:`state_dtype`).
    - ``overrides`` — ``{op_name: dtype}`` read by :meth:`compute_for`
      (``"sketch"``, ``"lloyd_bounds"``, ``"fast_transform"``).

    Frozen and hashable (overrides are kept as a sorted tuple), so a
    policy can key a memo entry."""

    storage: Any = None
    compute: Any = None
    accum: Any = torch.float32
    overrides: Any = None

    def __post_init__(self):
        for name in ("storage", "compute", "accum"):
            object.__setattr__(self, name, as_dtype(getattr(self, name)))
        ov = self.overrides
        if isinstance(ov, dict):
            ov = sorted(ov.items(), key=lambda kv: kv[0])
        if ov is not None:
            object.__setattr__(self, "overrides",
                               tuple((k, as_dtype(v)) for k, v in ov))

    def storage_dtype(self, default=None):
        """The staging / wire dtype, or ``default`` when the policy keeps
        input dtypes."""
        return self.storage if self.storage is not None else default

    def compute_for(self, op: Optional[str] = None):
        """Compute dtype for ``op``: its override first, then the
        policy-wide ``compute``; ``None`` means "follow the data"."""
        if op is not None and self.overrides:
            for name, dt in self.overrides:
                if name == op:
                    return dt
        return self.compute

    def state_dtype(self, data_dtype):
        """Solver-state dtype for data of ``data_dtype`` under this
        policy: the accumulation dtype, never below f32."""
        return state_dtype(data_dtype, accum=self.accum)

    def signature(self) -> tuple:
        """Hashable identity for memo keys."""
        return ("PrecisionPolicy", str(self.storage), str(self.compute),
                str(self.accum), self.overrides)


#: input dtypes kept, f32 accumulation: every path before the policy
F32 = PrecisionPolicy()

#: bf16 on the wire, in device memory and as matmul operands; every
#: contraction and all solver state f32
BF16 = PrecisionPolicy(storage=torch.bfloat16, compute=torch.bfloat16)


def resolve(knob: Any = "__config__") -> PrecisionPolicy:
    """The active :class:`PrecisionPolicy` from the ``precision`` config
    knob (or from ``knob`` when given):

    - ``"auto"`` (the default) → :data:`F32`, on the card and on the CPU
      alike (the JAX package takes bf16 only on a TPU backend);
    - ``None`` / ``"f32"`` / ``"float32"`` → :data:`F32`;
    - ``"bf16"`` / ``"bfloat16"`` → :data:`BF16`;
    - a :class:`PrecisionPolicy` → itself."""
    if isinstance(knob, str) and knob == "__config__":
        from dask_ml_tpu_torch.config import get_config

        knob = get_config()["precision"]
    if knob is None:
        return F32
    if isinstance(knob, PrecisionPolicy):
        return knob
    if knob == "auto":
        return F32
    if knob in ("bf16", "bfloat16"):
        return BF16
    if knob in ("f32", "float32"):
        return F32
    raise ValueError(
        "precision must be 'auto', None, 'f32'/'float32', "
        f"'bf16'/'bfloat16', or a PrecisionPolicy; got {knob!r}")


def state_dtype(data_dtype, accum=torch.float32) -> torch.dtype:
    """Solver-state dtype for data of ``data_dtype``: at least float32,
    however low the data goes. ``accum`` can raise the floor (f64) and
    never lower it: ``accum=bfloat16`` still gives float32. A pure
    function of the dtypes, never of the thread-local policy."""
    dt = as_dtype(data_dtype)
    if dt in _LOW_PRECISION:
        dt = torch.float32
    floor = torch.promote_types(dt, torch.float32)
    acc = as_dtype(accum)
    if acc in _LOW_PRECISION:
        acc = torch.float32
    return torch.promote_types(floor, acc)


def _raised(data_dtype, policy, op):
    p = resolve() if policy is None else policy
    base = state_dtype(data_dtype, accum=p.accum)
    override = p.compute_for(op)
    if override is None:
        return base
    return torch.promote_types(state_dtype(override), base)


def lloyd_bounds_dtype(data_dtype, policy=None) -> torch.dtype:
    """Dtype of the bounded Lloyd loop's bounds under the active policy:
    the ``"lloyd_bounds"`` override when the policy sets one, else
    :func:`state_dtype` of the data dtype, and never below f32 (an
    override of bf16 still gives f32: bounds must out-resolve the f32
    noise of the distances they guard)."""
    return _raised(data_dtype, policy, "lloyd_bounds")


def fast_transform_dtype(data_dtype, policy=None) -> torch.dtype:
    """Compute dtype of the fast-transform fit and its applications under
    the active policy: the ``"fast_transform"`` override, else
    :func:`state_dtype` of the data dtype, never below f32 (the rotation
    angles and the palm4MSA loss are solver state)."""
    return _raised(data_dtype, policy, "fast_transform")


def staging_wire_dtype():
    """The dtype predict / transform paths stage X in: the explicit
    ``dtype`` config knob when set (it outranks the policy, as in
    ``prepare_data``), else the policy's storage dtype, else ``None``
    (keep the input dtype)."""
    from dask_ml_tpu_torch.config import get_config

    dtype = get_config()["dtype"]
    if dtype is not None:
        return dtype
    return resolve().storage_dtype()


# ---------------------------------------------------------------------------
# precision-aware contractions
# ---------------------------------------------------------------------------


def _operand(t, cd):
    """``t`` rounded to the compute dtype ``cd`` and held in f32 (or in the
    wider of the two): the operand of an f32 matmul whose products are
    those of ``cd`` operands."""
    if t.dtype != cd:
        t = t.to(cd)
    if t.dtype in _LOW_PRECISION:
        t = t.to(torch.float32)
    return t


def pdot(a, b, dimension_numbers, *, compute=None, accum=torch.float32):
    """``lax.dot_general(a, b, dimension_numbers)`` (``((lhs contracting,
    rhs contracting), (lhs batch, rhs batch))``; the output's axes are the
    batch axes, then ``a``'s free axes, then ``b``'s) with both operands
    rounded to the COMPUTE dtype and the result in ``accum`` (at least
    f32). ``compute=None`` follows the first operand (by convention the
    data array). On f32 data it is the plain f32 product: a
    ``torch.tensordot`` without batch axes, an ``einsum`` with them."""
    (lc, rc), (lb, rb) = dimension_numbers
    cd = as_dtype(compute) if compute is not None else a.dtype
    A, B = _operand(a, cd), _operand(b, cd)
    if not len(lb) and not len(rb):
        out = torch.tensordot(A, B, (list(lc), list(rc)))
    else:
        letters = "abcdefghijklmnopqrstuvwxyz"
        sa = list(letters[:A.dim()])
        sb = list(letters[A.dim():A.dim() + B.dim()])
        for i, j in list(zip(lc, rc)) + list(zip(lb, rb)):
            sb[j] = sa[i]
        bound_a, bound_b = set(lc) | set(lb), set(rc) | set(rb)
        spec = ([sa[i] for i in lb]
                + [x for i, x in enumerate(sa) if i not in bound_a]
                + [x for j, x in enumerate(sb) if j not in bound_b])
        out = torch.einsum(
            f"{''.join(sa)},{''.join(sb)}->{''.join(spec)}", A, B)
    acc = state_dtype(out.dtype, accum=accum)
    return out if out.dtype == acc else out.to(acc)


def _mm_f32(a, b):
    """``a @ b`` of two low-precision operands in f32: one bf16-in /
    f32-out GEMM on the card for the 2-D and batched 3-D shapes, else the
    operands widened to f32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        if a.dim() == b.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        if a.dim() == b.dim() == 3 and a.shape[0] == b.shape[0]:
            return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(_operand(a, a.dtype), _operand(b, b.dtype))


class _PMatMul(torch.autograd.Function):
    """``a @ b`` of operands rounded to a low-precision compute dtype, f32
    out. The rounding passes the gradient straight through, and each
    gradient is the product of the other (rounded) operand with the f32
    cotangent, through :func:`pullback_matmul`: no cotangent is rounded."""

    @staticmethod
    def forward(ctx, a, b, cd):
        a, b = a.to(cd), b.to(cd)
        vec = b.dim() == 1
        b2 = b[:, None] if vec else b
        ctx.save_for_backward(a, b2)
        ctx.vec = vec
        out = _mm_f32(a, b2)
        return out[..., 0] if vec else out

    @staticmethod
    def backward(ctx, g):
        a, b2 = ctx.saved_tensors
        g2 = g[..., None] if ctx.vec else g
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = pullback_matmul(b2, g2.transpose(-1, -2)).transpose(-1, -2)
            while ga.dim() > a.dim():
                ga = ga.sum(0)
        if ctx.needs_input_grad[1]:
            gb = pullback_matmul(a.transpose(-1, -2), g2)
            while gb.dim() > b2.dim():
                gb = gb.sum(0)
            if ctx.vec:
                gb = gb[..., 0]
        return ga, gb, None


def pmatmul(a, b, *, compute=None, accum=torch.float32):
    """``a @ b`` with both operands rounded to the COMPUTE dtype and the
    result in ``accum`` (at least f32): ``a``'s last axis against ``b``'s
    first (the matmul / matvec shapes the solvers use). ``compute=None``
    follows the first operand (by convention the data array). On f32 data
    it is the plain ``torch.matmul``, bit for bit. With a bf16 compute
    dtype it is one bf16-in / f32-out GEMM on the card (no f32 copy of
    either operand), and its gradients keep the cotangent f32 (the
    module's cotangent rule)."""
    cd = as_dtype(compute) if compute is not None else a.dtype
    if cd in _LOW_PRECISION and a.dim() in (2, 3) and b.dim() >= 1:
        out = _PMatMul.apply(a, b, cd)
    else:
        out = torch.matmul(_operand(a, cd), _operand(b, cd))
    acc = state_dtype(out.dtype, accum=accum)
    return out if out.dtype == acc else out.to(acc)


def pullback_matmul(a, r):
    """``a @ r`` where ``a`` is the data operand (a transposed view of X,
    bf16 or f32) and ``r`` a cotangent, which stays f32 (the module's
    cotangent rule): for f32 data the plain ``torch.matmul``, bit for bit.
    For bf16 data on the card, ``r`` is split exactly into three bf16 parts
    (8 + 8 + 8 bits of its 24, so ``r1 + r2 + r3 == r`` wherever the parts
    stay normal) and one bf16-in / f32-out GEMM takes all three as
    columns: every product exact, f32 sums, X read at 2 bytes an element.
    Elsewhere ``a`` is widened to f32 and the products are rounded once in
    f32. Either way the result is ``aᵀ``'s contraction with the unrounded
    ``r`` at f32 accuracy."""
    if a.dtype not in _LOW_PRECISION:
        return pmatmul(a, r)
    r = r.to(torch.float32)
    if (a.is_cuda and a.dtype == torch.bfloat16 and a.dim() in (2, 3)
            and r.dim() == a.dim()):
        r1 = r.to(a.dtype)
        e = r - r1.to(torch.float32)
        r2 = e.to(a.dtype)
        r3 = (e - r2.to(torch.float32)).to(a.dtype)
        m = r.shape[-1]
        out = _mm_f32(a, torch.cat([r1, r2, r3], dim=-1))
        return (out[..., :m] + out[..., m:2 * m]) + out[..., 2 * m:]
    return torch.matmul(a.to(torch.float32), r)


# ---------------------------------------------------------------------------
# compensated summation (Neumaier's improved Kahan)
# ---------------------------------------------------------------------------


def neumaier_add(total, comp, x):
    """One compensated-summation step, ``(total, comp) += x``, with the
    rounding error kept in ``comp`` (Neumaier's variant of Kahan's, which
    stays right when ``|x| > |total|``). The running sum is
    ``total + comp``: add them once, at the end of the chain. Elementwise,
    so one step serves a scalar, the column sums and the streamed Gram."""
    t = total + x
    comp = comp + torch.where(torch.abs(total) >= torch.abs(x),
                              (total - t) + x, (x - t) + total)
    return t, comp


def neumaier_sum(x, axis: int = 0, dtype=torch.float32):
    """Compensated sum of ``x`` along ``axis`` in ``dtype``: one
    :func:`neumaier_add` a slice, in order (vectorized over the other
    axes)."""
    x = torch.movedim(torch.as_tensor(x), axis, 0).to(as_dtype(dtype))
    total = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    comp = torch.zeros_like(total)
    for i in range(x.shape[0]):
        total, comp = neumaier_add(total, comp, x[i])
    return total + comp


# ---------------------------------------------------------------------------
# host-side wire casting (the streamed tier's storage cast)
# ---------------------------------------------------------------------------


def _itemsize(dt) -> int:
    return torch.empty(0, dtype=dt).element_size()


def cast_wire(block: tuple, storage, pin: bool = False) -> tuple:
    """A host block tuple in the wire dtype ``storage``.

    Only floating leaves with ``ndim >= 2`` (the data matrix) narrow; 1-D
    labels and weights stay exact. Nothing is ever widened: a leaf already
    as narrow as ``storage`` is kept. A sparse element narrows its values
    and never its int32 columns. A narrowed leaf is a CPU tensor (numpy
    has no bfloat16), cast by torch with rounding to nearest even, and
    with ``pin=True`` written straight into page-locked memory, so its
    copy to the card is one DMA. ``storage=None`` returns the block
    unchanged."""
    if storage is None:
        return tuple(block)
    from dask_ml_tpu_torch.ops.sparse import SparseRows

    st = as_dtype(storage)
    size = _itemsize(st)

    def cast_leaf(leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else None
        if t is None:
            arr = np.asarray(leaf)
            if not (arr.ndim >= 2 and np.issubdtype(arr.dtype, np.floating)
                    and arr.dtype.itemsize > size):
                return leaf
            t = torch.from_numpy(np.ascontiguousarray(arr))
        elif not (t.dim() >= 2 and t.is_floating_point()
                  and t.element_size() > size):
            return leaf
        if pin:
            out = torch.empty(t.shape, dtype=st, pin_memory=True)
            return out.copy_(t)
        return t.to(st)

    def cast(a):
        if isinstance(a, SparseRows):
            return SparseRows(cast_leaf(a.values), a.cols, a.d)
        return cast_leaf(a)

    return tuple(cast(a) for a in block)
