"""Content-addressed tokens for work-sharing in the search driver (a copy
of ``dask_ml_tpu/model_selection/_tokenize.py``: pure Python and numpy;
tensors hash by their host bytes).

The reference registers ``dask.base.normalize_token`` rules for estimators and
CV splitters so that graph keys are content-addressed and identical
(estimator-config, data) fits collapse to one task
(reference: model_selection/_normalize.py:17-62, used by the ``seen`` maps in
_search.py:281-345). Our driver's memoization needs the same property but only
*within one search call*, so data identity can be a (split-id, role) pair and
only estimator configurations need content hashing.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _update(h, s: str):
    h.update(s.encode())


def _host_array(obj) -> np.ndarray:
    """An ndarray-like (numpy, or a tensor on any device) as a contiguous
    host ndarray."""
    if hasattr(obj, "detach") and hasattr(obj, "cpu"):
        obj = obj.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(obj))


# ---------------------------------------------------------------------------
# callable/value content identity
#
# Tokens must change when a callable's BEHAVIOR changes and be stable across
# processes. Neither module+qualname (every lambda is "<lambda>"; editing a
# function body changes nothing) nor pickle (serializes module-level
# functions by reference) nor repr (embeds addresses) has both properties —
# so callables are identified by bytecode + referenced global names +
# constants + closure/default/instance values, recursively.
# ---------------------------------------------------------------------------


_ADDR_RE = None


def _stable_repr(obj) -> str:
    """``repr`` with memory addresses stripped, so identities are stable
    across processes (default object reprs embed ``at 0x7f...``)."""
    global _ADDR_RE
    if _ADDR_RE is None:
        import re

        _ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")
    return _ADDR_RE.sub("0x", repr(obj))


def _code_identity(code):
    """Identity of a code object: bytecode + referenced GLOBAL NAMES +
    constants (nested code objects — inner lambdas/defs — recurse instead of
    repr'ing, which would embed an address). co_names matters: two lambdas
    calling different globals have byte-identical co_code."""
    consts = tuple(
        _code_identity(c) if hasattr(c, "co_code") else _stable_repr(c)
        for c in code.co_consts
    )
    return ("co", code.co_code, code.co_names, consts)


def _value_identity(obj, seen=None):
    """Process-stable content identity of an arbitrary captured value."""
    if callable(obj):
        return _callable_identity(obj, seen)
    if hasattr(obj, "shape") and hasattr(obj, "dtype") and hasattr(
            obj, "__array__"):
        # ndarray-likes incl. tensors: repr() truncates ('...') and would
        # collide distinct contents (same rule as _normalize below)
        arr = _host_array(obj)
        if arr.dtype == object:
            return ("nd-obj", arr.shape, _stable_repr(arr.tolist()))
        return ("nd", arr.shape, str(arr.dtype), arr.tobytes())
    if isinstance(obj, (list, tuple, dict, set, frozenset)):
        # containers join the cycle guard: self-referential lists/dicts are
        # legal Python and must not blow the stack
        seen = set() if seen is None else seen
        if id(obj) in seen:
            return ("cycle",)
        seen = seen | {id(obj)}
        if isinstance(obj, (list, tuple)):
            return ("seq", type(obj).__name__,
                    tuple(_value_identity(v, seen) for v in obj))
        if isinstance(obj, dict):
            return ("map", tuple(
                (_stable_repr(k), _value_identity(obj[k], seen))
                for k in sorted(obj, key=repr)))
        return ("set", tuple(sorted(
            (_value_identity(v, seen) for v in obj), key=repr)))
    return _stable_repr(obj)


def _object_identity(obj, seen=None):
    """Identity of an object by class + attribute CONTENT (function-valued
    attrs by their code), for scorer instances and bound-method selves."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return ("cycle",)  # self-referential object graph: mark and stop
    seen = seen | {id(obj)}
    attrs = getattr(obj, "__dict__", None)
    if isinstance(attrs, dict):
        attr_id = tuple(
            (k, _value_identity(v, seen)) for k, v in sorted(attrs.items())
        )
    else:
        # __slots__-backed objects have no __dict__; their state lives in
        # the slot descriptors declared across the MRO
        slot_names = sorted({
            name
            for klass in type(obj).__mro__
            for name in getattr(klass, "__slots__", ())
        })
        if slot_names:
            attr_id = tuple(
                (name, _value_identity(getattr(obj, name, "<unset>"), seen))
                for name in slot_names
            )
        else:
            attr_id = _stable_repr(obj)
    return ("obj", type(obj).__module__, type(obj).__qualname__, attr_id)


def _cell_value(cell):
    try:
        return cell.cell_contents
    except ValueError:  # unbound cell ("Cell is empty")
        return "<empty-cell>"


def _callable_identity(fn, seen=None):
    import functools

    outer_seen = set() if seen is None else seen
    if id(fn) in outer_seen:
        return ("cycle",)
    seen = outer_seen | {id(fn)}
    if isinstance(fn, functools.partial):
        # partial's __dict__ is empty — func/args/keywords carry the state
        return ("partial", _callable_identity(fn.func, seen),
                tuple(_value_identity(a, seen) for a in fn.args),
                tuple((k, _value_identity(v, seen))
                      for k, v in sorted(fn.keywords.items())))
    code = getattr(fn, "__code__", None)
    if code is not None:
        # a plain function/lambda/method: identify by its CODE, not by
        # pickle — pickle serializes module-level functions by reference
        # (module+qualname), so editing the body would not invalidate
        cells = tuple(
            _value_identity(_cell_value(c), seen)
            for c in (getattr(fn, "__closure__", None) or ())
        )
        defaults = tuple(
            _value_identity(v, seen)
            for v in (getattr(fn, "__defaults__", None) or ())
        )
        kwdefaults = tuple(
            (k, _value_identity(v, seen))
            for k, v in sorted((getattr(fn, "__kwdefaults__", None)
                                or {}).items())
        )
        # a bound method's behavior also depends on its instance's state
        self_obj = getattr(fn, "__self__", None)
        self_id = (None if self_obj is None
                   else _object_identity(self_obj, seen))
        return ("fn", getattr(fn, "__module__", ""),
                getattr(fn, "__qualname__", ""), _code_identity(code),
                cells, defaults, kwdefaults, self_id)
    # non-function callable (e.g. a make_scorer product): class + attribute
    # values, with function-valued attrs (the score_func) by code identity.
    # Delegate with the OUTER seen — _object_identity does its own
    # check-and-add for fn, and the id we just added would read as a cycle.
    return _object_identity(fn, outer_seen)


def _normalize(obj, h):
    """Feed a stable representation of ``obj`` into hash ``h``.

    Estimators normalize to (qualified class name, sorted shallow params) with
    nested estimators/arrays recursed — the same rule as the reference's
    ``normalize_estimator`` (reference: _normalize.py:17-23).
    """
    if isinstance(obj, type):
        _update(h, f"type:{obj.__module__}.{obj.__qualname__}")
    elif hasattr(obj, "get_params") and hasattr(obj, "set_params"):
        _update(h, f"est:{type(obj).__module__}.{type(obj).__qualname__}(")
        for k, v in sorted(obj.get_params(deep=False).items()):
            _update(h, f"{k}=")
            _normalize(v, h)
            _update(h, ",")
        _update(h, ")")
    elif isinstance(obj, np.ndarray) or (
        hasattr(obj, "shape") and hasattr(obj, "dtype")
        and hasattr(obj, "__array__")
    ):
        # covers tensors and other ndarray-likes too: repr() would
        # truncate large arrays ('...') and collide distinct contents
        arr = _host_array(obj)
        _update(h, f"nd:{arr.shape}:{arr.dtype}:")
        if arr.dtype == object:
            _update(h, repr(arr.tolist()))
        else:
            h.update(arr.tobytes())
    elif isinstance(obj, (list, tuple)):
        _update(h, f"{type(obj).__name__}[")
        for v in obj:
            _normalize(v, h)
            _update(h, ",")
        _update(h, "]")
    elif isinstance(obj, dict):
        _update(h, "dict{")
        for k in sorted(obj, key=repr):
            _update(h, f"{k!r}:")
            _normalize(obj[k], h)
            _update(h, ",")
        _update(h, "}")
    elif callable(obj):
        # content identity, not module+qualname: two lambdas (or two edits
        # of the same function) as hyperparameter values must NOT collide —
        # a name-keyed token would share one memoized fit between candidates
        # with different callables
        _normalize(_callable_identity(obj), h)
    else:
        _update(h, f"{type(obj).__name__}:{obj!r}")


def tokenize(*args) -> str:
    h = hashlib.sha256()
    for a in args:
        _normalize(a, h)
        _update(h, ";")
    return h.hexdigest()[:32]
