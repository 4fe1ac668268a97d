"""The port's public surface against the JAX package's, name by name.

- Every name of the dask-ml surface that ``tests/test_api_parity.py``
  pins (its ``SURFACE``) resolves under ``dask_ml_tpu_torch``, at the same
  module path.
- Every module of ``dask_ml_tpu`` has a counterpart at the same path in
  the port (``comm -23`` of the two packages' ``*.py`` lists is empty).
- Every name in each JAX module's ``__all__`` resolves in the port's
  counterpart, but an explicit list of ROADMAP Queue A item 10b names
  (empty since ``ElasticRun`` landed: what is left of item 10b are
  ``mesh=`` branches of names the port has).
- The package's ``__all__`` names the JAX package's submodules.
- Every public JAX function, constructor or method that takes ``mesh`` or
  ``meshes`` takes it in the port, and no raise or docstring of the port
  still names ROADMAP Queue A item 10b (the multi-device port is whole).
- Every public JAX callable (``jax.jit``-wrapped functions included) has a
  port counterpart that takes the JAX call: the same parameter names, in
  the same order, with the same defaults. The allowances: ``device`` /
  ``devices``, ``kernel``, ``mesh`` / ``meshes`` and ``n_shards`` where
  the JAX callable has none; a ``torch.Generator`` (``gen``,
  ``generator``) where JAX takes a ``key``; a default where JAX requires
  the argument; and the deviations ``README.md`` records
  (:data:`SIGNATURE_DEVIATIONS`).
"""

import ast
import importlib
import importlib.util
import inspect
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: ROADMAP Queue A item 10b (the rest of multi-device): no whole module
#: is missing, and no name of a ported module is
ITEM_10_MODULES = ()
ITEM_10_NAMES: dict = {}

#: the modules item 10a ported (the multi-device substrate)
SUBSTRATE = ("parallel.mesh", "parallel.hierarchy", "parallel.runtime",
             "parallel.decisions")


def _modules(pkg: str) -> list:
    """Dotted module names under ``pkg`` (relative, '' for the package),
    from the files on disk."""
    base = os.path.join(ROOT, pkg)
    out = []
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        rel = os.path.relpath(dirpath, base)
        parts = [] if rel == "." else rel.split(os.sep)
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            stem = f[:-3]
            mod = parts if stem == "__init__" else parts + [stem]
            out.append(".".join(mod))
    return sorted(out)


JAX_MODULES = _modules("dask_ml_tpu")


def _declares_all(module: str) -> bool:
    """Whether the JAX module's source assigns ``__all__`` (read without
    importing it, so collection stays cheap and the same on every
    worker)."""
    rel = module.replace(".", os.sep)
    path = os.path.join(ROOT, "dask_ml_tpu", rel, "__init__.py")
    if not os.path.exists(path):
        path = os.path.join(ROOT, "dask_ml_tpu", rel + ".py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return any(isinstance(node, ast.Assign)
               and any(getattr(t, "id", None) == "__all__"
                       for t in node.targets)
               for node in tree.body)


def _resolves(mod, name: str) -> bool:
    """``name`` is an attribute of ``mod``, or a submodule of it that
    imports (``from pkg import *`` imports those)."""
    if hasattr(mod, name):
        return True
    try:
        importlib.import_module(f"{mod.__name__}.{name}")
    except ImportError:
        return False
    return True


def _surface() -> dict:
    spec = importlib.util.spec_from_file_location(
        "_jax_api_parity", os.path.join(ROOT, "tests", "test_api_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SURFACE


SURFACE = _surface()


@pytest.mark.parametrize("module", sorted(SURFACE))
def test_reference_surface_resolves_in_the_port(module):
    port = importlib.import_module(
        "dask_ml_tpu_torch" + module[len("dask_ml_tpu"):])
    missing = [n for n in SURFACE[module] if not hasattr(port, n)]
    assert not missing, f"{port.__name__} missing: {missing}"


def test_every_module_has_a_port_counterpart():
    port = set(_modules("dask_ml_tpu_torch"))
    missing = sorted(set(JAX_MODULES) - port)
    assert missing == sorted(ITEM_10_MODULES) == []


@pytest.mark.parametrize("module", SUBSTRATE)
def test_substrate_all_names_resolve(module):
    """Every name of the new modules' ``__all__`` resolves in them, and the
    JAX module's ``__all__`` is a subset of the port's."""
    port = importlib.import_module(f"dask_ml_tpu_torch.{module}")
    jax_mod = importlib.import_module(f"dask_ml_tpu.{module}")
    assert [n for n in port.__all__ if not hasattr(port, n)] == []
    assert set(getattr(jax_mod, "__all__", ())) <= set(port.__all__)


def test_parallel_package_exports_what_jax_exports():
    """The names ``dask_ml_tpu/parallel/__init__.py`` imports from the
    substrate and staging modules resolve in the port's package."""
    import dask_ml_tpu_torch.parallel as port

    path = os.path.join(ROOT, "dask_ml_tpu", "parallel", "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in tree.body
             if isinstance(node, ast.ImportFrom)
             and node.module.rsplit(".", 1)[-1] in (
                 "mesh", "hierarchy", "sharding", "elastic")
             for a in node.names]
    missing = [n for n in names if not hasattr(port, n)
               and n not in ITEM_10_NAMES.get("parallel.elastic", ())]
    assert names and not missing, missing


@pytest.mark.parametrize(
    "module", [m for m in JAX_MODULES
               if m not in ITEM_10_MODULES and _declares_all(m)])
def test_jax_all_names_resolve_in_the_port(module):
    jax_mod = importlib.import_module(
        "dask_ml_tpu" + (f".{module}" if module else ""))
    port = importlib.import_module(
        "dask_ml_tpu_torch" + (f".{module}" if module else ""))
    missing = [n for n in jax_mod.__all__ if not _resolves(port, n)
               and n not in ITEM_10_NAMES.get(module, ())]
    assert not missing, f"{port.__name__} missing: {missing}"


def test_item_10_names_are_still_missing():
    """The exclusions above are exactly what the port lacks: a name that
    lands must leave the list."""
    for module, names in ITEM_10_NAMES.items():
        port = importlib.import_module(f"dask_ml_tpu_torch.{module}")
        assert not [n for n in names if hasattr(port, n)], module


def test_package_all_names_the_submodules():
    import dask_ml_tpu
    import dask_ml_tpu_torch

    assert list(dask_ml_tpu_torch.__all__) == list(dask_ml_tpu.__all__)
    for name in dask_ml_tpu_torch.__all__:
        assert _resolves(dask_ml_tpu_torch, name), name


#: public JAX callables taking ``mesh`` that the port has no counterpart of
#: by design: ``shard_map`` runs a body once per device in the JAX package,
#: where a port rank runs its own block's code
MESH_EXEMPT = {("parallel.mesh", "shard_map")}


def _mesh_takers(jax_mod) -> list:
    """(name, method) of every public function, class constructor or
    public method defined in ``jax_mod`` whose signature has ``mesh`` or
    ``meshes`` (method ``""`` for a function, ``"__init__"`` for a
    constructor), with those parameter names."""
    out = []
    for name, obj in vars(jax_mod).items():
        if name.startswith("_") or \
                getattr(obj, "__module__", None) != jax_mod.__name__:
            continue
        if inspect.isclass(obj):
            targets = [("__init__", obj.__init__)] + [
                (n, f) for n, f in vars(obj).items()
                if inspect.isfunction(f) and not n.startswith("_")]
        elif callable(obj):  # functions, and jax.jit-wrapped ones
            targets = [("", obj)]
        else:
            continue
        for method, fn in targets:
            try:
                params = inspect.signature(fn).parameters
            except (TypeError, ValueError):
                continue
            names = [p for p in ("mesh", "meshes") if p in params]
            if names:
                out.append((name, method, names))
    return out


def test_every_mesh_argument_is_taken_in_the_port():
    checked, missing = 0, []
    for module in JAX_MODULES:
        jax_mod = importlib.import_module(
            "dask_ml_tpu" + (f".{module}" if module else ""))
        port = importlib.import_module(
            "dask_ml_tpu_torch" + (f".{module}" if module else ""))
        for name, method, params in _mesh_takers(jax_mod):
            if (module, name) in MESH_EXEMPT:
                continue
            target = getattr(port, name, None)
            if target is not None and method:
                target = getattr(target, method, None)
            if target is None:
                missing.append(f"{module}.{name}.{method}: no counterpart")
                continue
            have = inspect.signature(target).parameters
            lacking = [p for p in params if p not in have]
            if lacking:
                missing.append(f"{module}.{name}.{method}: {lacking}")
            checked += 1
    assert not missing, missing
    assert checked >= 40  # the generators, the estimators, the ops, ...


def test_no_item_10b_raise_or_docstring_is_left():
    """``grep -rn "item 10b" dask_ml_tpu_torch`` finds nothing: no
    ``mesh=`` path raises for the multi-device port, and no docstring
    defers to it."""
    hits = []
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, "dask_ml_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if re.search(r"item\s+10b|Queue A item", line):
                        hits.append(f"{os.path.relpath(path, ROOT)}:{i}")
    assert hits == []


# ---------------------------------------------------------------------------
# signatures: the JAX call works in the port
# ---------------------------------------------------------------------------

#: parameters the port may add where the JAX callable has none
EXTRA_ALLOWED = {"device", "devices", "kernel", "mesh", "meshes", "n_shards"}
#: the names a port parameter takes where the JAX one is a ``key``
KEY_NAMES = {"key", "gen", "generator"}

#: the deviations ``README.md`` records ("Signature deviations"): per
#: (module, name, method), the port's extra parameters and, each as
#: ``"-name"``, the JAX parameters the port lacks (the rest of the
#: signature is still checked), or None where the port has no counterpart
SIGNATURE_DEVIATIONS = {
    ("models.kmeans", "compute_inertia", ""): {"n_valid"},
    ("models.kmeans", "predict_labels", ""): {"n_valid"},
    ("models.kmeans", "predict_labels_sketched", ""): {"n_valid"},
    ("models.kmeans", "measure_init_phases", ""): {"n_valid"},
    ("models.kmeans", "batched_lloyd_cells", ""): {"idx0"},
    ("ops.fast_transform", "FastTransform", "__init__"): {"perms"},
    ("ops.fast_transform", "FastTransform", "tree_flatten"): None,
    ("ops.fast_transform", "FastTransform", "tree_unflatten"): None,
    ("ops.fast_transform", "palm4msa_fit", ""): {"perms", "generator"},
    ("ops.linalg", "svd_compressed", ""): {"omega"},
    ("ops.sparse", "SparseRows", "tree_flatten"): None,
    ("ops.sparse", "SparseRows", "tree_unflatten"): None,
    ("parallel.decisions", "lookup", ""): {"backend"},
    ("parallel.elastic", "elastic_admm_host", ""): {
        "-z0", "-x0", "-u0", "-lamduh", "-rho", "-abstol", "-reltol",
        "-inner_tol", "-sw_total", "z", "x", "u", "pen_prox", "scal"},
    ("parallel.framing", "crc32c", ""): {"engine"},
    ("parallel.mesh", "shard_map", ""): None,
    ("parallel.precision", "pmatmul", ""): {"compute", "accum",
                                            "**kwargs"},
    ("parallel.precision", "cast_wire", ""): {"pin"},
    ("parallel.procfleet", "ProcessFleet", "__init__"): {
        "-devices_per_replica"},
    ("parallel.runtime", "initialize", ""): {"backend", "init_method",
                                             "timeout_s"},
    ("parallel.serving", "ServingLoop", "__init__"): {"_group", "_leader"},
    ("parallel.shapes", "note_bucket", ""): None,
    ("parallel.sharding", "DeviceData", "__init__"): {
        "-d", "n_features", "n_padded", "row_offset", "col_offset"},
    ("utils._log", "log_array", ""): {"rows"},
}

_P = inspect.Parameter
_POSITIONAL = (_P.POSITIONAL_ONLY, _P.POSITIONAL_OR_KEYWORD)


def _public_callables(jax_mod) -> list:
    """(name, method, callable) of every public function (``jax.jit``
    wrappers included), class constructor and public method, static
    method or class method defined in ``jax_mod``."""
    out = []
    for name, obj in vars(jax_mod).items():
        if name.startswith("_") or \
                getattr(obj, "__module__", None) != jax_mod.__name__:
            continue
        if inspect.isclass(obj):
            out.append((name, "__init__", obj.__init__))
            for n, f in vars(obj).items():
                if n.startswith("_") or inspect.isclass(f):
                    continue
                if isinstance(f, (staticmethod, classmethod)) \
                        or inspect.isfunction(f):
                    out.append((name, n, getattr(obj, n)))
        elif callable(obj):
            out.append((name, "", obj))
    return out


def _default(v) -> str:
    """A default as text, the JAX package's dtypes and classes named as
    the port's."""
    if v is _P.empty:
        return "<required>"
    text = repr(v)
    for jax_text, port_text in (("<class 'jax.numpy.", "torch."),
                                ("jax.numpy.", "torch."),
                                ("dask_ml_tpu_torch.", "dask_ml_tpu.")):
        text = text.replace(jax_text, port_text)
    return text.replace("torch.float32'>", "torch.float32")


def _signature_gaps(jax_fn, port_fn, recorded) -> list:
    """How ``port_fn``'s signature fails to take ``jax_fn``'s calls, after
    the allowances and the ``recorded`` deviations (extra port parameters,
    and ``"-name"`` for a JAX parameter the port lacks)."""
    lacks = {r[1:] for r in recorded if r.startswith("-")}
    jp = {n: q for n, q in inspect.signature(jax_fn).parameters.items()
          if n not in lacks}
    pp = dict(inspect.signature(port_fn).parameters)
    gaps = []
    for name in list(pp):
        if name not in jp and (name in EXTRA_ALLOWED or name in recorded):
            del pp[name]
    if "key" in jp and "key" not in pp:
        for alias in KEY_NAMES & set(pp):
            pp = {("key" if n == alias else n): q.replace(name="key")
                  if n == alias else q for n, q in pp.items()}
            break
    jpos = [n if q.kind == _P.POSITIONAL_OR_KEYWORD else "/"
            for n, q in jp.items() if q.kind in _POSITIONAL]
    ppos = [n if q.kind == _P.POSITIONAL_OR_KEYWORD else "/"
            for n, q in pp.items() if q.kind in _POSITIONAL]
    if ppos[:len(jpos)] != jpos:
        gaps.append(f"positional {jpos} against {ppos}")
    for name, q in jp.items():
        if q.kind == _P.VAR_POSITIONAL:
            continue
        if q.kind == _P.VAR_KEYWORD:
            if f"**{name}" not in recorded and not any(
                    r.kind == _P.VAR_KEYWORD for r in pp.values()):
                gaps.append(f"**{name}")
            continue
        if q.kind == _P.POSITIONAL_ONLY:
            continue  # bound by position: the order check above holds it
        r = pp.get(name)
        if r is None or r.kind in (_P.POSITIONAL_ONLY, _P.VAR_POSITIONAL,
                                   _P.VAR_KEYWORD):
            gaps.append(f"takes no {name}=")
        elif q.default is not _P.empty and name != "key" \
                and _default(q.default) != _default(r.default):
            gaps.append(f"{name}={_default(q.default)} is "
                        f"{_default(r.default)}")
    for name, r in pp.items():
        if name not in jp and r.kind not in (_P.VAR_POSITIONAL,
                                              _P.VAR_KEYWORD):
            gaps.append(f"adds {name}")
    return gaps


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_jax_signature_takes_its_call_in_the_port(module):
    jax_mod = importlib.import_module(
        "dask_ml_tpu" + (f".{module}" if module else ""))
    port = importlib.import_module(
        "dask_ml_tpu_torch" + (f".{module}" if module else ""))
    gaps = []
    for name, method, fn in _public_callables(jax_mod):
        where = (module, name, method)
        recorded = SIGNATURE_DEVIATIONS.get(where, set())
        if recorded is None:
            continue
        target = getattr(port, name, None)
        if target is not None and method:
            target = getattr(target, method, None)
        if target is None:
            gaps.append(f"{name}.{method}: no counterpart")
            continue
        try:
            inspect.signature(fn)
        except (TypeError, ValueError):
            continue
        gaps += [f"{name}.{method}: {g}"
                 for g in _signature_gaps(fn, target, recorded)]
    assert not gaps, gaps


def test_signature_deviations_are_recorded_and_still_deviate():
    """Every entry of :data:`SIGNATURE_DEVIATIONS` is named in README.md's
    "Signature deviations" and still differs: an entry the port has
    brought to the JAX signature must leave the table."""
    with open(os.path.join(ROOT, "README.md")) as f:
        readme = f.read()
    section = readme[readme.index("Signature deviations"):]
    for (module, name, method), extra in SIGNATURE_DEVIATIONS.items():
        qual = f"{module}.{name}" + (f".{method}" if method else "")
        assert f"`{qual}`" in section, qual
        jax_mod = importlib.import_module(f"dask_ml_tpu.{module}")
        port = importlib.import_module(f"dask_ml_tpu_torch.{module}")
        fn = getattr(jax_mod, name)
        target = getattr(port, name, None)
        if method:
            fn = getattr(fn, method)
            target = getattr(target, method, None)
        if target is None:
            assert extra is None, qual
            continue
        gaps = _signature_gaps(fn, target, set())
        assert gaps, f"{qual} takes the JAX call: drop it from the table"
        if extra is not None:
            assert _signature_gaps(fn, target, extra) == [], qual


def test_repaired_entries_take_the_jax_call():
    """The calls the JAX package's own tests make, in the port."""
    import numpy as np
    import torch

    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.decomposition.pca import transform_program
    from dask_ml_tpu_torch.metrics import (accuracy_score, get_scorer,
                                           log_loss, mean_absolute_error,
                                           mean_squared_error, r2_score)
    from dask_ml_tpu_torch.ops.pairwise import pairwise_distances_argmin_min
    from dask_ml_tpu_torch.ops.sparse import (SparseRows, ell_from_dense,
                                              is_sparse_rows)
    from dask_ml_tpu_torch.parallel.precision import pdot
    from dask_ml_tpu_torch.parallel.procfleet import ProcessFleet
    from dask_ml_tpu_torch.parallel.replica import ReplicaHost
    from dask_ml_tpu_torch.parallel.shapes import bucket_cols, bucket_nnz
    from dask_ml_tpu_torch.parallel.sharding import StagingMemo
    from dask_ml_tpu_torch.utils.validation import check_array

    with config_context(device="cpu"):
        for metric, args in (
                (accuracy_score, ([1, 0, 1], [1, 1, 1])),
                (log_loss, ([0, 1, 1], [0.2, 0.7, 0.9])),
                (mean_squared_error, ([1.0, 2.0], [1.5, 2.0])),
                (mean_absolute_error, ([1.0, 2.0], [1.5, 2.0])),
                (r2_score, ([1.0, 2.0, 3.0], [1.0, 2.5, 3.0]))):
            lazy = metric(*args, compute=False)
            assert isinstance(lazy, torch.Tensor) and lazy.dim() == 0
            assert float(lazy) == metric(*args)
        assert get_scorer("accuracy", compute=False) is get_scorer(
            "accuracy")
    assert ProcessFleet().max_batch_rows == 1024
    host = ReplicaHost("r0", "snapshot", "workdir")
    assert (host.max_batch_rows, host.max_queue) == (1024, 4096)
    assert check_array(np.arange(4.0), ensure_2d=False).shape == (4,)
    assert check_array(np.ones((2, 3, 4)), ensure_2d=False,
                       allow_nd=True).shape == (2, 3, 4)
    assert np.isnan(check_array(np.array([[np.nan]]),
                                force_all_finite=False)).all()
    assert check_array(np.ones((2, 2)), dtype=np.float64).dtype == np.float64
    with pytest.raises(ValueError, match="minimum of 3"):
        check_array(np.ones((2, 2)), min_samples=3)
    X = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
    idx, dist = pairwise_distances_argmin_min(X, X[1:], mesh=None)
    assert idx.tolist() == [0, 0] and dist.tolist() == [5.0, 0.0]
    A = ell_from_dense(np.array([[1.5, 0.0], [0.0, 2.0]], np.float32))
    assert is_sparse_rows(A) and not is_sparse_rows(A.values)
    B = A.astype(np.float64)
    assert isinstance(B, SparseRows) and B.values.dtype == np.float64
    assert B.cols is A.cols and B.d == A.d
    T = A.to("cpu").astype(torch.bfloat16)
    assert T.values.dtype == torch.bfloat16
    assert bucket_nnz(5, record=False) == bucket_nnz(5) == 8
    assert bucket_cols(10, align=4, record=False) == 12
    memo = StagingMemo()
    t = torch.ones(2)
    assert memo.trust(arr=t) is t and memo.is_trusted(arr=t)
    out = transform_program(torch.ones(2, 2), torch.zeros(2),
                            torch.eye(2), explained_variance=torch.full(
                                (2,), 4.0), whiten=True)
    assert torch.equal(out, torch.full((2, 2), 0.5))
    g = pdot(torch.ones(3, 2), torch.ones(2),
             dimension_numbers=(((1,), (0,)), ((), ())))
    assert g.tolist() == [2.0, 2.0, 2.0]
