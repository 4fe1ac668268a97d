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
        elif inspect.isfunction(obj):
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
