"""The port's public surface against the JAX package's.

Every module of ``gmmvi_tpu/`` is read by ``ast`` (not imported): its
module-level public names (functions, classes, constants and ``__all__``),
each public class's members (methods, properties, annotated fields and
class constants), and the parameter names of every function and method.
Each name must resolve on the port's module of the same path
(``gmmvi_tpu_torch/...``, imported: re-exports count; a dataclass's or
named tuple's field counts as a member), and each parameter name must
appear in the counterpart's signature, unless the name sits in
:data:`BY_DESIGN` with its reason.  One case per JAX module, and one that
holds the table to gaps that still exist, so no entry outlives its gap.
"""
import ast
import dataclasses
import importlib
import inspect
import os
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "gmmvi_tpu"
JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))

# The JAX package's Pallas wrappers: the port's modules that wrap their
# kernels' CUDA counterparts instead (ROADMAP.md section B, kernels B1-B9).
PALLAS_MODULES = {
    "ops/pallas_density.py": ("gmmvi_tpu_torch.ops.density",
                              "gmmvi_tpu_torch.ops.background"),
    "ops/pallas_density_large.py": ("gmmvi_tpu_torch.ops.density_large",),
    "ops/pallas_kernels.py": ("gmmvi_tpu_torch.ops.mixture_logpdf",),
    "ops/pallas_more.py": ("gmmvi_tpu_torch.ops.more",),
    "ops/pallas_stein.py": ("gmmvi_tpu_torch.ops.stein",),
    "ops/pallas_trust_region.py": ("gmmvi_tpu_torch.ops.trust_region",),
}

# (module, name) gaps by design, each with its reason.  A name is
# ``Class.member``; ``function(param)`` is one parameter; ``*(param)``
# every parameter of that name in the module; module ``*`` every module.
_SPMD = ("the gate of XLA's SPMD partitioner around shard_map; the port's "
         "ranks are torch.distributed processes (parallel/reduce.py)")
_BLOCKED = ("a TPU workaround: XLA's triangular solves and Cholesky are "
            "slow on the MXU above D = 128; torch.linalg is used on the card")
_SHARDING = "a jax.sharding spec; a torch.distributed rank holds its own rows"
_INIT_DIST = "jax.distributed's arguments; the port takes torch.distributed's"
BY_DESIGN = {
    ("*", "*(key)"): "a JAX PRNG key; the port draws from a torch.Generator "
                     "or takes injected draws (StepDraws)",
    ("*", "*(shard_fn)"): "a JAX sharding constraint; the port's ranks reduce "
                          "their partials through parallel/reduce.py",
    ("*", "*(dtype)"): "the port takes a device; its states are float32",
    ("ops/stable.py", "*(axis)"): "torch's name for it is dim",
    ("ops/stable.py", "*(keepdims)"): "torch's name for it is keepdim",
    ("optimization/gmmvi.py", "TrainState.key"):
        "the port draws from a torch.Generator or injected StepDraws",
    ("models/gmm.py", "DensityPack.prec_times_diff"):
        "the port always takes the Stein estimator's moment form, which "
        "never builds the [Kmax, N, D] array",
    ("models/gmm.py", "SPMD_ACTIVE"): _SPMD,
    ("models/gmm.py", "SPMD_MESH"): _SPMD,
    ("models/gmm.py", "spmd_scope"): _SPMD,
    ("models/gmm.py", "spmd_data_mesh"): _SPMD,
    ("models/gmm.py", "shard_map_data"): _SPMD,
    ("ops/blocked_linalg.py", "use_fast_tril"): _BLOCKED,
    ("ops/blocked_linalg.py", "blocked_cholesky"): _BLOCKED,
    ("ops/blocked_linalg.py", "fast_tril_inverse"): _BLOCKED,
    ("ops/blocked_linalg.py", "blocked_tril_inverse"): _BLOCKED,
    ("parallel/mesh.py", "batch_sharding"): _SHARDING,
    ("parallel/mesh.py", "replicated"): _SHARDING,
    ("parallel/mesh.py", "initialize_distributed(coordinator_address)"):
        _INIT_DIST,
    ("parallel/mesh.py", "initialize_distributed(num_processes)"):
        _INIT_DIST,
    ("parallel/mesh.py", "initialize_distributed(process_id)"): _INIT_DIST,
    ("configs/__init__.py", "LETTER_TO_PATH"):
        "the port reads no YAML at run time: LETTER_DEFAULTS holds the "
        "letters' defaults, held equal to the YAML files by "
        "tests/test_torch_guards.py",
    ("experiments/targets/bnn.py", "mlp_forward(x_flat_weights)"):
        "the port's first parameter is the [N, P] weights of every sample",
    ("utils/checkpoint.py", "structure_hash(state)"):
        "the port hashes the leaves' specs (paths, shapes, dtypes), which "
        "its checkpoints write, not a JAX pytree",
}


def _params(fn: ast.FunctionDef):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [v.arg for v in (a.vararg, a.kwarg) if v is not None]
    return [n for n in names if n not in ("self", "cls")]


def _is_property(fn: ast.FunctionDef) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               or isinstance(d, ast.Attribute) and d.attr == "setter"
               for d in fn.decorator_list)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _targets(node):
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def jax_surface(rel: str):
    """``[(name, params)]`` of JAX module ``rel``: ``params`` is the list
    of parameter names of a function or method, None for anything else
    (a class, a constant, a field, a property)."""
    tree = ast.parse((JAX_PKG / rel).read_text())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out.append((node.name, _params(node)))
        elif isinstance(node, ast.ClassDef):
            if not _public(node.name):
                continue
            out.append((node.name, None))
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _public(m.name) or m.name == "__init__":
                        out.append((f"{node.name}.{m.name}",
                                    None if _is_property(m)
                                    else _params(m)))
                for t in _targets(m):
                    if _public(t):
                        out.append((f"{node.name}.{t}", None))
        elif "__all__" in _targets(node):
            out += [(e.value, None) for e in node.value.elts]
        else:
            out += [(t, None) for t in _targets(node) if _public(t)]
    return out


def port_module_name(rel: str) -> str:
    parts = ["gmmvi_tpu_torch", *Path(rel).with_suffix("").parts]
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _fields(cls) -> set:
    names = set()
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    names |= set(getattr(cls, "_fields", ()))
    for base in inspect.getmro(cls):
        names |= set(getattr(base, "__annotations__", {}))
    return names


def resolve(module, name: str):
    """(found, object): ``name`` on ``module``, a member through its
    class (a field without a class attribute gives None)."""
    obj = module
    for part in name.split("."):
        if hasattr(obj, part):
            obj = getattr(obj, part)
        elif inspect.isclass(obj) and part in _fields(obj):
            return True, None
        else:
            return False, None
    return True, obj


def _by_design(rel: str, name: str, param=None) -> bool:
    keys = [(rel, name)] if param is None else [
        (rel, f"{name}({param})"), (rel, f"*({param})"), ("*", f"*({param})")]
    return any(k in BY_DESIGN for k in keys)


def surface_gaps(rel: str):
    """The JAX names and parameters of module ``rel`` that the port lacks:
    ``[(name, param or None)]``, by-design entries included."""
    module = importlib.import_module(port_module_name(rel))
    gaps = []
    for name, params in jax_surface(rel):
        found, obj = resolve(module, name)
        if not found:
            gaps.append((name, None))
            continue
        if params is None:
            continue
        fn = obj.__init__ if inspect.isclass(obj) else obj
        try:
            have = set(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            gaps.append((name, "<no signature>"))
            continue
        gaps += [(name, p) for p in params if p not in have]
    return gaps


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_public_surface(rel):
    """Every public name and parameter of JAX module ``rel`` has its
    counterpart in the port or a reasoned entry in BY_DESIGN; a Pallas
    wrapper module's counterparts are the port's kernel wrappers."""
    if rel in PALLAS_MODULES:
        for name in PALLAS_MODULES[rel]:
            assert hasattr(importlib.import_module(name), "cuda"), name
        return
    missing = [f"{name}({p})" if p else name
               for name, p in surface_gaps(rel)
               if not _by_design(rel, name, p)]
    assert not missing, f"{port_module_name(rel)} lacks {missing}"


def test_by_design_entries_are_still_gaps():
    """Every entry of BY_DESIGN names a gap the walk finds (a name or
    parameter that the port does not have), and each reason is one line;
    an entry whose gap was closed must go."""
    found = set()
    for rel in JAX_MODULES:
        if rel in PALLAS_MODULES:
            continue
        for name, p in surface_gaps(rel):
            if p is None:
                found.add((rel, name))
            else:
                found |= {(rel, f"{name}({p})"), (rel, f"*({p})"),
                          ("*", f"*({p})")}
    stale = sorted(set(BY_DESIGN) - found)
    assert not stale, f"by-design entries without a gap: {stale}"
    assert all(r and "\n" not in r for r in BY_DESIGN.values())
    assert set(PALLAS_MODULES) == {m for m in JAX_MODULES
                                   if os.path.basename(m).startswith(
                                       "pallas_")}
