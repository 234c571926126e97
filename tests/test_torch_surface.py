"""The port's surface against the JAX package's, by AST: neither package
is imported.

For every module of ``swarmdb_tpu/`` (one case each):

- its counterpart path exists in ``swarmdb_tpu_torch/``;
- every public top-level function and class, and every public method of
  a public class, has its counterpart there (a name the port module
  imports or assigns at top level counts);
- every parameter of a same-named public function, method or
  ``__init__`` is present in the port's;
- every ``SWARMDB_*`` name the module reads (a string constant that is
  the whole name) is read somewhere in the port.

What is not ported sits in ``NOT_PORTED``, each entry with its reason: XLA
or Pallas only, a deliberate difference named in ROADMAP.md's "Not to
port", or a wire-format difference. An entry that no longer names a
difference fails the run, so the list stays exact from change to change.
"""

import ast
import os
import re
from typing import Dict, List, Set, Tuple

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "swarmdb_tpu", "swarmdb_tpu_torch"
ENV_NAME = re.compile(r"SWARMDB_[A-Z0-9_]+")

_XLA = "XLA or Pallas only"
_AXIS = ("a JAX mesh and its axis name; the port takes a "
         "parallel.collectives.Axis of a process group")
_DEVICES = "a list of devices in place of a JAX Mesh"
_SHADOW = ("runs a Pallas kernel body over bounds-checked numpy refs "
           f"({_XLA}); the port's sanitizer checks its CUDA launches' "
           "descriptors, coverage and parity (obs/kerncheck.py checked_*)")
_PRNG = ("a JAX PRNG key; the port takes seed= (the generators differ; "
         "weights cross over through utils/convert.py)")

#: "module", "module::Name" or "module::Name(param)", or an env name ->
#: why the port has no counterpart
NOT_PORTED: Dict[str, str] = {
    # modules
    "ops/attention_pallas.py": ("the eight Pallas kernels; each is a CUDA "
                                "kernel in csrc/ behind "
                                "ops/attention_cuda.py"),
    "utils/compat.py": f"JAX version shims ({_XLA})",
    "utils/xla_cache.py": f"the XLA compile cache ({_XLA})",
    # analysis/kernelcheck.py: Pallas VMEM -> CUDA shared memory
    "analysis/kernelcheck.py::vmem_budget": (
        f"Pallas VMEM ({_XLA}); the port's is smem_budget"),
    "analysis/kernelcheck.py::estimate_vmem": (
        f"Pallas VMEM ({_XLA}); the port's is estimate_smem"),
    "analysis/kernelcheck.py::static_vmem_table": (
        f"symbolic VMEM footprints of pallas_call sites ({_XLA}); the "
        "port's launch layouts are smem_layout"),
    "analysis/kernelcheck.py::eval_with_dims": (
        f"evaluates static_vmem_table's expressions ({_XLA})"),
    # backend/engine.py
    "backend/engine.py::Engine.place_state": (
        f"places engine state on a jax Mesh ({_XLA})"),
    "backend/engine.py::Engine.warmup_call_plan": (
        f"plans the XLA compiles of warmup ({_XLA})"),
    "backend/engine.py::Engine.precompile": (
        f"AOT-compiles the XLA variants ({_XLA})"),
    "backend/engine.py::Engine.__init__(donate_cache)": (
        f"XLA buffer donation ({_XLA})"),
    "backend/engine.py::Engine.__init__(forward_last_fn)": (
        "deliberate difference: the port's forward(..., logits_at=) does "
        "its job"),
    # models
    "models/llama.py::param_specs": f"PartitionSpecs ({_XLA})",
    "models/llama.py::param_specs_pp": f"PartitionSpecs ({_XLA})",
    "models/llama.py::cache_specs": f"PartitionSpecs ({_XLA})",
    "models/llama.py::init_params(key)": _PRNG,
    "models/llama.py::forward_pipelined(mesh)": _AXIS,
    "models/llama.py::forward_pipelined(pipe_axis)": _AXIS,
    "models/llama.py::forward_seq_parallel(mesh)": _AXIS,
    "models/llama.py::forward_seq_parallel(seq_axis)": _AXIS,
    "models/mixtral.py::param_specs": f"PartitionSpecs ({_XLA})",
    "models/mixtral.py::init_params(key)": _PRNG,
    # obs/kerncheck.py
    "obs/kerncheck.py::ShadowRef": _SHADOW,
    "obs/kerncheck.py::ShadowRef.shape": _SHADOW,
    "obs/kerncheck.py::ShadowRef.dtype": _SHADOW,
    "obs/kerncheck.py::shadow_ragged_prefill": _SHADOW,
    "obs/kerncheck.py::shadow_paged_decode": _SHADOW,
    "obs/kerncheck.py::shadow_paged_write_ragged": _SHADOW,
    # ops
    "ops/layers.py::pallas_disabled": (
        f"switches the Pallas kernels off ({_XLA}); the port always runs "
        "its kernels on the card"),
    "ops/layers.py::decode_kernel_choice": (
        f"the Pallas/XLA crossover ({_XLA})"),
    "ops/layers.py::prefill_kernel_choice": (
        f"the Pallas/XLA crossover ({_XLA})"),
    "ops/layers.py::paged_attention_dispatch_chunked(q_positions)": (
        "kernel interface: the CUDA kernel takes each slot's chunk start "
        "(position - step)"),
    "ops/layers.py::ragged_prefill_dispatch(tok_row)": (
        "kernel interface: the CUDA kernel finds each token's row from "
        "starts and lens"),
    "ops/paged_kv.py::pool_flat": (
        f"the flat (L*P) page view that lax.scan's gathers address "
        f"({_XLA}); the port's forwards slice each layer (pool_layer)"),
    "ops/paged_kv.py::PageAllocator.flush_frees": (
        "nothing calls it: both engines drain with take_pending_frees "
        "and release_taken"),
    "ops/ring_attention.py::ring_attention(axis_name)": _AXIS,
    # parallel
    "parallel/lanes.py::build_lane_group(mesh)": _DEVICES,
    "parallel/serving.py::build_serving_engine(mesh)": _DEVICES,
    "parallel/mesh.py::make_mesh(n_devices)": (
        "the port's mesh is over a process group's ranks; device= names "
        "this rank's"),
    "parallel/mesh.py::make_mesh(devices)": (
        "the port's mesh is over a process group's ranks; device= names "
        "this rank's"),
    "parallel/mesh.py::named": f"NamedSharding helper ({_XLA})",
    "parallel/mesh.py::replicated": f"NamedSharding helper ({_XLA})",
    "parallel/mesh.py::tree_shardings": f"NamedSharding helper ({_XLA})",
    "parallel/mesh.py::shard_pytree": (
        f"device_put over NamedShardings ({_XLA}); the port's is "
        "shard_params"),
    "parallel/multihost.py::ControlPlane.__init__(prefill_batch)": (
        "wire-format difference: the port's calls carry self-describing "
        "payloads, so the plane needs no fixed wave rows"),
    # env names
    "SWARMDB_PALLAS": f"turns the Pallas kernels on or off ({_XLA})",
    "SWARMDB_PALLAS_KV_SPAN": f"the Pallas/XLA decode crossover ({_XLA})",
    "SWARMDB_PALLAS_MIN_SEQ": f"the Pallas/XLA prefill crossover ({_XLA})",
    "SWARMDB_VMEM_BYTES": f"the Pallas VMEM budget ({_XLA})",
    "SWARMDB_COMPILE_CACHE": f"the XLA compile cache ({_XLA})",
    "SWARMDB_WARMUP_PARALLEL": f"parallel XLA warmup compiles ({_XLA})",
    "SWARMDB_MERGE": (
        "picks the einsum or the scatter chunk merge; the port has one "
        "(deliberate difference, backend/service.py build_backend_engine)"),
}


def _modules(pkg: str) -> Dict[str, str]:
    """{path relative to the package: file} of every module."""
    base = os.path.join(ROOT, pkg)
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                out[os.path.relpath(p, base).replace(os.sep, "/")] = p
    return out


def _params(fn: ast.AST) -> List[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def surface(source: str) -> Tuple[Set[str], Dict[str, List[str]],
                                  Set[str], Set[str]]:
    """(public names, {function or Class.method: parameters}, names
    present at all, SWARMDB_* names read) of one module's source.
    Public: top-level functions and classes, and the methods of public
    classes, whose names do not start with "_"; ``__init__``'s
    parameters count too. Present: every def, class and method, and the
    names imported or assigned at top level or in a class body."""
    tree = ast.parse(source)
    public: Set[str] = set()
    params: Dict[str, List[str]] = {}
    present: Set[str] = set()
    fns = (ast.FunctionDef, ast.AsyncFunctionDef)

    def assigned(node: ast.AST) -> List[str]:
        if isinstance(node, ast.Assign):
            return [t.id for t in node.targets if isinstance(t, ast.Name)]
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            return [node.target.id]
        if isinstance(node, ast.ImportFrom):
            return [a.asname or a.name for a in node.names]
        return []

    for node in tree.body:
        present.update(assigned(node))
        if isinstance(node, fns):
            present.add(node.name)
            if not node.name.startswith("_"):
                public.add(node.name)
                params[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            present.add(node.name)
            pub = not node.name.startswith("_")
            if pub:
                public.add(node.name)
            for b in node.body:
                present.update(f"{node.name}.{n}" for n in assigned(b))
                if not isinstance(b, fns):
                    continue
                key = f"{node.name}.{b.name}"
                present.add(key)
                if pub and (not b.name.startswith("_")
                            or b.name == "__init__"):
                    params[key] = _params(b)
                    if b.name != "__init__":
                        public.add(key)
    env = {n.value for n in ast.walk(tree)
           if isinstance(n, ast.Constant) and isinstance(n.value, str)
           and ENV_NAME.fullmatch(n.value)}
    return public, params, present, env


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


JAX_MODULES = _modules(JAX_PKG)
PORT_MODULES = _modules(PORT_PKG)
PORT_ENV: Set[str] = set().union(*(surface(_read(p))[3]
                                   for p in PORT_MODULES.values()))


def differences(module: str) -> List[str]:
    """What the port lacks of JAX module ``module``, as ``NOT_PORTED``
    keys."""
    jpub, jparams, _, jenv = surface(_read(JAX_MODULES[module]))
    out = sorted(e for e in jenv if e not in PORT_ENV)
    if module not in PORT_MODULES:
        return [module] + out
    _, tparams, tpresent, _ = surface(_read(PORT_MODULES[module]))
    out += [f"{module}::{n}" for n in sorted(jpub) if n not in tpresent]
    for name, ps in sorted(jparams.items()):
        if name in tparams:
            out += [f"{module}::{name}({p})" for p in ps
                    if p not in tparams[name]]
    return out


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_module_is_ported(module):
    """Every difference of this module is listed, with a reason."""
    unlisted = [d for d in differences(module) if d not in NOT_PORTED]
    assert not unlisted, (
        f"swarmdb_tpu/{module}: not in the port and not in NOT_PORTED: "
        f"{unlisted}")


def test_every_allowlist_entry_names_a_difference():
    """An entry whose difference is gone (ported since) is taken out, so
    the list says exactly what the port does not do; every entry has a
    reason."""
    found = set()
    for module in JAX_MODULES:
        found.update(differences(module))
    stale = sorted(set(NOT_PORTED) - found)
    assert not stale, f"NOT_PORTED entries the port no longer lacks: {stale}"
    assert all(r.strip() for r in NOT_PORTED.values())


def test_the_scan_sees_both_packages():
    """The scan reads what it should: the engines' keywords and knobs on
    both sides, and a name, a parameter and an env name dropped from a
    module show up as differences."""
    assert len(JAX_MODULES) > 80 and "backend/engine.py" in PORT_MODULES
    for pkg in (JAX_MODULES, PORT_MODULES):
        pub, params, _, env = surface(_read(pkg["backend/engine.py"]))
        assert "Engine.generate_sync" in pub
        assert "aging_s" in params["Engine.__init__"]
        assert {"SWARMDB_AGING_S", "SWARMDB_PREFILL_ROWS"} <= env
    assert "ServingChaos.run_script" in surface(
        _read(PORT_MODULES["backend/chaos.py"]))[0]
    src = ("import os\n"
           "class A:\n"
           "    def __init__(self, x, y=1): pass\n"
           "    def go(self): return os.environ.get('SWARMDB_Q')\n"
           "def f(a, *, b=2): pass\n")
    pub, params, present, env = surface(src)
    assert pub == {"A", "A.go", "f"} and env == {"SWARMDB_Q"}
    assert params == {"A.__init__": ["x", "y"], "A.go": [], "f": ["a", "b"]}
    _, tparams, tpresent, _ = surface(
        "class A:\n    def __init__(self, x): pass\ndef f(a, b): pass\n")
    assert [n for n in pub if n not in tpresent] == ["A.go"]
    assert [p for p in params["A.__init__"]
            if p not in tparams["A.__init__"]] == ["y"]
