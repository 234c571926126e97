"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (an entry point over a kernel template in a
``csrc/*.cuh``) compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

Every library has a second, bounds-checked variant: the same source and
flags plus ``-DSWARM_KERNCHECK`` (``csrc/attn_common.cuh``), built into
``_build/lib<name>-kc-<hash>.so``. The kernel sanitizer
(``SWARMDB_KERNCHECK=1``) launches it; see ``ops/attention_cuda.py``.

The library name carries a hash of the sources and flags it was built
from, so an edited kernel never loads a stale build. Each build's
``-Xptxas -v`` log is kept beside its library (``lib<name>-<hash>.log``)
and ``ptxas_info`` parses it: registers, spill stores and loads, stack and
static shared memory of every kernel instance (the shared-memory view's
compile-time half; ``analysis/kernelcheck.py`` mirrors the dynamic half). Builds happen at
first use (or up front through ``build_all``, which starts one ``nvcc``
per source and variant at once, or ``start_all``, which leaves them
running) into ``swarmdb_tpu_torch/_build/`` inside
the checkout. Nothing here runs at import time: the CPU tests import
every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.sync import make_lock

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("ragged_prefill", "paged_decode_chunked", "paged_decode",
           "ragged_prefill_quant", "paged_decode_chunked_quant",
           "paged_decode_quant", "dense_decode_chunked", "dense_decode")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = make_lock("ops.build._lock")
_libs: Dict[Tuple[str, bool], ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


#: the bounds-checked variant's extra flag
CHECKED_FLAGS = ["-DSWARM_KERNCHECK"]


def _sources(name: str) -> List[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _flags(checked: bool) -> List[str]:
    return NVCC_FLAGS + (CHECKED_FLAGS if checked else [])


def library_path(name: str, checked: bool = False) -> Path:
    h = hashlib.sha256(" ".join(_flags(checked)).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    kind = "-kc" if checked else ""
    return BUILD_DIR / f"lib{name}{kind}-{h.hexdigest()[:12]}.so"


def _start_build(name: str, checked: bool) -> Optional[subprocess.Popen]:
    out = library_path(name, checked)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(checked), "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.swarm_paths = (tmp, out)  # type: ignore[attr-defined]
    return proc


def _finish_build(name: str, proc: Optional[subprocess.Popen]) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp, out = proc.swarm_paths  # type: ignore[attr-defined]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name} ({name}.cu):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def _kerncheck_enabled() -> bool:
    return os.environ.get("SWARMDB_KERNCHECK", "0") not in ("", "0")


def build_all(names=KERNELS, checked: Optional[bool] = None
              ) -> Dict[str, str]:
    """Compile every kernel that has no up-to-date library yet, one
    ``nvcc`` process per source and variant, all started together: the
    plain variants, and the bounds-checked ones too when ``checked`` (by
    default: when ``SWARMDB_KERNCHECK`` is on). Returns each build's
    compiler log (``-Xptxas -v``: registers, shared memory, spills) under
    the kernel's name (``<name>-kc`` for a checked one); empty for one
    that was already built."""
    if checked is None:
        checked = _kerncheck_enabled()
    variants = (False, True) if checked else (False,)
    with _lock:
        waits = [start_all(names, c) for c in variants]
        return {k: log for wait in waits for k, log in wait().items()}


def start_all(names=KERNELS, checked: bool = False
              ) -> Callable[[], Dict[str, str]]:
    """Start ``build_all``'s ``nvcc`` processes for one variant and return
    without waiting: the returned function waits for them and returns
    their logs as ``build_all`` does. Nothing may load these libraries
    before it has returned."""
    procs = {n: _start_build(n, checked) for n in names}
    suffix = "-kc" if checked else ""
    return lambda: {n + suffix: _finish_build(n, p) for n, p in procs.items()}


def load(name: str, checked: bool = False) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name`` (its bounds-checked
    variant when ``checked``), built if needed."""
    key = (name, checked)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        if key not in _libs:
            _finish_build(name, _start_build(name, checked))
            _libs[key] = ctypes.CDLL(str(library_path(name, checked)))
        return _libs[key]


# ------------------------------------------------------- the ptxas view

_ENTRY_RE = re.compile(r"Compiling entry function '(\w+)'")
_FRAME_RE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads")
_USED_RE = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
#: Itanium codes of the template arguments the kernels take
_TYPE_CODES = {"f": "float", "a": "int8", "b": "bool", "i": "int"}


def _template_args(s: str) -> List[str]:
    """Arguments of a mangled ``I...E`` template list: types (float,
    int8, bf16) and integer / bool literals, as the kernels use them."""
    args, i = [], 0
    while i < len(s) and s[i] != "E":
        if s[i] == "L":  # literal: L<type><value>E
            j = s.index("E", i)
            val = s[i + 2:j]
            args.append({"b": ("true" if val == "1" else "false")}.get(
                s[i + 1], val.replace("n", "-")))
            i = j + 1
        elif s[i].isdigit():  # a named type: <len><name>
            m = re.match(r"\d+", s[i:])
            n = int(m.group(0))
            name = s[i + len(m.group(0)):i + len(m.group(0)) + n]
            args.append("bf16" if name == "__nv_bfloat16" else name)
            i += len(m.group(0)) + n
        else:
            args.append(_TYPE_CODES.get(s[i], s[i]))
            i += 1
    return args


def demangle(symbol: str) -> str:
    """``swarm::<kernel><args>`` of a kernel instance's mangled name as
    ``kernel<arg, ...>`` (e.g. ``ragged_prefill_mma_kernel<bf16, 128, 2>``);
    the symbol itself when it is not one of ours."""
    m = re.match(r"_ZN5swarm(\d+)", symbol)
    if m is None:
        return symbol
    start = m.end()
    name = symbol[start:start + int(m.group(1))]
    rest = symbol[start + int(m.group(1)):]
    if rest.startswith("I"):
        return f"{name}<{', '.join(_template_args(rest[1:]))}>"
    return name


def parse_ptxas(log: str) -> List[Dict[str, Any]]:
    """Every kernel instance of a ``-Xptxas -v`` log: ``instance``
    (demangled), ``symbol``, ``regs``, ``spill_stores`` / ``spill_loads``
    (bytes per thread), ``stack`` (bytes) and ``smem_static`` (bytes)."""
    out: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = None
    for line in log.splitlines():
        m = _ENTRY_RE.search(line)
        if m:
            cur = {"symbol": m.group(1), "instance": demangle(m.group(1)),
                   "regs": 0, "spill_stores": 0, "spill_loads": 0,
                   "stack": 0, "smem_static": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _FRAME_RE.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
            continue
        m = _USED_RE.search(line)
        if m:
            cur["regs"] = int(m.group(1))
            cur["smem_static"] = int(m.group(2) or 0)
    return out


def ptxas_info(name: str, checked: bool = False) -> List[Dict[str, Any]]:
    """The parsed ``-Xptxas -v`` log of kernel library ``name`` (its
    bounds-checked variant when ``checked``), kept beside the library at
    its build; empty when the library has not been built here."""
    try:
        log = library_path(name, checked).with_suffix(".log").read_text()
    except OSError:
        return []
    return parse_ptxas(log)


#: the kernels' page type template argument, by torch dtype name
PAGE_TYPES = {"float32": "float", "bfloat16": "bf16", "int8": "int8"}


def ptxas_instances(name: str, page: str, head_dim: int
                    ) -> List[Dict[str, Any]]:
    """The instances of library ``name`` over pages of ``page`` (a
    ``PAGE_TYPES`` value) at head dim ``head_dim``: their template
    arguments lead with the page type and the head dim (``<bf16, 128,
    2>``)."""
    want = [page, str(head_dim)]
    return [r for r in ptxas_info(name)
            if r["instance"].partition("<")[2].rstrip(">").split(", ")[:2]
            == want]
