"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (an entry point over a kernel template in a
``csrc/*.cuh``) compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources it was built from, so an
edited kernel never loads a stale build. Builds happen at first use (or up
front through ``build_all``, which starts one ``nvcc`` per source at once)
into ``swarmdb_tpu_torch/_build/`` inside the checkout. Nothing here runs
at import time: the CPU tests import every module on a machine with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("ragged_prefill", "paged_decode_chunked", "paged_decode",
           "ragged_prefill_quant", "paged_decode_chunked_quant",
           "paged_decode_quant", "dense_decode_chunked", "dense_decode")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def _sources(name: str) -> List[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
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
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build_all(names=KERNELS) -> Dict[str, str]:
    """Compile every kernel that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together. Returns each
    source's compiler log (``-Xptxas -v``: registers, shared memory,
    spills); empty for a source that was already built."""
    with _lock:
        procs = {n: _start_build(n) for n in names}
        return {n: _finish_build(n, p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish_build(name, _start_build(name))
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
