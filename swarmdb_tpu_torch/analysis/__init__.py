"""swarmlint for the PyTorch/CUDA package: the port's own copy of the JAX
package's static analyzer (``swarmdb_tpu/analysis/``), taught the card.

The families, with what changed against the JAX package's:

- **host-sync** (SWL101/102/105, hostsync.py): host round trips inside
  functions annotated ``# swarmlint: hot``, with the card's syncs
  (``torch.cuda.synchronize``, ``Event`` / ``Stream.synchronize``, an
  ``Event.query()`` polled in a loop) and materializations (``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``np.asarray`` / ``int`` / ``float`` / ``bool`` / ``if`` on a CUDA
  tensor).
- **graph-capture** (SWL201-205, recompile.py): the card's counterpart of
  the recompile hazards — graphs captured per call, graph runners a
  warmup does not capture, len()-shaped buffers inside a capture; SWL202
  and SWL205 are void on the card (the module says why).
- **lock-discipline** (SWL301 locks.py; SWL302-305 lockorder.py), as in
  the JAX package. The runtime twin is ``SWARMDB_LOCKCHECK=1``
  (``obs/lockcheck.py``).
- **capture-leak** (SWL401, tracers.py): tensors made inside a CUDA graph
  capture stored on ``self`` / a global / a nonlocal, and rebindings of
  attributes a capture reads.
- **span-discipline**, **heartbeat-safety**, **retry-discipline** and
  **page-lifetime** (spans.py, heartbeat.py, retry.py, pagelife.py), as
  in the JAX package (pagelife binds a ``**`` splat to no parameter).
- **kernel-check** (SWL903, kernelcheck.py): the CUDA kernels' shared
  memory per block, mirrored from the C++ layouts (``estimate_smem``),
  against the card's opt-in limit (``smem_budget``); SWL901/902/904/905
  parse ``pl.pallas_call`` and have no CUDA counterpart.

Run it::

    python -m swarmdb_tpu_torch.analysis

(the package, against ``swarmdb_tpu_torch/analysis/baseline.json``, from
any working directory). Findings are suppressible inline
(``# swarmlint: disable=SWL101 -- why``) and diffed against the baseline
so that only NEW findings fail. See core.py for the directive grammar.
"""

from .core import (Finding, RULES, analyze_file, analyze_paths,
                   iter_py_files, load_baseline, write_baseline)
from .cli import main

__all__ = [
    "Finding",
    "RULES",
    "analyze_file",
    "analyze_paths",
    "iter_py_files",
    "load_baseline",
    "write_baseline",
    "main",
]
