"""kernel-check (SWL903): the CUDA kernels' shared memory per block.

The JAX family (``swarmdb_tpu/analysis/kernelcheck.py``, SWL901-905)
parses every ``pl.pallas_call`` and evaluates its index maps and VMEM
footprint. The port's kernels are CUDA C++ (``swarmdb_tpu_torch/csrc``),
which this stdlib-only analyzer does not parse, so:

- SWL901 (out-of-bounds block), SWL902 (grid write race), SWL904 (TPU
  tiling) and SWL905 (unwritten output) have no counterpart here. Their
  runtime halves are the bounds-checked build and the output canaries of
  the kernel sanitizer (``SWARMDB_KERNCHECK=1``, ``obs/kerncheck.py``).
- SWL903 becomes shared memory per block. A block's dynamic shared
  memory is sized on the host at each launch from the launch's dims, by
  three layouts that this module mirrors in Python:

  * ``DecodeLayout::bytes()`` (``csrc/decode.cuh``), the six decode entry
    points: two stages of 32 K and V rows at a row stride of the widest
    row (page or chunk element) plus 16 bytes, the query and accumulator
    (G x D fp32), the page walk, the int8 scales, the probabilities
    (G x 32 fp32) and the softmax statistics (3 x G fp32);
  * ``MmaSmem<D, NG>::bytes`` (``csrc/ragged_prefill_mma.cuh``), the
    tensor-core prefill (bf16 query and suffix): a 64-row Q tile, per
    group of 128 threads two stages of 64 K and V rows padded to D + 8
    bf16, their scales and the page walk, plus the static ``pick[2]``
    (16 bytes as compiled);
    NG is 2 when the wave's query tiles x KV heads fit one block per
    SM, else 1;
  * the fp32 prefill body's ``2 * kPrefillKT * D * 4`` bytes
    (``csrc/ragged_prefill.cuh``), any float32 operand.

  :func:`estimate_smem` evaluates them at concrete dims; the check runs
  every ``ModelConfig(...)`` of a scanned file (the registry,
  ``models/configs.py``) through every kernel at the dtypes the engines
  launch, and reports a kernel over the H100's opt-in limit per block
  (:func:`smem_budget`). ``chip_smoke.py`` holds each mirror against the
  value the library itself computes for the launch.

The profiler reports the estimate under the JAX package's keys
(``vmem_est_bytes``, ``vmem_budget_bytes``, ``vmem_utilization``); on
the card they mean shared memory per block against the opt-in limit.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional, Tuple

from .core import Finding, SourceFile, dotted_name, make_finding

# ------------------------------------------------------------- budgets

#: the card's opt-in shared memory per block
#: (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), by device kind
#: substring: 227 KiB on Hopper, 163 KiB on the A100
PLATFORM_SMEM_BYTES: Tuple[Tuple[str, int], ...] = (
    ("h100", 232_448),
    ("h200", 232_448),
    ("h800", 232_448),
    ("gh200", 232_448),
    ("a100", 166_912),
)
H100_SMEM_BYTES = 232_448
#: what every CUDA device grants a block without opting in
DEFAULT_SMEM_BYTES = 49_152

#: the JAX package's VMEM budgets per TPU core, kept so that a profile
#: dump of either package reads with a budget here
PLATFORM_VMEM_BYTES: Tuple[Tuple[str, int], ...] = (
    ("v6", 32 * 2 ** 20),
    ("v5p", 16 * 2 ** 20),
    ("v5e", 16 * 2 ** 20),
    ("v5", 16 * 2 ** 20),
    ("v4", 16 * 2 ** 20),
    ("v3", 16 * 2 ** 20),
    ("v2", 16 * 2 ** 20),
)
DEFAULT_VMEM_BYTES = 16 * 2 ** 20


def smem_budget(device_kind: str = "", device: Any = None) -> int:
    """On-chip memory budget per block, in bytes.

    With ``device`` (a CUDA device or its index) the card is asked: its
    opt-in limit per block, from PyTorch's device properties where the
    installed build has ``shared_memory_per_block_optin``, else from the
    kernel libraries' own query (``ops.attention_cuda.smem_info``).
    Without, ``device_kind`` is looked up: the table above by lowercase
    substring (spaces removed); another NVIDIA kind gets the 48 KiB every
    CUDA block gets; anything else (a TPU, or no kind at all) is read as
    the JAX package reads it (``vmem_budget``: its VMEM table, 16 MiB by
    default), so both packages' analyzers give a dump the same budget
    unless it names a card."""
    if device is not None:
        import torch

        props = torch.cuda.get_device_properties(device)
        optin = getattr(props, "shared_memory_per_block_optin", None)
        if optin:
            return int(optin)
        from ..ops.attention_cuda import smem_info

        return int(smem_info("paged_decode", {"Hq": 8, "Hkv": 8, "D": 128},
                             device=device)["optin"])
    kind = (device_kind or "").lower().replace(" ", "")
    for sub, budget in PLATFORM_SMEM_BYTES:
        if sub in kind:
            return budget
    if "nvidia" in kind:
        return DEFAULT_SMEM_BYTES
    kind = kind.replace("tpu", "")
    for sub, budget in PLATFORM_VMEM_BYTES:
        if sub in kind:
            return budget
    return DEFAULT_VMEM_BYTES


# ------------------------------------------------------------- mirrors

DTYPE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}

# csrc/decode.cuh
DECODE_KT = 32
DECODE_STAGES = 2
# csrc/ragged_prefill_mma.cuh
MMA_ROWS = 64
MMA_KT = 64
#: static shared memory: ``__shared__ int pick[2]`` (8 bytes) rounded up
#: to the 16-byte alignment of the dynamic region behind it (ptxas and
#: cudaFuncGetAttributes on the H100 both say 16)
MMA_STATIC = 16
# csrc/ragged_prefill.cuh
PREFILL_KT = 32
PREFILL_Q_ROWS = 64

#: entry points (ops/build.py KERNELS) -> (body, chunked, int8 pages)
KERNEL_BODIES: Dict[str, Tuple[str, bool, bool]] = {
    "ragged_prefill": ("prefill", False, False),
    "ragged_prefill_quant": ("prefill", False, True),
    "paged_decode_chunked": ("decode", True, False),
    "paged_decode_chunked_quant": ("decode", True, True),
    "paged_decode": ("decode", False, False),
    "paged_decode_quant": ("decode", False, True),
    "dense_decode_chunked": ("decode", True, False),
    "dense_decode": ("decode", False, False),
}
HEAD_DIMS = (16, 32, 64, 128)


def decode_layout_bytes(G: int, D: int, page_bytes: int,
                        chunk_bytes: int = 0) -> int:
    """``DecodeLayout{rs, G, D}.bytes()``, with ``rs`` =
    ``decode_row_stride(D * page_bytes, D * chunk_bytes)``."""
    rs = max(D * page_bytes, D * chunk_bytes) + 16
    stages = DECODE_STAGES * 2 * DECODE_KT * rs
    q_acc = 2 * G * D * 4
    rows = (DECODE_STAGES + 1) * DECODE_KT * 8
    scales = (DECODE_STAGES + 1) * 2 * DECODE_KT * 4
    p = G * DECODE_KT * 4
    stats = 3 * G * 4
    return stages + q_acc + rows + scales + p + stats


def mma_smem_bytes(D: int, NG: int) -> int:
    """``MmaSmem<D, NG>::bytes`` (dynamic only)."""
    DS = D + 8
    tile = MMA_KT * DS * 2
    q = MMA_ROWS * DS * 2
    kv = NG * 2 * 2 * tile
    sc = NG * 2 * 2 * MMA_KT * 4
    walk = NG * 2 * 2 * MMA_KT * 4
    return q + kv + sc + walk


def mma_groups(tiles: Optional[int], sms: Optional[int]) -> int:
    """NG the launch picks: 2 when the wave's query tiles x KV heads
    (``tiles``) fit one block per SM, else 1; 2 when either is unknown
    (the larger footprint)."""
    if tiles is None or sms is None:
        return 2
    return 2 if tiles <= sms else 1


def smem_layout(kernel: str, dims: Dict[str, Any]) -> Optional[
        Tuple[int, int]]:
    """(dynamic, static) shared memory bytes per block of entry point
    ``kernel`` launched at ``dims``: ``Hq``, ``Hkv``, ``D``; ``page`` /
    ``q`` / ``chunk`` / ``suffix`` dtype codes (``"f32"``, ``"bf16"``,
    ``"int8"``; defaults bf16, pages int8 for a quant kernel); for the
    prefill, the wave width ``W`` and the device's SM count ``sms``. None
    for an unknown kernel, a head dim the kernels do not take, or a
    G = Hq / Hkv they refuse."""
    body = KERNEL_BODIES.get(kernel)
    try:
        Hq, Hkv, D = int(dims["Hq"]), int(dims["Hkv"]), int(dims["D"])
    except (KeyError, TypeError, ValueError):
        return None
    if body is None or Hkv <= 0 or Hq % Hkv or D not in HEAD_DIMS:
        return None
    kind, chunked, quant = body
    G = Hq // Hkv
    page = "int8" if quant else dims.get("page", "bf16")
    q = dims.get("q", "bf16")
    if page not in DTYPE_BYTES or q not in DTYPE_BYTES:
        return None
    if kind == "decode":
        chunk = dims.get("chunk", "bf16") if chunked else None
        cb = DTYPE_BYTES.get(chunk, 0) if chunk else 0
        return decode_layout_bytes(G, D, DTYPE_BYTES[page], cb), 0
    suffix = dims.get("suffix", q)
    if q == "bf16" and suffix == "bf16" and page in ("bf16", "int8"):
        if G > MMA_ROWS:
            return None
        QT = MMA_ROWS // G
        W = dims.get("W")
        tiles = None if W is None else -(-int(W) // QT) * Hkv
        NG = mma_groups(tiles, dims.get("sms"))
        return mma_smem_bytes(D, NG), MMA_STATIC
    if G > PREFILL_Q_ROWS:
        return None
    return 2 * PREFILL_KT * D * 4, 0


def estimate_smem(kernel: str, dims: Dict[str, Any]) -> Optional[int]:
    """Shared memory per block (dynamic + static, bytes) of entry point
    ``kernel`` at ``dims`` (see :func:`smem_layout`); None when there is
    no estimate — callers treat that as 'no estimate', never an error."""
    lay = smem_layout(kernel, dims)
    return None if lay is None else lay[0] + lay[1]


def launch_dtypes(kernel: str) -> List[Dict[str, str]]:
    """The dtype codes the engines launch ``kernel`` with: f32 or bf16
    query and pages (int8 pages for a quant kernel), the chunk buffer in
    bf16 (the engines' default) or f32 (exact-token tests), the suffix in
    the query's type."""
    _kind, chunked, quant = KERNEL_BODIES[kernel]
    out = []
    for q in ("bf16", "f32"):
        for page in (("int8",) if quant else ("bf16", "f32")):
            for chunk in (("bf16", "f32") if chunked else (None,)):
                d = {"q": q, "page": page, "suffix": q}
                if chunk:
                    d["chunk"] = chunk
                out.append(d)
    return out


# -------------------------------------------------------------- SWL903

def _config_dims(call: ast.Call) -> Optional[Dict[str, Any]]:
    kw = {k.arg: k.value for k in call.keywords if k.arg}
    vals = {}
    for key in ("dim", "n_heads", "n_kv_heads"):
        node = kw.get(key)
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, int)):
            return None
        vals[key] = node.value
    name = kw.get("name")
    label = (name.value if isinstance(name, ast.Constant) else "?")
    return {"name": label, "Hq": vals["n_heads"], "Hkv": vals["n_kv_heads"],
            "D": vals["dim"] // vals["n_heads"]}


def check(src: SourceFile) -> List[Finding]:
    if "ModelConfig(" not in src.text:
        return []
    findings: List[Finding] = []
    budget = H100_SMEM_BYTES
    for node in ast.walk(src.tree):
        if not (isinstance(node, ast.Call)
                and (dotted_name(node.func) or "").split(".")[-1]
                == "ModelConfig"):
            continue
        cfg = _config_dims(node)
        if cfg is None:
            continue
        for kernel in KERNEL_BODIES:
            worst, at = 0, None
            for dt in launch_dtypes(kernel):
                est = estimate_smem(kernel, dict(cfg, **dt))
                if est is not None and est > worst:
                    worst, at = est, dt
            if at is not None and worst > budget:
                findings.append(make_finding(
                    src, "SWL903", node,
                    f"`{kernel}` needs {worst} bytes of shared memory per "
                    f"block for `{cfg['name']}` (Hq {cfg['Hq']}, Hkv "
                    f"{cfg['Hkv']}, D {cfg['D']}, {at}) — over the "
                    f"H100's opt-in limit of {budget}: the launch is "
                    f"refused"))
    return findings
