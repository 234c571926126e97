"""The kernels' shared-memory view: the port's counterpart of the JAX
package's static VMEM estimate (``analysis/kernelcheck.py``,
``ops/layers._record_static_vmem``, ``obs/analyze.py --roofline``).

- ``estimate_smem`` mirrors the C++ layouts (``DecodeLayout::bytes()``,
  ``MmaSmem<D, NG>::bytes`` plus its static bytes, the fp32 prefill's two
  KT x D tiles); here it is held against values worked out by hand from
  the C++ formulas at Llama-3-8B, Mixtral-8x7B and tiny-debug dims (on
  the card, ``chip_smoke.py``'s smem step holds it against the
  libraries' own numbers).
- SWL903 runs every registry config through every kernel at the dtypes
  the engines launch against the H100's limit.
- ``smem_budget`` reads a dump's device kind as the JAX package's
  ``vmem_budget`` does, except for a card.
- The roofline report's on-chip memory column from a port dump, read by
  both packages' analyzers.
- The dispatchers record nothing off the card; estimates made during a
  graph capture wait for the capture's end; the build log is parsed.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

from swarmdb_tpu.analysis.kernelcheck import vmem_budget
from swarmdb_tpu.obs import analyze as janalyze
from swarmdb_tpu_torch.analysis import analyze_file
from swarmdb_tpu_torch.analysis.kernelcheck import (H100_SMEM_BYTES,
                                                    KERNEL_BODIES,
                                                    estimate_smem,
                                                    launch_dtypes,
                                                    smem_budget,
                                                    smem_layout)
from swarmdb_tpu_torch.models.configs import REGISTRY, get_config
from swarmdb_tpu_torch.obs import analyze as tanalyze

# the module (the package's ``profiler`` name is its accessor function)
tprofiler = importlib.import_module("swarmdb_tpu_torch.obs.profiler")
ROOT = Path(__file__).resolve().parent.parent


def dims_of(name: str, **dt):
    cfg = get_config(name)
    return dict(Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, D=cfg.head_dim, **dt)


# Worked by hand from the C++:
# decode (csrc/decode.cuh), G = Hq / Hkv, KT 32, 2 stages:
#   rs = max(D * page bytes, D * chunk bytes) + 16
#   2 * 2 * 32 * rs + 2 * G * D * 4 + 3 * 32 * 8 + 3 * 2 * 32 * 4
#   + G * 32 * 4 + 3 * G * 4
# Llama-3-8B / Mixtral-8x7B (G 4, D 128):
#   bf16 pages, bf16 chunk: rs 272 -> 34816 + 4096 + 768 + 768 + 512 + 48
#   f32 pages (or f32 chunk): rs 528 -> 67584 + ... = 73776
#   int8 pages, single step: rs 144 -> 18432 + ... = 24624
# the tensor-core prefill (csrc/ragged_prefill_mma.cuh), DS = D + 8:
#   64 * DS * 2 + NG * 4 * 64 * DS * 2 + NG * 2 * 2 * 64 * 4 * 2, + 16
#   D 128, NG 2: 17408 + 139264 + 4096 = 160768 (+16 = 160784)
#   D 128, NG 1: 17408 + 69632 + 2048 = 89088 (+16 = 89104)
#   D 16, NG 2: 3072 + 24576 + 4096 = 31744 (+16 = 31760)
# the fp32 prefill (csrc/ragged_prefill.cuh): 2 * 32 * D * 4
# tiny-debug (G 2, D 16), bf16: rs 48 -> 6144 + 256 + 768 + 768 + 256 + 24
HAND = [
    ("llama3-8b", "paged_decode_chunked", {}, 41008),
    ("llama3-8b", "paged_decode_chunked", {"chunk": "f32"}, 73776),
    ("llama3-8b", "paged_decode", {"page": "f32"}, 73776),
    ("llama3-8b", "paged_decode_quant", {}, 24624),
    ("llama3-8b", "paged_decode_chunked_quant", {}, 41008),
    ("llama3-8b", "dense_decode_chunked", {}, 41008),
    ("llama3-8b", "dense_decode", {"page": "f32", "q": "f32"}, 73776),
    ("llama3-8b", "ragged_prefill", {"W": 64, "sms": 132}, 160784),
    ("llama3-8b", "ragged_prefill", {"W": 4096, "sms": 132}, 89104),
    ("llama3-8b", "ragged_prefill_quant", {"W": 64, "sms": 132}, 160784),
    ("llama3-8b", "ragged_prefill", {"q": "f32", "suffix": "f32"}, 32768),
    ("llama3-8b", "ragged_prefill", {"page": "f32"}, 32768),
    ("mixtral-8x7b", "paged_decode_chunked", {}, 41008),
    ("mixtral-8x7b", "dense_decode_chunked", {}, 41008),
    ("mixtral-8x7b", "ragged_prefill", {"W": 8, "sms": 132}, 160784),
    ("tiny-debug", "paged_decode_chunked", {}, 8216),
    ("tiny-debug", "ragged_prefill", {}, 31760),
    ("tiny-debug", "ragged_prefill_quant", {"q": "f32"}, 4096),
]


@pytest.mark.parametrize("model,kernel,dt,want", HAND,
                         ids=[f"{m}-{k}-{i}" for i, (m, k, _, _)
                              in enumerate(HAND)])
def test_estimate_smem_worked_by_hand(model, kernel, dt, want):
    assert estimate_smem(kernel, dims_of(model, **dt)) == want


def test_estimate_refuses_what_the_kernels_refuse():
    assert estimate_smem("no_such_kernel", dims_of("llama3-8b")) is None
    assert estimate_smem("paged_decode", {"Hq": 8, "Hkv": 3, "D": 128}) \
        is None
    assert estimate_smem("paged_decode", {"Hq": 8, "Hkv": 8, "D": 96}) \
        is None
    assert estimate_smem("ragged_prefill", {"Hq": 256, "Hkv": 2, "D": 64}) \
        is None                       # G 128 > the 64 query rows a block
    assert smem_layout("ragged_prefill", dims_of("llama3-8b"))[1] == 16
    assert smem_layout("paged_decode", dims_of("llama3-8b"))[1] == 0


def test_every_registry_config_fits_the_h100():
    assert [f.render() for f in analyze_file(
        str(ROOT / "swarmdb_tpu_torch" / "models" / "configs.py"))] == []
    for name, cfg in REGISTRY.items():
        for kernel in KERNEL_BODIES:
            for dt in launch_dtypes(kernel):
                est = estimate_smem(kernel, dims_of(name, **dt))
                assert est is not None and est <= H100_SMEM_BYTES, (
                    name, kernel, dt, est)


def test_swl903_flags_a_config_over_the_limit(tmp_path):
    path = tmp_path / "configs.py"
    path.write_text(
        "from dataclasses import dataclass\n\n\n"
        "@dataclass\nclass ModelConfig:\n    name: str\n    dim: int\n"
        "    n_heads: int\n    n_kv_heads: int\n\n\n"
        "OK = ModelConfig(name='ok', dim=4096, n_heads=32, n_kv_heads=8)\n"
        "WIDE = ModelConfig(name='mqa-256', dim=32768, n_heads=256,\n"
        "                   n_kv_heads=1)\n")
    found = analyze_file(str(path))
    assert {f.rule for f in found} == {"SWL903"}
    assert {f.line for f in found} == {13}
    # G 256: every decode entry point's fp32 query and accumulator alone
    # are 256 KiB; the prefill refuses G > 64 outright (no estimate)
    assert sorted(f.message.split("`")[1] for f in found) == sorted(
        k for k in KERNEL_BODIES if not k.startswith("ragged"))


@pytest.mark.parametrize("kind", ["", "cpu", "TPU v4", "TPU v5 lite",
                                  "TPU v5p", "TPU v6e"])
def test_smem_budget_reads_a_non_card_dump_as_jax_does(kind):
    assert smem_budget(kind) == vmem_budget(kind)


def test_smem_budget_of_the_cards():
    assert smem_budget("NVIDIA H100 80GB HBM3") == 232448 == H100_SMEM_BYTES
    assert smem_budget("NVIDIA A100-SXM4-80GB") == 166912
    assert smem_budget("NVIDIA L4") == 49152


def card_dump(tmp_path: Path) -> str:
    """A profile dump as the card writes one: a paged engine's decode and
    ragged variants with device time, their kernels' estimates recorded
    under the keys the dispatchers use."""
    prof = tprofiler.KernelProfiler(enabled=True)
    prof.set_platform("gpu", "NVIDIA H100 80GB HBM3")
    prof.record_variant("decode.greedy", 4e9, 2e8,
                        {"kernel": "paged_decode_chunked"})
    prof.record_variant("prefill.ragged[w64]", 8e10, 3e8,
                        {"kernel": "ragged_prefill"})
    prof.record_variant("decode.sampling", 4e9, 2e8,
                        {"kernel": "paged_decode_chunked"})
    lane = prof.lane("lane0")
    lane.dispatch("decode.greedy", 0, 2_000_000)
    lane.dispatch("prefill.ragged[w64]", 3_000_000, 1_000_000)
    prof.record_vmem_estimate("kernel:paged_decode_chunked", 41008,
                              H100_SMEM_BYTES)
    prof.record_vmem_estimate("prefill.ragged[w64]", 160784,
                              H100_SMEM_BYTES)
    assert prof.has_vmem_estimate("prefill.ragged[w64]")
    path = prof.dump_to(str(tmp_path), "smem")
    del lane
    return path


def test_roofline_column_from_a_card_dump(tmp_path):
    path = card_dump(tmp_path)
    rep = tanalyze.roofline_report([path])["dumps"][0]
    assert rep["vmem_budget_bytes"] == H100_SMEM_BYTES
    col = {r["variant"]: r for r in rep["vmem_variants"]}
    assert set(col) == {"decode.greedy", "decode.sampling",
                        "prefill.ragged[w64]"}
    assert col["prefill.ragged[w64]"]["vmem_est_bytes"] == 160784
    assert col["decode.greedy"]["vmem_utilization"] == round(
        41008 / H100_SMEM_BYTES, 4)
    # the JAX analyzer reads the same column from the dump's own budgets;
    # only its top-level budget of a card's dump differs (16 MiB)
    jrep = janalyze.roofline_report([path])["dumps"][0]
    assert jrep["vmem_variants"] == rep["vmem_variants"]
    assert jrep["vmem_budget_bytes"] == vmem_budget("NVIDIA H100")
    out = subprocess.run([sys.executable, "-m",
                          "swarmdb_tpu_torch.obs.analyze", "--roofline",
                          path], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    printed = json.loads(out.stdout)["dumps"][0]
    assert printed["vmem_variants"] == rep["vmem_variants"]


def test_dispatchers_record_nothing_off_the_card(monkeypatch):
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.backend.sampling import SamplingParams

    fresh = tprofiler.KernelProfiler(enabled=True)
    monkeypatch.setattr(tprofiler, "_PROFILER", fresh)
    eng, tok = build_backend_engine("tiny-debug", max_seq=64, paged=True,
                                    device="cpu")
    eng.warmup()
    eng.start()
    try:
        _toks, why = eng.generate_sync(tok.encode("hello"),
                                       SamplingParams(max_new_tokens=4))
    finally:
        eng.stop()
    assert why in ("length", "eos")
    rows = fresh.variants_report()
    assert rows and all("vmem_est_bytes" not in r for r in rows)
    kernels = {r["meta"]["kernel"] for r in rows
               if r.get("meta", {}).get("kernel")}
    assert kernels == {"paged_decode_chunked", "ragged_prefill"}
    # off the card a variant's meta names its kernel, no build facts
    assert all("ptxas" not in r["meta"] for r in rows if "meta" in r)


def test_estimates_made_under_capture_wait_for_its_end(monkeypatch):
    from swarmdb_tpu_torch.ops import layers

    fresh = tprofiler.KernelProfiler(enabled=True)
    monkeypatch.setattr(tprofiler, "_PROFILER", fresh)
    layers._smem_deferred.items = [("kernel:paged_decode", 41008,
                                    H100_SMEM_BYTES)]
    assert not fresh.has_vmem_estimate("kernel:paged_decode")
    layers.flush_static_smem()
    assert fresh.has_vmem_estimate("kernel:paged_decode")
    assert layers._smem_deferred.items == []
    layers.flush_static_smem()          # nothing pending: a no-op


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5swarm25ragged_prefill_mma_kernelI13__nv_bfloat16Li128ELi2EEEvPKS1_S3_S3_PKT_PKfS6_S8_PKiSA_SA_SA_PS1_iiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN5swarm25ragged_prefill_mma_kernelI13__nv_bfloat16Li128ELi2EEEvPKS1_S3_S3_PKT_PKfS6_S8_PKiSA_SA_SA_PS1_iiiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 243 registers, used 3 barriers, 16 bytes smem, 504 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5swarm21ragged_prefill_kernelIaLi128EEEviiPKvS2_S2_PKT_PKfS5_S7_PKiS9_S9_S9_Pviiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN5swarm21ragged_prefill_kernelIaLi128EEEviiPKvS2_S2_PKT_PKfS5_S7_PKiS9_S9_S9_Pviiiiiiif
    24 bytes stack frame, 48 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 496 bytes cmem[0]
"""


def test_the_build_log_is_parsed(monkeypatch):
    from swarmdb_tpu_torch.ops import build

    rows = build.parse_ptxas(PTXAS_LOG)
    monkeypatch.setattr(build, "ptxas_info",
                        lambda name, checked=False: rows)
    assert build.ptxas_instances("ragged_prefill", "bf16", 128) == rows[:1]
    assert build.ptxas_instances("ragged_prefill", "int8", 128) == rows[1:]
    assert build.ptxas_instances("ragged_prefill", "bf16", 64) == []
    assert [r["instance"] for r in rows] == [
        "ragged_prefill_mma_kernel<bf16, 128, 2>",
        "ragged_prefill_kernel<int8, 128>"]
    assert (rows[0]["regs"], rows[0]["smem_static"], rows[0]["spill_stores"]
            ) == (243, 16, 0)
    assert (rows[1]["regs"], rows[1]["stack"], rows[1]["spill_stores"],
            rows[1]["spill_loads"], rows[1]["smem_static"]) == (
        128, 24, 48, 48, 0)
    assert build.demangle(
        "_ZN5swarm35paged_decode_chunked_cluster_kernelIfLi16EEEv"
        "NS_10DecodeArgsE") == "paged_decode_chunked_cluster_kernel<float, 16>"
    assert build.demangle("main") == "main"
