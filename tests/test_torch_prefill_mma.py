"""The tensor-core body of the ragged-prefill kernels 1 and 4
(``csrc/ragged_prefill_mma.cuh``, the route for a bf16 query and suffix)
on the edge sweep that ``chip_smoke.py`` runs on the card.

``test_sweep_covers_the_edges`` runs everywhere: it pins that the sweep
walks every edge the body's tiling has (row lengths 1, QT - 1, QT, QT + 1
and a row filling the stream, QT = 64 // G query tokens per tile;
prefixes ending mid-page, mid-tile and past the table's coverage; dead
rows; W not a multiple of QT; windows of 1, below the 64-key tile and
above the prefix; G 1 / 2 / 4 / 8; every head dim the body is built for,
16 / 32 / 64 / 128, each in a wave the launch gives one warp group per
block and in one it gives two). ``test_mma_body_matches_plain_on_card``
needs the CUDA card: it is marked ``cuda`` and skips elsewhere;
there each wave goes through both kernels against their plain versions,
within 2e-2 (bf16 output rounding; the body rounds the softmax weights to
bf16 for the value product, as the plain version does for bf16 pages).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from swarmdb_tpu_torch.ops import attention_cuda as ac

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SWEEP = chip_smoke.prefill_sweep()
PS, KT = chip_smoke.PS, 64


def _edges(sp):
    """The edges one sweep wave touches."""
    G, W, window = sp["G"], sp["W"], sp["window"]
    QT = chip_smoke.MMA_ROWS // G
    cov = sp["maxp"] * PS
    live = [(n, p) for n, p in zip(sp["lens"], sp["plens"]) if n > 0]
    out = {f"G{G}", f"D{sp['D']}"}
    for n, p in live:
        out |= {f"len={d}" for d, v in (("1", 1), ("QT-1", QT - 1),
                                          ("QT", QT), ("QT+1", QT + 1))
                if n == v}
        if n == W:
            out.add("full row")
        if p > cov:
            out.add("prefix past coverage")
        elif p % PS:
            out.add("prefix mid-page")
        elif p % KT:
            out.add("prefix mid-tile")
        if window is not None and window > p + n:
            out.add("window > prefix")
    if any(n == 0 for n in sp["lens"]):
        out.add("dead row")
    if W % QT:
        out.add("W % QT != 0")
    # the launch's group count: two groups when the wave's query tiles x
    # KV heads fit one block per SM (132 on the H100)
    groups = "two groups" if -(-W // QT) * sp["Hkv"] <= 132 else "one group"
    out.add(f"D{sp['D']} {groups}")
    if window == 1:
        out.add("window 1")
    elif window is not None and window < KT:
        out.add("window < KT")
    return out


def test_sweep_covers_the_edges():
    seen = set().union(*(_edges(sp) for _, sp in SWEEP))
    want = {"len=1", "len=QT-1", "len=QT", "len=QT+1", "full row",
            "prefix mid-page", "prefix mid-tile", "prefix past coverage",
            "dead row", "W % QT != 0", "window 1", "window < KT",
            "window > prefix", "G1", "G2", "G4", "G8"}
    want |= {f"D{d}" for d in (16, 32, 64, 128)}
    want |= {f"D{d} {groups}" for d in (16, 32, 64, 128)
             for groups in ("one group", "two groups")}
    assert want <= seen, sorted(want - seen)
    assert 12 <= len(SWEEP) <= 16
    labels = [label for label, _ in SWEEP]
    assert len(set(labels)) == len(labels)
    for _, sp in SWEEP:
        assert sum(sp["lens"]) <= sp["W"]
        assert len(sp["lens"]) == len(sp["plens"])


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("i", range(len(SWEEP)),
                         ids=[label for label, _ in SWEEP])
def test_mma_body_matches_plain_on_card(cuda_device, quant, i):
    label, sp = SWEEP[i]
    c = chip_smoke.sweep_case(sp, quant, cuda_device, seed=100 + i)
    kernel = (ac.ragged_paged_prefill_attention_quant if quant
              else ac.ragged_paged_prefill_attention)
    plain = ac.ragged_prefill_quant_plain if quant else ac.ragged_prefill_plain
    ac.reset_launches()
    got = kernel(**c)
    want = plain(**c)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert ac.LAUNCHES["ragged_prefill_quant" if quant
                       else "ragged_prefill"] == 1
    assert (got.float() - want.float()).abs().max().item() <= 2e-2, label
