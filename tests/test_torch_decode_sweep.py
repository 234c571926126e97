"""The decode body of the six decode entry points (``csrc/decode.cuh``:
each (slot, KV head)'s live range split over a cluster of 8 blocks, key
tiles of 32 positions dealt to the ranks in turn) on the edge sweep that
``chip_smoke.py`` runs on the card.

``test_decode_sweep_covers_the_edges`` runs everywhere: it pins that the
sweep walks every edge of the split (lengths 0, 1, < KT, NS * KT, NS * KT +
1, at and past the table's or lane's coverage; slots shorter than NS tiles,
whose later ranks are empty; windows of 1, below a tile and spanning
several ranks; chunk step 0 and Kc - 1; G 1 / 2 / 4 / 8; D 16 / 32 / 64 /
128; one slot, and a batch whose grid holds more clusters than the H100's
132 SMs; page tables with repeated and out-of-range ids).
``test_plain_decode_zeroes_a_slot_without_live_keys`` pins the plain
versions' side of the kernels' contract on the CPU.
``test_decode_body_matches_plain_on_card`` needs the CUDA card: it is
marked ``cuda`` and skips elsewhere; there every wave goes through the
entry point against its plain version, bf16 within 2e-2 (bf16 output
rounding) and f32 within 1e-4 (float32 sums in another order), int8 pages
under a query of either type.
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

SWEEP = chip_smoke.decode_sweep()
PS = chip_smoke.PS
KT, NS = chip_smoke.DECODE_KT, chip_smoke.DECODE_SPLIT
H100_SMS = 132


def _edges(i, sp):
    """The edges sweep wave ``i`` touches (its page table as drawn)."""
    G, window, Kc, step = sp["G"], sp["window"], sp["Kc"], sp["step"]
    cov = sp["maxp"] * PS
    lens = sp["lens"]
    out = {f"G{G}", f"D{sp['D']}"}
    for n in lens:
        out |= {name for name, hit in (
            ("len=0", n == 0), ("len=1", n == 1), ("len<KT", 1 < n < KT),
            ("len=NS*KT", n == NS * KT), ("len=NS*KT+1", n == NS * KT + 1),
            ("len=coverage", n == cov), ("len>coverage", n > cov),
            ("ranks empty", 0 < -(-min(n, cov) // KT) < NS)) if hit}
    if window == 1:
        out.add("window 1")
    elif window is not None and window < KT:
        out.add("window < KT")
    elif window is not None and window >= 3 * KT and max(lens) > window:
        out.add("window spans ranks")
    out |= {name for name, hit in (("step 0", step == 0),
                                   ("step Kc-1", step == Kc - 1)) if hit}
    if len(lens) == 1:
        out.add("B1")
    if sp["Hkv"] * len(lens) > H100_SMS:
        out.add("clusters > SMs")
    c = chip_smoke.decode_sweep_case(sp, "paged_decode", torch.float32,
                                     "cpu", seed=200 + i)
    P = c["k_pages"].shape[0]
    for row, n in zip(c["page_table"].tolist(), lens):
        ids = row[:-(-min(n, cov) // PS)] if n > 0 else []
        if len(set(ids)) < len(ids):
            out.add("repeated ids")
        if any(p < 0 or p >= P for p in ids):
            out.add("out-of-range ids")
    return out


def test_decode_sweep_covers_the_edges():
    seen = set().union(*(_edges(i, sp) for i, (_, sp) in enumerate(SWEEP)))
    want = {"len=0", "len=1", "len<KT", "len=NS*KT", "len=NS*KT+1",
            "len=coverage", "len>coverage", "ranks empty", "window 1",
            "window < KT", "window spans ranks", "step 0", "step Kc-1",
            "B1", "clusters > SMs", "repeated ids", "out-of-range ids",
            "G1", "G2", "G4", "G8"}
    want |= {f"D{d}" for d in (16, 32, 64, 128)}
    assert want <= seen, sorted(want - seen)
    assert 10 <= len(SWEEP) <= 16
    labels = [label for label, _ in SWEEP]
    assert len(set(labels)) == len(labels)
    for _, sp in SWEEP:
        assert 0 <= sp["step"] < sp["Kc"]
        assert sp["G"] * sp["Hkv"] <= 32


def test_plain_decode_zeroes_a_slot_without_live_keys():
    """Length 0, and a length past the lane's coverage under a window that
    masks every covered position, give zeros (as the kernels do); a slot
    with a live key does not."""
    g = torch.Generator().manual_seed(0)
    B, S, Hkv, D = 3, 16, 2, 16
    q = torch.randn(B, 4, D, generator=g)
    k, v = (torch.randn(B, S, Hkv, D, generator=g) for _ in range(2))
    lengths = torch.tensor([0, S + 3, S + 3], dtype=torch.int32)
    out = ac.decode_gqa_attention(q, k, v, lengths, window=2)
    assert out[0].abs().max() == 0 and out[1].abs().max() == 0
    # a window of 4 reaches back to position S - 1: one live key
    out = ac.decode_gqa_attention(q, k, v, lengths, window=4)
    assert out[2].abs().max() > 0
    want = v[2, S - 1].repeat_interleave(2, 0)
    assert torch.allclose(out[2], want, atol=1e-6)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", list(chip_smoke.DECODE_KINDS))
def test_decode_body_matches_plain_on_card(cuda_device, name, dt):
    specs = chip_smoke.kernel_specs()
    dtype = getattr(torch, dt)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for i, (label, sp) in enumerate(SWEEP):
        c = chip_smoke.decode_sweep_case(sp, name, dtype, cuda_device,
                                         seed=200 + i)
        ac.reset_launches()
        got = specs[name]["kernel"](**c)
        want = specs[name]["plain"](**c)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert ac.LAUNCHES[name] == 1
        assert (got.float() - want.float()).abs().max().item() <= tol, label
