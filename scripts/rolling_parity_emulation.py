"""How far the card's decode kernels should sit from their plain versions
in ``chip_smoke.py``'s rolling parity cases, emulated on the CPU.

The engine's chunk K/V buffer is bf16. The plain two-segment decode
(``swarmdb_tpu_torch/ops/layers.py`` ``gqa_attention_chunked_reference``)
rounds the chunk's softmax weights to bf16 before the value product; the
CUDA kernels keep them in float32. This script serves each rolling parity
case of ``chip_smoke.ROLL_PARITY_CASES`` with a bf16 chunk buffer on the
CPU twice, with the plain version as it is and the kernels' way
(``chip_smoke.kernel_weights``: the same call on the bf16 values upcast
to float32, so no weight is rounded), and prints the largest differences
of the first-token logits and of the decode logprobs.

Run from the repository root (CPU only, seconds):

    python scripts/rolling_parity_emulation.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config

    torch.set_num_threads(2)
    params = llama.init_params(get_config("tiny-debug"), seed=11,
                               device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, kind, paged, chunked, f32_buf, tol in cs.ROLL_PARITY_CASES:
            if not chunked or f32_buf:
                continue   # no bf16 chunk buffer: nothing is rounded
            args = ("cpu", params, kind, paged, chunked, f32_buf)
            plain = cs.rolling_parity_run(*args)
            with cs.kernel_weights():
                kernel = cs.rolling_parity_run(*args)
            same = [t[:2] for t in plain[0]] == [t[:2] for t in kernel[0]]
            lg, lp, _ = cs.rolling_parity_errors(kernel, plain)
            print(json.dumps({"case": name, "greedy_equal": same,
                              "prefill_logits_max_abs_err": lg,
                              "decode_logprobs_max_abs_err": lp,
                              "bound": tol}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
