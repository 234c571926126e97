"""The plain reference against the port's own forward at tiny sizes on
the CPU (float32 weights, where both compute the same sums), the prompt
renderer against the service's, and the fp8 control's departure."""

import pytest
import torch

from swarmbench import weights
from swarmbench.reference import (TOKENIZER, Reference, render_prompt,
                                  served_gaps)
from swarmdb_tpu_torch.backend import tokenizer as port_tokenizer
from swarmdb_tpu_torch.models import llama, mixtral
from swarmdb_tpu_torch.models.configs import get_config

DENSE = weights.Dims(vocab=512, hidden=64, layers=2, heads=4, kv_heads=2,
                     ffn=128, eps=1e-5, theta=10_000.0)
MOE = weights.Dims(vocab=512, hidden=64, layers=2, heads=4, kv_heads=2,
                   ffn=128, eps=1e-5, theta=10_000.0, experts=4, top_k=2)


def port_logits(name, mod, w, toks):
    cfg = get_config(name)
    T = len(toks)
    cache = mod.init_kv_cache(cfg, 1, T, dtype=torch.float32, device="cpu")
    ids = torch.tensor([toks])
    pos = torch.arange(T)[None]
    logits, _ = mod.forward(w, cfg, ids, pos, cache)
    return logits[0]


@pytest.mark.parametrize("name,mod,d", [("tiny-debug", llama, DENSE),
                                        ("tiny-moe", mixtral, MOE)])
def test_reference_equals_the_port_forward(name, mod, d):
    # tiny-moe's 4 experts have capacity for every token (C = N), so the
    # port's capacity routing drops nothing and must equal dropless
    w = weights.draw(d, 2 ** 31 + 3, "cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(3, d.vocab, (48,), generator=g).tolist()
    want = port_logits(name, mod, w, toks)
    got = Reference(d, w).logits(toks, 0)
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), \
        float((got - want).abs().max())
    tail = Reference(d, w).logits(toks, 40)
    assert torch.allclose(tail, got[40:], atol=1e-5)


def test_fp8_control_departs():
    w = weights.draw(DENSE, 9, "cpu")
    toks = list(range(3, 67))
    exact = Reference(DENSE, w).logits(toks, 0)
    low = Reference(DENSE, w, precision="fp8").logits(toks, 0)
    assert float((exact - low).abs().max()) > 1e-2


def test_gaps_of_argmax_tokens_are_zero():
    w = weights.draw(DENSE, 11, "cpu")
    ref = Reference(DENSE, w)
    prompt = TOKENIZER.encode("u: hello\nassistant-0:")
    served = []
    for _ in range(6):
        served.append(int(ref.logits(prompt + served, len(prompt + served)
                                     - 1).argmax(-1)[-1]))
    gap, ctl = served_gaps(ref, prompt, served,
                           Reference(DENSE, w, precision="fp8"))
    assert gap == 0.0
    assert ctl >= 0.0
    wrong = served[:3] + [(served[3] + 1) % DENSE.vocab] + served[4:]
    assert served_gaps(ref, prompt, wrong)[0] > 0.0


def test_tokenizer_and_prompt_match_the_service():
    port = port_tokenizer.ByteTokenizer(512)
    text = "café � ok"
    assert TOKENIZER.encode(text) == port.encode(text)
    ids = [5, 300, 70, 2, 900, 200, 201]
    assert TOKENIZER.decode(ids) == port.decode(ids)
    from swarmdb_tpu_torch.backend.service import _current_lines
    from swarmdb_tpu_torch.core.messages import Message, MessageType

    for kind, mtype in (("chat", MessageType.CHAT),
                        ("function_call", MessageType.FUNCTION_CALL)):
        m = Message(sender_id="u1", receiver_id="assistant-2",
                    content="body", type=mtype)
        hist = [("u1", "first"), ("assistant-2", "")]
        lines = [f"{s}: {t}" for s, t in hist] + _current_lines(m)
        assert render_prompt(hist, kind, "u1", "assistant-2", "body") == \
            port.encode("\n".join(lines))
