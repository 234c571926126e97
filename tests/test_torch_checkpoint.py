"""The port's checkpoints (``swarmdb_tpu_torch/utils/checkpoint.py``)
against the JAX package's (``swarmdb_tpu/utils/checkpoint.py``).

Tiny ``transformers`` Llama / Mixtral models are built in-process from a
seed (nothing is downloaded) and written with ``save_pretrained``:

- the port's ``import_hf_llama`` / ``import_hf_mixtral`` give the JAX
  package's parameters exactly (float32);
- ``load_hf_checkpoint``, the port's own safetensors reader, gives the
  JAX package's ``load_hf_checkpoint`` (through ``transformers``) exactly,
  over one file and over shards (``max_shard_size``), bf16 and float32
  storage, bf16 and float32 targets, tied embeddings;
- the port's logits on the loaded weights equal the JAX package's within
  1e-5, and a greedy serve through HF's tokenizer and ``ServingService``
  equals HF ``generate``;
- ``save_params`` / ``restore_params`` round-trip, and a mismatch with
  ``target`` (or with the config) raises naming the key;
- a process that loads a checkpoint and serves from it imports none of
  ``jax``, ``swarmdb_tpu``, ``transformers`` or ``safetensors``.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from swarmdb_tpu.models.configs import ModelConfig as JaxConfig  # noqa: E402
from swarmdb_tpu.utils import checkpoint as jckpt  # noqa: E402
from swarmdb_tpu_torch.models.configs import ModelConfig  # noqa: E402
from swarmdb_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=64, rope_theta=10_000.0, max_seq_len=64)
MOE = dict(TINY, n_experts=4, experts_per_token=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_llama(seed: int, tie: bool = False, vocab: int = TINY["vocab_size"]):
    cfg = transformers.LlamaConfig(
        vocab_size=vocab, hidden_size=TINY["dim"],
        intermediate_size=TINY["ffn_dim"],
        num_hidden_layers=TINY["n_layers"],
        num_attention_heads=TINY["n_heads"],
        num_key_value_heads=TINY["n_kv_heads"], rms_norm_eps=1e-5,
        rope_theta=TINY["rope_theta"],
        max_position_embeddings=TINY["max_seq_len"],
        tie_word_embeddings=tie, attention_bias=False, mlp_bias=False)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


def hf_mixtral(seed: int):
    cfg = transformers.MixtralConfig(
        vocab_size=MOE["vocab_size"], hidden_size=MOE["dim"],
        intermediate_size=MOE["ffn_dim"], num_hidden_layers=MOE["n_layers"],
        num_attention_heads=MOE["n_heads"],
        num_key_value_heads=MOE["n_kv_heads"], rms_norm_eps=1e-5,
        rope_theta=MOE["rope_theta"],
        max_position_embeddings=MOE["max_seq_len"],
        num_local_experts=MOE["n_experts"],
        num_experts_per_tok=MOE["experts_per_token"],
        tie_word_embeddings=False)
    torch.manual_seed(seed)
    return transformers.MixtralForCausalLM(cfg).eval()


def as_np(x):
    """A tensor or a jax array as float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_tree_equal(port, ref):
    """Same keys, shapes and values (bit-exact after an exact widening)."""
    assert set(port) == set(ref)
    for k in port:
        if isinstance(port[k], dict):
            assert_tree_equal(port[k], ref[k])
            continue
        a, b = as_np(port[k]), as_np(ref[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("family", ["llama", "llama_tied", "mixtral"])
def test_module_import_equals_jax(family):
    model = hf_mixtral(2) if family == "mixtral" else hf_llama(
        0, tie=family == "llama_tied")
    base = MOE if family == "mixtral" else TINY
    tie = family == "llama_tied"
    tcfg = ModelConfig(name="t", tie_embeddings=tie, **base)
    jcfg = JaxConfig(name="t", tie_embeddings=tie, **base)
    if family == "mixtral":
        port = tckpt.import_hf_mixtral(model, tcfg, torch.float32, "cpu")
        ref = jckpt.import_hf_mixtral(model, jcfg, jnp.float32)
    else:
        port = tckpt.import_hf_llama(model, tcfg, torch.float32, "cpu")
        ref = jckpt.import_hf_llama(model, jcfg, jnp.float32)
    assert ("lm_head" in port) == (not tie)
    assert_tree_equal(port, ref)


# (family, stored dtype, target dtype, shard size, tied)
LOAD_CASES = [
    ("llama", torch.bfloat16, torch.bfloat16, None, False),
    ("llama", torch.bfloat16, torch.bfloat16, "20KB", False),
    ("llama", torch.float32, torch.float32, "20KB", False),
    ("llama", torch.float32, torch.bfloat16, None, False),
    ("llama", torch.float16, torch.bfloat16, None, False),
    ("llama", torch.bfloat16, torch.float32, None, True),
    ("mixtral", torch.bfloat16, torch.bfloat16, "40KB", False),
    ("mixtral", torch.float32, torch.bfloat16, None, False),
]


@pytest.mark.parametrize(
    "family,stored,target,shard,tie", LOAD_CASES,
    ids=[f"{f}-{str(s)[6:]}-to-{str(t)[6:]}-{sh or 'one'}"
         f"{'-tied' if tie else ''}" for f, s, t, sh, tie in LOAD_CASES])
def test_load_hf_checkpoint_equals_jax(tmp_path, family, stored, target,
                                       shard, tie):
    model = hf_mixtral(3) if family == "mixtral" else hf_llama(1, tie=tie)
    kwargs = {"max_shard_size": shard} if shard else {}
    model.to(stored).save_pretrained(str(tmp_path), **kwargs)
    names = os.listdir(tmp_path)
    assert (("model.safetensors.index.json" in names) == bool(shard))
    base = MOE if family == "mixtral" else TINY
    tcfg = ModelConfig(name="t", tie_embeddings=tie, **base)
    jcfg = JaxConfig(name="t", tie_embeddings=tie, **base)
    port = tckpt.load_hf_checkpoint(str(tmp_path), tcfg, target, "cpu")
    jdt = jnp.bfloat16 if target == torch.bfloat16 else jnp.float32
    ref = jckpt.load_hf_checkpoint(str(tmp_path), jcfg, jdt)
    assert all(t.dtype == target for t in
               list(port["layers"].values()) + [port["embed"]])
    assert_tree_equal(port, ref)


def test_load_names_the_key_a_config_disagrees_with(tmp_path):
    hf_llama(4).save_pretrained(str(tmp_path))
    wide = ModelConfig(name="t", **dict(TINY, ffn_dim=96))
    with pytest.raises(ValueError, match=r"model\.layers\.0\.mlp\."
                                         r"gate_proj\.weight: shape"):
        tckpt.load_hf_checkpoint(str(tmp_path), wide, torch.float32, "cpu")
    deep = ModelConfig(name="t", **dict(TINY, n_layers=3))
    with pytest.raises(KeyError, match=r"model\.layers\.2\."):
        tckpt.load_hf_checkpoint(str(tmp_path), deep, torch.float32, "cpu")
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        tckpt.load_hf_checkpoint(str(tmp_path / "none"), wide,
                                 torch.float32, "cpu")


def test_save_restore_round_trip_and_mismatches(tmp_path):
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config

    cfg = get_config("tiny-debug")
    params = llama.init_params(cfg, seed=0, device="cpu")
    path = tckpt.save_params(params, str(tmp_path / "p.pt"))
    back = tckpt.restore_params(path, target=params, device="cpu")
    assert_tree_equal(back, params)
    assert back["embed"].dtype == torch.bfloat16
    other = llama.init_params(get_config("tiny-debug", ffn_dim=96),
                              seed=0, device="cpu")
    with pytest.raises(ValueError, match=r"layers\.w_down: shape"):
        tckpt.restore_params(path, target=other, device="cpu")
    f32 = llama.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match=r"embed: dtype"):
        tckpt.restore_params(path, target=f32, device="cpu")
    tied = llama.init_params(get_config("tiny-debug", tie_embeddings=True),
                             seed=0, device="cpu")
    with pytest.raises(ValueError, match=r"lm_head: in the checkpoint"):
        tckpt.restore_params(path, target=tied, device="cpu")


def test_port_logits_on_loaded_weights_equal_jax(tmp_path):
    """The same f32 checkpoint loaded by each package, one prefill
    forward each: logits within 1e-5."""
    import jax

    from swarmdb_tpu.models import llama as jllama
    from swarmdb_tpu_torch.models import llama

    hf_llama(5).save_pretrained(str(tmp_path))
    tcfg = ModelConfig(name="t", **TINY)
    jcfg = JaxConfig(name="t", **TINY)
    tp = tckpt.load_hf_checkpoint(str(tmp_path), tcfg, torch.float32, "cpu")
    jp = jckpt.load_hf_checkpoint(str(tmp_path), jcfg, jnp.float32)
    tokens = np.array([[3, 17, 42, 99, 7], [1, 2, 3, 4, 5]], np.int32)
    B, T = tokens.shape
    jcache = jllama.init_kv_cache(jcfg, B, jcfg.max_seq_len,
                                  dtype=jnp.float32)
    pos = np.tile(np.arange(T)[None], (B, 1)).astype(np.int32)
    ref, _ = jllama.forward(jp, jcfg, jnp.asarray(tokens),
                            jnp.asarray(pos), jcache)
    tcache = llama.init_kv_cache(tcfg, B, tcfg.max_seq_len,
                                 dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, _ = llama.forward(tp, tcfg, torch.from_numpy(tokens).long(),
                               torch.from_numpy(pos).long(), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.device_get(ref)),
                               rtol=0, atol=1e-5)


def test_hf_tokenizer_weights_and_service_equal_hf_generate(tmp_path,
                                                            tmp_swarm):
    """The integration seam of ``tests/test_hf_parity.py``, on the port:
    a real (tiny) HF tokenizer, a checkpoint read from disk by the port's
    reader, the engine behind ``ServingService``; the greedy reply equals
    HF ``generate`` on the same prompt ids."""
    from tokenizers import Tokenizer as RawTokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine,
                                                   build_prompt)
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    words = ["hello", "plan", "the", "what", "is", "agent", "swarm", "ok"]
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    for w in words:
        vocab[w] = len(vocab)
    raw = RawTokenizer(WordLevel(vocab, unk_token="<unk>"))
    raw.pre_tokenizer = Whitespace()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, pad_token="<pad>", bos_token="<s>",
        eos_token="</s>", unk_token="<unk>")
    tok_dir = str(tmp_path / "tok")
    fast.save_pretrained(tok_dir)

    cfg = ModelConfig(name="t", **{**TINY, "vocab_size": len(vocab) + 4})
    hf = hf_llama(7, vocab=cfg.vocab_size)
    hf.save_pretrained(str(tmp_path / "ckpt"))
    params = tckpt.load_hf_checkpoint(str(tmp_path / "ckpt"), cfg,
                                      torch.float32, "cpu")
    eng, tokenizer = build_backend_engine(
        cfg, max_batch=2, max_seq=cfg.max_seq_len, device="cpu",
        params=params, paged=False, kv_dtype=torch.float32,
        tokenizer_path=tok_dir)
    db = SwarmDB(save_dir=str(tmp_path / "db"))
    service = ServingService(db, eng, tokenizer, backend_id="gpu-it")
    db.register_agent("alice")
    db.register_agent("helper")
    db.assign_llm_backend("helper", "gpu-it")
    service.start()
    try:
        got = {}
        done = threading.Event()

        def on_done(rid, toks, reason):
            got["tokens"] = toks
            done.set()

        mid = db.send_message(
            "alice", "helper", "what is the plan",
            metadata={"generation": {"max_new_tokens": 5,
                                     "temperature": 0.0}})
        msg = db.get_message(mid)
        prompt_ids = build_prompt(db, msg, tokenizer)
        service.serve_message(msg, on_done=on_done)
        assert done.wait(120), "generation did not complete"
        with torch.no_grad():
            ref = hf.generate(torch.tensor([prompt_ids], dtype=torch.long),
                              max_new_tokens=5, do_sample=False,
                              )[0, len(prompt_ids):].tolist()
        assert got["tokens"] and got["tokens"] == ref[:len(got["tokens"])]
    finally:
        service.stop()
        db.close()


def test_loading_and_serving_imports_no_jax_transformers_safetensors(
        tmp_path):
    hf_llama(8, vocab=512).save_pretrained(str(tmp_path / "ckpt"),
                                           max_shard_size="40KB")
    code = (
        "import sys, torch\n"
        "from swarmdb_tpu_torch.backend.service import build_backend_engine\n"
        "from swarmdb_tpu_torch.backend.sampling import SamplingParams\n"
        "from swarmdb_tpu_torch.models.configs import ModelConfig\n"
        "from swarmdb_tpu_torch.utils.checkpoint import (load_hf_checkpoint,"
        " restore_params, save_params)\n"
        f"cfg = ModelConfig(name='t', **{dict(TINY, vocab_size=512)!r})\n"
        f"p = load_hf_checkpoint({str(tmp_path / 'ckpt')!r}, cfg,"
        " torch.bfloat16, 'cpu')\n"
        f"path = save_params(p, {str(tmp_path / 'p.pt')!r})\n"
        "p = restore_params(path, target=p, device='cpu')\n"
        "for paged in (True, False):\n"
        "    eng, _ = build_backend_engine(cfg, max_seq=64, device='cpu',"
        " params=p, paged=paged)\n"
        "    eng.start()\n"
        "    toks, why = eng.generate_sync([1, 2, 3],"
        " SamplingParams(max_new_tokens=3))\n"
        "    eng.stop()\n"
        "    assert why in ('length', 'eos'), why\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax',"
        " 'jaxlib', 'swarmdb_tpu', 'transformers', 'safetensors')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
