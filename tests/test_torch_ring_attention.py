"""PyTorch port vs JAX reference: ring attention and the sequence-parallel
prefill over 2 and 4 ranks.

The JAX side is ``swarmdb_tpu.ops.ring_attention`` under ``shard_map``
over a ``data`` axis of CPU devices, ``gqa_attention`` (the dense
reference), and ``llama.forward_seq_parallel`` / ``forward``
(``tests/test_ring_attention.py``'s cases, float32). The port's side is
one gloo process per rank (``tests/torch_pod_child.py`` job ``ring``),
each calling ``ops.ring_attention`` and ``llama.forward_seq_parallel`` on
its own block of the sequence with ``Axis.shift`` rotating K/V: natural
order, chunks of a shuffled order (causal by global position), a sliding
window, and the seq-parallel prefill (full causal and windowed) whose
K/V then carry a decode step. Every rank's block is within 1e-4 of the
JAX ring's and of the dense references.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import get_config
from swarmdb_tpu.ops.layers import gqa_attention
from swarmdb_tpu.ops.ring_attention import ring_attention
from swarmdb_tpu.parallel import make_mesh
from swarmdb_tpu.utils.compat import shard_map
from swarmdb_tpu_torch.models import llama as tl
from swarmdb_tpu_torch.models.configs import get_config as port_config
from swarmdb_tpu_torch.utils.convert import params_from_numpy
from torch_pod_child import params_npz, run_pod

CFG = get_config("tiny-debug")
TOL = 1e-4
WINDOW = 8
Bq, Tq, HQ, HKV, D = 2, 32, 4, 2, 16
Tp = 64                  # the seq-parallel prompt


def _jax_ring(n, window=None):
    mesh = make_mesh(n, data=n, model=1, expert=1)
    return shard_map(
        lambda q, k, v, qp, kp: ring_attention(q, k, v, qp, kp, "data",
                                               window=window),
        mesh=mesh, in_specs=(P(None, "data"),) * 5,
        out_specs=P(None, "data"))


@pytest.fixture(scope="module", params=[2, 4], ids=["ring2", "ring4"])
def pod(request, tmp_path_factory):
    n = request.param
    rng = np.random.default_rng(0)
    q = rng.normal(size=(Bq, Tq, HQ, D)).astype(np.float32)
    k = rng.normal(size=(Bq, Tq, HKV, D)).astype(np.float32)
    v = rng.normal(size=(Bq, Tq, HKV, D)).astype(np.float32)
    pos = np.tile(np.arange(Tq, dtype=np.int32)[None], (Bq, 1))
    perm = rng.permutation(Tq)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jl.init_params(CFG, jax.random.PRNGKey(0),
                                         dtype=jnp.float32))
    tokens = rng.integers(3, CFG.vocab_size, (1, Tp)).astype(np.int32)
    tok_pos = np.arange(Tp, dtype=np.int32)[None]

    J = jnp.asarray
    want = {
        "ring": np.asarray(_jax_ring(n)(J(q), J(k), J(v), J(pos), J(pos))),
        "ring_dense": np.asarray(gqa_attention(J(q), J(k), J(v), J(pos))),
        "shuffled": np.asarray(_jax_ring(n)(
            *(J(a[:, perm]) for a in (q, k, v, pos, pos)))),
        "windowed": np.asarray(_jax_ring(n, WINDOW)(
            J(q), J(k), J(v), J(pos), J(pos))),
        "windowed_dense": np.asarray(gqa_attention(
            J(q), J(k), J(v), J(pos), window=WINDOW)),
    }
    mesh = make_mesh(n, data=n, model=1, expert=1)
    jp = jax.tree.map(J, params)
    for name, cfg in (("sp", CFG),
                      ("sp_window", replace(CFG, sliding_window=WINDOW))):
        lg, (ks, vs) = jl.forward_seq_parallel(jp, cfg, J(tokens),
                                               J(tok_pos), mesh)
        want[f"{name}_logits"] = np.asarray(lg)
        want[f"{name}_k"], want[f"{name}_v"] = np.asarray(ks), np.asarray(vs)
        dl, (dk, dv) = jl.forward(jp, cfg, J(tokens), J(tok_pos),
                                  jl.init_kv_cache(cfg, 1, Tp, jnp.float32))
        want[f"{name}_dense_logits"] = np.asarray(dl)
        want[f"{name}_dense_k"] = np.asarray(dk)
        want[f"{name}_dense_v"] = np.asarray(dv)

    tmp = tmp_path_factory.mktemp(f"ring{n}")
    got, codes, logs = run_pod("ring", tmp, dict(
        params_npz(params), q=q, k=k, v=v, pos=pos, perm=perm,
        tokens=tokens, tok_pos=tok_pos, window=WINDOW, data=n), world=n)
    assert codes == [0] * n, logs
    return n, dict(q=q, pos=pos, perm=perm, params=params, tokens=tokens,
                   want=want), got


def _joined(got, key, axis=1):
    """The ranks' blocks of ``key`` joined along the sequence dim."""
    return np.concatenate([out[key] for out in got], axis=axis)


@pytest.mark.parametrize("case", ["ring", "windowed"])
def test_ring_attention_matches_jax_ring_and_dense(pod, case):
    _n, ctx, got = pod
    out = _joined(got, case)
    np.testing.assert_allclose(out, ctx["want"][case], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, ctx["want"][f"{case}_dense"], atol=TOL,
                               rtol=TOL)


def test_ring_attention_shuffled_chunks_still_causal(pod):
    """Rank r holds positions perm[r * c:(r + 1) * c]: un-permuted, the
    output is the dense causal attention's, and the JAX ring's as laid
    out."""
    _n, ctx, got = pod
    out = _joined(got, "shuffled")
    np.testing.assert_allclose(out, ctx["want"]["shuffled"], atol=TOL,
                               rtol=TOL)
    inv = np.argsort(ctx["perm"])
    np.testing.assert_allclose(out[:, inv], ctx["want"]["ring_dense"],
                               atol=TOL, rtol=TOL)


def test_ring_rotates_size_minus_one_times(pod):
    """Three shifts (K, V, positions) per rotation, size - 1 rotations per
    attention: three ring attentions, then one per layer of each of the
    two seq-parallel prefills."""
    n, _ctx, got = pod
    calls = 3 * (n - 1) * (3 + 2 * CFG.n_layers)
    for out in got:
        assert int(out["shifts"]) == calls


@pytest.mark.parametrize("name", ["sp", "sp_window"])
@pytest.mark.parametrize("part", ["logits", "k", "v"])
def test_seq_parallel_prefill_matches_jax_and_dense(pod, name, part):
    """Each rank's block of the logits [1, T / n, V] and of the prompt
    K/V [L, 1, T / n, Hkv, D] against the JAX seq-parallel prefill and the
    dense forward's slot cache (with the window: both windowed)."""
    _n, ctx, got = pod
    axis = 1 if part == "logits" else 2
    out = _joined(got, f"{name}_{part}", axis)
    for ref in (ctx["want"][f"{name}_{part}"],
                ctx["want"][f"{name}_dense_{part}"]):
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_window_changes_the_prefill(pod):
    _n, _ctx, got = pod
    gap = np.abs(_joined(got, "sp_logits") - _joined(got, "sp_window_logits"))
    assert float(gap.max()) > 100 * TOL


def test_seq_parallel_then_decode_continuation(pod):
    """The ranks' prompt K/V scattered into a slot cache carry one decode
    step of the port's dense forward to the JAX dense forward's logits
    over the whole prompt plus that token."""
    _n, ctx, got = pod
    cfg = port_config("tiny-debug")
    S = Tp + 16
    ks, vs = _joined(got, "sp_k", 2), _joined(got, "sp_v", 2)
    nxt = int(np.argmax(_joined(got, "sp_logits")[0, -1]))
    params = params_from_numpy(ctx["params"], "cpu")
    ck, cv = tl.init_kv_cache(cfg, 1, S, dtype=torch.float32, device="cpu")
    ck[:, :, :Tp] = torch.from_numpy(ks)
    cv[:, :, :Tp] = torch.from_numpy(vs)
    with torch.no_grad():
        step, _ = tl.forward(params, cfg, torch.tensor([[nxt]],
                                                       dtype=torch.int32),
                             torch.tensor([[Tp]], dtype=torch.int32),
                             (ck, cv))
    full = np.concatenate([ctx["tokens"], [[nxt]]], 1).astype(np.int32)
    ref, _ = jl.forward(jax.tree.map(jnp.asarray, ctx["params"]), CFG,
                        jnp.asarray(full),
                        jnp.asarray(np.arange(Tp + 1, dtype=np.int32)[None]),
                        jl.init_kv_cache(CFG, 1, S, jnp.float32))
    np.testing.assert_allclose(step[:, 0].numpy(), np.asarray(ref)[:, -1],
                               atol=TOL, rtol=TOL)


def test_seq_parallel_refuses_moe():
    """A MoE config has no dense FFN: the port raises before any
    collective (the JAX function fails inside its scan instead)."""
    from swarmdb_tpu_torch.parallel.collectives import Axis

    axis = Axis("data", None, 2, 0, torch.device("cpu"))
    tokens = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="MoE"):
        tl.forward_seq_parallel({}, port_config("tiny-moe"), tokens,
                                torch.arange(8)[None], axis)
