"""PyTorch port vs JAX reference: pipeline parallelism
(``llama.forward_pipelined``), GPipe microbatches over a stage ring.

The JAX side is ``swarmdb_tpu.models.llama.forward_pipelined`` over a
mesh of CPU devices with a ``pipe`` axis, and the dense single-device
``forward`` (``tests/test_pipeline.py``'s config and inputs, float32).
The port's side is one gloo process per stage (``tests/torch_pod_child.py``
job ``pipe``), each holding its L / P layers (``param_plan_pp``) and
handing each microbatch on with ``Axis.shift``: every stage's logits are
the JAX pipeline's and the dense forward's within 1e-4, and its K/V are
its layers' rows of theirs. A MoE config, n_layers % P and B % M raise
the JAX package's ``ValueError``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swarmdb_tpu.models import llama as jl
from swarmdb_tpu.models.configs import ModelConfig
from swarmdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from swarmdb_tpu_torch.models import llama as tl
from swarmdb_tpu_torch.models.configs import ModelConfig as PortConfig
from swarmdb_tpu_torch.models.configs import get_config as port_config
from swarmdb_tpu_torch.parallel.collectives import Axis
from torch_pod_child import params_npz, run_pod

CFG = ModelConfig(
    name="pp-test", vocab_size=256, dim=32, n_layers=4, n_heads=4,
    n_kv_heads=2, ffn_dim=64, max_seq_len=64, rope_theta=10_000.0,
)
B, T = 4, 16
TOL = 1e-4
CASES = [(2, 2), (2, 4), (4, 2)]


@pytest.fixture(scope="module")
def inputs():
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jl.init_params(CFG, jax.random.PRNGKey(0),
                                         dtype=jnp.float32))
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, CFG.vocab_size, (B, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32)[None], (B, 1))
    cache = jl.init_kv_cache(CFG, B, T, dtype=jnp.float32)
    logits, (ck, cv) = jl.forward(jax.tree.map(jnp.asarray, params), CFG,
                                  jnp.asarray(tokens),
                                  jnp.asarray(positions), cache)
    dense = {"logits": np.asarray(logits), "ks": np.asarray(ck),
             "vs": np.asarray(cv)}
    return params, tokens, positions, dense


@pytest.fixture(scope="module", params=CASES,
                ids=[f"pipe{p}_micro{m}" for p, m in CASES])
def pod(request, inputs, tmp_path_factory):
    pipe, micro = request.param
    params, tokens, positions, dense = inputs
    mesh = jax_make_mesh(pipe, model=1, expert=1, pipe=pipe,
                         devices=jax.devices()[:pipe])
    logits, (ks, vs) = jl.forward_pipelined(
        jax.tree.map(jnp.asarray, params), CFG, jnp.asarray(tokens),
        jnp.asarray(positions), mesh, microbatches=micro)
    want = {"logits": np.asarray(logits), "ks": np.asarray(ks),
            "vs": np.asarray(vs)}
    tmp = tmp_path_factory.mktemp(f"pipe{pipe}_{micro}")
    got, codes, logs = run_pod("pipe", tmp, dict(
        params_npz(params), tokens=tokens, positions=positions,
        micro=micro, pipe=pipe, data=1,
        cfg=json.dumps(dataclasses.asdict(CFG))), world=pipe)
    assert codes == [0] * pipe, logs
    return pipe, micro, want, dense, got


@pytest.mark.parametrize("ref", ["jax_pipelined", "dense"])
def test_every_stage_has_the_logits(pod, ref):
    _pipe, _micro, want, dense, got = pod
    ref_logits = (want if ref == "jax_pipelined" else dense)["logits"]
    for out in got:
        np.testing.assert_allclose(out["logits"], ref_logits, atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("key", ["ks", "vs"])
def test_each_stage_holds_its_layers_kv(pod, key):
    """Stage s's K/V are layers [s * L/P, (s + 1) * L/P) of the JAX
    pipeline's (pipe-sharded on its layer axis) and the dense cache."""
    pipe, _micro, want, dense, got = pod
    per = CFG.n_layers // pipe
    for s, out in enumerate(got):
        assert int(out["n_layers"]) == per
        for ref in (want[key], dense[key]):
            np.testing.assert_allclose(out[key], ref[s * per:(s + 1) * per],
                                       atol=TOL, rtol=TOL)


def test_one_hand_off_per_step(pod):
    """M + P - 1 ring steps, each one shift on every stage, then one sum
    of the last stage's activations."""
    pipe, micro, _want, _dense, got = pod
    for out in got:
        assert int(out["collectives"]) == micro + pipe - 1 + 1


def test_pipelined_rejects_bad_divisibility_and_moe():
    """The JAX package's refusals (``tests/test_pipeline.py``), raised
    before any collective: B % M, n_layers % P, a MoE config."""
    cfg = PortConfig(**dataclasses.asdict(CFG))
    axis = Axis("pipe", None, 4, 0, torch.device("cpu"))
    params = tl.init_params(cfg, device="cpu", dtype=torch.float32)
    tokens = torch.ones((3, 8), dtype=torch.int32)
    positions = torch.arange(8, dtype=torch.int32).expand(3, 8)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        tl.forward_pipelined(params, cfg, tokens, positions, axis,
                             microbatches=2)
    odd = dataclasses.replace(cfg, name="odd", n_layers=5)
    with pytest.raises(ValueError, match="not divisible by pipe=4"):
        tl.forward_pipelined(tl.init_params(odd, device="cpu"), odd,
                             torch.ones((4, 8), dtype=torch.int32),
                             torch.arange(8).expand(4, 8), axis,
                             microbatches=2)
    moe = port_config("tiny-moe")
    with pytest.raises(ValueError, match="MoE"):
        tl.forward_pipelined({}, moe, torch.ones((4, 8), dtype=torch.int32),
                             torch.arange(8).expand(4, 8), axis)


def test_param_plan_pp_is_the_jax_param_specs_pp():
    specs = jl.param_specs_pp(CFG)
    plan = tl.param_plan_pp(PortConfig(**dataclasses.asdict(CFG)))
    assert plan["embed"] is None and plan["final_norm"] is None
    assert plan["lm_head"] is None
    for key, spec in specs["layers"].items():
        assert tuple(spec) == ("pipe",)
        assert plan["layers"][key] == (0, "pipe")
    assert set(plan["layers"]) == set(specs["layers"])
