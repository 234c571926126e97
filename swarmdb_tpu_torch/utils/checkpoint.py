"""Weight checkpoints and HF-checkpoint import.

The counterpart of ``swarmdb_tpu/utils/checkpoint.py``, whose planes it
keeps, with PyTorch in place of orbax and ``transformers``:

- ``save_params`` / ``restore_params``: the parameter tree (a nested dict
  of tensors, weights stacked ``[L, ...]``) through ``torch.save`` /
  ``torch.load(weights_only=True)``, restored straight onto a device.
  With ``target`` every key, shape and dtype is checked against it.
  With ``shardings`` (a shard plan and a mesh, ``parallel/mesh.py``; the
  JAX package's tree of ``NamedSharding``) a tensor-parallel rank reads
  only its own slice of each leaf: the file is memory-mapped and each
  slice copied to the device on its own.
- ``import_hf_llama`` / ``import_hf_mixtral``: a ``transformers``
  ``LlamaForCausalLM`` / ``MixtralForCausalLM`` (any object with its
  module tree) into the stacked layout, as the JAX package's do: HF
  ``Linear`` weights (``[out, in]``) transposed, ``w1`` = gate, ``w3`` =
  up, ``w2`` = down, experts stacked ``[L, E, ...]``, Llama's ``lm_head``
  left out when ``cfg.tie_embeddings``.
- ``load_hf_checkpoint``: an HF checkpoint directory read from its
  safetensors files by this module itself (one ``model.safetensors``, or
  shards named by ``model.safetensors.index.json``), importing neither
  ``transformers`` nor ``safetensors``. Each file is memory-mapped; each
  tensor is read in place, converted and copied into a stacked tensor
  preallocated on ``device``, so the model is never held twice in host
  memory. A stored dtype other than the target's goes through float32 on
  its way, as the JAX package's import does (``F16`` / ``F32`` to bf16
  round to nearest even); ``BF16`` bytes are read as int16 and viewed as
  bfloat16 (numpy has no bfloat16). A tensor whose shape disagrees with
  ``cfg`` raises and names its HF key.

The safetensors layout: an 8-byte little-endian header length, a JSON
header mapping each tensor's name to its ``dtype``, ``shape`` and
``data_offsets`` (relative to the end of the header), then the raw bytes.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from contextlib import ExitStack
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.configs import ModelConfig
from .device import DeviceLike, resolve_device

Params = Dict[str, Any]


# ------------------------------------------------------------ torch.save


def save_params(params: Params, path: str) -> str:
    """Write the parameter tree to ``path`` (one ``torch.save`` file);
    returns its absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(params, path)
    return path


def restore_params(path: str, target: Optional[Params] = None,
                   device: DeviceLike = None,
                   shardings: Optional[Tuple[Any, Any]] = None) -> Params:
    """Load a tree written by ``save_params`` onto ``device`` (default the
    card), tensors only (``weights_only``). With ``target`` (a tree of
    tensors giving the expected structure) a missing or extra key, or a
    shape or dtype that differs, raises ``ValueError`` naming the key.

    ``shardings`` = (plan, mesh): keep only this rank's slice of each leaf
    (``parallel.mesh.shard_leaf``), read from the memory-mapped file leaf
    by leaf; ``target`` is then the rank's shares."""
    dev = resolve_device(device)
    if shardings is None:
        params = torch.load(os.path.abspath(path), map_location=dev,
                            weights_only=True)
    else:
        from ..parallel.mesh import shard_params

        plan, mesh = shardings
        whole = torch.load(os.path.abspath(path), map_location="cpu",
                           weights_only=True, mmap=True)
        params = _to_device(shard_params(whole, plan, mesh), dev)
        del whole
    if target is not None:
        _check_like(params, target, "")
    return params


def _to_device(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    # a leaf held whole is still a view of the mapped file: copy it out
    return tree.to(dev, copy=True)


def _check_like(got: Any, want: Any, key: str) -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise ValueError(f"{key or '<root>'}: expected a dict, the "
                             f"checkpoint holds {type(got).__name__}")
        for k in sorted(set(want) | set(got)):
            name = f"{key}.{k}" if key else str(k)
            if k not in got:
                raise ValueError(f"{name}: missing from the checkpoint")
            if k not in want:
                raise ValueError(f"{name}: in the checkpoint, not in the "
                                 f"target")
            _check_like(got[k], want[k], name)
        return
    if tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"{key}: shape {tuple(got.shape)} in the "
                         f"checkpoint, {tuple(want.shape)} in the target")
    if got.dtype != want.dtype:
        raise ValueError(f"{key}: dtype {got.dtype} in the checkpoint, "
                         f"{want.dtype} in the target")


# ---------------------------------------------------------- module import


def _t(w: torch.Tensor, dtype: torch.dtype,
       device: torch.device) -> torch.Tensor:
    """An HF ``Linear`` weight ([out, in]) transposed, through float32."""
    return w.detach().to("cpu").float().t().to(dtype).contiguous().to(
        device)


def _n(w: torch.Tensor, dtype: torch.dtype,
       device: torch.device) -> torch.Tensor:
    """A weight in its own layout, through float32."""
    return w.detach().to("cpu").float().to(dtype).contiguous().to(device)


def _attention(hf, L: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    def stack(getter):
        return torch.stack([getter(hf.layers[i]) for i in range(L)])

    return {
        "attn_norm": stack(lambda l: _n(l.input_layernorm.weight, dtype,
                                        device)),
        "wq": stack(lambda l: _t(l.self_attn.q_proj.weight, dtype, device)),
        "wk": stack(lambda l: _t(l.self_attn.k_proj.weight, dtype, device)),
        "wv": stack(lambda l: _t(l.self_attn.v_proj.weight, dtype, device)),
        "wo": stack(lambda l: _t(l.self_attn.o_proj.weight, dtype, device)),
        "mlp_norm": stack(lambda l: _n(l.post_attention_layernorm.weight,
                                       dtype, device)),
    }


def import_hf_llama(model, cfg: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = None) -> Params:
    """A ``transformers`` LlamaForCausalLM as the stacked tree of
    ``models/llama.py`` on ``device`` (the RoPE split-half convention is
    HF's rotate_half)."""
    dev = resolve_device(device)
    hf = model.model
    L = cfg.n_layers
    if len(hf.layers) != L:
        raise ValueError(f"the model has {len(hf.layers)} layers, "
                         f"{cfg.name} {L}")
    layers = _attention(hf, L, dtype, dev)

    def stack(getter):
        return torch.stack([getter(hf.layers[i]) for i in range(L)])

    layers.update({
        "w_gate": stack(lambda l: _t(l.mlp.gate_proj.weight, dtype, dev)),
        "w_up": stack(lambda l: _t(l.mlp.up_proj.weight, dtype, dev)),
        "w_down": stack(lambda l: _t(l.mlp.down_proj.weight, dtype, dev)),
    })
    params: Params = {
        "embed": _n(hf.embed_tokens.weight, dtype, dev),
        "layers": layers,
        "final_norm": _n(hf.norm.weight, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _t(model.lm_head.weight, dtype, dev)
    return params


def import_hf_mixtral(model, cfg: ModelConfig,
                      dtype: torch.dtype = torch.bfloat16,
                      device: DeviceLike = None) -> Params:
    """A ``transformers`` MixtralForCausalLM as the stacked tree of
    ``models/mixtral.py`` on ``device`` (w1 = gate, w3 = up, w2 = down,
    HF's naming)."""
    dev = resolve_device(device)
    hf = model.model
    L, E = cfg.n_layers, cfg.n_experts
    if len(hf.layers) != L:
        raise ValueError(f"the model has {len(hf.layers)} layers, "
                         f"{cfg.name} {L}")
    layers = _attention(hf, L, dtype, dev)

    def stack_experts(getter):
        return torch.stack([
            torch.stack([getter(hf.layers[i].block_sparse_moe.experts[e])
                         for e in range(E)])
            for i in range(L)])

    layers.update({
        "router": torch.stack([_t(hf.layers[i].block_sparse_moe.gate.weight,
                                  dtype, dev) for i in range(L)]),
        "w_gate": stack_experts(lambda e: _t(e.w1.weight, dtype, dev)),
        "w_up": stack_experts(lambda e: _t(e.w3.weight, dtype, dev)),
        "w_down": stack_experts(lambda e: _t(e.w2.weight, dtype, dev)),
    })
    return {
        "embed": _n(hf.embed_tokens.weight, dtype, dev),
        "layers": layers,
        "final_norm": _n(hf.norm.weight, dtype, dev),
        "lm_head": _t(model.lm_head.weight, dtype, dev),
    }


# ---------------------------------------------------------- safetensors

#: safetensors dtype -> (the torch dtype its bytes are read as, the
#: tensor's torch dtype after a bit view)
_ST_DTYPES: Dict[str, Tuple[torch.dtype, torch.dtype]] = {
    "F32": (torch.float32, torch.float32),
    "F16": (torch.float16, torch.float16),
    "BF16": (torch.int16, torch.bfloat16),
    "F64": (torch.float64, torch.float64),
}


class _SafetensorsDir:
    """The tensors of an HF checkpoint directory by name, each a view of
    its file's memory map (nothing is read until a tensor is used)."""

    def __init__(self, path: str, stack: ExitStack) -> None:
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index, "r", encoding="utf-8") as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        elif os.path.exists(os.path.join(path, "model.safetensors")):
            files = ["model.safetensors"]
        else:
            raise FileNotFoundError(
                f"{path}: no model.safetensors or "
                f"model.safetensors.index.json")
        self._where: Dict[str, Tuple[mmap.mmap, int, Dict[str, Any]]] = {}
        for name in files:
            fpath = os.path.join(path, name)
            f = stack.enter_context(open(fpath, "rb"))
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            # copy-on-write: a writable buffer that shares the page cache.
            # Not closed here: a tensor still viewing it (an exception's
            # traceback) would make close() raise; it goes with its last
            # reference
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
            for key, meta in header.items():
                if key != "__metadata__":
                    self._where[key] = (mm, 8 + n, meta)

    def __contains__(self, key: str) -> bool:
        return key in self._where

    def get(self, key: str, shape: Tuple[int, ...]) -> torch.Tensor:
        """Tensor ``key`` as stored, in place in its file's map; raises
        naming the key when it is missing or its shape is not ``shape``."""
        if key not in self._where:
            raise KeyError(f"{key}: not in the checkpoint")
        mm, base, meta = self._where[key]
        got = tuple(meta["shape"])
        if got != tuple(shape):
            raise ValueError(f"{key}: shape {got} in the checkpoint, "
                             f"{tuple(shape)} for the config")
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{key}: stored dtype {meta['dtype']} is not "
                             f"a float type")
        raw, view = _ST_DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        count = 1
        for s in got:
            count *= s
        item = torch.empty((), dtype=raw).element_size()
        if end - begin != count * item:
            raise ValueError(f"{key}: {end - begin} bytes for {count} "
                             f"{meta['dtype']} values")
        if (base + begin) % item:
            # an unaligned tensor (a writer without header padding): copy
            buf = bytearray(mm[base + begin:base + end])
            t = torch.frombuffer(buf, dtype=raw, count=count)
        else:
            t = torch.frombuffer(mm, dtype=raw, count=count,
                                 offset=base + begin)
        return t.view(view).reshape(got)


def _put(dst: torch.Tensor, src: torch.Tensor, transpose: bool) -> None:
    """Copy a stored tensor into ``dst`` on its device: the stored bytes
    go over as they are, then (on the device) through float32 to
    ``dst``'s dtype unless already in it, transposed for a Linear."""
    x = src.to(dst.device)
    if x.dtype != dst.dtype:
        x = x.float().to(dst.dtype)
    dst.copy_(x.t() if transpose else x)


def load_hf_checkpoint(path: str, cfg: ModelConfig,
                       dtype: torch.dtype = torch.bfloat16,
                       device: DeviceLike = None) -> Params:
    """Read an HF Llama or Mixtral checkpoint directory (``cfg.is_moe``
    picks) into the stacked tree on ``device`` (default the card),
    streaming one tensor at a time into preallocated stacks."""
    dev = resolve_device(device)
    L, Dm, F, V = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def empty(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=dev)

    # param -> (stacked tensor, HF key of layer i [and expert e], HF shape,
    # transpose)
    plan: List[Tuple[torch.Tensor, Callable[..., str], Tuple[int, ...],
                     bool]] = []
    layers: Dict[str, torch.Tensor] = {}

    def per_layer(name: str, key: str, shape: Tuple[int, ...],
                  transpose: bool) -> None:
        out = shape[::-1] if transpose else shape
        layers[name] = empty(L, *out)
        plan.append((layers[name],
                     lambda i, k=key: f"model.layers.{i}.{k}", shape,
                     transpose))

    per_layer("attn_norm", "input_layernorm.weight", (Dm,), False)
    per_layer("wq", "self_attn.q_proj.weight", (Hq * hd, Dm), True)
    per_layer("wk", "self_attn.k_proj.weight", (Hkv * hd, Dm), True)
    per_layer("wv", "self_attn.v_proj.weight", (Hkv * hd, Dm), True)
    per_layer("wo", "self_attn.o_proj.weight", (Dm, Hq * hd), True)
    per_layer("mlp_norm", "post_attention_layernorm.weight", (Dm,), False)
    if cfg.is_moe:
        E = cfg.n_experts
        per_layer("router", "block_sparse_moe.gate.weight", (E, Dm), True)
        for name, w, shape in (("w_gate", "w1", (F, Dm)),
                               ("w_up", "w3", (F, Dm)),
                               ("w_down", "w2", (Dm, F))):
            layers[name] = empty(L, E, *shape[::-1])
            plan.append((layers[name],
                         lambda i, e, w=w: (f"model.layers.{i}.block_sparse"
                                            f"_moe.experts.{e}.{w}.weight"),
                         shape, True))
    else:
        per_layer("w_gate", "mlp.gate_proj.weight", (F, Dm), True)
        per_layer("w_up", "mlp.up_proj.weight", (F, Dm), True)
        per_layer("w_down", "mlp.down_proj.weight", (Dm, F), True)

    with ExitStack() as stack:
        st = _SafetensorsDir(path, stack)
        params: Params = {"embed": empty(V, Dm), "layers": layers,
                          "final_norm": empty(Dm)}
        _put(params["embed"], st.get("model.embed_tokens.weight", (V, Dm)),
             False)
        _put(params["final_norm"], st.get("model.norm.weight", (Dm,)),
             False)
        for dst, key, shape, transpose in plan:
            for i in range(L):
                if dst.dim() == len(shape) + 2:  # experts
                    for e in range(dst.shape[1]):
                        _put(dst[i, e], st.get(key(i, e), shape), transpose)
                else:
                    _put(dst[i], st.get(key(i), shape), transpose)
        if cfg.is_moe or not cfg.tie_embeddings:
            params["lm_head"] = empty(Dm, V)
            if "lm_head.weight" in st:
                _put(params["lm_head"], st.get("lm_head.weight", (V, Dm)),
                     True)
            else:
                # a tied Mixtral: the JAX package's import reads the tied
                # module weight, the embedding
                _put(params["lm_head"],
                     st.get("model.embed_tokens.weight", (V, Dm)), True)
    return params
