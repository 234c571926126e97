"""The pod's control plane: rank 0 publishes each device call, the other
ranks replay it.

The counterpart of ``swarmdb_tpu/parallel/multihost.py``. Every rank of a
tensor-parallel pod must issue the same device calls in the same order,
since their collectives meet by program order; but only rank 0, the
coordinator, has the request queue (the broker, the HTTP ingress, the
scheduler and the tokenizer). So the coordinator's engine publishes a
record before every device call, and the workers (``Engine.worker_loop``)
receive it and issue the identical call on identically shaped state. The
state starts identical (every rank draws the same weights, or reads the
same checkpoint, and keeps its slice) and stays identical because the
calls and their arguments are.

A record is two broadcasts from rank 0 over the whole process group, as
in the JAX package: a fixed ``[4]`` int64 header ``[op, a, b, nbytes]``,
which every rank can always receive, then the op's arguments, packed into
one byte payload of ``nbytes`` (the JAX package broadcasts a tuple of
arrays at once; here one tensor carries them all). The header and the
engine's configuration fix the payload's layout:

- ``OP_DECODE`` (a = the sampling variant): positions int32 [B], slot
  keys int64 [B, 2], temperature float32 [B], top-k int32 [B], top-p
  float32 [B], B = ``max_batch``;
- ``OP_PREFILL`` (a = rows, b = bucket): tokens int32 [rows, bucket],
  lengths int32 [rows], scatter int64 [rows] (the slot each row's first
  token goes to; ``max_batch`` = discard), then the rows' keys, temperature,
  top-k and top-p as for decode;
- ``OP_CALL`` (a = the engine's call id, b = the argument count): a
  mirrored device call of the paged engine (``Engine._mirrored``: its
  page-table rows, its prefill waves), whose argument shapes vary per
  call. The payload opens with a fixed-width descriptor matrix, int64 [b,
  2 + ``MAX_NDIM``] of (dtype code, ndim, dims...) per argument, from
  which the workers read the arrays packed after it (the JAX package's
  ``publish_call``, whose descriptor matrix is a broadcast of its own);
- ``OP_STOP``: no payload; the workers leave their loop;
- ``OP_BEAT``: no payload, nothing to do. A worker waits for the next
  record inside a collective, which fails after the process group's
  timeout (``SWARMDB_PG_TIMEOUT_S``), so an idle coordinator publishes a
  beat every quarter of it (at most every 5 s; ``beat_due``): an idle pod
  stays up, and a dead rank still shows within the timeout.

Under gloo the payload is a CPU tensor; under NCCL it lives on the rank's
device (``collectives.Axis.wire_device``). A broadcast that fails (a dead
rank, or the process group's timeout) raises on every live rank: the
coordinator's engine then stops the pod loudly.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import Axis
from .distributed import pg_timeout_s

logger = logging.getLogger("swarmdb_tpu_torch.multihost")

# op codes (header slot 0)
OP_STOP = 0
OP_DECODE = 1
OP_PREFILL = 2
OP_BEAT = 3
OP_CALL = 4

_HEADER_LEN = 4  # [op, a, b, nbytes]

# OP_CALL's argument dtypes, by wire code (the JAX package's four)
MAX_NDIM = 4
_DTYPE_BY_CODE = [np.int32, np.int64, np.float32, np.uint32]
_CODE_BY_DTYPE = {np.dtype(d): i for i, d in enumerate(_DTYPE_BY_CODE)}

__all__ = ["ControlPlane", "MAX_NDIM", "OP_BEAT", "OP_CALL", "OP_DECODE",
           "OP_PREFILL", "OP_STOP", "pod_axis"]


def pod_axis(device: torch.device) -> Axis:
    """The whole process group as the control plane's axis."""
    return Axis("pod", dist.group.WORLD, dist.get_world_size(),
                dist.get_rank(), device)


def _pack(arrays: Sequence[np.ndarray]) -> np.ndarray:
    return np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                           for a in arrays]) if arrays else np.zeros(
        0, np.uint8)


def _unpack(buf: np.ndarray, specs: Sequence[Tuple[Tuple[int, ...], type]]
            ) -> List[np.ndarray]:
    out, off = [], 0
    for shape, dtype in specs:
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        out.append(buf[off:off + n].view(dtype).reshape(shape).copy())
        off += n
    if off != buf.size:
        raise ValueError(f"control payload of {buf.size} bytes, layout "
                         f"takes {off}")
    return out


def _sampling_specs(rows: int):
    return [((rows, 2), np.int64), ((rows,), np.float32),
            ((rows,), np.int32), ((rows,), np.float32)]


class ControlPlane:
    """Coordinator-side publish and worker-side receive of engine calls
    over ``axis`` (the pod: every rank of the process group)."""

    def __init__(self, max_batch: int, axis: Axis) -> None:
        self.max_batch = max_batch
        self.axis = axis
        #: seconds between an idle coordinator's beats
        self.beat_s = min(5.0, pg_timeout_s() / 4)
        self._last = time.monotonic()

    # ------------------------------------------------------------- wire

    def _send(self, arr: np.ndarray) -> None:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        self.axis.broadcast(t.to(self.axis.wire_device), 0)

    def _recv(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        t = torch.zeros(shape, dtype=dtype, device=self.axis.wire_device)
        return self.axis.broadcast(t, 0).cpu().numpy()

    def _publish(self, op: int, a: int, b: int,
                 arrays: Sequence[np.ndarray]) -> None:
        payload = _pack(arrays)
        self._send(np.asarray([op, a, b, payload.size], np.int64))
        if payload.size:
            self._send(payload)
        self._last = time.monotonic()

    # ------------------------------------------------------- coordinator

    def publish_decode(self, variant: int, positions: np.ndarray,
                       keys: np.ndarray, temp: np.ndarray,
                       topk: np.ndarray, topp: np.ndarray) -> None:
        self._publish(OP_DECODE, variant, 0, [
            positions.astype(np.int32), keys.astype(np.int64),
            temp.astype(np.float32), topk.astype(np.int32),
            topp.astype(np.float32)])

    def publish_prefill(self, tokens: np.ndarray, lengths: np.ndarray,
                        scatter: np.ndarray, keys: np.ndarray,
                        temp: np.ndarray, topk: np.ndarray,
                        topp: np.ndarray) -> None:
        rows, bucket = tokens.shape
        self._publish(OP_PREFILL, rows, bucket, [
            tokens.astype(np.int32), lengths.astype(np.int32),
            scatter.astype(np.int64), keys.astype(np.int64),
            temp.astype(np.float32), topk.astype(np.int32),
            topp.astype(np.float32)])

    def publish_call(self, call_id: int, args: Sequence[np.ndarray]) -> None:
        """One mirrored device call: the workers apply ``call_id`` of
        their engine's call table to ``args`` (numpy arrays of the wire
        dtypes, at most ``MAX_NDIM`` dims each)."""
        arrs = [np.asarray(a) for a in args]
        desc = np.zeros((len(arrs), 2 + MAX_NDIM), np.int64)
        for i, a in enumerate(arrs):
            if a.ndim > MAX_NDIM:
                raise ValueError(f"mirrored call arg ndim {a.ndim} > "
                                 f"{MAX_NDIM}")
            if a.dtype not in _CODE_BY_DTYPE:
                raise ValueError(f"mirrored call arg dtype {a.dtype} "
                                 "not wire-encodable")
            desc[i, :2] = _CODE_BY_DTYPE[a.dtype], a.ndim
            desc[i, 2:2 + a.ndim] = a.shape
        self._publish(OP_CALL, call_id, len(arrs), [desc] + arrs)

    def publish_stop(self) -> None:
        self._publish(OP_STOP, 0, 0, [])

    def beat_due(self) -> bool:
        """Whether the coordinator has published nothing for ``beat_s``."""
        return time.monotonic() - self._last >= self.beat_s

    def publish_beat(self) -> None:
        self._publish(OP_BEAT, 0, 0, [])

    # ------------------------------------------------------------ worker

    def receive(self) -> Tuple[int, Optional[list]]:
        """Blocking receive of one record: (op, arguments). Decode gives
        [variant, positions, keys, temp, topk, topp]; prefill [tokens,
        lengths, scatter, keys, temp, topk, topp]; a call [call id, its
        arrays...]; stop and beat None."""
        op, a, b, nbytes = (int(x) for x in self._recv((_HEADER_LEN,),
                                                       torch.int64))
        if op in (OP_STOP, OP_BEAT):
            return op, None
        # a record without payload sends none (an OP_CALL of no arguments)
        buf = (self._recv((nbytes,), torch.uint8) if nbytes
               else np.zeros(0, np.uint8))
        B = self.max_batch
        if op == OP_DECODE:
            args = _unpack(buf, [((B,), np.int32)] + _sampling_specs(B))
            return op, [a, *args]
        if op == OP_PREFILL:
            rows, bucket = a, b
            args = _unpack(buf, [((rows, bucket), np.int32),
                                 ((rows,), np.int32), ((rows,), np.int64)]
                           + _sampling_specs(rows))
            return op, args
        if op == OP_CALL:
            desc = buf[:b * (2 + MAX_NDIM) * 8].view(np.int64).reshape(
                b, 2 + MAX_NDIM)
            specs = [(tuple(int(x) for x in d[2:2 + int(d[1])]),
                      _DTYPE_BY_CODE[int(d[0])]) for d in desc]
            return op, [a, *_unpack(buf[desc.nbytes:], specs)]
        raise ValueError(f"unknown control op {op}")
