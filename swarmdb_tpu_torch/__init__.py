"""swarmdb_tpu_torch — the multi-agent messaging runtime with its LLM
serving backend, in PyTorch with hand-written CUDA kernels for NVIDIA
Hopper.

A port of ``swarmdb_tpu`` (the JAX reference, which stays beside it): the
same module layout (``core/``, ``broker/``, ``ops/``, ``models/``,
``backend/``, ``utils/``), importing nothing of the JAX package. Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from .core.messages import (
    BackendSpec,
    BrokerConfig,
    Message,
    MessagePriority,
    MessageStatus,
    MessageType,
)
from .core.runtime import SwarmDB

__version__ = "0.1.0"

__all__ = [
    "BackendSpec",
    "BrokerConfig",
    "Message",
    "MessagePriority",
    "MessageStatus",
    "MessageType",
    "SwarmDB",
]
