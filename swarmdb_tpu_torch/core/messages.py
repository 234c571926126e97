"""Core data model: message types, priorities, statuses, the Message record,
and broker configuration. A copy of ``swarmdb_tpu/core/messages.py``
without the tracer hook.

Capability parity: reference `swarmdb/ main.py:23-127` (MessageType :23-32,
MessagePriority :35-41, MessageStatus :44-51, Message :54-111, KafkaConfig
:114-127). Behavioral fixes relative to the reference:

- `Message.to_dict` uses pydantic serialization, not ``dataclasses.asdict``
  (reference defect D2, ` main.py:91-98`, which raises TypeError on every
  send).
- Timestamps are coerced to float on construction exactly like the
  reference's validator (` main.py:84-89`).
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from pydantic import BaseModel, Field, field_validator

from ..obs.tracer import TRACER


class MessageType(str, enum.Enum):
    """Kinds of inter-agent traffic (reference ` main.py:23-32`)."""

    CHAT = "chat"
    COMMAND = "command"
    FUNCTION_CALL = "function_call"
    FUNCTION_RESULT = "function_result"
    SYSTEM = "system"
    ERROR = "error"
    STATUS = "status"


class MessagePriority(int, enum.Enum):
    """Delivery priority (reference ` main.py:35-41`).

    Unlike the reference — which stores the priority but never orders by it —
    the serving engine's admission queue services higher priorities first (see
    ``backend/engine.py``).
    """

    LOW = 0
    NORMAL = 1
    HIGH = 2
    CRITICAL = 3


class MessageStatus(str, enum.Enum):
    """Lifecycle: pending → delivered → read → processed; failed
    (reference ` main.py:44-51`)."""

    PENDING = "pending"
    DELIVERED = "delivered"
    READ = "read"
    PROCESSED = "processed"
    FAILED = "failed"


MessageContent = Union[str, Dict[str, Any], List[Any]]


class Message(BaseModel):
    """A single inter-agent message (reference ` main.py:54-111`).

    Field-for-field compatible with the reference's pydantic model so that
    persisted JSON snapshots and wire payloads interoperate.
    """

    id: str = Field(default_factory=lambda: str(uuid.uuid4()))
    sender_id: str
    receiver_id: Optional[str] = None  # None = broadcast
    content: MessageContent
    type: MessageType = MessageType.CHAT
    priority: MessagePriority = MessagePriority.NORMAL
    timestamp: float = Field(default_factory=time.time)
    status: MessageStatus = MessageStatus.PENDING
    metadata: Dict[str, Any] = Field(default_factory=dict)
    token_count: Optional[int] = None
    visible_to: List[str] = Field(default_factory=list)

    @field_validator("timestamp", mode="before")
    @classmethod
    def _coerce_timestamp(cls, v: Any) -> float:
        # Reference ` main.py:84-89`: accepts int/float/str, coerces to float.
        if v is None:
            return time.time()
        return float(v)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe dict (enums → values). Fixes reference defect D2."""
        return self.model_dump(mode="json")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Message":
        """Inverse of :meth:`to_dict` (reference ` main.py:100-111`)."""
        return cls.model_validate(data)

    def stage_stamp(self, stage: str) -> None:
        """Record a per-stage timestamp in metadata (tracing hook).

        Stages used by the serving path: ``enqueued``, ``admitted``,
        ``first_token``, ``done``. Each stamp also lands in the span
        tracer as an instant ``stage.<stage>`` keyed by the message id, so
        the stage marks sit on the exported timeline beside the engine's
        spans (as in the JAX package); ``metadata["stages"]`` stays for
        the wire API's clients.
        """
        self.metadata.setdefault("stages", {})[stage] = time.time()
        TRACER.instant(f"stage.{stage}", cat="stage", rid=self.id)


@dataclass
class BrokerConfig:
    """Transport configuration (reference ``KafkaConfig``, ` main.py:114-127`).

    The field names and defaults mirror the reference so env-var based
    deployments translate directly; Kafka-specific knobs (heartbeats,
    session timeouts) are honored by the in-tree broker's liveness tracker
    rather than by an external cluster.
    """

    bootstrap_servers: str = "localhost:9092"  # ignored by in-proc broker
    group_id: str = "swarm_agents"
    auto_offset_reset: str = "earliest"
    num_partitions: int = 3
    replication_factor: int = 1
    retention_ms: int = 7 * 24 * 60 * 60 * 1000  # 7 days
    max_poll_interval_ms: int = 300_000
    session_timeout_ms: int = 30_000
    heartbeat_interval_ms: int = 10_000
    consumer_timeout_ms: int = 1_000
    # extensions of this build (no reference counterpart):
    # directory for the C++ broker's mmap segment logs; None = in-memory only.
    log_dir: Optional[str] = None
    # preferred broker implementation: "auto" | "python" | "native"
    implementation: str = "auto"


# Backwards-compatible alias: deployments written against the reference
# import `KafkaConfig`.
KafkaConfig = BrokerConfig


@dataclass
class BackendSpec:
    """Descriptor of one LLM serving backend (this build's replacement for
    the reference's bare backend-id strings, ` main.py:1293-1325`)."""

    backend_id: str
    model_name: str = "llama3-8b"
    mesh_shape: Dict[str, int] = field(default_factory=dict)  # e.g. {"data": 4, "model": 2}
    max_batch_size: int = 8
    max_seq_len: int = 2048
    partitions: List[int] = field(default_factory=list)  # broker partitions this backend drains
