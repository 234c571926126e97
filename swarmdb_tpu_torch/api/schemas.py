"""Wire-API request/response schemas: a copy of
``swarmdb_tpu/api/schemas.py`` over the port's ``core/messages.py``, so a
client of the JAX package's server talks to the port's unchanged.

Extensions of the reference API kept from the JAX package:
``MessageRequest.stream`` / ``GroupMessageRequest.stream`` ask for the
reply as an SSE token stream, and ``HealthResponse.tpu`` carries the
serving backend's device probe (its wire name kept; on the card it names
the GPU).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Union

from pydantic import BaseModel, Field

from ..core.messages import Message, MessagePriority, MessageStatus, MessageType

MessageContent = Union[str, Dict[str, Any], List[Any]]


class MessageRequest(BaseModel):
    receiver_id: Optional[str] = None
    content: MessageContent
    message_type: MessageType = MessageType.CHAT
    priority: MessagePriority = MessagePriority.NORMAL
    metadata: Dict[str, Any] = Field(default_factory=dict)
    # stream the LLM backend's reply tokens over SSE
    stream: bool = False


class MessageResponse(BaseModel):
    id: str
    sender_id: str
    receiver_id: Optional[str]
    content: MessageContent
    type: str
    priority: int
    timestamp: float
    status: str
    metadata: Dict[str, Any]
    token_count: Optional[int] = None
    visible_to: List[str] = Field(default_factory=list)

    @classmethod
    def from_message(cls, m: Message) -> "MessageResponse":
        return cls(
            id=m.id,
            sender_id=m.sender_id,
            receiver_id=m.receiver_id,
            content=m.content,
            type=m.type.value,
            priority=m.priority.value,
            timestamp=m.timestamp,
            status=m.status.value,
            metadata=m.metadata,
            token_count=m.token_count,
            visible_to=m.visible_to,
        )


class BroadcastRequest(BaseModel):
    content: MessageContent
    message_type: MessageType = MessageType.CHAT
    priority: MessagePriority = MessagePriority.NORMAL
    metadata: Dict[str, Any] = Field(default_factory=dict)
    exclude_agents: List[str] = Field(default_factory=list)


class BroadcastResponse(BaseModel):
    status: str
    message_id: str


class LlmBackendRequest(BaseModel):
    agent_id: str
    backend_id: str


class AgentRegistrationRequest(BaseModel):
    agent_id: str
    description: Optional[str] = None
    capabilities: List[str] = Field(default_factory=list)
    metadata: Dict[str, Any] = Field(default_factory=dict)
    # cross-process adoption: drain records produced for this agent before
    # this registration (SwarmDB.register_agent adopt_backlog)
    adopt_backlog: bool = False


class AgentGroupRequest(BaseModel):
    group_name: str
    agent_ids: List[str]


class GroupMessageRequest(BaseModel):
    group_name: str
    content: MessageContent
    message_type: MessageType = MessageType.CHAT
    priority: MessagePriority = MessagePriority.NORMAL
    metadata: Dict[str, Any] = Field(default_factory=dict)
    stream: bool = False


class GroupMessageResponse(BaseModel):
    status: str
    group_name: str
    message_ids: List[str]


class ReceiveRequest(BaseModel):
    max_messages: int = 10
    timeout: float = 5.0


class StatusUpdateRequest(BaseModel):
    status: MessageStatus


class HealthResponse(BaseModel):
    status: str
    broker_connected: bool
    timestamp: float = Field(default_factory=time.time)
    version: str = "0.1.0"
    # the serving backend's device probe and engine state (wire name kept)
    tpu: Optional[Dict[str, Any]] = None
    # the HA node's role / epoch / leader / detector verdict (None when
    # this process runs no HA node)
    ha: Optional[Dict[str, Any]] = None


class SystemStats(BaseModel):
    total_messages: int
    message_count: int
    registered_agents: int
    messages_by_type: Dict[str, int]
    messages_by_status: Dict[str, int]
    messages_by_agent: Dict[str, Dict[str, int]]
    metrics: Dict[str, Any] = Field(default_factory=dict)


class UserCredentials(BaseModel):
    username: str
    password: str


class Token(BaseModel):
    access_token: str
    token_type: str = "bearer"
