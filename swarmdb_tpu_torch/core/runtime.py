"""SwarmDB — the multi-agent messaging runtime, the part the serving path
uses.

The counterpart of ``swarmdb_tpu/core/runtime.py``, cut to what a chat
served by an LLM backend needs: agent registration with a
partition-affine consumer, unicast and broadcast send, polled receive,
the conversation index the prompt builder reads, status transitions,
incremental stats and the agent -> backend routing table. Persistence,
autosave, group fan-out, partition autoscaling, the SLO sentinel and
trace propagation are not ported yet (ROADMAP.md, queue 1).

Semantics kept from the JAX package: stable FNV-1a partition routing,
consumers that read only their own partition, broadcast as a fan-out
write, one RLock around all shared state, acks-all delivery reports fired
by a background poller.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..broker.base import Broker, Consumer, Producer, Record
from ..broker.local import LocalBroker
from ..utils.hashing import stable_partition
from ..utils.metrics import MetricsRegistry
from ..utils.sync import make_rlock
from .messages import (
    BrokerConfig,
    Message,
    MessageContent,
    MessagePriority,
    MessageStatus,
    MessageType,
)

logger = logging.getLogger("swarmdb_tpu_torch")


class SwarmDB:
    """Messaging runtime over an in-tree broker (LocalBroker by default)."""

    def __init__(
        self,
        config: Optional[BrokerConfig] = None,
        topic_name: str = "swarm_messages",
        token_counter: Optional[Callable[[str], int]] = None,
        broker: Optional[Broker] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.config = config or BrokerConfig()
        self.topic_name = topic_name
        self.error_topic = f"{topic_name}_errors"
        self.token_counter = token_counter
        self.metrics = metrics or MetricsRegistry()
        self.broker: Broker = broker if broker is not None else LocalBroker()
        self.producer = Producer(self.broker)
        self.broker.create_topic(self.topic_name, self.config.num_partitions,
                                 self.config.retention_ms)
        self.broker.create_topic(self.error_topic, 1,
                                 self.config.retention_ms * 2)

        self._lock = make_rlock("core.runtime.SwarmDB._lock")
        self.registered_agents: Set[str] = set()
        self.consumers: Dict[str, Consumer] = {}
        self.messages: Dict[str, Message] = {}
        self.agent_inbox: Dict[str, List[Message]] = {}
        # unicast (a,b)-pair index: the prompt builder reads a window of
        # it once per served message, O(limit) instead of a full scan
        self._conversations: Dict[tuple, List[Message]] = {}
        self.agent_metadata: Dict[str, Dict[str, Any]] = {}
        self.metadata: Dict[str, Any] = {"llm_backends": {}}
        self.llm_load_balancing_enabled = False
        self.message_count = 0
        self._nparts_cache: Tuple[int, float] = (0, 0.0)
        self._closed = False
        self._stats_by_type: Dict[str, int] = {}
        self._stats_by_status: Dict[str, int] = {}
        self._stats_by_agent: Dict[str, Dict[str, int]] = {}

        # delivery-report poller: reports fire once a record clears the
        # broker's durability watermark; the loop spins only while reports
        # are outstanding and parks on the event otherwise
        self._poller_stop = threading.Event()
        self._poller_wake = threading.Event()
        self._poller = threading.Thread(
            target=self._delivery_poll_loop, name="swarmdb-delivery-poll",
            daemon=True)
        self._poller.start()

    def _delivery_poll_loop(self) -> None:
        while not self._poller_stop.is_set():
            if not self.producer.pending_count:
                self._poller_wake.wait(timeout=1.0)
                self._poller_wake.clear()
                continue
            try:
                self.producer.poll(0.02)
            except Exception:
                logger.exception("delivery poll failed")
            self._poller_stop.wait(0.005)

    # ------------------------------------------------------------------ setup

    def _count_tokens(self, content: MessageContent) -> Optional[int]:
        if self.token_counter is None:
            return None
        text = content if isinstance(content, str) else json.dumps(content)
        try:
            return int(self.token_counter(text))
        except Exception as exc:
            logger.warning("token counter failed: %s", exc)
            return None

    @staticmethod
    def _pair(a: str, b: str) -> tuple:
        return (a, b) if a <= b else (b, a)

    def num_partitions(self) -> int:
        """Partition count of the base topic, cached for about a second."""
        num, expires = self._nparts_cache
        now = time.monotonic()
        if num and now < expires:
            return num
        num = self.broker.list_topics()[self.topic_name].num_partitions
        self._nparts_cache = (num, now + 1.0)
        return num

    def _get_partition(self, agent_id: str) -> int:
        return stable_partition(agent_id, self.num_partitions())

    # --------------------------------------------------------------- registry

    def register_agent(self, agent_id: str,
                       metadata: Optional[Dict[str, Any]] = None) -> bool:
        """Register an agent and attach a consumer on its own partition.
        The consumer starts at the partition end: send_message registers
        the receiver before producing, so nothing addressed to the agent
        can predate it."""
        with self._lock:
            if agent_id in self.registered_agents:
                if metadata:
                    self.agent_metadata.setdefault(agent_id, {}).update(
                        metadata)
                return False
            self.registered_agents.add(agent_id)
            self.agent_inbox.setdefault(agent_id, [])
            if metadata:
                self.agent_metadata[agent_id] = dict(metadata)
            consumer = Consumer(
                self.broker,
                group_id=f"{self.config.group_id}_{agent_id}",
                auto_offset_reset="latest",
            )
            consumer.assign([(self.topic_name,
                              self._get_partition(agent_id))])
            self.consumers[agent_id] = consumer
            self.metrics.counters["agents_registered"].inc()
            return True

    # ------------------------------------------------------------------- send

    def _delivery_callback(self, err: Optional[str], record: Record) -> None:
        msg_id = record.key.decode() if record.key else None
        with self._lock:
            msg = self.messages.get(msg_id) if msg_id else None
            if msg is None:
                return
            if err is None:
                # upgrade only: the consumer may already have READ it
                if msg.status == MessageStatus.PENDING:
                    self._set_status(msg, MessageStatus.DELIVERED)
                msg.metadata.setdefault("partition", record.partition)
                msg.metadata.setdefault("offset", record.offset)
            else:
                self._set_status(msg, MessageStatus.FAILED)
                msg.metadata["error"] = err

    def send_message(
        self,
        sender_id: str,
        receiver_id: Optional[str],
        content: MessageContent,
        message_type: MessageType = MessageType.CHAT,
        priority: MessagePriority = MessagePriority.NORMAL,
        metadata: Optional[Dict[str, Any]] = None,
        visible_to: Optional[List[str]] = None,
    ) -> str:
        """Send one message; returns its id. ``receiver_id=None``
        broadcasts to every registered agent but the sender (a fan-out
        write to every partition)."""
        message_type = MessageType(message_type)
        priority = MessagePriority(priority)
        self.register_agent(sender_id)
        if receiver_id is not None:
            self.register_agent(receiver_id)
        msg = Message(
            sender_id=sender_id,
            receiver_id=receiver_id,
            content=content,
            type=message_type,
            priority=priority,
            metadata=dict(metadata or {}),
            token_count=self._count_tokens(content),
        )
        if receiver_id is None:
            with self._lock:
                everyone = self.registered_agents - {sender_id}
            msg.visible_to = sorted(everyone if visible_to is None
                                    else set(visible_to) & everyone)
        elif visible_to:
            msg.visible_to = list(visible_to)
        msg.stage_stamp("enqueued")

        with self._lock:
            self.messages[msg.id] = msg
            self._stats_record_new(msg)
            if receiver_id is not None:
                self.agent_inbox.setdefault(receiver_id, []).append(msg)
                self._conversations.setdefault(
                    self._pair(sender_id, receiver_id), []).append(msg)
            else:
                for agent in msg.visible_to:
                    self.agent_inbox.setdefault(agent, []).append(msg)
            self.message_count += 1

        if receiver_id is None and not msg.visible_to:
            with self._lock:
                self._set_status(msg, MessageStatus.DELIVERED)
            self.metrics.counters["messages_sent"].inc()
            return msg.id

        payload = json.dumps(msg.to_dict()).encode("utf-8")
        key = msg.id.encode("utf-8")
        try:
            if receiver_id is not None:
                self.producer.produce(
                    self.topic_name, payload, key=key,
                    partition=self._get_partition(receiver_id),
                    on_delivery=self._delivery_callback)
            else:
                for p in range(self.num_partitions()):
                    self.producer.produce(
                        self.topic_name, payload, key=key, partition=p,
                        on_delivery=self._delivery_callback)
            self.producer.poll(0)
            self._poller_wake.set()
        except Exception as exc:
            with self._lock:
                self._set_status(msg, MessageStatus.FAILED)
                msg.metadata["error"] = str(exc)
            try:
                self.producer.produce(self.error_topic, payload, key=key,
                                      partition=0)
            except Exception:
                logger.exception("error-topic produce failed for %s", msg.id)
            raise
        self.metrics.counters["messages_sent"].inc()
        self.metrics.rates["messages_sent"].mark()
        return msg.id

    # ---------------------------------------------------------------- receive

    def receive_messages(self, agent_id: str, max_messages: int = 10,
                         timeout: float = 5.0) -> List[Message]:
        """Poll the agent's partition for its messages, up to
        ``max_messages`` within ``timeout`` seconds (``timeout <= 0``
        drains what is already there); marks them READ."""
        self.register_agent(agent_id)
        with self._lock:
            consumer = self.consumers[agent_id]
        out: List[Message] = []
        deadline = time.time() + timeout
        while len(out) < max_messages:
            remaining = deadline - time.time()
            if timeout > 0 and remaining <= 0:
                break
            rec = consumer.poll(min(max(remaining, 0.0),
                                    self.config.consumer_timeout_ms / 1000.0))
            if rec is None:
                break
            try:
                msg = Message.from_dict(json.loads(rec.value.decode("utf-8")))
            except Exception as exc:
                logger.warning("undecodable record at %s[%d]@%d: %s",
                               rec.topic, rec.partition, rec.offset, exc)
                continue
            if msg.receiver_id not in (agent_id, None):
                continue
            if msg.receiver_id is None:
                if msg.sender_id == agent_id:
                    continue
                if msg.visible_to and agent_id not in msg.visible_to:
                    continue
            with self._lock:
                stored = self.messages.get(msg.id)
                target = stored if stored is not None else msg
                if msg.receiver_id is None:
                    read_by = target.metadata.setdefault("read_by", [])
                    if agent_id in read_by:
                        continue
                    read_by.append(agent_id)
                self._set_status(target, MessageStatus.READ)
                if stored is None:
                    self.messages[msg.id] = msg
                    self.agent_inbox.setdefault(agent_id, []).append(msg)
                    self._stats_record_new(msg)
                    if msg.receiver_id is not None:
                        self._conversations.setdefault(
                            self._pair(msg.sender_id, msg.receiver_id), []
                        ).append(msg)
            out.append(target)
            self.metrics.counters["messages_received"].inc()
        return out

    # ------------------------------------------------------------ read/query

    def conversation_length(self, agent_a: str, agent_b: str) -> int:
        """Total messages ever exchanged between the pair."""
        with self._lock:
            return len(self._conversations.get(
                self._pair(agent_a, agent_b), ()))

    def get_conversation_delta(self, agent_a: str, agent_b: str,
                               since: int) -> Tuple[int, List[Message]]:
        """(stream length, messages with stream index >= since) in send
        order, under one lock acquisition."""
        with self._lock:
            stream = self._conversations.get(self._pair(agent_a, agent_b),
                                             ())
            return len(stream), list(stream[max(0, since):])

    def get_conversation_window(self, agent_a: str, agent_b: str,
                                limit: int,
                                step: Optional[int] = None) -> List[Message]:
        """Window anchored in stream coordinates: old messages drop in
        ``step``-sized jumps (default ``limit // 2``) so consecutive
        prompts share a prefix the prefix cache can hit. Send order."""
        if limit <= 0:
            return []
        with self._lock:
            stream = self._conversations.get(self._pair(agent_a, agent_b),
                                             ())
            total = len(stream)
            keep = limit
            if total > limit:
                step = max(1, limit // 2 if step is None
                           else min(step, limit))
                start = -(-(total - limit) // step) * step
                keep = max(1, total - start)
            return list(stream[-keep:])

    # ------------------------------------------------------------- status mgmt

    def _set_status(self, msg: Message, status: MessageStatus) -> None:
        """Single choke-point for status transitions (caller holds the
        lock); keeps the by-status counters consistent."""
        old = msg.status
        if old == status:
            return
        msg.status = status
        self._stats_by_status[old.value] = max(
            0, self._stats_by_status.get(old.value, 0) - 1)
        self._stats_by_status[status.value] = (
            self._stats_by_status.get(status.value, 0) + 1)

    def update_message_status(self, message_id: str,
                              status: MessageStatus) -> bool:
        status = MessageStatus(status)
        with self._lock:
            msg = self.messages.get(message_id)
            if msg is None:
                return False
            self._set_status(msg, status)
            return True

    def mark_message_as_processed(self, message_id: str) -> bool:
        return self.update_message_status(message_id,
                                          MessageStatus.PROCESSED)

    # ------------------------------------------------------------------ stats

    def _stats_record_new(self, msg: Message) -> None:
        self._stats_by_type[msg.type.value] = (
            self._stats_by_type.get(msg.type.value, 0) + 1)
        self._stats_by_status[msg.status.value] = (
            self._stats_by_status.get(msg.status.value, 0) + 1)
        sender = self._stats_by_agent.setdefault(
            msg.sender_id, {"sent": 0, "received": 0})
        sender["sent"] += 1
        if msg.receiver_id is not None:
            recv = self._stats_by_agent.setdefault(
                msg.receiver_id, {"sent": 0, "received": 0})
            recv["received"] += 1

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "total_messages": len(self.messages),
                "message_count": self.message_count,
                "registered_agents": len(self.registered_agents),
                "messages_by_type": dict(self._stats_by_type),
                "messages_by_status": dict(self._stats_by_status),
                "messages_by_agent": {a: dict(c) for a, c
                                      in self._stats_by_agent.items()},
                "metrics": self.metrics.snapshot(),
            }

    # ------------------------------------------------------- LLM load balancer

    def set_llm_load_balancing(self, enabled: bool) -> None:
        with self._lock:
            self.llm_load_balancing_enabled = bool(enabled)

    def assign_llm_backend(self, agent_id: str, backend_id: str) -> None:
        """Route ``agent_id``'s incoming chat to the serving backend
        ``backend_id`` (the table ServingService consumers act on)."""
        with self._lock:
            self.metadata["llm_backends"][agent_id] = backend_id

    def get_llm_backend(self, agent_id: str) -> Optional[str]:
        with self._lock:
            return self.metadata["llm_backends"].get(agent_id)

    def agents_for_backend(self, backend_id: str) -> List[str]:
        with self._lock:
            return [a for a, b in self.metadata["llm_backends"].items()
                    if b == backend_id]

    # --------------------------------------------------------------- shutdown

    def close(self) -> None:
        """Stop the delivery poller, flush reports, close consumers."""
        if self._closed:
            return
        self._closed = True
        self._poller_stop.set()
        self._poller_wake.set()
        self._poller.join(timeout=1.0)
        try:
            self.producer.flush()
        except Exception:
            logger.exception("final producer flush failed")
        with self._lock:
            consumers = list(self.consumers.values())
        for c in consumers:
            c.close()
        self.broker.close()

    def __enter__(self) -> "SwarmDB":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
