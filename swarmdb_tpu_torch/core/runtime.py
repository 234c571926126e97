"""SwarmDB -- the multi-agent messaging runtime.

The counterpart of ``swarmdb_tpu/core/runtime.py`` with its whole
surface: agent registration and deregistration with a partition-affine
consumer, unicast / broadcast / group send, polled receive, lookup, query,
search and conversations (the index the serving path's prompt builder
reads), status transitions and resend of failed messages, JSON / YAML
persistence with autosave and a final save on ``close``, archive of old
messages, incremental stats and agent load, the agent -> backend routing
table and partition autoscaling, and the online SLO sentinel
(``self.sentinel``, one per runtime over its metrics registry, which the
serving engine shares; the send path probes its window).

The broker is chosen as the JAX package chooses it: the native C++ engine
(``broker/native.py``) when ``implementation`` is ``auto`` and its library
builds, or always under ``native`` (which raises if it cannot); the
pure-Python ``LocalBroker`` under ``python``. ``replication_factor`` N > 1
wraps it in a ``ReplicatedBroker`` streaming to the N - 1 followers named
in ``SWARMDB_REPLICA_TARGETS``; ``SWARMDB_HA_CLUSTER`` (without
``SWARMDB_HA_NODE_ID``) makes the runtime a client of an HA cluster
through a ``ClusterBroker``. The send path activates the message's trace
context around the publish, and those wire clients carry it across
processes.

Semantics kept from the JAX package: stable FNV-1a partition routing,
consumers that read only their own partition, broadcast as a fan-out
write to every partition, one RLock around all shared state, acks-all
delivery reports fired by a background poller, and resend that stamps
the failed original so a second call resends nothing.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..broker.base import Broker, Consumer, Producer, Record
from ..obs import TRACER, propagate
from ..obs.metrics import HIST_PUBLISH
from ..obs.sentinel import SLOSentinel
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


def _default_broker(config: BrokerConfig) -> Broker:
    """Pick the broker implementation as the JAX package does: the native
    C++ engine when its library builds and ``auto`` or ``native`` asks
    for it, else the pure-Python LocalBroker. ``native`` raises when the
    library cannot be built or loaded."""
    impl = config.implementation
    if impl in ("auto", "native"):
        try:
            from ..broker.native import NativeBroker, native_available

            if native_available():
                return NativeBroker(log_dir=config.log_dir)
            if impl == "native":
                raise RuntimeError(
                    "native broker requested but its library could not be "
                    "built")
        except ImportError:
            if impl == "native":
                raise
    from ..broker.local import LocalBroker

    return LocalBroker()


def replica_targets(config: BrokerConfig) -> List[str]:
    """The follower endpoints ``replication_factor`` N > 1 needs: N - 1
    ``host:port`` entries of ``SWARMDB_REPLICA_TARGETS``, each running
    ``python -m swarmdb_tpu_torch.broker.replica``. A factor without its
    followers is refused: running single-node would misrepresent what a
    DELIVERED report implies."""
    if config.replication_factor <= 1:
        return []
    targets = [t.strip() for t in
               os.environ.get("SWARMDB_REPLICA_TARGETS", "").split(",")
               if t.strip()]
    if len(targets) < config.replication_factor - 1:
        raise ValueError(
            f"replication_factor={config.replication_factor} needs "
            f"{config.replication_factor - 1} follower endpoints in "
            f"SWARMDB_REPLICA_TARGETS (found {len(targets)}); run followers "
            "with `python -m swarmdb_tpu_torch.broker.replica` or use "
            "replication_factor=1 (single-node group-commit fsync).")
    return targets


class SwarmDB:
    """Messaging runtime over an in-tree broker (LocalBroker by default)."""

    def __init__(
        self,
        config: Optional[BrokerConfig] = None,
        topic_name: str = "swarm_messages",
        save_dir: str = "message_history",
        autosave_interval: float = 300.0,
        max_messages_per_file: int = 10_000,
        token_counter: Optional[Callable[[str], int]] = None,
        broker: Optional[Broker] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.config = config or BrokerConfig()
        self.topic_name = topic_name
        self.error_topic = f"{topic_name}_errors"
        self.save_dir = save_dir
        self.autosave_interval = autosave_interval
        self.max_messages_per_file = max_messages_per_file
        self.token_counter = token_counter
        self.metrics = metrics or MetricsRegistry()
        # the online SLO sentinel (GET /admin/slo): one per runtime,
        # watching the shared registry the serving engine records into;
        # the send path and the engine loop drive its window closes.
        # SWARMDB_SENTINEL=0 turns it off
        self.sentinel = SLOSentinel(metrics=self.metrics)
        targets = replica_targets(self.config)
        # HA client mode: SWARMDB_HA_CLUSTER names a shared cluster-map
        # file and this runtime writes through whichever node leads (a
        # process with SWARMDB_HA_NODE_ID set is itself a node: the server
        # hands it the node's client broker instead)
        ha_cluster = os.environ.get("SWARMDB_HA_CLUSTER") or None
        if (broker is None and ha_cluster
                and not os.environ.get("SWARMDB_HA_NODE_ID")):
            from ..ha.client import ClusterBroker, data_plane_opener
            from ..ha.cluster import FileClusterMap

            broker = ClusterBroker(FileClusterMap(ha_cluster),
                                   data_plane_opener())
        self.broker: Broker = (broker if broker is not None
                               else _default_broker(self.config))
        if targets:
            from ..broker.replica import ReplicatedBroker

            self.broker = ReplicatedBroker(self.broker, targets)
        self.producer = Producer(self.broker)
        self._ensure_topics_exist()

        self._lock = make_rlock("core.runtime.SwarmDB._lock")
        # swarmlint: guarded-by[self._lock]: registered_agents, messages, agent_inbox, _conversations, message_count, _stats_by_type, _stats_by_status, _stats_by_agent
        self.registered_agents: Set[str] = set()
        self.consumers: Dict[str, Consumer] = {}
        self.messages: Dict[str, Message] = {}
        self.agent_inbox: Dict[str, List[Message]] = {}
        # unicast (a,b)-pair index: the prompt builder reads a window of
        # it once per served message, O(limit) instead of a full scan
        self._conversations: Dict[tuple, List[Message]] = {}
        self.agent_metadata: Dict[str, Dict[str, Any]] = {}
        self.metadata: Dict[str, Any] = {"agent_groups": {},
                                         "llm_backends": {}}
        self.llm_load_balancing_enabled = False
        self.message_count = 0
        self._last_save_time = time.time()
        self._sends_since_save = 0
        self._prescale_ends: Dict[int, int] = {}
        self._nparts_cache: Tuple[int, float] = (0, 0.0)
        self._closed = False
        self._stats_by_type: Dict[str, int] = {}
        self._stats_by_status: Dict[str, int] = {}
        self._stats_by_agent: Dict[str, Dict[str, int]] = {}

        os.makedirs(self.save_dir, exist_ok=True)

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

    def _ensure_topics_exist(self) -> None:
        """Create the base topic and ``{base}_errors`` (one partition, twice
        the retention). With a partition-routed broker the create is an
        admin op against the controller, and a runtime booting beside its
        cluster can race the first promotion: a retryable failure
        (LeaderChangedError) is retried for ``SWARMDB_TOPIC_WAIT_S``
        (default 10 s) instead of failing the runtime."""
        deadline = time.monotonic() + float(
            os.environ.get("SWARMDB_TOPIC_WAIT_S", "10"))
        while True:
            try:
                self.broker.create_topic(
                    self.topic_name, self.config.num_partitions,
                    self.config.retention_ms)
                self.broker.create_topic(self.error_topic, 1,
                                         self.config.retention_ms * 2)
                return
            except Exception as exc:
                if (not getattr(exc, "retryable", False)
                        or time.monotonic() >= deadline):
                    raise
                time.sleep(0.1)

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
        """Partition count of the base topic, cached for about a second
        (growth through ``auto_scale_partitions`` clears the cache)."""
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
                       metadata: Optional[Dict[str, Any]] = None,
                       adopt_backlog: bool = False) -> bool:
        """Register an agent and attach a consumer on its own partition.
        The consumer starts at the partition end: send_message registers
        the receiver before producing, so nothing addressed to the agent
        can predate it. ``adopt_backlog`` starts it at the beginning
        instead, for an agent whose records another process produced."""
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
                auto_offset_reset="earliest" if adopt_backlog else "latest",
            )
            consumer.assign([(self.topic_name,
                              self._get_partition(agent_id))])
            self.consumers[agent_id] = consumer
            self.metrics.counters["agents_registered"].inc()
            return True

    def deregister_agent(self, agent_id: str) -> bool:
        """Remove an agent and close its consumer; its inbox and per-agent
        stats stay (its messages remain queryable)."""
        with self._lock:
            if agent_id not in self.registered_agents:
                return False
            self.registered_agents.discard(agent_id)
            consumer = self.consumers.pop(agent_id, None)
            if consumer is not None:
                consumer.close()
            self.agent_metadata.pop(agent_id, None)
            self.metrics.rates.pop(f"agent_recv:{agent_id}", None)
            return True

    def _reassign_consumers(self) -> None:
        """After partition growth, add each agent's newly mapped partition
        to its consumer and keep the old one, so the old partition's
        backlog still drains and the new one starts at its pre-growth
        end (no broadcast replay)."""
        with self._lock:
            for agent_id, consumer in self.consumers.items():
                part = self._get_partition(agent_id)
                consumer.add_assignment(
                    self.topic_name, part,
                    start_offset=self._prescale_ends.get(part))

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
        write to every partition); an explicit ``visible_to`` (even
        empty) narrows it."""
        t_send = TRACER.span_begin()
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
            self._sends_since_save += 1

        if receiver_id is None and not msg.visible_to:
            # a broadcast nobody may see: nothing to put on the wire (an
            # empty visible_to there would mean "everyone")
            with self._lock:
                self._set_status(msg, MessageStatus.DELIVERED)
            self.metrics.counters["messages_sent"].inc()
            TRACER.span_end(t_send, "runtime.send", cat="runtime",
                            rid=msg.id)
            return msg.id

        payload = json.dumps(msg.to_dict()).encode("utf-8")
        key = msg.id.encode("utf-8")
        t_pub = TRACER.span_begin()
        t_pub_mono = time.monotonic()
        try:
            # the publish hop's trace context: trace id = message id, the
            # join key every local span carries as rid
            with propagate.use(propagate.TraceContext(msg.id)):
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
            retryable = getattr(exc, "retryable", False)
            with self._lock:
                self._set_status(msg, MessageStatus.FAILED)
                msg.metadata["error"] = str(exc)
                if retryable:
                    # mid-failover (LeaderChangedError): the caller's retry
                    # or resend_failed_messages lands it on the new leader
                    # as a new message, so this one leaves the conversation
                    # (kept, a prompt's history would hold it twice)
                    msg.metadata["retryable"] = True
                    if receiver_id is not None:
                        convo = self._conversations.get(
                            self._pair(sender_id, receiver_id), [])
                        for i in range(len(convo) - 1, -1, -1):
                            if convo[i] is msg:
                                del convo[i]
                                break
            if not retryable:
                # (a retryable failure skips the error-topic copy: it would
                # go through the same dead leader)
                try:
                    self.producer.produce(self.error_topic, payload, key=key,
                                          partition=0)
                except Exception:
                    logger.exception("error-topic produce failed for %s",
                                     msg.id)
            raise
        TRACER.span_end(t_pub, "broker.publish", cat="broker", rid=msg.id)
        HIST_PUBLISH.observe(time.monotonic() - t_pub_mono, msg.id)
        self.metrics.counters["messages_sent"].inc()
        self.metrics.rates["messages_sent"].mark()
        self._maybe_autosave()
        TRACER.span_end(t_send, "runtime.send", cat="runtime", rid=msg.id)
        # the sentinel's window probe (one compare): a runtime without an
        # engine loop still closes windows
        self.sentinel.maybe_tick()
        return msg.id

    def broadcast_message(
        self,
        sender_id: str,
        content: MessageContent,
        message_type: MessageType = MessageType.CHAT,
        priority: MessagePriority = MessagePriority.NORMAL,
        metadata: Optional[Dict[str, Any]] = None,
        exclude_agents: Optional[Sequence[str]] = None,
    ) -> str:
        """Broadcast to every registered agent but the sender and the
        excluded ones."""
        with self._lock:
            visible = sorted(self.registered_agents - {sender_id}
                             - set(exclude_agents or ()))
        return self.send_message(sender_id, None, content,
                                 message_type=message_type,
                                 priority=priority, metadata=metadata,
                                 visible_to=visible)

    # ---------------------------------------------------------------- receive

    def receive_messages(self, agent_id: str, max_messages: int = 10,
                         timeout: float = 5.0) -> List[Message]:
        """Poll the agent's partition for its messages, up to
        ``max_messages`` within ``timeout`` seconds (``timeout <= 0``
        drains what is already there); marks them READ."""
        self.register_agent(agent_id)
        with self._lock:
            consumer = self.consumers[agent_id]
        t_recv = TRACER.span_begin()
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
                    # one broadcast copy per partition: a consumer holding
                    # several partitions dedups through read_by
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
            self.metrics.rates[f"agent_recv:{agent_id}"].mark()
        if out:
            TRACER.span_end(t_recv, "runtime.receive", cat="runtime",
                            rid=out[0].id)
        return out

    # ------------------------------------------------------------ read/query

    def get_message(self, message_id: str) -> Optional[Message]:
        with self._lock:
            return self.messages.get(message_id)

    def get_agent_messages(self, agent_id: str,
                           status: Optional[MessageStatus] = None,
                           limit: int = 100, skip: int = 0) -> List[Message]:
        """Inbox pagination, newest first."""
        with self._lock:
            inbox = list(reversed(self.agent_inbox.get(agent_id, [])))
        if status is not None:
            status = MessageStatus(status)
            inbox = [m for m in inbox if m.status == status]
        return inbox[skip:skip + limit]

    def query_messages(
        self,
        sender_id: Optional[str] = None,
        receiver_id: Optional[str] = None,
        message_type: Optional[MessageType] = None,
        status: Optional[MessageStatus] = None,
        start_time: Optional[float] = None,
        end_time: Optional[float] = None,
        limit: int = 100,
        involving: Optional[str] = None,
    ) -> List[Message]:
        """Multi-filter scan, newest first. ``involving`` keeps only the
        messages the agent takes part in (sender, receiver or visible_to),
        applied before the limit."""
        message_type = (MessageType(message_type)
                        if message_type is not None else None)
        status = MessageStatus(status) if status is not None else None
        if limit <= 0:
            return []
        with self._lock:
            msgs = list(self.messages.values())
        out = []
        for m in sorted(msgs, key=lambda m: m.timestamp, reverse=True):
            if sender_id is not None and m.sender_id != sender_id:
                continue
            if receiver_id is not None and m.receiver_id != receiver_id:
                continue
            if message_type is not None and m.type != message_type:
                continue
            if status is not None and m.status != status:
                continue
            if start_time is not None and m.timestamp < start_time:
                continue
            if end_time is not None and m.timestamp > end_time:
                continue
            if (involving is not None
                    and involving not in (m.sender_id, m.receiver_id)
                    and involving not in m.visible_to):
                continue
            out.append(m)
            if len(out) >= limit:
                break
        return out

    def search_messages(self, keyword: str, case_sensitive: bool = False,
                        limit: int = 100) -> List[Message]:
        """Keyword search over content (structured content as JSON),
        newest first."""
        if limit <= 0:
            return []
        needle = keyword if case_sensitive else keyword.lower()
        with self._lock:
            msgs = list(self.messages.values())
        out = []
        for m in sorted(msgs, key=lambda m: m.timestamp, reverse=True):
            hay = (m.content if isinstance(m.content, str)
                   else json.dumps(m.content))
            if not case_sensitive:
                hay = hay.lower()
            if needle in hay:
                out.append(m)
                if len(out) >= limit:
                    break
        return out

    def get_conversation(self, agent_a: str, agent_b: str,
                         limit: int = 100) -> List[Message]:
        """The pair's newest ``limit`` messages, chronological."""
        if limit <= 0:
            return []
        with self._lock:
            tail = list(self._conversations.get(
                self._pair(agent_a, agent_b), ())[-limit:])
        return sorted(tail, key=lambda m: m.timestamp)

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

    # swarmlint: holds[self._lock]
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

    def resend_failed_messages(self) -> List[str]:
        """Re-send every FAILED message as a new one with
        ``metadata.resent_from``; the original gets ``resent_to`` and is
        skipped next time, so a repeated call resends nothing."""
        with self._lock:
            failed = [m for m in self.messages.values()
                      if m.status == MessageStatus.FAILED
                      and "resent_to" not in m.metadata]
        new_ids: List[str] = []
        for m in failed:
            new_id = self.send_message(
                m.sender_id, m.receiver_id, m.content, message_type=m.type,
                priority=m.priority,
                metadata={**m.metadata, "resent_from": m.id})
            with self._lock:
                m.metadata["resent_to"] = new_id
            new_ids.append(new_id)
        return new_ids

    # ----------------------------------------------------------------- groups

    def add_agent_group(self, group_name: str,
                        agent_ids: Sequence[str]) -> bool:
        """Create or replace a named group (its members are registered)."""
        for a in agent_ids:
            self.register_agent(a)
        with self._lock:
            self.metadata["agent_groups"][group_name] = list(agent_ids)
        return True

    def get_agent_group(self, group_name: str) -> Optional[List[str]]:
        with self._lock:
            members = self.metadata["agent_groups"].get(group_name)
            return list(members) if members is not None else None

    def send_to_group(
        self,
        sender_id: str,
        group_name: str,
        content: MessageContent,
        message_type: MessageType = MessageType.CHAT,
        priority: MessagePriority = MessagePriority.NORMAL,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> List[str]:
        """One unicast per member but the sender, each stamped with
        ``metadata.group``; KeyError for an unknown group."""
        members = self.get_agent_group(group_name)
        if members is None:
            raise KeyError(f"unknown group: {group_name}")
        return [self.send_message(sender_id, member, content,
                                  message_type=message_type,
                                  priority=priority,
                                  metadata={**(metadata or {}),
                                            "group": group_name})
                for member in members if member != sender_id]

    # ------------------------------------------------------------ persistence

    def _snapshot_state(self) -> Dict[str, Any]:
        """{messages, agent_inbox, registered_agents, timestamp,
        message_count}: the JAX package's snapshot schema."""
        with self._lock:
            return {
                "messages": {mid: m.to_dict()
                             for mid, m in self.messages.items()},
                "agent_inbox": {a: [m.id for m in inbox]
                                for a, inbox in self.agent_inbox.items()},
                "registered_agents": sorted(self.registered_agents),
                "timestamp": time.time(),
                "message_count": self.message_count,
            }

    def save_message_history(self, filepath: Optional[str] = None) -> str:
        """JSON snapshot to ``filepath`` (default a timestamped file in
        ``save_dir``), written atomically; returns the path."""
        if filepath is None:
            filepath = os.path.join(
                self.save_dir, f"message_history_{int(time.time())}.json")
        state = self._snapshot_state()
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        tmp = f"{filepath}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=2)
        os.replace(tmp, filepath)
        with self._lock:
            self._last_save_time = time.time()
            self._sends_since_save = 0
        return filepath

    def load_message_history(self, filepath: str) -> int:
        """Restore a snapshot: messages, inboxes, re-registered agents.
        Returns the number of messages loaded."""
        with open(filepath) as f:
            state = json.load(f)
        msgs = {mid: Message.from_dict(d)
                for mid, d in state["messages"].items()}
        with self._lock:
            self.messages.update(msgs)
            self._rebuild_stats()
            for agent, ids in state.get("agent_inbox", {}).items():
                inbox = self.agent_inbox.setdefault(agent, [])
                known = {m.id for m in inbox}
                inbox.extend(msgs[mid] for mid in ids
                             if mid in msgs and mid not in known)
            self.message_count = state.get("message_count",
                                           len(self.messages))
        for agent in state.get("registered_agents", []):
            self.register_agent(agent)
        return len(msgs)

    def export_as_yaml(self, filepath: Optional[str] = None) -> str:
        """YAML export of the same snapshot."""
        import yaml

        if filepath is None:
            filepath = os.path.join(
                self.save_dir, f"message_history_{int(time.time())}.yaml")
        with open(filepath, "w") as f:
            yaml.safe_dump(self._snapshot_state(), f, sort_keys=False)
        return filepath

    def _maybe_autosave(self) -> None:
        """Autosave every ``autosave_interval`` seconds or
        ``max_messages_per_file`` sends."""
        with self._lock:
            due = (time.time() - self._last_save_time
                   >= self.autosave_interval
                   or self._sends_since_save >= self.max_messages_per_file)
        if due:
            try:
                self.save_message_history()
            except Exception:
                logger.exception("autosave failed")

    # --------------------------------------------------------------------- GC

    def delete_message(self, message_id: str) -> bool:
        """Remove from the store, every inbox and the conversation index."""
        with self._lock:
            msg = self.messages.pop(message_id, None)
            if msg is None:
                return False
            self._stats_record_removed(msg)
            for inbox in self.agent_inbox.values():
                inbox[:] = [m for m in inbox if m.id != message_id]
            if msg.receiver_id is not None:
                convo = self._conversations.get(
                    self._pair(msg.sender_id, msg.receiver_id))
                if convo is not None:
                    convo[:] = [m for m in convo if m.id != message_id]
            return True

    def flush_old_messages(self,
                           max_age_seconds: float = 7 * 24 * 3600) -> int:
        """Archive to ``save_dir/archives/``, then delete, every message
        older than the cutoff; the broker log is trimmed to match."""
        cutoff = time.time() - max_age_seconds
        with self._lock:
            old = [m for m in self.messages.values() if m.timestamp < cutoff]
        if not old:
            return 0
        archive_dir = os.path.join(self.save_dir, "archives")
        os.makedirs(archive_dir, exist_ok=True)
        path = os.path.join(archive_dir, f"archive_{int(time.time())}.json")
        with open(path, "w") as f:
            json.dump({"messages": [m.to_dict() for m in old],
                       "archived_at": time.time()}, f, indent=2)
        for m in old:
            self.delete_message(m.id)
        self.broker.trim_older_than(self.topic_name, cutoff)
        return len(old)

    # ------------------------------------------------------------------ stats

    # swarmlint: holds[self._lock]
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

    # swarmlint: holds[self._lock]
    def _stats_record_removed(self, msg: Message) -> None:
        self._stats_by_type[msg.type.value] = max(
            0, self._stats_by_type.get(msg.type.value, 0) - 1)
        self._stats_by_status[msg.status.value] = max(
            0, self._stats_by_status.get(msg.status.value, 0) - 1)
        sender = self._stats_by_agent.get(msg.sender_id)
        if sender is not None:
            sender["sent"] = max(0, sender["sent"] - 1)
        if msg.receiver_id is not None:
            recv = self._stats_by_agent.get(msg.receiver_id)
            if recv is not None:
                recv["received"] = max(0, recv["received"] - 1)

    # swarmlint: holds[self._lock]
    def _rebuild_stats(self) -> None:
        self._stats_by_type = {}
        self._stats_by_status = {}
        self._stats_by_agent = {}
        self._conversations = {}
        for m in sorted(self.messages.values(), key=lambda m: m.timestamp):
            self._stats_record_new(m)
            if m.receiver_id is not None:
                self._conversations.setdefault(
                    self._pair(m.sender_id, m.receiver_id), []).append(m)

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

    def get_unread_message_count(self, agent_id: str) -> int:
        """Unread = DELIVERED inbox entries."""
        with self._lock:
            return sum(1 for m in self.agent_inbox.get(agent_id, [])
                       if m.status == MessageStatus.DELIVERED)

    def get_agent_load(self, agent_id: str) -> Dict[str, Any]:
        """Inbox size, unread count and messages/s received over the last
        60 s."""
        with self._lock:
            return {
                "agent_id": agent_id,
                "inbox_size": len(self.agent_inbox.get(agent_id, [])),
                "unread_count": self.get_unread_message_count(agent_id),
                "messages_per_second":
                    self.metrics.rates[f"agent_recv:{agent_id}"].rate(),
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

    # -------------------------------------------------------------- autoscale

    def auto_scale_partitions(self) -> int:
        """Grow the base topic to ``max(3, ceil(agents / 10) * 3)``
        partitions, never shrinking; returns the (possibly new) count."""
        with self._lock:
            n_agents = len(self.registered_agents)
        recommended = max(3, math.ceil(n_agents / 10) * 3)
        current = self.broker.list_topics()[self.topic_name].num_partitions
        if recommended <= current:
            return current
        # pre-growth ends first: a send racing the growth is not skipped,
        # and pre-growth history is not replayed
        self._prescale_ends = {p: self.broker.end_offset(self.topic_name, p)
                               for p in range(current)}
        self._prescale_ends.update({p: 0 for p in range(current,
                                                         recommended)})
        self.broker.create_partitions(self.topic_name, recommended)
        self._nparts_cache = (0, 0.0)
        self._reassign_consumers()
        return recommended

    # --------------------------------------------------------------- shutdown

    def close(self) -> None:
        """Stop the delivery poller, flush reports, save a final
        snapshot, close consumers and the broker."""
        if self._closed:
            return
        self._closed = True
        self._poller_stop.set()
        self._poller_wake.set()
        self._poller.join(timeout=1.0)
        # flush before the snapshot, or it freezes messages at PENDING
        try:
            self.producer.flush()
        except Exception:
            logger.exception("final producer flush failed")
        try:
            self.save_message_history()
        except Exception:
            logger.exception("final autosave failed")
        with self._lock:
            consumers = list(self.consumers.values())
        for c in consumers:
            c.close()
        # again: the consumers' final offset commits reach the broker's
        # snapshot (a snapshot-mode LocalBroker persists on flush)
        self.producer.flush()
        self.broker.close()

    def __enter__(self) -> "SwarmDB":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# the upstream project's class name
SwarmsDB = SwarmDB
