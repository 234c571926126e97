"""Network data plane: the Broker surface served over TCP.

Why this exists: a cross-process client cannot share a broker engine
with the leader node — a second :class:`NativeBroker` handle over the
same log dir snapshots at open (no visibility into the live engine's
tail) and, worse, its appends would bypass the leader's replication
entirely, so nothing the client wrote would survive a failover. The
data plane closes that hole: every client operation executes inside the
node process against :attr:`HANode.broker_facade` — the same acks=all +
fencing surface the embedded runtime writes through — so client appends
replicate, fencing applies, and zero-loss failover holds for remote
clients too.

Protocol (one TCP stream per client connection, many requests):
length-prefixed JSON both ways — ``<u32 len><json>``. Request
``{"op": name, "a": {kwargs}, "tc": {trace-context}?}``; response
``{"ok": result}`` or ``{"err": ExceptionName, "msg": str}``. Bytes
travel base64; records as ``[partition-invariant dicts]``. Blocking ops
(``wait_for_data`` / ``wait_durable``) block server-side on the
connection's thread; the client stretches its socket deadline by the
op's own timeout.

Tracing: the client injects the thread's current trace
context (``obs/propagate.py``) into each envelope and records the op's
round-trip into the ``dataplane_rtt_seconds`` histogram plus — when a
trace is active — a ``dataplane.call`` client span. The server
activates the received context around the dispatch and records a
``dataplane.<op>`` span in ITS process's ring, so one message id joins
client and node-side spans across processes. The reserved
``trace_export`` op returns the node's own bounded Chrome-trace export
(``GET /admin/cluster/trace`` fans out over it to merge the cluster's
rings into one timeline).

Failure mapping keeps :class:`~swarmdb_tpu_torch.ha.client.ClusterBroker`'s
contract intact: a dead/partitioned node surfaces as ``ConnectionError``
(transient → re-resolve the leader), a fenced or unknown-topic error is
re-raised under its own class, anything else as ``BrokerError``.

Partition-level leadership needs no wire change here: the
server always dispatches against ``HANode.broker_facade``, which in
partition mode is the partition-replicated facade — a remote append to
a partition this node no longer leases raises the partition-scoped
``FencedError`` across the wire, and the ClusterBroker that dialed us
re-routes to the partition's current leader.
"""

from __future__ import annotations

import base64
import json
import logging
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..broker.base import (Broker, BrokerError, FencedError,
                           LeaderChangedError, Record, TopicMeta,
                           UnknownTopicError)
from ..obs import TRACER, propagate
from ..obs.metrics import HIST_DATAPLANE_RTT
from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.ha")

__all__ = ["DataPlaneServer", "RemoteBroker"]

_LEN = struct.Struct("<I")
_MAX_FRAME = 64 * 1024 * 1024
#: errors that cross the wire under their own name (everything else is
#: flattened to BrokerError — the client must not grow a failure surface
#: the Broker interface doesn't have)
_WIRE_ERRORS = {
    "FencedError": FencedError,
    "UnknownTopicError": UnknownTopicError,
    "LeaderChangedError": LeaderChangedError,
    "BrokerError": BrokerError,
}


def _b64(data: Optional[bytes]) -> Optional[str]:
    return None if data is None else base64.b64encode(data).decode("ascii")


def _unb64(data: Optional[str]) -> Optional[bytes]:
    return None if data is None else base64.b64decode(data)


def _send_frame(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj).encode("utf-8")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Optional[Any]:
    head = b""
    while len(head) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(head))
        if not chunk:
            return None  # clean EOF between frames
        head += chunk
    (n,) = _LEN.unpack(head)
    if n > _MAX_FRAME:
        raise ConnectionError(f"data-plane frame too large ({n} bytes)")
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            raise ConnectionError("data-plane stream truncated mid-frame")
        buf += chunk
    return json.loads(bytes(buf).decode("utf-8"))


def _rec_out(rec: Record) -> Dict[str, Any]:
    return {"t": rec.topic, "p": rec.partition, "o": rec.offset,
            "k": _b64(rec.key), "v": _b64(rec.value), "ts": rec.timestamp}


def _rec_in(d: Dict[str, Any]) -> Record:
    return Record(topic=d["t"], partition=d["p"], offset=d["o"],
                  key=_unb64(d.get("k")), value=_unb64(d["v"]) or b"",
                  timestamp=d["ts"])


class DataPlaneServer:
    """Serves a (role-changing) broker facade over TCP.

    ``get_broker`` is re-evaluated per request — pass
    ``lambda: node.broker_facade`` so a promotion/deposal takes effect on
    the very next client operation, exactly like the embedded
    :class:`~swarmdb_tpu_torch.ha.node.NodeBroker`. A facade that raises
    ``ConnectionError`` (chaos-killed node) tears the connection down,
    which is what a dead process's sockets would do.
    """

    def __init__(self, get_broker: Callable[[], Broker],
                 host: str = "127.0.0.1", port: int = 0, *,
                 gate: Optional[Callable[[], bool]] = None,
                 node_id: Optional[str] = None) -> None:
        self._get_broker = get_broker
        self.gate = gate
        # identity stamped onto trace_export responses so the cluster
        # merge can label each ring's source even when several
        # in-process nodes share one tracer
        self.node_id = node_id or propagate.node_id()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self.host, self.port = self._listener.getsockname()
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns_lock = make_lock("ha.dataplane.DataPlaneServer._conns_lock")
        # swarmlint: guarded-by[self._conns_lock]: _conns
        self._conns: List[socket.socket] = []

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "DataPlaneServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"swarmdb-dataplane-{self.port}")
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for op in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                   self._listener.close):
            try:
                op()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)

    def drop_connections(self) -> None:
        """Cut live client streams (chaos partition)."""
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            for op in (lambda c=conn: c.shutdown(socket.SHUT_RDWR),
                       conn.close):
                try:
                    op()
                except OSError:
                    pass

    # ------------------------------------------------------------------ serve

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            if self.gate is not None and not self.gate():
                try:
                    conn.close()  # chaos partition: client sees EOF
                except OSError:
                    pass
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="swarmdb-dataplane-conn")
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                req = _recv_frame(conn)
                if req is None:
                    return
                if self.gate is not None and not self.gate():
                    return  # mid-stream partition
                try:
                    result = self._traced_dispatch(req)
                except ConnectionError:
                    return  # node is dead: look exactly like one
                except BrokerError as exc:
                    name = type(exc).__name__
                    _send_frame(conn, {
                        "err": name if name in _WIRE_ERRORS else "BrokerError",
                        "msg": str(exc)})
                    continue
                except Exception as exc:  # defensive: never kill the conn
                    logger.exception("data-plane op %r failed",
                                     req.get("op"))
                    _send_frame(conn, {"err": "BrokerError", "msg": str(exc)})
                    continue
                _send_frame(conn, {"ok": result})
        except (OSError, ValueError, ConnectionError):
            pass
        finally:
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _traced_dispatch(self, req: Dict[str, Any]) -> Any:
        """Activate the caller's trace context (if any) for the dispatch
        and record the node-side span: the cross-process half of the one
        trace a message produces (rid = the propagated trace id)."""
        op = req.get("op", "")
        a = req.get("a", {})
        ctx = propagate.extract(req.get("tc"))
        if ctx is None:
            return self._dispatch(op, a)
        t0 = TRACER.span_begin()
        try:
            with propagate.use(ctx.child()):
                return self._dispatch(op, a)
        finally:
            TRACER.span_end(t0, f"dataplane.{op}", cat="dataplane",
                            rid=ctx.trace_id,
                            args={"origin": ctx.origin,
                                  "node": self.node_id})

    def _dispatch(self, op: str, a: Dict[str, Any]) -> Any:
        if op == "trace_export":
            # observability op: serves THIS node's span ring (bounded),
            # labeled with the node id — never touches the broker, so it
            # works on fenced/deposed nodes too (a failover post-mortem
            # needs exactly those rings)
            trace = TRACER.to_chrome_trace(
                last_n=a.get("last_n"), rid=a.get("trace_id"),
                max_events=a.get("max_events"))
            return {"node": self.node_id, "trace": trace}
        b = self._get_broker()
        if op == "append":
            return b.append(a["topic"], a["partition"], _unb64(a["value"]),
                            key=_unb64(a.get("key")),
                            timestamp=a.get("timestamp"))
        if op == "fetch":
            return [_rec_out(r) for r in
                    b.fetch(a["topic"], a["partition"], a["offset"],
                            a.get("max_records", 256))]
        if op == "end_offset":
            return b.end_offset(a["topic"], a["partition"])
        if op == "begin_offset":
            return b.begin_offset(a["topic"], a["partition"])
        if op == "wait_for_data":
            return b.wait_for_data(a["topic"], a["partition"], a["offset"],
                                   a["timeout_s"])
        if op == "wait_durable":
            return b.wait_durable(a["topic"], a["partition"], a["offset"],
                                  a["timeout_s"])
        if op == "durable_offset":
            return b.durable_offset(a["topic"], a["partition"])
        if op == "commit_offset":
            return b.commit_offset(a["group"], a["topic"], a["partition"],
                                   a["offset"])
        if op == "committed_offset":
            return b.committed_offset(a["group"], a["topic"], a["partition"])
        if op == "create_topic":
            return b.create_topic(a["name"], a["num_partitions"],
                                  retention_ms=a["retention_ms"])
        if op == "list_topics":
            return {name: {"num_partitions": m.num_partitions,
                           "retention_ms": m.retention_ms}
                    for name, m in b.list_topics().items()}
        if op == "create_partitions":
            return b.create_partitions(a["name"], a["new_total"])
        if op == "trim_older_than":
            return b.trim_older_than(a["topic"], a["cutoff_ts"])
        if op == "flush":
            return b.flush()
        if op == "healthy":
            return bool(b.healthy())
        raise BrokerError(f"unknown data-plane op {op!r}")


class RemoteBroker(Broker):
    """Client half: a Broker whose every call executes in the node
    process at ``addr``. Connections are pooled (one in flight per
    socket); any transport failure closes the socket and surfaces as
    ``ConnectionError`` — :class:`~swarmdb_tpu_torch.ha.client.ClusterBroker`
    turns that into re-resolve + :class:`LeaderChangedError`."""

    _POOL_MAX = 4

    def __init__(self, addr: str, *, timeout_s: float = 5.0) -> None:
        host, _, port = addr.rpartition(":")
        self.addr = addr
        self._host, self._port = host or "127.0.0.1", int(port)
        self.timeout_s = timeout_s
        self._pool_lock = make_lock("ha.dataplane.RemoteBroker._pool_lock")
        # swarmlint: guarded-by[self._pool_lock]: _pool, _closed
        self._pool: List[socket.socket] = []
        self._closed = False

    # ------------------------------------------------------------- transport

    def _checkout(self) -> socket.socket:
        with self._pool_lock:
            if self._closed:
                raise ConnectionError(f"RemoteBroker({self.addr}) is closed")
            if self._pool:
                return self._pool.pop()
        sock = socket.create_connection((self._host, self._port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _checkin(self, sock: socket.socket) -> None:
        with self._pool_lock:
            if not self._closed and len(self._pool) < self._POOL_MAX:
                self._pool.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def _call(self, op: str, extra_deadline_s: float = 0.0,
              **kwargs: Any) -> Any:
        envelope: Dict[str, Any] = {"op": op, "a": kwargs}
        # propagate the active trace across the process boundary: the
        # node records dataplane.<op> under the same trace id
        tc = propagate.inject()
        if tc is not None:
            envelope["tc"] = tc
        t0 = time.monotonic()
        t_span = TRACER.span_begin() if tc is not None else 0
        sock = self._checkout()
        try:
            sock.settimeout(self.timeout_s + extra_deadline_s)
            _send_frame(sock, envelope)
            resp = _recv_frame(sock)
        except (OSError, ValueError) as exc:
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionError(
                f"data-plane {op} to {self.addr} failed: {exc}") from exc
        if resp is None:  # EOF: node died/partitioned mid-request
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionError(
                f"data-plane {op}: node {self.addr} closed the stream")
        self._checkin(sock)
        if extra_deadline_s == 0.0:
            # plain ops only: the blocking waits' RTT is dominated by
            # their own server-side timeout, not the wire. The active
            # trace id rides as the bucket exemplar so a tail RTT links
            # to the merged cluster trace of that request.
            HIST_DATAPLANE_RTT.observe(time.monotonic() - t0,
                                       tc["t"] if tc is not None else None)
        if t_span:
            TRACER.span_end(t_span, "dataplane.call", cat="dataplane",
                            rid=tc["t"], args={"op": op, "addr": self.addr})
        if "err" in resp:
            raise _WIRE_ERRORS.get(resp["err"], BrokerError)(resp.get("msg"))
        return resp.get("ok")

    # -- admin ---------------------------------------------------------------

    def create_topic(self, name: str, num_partitions: int,
                     retention_ms: int = 7 * 24 * 3600 * 1000) -> bool:
        return self._call("create_topic", name=name,
                          num_partitions=num_partitions,
                          retention_ms=retention_ms)

    def list_topics(self) -> Dict[str, TopicMeta]:
        return {name: TopicMeta(name=name,
                                num_partitions=m["num_partitions"],
                                retention_ms=m["retention_ms"])
                for name, m in self._call("list_topics").items()}

    def create_partitions(self, name: str, new_total: int) -> None:
        self._call("create_partitions", name=name, new_total=new_total)

    # -- data plane ----------------------------------------------------------

    def append(self, topic: str, partition: int, value: bytes,
               key: Optional[bytes] = None,
               timestamp: Optional[float] = None) -> int:
        return self._call("append", topic=topic, partition=partition,
                          value=_b64(value), key=_b64(key),
                          timestamp=timestamp)

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int = 256) -> List[Record]:
        return [_rec_in(d) for d in
                self._call("fetch", topic=topic, partition=partition,
                           offset=offset, max_records=max_records)]

    def end_offset(self, topic: str, partition: int) -> int:
        return self._call("end_offset", topic=topic, partition=partition)

    def begin_offset(self, topic: str, partition: int) -> int:
        return self._call("begin_offset", topic=topic, partition=partition)

    def wait_for_data(self, topic: str, partition: int, offset: int,
                      timeout_s: float) -> bool:
        return self._call("wait_for_data", extra_deadline_s=timeout_s,
                          topic=topic, partition=partition, offset=offset,
                          timeout_s=timeout_s)

    # -- consumer-group offsets ----------------------------------------------

    def commit_offset(self, group: str, topic: str, partition: int,
                      offset: int) -> None:
        self._call("commit_offset", group=group, topic=topic,
                   partition=partition, offset=offset)

    def committed_offset(self, group: str, topic: str,
                         partition: int) -> Optional[int]:
        return self._call("committed_offset", group=group, topic=topic,
                          partition=partition)

    # -- retention / durability ----------------------------------------------

    def trim_older_than(self, topic: str, cutoff_ts: float) -> int:
        return self._call("trim_older_than", topic=topic,
                          cutoff_ts=cutoff_ts)

    def durable_offset(self, topic: str, partition: int) -> int:
        return self._call("durable_offset", topic=topic, partition=partition)

    def wait_durable(self, topic: str, partition: int, offset: int,
                     timeout_s: float) -> bool:
        return self._call("wait_durable", extra_deadline_s=timeout_s,
                          topic=topic, partition=partition, offset=offset,
                          timeout_s=timeout_s)

    def flush(self) -> None:
        self._call("flush")

    # -- observability -------------------------------------------------------

    def trace_export(self, last_n: Optional[int] = None,
                     trace_id: Optional[str] = None,
                     max_events: Optional[int] = None) -> Dict[str, Any]:
        """The node's bounded Chrome-trace export + its node id (the
        /admin/cluster/trace fan-out unit)."""
        return self._call("trace_export", last_n=last_n,
                          trace_id=trace_id, max_events=max_events)

    def close(self) -> None:
        with self._pool_lock:
            self._closed = True
            pool, self._pool = list(self._pool), []
        for sock in pool:
            try:
                sock.close()
            except OSError:
                pass

    def healthy(self) -> bool:
        try:
            return bool(self._call("healthy"))
        except Exception:
            return False
