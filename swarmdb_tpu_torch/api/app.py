"""HTTP API server: the wire surface of ``swarmdb_tpu/api/app.py`` on
aiohttp.

The same routes, methods, payload schemas and auth rules (JWT HS256,
``sub`` = agent id, username ``admin`` = superuser), per-IP sliding-window
rate limiting, a CORS allowlist, structured 422 bodies, a CORS-carrying
500 on unexpected errors, and the same env-var config names, so a client
of the JAX package's server talks to this one unchanged. Blocking SwarmDB
calls run in the default executor (``_run_sync``), never on the event
loop.

``POST /messages`` and ``POST /groups/message`` accept ``stream: true``
and reply with SSE: with a serving backend attached
(``create_app(serving=...)``) the events carry decode tokens from the
card; without one, the message's lifecycle. Every event's data is one
JSON value; a ``token`` event's is a JSON string (the JAX package writes
its text raw, which a line break inside the text cuts short).
``/admin/profile/start`` and ``/stop`` drive ``torch.profiler``.
``/metrics`` carries the counters, the latency histograms with their
trace-id exemplars (``obs/metrics.py``) and the SLO sentinel's gauges;
``/admin/slo`` serves the sentinel and ``/admin/cluster/trace`` the
local trace through the cluster merge (the fan-out to other nodes rides
the data plane, ROADMAP.md queue 1 item 12). Routes whose subsystem is
not ported yet answer 501 with a body that names its ROADMAP.md item
(queue 1): ``/admin/lockcheck``, ``/admin/pagecheck``,
``/admin/kerncheck`` (item 10c), ``/admin/profile``, ``/admin/mem``
(item 10b) and ``/admin/ha`` (item 12).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json
import logging
import os
import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from aiohttp import web
from pydantic import ValidationError

from ..core.messages import MessageStatus
from ..core.runtime import SwarmDB
from ..obs import HISTOGRAMS, TRACER, propagate
from ..utils import jwt as jwt_util
from . import schemas

logger = logging.getLogger("swarmdb_tpu_torch.api")

ADMIN_USERNAME = "admin"  # the authorization superuser

DB_KEY: web.AppKey = web.AppKey("db", object)
CONFIG_KEY: web.AppKey = web.AppKey("config", object)
SERVING_KEY: web.AppKey = web.AppKey("serving", object)

#: Routes of the JAX package's server whose subsystem the port has not
#: yet: path -> (what it serves, the ROADMAP.md queue 1 item). They
#: answer 501 naming the item.
UNPORTED_ROUTES = {
    "/admin/ha": ("the HA control plane", "12"),
    "/admin/lockcheck": ("the lock sanitizer", "10c"),
    "/admin/pagecheck": ("the page sanitizer", "10c"),
    "/admin/kerncheck": ("the kernel sanitizer", "10c"),
    "/admin/profile": ("the device-time profiler", "10b"),
    "/admin/mem": ("the memory accountant", "10b"),
}


@dataclass
class ApiConfig:
    """Env-var backed config (the JAX package's names)."""

    jwt_secret_key: str = "change-me-in-production"
    token_expire_minutes: float = 30.0
    rate_limit_per_minute: int = 300
    cors_origins: str = "*"
    host: str = "0.0.0.0"
    port: int = 8000
    # If set, the "admin" username requires this password; unset, any
    # credentials get an admin token (demo parity, logged loudly).
    admin_password: Optional[str] = None
    # worker recycling: after ~this many requests (+ jitter) the process
    # drains and exits; its supervisor starts a fresh one. 0 = never.
    max_requests: int = 0
    max_requests_jitter: int = 0

    @classmethod
    def from_env(cls) -> "ApiConfig":
        return cls(
            jwt_secret_key=os.environ.get("JWT_SECRET_KEY",
                                          "change-me-in-production"),
            token_expire_minutes=float(
                os.environ.get("TOKEN_EXPIRE_MINUTES", "30")),
            rate_limit_per_minute=int(
                os.environ.get("RATE_LIMIT_PER_MINUTE", "300")),
            cors_origins=os.environ.get("CORS_ORIGINS", "*"),
            host=os.environ.get("API_HOST", "0.0.0.0"),
            port=int(os.environ.get("API_PORT", "8000")),
            admin_password=os.environ.get("ADMIN_PASSWORD") or None,
            max_requests=int(os.environ.get("API_MAX_REQUESTS", "0")),
            max_requests_jitter=int(
                os.environ.get("API_MAX_REQUESTS_JITTER", "0")),
        )

    def allowed_origin(self, request_origin: Optional[str]) -> Optional[str]:
        """The Access-Control-Allow-Origin value for one request, or None
        to omit the header (deny). A listed origin is echoed verbatim;
        "null" is never echoed and a miss never widens to "*"."""
        if self.cors_origins.strip() == "*":
            return "*"
        allowed = {o.strip() for o in self.cors_origins.split(",")
                   if o.strip()}
        if request_origin and request_origin in allowed:
            return request_origin
        return None


def _error(status_code: int, detail: Any) -> web.HTTPException:
    exc_cls = {
        400: web.HTTPBadRequest,
        401: web.HTTPUnauthorized,
        403: web.HTTPForbidden,
        404: web.HTTPNotFound,
        409: web.HTTPConflict,
        422: web.HTTPUnprocessableEntity,
        429: web.HTTPTooManyRequests,
        501: web.HTTPNotImplemented,
        503: web.HTTPServiceUnavailable,
    }.get(status_code, web.HTTPInternalServerError)
    return exc_cls(text=json.dumps({"detail": detail}),
                   content_type="application/json")


async def _run_sync(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
    loop = asyncio.get_running_loop()
    if kwargs:
        fn = functools.partial(fn, **kwargs)
    return await loop.run_in_executor(None, fn, *args)


async def _parse(request: web.Request, model: type) -> Any:
    try:
        body = await request.json()
    except Exception:
        raise _error(400, "invalid JSON body")
    try:
        return model.model_validate(body)
    except ValidationError as exc:
        # the parsed error list, not a double-encoded string
        raise _error(422, json.loads(exc.json()))


def _json(model_or_dict: Any, status_code: int = 200) -> web.Response:
    if hasattr(model_or_dict, "model_dump"):
        body = model_or_dict.model_dump(mode="json")
    else:
        body = model_or_dict
    return web.json_response(body, status=status_code)


def _msg_json(m: Any) -> Dict[str, Any]:
    return schemas.MessageResponse.from_message(m).model_dump(mode="json")


class RateLimiter:
    """Per-IP sliding 60 s window. Runs on the event loop only, so it
    needs no lock."""

    def __init__(self, limit_per_minute: int) -> None:
        self.limit = limit_per_minute
        self._windows: Dict[str, deque] = {}
        self._ops = 0

    def check(self, ip: str) -> bool:
        now = time.time()
        self._ops += 1
        if self._ops % 4096 == 0:
            # bound memory across IP churn: drop idle windows
            self._windows = {k: w for k, w in self._windows.items()
                             if w and w[-1] >= now - 60.0}
        win = self._windows.setdefault(ip, deque())
        while win and win[0] < now - 60.0:
            win.popleft()
        if len(win) >= self.limit:
            return False
        win.append(now)
        return True


class _TorchProfile:
    """One ``torch.profiler`` session at a time, started and stopped on
    one dedicated thread (the profiler's state belongs to a thread)."""

    def __init__(self) -> None:
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="swarmdb-profiler")
        self._prof = None
        self._trace_dir: Optional[str] = None

    async def call(self, fn: Callable[[], Any]) -> Any:
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, fn)

    def start(self, trace_dir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self._prof is not None:
            raise RuntimeError("a torch.profiler trace is already running")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
        self._prof, self._trace_dir = prof, trace_dir

    def stop(self) -> str:
        """Stop the trace and write it (Chrome trace-event JSON, loadable
        in Perfetto); returns the file's path."""
        if self._prof is None:
            raise RuntimeError("no torch.profiler trace is running")
        prof, self._prof = self._prof, None
        prof.stop()
        path = os.path.join(self._trace_dir,
                            f"torch_trace_{int(time.time() * 1000)}.json")
        prof.export_chrome_trace(path)
        return path

    def close(self) -> None:
        if self._prof is not None:
            try:
                self._prof.stop()
            except Exception:
                logger.exception("profiler stop on shutdown failed")
            self._prof = None
        self._pool.shutdown(wait=False)


def create_app(
    db: SwarmDB,
    config: Optional[ApiConfig] = None,
    serving: Optional[Any] = None,
    on_max_requests: Optional[Callable[[], None]] = None,
    ha_node: Optional[Any] = None,
) -> web.Application:
    """Build the application. ``serving`` is an optional
    :class:`~swarmdb_tpu_torch.backend.service.ServingService` that
    answers LLM-addressed messages (and streams them); it is stopped
    with the app. ``on_max_requests`` fires once after
    ``cfg.max_requests`` (+ jitter) requests (worker recycling).
    ``ha_node`` is refused: the HA control plane is not ported yet."""
    if ha_node is not None:
        raise NotImplementedError(
            "the HA control plane is not ported yet (ROADMAP.md, queue 1 "
            "item 12)")
    cfg = config or ApiConfig()
    limiter = RateLimiter(cfg.rate_limit_per_minute)
    recycle_at: Optional[int] = None
    if cfg.max_requests > 0:
        recycle_at = cfg.max_requests + random.randint(
            0, max(0, cfg.max_requests_jitter))
    served_requests = {"n": 0, "fired": False}
    torch_profile = _TorchProfile()
    if cfg.admin_password is None:
        logger.warning("ADMIN_PASSWORD not set: any client can obtain an "
                       "admin token. Set it in production.")

    # ---------------------------------------------------------------- auth

    def current_agent(request: web.Request) -> str:
        """The bearer token's subject, or 401."""
        auth = request.headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            raise _error(401, "missing bearer token")
        try:
            claims = jwt_util.decode(auth[len("Bearer "):],
                                     cfg.jwt_secret_key)
        except jwt_util.ExpiredTokenError:
            raise _error(401, "token expired")
        except jwt_util.JWTError as exc:
            raise _error(401, f"invalid token: {exc}")
        sub = claims.get("sub")
        if not sub:
            raise _error(401, "token missing subject")
        return sub

    def require_admin(agent: str) -> None:
        if agent != ADMIN_USERNAME:
            raise _error(403, "admin privileges required")

    # ---------------------------------------------------------- middleware

    @web.middleware
    async def middleware(request: web.Request,
                         handler: Any) -> web.StreamResponse:
        t_req = TRACER.span_begin()
        if request.method == "OPTIONS":  # CORS preflight
            resp: web.StreamResponse = web.Response(status=204)
        else:
            # /health is never limited: a 429 must not fail a healthcheck
            if request.path != "/health":
                if not limiter.check(request.remote or "unknown"):
                    resp = web.json_response(
                        {"detail": "rate limit exceeded"}, status=429)
                    _add_cors(resp, request.headers.get("Origin"))
                    return resp
            try:
                resp = await handler(request)
            except web.HTTPException as exc:
                resp = web.Response(
                    status=exc.status, text=exc.text,
                    content_type=exc.content_type or "application/json")
            except Exception:
                # a JSON body WITH CORS headers, or a browser sees an
                # opaque CORS error (SSE handlers contain their own errors
                # once prepared)
                logger.exception("unhandled error on %s %s",
                                 request.method, request.path)
                resp = web.json_response({"detail": "internal error"},
                                         status=500)
        TRACER.span_end(t_req, "api.request", cat="api",
                        args={"method": request.method,
                              "path": request.path,
                              "status": resp.status})
        _add_cors(resp, request.headers.get("Origin"))
        if recycle_at is not None and request.path != "/health":
            served_requests["n"] += 1
            if (served_requests["n"] >= recycle_at
                    and not served_requests["fired"]):
                served_requests["fired"] = True
                logger.info("max_requests reached (%d); recycling worker",
                            served_requests["n"])
                if on_max_requests is not None:
                    try:
                        on_max_requests()
                    except Exception:
                        logger.exception("max_requests hook failed")
        return resp

    def _add_cors(resp: web.StreamResponse,
                  origin: Optional[str] = None) -> None:
        acao = cfg.allowed_origin(origin)
        if acao is not None:
            resp.headers["Access-Control-Allow-Origin"] = acao
        resp.headers["Access-Control-Allow-Methods"] = (
            "GET, POST, PUT, DELETE, OPTIONS")
        resp.headers["Access-Control-Allow-Headers"] = (
            "Authorization, Content-Type")

    # -------------------------------------------------------------- handlers

    async def auth_token(request: web.Request) -> web.Response:
        """POST /auth/token: any non-empty username and password (the
        admin's checked when ADMIN_PASSWORD is set); sub = username."""
        creds = await _parse(request, schemas.UserCredentials)
        if not creds.username or not creds.password:
            raise _error(401, "empty credentials")
        if (creds.username == ADMIN_USERNAME
                and cfg.admin_password is not None
                and creds.password != cfg.admin_password):
            raise _error(401, "invalid admin credentials")
        token = jwt_util.create_access_token(
            creds.username, cfg.jwt_secret_key, cfg.token_expire_minutes)
        return _json(schemas.Token(access_token=token))

    async def register_agent(request: web.Request) -> web.Response:
        """POST /agents/register: self or admin."""
        agent = current_agent(request)
        req = await _parse(request, schemas.AgentRegistrationRequest)
        if agent != ADMIN_USERNAME and agent != req.agent_id:
            raise _error(403, "can only register yourself (or be admin)")
        meta = {"description": req.description,
                "capabilities": req.capabilities, **req.metadata}
        created = await _run_sync(db.register_agent, req.agent_id, meta,
                                  req.adopt_backlog)
        return _json({"status": ("registered" if created
                                 else "already_registered"),
                      "agent_id": req.agent_id})

    async def deregister_agent(request: web.Request) -> web.Response:
        """DELETE /agents/{agent_id}: self or admin."""
        agent = current_agent(request)
        target = request.match_info["agent_id"]
        if agent != ADMIN_USERNAME and agent != target:
            raise _error(403, "can only deregister yourself (or be admin)")
        if not await _run_sync(db.deregister_agent, target):
            raise _error(404, f"agent {target} not registered")
        return _json({"status": "deregistered", "agent_id": target})

    async def send_message(request: web.Request) -> web.StreamResponse:
        """POST /messages: the sender is the token's subject; with
        ``stream: true`` the reply comes as SSE."""
        agent = current_agent(request)
        req = await _parse(request, schemas.MessageRequest)
        msg_id = await _run_sync(
            db.send_message, agent, req.receiver_id, req.content,
            message_type=req.message_type, priority=req.priority,
            metadata=req.metadata)
        if req.stream:
            return await _stream_reply(request, msg_id)
        msg = await _run_sync(db.get_message, msg_id)
        if msg is None:
            raise _error(404, "message vanished after send")
        return _json(schemas.MessageResponse.from_message(msg))

    async def broadcast(request: web.Request) -> web.Response:
        """POST /messages/broadcast."""
        agent = current_agent(request)
        req = await _parse(request, schemas.BroadcastRequest)
        msg_id = await _run_sync(
            db.broadcast_message, agent, req.content,
            message_type=req.message_type, priority=req.priority,
            metadata=req.metadata, exclude_agents=req.exclude_agents)
        return _json(schemas.BroadcastResponse(status="broadcast",
                                               message_id=msg_id))

    async def get_message(request: web.Request) -> web.Response:
        """GET /messages/{message_id}: admin, sender, receiver or an agent
        in visible_to."""
        agent = current_agent(request)
        msg = await _run_sync(db.get_message, request.match_info["message_id"])
        if msg is None:
            raise _error(404, "message not found")
        if not (agent == ADMIN_USERNAME or agent == msg.sender_id
                or agent == msg.receiver_id or agent in msg.visible_to):
            raise _error(403, "not authorized to view this message")
        return _json(schemas.MessageResponse.from_message(msg))

    async def query_messages(request: web.Request) -> web.Response:
        """GET /messages: a non-admin sees only its own traffic, filtered
        before the limit."""
        agent = current_agent(request)
        q = request.query
        sender = q.get("sender_id")
        receiver = q.get("receiver_id")
        involving = None
        if agent != ADMIN_USERNAME:
            if sender is None and receiver is None:
                involving = agent
            elif agent not in (sender, receiver):
                raise _error(403, "non-admin may only query own messages")
        try:
            msgs = await _run_sync(
                db.query_messages, sender_id=sender, receiver_id=receiver,
                message_type=q.get("message_type"), status=q.get("status"),
                start_time=(float(q["start_time"]) if "start_time" in q
                            else None),
                end_time=float(q["end_time"]) if "end_time" in q else None,
                limit=int(q.get("limit", "100")), involving=involving)
        except ValueError as exc:
            raise _error(422, str(exc))
        return _json([_msg_json(m) for m in msgs])

    async def agent_messages(request: web.Request) -> web.Response:
        """GET /agents/{agent_id}/messages: self or admin."""
        agent = current_agent(request)
        target = request.match_info["agent_id"]
        if agent != ADMIN_USERNAME and agent != target:
            raise _error(403, "can only read your own inbox (or be admin)")
        q = request.query
        try:
            msgs = await _run_sync(
                db.get_agent_messages, target, status=q.get("status"),
                limit=int(q.get("limit", "100")),
                skip=int(q.get("skip", "0")))
        except ValueError as exc:
            raise _error(422, str(exc))
        return _json([_msg_json(m) for m in msgs])

    async def receive(request: web.Request) -> web.Response:
        """POST /agents/receive: a broker poll for the calling agent."""
        agent = current_agent(request)
        req = await _parse(request, schemas.ReceiveRequest)
        msgs = await _run_sync(db.receive_messages, agent,
                               max_messages=req.max_messages,
                               timeout=req.timeout)
        return _json([_msg_json(m) for m in msgs])

    async def update_status(request: web.Request) -> web.Response:
        """PUT /messages/{message_id}/status: admin or the receiver."""
        agent = current_agent(request)
        msg = await _run_sync(db.get_message, request.match_info["message_id"])
        if msg is None:
            raise _error(404, "message not found")
        if agent != ADMIN_USERNAME and agent != msg.receiver_id:
            raise _error(403, "only the receiver (or admin) may update "
                              "status")
        req = await _parse(request, schemas.StatusUpdateRequest)
        if req.status == MessageStatus.PROCESSED:
            ok = await _run_sync(db.mark_message_as_processed, msg.id)
        else:
            ok = await _run_sync(db.update_message_status, msg.id,
                                 req.status)
        if not ok:
            raise _error(404, "message vanished during update")
        return _json({"status": "updated", "message_id": msg.id,
                      "new_status": req.status.value})

    async def create_group(request: web.Request) -> web.Response:
        """POST /groups."""
        current_agent(request)
        req = await _parse(request, schemas.AgentGroupRequest)
        if not req.agent_ids:
            raise _error(422, "agent_ids must be non-empty")
        await _run_sync(db.add_agent_group, req.group_name, req.agent_ids)
        return _json({"status": "created", "group_name": req.group_name,
                      "agent_ids": req.agent_ids})

    async def group_message(request: web.Request) -> web.StreamResponse:
        """POST /groups/message; with ``stream: true`` the fan-out's
        replies come as SSE."""
        agent = current_agent(request)
        req = await _parse(request, schemas.GroupMessageRequest)
        try:
            ids = await _run_sync(
                db.send_to_group, agent, req.group_name, req.content,
                message_type=req.message_type, priority=req.priority,
                metadata=req.metadata)
        except KeyError:
            raise _error(404, f"group {req.group_name} not found")
        if req.stream:
            return await _stream_group(request, ids)
        return _json(schemas.GroupMessageResponse(
            status="sent", group_name=req.group_name, message_ids=ids))

    async def health(request: web.Request) -> web.Response:
        """GET /health: a live broker probe, and the serving backend's
        device probe and engine / supervisor state."""
        ok = await _run_sync(db.broker.healthy)
        backend = None
        if serving is not None and hasattr(serving, "health"):
            try:
                backend = await _run_sync(serving.health)
            except Exception as exc:
                backend = {"status": "error", "error": str(exc)}
        resp = schemas.HealthResponse(
            status="healthy" if ok else "degraded", broker_connected=ok,
            tpu=backend)
        return _json(resp, 200 if ok else 503)

    async def stats(request: web.Request) -> web.Response:
        """GET /stats: admin only."""
        require_admin(current_agent(request))
        return _json(schemas.SystemStats(**await _run_sync(db.get_stats)))

    async def admin_save(request: web.Request) -> web.Response:
        require_admin(current_agent(request))
        path = await _run_sync(db.save_message_history)
        return _json({"status": "saved", "filepath": path})

    async def admin_flush(request: web.Request) -> web.Response:
        require_admin(current_agent(request))
        try:
            max_age = float(request.query.get("max_age_seconds",
                                              str(7 * 24 * 3600)))
        except ValueError as exc:
            raise _error(422, f"bad max_age_seconds: {exc}")
        n = await _run_sync(db.flush_old_messages, max_age)
        return _json({"status": "flushed", "archived_count": n})

    async def admin_resend(request: web.Request) -> web.Response:
        require_admin(current_agent(request))
        ids = await _run_sync(db.resend_failed_messages)
        return _json({"status": "resent", "message_ids": ids})

    async def admin_scale(request: web.Request) -> web.Response:
        require_admin(current_agent(request))
        n = await _run_sync(db.auto_scale_partitions)
        return _json({"status": "scaled", "num_partitions": n})

    async def admin_llm_backend(request: web.Request) -> web.Response:
        """POST /admin/llm_backend: make a registered agent LLM-backed."""
        require_admin(current_agent(request))
        req = await _parse(request, schemas.LlmBackendRequest)
        if not req.agent_id or not req.backend_id:
            raise _error(422, "agent_id and backend_id must be non-empty")
        known = await _run_sync(lambda: req.agent_id in db.registered_agents)
        if not known:
            raise _error(404, f"agent {req.agent_id} not registered")
        await _run_sync(db.assign_llm_backend, req.agent_id, req.backend_id)
        return _json({"status": "assigned", "agent_id": req.agent_id,
                      "backend_id": req.backend_id})

    async def metrics(request: web.Request) -> web.Response:
        """GET /metrics: Prometheus text of the runtime's counters, rates
        and latency percentiles (per-agent keys left out), plus the
        supervisor's lane gauges. Unauthenticated by scraper convention."""
        snap = await _run_sync(db.metrics.snapshot)
        lines = []

        def _name(k: str) -> str:
            return "swarmdb_" + "".join(
                c if c.isalnum() or c == "_" else "_" for c in k)

        for k, v in sorted(snap["counters"].items()):
            if k.startswith("agent_recv:"):
                continue
            n = _name(k)
            lines += [f"# TYPE {n} counter", f"{n} {v}"]
        for k, v in sorted(snap["rates"].items()):
            if k.startswith("agent_recv:"):
                continue
            n = _name(k) + "_per_second"
            lines += [f"# TYPE {n} gauge", f"{n} {v}"]
        for k, s in sorted(snap["latencies"].items()):
            n = _name(k)
            lines.append(f"# TYPE {n} summary")
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                if s.get(key) is not None:
                    lines.append(f'{n}{{quantile="{q}"}} {s[key]}')
            lines.append(f"{n}_count {int(s.get('count') or 0)}")
        # fixed-bucket latency histograms, buckets that kept a trace id
        # carrying it in OpenMetrics exemplar syntax (the id resolves at
        # /admin/trace/export?trace_id=), then the sentinel's gauges
        lines.extend(HISTOGRAMS.render_prometheus(exemplars=True))
        sentinel = getattr(db, "sentinel", None)
        if sentinel is not None:
            lines.extend(await _run_sync(sentinel.prometheus_lines))
        supervisor = getattr(serving, "supervisor", None)
        if supervisor is not None:
            lines.extend(await _run_sync(supervisor.prometheus_lines))
        tier = getattr(serving, "_tier", None)
        if tier is not None:
            tstatus = await _run_sync(tier.status)
            lines.append("# TYPE swarmdb_tier_pages gauge")
            lines += [f'swarmdb_tier_pages{{tier="{name}"}} {n}'
                      for name, n in tstatus["pages"].items()]
            for cname in ("demotions", "promotions", "cold_resumes"):
                lines += [f"# TYPE swarmdb_tier_{cname}_total counter",
                          f"swarmdb_tier_{cname}_total "
                          f"{tstatus['counters'][cname]}"]
        return web.Response(text="\n".join(lines) + "\n",
                            content_type="text/plain")

    def _trace_query(request: web.Request):
        """(last_n, trace_id) of a trace route's query."""
        q = request.query
        last_n = None
        if q.get("last_n"):
            try:
                last_n = max(0, int(q["last_n"]))
            except ValueError:
                raise _error(422, f"bad last_n: {q['last_n']!r}")
        return last_n, q.get("trace_id") or None

    async def trace_export(request: web.Request) -> web.Response:
        """GET /admin/trace/export: the span tracer's rings as Chrome
        trace-event JSON, bounded by ``?last_n=`` / ``?trace_id=`` and
        ``SWARMDB_TRACE_EXPORT_MAX``."""
        require_admin(current_agent(request))
        last_n, trace_id = _trace_query(request)
        trace = await _run_sync(
            lambda: TRACER.to_chrome_trace(last_n=last_n, rid=trace_id))
        return web.json_response(trace)

    async def cluster_trace(request: web.Request) -> web.Response:
        """GET /admin/cluster/trace: one merged, Perfetto-loadable trace
        of the cluster, with the filters of /admin/trace/export. The port
        has no cluster map yet, so this is the JAX package's no-cluster
        answer: the local process's trace through ``merge_chrome_traces``
        and an empty ``metadata.unreachable`` (the fan-out to other nodes
        rides the data plane, ROADMAP.md queue 1 item 12)."""
        require_admin(current_agent(request))
        last_n, trace_id = _trace_query(request)
        local = await _run_sync(
            lambda: TRACER.to_chrome_trace(last_n=last_n, rid=trace_id))
        merged = propagate.merge_chrome_traces([(propagate.node_id(),
                                                 local)])
        merged["metadata"]["unreachable"] = []
        if trace_id:
            merged["metadata"]["trace_id"] = trace_id
        return web.json_response(merged)

    async def admin_slo(request: web.Request) -> web.Response:
        """GET /admin/slo: the online SLO sentinel -- its config and
        learned baseline, the last closed window's per-completion cost
        split and p95s, the attributed alert ring (each alert names its
        dominant contributor, shares summing to 1, and points at its
        flight and trace dumps), and the histogram exemplars with
        ``?trace_id=`` export links. ``?tick=1`` runs a window-close check
        first. 503 without a sentinel."""
        require_admin(current_agent(request))
        sentinel = getattr(db, "sentinel", None)
        if sentinel is None:
            raise _error(503, "this runtime has no SLO sentinel")
        if request.query.get("tick"):
            await _run_sync(sentinel.maybe_tick)
        return web.json_response(await _run_sync(sentinel.status))

    async def flight_record(request: web.Request) -> web.Response:
        """GET /admin/flight: the engine's flight rings; ``?last=1`` the
        last automatic dump (an engine restart takes one)."""
        require_admin(current_agent(request))
        if serving is None or not hasattr(serving, "engine"):
            raise _error(503, "no serving engine attached")
        flight = serving.engine.flight
        if request.query.get("last"):
            if flight.last_dump is None:
                raise _error(404, "no automatic dump taken yet")
            return web.json_response(flight.last_dump)
        return web.json_response(await _run_sync(flight.dump))

    async def admin_tiers(request: web.Request) -> web.Response:
        """GET /admin/tiers: the conversation-state tiers (pages hot on
        the card, warm in host memory, cold in the log), the warm store,
        the demote / promote / cold-resume counters, the warm hit rate
        and the config. Always answers: without a tier manager,
        ``{"enabled": false}`` and the hot page count."""
        require_admin(current_agent(request))
        tier = getattr(serving, "_tier", None)
        if tier is not None:
            return web.json_response(await _run_sync(tier.status))
        out: Dict[str, Any] = {"enabled": False,
                               "pages": {"hot": 0, "warm": 0, "cold": 0}}
        paged = getattr(getattr(serving, "engine", None), "paged", None)
        if paged is not None:
            pstats = await _run_sync(paged.allocator.stats)
            out["pages"]["hot"] = max(0, int(pstats["num_pages"]) - 1
                                      - int(pstats["free_pages"]))
        return web.json_response(out)

    async def admin_lanes(request: web.Request) -> web.Response:
        """GET /admin/lanes: the lane supervisor's status (per-lane state,
        beat age, quarantines and restarts; the migration / retry / shed /
        deadline counters; the config), for one engine or a lane group;
        503 without a supervisor."""
        require_admin(current_agent(request))
        supervisor = getattr(serving, "supervisor", None)
        if supervisor is None:
            raise _error(503, "no lane supervisor attached")
        return web.json_response(await _run_sync(supervisor.status))

    def unported(path: str):
        what, item = UNPORTED_ROUTES[path]

        async def handler(request: web.Request) -> web.Response:
            require_admin(current_agent(request))
            raise _error(501, f"{path}: {what} is not ported yet "
                              f"(ROADMAP.md, queue 1 item {item})")

        return handler

    async def dashboard(request: web.Request) -> web.Response:
        """GET /dashboard: the self-contained observability page."""
        from .dashboard import DASHBOARD_HTML

        return web.Response(text=DASHBOARD_HTML, content_type="text/html")

    async def agent_load(request: web.Request) -> web.Response:
        """GET /agents/{agent_id}/load: inbox size, unread count, trailing
        msgs/s. Self or admin."""
        agent = current_agent(request)
        target = request.match_info["agent_id"]
        if agent != target and agent != ADMIN_USERNAME:
            raise _error(403, "can only read your own load (or be admin)")
        return _json(await _run_sync(db.get_agent_load, target))

    async def profile_start(request: web.Request) -> web.Response:
        """POST /admin/profile/start: begin a ``torch.profiler`` trace
        (host ops, and device kernels on the card); 409 while one runs."""
        require_admin(current_agent(request))
        trace_dir = (request.query.get("dir")
                     or os.path.join(db.save_dir, "profiles"))
        try:
            await torch_profile.call(lambda: torch_profile.start(trace_dir))
        except Exception as exc:
            raise _error(409, str(exc))
        return _json({"status": "tracing", "trace_dir": trace_dir})

    async def profile_stop(request: web.Request) -> web.Response:
        """POST /admin/profile/stop: end the trace and write it as Chrome
        trace-event JSON under the start's directory; 409 without one."""
        require_admin(current_agent(request))
        try:
            path = await torch_profile.call(torch_profile.stop)
        except Exception as exc:
            raise _error(409, str(exc))
        return _json({"status": "stopped", "trace_file": path})

    # ----------------------------------------------------------- SSE helpers

    async def _sse_response(request: web.Request) -> web.StreamResponse:
        resp = web.StreamResponse(status=200, headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        _add_cors(resp, request.headers.get("Origin"))
        await resp.prepare(request)
        return resp

    async def _sse_event(resp: web.StreamResponse, event: str,
                         data: Any) -> None:
        # JSON for every event, token text too: raw text holding a line
        # break (the byte tokenizer can emit one) would end the data line
        # early, since SSE lines end at CR or LF
        await resp.write(
            f"event: {event}\ndata: {json.dumps(data)}\n\n".encode())

    async def _stream_reply(request: web.Request,
                            msg_id: str) -> web.StreamResponse:
        """SSE for one message: decode tokens with a serving backend,
        else its lifecycle. Once prepared no exception may escape (a
        second response cannot follow an event-stream's headers): errors
        become "error" events, a gone client is let go."""
        resp = await _sse_response(request)
        try:
            msg = await _run_sync(db.get_message, msg_id)
            if msg is not None:
                await _sse_event(resp, "message", _msg_json(msg))
            if serving is not None and msg is not None:
                try:
                    async for tok in serving.stream_reply(msg):
                        await _sse_event(resp, "token", tok)
                    reply_id = msg.metadata.get("reply_id")
                    reply = (await _run_sync(db.get_message, reply_id)
                             if reply_id else None)
                    if reply is not None:
                        await _sse_event(resp, "reply", _msg_json(reply))
                except Exception as exc:
                    await _sse_event(resp, "error", {"detail": str(exc)})
            await _sse_event(resp, "done", {"message_id": msg_id})
            await resp.write_eof()
        except (ConnectionResetError, ConnectionError,
                asyncio.CancelledError):
            logger.debug("SSE client disconnected during /messages stream")
        except Exception:
            logger.exception("error inside prepared SSE stream")
        return resp

    async def _stream_group(request: web.Request,
                            ids: list) -> web.StreamResponse:
        """SSE for a group send, with _stream_reply's error containment."""
        resp = await _sse_response(request)
        try:
            group_msgs = []
            for mid in ids:
                m = await _run_sync(db.get_message, mid)
                if m is None:
                    continue  # deleted between send and stream
                group_msgs.append(m)
                await _sse_event(resp, "message", _msg_json(m))
            if serving is not None:
                try:
                    async for item in serving.stream_group(group_msgs):
                        await _sse_event(resp, item.get("event", "token"),
                                         item)
                except Exception as exc:
                    await _sse_event(resp, "error", {"detail": str(exc)})
            await _sse_event(resp, "done", {"message_ids": ids})
            await resp.write_eof()
        except (ConnectionResetError, ConnectionError,
                asyncio.CancelledError):
            logger.debug("SSE client disconnected during group stream")
        except Exception:
            logger.exception("error inside prepared SSE stream")
        return resp

    # ---------------------------------------------------------------- wiring

    app = web.Application(middlewares=[middleware])
    app[DB_KEY] = db
    app[CONFIG_KEY] = cfg
    app[SERVING_KEY] = serving
    app.add_routes([
        web.post("/auth/token", auth_token),
        web.post("/agents/register", register_agent),
        web.delete("/agents/{agent_id}", deregister_agent),
        web.post("/messages", send_message),
        web.post("/messages/broadcast", broadcast),
        web.get("/messages/{message_id}", get_message),
        web.get("/messages", query_messages),
        web.get("/agents/{agent_id}/messages", agent_messages),
        web.post("/agents/receive", receive),
        web.put("/messages/{message_id}/status", update_status),
        web.post("/groups", create_group),
        web.post("/groups/message", group_message),
        web.get("/health", health),
        web.get("/stats", stats),
        web.post("/admin/save", admin_save),
        web.post("/admin/flush", admin_flush),
        web.post("/admin/resend_failed", admin_resend),
        web.post("/admin/scale_partitions", admin_scale),
        web.post("/admin/llm_backend", admin_llm_backend),
        web.get("/metrics", metrics),
        web.get("/dashboard", dashboard),
        web.get("/agents/{agent_id}/load", agent_load),
        web.post("/admin/profile/start", profile_start),
        web.post("/admin/profile/stop", profile_stop),
        web.get("/admin/trace/export", trace_export),
        web.get("/admin/cluster/trace", cluster_trace),
        web.get("/admin/slo", admin_slo),
        web.get("/admin/flight", flight_record),
        web.get("/admin/tiers", admin_tiers),
        web.get("/admin/lanes", admin_lanes),
    ] + [web.get(path, unported(path)) for path in UNPORTED_ROUTES])

    async def on_shutdown(app: web.Application) -> None:
        torch_profile.close()
        if serving is not None:
            await _run_sync(serving.stop)
        await _run_sync(db.close)

    app.on_shutdown.append(on_shutdown)
    return app
