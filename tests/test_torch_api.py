"""PyTorch port vs JAX reference: the HTTP wire API.

Each case of ``tests/test_api.py`` (the routes, auth, rate limit, CORS,
structured errors, SSE without a backend, the dashboard and /metrics)
sends the same requests to both packages' ``create_app`` through aiohttp's
``TestClient`` (ephemeral ports) and keeps the reference test's own checks
in both. Every response is recorded as (status, JSON or text); uuids are
named by the order the case first saw them, and timestamps, tokens and
file paths are reduced to their shape. The two records must be equal
(exactly). Two known differences are stated where they apply: the port's
``/admin/profile/stop`` also names the trace file it wrote, and the port
writes an SSE ``token`` event's data as a JSON string where the JAX
package writes the raw text.

The last case streams one greedy reply from a tiny-debug backend through
both servers (the same float32 weights and a float32 page pool, as in
tests/test_torch_serve.py): the streamed text, the reply's body and its
finish reason must be equal (exact: greedy tokens). ``/admin/lanes``
answers the supervisor's per-lane status over one engine and over a
2-lane group the same way in both packages (beat ages and the port's
extra config keys aside), and 503 without a supervisor.
"""

import asyncio
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import swarmdb_tpu.api.app as japp
import swarmdb_tpu.broker.local as jbroker
import swarmdb_tpu.core.runtime as jrt
import swarmdb_tpu.utils.jwt as jjwt
import swarmdb_tpu_torch.api.app as tapp
import swarmdb_tpu_torch.broker.local as tbroker
import swarmdb_tpu_torch.core.runtime as trt
import swarmdb_tpu_torch.utils.jwt as tjwt

PKGS = {
    "jax": SimpleNamespace(app=japp, SwarmDB=jrt.SwarmDB,
                           LocalBroker=jbroker.LocalBroker, jwt=jjwt),
    "torch": SimpleNamespace(app=tapp, SwarmDB=trt.SwarmDB,
                             LocalBroker=tbroker.LocalBroker, jwt=tjwt),
}
BASE_CFG = dict(jwt_secret_key="test-secret", rate_limit_per_minute=10_000)
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")
VOLATILE = ("timestamp", "access_token", "dumped_at", "probe_ms")
PATHS = ("filepath", "trace_dir", "trace_file")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Ctx:
    """One package's run of a case: the client, the runtime, the record."""

    def __init__(self, P, client, db, tmp):
        self.P, self.client, self.db, self.tmp = P, client, db, tmp
        self.record = []
        self._ids = {}

    def norm(self, v):
        if isinstance(v, dict):
            out = {}
            for k, x in v.items():
                if k in VOLATILE:
                    x = "<volatile>"
                elif k == "stages":
                    x = sorted(x)
                elif k in PATHS and isinstance(x, str):
                    x = re.sub(r"\d+", "#", os.path.relpath(x, self.tmp))
                out[k] = self.norm(x)
            return out
        if isinstance(v, (list, tuple)):
            return [self.norm(x) for x in v]
        if isinstance(v, str):
            return UUID.sub(lambda m: self._ids.setdefault(
                m.group(0), f"<id{len(self._ids)}>"), v)
        return v

    async def call(self, method, path, *, keep=True, **kw):
        """One request: (status, JSON body or text), recorded."""
        r = await self.client.request(method, path, **kw)
        ctype = r.headers.get("Content-Type", "")
        body = (await r.json() if ctype.startswith("application/json")
                else await r.text())
        if keep:
            self.record.append((method, self.norm(path), r.status,
                                self.norm(body)))
        return r.status, body, r.headers

    async def token(self, username="tester", password="pw"):
        st, body, _ = await self.call("POST", "/auth/token", json={
            "username": username, "password": password})
        assert st == 200, body
        assert body["token_type"] == "bearer"
        return {"Authorization": f"Bearer {body['access_token']}"}

    def see(self, what, value):
        self.record.append((what, self.norm(value)))


def drive(name, case, tmp_path, config=None, serving=None):
    P = PKGS[name]
    tmp_path.mkdir(parents=True, exist_ok=True)

    async def runner():
        db = P.SwarmDB(broker=P.LocalBroker(), save_dir=str(tmp_path / "h"))
        cfg = P.app.ApiConfig(**{**BASE_CFG, **(config or {})})
        app = P.app.create_app(db, cfg, serving=serving(db) if serving
                               else None)
        client = TestClient(TestServer(app))
        await client.start_server()
        C = Ctx(P, client, db, tmp_path)
        try:
            await case(C)
        finally:
            await client.close()
        return C.record

    return asyncio.run(runner())


def sse_events(raw, token_json):
    """(event, data) pairs of an SSE body; a token event's data is a JSON
    string in the port and raw text in the JAX package (events split at
    the blank line before the next ``event:``)."""
    out = []
    for chunk in re.split(r"\n\n(?=event: )", raw.rstrip("\n")):
        head, _, data = chunk.partition("\ndata: ")
        event = head[len("event: "):]
        out.append((event, data if event == "token" and not token_json
                    else json.loads(data)))
    return out


# ---------------------------------------------------------------- the cases


async def case_auth_token_and_rejections(C):
    await C.token()
    assert (await C.call("POST", "/auth/token", json={
        "username": "", "password": "x"}))[0] == 401
    assert (await C.call("POST", "/messages", json={
        "receiver_id": "b", "content": "x"}))[0] == 401
    assert (await C.call("POST", "/messages", json={
        "receiver_id": "b", "content": "x"},
        headers={"Authorization": "Bearer garbage"}))[0] == 401
    bad = C.P.jwt.create_access_token("x", "wrong-secret")
    assert (await C.call("GET", "/messages", headers={
        "Authorization": f"Bearer {bad}"}))[0] == 401


async def case_register_and_deregister(C):
    hdrs = await C.token("agent1")
    st, body, _ = await C.call("POST", "/agents/register", json={
        "agent_id": "agent1", "description": "test agent",
        "capabilities": ["chat"]}, headers=hdrs)
    assert st == 200 and body["status"] == "registered"
    assert C.db.agent_metadata["agent1"]["description"] == "test agent"
    assert (await C.call("POST", "/agents/register",
                         json={"agent_id": "other"}, headers=hdrs))[0] == 403
    admin = await C.token("admin")
    assert (await C.call("POST", "/agents/register",
                         json={"agent_id": "other"}, headers=admin))[0] == 200
    assert (await C.call("DELETE", "/agents/other", headers=hdrs))[0] == 403
    assert (await C.call("DELETE", "/agents/agent1", headers=hdrs))[0] == 200
    assert (await C.call("DELETE", "/agents/ghost", headers=admin))[0] == 404
    C.see("agents", sorted(C.db.registered_agents))


async def case_send_and_get_message(C):
    alice = await C.token("alice")
    st, body, _ = await C.call("POST", "/messages", json={
        "receiver_id": "bob", "content": "hi bob", "message_type": "chat",
        "priority": 2, "metadata": {"k": "v"}}, headers=alice)
    assert st == 200 and body["sender_id"] == "alice"
    assert body["status"] == "delivered" and body["priority"] == 2
    mid = body["id"]
    assert (await C.call("GET", f"/messages/{mid}", headers=alice))[0] == 200
    bob = await C.token("bob")
    assert (await C.call("GET", f"/messages/{mid}", headers=bob))[0] == 200
    eve = await C.token("eve")
    assert (await C.call("GET", f"/messages/{mid}", headers=eve))[0] == 403
    admin = await C.token("admin")
    assert (await C.call("GET", f"/messages/{mid}", headers=admin))[0] == 200
    assert (await C.call("GET", "/messages/doesnotexist",
                         headers=admin))[0] == 404


async def case_broadcast_and_group_flow(C):
    admin = await C.token("admin")
    for a in ("a", "b", "c"):
        await C.call("POST", "/agents/register", json={"agent_id": a},
                     headers=admin)
    a_hdrs = await C.token("a")
    st, body, _ = await C.call("POST", "/messages/broadcast", json={
        "content": "hello all", "exclude_agents": ["c"]}, headers=a_hdrs)
    assert st == 200 and body["status"] == "broadcast" and body["message_id"]
    assert (await C.call("POST", "/groups", json={
        "group_name": "team", "agent_ids": ["a", "b", "c"]},
        headers=a_hdrs))[0] == 200
    st, body, _ = await C.call("POST", "/groups/message", json={
        "group_name": "team", "content": "standup"}, headers=a_hdrs)
    assert st == 200 and body["status"] == "sent"
    assert len(body["message_ids"]) == 2
    assert (await C.call("POST", "/groups/message", json={
        "group_name": "ghost", "content": "x"}, headers=a_hdrs))[0] == 404
    assert (await C.call("POST", "/groups", json={
        "group_name": "e", "agent_ids": []}, headers=a_hdrs))[0] == 422


async def case_receive_and_inbox_and_status(C):
    alice = await C.token("alice")
    bob = await C.token("bob")
    await C.call("POST", "/agents/register", json={"agent_id": "bob"},
                 headers=bob)
    _, body, _ = await C.call("POST", "/messages", json={
        "receiver_id": "bob", "content": "poll me"}, headers=alice)
    mid = body["id"]
    st, msgs, _ = await C.call("POST", "/agents/receive", json={
        "max_messages": 5, "timeout": 1.0}, headers=bob)
    assert st == 200 and [m["id"] for m in msgs] == [mid]
    assert msgs[0]["status"] == "read"
    st, msgs, _ = await C.call("GET", "/agents/bob/messages?limit=10",
                               headers=bob)
    assert st == 200 and len(msgs) == 1
    assert (await C.call("GET", "/agents/bob/messages",
                         headers=alice))[0] == 403
    eve = await C.token("eve")
    assert (await C.call("PUT", f"/messages/{mid}/status", json={
        "status": "processed"}, headers=eve))[0] == 403
    assert (await C.call("PUT", f"/messages/{mid}/status", json={
        "status": "processed"}, headers=bob))[0] == 200
    assert C.db.get_message(mid).status.value == "processed"
    assert (await C.call("PUT", f"/messages/{mid}/status", json={
        "status": "bogus"}, headers=bob))[0] == 422


async def case_query_scoping(C):
    C.db.send_message("a", "b", "ab")
    C.db.send_message("b", "a", "ba")
    C.db.send_message("c", "d", "cd")
    a = await C.token("a")
    st, msgs, _ = await C.call("GET", "/messages", headers=a)
    assert st == 200 and {m["content"] for m in msgs} == {"ab", "ba"}
    assert (await C.call("GET", "/messages?sender_id=c", headers=a))[0] == 403
    assert (await C.call("GET", "/messages?sender_id=a", headers=a))[0] == 200
    admin = await C.token("admin")
    assert len((await C.call("GET", "/messages", headers=admin))[1]) == 3
    assert (await C.call("GET", "/messages?message_type=bogus",
                         headers=admin))[0] == 422


async def case_health_open_and_stats_admin(C):
    st, body, _ = await C.call("GET", "/health")
    assert st == 200 and body["status"] == "healthy"
    assert body["broker_connected"]
    tester = await C.token("tester")
    assert (await C.call("GET", "/stats", headers=tester))[0] == 403
    admin = await C.token("admin")
    C.db.send_message("x", "y", "1")
    st, stats, _ = await C.call("GET", "/stats", headers=admin, keep=False)
    assert st == 200 and stats["total_messages"] == 1
    assert stats["messages_by_type"]["chat"] == 1
    C.see("stats", {k: v for k, v in stats.items() if k != "metrics"})
    C.see("counters", stats["metrics"]["counters"])


async def case_admin_routes(C):
    tester = await C.token("tester")
    admin = await C.token("admin")
    for route in ("/admin/save", "/admin/flush", "/admin/resend_failed",
                  "/admin/scale_partitions"):
        assert (await C.call("POST", route, headers=tester))[0] == 403
    C.db.send_message("a", "b", "save me")
    st, body, _ = await C.call("POST", "/admin/save", headers=admin)
    assert st == 200 and body["filepath"]
    st, body, _ = await C.call("POST", "/admin/flush?max_age_seconds=0.0",
                               headers=admin)
    assert st == 200 and body["archived_count"] == 1
    st, body, _ = await C.call("POST", "/admin/resend_failed", headers=admin)
    assert body["message_ids"] == []
    for i in range(35):
        C.db.register_agent(f"agent{i}")
    st, body, _ = await C.call("POST", "/admin/scale_partitions",
                               headers=admin)
    assert body["num_partitions"] == 12


async def case_rate_limit(C):
    statuses = [(await C.call("GET", "/health"))[0] for _ in range(8)]
    assert all(s == 200 for s in statuses)
    hdrs = await C.token("x")
    statuses = [(await C.call("GET", "/messages", headers=hdrs))[0]
                for _ in range(8)]
    assert 429 in statuses and statuses[:4] == [200] * 4


async def case_sse_stream_without_backend(C):
    alice = await C.token("alice")
    st, raw, headers = await C.call("POST", "/messages", json={
        "receiver_id": "bob", "content": "stream me", "stream": True},
        headers=alice, keep=False)
    assert st == 200
    assert headers["Content-Type"].startswith("text/event-stream")
    events = sse_events(raw, token_json=C.P is PKGS["torch"])
    assert events[0][0] == "message" and events[-1][0] == "done"
    assert events[0][1]["content"] == "stream me"
    C.see("events", events)


async def case_cors_headers_and_preflight(C):
    _, _, h = await C.call("GET", "/health")
    assert h["Access-Control-Allow-Origin"] == "*"
    st, _, h = await C.call("OPTIONS", "/messages")
    assert st == 204 and "POST" in h["Access-Control-Allow-Methods"]
    C.see("cors", [h.get("Access-Control-Allow-Origin"),
                   h.get("Access-Control-Allow-Methods"),
                   h.get("Access-Control-Allow-Headers")])


async def case_malformed_bodies(C):
    hdrs = await C.token("x")
    assert (await C.call("POST", "/messages", data=b"not json", headers={
        **hdrs, "Content-Type": "application/json"}))[0] == 400
    assert (await C.call("POST", "/messages", json={"receiver_id": "b"},
                         headers=hdrs))[0] == 422


async def case_admin_password_enforced(C):
    assert (await C.call("POST", "/auth/token", json={
        "username": "admin", "password": "wrong"}))[0] == 401
    assert (await C.call("POST", "/auth/token", json={
        "username": "admin", "password": "hunter2"}))[0] == 200
    assert (await C.call("POST", "/auth/token", json={
        "username": "joe", "password": "anything"}))[0] == 200


async def case_crafted_tokens_give_401_not_500(C):
    import base64

    for bad in ("é.a.b", "a.b", "a.b.c.d", "!!!.###.$$$", "..", "a.é.c"):
        assert (await C.call("GET", "/messages", headers={
            "Authorization": f"Bearer {bad}"}))[0] == 401, bad

    def seg(d):
        return base64.urlsafe_b64encode(
            json.dumps(d).encode()).rstrip(b"=").decode()

    forged = f'{seg({"alg": "HS256"})}.{seg({"sub": "x", "exp": "soon"})}.AAAA'
    assert (await C.call("GET", "/messages", headers={
        "Authorization": f"Bearer {forged}"}))[0] == 401


async def case_cors_allowlist_echoes_single_origin(C):
    _, _, h = await C.call("GET", "/health",
                           headers={"Origin": "https://b.com"})
    assert h["Access-Control-Allow-Origin"] == "https://b.com"
    _, _, h = await C.call("GET", "/health",
                           headers={"Origin": "https://evil.com"})
    assert "Access-Control-Allow-Origin" not in h
    _, _, h = await C.call("GET", "/health")
    assert "Access-Control-Allow-Origin" not in h


async def case_admin_flush_bad_param_422(C):
    admin = await C.token("admin")
    assert (await C.call("POST", "/admin/flush?max_age_seconds=abc",
                         headers=admin))[0] == 422


async def case_query_own_messages_not_crowded_out(C):
    C.db.send_message("a", "b", "mine-1")
    for i in range(150):
        C.db.send_message("x", "y", f"noise-{i}")
    a = await C.token("a")
    _, msgs, _ = await C.call("GET", "/messages?limit=100", headers=a)
    assert [m["content"] for m in msgs] == ["mine-1"]


async def case_422_detail_is_structured(C):
    hdrs = await C.token("x")
    st, body, _ = await C.call("POST", "/messages",
                               json={"receiver_id": "b"}, headers=hdrs)
    assert st == 422
    assert isinstance(body["detail"], list) and "loc" in body["detail"][0]


async def case_unexpected_error_returns_cors_500(C):
    def boom(*a, **k):
        raise RuntimeError("injected")

    C.db.get_stats = boom
    admin = await C.token("admin")
    st, body, h = await C.call("GET", "/stats", headers=admin)
    assert st == 500 and "Access-Control-Allow-Origin" in h
    assert body["detail"] == "internal error"


async def case_cors_empty_allowlist_denies(C):
    for origin in ("https://evil.com", "null"):
        _, _, h = await C.call("GET", "/health", headers={"Origin": origin})
        assert "Access-Control-Allow-Origin" not in h


async def case_agent_load_endpoint(C):
    hdrs = await C.token("loady")
    assert (await C.call("POST", "/agents/register",
                         json={"agent_id": "loady"}, headers=hdrs))[0] == 200
    st, body, _ = await C.call("GET", "/agents/loady/load", headers=hdrs)
    assert st == 200 and body["agent_id"] == "loady"
    assert {"inbox_size", "unread_count", "messages_per_second"} <= set(body)
    other = await C.token("nosy")
    assert (await C.call("GET", "/agents/loady/load",
                         headers=other))[0] == 403
    admin = await C.token("admin")
    assert (await C.call("GET", "/agents/loady/load",
                         headers=admin))[0] == 200


async def case_profile_routes_admin_only(C):
    """Status codes and the ``status`` field (the port's stop also names
    the trace file it wrote, and the JAX package's traces are XLA's)."""
    hdrs = await C.token("pleb")
    assert (await C.call("POST", "/admin/profile/start", headers=hdrs,
                         keep=False))[0] == 403
    admin = await C.token("admin")
    trace = C.tmp / "tr"
    codes = []
    for path in (f"/admin/profile/start?dir={trace}",
                 f"/admin/profile/start?dir={trace}",
                 "/admin/profile/stop", "/admin/profile/stop"):
        st, body, _ = await C.call("POST", path, headers=admin, keep=False)
        codes.append((st, body.get("status") if st == 200 else None))
    assert [c[0] for c in codes] == [200, 409, 200, 409]
    C.see("profile", codes)


async def case_dashboard_page(C):
    st, body, h = await C.call("GET", "/dashboard", keep=False)
    assert st == 200 and "text/html" in h["Content-Type"]
    assert "/stats" in body and "/health" in body
    C.see("dashboard", [st, h["Content-Type"]])


async def case_metrics_scrape_endpoint(C):
    headers = await C.token("scraper")
    C.db.register_agent("sink")
    for i in range(3):
        await C.call("POST", "/messages", json={
            "receiver_id": "sink", "content": f"m{i}"}, headers=headers)
    st, body, _ = await C.call("GET", "/metrics", keep=False)
    assert st == 200
    assert "# TYPE swarmdb_messages_sent counter" in body
    assert "swarmdb_messages_sent 3" in body
    assert "agent_recv" not in body
    C.see("counter lines", sorted(
        ln for ln in body.splitlines()
        if ln.startswith(("swarmdb_messages_sent ",
                          "swarmdb_agents_registered "))))


async def case_admin_tiers_without_a_backend(C):
    """``/admin/tiers`` always answers (admin only): without a serving
    backend, tiering is off and no page is hot."""
    hdrs = await C.token("tester")
    assert (await C.call("GET", "/admin/tiers", headers=hdrs))[0] == 403
    admin = await C.token("admin")
    st, body, _ = await C.call("GET", "/admin/tiers", headers=admin)
    assert st == 200
    assert body == {"enabled": False,
                    "pages": {"hot": 0, "warm": 0, "cold": 0}}


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}
CONFIGS = {
    "rate_limit": dict(rate_limit_per_minute=5),
    "admin_password_enforced": dict(jwt_secret_key="s",
                                    admin_password="hunter2"),
    "cors_allowlist_echoes_single_origin": dict(
        jwt_secret_key="s", cors_origins="https://a.com, https://b.com"),
    "cors_empty_allowlist_denies": dict(jwt_secret_key="s",
                                        cors_origins=","),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_api_session_equals_jax(case, tmp_path):
    records = {name: drive(name, CASES[case], tmp_path / name,
                           config=CONFIGS.get(case))
               for name in PKGS}
    assert records["torch"] == records["jax"]


def test_sse_stream_from_a_tiny_backend_equals_jax(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from swarmdb_tpu.backend import service as jsvc
    from swarmdb_tpu.models.configs import get_config
    from swarmdb_tpu_torch.backend import service as tsvc
    from swarmdb_tpu_torch.utils.convert import params_from_numpy

    monkeypatch.setenv("SWARMDB_KV_DTYPE", "f32")
    cfg = get_config("tiny-debug")
    je, jtok = jsvc.build_backend_engine(cfg, max_batch=2, max_seq=128,
                                         paged=True, page_size=16)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    te, ttok = tsvc.build_backend_engine(
        "tiny-debug", max_batch=2, max_seq=128, paged=True, page_size=16,
        device="cpu", params=params_from_numpy(
            jax.tree.map(np.asarray, je.params), device="cpu"))
    services = {"jax": lambda db: jsvc.ServingService(db, je, jtok, "b0"),
                "torch": lambda db: tsvc.ServingService(db, te, ttok, "b0")}
    streams = {}

    async def case(C):
        svc = C.client.server.app[C.P.app.SERVING_KEY]
        svc.start()
        try:
            admin = await C.token("admin")
            await C.call("POST", "/agents/register",
                         json={"agent_id": "bot"}, headers=admin)
            assert (await C.call("POST", "/admin/llm_backend", json={
                "agent_id": "bot", "backend_id": "b0"},
                headers=admin))[0] == 200
            st, raw, _ = await C.call("POST", "/messages", json={
                "receiver_id": "bot", "content": "tell me a story",
                "stream": True,
                "metadata": {"generation": {"max_new_tokens": 16}}},
                headers=admin, keep=False)
            assert st == 200
        finally:
            svc.stop()
        events = sse_events(raw, token_json=C.P is PKGS["torch"])
        reply = [d for e, d in events if e == "reply"][0]
        streams[C.P is PKGS["torch"]] = (
            "".join(d for e, d in events if e == "token"),
            reply["content"], reply["metadata"]["finish_reason"],
            reply["metadata"]["completion_tokens"])

    for name in PKGS:
        drive(name, case, tmp_path / name, serving=services[name])
    port, ref = streams[True], streams[False]
    assert port == ref
    assert port[0] == port[1] and port[3] > 0


@pytest.mark.parametrize("group", [False, True])
def test_a_streamed_message_is_generated_once(tmp_path, monkeypatch, group):
    """A message streamed to an agent this backend answers is also picked
    up by the backend's consumer: the two share one generation, so the
    user gets one reply and the engine one request per message (the JAX
    package decodes such a message twice and replies twice)."""
    from swarmdb_tpu_torch.backend import service as tsvc

    monkeypatch.delenv("SWARMDB_PAGED", raising=False)

    def serving(db):
        return tsvc.ServingService.from_model_name(
            db, "tiny-debug", backend_id="b0", max_batch=4, max_seq=128,
            device="cpu")

    async def case(C):
        svc = C.client.server.app[C.P.app.SERVING_KEY]
        svc.start()
        try:
            admin = await C.token("admin")
            for a in ("bot", "bot2"):
                await C.call("POST", "/agents/register",
                             json={"agent_id": a}, headers=admin)
                await C.call("POST", "/admin/llm_backend", json={
                    "agent_id": a, "backend_id": "b0"}, headers=admin)
            user = await C.token("user")
            gen = {"generation": {"max_new_tokens": 12}}
            if group:
                await C.call("POST", "/groups", json={
                    "group_name": "g", "agent_ids": ["bot", "bot2"]},
                    headers=user)
                st, raw, _ = await C.call("POST", "/groups/message", json={
                    "group_name": "g", "content": "hi both",
                    "stream": True, "metadata": gen}, headers=user,
                    keep=False)
                sent = [d["id"] for e, d in sse_events(raw, True)
                        if e == "message"]
            else:
                st, raw, _ = await C.call("POST", "/messages", json={
                    "receiver_id": "bot", "content": "hi bot",
                    "stream": True, "metadata": gen}, headers=user,
                    keep=False)
                sent = [d["id"] for e, d in sse_events(raw, True)
                        if e == "message"]
            assert st == 200 and sent
            await asyncio.sleep(1.0)   # the consumer's poll has run
            replies = [m for m in C.db.query_messages(receiver_id="user")
                       if m.metadata.get("reply_to") in sent]
            assert sorted(m.metadata["reply_to"] for m in replies) == \
                sorted(sent)
            c = svc.engine.metrics.counters
            assert c["engine_requests"].value == len(sent)
        finally:
            svc.stop()

    drive("torch", case, tmp_path, serving=serving)


def test_build_serving_on_the_cpu_answers_a_message(tmp_path, monkeypatch):
    """The server's backend builder with ``device="cpu"``: the SERVE_*
    settings shape the engine, the backend's tokenizer counts message
    tokens, and an LLM-backed agent's message gets a reply."""
    import time

    from swarmdb_tpu_torch.api.server import build_serving

    monkeypatch.setenv("SERVE_MODEL", "tiny-debug")
    monkeypatch.setenv("SERVE_MAX_BATCH", "2")
    monkeypatch.setenv("SERVE_MAX_SEQ", "128")
    monkeypatch.delenv("SWARMDB_PAGED", raising=False)
    db = trt.SwarmDB(broker=tbroker.LocalBroker(), save_dir=str(tmp_path))
    svc = build_serving(db, device="cpu")
    try:
        assert svc.engine.device.type == "cpu"
        assert (svc.engine.max_batch, svc.engine.max_seq) == (2, 128)
        assert db.token_counter is not None
        db.register_agent("user")
        db.register_agent("bot")
        db.assign_llm_backend("bot", svc.backend_id)
        svc.start()
        mid = db.send_message("user", "bot", "hello bot",
                              metadata={"generation": {"max_new_tokens": 6}})
        deadline = time.time() + 60
        replies = []
        while not replies and time.time() < deadline:
            replies = db.receive_messages("user", timeout=0.2)
        assert replies, "no reply arrived"
        assert replies[0].metadata["reply_to"] == mid
        assert replies[0].metadata["finish_reason"] in ("length", "eos")
    finally:
        svc.stop()
        db.close()


def _tiers_over(svc, tmp_path, pkg):
    """GET /admin/tiers and /metrics of ``pkg``'s app over ``svc``:
    (status, JSON body, the metrics' tier lines)."""
    P = PKGS[pkg]

    async def runner():
        db = P.SwarmDB(broker=P.LocalBroker(), save_dir=str(tmp_path))
        app = P.app.create_app(db, P.app.ApiConfig(**BASE_CFG), serving=svc)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/auth/token", json={
                "username": "admin", "password": "pw"})
            hdrs = {"Authorization":
                    f"Bearer {(await r.json())['access_token']}"}
            r = await client.get("/admin/tiers", headers=hdrs)
            body = await r.json()
            m = await client.get("/metrics")
            lines = [ln for ln in (await m.text()).splitlines()
                     if ln.startswith("swarmdb_tier_pages")
                     or ln.startswith("swarmdb_tier_demotions_total")]
            return r.status, body, lines
        finally:
            await client.close()
            db.close()

    return asyncio.run(runner())


def _shape(d):
    return {k: _shape(v) if isinstance(v, dict) else type(v).__name__
            for k, v in d.items()}


def test_admin_tiers_with_a_tier_manager_equals_jax(tmp_path, monkeypatch):
    """Over a rolling paged backend with its tier manager, after a turn
    whose conversation was then demoted: both packages' ``/admin/tiers``
    answer the same keys (the tier manager's ``status()``), warm pages
    and counters, and ``/metrics`` carries the tier gauges."""
    from tests.test_torch_tiering import (demote_all, tier_pair, turns,
                                          wait_parked)

    pair = tier_pair(monkeypatch, tmp_path / "svc")
    out = []
    for pkg, svc in zip(("jax", "torch"), pair):
        svc.start(warmup=False)
        try:
            turns(svc, "u", 1)
            wait_parked(svc, ("u", "bot"))
            assert demote_all(svc) > 0
            st, body, lines = _tiers_over(svc, tmp_path / pkg, pkg)
        finally:
            svc.stop()
            svc.db.close()
        assert st == 200 and body["enabled"] is True
        assert body["pages"]["warm"] > 0
        assert any(ln.startswith('swarmdb_tier_pages{tier="warm"}')
                   for ln in lines), lines
        body.pop("warm_hit_rate")
        out.append((_shape(body), body["pages"], body["counters"],
                    body["warm_store"]["entries"], lines))
    assert out[1] == out[0]


def test_admin_tiers_without_a_tier_manager_counts_hot_pages(tmp_path,
                                                              monkeypatch):
    """Rolling KV on but ``SWARMDB_TIER=0``: ``/admin/tiers`` still
    answers, tiering off, with the pool's hot pages after a kept turn,
    equal in both packages."""
    from tests.test_torch_rolling import chat, service_pair

    monkeypatch.setenv("SWARMDB_TIER", "0")
    pair = service_pair(monkeypatch, tmp_path / "svc", True)
    out = []
    for pkg, svc in zip(("jax", "torch"), pair):
        svc.start(warmup=False)
        try:
            chat(svc, "u", "hello there")
            st, body, _ = _tiers_over(svc, tmp_path / pkg, pkg)
        finally:
            svc.stop()
            svc.db.close()
        assert st == 200 and body["enabled"] is False
        out.append(body)
    assert out[1] == out[0] and out[1]["pages"]["hot"] > 0


# ------------------------------------------------------------ /admin/lanes


def _lanes_backend(pkg, kind, tmp_path, groups):
    """A ``pkg`` ServingService over one engine ("engine",
    "unsupervised") or over ``groups[pkg]``, a 2-lane group ("group"),
    not started."""
    from swarmdb_tpu.backend import service as jsvc
    from swarmdb_tpu.backend.tokenizer import default_tokenizer
    from swarmdb_tpu_torch.backend import service as tsvc

    svc_mod = jsvc if pkg == "jax" else tsvc
    db = PKGS[pkg].SwarmDB(broker=PKGS[pkg].LocalBroker(),
                           save_dir=str(tmp_path / pkg / "db"))
    if kind == "group":
        return svc_mod.ServingService(db, groups[pkg],
                                      default_tokenizer(512))
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return svc_mod.ServingService.from_model_name(
        db, "tiny-debug", max_batch=2, max_seq=64, **extra)


@pytest.mark.parametrize("kind", ["engine", "group", "unsupervised"])
def test_admin_lanes_equals_jax(kind, tmp_path, monkeypatch):
    """``GET /admin/lanes``: the supervisor's per-lane status over one
    engine (one lane) or a 2-lane group, the same in both packages but for
    the beat ages and the port's extra config keys; 503 without a
    supervisor (``SWARMDB_SUPERVISE=0``). ``/metrics`` carries one
    ``swarmdb_lane_state`` gauge per lane."""
    from tests.test_torch_lanes import build_pair

    monkeypatch.setenv("SWARMDB_SUPERVISE",
                       "0" if kind == "unsupervised" else "1")
    monkeypatch.delenv("SWARMDB_PAGED", raising=False)
    groups = {}
    if kind == "group":
        groups = dict(zip(("jax", "torch"), build_pair(monkeypatch)))
    out = {}
    for pkg in ("jax", "torch"):
        svc = _lanes_backend(pkg, kind, tmp_path, groups)
        P = PKGS[pkg]

        async def runner():
            db = P.SwarmDB(broker=P.LocalBroker(),
                           save_dir=str(tmp_path / pkg / "api"))
            app = P.app.create_app(db, P.app.ApiConfig(**BASE_CFG),
                                   serving=svc)
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                r = await client.post("/auth/token", json={
                    "username": "admin", "password": "pw"})
                hdrs = {"Authorization":
                        f"Bearer {(await r.json())['access_token']}"}
                r = await client.get("/admin/lanes", headers=hdrs)
                body = await r.json()
                m = await client.get("/metrics")
                lines = [ln for ln in (await m.text()).splitlines()
                         if ln.startswith("swarmdb_lane_state{")]
                return r.status, body, lines
            finally:
                await client.close()
                db.close()

        try:
            out[pkg] = asyncio.run(runner())
        finally:
            svc.stop()
            svc.db.close()
    for pkg in ("jax", "torch"):
        st, body, lines = out[pkg]
        if kind == "unsupervised":
            assert st == 503 and "no lane supervisor" in body["detail"]
            assert lines == []
            continue
        assert st == 200
        for lane in body["lanes"]:
            assert lane.pop("beat_age_s") >= 0
        body["config"] = {k: v for k, v in body["config"].items()
                          if k in ("suspect_s", "quarantine_s",
                                   "probe_clean_n", "deadline_s", "retries")}
    assert out["torch"] == out["jax"]
    if kind != "unsupervised":
        lanes = 2 if kind == "group" else 1
        assert len(out["torch"][1]["lanes"]) == lanes
        assert out["torch"][2] == [f'swarmdb_lane_state{{lane="{i}"}} 0'
                                   for i in range(lanes)]
