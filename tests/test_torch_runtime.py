"""PyTorch port vs JAX reference: the SwarmDB messaging runtime.

Every case of ``tests/test_runtime.py`` runs as one scripted session
through both packages' ``SwarmDB``, each over a fresh ``LocalBroker`` and
its own save directory. A session keeps its own checks (the reference
test's assertions, held in both packages) and records what it observed:
contents, senders, receivers, types, priorities, statuses, visibility,
metadata, the order of every returned list, and the stats. Message ids
are uuids drawn per run, so the record names each message by the order
in which the session first saw it. The two records must be equal
(exactly: no tolerance applies to a messaging runtime).

One more case loads a snapshot saved by one package into the other, both
ways: the snapshot schema is shared.
"""

import json
import os
import time
from types import SimpleNamespace

import pytest

import swarmdb_tpu.broker.local as jbroker
import swarmdb_tpu.core.messages as jmsgs
import swarmdb_tpu.core.runtime as jrt
import swarmdb_tpu_torch.broker.local as tbroker
import swarmdb_tpu_torch.core.messages as tmsgs
import swarmdb_tpu_torch.core.runtime as trt


def _pkg(rt, broker, msgs):
    return SimpleNamespace(SwarmDB=rt.SwarmDB, SwarmsDB=rt.SwarmsDB,
                           LocalBroker=broker.LocalBroker,
                           MessageStatus=msgs.MessageStatus,
                           MessageType=msgs.MessageType,
                           MessagePriority=msgs.MessagePriority)


PKGS = {"jax": _pkg(jrt, jbroker, jmsgs), "torch": _pkg(trt, tbroker, tmsgs)}
VOLATILE_META = ("stages", "partition", "offset")


class Session:
    """One package's run of a case: its runtime, and the record."""

    def __init__(self, P, tmp_path):
        self.P = P
        self.tmp = tmp_path
        self.record = []
        self._ids = {}

    def db(self, name="history", **kw):
        kw.setdefault("broker", self.P.LocalBroker())
        return self.P.SwarmDB(save_dir=str(self.tmp / name), **kw)

    def mid(self, message_id):
        """A message's name in the record: the order it was first seen."""
        if message_id is None:
            return None
        return self._ids.setdefault(message_id, f"m{len(self._ids)}")

    def msg(self, m):
        if m is None:
            return None
        meta = {k: v for k, v in m.metadata.items() if k not in VOLATILE_META}
        for k in ("resent_from", "resent_to", "reply_to"):
            if k in meta:
                meta[k] = self.mid(meta[k])
        if "read_by" in meta:
            meta["read_by"] = sorted(meta["read_by"])
        return (self.mid(m.id), m.sender_id, m.receiver_id, m.content,
                m.type.value, int(m.priority.value), m.status.value,
                sorted(m.visible_to), meta, m.token_count)

    def see(self, what, value):
        if isinstance(value, list) and value and hasattr(value[0], "id"):
            value = [self.msg(m) for m in value]
        elif hasattr(value, "id") and hasattr(value, "sender_id"):
            value = self.msg(value)
        self.record.append((what, value))
        return value

    def stats(self, db):
        s = db.get_stats()
        s["metrics"] = {"counters": s["metrics"]["counters"]}
        self.see("stats", s)


# ---------------------------------------------------------------- the cases


def case_alias(S):
    assert S.P.SwarmsDB is S.P.SwarmDB


def case_register_deregister(S):
    db = S.db()
    try:
        assert db.register_agent("a", metadata={"role": "tester"})
        assert not db.register_agent("a")
        assert "a" in db.registered_agents
        assert db.agent_metadata["a"]["role"] == "tester"
        assert db.deregister_agent("a")
        assert not db.deregister_agent("a")
        assert "a" not in db.registered_agents
        S.see("agents", sorted(db.registered_agents))
        S.stats(db)
    finally:
        db.close()


def case_send_receive_unicast(S):
    db = S.db()
    try:
        mid = db.send_message("alice", "bob", "hello bob")
        msg = db.get_message(mid)
        assert msg.status == S.P.MessageStatus.DELIVERED
        assert "partition" in msg.metadata
        S.see("sent", msg)
        got = db.receive_messages("bob", max_messages=5, timeout=1.0)
        assert [m.id for m in got] == [mid]
        assert got[0].status == S.P.MessageStatus.READ
        S.see("received", got)
        S.stats(db)
    finally:
        db.close()


def case_receive_does_not_leak(S):
    db = S.db()
    try:
        db.send_message("s", "r1", "for r1")
        db.send_message("s", "r2", "for r2")
        got1 = db.receive_messages("r1", timeout=0.5)
        got2 = db.receive_messages("r2", timeout=0.5)
        assert [m.receiver_id for m in got1] == ["r1"]
        assert [m.receiver_id for m in got2] == ["r2"]
        S.see("r1", got1)
        S.see("r2", got2)
    finally:
        db.close()


def case_broadcast_visibility_and_exclusion(S):
    db = S.db()
    try:
        for a in ("a", "b", "c", "d"):
            db.register_agent(a)
        mid = db.broadcast_message("a", "all hands", exclude_agents=["d"])
        msg = db.get_message(mid)
        assert msg.receiver_id is None and set(msg.visible_to) == {"b", "c"}
        for a, t in (("b", 0.5), ("c", 0.5), ("d", 0.2), ("a", 0.2)):
            got = db.receive_messages(a, timeout=t)
            assert [m.id for m in got] == ([mid] if a in "bc" else [])
            S.see(f"recv {a}", got)
        S.see("broadcast", db.get_message(mid))
        S.stats(db)
    finally:
        db.close()


def case_send_auto_registers(S):
    db = S.db()
    try:
        db.send_message("newbie", "other", "hi")
        assert {"newbie", "other"} <= db.registered_agents
        S.see("agents", sorted(db.registered_agents))
    finally:
        db.close()


def case_token_counting(S):
    db = S.db(token_counter=lambda text: len(text.split()))
    try:
        mid = db.send_message("a", "b", "one two three")
        assert db.get_message(mid).token_count == 3
        mid2 = db.send_message("a", "b", {"k": "v"})
        assert db.get_message(mid2).token_count == len(
            json.dumps({"k": "v"}).split())
        S.see("counted", [db.get_message(mid), db.get_message(mid2)])
    finally:
        db.close()


def case_get_agent_messages_pagination(S):
    db = S.db()
    try:
        ids = [db.send_message("s", "r", f"m{i}") for i in range(10)]
        page = db.get_agent_messages("r", limit=3)
        assert [m.id for m in page] == ids[-1:-4:-1]
        page2 = db.get_agent_messages("r", limit=3, skip=3)
        assert [m.id for m in page2] == ids[-4:-7:-1]
        db.mark_message_as_processed(ids[0])
        done = db.get_agent_messages("r", status=S.P.MessageStatus.PROCESSED)
        assert [m.id for m in done] == [ids[0]]
        for i in ids:
            S.mid(i)
        S.see("page", page)
        S.see("page2", page2)
        S.see("processed", done)
    finally:
        db.close()


def case_query_messages_filters(S):
    db = S.db()
    P = S.P
    try:
        t0 = time.time()
        m1 = db.send_message("a", "b", "x", message_type=P.MessageType.CHAT)
        m2 = db.send_message("b", "a", "y",
                             message_type=P.MessageType.COMMAND)
        m3 = db.send_message("a", "c", "z", message_type=P.MessageType.CHAT,
                             priority=P.MessagePriority.HIGH)
        for i in (m1, m2, m3):
            S.mid(i)
        assert {m.id for m in db.query_messages(sender_id="a")} == {m1, m3}
        assert [m.id for m in db.query_messages(
            message_type=P.MessageType.COMMAND)] == [m2]
        assert {m.id for m in db.query_messages(start_time=t0)} == {m1, m2,
                                                                     m3}
        assert db.query_messages(end_time=t0 - 1) == []
        assert len(db.query_messages(limit=2)) == 2
        S.see("by sender", sorted(S.msg(m) for m in
                                  db.query_messages(sender_id="a")))
        S.see("commands", db.query_messages(
            message_type=P.MessageType.COMMAND))
        S.see("high", db.query_messages(status="delivered",
                                        receiver_id="c"))
        S.see("involving c", db.query_messages(involving="c"))
    finally:
        db.close()


def case_search_messages(S):
    db = S.db()
    try:
        m1 = db.send_message("a", "b", "The Quick brown fox")
        db.send_message("a", "b", "nothing here")
        m3 = db.send_message("a", "b", {"tool": "quicksort"})
        S.mid(m1)
        S.mid(m3)
        assert {m.id for m in db.search_messages("quick")} == {m1, m3}
        assert [m.id for m in db.search_messages(
            "Quick", case_sensitive=True)] == [m1]
        S.see("quick", sorted(S.msg(m) for m in db.search_messages("quick")))
        S.see("Quick", db.search_messages("Quick", case_sensitive=True))
    finally:
        db.close()


def case_conversation(S):
    db = S.db()
    try:
        ids = [db.send_message("a", "b", "1"), db.send_message("b", "a", "2"),
               db.send_message("a", "b", "3")]
        db.send_message("a", "c", "unrelated")
        convo = db.get_conversation("a", "b", limit=10)
        assert [m.id for m in convo] == ids
        S.see("convo", convo)
        S.see("last 2", db.get_conversation("b", "a", limit=2))
        S.see("length", db.conversation_length("b", "a"))
    finally:
        db.close()


def case_window_and_delta_agree_on_order(S):
    db = S.db()
    try:
        ids = [db.send_message("a", "b", f"m{i}") for i in range(6)]
        db.messages[ids[2]].timestamp, db.messages[ids[4]].timestamp = (
            db.messages[ids[4]].timestamp, db.messages[ids[2]].timestamp)
        window = db.get_conversation_window("a", "b", limit=10)
        total, delta = db.get_conversation_delta("a", "b", 0)
        assert [m.id for m in window] == ids == [m.id for m in delta]
        S.see("window", window)
        S.see("delta", (total, [S.msg(m) for m in delta]))
        S.see("window 4", db.get_conversation_window("a", "b", limit=4))
    finally:
        db.close()


def case_status_management_and_resend(S):
    db = S.db()
    P = S.P
    try:
        mid = db.send_message("a", "b", "x")
        assert db.mark_message_as_processed(mid)
        assert db.get_message(mid).status == P.MessageStatus.PROCESSED
        assert not db.update_message_status("nope", P.MessageStatus.READ)
        db.update_message_status(mid, P.MessageStatus.FAILED)
        new_ids = db.resend_failed_messages()
        assert len(new_ids) == 1
        assert db.get_message(new_ids[0]).metadata["resent_from"] == mid
        assert db.get_message(mid).metadata["resent_to"] == new_ids[0]
        assert db.resend_failed_messages() == []
        S.see("original", db.get_message(mid))
        S.see("resent", db.get_message(new_ids[0]))
        S.stats(db)
    finally:
        db.close()


def case_groups(S):
    db = S.db()
    try:
        db.add_agent_group("team", ["a", "b", "c"])
        assert db.get_agent_group("team") == ["a", "b", "c"]
        ids = db.send_to_group("a", "team", "standup")
        assert len(ids) == 2
        assert {db.get_message(i).receiver_id for i in ids} == {"b", "c"}
        assert all(db.get_message(i).metadata["group"] == "team"
                   for i in ids)
        with pytest.raises(KeyError):
            db.send_to_group("a", "ghost", "x")
        S.see("group", db.get_agent_group("team"))
        S.see("sent", [db.get_message(i) for i in ids])
        S.see("unknown", db.get_agent_group("ghost"))
    finally:
        db.close()


def case_persistence_roundtrip(S):
    db = S.db("h1")
    db.register_agent("a")
    mid = db.send_message("a", "b", "persist me", metadata={"k": 1})
    path = db.save_message_history()
    assert os.path.exists(path)
    db.close()
    db2 = S.db("h2")
    try:
        assert db2.load_message_history(path) >= 1
        msg = db2.get_message(mid)
        assert msg.content == "persist me"
        assert {"a", "b"} <= db2.registered_agents
        assert mid in [m.id for m in db2.get_agent_messages("b")]
        S.see("loaded", msg)
        S.see("agents", sorted(db2.registered_agents))
        S.stats(db2)
    finally:
        db2.close()


def case_yaml_export(S):
    import yaml

    db = S.db()
    try:
        db.send_message("a", "b", "to yaml")
        with open(db.export_as_yaml()) as f:
            state = yaml.safe_load(f)
        assert state["message_count"] == 1 and len(state["messages"]) == 1
        S.see("yaml", (state["message_count"], state["registered_agents"],
                       sorted(state["agent_inbox"]),
                       [m["content"] for m in state["messages"].values()]))
    finally:
        db.close()


def case_delete_and_flush_old(S):
    db = S.db()
    try:
        mid = db.send_message("a", "b", "temp")
        assert db.delete_message(mid)
        assert not db.delete_message(mid)
        assert db.get_agent_messages("b") == []
        mid2 = db.send_message("a", "b", "old one")
        db.get_message(mid2).timestamp = time.time() - 10 * 24 * 3600
        assert db.flush_old_messages(max_age_seconds=7 * 24 * 3600) == 1
        assert db.get_message(mid2) is None
        archives = os.listdir(os.path.join(db.save_dir, "archives"))
        assert len(archives) == 1
        with open(os.path.join(db.save_dir, "archives", archives[0])) as f:
            S.see("archived", [m["content"]
                               for m in json.load(f)["messages"]])
        S.stats(db)
    finally:
        db.close()


def case_stats_and_load(S):
    db = S.db()
    P = S.P
    try:
        db.send_message("a", "b", "1")
        db.send_message("a", "b", "2", message_type=P.MessageType.COMMAND)
        db.send_message("b", "a", "3")
        stats = db.get_stats()
        assert stats["total_messages"] == 3
        assert stats["messages_by_type"] == {"chat": 2, "command": 1}
        assert stats["messages_by_agent"]["a"] == {"sent": 2, "received": 1}
        assert stats["messages_by_status"]["delivered"] == 3
        S.stats(db)
        assert db.get_unread_message_count("b") == 2
        db.receive_messages("b", timeout=0.5)
        assert db.get_unread_message_count("b") == 0
        load = db.get_agent_load("b")
        assert load["inbox_size"] == 2 and load["messages_per_second"] > 0
        S.see("load", {k: v for k, v in load.items()
                       if k != "messages_per_second"})
        S.stats(db)
    finally:
        db.close()


def case_llm_backend_assignment(S):
    db = S.db()
    try:
        db.set_llm_load_balancing(True)
        assert db.llm_load_balancing_enabled
        for a, b in (("agent1", "tpu-0"), ("agent2", "tpu-0"),
                     ("agent3", "tpu-1")):
            db.assign_llm_backend(a, b)
        assert db.get_llm_backend("agent1") == "tpu-0"
        assert db.get_llm_backend("ghost") is None
        assert sorted(db.agents_for_backend("tpu-0")) == ["agent1", "agent2"]
        S.see("tpu-1", db.agents_for_backend("tpu-1"))
    finally:
        db.close()


def case_auto_scale_partitions(S):
    db = S.db()
    try:
        assert db.auto_scale_partitions() == 3
        for i in range(35):
            db.register_agent(f"agent{i}")
        assert db.auto_scale_partitions() == 12
        assert db.broker.list_topics()[db.topic_name].num_partitions == 12
        mid = db.send_message("agent0", "agent1", "post-scale")
        got = db.receive_messages("agent1", timeout=1.0)
        assert mid in [m.id for m in got]
        S.see("post-scale", got)
        S.see("partitions", [db._get_partition(f"agent{i}")
                             for i in range(35)])
    finally:
        db.close()


def case_context_manager_and_final_save(S):
    with S.db("ctx") as db:
        db.send_message("a", "b", "bye")
    saves = [f for f in os.listdir(S.tmp / "ctx") if f.endswith(".json")]
    assert saves
    with open(S.tmp / "ctx" / saves[0]) as f:
        state = json.load(f)
    S.see("final save", (state["message_count"],
                         [m["status"] for m in state["messages"].values()]))


def case_error_topic_receives_failed_sends(S):
    class FlakyBroker(S.P.LocalBroker):
        def __init__(self):
            super().__init__()
            self.fail_next = False

        def append(self, topic, partition, value, key=None, timestamp=None):
            if self.fail_next and topic != "swarm_messages_errors":
                raise RuntimeError("injected broker failure")
            return super().append(topic, partition, value, key, timestamp)

    b = FlakyBroker()
    db = S.db(broker=b)
    try:
        db.register_agent("a")
        db.register_agent("b")
        b.fail_next = True
        with pytest.raises(RuntimeError):
            db.send_message("a", "b", "doomed")
        b.fail_next = False
        failed = db.query_messages(status=S.P.MessageStatus.FAILED)
        assert len(failed) == 1 and "error" in failed[0].metadata
        assert b.end_offset("swarm_messages_errors", 0) == 1
        S.see("failed", failed)
    finally:
        db.close()


def case_broadcast_exclude_all(S):
    db = S.db()
    try:
        for a in ("a", "b", "c"):
            db.register_agent(a)
        mid = db.broadcast_message("a", "secret", exclude_agents=["b", "c"])
        assert db.get_message(mid).visible_to == []
        assert db.receive_messages("b", timeout=0.3) == []
        assert db.receive_messages("c", timeout=0.3) == []
        assert db.get_message(mid).status == S.P.MessageStatus.DELIVERED
        S.see("secret", db.get_message(mid))
    finally:
        db.close()


def case_scale_preserves_undelivered_and_no_replay(S):
    db = S.db()
    try:
        for i in range(5):
            db.register_agent(f"agent{i}")
        bid = db.broadcast_message("agent0", "pre-scale broadcast")
        assert bid in [m.id for m in db.receive_messages("agent1",
                                                         timeout=0.5)]
        pending = db.send_message("agent0", "agent2", "pending across scale")
        for i in range(5, 35):
            db.register_agent(f"agent{i}")
        db.auto_scale_partitions()
        got2 = db.receive_messages("agent2", max_messages=50, timeout=1.0)
        assert pending in [m.id for m in got2]
        got1 = db.receive_messages("agent1", max_messages=50, timeout=0.5)
        assert bid not in [m.id for m in got1]
        S.see("agent2", got2)
        S.see("agent1", got1)
    finally:
        db.close()


def case_stats_decrement_on_delete(S):
    db = S.db()
    try:
        for i in [db.send_message("a", "b", f"m{i}") for i in range(3)]:
            db.delete_message(i)
        s = db.get_stats()
        assert s["messages_by_agent"]["a"]["sent"] == 0
        assert s["messages_by_agent"]["b"]["received"] == 0
        assert s["messages_by_type"].get("chat", 0) == 0
        S.stats(db)
    finally:
        db.close()


def case_snapshot_with_separator_chars_in_ids(S):
    path = str(S.tmp / "snap.json")
    db = S.db("h", broker=S.P.LocalBroker(snapshot_path=path))
    db.send_message("team|alpha", "user|beta", "pipes everywhere")
    S.see("got", db.receive_messages("user|beta", timeout=0.5))
    part = db._get_partition("user|beta")
    db.close()
    b2 = S.P.LocalBroker(snapshot_path=path)
    committed = b2.committed_offset(f"{db.config.group_id}_user|beta",
                                    db.topic_name, part)
    assert committed is not None
    S.see("committed", (part, committed))


def case_broadcast_no_duplicate_after_scale(S):
    db = S.db()
    try:
        for i in range(35):
            db.register_agent(f"agent{i}")
        db.auto_scale_partitions()
        bid = db.broadcast_message("agent0", "once please")
        got = db.receive_messages("agent1", max_messages=50, timeout=1.0)
        assert [m.id for m in got].count(bid) == 1
        S.see("got", got)
    finally:
        db.close()


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_runtime_session_equals_jax(case, tmp_path):
    records = {}
    for name, P in PKGS.items():
        S = Session(P, tmp_path / name)
        (tmp_path / name).mkdir()
        CASES[case](S)
        records[name] = S.record
    assert records["torch"] == records["jax"]


def _loaded_stats(db):
    """Stats without the metrics and without zero status counts (a
    message that went PENDING -> DELIVERED leaves ``pending: 0`` behind;
    a loaded one never passed through PENDING)."""
    s = {k: v for k, v in db.get_stats().items() if k != "metrics"}
    s["messages_by_status"] = {k: v for k, v
                               in s["messages_by_status"].items() if v}
    return s


@pytest.mark.parametrize("saver,loader", [("jax", "torch"),
                                          ("torch", "jax")])
def test_snapshot_loads_across_packages(saver, loader, tmp_path):
    """A history saved by one package loads into the other: the same
    messages, inboxes, agents and stats."""
    src = PKGS[saver].SwarmDB(broker=PKGS[saver].LocalBroker(),
                              save_dir=str(tmp_path / "src"))
    src.send_message("a", "b", "first")
    src.broadcast_message("b", {"note": "everyone"})
    src.add_agent_group("g", ["a", "b", "c"])
    src.send_to_group("c", "g", "group hello")
    path = src.save_message_history()
    want = Session(PKGS[saver], tmp_path)
    want.see("stats", _loaded_stats(src))
    want.see("inbox b", src.get_agent_messages("b"))
    src.close()
    dst = PKGS[loader].SwarmDB(broker=PKGS[loader].LocalBroker(),
                               save_dir=str(tmp_path / "dst"))
    try:
        assert dst.load_message_history(path) == 4
        got = Session(PKGS[loader], tmp_path)
        got.see("stats", _loaded_stats(dst))
        got.see("inbox b", dst.get_agent_messages("b"))
        assert got.record == want.record
        assert sorted(dst.registered_agents) == ["a", "b", "c"]
    finally:
        dst.close()
