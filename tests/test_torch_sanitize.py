"""The three runtime sanitizers over the port's serving paths on the CPU.

One subprocess with ``SWARMDB_LOCKCHECK=1 SWARMDB_PAGECHECK=1
SWARMDB_KERNCHECK=1`` (module-level locks take their flag at import, so
the flags are set before the port is imported) drives a tiny-debug paged
service through a supervised kill mid-stream, a rolling conversation
demoted to the warm tier and promoted back, and a one-device fleet
(``prefill:1,decode:1`` over two CPU lanes) handing requests off through
the transit store. Every reply must end length / eos, and the three
registries must hold zero cycles and zero violations while each shows it
watched (lock sites, page churn, kernel checks). The port's counterpart
of the JAX package's sanitizer CI jobs (tests/conftest.py's session
check).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

DRIVE = r'''
import json, os, threading, time
import torch
torch.set_num_threads(1)
from swarmdb_tpu_torch.backend.chaos import ServingChaos
from swarmdb_tpu_torch.backend.service import ServingService
from swarmdb_tpu_torch.backend.tokenizer import default_tokenizer
from swarmdb_tpu_torch.broker.local import LocalBroker
from swarmdb_tpu_torch.core.messages import Message
from swarmdb_tpu_torch.core.runtime import SwarmDB
from swarmdb_tpu_torch.obs import kerncheck, lockcheck, pagecheck
from swarmdb_tpu_torch.parallel import build_serving_engine

out = {"reasons": []}
GEN = {"max_new_tokens": 12, "temperature": 0.0}


def chat(db, user, text, timeout=120.0):
    mid = db.send_message(user, "bot", text,
                          metadata={"generation": dict(GEN)})
    deadline = time.time() + timeout
    while time.time() < deadline:
        for m in db.receive_messages(user, timeout=0.2):
            if m.metadata.get("reply_to") == mid:
                out["reasons"].append(m.metadata["finish_reason"])
                return
    raise AssertionError(f"no reply to {text!r}")


def new_db(name):
    db = SwarmDB(broker=LocalBroker(), save_dir=os.path.join(SAVE, name))
    for a in ("u1", "u2", "bot"):
        db.register_agent(a)
    db.assign_llm_backend("bot", "b0")
    return db


SAVE = os.environ["SANITIZE_SAVE"]

# (1) a supervised paged service, one decode killed mid-stream
os.environ["SWARMDB_PAGED"] = "1"
db = new_db("chaos")
svc = ServingService.from_model_name(db, "tiny-debug", backend_id="b0",
                                     max_batch=4, max_seq=128,
                                     decode_chunk=4, page_size=8,
                                     device="cpu")
svc.supervisor.poll_s = 0.05
chaos = ServingChaos(svc.engine)
svc.start()
streamed, got, done = [], {}, threading.Event()


def on_token(rid, tok):
    streamed.append(tok)
    if len(streamed) == 4:
        chaos.kill_lane(0)


def on_done(rid, toks, reason):
    got.update(reason=reason, n=len(toks))
    done.set()


svc.serve_message(Message(sender_id="u1", receiver_id="bot",
                          content="keep talking for a while",
                          metadata={"generation": {"max_new_tokens": 16}}),
                  on_token=on_token, on_done=on_done)
assert done.wait(120), "the killed request never finished"
out["reasons"].append(got["reason"])
out["retried"] = svc.supervisor.status()["requests_retried"]
for i in range(3):
    chat(db, "u2", f"turn {i}: say something about sanitizers " * 3)
chaos.stop()
svc.stop()

# (2) rolling KV: demote to the warm tier between turns, promote back
os.environ["SWARMDB_ROLLING_KV"] = "1"
db = new_db("rolling")
svc = ServingService.from_model_name(db, "tiny-debug", backend_id="b0",
                                     max_batch=4, max_seq=256,
                                     decode_chunk=4, page_size=8,
                                     device="cpu")
svc._tier.min_idle_s = 0.0
svc.start()
chat(db, "u1", "the first turn of a long conversation " * 3)
chat(db, "u2", "another conversation entirely " * 2)
with svc._rolling_lock:
    svc._tier.demote_now(10 ** 6)
chat(db, "u1", "and a second turn")
chat(db, "u2", "a follow-up")
counters = db.metrics.snapshot()["counters"]
out["demotions"] = counters.get("tier_demotions", 0)
out["promotions"] = counters.get("tier_promotions", 0)
svc.stop()
os.environ["SWARMDB_ROLLING_KV"] = "0"

# (3) a fleet over two lanes of one device: prefill -> decode handoffs
os.environ["SWARMDB_FLEET"] = "prefill:1,decode:1"
os.environ["SWARMDB_FLEET_TRANSIT_MB"] = "16"
g, _info = build_serving_engine("tiny-debug", ["cpu", "cpu"], max_batch=4,
                                max_seq=128, paged=True, page_size=8,
                                decode_chunk=4)
db = new_db("fleet")
svc = ServingService(db, g, default_tokenizer(512), backend_id="b0")
svc.start()
for i in range(4):
    chat(db, "u1" if i % 2 else "u2", f"handoff number {i} " * 4)
out["handoffs"] = g.fleet.stats()["handoffs"]
svc.stop()

out["cycles"] = lockcheck.registry().cycles()
out["lock_sites"] = len(lockcheck.registry().report()["sites"])
page = pagecheck.registry().report()
out["page_violations"] = page["violations"]
out["page_churn"] = sum(p["churn_allocated"] for p in page["pools"])
out["page_lanes"] = sorted({p["lane"] for p in page["pools"] if p["lane"]})
kern = kerncheck.registry().report()
out["kern_violations"] = kern["violations"]
out["kern_checks"] = kern["checks"]
print("SANITIZE " + json.dumps(out, default=str))
'''


def test_serving_paths_clean_under_all_three_sanitizers(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SWARMDB_")}
    env.update(SWARMDB_LOCKCHECK="1", SWARMDB_PAGECHECK="1",
               SWARMDB_KERNCHECK="1", SWARMDB_FLIGHT_DIR=str(tmp_path),
               SWARMDB_NODE_ID="sanitize", SANITIZE_SAVE=str(tmp_path),
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", DRIVE], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("SANITIZE "))
    out = json.loads(line[len("SANITIZE "):])
    assert set(out["reasons"]) <= {"length", "eos"}, out["reasons"]
    assert out["retried"] >= 1
    assert out["demotions"] >= 1 and out["promotions"] >= 1
    assert out["handoffs"] >= 1
    assert out["cycles"] == []
    assert out["page_violations"] == []
    assert out["kern_violations"] == []
    assert out["lock_sites"] >= 5
    assert out["page_churn"] > 0
    assert out["page_lanes"] == ["lane0", "lane1"]
    assert out["kern_checks"].get("wave-descriptors", 0) >= 1
    assert out["kern_checks"].get("shadow.ragged-prefill", 0) >= 1
    # a violation would have dumped at once; at exit every registry dumps
    for name in ("lockcheck", "pagecheck", "kerncheck"):
        dump = json.loads((tmp_path / f"{name}_sanitize.json").read_text())
        assert dump.get("violations", dump.get("cycles")) == []
