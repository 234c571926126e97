"""Demo session: ``python -m swarmdb_tpu_torch``.

The walkthrough of ``python -m swarmdb_tpu``: three agents, two unicasts,
a broadcast, polled receives, a group send, the stats, close. The in-tree
broker needs no external cluster, so the messaging part runs anywhere. Set
``SWARMDB_DEMO_MODEL`` (e.g. ``tiny-debug``) to attach a serving backend
and get a generated reply; it runs on the card unless
``SWARMDB_DEMO_DEVICE=cpu``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from .core.runtime import SwarmDB


def main() -> None:
    save_dir = os.environ.get("SAVE_DIR") or tempfile.mkdtemp(
        prefix="swarm_demo_")
    with SwarmDB(save_dir=save_dir) as db:
        for agent in ("orchestrator", "researcher", "coder"):
            db.register_agent(agent)
        print(f"registered agents: {sorted(db.registered_agents)}")

        db.send_message("orchestrator", "researcher",
                        "Find papers on ring attention.")
        db.send_message("orchestrator", "coder",
                        {"task": "implement", "module": "ring_attention"},
                        message_type="command")
        db.broadcast_message("orchestrator", "Standup in 5 minutes.")

        for agent in ("researcher", "coder"):
            for m in db.receive_messages(agent, max_messages=10, timeout=1.0):
                print(f"  {agent} <- {m.sender_id}: {m.content!r} "
                      f"[{m.type.value}]")

        db.add_agent_group("builders", ["researcher", "coder"])
        ids = db.send_to_group("orchestrator", "builders", "Ship it today.")
        print(f"group fan-out sent {len(ids)} messages")

        model = os.environ.get("SWARMDB_DEMO_MODEL")
        if model:
            from .backend.service import ServingService

            svc = ServingService.from_model_name(
                db, model, max_batch=4, max_seq=256,
                device=os.environ.get("SWARMDB_DEMO_DEVICE") or None)
            svc.start()
            try:
                db.register_agent("assistant")
                db.assign_llm_backend("assistant", svc.backend_id)
                mid = db.send_message(
                    "orchestrator", "assistant", "Summarize the plan.",
                    metadata={"generation": {"max_new_tokens": 16}})
                deadline = time.time() + 120
                while time.time() < deadline:
                    replies = [m for m in db.receive_messages(
                        "orchestrator", max_messages=10, timeout=0.5)
                        if m.metadata.get("reply_to") == mid]
                    if replies:
                        print(f"assistant replied: {replies[0].content!r}")
                        break
            finally:
                svc.stop()

        print(json.dumps(db.get_stats(), indent=2, default=str))


if __name__ == "__main__":
    main()
