"""Server entry point: ``python -m swarmdb_tpu_torch.api.server``.

Builds SwarmDB + the aiohttp app from the JAX package's env-var catalog:
KAFKA_GROUP_ID, KAFKA_NUM_PARTITIONS, KAFKA_TOPIC, SAVE_DIR,
AUTOSAVE_INTERVAL, BROKER_IMPL, JWT_SECRET_KEY, TOKEN_EXPIRE_MINUTES,
RATE_LIMIT_PER_MINUTE, CORS_ORIGINS, API_HOST, API_PORT, API_SSL_CERT /
API_SSL_KEY, API_MAX_REQUESTS, API_SHUTDOWN_TIMEOUT, LOG_FILE. One process
owns the broker: a single node over ``LocalBroker``.

Set ``SERVE_MODEL`` (``llama3-8b``, ``tiny-debug``, ...) to attach a
serving backend (``ServingService.from_model_name``) on the card
(``build_serving(db, device="cpu")`` puts it on the CPU). ``SERVE_MAX_BATCH``,
``SERVE_MAX_SEQ``, ``SERVE_CHUNK`` and ``SERVE_SEED`` shape the engine;
``SWARMDB_PAGED=1`` picks the paged one. An agent becomes LLM-backed with
``POST /admin/llm_backend`` naming the backend ``gpu-0`` (its id is also
in ``GET /health``).

Not ported yet, and refused with ``NotImplementedError``: the native
broker (``BROKER_IMPL=native``) and HA (``SWARMDB_HA_NODE_ID`` /
``SWARMDB_HA_CLUSTER``), ROADMAP.md queue 1 item 12; multi-process
serving (``SWARMDB_COORDINATOR`` / ``SWARMDB_NUM_PROCESSES`` > 1),
item 11. ``BROKER_IMPL=auto`` takes ``LocalBroker``, as the JAX server
does where the native library is absent.
"""

from __future__ import annotations

import os

from aiohttp import web

from ..core.messages import BrokerConfig
from ..core.runtime import SwarmDB
from ..utils.device import DeviceLike
from .app import ApiConfig, create_app


def refuse_unported() -> None:
    """Raise for the deployment modes of the JAX server that the port
    does not have yet."""
    if os.environ.get("SWARMDB_HA_NODE_ID") or os.environ.get(
            "SWARMDB_HA_CLUSTER"):
        raise NotImplementedError(
            "HA serving (SWARMDB_HA_NODE_ID / SWARMDB_HA_CLUSTER) is not "
            "ported yet (ROADMAP.md, queue 1 item 12)")
    if os.environ.get("BROKER_IMPL", "auto") == "native":
        raise NotImplementedError(
            "BROKER_IMPL=native: the C++ broker is not ported yet "
            "(ROADMAP.md, queue 1 item 12); use auto or python")
    if (os.environ.get("SWARMDB_COORDINATOR")
            or int(os.environ.get("SWARMDB_NUM_PROCESSES", "1")) > 1):
        raise NotImplementedError(
            "multi-process serving is not ported yet (ROADMAP.md, queue 1 "
            "item 11)")


def build_db() -> SwarmDB:
    cfg = BrokerConfig(
        bootstrap_servers=os.environ.get("KAFKA_BOOTSTRAP_SERVERS",
                                         "localhost:9092"),
        group_id=os.environ.get("KAFKA_GROUP_ID", "swarm_agents"),
        num_partitions=int(os.environ.get("KAFKA_NUM_PARTITIONS", "3")),
        log_dir=os.environ.get("BROKER_LOG_DIR") or None,
        implementation=os.environ.get("BROKER_IMPL", "auto"),
    )
    return SwarmDB(
        config=cfg,
        topic_name=os.environ.get("KAFKA_TOPIC", "swarm_messages"),
        save_dir=os.environ.get("SAVE_DIR", "message_history"),
        autosave_interval=float(os.environ.get("AUTOSAVE_INTERVAL", "300")),
    )


def build_serving(db: SwarmDB, device: DeviceLike = None):
    """The ``SERVE_MODEL`` backend, or None without one. ``device``
    (default the card) lets a caller ask for the CPU."""
    model_name = os.environ.get("SERVE_MODEL")
    if not model_name:
        return None
    from ..backend.service import ServingService

    serving = ServingService.from_model_name(
        db, model_name,
        max_batch=int(os.environ.get("SERVE_MAX_BATCH", "8")),
        max_seq=int(os.environ.get("SERVE_MAX_SEQ", "1024")),
        decode_chunk=int(os.environ.get("SERVE_CHUNK", "8")),
        seed=int(os.environ.get("SERVE_SEED", "0")),
        tokenizer_path=os.environ.get("SERVE_TOKENIZER") or None,
        device=device)
    if db.token_counter is None:
        # the backend's tokenizer fills Message.token_count
        db.token_counter = serving.tokenizer.count
    return serving


def build_ssl_context():
    """HTTPS when API_SSL_CERT (+ API_SSL_KEY) is set, else None."""
    cert = os.environ.get("API_SSL_CERT")
    if not cert:
        return None
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, os.environ.get("API_SSL_KEY") or None)
    return ctx


def main() -> None:
    from ..utils.logsink import configure_logging

    configure_logging()
    refuse_unported()
    db = build_db()
    serving = build_serving(db)
    cfg = ApiConfig.from_env()

    def _recycle() -> None:
        # SIGTERM ourselves: aiohttp drains in-flight requests within
        # shutdown_timeout and the process supervisor starts a fresh one
        import signal

        os.kill(os.getpid(), signal.SIGTERM)

    app = create_app(db, cfg, serving=serving, on_max_requests=_recycle)
    if serving is not None:
        serving.start()
    web.run_app(app, host=cfg.host, port=cfg.port,
                ssl_context=build_ssl_context(),
                shutdown_timeout=float(
                    os.environ.get("API_SHUTDOWN_TIMEOUT", "30")))


if __name__ == "__main__":
    main()
