"""Server entry point: ``python -m swarmdb_tpu_torch.api.server``.

Builds SwarmDB + the aiohttp app from the JAX package's env-var catalog:
KAFKA_GROUP_ID, KAFKA_NUM_PARTITIONS, KAFKA_TOPIC, SAVE_DIR,
AUTOSAVE_INTERVAL, BROKER_IMPL, JWT_SECRET_KEY, TOKEN_EXPIRE_MINUTES,
RATE_LIMIT_PER_MINUTE, CORS_ORIGINS, API_HOST, API_PORT, API_SSL_CERT /
API_SSL_KEY, API_MAX_REQUESTS, API_SHUTDOWN_TIMEOUT, LOG_FILE. One process
owns the broker. ``BROKER_IMPL`` picks it as the JAX server does: ``auto``
(the default) takes the native C++ broker when its library builds, else
``LocalBroker``; ``native`` raises if it cannot build; ``python`` takes
``LocalBroker``.

Set ``SERVE_MODEL`` (``llama3-8b``, ``tiny-debug``, ...) to attach a
serving backend (``ServingService.from_model_name``) on the card
(``SERVE_DEVICE=cpu``, or ``build_serving(db, device="cpu")``, puts it on
the CPU). ``SERVE_MAX_BATCH``, ``SERVE_MAX_SEQ``, ``SERVE_CHUNK`` and
``SERVE_SEED`` shape the engine; ``SWARMDB_PAGED=1`` picks the paged one.
An agent becomes LLM-backed with ``POST /admin/llm_backend`` naming the
backend ``gpu-0`` (its id is also in ``GET /health``).

A pod (the JAX server's multi-host mode): start one process per rank
with ``SWARMDB_COORDINATOR`` (rank 0's ``host:port``),
``SWARMDB_NUM_PROCESSES`` and ``SWARMDB_PROCESS_ID``. Every rank builds
its share of the single program over the default mesh, every rank on the
model axis (``parallel.serving.build_serving_engine``; NCCL on the cards,
rank r on ``cuda:r`` of its host unless ``SERVE_DEVICE`` says otherwise;
gloo with ``SERVE_DEVICE=cpu``): the dense engine, or with
``SWARMDB_PAGED=1`` the sharded paged engine, which needs a pure-DP mesh
and so raises the JAX server's ``ValueError`` on every rank there, as the
JAX server does (neither server has a knob for the mesh). Rank 0 serves: broker, HTTP, queue and
tokenizer, publishing every device call; the others run
``Engine.worker_loop`` with no broker and no HTTP. The ``SERVE_*`` knobs
must be equal on every rank. ``API_MAX_REQUESTS`` is ignored on the
coordinator (a recycled coordinator would strand its workers).

High availability, two modes as in the JAX server:

- ``SWARMDB_HA_NODE_ID`` (+ ``SWARMDB_HA_CLUSTER``, the shared cluster-map
  file): this process IS a cluster node. An embedded ``HANode``
  supervises its broker (failure detection, fenced promotion) with
  partition leadership on by default (``SWARMDB_HA_PARTITION_LEADERSHIP``
  overrides); the runtime writes through ``HANode.client_broker()`` and
  the serving backend pins conversations to lanes by partition leader.
  ``SWARMDB_HA_ROLE`` (``follower``), ``SWARMDB_HA_LISTEN`` /
  ``_LIVENESS`` / ``_DATA`` (``0.0.0.0:9444`` / ``:9445`` / ``:9446``;
  port 0 picks a free one), ``SWARMDB_HA_ADVERTISE_HOST`` and
  ``BROKER_LOG_DIR`` (``ha_broker_log``) shape it.
- ``SWARMDB_HA_CLUSTER`` alone: a client of an external cluster (the
  runtime binds a ``ClusterBroker``, ``core/runtime.py``).
"""

from __future__ import annotations

import logging
import os

import torch
from aiohttp import web

from ..core.messages import BrokerConfig
from ..core.runtime import SwarmDB
from ..utils.device import DeviceLike
from .app import ApiConfig, create_app


def serve_device(rank: int = 0) -> DeviceLike:
    """The serving backend's device: ``SERVE_DEVICE`` if set, else the
    card, rank r of a pod on ``cuda:r`` of its host (modulo its cards)."""
    dev = os.environ.get("SERVE_DEVICE")
    if dev:
        return dev
    if rank and torch.cuda.is_available():
        return f"cuda:{rank % torch.cuda.device_count()}"
    return None


def build_ha_node():
    """The embedded HA node when this server process is a cluster member
    (``SWARMDB_HA_NODE_ID`` + ``SWARMDB_HA_CLUSTER``), started; else None.
    Its broker follows ``BROKER_IMPL`` as the runtime's does."""
    node_id = os.environ.get("SWARMDB_HA_NODE_ID")
    cluster_path = os.environ.get("SWARMDB_HA_CLUSTER")
    if not node_id:
        return None
    if not cluster_path:
        raise SystemExit(
            "SWARMDB_HA_NODE_ID is set but SWARMDB_HA_CLUSTER is not: an "
            "HA node needs the shared cluster-map path")
    from ..broker.local import LocalBroker
    from ..core.runtime import _default_broker
    from ..ha.cluster import FileClusterMap
    from ..ha.node import HANode

    log_dir = os.environ.get("BROKER_LOG_DIR") or "ha_broker_log"
    broker = _default_broker(BrokerConfig(
        implementation=os.environ.get("BROKER_IMPL", "auto"),
        log_dir=log_dir))
    if isinstance(broker, LocalBroker):
        # the python broker keeps the node's log as a snapshot in its folder
        broker = LocalBroker(
            snapshot_path=os.path.join(log_dir, "snapshot.json"))

    def port_of(addr: str) -> str:
        return addr.rpartition(":")[2]

    listen = os.environ.get("SWARMDB_HA_LISTEN", "0.0.0.0:9444")
    data = os.environ.get("SWARMDB_HA_DATA", "0.0.0.0:9446")
    host = listen.rpartition(":")[0]
    node = HANode(
        node_id, broker, FileClusterMap(cluster_path),
        listen_host=host or "0.0.0.0", replica_port=int(port_of(listen)),
        liveness_port=int(port_of(
            os.environ.get("SWARMDB_HA_LIVENESS", "0.0.0.0:9445"))),
        data_port=None if port_of(data) == "off" else int(port_of(data)),
        advertise_host=os.environ.get("SWARMDB_HA_ADVERTISE_HOST"),
        log_dir=log_dir,
        # a deployment entry point is cluster mode: partition leadership
        # on by default (SWARMDB_HA_PARTITION_LEADERSHIP overrides)
        cluster_mode=True,
    )
    node.start(role=os.environ.get("SWARMDB_HA_ROLE", "follower"))
    return node


def build_db(ha_node=None) -> SwarmDB:
    cfg = BrokerConfig(
        bootstrap_servers=os.environ.get("KAFKA_BOOTSTRAP_SERVERS",
                                         "localhost:9092"),
        group_id=os.environ.get("KAFKA_GROUP_ID", "swarm_agents"),
        num_partitions=int(os.environ.get("KAFKA_NUM_PARTITIONS", "3")),
        log_dir=os.environ.get("BROKER_LOG_DIR") or None,
        implementation=os.environ.get("BROKER_IMPL", "auto"),
    )
    # a cluster node writes through its node: in partition mode a
    # per-partition-routing ClusterBroker whose opener short-circuits this
    # node, so every produce reaches the owning partition leader
    return SwarmDB(
        config=cfg,
        topic_name=os.environ.get("KAFKA_TOPIC", "swarm_messages"),
        save_dir=os.environ.get("SAVE_DIR", "message_history"),
        autosave_interval=float(os.environ.get("AUTOSAVE_INTERVAL", "300")),
        broker=ha_node.client_broker() if ha_node is not None else None,
    )


def _serve_knobs() -> dict:
    """The engine's shape: equal on every rank of a pod (the workers
    replay the coordinator's calls shape for shape)."""
    return {
        "max_batch": int(os.environ.get("SERVE_MAX_BATCH", "8")),
        "max_seq": int(os.environ.get("SERVE_MAX_SEQ", "1024")),
        "decode_chunk": int(os.environ.get("SERVE_CHUNK", "8")),
        "seed": int(os.environ.get("SERVE_SEED", "0")),
    }


def _build_pod_engine(model_name: str, device: DeviceLike = None):
    """This rank's share of the single program (``SWARMDB_PAGED`` picks
    the engine), built alike on every rank so that the state starts
    identical."""
    from ..backend.tokenizer import default_tokenizer
    from ..parallel.serving import build_serving_engine

    path = os.environ.get("SERVE_TOKENIZER") or None
    engine, sm = build_serving_engine(model_name, [device],
                                      tokenizer_path=path, **_serve_knobs())
    return engine, default_tokenizer(sm.cfg.vocab_size, path)


def build_serving(db: SwarmDB, device: DeviceLike = None, ha_node=None,
                  distributed: bool = False):
    """The ``SERVE_MODEL`` backend, or None without one. ``device``
    (default the card) lets a caller ask for the CPU. With ``ha_node``
    its conversations ride partition leadership (lane pins follow the
    partition leaders and re-pin on rebalance). ``distributed``: this
    process is a pod's coordinator (rank 0): its engine is its share of
    the single program and publishes its device calls."""
    model_name = os.environ.get("SERVE_MODEL")
    if not model_name:
        return None
    from ..backend.service import ServingService

    if distributed:
        engine, tokenizer = _build_pod_engine(model_name, device)
        engine.enable_multihost()
        serving = ServingService(db, engine, tokenizer)
    else:
        knobs = _serve_knobs()
        serving = ServingService.from_model_name(
            db, model_name, max_batch=knobs["max_batch"],
            max_seq=knobs["max_seq"], decode_chunk=knobs["decode_chunk"],
            seed=knobs["seed"],
            tokenizer_path=os.environ.get("SERVE_TOKENIZER") or None,
            device=device)
    serving.bind_partition_leadership(ha_node)
    if db.token_counter is None:
        # the backend's tokenizer fills Message.token_count
        db.token_counter = serving.tokenizer.count
    return serving


def run_worker(device: DeviceLike = None) -> None:
    """A pod rank other than the coordinator: build the same engine and
    replay the coordinator's device calls until it publishes stop. No
    broker, no HTTP."""
    model_name = os.environ.get("SERVE_MODEL")
    if not model_name:
        raise SystemExit("a pod worker needs SERVE_MODEL to build its "
                         "share of the engine")
    engine, _tok = _build_pod_engine(model_name, device)
    logging.getLogger(__name__).info("worker joined the pod's decode "
                                     "program")
    engine.worker_loop()


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
    from ..parallel.distributed import init_distributed, is_coordinator

    rank = int(os.environ.get("SWARMDB_PROCESS_ID", "0"))
    device = serve_device(rank)
    distributed = init_distributed(device=device)
    if distributed and not is_coordinator():
        run_worker(device)
        return
    ha_node = build_ha_node()
    db = build_db(ha_node)
    serving = build_serving(db, device=device, ha_node=ha_node,
                            distributed=distributed)
    cfg = ApiConfig.from_env()
    if distributed and cfg.max_requests > 0:
        # a recycled coordinator would strand every worker in its loop:
        # a pod is recycled by restarting all of its processes
        import dataclasses

        logging.getLogger(__name__).warning(
            "API_MAX_REQUESTS ignored on a pod coordinator")
        cfg = dataclasses.replace(cfg, max_requests=0)

    def _recycle() -> None:
        # SIGTERM ourselves: aiohttp drains in-flight requests within
        # shutdown_timeout and the process supervisor starts a fresh one
        import signal

        os.kill(os.getpid(), signal.SIGTERM)

    app = create_app(db, cfg, serving=serving, on_max_requests=_recycle,
                     ha_node=ha_node)
    if serving is not None:
        serving.start()
    web.run_app(app, host=cfg.host, port=cfg.port,
                ssl_context=build_ssl_context(),
                shutdown_timeout=float(
                    os.environ.get("API_SHUTDOWN_TIMEOUT", "30")))


if __name__ == "__main__":
    main()
