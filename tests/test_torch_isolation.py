"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, and its entry points run on the card unless the caller
asks for the CPU -- without CUDA they raise instead of falling back.
What is not ported yet says so: it raises naming its ROADMAP.md item.
An installed wheel carries every folder of the port.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "swarmdb_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "swarmdb_tpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the other test workers' timing checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


NEW_MODULES = sorted((PORT / "analysis").glob("*.py")) + [
    PORT / "utils" / "checkpoint.py"]


@pytest.mark.parametrize("path", NEW_MODULES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_lint_and_checkpoint_modules_import_none_of_four(path):
    """swarmlint and the checkpoint reader import neither JAX, the JAX
    package, ``transformers`` nor ``safetensors``; swarmlint's modules
    import only the standard library at module level (PyTorch is asked
    inside ``smem_budget`` only, given a device)."""
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN + ("transformers", "safetensors"), (
            f"{path} imports {name}")
    if path.parent.name == "analysis":
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in sys.stdlib_module_names, (
                    f"{path} imports {name} at module level")


def test_lint_baseline_ships_with_the_package():
    """``pyproject.toml`` lists the port's lint baseline as package data
    (the CLI finds it beside its own file, installed or not)."""
    import json
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert "analysis/baseline.json" in data["swarmdb_tpu_torch"]
    from swarmdb_tpu_torch.analysis.core import DEFAULT_BASELINE

    assert Path(DEFAULT_BASELINE) == PORT / "analysis" / "baseline.json"
    with open(DEFAULT_BASELINE, encoding="utf-8") as f:
        assert json.load(f)["version"] == 1


def test_scan_covers_every_port_folder():
    """The AST scan above walks every folder of the port, the wire API and
    observability included."""
    folders = {p.relative_to(PORT).parts[0] for p in PORT.rglob("*.py")
               if len(p.relative_to(PORT).parts) > 1}
    assert {"api", "obs", "backend", "core", "broker", "ops", "models",
            "parallel", "utils", "analysis", "ha"} <= folders
    assert PORT / "models" / "mixtral.py" in set(PORT.rglob("*.py"))
    assert {PORT / "broker" / "native.py", PORT / "broker" / "replica.py",
            PORT / "backend" / "locality.py"} <= set(PORT.rglob("*.py"))


# an import hook that reports (and refuses) JAX and the JAX package, then
# runs a module as ``python -m`` does
_CLI_RUNNER = (
    "import runpy, sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'swarmdb_tpu'):\n"
    "            print('FORBIDDEN', name, file=sys.stderr, flush=True)\n"
    "            raise ImportError(name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


@pytest.mark.parametrize("cli", ["swarmdb_tpu_torch.ha.node",
                                 "swarmdb_tpu_torch.broker.replica"])
def test_cli_runs_without_jax(cli, tmp_path):
    """The HA node CLI and the follower CLI start (their ready line) with
    JAX and the JAX package refused at import."""
    if cli.endswith("node"):
        args = ["--node-id", "n1", "--role", "leader", "--log-dir",
                str(tmp_path / "log"), "--cluster",
                str(tmp_path / "cluster.json"), "--listen", "127.0.0.1:0",
                "--liveness", "127.0.0.1:0", "--data", "127.0.0.1:0"]
        ready = "HA_NODE_READY"
    else:
        args = ["--log-dir", str(tmp_path / "log"), "--listen",
                "127.0.0.1:0"]
        ready = "REPLICA_READY"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-c", _CLI_RUNNER, cli, *args],
                            cwd=str(tmp_path), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith(ready), (line, proc.poll())
    finally:
        proc.kill()
        _, err = proc.communicate(timeout=30)
    assert "FORBIDDEN" not in err, err[-2000:]


def test_serving_a_request_loads_no_jax(tmp_path):
    """Serving through each engine, a lane group, a one-rank pod and the
    single program over two devices of this process loads neither JAX nor
    the JAX package -- in the worker that program spawns either
    (``python -m swarmdb_tpu_torch.parallel.local``), where the import hook
    of ``_CLI_RUNNER`` refuses them (a ``sitecustomize`` on the path every
    process here inherits): a refused import fails the worker's build, and
    so the program's."""
    (tmp_path / "sitecustomize.py").write_text(
        _CLI_RUNNER.split("sys.argv")[0])
    code = (
        "import sys\n"
        "import swarmdb_tpu_torch.api.server\n"
        "import swarmdb_tpu_torch.__main__\n"
        "from swarmdb_tpu_torch.backend.service import build_backend_engine\n"
        "from swarmdb_tpu_torch.backend.sampling import SamplingParams\n"
        "for model in ('tiny-debug', 'tiny-moe'):\n"
        "  for paged in (None, True):\n"
        "    eng, tok = build_backend_engine(model, max_seq=64,"
        " paged=paged, device='cpu')\n"
        "    eng.start()\n"
        "    toks, why = eng.generate_sync(tok.encode('hi there'),"
        " SamplingParams(max_new_tokens=3))\n"
        "    eng.stop()\n"
        "    assert why in ('length', 'eos'), why\n"
        "from swarmdb_tpu_torch.parallel import build_serving_engine\n"
        "g, _ = build_serving_engine('tiny-debug', ['cpu', 'cpu'],"
        " max_seq=64, paged=True)\n"
        "g.start()\n"
        "toks, why = g.generate_sync([1, 2, 3],"
        " SamplingParams(max_new_tokens=3))\n"
        "g.stop()\n"
        "assert why in ('length', 'eos'), why\n"
        # the pod path: a one-rank gloo process group, the dense engine
        # over its model axis, the control plane
        "import tempfile\n"
        "from swarmdb_tpu_torch.parallel.distributed import"
        " init_distributed\n"
        "assert init_distributed('file://' + tempfile.mktemp(), 1, 0,"
        " device='cpu')\n"
        "eng, sm = build_serving_engine('tiny-debug', ['cpu'], max_seq=64,"
        " paged=False)\n"
        "eng.enable_multihost()\n"
        "eng.start()\n"
        "toks, why = eng.generate_sync([1, 2, 3],"
        " SamplingParams(max_new_tokens=3))\n"
        "eng.stop()\n"
        "assert why in ('length', 'eos') and sm.mesh.shape['model'] == 1\n"
        # the paged engine of the same one-rank pod: its page calls go
        # over the control plane's mirrored-call record
        "eng, sm = build_serving_engine('tiny-debug', ['cpu'], max_seq=64,"
        " paged=True, page_size=16)\n"
        "eng.enable_multihost()\n"
        "eng.start()\n"
        "toks, why = eng.generate_sync(list(range(3, 40)),"
        " SamplingParams(max_new_tokens=3))\n"
        "eng.stop()\n"
        "assert why in ('length', 'eos')\n"
        "assert eng.flight.meta['paged_shards'] == 1\n"
        # the single program over two devices of this process: its worker
        # is a new interpreter with the hook
        "from swarmdb_tpu_torch.parallel.distributed import"
        " destroy_distributed\n"
        "destroy_distributed()\n"
        "eng, sm = build_serving_engine('tiny-debug', ['cpu', 'cpu'],"
        " max_seq=64, paged=False)\n"
        "eng.start()\n"
        "toks, why = eng.generate_sync([1, 2, 3],"
        " SamplingParams(max_new_tokens=3))\n"
        "procs = list(eng._owner.procs)\n"
        "eng.stop()\n"
        "assert why in ('length', 'eos') and sm.mesh.shape['model'] == 2\n"
        "assert [p.returncode for p in procs] == [0], procs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'swarmdb_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT)]), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
    assert "FORBIDDEN" not in out.stderr, out.stderr[-2000:]


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from swarmdb_tpu_torch.api.server import build_serving
    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny-debug")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_backend_engine("tiny-debug", max_seq=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_serving_engine("tiny-debug", max_seq=64, paged=True)
    db = SwarmDB(save_dir=str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingService.from_model_name(db, "tiny-debug", max_seq=64)
        monkeypatch.setenv("SERVE_MODEL", "tiny-debug")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_serving(db)   # the server's backend: the card by default
    finally:
        db.close()
    params = llama.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    eng, _ = build_backend_engine("tiny-debug", max_seq=64, device="cpu")
    assert eng.device.type == "cpu" and eng.paged is None
    assert all(t.device.type == "cpu" for t in eng.cache)      # dense
    eng, _ = build_backend_engine("tiny-debug", max_seq=64, paged=True,
                                  device="cpu")
    assert eng.device.type == "cpu"
    assert eng.cache["k"].device.type == "cpu"


def test_unported_paths_say_so(monkeypatch, tmp_path):
    from swarmdb_tpu_torch.api import server
    from swarmdb_tpu_torch.api.app import create_app
    from swarmdb_tpu_torch.backend.service import build_backend_engine
    from swarmdb_tpu_torch.core.messages import BrokerConfig
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.parallel.serving import build_serving_engine

    # Mixtral is ported: a tiny-moe engine builds on the CPU, both kinds,
    # and the paged one prefills in row-bucketed waves (no ragged forward)
    for paged in (None, True):
        eng, _ = build_backend_engine("tiny-moe", max_seq=64, paged=paged,
                                      device="cpu")
        assert eng.params["layers"]["router"].device.type == "cpu"
        assert (eng.paged is None) == (paged is None)
        assert paged is None or eng.paged.prefill_ragged is None
    # lanes are ported (item 9), the single program over a model axis
    # (item 11a: tests/test_torch_tp.py, test_torch_multihost.py), over a
    # data axis (11b's data half: tests/test_torch_dp.py,
    # test_torch_sharded_paged.py) and over an expert axis, with Mixtral on
    # every axis (11b's expert half: tests/test_torch_ep.py), and over the
    # devices of one process (item 11's last part:
    # tests/test_torch_local_program.py). No port module keeps a refusal
    # naming an unported item. A paged engine over an expert or pipe axis
    # raises the JAX package's pure-DP refusal, and an expert or pipe
    # axis, as a model axis, larger than the devices of a process without
    # a group says how to get its ranks
    for path in PORT.rglob("*.py"):
        assert "_unported" not in path.read_text(), path
    for kwargs in ({"expert": 2}, {"pipe": 2}):
        with pytest.raises(ValueError, match="pure-DP mesh"):
            build_serving_engine("tiny-debug", ["cpu", "cpu"], max_seq=64,
                                 paged=True, **kwargs)
        with pytest.raises(ValueError, match="needs 2 ranks.*"
                           "init_distributed"):
            build_serving_engine("tiny-moe", ["cpu"], max_seq=64,
                                 paged=False, **kwargs)
    # the paged engine over a model axis is the JAX package's refusal
    with pytest.raises(ValueError, match="pure-DP mesh"):
        build_serving_engine("tiny-debug", ["cpu", "cpu"], max_seq=64,
                             paged=True, model=2)
    # a model axis without a process group says how to get one
    with pytest.raises(ValueError, match="init_distributed"):
        build_serving_engine("tiny-debug", ["cpu"], max_seq=64, model=2,
                             paged=False)
    # a data, expert and pipe axis build (the caches follow the engine's
    # slots), Mixtral's too: each rank keeps its experts
    from swarmdb_tpu_torch.parallel.mesh import make_mesh
    from swarmdb_tpu_torch.parallel.serving import build_sharded_model

    mesh = make_mesh(device="cpu")
    mesh.shape = dict(mesh.shape, data=2)
    assert build_sharded_model("tiny-debug", mesh).data_size == 2
    mesh.shape = dict(mesh.shape, data=1, expert=2, pipe=2)
    assert build_sharded_model("tiny-debug", mesh).params["layers"][
        "w_gate"].shape[0] == 2          # a pipe axis splits no layer
    sm = build_sharded_model("tiny-moe", mesh)
    assert sm.params["layers"]["w_gate"].shape[1] == 2   # 4 experts / 2
    # a paged engine's pod mode is ported; its ragged waves are not
    # mirrored, so an engine built to prefill with them says so
    paged_eng, _ = build_backend_engine("tiny-debug", max_seq=64, paged=True,
                                        device="cpu")
    with pytest.raises(ValueError, match="ragged waves are not mirrored"):
        paged_eng.enable_multihost()
    # the server refuses no pod (a paged one raises the pure-DP error on
    # its default mesh: tests/test_torch_sharded_paged.py)
    assert not hasattr(server, "refuse_unported")
    # item 12 is ported: each of its modes builds
    _item_12_modes_build(monkeypatch, tmp_path, create_app, BrokerConfig,
                         SwarmDB)


def _item_12_modes_build(monkeypatch, tmp_path, create_app, BrokerConfig,
                         SwarmDB):
    """The HA node and HA client modes, BROKER_IMPL=native and
    replication_factor 2 build (they were refused naming item 12)."""
    from swarmdb_tpu_torch.api import server
    from swarmdb_tpu_torch.broker.native import NativeBroker
    from swarmdb_tpu_torch.broker.replica import (ReplicatedBroker,
                                                  ReplicaServer)
    from swarmdb_tpu_torch.ha.client import ClusterBroker

    cluster = str(tmp_path / "cluster.json")
    node = client_db = None
    with monkeypatch.context() as m:
        # the HA node mode: the server's embedded node, leading
        for key, val in (("SWARMDB_HA_NODE_ID", "n1"),
                         ("SWARMDB_HA_CLUSTER", cluster),
                         ("SWARMDB_HA_ROLE", "leader"),
                         ("SWARMDB_HA_LISTEN", "127.0.0.1:0"),
                         ("SWARMDB_HA_LIVENESS", "127.0.0.1:0"),
                         ("SWARMDB_HA_DATA", "127.0.0.1:0"),
                         ("BROKER_LOG_DIR", str(tmp_path / "halog"))):
            m.setenv(key, val)
        node = server.build_ha_node()
        try:
            assert node.partition_leadership       # cluster mode's default
            assert type(node.broker).__name__ == "NativeBroker"
            create_app(SwarmDB(save_dir=str(tmp_path / "node"),
                               broker=node.client_broker()), ha_node=node)
            # the HA client mode: SWARMDB_HA_CLUSTER alone
            m.delenv("SWARMDB_HA_NODE_ID")
            client_db = SwarmDB(save_dir=str(tmp_path / "client"))
            assert isinstance(client_db.broker, ClusterBroker)
            assert client_db.topic_name in client_db.broker.list_topics()
        finally:
            if client_db is not None:
                client_db.close()
            node.stop()
            node.broker.close()
    with monkeypatch.context() as m:
        m.setenv("BROKER_IMPL", "native")
        m.setenv("SAVE_DIR", str(tmp_path / "native"))
        db = server.build_db()
        assert isinstance(db.broker, NativeBroker)
        db.close()
    db = SwarmDB(config=BrokerConfig(implementation="native"),
                 save_dir=str(tmp_path))
    assert isinstance(db.broker, NativeBroker)
    db.close()
    # replication_factor 2 needs its follower, as in the JAX package
    with pytest.raises(ValueError, match="SWARMDB_REPLICA_TARGETS"):
        SwarmDB(config=BrokerConfig(replication_factor=2),
                save_dir=str(tmp_path))
    follower = NativeBroker(log_dir=str(tmp_path / "follower"))
    rs = ReplicaServer(follower).start()
    try:
        with monkeypatch.context() as m:
            m.setenv("SWARMDB_REPLICA_TARGETS", f"127.0.0.1:{rs.port}")
            db = SwarmDB(config=BrokerConfig(replication_factor=2),
                         save_dir=str(tmp_path))
            assert isinstance(db.broker, ReplicatedBroker)
            db.close()
    finally:
        rs.stop()
        follower.close()


def test_find_packages_lists_every_port_folder():
    """An installed wheel carries every folder of the port that holds
    Python files: setuptools' regular ``packages.find`` (pyproject.toml)
    skips a folder without an ``__init__.py``."""
    from setuptools import find_packages

    found = set(find_packages(where=str(ROOT), include=["swarmdb_tpu*"]))
    folders = {".".join(p.parent.relative_to(ROOT).parts)
               for p in PORT.rglob("*.py")}
    assert folders, "no port folder found"
    assert folders <= found, sorted(folders - found)
    assert "swarmdb_tpu_torch.api" in found
    assert "swarmdb_tpu_torch.ha" in found


@pytest.mark.parametrize("path", ["/admin/ha"])
def test_admin_ha_answers_503_without_a_node_and_403_to_a_user(path,
                                                               tmp_path):
    """Every route of the JAX package's server is served by the port's:
    ``/admin/ha``, the last to be ported, answers 503 in a process without
    an HA node (the JAX server's answer there) and 403 to a user who is
    not the admin."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    async def drive():
        db = SwarmDB(save_dir=str(tmp_path))
        client = TestClient(TestServer(create_app(db, ApiConfig(
            jwt_secret_key="s", rate_limit_per_minute=10_000))))
        await client.start_server()
        try:
            out = []
            for user in ("tester", "admin"):
                r = await client.post("/auth/token", json={
                    "username": user, "password": "pw"})
                tok = (await r.json())["access_token"]
                r = await client.get(path, headers={
                    "Authorization": f"Bearer {tok}"})
                out.append((r.status, (await r.json())["detail"]))
            return out
        finally:
            await client.close()

    (user_st, _), (admin_st, detail) = asyncio.run(drive())
    assert user_st == 403
    assert admin_st == 503
    assert "without an HA node" in detail


@pytest.mark.parametrize("path", ["/admin/cluster/trace", "/admin/slo"])
def test_served_admin_routes_answer(path, tmp_path):
    """Routes that answered 501 until their subsystem was ported now
    serve the admin (403 for a user), with the JAX package's keys: the
    SLO sentinel's status, and the local trace through the cluster merge
    (its span count equal to /admin/trace/export's, nothing
    unreachable)."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    async def drive():
        db = SwarmDB(save_dir=str(tmp_path))
        client = TestClient(TestServer(create_app(db, ApiConfig(
            jwt_secret_key="s", rate_limit_per_minute=10_000))))
        await client.start_server()
        try:
            hdrs = {}
            for user in ("tester", "admin"):
                r = await client.post("/auth/token", json={
                    "username": user, "password": "pw"})
                hdrs[user] = {"Authorization":
                              f"Bearer {(await r.json())['access_token']}"}
            db.register_agent("a")
            db.register_agent("b")
            mid = db.send_message("a", "b", "traced")
            r = await client.get(path, headers=hdrs["tester"])
            user_st = r.status
            r = await client.get(f"{path}?trace_id={mid}",
                                 headers=hdrs["admin"])
            body = await r.json()
            r2 = await client.get(f"/admin/trace/export?trace_id={mid}",
                                  headers=hdrs["admin"])
            return user_st, r.status, body, await r2.json(), mid
        finally:
            await client.close()
            db.close()

    user_st, admin_st, body, local, mid = asyncio.run(drive())
    assert user_st == 403 and admin_st == 200
    if path == "/admin/slo":
        assert {"enabled", "config", "baseline", "warmup_windows_seen",
                "last_window", "breached", "windows_total",
                "alerts_total", "alerts", "exemplars"} == set(body)
    else:
        # the export also carries the profiler's device tracks (cat
        # "device"), which the cluster merge of host spans does not
        spans = [e for e in body["traceEvents"] if e.get("ph") == "X"]
        assert len(spans) == len([e for e in local["traceEvents"]
                                  if e.get("ph") == "X"
                                  and e.get("cat") != "device"]) >= 2
        assert {"runtime.send", "broker.publish"} <= {
            e["name"] for e in spans}
        assert body["metadata"]["unreachable"] == []
        assert body["metadata"]["trace_id"] == mid
        assert len(body["metadata"]["nodes"]) == 1


@pytest.mark.parametrize("switch", ["on", "off"])
@pytest.mark.parametrize("path,env,kind", [
    ("/admin/profile", "SWARMDB_PROFILE", "swarmdb.profile"),
    ("/admin/mem", "SWARMDB_MEMPROF", "swarmdb.mem")])
def test_profile_and_mem_routes_answer(path, env, kind, switch, tmp_path,
                                       monkeypatch):
    """The device-time profiler's and the memory accountant's routes
    (501 until they were ported) serve the admin their report, with the
    JAX package's ``kind`` and ``version``, and 403 a user; with their
    switch off they answer 503, as in the JAX package."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    monkeypatch.setenv(env, "1" if switch == "on" else "0")

    async def drive():
        db = SwarmDB(save_dir=str(tmp_path))
        client = TestClient(TestServer(create_app(db, ApiConfig(
            jwt_secret_key="s", rate_limit_per_minute=10_000))))
        await client.start_server()
        try:
            out = []
            for user in ("tester", "admin"):
                r = await client.post("/auth/token", json={
                    "username": user, "password": "pw"})
                tok = (await r.json())["access_token"]
                r = await client.get(path, headers={
                    "Authorization": f"Bearer {tok}"})
                out.append((r.status, await r.json()))
            return out
        finally:
            await client.close()
            db.close()

    (user_st, _), (admin_st, body) = asyncio.run(drive())
    assert user_st == 403
    if switch == "off":
        assert admin_st == 503
        assert env in body["detail"]
    else:
        assert admin_st == 200
        assert body["kind"] == kind and body["version"] == 1
        assert body["enabled"] is True


@pytest.mark.parametrize("switch", ["on", "off"])
@pytest.mark.parametrize("path,env,keys", [
    ("/admin/lockcheck", "SWARMDB_LOCKCHECK",
     {"enabled", "node", "sites", "edges", "cycles"}),
    ("/admin/pagecheck", "SWARMDB_PAGECHECK",
     {"enabled", "node", "pools", "violations"}),
    ("/admin/kerncheck", "SWARMDB_KERNCHECK",
     {"enabled", "node", "checks", "violations"})])
def test_sanitizer_routes_answer(path, env, keys, switch, tmp_path,
                                 monkeypatch):
    """The three runtime sanitizers' routes (501 until they were ported)
    answer 403 to a user, 503 naming the flag to an admin with the flag
    off (an empty report would read as "no bugs"), and the report with
    the JAX package's keys with it on; ``/metrics`` carries the
    sanitizer's lines exactly when its flag is on."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from swarmdb_tpu_torch.api.app import ApiConfig, create_app
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    monkeypatch.setenv(env, "1" if switch == "on" else "0")
    metric = {"SWARMDB_LOCKCHECK": "swarmdb_lock_inversion_cycles",
              "SWARMDB_PAGECHECK": "swarmdb_page_violations_total",
              "SWARMDB_KERNCHECK": "swarmdb_kernel_violations_total"}[env]

    async def drive():
        db = SwarmDB(save_dir=str(tmp_path))
        client = TestClient(TestServer(create_app(db, ApiConfig(
            jwt_secret_key="s", rate_limit_per_minute=10_000))))
        await client.start_server()
        try:
            out = []
            for user in ("tester", "admin"):
                r = await client.post("/auth/token", json={
                    "username": user, "password": "pw"})
                tok = (await r.json())["access_token"]
                r = await client.get(path, headers={
                    "Authorization": f"Bearer {tok}"})
                out.append((r.status, await r.json()))
            r = await client.get("/metrics")
            return out, await r.text()
        finally:
            await client.close()
            db.close()

    ((user_st, _), (admin_st, body)), text = asyncio.run(drive())
    assert user_st == 403
    if switch == "off":
        assert admin_st == 503
        assert env in body["detail"]
        assert metric not in text
    else:
        assert admin_st == 200
        assert keys <= set(body)
        assert body["enabled"] is True
        assert metric in text


def test_scan_covers_the_sanitizers():
    """The AST scan above reaches the three sanitizer modules."""
    scanned = set(PORT.rglob("*.py"))
    for name in ("lockcheck", "pagecheck", "kerncheck"):
        assert PORT / "obs" / f"{name}.py" in scanned


def test_sanitizer_factories_are_plain_with_flags_off(monkeypatch):
    """Flags off, every sanitizer factory hands back the plain object:
    the exact ``threading`` types, ``PageAllocator``, ``PrefixLRU`` and
    the unwrapped dispatch functions (the engine's forwards then call the
    plain dispatchers themselves)."""
    import threading

    from swarmdb_tpu_torch.obs import kerncheck
    from swarmdb_tpu_torch.ops import layers, paged_kv
    from swarmdb_tpu_torch.ops.prefix_cache import (PrefixLRU,
                                                    make_prefix_lru)
    from swarmdb_tpu_torch.utils import sync

    for env in ("SWARMDB_LOCKCHECK", "SWARMDB_PAGECHECK",
                "SWARMDB_KERNCHECK"):
        monkeypatch.delenv(env, raising=False)
    assert type(sync.make_lock("x")) is type(threading.Lock())
    assert type(sync.make_rlock("x")) is type(threading.RLock())
    assert type(sync.make_condition("x")) is threading.Condition
    assert type(paged_kv.make_page_allocator(8, 4, 16, 2)) \
        is paged_kv.PageAllocator
    assert type(make_prefix_lru(8, 4)) is PrefixLRU
    assert layers.attention_dispatchers() == (None, None)
    fn = paged_kv.paged_write_ragged
    assert kerncheck.checked_ragged_prefill_dispatch(fn) is fn
    assert kerncheck.checked_paged_attention_dispatch(fn) is fn
    assert kerncheck.checked_paged_write_ragged(fn) is fn


def test_flags_off_serve_imports_no_sanitizer(tmp_path):
    """A tiny-debug paged serve with every flag off imports none of the
    three sanitizer modules (a fresh process: the tests above import
    them)."""
    code = (
        "import sys\n"
        "from swarmdb_tpu_torch.backend.service import build_backend_engine\n"
        "from swarmdb_tpu_torch.backend.sampling import SamplingParams\n"
        "eng, _ = build_backend_engine('tiny-debug', paged=True, "
        "device='cpu', max_batch=2, max_seq=64, page_size=8, "
        "decode_chunk=4)\n"
        "eng.start()\n"
        "toks, why = eng.generate_sync([5] * 12, "
        "SamplingParams(max_new_tokens=4))\n"
        "eng.stop()\n"
        "assert why in ('length', 'eos'), why\n"
        "assert eng._pagecheck is None and not eng._kerncheck\n"
        "print(sorted(m for m in sys.modules if m.split('.')[-1] in "
        "('lockcheck', 'pagecheck', 'kerncheck')))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("SWARMDB_LOCKCHECK", "SWARMDB_PAGECHECK",
                        "SWARMDB_KERNCHECK")}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
