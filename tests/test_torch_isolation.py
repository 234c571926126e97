"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, and its entry points run on the card unless the caller
asks for the CPU -- without CUDA they raise instead of falling back.
What is not ported yet says so: it raises, or (an HTTP route) answers 501
naming its ROADMAP.md item. An installed wheel carries every folder of
the port.
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


def test_scan_covers_every_port_folder():
    """The AST scan above walks every folder of the port, the wire API and
    observability included."""
    folders = {p.relative_to(PORT).parts[0] for p in PORT.rglob("*.py")
               if len(p.relative_to(PORT).parts) > 1}
    assert {"api", "obs", "backend", "core", "broker", "ops", "models",
            "parallel", "utils"} <= folders
    assert PORT / "models" / "mixtral.py" in set(PORT.rglob("*.py"))


def test_serving_a_request_loads_no_jax():
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
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'swarmdb_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


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
    from swarmdb_tpu_torch.api.app import create_app
    from swarmdb_tpu_torch.api.server import refuse_unported
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
    # lanes are ported (item 9); the single-program sharded engine, a
    # model / expert / pipeline axis and the dense engine over several
    # devices are multi-GPU serving (item 11)
    for kwargs in ({"admit_overlap": False}, {"model": 2}, {"expert": 2},
                   {"pipe": 2}, {"paged": False}):
        with pytest.raises(NotImplementedError, match="item 11"):
            build_serving_engine("tiny-debug", ["cpu", "cpu"], max_seq=64,
                                 **{"paged": True, **kwargs})
    with monkeypatch.context() as m:
        m.setenv("SWARMDB_ADMIT_OVERLAP", "0")
        with pytest.raises(NotImplementedError, match="item 11"):
            build_serving_engine("tiny-debug", ["cpu"], max_seq=64)
    for env, item in ((("SWARMDB_HA_NODE_ID", "n1"), 12),
                      (("SWARMDB_HA_CLUSTER", "/x.json"), 12),
                      (("BROKER_IMPL", "native"), 12),
                      (("SWARMDB_NUM_PROCESSES", "2"), 11),
                      (("SWARMDB_COORDINATOR", "h:1"), 11)):
        with monkeypatch.context() as m:
            m.setenv(*env)
            with pytest.raises(NotImplementedError, match=f"item {item}"):
                refuse_unported()
    refuse_unported()   # a single node over LocalBroker: nothing to refuse
    for cfg in (BrokerConfig(implementation="native"),
                BrokerConfig(replication_factor=2)):
        with pytest.raises(NotImplementedError, match="item 12"):
            SwarmDB(config=cfg, save_dir=str(tmp_path))
    db = SwarmDB(save_dir=str(tmp_path))
    try:
        with pytest.raises(NotImplementedError, match="item 12"):
            create_app(db, ha_node=object())
    finally:
        db.close()


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


@pytest.mark.parametrize("path", [
    "/admin/ha",
    "/admin/lockcheck", "/admin/pagecheck", "/admin/kerncheck",
    "/admin/profile", "/admin/mem"])
def test_unported_routes_answer_501(path, tmp_path):
    """Every route of the JAX package's server exists in the port's; one
    whose subsystem is not ported answers 501 (admin only) with a body
    that names its ROADMAP.md item."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from swarmdb_tpu_torch.api.app import (UNPORTED_ROUTES, ApiConfig,
                                           create_app)
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
    assert admin_st == 501
    assert f"queue 1 item {UNPORTED_ROUTES[path][1]}" in detail


@pytest.mark.parametrize("path", ["/admin/cluster/trace", "/admin/slo"])
def test_served_admin_routes_answer(path, tmp_path):
    """Routes that answered 501 until their subsystem was ported now
    serve the admin (403 for a user), with the JAX package's keys: the
    SLO sentinel's status, and the local trace through the cluster merge
    (its span count equal to /admin/trace/export's, nothing
    unreachable)."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from swarmdb_tpu_torch.api.app import (UNPORTED_ROUTES, ApiConfig,
                                           create_app)
    from swarmdb_tpu_torch.core.runtime import SwarmDB

    assert path not in UNPORTED_ROUTES

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
        spans = [e for e in body["traceEvents"] if e.get("ph") == "X"]
        assert len(spans) == len([e for e in local["traceEvents"]
                                  if e.get("ph") == "X"]) >= 2
        assert {"runtime.send", "broker.publish"} <= {
            e["name"] for e in spans}
        assert body["metadata"]["unreachable"] == []
        assert body["metadata"]["trace_id"] == mid
        assert len(body["metadata"]["nodes"]) == 1
