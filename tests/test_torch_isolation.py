"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, and its entry points run on the card unless the caller
asks for the CPU -- without CUDA they raise instead of falling back.
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


def test_serving_a_request_loads_no_jax():
    code = (
        "import sys\n"
        "from swarmdb_tpu_torch.backend.service import build_backend_engine\n"
        "from swarmdb_tpu_torch.backend.sampling import SamplingParams\n"
        "for paged in (None, True):\n"
        "    eng, tok = build_backend_engine('tiny-debug', max_seq=64,"
        " paged=paged, device='cpu')\n"
        "    eng.start()\n"
        "    toks, why = eng.generate_sync(tok.encode('hi there'),"
        " SamplingParams(max_new_tokens=3))\n"
        "    eng.stop()\n"
        "    assert why in ('length', 'eos'), why\n"
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


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from swarmdb_tpu_torch.backend.service import (ServingService,
                                                   build_backend_engine)
    from swarmdb_tpu_torch.core.runtime import SwarmDB
    from swarmdb_tpu_torch.models import llama
    from swarmdb_tpu_torch.models.configs import get_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny-debug")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_backend_engine("tiny-debug", max_seq=64)
    db = SwarmDB()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingService.from_model_name(db, "tiny-debug", max_seq=64)
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


def test_unported_paths_say_so():
    from swarmdb_tpu_torch.backend.service import build_backend_engine

    with pytest.raises(NotImplementedError, match="Mixtral"):
        build_backend_engine("tiny-moe", device="cpu")
