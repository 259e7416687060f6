"""What the PyTorch/CUDA port may import, and where it runs by default.

- A fresh interpreter imports every module of ``localai_tfp_tpu_torch``
  and every module ``chip_smoke.py`` imports, and then holds no ``jax``,
  nothing of the JAX package, and none of the packages the GPU machine
  lacks (aiohttp, yaml, jinja2, tokenizers, safetensors, transformers).
- An AST scan of the port and ``chip_smoke.py`` finds no import of
  ``jax`` or of ``localai_tfp_tpu`` (other than ``localai_tfp_tpu_torch``),
  at module level or inside a function.
- Every entry point defaults to the card and raises without one unless it
  is given ``device="cpu"``; ``chip_smoke.py`` exits non-zero and prints
  no result without a card, and alone in a directory.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "localai_tfp_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "localai_tfp_tpu")
ABSENT_ON_CARD = ("aiohttp", "yaml", "jinja2", "tokenizers", "safetensors",
                  "transformers")


def _sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path) -> list[str]:
    """Absolute module names imported anywhere in ``path``."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_ast_scan_finds_no_jax_or_jax_package_import():
    bad = [(str(p.relative_to(ROOT)), n) for p in _sources()
           for n in _imported(p) if n.split(".")[0] in FORBIDDEN_ROOTS]
    assert bad == []


def test_fresh_interpreter_imports_port_without_jax():
    chip_mods = sorted({n for n in _imported(ROOT / "chip_smoke.py")})
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import localai_tfp_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods + {chip_mods!r} + ["chip_smoke"]:
    importlib.import_module(m)
print(json.dumps({{"mods": mods, "loaded": sorted(sys.modules)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT),
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # every module of the slice was imported, the kernel wrapper included
    for m in ("engine.engine", "models.transformer", "ops.sampling",
              "ops.ragged_paged_attention", "server.app", "workers.llm",
              "models.quant", "models.artifact_cache", "ops.int8_matmul"):
        assert f"localai_tfp_tpu_torch.{m}" in res["mods"]
    roots = {m.split(".")[0] for m in res["loaded"]}
    assert not roots & set(FORBIDDEN_ROOTS)
    assert not roots & set(ABSENT_ON_CARD)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_one(
        no_cuda, tmp_path):
    from localai_tfp_tpu_torch.device import resolve
    from localai_tfp_tpu_torch.engine.engine import LLMEngine
    from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
    from localai_tfp_tpu_torch.server.__main__ import main
    from localai_tfp_tpu_torch.server.app import build_server
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    for call in (resolve,
                 lambda: LLMEngine(tiny_spec(), {}, ByteTokenizer()),
                 TorchLLMBackend,
                 lambda: build_server(str(tmp_path)),
                 lambda: main(["--models-path", str(tmp_path), "--port",
                               "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for explicitly, the CPU serves
    assert resolve("cpu") == torch.device("cpu")
    assert TorchLLMBackend("cpu").device == torch.device("cpu")
    build_server(str(tmp_path), device="cpu").server_close()


def _chip_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(cwd),
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        out = _chip_smoke(cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
