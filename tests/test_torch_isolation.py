"""The port stands alone: importing every module of
``xllm_service_tpu_torch`` pulls in neither ``jax`` nor anything of
``xllm_service_tpu`` (nor ``ml_dtypes``, the reference's bf16 host type),
and ``chip_smoke.py`` imports none of them. Nor does the port import the
third-party packages its card's machine lacks (``aiohttp``, ``requests``,
``msgpack``, ``tokenizers``): its agent is written on the standard
library. ``jinja2`` (PyTorch requires it) and PIL are on the card's
machine: the chat template and the image decode use them, as the
reference does."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import xllm_service_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "xllm_service_tpu", "ml_dtypes")
NOT_ON_THE_CARD = ("aiohttp", "requests", "msgpack", "tokenizers")


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        xllm_service_tpu_torch.__path__, "xllm_service_tpu_torch."))


def test_every_port_module_imports_without_jax_or_the_reference():
    mods = _modules()
    assert "xllm_service_tpu_torch.engine.engine" in mods
    for m in ("ops.mq_paged_attention", "ops.fused_decode_attention",
              "ops.page_dma", "engine.kv_tier", "parallel.mesh",
              "ops.cp_paged_attention", "ops.ring_attention",
              "engine.agent", "coordination.client", "coordination.memory",
              "rpc.wire", "common.net", "tokenizer.factory",
              "engine.speculative", "benchmarks.spec_bench",
              "rpc.msgpack_lite", "common.topology", "engine.kv_transfer",
              "benchmarks.pd_handoff_bench", "models.safetensors_io",
              "models.hf_config", "models.loader", "tokenizer.args",
              "tokenizer.unicode_re", "tokenizer.tiktoken",
              "tokenizer.hf_json", "tokenizer.sentencepiece_tok",
              "multimaster.ownership", "common.metrics", "common.tracing",
              "common.faults", "common.flightrecorder", "profiling.sampler",
              "profiling.critical_path", "models.deepseek_moe",
              "models.mixtral", "models.quant", "models.weights",
              "models.qwen2_vl", "chat_template",
              "chat_template.jinja_chat_template"):
        assert f"xllm_service_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {FORBIDDEN + NOT_ON_THE_CARD!r})\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_chip_smoke_imports_neither():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "torch" in roots and "xllm_service_tpu_torch" in roots
    assert not roots & set(FORBIDDEN + NOT_ON_THE_CARD)


def test_port_sources_import_neither():
    for path in (ROOT / "xllm_service_tpu_torch").rglob("*.py"):
        assert not _imported_roots(path) & set(FORBIDDEN + NOT_ON_THE_CARD), \
            path
