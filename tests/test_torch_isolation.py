"""The port stands alone: importing every module of
``xllm_service_tpu_torch`` pulls in neither ``jax`` nor anything of
``xllm_service_tpu`` (nor ``ml_dtypes``, the reference's bf16 host type),
and ``chip_smoke.py`` imports none of them. Nor does the port import the
third-party packages its card's machine lacks (``aiohttp``, ``requests``,
``msgpack``, ``tokenizers``): its agent, master and coordination server
are written on the standard library, and the entry points
(``python -m xllm_service_tpu_torch.master``, ``python -m
xllm_service_tpu_torch.coordination.server`` and ``python -m
xllm_service_tpu_torch.testing.fake_engine``) run in a process that
imports none of them, as do a second master started beside a live one
(a replica frontend with the handoff relay's client), a fake engine
serving from its entry point, and a master started with
``--autoscaler-enabled --autoscaler-actuator local`` whose default
launcher starts the port's fake engine. ``jinja2`` (PyTorch requires it) and PIL are on the card's
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
              "benchmarks.pd_handoff_bench", "benchmarks.kvtier_bench",
              "models.safetensors_io",
              "models.hf_config", "models.loader", "tokenizer.args",
              "tokenizer.unicode_re", "tokenizer.tiktoken",
              "tokenizer.hf_json", "tokenizer.sentencepiece_tok",
              "multimaster.ownership", "common.metrics", "common.tracing",
              "common.faults", "common.flightrecorder", "profiling.sampler",
              "profiling.critical_path", "models.deepseek_moe",
              "models.mixtral", "models.quant", "models.weights",
              "models.qwen2_vl", "chat_template",
              "chat_template.jinja_chat_template",
              # The master and its service plane.
              "master", "utils", "coordination.base", "coordination.server",
              "coordination.health", "common.config", "common.slo",
              "common.hotpath", "common.call_data",
              "common.ordered_executor", "common.time_predictor",
              "common.types", "common.request", "overload",
              "overload.admission", "overload.brownout", "overload.deadline",
              "overload.retry_budget", "rpc.breaker", "rpc.channel",
              "scheduler.output_parsers", "scheduler.response_handler",
              "scheduler.policies", "scheduler.policies.base",
              "scheduler.policies.round_robin",
              "scheduler.policies.cache_aware",
              "scheduler.global_kvcache_mgr", "scheduler.instance_mgr",
              "scheduler.planner", "scheduler.scheduler",
              "multimaster.handoff", "http_service.web",
              "http_service.client", "scheduler.policies.slo_aware",
              "http_service.connection", "http_service.request_tracer",
              "http_service.service",
              # The autoscaler, the fake engine and the compile gate.
              "autoscaler", "autoscaler.controller", "autoscaler.actuator",
              "testing", "testing.fake_engine", "benchmarks.compile_gate",
              # The service-plane bench twins and what they share.
              "benchmarks.stack", "benchmarks.master_hotpath_bench",
              "benchmarks.kvcache_routing_bench",
              "benchmarks.generations_bench",
              "benchmarks.bench_tracing_overhead",
              "benchmarks.bench_profile_overhead",
              "benchmarks.overload_bench", "benchmarks.outage_bench",
              "benchmarks.fleet_bench"):
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


ENTRY_POINTS = ("xllm_service_tpu_torch.master",
                "xllm_service_tpu_torch.coordination.server",
                "xllm_service_tpu_torch.testing.fake_engine")


def test_entry_points_run_without_jax_the_reference_or_aiohttp():
    """``--help`` of the master and of the coordination server, each as
    ``python -m``, in a process whose modules are then listed."""
    for mod in ENTRY_POINTS:
        code = (
            "import runpy, sys\n"
            f"sys.argv = [{mod!r}, '--help']\n"
            "try:\n"
            f"    runpy.run_module({mod!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n"
            "bad = sorted(n for n in sys.modules\n"
            f"             if n.split('.')[0] in "
            f"{FORBIDDEN + NOT_ON_THE_CARD!r})\n"
            "print(repr(bad))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        lines = out.stdout.strip().splitlines()
        assert lines[0].startswith("usage:"), out.stdout[:200]
        assert lines[-1] == "[]", (mod, lines[-1])


def test_second_master_entry_point_runs_without_jax_the_reference_or_aiohttp():
    """A port master and the port's coordination server in a process, then
    ``python -m xllm_service_tpu_torch.master`` in the same process beside
    them: it starts as a replica frontend (``/hello`` says ``master:
    false``), the process's modules are listed, and SIGTERM ends it with
    exit 0."""
    code = (
        "import http.client, json, os, runpy, signal, sys, threading, time\n"
        "from xllm_service_tpu_torch.common.config import ServiceOptions\n"
        "from xllm_service_tpu_torch.common.net import pick_free_port\n"
        "from xllm_service_tpu_torch.coordination.memory import MemoryStore\n"
        "from xllm_service_tpu_torch.coordination.server import "
        "CoordinationServer\n"
        "from xllm_service_tpu_torch.master import Master\n"
        "srv = CoordinationServer(host='127.0.0.1', port=0,\n"
        "                         store=MemoryStore(expiry_tick_s=0.05))\n"
        "srv.start_background()\n"
        "addr = f'127.0.0.1:{srv.port}'\n"
        "first = Master(ServiceOptions(host='127.0.0.1', http_port=0,\n"
        "    rpc_port=0, coordination_addr=addr, lease_ttl_s=1.0))\n"
        "first.start()\n"
        "http_port = pick_free_port()\n"
        "def probe():\n"
        "    for _ in range(300):\n"
        "        try:\n"
        "            c = http.client.HTTPConnection('127.0.0.1', http_port,\n"
        "                                           timeout=5)\n"
        "            c.request('GET', '/hello')\n"
        "            hello = json.loads(c.getresponse().read())\n"
        "            break\n"
        "        except OSError:\n"
        "            time.sleep(0.1)\n"
        "    print('HELLO', json.dumps(hello), first.scheduler.is_master)\n"
        "    bad = sorted(n for n in sys.modules\n"
        f"                 if n.split('.')[0] in "
        f"{FORBIDDEN + NOT_ON_THE_CARD!r})\n"
        "    print(repr(bad), flush=True)\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "threading.Thread(target=probe, daemon=True).start()\n"
        "sys.argv = ['xllm_service_tpu_torch.master', '--host', '127.0.0.1',\n"
        "            '--http-port', str(http_port), '--rpc-port', '0',\n"
        "            '--coordination-addr', addr, '--lease-ttl-s', '1.0']\n"
        "runpy.run_module('xllm_service_tpu_torch.master', "
        "run_name='__main__')\n"
        "first.stop()\n"
        "srv.stop()\n"
        "print('STOPPED')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == 'HELLO {"status": "ok", "master": false} True', lines
    assert lines[1] == "[]", lines[1]
    assert lines[-1] == "STOPPED"


_BAD = ("    bad = sorted(n for n in sys.modules\n"
        f"                 if n.split('.')[0] in "
        f"{FORBIDDEN + NOT_ON_THE_CARD!r})\n"
        "    print(repr(bad), flush=True)\n")


def test_fake_engine_entry_point_serves_without_jax_the_reference_or_aiohttp():
    """``python -m xllm_service_tpu_torch.testing.fake_engine`` in a
    process beside the port's coordination server: it registers, serves
    ``/health``, the process's modules are listed, and SIGTERM ends it
    with exit 0 and its registration gone."""
    code = (
        "import http.client, json, os, runpy, signal, sys, threading, time\n"
        "from xllm_service_tpu_torch.common.net import pick_free_port\n"
        "from xllm_service_tpu_torch.coordination.memory import (\n"
        "    InMemoryCoordination, MemoryStore)\n"
        "from xllm_service_tpu_torch.coordination.server import "
        "CoordinationServer\n"
        "store = MemoryStore(expiry_tick_s=0.05)\n"
        "srv = CoordinationServer(host='127.0.0.1', port=0, store=store)\n"
        "srv.start_background()\n"
        "coord = InMemoryCoordination(store)\n"
        "port = pick_free_port()\n"
        "key = f'XLLM:INSTANCE:MIX:127.0.0.1:{port}'\n"
        "def probe():\n"
        "    for _ in range(300):\n"
        "        if coord.get(key):\n"
        "            break\n"
        "        time.sleep(0.1)\n"
        "    c = http.client.HTTPConnection('127.0.0.1', port, timeout=5)\n"
        "    c.request('GET', '/health')\n"
        "    print('HEALTH', c.getresponse().read().decode())\n"
        + _BAD +
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "threading.Thread(target=probe, daemon=True).start()\n"
        "sys.argv = ['fake_engine', '--coordination-addr',\n"
        "            f'127.0.0.1:{srv.port}', '--port', str(port)]\n"
        "runpy.run_module('xllm_service_tpu_torch.testing.fake_engine', "
        "run_name='__main__')\n"
        "print('GONE', coord.get(key) is None)\n"
        "srv.stop()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.strip().splitlines()
             if not ln.startswith("fake engine ")]
    assert lines == ['HEALTH {"status": "ok"}', "[]", "GONE True"], lines


def test_autoscaling_master_launches_the_ports_fake_engine():
    """``python -m xllm_service_tpu_torch.master --autoscaler-enabled
    --autoscaler-actuator local`` with no spawn command, beside the port's
    coordination server: its controller's first tick launches the port's
    fake engine (``python -m xllm_service_tpu_torch.testing.fake_engine``),
    which registers; the master's modules are listed; SIGTERM stops the
    master, whose actuator ends the child."""
    code = (
        "import json, os, runpy, signal, sys, threading, time\n"
        "from xllm_service_tpu_torch.common.net import pick_free_port\n"
        "from xllm_service_tpu_torch.coordination.memory import (\n"
        "    InMemoryCoordination, MemoryStore)\n"
        "from xllm_service_tpu_torch.coordination.server import "
        "CoordinationServer\n"
        "store = MemoryStore(expiry_tick_s=0.05)\n"
        "srv = CoordinationServer(host='127.0.0.1', port=0, store=store)\n"
        "srv.start_background()\n"
        "coord = InMemoryCoordination(store)\n"
        "def probe():\n"
        "    names = {}\n"
        "    for _ in range(600):\n"
        "        names = coord.get_prefix('XLLM:INSTANCE:')\n"
        "        if names:\n"
        "            break\n"
        "        time.sleep(0.1)\n"
        "    meta = json.loads(next(iter(names.values())))\n"
        "    print('LAUNCHED', len(names), meta['models'])\n"
        + _BAD +
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "threading.Thread(target=probe, daemon=True).start()\n"
        "sys.argv = ['xllm_service_tpu_torch.master', '--host', '127.0.0.1',\n"
        "            '--http-port', '0', '--rpc-port', '0',\n"
        "            '--coordination-addr', f'127.0.0.1:{srv.port}',\n"
        "            '--sync-interval-s', '0.2', '--autoscaler-enabled',\n"
        "            '--autoscaler-actuator', 'local']\n"
        "runpy.run_module('xllm_service_tpu_torch.master', "
        "run_name='__main__')\n"
        "for _ in range(100):\n"
        "    if not coord.get_prefix('XLLM:INSTANCE:'):\n"
        "        break\n"
        "    time.sleep(0.1)\n"
        "print('ENDED', coord.get_prefix('XLLM:INSTANCE:') == {})\n"
        "srv.stop()\n")
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as logs:
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
            text=True, timeout=120,
            env={**os.environ, "XLLM_AUTOSCALER_LOGDIR": logs,
                 "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines == ["LAUNCHED 1 ['fake-model']", "[]", "ENDED True"], \
        (lines, out.stderr[-2000:])
