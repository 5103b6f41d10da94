"""The port's xlint (``xllm_service_tpu_torch/devtools/xlint``) against the
reference's, and over the port's own tree.

- Both packages' xlint over ``tests/data/xlint_fixtures`` give the same
  (rule, file, line, message). Two pair-rule messages end in a
  parenthetical naming the bug's shape, which the reference words with
  its own history; :data:`SHAPE_NOTE` blanks that parenthetical on both
  sides.
- The port's tree is clean under every rule, in under 30 s.
- Every hatch in the port's tree carries a reason.
- Each registry the rules read is live: a known-bad probe linted next to
  the port's registry file fires its rule (the reference's
  ``test_xlint_*_registry_is_live`` probes).
"""

import re
import tempfile
import time
from pathlib import Path

import pytest

from xllm_service_tpu.devtools import xlint as ref_xlint
from xllm_service_tpu_torch.devtools import xlint

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "xlint_fixtures"
PORT = ROOT / "xllm_service_tpu_torch"

#: The parenthetical that names a pair finding's shape.
SHAPE_NOTE = re.compile(r"\(the [\w -]*(slot-leak|gauge-resurrection) "
                        r"shape\)")


HATCH_RE = re.compile(r"#\s*xlint:\s*allow-([a-z-]+)\(([^)]*)\)")


def _key(v):
    return (v.rule, v.path, v.line,
            SHAPE_NOTE.sub(r"(the \1 shape)", v.message))


def test_fixture_findings_match_the_reference():
    ref = sorted(_key(v) for v in ref_xlint.run([str(FIXTURES)]))
    port = sorted(_key(v) for v in xlint.run([str(FIXTURES)]))
    assert port == ref
    assert len(port) > 50
    # Every rule of the reference fires on the fixtures in both.
    assert {k[0] for k in port} == {k[0] for k in ref}


@pytest.fixture(scope="module")
def port_run():
    """One strict run over the port's tree: (violations, stats, seconds)."""
    t0 = time.monotonic()
    stats: dict = {}
    vs = xlint.run([str(PORT)], stats=stats)
    return vs, stats, time.monotonic() - t0


def test_port_tree_is_clean_within_budget(port_run):
    vs, stats, took = port_run
    assert not vs, "\n".join(str(v) for v in vs)
    assert stats["files"] > 120
    assert took < 30.0, took


def test_cli_exits_zero_on_the_port(capsys):
    assert xlint.main([str(PORT)]) == 0
    assert "xlint: clean" in capsys.readouterr().out


def test_every_hatch_carries_a_reason(port_run):
    hatches = port_run[1]["hatches"]
    assert hatches
    for h in hatches:
        assert h["reason"], h
    assert {h["kind"].split(":")[0] for h in hatches} == {"comment",
                                                          "runtime"}
    # A hatch comment without a reason does not register (its violation
    # still fires), so look for empty ones in the source too.
    empty = [f"{p}:{n}" for p in PORT.rglob("*.py")
             for n, line in enumerate(p.read_text().splitlines(), 1)
             for m in HATCH_RE.finditer(line) if not m.group(2).strip()]
    assert not empty, empty


def _probe(registry_files, probe_src):
    with tempfile.TemporaryDirectory() as td:
        bad = Path(td) / "probe.py"
        bad.write_text(probe_src)
        return [v for v in xlint.run([*map(str, registry_files), str(bad)])
                if "probe.py" in v.path]


def test_rcu_registry_is_live():
    from xllm_service_tpu_torch.devtools import rcu

    assert rcu.RCU_FROZEN_TYPES and rcu.RCU_PUBLICATIONS
    vs = _probe([rcu.__file__], (
        "class PrefixIndex:\n"
        "    def __init__(self):\n"
        "        self.blocks = {}\n"
        "class Mgr:\n"
        "    def bad(self, snap):\n"
        "        snap = PrefixIndex()\n"
        "        snap.blocks = {}\n"))
    assert any(v.rule == "rcu-frozen" for v in vs), vs


def test_state_registry_is_live():
    from xllm_service_tpu_torch.devtools import ownership
    from xllm_service_tpu_torch.rpc import wire

    assert ownership.STATE_DISCIPLINES["GlobalKVCacheMgr._frame_seq"] \
        == "lock:_lock"
    assert ownership.STATE_DISCIPLINES["EngineAgent._reg_epoch"] \
        == "lock:_reg_lock"
    vs = _probe([ownership.__file__, wire.__file__], (
        "import threading\n"
        "class GlobalKVCacheMgr:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()  # lock-order: 26\n"
        "        self._frame_seq = 0\n"
        "        self._dirty = set()\n"
        "    def bad_write(self):\n"
        "        self._frame_seq = 7\n"
        "    def bad_decl(self):\n"
        "        self._made_up_attr = 1\n"
        "    def match(self):\n"
        "        return self._frame_seq\n"))
    rules = {v.rule for v in vs}
    assert {"state-write", "state-decl", "state-read"} <= rules, vs
    assert any("_made_up_attr" in v.message for v in vs), vs


def test_pair_registry_is_live():
    from xllm_service_tpu_torch.common import metrics
    from xllm_service_tpu_torch.devtools import lifecycle

    assert set(lifecycle.pair_specs()) == set(lifecycle.EFFECT_PAIRS)
    vs = _probe([lifecycle.__file__, metrics.__file__], (
        "class AdmissionController:\n"
        "    def try_admit(self):\n"
        "        return True\n"
        "    def release(self):\n"
        "        pass\n"
        "ADMISSION = AdmissionController()\n"
        "def leaky():\n"
        "    if ADMISSION.try_admit():\n"
        "        pass\n"
        "def twice():\n"
        "    ADMISSION.release()\n"
        "    ADMISSION.release()\n"
        "def zap(name):\n"
        "    INSTANCE_QUEUE_DEPTH.remove(instance=name)\n"))
    msgs = {v.rule: v.message for v in vs}
    assert "not discharged" in msgs.get("pair-release", ""), vs
    assert "released twice" in msgs.get("pair-once", ""), vs
    assert "remove" in msgs.get("pair-evict", ""), vs


@pytest.mark.parametrize("registry,rule,probe", [
    ("common/faults.py", "fault-point",
     "from x import FAULTS\n"
     "def f():\n"
     "    FAULTS.fire('no.such.point')\n"),
    ("common/tracing.py", "span-point",
     "from x import TRACER\n"
     "def f():\n"
     "    with TRACER.span('no.such.span'):\n"
     "        pass\n"),
    ("rpc/wire.py", "hot-json",
     "import json\n"
     "class SimpleTokenizer:\n"
     "    def encode(self, text):\n"
     "        return json.dumps(text)\n"),
])
def test_point_registries_are_live(registry, rule, probe):
    vs = _probe([PORT / registry], probe)
    assert any(v.rule == rule for v in vs), vs
