"""The port's decode pipeline against the reference engine's, on the CPU:
dispatch before fetch (horizon N+1 is dispatched before horizon N is read),
the rows of finished, cancelled and reused slots dropped at the drain, the
pending horizon dropped by ``stop()`` and ``_fail_all``, the decode
telemetry, the per-slot generators, the cos/sin computed once per step, the
roofline byte counts and the two benchmark twins.

Both engines run on shared tiny f32 weights (``llama_params_from_jax``, as
tests/test_torch_engine.py builds them). Greedy tokens are compared
exactly: the logits agree to ~1e-5, far inside the gaps between a random
model's top logits.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.common.request import SamplingParams as RefSampling
from xllm_service_tpu.engine.config import EngineConfig as RefConfig
from xllm_service_tpu.engine.engine import EngineRequest as RefRequest
from xllm_service_tpu.engine.engine import InferenceEngine as RefEngine
from xllm_service_tpu.models import base as ref_base
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu_torch.common.request import SamplingParams
from xllm_service_tpu_torch.engine import (
    EngineConfig,
    EngineRequest,
    InferenceEngine,
)
from xllm_service_tpu_torch.models import base, llama
from xllm_service_tpu_torch.models.weights import llama_params_from_jax
from xllm_service_tpu_torch.ops import attention

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ROOT = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=2, max_seq_len=256, admission_horizon=2)
GREEDY = dict(temperature=0.0, ignore_eos=True)
TOL = dict(rtol=1e-4, atol=1e-4)         # tests/test_torch_llama.py's


class Collector:
    def __init__(self):
        self.outputs = []
        self.after_finish = 0      # outputs that arrived after the last one

    def __call__(self, out) -> None:
        if self.done:
            self.after_finish += 1
        self.outputs.append(out)

    @property
    def done(self):
        return any(o.finished for o in self.outputs)

    @property
    def tokens(self):
        return [t for o in self.outputs for s in o.outputs
                for t in s.token_ids]

    @property
    def finish_reason(self):
        for o in self.outputs:
            for s in o.outputs:
                if s.finish_reason:
                    return s.finish_reason
        return ""


@pytest.fixture(scope="module")
def weights():
    rcfg = ref_base.tiny_config(dtype=jnp.float32, max_context_len=256)
    tree = ref_llama.init_params(rcfg, jax.random.PRNGKey(0))
    params = llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                   device="cpu")
    return rcfg, tree, params


def ref_engine(weights, horizon=4):
    rcfg, tree, _ = weights
    return RefEngine(RefConfig(model=rcfg, prefill_buckets=(32, 64, 256),
                               decode_horizon=horizon, **ENGINE_KW),
                     params=tree)


def port_engine(weights, horizon=4, **kw):
    cfg = EngineConfig(model=base.tiny_config(dtype=torch.float32,
                                              max_context_len=256),
                       decode_horizon=horizon, **{**ENGINE_KW, **kw})
    return InferenceEngine(cfg, device="cpu", params=weights[2])


_ids = iter(range(10**6))


def drive(engine, schedule, timeout=120):
    """``schedule``: (step index, prompt, sampling kwargs) per request;
    each request is submitted before the engine's step of that index, and
    the engine steps until all have finished. Returns the collectors."""
    is_ref = isinstance(engine, RefEngine)
    req_cls, sp_cls = ((RefRequest, RefSampling) if is_ref
                       else (EngineRequest, SamplingParams))
    cols = [Collector() for _ in schedule]
    t0, n = time.monotonic(), 0
    while any(not c.done for c in cols):
        assert time.monotonic() - t0 < timeout
        for (at, prompt, sp), col in zip(schedule, cols):
            if at == n:
                engine.submit(req_cls(f"r{next(_ids)}", token_ids=list(prompt),
                                      sampling=sp_cls(**sp), on_output=col))
        engine.step()
        n += 1
    return cols


def staggered():
    """Five greedy requests over two slots, arriving at steps 0-5."""
    return [(0, range(10, 30), dict(max_tokens=11, **GREEDY)),
            (0, range(40, 52), dict(max_tokens=5, **GREEDY)),
            (1, range(100, 133), dict(max_tokens=9, **GREEDY)),
            (3, range(3, 21), dict(max_tokens=3, **GREEDY)),
            (5, range(200, 240), dict(max_tokens=7, **GREEDY))]


@pytest.fixture(scope="module")
def ref_staggered(weights):
    return [(c.tokens, c.finish_reason)
            for c in drive(ref_engine(weights), staggered())]


@pytest.mark.parametrize("route", ["default", "fused"])
@pytest.mark.parametrize("horizon", [1, 2, 4, 8])
def test_staggered_greedy_tokens_equal_reference(weights, ref_staggered,
                                                 monkeypatch, horizon, route):
    if route == "fused":
        monkeypatch.setenv("XLLM_KV_WRITEBACK", "fused")
    port = port_engine(weights, horizon)
    assert port._graphs is None          # the CPU runs the eager step
    cols = drive(port, staggered())
    assert [(c.tokens, c.finish_reason) for c in cols] == ref_staggered
    assert all(c.after_finish == 0 for c in cols)
    assert not port._running
    port.step()                          # the pipeline's tail is drained
    assert port._pending_decode is None


def test_slot_reused_while_pending_gets_no_old_rows(weights):
    """One slot: A finishes at the drain of its first horizon while its
    next horizon is already in flight; B takes the slot before that
    horizon's rows are read, and none of them reach either request."""
    port = port_engine(weights, horizon=4, max_batch_size=1,
                       admission_horizon=0)
    sched = [(0, range(10, 30), dict(max_tokens=3, **GREEDY)),
             (0, range(60, 90), dict(max_tokens=6, **GREEDY))]
    a, b = drive(port, sched)
    ref = drive(ref_engine(weights), sched)
    assert (a.tokens, b.tokens) == (ref[0].tokens, ref[1].tokens)
    assert len(a.tokens) == 3 and len(b.tokens) == 6
    assert a.after_finish == 0 and b.after_finish == 0


def _pending(port, prompt, **sp):
    """Submit one request and step until a horizon is in flight."""
    col = Collector()
    port.submit(EngineRequest(f"p{next(_ids)}", token_ids=list(prompt),
                              sampling=SamplingParams(**sp), on_output=col))
    for _ in range(3):
        port.step()
    assert port._pending_decode is not None
    return col


def test_cancel_while_pending(weights):
    port = port_engine(weights, horizon=4)
    col = _pending(port, range(20, 44), max_tokens=100, **GREEDY)
    seen = len(col.tokens)
    port.cancel(col.outputs[0].service_request_id)
    port.step()
    assert col.done and col.outputs[-1].status.code.name == "CANCELLED"
    for _ in range(3):
        port.step()
    assert not port._running and port._pending_decode is None
    assert col.after_finish == 0 and len(col.tokens) == seen


def test_stop_id_mid_horizon_while_pending(weights):
    prompt = list(range(10, 26))
    want = drive(ref_engine(weights, 8),
                 [(0, prompt, dict(max_tokens=12, **GREEDY))])[0].tokens
    port = port_engine(weights, horizon=8)
    sched = [(0, prompt, dict(max_tokens=12, stop_token_ids=[want[4]],
                              **GREEDY))]
    got = drive(port, sched)[0]
    ref = drive(ref_engine(weights, 8), sched)[0]
    assert got.tokens == ref.tokens == want[:want.index(want[4]) + 1]
    assert got.finish_reason == ref.finish_reason == "stop"
    assert got.after_finish == 0


@pytest.mark.parametrize("how", ["stop", "fail_all"])
def test_stop_and_fail_all_drop_the_pending_horizon(weights, how):
    port = port_engine(weights, horizon=4)
    col = _pending(port, range(30, 50), max_tokens=100, **GREEDY)
    addrs = [t.data_ptr() for t in (port._last, port._clens, port._pt,
                                    port._active, port._st.token_counts)]
    if how == "stop":
        port.stop()
    else:
        port._fail_all("boom")
        assert col.done and "boom" in col.outputs[-1].status.message
        assert not port._running and not port._active.any()
        assert (port._pt == 0).all()
    assert port._pending_decode is None
    # Slot state is reset in place: a captured step keeps its addresses.
    assert addrs == [t.data_ptr() for t in (port._last, port._clens,
                                            port._pt, port._active,
                                            port._st.token_counts)]


def test_decode_telemetry_as_the_reference(weights):
    sched = [(0, range(10, 40), dict(max_tokens=9, **GREEDY)),
             (0, range(50, 70), dict(max_tokens=9, **GREEDY))]
    engines = (ref_engine(weights), port_engine(weights))
    for eng in engines:
        drive(eng, sched)
    ref, port = engines
    # (batch, total context) per drained horizon: the same horizons in
    # the same order, the same pipeline lag.
    assert [s[:2] for s in port.tpot_samples] == \
        [s[:2] for s in ref.tpot_samples]
    assert [s[0] for s in port.ttft_samples] == \
        [s[0] for s in ref.ttft_samples] == [30, 20]
    assert all(s[2] > 0 for s in port.tpot_samples)
    ttft, tbt = port.drain_recent_latency()
    assert ttft == max(s[1] for s in port.ttft_samples)
    assert tbt == max(s[2] for s in port.tpot_samples)
    assert port.drain_recent_latency() == (0.0, 0.0)
    assert ref.drain_recent_latency()[1] > 0


def test_seeded_request_deterministic_across_fresh_engines(weights):
    sp = dict(max_tokens=7, temperature=0.9, top_k=30, top_p=0.95, seed=77,
              ignore_eos=True)
    prompt = range(60, 90)
    a = drive(port_engine(weights), [(0, prompt, sp)])[0].tokens
    # Beside other traffic, admitted later into another slot.
    b = drive(port_engine(weights, horizon=2),
              [(0, range(5, 25), dict(max_tokens=9, **GREEDY)),
               (2, prompt, sp)])[1].tokens
    assert a == b and len(a) == 7


def test_rope_once_per_step_matches_reference(weights):
    """cos/sin computed once per decode step from the cached inverse
    frequencies give the reference's logits, at positions across the
    whole table."""
    rcfg, tree, params = weights
    cfg = base.tiny_config(dtype=torch.float32, max_context_len=256)
    rng = np.random.default_rng(3)
    n_kv, ps = rcfg.num_kv_heads, 16
    P = 17
    kv = rng.normal(size=(rcfg.num_layers, 2, P, n_kv, ps, rcfg.head_dim)
                    ).astype(np.float32)
    pt = np.arange(1, 17, dtype=np.int32).reshape(1, 16).repeat(3, 0)
    clens = np.asarray([1, 131, 256], np.int32)
    last = rng.integers(3, 500, size=3).astype(np.int32)
    want, _ = jax.jit(ref_llama.decode_forward, static_argnums=1)(
        tree, rcfg, jnp.asarray(last), jnp.asarray(clens - 1),
        jnp.asarray(kv), jnp.asarray(pt), jnp.asarray(clens))
    got, _ = llama.decode_forward(
        params, cfg, torch.from_numpy(last), torch.from_numpy(clens - 1),
        torch.from_numpy(kv.copy()), torch.from_numpy(pt),
        torch.from_numpy(clens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    inv = attention.rope_inv_freq(cfg.head_dim, cfg.rope_theta,
                                  torch.device("cpu"))
    assert attention.rope_inv_freq(cfg.head_dim, cfg.rope_theta,
                                   torch.device("cpu")) is inv
    exps = torch.arange(0, cfg.head_dim, 2, dtype=torch.float32) / \
        cfg.head_dim
    assert torch.equal(inv, 1.0 / torch.pow(torch.tensor(
        cfg.rope_theta, dtype=torch.float32), exps))


@pytest.mark.parametrize("name", ["tiny_config", "bench_1b_config",
                                  "llama3_8b_config"])
def test_roofline_byte_counts_equal_reference(name):
    ref, port = getattr(ref_base, name)(), getattr(base, name)()
    assert port.decode_weight_stream_bytes() == \
        ref.decode_weight_stream_bytes()
    for ctx in (1, 512, 1280):
        assert port.kv_bytes_per_token(ctx) == ref.kv_bytes_per_token(ctx)


@pytest.mark.parametrize("module,keys", [
    ("xllm_service_tpu_torch.bench",
     {"metric", "value", "unit", "tokens", "bytes_per_step_mb",
      "effective_gbps", "ms_per_token_step"}),
    ("xllm_service_tpu_torch.benchmarks.decode_profile",
     {"full_step_ms", "full_step_graphed_ms", "forward_only_ms",
      "attention_only_ms", "attention_per_layer_ms", "sampling_only_ms",
      "matmul_and_rest_ms", "sample_overhead_ms", "dispatch_fetch_rtt_ms",
      "upload_32kb_ms", "trace", "trace_graphed", "weight_stream_mb"}),
])
def test_twin_runs_on_the_cpu_and_prints_one_json_line(module, keys):
    out = subprocess.run([sys.executable, "-m", module, "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert keys <= set(rec) and rec["backend"] == "cpu"
    if "value" in keys and "tokens" in keys:
        assert rec["value"] > 0 and rec["tokens"] > 0


@pytest.mark.parametrize("module", ["xllm_service_tpu_torch.bench",
                                    "xllm_service_tpu_torch.benchmarks."
                                    "decode_profile"])
def test_twin_raises_without_a_card(module):
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.argv = [{module!r}]\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "device='cpu'" in out.stderr
