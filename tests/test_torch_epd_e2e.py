"""EPD (encode, prefill, decode) through the unchanged reference master,
on the CPU: an image chat goes to the MIX agent with ``routing.
encode_name`` set to the ENCODE agent, which runs the vision tower on
``/rpc/encode``; the MIX engine splices the visual rows and decodes.

Three clusters on one reference ``Master`` each, their agents on the same
tiny f32 qwen2_vl weights (the port's through ``params_from_jax``):

- all-JAX (the reference's MIX and ENCODE agents);
- all-port (the port's MIX and ENCODE agents);
- mixed (the port's MIX agent with the JAX ENCODE agent), which shows the
  msgpack ``{"bytes", "shape", "dtype"}`` body is the same both ways.

The six cases of tests/test_e2e_epd.py run on the port's cluster; the
greedy token ids (recorded at each MIX agent's streamer) equal the
all-JAX cluster's and the logprobs agree within 1e-4 (f32 programs in
another summation order).
"""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests

from xllm_service_tpu.common.config import ServiceOptions
from xllm_service_tpu.common.types import InstanceType as RefType
from xllm_service_tpu.coordination.memory import (
    InMemoryCoordination,
    MemoryStore,
)
from xllm_service_tpu.engine.agent import AgentConfig as RefAgentConfig
from xllm_service_tpu.engine.agent import EngineAgent as RefAgent
from xllm_service_tpu.engine.config import EngineConfig as RefEngineConfig
from xllm_service_tpu.master import Master
from xllm_service_tpu.models import qwen2_vl as ref_vl
from xllm_service_tpu_torch.common.types import InstanceType
from xllm_service_tpu_torch.engine import EngineConfig
from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
from xllm_service_tpu_torch.models.weights import params_from_jax

from fakes import wait_until
from test_torch_qwen2_vl import port_config

LOGPROB_TOL = 1e-4
ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=256)


def _rcfg():
    return ref_vl.tiny_vl_config(dtype=jnp.float32, max_context_len=256,
                                 image_token_id=100)


def _ref_agent(store, itype, tree):
    return RefAgent(
        RefEngineConfig(model_id="tiny-vl", model_family="qwen2_vl",
                        model=_rcfg(), prefill_buckets=(32, 64, 256),
                        **ENGINE_KW),
        RefAgentConfig(host="127.0.0.1", model_id="tiny-vl",
                       instance_type=RefType(itype.value),
                       heartbeat_interval_s=0.3, lease_ttl_s=1.0),
        coord=InMemoryCoordination(store), params=tree)


def _port_agent(store, itype, tree):
    return EngineAgent(
        EngineConfig(model_family="qwen2_vl", model=port_config(_rcfg()),
                     **ENGINE_KW),
        AgentConfig(host="127.0.0.1", model_id="tiny-vl",
                    instance_type=itype, heartbeat_interval_s=0.3,
                    lease_ttl_s=1.0),
        coord=InMemoryCoordination(store), device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, tree),
                               device="cpu"))


class _Cluster:
    def __init__(self, make_mix, make_encode, tree):
        self.store = MemoryStore(expiry_tick_s=0.05)
        self.master = Master(ServiceOptions(
            host="127.0.0.1", http_port=0, rpc_port=0, lease_ttl_s=1.0,
            sync_interval_s=0.3, reconcile_interval_s=0.1),
            coord=InMemoryCoordination(self.store))
        self.master.start()
        self.mix = make_mix(self.store, InstanceType.MIX, tree).start()
        self.encode = make_encode(self.store, InstanceType.ENCODE,
                                  tree).start()
        self.tokens: dict = {}
        push = self.mix.streamer.push

        def recording_push(dest, out):
            for o in out.outputs:
                self.tokens.setdefault(out.service_request_id, []).extend(
                    o.token_ids)
            push(dest, out)

        self.mix.streamer.push = recording_push
        mgr = self.master.scheduler.instance_mgr
        assert wait_until(
            lambda: mgr.get_instance_meta(self.mix.name) is not None
            and mgr.get_instance_meta(self.encode.name) is not None,
            timeout=10)
        self.base = f"http://127.0.0.1:{self.master.http_port}"

    def chat(self, body):
        """(response, the token ids the MIX agent streamed for it)."""
        r = requests.post(self.base + "/v1/chat/completions", json=body,
                          timeout=120)
        sid = r.headers.get("X-Request-Id", "")
        return r, self.tokens.get(sid)

    def stop(self):
        self.mix.stop()
        self.encode.stop()
        self.master.stop()
        self.store.close()


@pytest.fixture(scope="module")
def clusters():
    tree = ref_vl.init_params(_rcfg(), jax.random.PRNGKey(0))
    made = {"jax": _Cluster(_ref_agent, _ref_agent, tree),
            "port": _Cluster(_port_agent, _port_agent, tree),
            "mixed": _Cluster(_port_agent, _ref_agent, tree)}
    yield made
    for c in made.values():
        c.stop()


def _data_uri(seed: int) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (28, 28, 3),
                                       dtype=np.uint8), "RGB")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + \
        base64.b64encode(buf.getvalue()).decode()


def _chat_body(seed: int, **kw) -> dict:
    return {
        "model": "tiny-vl",
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "describe: "},
            {"type": "image_url", "image_url": {"url": _data_uri(seed)}},
        ]}],
        "max_tokens": 6, "temperature": 0, "ignore_eos": True, **kw,
    }


def _logprobs(r):
    return [t["logprob"] for t in r.json()["choices"][0]["logprobs"]
            ["content"]]


def _same_as_jax(clusters, body, names=("port",)):
    """Serve ``body`` on the all-JAX cluster and on ``names``: each
    response's token ids equal the JAX cluster's, its logprobs within
    LOGPROB_TOL. Returns the port cluster's response."""
    want, want_ids = clusters["jax"].chat(body)
    assert want.status_code == 200, want.text
    out = None
    for name in names:
        got, got_ids = clusters[name].chat(body)
        assert got.status_code == 200, got.text
        assert got_ids == want_ids and got_ids
        if body.get("logprobs"):
            np.testing.assert_allclose(_logprobs(got), _logprobs(want),
                                       atol=LOGPROB_TOL)
        out = out or got
    return out


def test_image_chat_routes_through_the_encode_instance(clusters):
    port = clusters["port"]
    before = port.encode.encode_count
    r = _same_as_jax(clusters, _chat_body(seed=1, logprobs=True),
                     names=("port", "mixed"))
    body = r.json()
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["usage"]["completion_tokens"] == 6
    assert port.mix.engine.stats()["total_generated"] >= 6
    # The ENCODE agent generated nothing but did encode: the stage ran
    # remotely, not as the MIX agent's local fallback.
    assert port.encode.engine.stats()["total_generated"] == 0
    assert port.encode.encode_count == before + 1
    assert port.mix.encode_count == 0
    stats = requests.get(f"http://{port.encode.name}/stats", timeout=5)
    assert stats.json()["encode_count"] == port.encode.encode_count
    # The mixed pair's JAX ENCODE agent answered the port's msgpack body.
    assert clusters["mixed"].encode.encode_count >= 1


def test_different_images_different_outputs(clusters):
    def run(seed):
        r = _same_as_jax(clusters, _chat_body(seed, logprobs=True,
                                              top_logprobs=1))
        choice = r.json()["choices"][0]
        return choice["message"]["content"], tuple(
            round(t["logprob"], 5) for t in choice["logprobs"]["content"])

    (t1, lp1), (t2, lp2), (t1b, lp1b) = run(1), run(2), run(1)
    assert (t1, lp1) == (t1b, lp1b)
    assert lp1 != lp2 or t1 != t2


def test_text_only_chat_still_works_on_a_vl_fleet(clusters):
    r = _same_as_jax(clusters, {
        "model": "tiny-vl",
        "messages": [{"role": "user", "content": "plain text"}],
        "max_tokens": 4, "temperature": 0, "ignore_eos": True})
    assert r.json()["usage"]["completion_tokens"] == 4


@pytest.mark.parametrize("case", ["http_url", "unknown_part"])
def test_bad_image_parts_are_refused(clusters, case):
    """A URL that is not a data URI, or an image part of an unknown type:
    the agent answers 400 (never a mis-spliced prompt), which the master
    surfaces as it surfaces the JAX agent's."""
    body = _chat_body(seed=1)
    if case == "http_url":
        body["messages"][0]["content"][1]["image_url"]["url"] = \
            "https://example.com/cat.png"
    else:
        body["messages"][0]["content"].append(
            {"type": "image_file", "file_id": "f123"})
    codes = [clusters[n].chat(body)[0].status_code for n in ("jax", "port")]
    assert codes[0] == codes[1] and codes[1] in (400, 503)


def test_multimodal_skips_the_prefix_cache(clusters):
    port = clusters["port"]
    text = "repeat this exact text many times " * 2

    def run(seed):
        body = _chat_body(seed, logprobs=True)
        body["messages"][0]["content"][0]["text"] = text
        return tuple(round(x, 5) for x in _logprobs(
            _same_as_jax(clusters, body)))

    cached = port.mix.engine.stats()["cached_blocks"]
    lp1, lp2 = run(11), run(12)
    assert port.mix.engine.stats()["cached_blocks"] == cached
    assert lp1 != lp2
