"""PD disaggregation through the unchanged reference master, on the CPU: a
mirror of tests/test_e2e_pd_disagg.py with the port's agents.

Each cluster is a reference ``Master`` on its own ``InMemoryCoordination``
store serving a PREFILL agent and a DECODE agent: two port agents; two
JAX agents; and both mixed pairs (a JAX prefill agent handing off to a
port decode agent, and the reverse). All engines get the JAX engine's tiny
f32 params (the port's through ``llama_params_from_jax``). On the CPU the
port has no device path (its transfer manager exists only on a card), so
every handoff here rides a host path: streamed (the default threshold is
256 KiB; the cluster sets 0 to stream every payload) or inline (threshold
-1). The greedy token ids each decode agent streams must be identical
across all four pairs and to a MIX port agent's: that proves the frames
are the reference's in both directions.
"""

import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import requests
import torch

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
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu_torch.common.types import InstanceType
from xllm_service_tpu_torch.engine import EngineConfig
from xllm_service_tpu_torch.engine import kv_transfer as port_kv
from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
from xllm_service_tpu_torch.models.base import tiny_config
from xllm_service_tpu_torch.models.weights import llama_params_from_jax

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

ENGINE_KW = dict(num_pages=64, page_size=16, hash_block_size=32,
                 max_batch_size=4, max_seq_len=256)
BODY = {"model": "tiny-llama", "prompt": "disaggregate me please",
        "max_tokens": 6, "temperature": 0, "ignore_eos": True}


def _options():
    return ServiceOptions(host="127.0.0.1", http_port=0, rpc_port=0,
                          lease_ttl_s=1.0, sync_interval_s=0.3,
                          reconcile_interval_s=0.1)


def _port(store, tree, itype, **agent_kw):
    return EngineAgent(
        EngineConfig(model=tiny_config(dtype=torch.float32,
                                       max_context_len=256), **ENGINE_KW),
        AgentConfig(host="127.0.0.1", model_id="tiny-llama",
                    instance_type=itype, heartbeat_interval_s=0.3,
                    lease_ttl_s=1.0, **agent_kw),
        coord=InMemoryCoordination(store), device="cpu",
        params=llama_params_from_jax(jax.tree.map(np.asarray, tree),
                                     device="cpu"))


def _ref(store, tree, itype):
    return RefAgent(
        RefEngineConfig(model_id="tiny-llama",
                        model=ref_tiny(dtype=jnp.float32,
                                       max_context_len=256),
                        prefill_buckets=(32, 64, 256), **ENGINE_KW),
        RefAgentConfig(host="127.0.0.1", model_id="tiny-llama",
                       instance_type=RefType(itype.value),
                       heartbeat_interval_s=0.3, lease_ttl_s=1.0),
        coord=InMemoryCoordination(store), params=tree)


def _record(agent):
    """Token ids the agent's streamer pushes, per service request id."""
    log: dict = {}
    push = agent.streamer.push

    def recording_push(dest, out):
        for o in out.outputs:
            log.setdefault(out.service_request_id, []).extend(o.token_ids)
        push(dest, out)

    agent.streamer.push = recording_push
    return log


class _Cluster:
    """A master and its agents (``makers``: store -> started agent)."""

    def __init__(self, *makers):
        self.store = MemoryStore(expiry_tick_s=0.05)
        self.master = Master(_options(),
                             coord=InMemoryCoordination(self.store))
        self.master.start()
        self.agents = [make(self.store).start() for make in makers]
        self.tokens = _record(self.agents[-1])
        mgr = self.master.scheduler.instance_mgr
        assert wait_until(lambda: all(mgr.get_instance_meta(a.name)
                                      for a in self.agents), timeout=10)
        if len(self.agents) == 2:
            pre, dec = self.agents
            assert wait_until(lambda: pre.name in dec.linked_peers
                              and dec.name in pre.linked_peers, timeout=10)
        self.base = f"http://127.0.0.1:{self.master.http_port}"

    def serve(self, body=BODY):
        """One completion: (text, the decode agent's token ids)."""
        r = requests.post(self.base + "/v1/completions", json=body,
                          timeout=120)
        assert r.status_code == 200, r.text
        sid = r.headers["X-Request-Id"]
        assert wait_until(lambda: sid in self.tokens, timeout=10)
        return r.json()["choices"][0]["text"], self.tokens[sid]

    def stop(self):
        for a in self.agents:
            a.stop()
        self.master.stop()
        self.store.close()


@pytest.fixture(scope="module")
def tree():
    return ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))


def _pair(pre, dec):
    return _Cluster(lambda s: pre(s, InstanceType.PREFILL),
                    lambda s: dec(s, InstanceType.DECODE))


@pytest.fixture(scope="module")
def pd_cluster(tree):
    """Two port agents; the prefill side streams every payload."""
    c = _pair(lambda s, t: _port(s, tree, t, kv_stream_threshold_bytes=0),
              lambda s, t: _port(s, tree, t))
    yield c
    c.stop()


@pytest.fixture(scope="module")
def reference(tree):
    """The JAX PD pair's and a port MIX agent's (text, tokens) for BODY."""
    out = {}
    for name, c in (("jax_pd", _pair(lambda s, t: _ref(s, tree, t),
                                     lambda s, t: _ref(s, tree, t))),
                    ("mix", _Cluster(lambda s: _port(s, tree,
                                                     InstanceType.MIX)))):
        try:
            out[name] = c.serve()
        finally:
            c.stop()
    assert out["mix"] == out["jax_pd"]
    return out


class TestPDDisaggregation:
    def test_pair_routing_and_linking(self, pd_cluster):
        pre, dec = pd_cluster.agents
        assert dec.name in pre.linked_peers and pre.name in dec.linked_peers
        assert pre.kv_transfer is None and dec.kv_transfer is None

    def test_pd_completion_matches_mix(self, pd_cluster, reference):
        pre, dec = pd_cluster.agents
        before = pre.engine.stats()["total_generated"]
        text, toks = pd_cluster.serve()
        assert (text, toks) == reference["mix"] == reference["jax_pd"]
        assert len(toks) == 6
        # The decode side emitted the whole stream; the prefill side holds
        # no sequence and emitted nothing.
        assert dec.engine.stats()["total_generated"] >= 6
        assert pre.engine.stats()["running"] == 0
        assert pre.engine.stats()["total_generated"] == before
        assert pre.engine.page_mgr.usage_perc() < 0.5

    def test_pd_streaming(self, pd_cluster, reference):
        r = requests.post(pd_cluster.base + "/v1/completions",
                          json={**BODY, "stream": True}, stream=True,
                          timeout=120)
        assert r.status_code == 200
        events = [line for line in r.iter_lines()
                  if line.startswith(b"data: ")]
        assert events[-1] == b"data: [DONE]"
        texts = [json.loads(e[6:])["choices"][0]["text"]
                 for e in events[:-1] if b'"choices"' in e]
        assert "".join(texts) == reference["mix"][0]

    def test_unlinked_peer_handoff_rejected(self, pd_cluster):
        _, dec = pd_cluster.agents
        msg = msgpack.packb({
            "service_request_id": "rogue-1", "request_id": "rogue-1",
            "source_service_addr": "127.0.0.1:1", "token_ids": [1, 2, 3],
            "first_token": 1, "sampling": {},
            "source_instance": "127.0.0.1:59999",   # never linked
            "kv": {"bytes": b"", "shape": [0], "dtype": "float32"},
        }, use_bin_type=True)
        r = requests.post(f"http://{dec.name}/rpc/kv_transfer", data=msg,
                          headers={"Content-Type": "application/msgpack"},
                          timeout=30)
        assert r.status_code == 403

    def test_bad_frame_and_failed_pull(self, pd_cluster):
        pre, dec = pd_cluster.agents
        url = f"http://{dec.name}/rpc/kv_transfer"
        hdr = {"Content-Type": "application/msgpack"}
        r = requests.post(url, data=b"\x92\x01", headers=hdr, timeout=30)
        assert r.status_code == 400
        # A stream offer the (linked) prefill side does not hold: 502.
        msg = msgpack.packb({
            "service_request_id": "lost-1", "request_id": "lost-1",
            "source_service_addr": "127.0.0.1:1", "token_ids": [1, 2, 3],
            "first_token": 1, "sampling": {},
            "source_instance": pre.name,
            "kv_stream": {"stream_uuid": 12345, "total_bytes": 64,
                          "chunk_bytes": 32, "block_bytes": 64,
                          "shape": [16], "dtype": "float32",
                          "checksum": ""},
        }, use_bin_type=True)
        r = requests.post(url, data=msg, headers=hdr, timeout=30)
        assert r.status_code == 502
        assert "lost-1" not in dec._handoffs_seen

    def test_duplicate_handoff_acknowledged_without_a_second_inject(
            self, pd_cluster):
        pre, dec = pd_cluster.agents
        submitted = []
        submit = dec.engine.submit
        dec.engine.submit = lambda req: (submitted.append(req),
                                         submit(req))[1]
        try:
            blob = np.zeros((2, 2, 1, 2, 16, 32), np.float32)
            msg = msgpack.packb({
                "service_request_id": "dup-1", "request_id": "dup-1",
                "source_service_addr": "127.0.0.1:1",
                "token_ids": [5, 6, 7], "first_token": 9,
                "first_logprob": None,
                "sampling": {"max_tokens": 2, "temperature": 0.0},
                "source_instance": pre.name,
                "kv": {"bytes": blob.tobytes(), "shape": list(blob.shape),
                       "dtype": "float32"},
            }, use_bin_type=True)
            url = f"http://{dec.name}/rpc/kv_transfer"
            hdr = {"Content-Type": "application/msgpack"}
            first = requests.post(url, data=msg, headers=hdr, timeout=30)
            again = requests.post(url, data=msg, headers=hdr, timeout=30)
        finally:
            dec.engine.submit = submit
        assert first.status_code == again.status_code == 200
        assert first.json() == {"ok": True}
        assert again.json() == {"ok": True, "duplicate": True}
        assert [r.service_request_id for r in submitted] == ["dup-1"]

    def test_decode_kv_transfer_populates_prefix_cache(self, pd_cluster):
        pre, dec = pd_cluster.agents
        pd_cluster.serve({**BODY, "prompt": "cache this prefix " * 8})
        assert wait_until(lambda: pre.engine.stats()["cached_blocks"] > 0,
                          timeout=5)
        assert wait_until(lambda: dec.engine.stats()["cached_blocks"] > 0,
                          timeout=5)

    def test_stream_and_inline_paths(self, pd_cluster, reference):
        pre, dec = pd_cluster.agents
        for thresh, path in ((0, "stream"), (-1, "inline")):
            pre.cfg.kv_stream_threshold_bytes = thresh
            sent = (pre.kv_stream_sent, pre.kv_host_sent)
            got = (dec.kv_stream_received, dec.kv_host_received)
            assert pd_cluster.serve() == reference["mix"]
            streamed = path == "stream"
            assert (pre.kv_stream_sent, pre.kv_host_sent) == (
                sent[0] + streamed, sent[1] + 1)
            assert (dec.kv_stream_received, dec.kv_host_received) == (
                got[0] + streamed, got[1] + 1)
        pre.cfg.kv_stream_threshold_bytes = 0
        stats = requests.get(f"http://{dec.name}/stats",
                             timeout=30).json()["kv_transfer"]
        assert stats["device_received"] == 0 and stats["host_received"] >= 2
        # Both agents declare the default slice: an ICI-shaped link.
        assert stats["bandwidth"]["ici"]["bytes_total"] > 0
        assert pre.kv_device_sent == 0


class FakeDevicePath:
    """Stands in for the CUDA IPC manager on the CPU (both agents share
    one): an offer lands in a dict that the peer's pull copies out, so the
    agents' device-path control flow runs here. ``fail`` makes the offer
    raise."""

    def __init__(self, fail=False):
        self.address = "cuda-ipc:GPU-fake"
        self.fail = fail
        self.offers: dict = {}

    def offer(self, sid, blob, incarnation="", ready=None, ctx=None):
        if self.fail:
            raise RuntimeError("offer failed")
        uid = port_kv.transfer_uuid(sid, incarnation)
        self.offers[uid] = blob.clone()
        return {"addr": self.address, "uuid": uid, "shape": list(blob.shape),
                "dtype": port_kv.dtype_name(blob.dtype),
                "ipc_handle": bytes(64), "offset": 0,
                "nbytes": blob.numel() * blob.element_size()}

    def pull(self, desc, ctx=None):
        return self.offers[desc["uuid"]].clone()

    def release(self, uuid):
        self.offers.pop(uuid, None)

    def gc(self):
        pass

    def close(self):
        pass


def test_device_path_and_its_counted_fallback(tree, reference):
    """The device path is taken when the decode peer advertises this
    card's transfer address; a failed offer falls back to the host path,
    counted apart."""
    c = _pair(lambda s, t: _port(s, tree, t), lambda s, t: _port(s, tree, t))
    pre, dec = c.agents
    try:
        fake = FakeDevicePath()
        pre.kv_transfer = dec.kv_transfer = fake
        pre.linked_peers[dec.name].topology.kv_transfer_addr = fake.address
        assert c.serve() == reference["jax_pd"]
        assert (pre.kv_device_sent, pre.kv_host_sent) == (1, 0)
        assert (dec.kv_device_received, dec.kv_host_received) == (1, 0)
        assert not fake.offers                # released after the POST
        fake.fail = True
        assert c.serve() == reference["jax_pd"]
        assert (pre.kv_device_sent, pre.kv_host_sent) == (1, 1)
        assert (dec.kv_device_received, dec.kv_host_received) == (1, 1)
        # A peer on another card (another address) is never offered.
        fake.fail = False
        pre.linked_peers[dec.name].topology.kv_transfer_addr = \
            "cuda-ipc:GPU-other"
        assert c.serve() == reference["jax_pd"]
        assert (pre.kv_device_sent, pre.kv_host_sent) == (1, 2)
    finally:
        pre.kv_transfer = dec.kv_transfer = None
        c.stop()


@pytest.mark.parametrize("pair", ["jax_prefill_port_decode",
                                  "port_prefill_jax_decode"])
def test_mixed_pairs_match_the_jax_pair(tree, reference, pair):
    port = lambda s, t: _port(s, tree, t)   # noqa: E731
    jax_ = lambda s, t: _ref(s, tree, t)    # noqa: E731
    c = _pair(jax_, port) if pair.startswith("jax") else _pair(port, jax_)
    try:
        assert c.serve() == reference["jax_pd"]
        pre, dec = c.agents
        assert pre.kv_host_sent == 1 and pre.kv_device_sent == 0
        assert dec.kv_host_received == 1
    finally:
        c.stop()
