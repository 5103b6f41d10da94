"""The wire contract the other way: the port's master serving the JAX
package's engine agent, against the JAX master serving the same agent, on
the CPU (tiny f32 llama, the same weights).

The JAX agent registers, heartbeats (msgpack, with KV events) and streams
its Generations to the port's master exactly as to the JAX master; the
same completions, chat, streaming, ``n > 1``, logprob, embeddings and
``/v1/messages`` requests give the same status, content type and bodies
(ids and timestamps aside), and the agent's KV events reach the port
master's index.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.engine.agent import AgentConfig as RefAgentConfig
from xllm_service_tpu.engine.agent import EngineAgent as RefAgent
from xllm_service_tpu.engine.config import EngineConfig as RefEngineConfig
from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny

from fakes import wait_until
from test_torch_master_e2e import (CASES, ENGINE_KW, GREEDY, Cluster,
                                   normalized)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

CHOSEN = ["completion", "completion_stream_usage", "chat", "chat_stream",
          "n2", "logprobs", "messages", "messages_stream"]


@pytest.fixture(scope="module")
def clusters():
    tree = ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))

    def jax_agent(coord):
        return RefAgent(
            RefEngineConfig(model_id="tiny-llama",
                            model=ref_tiny(dtype=jnp.float32,
                                           max_context_len=256),
                            prefill_buckets=(32, 64, 256), **ENGINE_KW),
            RefAgentConfig(host="127.0.0.1", model_id="tiny-llama",
                           heartbeat_interval_s=0.3, lease_ttl_s=1.0),
            coord=coord, params=tree)

    made = [Cluster(which, jax_agent, block_size=32)
            for which in ("ref", "port")]
    yield made
    for c in made:
        c.stop()


@pytest.mark.parametrize("case", CHOSEN)
def test_jax_agent_behind_the_port_master(clusters, case):
    path, body = CASES[case]
    body = {**GREEDY, **body}
    want, got = (normalized(c.call("POST", path, body)) for c in clusters)
    assert want["status"] == 200, want
    assert got == want


def test_embeddings_from_the_jax_agent(clusters):
    body = {"model": "tiny-llama", "input": "hello world"}
    want, got = (normalized(c.call("POST", "/v1/embeddings", body))
                 for c in clusters)
    assert want["status"] == 200 and got == want


def test_heartbeats_and_kv_events_reach_the_port_master(clusters):
    port = clusters[1]
    agent = port.agents[0]
    mgr = port.master.scheduler.instance_mgr
    kvm = port.master.scheduler.kvcache_mgr
    prompt = "a prompt long enough to fill two hash blocks " * 3
    status, _, _ = port.call("POST", "/v1/completions", {
        **GREEDY, "prompt": prompt, "max_tokens": 2})
    assert status == 200
    ids = port.master.scheduler.tokenizer.encode(prompt)
    assert wait_until(lambda: kvm.match(ids).scores.get(agent.name, 0)
                      >= len(ids) // 32, timeout=10)
    assert wait_until(lambda: mgr.get_load_infos()[agent.name].updated_ms,
                      timeout=10)
    assert mgr.get_instance_meta(agent.name).wire_formats[0] == "msgpack"
