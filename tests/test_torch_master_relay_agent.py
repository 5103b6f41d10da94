"""The relay between masters with a port agent on the JAX engine's tiny f32
llama, on the CPU: the same drill on a pair of JAX masters and on a pair
of port masters, each with one port ``EngineAgent``.

- A request accepted by the frontend that does not own it, whole and
  streamed, is relayed and served by its owner: the same body and SSE
  frames (but for ids and timestamps) as the owner's direct answer, and
  the same under both packages.
- The owner killed mid-stream: the stream completes through the survivor
  with the frames of a direct stream, none duplicated or missing (greedy
  tokens), under both packages. The survivor re-dispatches the request
  under its id while the dead owner's incarnation still runs on the
  agent, which ends that incarnation first (``EngineAgent._supersede``):
  the dead owner's undeliverable deltas then cancel nothing of the new
  one.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models.base import tiny_config as ref_tiny

from test_torch_master_e2e import port_agent
from test_torch_master_multimaster import PKGS, both, key_owned_by
from test_torch_master_multimaster import Call, FAST, Plane

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

PROMPT = [5, 7, 9, 11, 13, 17, 19, 23]
GREEDY = dict(model="tiny-llama", temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def tree():
    return ref_llama.init_params(ref_tiny(dtype=jnp.float32,
                                          max_context_len=256),
                                 jax.random.PRNGKey(0))


class AgentPlane(Plane):
    """Two masters of one package and one port agent on ``tree``."""

    def __init__(self, P, tree):
        self.tree = tree
        super().__init__(P, engines=({},))

    def engine(self, **kw):
        return port_agent(self.coord(), self.tree).start()


def _call(m, okey, stream, n, **kw):
    body = {**GREEDY, "prompt": PROMPT, "max_tokens": n, "stream": stream,
            "ownership_key": okey}
    return Call(m.http_port, "/v1/completions", body, **kw)


def drill(P, tree):
    pl = AgentPlane(P, tree)
    try:
        m1, m2 = pl.masters
        agent = pl.engines[0]
        okey = key_owned_by(m1.scheduler.ownership, m2.scheduler.self_addr)
        fwd = P.metrics.HANDOFF_FORWARDED_TOTAL
        rec = P.metrics.HANDOFF_RECOVERIES_TOTAL
        f0 = fwd.value()
        out = {}
        for stream in (False, True):
            relayed = _call(m1, okey, stream, 16)
            direct = _call(m2, okey, stream, 16)
            assert relayed.status == direct.status == 200
            assert relayed.normalized() == direct.normalized()
            out["stream" if stream else "whole"] = relayed.normalized()
        out["forwarded"] = fwd.value() - f0
        want = _call(m2, okey, True, 64)
        # Slow the agent's deltas so the owner dies mid-stream.
        push = agent.streamer.push

        def slowed(dest, o):
            import time

            time.sleep(0.02)
            push(dest, o)
        agent.streamer.push = slowed
        r0 = rec.value()
        got = _call(m1, okey, True, 64, after=3, hook=lambda: pl.kill(m2))
        agent.streamer.push = push
        out["recovered"] = rec.value() - r0 >= 1
        out["killed"] = got.normalized() == want.normalized()
        out["killed_frames"] = len(got.frames)
        out["text"] = got.text()
        return out
    finally:
        pl.close()


def test_relay_and_owner_death_with_a_port_agent(tree):
    out = both(lambda P: drill(P, tree))
    assert out["forwarded"] == 2 and out["recovered"] and out["killed"]
    text, finishes, errors = out["text"]
    assert finishes == ["length"] and not errors
    # The owner died after three of the stream's frames.
    assert out["killed_frames"] > 4
