"""Tensor- and expert-parallel serving through the unchanged reference
master, on the CPU: the twins of tests/test_tp_serving.py and
tests/test_moe_pd.py with the port's agents.

Each cluster is a reference ``Master`` on its own ``InMemoryCoordination``
store. An agent's engine gets its mesh as ``InferenceEngine`` takes one
(``EngineAgent(mesh=...)``, ``cpu`` repeated: the CPU is one device, so a
mesh from ``--tp`` alone would need distinct devices), its config the one
``--tp 2`` parses to. All engines get the JAX engine's tiny f32 weights.
On the CPU the port has no device path, so every handoff rides a host
path: the canonical block in the reference's layout, which is what lets
a ``model=2`` prefill side hand off to an unmeshed decode side (the
reference's topology rule sends mismatched meshes there too).

Checked: a ``--tp 2`` MIX agent's text equals an unmeshed one's and it
advertises a two-device topology; a TP=2 PD pair and a TP=2 -> TP=1 pair
stream the MIX agent's tokens; an expert-parallel Mixtral PD pair on
``expert=2 x model=2`` (the EP-PD test's layout) streams its own MIX
agent's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xllm_service_tpu.models import llama as ref_llama
from xllm_service_tpu.models import mixtral as ref_mixtral
from xllm_service_tpu.models.base import tiny_config as ref_tiny
from xllm_service_tpu_torch.common.types import InstanceType
from xllm_service_tpu_torch.coordination.memory import InMemoryCoordination
from xllm_service_tpu_torch.engine import agent as port_agent
from xllm_service_tpu_torch.engine.agent import AgentConfig, EngineAgent
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh

from test_torch_gemma import drawn_tree, port_config
from test_torch_pd_e2e import BODY, ENGINE_KW, _Cluster

MOE_BODY = {**BODY, "model": "tiny-moe",
            "prompt": "route me through the experts"}


def _agent(store, tree, itype, mesh_axes=None, family=None, model_id=None):
    """A port agent whose engine config is the one ``--tp`` parses to
    (``tiny_f32``, or ``family``'s model), on a ``cpu`` mesh of
    ``mesh_axes``."""
    argv = ["--model-config", "tiny_f32", "--max-seq-len", "256",
            "--num-pages", "64", "--max-batch-size", "4"]
    if mesh_axes and set(mesh_axes) == {"model"}:
        argv += ["--tp", str(mesh_axes["model"])]
    ecfg = port_agent.engine_config(port_agent._parser().parse_args(argv))
    ecfg.hash_block_size = ENGINE_KW["hash_block_size"]
    if family is not None:
        ecfg.model = port_config(family)
        ecfg.model_family = family.name
    mesh = None
    if mesh_axes:
        cfg = MeshConfig(**mesh_axes)
        ecfg.mesh = cfg
        mesh = build_mesh(cfg, ["cpu"] * cfg.num_devices())
    return EngineAgent(
        ecfg,
        AgentConfig(host="127.0.0.1", model_id=model_id or "tiny-llama",
                    instance_type=itype, heartbeat_interval_s=0.3,
                    lease_ttl_s=1.0),
        coord=InMemoryCoordination(store), device="cpu",
        params=params_from_jax(tree, device="cpu"), mesh=mesh)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, ref_llama.init_params(
        ref_tiny(dtype=jnp.float32, max_context_len=256),
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def mix(tree):
    """An unmeshed MIX agent's (text, tokens) for BODY."""
    c = _Cluster(lambda s: _agent(s, tree, InstanceType.MIX))
    try:
        return c.serve()
    finally:
        c.stop()


def test_tp2_mix_agent_matches_unmeshed(tree, mix):
    c = _Cluster(lambda s: _agent(s, tree, InstanceType.MIX,
                                  dict(model=2)))
    try:
        a = c.agents[0]
        assert a.engine.mesh.shape["model"] == 2
        assert a.engine.cfg.mesh.shape == (1, 1, 1, 1, 2)
        meta = c.master.scheduler.instance_mgr.get_instance_meta(a.name)
        assert meta.topology.num_devices() == 2
        assert c.serve() == mix
    finally:
        c.stop()


@pytest.mark.parametrize("decode_axes", [dict(model=2), None],
                         ids=["tp2-tp2", "tp2-tp1"])
def test_tp2_pd_pair_matches_mix(tree, mix, decode_axes):
    """A TP=2 prefill side and a TP=2 or unmeshed decode side: the
    handoff rides the host path in the reference's layout, and the decode
    side streams the MIX agent's tokens."""
    c = _Cluster(lambda s: _agent(s, tree, InstanceType.PREFILL,
                                  dict(model=2)),
                 lambda s: _agent(s, tree, InstanceType.DECODE,
                                  decode_axes))
    try:
        pre, dec = c.agents
        assert c.serve() == mix
        assert pre.kv_host_sent == 1 and dec.kv_host_received == 1
        assert pre._same_mesh_topology(pre.linked_peers[dec.name]) == \
            (decode_axes is not None)
    finally:
        c.stop()


def test_ep_pd_pair_matches_ep_mix():
    """Mixtral on ``expert=2 x model=2`` (the reference's EP-PD layout): a
    PREFILL and a DECODE agent stream what a MIX agent on the same mesh
    and an unmeshed MIX agent stream."""
    rcfg = ref_mixtral.mixtral_tiny_config(dtype=jnp.float32,
                                           max_context_len=256)
    tree = drawn_tree(rcfg)
    axes = dict(expert=2, model=2)
    kw = dict(family=rcfg, model_id="tiny-moe")
    out = {}
    for name, makers in (
            ("mix", [lambda s: _agent(s, tree, InstanceType.MIX, **kw)]),
            ("ep_mix", [lambda s: _agent(s, tree, InstanceType.MIX, axes,
                                         **kw)]),
            ("ep_pd", [lambda s: _agent(s, tree, InstanceType.PREFILL,
                                        axes, **kw),
                       lambda s: _agent(s, tree, InstanceType.DECODE, axes,
                                        **kw)])):
        c = _Cluster(*makers)
        try:
            out[name] = c.serve(MOE_BODY)
            if name == "ep_pd":
                pre = c.agents[0]
                assert pre.engine.mesh.shape["expert"] == 2
                assert pre.kv_device_sent + pre.kv_host_sent == 1
        finally:
            c.stop()
    assert out["ep_pd"] == out["ep_mix"] == out["mix"]
    assert len(out["mix"][1]) == 6
