"""The dry run's train step (``parallel/train.py``) against the
reference's, rebuilt here from the reference's own functions exactly as
``__graft_entry__.py::dryrun_multichip`` writes it (its loss over
``xllm_service_tpu.models.llama._project_qkv`` and ``_mlp``,
``xllm_service_tpu.ops.attention.prefill_attention`` and ``rms_norm``; the
gradients; an ``optax.adamw(1e-4)`` update), on the same mesh: the
reference's on the virtual CPU devices of tests/conftest.py (its
parameters through ``shard_params``, its batch split over ``data``), the
port's on ``cpu`` repeated.

The weights are the reference's ``init_params`` for a one-process llama
small enough for the CPU (2 layers, hidden 64, 4 heads and 4 KV heads of
32, ffn 128, vocabulary 256, f32), carried across with
``params_from_jax``; the batch is 4 rows of 17 tokens drawn with numpy
from a seed. Three steps on that batch, unsharded, on ``data=2 x
model=2`` and on ``data=1 x model=4``: each step's loss and, after the
third, every updated leaf agree with the reference's within 1e-5
relative (of the leaf's largest magnitude). Every copy of a leaf
(replicated over ``model``, or over ``data``) is equal on every shard,
and the optimizer's settings are optax's ``adamw`` defaults.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from xllm_service_tpu.models.base import ModelConfig as RefConfig
from xllm_service_tpu.models.base import get_model_family as ref_family
from xllm_service_tpu.models.llama import (
    LLAMA_STACKED_RULES as REF_RULES,
    _mlp,
    _project_qkv,
)
from xllm_service_tpu.ops.attention import prefill_attention, rms_norm
from xllm_service_tpu.parallel.mesh import AXIS_DATA
from xllm_service_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from xllm_service_tpu.parallel.mesh import build_mesh as ref_build_mesh
from xllm_service_tpu.parallel.sharding import shard_params as ref_shard
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from xllm_service_tpu_torch.parallel.train import ADAMW, TrainState

import test_torch_gemma

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

RTOL = 1e-5
STEPS = 3
B, S = 4, 16
MESHES = {"unsharded": None, "data2_model2": dict(data=2, model=2),
          "data1_model4": dict(data=1, model=4)}


def ref_config():
    return RefConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, num_kv_heads=4, head_dim=32, ffn_size=128,
                     max_context_len=256, dtype=jnp.float32)


def drawn():
    cfg = ref_config()
    tree = jax.tree.map(np.asarray, ref_family("llama").init_params(
        cfg, jax.random.PRNGKey(0)))
    batch = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return cfg, tree, batch


def reference_steps(cfg, tree, batch, axes):
    """``__graft_entry__.py:141-174``'s train step, STEPS times on
    ``batch``: (losses, the updated tree as numpy)."""
    params = jax.tree.map(jnp.asarray, tree)
    if axes is not None:
        mcfg = RefMeshConfig(**axes)
        mesh = ref_build_mesh(mcfg, devices=jax.devices()[
            :mcfg.num_devices()])
        params = ref_shard(params, mesh, REF_RULES)
        tokens = jax.device_put(batch, NamedSharding(mesh,
                                                     P(AXIS_DATA, None)))
    else:
        mesh = None
        tokens = jnp.asarray(batch)
    opt = optax.adamw(1e-4)
    opt_state = jax.jit(opt.init)(params)

    def loss_fn(p, batch):
        inp, tgt = batch[:, :-1], batch[:, 1:]
        pos = jnp.broadcast_to(jnp.arange(S)[None, :], inp.shape)
        pt = jnp.zeros((B, 1), jnp.int32)
        x = p["embed"]["embedding"][inp].astype(cfg.dtype)

        def layer(x, lp):
            h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_eps)
            q, k, v = _project_qkv(lp, h, cfg, pos)
            attn = prefill_attention(
                q, k, v, None, None, pt,
                jnp.zeros((B,), jnp.int32),
                jnp.full((B,), S, jnp.int32))
            attn = attn.reshape(*attn.shape[:-2], cfg.q_size)
            x = x + jnp.einsum("...f,fd->...d", attn, lp["o_proj"]["kernel"])
            h2 = rms_norm(x, lp["post_attn_norm"]["scale"], cfg.rms_eps)
            x = x + _mlp(lp, h2, cfg)
            return x, None

        x, _ = jax.lax.scan(layer, x, p["layers"])
        x = rms_norm(x, p["final_norm"]["scale"], cfg.rms_eps)
        logits = jnp.einsum("...d,dv->...v", x, p["lm_head"]["kernel"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), tgt).mean()

    @jax.jit
    def train_step(p, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(p, batch)
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    losses = []
    if mesh is not None:
        with mesh:
            for _ in range(STEPS):
                params, opt_state, loss = train_step(params, opt_state,
                                                     tokens)
                losses.append(float(loss))
    else:
        for _ in range(STEPS):
            params, opt_state, loss = train_step(params, opt_state, tokens)
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def port_steps(cfg, tree, batch, axes):
    mesh = None
    if axes is not None:
        mcfg = MeshConfig(**axes)
        mesh = build_mesh(mcfg, ["cpu"] * mcfg.num_devices())
    state = TrainState(params_from_jax(tree, device="cpu"),
                       test_torch_gemma.port_config(cfg), mesh)
    losses = [state.step(torch.from_numpy(batch)).item()
              for _ in range(STEPS)]
    return losses, state


@pytest.fixture(scope="module")
def inputs():
    return drawn()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.mark.parametrize("name", sorted(MESHES))
def test_step_matches_reference(inputs, name):
    cfg, tree, batch = inputs
    axes = MESHES[name]
    want_losses, want = reference_steps(cfg, tree, batch, axes)
    losses, state = port_steps(cfg, tree, batch, axes)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=0)
    assert losses[-1] < losses[0]
    got = state.full()
    want = _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape, path
        err = np.abs(g - w).max()
        assert err <= RTOL * np.abs(w).max(), (path, err)
        # Every leaf moved.
        assert not np.array_equal(g, _flat(tree)[path]), path


@pytest.mark.parametrize("name", ["data2_model2", "data1_model4"])
def test_copies_of_a_slice_stay_equal(inputs, name):
    cfg, tree, batch = inputs
    _, state = port_steps(cfg, tree, batch, MESHES[name])
    axes = MESHES[name]
    n = axes["data"] * axes["model"]
    assert len(state.trees()) == n
    replicated = 0
    for group in state.groups:
        # A leaf held by several coordinates: replicated over model (the
        # norm scales) or over data.
        assert len(group) in (axes["data"], n)
        replicated += len(group) == n
        for leaf in group[1:]:
            assert leaf.data_ptr() != group[0].data_ptr()
            assert torch.equal(leaf, group[0])
    # The three norm scales are the leaves the rules replicate.
    assert replicated == 3


def test_optimizer_is_optax_adamw_defaults():
    sig = inspect.signature(optax.adamw).parameters
    want = dict(lr=1e-4, betas=(sig["b1"].default, sig["b2"].default),
                eps=sig["eps"].default,
                weight_decay=sig["weight_decay"].default)
    assert ADAMW == want
    cfg, tree, _ = drawn()
    state = TrainState(params_from_jax(tree, device="cpu"),
                       test_torch_gemma.port_config(cfg))
    for k, v in want.items():
        assert state.opt.defaults[k] == v, k
    assert len(state.opt.param_groups) == 1
    assert len(state.opt.param_groups[0]["params"]) == len(_flat(tree))
