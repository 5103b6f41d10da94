"""Multi-device dry run of the port's mesh (the serving steps of the
reference's ``__graft_entry__.py::dryrun_multichip``), each held against
its unsharded run on the same inputs.

- **The sharded decode step** over ``data x model``: a one-layer f32
  llama whose heads cover the model axis, its tree through
  ``shard_params`` with ``LLAMA_STACKED_RULES`` and its pool head-sharded
  (``ModelShardedPages``), one ``decode_forward`` against the unsharded
  tree and pool.
- **The expert-parallel MoE decode** over ``expert x model``: the tiny
  deepseek_moe config, its tree through ``MOE_STACKED_RULES``.
- **Ring attention** over ``seq`` against the dense causal attention, and
  **context-parallel paged decode** over the same axis against the
  single-pool attention.
- **The decode step over ``seq x model``**: the llama step of the first
  part on ``seq=2 x model`` (``n / 2`` model shards), its pool the
  page-and-head grid (a ``ModelShardedPages`` of ``ShardedPages``), so
  every model shard runs the context-parallel op at its heads.

``northstar`` takes the reference's north-star axis sizes (``model=8``,
``expert=8`` with 16 experts, ``seq=8``) where it takes 4 or 2 otherwise,
so mesh arithmetic that only breaks past an axis of 4 (head, expert and
page divisibility, ring step counts) fails here. The devices are the
caller's and may repeat (``cuda:0`` eight times on a one-card machine).
The reference's train step (loss, gradients and an optimizer update) is
training work the port does not have.

    python -m xllm_service_tpu_torch.parallel.dryrun --device cpu
    python -m xllm_service_tpu_torch.parallel.dryrun --northstar
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence, Union

import torch

from ..common.device import resolve_device
from .mesh import AXIS_SEQ, MeshConfig, build_mesh
from .sharding import ModelShardedPages, shard_params

# f32 throughout: the sharded and unsharded runs differ only in summation
# order (partials summed over the model axis, flash statistics merged over
# the seq axis), about 1e-6 of values of order 1.
TOL = 1e-4


def _check(name: str, got: torch.Tensor, want: torch.Tensor,
           results: dict) -> None:
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    results[name] = err
    if not err <= TOL * max(1.0, want.abs().max().item()):
        raise AssertionError(f"dryrun {name}: max |err| {err} over {TOL}")


def _pool(cfg, pages: int, ps: int, device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((cfg.num_layers, 2, pages, cfg.num_kv_heads, ps,
                        cfg.head_dim), generator=gen).to(device)


def _decode(family, cfg, params, kv, B: int, device) -> torch.Tensor:
    tokens = torch.arange(B, dtype=torch.int32, device=device) * 7 + 1
    positions = torch.full((B,), 40, dtype=torch.int32, device=device)
    pt = (torch.arange(B * 4, dtype=torch.int32, device=device)
          .reshape(B, 4) + 1)
    clens = positions + 1
    return family.decode_forward(params, cfg, tokens, positions, kv, pt,
                                 clens)[0]


def _sharded_decode(family, cfg, params, rules, mesh, B, device, seed,
                    results, name, pages: Optional[int] = None) -> None:
    """One decode step of ``params`` unsharded and sharded over ``mesh``
    from the same pool of ``pages`` pages (``4 * B + 1`` by default)."""
    from ..ops.page_dma import scatter_kv_pages

    full = _pool(cfg, pages or 4 * B + 1, 16, device, seed)
    ref_pool = full.clone()
    want = _decode(family, cfg, params, ref_pool, B, device)
    sharded = ModelShardedPages.zeros(full.shape, full.dtype, mesh)
    scatter_kv_pages(sharded, range(full.shape[2]), full)
    got = _decode(family, cfg, shard_params(params, mesh, rules), sharded,
                  B, device)
    _check(name, got, want, results)
    # Each shard wrote its heads' new K/V as the unsharded step did.
    _check(f"{name}_pool", sharded.full(), ref_pool, results)


def dryrun(devices: Sequence[Union[str, torch.device]],
           northstar: bool = False) -> dict:
    """The dry run over ``devices`` (their count, n, sizes the meshes);
    returns each part's max |sharded - unsharded| and raises where one
    exceeds ``TOL``."""
    from ..models import deepseek_moe
    from ..models.base import ModelConfig, get_model_family
    from ..ops.attention import dense_prefill_attention
    from ..ops.cp_paged_attention import cp_paged_attention
    from ..ops.paged_attention import paged_attention
    from ..ops.ring_attention import ring_attention

    devs = [torch.device(d) for d in devices]
    n = len(devs)
    dev = devs[0]
    results: dict = {}
    if northstar:
        if n % 8:
            raise ValueError("north-star axes need a multiple of 8 devices")
        tp = 8
    else:
        tp = next((c for c in (4, 2) if n % c == 0), 1)

    # The sharded decode step over data x model.
    fam = get_model_family("llama")
    cfg = ModelConfig(vocab_size=256, hidden_size=128, num_layers=1,
                      num_heads=max(4, tp), num_kv_heads=max(4, tp),
                      head_dim=32, ffn_size=256, max_context_len=256,
                      dtype=torch.float32)
    params = fam.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    mesh = build_mesh(MeshConfig(data=n // tp, model=tp), devs)
    _sharded_decode(fam, cfg, params, fam.sharding_rules, mesh,
                    2 * (n // tp), dev, 1, results, "decode")
    results["decode_mesh"] = dict(mesh.shape)

    if n >= 2:
        # The expert-parallel MoE decode over expert x model.
        moe = get_model_family("deepseek_moe")
        if northstar:
            ep = 8
            moe_tp = 1
            while moe_tp * 2 <= min(8, n // ep):
                moe_tp *= 2
            mcfg = deepseek_moe.tiny_moe_config(
                num_heads=8, num_kv_heads=8, num_experts=16,
                dtype=torch.float32)
        else:
            ep = 4 if n % 4 == 0 else 2
            moe_tp = max(1, n // ep)
            mcfg = deepseek_moe.tiny_moe_config(dtype=torch.float32)
        moe_mesh = build_mesh(MeshConfig(expert=ep, model=moe_tp),
                              devs[:ep * moe_tp])
        mparams = moe.init_params(
            mcfg, torch.Generator(device=dev).manual_seed(1), dev)
        _sharded_decode(moe, mcfg, mparams, moe.sharding_rules, moe_mesh, 4,
                        dev, 2, results, "moe_decode")
        results["moe_mesh"] = dict(moe_mesh.shape)

        # Ring attention and context-parallel paged decode over seq.
        sp = 8 if northstar else (4 if n % 4 == 0 else 2)
        seq_mesh = build_mesh(MeshConfig(seq=sp), devs[:sp])
        gen = torch.Generator(device="cpu").manual_seed(3)
        q, k, v = (torch.randn((1, 16 * sp, 2, 32), generator=gen).to(dev)
                   for _ in range(3))
        zeros = torch.zeros((1,), dtype=torch.int32, device=dev)
        lens = torch.full((1,), 16 * sp, dtype=torch.int32, device=dev)
        _check("ring", ring_attention(q, k, v, seq_mesh),
               dense_prefill_attention(q, k, v, None, None, None, zeros,
                                       lens), results)
        pages = 4 * sp
        kp, vp = (torch.randn((pages, 2, 16, 32), generator=gen).to(dev)
                  for _ in range(2))
        qd = torch.randn((2, 4, 32), generator=gen).to(dev)
        ptd = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
        clens = torch.tensor([30, 50], dtype=torch.int32, device=dev)
        k_sh = [c.contiguous() for c in kp.chunk(sp)]
        v_sh = [c.contiguous() for c in vp.chunk(sp)]
        _check("cp_decode",
               cp_paged_attention(qd, k_sh, v_sh, ptd, clens, seq_mesh,
                                  AXIS_SEQ),
               paged_attention(qd, kp, vp, ptd, clens), results)
        results["seq_axis"] = sp

    if n >= 4:
        # The decode step over seq x model: the grid pool.
        gm = max(2, tp // 2)
        grid = build_mesh(MeshConfig(seq=2, model=gm), devs[:2 * gm])
        _sharded_decode(fam, cfg, params, fam.sharding_rules, grid, 2, dev,
                        4, results, "seq_model_decode", pages=10)
        results["seq_model_mesh"] = dict(grid.shape)
    return results


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device, repeated --n times (default: cuda)")
    p.add_argument("--n", type=int, default=8, help="mesh devices")
    p.add_argument("--northstar", action="store_true",
                   help="the north-star axis sizes (model, expert, seq 8)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps(dryrun([dev] * args.n, northstar=args.northstar)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
