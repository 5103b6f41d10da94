"""CUDA compile gate (twin of ``benchmarks/compile_gate.py``): build every
library of ``ops/_build.py`` and launch each kernel arm once at the bench-1b
serving shapes, BEFORE any timing step runs.

    python -m xllm_service_tpu_torch.benchmarks.compile_gate

A build that ``nvcc`` rejects or a launch that fails becomes a named
verdict in one JSON line instead of a crash mid-run:

    {"metric": "cuda_compile_gate", "backend": "cuda",
     "arms": {"paged_default": {"ok": true, "build_s": 41.2}, ...},
     "failed_arms": ["..."], "error": "..."?}

The arms are the six kernels: kernel 1 (paged decode) at the bench-1b
decode shape, at head dim 256 with Gemma-2's softcap and a window, and
both routes of ``csrc/split_routes.cu`` (``mma`` and ``fma``) at head dim
256; kernel 2 at the speculative verify's block (Sq 5) and the 128-row
prefill chunk; kernel 3 (fused append and attend); kernels 4 and 5 (the
page movers) at a hash block of the bench-1b pool; kernel 6 (a seq shard's
partial statistics) on shard 0 of two. ``build_s`` is the wall time of the
arm's library build (every library builds at once, one ``nvcc`` each); an
arm's launch must finish with finite values.

Without a card nothing is built or launched: the line says ``"backend":
"cpu"``, names the arms and carries no verdict (a plain version run on
the CPU is no verdict on a kernel).
"""

from __future__ import annotations

import ctypes
import json
import threading
import time
from typing import Callable, Optional

#: arm -> the library of ``ops/_build.py`` it launches from.
ARMS = {
    "paged_default": "paged_attention",
    "paged_hd256_softcap_window": "paged_attention",
    "split_route_mma": "split_routes",
    "split_route_fma": "split_routes",
    "mq_verify_k4": "mq_paged_attention",
    "mq_prefill_s128": "mq_paged_attention",
    "fused_writeback": "fused_decode_attention",
    "page_gather": "page_dma",
    "page_scatter": "page_dma",
    "cp_partial_stats": "cp_paged_partial",
}
LIBRARIES = sorted(set(ARMS.values()))


def _finite(*ts) -> None:
    import torch

    for t in ts:
        if not bool(torch.isfinite(t.float()).all()):
            raise RuntimeError("the launch left non-finite values")


def _arm_thunks() -> dict[str, Callable[[], None]]:
    """name -> a thunk that launches that arm once on the card (raises on
    a failed launch or a non-finite result)."""
    import torch

    from ..models.base import bench_1b_config
    from ..ops import _build, page_dma
    from ..ops.cp_paged_attention import compact_local_table, paged_partial
    from ..ops.fused_decode_attention import fused_decode_attention
    from ..ops.mq_paged_attention import mq_paged_attention
    from ..ops.paged_attention import paged_attention

    mcfg = bench_1b_config()
    B, ps, max_seq = 16, 16, 1024
    n_q, n_kv, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    max_pages = max_seq // ps
    dev, bf16, i32 = "cuda", torch.bfloat16, torch.int32
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    def table(b, mp):
        return (torch.arange(b * mp, dtype=i32, device=dev)
                .reshape(b, mp) + 1)

    def decode_operands(b, mp, q_heads, kv_heads, dim):
        return (randn(b, q_heads, dim), randn(b * mp + 1, kv_heads, ps, dim),
                randn(b * mp + 1, kv_heads, ps, dim), table(b, mp),
                torch.full((b,), mp * ps - 3, dtype=i32, device=dev))

    def paged(**opts):
        q, k, v, pt, cl = decode_operands(B, max_pages, n_q, n_kv, hd)
        return lambda: _finite(paged_attention(q, k, v, pt, cl, **opts))

    def hd256(**opts):
        q, k, v, pt, cl = decode_operands(8, 64, 16, 8, 256)
        return lambda: _finite(paged_attention(q, k, v, pt, cl, **opts))

    def split_route(route):
        def thunk():
            from .hd256_routes import N_KV, N_Q, ROUTES, inputs, route_call

            # As hd256_routes.run does: both routes' occupancy queries
            # first (each sets its kernel's shared-memory limit), then the
            # launch.
            query = _build.kernel_fn("split_routes",
                                     "split_routes_blocks_per_sm",
                                     [ctypes.c_int] * 2)
            for name, code in ROUTES.items():
                per_sm = query(N_Q // N_KV, code)
                if per_sm < 1:
                    raise RuntimeError(f"split_routes {name}: occupancy "
                                       f"query failed ({per_sm})")
            q, k, v, pt, cl = inputs(1024, 0)
            call, _ = route_call(route, q, k, v, pt, cl,
                                 torch.empty_like(q), {})
            _finite(call())
        return thunk

    def mq(s_q):
        def thunk():
            prefix = torch.full((B,), 512, dtype=i32, device=dev)
            blocks = torch.full((B,), s_q, dtype=i32, device=dev)
            mp = -(-(512 + s_q) // ps)
            k = randn(B * mp + 1, n_kv, ps, hd)
            v = randn(B * mp + 1, n_kv, ps, hd)
            _finite(mq_paged_attention(randn(B, s_q, n_q, hd), k, v,
                                       table(B, mp), prefix, blocks))
        return thunk

    def fused():
        q, k, v, pt, cl = decode_operands(B, max_pages, n_q, n_kv, hd)
        out, _, _ = fused_decode_attention(q, randn(B, n_kv, hd),
                                           randn(B, n_kv, hd), k, v, pt, cl)
        _finite(out)

    layers = mcfg.num_layers
    block_ids = list(range(1, 1 + 128 // ps))      # one 128-token block

    def movers(which):
        def thunk():
            kv = torch.zeros((layers, 2, 128 + 1, n_kv, ps, hd), dtype=bf16,
                             device=dev)
            block = randn(layers, 2, len(block_ids), n_kv, ps, hd)
            if which == "scatter":
                page_dma.scatter_kv_pages(kv, block_ids, block)
                if not torch.equal(kv[:, :, block_ids], block):
                    raise RuntimeError("the scatter wrote other bytes")
            else:
                kv[:, :, block_ids] = block
                if not torch.equal(page_dma.gather_kv_pages(kv, block_ids),
                                   block):
                    raise RuntimeError("the gather read other bytes")
        return thunk

    def cp_partial():
        q, k, v, pt, cl = decode_operands(B, max_pages, n_q, n_kv, hd)
        per = k.shape[0] // 2                      # shard 0 of two
        lp, st, nl = compact_local_table(pt, cl, 0, per, ps)
        _, l_, acc = paged_partial(q, k[:per], v[:per], lp, st, nl, cl,
                                   shards=2)
        _finite(l_, acc)

    return {
        "paged_default": paged(),
        "paged_hd256_softcap_window": hd256(softcap=50.0, scale=1 / 16,
                                            window=300),
        "split_route_mma": split_route("mma"),
        "split_route_fma": split_route("fma"),
        "mq_verify_k4": mq(5),
        "mq_prefill_s128": mq(128),
        "fused_writeback": fused,
        "page_gather": movers("gather"),
        "page_scatter": movers("scatter"),
        "cp_partial_stats": cp_partial,
    }


def _build_all(logs: Optional[dict]) -> dict[str, dict]:
    """Every library built at once (one ``nvcc`` each): ``{library:
    {"build_s", "error"?}}``; with ``logs``, ptxas's report of each
    library built now goes there by name."""
    from ..ops import _build

    out: dict[str, dict] = {}

    def one(name: str) -> None:
        t0 = time.perf_counter()
        try:
            built = _build.build([name], verbose=logs is not None)
            if logs is not None:
                logs.update(built)
            out[name] = {"build_s": round(time.perf_counter() - t0, 1)}
        except Exception as e:  # noqa: BLE001 — the verdict IS the point
            out[name] = {"build_s": round(time.perf_counter() - t0, 1),
                         "error": f"{type(e).__name__}: {e}"[:300]}

    threads = [threading.Thread(target=one, args=(n,)) for n in LIBRARIES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def run_gate(logs: Optional[dict] = None) -> dict:
    """The gate's line (see the module docstring); ``logs`` collects the
    compiler output of the libraries built now."""
    import torch

    if not torch.cuda.is_available():
        return {"metric": "cuda_compile_gate", "backend": "cpu",
                "arms": {}, "arm_names": list(ARMS),
                "error": "no CUDA card: nothing was built or launched"}
    builds = _build_all(logs)
    try:
        # Materialize the arms first: a kernel module's ImportError is
        # exactly the breakage the gate exists to name.
        thunks = _arm_thunks()
    except Exception as e:  # noqa: BLE001 — import/setup failure
        return {"metric": "cuda_compile_gate", "backend": "cuda",
                "arms": {}, "failed_arms": list(ARMS),
                "error": f"arm setup failed: {type(e).__name__}: {e}"[:400]}
    arms: dict[str, dict] = {}
    failed = []
    for name, lib in ARMS.items():
        verdict = {"build_s": builds[lib]["build_s"]}
        err = builds[lib].get("error")
        if err is None:
            try:
                thunks[name]()
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 — a launch verdict
                err = f"{type(e).__name__}: {e}"[:300]
        verdict["ok"] = err is None
        if err is not None:
            verdict["error"] = err
            failed.append(name)
        arms[name] = verdict
    out = {"metric": "cuda_compile_gate", "backend": "cuda", "arms": arms,
           "failed_arms": failed}
    if failed:
        out["error"] = f"{len(failed)} arm(s) failed to build or launch"
    return out


def main() -> int:
    out = run_gate()
    print(json.dumps(out))
    return 0 if out["backend"] == "cuda" and not out.get("failed_arms") \
        else 1


if __name__ == "__main__":
    raise SystemExit(main())
