"""Which gloo calls take CUDA tensors, probed on this machine's card.

    python -m xllm_service_tpu_torch.benchmarks.gloo_probe

Two ranks on one card share it, and NCCL refuses two ranks on one device,
so ranks that share a card talk through gloo, whose CUDA support is
narrower than its CPU support. For each call the port's collectives
might make (``parallel/multihost.py``) this script starts two ranks
(processes on ``cuda:0``, a gloo group over ``tcp://127.0.0.1`` with a
short timeout) that make the call on CUDA tensors in f32 and bf16 and
check its result. A call gloo does not take may kill the ranks (gloo's
send on a CUDA tensor aborts the process), so every call has its own pair.
It prints one JSON line per call and dtype (``{"call", "dtype",
"cuda_ok", "error"}``), then the card's name and power limit.
``parallel/multihost.py::GLOO_CUDA_CALLS`` records what it found; a call marked False there stages its CUDA tensors
through host memory on gloo. Without a card it raises.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys

import torch

CALLS = ("all_gather_into_tensor", "all_gather", "all_reduce", "broadcast",
         "send_recv")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _try(call: str, dtype: torch.dtype, rank: int, group) -> None:
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    x = torch.full((4, 8), float(rank + 1), dtype=dtype, device=dev)
    if call == "all_gather_into_tensor":
        out = torch.empty((8, 8), dtype=dtype, device=dev)
        dist.all_gather_into_tensor(out, x, group=group)
        assert out[:4].eq(1).all() and out[4:].eq(2).all()
    elif call == "all_gather":
        outs = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(outs, x, group=group)
        assert outs[0].eq(1).all() and outs[1].eq(2).all()
    elif call == "all_reduce":
        dist.all_reduce(x, group=group)
        assert x.eq(3).all()
    elif call == "broadcast":
        dist.broadcast(x, src=0, group=group)
        assert x.eq(1).all()
    elif call == "send_recv":
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, 1 - rank, group=group),
               dist.P2POp(dist.irecv, got, 1 - rank, group=group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        assert got.eq(2 - rank).all()
    torch.cuda.synchronize(dev)


def rank_main(call: str, rank: int, port: int) -> int:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    torch.cuda.set_device(0)
    for name, dtype in DTYPES.items():
        try:
            _try(call, dtype, rank, None)
            rec = {"call": call, "dtype": name, "cuda_ok": True, "error": ""}
        except Exception as e:  # noqa: BLE001 — the probe's finding
            rec = {"call": call, "dtype": name, "cuda_ok": False,
                   "error": f"{type(e).__name__}: {str(e)[:200]}"}
        if rank == 0:
            print(json.dumps(rec), flush=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    from ..common.device import card_line
    from ..common.net import pick_free_port

    if not torch.cuda.is_available():
        raise RuntimeError("gloo_probe needs a CUDA card")
    for call in CALLS:
        port = pick_free_port("127.0.0.1")
        cmd = [sys.executable, "-m", __spec__.name, "--rank", call]
        procs = [subprocess.Popen(cmd + [str(r), str(port)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")]
        print("\n".join(lines), flush=True)
        if any(p.returncode for p in procs):
            err = " | ".join(e.strip().splitlines()[-1] for _, e in outs
                             if e.strip())
            print(json.dumps({"call": call, "dtype": "the rest",
                              "cuda_ok": False,
                              "error": f"ranks exited "
                                       f"{[p.returncode for p in procs]}: "
                                       f"{err[:300]}"}), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(main())
