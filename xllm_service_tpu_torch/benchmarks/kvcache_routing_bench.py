"""Cache-aware routing data-plane benchmark of the port (twin of the
repository's ``benchmarks/kvcache_routing_bench.py``), measurement rounds
interleaved so CPU drift can't masquerade as speedup:

1. **Prefix-index match**: the pre-optimisation index (coarse lock
   around a flat hex-string dict, per-match chained hashing in a Python
   per-slice loop, per-block ``getattr`` tier scoring — kept verbatim
   below as :class:`LegacyKVCacheIndex`) against the port's lock-free
   radix index (``scheduler/global_kvcache_mgr.py``), single-threaded
   and at N threads.
2. **Chained block hashing**: the old per-slice hashlib loop against the
   port's ``common/hashing.py`` (one-shot conversion, and
   ``libblockhash`` built from ``csrc/blockhash.c`` when a C compiler is
   there).
3. **Routed TTFT** (``--routed``): the ``master_hotpath_bench`` twin's
   multiproc harness driven under RR and CAR on the port's processes.

    python -m xllm_service_tpu_torch.benchmarks.kvcache_routing_bench
    python -m xllm_service_tpu_torch.benchmarks.kvcache_routing_bench --routed
    python -m xllm_service_tpu_torch.benchmarks.kvcache_routing_bench --quick

``--quick`` (not in the reference) is 2 instances x 10,000 blocks, 32
prompts, two rounds, and a hashing leg of 40 prompts x 2 rounds.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import threading
import time

import numpy as np

from ..common.hashing import native_available, prefix_block_hashes
from ..common.types import KvCacheEvent
from ..coordination.memory import InMemoryCoordination, MemoryStore
from ..devtools.locks import make_lock
from ..scheduler.global_kvcache_mgr import GlobalKVCacheMgr
from .stack import percentile

BLOCK = 128

QUICK = dict(instances=2, blocks=10_000, prompts=32, rounds=2,
             hash_iters=40, hash_rounds=2)


# --------------------------------------------------------------------------
# Pre-optimisation implementation, kept verbatim in shape: flat hex dict
# under one lock, per-match per-slice hashing, getattr tier walk. This is
# the "before" side of every index comparison.
# --------------------------------------------------------------------------

LEGACY_TIER_WEIGHTS = {"hbm": 1.0, "dram": 0.6, "ssd": 0.3}
_SEED = b"xllm-service-tpu"


def _legacy_hash_block(prev: bytes, token_ids) -> bytes:
    key = prev if prev else _SEED
    h = hashlib.blake2b(digest_size=16, key=key)
    h.update(np.asarray(token_ids, dtype=np.int32).tobytes())
    return h.digest()


def legacy_prefix_block_hash_hexes(token_ids, block_size=BLOCK) -> list[str]:
    arr = np.asarray(token_ids, dtype=np.int32)
    n_blocks = len(arr) // block_size
    out, prev = [], b""
    for i in range(n_blocks):
        prev = _legacy_hash_block(prev, arr[i * block_size:(i + 1) * block_size])
        out.append(prev)
    return [h.hex() for h in out]


class _LegacyLocations:
    __slots__ = ("hbm", "dram", "ssd")

    def __init__(self):
        self.hbm: set[str] = set()
        self.dram: set[str] = set()
        self.ssd: set[str] = set()

    def empty(self):
        return not (self.hbm or self.dram or self.ssd)

    def remove_instance(self, name):
        self.hbm.discard(name)
        self.dram.discard(name)
        self.ssd.discard(name)


class LegacyKVCacheIndex:
    """The pre-optimisation GlobalKVCacheMgr core (coordination sync
    stripped)."""

    def __init__(self, block_size=BLOCK):
        self._block_size = block_size
        self._lock = make_lock("bench.legacy_kvcache", order=890)  # lock-order: 890
        self._cache: dict[str, _LegacyLocations] = {}
        self._dirty: set[str] = set()
        self._removed: set[str] = set()

    def match(self, token_ids):
        hashes = legacy_prefix_block_hash_hexes(token_ids, self._block_size)
        scores: dict[str, float] = {}
        with self._lock:
            for h in hashes:
                loc = self._cache.get(h)
                if loc is None or loc.empty():
                    break
                for tier, weight in LEGACY_TIER_WEIGHTS.items():
                    for inst in getattr(loc, tier):
                        scores[inst] = scores.get(inst, 0.0) + weight
        return scores

    def record_updated_kvcaches(self, instance, stored_hexes):
        with self._lock:
            for h in stored_hexes:
                loc = self._cache.setdefault(h, _LegacyLocations())
                loc.hbm.add(instance)
                loc.dram.discard(instance)
                loc.ssd.discard(instance)
                self._dirty.add(h)

    def remove_instance(self, instance):
        with self._lock:
            dead = []
            for h, loc in self._cache.items():
                before = (len(loc.hbm), len(loc.dram), len(loc.ssd))
                loc.remove_instance(instance)
                if (len(loc.hbm), len(loc.dram), len(loc.ssd)) != before:
                    if loc.empty():
                        dead.append(h)
                    else:
                        self._dirty.add(h)
            for h in dead:
                del self._cache[h]
                self._removed.add(h)
                self._dirty.discard(h)


# --------------------------------------------------------------------------
# Workload
# --------------------------------------------------------------------------

def make_workload(n_instances, blocks_per_instance, n_prompts, chain_len,
                  seed=0):
    """Synthetic fleet state + match traffic.

    - ``n_prompts`` prompts of ``chain_len`` full blocks; 75% of their
      chains are stored (each on 1-3 instances), 25% miss at block 0.
    - Filler keys pad every instance to ``blocks_per_instance`` owned
      blocks (the realistic case: the index is much bigger than any one
      prompt's chain).
    """
    rng = np.random.default_rng(seed)
    instances = [f"inst-{i}:8000" for i in range(n_instances)]
    prompts, prompt_hashes, stored_flags = [], [], []
    per_instance_keys: dict[str, list[bytes]] = {n: [] for n in instances}
    for p in range(n_prompts):
        toks = ((np.arange(chain_len * BLOCK, dtype=np.int64) * 131 + p * 7919)
                % 50000).astype(np.int32).tolist()
        chain = prefix_block_hashes(toks, BLOCK)
        prompts.append(toks)
        prompt_hashes.append(chain)
        hit = (p % 4) != 3
        stored_flags.append(hit)
        if hit:
            for k in range(1 + p % 3):
                per_instance_keys[instances[(p + k) % n_instances]].extend(chain)
    for name in instances:
        deficit = blocks_per_instance - len(per_instance_keys[name])
        if deficit > 0:
            blob = rng.bytes(16 * deficit)
            per_instance_keys[name].extend(
                blob[i * 16:(i + 1) * 16] for i in range(deficit))
    return instances, per_instance_keys, prompts, prompt_hashes, stored_flags


def _timed_matches(fn, work, rounds, threads):
    """Run `fn(item)` over `work` `rounds` times on `threads` threads;
    returns (throughput per s, latencies ms)."""
    lat_all: list[float] = []
    lock = threading.Lock()  # xlint: allow-local-lock(the drive's result lists; its workers join before it returns)
    total = [0]

    def worker(items):
        lats = []
        pc = time.perf_counter
        for it in items:
            t0 = pc()
            fn(it)
            lats.append((pc() - t0) * 1000)
        with lock:
            lat_all.extend(lats)
            total[0] += len(items)

    items = work * rounds
    shards = [items[i::threads] for i in range(threads)]
    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(s,)) for s in shards]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    return total[0] / wall if wall else 0.0, lat_all


def build_indexes(instances, per_keys):
    """Both indexes filled with the workload's keys, batched as
    heartbeat-sized events, interleaved new/legacy. Returns (the port's
    index, the legacy one, keys, ingest s new, ingest s legacy, the
    coordination client and store to close)."""
    store = MemoryStore()
    coord = InMemoryCoordination(store)
    new_mgr = GlobalKVCacheMgr(coord, block_size=BLOCK, is_master=True)
    legacy = LegacyKVCacheIndex(BLOCK)
    ingest_new_s = ingest_legacy_s = 0.0
    n_keys = 0
    for name in instances:
        keys = per_keys[name]
        n_keys += len(keys)
        for i in range(0, len(keys), 10_000):
            batch = keys[i:i + 10_000]
            t0 = time.perf_counter()
            new_mgr.record_updated_kvcaches(name, KvCacheEvent(stored=batch))
            ingest_new_s += time.perf_counter() - t0
            hexes = [b.hex() for b in batch]
            t0 = time.perf_counter()
            legacy.record_updated_kvcaches(name, hexes)
            ingest_legacy_s += time.perf_counter() - t0
    return (new_mgr, legacy, n_keys, ingest_new_s, ingest_legacy_s, coord,
            store)


def run_index_bench(n_instances=8, blocks_per_instance=100_000,
                    n_prompts=256, chain_len=32, threads=4, rounds=4,
                    seed=0):
    (instances, per_keys, prompts, prompt_hashes, _flags) = make_workload(
        n_instances, blocks_per_instance, n_prompts, chain_len, seed)
    (new_mgr, legacy, n_keys, ingest_new_s, ingest_legacy_s, coord,
     store) = build_indexes(instances, per_keys)

    # Match throughput, interleaved rounds: legacy hashes per call (that
    # IS its hot path); new walks the memoized chain (hashed once per
    # request at tokenize — Request.prefix_hashes).
    def legacy_match(i):
        legacy.match(prompts[i])

    def new_match(i):
        new_mgr.match(block_hashes=prompt_hashes[i])

    def new_match_rehash(i):
        new_mgr.match(prompts[i])

    idx = list(range(len(prompts)))
    report = {"config": {
        "instances": n_instances, "blocks_per_instance": blocks_per_instance,
        "total_keys_ingested": n_keys, "index_blocks": new_mgr.num_blocks(),
        "prompts": len(prompts), "chain_len_blocks": chain_len,
        "threads": threads, "rounds": rounds,
        "native_hash": native_available(),
    }}
    for label, fn in (("legacy", legacy_match), ("new", new_match),
                      ("new_rehash", new_match_rehash)):
        tput1, lat1 = _timed_matches(fn, idx, rounds, 1)
        tputN, latN = _timed_matches(fn, idx, rounds, threads)
        report[f"match_{label}"] = {
            "throughput_1t_per_s": round(tput1, 1),
            f"throughput_{threads}t_per_s": round(tputN, 1),
            "p50_ms": round(percentile(lat1, 50), 4),
            "p99_ms": round(percentile(lat1, 99), 4),
            f"p99_{threads}t_ms": round(percentile(latN, 99), 4),
        }
    t_key = f"throughput_{threads}t_per_s"
    report["match_speedup_1t"] = round(
        report["match_new"]["throughput_1t_per_s"]
        / max(report["match_legacy"]["throughput_1t_per_s"], 1e-9), 2)
    report[f"match_speedup_{threads}t"] = round(
        report["match_new"][t_key]
        / max(report["match_legacy"][t_key], 1e-9), 2)
    report["ingest_new_keys_per_s"] = round(n_keys / max(ingest_new_s, 1e-9))
    report["ingest_legacy_keys_per_s"] = round(
        n_keys / max(ingest_legacy_s, 1e-9))

    # Eviction: legacy walks the whole index; new touches only the dead
    # instance's reverse-index entry.
    victim = instances[0]
    t0 = time.perf_counter()
    new_mgr.remove_instance(victim)
    report["remove_instance_new_ms"] = round(
        (time.perf_counter() - t0) * 1000, 3)
    t0 = time.perf_counter()
    legacy.remove_instance(victim)
    report["remove_instance_legacy_ms"] = round(
        (time.perf_counter() - t0) * 1000, 3)

    coord.close()
    store.close()
    return report


def run_hashing_bench(prompt_tokens=4096, iters=400, rounds=5):
    """Old per-slice loop vs shipped hashing, interleaved."""
    toks = list(range(prompt_tokens))
    t_old = t_new = 0.0
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            legacy_prefix_block_hash_hexes(toks, BLOCK)
        t_old += time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            prefix_block_hashes(toks, BLOCK)
        t_new += time.perf_counter() - t0
    n = iters * rounds
    return {
        "prompt_tokens": prompt_tokens,
        "native_hash": native_available(),
        "old_us_per_prompt": round(t_old / n * 1e6, 1),
        "new_us_per_prompt": round(t_new / n * 1e6, 1),
        "speedup": round(t_old / max(t_new, 1e-12), 2),
    }


def run_routed_bench(requests_n=192, concurrency=8):
    """CAR vs RR client TTFT through the master_hotpath_bench twin."""
    from .master_hotpath_bench import run_bench
    out = {}
    for policy in ("RR", "CAR"):
        r = run_bench(requests_n=requests_n, concurrency=concurrency,
                      prompt_chars=1024, max_tokens=8, reply_chars=32,
                      policy=policy, n_engines=2)
        out[policy] = {
            "ttft_ms": r["master_wire_ttft_ms"],
            "req_per_s": r["req_per_s"],
            "errors": r["errors"],
            "schedule_p50_ms": (r.get("master_stages_ms", {})
                                .get("schedule", {}).get("p50")),
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=100_000,
                    help="blocks per instance")
    ap.add_argument("--prompts", type=int, default=256)
    ap.add_argument("--chain-len", type=int, default=32,
                    help="full blocks per prompt (32 = 4096 tokens)")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--routed", action="store_true",
                    help="also run the CAR-vs-RR multiproc TTFT bench")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized: 2 instances x 10,000 blocks, 32 "
                         "prompts, 2 rounds, a short hashing leg")
    args = ap.parse_args(argv)
    hashing = {}
    if args.quick:
        args.instances, args.blocks = QUICK["instances"], QUICK["blocks"]
        args.prompts, args.rounds = QUICK["prompts"], QUICK["rounds"]
        hashing = dict(iters=QUICK["hash_iters"],
                       rounds=QUICK["hash_rounds"])
    report = {
        "index": run_index_bench(args.instances, args.blocks, args.prompts,
                                 args.chain_len, args.threads, args.rounds),
        "hashing": run_hashing_bench(**hashing),
    }
    if args.routed:
        report["routed_ttft"] = run_routed_bench()
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
