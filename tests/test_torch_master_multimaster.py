"""Several active masters of the port against several JAX masters, on the
CPU: the drills of ``tests/test_multimaster.py`` run once on a pair of
JAX masters and once on a pair of port masters, each pair on its own
package's in-process coordination store with the reference's fake
engines, and the outcomes must be equal.

- The active-active plane: a request accepted by a frontend that does not
  own it is relayed to its owner and served there (one forward, one
  serve), an affinity key sticks to its owner, the relayed JSON body and
  SSE frames equal the owner's direct answer (but for ids and
  timestamps), mined ids serve locally, and a replica routes off mirrored
  state.
- An owner killed mid-stream (the owning frontend, or the elected master)
  completes the stream on the rendezvous successor with exactly the
  frames of the reply, a ``handoff_recovery`` record naming the
  successor, and the survivor takes the election key.
- A split brain demotes the old master, which stops publishing.
- The delta journal: a reconnect replays the exact frames without a
  re-run, and a detached stream keeps absorbing through its grace window.
- A mixed cluster: a JAX master and a port master on the port's
  coordination server relay to each other, and killing either one
  mid-stream completes the stream on the other.
"""

import http.client
import json
import threading
import time

import pytest
import torch

from xllm_service_tpu.testing.fake_engine import FakeEngine, FakeEngineConfig

from fakes import wait_until

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

REPLY = "Many masters, one owner per request; the stream never notices."
BLOCK = 16


class Pkg:
    """The modules of one package ("ref" or "port") a drill touches."""

    def __init__(self, which):
        self.which = which
        if which == "ref":
            from xllm_service_tpu import rpc
            from xllm_service_tpu.common import metrics
            from xllm_service_tpu.common.config import ServiceOptions
            from xllm_service_tpu.common.faults import FAULTS
            from xllm_service_tpu.common.flightrecorder import RECORDER
            from xllm_service_tpu.common.tracing import TRACER
            from xllm_service_tpu.common import types
            from xllm_service_tpu.coordination import client, memory, server
            from xllm_service_tpu.master import Master
            from xllm_service_tpu.rpc import wire
            from xllm_service_tpu.scheduler.global_kvcache_mgr import (
                GlobalKVCacheMgr,
            )
        else:
            from xllm_service_tpu_torch import rpc
            from xllm_service_tpu_torch.common import metrics
            from xllm_service_tpu_torch.common.config import ServiceOptions
            from xllm_service_tpu_torch.common.faults import FAULTS
            from xllm_service_tpu_torch.common.flightrecorder import RECORDER
            from xllm_service_tpu_torch.common.tracing import TRACER
            from xllm_service_tpu_torch.common import types
            from xllm_service_tpu_torch.coordination import (
                client,
                memory,
                server,
            )
            from xllm_service_tpu_torch.master import Master
            from xllm_service_tpu_torch.rpc import wire
            from xllm_service_tpu_torch.scheduler.global_kvcache_mgr import (
                GlobalKVCacheMgr,
            )
        self.rpc, self.metrics, self.types, self.wire = rpc, metrics, types, wire
        self.Options, self.Master = ServiceOptions, Master
        self.FAULTS, self.RECORDER, self.TRACER = FAULTS, RECORDER, TRACER
        self.memory, self.client, self.server = memory, client, server
        self.GlobalKVCacheMgr = GlobalKVCacheMgr


PKGS = {w: Pkg(w) for w in ("ref", "port")}

FAST = dict(
    host="127.0.0.1", http_port=0, rpc_port=0,
    lease_ttl_s=0.5, sync_interval_s=0.2, reconcile_interval_s=0.05,
    heartbeat_silence_to_suspect_s=0.3,
    detect_disconnected_instance_interval_s=0.3,
    health_probe_attempts=1, health_probe_timeout_s=0.2,
    failover_backoff_base_s=0.05, failover_backoff_max_s=0.3,
    rpc_backoff_base_s=0.02, rpc_backoff_max_s=0.1,
    # A killed master's connection may stay open but silent; the stall
    # deadline is what detects it. Short here so the drills converge fast.
    handoff_stall_timeout_s=1.5,
    # The fake engines' paced deltas breach the default TPOT objective, so
    # brownout would enter mid-drill and drop trace sampling to zero at a
    # moment set by the sync tick: whether a relay's root span exists
    # would then depend on timing. The drills read those spans.
    brownout_enabled=False)


class Plane:
    """Masters of one package on one in-process store, with fake engines.
    ``close()`` stops whatever is still up."""

    def __init__(self, P, n_masters=2, engines=({},), **opts):
        self.P = P
        self.store = P.memory.MemoryStore(expiry_tick_s=0.02)
        self.masters = [self.master(**opts) for _ in range(n_masters)]
        self.engines = [self.engine(**kw) for kw in engines]
        self.killers: list[threading.Thread] = []
        self.await_plane()

    def coord(self):
        return self.P.memory.InMemoryCoordination(self.store)

    def master(self, **kw):
        m = self.P.Master(self.P.Options(**{**FAST, **kw}),
                          coord=self.coord())
        m.start()
        return m

    def engine(self, delay_s=0.0, **kw):
        cfg = FakeEngineConfig(**{
            **dict(reply_text=REPLY, chunk_size=4, delay_s=delay_s,
                   heartbeat_interval_s=0.1, lease_ttl_s=0.5), **kw})
        return FakeEngine(self.coord(), cfg).start()

    def await_plane(self, masters=None):
        """Every frontend sees every engine and the whole membership."""
        masters = masters or self.masters
        addrs = {m.scheduler.self_addr for m in masters}
        assert wait_until(lambda: all(
            all(m.scheduler.instance_mgr.get_instance_meta(e.name)
                is not None for e in self.engines)
            and set(m.scheduler.ownership.members()) == addrs
            for m in masters), timeout=20)

    def kill(self, m):
        self.killers.append(m.kill())
        m._killed = True

    def close(self):
        for e in self.engines:
            e.stop()
        for m in self.masters:
            if not getattr(m, "_killed", False):
                m.stop()
        for t in self.killers:
            t.join(timeout=15)
        self.store.close()


def key_owned_by(router, addr):
    """A client-affinity key whose rendezvous owner is ``addr``."""
    for i in range(10000):
        k = f"affinity-{i}"
        if router.owner_of(k) == addr:
            return k
    raise AssertionError(f"no key owned by {addr} in 10k draws")


def scrub(obj):
    """Drop the random ids and wall-clock timestamps."""
    if isinstance(obj, dict):
        return {k: (None if k in ("id", "created") else scrub(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


class Call:
    """One request on ``http.client``, read as it arrives; ``hook`` runs
    once after ``after`` SSE data frames."""

    def __init__(self, port, path, body, after=0, hook=None, timeout=90):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        try:
            c.request("POST", path, body=json.dumps(body),
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            self.status = r.status
            self.headers = {k.lower(): v for k, v in r.getheaders()}
            self.frames, buf, fired = [], b"", False
            while True:
                piece = r.read1(1 << 16)
                if not piece:
                    break
                buf += piece
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    self.frames.append(frame + b"\n\n")
                    if hook is not None and not fired \
                            and len(self.frames) >= after:
                        fired = True
                        hook()
            self.body = b"".join(self.frames) + buf
        finally:
            c.close()

    @property
    def is_sse(self):
        return self.headers.get("content-type", "").startswith(
            "text/event-stream")

    def text(self):
        """(text, finish reasons, error messages) of a stream or body."""
        if not self.is_sse:
            obj = json.loads(self.body)
            ch = obj["choices"][0]
            return ch["text"], [ch["finish_reason"]], []
        text, finishes, errors = "", [], []
        for f in self.frames:
            data = f[6:-2]
            if not f.startswith(b"data: ") or data == b"[DONE]":
                continue
            obj = json.loads(data)
            if "error" in obj:
                errors.append(obj["error"].get("message", ""))
            for ch in obj.get("choices", ()):
                text += ch.get("text", "")
                if ch.get("finish_reason"):
                    finishes.append(ch["finish_reason"])
        return text, finishes, errors

    def normalized(self):
        if self.is_sse:
            return [f if f == b"data: [DONE]\n\n"
                    else scrub(json.loads(f[6:-2])) for f in self.frames]
        return scrub(json.loads(self.body))


def completion(m, okey=None, stream=False, prompt="multimaster", **kw):
    body = {"model": "fake-model", "prompt": prompt, "max_tokens": 1000,
            "stream": stream}
    if okey is not None:
        body["ownership_key"] = okey
    return Call(m.http_port, "/v1/completions", body, **kw)


def both(drill):
    """The drill on the JAX pair, then on the port's: equal outcomes."""
    want = drill(PKGS["ref"])
    got = drill(PKGS["port"])
    assert got == want, (got, want)
    return got


def counter(metric):
    return metric.value()


def blocks(mgr):
    return {h: loc.to_row() for h, loc in mgr._snapshot.blocks.items()}


# --------------------------------------------------------- active-active
def drill_foreign_owner(P):
    pl = Plane(P)
    try:
        m1, m2 = pl.masters
        okey = key_owned_by(m1.scheduler.ownership, m2.scheduler.self_addr)
        M = P.metrics
        fwd0 = counter(M.HANDOFF_FORWARDED_TOTAL)
        served0 = counter(M.HANDOFF_SERVED_TOTAL)
        relayed = completion(m1, okey)
        moved = (counter(M.HANDOFF_FORWARDED_TOTAL) - fwd0,
                 counter(M.HANDOFF_SERVED_TOTAL) - served0)
        direct = completion(m2, okey)
        after_direct = counter(M.HANDOFF_FORWARDED_TOTAL) - fwd0
        relayed_s = completion(m1, okey, stream=True)
        direct_s = completion(m2, okey, stream=True)
        assert relayed.normalized() == direct.normalized()
        assert relayed_s.normalized() == direct_s.normalized()
        return dict(
            status=(relayed.status, direct.status, relayed_s.status),
            rid=relayed.headers["x-request-id"].split("-")[0],
            stream_rid=relayed_s.headers["x-request-id"].split("-")[0],
            body=relayed.normalized(), sse=relayed_s.normalized(),
            text=relayed_s.text(), moved=moved, after_direct=after_direct)
    finally:
        pl.close()


def test_foreign_owner_accept_relays_and_affinity_sticks():
    out = both(drill_foreign_owner)
    assert out["moved"] == (1, 1) and out["after_direct"] == 1
    assert out["text"] == (REPLY, ["stop"], [])
    assert out["rid"] == out["stream_rid"] == "completion"
    assert out["sse"][-1] == b"data: [DONE]\n\n"


def drill_mined(P):
    pl = Plane(P)
    try:
        m1 = pl.masters[0]
        fwd0 = counter(P.metrics.HANDOFF_FORWARDED_TOTAL)
        mined0 = m1.scheduler.ownership.mined
        texts = [completion(m1).text() for _ in range(8)]
        return (texts, counter(P.metrics.HANDOFF_FORWARDED_TOTAL) - fwd0,
                m1.scheduler.ownership.mined - mined0 >= 8)
    finally:
        pl.close()


def test_mined_accepts_serve_locally():
    texts, forwarded, mined = both(drill_mined)
    assert texts == [(REPLY, ["stop"], [])] * 8
    assert forwarded == 0 and mined


def drill_replica_mirrors(P):
    pl = Plane(P)
    try:
        m1, m2 = pl.masters
        engine = pl.engines[0]
        roles = (m1.scheduler.is_master, m2.scheduler.is_master)
        okey = key_owned_by(m2.scheduler.ownership, m2.scheduler.self_addr)
        # Two full 128-token blocks, so the engine's KV events carry hashes.
        out = completion(m2, okey, prompt="m" * 300)
        converged = wait_until(
            lambda: blocks(m2.scheduler.kvcache_mgr)
            == blocks(m1.scheduler.kvcache_mgr)
            and m2.scheduler.kvcache_mgr.num_blocks() > 0, timeout=10)
        aged = wait_until(
            lambda: m2.scheduler.instance_mgr.load_info_ages_s()
            .get(engine.name, -1.0) >= 0, timeout=10)
        return roles, out.text(), converged, aged
    finally:
        pl.close()


def test_replica_routes_off_mirrored_state():
    roles, text, converged, aged = both(drill_replica_mirrors)
    assert roles == (True, False)
    assert text == (REPLY, ["stop"], []) and converged and aged


# ------------------------------------------------- owner death mid-stream
def drill_kill_owner(P):
    """The accepting frontend relays; the owner dies after three frames;
    the stream completes on the rendezvous successor."""
    pl = Plane(P, engines=({"delay_s": 0.12},))
    try:
        m1, m2 = pl.masters
        a1, a2 = m1.scheduler.self_addr, m2.scheduler.self_addr
        okey = key_owned_by(m1.scheduler.ownership, a2)
        rec0 = counter(P.metrics.HANDOFF_RECOVERIES_TOTAL)
        c = completion(m1, okey, stream=True, after=3,
                       hook=lambda: pl.kill(m2))
        sid = c.headers["x-request-id"]
        datas = [f for f in c.frames if f != b"data: [DONE]\n\n"]
        recs = [r["detail"] for r in P.RECORDER.recent(
            limit=50, kind="handoff_recovery") if r["request_id"] == sid]

        def relay_roots():
            _, trace = P.TRACER.query_trace(request_id=sid)
            return [s["attrs"] for s in trace.get("spans", ())
                    if s["point"] == "frontend.request"
                    and s["attrs"].get("relay")]
        # The relay ends its root span after it has written the stream's
        # last chunk, so the client can read the whole stream first: the
        # span is awaited, not read at once.
        wait_until(relay_roots, timeout=5)
        relay_root = relay_roots()
        return dict(
            text=c.text(), frames=len(datas),
            distinct=len(set(datas)) == len(datas),
            recovered=counter(P.metrics.HANDOFF_RECOVERIES_TOTAL) - rec0 >= 1,
            record=[(d["dead_owner"] == a2, d["successor"] == a1)
                    for d in recs],
            reowned=[a.get("reowned_to") == a1 for a in relay_root])
    finally:
        pl.close()


def test_kill_owning_frontend_completes_on_survivor():
    out = both(drill_kill_owner)
    assert out["text"] == (REPLY, ["stop"], []) and out["distinct"]
    assert out["frames"] == len(REPLY) // 4 + (len(REPLY) % 4 > 0)
    assert out["recovered"]
    # The same-owner retry fails at connect, then one re-ownership: the
    # successor is named in the record, and on the relay's root span when
    # tracing sampled it.
    assert out["record"] == [(True, True)]
    assert all(out["reowned"])


def drill_kill_elected(P):
    pl = Plane(P, engines=({"delay_s": 0.12},))
    try:
        m1, m2 = pl.masters
        first = m1.scheduler.is_master
        okey = key_owned_by(m2.scheduler.ownership, m1.scheduler.self_addr)
        c = completion(m2, okey, stream=True, after=3,
                       hook=lambda: pl.kill(m1))
        t0 = time.monotonic()
        promoted = wait_until(lambda: m2.scheduler.is_master, timeout=5)
        took = time.monotonic() - t0

        def converged():
            fresh = P.GlobalKVCacheMgr(pl.coord(), m2.options.block_size,
                                       is_master=False)
            try:
                return blocks(fresh) == blocks(m2.scheduler.kvcache_mgr)
            finally:
                fresh.stop()
        return dict(first=first, text=c.text(), promoted=promoted,
                    in_time=took <= FAST["lease_ttl_s"]
                    + FAST["sync_interval_s"] + 1.0,
                    converged=wait_until(converged, timeout=5),
                    after=completion(m2).text())
    finally:
        pl.close()


def test_kill_elected_master_completes_and_converges():
    out = both(drill_kill_elected)
    assert out["first"] and out["promoted"] and out["in_time"]
    assert out["text"] == out["after"] == (REPLY, ["stop"], [])
    assert out["converged"]


# ----------------------------------------------------------- split brain
def drill_split_brain(P):
    pl = Plane(P, engines=({"delay_s": 0.12},))
    try:
        m1, m2 = pl.masters
        first = m1.scheduler.is_master
        okey = key_owned_by(m1.scheduler.ownership, m1.scheduler.self_addr)
        # Mid-stream, m1's election lease lapses (release stops its
        # keepalive) and m2 wins while m1 still believes it is master.
        c = completion(m1, okey, stream=True, after=3,
                       hook=lambda: m1.scheduler._coord.release(
                           P.rpc.MASTER_KEY))
        promoted = wait_until(lambda: m2.scheduler.is_master, timeout=5)
        demoted = wait_until(lambda: not m1.scheduler.is_master, timeout=5)
        prefix = P.rpc.CACHE_FRAME_KEY_PREFIX
        tail = sorted(m1.scheduler._coord.get_prefix(prefix))
        m1.scheduler.kvcache_mgr.upload_kvcache()
        m1.scheduler.instance_mgr.upload_load_metrics()
        silent = sorted(m1.scheduler._coord.get_prefix(prefix)) == tail
        mirrors = wait_until(lambda: blocks(m1.scheduler.kvcache_mgr)
                             == blocks(m2.scheduler.kvcache_mgr), timeout=10)
        return dict(first=first, text=c.text(), promoted=promoted,
                    demoted=demoted, silent=silent, mirrors=mirrors,
                    after=(completion(m1).text(), completion(m2).text()))
    finally:
        pl.close()


def test_replica_election_win_demotes_streaming_master():
    out = both(drill_split_brain)
    ok = (REPLY, ["stop"], [])
    assert out == dict(first=True, text=ok, promoted=True, demoted=True,
                       silent=True, mirrors=True, after=(ok, ok))


# -------------------------------------------------- handoff delta journal
def _handoff(m, sid, attempt, skip=0, body=None, **kw):
    body = body or {"model": "fake-model", "prompt": "journal",
                    "stream": True, "max_tokens": 1000}
    return Call(m.rpc_port, f"/rpc/handoff?kind=completion&sid={sid}"
                f"&attempt={attempt}&skip={skip}", body, **kw)


def drill_journal_replay(P):
    pl = Plane(P, n_masters=1)
    try:
        m1, engine = pl.masters[0], pl.engines[0]
        sid = f"completion-journal-{P.which}-1"
        first = _handoff(m1, sid, 0)
        accepted0 = len(engine.accepted_requests)
        replays0 = counter(P.metrics.HANDOFF_JOURNAL_REPLAYS_TOTAL)
        # A re-run now would stream other bytes; the replay must not.
        engine.cfg.reply_text = "DIVERGENT " * 8
        replay = _handoff(m1, sid, 1, skip=2)
        return dict(
            status=(first.status, replay.status), n=len(first.frames) >= 3,
            exact=replay.frames == first.frames[2:],
            tail=[scrub(json.loads(f[6:-2])) if f != b"data: [DONE]\n\n"
                  else f for f in replay.frames],
            reruns=len(engine.accepted_requests) - accepted0,
            replays=counter(P.metrics.HANDOFF_JOURNAL_REPLAYS_TOTAL)
            - replays0)
    finally:
        pl.close()


def test_reconnect_replays_exact_frames_without_rerun():
    out = both(drill_journal_replay)
    assert out["status"] == (200, 200) and out["n"] and out["exact"]
    assert out["reruns"] == 0 and out["replays"] == 1


def drill_journal_detach(P):
    pl = Plane(P, n_masters=1, engines=({"delay_s": 0.08},))
    try:
        m1 = pl.masters[0]
        sid = f"completion-journal-{P.which}-2"
        body = {"model": "fake-model", "prompt": "journal-detach",
                "stream": True, "max_tokens": 1000}
        c = http.client.HTTPConnection("127.0.0.1", m1.rpc_port, timeout=30)
        c.request("POST", f"/rpc/handoff?kind=completion&sid={sid}"
                  "&attempt=0", body=json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        buf = b""
        while buf.count(b"\n\n") < 2:
            buf += r.read1(1)
        # A relay break, not a client abort: no /rpc/handoff_abort.
        c.sock.close()
        c.close()
        time.sleep(0.3)
        again = _handoff(m1, sid, 1, 0, body)
        return again.text(), again.frames[-1]
    finally:
        pl.close()


def test_detached_stream_absorbs_and_replays_through_grace():
    text, last = both(drill_journal_detach)
    assert text == (REPLY, ["stop"], []) and last == b"data: [DONE]\n\n"


# ---------------------------------------------------------- mixed cluster
def _mixed_cluster(accept_on, killed):
    """A JAX master and a port master on the port's coordination server;
    ``accept_on`` takes a stream owned by the other, which dies after
    three frames when ``killed``."""
    R, T = PKGS["ref"], PKGS["port"]
    srv = T.server.CoordinationServer(
        host="127.0.0.1", port=0,
        store=T.memory.MemoryStore(expiry_tick_s=0.02))
    srv.start_background()
    addr = f"127.0.0.1:{srv.port}"
    clients = {"ref": R.client.TcpCoordinationClient,
               "port": T.client.TcpCoordinationClient}
    masters, killers, dead, engine = {}, [], [], None
    try:
        for which in ("ref", "port"):
            P = PKGS[which]
            m = P.Master(P.Options(**{**FAST, "coordination_addr": addr}),
                         coord=clients[which](addr))
            m.start()
            masters[which] = m
        engine = FakeEngine(
            R.client.TcpCoordinationClient(addr),
            FakeEngineConfig(reply_text=REPLY, chunk_size=4, delay_s=0.1,
                             heartbeat_interval_s=0.1,
                             lease_ttl_s=0.5)).start()
        addrs = {m.scheduler.self_addr for m in masters.values()}
        assert wait_until(lambda: all(
            m.scheduler.instance_mgr.get_instance_meta(engine.name)
            and set(m.scheduler.ownership.members()) == addrs
            for m in masters.values()), timeout=20)
        front = masters[accept_on]
        owner = masters["port" if accept_on == "ref" else "ref"]
        okey = key_owned_by(front.scheduler.ownership,
                            owner.scheduler.self_addr)
        fwd = PKGS[accept_on].metrics.HANDOFF_FORWARDED_TOTAL
        served = PKGS["port" if accept_on == "ref" else "ref"] \
            .metrics.HANDOFF_SERVED_TOTAL
        f0, s0 = fwd.value(), served.value()
        whole = completion(front, okey)
        assert whole.text() == (REPLY, ["stop"], [])
        assert (fwd.value() - f0, served.value() - s0) == (1, 1)
        direct = completion(owner, okey)
        assert whole.normalized() == direct.normalized()
        if not killed:
            s = completion(front, okey, stream=True)
            assert s.text() == (REPLY, ["stop"], [])
            return
        def kill():
            dead.append(owner)
            killers.append(owner.kill())
        s = completion(front, okey, stream=True, after=3, hook=kill)
        assert s.text() == (REPLY, ["stop"], [])
        datas = [f for f in s.frames if f != b"data: [DONE]\n\n"]
        assert len(set(datas)) == len(datas)
        # The survivor serves on, and holds the election key.
        assert completion(front).text() == (REPLY, ["stop"], [])
        assert wait_until(lambda: front.scheduler.is_master, timeout=10)
    finally:
        if engine is not None:
            engine.stop()
        for m in masters.values():
            if m not in dead:
                m.stop()
        for t in killers:
            t.join(timeout=15)
        srv.stop()


@pytest.mark.parametrize("accept_on,killed", [
    ("port", False), ("ref", False), ("port", True), ("ref", True)],
    ids=["port-relays-to-jax", "jax-relays-to-port",
         "jax-owner-killed", "port-owner-killed"])
def test_mixed_cluster_relays_both_ways(accept_on, killed):
    _mixed_cluster(accept_on, killed)
