"""ICI-topology link-cost kernel — the one shared model of what a KV
handoff between two instances costs.

Every instance registers a topology coordinate ``(slice_id, host, chip)``
(`TpuTopology.slice_id/host/chip`, common/types.py). The kernel below is
*pure*: no clocks, no locks, no I/O — routing policies (RR/CAR/SLO),
the planner, the autoscaler, the kv_transfer link derivation, and the
bench all call the same three functions so they can never disagree about
which pair rides ICI and which pays DCN.

Placement semantics (the "flat fleets behave exactly as today" rule):

* An instance is **placed** only when its topology carries a non-empty
  ``host``. ``slice_id`` alone does NOT place it — agents have always
  defaulted to ``slice_id="slice-0"`` and fake engines to
  ``"fake-slice"``, so keying off slice_id would silently re-route
  every existing deployment.
* An **unplaced** instance gets a synthetic per-host coordinate derived
  from its registered name (``host:port``): slice ``host:<h>``, host
  ``<h>``. A flat fleet on one box therefore collapses into ONE
  synthetic slice and the whole plane stays dormant
  (`fleet_topo_active` is False ⇒ zero routing behavior change).

Link classes and cost:

* ``local`` — same host: the handoff never leaves the machine.
* ``ici``   — same slice, different host: inter-chip interconnect.
* ``dcn``   — different slices: data-center network, the slow path.

``transfer_cost(nbytes, link)`` is seconds of modeled wire time, seeded
from the same per-class budgets the engine's ``BandwidthAccountant``
paces with (engine/kv_transfer.py). A budget of 0 means "account only,
don't throttle" on the engine side; here it falls back to class-default
bandwidths so the *ordering* local < ici < dcn survives even on
unthrottled fleets — the knob trades absolute accuracy for a stable
preference, which is what placement needs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

LINK_LOCAL = "local"
LINK_ICI = "ici"
LINK_DCN = "dcn"

#: Class-default bandwidths (bytes/s) used when the matching accountant
#: budget is 0 (= account-only). Shaped after v5e numbers: ~1.6 Tbps ICI
#: per link vs ~25 Gbps DCN per host; `local` is host-memory speed. Only
#: the ORDER matters for placement — absolute values only matter when a
#: deployment actually throttles.
DEFAULT_BYTES_PER_S = {
    LINK_LOCAL: 400e9,
    LINK_ICI: 100e9,
    LINK_DCN: 3.125e9,
}

#: Normalized link penalty in [0, 1] for score-space consumers (CAR):
#: a knob value t means "a DCN pair must beat an ICI pair by > ~t score
#: units to win". Derived from the default-bandwidth ratios, then
#: clamped to a readable scale.
LINK_PENALTY = {LINK_LOCAL: 0.0, LINK_ICI: 0.03, LINK_DCN: 1.0}


class Coord(NamedTuple):
    """Effective placement coordinate. `placed` is False for synthetic
    (per-host fallback) coordinates — consumers that want to act only on
    operator-declared topology can check it."""

    slice_id: str
    host: str
    chip: int = -1
    placed: bool = False


def effective_coord(topology, instance_name: str) -> Coord:
    """Coordinate for an instance, synthesizing a per-host slice when the
    registration didn't place it (no ``host``).

    ``topology`` is a ``TpuTopology`` or None. ``instance_name`` is the
    registry identity (typically ``host:http_port``)."""
    host = getattr(topology, "host", "") if topology is not None else ""
    if host:
        slice_id = getattr(topology, "slice_id", "") or f"host:{host}"
        return Coord(slice_id, host, int(getattr(topology, "chip", -1)),
                     placed=True)
    h = instance_name.rsplit(":", 1)[0] if instance_name else ""
    return Coord(f"host:{h}", h, -1, placed=False)


def link_class(a: Coord, b: Coord) -> str:
    """Pure link classification between two effective coordinates."""
    if a.host and a.host == b.host:
        return LINK_LOCAL
    if a.slice_id and a.slice_id == b.slice_id:
        return LINK_ICI
    return LINK_DCN


def link_penalty(link: str) -> float:
    return LINK_PENALTY.get(link, LINK_PENALTY[LINK_DCN])


def transfer_cost(nbytes: int, link: str,
                  ici_bytes_per_s: float = 0.0,
                  dcn_bytes_per_s: float = 0.0) -> float:
    """Modeled seconds to move ``nbytes`` over ``link``.

    The two budget arguments mirror `BandwidthAccountant`'s constructor;
    0 (= account-only on the engine side) falls back to the class
    default so the cost ordering is preserved on unthrottled fleets.
    ``local`` always uses its class default — the accountant has no
    intra-host budget to borrow."""
    if nbytes <= 0:
        return 0.0
    if link == LINK_ICI and ici_bytes_per_s > 0:
        bps = ici_bytes_per_s
    elif link == LINK_DCN and dcn_bytes_per_s > 0:
        bps = dcn_bytes_per_s
    else:
        bps = DEFAULT_BYTES_PER_S.get(link, DEFAULT_BYTES_PER_S[LINK_DCN])
    return nbytes / bps


def kv_handoff_bytes(meta, tokens: int) -> int:
    """Estimated prefill→decode KV payload for ``tokens`` prompt tokens,
    from the KV-layout contract an instance advertises at registration
    (``InstanceMetaInfo.num_layers/num_kv_heads/head_dim/kv_dtype``).
    Returns 0 when the layout is unadvertised (fake engines) — callers
    then substitute their own modeled payload size."""
    if meta is None or tokens <= 0:
        return 0
    layers = int(getattr(meta, "num_layers", 0) or 0)
    heads = int(getattr(meta, "num_kv_heads", 0) or 0)
    head_dim = int(getattr(meta, "head_dim", 0) or 0)
    if layers <= 0 or heads <= 0 or head_dim <= 0:
        return 0
    dtype = str(getattr(meta, "kv_dtype", "") or "bfloat16").lower()
    itemsize = 1 if ("int8" in dtype or "fp8" in dtype or "e4m3" in dtype
                     or "e5m2" in dtype) else (4 if "32" in dtype else 2)
    # K and V planes.
    return 2 * layers * heads * head_dim * itemsize * tokens


def pair_link(topo_a, name_a: str, topo_b, name_b: str) -> str:
    """Convenience: link class straight from two registrations."""
    return link_class(effective_coord(topo_a, name_a),
                      effective_coord(topo_b, name_b))


def fleet_topo_active(coords) -> bool:
    """True when placement should engage: >= 2 distinct effective slices
    among the given coordinates. One slice (the flat-fleet collapse) ⇒
    every pair costs the same ⇒ stay dormant and keep legacy ordering."""
    first: Optional[str] = None
    for c in coords:
        if first is None:
            first = c.slice_id
        elif c.slice_id != first:
            return True
    return False
