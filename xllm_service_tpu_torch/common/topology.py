"""Link classes between two instances' placement coordinates.

A copy of the part of ``xllm_service_tpu/common/topology.py`` the agent's
KV-transfer bandwidth accounting needs (``EngineAgent._link_class``):
``Coord``, ``effective_coord``, ``link_class`` and the ``LINK_*``
constants, with the same behaviour.

An instance is *placed* only when its topology carries a non-empty
``host``; an unplaced one gets a synthetic per-host coordinate from its
registered name (``host:port``): slice ``host:<h>``, host ``<h>``. Link
classes: ``local`` (same host), ``ici`` (same slice, another host) and
``dcn`` (another slice).
"""

from __future__ import annotations

from typing import NamedTuple

LINK_LOCAL = "local"
LINK_ICI = "ici"
LINK_DCN = "dcn"


class Coord(NamedTuple):
    """Effective placement coordinate. ``placed`` is False for synthetic
    (per-host fallback) coordinates."""

    slice_id: str
    host: str
    chip: int = -1
    placed: bool = False


def effective_coord(topology, instance_name: str) -> Coord:
    """Coordinate for an instance, synthesizing a per-host slice when the
    registration didn't place it (no ``host``). ``topology`` is a
    ``TpuTopology`` or None; ``instance_name`` is the registry identity
    (``host:http_port``)."""
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
