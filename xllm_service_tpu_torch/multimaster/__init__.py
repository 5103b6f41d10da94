"""The multi-master service plane: every master is an active frontend.

- :mod:`ownership` — rendezvous-hash request ownership over the live
  service-replica set (``XLLM:SERVICE:`` records), the telemetry shard
  map, and the engine's resolver of its telemetry owner.
- :mod:`handoff` — the relay of a request the accepting frontend does
  not own to its owner's ``/rpc/handoff``, with re-ownership to the
  rendezvous successor when the owner dies mid-stream, and the owner's
  delta journal a reconnect replays from.
"""

from .handoff import DeltaJournal, HandoffRelay
from .ownership import (
    TELEMETRY_SALT,
    OwnershipRouter,
    TelemetryOwnerResolver,
    rendezvous_owner,
    telemetry_owner,
)

__all__ = ["DeltaJournal", "HandoffRelay", "OwnershipRouter",
           "TELEMETRY_SALT", "TelemetryOwnerResolver", "rendezvous_owner",
           "telemetry_owner"]
