"""The engine's side of the multi-master service plane: which master owns
this instance's telemetry (``ownership.py``)."""

from .ownership import (
    TELEMETRY_SALT,
    TelemetryOwnerResolver,
    rendezvous_owner,
    telemetry_owner,
)

__all__ = ["TELEMETRY_SALT", "TelemetryOwnerResolver", "rendezvous_owner",
           "telemetry_owner"]
