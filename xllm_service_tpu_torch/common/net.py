"""Network helpers of the agent and the coordination client (copy of the
part of ``xllm_service_tpu/utils/__init__.py`` they use)."""

from __future__ import annotations

import random
import socket


def jittered_backoff(base_s: float, max_s: float, attempt: int) -> float:
    """Exponential backoff with full-range jitter: 0-based ``attempt`` k
    yields a delay in (cap/2, cap] where cap = min(max_s, base_s * 2^k)."""
    delay = min(max_s, base_s * (2 ** attempt))
    return delay * (0.5 + random.random() / 2)


def pick_free_port(host: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def get_local_ip() -> str:
    """Best-effort local IP: the source address of a connected UDP socket
    (connecting a UDP socket sends nothing), loopback when there is no
    route."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
