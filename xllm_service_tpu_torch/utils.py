"""Misc helpers of the service plane (copy of ``xllm_service_tpu/utils``
without its JAX helpers): request ids, port checks, loggers."""

from __future__ import annotations

import logging
import socket
import threading
import uuid as _uuid

from .common.net import get_local_ip, jittered_backoff, pick_free_port

__all__ = ["generate_service_request_id", "get_local_ip", "get_logger",
           "is_port_available", "jittered_backoff", "join_namespace",
           "pick_free_port", "short_uuid"]


def short_uuid() -> str:
    """8-char request-id suffix."""
    return _uuid.uuid4().hex[:8]


def generate_service_request_id(method: str) -> str:
    """Service-generated request id ``method-threadid-shortuuid``."""
    return f"{method}-{threading.get_ident() & 0xFFFF}-{short_uuid()}"


def is_port_available(port: int, host: str = "0.0.0.0") -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, port))
            return True
        except OSError:
            return False


def join_namespace(namespace: str, key: str) -> str:
    """etcd-style namespace prefixing."""
    ns = namespace.strip("/")
    return f"{ns}/{key}" if ns else key


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger().handlers and not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger
