"""The engine plane of the port: continuous batching over a paged KV pool
on one CUDA device."""

from .config import EngineConfig
from .engine import EngineRequest, InferenceEngine

__all__ = ["EngineConfig", "EngineRequest", "InferenceEngine"]
