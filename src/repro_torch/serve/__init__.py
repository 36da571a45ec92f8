"""Serving substrate: continuous batching."""
from .batcher import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "Request"]
