"""Batched decode serving (the port of ``repro.serving``)."""
from .engine import GenRequest, ServeEngine

__all__ = ["GenRequest", "ServeEngine"]
