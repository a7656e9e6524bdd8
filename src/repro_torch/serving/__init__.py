"""Serving runtime: engine, sampling, cache bookkeeping."""
from .engine import Request, Result, ServingEngine  # noqa: F401
