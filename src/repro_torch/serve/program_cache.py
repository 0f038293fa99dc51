"""Serving-facing alias of the program store (see core/program_cache.py).

The implementation lives in repro_torch.core so the compiler's executor can
memoize dynamic programs without importing the serving package; this
module is the serving layer's canonical import path for it.
"""
from repro_torch.core.program_cache import CacheStats, ProgramCache, ProgramKey

__all__ = ["CacheStats", "ProgramCache", "ProgramKey"]
