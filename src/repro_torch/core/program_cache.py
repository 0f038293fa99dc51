"""Keyed LRU store for compiled engine programs (the port's copy of
repro.core.program_cache).

One fabric serves many models (the f-CNNx setting): a request trace
revisits a small working set, so recompiling -- graph build + calibration +
requant folding -- on every request would dominate serving latency.
Programs are cached under ``(model config, EngineConfig, calibration-id)``
where the model config is the CNNConfig or ArchConfig the graph lowered
from (with a variant tag that keeps an LM's prefill and decode programs
apart): the config
pair pins the lowering and the kernel/quant mode, the calibration id pins
the static scales and the calibrator method, so a hit is guaranteed to be
the byte-identical program a fresh compile would produce.

The store is a plain bounded LRU: hits refresh recency, inserts beyond
capacity evict the least-recently-used entry, and hit/miss/eviction
counters feed the serving stats.  A lock makes it safe to share one cache
across engines serving from threads.

Lives in core (pure stdlib, no model/compiler imports) because both ends
of the stack depend on it: compiler.executor memoizes dynamic programs
here, and serve.cnn_engine keys full calibrated programs.  The serving
layer re-exports it as ``repro_torch.serve.program_cache``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Hashable, Optional


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    compiles: int = 0

    @property
    def requests(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.requests if self.requests else 0.0


@dataclass(frozen=True)
class ProgramKey:
    """The cache key: what uniquely determines a compiled program."""
    model: Hashable                   # the frontend config the graph lowers
                                      # from (a CNNConfig or ArchConfig)
    engine: Optional[Hashable]        # EngineConfig, or None when the
                                      # program is backend-agnostic (dynamic)
    calibration: Optional[str]        # digest of the calibration batches
                                      # and float params, or None for
                                      # uncalibrated programs
    variant: str = ""                 # the program variant within one
                                      # model, e.g. "prefill" / "decode:p16"


class ProgramCache:
    """Bounded LRU mapping ProgramKey-like hashables -> compiled programs."""

    def __init__(self, capacity: int = 8,
                 on_evict: Optional[Callable[[Hashable, Any], None]] = None):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self.stats = CacheStats()
        self._store: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._on_evict = on_evict
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._store

    def peek(self, key: Hashable, default=None):
        """Non-refreshing lookup for stats/introspection: touches neither
        recency nor counters, so monitoring cannot perturb eviction order."""
        with self._lock:
            return self._store.get(key, default)

    def put(self, key: Hashable, value: Any) -> None:
        evicted = []
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
            self._store[key] = value
            while len(self._store) > self.capacity:
                evicted.append(self._store.popitem(last=False))
                self.stats.evictions += 1
        for k, v in evicted:
            if self._on_evict is not None:
                self._on_evict(k, v)

    def get_or_compile(self, key: Hashable, compile_fn: Callable[[], Any]):
        """The serving entry point: hit -> cached program, miss -> compile,
        store, and count.  The compile runs outside the lock (it can take
        seconds); a racing duplicate compile is tolerated -- last write wins
        and both callers get a valid program."""
        with self._lock:
            if key in self._store:
                self.stats.hits += 1
                self._store.move_to_end(key)
                return self._store[key]
            self.stats.misses += 1
        value = compile_fn()
        with self._lock:
            self.stats.compiles += 1
        if self.capacity > 0:
            self.put(key, value)
        return value
