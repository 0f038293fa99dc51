"""Shared program-serving base (the port's copy of repro.serve.base, without
the mesh and the cross-engine FabricPump).

  * the keyed LRU ProgramCache (own or injected), keyed by (model config,
    EngineConfig, calibration-id);
  * the per-program store of bound executors (the reference's jitted
    store: PyTorch runs eagerly, so an executor is the program bound to its
    engine config), pruned against the cache so evictions drop it too;
  * the SlotScheduler, the continuous-batching request queue;
  * per-request latency and cache statistics.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compiler.executor import Program
from repro_torch.core.config import EngineConfig
from repro_torch.core.program_cache import ProgramCache, ProgramKey


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _host_bytes(a) -> np.ndarray:
    """A leaf's bytes as a contiguous host array (hashed without a copy)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def calibration_digest(batches: Sequence, params=None,
                       weight_mode: str = "") -> str:
    """Stable id of the calibration inputs.  The recorded scales depend on
    the batches AND the float params (calibrate() runs the model), so both
    are digested: re-registering a model with new weights or new batches
    must miss the cache, not reuse stale activation scales.  `weight_mode`
    (core.engine.weight_mode: "" for int8 weights, "w4g64" for int4
    groups) is appended, so w4 and w8 programs of one model never share a
    cache line: their activation scales coincide, their weights do not."""
    h = hashlib.sha1()
    for b in batches:
        h.update(str(tuple(b.shape)).encode())
        h.update(_host_bytes(b))
    if params is not None:
        for leaf in _leaves(params):
            h.update(_host_bytes(leaf))
    digest = h.hexdigest()[:12]
    return f"{digest}:{weight_mode}" if weight_mode else digest


# ---------------------------------------------------------------------------
# SlotScheduler: the continuous-batching request queue
# ---------------------------------------------------------------------------

@dataclass
class SlotStats:
    """Slot accounting across every dispatch the scheduler served."""
    submitted: int = 0
    dispatched: int = 0                  # requests handed out
    waves: int = 0                       # full-or-forced groups handed out
    padded_slots: int = 0                # empty slots in forced groups
    refilled_waves: int = 0              # groups spanning >1 arrival epoch

    @property
    def fill_rate(self) -> float:
        slots = self.dispatched + self.padded_slots
        return self.dispatched / slots if slots else 0.0


@dataclass
class _Entry:
    ticket: int
    epoch: int
    payload: object


class SlotScheduler:
    """One slot-based request queue.

    Requests enter FIFO under a hashable group key (the CNN engine groups by
    input shape so same-shape models share wave buffers).  A group's
    requests leave in waves of `slots`; a partial group is NOT dispatched
    until later arrivals top it up (continuous batching) or the caller
    forces a drain (`take_wave(force=True)` pads, and the padding is what
    the fill-rate metric charges).  `epoch` advances on every dispatch
    round (`next_epoch`), so a wave whose entries span epochs counts as a
    refilled wave."""

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.slots = slots
        self.stats = SlotStats()
        self.epoch = 0
        self._queues: "OrderedDict[Hashable, List[_Entry]]" = OrderedDict()
        self._next_ticket = 0

    def submit(self, group: Hashable, payload) -> int:
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queues.setdefault(group, []).append(
            _Entry(ticket, self.epoch, payload))
        self.stats.submitted += 1
        return ticket

    def next_epoch(self) -> None:
        """Mark a dispatch round boundary; entries surviving it count as
        refill candidates."""
        self.epoch += 1

    def groups(self) -> List[Hashable]:
        return [g for g, q in self._queues.items() if q]

    def pending(self, group: Optional[Hashable] = None) -> int:
        if group is not None:
            return len(self._queues.get(group, []))
        return sum(len(q) for q in self._queues.values())

    def peek(self, group: Hashable) -> List[object]:
        """The group's queued payloads, oldest first (not dequeued)."""
        return [e.payload for e in self._queues.get(group, [])]

    def take(self, group: Hashable, limit: int) -> List[Tuple[int, object]]:
        """Pop up to `limit` requests, oldest first (the LM engine's
        slot-by-slot refill; no padding is charged)."""
        q = self._queues.get(group, [])
        taken, self._queues[group] = q[:limit], q[limit:]
        self.stats.dispatched += len(taken)
        if taken and len({e.epoch for e in taken}) > 1:
            self.stats.refilled_waves += 1
        return [(e.ticket, e.payload) for e in taken]

    def take_wave(self, group: Hashable, force: bool = False
                  ) -> Optional[List[Tuple[int, object]]]:
        """Pop one wave of exactly `slots` requests, or None when the group
        is partial.  force=True drains a final partial wave (its empty slots
        are charged to padded_slots)."""
        q = self._queues.get(group, [])
        if not q or (len(q) < self.slots and not force):
            return None
        taken, self._queues[group] = q[:self.slots], q[self.slots:]
        self.stats.dispatched += len(taken)
        self.stats.waves += 1
        self.stats.padded_slots += self.slots - len(taken)
        if len({e.epoch for e in taken}) > 1:
            self.stats.refilled_waves += 1
        return [(e.ticket, e.payload) for e in taken]


class LatencyTracker:
    """Per-request wall-clock latency, submit -> response materialization
    (the host copy of the logits, which waits for the device): queueing +
    batching + device time, not just kernel time."""

    def __init__(self):
        self._open: Dict[int, float] = {}
        self.samples_ms: List[float] = []

    def submitted(self, ticket: int) -> None:
        self._open[ticket] = time.perf_counter()

    def completed(self, ticket: int) -> None:
        t0 = self._open.pop(ticket, None)
        if t0 is not None:
            self.samples_ms.append((time.perf_counter() - t0) * 1e3)

    def percentiles(self) -> Dict[str, float]:
        if not self.samples_ms:
            return {"n": 0, "p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
        a = np.asarray(self.samples_ms)
        return {"n": int(a.size),
                "p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99)),
                "mean_ms": float(a.mean())}


class ProgramServeBase:
    """Compile-once, cache-keyed program serving."""

    def __init__(self, eng: EngineConfig, cache_capacity: int = 8,
                 cache: Optional[ProgramCache] = None):
        self.eng = eng
        self.cache = (ProgramCache(cache_capacity, on_evict=self._on_evict)
                      if cache is None else cache)
        self._executors: Dict[object, tuple] = {}
        self.latency = LatencyTracker()

    # -- program cache -------------------------------------------------------

    def _program_key(self, model_cfg, calib_id: Optional[str],
                     tag: str = "") -> ProgramKey:
        """The cache key; `tag` names the program variant (an LM's
        "prefill" and "decode:p16" programs hold distinct lines)."""
        return ProgramKey(model_cfg, self.eng, calib_id, tag)

    def _cached_program(self, key: ProgramKey,
                        compile_fn: Callable[[], Program]) -> Program:
        """Cache hit, or compile-and-insert (counts hits/misses)."""
        return self.cache.get_or_compile(key, compile_fn)

    def _on_evict(self, key, program) -> None:
        self._executors.pop(key, None)

    # -- bound executors -----------------------------------------------------

    def _bound_for(self, key, program: Program,
                   build: Callable[[Program], Callable]):
        """The program's bound executor, built once per cached program.  A
        shared cache evicts without calling this engine's _on_evict, so the
        store is pruned against the cache on every call."""
        self._executors = {k: f for k, f in self._executors.items()
                           if k in self.cache}
        fn = self._executors.get(key)
        if fn is None or fn[0] is not program:
            fn = (program, build(program))
            self._executors[key] = fn
        return fn[1]

    # -- stats ---------------------------------------------------------------

    def cache_stats(self) -> Dict[str, object]:
        c = self.cache.stats
        return {
            "cache_hits": c.hits,
            "cache_misses": c.misses,
            "cache_evictions": c.evictions,
            "cache_hit_rate": c.hit_rate,
            "programs_cached": len(self.cache),
        }
