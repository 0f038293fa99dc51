"""CNN serving engine: cached programs + continuous wave batching (the
port's copy of repro.serve.cnn_engine, single device).

One engine serves many registered CNNs on one card (the f-CNNx setting):

  * compile  -- each (model, engine, calibration) triple lowers once to a
    static-int8 (or dynamic) engine program, epilogue-fused: conv/dwc ->
    {residual add, pool} chains execute as single kernel launches;
  * cache    -- programs live in a keyed LRU ProgramCache, so a request
    trace that revisits models never re-calibrates;
  * batch    -- single-image requests queue in the SlotScheduler keyed by
    INPUT SHAPE, not by model: same-shape models draw slots from one queue.
    `pump()` dispatches only FULL waves and leaves partial waves queued for
    later arrivals (continuous batching); `flush()` drains, padding the
    final partial wave per shape (the only place pad slots are charged);
  * fold     -- the first time a model's program is bound, its weight
    layouts (the im2col reshape) are folded into the param tree;
  * async    -- every wave is launched before any result is read; the host
    syncs (one device-to-host copy per wave-model execution) only at the
    response edges of pump()/flush()/infer().

A multi-model wave executes the shared buffer once per distinct model in
it, and each request reads its own slot's logits (CNN programs are
batch-row independent).

    engine = CNNServeEngine(eng_lib.paper_engine(), wave_size=4)
    engine.register(cfg, params, calib_batches=[batch])
    for img in images:
        engine.submit(cfg.name, img)
        engine.pump()                # dispatch full waves only
    logits = engine.flush()          # drain; per-request, submission order
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import compiler
from repro_torch.compiler.executor import Program
from repro_torch.core import engine as eng_lib
from repro_torch.core.config import CNNConfig, EngineConfig
from repro_torch.serve.base import (ProgramServeBase, SlotScheduler,
                                    calibration_digest)
from repro_torch.serve.program_cache import ProgramCache

__all__ = ["CNNServeEngine", "calibration_digest"]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


@dataclasses.dataclass
class _Model:
    cfg: CNNConfig
    params: object                    # float tree (calibration input)
    qparams: object                   # engine-quantized tree (execution)
    calib_batches: Optional[List[torch.Tensor]]
    calib_id: Optional[str]
    folded: Optional[Tuple[Program, object]] = None   # layout-folded qparams


@dataclasses.dataclass
class WaveStats:
    requests: int = 0
    waves: int = 0                    # physical wave buffers dispatched
    padded: int = 0                   # empty slots across drained waves
    program_execs: int = 0            # program runs (>= waves: multi-model
                                      # waves run once per distinct model)

    @property
    def fill_rate(self) -> float:
        slots = self.requests + self.padded
        return self.requests / slots if slots else 0.0


class CNNServeEngine(ProgramServeBase):
    """Serve registered CNNs as cached, batched, scheduled engine programs
    on `device` (the card unless the caller asks for "cpu")."""

    def __init__(self, eng: EngineConfig, wave_size: int = 4,
                 cache_capacity: int = 8,
                 cache: Optional[ProgramCache] = None, device="cuda"):
        if wave_size < 1:
            raise ValueError("wave_size must be >= 1")
        super().__init__(eng, cache_capacity=cache_capacity, cache=cache)
        self.device = torch.device(device)
        self.wave_size = wave_size
        self.wave_stats = WaveStats()
        self.execs_by_model: Dict[str, int] = {}
        self._models: Dict[str, _Model] = {}
        self._sched = SlotScheduler(wave_size)

    # -- model registry ------------------------------------------------------

    def register(self, cfg: CNNConfig, params,
                 calib_batches: Optional[Sequence] = None) -> str:
        """Register a model under cfg.name.  `params` is the FLOAT tree; it
        moves to the engine's device and is engine-quantized here.
        `calib_batches` ([N, H, W, C] images, numpy or torch), when given on
        a quantized engine, select the static-int8 program.  The program
        itself compiles lazily on first request."""
        params = _to_device(params, self.device)
        batches = None
        if calib_batches is not None and self.eng.quant != "none":
            batches = [torch.as_tensor(b, dtype=torch.float32,
                                       device=self.device)
                       for b in calib_batches]
        self._models[cfg.name] = _Model(
            cfg=cfg, params=params,
            qparams=eng_lib.quantize_params(params, self.eng),
            calib_batches=batches,
            calib_id=(calibration_digest(batches, params)
                      if batches is not None else None))
        return cfg.name

    def models(self) -> List[str]:
        return sorted(self._models)

    # -- program cache -------------------------------------------------------

    def _key(self, m: _Model):
        return self._program_key(m.cfg, m.calib_id)

    def _compile(self, m: _Model) -> Program:
        if m.calib_batches is None:
            return compiler.compile_cnn(m.cfg)
        return compiler.compile_calibrated(m.cfg, m.params, m.calib_batches)

    def program_for(self, name: str) -> Program:
        """The model's compiled program: cache hit, or compile-and-insert."""
        m = self._models[name]
        return self._cached_program(self._key(m), lambda: self._compile(m))

    def _executor_for(self, name: str):
        """The model's program bound to this engine's config, and its
        layout-folded parameter tree."""
        m = self._models[name]
        program = self.program_for(name)
        run = self._bound_for(
            self._key(m), program,
            lambda prog: lambda p, im: compiler.execute(prog, p, im,
                                                        self.eng))
        if m.folded is None or m.folded[0] is not program:
            m.folded = (program,
                        compiler.fold_weight_layouts(program.graph,
                                                     m.qparams))
        return run, m.folded[1]

    # -- request batching ----------------------------------------------------

    def submit(self, name: str, image: np.ndarray) -> int:
        """Queue one [H, W, C] image request; returns its ticket (the key of
        its logits in a pump() result, and its submission-order rank in a
        flush() result)."""
        if name not in self._models:
            raise KeyError(f"model {name!r} not registered "
                           f"(have {self.models()})")
        image = np.asarray(image)
        cfg = self._models[name].cfg
        want = (cfg.input_hw, cfg.input_hw, cfg.input_ch)
        if image.shape != want:
            # reject at submission: a bad request must not reach dispatch,
            # where the queue is already drained
            raise ValueError(f"submit() takes one {want} image per "
                             f"{name!r} request, got shape {image.shape}")
        ticket = self._sched.submit(want, (name, image))
        self.latency.submitted(ticket)
        return ticket

    def pending(self) -> int:
        return self._sched.pending()

    def pump(self) -> Dict[int, np.ndarray]:
        """Dispatch every FULL wave and return its results; partial waves
        stay queued for later arrivals to refill."""
        return self._dispatch(force=False)

    def flush(self) -> List[np.ndarray]:
        """Run every queued request and return logits in submission order;
        each shape group's final partial wave is zero-padded."""
        results = self._dispatch(force=True)
        return [results[t] for t in sorted(results)]

    def _dispatch(self, force: bool) -> Dict[int, np.ndarray]:
        """Launch every wave-model execution first, then copy each result
        to the host once (the response edge)."""
        in_flight: List[Tuple[torch.Tensor, List[Tuple[int, int]]]] = []
        for group in self._sched.groups():
            while True:
                wave = self._sched.take_wave(group, force=force)
                if wave is None:
                    break
                self._run_wave(wave, group, in_flight)
        self._sched.next_epoch()
        results: Dict[int, np.ndarray] = {}
        for dev_logits, slots in in_flight:      # response edge: host sync
            logits = dev_logits.cpu().numpy()
            for slot, ticket in slots:
                results[ticket] = logits[slot]   # mask foreign/pad slots
                self.latency.completed(ticket)
        return results

    def _run_wave(self, wave, shape, in_flight) -> None:
        """Launch one wave buffer, once per distinct model in it."""
        buf = np.zeros((self.wave_size,) + shape, np.float32)
        slots_of: Dict[str, List[Tuple[int, int]]] = {}
        for slot, (ticket, (name, img)) in enumerate(wave):
            buf[slot] = img
            slots_of.setdefault(name, []).append((slot, ticket))
        dbuf = torch.from_numpy(buf).to(self.device)
        for name, slots in slots_of.items():
            run, qparams = self._executor_for(name)
            in_flight.append((run(qparams, dbuf), slots))
            self.wave_stats.program_execs += 1
            self.execs_by_model[name] = self.execs_by_model.get(name, 0) + 1
        self.wave_stats.requests += len(wave)
        self.wave_stats.waves += 1
        self.wave_stats.padded += self.wave_size - len(wave)

    def infer(self, name: str, images) -> np.ndarray:
        """Submit a [N, H, W, C] batch as N requests and drain; returns
        logits [N, num_classes]."""
        tickets = [self.submit(name, img) for img in np.asarray(images)]
        results = self._dispatch(force=True)
        return np.stack([results[t] for t in tickets])

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        out = {"models": len(self._models), "device": str(self.device)}
        out.update(self.cache_stats())
        fused: Dict[str, Dict[str, int]] = {}
        for name, m in self._models.items():
            prog = self.cache.peek(self._key(m))
            if prog is not None:
                fs = compiler.fusion_stats(prog.graph)
                fused[name] = {"launches": fs["launches"],
                               "fused_ops": fs["fused_ops"]}
        out["fused_programs"] = fused
        out.update({
            "waves": self.wave_stats.waves,
            "requests": self.wave_stats.requests,
            "padded_slots": self.wave_stats.padded,
            "wave_fill_rate": self.wave_stats.fill_rate,
            "program_execs": self.wave_stats.program_execs,
            "execs_by_model": dict(self.execs_by_model),
            "refilled_waves": self._sched.stats.refilled_waves,
            "queued": self._sched.pending(),
            "latency_ms": self.latency.percentiles(),
        })
        return out
