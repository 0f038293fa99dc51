"""LM serving engine: compiled prefill + decode programs behind a
continuous-batching slot scheduler (the port's copy of
repro.serve.engine, single device).

  * prefill AND decode lower through the engine IR
    (compiler.lower_transformer) into programs cached in the keyed
    ProgramCache under distinct "prefill" / "decode[:pN]" variants.  With
    calibration token batches and a w8a8 / w4a8 engine both programs are
    static int8 from ONE calibration run (compiler.calibrate_lm): every
    projection GEMM, the decode step's included, consumes activations at
    compile-time scales.
  * the prefill program fills the decode KV cache (each AttnOp deposits
    its post-RoPE k / v), and the decode program IS the cache recurrence
    (AttnOp `update` mode).
  * requests queue in the SlotScheduler: `submit()` enqueues (prompt,
    max_new_tokens); `run()` serves the queue with B fixed decode slots,
    refilling finished slots between decode bursts.  Prompts left-pad to
    one prefill width, so with `prefill_len` pinned a request's tokens
    depend only on its own padded row.
  * dispatch is asynchronous: emitted tokens stay on the device and the
    host syncs only at response edges (a request completing).

With `kv_layout="paged"` the global layers' KV lives in a shared block
pool behind one block table: a request holds exactly
ceil((prompt + max_new_tokens) / page_size) blocks of a BlockAllocator,
and admission gates on free blocks.  Paged decode reads its KV through
the paged-gather kernel, a pure copy, so its ids equal dense decode's.

An arch the IR does not lower (`compiler.lowering_blockers`; ported:
mamba blocks, e.g. falcon-mamba-7b, and RG-LRU blocks with local ring
attention, e.g. recurrentgemma-2b) falls back to the reference's eager
path: `T.prefill` on a fresh cache, merged into the live cache row by row
for the refilled slots (`_merge`, which casts fresh state to the live
cache's dtype: a mamba layer's {conv, ssm}, an RG-LRU layer's {rec,
conv}, an attention layer's dense or ring {k, v}), and `T.decode` per
step.  That path is dense only (paged KV raises ValueError, as in the
reference) and takes no calibration (no digest is hashed when both paths
are eager).  MoE, encoder-decoder and modality-frontend archs raise
NotImplementedError (`T.check_eager`).

The reference jits prefill, decode and the cache merge; the port runs them
eagerly.  Not ported yet, each raising NotImplementedError: `mesh=`
(multi-device serving), `draft_len` (speculative bursts) and
`prefix_sharing`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import compiler
from repro_torch.compiler import executor as ex
from repro_torch.core import engine as eng_lib
from repro_torch.core.config import ArchConfig, EngineConfig
from repro_torch.models import transformer as T
from repro_torch.serve.base import (ProgramServeBase, SlotScheduler,
                                    calibration_digest)
from repro_torch.serve.kv_alloc import BlockAllocator
from repro_torch.serve.program_cache import ProgramCache

_LM = "lm"                            # the scheduler's single slot group


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # [L] int32
    max_new_tokens: int = 16
    out_tokens: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class SubmitRejection:
    """Structured submit() rejection (queue-level backpressure, not an
    exception).  Falsy, so `if ticket:` keeps working."""
    reason: str                     # "over_length" | "over_capacity"
    detail: str
    prompt_len: int
    max_new_tokens: int

    def __bool__(self) -> bool:
        return False


@dataclasses.dataclass
class LMServeStats:
    """Continuous-batching counters across run() calls."""
    requests: int = 0
    prefill_calls: int = 0            # batched prefill executions
    decode_steps: int = 0             # decode program steps
    active_slot_steps: int = 0        # slot-steps that served a request
    slot_refills: int = 0             # slots reused after a finished request
    rejected_requests: int = 0        # structured submit() rejections
    prefill_tokens_computed: int = 0  # prompt tokens run through prefill
    batch: int = 0

    @property
    def slot_occupancy(self) -> float:
        total = self.decode_steps * max(self.batch, 1)
        return self.active_slot_steps / total if total else 0.0

    @property
    def refill_rate(self) -> float:
        return self.slot_refills / self.requests if self.requests else 0.0


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (the {slice_name} "
                               "slice of the PyTorch port)")


def _merge(old: dict, new: dict, mask: torch.Tensor) -> dict:
    """Scatter refilled slots' prefill state into the live cache: per-slot
    row select on every [B, ...] tensor of every layer's entry (fresh state
    cast to the live tensor's dtype), per-slot position."""
    def sel(o, n):
        m = mask.reshape((mask.shape[0],) + (1,) * (o.ndim - 1))
        return torch.where(m, n.to(o.dtype), o)
    layers = [{k: sel(o[k], n[k]) for k in o}
              for o, n in zip(old["layers"], new["layers"])]
    pos = torch.where(mask, new["pos"].to(torch.int32),
                      old["pos"].to(torch.int32))
    return {"layers": layers, "pos": pos}


class ServeEngine(ProgramServeBase):
    """Greedy LM serving on `device` (the card unless the caller asks for
    "cpu"): compiled programs for the archs the IR lowers, the eager path
    for the rest."""

    def __init__(self, arch: ArchConfig, params, eng: EngineConfig,
                 batch_size: int = 4, max_seq: int = 256,
                 calib_batches: Optional[Sequence] = None,
                 cache: Optional[ProgramCache] = None,
                 cache_capacity: int = 4, decode_burst: int = 4,
                 prefill_len: Optional[int] = None, mesh=None,
                 kv_layout: str = "dense", page_size: int = 8,
                 kv_blocks: Optional[int] = None, draft_len: int = 0,
                 prefix_sharing: bool = False, device="cuda"):
        if mesh is not None:
            raise _later("multi-device serving (mesh=)", "multi-device")
        if draft_len:
            raise _later("speculative decode (draft_len)",
                         "speculative-decode")
        if prefix_sharing:
            raise _later("prefix sharing", "prefix-sharing")
        blockers = compiler.lowering_blockers(arch)
        self.compiled = not blockers
        if not self.compiled:
            T.check_eager(arch)
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                             f"{kv_layout!r}")
        if kv_layout == "paged" and not self.compiled:
            raise ValueError(
                "paged KV / speculative decode need the compiled "
                f"prefill+decode programs ({'; '.join(blockers)})")
        super().__init__(eng, cache_capacity=cache_capacity, cache=cache)
        self.device = torch.device(device)
        self.arch = arch
        self.batch, self.max_seq = batch_size, max_seq
        self.decode_burst = max(1, decode_burst)
        self.prefill_len = prefill_len
        self._float_params = _to_device(params, self.device)
        self.params = eng_lib.quantize_params(self._float_params, eng)
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        self.page_size = int(page_size)
        self.alloc: Optional[BlockAllocator] = None
        if self.paged:
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            # max_seq rounds UP to a page multiple, so the gathered view
            # has the dense cache's shape
            self.max_seq = T.num_pages(max_seq, self.page_size) \
                * self.page_size
            self.kv_pages = T.num_pages(self.max_seq, self.page_size)
            total = (int(kv_blocks) if kv_blocks is not None
                     else batch_size * self.kv_pages)
            self.alloc = BlockAllocator(total)
            # host mirror of cache["tables"]; the sentinel `total` (one
            # past the pool) makes unallocated pages' writes drop
            self._host_tables = np.full((batch_size, self.kv_pages), total,
                                        np.int32)
            self._slot_blocks: List[List[int]] = [
                [] for _ in range(batch_size)]
        # calibration feeds the static programs of the int8-activation
        # modes (skipped, digest included, when both paths stay eager);
        # w4a8 shares w8a8's activation scales, and the digest carries the
        # weight mode so their programs key distinct lines
        batches = None
        if (calib_batches is not None and eng.quant in ("w8a8", "w4a8")
                and self.compiled):
            batches = [torch.as_tensor(np.asarray(b), dtype=torch.int64,
                                       device=self.device)
                       for b in calib_batches]
        self.calib_batches = batches
        self.digest_s = 0.0
        self.calib_id = None
        if batches is not None:
            t0 = time.perf_counter()
            self.calib_id = calibration_digest(
                batches, self._float_params,
                weight_mode=eng_lib.weight_mode(eng))
            self.digest_s = time.perf_counter() - t0
        self._scales = None           # one calibration run, both programs
        self._sched = SlotScheduler(batch_size)
        self.serve_stats = LMServeStats(batch=batch_size)

    # -- compiled programs ---------------------------------------------------

    def lowering_blockers(self) -> List[str]:
        return compiler.lowering_blockers(self.arch)

    def _lm_scales(self):
        """The shared calibration run (graph node ids line up between the
        prefill and decode programs)."""
        if self._scales is None:
            self._scales = compiler.calibrate_lm(
                self.arch, self._float_params, self.calib_batches)
        return self._scales

    def _prefill_key(self):
        return self._program_key(self.arch, self.calib_id, tag="prefill")

    def _decode_key(self):
        # the page size rides the key: paged and dense decode programs hold
        # distinct ProgramCache lines
        tag = "decode" + (f":p{self.page_size}" if self.paged else "")
        return self._program_key(self.arch, self.calib_id, tag=tag)

    def _compile_mode(self, mode: str) -> ex.Program:
        page = self.page_size if (self.paged and mode == "decode") else 0
        scales = (self._lm_scales() if self.calib_batches is not None
                  else None)
        return compiler.compile_lm(self.arch, scales=scales, mode=mode,
                                   page_size=page)

    def prefill_program(self) -> ex.Program:
        """The compiled prefill program: ProgramCache hit, or compile."""
        return self._cached_program(self._prefill_key(),
                                    lambda: self._compile_mode("prefill"))

    def decode_program(self) -> ex.Program:
        """The compiled DecodeStep program: ProgramCache hit, or compile."""
        return self._cached_program(self._decode_key(),
                                    lambda: self._compile_mode("decode"))

    def _prefill_dense(self, program, cache, tokens, mask):
        """Prefill the refilled slots and merge their fresh cache rows
        into the live cache (per-slot row select on every [B, ...] tensor,
        per-slot position) -- the reference's prefill + merge."""
        kvs: Dict[int, tuple] = {}
        logits = ex.execute(program, self.params, tokens, self.eng,
                            collect=kvs)
        m = mask.reshape(-1, 1, 1, 1)
        layers = []
        for i, entry in enumerate(cache["layers"]):
            fresh = {name: torch.zeros_like(t) for name, t in entry.items()}
            k, v = kvs[i]
            if self.arch.layer_kind(i) == "local":
                w = fresh["k"].shape[1]
                k, v = k[:, -w:], v[:, -w:]
            fresh = T._kv_store(fresh, k, v, 0, self.eng)
            layers.append({name: torch.where(m, fresh[name], entry[name])
                           for name in entry})
        pos = torch.where(mask, torch.full_like(cache["pos"],
                                                tokens.shape[1]),
                          cache["pos"])
        return logits, {"layers": layers, "pos": pos}

    def _prefill_paged(self, program, cache, tokens, mask):
        """Prefill the refilled slots and scatter their k / v spans through
        the block table into the live pool (other rows' writes drop)."""
        kvs: Dict[int, tuple] = {}
        logits = ex.execute(program, self.params, tokens, self.eng,
                            collect=kvs)
        m = mask.reshape(-1, 1, 1, 1)
        layers = []
        for i, entry in enumerate(cache["layers"]):
            k, v = kvs[i]
            if self.arch.layer_kind(i) == "local":
                w = entry["k"].shape[1]
                fresh = {name: torch.zeros_like(t)
                         for name, t in entry.items()}
                fresh = T._kv_store(fresh, k[:, -w:], v[:, -w:], 0, self.eng)
                entry = {name: torch.where(m, fresh[name], entry[name])
                         for name in entry}
            else:
                entry = T._paged_prefill_store(entry, k, v, cache["tables"],
                                               mask, self.eng,
                                               self.page_size)
            layers.append(entry)
        pos = torch.where(mask, torch.full_like(cache["pos"],
                                                tokens.shape[1]),
                          cache["pos"])
        return logits, {"layers": layers, "tables": cache["tables"],
                        "pos": pos}

    def _prefill_eager(self, cache, tokens, mask):
        """The eager prefill of the refilled slots on a fresh cache, merged
        into the live cache (the reference's jprefill + jmerge)."""
        logits, fresh = T.prefill(self.params, self._empty_cache(),
                                  {"tokens": tokens}, self.arch, self.eng)
        return logits, _merge(cache, fresh, mask)

    def _decode_step(self, cache, tokens):
        if not self.compiled:
            return T.decode(self.params, cache, tokens, self.arch, self.eng)
        return ex.execute_decode(self.decode_program(), self.params, cache,
                                 tokens, self.eng)

    # -- request queue / continuous batching ---------------------------------

    def _empty_cache(self):
        if self.paged:
            cs = T.paged_cache_schema(self.arch, self.batch, self.max_seq,
                                      self.eng, self.page_size,
                                      num_blocks=self.alloc.num_blocks)
        else:
            cs = T.cache_schema(self.arch, self.batch, self.max_seq,
                                self.eng)
        cache = T.zeros_from_schema(cs, self.device)
        if self.paged:
            cache["tables"] = torch.from_numpy(self._host_tables).to(
                self.device)
        cache["pos"] = torch.zeros(self.batch, dtype=torch.int32,
                                   device=self.device)
        return cache

    def submit(self, prompt, max_new_tokens: int = 16):
        """Queue one prompt; returns its ticket, or a falsy SubmitRejection
        when the request cannot be served (over max_seq, or over the paged
        pool's total capacity)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_seq:
            self.serve_stats.rejected_requests += 1
            return SubmitRejection(
                reason="over_length",
                detail=(f"prompt ({len(prompt)}) + max_new_tokens "
                        f"({max_new_tokens}) exceeds "
                        f"max_seq={self.max_seq}"),
                prompt_len=len(prompt), max_new_tokens=int(max_new_tokens))
        if self.paged:
            need = T.num_pages(len(prompt) + max_new_tokens, self.page_size)
            if need > self.alloc.num_blocks:
                self.serve_stats.rejected_requests += 1
                return SubmitRejection(
                    reason="over_capacity",
                    detail=(f"request needs {need} KV blocks but the pool "
                            f"holds {self.alloc.num_blocks} total"),
                    prompt_len=len(prompt),
                    max_new_tokens=int(max_new_tokens))
        ticket = self._sched.submit(_LM, (prompt, int(max_new_tokens)))
        self.latency.submitted(ticket)
        return ticket

    def pending(self) -> int:
        return self._sched.pending(_LM)

    def _blocks_needed(self, plen: int, mnt: int) -> int:
        """Blocks covering positions [0, padded prompt + new tokens), capped
        at max_seq (writes past it drop, as in the dense cache)."""
        return T.num_pages(min(plen + mnt, self.max_seq), self.page_size)

    def _admit(self, nfree: int, plen: int):
        """FIFO admission: dense takes up to `nfree` queued requests; paged
        also gates each on free blocks, head of line (arrival order is the
        serving contract), counting what this wave already reserved."""
        if not self.paged:
            return self._sched.take(_LM, limit=nfree)
        taken, reserved = [], 0
        while len(taken) < nfree and self._sched.pending(_LM):
            _, mnt = self._sched.peek(_LM)[0]
            need = self._blocks_needed(plen, mnt)
            if not self.alloc.can_allocate(reserved + need):
                break                 # backpressure: wait for frees
            reserved += need
            taken.extend(self._sched.take(_LM, limit=1))
        return taken

    def _bind_blocks(self, slot: int, plen: int, mnt: int) -> None:
        """Bind an admitted request's blocks into its slot's table row (the
        host mirror, pushed to the device at the admission edge)."""
        need = self._blocks_needed(plen, mnt)
        blocks = self.alloc.alloc(need)
        self._slot_blocks[slot] = blocks
        row = np.full(self.kv_pages, self.alloc.num_blocks, np.int32)
        row[:need] = blocks
        self._host_tables[slot] = row

    def _release_blocks(self, slot: int) -> None:
        """Response edge: return the slot's blocks and clear its row to the
        drop sentinel, so the dead slot's writes land nowhere."""
        self.alloc.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._host_tables[slot] = self.alloc.num_blocks

    def _ensure_admissible(self, plen: int) -> None:
        """The queue is non-empty, no slot is active and admission took
        nothing: the pool itself is too small."""
        if self.paged and self.alloc.in_use == 0:
            _, mnt = self._sched.peek(_LM)[0]
            raise RuntimeError(
                f"queued request needs {self._blocks_needed(plen, mnt)} KV "
                f"blocks but the pool holds {self.alloc.num_blocks} total; "
                "raise kv_blocks or shrink the request")

    def run(self) -> Dict[int, np.ndarray]:
        """Serve the queue to completion with continuous batching: prefill
        fills free slots, decode bursts advance every slot one token per
        step, finished slots refill between bursts.  Returns {ticket:
        greedy token ids}.  Every prompt left-pads to ONE prefill width
        (`prefill_len`, or the longest queued prompt).  Emitted tokens stay
        on the device as one [B, burst] block per burst; the host copies a
        block only when some slot's request completes."""
        with torch.inference_mode():
            return self._run()

    def _run(self) -> Dict[int, np.ndarray]:
        results: Dict[int, np.ndarray] = {}
        sched, B = self._sched, self.batch
        if not sched.pending(_LM):
            return results
        plen = self.prefill_len
        if plen is None:
            plen = max(len(p) for p, _ in sched.peek(_LM))
        if self.compiled:
            program = self.prefill_program()
            self.decode_program()
            fill = self._prefill_paged if self.paged else self._prefill_dense

            def prefill(cache, toks, mask):
                return fill(program, cache, toks, mask)
        else:
            prefill = self._prefill_eager

        cache = self._empty_cache()
        dev = self.device
        cur = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        tickets: List[Optional[int]] = [None] * B
        remaining = np.zeros(B, np.int64)
        start = np.zeros(B, np.int64)     # slot's first global step
        step = 0                          # global decode-step counter
        blocks: List[list] = []           # [start step, [B, w] device toks]
        block_np: Dict[int, np.ndarray] = {}

        def tokens_for(slot: int, lo: int, hi: int) -> np.ndarray:
            parts = []
            for s0, blk in blocks:
                w = blk.shape[1]
                if s0 + w <= lo or s0 >= hi:
                    continue
                arr = block_np.get(id(blk))
                if arr is None:
                    arr = block_np[id(blk)] = blk.cpu().numpy()
                parts.append(arr[slot, max(lo - s0, 0):min(hi - s0, w)])
            return (np.concatenate(parts).astype(np.int32) if parts
                    else np.zeros(0, np.int32))

        while True:
            free = [i for i in range(B) if remaining[i] == 0]
            if free and sched.pending(_LM):
                taken = self._admit(len(free), plen)
                if taken:
                    toks = np.zeros((B, plen), np.int32)
                    mask = np.zeros(B, bool)
                    for slot, (ticket, (prompt, mnt)) in zip(free, taken):
                        if len(prompt) > plen:
                            raise ValueError(
                                f"prompt of length {len(prompt)} exceeds the "
                                f"run's fixed prefill width {plen} (set "
                                f"prefill_len at construction)")
                        toks[slot, plen - len(prompt):] = prompt
                        mask[slot] = True
                        if tickets[slot] is not None:
                            self.serve_stats.slot_refills += 1
                        tickets[slot] = ticket
                        remaining[slot] = mnt
                        start[slot] = step
                        if self.paged:
                            self._bind_blocks(slot, plen, mnt)
                    jmask = torch.from_numpy(mask).to(dev)
                    if self.paged:
                        # admission edge: push the host table (new rows AND
                        # rows cleared at response edges) before any write
                        cache["tables"] = torch.from_numpy(
                            self._host_tables).to(dev)
                    logits, cache = prefill(
                        cache, torch.from_numpy(toks).to(dev), jmask)
                    self.serve_stats.prefill_tokens_computed += (
                        len(taken) * plen)
                    first = torch.argmax(logits[:, -1, :], dim=-1)
                    cur = torch.where(jmask[:, None], first[:, None].to(
                        torch.int32), cur)
                    self.serve_stats.prefill_calls += 1
                    self.serve_stats.requests += len(taken)
                    sched.next_epoch()

            act = [i for i in range(B) if remaining[i] > 0]
            if not act:
                if sched.pending(_LM):
                    self._ensure_admissible(plen)
                    continue
                break
            burst = int(min(self.decode_burst,
                            min(remaining[i] for i in act)))
            cols = []
            for _ in range(burst):
                cols.append(cur)          # emitted token, still on device
                logits, cache = self._decode_step(cache, cur)
                cur = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
                    torch.int32)
                self.serve_stats.decode_steps += 1
                self.serve_stats.active_slot_steps += len(act)
            blocks.append([step, cols[0] if burst == 1
                           else torch.cat(cols, dim=1)])
            step += burst
            finished = False
            for i in act:
                remaining[i] -= burst
                if remaining[i] == 0:     # response edge for this ticket
                    results[tickets[i]] = tokens_for(i, int(start[i]), step)
                    self.latency.completed(tickets[i])
                    if self.paged:
                        self._release_blocks(i)
                    finished = True
            if finished:
                # drop blocks every live slot is past (bounded in flight)
                live = [int(start[i]) for i in range(B) if remaining[i] > 0]
                lo = min(live) if live else step
                keep = [b for b in blocks if b[0] + b[1].shape[1] > lo]
                kept = {id(b[1]) for b in keep}
                for b in blocks:
                    if id(b[1]) not in kept:
                        block_np.pop(id(b[1]), None)
                blocks = keep
        return results

    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int = 16) -> List[np.ndarray]:
        """Greedy generation for a batch of requests, in submission order
        (submit() + run())."""
        tickets = [self.submit(p, max_new_tokens) for p in prompts]
        rejected = [t for t in tickets if isinstance(t, SubmitRejection)]
        if rejected:
            raise ValueError(f"{len(rejected)} of {len(prompts)} prompts "
                             f"rejected: {rejected[0].detail}")
        results = self.run()
        return [results[t] for t in tickets]

    # -- stats ---------------------------------------------------------------

    def _kv_memory(self) -> Dict[str, float]:
        """KV-cache footprint: bytes of global-layer KV state, and bytes one
        request occupies (dense: the max_seq envelope every slot reserves;
        paged: mean blocks held per admitted request)."""
        per_pos = 2 * self.arch.n_kv_heads * self.arch.head_dim * 2  # bf16
        n_glb = sum(1 for i in range(self.arch.n_layers)
                    if self.arch.layer_kind(i) == "global")
        if self.paged:
            block_bytes = self.page_size * per_pos * n_glb
            st = self.alloc.stats
            per_slot = (block_bytes * st.blocks_served / st.allocs
                        if st.allocs else float(block_bytes * self.kv_pages))
            return {"kv_bytes": float(block_bytes * self.alloc.num_blocks),
                    "kv_bytes_per_slot": per_slot,
                    "kv_block_bytes": float(block_bytes)}
        per_slot = float(self.max_seq * per_pos * n_glb)
        return {"kv_bytes": per_slot * self.batch,
                "kv_bytes_per_slot": per_slot}

    def stats(self) -> Dict[str, object]:
        s = self.serve_stats
        out = {"arch": self.arch.name, "compiled_prefill": self.compiled,
               "compiled_decode": self.compiled,
               "kv_layout": self.kv_layout,
               "lowering_blockers": self.lowering_blockers(),
               "calibration_digest_s": self.digest_s}
        out.update(self.cache_stats())
        out.update({
            "requests": s.requests,
            "prefill_calls": s.prefill_calls,
            "decode_steps": s.decode_steps,
            "slot_refills": s.slot_refills,
            "slot_refill_rate": s.refill_rate,
            "slot_occupancy": s.slot_occupancy,
            "rejected_requests": s.rejected_requests,
            "prefill_tokens_computed": s.prefill_tokens_computed,
            "latency_ms": self.latency.percentiles(),
        })
        out.update(self._kv_memory())
        if self.paged:
            out["page_size"] = self.page_size
            out["kv_blocks"] = self.alloc.describe()
        for tag, key in (("prefill", self._prefill_key()),
                         ("decode", self._decode_key())):
            program = self.cache.peek(key)
            if program is not None and program.schedule is not None:
                out[f"{tag}_levels"] = len(program.schedule.levels)
        return out
