"""End-to-end training launcher with the fault-tolerance loop (the port's
copy of repro.launch.train), on one device: the card unless `--device
cpu`.

Fault-tolerance features:
  * checkpoint/restart: atomic async checkpoints every --ckpt-every steps;
    with --resume, training continues from the latest checkpoint (params,
    optimizer state and step, which is also the data pipeline's position:
    the batch of step k is a function of (seed, k)).
  * preemption: SIGTERM / SIGINT trigger a final synchronous checkpoint
    before exit (code 75).
  * straggler watchdog: a step slower than --step-timeout seconds saves a
    checkpoint and exits with code 75 (EX_TEMPFAIL: reschedule me).

Multi-host launches (--coordinator) join with the multi-device slice.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 8 --batch 8 --seq 128            # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --device cpu --steps 20          # reduced, on the CPU
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.core import engine as eng_lib
from repro_torch.core.config import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
from repro_torch.models import params as prm
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--remat", default="none")
    ap.add_argument("--step-timeout", type=float, default=0.0)
    ap.add_argument("--coordinator", default="",
                    help="host:port of a multi-host launch (not ported)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the float GEMM kernel) or cpu")
    args = ap.parse_args(argv)

    if args.coordinator:
        raise NotImplementedError("multi-host training joins with the "
                                  "multi-device slice")
    dev = torch.device(args.device)
    arch = configs.get_arch(args.arch)
    if args.smoke:
        arch = configs.reduced(arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatches=args.microbatches, remat=args.remat,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                       step_timeout_s=args.step_timeout)
    eng = eng_lib.train_engine()

    params = prm.init_params(T.lm_schema(arch),
                             torch.Generator().manual_seed(tcfg.seed),
                             device=dev)
    state = init_train_state(params)

    mgr = ckpt_lib.CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts,
                                     async_save=tcfg.async_ckpt)
    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        state = mgr.restore(state, device=dev)
        start_step = int(state["opt"]["step"])
        print(f"resumed from step {start_step}", flush=True)

    pipe = SyntheticTokens(arch, shape, PipelineConfig(seed=tcfg.seed))
    step_fn = make_train_step(arch, eng, tcfg)

    # --- preemption protocol -------------------------------------------------
    preempted = {"flag": False}

    def _handler(signum, frame):
        preempted["flag"] = True
        print(f"signal {signum}: checkpoint-and-exit requested", flush=True)

    prev_term = signal.signal(signal.SIGTERM, _handler)
    prev_int = signal.signal(signal.SIGINT, _handler)

    losses = []
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, pipe.batch_at(step))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"{dt * 1e3:7.1f} ms", flush=True)
            if tcfg.step_timeout_s and dt > tcfg.step_timeout_s:
                print(f"STRAGGLER: step took {dt:.1f}s > "
                      f"{tcfg.step_timeout_s:.1f}s; checkpointing and "
                      f"aborting for reschedule", flush=True)
                mgr.save(step + 1, state)
                mgr.wait()
                return 75                      # EX_TEMPFAIL: reschedule me
            if (step + 1) % tcfg.ckpt_every == 0:
                mgr.save(step + 1, state)
            if preempted["flag"]:
                mgr.save(step + 1, state)
                mgr.wait()
                print("preemption checkpoint complete", flush=True)
                return 75
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)
    mgr.save(args.steps, state)
    mgr.wait()
    if len(losses) >= 5:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"(improved={losses[-1] < losses[0]})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
