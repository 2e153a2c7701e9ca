"""Fault-tolerant training driver, the counterpart of
``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch demo-110m \
      --steps 300
  PYTHONPATH=src python -m repro_torch.launch.train --arch demo-110m --resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch demo-10m \
      --device cpu --steps 4 --seq 32

Trains on the card by default (``--device cpu`` runs on the CPU): f32
params drawn from a ``torch.Generator`` seeded 0 on the device, the
synthetic token stream of ``repro_torch.workload.datasets``, AdamW under a
cosine schedule, attention through the flash kernel and its backward
kernel.  Checkpoints are atomic and in the JAX package's layout; kill the
process at any step and ``--resume`` continues from the last durable
checkpoint, skipping the batches already consumed, so a resumed run sees
the same data as an uninterrupted one.  One device, as the JAX
package's trainer, which builds no mesh and jits its step on one device.
Data- and tensor-parallel training is ``make_train_step(..., grid=)`` on
the ranks of a grid (``repro_torch.launch.mesh.run_ranks(fn, tp, dp=)``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN_MLP, ArchConfig, simple_stages
from repro_torch.models import Model
from repro_torch.train import (AdamW, TrainStepConfig, cosine_schedule,
                               init_state, make_train_step)
from repro_torch.train import checkpoint as ckpt
from repro_torch.workload.datasets import DataConfig, token_batches

# ~110M-parameter demo config (the "train a ~100M model" driver)
DEMO_110M = ArchConfig(
    name="demo-110m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_head=64, d_ff=2048, vocab=16384,
    stages=simple_stages(ATTN_MLP, 12))


def get_train_config(name: str) -> ArchConfig:
    if name == "demo-110m":
        return DEMO_110M
    if name == "demo-10m":
        return dataclasses.replace(
            DEMO_110M, name="demo-10m", n_layers=4, d_model=256, n_heads=4,
            d_ff=768, vocab=4096, stages=simple_stages(ATTN_MLP, 4))
    return get_config(name)


def _device_batch(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(arch: str = "demo-10m", *, steps: int = 40, batch: int = 8,
          seq: int = 128, lr: float = 3e-3, ckpt_dir: str = "checkpoints",
          ckpt_every: int = 20, resume: bool = False, microbatches: int = 1,
          grad_compress: bool = False, device: Optional[str] = None,
          log=print) -> dict:
    """Run the driver; returns ``{"losses", "state", "start", "step_s"}``
    (``step_s``: each step's wall time, ending when the step's loss is on
    the host).  The model is built with ``remat=False``, as the JAX
    driver builds it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: CUDA is not available; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    cfg = get_train_config(arch)
    model = Model(cfg, remat=False)
    optimizer = AdamW(lr=cosine_schedule(lr, 20, steps))
    step_fn = make_train_step(
        model, optimizer, TrainStepConfig(microbatches=microbatches,
                                          grad_compress=grad_compress))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(model, optimizer, gen, device=dev)
    start = 0
    if resume:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            state = ckpt.restore(ckpt_dir, latest, state)
            start = latest
            log(f"resumed from step {latest}")

    data = token_batches(DataConfig(vocab=cfg.vocab, batch=batch,
                                    seq_len=seq, seed=0))
    # deterministic resume: skip consumed batches
    for _ in range(start):
        next(data)

    losses, step_s = [], []
    t0 = time.time()
    for step in range(start, steps):
        b = _device_batch(next(data), dev)
        ts = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])       # waits for the step
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            path = ckpt.save(ckpt_dir, step + 1, state)
            log(f"step {step+1}: loss={loss:.4f} "
                f"grad_norm={float(metrics['grad_norm']):.3f} ckpt={path}")
        elif (step + 1) % 10 == 0:
            log(f"step {step+1}: loss={loss:.4f}")
    dt = time.time() - t0
    if losses:
        log(f"done: {steps - start} steps in {dt:.1f}s "
            f"({dt / max(steps - start, 1):.2f}s/step); "
            f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"losses": losses, "state": state, "start": start,
            "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo-10m")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                microbatches=args.microbatches,
                grad_compress=args.grad_compress, device=args.device,
                log=lambda s: print(s, flush=True))
    losses = out["losses"]
    assert losses[-1] < losses[0], "loss did not decrease"


if __name__ == "__main__":
    main()
