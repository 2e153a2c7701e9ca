"""Serving driver CLI: the PyTorch engine(s) with batched requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \
      --n 8 --max-batch 8 --max-len 2048 --chunked-prefill

Runs on the card by default; ``--device cpu`` runs on the CPU (use a
``-tiny`` arch there).  The flags are those of the JAX package's CLI
(``src/repro/launch/serve.py``); ``--pd`` serves one prefill and one
decode engine that share their weights, and ``--prefix-cache`` gives each
engine the real radix prefix store (the workload then shares prefixes).
Speculative decoding: ``--spec-k K`` drafts K tokens a step with a draft
that shares the target's weights (always right: the mechanism, not a
speed-up), greedy-lossless, or replaying an acceptance trace synthesized
at ``--alpha``.

``--tp k`` spawns k ranks (``repro_torch.launch.mesh.run_ranks``), each
running the same driver on its shard of the same seeded weights: NCCL with
one card a rank (fewer cards than k refuse), gloo with ``--device cpu``.
Any k splits the heads (GSPMD's padded layout: ``launch/sharding.py``);
a k that ``sharding.unsupported`` names (a feed-forward width that does
not divide it) refuses.  The ranks' decisions must agree; rank 0's
metrics are printed.  ``--pd``,
``--prefix-cache`` and ``--spec-k`` combine with it: every engine of the
serve has the one ``--tp``, and rank r of the prefill engine hands off to
rank r of the decode engine.  Without a draft each engine draws the seeded
weights itself and keeps only its shard, so no full copy outlives its
construction; with one the full weights are the draft's (a tp = 1 engine
on every rank) and the target cuts its shard from them.  The JAX CLI has
one ``--tp``, and so has this one: a P/D pair of different tp is built
through ``ServeDriver``, its tp = 1 engine replicated on every rank with
the rank's group as its handle (``ServingEngine(tp=1, replicas=group)``).

The recurrent and hybrid families serve too (``--arch zamba2-1.2b``,
``--arch xlstm-125m``; their ``-tiny`` variants with ``--device cpu``),
at any ``--tp`` whose widths split (``launch.sharding.unsupported``:
zamba2-1.2b-tiny's ``d_ff`` 128 splits over 2 and 4, not 3, and
xlstm-125m-tiny's sLSTM width 85 over none);
with them the prefix store and speculative decoding refuse (ROADMAP queue
1 item 7).  xLSTM has no cached prefill, so under
``--chunked-prefill`` a prompt longer than one chunk (64) raises, as in
the JAX package.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.launch.sharding import unsupported
from repro_torch.models import Model
from repro_torch.models.transformer import torch_dtype
from repro_torch.serve import (DriverCfg, ServeDriver, ServingEngine,
                               SpecDecodeCfg)
from repro_torch.serve.engine import (refuse_unported_recurrent,
                                      resolve_device)
from repro_torch.workload import ShareGPTConfig, generate
from repro_torch.workload.acceptance import (AcceptanceConfig,
                                             synthesize_acceptance)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b-tiny")
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--rate", type=float, default=10.0)
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--pd", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--router", default="round_robin",
                    help="any registered routing policy "
                         "(round_robin | least_loaded | prefix_aware)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="continuous batching with chunked prefill on the "
                         "real engine (unified runtime scheduler)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens per step "
                         "(0: off)")
    ap.add_argument("--alpha", type=float, default=None,
                    help="replay an acceptance trace synthesized at this "
                         "per-token acceptance rate (default: greedy "
                         "acceptance)")
    args = ap.parse_args(argv)
    if args.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {args.tp}")
    try:
        refuse_unported_recurrent(get_config(args.arch),
                                  prefix_cache=args.prefix_cache,
                                  spec=args.spec_k or None)
    except NotImplementedError as e:
        raise SystemExit(f"--arch {args.arch}: {e}") from None
    why = unsupported(get_config(args.arch), args.tp)
    if why is not None:
        raise SystemExit(f"--tp {args.tp}: {why}")
    if args.tp == 1:
        m = serve(args)[0]
    else:
        from repro_torch.launch.mesh import run_ranks, visible_devices
        kind = torch.device(args.device).type
        n = visible_devices(kind)
        if n is not None and n < args.tp:
            raise SystemExit(f"--tp {args.tp} needs {args.tp} {kind} "
                             f"devices, one a rank, but {n} are visible")
        ranks = run_ranks(_serve_rank, args.tp, args, device=args.device)
        if any(d != ranks[0][1] for _, d in ranks):
            raise SystemExit(f"--tp {args.tp}: the ranks' decisions differ")
        m = ranks[0][0]
    print(json.dumps(m, indent=1, default=float))


def _serve_rank(group, args):
    return serve(args, group)


def serve(args, group=None):
    """Build the engines and serve: (metrics, decisions by instance).
    ``group``: this rank's engine group at ``--tp`` above 1."""
    cfg = get_config(args.arch)
    reqs = generate(ShareGPTConfig(
        n_requests=args.n, rate=args.rate, vocab=cfg.vocab,
        mean_prompt=90, mean_output=24, max_prompt=args.max_len // 2,
        max_output=48, share_fraction=0.5 if args.prefix_cache else 0.0))
    kw = dict(max_batch=args.max_batch, max_len=args.max_len,
              prefix_cache=args.prefix_cache, tp=args.tp,
              device=args.device if group is None else group.device,
              group=group)
    # the weights every engine shares (and a default draft with them);
    # at tp > 1 without a draft each engine draws them from the same seed
    # and keeps its shard (None), so the full draw is freed before the
    # engine's pools are allocated
    params = None
    if group is None or args.spec_k > 0:
        dev = resolve_device(kw["device"])
        params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 device=dev,
                                 dtype=torch_dtype(cfg.compute_dtype))
    spec = None
    if args.spec_k > 0:
        acceptance = None
        if args.alpha is not None:
            acceptance = synthesize_acceptance(
                AcceptanceConfig(alpha=args.alpha, k=args.spec_k),
                model=cfg.name)
        spec = SpecDecodeCfg(draft=cfg, k=args.spec_k,
                             acceptance=acceptance, draft_params=params)
    if args.pd:
        engines = [ServingEngine(cfg, params, name="p0", role="prefill",
                                 **kw),
                   ServingEngine(cfg, params, name="d0", role="decode",
                                 spec=spec, **kw)]
        pd = {"p0": ("d0",)}
    else:
        engines = [ServingEngine(cfg, params, name=f"e{i}", spec=spec, **kw)
                   for i in range(args.instances)]
        pd = None
    sched = None
    if args.chunked_prefill:
        from repro_torch.core.config import SchedulerCfg
        sched = SchedulerCfg(max_batch_size=args.max_batch,
                             max_batch_tokens=256,
                             chunked_prefill=True, prefill_chunk=64)
    drv = ServeDriver(engines, DriverCfg(router=args.router,
                                         scheduler=sched), pd_map=pd)
    m = drv.run(reqs)
    return m, {n: list(i.decisions)
               for n, i in drv.runtime.instances.items()}


if __name__ == "__main__":
    main()
