"""Serving driver CLI: the PyTorch engine(s) with batched requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \
      --n 8 --max-batch 8 --max-len 2048 --chunked-prefill

Runs on the card by default; ``--device cpu`` runs on the CPU (use a
``-tiny`` arch there).  The flags are those of the JAX package's CLI
(``src/repro/launch/serve.py``); ``--pd`` serves one prefill and one
decode engine that share their weights.  ``--prefix-cache`` and ``--tp``
> 1 are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
from repro_torch.workload import ShareGPTConfig, generate


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    reqs = generate(ShareGPTConfig(
        n_requests=args.n, rate=args.rate, vocab=cfg.vocab,
        mean_prompt=90, mean_output=24, max_prompt=args.max_len // 2,
        max_output=48, share_fraction=0.5 if args.prefix_cache else 0.0))
    kw = dict(max_batch=args.max_batch, max_len=args.max_len,
              prefix_cache=args.prefix_cache, tp=args.tp,
              device=args.device)
    if args.pd:
        p0 = ServingEngine(cfg, name="p0", role="prefill", **kw)
        engines = [p0, ServingEngine(cfg, params=p0.params, name="d0",
                                     role="decode", **kw)]
        pd = {"p0": ("d0",)}
    else:
        e0 = ServingEngine(cfg, name="e0", **kw)
        engines = [e0] + [
            ServingEngine(cfg, params=e0.params, name=f"e{i}", **kw)
            for i in range(1, args.instances)]
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
    print(json.dumps(m, indent=1, default=float))


if __name__ == "__main__":
    main()
