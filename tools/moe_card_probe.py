"""Probe the MoE path on one H100: the card against the CPU in f32 training,
and the CUDA launches of one MoE layer.

    python3 tools/moe_card_probe.py [--src DIR] [--only grads|launches]
                                    [--out chiprun_out/moe_probe.json]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (to
count the launches of the parent's combine in the same call); the setups
come from this checkout's ``chip_smoke.py``.

1. ``grads``: tiny f32 phimini-moe with its published 16 experts and top-2
   (``chip_smoke.py`` phase 10's weights and batches) in one process, on
   the card and on the CPU: step 0's gradient of every leaf (the largest
   difference over the leaf's largest |g|); the router's top-k choices of
   every layer; each layer's dispatched buffer and MoE output (the largest
   difference over the largest value); the card's grouped-matmul kernels,
   forward and backward, against their plain version on the CPU on the
   card run's own inputs; then ``GRID_STEPS`` AdamW steps at
   ``TINY_TRAIN_LR`` on both, each step's gradient taken beside it: the
   largest gradient difference of each step, the params off by more than
   rtol 1e-4, atol 1e-5 after each step (counts by leaf), and every entry
   off after the last with its param differences, gradients, gradient
   differences and the CPU's Adam moments, step by step.
2. ``launches``: one bf16 ``moe_ffn`` forward (no gradient) at
   phimini-moe's widths (d 4096, 16 experts of 960, top-2) and at
   granite-moe-3b's (d 1536, 40 of 512, top-8), 8 and 256 tokens: the CUDA
   kernels ``torch.profiler`` sees and the ATen calls dispatched.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _spy(mod, name, record):
    """Wrap ``mod.name``, recording each call with ``record(args, out)``;
    returns the undo."""
    orig = getattr(mod, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        record(a, kw, out)
        return out
    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, orig)


def _names(tree, pre=""):
    """Leaf names in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k],
                                                        f"{pre}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [n for i, t in enumerate(tree) for n in _names(t,
                                                              f"{pre}/{i}")]
    return [] if tree is None else [pre.lstrip("/")]


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    top = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / top if top else 0.0


def grads_probe(torch, cs, card="cuda"):
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import (moe_gmm_bwd_plain,
                                             moe_gmm_plain)
    from repro_torch.models import Model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.train import (AdamW, TrainState, TrainStepConfig,
                                   make_train_step)
    from repro_torch.train.tree import leaves, map_tree
    arch = "phimini-moe-tiny"
    cfg = cs._se_tiny_cfg(arch)
    params = Model(cfg).init(torch.Generator().manual_seed(3))
    batches = cs._tiny_batches(cfg, n=cs.GRID_STEPS, seed=16)
    names = _names(params)

    def step0(dev):
        rec = {"route": [], "buf": [], "y": [], "gmm": []}
        undo = [
            _spy(moe_mod, "router_topk",
                 lambda a, kw, o: rec["route"].append(o[0].cpu())),
            _spy(moe_mod, "grouped_matmul",
                 lambda a, kw, o: rec["gmm"].append(
                     tuple(t.detach().clone() for t in a))),
            _spy(transformer, "moe_ffn",
                 lambda a, kw, o: (rec["buf"].append(a[0].detach().cpu()),
                                   rec["y"].append(o[0].detach().cpu()))),
        ]
        try:
            model = Model(cfg, remat=True)
            p = map_tree(lambda t: t.detach().to(dev).clone()
                         .requires_grad_(), params)
            total, _ = model.loss_fn(p, {k: v.to(dev)
                                         for k, v in batches[0].items()})
            g = torch.autograd.grad(total, leaves(p))
        finally:
            for u in undo:
                u()
        return float(total.detach()), [t.detach().cpu() for t in g], rec

    loss_cpu, g_cpu, rec_cpu = step0("cpu")
    loss_gpu, g_gpu, rec_gpu = step0(card)
    n = len(rec_cpu["route"])            # router calls (remat: twice each)
    out = {"arch": arch, "experts": cfg.moe.n_experts,
           "top_k": cfg.moe.top_k, "loss_cpu": loss_cpu,
           "loss_card": loss_gpu,
           "grad_rel": {k: _rel(a, b) for k, a, b in zip(names, g_gpu,
                                                         g_cpu)},
           "route_differs": [int((a != b).sum()) for a, b in
                             zip(rec_gpu["route"], rec_cpu["route"])],
           "moe_in_rel": [_rel(a, b) for a, b in zip(rec_gpu["buf"],
                                                     rec_cpu["buf"])],
           "moe_out_rel": [_rel(a, b) for a, b in zip(rec_gpu["y"],
                                                      rec_cpu["y"])],
           "router_calls": n}
    # the card's grouped-matmul kernels on the card run's own inputs
    gen = torch.Generator().manual_seed(5)
    fwd, bwd = [], []
    for x, w, gs in rec_gpu["gmm"]:
        fwd.append(_rel(ops.moe_gmm(x, w, gs),
                        moe_gmm_plain(x.cpu(), w.cpu(), gs.cpu())))
        dy = torch.randn(x.shape[:2] + (w.shape[2],), generator=gen)
        got = ops.moe_gmm_bwd(x, w, gs, dy.to(x.device))
        want = moe_gmm_bwd_plain(x.cpu(), w.cpu(), gs.cpu(), dy)
        bwd.append([_rel(a, b) for a, b in zip(got, want)])
    out["gmm_fwd_rel"], out["gmm_bwd_rel"] = fwd, bwd
    # GRID_STEPS AdamW steps on both, as phase 10's reference, each step's
    # gradient taken beside it at the step's params
    hist = {}
    for dev in ("cpu", card):
        opt = AdamW(lr=cs.TINY_TRAIN_LR)
        model = Model(cfg, remat=True)
        p = map_tree(lambda t: t.detach().to(dev).clone(), params)
        state = TrainState(p, opt.init(p))
        step = make_train_step(model, opt, TrainStepConfig())
        gs, ps, ms, vs = [], [], [], []
        for b in batches:
            b = {k: v.to(dev) for k, v in b.items()}
            pg = map_tree(lambda t: t.detach().clone().requires_grad_(),
                          state.params)
            total, _ = model.loss_fn(pg, b)
            gs.append([t.cpu() for t in torch.autograd.grad(total,
                                                            leaves(pg))])
            state, _ = step(state, b)
            ps.append([t.detach().cpu().clone()
                       for t in leaves(state.params)])
            ms.append([t.detach().cpu().clone()
                       for t in leaves(state.opt.mu)])
            vs.append([t.detach().cpu().clone()
                       for t in leaves(state.opt.nu)])
        hist[dev] = gs, ps, ms, vs
    (g_c, p_c, m_c, v_c), (g_g, p_g, _, _) = hist["cpu"], hist[card]
    out["grad_rel_by_step"] = [max(_rel(a, b) for a, b in zip(ga, gb))
                               for ga, gb in zip(g_g, g_c)]
    off, entries = {}, []
    for i, k in enumerate(names):
        for t in range(len(batches)):
            a, b = p_g[t][i], p_c[t][i]
            bad = (a - b).abs() > 1e-5 + 1e-4 * b.abs()
            if bad.any():
                off.setdefault(k, {})[f"after step {t}"] = int(bad.sum())
        bad = ((p_g[-1][i] - p_c[-1][i]).abs()
               > 1e-5 + 1e-4 * p_c[-1][i].abs()).reshape(-1)
        for j in bad.nonzero().reshape(-1).tolist():
            entries.append({
                "leaf": k, "index": j,
                "dp": [float((p_g[t][i] - p_c[t][i]).reshape(-1)[j])
                       for t in range(len(batches))],
                "g": [float(g_c[t][i].reshape(-1)[j])
                      for t in range(len(batches))],
                "dg": [float((g_g[t][i] - g_c[t][i]).reshape(-1)[j])
                       for t in range(len(batches))],
                "mu": [float(m_c[t][i].reshape(-1)[j])
                       for t in range(len(batches))],
                "nu": [float(v_c[t][i].reshape(-1)[j])
                       for t in range(len(batches))]})
    out["params_off"] = off
    out["params_off_entries"] = entries
    out["adam_eps"] = 1e-8
    return out


#: (name, d, experts, d_expert, top_k)
LAUNCH_LAYERS = (("phimini-moe top-2", 4096, 16, 960, 2),
                 ("granite-moe-3b top-8", 1536, 40, 512, 8))


def launches_probe(torch):
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models.moe import moe_ffn

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for name, d, E, de, k in LAUNCH_LAYERS:
        p = {"router": torch.randn((d, E), generator=gen, device=dev),
             **{w: (torch.randn(s, generator=gen, device=dev) * d ** -0.5)
                .bfloat16() for w, s in (("w_gate", (E, d, de)),
                                         ("w_up", (E, d, de)),
                                         ("w_down", (E, de, d)))}}
        for T in (8, 256):
            x = torch.randn((T, d), generator=gen, device=dev).bfloat16()
            with torch.no_grad():
                moe_ffn(x, p, top_k=k)                       # warm
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    moe_ffn(x, p, top_k=k)
                    torch.cuda.synchronize()
                Count.n = 0
                with Count():
                    moe_ffn(x, p, top_k=k)
            kern = [e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            out[f"{name} T{T}"] = {"cuda_kernels": len(kern),
                                   "aten_calls": Count.n,
                                   "kernels": kern}
        del p
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", choices=("grads", "launches"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("moe_card_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [args.src, str(ROOT)]
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    res = {"card": card, "src": args.src}
    probes = {"grads": lambda: grads_probe(torch, cs),
              "launches": lambda: launches_probe(torch)}
    for name, fn in probes.items():
        if args.only in (None, name):
            res[name] = fn()
    text = json.dumps(res, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    short = {k: v for k, v in res.items() if k != "launches"}
    if "launches" in res:
        short["launches"] = {k: {a: b for a, b in v.items()
                                 if a != "kernels"}
                             for k, v in res["launches"].items()}
    print(json.dumps(short))
    return 0


if __name__ == "__main__":
    sys.exit(main())
