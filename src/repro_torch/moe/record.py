"""Record an ``ExpertRoutingTrace`` from a real ``TorchBackend`` run.

The counterpart of ``repro/moe/record.py``.  The recording hook
(``repro_torch.moe.hooks.make_recording_hook``) hands every MoE layer's
routing decisions to a :class:`RoutingRecorder` while the unified runtime
serves a workload through the port's engine: bucketed prefill, extend and
batched decode, the production paths.  The recorder buckets observations
by token position (``position % period``) and distills them into the
deterministic per-layer assignment tables the artifact carries: for each
(layer, position bucket), the top-k most frequently observed experts.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.moe.trace import ExpertRoutingTrace, moe_layer_count


class RoutingRecorder:
    """Host-side accumulator for routed (layer, position, expert) triples.

    ``enabled`` gates accumulation: the recording hook calls ``tap`` only
    while it is set, so warmup traffic is excluded and costs no copies.
    """

    def __init__(self, n_layers: int, n_experts: int, top_k: int,
                 period: int = 256):
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.top_k = top_k
        self.period = period
        self.hist = np.zeros((n_layers, period, n_experts), np.int64)
        self.enabled = True

    def tap(self, layer, positions, expert_idx, valid=None):
        """One MoE layer's assignments for one executed batch (numpy).
        ``valid`` masks pad-tail rows and empty decode slots (the batch
        routes them too, but they are not workload tokens and must not
        bias the tables)."""
        if not self.enabled:
            return
        l = int(layer)
        if not 0 <= l < self.n_layers:
            return
        pos = np.asarray(positions).reshape(-1)
        idx = np.asarray(expert_idx).reshape(pos.size, -1)
        if valid is not None:
            keep = np.asarray(valid).reshape(-1).astype(bool)
            pos, idx = pos[keep], idx[keep]
        pos = pos % self.period
        for j in range(idx.shape[1]):
            np.add.at(self.hist[l], (pos, idx[:, j]), 1)

    def to_trace(self, model: str = "*",
                 meta: Optional[Dict] = None) -> ExpertRoutingTrace:
        """Distill the histograms into a deterministic artifact: per
        (layer, position) the top-k most observed experts (ties -> lower
        expert id); positions never observed fall back to the layer's
        global top-k."""
        layers = []
        for l in range(self.n_layers):
            h = self.hist[l]
            glob = np.argsort(-h.sum(axis=0), kind="stable")[:self.top_k]
            table = np.argsort(-h, axis=1, kind="stable")[:, :self.top_k]
            unseen = h.sum(axis=1) == 0
            table[unseen] = glob
            layers.append(table.astype(np.int32))
        info = {"source": "recorded", "period": self.period,
                "observations": int(self.hist.sum())}
        info.update(meta or {})
        return ExpertRoutingTrace(
            model=model, n_experts=self.n_experts, top_k=self.top_k,
            layers=layers, meta=info).validate()


def record_routing(arch: str, *, n_requests: int = 8, rate: float = 50.0,
                   max_batch: int = 4, max_len: int = 256,
                   period: int = 256, seed: int = 0,
                   mean_prompt: int = 40, mean_output: int = 8,
                   device=None) -> ExpertRoutingTrace:
    """Serve a synthetic workload through the port's engine (on the card;
    ``device="cpu"`` for the CPU) with a recording hook installed and
    distill the observed routing into an artifact."""
    from repro_torch.configs import get_config
    from repro_torch.moe.hooks import make_recording_hook
    from repro_torch.serve.driver import ServeDriver
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.workload import ShareGPTConfig, generate

    cfg = get_config(arch)
    if cfg.moe is None:
        raise ValueError(f"{arch!r} is not a MoE architecture; "
                         f"record-routing needs one")
    recorder = RoutingRecorder(moe_layer_count(cfg), cfg.moe.n_experts,
                               cfg.moe.top_k, period=period)
    recorder.enabled = False          # exclude warmup/compile traffic
    eng = ServingEngine(cfg, max_batch=max_batch, max_len=max_len,
                        name="rec0", seed=seed,
                        routing=make_recording_hook(recorder), device=device)
    drv = ServeDriver([eng])
    drv.runtime.warmup()
    recorder.enabled = True
    reqs = generate(ShareGPTConfig(
        n_requests=n_requests, rate=rate, vocab=cfg.vocab, seed=seed,
        mean_prompt=mean_prompt, mean_output=mean_output,
        max_prompt=max(max_len // 2, 16), max_output=max(mean_output, 4)))
    drv.runtime.submit_workload(reqs)
    drv.runtime.run()
    return recorder.to_trace(model=cfg.name,
                             meta={"arch": arch, "n_requests": n_requests,
                                   "seed": seed})
