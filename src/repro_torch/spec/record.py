"""Record an ``AcceptanceTrace`` from a real draft/target run.

A :class:`AcceptanceRecorder` accumulates the (position, accepted-length)
pairs ``TorchBackend`` produces while serving a workload through a
speculating ``ServingEngine`` in *verify* mode (no trace replay: accepted
length = how many draft proposals the target's greedy verification really
matched).  The histogram is the artifact: per position bucket, the
observed distribution over accepted lengths 0..k.

CLI: ``python -m repro_torch.profiler record-acceptance --arch <arch>
[--draft-arch <arch>]`` (also ``profile --spec`` to ride along with a
hardware profile).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.spec.trace import AcceptanceTrace


class AcceptanceRecorder:
    """Host-side accumulator for (position, accepted) observations.

    ``enabled`` gates accumulation at runtime so warmup traffic can be
    excluded (spec steps only run from scheduled work, but the gate keeps
    the contract symmetric with ``repro_torch.moe.record.RoutingRecorder``).
    """

    def __init__(self, k: int, period: int = 256):
        self.k = int(k)
        self.period = int(period)
        self.hist = np.zeros((self.period, self.k + 1), np.int64)
        self.enabled = True

    def observe(self, position: int, accepted: int):
        if not self.enabled:
            return
        a = int(min(max(accepted, 0), self.k))
        self.hist[int(position) % self.period, a] += 1

    def to_trace(self, model: str = "*", draft: str = "*",
                 meta: Optional[Dict] = None) -> AcceptanceTrace:
        """Distill the histogram into an artifact.  Position buckets with
        no observations fall back to the trace-global distribution (every
        recorded trace has at least one observation — an empty recorder
        is an error, not a fabricated artifact)."""
        total = self.hist.sum(axis=0)
        if total.sum() == 0:
            raise ValueError(
                "AcceptanceRecorder saw no spec steps — record through a "
                "speculating engine (ServingEngine(spec=...)) first")
        hist = self.hist.astype(float)
        unseen = hist.sum(axis=1) == 0
        hist[unseen] = total / total.sum()
        info = {"source": "recorded", "period": self.period,
                "observations": int(self.hist.sum())}
        info.update(meta or {})
        return AcceptanceTrace(model=model, draft=draft, k=self.k,
                               hist=hist, meta=info).validate()


def record_acceptance(arch: str, draft_arch: Optional[str] = None, *,
                      k: int = 4, n_requests: int = 8, rate: float = 50.0,
                      max_batch: int = 4, max_len: int = 256,
                      period: int = 256, seed: int = 0,
                      draft_seed: int = 1, mean_prompt: int = 40,
                      mean_output: int = 8,
                      device=None) -> AcceptanceTrace:
    """Serve a synthetic workload through a speculating engine (real
    draft proposals, real batched target verification) and distill the
    observed acceptance lengths into an artifact.

    ``draft_arch`` defaults to the target architecture itself with a
    different parameter seed — the smallest self-contained draft/target
    pair this container can run; pass a genuinely smaller arch for
    realistic acceptance dynamics.  The engines run on the card unless
    ``device="cpu"``.
    """
    from repro_torch.configs import get_config
    from repro_torch.serve.driver import ServeDriver
    from repro_torch.serve.engine import ServingEngine, SpecDecodeCfg
    from repro_torch.workload import ShareGPTConfig, generate

    cfg = get_config(arch)
    draft_cfg = get_config(draft_arch) if draft_arch else cfg
    recorder = AcceptanceRecorder(k, period=period)
    eng = ServingEngine(
        cfg, max_batch=max_batch, max_len=max_len, name="rec0", seed=seed,
        spec=SpecDecodeCfg(draft=draft_cfg, k=k, draft_seed=draft_seed,
                           recorder=recorder), device=device)
    drv = ServeDriver([eng])
    drv.runtime.warmup()
    reqs = generate(ShareGPTConfig(
        n_requests=n_requests, rate=rate, vocab=cfg.vocab, seed=seed,
        mean_prompt=mean_prompt, mean_output=mean_output,
        max_prompt=max(max_len // 4, 16), max_output=max(mean_output, 4)))
    drv.runtime.submit_workload(reqs)
    drv.runtime.run()
    return recorder.to_trace(model=cfg.name, draft=draft_cfg.name,
                             meta={"arch": arch,
                                   "draft_arch": draft_arch or arch,
                                   "n_requests": n_requests, "seed": seed})
