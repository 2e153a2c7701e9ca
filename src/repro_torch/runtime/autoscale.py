"""SLO-aware autoscaling: a policy evaluated on a fixed cadence that
watches per-tenant SLO attainment and queue depth, and scales the fleet
through the runtime's elastic-scaling primitives.

The policy is deliberately event-pure: every evaluation is an explicit
event on the simulation queue (hence a decode fast-forward barrier by
construction), every observation is taken at that event's simulated time,
and every action lands as another explicit event (``add_instance`` /
``remove_instance`` / ``rebalance_pd``).  Nothing reads wall-clock time or
draws randomness, so the decision sequence — and therefore the whole
simulation — is bit-identical between the fast path and exact stepped
mode, and between ``SimBackend`` and ``TorchBackend`` up to the time axis.

Scaling rules (classic target-tracking, kept simple on purpose — the
point is the *interface*: subclass and override ``decide``):

* scale OUT when the worst tenant's SLO attainment over the last window
  drops below ``target_attainment``, or the mean per-instance queue depth
  exceeds ``queue_high`` — whichever fires first;
* scale IN when attainment is healthy and mean queue depth falls below
  ``queue_low`` — the least-loaded instance is drained (in-flight work
  preempts and requeues) and retired;
* both respect ``min_instances`` / ``max_instances`` bounds and an
  optional ``cooldown_s`` between actions.

Only instances whose role matches the template's role participate in the
count and in victim selection, so a P/D fleet can autoscale its decode
pool while the prefill pool stays fixed; when a P/D map is live, pool
membership is re-published via ``rebalance_pd`` after every action.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.config import InstanceCfg
from repro_torch.core.metrics import slo_met


@dataclasses.dataclass(frozen=True)
class AutoscaleCfg:
    interval_s: float = 2.0          # evaluation cadence (simulated time)
    target_attainment: float = 0.95  # worst-tenant SLO floor before scale-out
    queue_high: float = 4.0          # mean queue depth triggering scale-out
    queue_low: float = 1.0           # mean queue depth allowing scale-in
    min_instances: int = 1
    max_instances: int = 64
    cooldown_s: float = 0.0          # min simulated time between actions
    name_prefix: str = "as"          # scale-out instances: as0, as1, ...


class SLOAutoscaler:
    """Evaluate ``AutoscaleCfg`` thresholds on cadence and act through the
    runtime's elastic-scaling events.  Attach via
    ``runtime.attach_autoscaler(SLOAutoscaler(cfg))`` (or the
    ``autoscale=`` argument of ``repro_torch.core.simulate``) before ``run``.

    ``template`` is the ``InstanceCfg`` cloned for scale-out instances
    (only the name changes); it defaults to the first configured instance
    whose role is ``unified``, else the first instance outright.
    """

    def __init__(self, cfg: AutoscaleCfg = AutoscaleCfg(),
                 template: Optional[InstanceCfg] = None):
        self.cfg = cfg
        self.template = template
        self.rt = None
        self.ticks = 0
        self.actions: List[Dict] = []
        # (t, live instance count in the scaled pool) after every tick
        self.timeline: List[tuple] = []
        self._counter = 0
        self._seen_finished = 0
        self._last_action_t = float("-inf")

    # ---- wiring ----
    def attach(self, runtime):
        self.rt = runtime
        if self.template is None:
            insts = list(runtime.cfg.instances)
            if not insts:
                raise ValueError("autoscaler needs at least one configured "
                                 "instance to use as a scale-out template")
            unified = [i for i in insts if i.role == "unified"]
            self.template = (unified or insts)[0]
        self._schedule_tick()

    def _schedule_tick(self):
        self.rt.queue.schedule(self.cfg.interval_s, self._tick,
                               tag="autoscale.tick")

    # ---- pool view ----
    def _pool(self):
        """Live instances the policy manages (role-matched to template)."""
        role = self.template.role
        return [i for i in self.rt.instances.values()
                if i.alive and i.cfg.role == role]

    # ---- observation ----
    def observe(self) -> Dict:
        """Window observation at the current tick: worst-tenant SLO
        attainment over finishes since the last tick (None when none
        finished) and mean queue depth over the managed pool."""
        new = self.rt.finished[self._seen_finished:]
        self._seen_finished = len(self.rt.finished)
        attainment: Optional[float] = None
        if new:
            per_tenant: Dict[str, List[bool]] = {}
            for r in new:
                per_tenant.setdefault(r.tenant, []).append(slo_met(r))
            attainment = min(sum(v) / len(v) for v in per_tenant.values())
        pool = self._pool()
        depth = (sum(len(i.scheduler.waiting) + len(i._pending_decode)
                     for i in pool) / len(pool)) if pool else 0.0
        return {"attainment": attainment, "queue_depth": depth,
                "pool": pool}

    # ---- policy ----
    def decide(self, obs: Dict) -> Optional[str]:
        """Return "out", "in" or None.  Override for custom policies; the
        surrounding machinery (cadence, bounds, cooldown, event purity)
        is inherited."""
        att, depth = obs["attainment"], obs["queue_depth"]
        slo_bad = att is not None and att < self.cfg.target_attainment
        if slo_bad or depth > self.cfg.queue_high:
            return "out"
        if not slo_bad and depth < self.cfg.queue_low:
            return "in"
        return None

    # ---- the tick event ----
    def _tick(self):
        rt = self.rt
        self.ticks += 1
        now = rt.queue.now
        obs = self.observe()
        pool = obs["pool"]
        n = len(pool)
        verdict = self.decide(obs)
        if now - self._last_action_t < self.cfg.cooldown_s:
            verdict = None
        rec = rt.obs
        if rec is not None:
            from repro_torch.obs.events import AUTOSCALE
            rec.emit(now, AUTOSCALE,
                     payload={"verdict": verdict, "pool": n,
                              "attainment": obs["attainment"],
                              "queue_depth": obs["queue_depth"]})
        if verdict == "out" and n < self.cfg.max_instances:
            name = f"{self.cfg.name_prefix}{self._counter}"
            self._counter += 1
            rt.add_instance(now, dataclasses.replace(self.template,
                                                     name=name))
            self._record("scale_out", name, obs, now)
            n += 1
            self._sync_pd(now, added=name)
        elif verdict == "in" and n > self.cfg.min_instances:
            # deterministic victim: least loaded, name as tiebreak
            victim = min(pool, key=lambda i: (i.load(), i.name))
            rt.remove_instance(now, victim.name)
            self._record("scale_in", victim.name, obs, now)
            n -= 1
            self._sync_pd(now, removed=victim.name)
        self.timeline.append((now, n))
        # keep evaluating until the workload is fully served
        if rt._all_requests and len(rt.finished) < len(rt._all_requests):
            self._schedule_tick()

    def _record(self, action: str, name: str, obs: Dict, now: float):
        self._last_action_t = now
        self.actions.append({
            "t": now, "action": action, "instance": name,
            "attainment": obs["attainment"],
            "queue_depth": obs["queue_depth"]})

    def _sync_pd(self, now: float, added: Optional[str] = None,
                 removed: Optional[str] = None):
        """When a P/D map is live and the scaled pool is the decode side,
        republish membership so prefill instances hand off to the current
        decode fleet (scale-out targets join, drained targets leave)."""
        if not self.rt.pd_map or self.template.role != "decode":
            return
        new_map: Dict[str, tuple] = {}
        for pre, decs in self.rt.pd_map.items():
            decs = tuple(d for d in decs if d != removed)
            if added is not None:
                decs = decs + (added,)
            new_map[pre] = decs
        self.rt.rebalance_pd(now, new_map)

    # ---- reporting ----
    def metrics(self) -> Dict:
        return {
            "ticks": self.ticks,
            "actions": list(self.actions),
            "timeline": list(self.timeline),
            "n_scale_out": sum(1 for a in self.actions
                               if a["action"] == "scale_out"),
            "n_scale_in": sum(1 for a in self.actions
                              if a["action"] == "scale_in"),
        }
