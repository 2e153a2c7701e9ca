"""Engine groups: the ranks of one tensor-parallel ``ServingEngine``.

The counterpart of ``make_engine_mesh`` (``repro/launch/mesh.py``).  JAX
gets tensor parallelism from GSPMD under one controller over a (1, tp)
mesh; the port runs one process per rank and makes the collectives
explicit over ``torch.distributed``.  An :class:`EngineGroup` is one rank's
view of its group: rank, world size, its device, the three collectives
the model needs (all-reduce sum, all-reduce max, all-gather on the last
dim), and the engine's bookkeeping over the ranks (the slowest rank's
time, a count summed over the ranks, a guard that the ranks agree, and a
gather of a P/D payload's KV heads).  A tp = 1 engine alone has no group
and calls none of them, so it launches exactly what it launched before
tensor parallelism.  A tp = 1 engine served beside a tp > 1 one (a P/D
pair of different tp) runs replicated on every rank and takes the group
as its replica handle (``ServingEngine(replicas=group)``): it calls only
the bookkeeping (``slowest``, ``check_equal``), never the model's
collectives.

Backends: gloo on the CPU; NCCL with one rank per card (rank r on
``cuda:r``).  Fewer visible cards than tp raises.  Several ranks on one
card is allowed only when the caller names the devices
(``devices=["cuda:0", "cuda:0"]``), and then the backend is gloo, which
stages CUDA tensors through the host: a correctness check of the sharded
path, not a tensor-parallel speed.  A failing collective raises; nothing
here catches it.

:func:`run_ranks` spawns the ranks of one group (``torch.multiprocessing``,
spawn start method), calls a function in each with its group and returns
every rank's result.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def visible_devices(kind: str) -> Optional[int]:
    """How many devices of ``kind`` ("cuda" or "cpu") can hold a rank:
    the card count, or None on the CPU (ranks are processes there)."""
    if kind == "cuda":
        return torch.cuda.device_count()
    return None


@dataclasses.dataclass
class EngineGroup:
    """One rank of an engine group; its collectives run on the default
    process group that :func:`make_engine_group` initialised."""
    rank: int
    size: int
    device: torch.device
    backend: str

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; every rank gets the same
        bytes."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's ``x`` along the last dim, in rank
        order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=-1)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``x`` (the same shape on every rank)
        along ``dim``, in rank order: on the card under NCCL, on the host
        under gloo (``x`` is copied there first, and the result stays
        there)."""
        x = x.to(self._host_side()).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=dim)

    def _host_side(self):
        """Where a small bookkeeping tensor lives for a collective: the
        card under NCCL, the host under gloo."""
        return self.device if self.backend == "nccl" else "cpu"

    def slowest(self, seconds: float) -> float:
        """The largest of the ranks' ``seconds``: a tensor-parallel step
        ends when its slowest rank ends, and every rank must hand the
        runtime the same latency, or their schedules part."""
        t = torch.tensor([seconds], dtype=torch.float64,
                         device=self._host_side())
        return float(self.all_reduce_max(t).item())

    def total(self, value: int) -> int:
        """The sum of the ranks' ``value`` (an integer count), the same on
        every rank."""
        t = torch.tensor([value], dtype=torch.int64,
                         device=self._host_side())
        return int(self.all_reduce_sum(t).item())

    def check_equal(self, values, what: str) -> None:
        """Raise on every rank unless every rank holds the same integer
        ``values`` (one fixed-length vector a rank): a guard before the
        ranks part, which would otherwise hang the next collective."""
        t = torch.as_tensor(list(values), dtype=torch.int64).to(
            self._host_side())
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        if any(not torch.equal(p, parts[0]) for p in parts[1:]):
            raise RuntimeError(
                f"engine group: the ranks' {what} differ: "
                f"{[p.tolist() for p in parts]}")


def make_engine_group(tp: int, rank: int, *, init_method: str,
                      device: str = "cuda",
                      devices: Optional[Sequence[str]] = None,
                      timeout_s: float = 600.0) -> EngineGroup:
    """Join rank ``rank`` of a ``tp``-rank engine group.

    ``init_method`` is the rendezvous (``file://<path>`` or
    ``tcp://localhost:<port>``).  Without ``devices``: on the card, rank r
    takes ``cuda:r`` over NCCL and fewer visible cards than ``tp`` raise;
    on the CPU every rank runs on the CPU over gloo.  ``devices`` names
    each rank's device; a device named twice makes the backend gloo."""
    if tp < 1 or not 0 <= rank < tp:
        raise ValueError(f"rank {rank} of a {tp}-rank engine group")
    kind = torch.device(device).type
    if devices is None:
        n = visible_devices(kind)
        if n is not None and n < tp:
            raise ValueError(
                f"tensor-parallel degree {tp} needs {tp} {kind} devices "
                f"but only {n} are visible; to check the sharded path on "
                f"fewer cards, name the devices (devices=['cuda:0'] * "
                f"{tp}: gloo, not a tensor-parallel speed)")
        devices = [f"cuda:{r}" for r in range(tp)] if kind == "cuda" \
            else ["cpu"] * tp
    devs = [torch.device(d) for d in devices]
    if len(devs) != tp:
        raise ValueError(f"{len(devs)} devices named for {tp} ranks")
    kinds = {d.type for d in devs}
    if len(kinds) != 1:
        raise ValueError(f"an engine group spans one device kind, got "
                         f"{sorted(kinds)}")
    if kinds == {"cuda"}:
        devs = [torch.device("cuda", d.index or 0) for d in devs]
        n = torch.cuda.device_count()
        if max(d.index for d in devs) >= n:
            raise ValueError(f"devices {list(devices)} name a card past "
                             f"the {n} visible")
    distinct = len(set(devs)) == tp
    backend = "nccl" if kinds == {"cuda"} and distinct else "gloo"
    dev = devs[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=tp, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return EngineGroup(rank=rank, size=tp, device=dev, backend=backend)


def _rank_main(rank: int, fn: Callable, tp: int, payload, init_method: str,
               device: str, devices, out_dir: str, timeout_s: float):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // tp))
    group = make_engine_group(tp, rank, init_method=init_method,
                              device=device, devices=devices,
                              timeout_s=timeout_s)
    try:
        result = fn(group, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, tp: int, payload=None, *, device: str = "cuda",
              devices: Optional[Sequence[str]] = None,
              timeout_s: float = 900.0) -> list:
    """Spawn ``tp`` ranks, run ``fn(group, payload)`` in each and return
    their results in rank order.  ``fn`` must be importable by name (a
    module-level function) and ``payload`` picklable.  A rank that raises
    ends the others and raises here with its traceback; past
    ``timeout_s`` every rank is ended and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp
    work = tempfile.mkdtemp(prefix="engine-group-")
    ctx = None
    try:
        init_method = "file://" + os.path.join(work, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, tp, payload, init_method, device, devices,
                              work, timeout_s),
            nprocs=tp, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{tp} ranks still running after "
                                   f"{timeout_s:.0f} s")
        out = []
        for r in range(tp):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
