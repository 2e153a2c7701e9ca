"""Rank groups and rank grids: the port's meshes.

The counterpart of ``repro/launch/mesh.py``.  JAX gets data and tensor
parallelism from GSPMD under one controller over a device mesh; the port
runs one process per rank and makes the collectives explicit over
``torch.distributed``.

* :func:`make_production_mesh` returns the JAX study's mesh shapes, 16×16
  ``("data", "model")`` or 2×16×16 ``("pod", "data", "model")``, as a
  :class:`MeshShape` (axis names and extents, no devices); :func:`dp_axes`
  and :func:`dp_size` read it as the JAX functions read a mesh (the pod
  axis folds into data parallelism).
* An :class:`EngineGroup` is one rank's view of one group of ranks: its
  rank and size in the group, its device, the model's collectives
  (all-reduce sum and max, all-gather on the last dim or any dim, an
  all-to-all of rows with static splits) and the
  serving engine's bookkeeping over the ranks (the slowest rank's time, a
  count summed over the ranks, a guard that the ranks agree).  Its
  collectives run on its own process group (``pg``; None: the default,
  every rank), and under an active ``repro_torch.roofline.counter.Counter``
  each model collective records its result bytes by kind and by ``axis``.
* A :class:`RankGrid` is one rank of a (data, model) or (pod, data, model)
  grid, ranks numbered row-major (the model axis fastest, so a
  tensor-parallel group is consecutive ranks): one group per axis
  (``model``, ``data``, ``pod``) made with ``dist.new_group``, plus the
  data-parallel group ``dp`` over pod and data folded (the gradient's), on
  request the model ranks that read one shared KV head
  (:meth:`RankGrid.model_subgroup`), and the group a decode cache's
  sequence splits over (:meth:`RankGrid.seq_group`: ``data`` for a batch
  of one, ``model`` under ``seq_shard_cache``).  Training takes a grid; serving keeps
  ``ServingEngine(tp=, group=)``: one tensor-parallel group, dp = 1.

A tp = 1 engine alone has no group and calls none of this, so it launches
exactly what it launched before tensor parallelism.  A tp = 1 engine served
beside a tp > 1 one (a P/D pair of different tp) runs replicated on every
rank and takes the group as its replica handle (``ServingEngine(replicas=
group)``): it calls only the bookkeeping (``slowest``, ``check_equal``).

Backends: gloo on the CPU; NCCL with one rank per card (rank r on
``cuda:r``).  Fewer visible cards than ranks raises.  Several ranks on one
card is allowed only when the caller names the devices (``devices=
["cuda:0", "cuda:0"]``), and then the backend is gloo, which stages CUDA
tensors through the host: a correctness check of the sharded path, not a
parallel speed.  A failing collective raises; nothing here catches it.

:func:`run_ranks` spawns the ranks (``torch.multiprocessing``, spawn start
method), calls a function in each with its group (``dp=None``) or its grid
and returns every rank's result.

:class:`CountingGroup` is one rank of a group that does not exist, and
:func:`counting_grid` a grid of them: the dry run's stand-ins
(``repro_torch.launch.dryrun``).  Their collectives return what the real
ones return in shape and dtype (the values are not the group's) and record
their result bytes like the real ones.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and extents, no devices: what the JAX
    functions :func:`dp_axes` and :func:`dp_size` read of a mesh."""
    axis_names: Tuple[str, ...]
    extents: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.extents))

    @property
    def size(self) -> int:
        return math.prod(self.extents)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 (data, model) single pod; 2x16x16 (pod, data, model) two
    pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def grid_mesh(dp: int, tp: int) -> MeshShape:
    """The (data, model) mesh of a dp × tp grid."""
    return MeshShape(("data", "model"), (dp, tp))


def dp_axes(mesh) -> tuple:
    """The data-parallel axis names of a mesh (pod axis folds into DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_size(mesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= mesh.shape[a]
    return s


def visible_devices(kind: str) -> Optional[int]:
    """How many devices of ``kind`` ("cuda" or "cpu") can hold a rank:
    the card count, or None on the CPU (ranks are processes there)."""
    if kind == "cuda":
        return torch.cuda.device_count()
    return None


def _record(kind: str, nbytes: int, size: int, axis: str) -> None:
    from repro_torch.roofline import counter
    c = counter.active()
    if c is not None:
        c.collective(kind, nbytes, size, axis)


@dataclasses.dataclass
class EngineGroup:
    """One rank of a group; its collectives run on ``pg`` (None: the
    default process group that :func:`make_engine_group` initialised)."""
    rank: int
    size: int
    device: torch.device
    backend: str
    pg: Any = None
    axis: str = "model"

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        dist.all_reduce(x, op=op, group=self.pg)
        return x

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; every rank gets the same
        bytes."""
        _record("all-reduce", x.numel() * x.element_size(), self.size,
                self.axis)
        return self._reduce(x, dist.ReduceOp.SUM)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        _record("all-reduce", x.numel() * x.element_size(), self.size,
                self.axis)
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's ``x`` along the last dim, in rank
        order."""
        return self._gather(x.contiguous(), -1)

    def all_gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in rank order, on
        ``x``'s device."""
        return self._gather(x.contiguous(), dim)

    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.size)]
        _record("all-gather", self.size * x.numel() * x.element_size(),
                self.size, self.axis)
        dist.all_gather(parts, x, group=self.pg)
        return torch.cat(parts, dim=dim)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``x`` (the same shape on every rank)
        along ``dim``, in rank order: on the card under NCCL, on the host
        under gloo (``x`` is copied there first, and the result stays
        there)."""
        return self._gather(x.to(self._host_side()).contiguous(), dim)

    def all_to_all(self, x: torch.Tensor, in_splits: Sequence[int],
                   out_splits: Sequence[int]) -> torch.Tensor:
        """Rows ``in_splits[r]`` of ``x`` (in order along dim 0) to rank r;
        returns the rows every rank sent here, in rank order
        (``out_splits[r]`` from rank r), on ``x``'s device.  The splits
        are static: every rank's ``in_splits[me]`` is its peer's
        ``out_splits``.  Under gloo, which takes host tensors only, the
        rows go through the host.  Records the result's bytes."""
        side = self._host_side()
        out = torch.empty((sum(out_splits),) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=side)
        _record("all-to-all", out.numel() * out.element_size(), self.size,
                self.axis)
        dist.all_to_all_single(out, x.to(side).contiguous(),
                               output_split_sizes=list(out_splits),
                               input_split_sizes=list(in_splits),
                               group=self.pg)
        return out.to(x.device)

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
        return float(self._reduce(t, dist.ReduceOp.MAX).item())

    def total(self, value: int) -> int:
        """The sum of the ranks' ``value`` (an integer count), the same on
        every rank."""
        t = torch.tensor([value], dtype=torch.int64,
                         device=self._host_side())
        return int(self._reduce(t, dist.ReduceOp.SUM).item())

    def check_equal(self, values, what: str) -> None:
        """Raise on every rank unless every rank holds the same integer
        ``values`` (one fixed-length vector a rank): a guard before the
        ranks part, which would otherwise hang the next collective."""
        t = torch.as_tensor(list(values), dtype=torch.int64).to(
            self._host_side())
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.pg)
        if any(not torch.equal(p, parts[0]) for p in parts[1:]):
            raise RuntimeError(
                f"engine group: the ranks' {what} differ: "
                f"{[p.tolist() for p in parts]}")


@dataclasses.dataclass
class CountingGroup:
    """A rank of a ``size``-rank group on any device, the meta one
    included: :class:`EngineGroup`'s model collectives with no other rank.
    An all-reduce returns its input; an all-gather allocates the parts as
    the real one does and concatenates them.  Each records its result
    bytes (``all-reduce``: the input's; ``all-gather``: the gathered
    tensor's) with the active counter, under ``axis``."""
    rank: int
    size: int
    device: torch.device = torch.device("meta")
    backend: str = "count"
    axis: str = "model"

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        _record("all-reduce", x.numel() * x.element_size(), self.size,
                self.axis)
        return x

    all_reduce_max = all_reduce_sum

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather(x, -1)

    def all_gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self.all_gather(x, dim)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        _record("all-gather", self.size * x.numel() * x.element_size(),
                self.size, self.axis)
        return torch.cat(parts, dim=dim)

    def all_to_all(self, x: torch.Tensor, in_splits: Sequence[int],
                   out_splits: Sequence[int]) -> torch.Tensor:
        out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
        _record("all-to-all", out.numel() * out.element_size(), self.size,
                self.axis)
        return out


@dataclasses.dataclass
class RankGrid:
    """One rank of a grid of ``mesh.size`` ranks (see the module
    docstring): ``coords`` by axis name, one group per axis, ``dp`` over
    the data-parallel axes folded."""
    mesh: MeshShape
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Any]
    dp: Any
    device: torch.device
    backend: str
    _subgroups: Dict[Tuple[int, ...], Any] = dataclasses.field(
        default_factory=dict)
    _new_group: Optional[Callable] = None

    @property
    def tp(self) -> int:
        return self.mesh.shape["model"]

    @property
    def dp_size(self) -> int:
        return dp_size(self.mesh)

    @property
    def dp_rank(self) -> int:
        return self.dp.rank

    @property
    def model(self):
        return self.groups["model"]

    @property
    def data(self):
        return self.groups["data"]

    def model_kw(self) -> dict:
        """``Model``'s group arguments on this rank: the model group at tp
        above 1 and the data-parallel group at dp above 1, else None."""
        return {"group": self.model if self.tp > 1 else None,
                "dp_group": self.dp if self.dp_size > 1 else None}

    def seq_group(self, batch: int, seq_shard: bool = False):
        """The group a decode cache's sequence splits over (JAX's
        ``cache_pspecs``): the ``data`` group alone for a batch of one (on
        a (pod, data, model) grid the pod axis then holds a replica), the
        model group under ``seq_shard`` (``seq_shard_cache``) for a larger
        batch; None where that axis has one rank, or otherwise.
        ``Model(seq_group=)`` takes it."""
        if batch == 1:
            g = self.groups.get("data")
        elif seq_shard:
            g = self.model
        else:
            return None
        return g if g is not None and g.size > 1 else None

    def model_subgroup(self, ranks: Sequence[int]):
        """The group of the model ranks ``ranks`` (model coordinates,
        ascending) in this rank's row of the grid, or None when this rank
        is not among them: the readers of one shared KV head
        (``sharding.shared_kv_heads``).  Every rank of the grid must ask
        for the same sets in the same order (making a process group is
        collective over every rank)."""
        ranks = tuple(ranks)
        if ranks not in self._subgroups:
            self._subgroups[ranks] = self._new_group(ranks)
        return self._subgroups[ranks]


def _axis_name(axes: Sequence[str]) -> str:
    return "+".join(axes)


def _grid_ranks(mesh: MeshShape, axes: Sequence[str], rank: int):
    """Every group of ranks that varies only along ``axes`` (in a fixed
    order) and the one holding ``rank``."""
    names = mesh.axis_names
    idx = torch.arange(mesh.size).reshape(mesh.extents)
    keep = [i for i, a in enumerate(names) if a not in axes]
    vary = [i for i, a in enumerate(names) if a in axes]
    flat = idx.permute(keep + vary).reshape(-1, math.prod(
        mesh.extents[i] for i in vary))
    groups = [row.tolist() for row in flat]
    mine = next((g for g in groups if rank in g), None)
    return groups, mine


def counting_grid(mesh: MeshShape, rank: int = 0) -> RankGrid:
    """Rank ``rank`` of ``mesh`` with a :class:`CountingGroup` for each
    axis: the dry run's grid."""
    coords = dict(zip(mesh.axis_names, torch.unravel_index(
        torch.tensor(rank), mesh.extents)))
    coords = {a: int(c) for a, c in coords.items()}
    groups = {a: CountingGroup(coords[a], n, axis=a)
              for a, n in mesh.shape.items()}
    dpa = dp_axes(mesh)
    dpr = 0
    for a in dpa:
        dpr = dpr * mesh.shape[a] + coords[a]
    dp = CountingGroup(dpr, dp_size(mesh), axis=_axis_name(dpa))
    mr = coords["model"]

    def subgroup(ranks):
        if mr not in ranks:
            return None
        return CountingGroup(ranks.index(mr), len(ranks), axis="model")
    return RankGrid(mesh, rank, coords, groups, dp, torch.device("meta"),
                    "count", _new_group=subgroup)


def _devices_and_backend(n: int, device: str, devices):
    """Each rank's device and the backend (see the module docstring)."""
    kind = torch.device(device).type
    if devices is None:
        avail = visible_devices(kind)
        if avail is not None and avail < n:
            raise ValueError(
                f"{n} ranks need {n} {kind} devices but only {avail} are "
                f"visible; to check the sharded path on fewer cards, name "
                f"the devices (devices=['cuda:0'] * {n}: gloo, not a "
                f"parallel speed)")
        devices = [f"cuda:{r}" for r in range(n)] if kind == "cuda" \
            else ["cpu"] * n
    devs = [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices named for {n} ranks")
    kinds = {d.type for d in devs}
    if len(kinds) != 1:
        raise ValueError(f"a group spans one device kind, got "
                         f"{sorted(kinds)}")
    if kinds == {"cuda"}:
        devs = [torch.device("cuda", d.index or 0) for d in devs]
        avail = torch.cuda.device_count()
        if max(d.index for d in devs) >= avail:
            raise ValueError(f"devices {list(devices)} name a card past "
                             f"the {avail} visible")
    distinct = len(set(devs)) == n
    return devs, "nccl" if kinds == {"cuda"} and distinct else "gloo"


def _init(n: int, rank: int, init_method: str, device: str, devices,
          timeout_s: float):
    devs, backend = _devices_and_backend(n, device, devices)
    dev = devs[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev, backend


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
    dev, backend = _init(tp, rank, init_method, device, devices, timeout_s)
    return EngineGroup(rank=rank, size=tp, device=dev, backend=backend)


def make_rank_grid(mesh: MeshShape, rank: int, *, init_method: str,
                   device: str = "cuda",
                   devices: Optional[Sequence[str]] = None,
                   timeout_s: float = 600.0) -> RankGrid:
    """Join rank ``rank`` of a grid of ``mesh.size`` ranks (devices and
    backend as :func:`make_engine_group`) and make its groups."""
    n = mesh.size
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} of a {n}-rank grid")
    dev, backend = _init(n, rank, init_method, device, devices, timeout_s)
    return grid_on_world(mesh, rank, dev, backend)


def grid_on_world(mesh: MeshShape, rank: int, dev: torch.device,
                  backend: str) -> Optional[RankGrid]:
    """Rank ``rank``'s grid over a default process group that is already
    initialised (one spawn can hold grids of several shapes).  The grid's
    ranks are the world's first ``mesh.size``; on a larger world the
    others get None.  Collective: every rank of the world must call it,
    in the same order.  A grid on part of the world cannot make
    :meth:`RankGrid.model_subgroup`'s groups (each is made over the whole
    world): it raises there."""
    n = mesh.size
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"a grid of {n} ranks over a world of {world}")

    def group_over(axes):
        mine_pg = None
        all_groups, mine = _grid_ranks(mesh, axes, rank)
        for ranks in all_groups:        # collective: every rank, in order
            pg = dist.new_group(ranks)
            if rank in ranks:
                mine_pg = pg
        if mine is None:
            return None
        return EngineGroup(rank=mine.index(rank), size=len(mine),
                           device=dev, backend=backend, pg=mine_pg,
                           axis=_axis_name(axes))

    groups = {a: group_over((a,)) for a in mesh.axis_names}
    dpa = dp_axes(mesh)
    dp = groups["data"] if dpa == ("data",) else group_over(dpa)
    if rank >= n:
        return None
    coords = {a: g.rank for a, g in groups.items()}
    tp = mesh.shape["model"]

    def subgroup(model_ranks):
        if world != n:
            raise ValueError(f"a shared KV head's reader group is made "
                             f"over the whole world: a grid of {n} ranks "
                             f"on a world of {world} cannot make one")
        mine_pg = None
        for row in range(n // tp):          # collective, as above
            ranks = [row * tp + r for r in model_ranks]
            pg = dist.new_group(ranks)
            if rank in ranks:
                mine_pg = pg
        if mine_pg is None:
            return None
        return EngineGroup(rank=model_ranks.index(coords["model"]),
                           size=len(model_ranks), device=dev,
                           backend=backend, pg=mine_pg, axis="model")

    return RankGrid(mesh, rank, coords, groups, dp, dev, backend,
                    _new_group=subgroup)


def _rank_main(rank: int, fn: Callable, n: int, mesh, payload,
               init_method: str, device: str, devices, out_dir: str,
               timeout_s: float):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    if mesh is None:
        group = make_engine_group(n, rank, init_method=init_method,
                                  device=device, devices=devices,
                                  timeout_s=timeout_s)
    else:
        group = make_rank_grid(mesh, rank, init_method=init_method,
                               device=device, devices=devices,
                               timeout_s=timeout_s)
    try:
        result = fn(group, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, tp: int, payload=None, *, dp: Optional[int] = None,
              device: str = "cuda",
              devices: Optional[Sequence[str]] = None,
              timeout_s: float = 900.0) -> list:
    """Spawn the ranks, run ``fn(group, payload)`` in each and return
    their results in rank order.  With ``dp=None``: ``tp`` ranks of one
    engine group (an :class:`EngineGroup`).  With ``dp``: ``dp · tp``
    ranks of a grid (a :class:`RankGrid` of :func:`grid_mesh`; another
    mesh of as many ranks, a (pod, data, model) one, through
    :func:`grid_on_world`).
    ``fn`` must be importable by name (a module-level function) and
    ``payload`` picklable.  A rank that raises ends the others and raises
    here with its traceback; past ``timeout_s`` every rank is ended and
    ``TimeoutError`` raised."""
    import torch.multiprocessing as mp
    mesh = None if dp is None else grid_mesh(dp, tp)
    n = tp if mesh is None else mesh.size
    work = tempfile.mkdtemp(prefix="engine-group-")
    ctx = None
    try:
        init_method = "file://" + os.path.join(work, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, mesh, payload, init_method, device,
                              devices, work, timeout_s),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n} ranks still running after "
                                   f"{timeout_s:.0f} s")
        out = []
        for r in range(n):
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
