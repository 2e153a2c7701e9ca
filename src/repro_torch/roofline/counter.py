"""Operation counter: FLOPs, HBM bytes, live memory, kernel work and
collective bytes of an eager PyTorch step, on any device, meta included.

The counterpart of ``repro/roofline/hlo_analyzer.py``.  The JAX package
walks the compiled HLO; eager PyTorch has no HLO, so :class:`Counter` is a
``TorchDispatchMode`` that sees every aten op as it runs and keeps:

* **FLOPs** per op, from ``torch.utils.flop_counter``'s formulas (2·m·n·k
  a matmul, the same count as the analyzer's 2·prod(result)·prod
  (contracting) a ``dot``); every other op costs 0, as in the analyzer;
* **HBM bytes**, in the eager model: the bytes of every tensor operand of
  an op plus every tensor it returns (an in-place op reads and writes its
  target), 0 for views, metadata ops and allocations without a write
  (``empty``).  This is not XLA's fusion model, which counts a fusion's
  result twice and nothing inside it, so no byte count is compared across
  the two packages;
* **live storage bytes and their peak**: a storage counts from the op that
  creates it to the moment it is freed (a weak reference's finalizer).
  :meth:`arguments` names what lives before the step, and
  :meth:`memory`, given what the step returns, gives the JAX record's
  argument, output, temp and alias bytes (alias: outputs sharing storage
  with an argument, what an in-place optimizer update gives);
* **kernel calls**: each port kernel wrapper runs inside :func:`kernel_call`
  under the name ``ops.launch_counts()`` uses.  The aten ops inside a call
  (the plain version on the CPU, the wrapper's allocations on the card)
  are kept apart from the totals above; the call charges the kernel's own
  work from its work-count function and adds its launch.  On the meta
  device that launch is a prediction;
* **collective bytes** by kind (``all-reduce``, ``all-gather``) and by
  mesh axis (``model``, ``data``, ``pod+data``: the group's; a
  sequence-sharded decode's combine under its group's axis), the result
  bytes as the analyzer records them, and the bytes each device moves
  under the ring factors of ``analysis`` at each group's size.

:func:`trip_count` is the analyzer's ``known_trip_count``: it counts one
iteration of a loop whose shapes do not change and charges it ``n``
times, backward included.  Eager PyTorch has no loop op to read a count
from, so the loop asks for it (``repeats`` says when: a counter is active,
it allows trip counts, and the tensors are on the meta device).

Nothing here runs unless a counter is active: with none, a wrapper's only
extra work is one truth test of a list.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import ring_factor

aten = torch.ops.aten

#: the active counters, innermost last.  A plain list, not thread-local:
#: the autograd engine runs a CUDA backward on its own thread, and the
#: dispatch mode follows it there (torch carries the mode stack over).
STACK: List["Counter"] = []

#: ops that allocate without writing, or only read metadata: no bytes
_NO_BYTES = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.detach.default,
    aten.lift_fresh.default, aten.alias.default,
    aten._local_scalar_dense.default,
}


def active() -> Optional["Counter"]:
    return STACK[-1] if STACK else None


def repeats(x: torch.Tensor) -> bool:
    """Whether a loop over ``x`` may run one iteration under
    :func:`trip_count`: a counter is active and allows it, and ``x`` is on
    the meta device (on the CPU and the card every iteration runs)."""
    c = active()
    return c is not None and c.trip_counts and x.device.type == "meta"


def _key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class KernelTally:
    """One port kernel's calls under a counter: its launches (predicted on
    meta), the work its work-count function charges, and on the CPU the
    FLOPs and bytes of the plain version that ran in its place."""
    launches: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    plain_flops: float = 0.0
    plain_bytes: float = 0.0


class Counter(TorchDispatchMode):
    """Count one step (see the module docstring).  ``trip_counts=False``
    runs every loop iteration even on meta (what the trip-count scope is
    checked against)."""

    def __init__(self, *, trip_counts: bool = True):
        super().__init__()
        self.trip_counts = trip_counts
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.kernels: Dict[str, KernelTally] = {}
        self.coll_bytes: Dict[str, float] = {}
        self.coll_by_axis: Dict[str, Dict[str, float]] = {}
        self.coll_moved = 0.0
        self.live = 0
        self.peak = 0
        self._mult = 1
        self._kernel: Optional[str] = None
        self._sizes: Dict[int, list] = {}    # storage key -> [bytes, weight]
        self._args: set = set()
        self._scoped: Optional[list] = None  # keys made in a trip scope

    # ---- entering / leaving ----
    def __enter__(self):
        STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        STACK.remove(self)
        return super().__exit__(*exc)

    # ---- memory ----
    def _track(self, t: torch.Tensor) -> bool:
        """Start counting ``t``'s storage; False if it is counted already."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return False
        n = st.nbytes()
        self._sizes[key] = [n, 1]
        self.live += n
        self.peak = max(self.peak, self.live)
        if self._scoped is not None:
            self._scoped.append(key)
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key):
        n, w = self._sizes.pop(key, (0, 0))
        self.live -= n * w

    def arguments(self, *trees) -> int:
        """Count the storages of ``trees`` as the step's arguments; returns
        their bytes (each storage once)."""
        total = 0
        for t in _tensors(trees):
            if self._track(t):
                self._args.add(_key(t))
                total += self._sizes[_key(t)][0]
        return total

    def memory(self, outputs) -> Dict[str, int]:
        """The JAX record's memory keys: ``argument_size_in_bytes`` (the
        storages named by :meth:`arguments` and those the step made that
        outlive it outside its outputs, such as a kernel's persistent
        workspace), ``output_size_in_bytes`` (each storage of ``outputs``
        once), ``alias_size_in_bytes`` (outputs that are arguments'
        storages), ``temp_size_in_bytes`` (the peak above the arguments:
        eager PyTorch has no output buffers apart from the temporaries, so
        the outputs a step makes are in it) and ``peak_bytes``."""
        seen, out, alias = set(), 0, 0
        for t in _tensors(outputs):
            k = _key(t)
            if k in seen:
                continue
            seen.add(k)
            n = t.untyped_storage().nbytes()
            out += n
            alias += n if k in self._args else 0
        arg = sum(self._sizes[k][0] for k in self._args if k in self._sizes)
        arg += sum(n * w for k, (n, w) in self._sizes.items()
                   if k not in self._args and k not in seen)
        return {"argument_size_in_bytes": int(arg),
                "output_size_in_bytes": int(out),
                "temp_size_in_bytes": int(self.peak - arg),
                "alias_size_in_bytes": int(alias),
                "peak_bytes": int(self.peak)}

    # ---- the ops ----
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_key(t) for t in ins if t.layout == torch.strided}
        for t in outs:
            if t.layout == torch.strided and _key(t) not in in_keys:
                self._track(t)
        flops = 0.0
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        nbytes = 0
        if not func.is_view and func not in _NO_BYTES:
            # every operand read and every result written: an in-place
            # op's target is both
            nbytes = sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
        m = self._mult
        if self._kernel is None:
            self.flops += m * flops
            self.hbm_bytes += m * nbytes
        else:
            k = self.kernels[self._kernel]
            k.plain_flops += m * flops
            k.plain_bytes += m * nbytes
        return out

    # ---- kernels and collectives ----
    def charge(self, name: str, flops: float, nbytes: float,
               launches: int) -> None:
        k = self.kernels.setdefault(name, KernelTally())
        k.launches += self._mult * launches
        k.flops += self._mult * flops
        k.bytes += self._mult * nbytes

    def collective(self, kind: str, result_bytes: int, n: int,
                   axis: str = "model") -> None:
        """Record a collective's result bytes over a group of ``n`` along
        ``axis``, and what each device moves (``analysis.RING_FACTORS``)."""
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) \
            + self._mult * result_bytes
        by = self.coll_by_axis.setdefault(axis, {})
        by[kind] = by.get(kind, 0.0) + self._mult * result_bytes
        self.coll_moved += self._mult * result_bytes * ring_factor(kind, n)

    # ---- totals ----
    @property
    def kernel_flops(self) -> float:
        return sum(k.flops for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> float:
        return sum(k.bytes for k in self.kernels.values())

    def launches(self) -> Dict[str, int]:
        return {n: k.launches for n, k in self.kernels.items()}


@contextlib.contextmanager
def kernel_call(name: str, flops: float, nbytes: float, launches: int):
    """Run a kernel wrapper's body as one call of kernel ``name``: charge
    its work and launches to the active counter and keep the aten ops
    inside apart from the totals.  No counter: nothing happens."""
    c = active()
    if c is None:
        yield
        return
    c.charge(name, flops, nbytes, launches)
    outer, c._kernel = c._kernel, name
    try:
        yield
    finally:
        c._kernel = outer


class _Repeat:
    """What :func:`trip_count` yields: ``region`` marks the iteration's
    autograd nodes so that their backward is charged ``n`` times too, and
    ``carry`` names the loop state the next iteration would replace."""

    def __init__(self, counter, n):
        self.counter, self.n = counter, n
        self.carried = set()

    def carry(self, *tensors: torch.Tensor) -> None:
        """Tensors the iteration hands to the next one and that the loop
        keeps no copy of: without autograd only the last iteration's stay
        alive, so their storages weigh 1, not ``n`` (under autograd the
        next iteration's backward keeps each, and they weigh ``n``)."""
        if not torch.is_grad_enabled():
            self.carried.update(_key(t) for t in tensors)

    def region(self, inputs: Iterable[torch.Tensor],
               outputs: Iterable[torch.Tensor],
               shared: Iterable[torch.Tensor] = ()) -> None:
        """``outputs`` came from ``inputs`` in the counted iteration.
        Every autograd node between them runs its backward under the
        multiplier.  ``shared`` are inputs every iteration reads (a
        projection computed once, a weight): over ``n`` iterations the
        autograd engine sums ``n`` gradients into each, so each gets
        ``n - 1`` more adds of its size (3 × its bytes each) when its
        gradient is ready: the counted iteration's and the caller's
        iterations outside the scope reach it as separate gradients, whose
        adds run anyway."""
        c, n = self.counter, self.n
        if not torch.is_grad_enabled():
            return
        stop = {t.grad_fn for t in inputs if t.grad_fn is not None}
        nodes, todo = set(), [t.grad_fn for t in outputs
                              if t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or node in nodes or node in stop \
                    or type(node).__name__ == "AccumulateGrad":
                continue
            nodes.add(node)
            todo.extend(f for f, _ in node.next_functions)

        def enter(*_):
            c._mult *= n

        def leave(*_):
            c._mult //= n

        for node in nodes:
            node.register_prehook(enter)
            node.register_hook(leave)
        for t in shared:
            if t.requires_grad:
                t.register_hook(lambda g: _extra_adds(c, g, n - 1))


def _extra_adds(c: Counter, g: torch.Tensor, n: int) -> None:
    if n > 0:
        outer, c._mult = c._mult, c._mult * n
        try:
            torch.add(g, g)          # two operands read, one result written
        finally:
            c._mult = outer


@contextlib.contextmanager
def trip_count(n: int):
    """Charge what runs inside ``n`` times: FLOPs, bytes, kernel work and
    collectives, and the storages made inside that are still alive at the
    end weigh ``n`` times their bytes.  Use it around one iteration of a
    loop whose shapes do not change, and only when :func:`repeats` says so.
    Memory is approximate: every storage the iteration leaves alive weighs
    ``n`` (the loop's outputs and autograd's saved tensors, one set an
    iteration) except the ones named by ``carry``; what the autograd engine
    allocates between the iteration's backward nodes is charged once."""
    c = active()
    outer, c._mult = c._mult, c._mult * n
    scoped, c._scoped = c._scoped, []
    rep = _Repeat(c, n)
    try:
        yield rep
    finally:
        for key in c._scoped:
            if key in c._sizes and key not in rep.carried:
                size = c._sizes[key]
                c.live += size[0] * (n - 1)
                size[1] = n
        c.peak = max(c.peak, c.live)
        c._mult = outer
        c._scoped = scoped if scoped is None else scoped + c._scoped
