"""One rank's cost of a traced step, from the ops it dispatches on its local
tensors — the port's counterpart of the JAX package's
``roofline/hlo_cost.py``.

The JAX package compiles the SPMD program and parses the partitioned HLO.
The port has no HLO: ``DispatchCostMode`` is a ``TorchDispatchMode`` that
sees every ATen op the step runs, below autograd, so the backward and
remat's recompute are counted as they run.  Python loops over layers and
microbatches run eagerly, op by op, so there is no trip count to recover.
What it counts, on one rank's local tensors (DTensor ops are let through to
DTensor, which runs the op on each local shard; that local op is counted):

* **FLOPs** — the JAX convention: 2 x |result| x |contracted dims| for
  ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and convolutions (``einsum``,
  ``matmul`` and ``linear`` decompose into these), by unit: ``"bf16"`` for
  products of 16-bit operands (the tensor cores), ``"f32"`` otherwise.  A
  hand-written kernel's operator (``repro_torch::flash_attention``,
  ``repro_torch::ssd_scan``, whose fake implementations give meta tensors
  their shapes) is charged the kernel's own work,
  ``kernel_cost.kernel_work``, and counted in ``Cost.kernels``.
* **HBM bytes** — the operands plus the result of every op that moves
  data; views and allocations charge 0, an in-place op its operands.
  Eager PyTorch fuses nothing, so this is not held equal to XLA's count of
  a fused program, which charges each fusion once.
* **Collective bytes** — the result bytes of each ``_c10d_functional``
  collective, by kind (JAX's names: ``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``broadcast``), and the part whose
  group spans more than one node of ``NODE_GPUS`` consecutive ranks.  On a
  CPU mesh (the dry run's fake world) DTensor stands in for an all-to-all
  with an all-gather and a chunk; that gather is charged as the all-to-all
  a CUDA mesh runs (``_dtensor.shard_dim_alltoall``, its result the size
  of its input), which is also counted where it is dispatched.
* **Peak live bytes** — the storages that the counted ops create, alive
  from the op until the last tensor on them is freed (an autograd saved
  tensor keeps its storage alive), the counterpart of
  ``memory_analysis()``'s temp size.

The attention and SSD kernels' backward (``kernels.grad``) is the plain
version's gradient, hundreds of small ops a call: on meta tensors it is
traced once for each input signature and every later call with the same
signature is charged that trace's counts and transient peak
(``DispatchCostMode.plain_vjp``).

DTensor's sharding propagation runs an op once on global-shaped tensors the
first time an (op, shapes, placements) signature occurs, and caches the
result.  Those runs are not the rank's work, and are not counted: DTensor
runs them under a ``FakeTensorMode`` (``ShardingPropagator.
_propagate_tensor_meta_non_cached``, the same in torch 2.11 and 2.13), so
every tensor they make is a ``FakeTensor``, while a rank's local tensors in
the dry run are ``meta`` tensors, never fake.  An op that takes or makes a
``FakeTensor`` is skipped; the rank's own ops never do.

The JAX names and theirs here:

* ``HloCostModel(text).cost()`` / ``analyze_hlo(text)`` ->
  ``trace_cost(fn, *args)`` (a ``Cost``);
* ``collective_bytes_from_hlo(text)`` -> ``Cost.collectives``;
* ``cost_analysis_dict(compiled)`` -> ``Cost.as_dict()``;
* ``analyze_compiled(name, compiled, chips, model_flops)`` ->
  ``report(name, trace_cost(fn, *args)[1], chips, model_flops)``.
"""

from __future__ import annotations

import contextlib
import sys
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .analysis import NODE_GPUS, PEAK_FLOPS, RooflineReport
from .kernel_cost import kernel_work, ssd_scan_work

aten = torch.ops.aten

_MATMULS = {aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default}
_CONVS = {aten.convolution.default}
# allocations and metadata: no data moves
_FREE = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
         aten.new_empty.default, aten.new_empty_strided.default, aten.detach.default,
         aten.alias.default, aten.lift_fresh.default, aten._local_scalar_dense.default}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")
_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"), ("broadcast", "broadcast"))


def _unit(t: torch.Tensor) -> str:
    return "bf16" if t.dtype in (torch.bfloat16, torch.float16) else "f32"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class Cost:
    flops: Dict[str, float] = field(default_factory=dict)      # by unit
    bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)
    network: Dict[str, float] = field(default_factory=dict)    # the cross-node part
    kernels: Dict[str, int] = field(default_factory=dict)      # launches by kernel
    peak_live_bytes: int = 0
    ops: int = 0
    propagation_ops: int = 0       # DTensor's global-shape runs, not counted

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def counters(self) -> Tuple:
        """The additive counters, for ``add``'s delta."""
        return (dict(self.flops), self.bytes, dict(self.collectives), dict(self.network),
                dict(self.kernels), self.ops)

    def add(self, before: Tuple, after: Tuple) -> None:
        """Adds the counters' change from ``before`` to ``after`` (both
        ``counters()``) once more."""
        (f0, b0, c0, n0, k0, o0), (f1, b1, c1, n1, k1, o1) = before, after
        for mine, x0, x1 in ((self.flops, f0, f1), (self.collectives, c0, c1),
                             (self.network, n0, n1), (self.kernels, k0, k1)):
            for k, v in x1.items():
                mine[k] = mine.get(k, 0) + v - x0.get(k, 0)
        self.bytes += b1 - b0
        self.ops += o1 - o0

    def as_dict(self) -> Dict:
        return {"flops": dict(self.flops), "bytes": self.bytes,
                "collectives": dict(self.collectives), "network": dict(self.network),
                "kernels": dict(self.kernels), "peak_live_bytes": self.peak_live_bytes,
                "ops": self.ops, "propagation_ops": self.propagation_ops}


def _in_alltoall_standin() -> bool:
    """Whether the collective being dispatched is DTensor's stand-in for an
    all-to-all on a CPU mesh (``_collective_utils.shard_dim_alltoall``
    gathers the whole dim and keeps its chunk, as gloo has no all-to-all);
    on a CUDA mesh the same redistribution is one all-to-all."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def _group_in_node(group_name: str) -> bool:
    pg = dist.distributed_c10d._resolve_process_group(group_name)
    ranks = dist.get_process_group_ranks(pg)
    return len({r // NODE_GPUS for r in ranks}) == 1


class DispatchCostMode(TorchDispatchMode):
    """Counts one rank's local work (see the module docstring) into
    ``self.cost`` while it is active."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live = 0
        self._seen: Dict[int, int] = {}       # storage -> bytes, while alive
        self._in_node: Dict[str, bool] = {}
        self._window_peak = 0
        self._vjps: Dict[Tuple, Tuple] = {}

    # -- live storages ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self._live += n
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self._live)
        self._window_peak = max(self._window_peak, self._live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._seen.pop(key, 0)

    def _add_flops(self, unit: str, n: float) -> None:
        self.cost.flops[unit] = self.cost.flops.get(unit, 0.0) + n

    # -- the ops ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            self.cost.propagation_ops += 1     # DTensor's sharding propagation
            return out
        self._charge(func, args, ins, outs)
        return out

    def _charge(self, func, args, ins, outs) -> None:
        c = self.cost
        c.ops += 1
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NS or (ns, name) == ("_dtensor", "shard_dim_alltoall"):
            kind = next((k for prefix, k in _KINDS
                         if name.removeprefix("shard_dim_").startswith(prefix)), None)
            if kind is not None:
                group = [a for a in args if isinstance(a, str)][-1]   # the group's name
                if group not in self._in_node:
                    self._in_node[group] = _group_in_node(group)
                n = sum(_nbytes(t) for t in outs)
                if kind == "all-gather" and _in_alltoall_standin():
                    # charged as the all-to-all a CUDA mesh runs: its result
                    # is one group member's share of the gathered one
                    kind, n = "all-to-all", n // dist.get_world_size(
                        dist.distributed_c10d._resolve_process_group(group))
                c.collectives[kind] = c.collectives.get(kind, 0.0) + n
                if not self._in_node[group]:
                    c.network[kind] = c.network.get(kind, 0.0) + n
                for t in outs:
                    self._track(t)
            return
        if ns == "repro_torch":
            self._charge_kernel(name, args, outs[0])
        elif func in _MATMULS:
            a, b = args[-2], args[-1]
            self._add_flops(_unit(a), 2.0 * outs[0].numel() * a.shape[-1])
        elif func in _CONVS:
            w = args[1]
            self._add_flops(_unit(args[0]), 2.0 * outs[0].numel() * (w.numel() // w.shape[0]))
        if func.is_view:
            return
        mutable = func._schema.is_mutable         # writes into its operands: no new storage
        if func not in _FREE and ns != "repro_torch":
            c.bytes += sum(_nbytes(t) for t in ins)
            if not mutable:
                c.bytes += sum(_nbytes(t) for t in outs)
        if not mutable:
            for t in outs:
                self._track(t)

    def _charge_kernel(self, name: str, args, out) -> None:
        if name == "flash_attention":
            q, k, v, causal, q_offset = args[:5]
            works = [("flash_attention", *kernel_work("flash_attention", (q, k, v), out,
                                                      causal=causal, q_offset=q_offset))]
        else:                                  # ssd_scan(x, dt, a, b, c, chunk)
            works = ssd_scan_work(*args[:6])
        for kname, nbytes, ops, peak in works:
            self.cost.bytes += nbytes
            self._add_flops("bf16" if peak == PEAK_FLOPS else "f32", ops)
            self.cost.kernels[kname] = self.cost.kernels.get(kname, 0) + 1


    # -- the kernels' plain backward, traced once a signature -----------------
    def plain_vjp(self, run, plain, inputs, needs, grad_out, **kw):
        """``kernels.grad._plain_vjp`` on meta tensors, traced once for each
        signature (the plain version, its inputs' shapes and dtypes, which
        gradients, its blocks, query offset or chunk) and charged that
        trace's counters and transient peak at every later call, which
        returns fresh gradients of the same shapes: every layer and
        microbatch runs the same ops on the same shapes, and tracing them op
        by op again would take most of a train cell's trace."""
        key = (plain.__name__, tuple((tuple(t.shape), t.dtype) for t in inputs), tuple(needs),
               tuple(grad_out.shape), tuple(sorted(kw.items())))
        if key in self._vjps:
            delta, transient = self._vjps[key]
            self.cost.add(*delta)
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self._live + transient)
            return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) if need else None
                         for t, need in zip(inputs, needs))
        before, live0, window0 = self.cost.counters(), self._live, self._window_peak
        self._window_peak = live0
        grads = run(plain, inputs, needs, grad_out, **kw)
        self._vjps[key] = ((before, self.cost.counters()), self._window_peak - live0)
        self._window_peak = max(window0, self._window_peak)
        return grads


@contextlib.contextmanager
def _tracing_plain_vjps(mode: DispatchCostMode) -> Iterator[None]:
    """Routes ``kernels.grad._plain_vjp`` of meta tensors through
    ``mode.plain_vjp`` while ``mode`` traces; CUDA and CPU calls go on as
    they are."""
    from repro_torch.kernels import grad

    run = grad._plain_vjp

    def vjp(plain, inputs, needs, grad_out, **kw):
        if grad_out.device.type != "meta":
            return run(plain, inputs, needs, grad_out, **kw)
        return mode.plain_vjp(run, plain, inputs, needs, grad_out, **kw)

    grad._plain_vjp = vjp
    try:
        yield
    finally:
        grad._plain_vjp = run


def trace_cost(fn, *args, **kwargs) -> Tuple[object, Cost, float]:
    """``fn(*args, **kwargs)`` under a ``DispatchCostMode``: (its result,
    the rank's ``Cost``, the trace's wall seconds)."""
    mode = DispatchCostMode()
    t0 = time.perf_counter()
    with mode, _tracing_plain_vjps(mode):
        out = fn(*args, **kwargs)
    return out, mode.cost, time.perf_counter() - t0


def report(name: str, cost: Cost, chips: int, model_flops: float = 0.0) -> RooflineReport:
    """The roofline report of one rank's traced ``cost``."""
    return RooflineReport(
        name, chips, cost.total_flops, cost.bytes,
        {k: int(v) for k, v in cost.collectives.items()}, model_flops,
        flops_by_unit=dict(cost.flops), network_bytes=int(sum(cost.network.values())),
        trace_cost=cost.as_dict(),
    )


__all__ = ["Cost", "DispatchCostMode", "report", "trace_cost"]
