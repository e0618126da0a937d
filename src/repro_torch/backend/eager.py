"""The plain PyTorch version of the generated group kernel.

``EagerKernel`` executes one planned :class:`~repro_torch.backend.plan.KernelGroup`
with torch ops on whatever device its tensors live on.  It computes what the
JAX package's generated Pallas kernel computes (``repro/backend/codegen.py``,
``emit_kernel``): the same grid sweep in the same order (row steps, then lane
steps, then reduction chunks, fastest last) with per-batch-slot warm-ups, the
same input-ring and line-buffer rotation on rows and on columns, the same
scratch panels, padded row and lane masks, masked K-tail and unrolled
accumulation order.  It is vectorized over each panel and over batch slots
(no state crosses slots), so it is the port's counterpart of Pallas
interpret mode: the only path the CPU tests can run, and the reference the
hand-written CUDA kernel (``cuda_codegen``) is held against on the card.

This module also resolves the plan's address arithmetic once, for both
versions: :class:`LoweredGroup` turns every load of every fused stage into a
:class:`Tap` (which source, and per source axis an affine index of the panel
coordinates and the grid position) and every stage panel into a
straight-line program of f32 operations in the Pallas kernel's order.  The
CUDA emitter prints the same programs as C, so the two versions run the same
f32 operations in the same order.  The eval counter (:func:`eval_trace`)
records each group's panel evaluation sites from the same lowering, for
both versions.
"""

from __future__ import annotations

import itertools
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.frontend.expr import BinOp, Const, Expr, FuncRef, IterVal, Select, UnOp

from .access import UnsupportedAccessError
from .errors import EmitError
from .plan import KernelGroup, StagePlan

# ---------------------------------------------------------------------------
# Eval counter (shared by both versions of a kernel)
# ---------------------------------------------------------------------------

# one list per open ``eval_trace()`` scope, innermost last
_EVAL_TRACE_STACK: List[List[Dict]] = []


@contextmanager
def eval_trace() -> Iterator[List[Dict]]:
    """Collect the eval-site records of kernels *first run* inside the
    scope, the counter behind the computed-exactly-once properties::

        with eval_trace() as trace:
            pp.run(inputs)
        assert trace  # [{kernel, stage, shift, lane_shift, rows, when}, ...]

    A record is one panel evaluation site of a kernel group, as the JAX
    package's ``codegen.eval_trace`` records it: ``when`` is ``"step0"``
    for a row line buffer's warm-up (``rows`` halo rows, once a row sweep),
    ``"lane0"`` for a lane line buffer's warm-up, and ``"every"`` for a
    panel evaluated at every grid step.  The JAX package records at
    jit-trace time, so on a kernel's first run; here a kernel (CUDA or
    eager) records its group's sites (:meth:`LoweredGroup.eval_sites`) on
    its first run inside a scope, once, and outside every scope a run
    only checks that no scope is open.  Scopes nest: records go to the
    innermost open scope."""
    trace: List[Dict] = []
    _EVAL_TRACE_STACK.append(trace)
    try:
        yield trace
    finally:
        _EVAL_TRACE_STACK.remove(trace)


def record_eval_sites(kernel) -> None:
    """Record ``kernel``'s eval sites into the innermost open scope on its
    first run inside one (the kernel wrappers call this on every run)."""
    if _EVAL_TRACE_STACK and not kernel.eval_recorded:
        kernel.eval_recorded = True
        _EVAL_TRACE_STACK[-1].extend(kernel.lg.eval_sites())


# ---------------------------------------------------------------------------
# Resolved address arithmetic (shared with cuda_codegen)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AxisIndex:
    """An affine index ``const + step * i0 + lstep * j + kstep * k + stride *
    p[q]``: ``i0`` is the row step, ``j`` the lane step, ``k`` the reduction
    chunk and ``p[q]`` the panel coordinate on panel axis ``q`` (``q is
    None``: no panel coordinate)."""

    q: Optional[int]
    const: int
    stride: int = 1
    step: int = 0
    lstep: int = 0
    kstep: int = 0


# ``(index, limit)`` pairs: an element is valid iff every index < its limit
Bounds = Tuple[Tuple[AxisIndex, int], ...]


@dataclass(frozen=True)
class Tap:
    """Where one load reads: a delivered view of a global buffer
    (``kind="view"``, ``src`` = view-group index), an input ring
    (``"ring"``, ring index) or a scratch entry (``"scratch"``, index into
    ``KernelGroup.scratch_entries()``).  ``bounds`` are the view's valid
    rows and lanes: past them the view is padding and reads as 0, as does
    any index outside the buffer."""

    kind: str
    src: int
    axes: Tuple[AxisIndex, ...]
    bounds: Bounds = ()


# A panel program is a tuple of SSA ops; op ``i`` may read ops ``< i``:
#   ("const", value)           f32 constant
#   ("iter", AxisIndex)        the index as f32
#   ("tap", Tap)               one load
#   ("bin", op, a, b)          add|sub|mul|div|min|max|shr|lt|gt
#   ("un", op, a)              sqrt|erf|exp
#   ("sel", c, t, f)           c != 0 ? t : f
#   ("mask", a, Bounds)        a where every bound holds, else 0.0
#   ("acc",)                   the running accumulator (a reduction chunk)
# The last op is the panel value.
Op = Tuple


def check_supported(kg: KernelGroup) -> None:
    """Raise :class:`EmitError` for a plan the port cannot run: an input
    ring on a non-leading axis (no plan produces one) or a carried halo
    wider than the block it rotates through."""
    for r in kg.rings:
        if r.lane:
            if r.halo > kg.bw:
                raise EmitError(
                    f"column ring halo {r.halo} exceeds the block width {kg.bw}",
                    kernel=kg.name,
                )
        elif r.axis != 0:
            raise EmitError(
                "the input ring on a non-leading axis variant of the generated "
                "kernel is not ported",
                kernel=kg.name,
            )
        elif r.halo > kg.bh:
            raise EmitError(
                f"input ring halo {r.halo} exceeds the block height {kg.bh}",
                kernel=kg.name,
            )
    for sp in kg.stages:
        lb = sp.line_buffer
        if lb is not None and lb.halo > (kg.bw if lb.lane else kg.bh):
            raise EmitError(
                f"line buffer halo {lb.halo} exceeds the block "
                f"{'width' if lb.lane else 'height'}",
                kernel=kg.name, stage=sp.name,
            )


def _view_bounds(kg: KernelGroup, gi: int, q0: Optional[int], qL: Optional[int]) -> Bounds:
    """Valid rows (panel axis ``q0``) and lanes (``qL``) of view group
    ``gi``'s delivered block."""
    g = kg.groups[gi]
    out = []
    if q0 is not None:
        limit = g.valid0 if g.valid0 is not None else (g.rows0 if g.pinned else kg.e0)
        out.append((AxisIndex(q0, 0, 1, 0 if g.pinned else kg.bh), limit))
    if qL is not None:
        limit = g.valid1 if g.valid1 is not None else (g.cols0 if g.lane_pinned else kg.e1)
        out.append((AxisIndex(qL, 0, 1, lstep=0 if g.lane_pinned else kg.bw), limit))
    return tuple(out)


def block_tap(kg: KernelGroup, gi: int) -> Tap:
    """The delivered block of view group ``gi`` (a ring's steady or pinned
    warm-up view), indexed by the block's own coordinates."""
    g = kg.groups[gi]
    axes = []
    for j in range(g.ndim):
        if j == g.blocked_axis:
            step = 0 if g.pinned else g.stride0 * kg.bh
            axes.append(AxisIndex(j, g.k0, g.stride0, step))
        elif j == g.lane_axis:
            lstep = 0 if g.lane_pinned else g.lane_stride * kg.bw
            axes.append(AxisIndex(j, g.l0, g.lane_stride, lstep=lstep))
        else:
            axes.append(AxisIndex(j, g.base[j]))
    return Tap("view", gi, tuple(axes), _view_bounds(kg, gi, g.blocked_axis, g.lane_axis))


class LoweredGroup:
    """A kernel group's plan with every load resolved to a :class:`Tap` and
    every (stage, row shift, lane shift) panel lowered to a program.  Under
    a grid reduction the output stage has two programs: ``init_program``
    (chunk 0's initial block) and ``programs[(output, 0, 0)]``, one chunk's
    accumulation starting from the ``("acc",)`` op."""

    def __init__(self, kg: KernelGroup):
        check_supported(kg)
        self.kg = kg
        self.entries = kg.scratch_entries()
        self.entry_index = {
            (sp.name, key): i for i, (sp, key) in enumerate(self.entries)
        }
        self.buffer_order: List[str] = []
        for g in kg.groups:
            if g.buffer not in self.buffer_order:
                self.buffer_order.append(g.buffer)
        self.slot_of = {b: i for i, b in enumerate(self.buffer_order)}
        self.lane = kg.lane_grid is not None
        self.steps = kg.steps0 if kg.streamed else 1
        self.lane_steps = kg.lane_steps
        self.red_steps = kg.red_grid.steps if kg.red_grid is not None else 1
        # a group that carries rows from one row step to the next sweeps its
        # row steps in order; under a lane grid only columns are carried
        # (plan.py: row carry cannot survive a lane grid), from one lane
        # step to the next inside each row step
        carries = bool(kg.rings) or bool(kg.line_buffered)
        self.row_carried = carries and not self.lane
        self.lane_carried = carries and self.lane
        self.programs: Dict[Tuple[str, int, int], Tuple[Op, ...]] = {}
        for sp, key in self.entries:
            lb = sp.line_buffer
            if key is None:
                pairs = [(lb.lo, 0), (lb.hi, 0)]
            elif isinstance(key, tuple) and key[1] is None:
                pairs = [(key[0], lb.lo), (key[0], lb.hi)]
            elif isinstance(key, tuple):
                pairs = [key]
            else:
                pairs = [(key, 0)]
            for s, t in pairs:
                self.programs[(sp.name, s, t)] = self._lower_panel(sp, s, t)
        out = kg.output
        self.init_program: Optional[Tuple[Op, ...]] = None
        if kg.red_grid is None:
            self.programs[(out.name, 0, 0)] = self._lower_panel(out, 0, 0)
        else:
            self.init_program = self._lower_init(out)
            self.programs[(out.name, 0, 0)] = self._lower_chunk(out)

    def eval_sites(self) -> List[Dict]:
        """Every panel evaluation site of the group, in the order and with
        the records of the JAX kernel body (``codegen.py`` 905-1003): each
        scratch entry in topological order (a line buffer's warm-up before
        its steady panel), then the output panel unless a grid reduction
        accumulates it."""
        kg = self.kg
        out: List[Dict] = []

        def site(sp: StagePlan, shift: int, lshift: int, rows: int, when: str) -> None:
            out.append({"kernel": kg.name, "stage": sp.name, "shift": shift,
                        "lane_shift": lshift, "rows": rows, "when": when})

        for sp, key in self.entries:
            lb = sp.line_buffer
            rows = self.panel_shape(sp)[0]
            if key is None:
                site(sp, lb.lo, 0, lb.halo, "step0")
                site(sp, lb.hi, 0, rows, "every")
            elif isinstance(key, tuple) and key[1] is None:
                site(sp, key[0], lb.lo, rows, "lane0")
                site(sp, key[0], lb.hi, rows, "every")
            elif isinstance(key, tuple):
                site(sp, key[0], key[1], rows, "every")
            else:
                site(sp, key, 0, rows, "every")
        if kg.red_grid is None:
            site(kg.output, 0, 0, self.panel_shape(kg.output)[0], "every")
        return out

    def streamed(self, sp: StagePlan) -> bool:
        return self.kg.streamed and sp.streamed

    def lane_blocked(self, sp: StagePlan) -> bool:
        return self.lane and self.streamed(sp)

    def panel_shape(
        self, sp: StagePlan, rows: Optional[int] = None, cols: Optional[int] = None
    ) -> Tuple[int, ...]:
        """Panel shape of ``sp``: ``rows`` leading rows (default ``bh``) when
        streamed, the full extents otherwise; under a lane grid ``cols``
        trailing lanes (default ``bw``)."""
        if not self.streamed(sp):
            return tuple(sp.nstage.pure_extents)
        shape = (self.kg.bh if rows is None else rows,) + tuple(sp.nstage.pure_extents[1:])
        if self.lane_blocked(sp):
            shape = shape[:-1] + (self.kg.bw if cols is None else cols,)
        return shape

    def mask_bounds(self, sp: StagePlan) -> Bounds:
        """The panel mask (``codegen.py`` ``panel_mask``): rows past a padded
        row grid's extent and lanes past a padded lane grid's extent."""
        kg = self.kg
        out = []
        if kg.padded_grid is not None and self.streamed(sp):
            out.append((AxisIndex(0, 0, 1, kg.bh), kg.padded_grid.extent))
        lg = kg.lane_grid
        if self.lane_blocked(sp) and lg.pad > 0:
            q = len(sp.nstage.pure_dims) - 1
            out.append((AxisIndex(q, 0, 1, lstep=kg.bw), lg.extent))
        return tuple(out)

    # -- lowering ---------------------------------------------------------

    def _tap(
        self, sp: StagePlan, k: int, rho: Mapping[str, int], shift: int, lshift: int
    ) -> Tap:
        kg = self.kg
        la = sp.accesses[k]
        pure_pos = {d: i for i, d in enumerate(sp.nstage.pure_dims)}
        lane = self.lane_blocked(sp)
        qL = len(sp.nstage.pure_dims) - 1
        last = len(la.axes) - 1

        def other(ax, base: int) -> AxisIndex:
            if ax.pure_dim is None:
                return AxisIndex(None, ax.offset_at(rho) - base)
            return AxisIndex(pure_pos[ax.pure_dim], ax.offset_at(rho) - base, ax.stride)

        if sp.load_kind[k] == "scratch":
            pname = sp.scratch_producer[k]
            slot = la.axes[0].offset_at(rho) + shift
            plb = kg.stage_plan(pname).line_buffer
            lead, lane_ax = 0, AxisIndex(qL, 0)
            if plb is not None and plb.lane:
                # one column ring per row shift; the lane-shift panel starts
                # ``lslot - lo`` columns in
                lslot = la.axes[-1].offset_at(rho) + lshift
                src = self.entry_index[(pname, (slot, None))]
                lane_ax = AxisIndex(qL, lslot - plb.lo)
            elif plb is not None:
                src, lead = self.entry_index[(pname, None)], slot - plb.lo
            elif lane:
                lslot = la.axes[-1].offset_at(rho) + lshift
                src = self.entry_index[(pname, (slot, lslot))]
            else:
                src = self.entry_index[(pname, slot)]
            axes = [AxisIndex(0, lead)] + [
                lane_ax if lane and j == last else other(ax, 0)
                for j, ax in enumerate(la.axes) if j > 0
            ]
            return Tap("scratch", src, tuple(axes))
        j0 = sp.blocked_axis_of[k]
        jL = sp.lane_axis_of[k] if lane else None
        roff = la.axes[j0].offset_at(rho) if j0 is not None else None
        if lane:
            loff = la.axes[jL].offset_at(rho) if jL is not None else None
            key: Tuple = (shift, roff, lshift, loff)
        else:
            key = (shift, roff)
        hit = sp.ring_binding[k].get(key) if sp.ring_binding else None
        if hit is not None:
            r, t0 = hit
            ring = kg.rings[r]
            axes = []
            for j, ax in enumerate(la.axes):
                if ring.lane and j == ring.axis:
                    # column ring: the tap's window starts t0 columns in
                    axes.append(AxisIndex(pure_pos[ax.pure_dim], t0))
                elif ring.lane and j == ring.row_axis:
                    axes.append(AxisIndex(0, 0))
                elif not ring.lane and j == j0:
                    axes.append(AxisIndex(0, t0))
                else:
                    axes.append(other(ax, ring.base[j]))
            return Tap("ring", r, tuple(axes))
        gi = sp.view_binding[k][key]
        g = kg.groups[gi]
        rg = kg.red_grid
        axes = []
        for j, ax in enumerate(la.axes):
            if j0 is not None and j == j0:
                step = 0 if g.pinned else g.stride0 * kg.bh
                axes.append(AxisIndex(0, g.k0, g.stride0, step))
            elif jL is not None and j == jL:
                lstep = 0 if g.lane_pinned else g.lane_stride * kg.bw
                axes.append(AxisIndex(qL, g.l0, g.lane_stride, lstep=lstep))
            elif j == g.red_axis:
                # resident or chunked, the operand is read at the global
                # reduction position: chunk * k + the in-chunk offset
                axes.append(AxisIndex(None, ax.offset_at(rho) - g.base[j], kstep=rg.chunk))
            else:
                axes.append(other(ax, 0))
        return Tap("view", gi, tuple(axes), _view_bounds(kg, gi, 0 if j0 is not None else None,
                                                          qL if jL is not None else None))

    def _emitter(self, sp: StagePlan, ops: List[Op], shift: int, lshift: int):
        ns = sp.nstage
        lower = dict(ns.dim_lower)
        pure_pos = {d: i for i, d in enumerate(ns.pure_dims)}
        row = self.streamed(sp)
        lane = self.lane_blocked(sp)
        qL = len(ns.pure_dims) - 1
        kg = self.kg
        rg = kg.red_grid

        def emit(e: Expr, rho: Mapping[str, int], counter: List[int]) -> int:
            if isinstance(e, Const):
                ops.append(("const", float(e.value)))
            elif isinstance(e, IterVal):
                lo = lower.get(e.name, 0)
                if e.name in ns.red_dims:
                    # an index, not a constant: a reduction's terms that read
                    # their own variable differ in index constants alone,
                    # which the emitter rolls into a loop
                    kstep = rg.chunk if rg is not None and e.name == rg.dim else 0
                    ops.append(("iter", AxisIndex(None, rho[e.name] + lo, kstep=kstep)))
                else:
                    q = pure_pos[e.name]
                    if row and q == 0:
                        ops.append(("iter", AxisIndex(q, lo + shift, 1, kg.bh)))
                    elif lane and q == qL:
                        ops.append(("iter", AxisIndex(q, lo + lshift, 1, lstep=kg.bw)))
                    else:
                        ops.append(("iter", AxisIndex(q, lo)))
            elif isinstance(e, FuncRef):
                k = counter[0]
                counter[0] += 1
                ops.append(("tap", self._tap(sp, k, rho, shift, lshift)))
            elif isinstance(e, BinOp):
                if e.op not in _BINOPS:
                    raise UnsupportedAccessError(
                        f"binop {e.op} not supported by codegen"
                    )
                a = emit(e.a, rho, counter)
                b = emit(e.b, rho, counter)
                ops.append(("bin", e.op, a, b))
            elif isinstance(e, UnOp):
                if e.op not in _UNOPS:
                    raise UnsupportedAccessError(
                        f"unary op {e.op} not supported by codegen"
                    )
                ops.append(("un", e.op, emit(e.a, rho, counter)))
            elif isinstance(e, Select):
                c = emit(e.cond, rho, counter)
                t = emit(e.if_true, rho, counter)
                f = emit(e.if_false, rho, counter)
                ops.append(("sel", c, t, f))
            else:
                raise UnsupportedAccessError(f"cannot compile {e!r}")
            return len(ops) - 1

        return emit

    def _masked(self, sp: StagePlan, ops: List[Op]) -> None:
        bounds = self.mask_bounds(sp)
        if bounds:
            ops.append(("mask", len(ops) - 1, bounds))

    def _lower_panel(self, sp: StagePlan, shift: int, lshift: int) -> Tuple[Op, ...]:
        ns = sp.nstage
        ops: List[Op] = []
        emit = self._emitter(sp, ops, shift, lshift)
        if ns.red_dims:
            acc = emit(ns.init, {}, [0])
            ranges = [range(ex) for ex in ns.red_extents]
            for combo in itertools.product(*ranges):
                term = emit(ns.value, dict(zip(ns.red_dims, combo)), [0])
                ops.append(("bin", ns.combiner, acc, term))
                acc = len(ops) - 1
        else:
            emit(ns.value, {}, [0])
        self._masked(sp, ops)
        return tuple(ops)

    def _lower_init(self, sp: StagePlan) -> Tuple[Op, ...]:
        ops: List[Op] = []
        self._emitter(sp, ops, 0, 0)(sp.nstage.init, {}, [0])
        self._masked(sp, ops)
        return tuple(ops)

    def _lower_chunk(self, sp: StagePlan) -> Tuple[Op, ...]:
        """One reduction chunk (``codegen.py`` 984-999): every in-chunk term
        in ``itertools.product`` order, a K-tail term past the extent
        replaced by 0.0, masked, and added to the accumulator."""
        ns = sp.nstage
        rg = self.kg.red_grid
        ops: List[Op] = [("acc",)]
        emit = self._emitter(sp, ops, 0, 0)
        ranges = [
            range(rg.chunk if rd == rg.dim else ex)
            for rd, ex in zip(ns.red_dims, ns.red_extents)
        ]
        acc = 0
        for combo in itertools.product(*ranges):
            rho = dict(zip(ns.red_dims, combo))
            emit(ns.value, rho, [0])
            if rg.padded:
                tail = AxisIndex(None, rho[rg.dim], kstep=rg.chunk)
                ops.append(("mask", len(ops) - 1, ((tail, rg.extent),)))
            self._masked(sp, ops)
            ops.append(("bin", ns.combiner, acc, len(ops) - 1))
            acc = len(ops) - 1
        return tuple(ops)


_BINOPS = ("add", "sub", "mul", "div", "min", "max", "shr", "lt", "gt")
# torch's square root is IEEE's, as CUDA's ``sqrtf`` and the host's are; its
# ``erf`` and ``exp`` are the device library's own, within a few ulp of any
# other
_UNOPS = {"sqrt": torch.sqrt, "erf": torch.erf, "exp": torch.exp}


# ---------------------------------------------------------------------------
# Execution with torch ops
# ---------------------------------------------------------------------------


def _binop(op: str, a: torch.Tensor, b: torch.Tensor, one, zero) -> torch.Tensor:
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        # reference semantics: x / 0 == 0.  Both operands are tensors, so
        # torch divides (a CPU-scalar divisor would make CUDA multiply by
        # the reciprocal instead, which rounds differently)
        z = b == 0
        return torch.where(z, zero, a / torch.where(z, one, b))
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    if op == "shr":
        return (a.to(torch.int32) >> b.to(torch.int32)).to(torch.float32)
    if op == "lt":
        return torch.where(a < b, one, zero)
    if op == "gt":
        return torch.where(a > b, one, zero)
    raise UnsupportedAccessError(f"binop {op} not supported by codegen")


def _slab(axis: int, lo: int, hi: int) -> Tuple[slice, ...]:
    """Index of ``[lo, hi)`` on ``axis`` of a tensor with a leading batch dim."""
    return (slice(None),) * (axis + 1) + (slice(lo, hi),)


def _resized(shape: Sequence[int], axis: int, n: int) -> Tuple[int, ...]:
    return tuple(n if d == axis else s for d, s in enumerate(shape))


class _Env:
    """Sources one grid step's panels read: the batched global buffers, the
    input rings and the scratch entries (each with a leading batch dim),
    and the grid position ``(i0, j, k)``."""

    def __init__(self, lg: LoweredGroup, srcs, rings, scratch, device):
        self.lg = lg
        self.srcs = srcs
        self.rings = rings
        self.scratch = scratch
        self.device = device
        self.i0 = self.j = self.k = 0
        self._consts: Dict[float, torch.Tensor] = {}

    def const(self, v: float) -> torch.Tensor:
        t = self._consts.get(v)
        if t is None:
            t = torch.tensor(v, dtype=torch.float32, device=self.device)
            self._consts[v] = t
        return t

    def coord(self, shape: Sequence[int], q: int) -> torch.Tensor:
        view = [1] * (len(shape) + 1)
        view[q + 1] = shape[q]
        return torch.arange(shape[q], device=self.device).view(view)

    def base(self, ax: AxisIndex) -> int:
        return ax.const + ax.step * self.i0 + ax.lstep * self.j + ax.kstep * self.k

    def span(self, ax: AxisIndex, shape: Sequence[int]) -> Tuple[int, int]:
        """Smallest and largest value of ``ax`` over a panel of ``shape``."""
        b = self.base(ax)
        if ax.q is None:
            return b, b
        e = b + ax.stride * (shape[ax.q] - 1)
        return min(b, e), max(b, e)

    def index(self, ax: AxisIndex, shape: Sequence[int]):
        b = self.base(ax)
        if ax.q is None:
            return torch.tensor(b, device=self.device)
        return b + ax.stride * self.coord(shape, ax.q)

    def valid(self, bounds: Bounds, shape: Sequence[int]) -> Optional[torch.Tensor]:
        """Where every bound holds over a panel of ``shape``; None when all
        hold everywhere."""
        ok = None
        for ax, limit in bounds:
            if self.span(ax, shape)[1] < limit:
                continue
            t = self.index(ax, shape) < limit
            ok = t if ok is None else ok & t
        return ok

    def gather(self, tap: Tap, shape: Sequence[int]) -> torch.Tensor:
        """``tap``'s values over a panel of ``shape`` (leading batch dim)."""
        if tap.kind == "view":
            src = self.srcs[self.lg.slot_of[self.lg.kg.groups[tap.src].buffer]]
        elif tap.kind == "ring":
            src = self.rings[tap.src]
        else:
            src = self.scratch[tap.src]
        qs = [ax.q for ax in tap.axes if ax.q is not None]
        inside = all(
            0 <= lo and hi < n
            for (lo, hi), n in zip((self.span(ax, shape) for ax in tap.axes), src.shape[1:])
        )
        if inside and len(set(qs)) == len(qs) and all(
            ax.stride > 0 for ax in tap.axes if ax.q is not None
        ):
            # every index in range: a strided view of the source, its axes
            # put in panel order
            sl: List[object] = [slice(None)]
            for ax in tap.axes:
                b = self.base(ax)
                if ax.q is None:
                    sl.append(b)
                else:
                    sl.append(slice(b, b + ax.stride * (shape[ax.q] - 1) + 1, ax.stride))
            out = src[tuple(sl)]
            order = sorted(range(len(qs)), key=lambda i: qs[i])
            out = out.permute(0, *[1 + i for i in order])
            out = out.reshape(
                [out.shape[0]] + [shape[q] if q in qs else 1 for q in range(len(shape))]
            )
        else:
            nb = src.shape[0]
            idx: List[torch.Tensor] = [
                torch.arange(nb, device=self.device).view([nb] + [1] * len(shape))
            ]
            ok = None
            for j, ax in enumerate(tap.axes):
                t = self.index(ax, shape)
                n = src.shape[j + 1]
                lo, hi = self.span(ax, shape)
                if lo < 0 or hi >= n:
                    inb = (t >= 0) & (t < n)
                    ok = inb if ok is None else ok & inb
                    t = t.clamp(0, n - 1)
                idx.append(t)
            out = src[tuple(idx)]
            if ok is not None:
                out = torch.where(ok, out, self.const(0.0))
        ok = self.valid(tap.bounds, shape)
        if ok is not None:
            out = torch.where(ok, out, self.const(0.0))
        return out

    def run(
        self, ops: Sequence[Op], shape: Sequence[int], acc: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        one, zero = self.const(1.0), self.const(0.0)
        vals: List[torch.Tensor] = []
        for op in ops:
            kind = op[0]
            if kind == "const":
                v = self.const(op[1])
            elif kind == "iter":
                v = self.index(op[1], shape).to(torch.float32)
            elif kind == "tap":
                v = self.gather(op[1], shape)
            elif kind == "bin":
                v = _binop(op[1], vals[op[2]], vals[op[3]], one, zero)
            elif kind == "un":
                v = _UNOPS[op[1]](vals[op[2]])
            elif kind == "sel":
                v = torch.where(vals[op[1]] != 0, vals[op[2]], vals[op[3]])
            elif kind == "mask":
                ok = self.valid(op[2], shape)
                v = vals[op[1]] if ok is None else torch.where(ok, vals[op[1]], zero)
            else:
                v = acc
            vals.append(v)
        return vals[-1]


class GroupKernel:
    """What both versions of a generated kernel share: the lowered group
    and the plan passthroughs the JAX package's ``CompiledKernel`` exposes
    (its output stage ``name``, ``stage_names``, ``bh``, ``grid``,
    ``groups``, ``rings``, the padded and reduction grids, the
    unified-buffer ``plan``), and whether its eval sites were recorded
    (:func:`eval_trace`)."""

    def __init__(self, lowered: LoweredGroup):
        self.lg = lowered
        self.kg = lowered.kg
        self.eval_recorded = False

    @property
    def name(self) -> str:
        return self.kg.name

    @property
    def stage_names(self) -> List[str]:
        return self.kg.stage_names

    @property
    def plan(self):
        return self.kg.ub_plan()

    @property
    def fused(self) -> bool:
        return self.kg.fused

    @property
    def groups(self):
        return self.kg.groups

    @property
    def bh(self) -> int:
        return self.kg.bh

    @property
    def grid(self) -> Tuple[int, ...]:
        return self.kg.grid

    @property
    def streamed(self) -> bool:
        return self.kg.streamed

    @property
    def red_grid(self):
        return self.kg.red_grid

    @property
    def padded_grid(self):
        return self.kg.padded_grid

    @property
    def rings(self):
        return self.kg.rings

    @property
    def line_buffered(self) -> Tuple[str, ...]:
        return self.kg.line_buffered

    @property
    def block(self) -> Tuple[int, ...]:
        return self.kg.output.panel_shape(self.kg.bh)


class EagerKernel(GroupKernel):
    """Plain-PyTorch execution of one lowered kernel group.  Call with a
    mapping of buffer name -> f32 tensor (leading batch dim of
    ``batch_steps`` slots when the group is batched); returns the group's
    output tensor."""

    def _panel(
        self, env: _Env, sp: StagePlan, shift: int, lshift: int,
        rows: Optional[int] = None, cols: Optional[int] = None,
    ) -> torch.Tensor:
        shape = self.lg.panel_shape(sp, rows, cols)
        v = env.run(self.lg.programs[(sp.name, shift, lshift)], shape)
        nb = env.srcs[0].shape[0]
        return torch.broadcast_to(v, (nb,) + shape).to(torch.float32)

    def _rings(self, env: _Env, rings: List[torch.Tensor]) -> None:
        """Input delivery rings (``codegen.py`` 864-902): rotate the carried
        halo (warm up from the pinned prefix view at the first row step, or
        at the first lane step for a column ring), land the new block."""
        kg = self.kg
        for r, ring in enumerate(kg.rings):
            h, ax = ring.halo, ring.axis
            n = kg.bw if ring.lane else kg.bh
            first = env.j == 0 if ring.lane else env.i0 == 0
            shape = ring.ring_shape(kg.bh, kg.bw)
            if not first:
                rings[r][_slab(ax, 0, h)] = rings[r][_slab(ax, n, n + h)].clone()
            else:
                rings[r][_slab(ax, 0, h)] = env.gather(
                    block_tap(kg, ring.prefix), _resized(shape, ax, h)
                )
            rings[r][_slab(ax, h, h + n)] = env.gather(
                block_tap(kg, ring.steady), _resized(shape, ax, n)
            )

    def _scratch(self, env: _Env, scratch: List[torch.Tensor]) -> None:
        """Fused intermediates in topological order (``codegen.py`` 908-966)."""
        kg, lg = self.kg, self.lg
        bh, bw = kg.bh, kg.bw
        for si, (sp, key) in enumerate(lg.entries):
            buf = scratch[si]
            lb = sp.line_buffer
            if key is None:
                # row line buffer: rotate halo rows, warm up at row step 0
                h = lb.halo
                if env.i0 > 0:
                    buf[:, :h] = buf[:, bh:bh + h].clone()
                else:
                    buf[:, :h] = self._panel(env, sp, lb.lo, 0, rows=h)
                buf[:, h:h + bh] = self._panel(env, sp, lb.hi, 0)
            elif isinstance(key, tuple) and key[1] is None:
                # lane line buffer: one column ring per row shift, rotated per
                # lane step, warmed up with a halo-wide panel at lane step 0
                h, ax = lb.halo, buf.dim() - 2
                if env.j > 0:
                    buf[_slab(ax, 0, h)] = buf[_slab(ax, bw, bw + h)].clone()
                else:
                    buf[_slab(ax, 0, h)] = self._panel(env, sp, key[0], lb.lo, cols=h)
                buf[_slab(ax, h, h + bw)] = self._panel(env, sp, key[0], lb.hi)
            elif isinstance(key, tuple):
                buf[...] = self._panel(env, sp, key[0], key[1])
            else:
                buf[...] = self._panel(env, sp, key, 0)

    def __call__(self, buffers: Mapping[str, torch.Tensor]) -> torch.Tensor:
        kg, lg = self.kg, self.lg
        kg.validate_buffers(buffers)
        record_eval_sites(self)
        batched = kg.batch_grid is not None
        srcs = [
            buffers[b] if batched else buffers[b].unsqueeze(0)
            for b in lg.buffer_order
        ]
        dev = srcs[0].device
        nb = srcs[0].shape[0]
        bh, bw = kg.bh, kg.bw
        f32 = dict(dtype=torch.float32, device=dev)
        scratch = [
            torch.zeros((nb,) + sp.scratch_shape(bh, key), **f32)
            for sp, key in lg.entries
        ]
        rings = [torch.zeros((nb,) + r.ring_shape(bh, bw), **f32) for r in kg.rings]
        out_sp = kg.output
        out = torch.zeros((nb,) + tuple(out_sp.nstage.pure_extents), **f32)
        nd = out.dim() - 1
        env = _Env(lg, srcs, rings, scratch, dev)
        red = kg.red_grid is not None
        panel = None
        for i0, j, k in itertools.product(
            range(lg.steps), range(lg.lane_steps), range(lg.red_steps)
        ):
            env.i0, env.j, env.k = i0, j, k
            if k == 0:
                # rings land once per row panel, on chunk 0
                self._rings(env, rings)
            self._scratch(env, scratch)
            shape = lg.panel_shape(out_sp)
            if not red:
                panel = self._panel(env, out_sp, 0, 0)
            else:
                if k == 0:
                    init = env.run(lg.init_program, shape)
                    panel = torch.broadcast_to(init, (nb,) + shape).to(torch.float32)
                acc = env.run(lg.programs[(out_sp.name, 0, 0)], shape, acc=panel)
                panel = torch.broadcast_to(acc, (nb,) + shape).to(torch.float32)
            if lg.streamed(out_sp):
                n = min(bh, kg.e0 - i0 * bh)
                dst = [slice(None), slice(i0 * bh, i0 * bh + n)]
                src = [slice(None), slice(0, n)]
                if lg.lane_blocked(out_sp):
                    m = min(bw, kg.e1 - j * bw)
                    pad = [slice(None)] * (nd - 2)
                    dst += pad + [slice(j * bw, j * bw + m)]
                    src += pad + [slice(0, m)]
                out[tuple(dst)] = panel[tuple(src)]
            else:
                out[...] = panel
        return out if batched else out[0]


__all__ = [
    "AxisIndex",
    "EagerKernel",
    "GroupKernel",
    "LoweredGroup",
    "Tap",
    "block_tap",
    "check_supported",
    "eval_trace",
    "record_eval_sites",
]
