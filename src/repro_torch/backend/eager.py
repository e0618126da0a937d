"""The plain PyTorch version of the generated group kernel.

``EagerKernel`` executes one planned :class:`~repro_torch.backend.plan.KernelGroup`
with torch ops on whatever device its tensors live on.  It computes what the
JAX package's generated Pallas kernel computes (``repro/backend/codegen.py``,
``emit_kernel``): the same row-step loop with per-batch-slot warm-ups, the
same input-ring and line-buffer rotation, the same scratch panels, padded-row
masks and unrolled accumulation order.  It is vectorized over each panel and
over batch slots (no state crosses slots), so it is the port's counterpart of
Pallas interpret mode: the only path the CPU tests can run, and the reference
the hand-written CUDA kernel (``cuda_codegen``) is held against on the card.

This module also resolves the plan's address arithmetic once, for both
versions: :class:`LoweredGroup` turns every load of every fused stage into a
:class:`Tap` (which source, and per source axis an affine index of the panel
coordinates and the row step) and every stage panel into a straight-line
program of f32 operations in the reference interpreter's order.  The CUDA
emitter prints the same programs as C, so the two versions run the same f32
operations in the same order.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.frontend.expr import BinOp, Const, Expr, FuncRef, IterVal, Select

from .access import UnsupportedAccessError
from .errors import EmitError
from .plan import KernelGroup, StagePlan

# ---------------------------------------------------------------------------
# Resolved address arithmetic (shared with cuda_codegen)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AxisIndex:
    """Index along one source axis: ``const + step * i0 + stride * p[q]``,
    where ``i0`` is the row step and ``p[q]`` the panel coordinate on panel
    axis ``q`` (``q is None``: a static index)."""

    q: Optional[int]
    const: int
    stride: int = 1
    step: int = 0


@dataclass(frozen=True)
class Tap:
    """Where one load reads: a delivered view of a global buffer
    (``kind="view"``, ``src`` = view-group index), an input ring
    (``"ring"``, ring index) or a scratch entry (``"scratch"``, index into
    ``KernelGroup.scratch_entries()``).  ``rows`` bounds a view read on its
    blocked axis: the element is valid iff ``rows[0] * i0 + p[0] <
    rows[1]`` (rows past the view's extent are padding and read as 0)."""

    kind: str
    src: int
    axes: Tuple[AxisIndex, ...]
    rows: Optional[Tuple[int, int]] = None


# A panel program is a tuple of SSA ops; op ``i`` may read ops ``< i``:
#   ("const", value)           f32 constant
#   ("iter", q, const, step)   float(p[q] + const + step * i0)
#   ("tap", Tap)               one load
#   ("bin", op, a, b)          add|sub|mul|div|min|max|shr|lt|gt
#   ("sel", c, t, f)           c != 0 ? t : f
# The last op is the panel value.
Op = Tuple


def check_supported(kg: KernelGroup) -> None:
    """Raise :class:`EmitError` for the generated-kernel variants this port
    does not run yet (ROADMAP, Queue 2 item 1 slices (c), (e), (f))."""
    variant = None
    if kg.red_grid is not None:
        variant = "grid reduction (Queue 2 item 1 slice (c))"
    elif kg.lane_grid is not None:
        variant = "lane grid (Queue 2 item 1 slice (e))"
    elif any(r.lane for r in kg.rings):
        variant = "column ring (Queue 2 item 1 slice (f))"
    elif any(sp.line_buffer is not None and sp.line_buffer.lane for sp in kg.stages):
        variant = "lane line buffer (Queue 2 item 1 slice (f))"
    elif any(r.axis != 0 for r in kg.rings):
        variant = "input ring on a non-leading axis"
    if variant is not None:
        raise EmitError(
            f"the {variant} variant of the generated kernel is not ported yet",
            kernel=kg.name,
        )
    for r in kg.rings:
        if r.halo > kg.bh:
            raise EmitError(
                f"input ring halo {r.halo} exceeds the block height {kg.bh}",
                kernel=kg.name,
            )
    for sp in kg.stages:
        lb = sp.line_buffer
        if lb is not None and lb.halo > kg.bh:
            raise EmitError(
                f"line buffer halo {lb.halo} exceeds the block height {kg.bh}",
                kernel=kg.name, stage=sp.name,
            )


def view_limit(kg: KernelGroup, gi: int) -> int:
    """Valid elements of view group ``gi`` along its blocked axis."""
    g = kg.groups[gi]
    if g.valid0 is not None:
        return g.valid0
    return g.rows0 if g.pinned else kg.e0


def block_tap(kg: KernelGroup, gi: int) -> Tap:
    """The delivered block of view group ``gi`` (a ring's steady or pinned
    warm-up view), indexed by the block's own coordinates."""
    g = kg.groups[gi]
    axes = []
    for j in range(g.ndim):
        if j == g.blocked_axis:
            step = 0 if g.pinned else g.stride0 * kg.bh
            axes.append(AxisIndex(j, g.k0, g.stride0, step))
        else:
            axes.append(AxisIndex(j, g.base[j]))
    rows = (0 if g.pinned else kg.bh, view_limit(kg, gi))
    return Tap("view", gi, tuple(axes), rows)


class LoweredGroup:
    """A kernel group's plan with every load resolved to a :class:`Tap` and
    every (stage, shift) panel lowered to a program."""

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
        self.steps = kg.steps0 if kg.streamed else 1
        # a group that carries rows from one row step to the next must sweep
        # its row steps in order
        self.carried = bool(kg.rings) or bool(kg.line_buffered)
        self.programs: Dict[Tuple[str, int], Tuple[Op, ...]] = {}
        for sp, key in self.entries:
            if key is None:
                shifts = (sp.line_buffer.lo, sp.line_buffer.hi)
            else:
                shifts = (key,)
            for s in shifts:
                self.programs[(sp.name, s)] = self._lower_panel(sp, s)
        self.programs[(kg.output.name, 0)] = self._lower_panel(kg.output, 0)

    def streamed(self, sp: StagePlan) -> bool:
        return self.kg.streamed and sp.streamed

    def panel_shape(self, sp: StagePlan, rows: Optional[int] = None) -> Tuple[int, ...]:
        """Panel shape of ``sp``: ``rows`` leading rows (default ``bh``) when
        streamed, the full extents otherwise."""
        if not self.streamed(sp):
            return tuple(sp.nstage.pure_extents)
        return (self.kg.bh if rows is None else rows,) + tuple(
            sp.nstage.pure_extents[1:]
        )

    def masked(self, sp: StagePlan) -> bool:
        return self.kg.padded_grid is not None and self.streamed(sp)

    # -- lowering ---------------------------------------------------------

    def _tap(self, sp: StagePlan, k: int, rho: Mapping[str, int], shift: int) -> Tap:
        kg = self.kg
        la = sp.accesses[k]
        pure_pos = {d: i for i, d in enumerate(sp.nstage.pure_dims)}

        def other(ax, base: int) -> AxisIndex:
            if ax.pure_dim is None:
                return AxisIndex(None, ax.offset_at(rho) - base)
            return AxisIndex(pure_pos[ax.pure_dim], ax.offset_at(rho) - base, ax.stride)

        if sp.load_kind[k] == "scratch":
            pname = sp.scratch_producer[k]
            slot = la.axes[0].offset_at(rho) + shift
            plb = kg.stage_plan(pname).line_buffer
            if plb is not None:
                src, lead = self.entry_index[(pname, None)], slot - plb.lo
            else:
                src, lead = self.entry_index[(pname, slot)], 0
            axes = [AxisIndex(0, lead)] + [other(ax, 0) for ax in la.axes[1:]]
            return Tap("scratch", src, tuple(axes))
        j0 = sp.blocked_axis_of[k]
        roff = la.axes[j0].offset_at(rho) if j0 is not None else None
        key = (shift, roff)
        hit = sp.ring_binding[k].get(key) if sp.ring_binding else None
        if hit is not None:
            r, t0 = hit
            ring = kg.rings[r]
            axes = [
                AxisIndex(0, t0) if j == j0 else other(ax, ring.base[j])
                for j, ax in enumerate(la.axes)
            ]
            return Tap("ring", r, tuple(axes))
        gi = sp.view_binding[k][key]
        g = kg.groups[gi]
        axes = []
        for j, ax in enumerate(la.axes):
            if j0 is not None and j == j0:
                step = 0 if g.pinned else g.stride0 * kg.bh
                axes.append(AxisIndex(0, g.k0, g.stride0, step))
            else:
                axes.append(other(ax, 0))
        rows = None
        if j0 is not None:
            rows = (0 if g.pinned else kg.bh, view_limit(kg, gi))
        return Tap("view", gi, tuple(axes), rows)

    def _lower_panel(self, sp: StagePlan, shift: int) -> Tuple[Op, ...]:
        ns = sp.nstage
        ops: List[Op] = []
        lower = dict(ns.dim_lower)
        pure_pos = {d: i for i, d in enumerate(ns.pure_dims)}
        row = self.streamed(sp)

        def emit(e: Expr, rho: Mapping[str, int], counter: List[int]) -> int:
            if isinstance(e, Const):
                ops.append(("const", float(e.value)))
            elif isinstance(e, IterVal):
                lo = lower.get(e.name, 0)
                if e.name in ns.red_dims:
                    ops.append(("const", float(rho[e.name] + lo)))
                else:
                    q = pure_pos[e.name]
                    if row and q == 0:
                        ops.append(("iter", q, lo + shift, self.kg.bh))
                    else:
                        ops.append(("iter", q, lo, 0))
            elif isinstance(e, FuncRef):
                k = counter[0]
                counter[0] += 1
                ops.append(("tap", self._tap(sp, k, rho, shift)))
            elif isinstance(e, BinOp):
                if e.op not in _BINOPS:
                    raise UnsupportedAccessError(
                        f"binop {e.op} not supported by codegen"
                    )
                a = emit(e.a, rho, counter)
                b = emit(e.b, rho, counter)
                ops.append(("bin", e.op, a, b))
            elif isinstance(e, Select):
                c = emit(e.cond, rho, counter)
                t = emit(e.if_true, rho, counter)
                f = emit(e.if_false, rho, counter)
                ops.append(("sel", c, t, f))
            else:
                raise UnsupportedAccessError(f"cannot compile {e!r}")
            return len(ops) - 1

        if ns.red_dims:
            acc = emit(ns.init, {}, [0])
            ranges = [range(ex) for ex in ns.red_extents]
            for combo in itertools.product(*ranges):
                term = emit(ns.value, dict(zip(ns.red_dims, combo)), [0])
                ops.append(("bin", "add", acc, term))
                acc = len(ops) - 1
        else:
            emit(ns.value, {}, [0])
        return tuple(ops)


_BINOPS = ("add", "sub", "mul", "div", "min", "max", "shr", "lt", "gt")


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


class _Env:
    """Sources one row step's panels read: the batched global buffers, the
    input rings and the scratch entries (each with a leading batch dim)."""

    def __init__(self, lg: LoweredGroup, srcs, rings, scratch, device):
        self.lg = lg
        self.srcs = srcs
        self.rings = rings
        self.scratch = scratch
        self.device = device
        self.i0 = 0
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

    def gather(self, tap: Tap, shape: Sequence[int]) -> torch.Tensor:
        """``tap``'s values over a panel of ``shape`` (leading batch dim)."""
        if tap.kind == "view":
            src = self.srcs[self.lg.slot_of[self.lg.kg.groups[tap.src].buffer]]
        elif tap.kind == "ring":
            src = self.rings[tap.src]
        else:
            src = self.scratch[tap.src]
        nb = src.shape[0]
        idx: List[torch.Tensor] = [
            torch.arange(nb, device=self.device).view([nb] + [1] * len(shape))
        ]
        valid = None
        for j, ax in enumerate(tap.axes):
            base = ax.const + ax.step * self.i0
            if ax.q is None:
                t = torch.tensor(base, device=self.device)
            else:
                t = base + ax.stride * self.coord(shape, ax.q)
            if tap.kind == "view":
                ok = (t >= 0) & (t < src.shape[j + 1])
                valid = ok if valid is None else valid & ok
                t = t.clamp(0, src.shape[j + 1] - 1)
            idx.append(t)
        if tap.rows is not None:
            ok = tap.rows[0] * self.i0 + self.coord(shape, 0) < tap.rows[1]
            valid = ok if valid is None else valid & ok
        out = src[tuple(idx)]
        if valid is not None:
            out = torch.where(valid, out, self.const(0.0))
        return out

    def run(self, ops: Sequence[Op], shape: Sequence[int]) -> torch.Tensor:
        one, zero = self.const(1.0), self.const(0.0)
        vals: List[torch.Tensor] = []
        for op in ops:
            kind = op[0]
            if kind == "const":
                v = self.const(op[1])
            elif kind == "iter":
                _, q, c, step = op
                v = (self.coord(shape, q) + (c + step * self.i0)).to(torch.float32)
            elif kind == "tap":
                v = self.gather(op[1], shape)
            elif kind == "bin":
                v = _binop(op[1], vals[op[2]], vals[op[3]], one, zero)
            else:
                v = torch.where(vals[op[1]] != 0, vals[op[2]], vals[op[3]])
            vals.append(v)
        return vals[-1]


class EagerKernel:
    """Plain-PyTorch execution of one lowered kernel group.  Call with a
    mapping of buffer name -> f32 tensor (leading batch dim of
    ``batch_steps`` slots when the group is batched); returns the group's
    output tensor."""

    def __init__(self, lowered: LoweredGroup):
        self.lg = lowered
        self.kg = lowered.kg

    @property
    def name(self) -> str:
        return self.kg.name

    @property
    def stage_names(self) -> List[str]:
        return self.kg.stage_names

    def _panel(self, env: _Env, sp: StagePlan, shift: int, rows: Optional[int] = None):
        lg = self.lg
        shape = lg.panel_shape(sp, rows)
        v = env.run(lg.programs[(sp.name, shift)], shape)
        nb = env.srcs[0].shape[0]
        panel = torch.broadcast_to(v, (nb,) + shape).to(torch.float32)
        if lg.masked(sp):
            ok = env.coord(shape, 0) + env.i0 * self.kg.bh < self.kg.padded_grid.extent
            panel = torch.where(ok, panel, env.const(0.0))
        return panel

    def __call__(self, buffers: Mapping[str, torch.Tensor]) -> torch.Tensor:
        kg, lg = self.kg, self.lg
        batched = kg.batch_grid is not None
        srcs = [
            buffers[b] if batched else buffers[b].unsqueeze(0)
            for b in lg.buffer_order
        ]
        dev = srcs[0].device
        nb = srcs[0].shape[0]
        bh = kg.bh
        f32 = dict(dtype=torch.float32, device=dev)
        scratch = [
            torch.zeros((nb,) + sp.scratch_shape(bh, key), **f32)
            for sp, key in lg.entries
        ]
        rings = [torch.zeros((nb,) + r.ring_shape(bh), **f32) for r in kg.rings]
        out_sp = kg.output
        out = torch.zeros((nb,) + tuple(out_sp.nstage.pure_extents), **f32)
        env = _Env(lg, srcs, rings, scratch, dev)
        for i0 in range(lg.steps):
            env.i0 = i0
            # input delivery rings: rotate the carried halo (warm-up from the
            # pinned prefix view at row step 0), land the new block
            for r, ring in enumerate(kg.rings):
                h = ring.halo
                body = tuple(ring.ring_shape(bh)[1:])
                if i0 > 0:
                    rings[r][:, :h] = rings[r][:, bh:bh + h].clone()
                else:
                    rings[r][:, :h] = env.gather(block_tap(kg, ring.prefix), (h,) + body)
                rings[r][:, h:h + bh] = env.gather(
                    block_tap(kg, ring.steady), (bh,) + body
                )
            # fused intermediates in topological order
            for si, (sp, key) in enumerate(lg.entries):
                if key is None:
                    lb = sp.line_buffer
                    h = lb.halo
                    if i0 > 0:
                        scratch[si][:, :h] = scratch[si][:, bh:bh + h].clone()
                    else:
                        scratch[si][:, :h] = self._panel(env, sp, lb.lo, rows=h)
                    scratch[si][:, h:h + bh] = self._panel(env, sp, lb.hi)
                else:
                    scratch[si][...] = self._panel(env, sp, key)
            panel = self._panel(env, out_sp, 0)
            if lg.streamed(out_sp):
                n = min(bh, kg.e0 - i0 * bh)
                out[:, i0 * bh:i0 * bh + n] = panel[:, :n]
            else:
                out[...] = panel
        return out if batched else out[0]


__all__ = [
    "AxisIndex",
    "EagerKernel",
    "LoweredGroup",
    "Tap",
    "block_tap",
    "check_supported",
]
