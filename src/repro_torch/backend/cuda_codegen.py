"""Plan -> CUDA C++ emission for Hopper (``sm_90a``).

``emit_kernel`` writes one CUDA kernel, plus an ``extern "C"`` launcher and
an occupancy query, for a planned
:class:`~repro_torch.backend.plan.KernelGroup`.  It replaces the JAX
package's generated Pallas kernel (``repro/backend/codegen.py``,
``emit_kernel``) and computes what that kernel computes; it is not a
block-by-block transliteration:

* **Carried axes are loops, independent axes are grid dims.**  A Pallas TPU
  grid runs in order and the generated kernel depends on it: input rings and
  line buffers rotate across row steps (or, under a lane grid, across lane
  steps) and warm up at the first step; a grid reduction accumulates into
  the revisited output block over its chunks.  CUDA blocks run in no order,
  so each carried axis becomes a loop inside one block:

  ============================  ==========================  ====================
  group                          one thread block per        loop inside
  ============================  ==========================  ====================
  row rings / line buffers       (band of row steps, slot)   the band's row
                                                             steps ``i0``
  column rings / lane buffers    (row step, slot)            lane steps ``j``
  fused scratch, nothing         (row step x lane step,      none
  carried                        slot)
  element-parallel (below)       run of work items, slot     chunks ``k`` of a
                                                             grid reduction
  ============================  ==========================  ====================

* **A row sweep is cut into bands** (:func:`row_bands`).  A row ring or
  line buffer carries only its halo from one row step to the next, so each
  band of consecutive row steps is swept by its own block, which warms up
  at the band's first step ``band_begin``: an input ring lands the last
  ``halo`` rows of the steady view's block at the step before (what
  rotation would have carried, loaded and bounded as that step loaded
  them), and a line buffer computes its halo rows with the warm-up panel
  that step 0 uses.  Band 0 warms up from the pinned prefix view, as the
  Pallas kernel does.  The same operations on the same loaded values give
  every element the value the sweep in one block gives it, bit for bit.

* **Shared memory holds what Pallas kept in VMEM scratch**: the fused
  intermediates' panels and row or column line-buffer rings and the input
  rings (``KernelGroup.scratch_bytes``), except that in a column-carried
  group the column rings of one buffer, and the lane line buffers of one
  stage, that differ only by row shift share one panel of ``bh`` + the
  largest shift rows (:func:`shift_panels`): each physical row is landed
  or evaluated once a lane step, by the member of the largest shift that
  holds it, and the others read it at their row offset.  A member's
  program masks by its own output row, so a row the panel holds real where
  a shifted ring held 0 is read only by outputs that are never stored.
  Delivered view blocks are read
  straight from global memory through the plan's own address arithmetic
  (resolved once in ``eager.LoweredGroup``), every load bounded by the
  buffer's extents and the view's valid rows and lanes, with 0 outside.
* **Carried or fused groups: one element per thread iteration.**  Threads
  stride over each panel's elements; each evaluates the stage's lowered
  program (the reference interpreter's f32 operations in the Pallas
  kernel's order, reductions unrolled per chunk) as C.
  ``__syncthreads()`` separates ring rotation, landing, each fused stage
  and the output store, in the order of the Pallas kernel body; a
  column-carried group's lane step instead runs in phases, every rotation
  first, then each level of producers one above what it reads, one
  barrier after each (:func:`lane_layout` reports the count), with each
  phase's loops merged into one over all its parts.
* **A group that carries nothing stages its weights and tiles its
  output** (mobilenet's fused depthwise -> pointwise at full size): each
  input whose loads vary with no row step, lane step or chunk is copied
  into shared memory once a block, coalesced, in a bank-conflict-free
  layout (:func:`staged_inputs`), and the output panel is evaluated in
  register tiles (:func:`output_tile`): lanes along the output's innermost
  axis, each thread several positions by several of those elements, its
  programs interleaved and a reduction's chain rolled, so each fused value
  or weight is loaded once for the elements that share it.  Where the
  weights do not fit whole (``KernelGroup.panels``: MobileNet v1's blocks
  from 56x56x128 on), the reduction's weight is staged one panel of its
  reduction axis at a time, by asynchronous copies, and each thread keeps
  its whole tile's sums in registers across the panels.
* **A chained group walks its hidden axis** (``KernelGroup.chain``:
  ConvNeXt's MLP, whose second linear reduces over the first's 4x-wide
  output): ``CHAIN_THREADS`` threads a block evaluate the stages before the
  chain once, each thread an element, a reduction's chain rolled
  (``rolled_panel``); then, for each panel of the hidden axis, the panel of
  every input indexed along it is copied in, the hidden stages' panel is
  evaluated into shared memory (indexed at ``p - kc * block``), each thread
  a register tile of it (``hidden_tile``: e.g. two positions of one hidden
  entry, their chains side by side), and the consumer's terms over it are
  added to its sums, which each thread holds for its register tile
  (``chain_tile``) across the panels (``chain_panels``).  A reduction whose
  loads all read shared memory, one float further a term from a 16-byte
  boundary, loads four terms at a time as a ``float4`` for the elements of
  the tile that read it (``vector_chain``: fc1 over LayerNorm rows and a
  row of its weight panel, laid out in 16-byte words,
  ``staged_strides(vector=True)``).  The stages before the chain read
  their weights from global memory: the shared memory goes to the chain,
  and the consumer's sums take the words of a panel no later stage reads
  (``HiddenChain.reuse``, ``smem_layout``).
* **Element-parallel groups get a thread map of their own**
  (:func:`element_map`): a group with no rings, no fused scratch and no
  carry (resnet's lane grid, matmul's grid reduction, upsample) shares
  nothing between elements, and a Pallas grid step is not a CUDA block.
  Its threads stride over work items of the whole slot, fastest along the
  axis on which its heavy input reads consecutive floats (resnet's x,
  matmul's columns), so a warp reads one run of memory.  Each thread
  evaluates a tile of up to ``TILE_MAX`` output elements along the axis on
  which that input does not vary (resnet's output channels, matmul's
  rows): a load that does not depend on the tile axis is issued once for
  the tile, and the tile's programs are interleaved statement by
  statement, independent chains for the scheduler.  A group with a
  reduction whose other input does not vary along the thread axis (the
  weights, A) takes a two-axis tile: each thread evaluates a run of up to
  ``RUN_MAX`` positions of the thread axis, ``lanes`` apart so that each
  load of a warp is still one run of memory, by its tile; a load of the
  heavy input is issued once per run position for the whole tile, and a
  value of the other input once for the whole run.  That input is staged
  in shared memory once a block (:class:`TiledInput`), by a coalesced,
  asynchronous copy: a block holds one value of each axis its loads vary
  with (resnet's 8 output channels of a row step, matmul's 8 rows), so it
  copies only that chunk's values, laid out so that one reduction term's
  values for the tile lie together and are read as 16-byte broadcasts.
  The run and the threads a block come from the shape alone
  (:func:`_run_shape`): the longest run whose launch still gives every SM
  ``FILL_BLOCKS`` blocks where the slots allow.  A group with no
  reduction, or no load a run could share (upsample), keeps the one-axis
  map.  Under a grid reduction the chunk loop runs inside the thread with
  the tile's accumulators in registers: each output still has one thread
  and one chain, in the plan's order, so the two-axis tile changes no
  operation and no order of the plain version's.  A load that no element
  of the launch can take outside its buffer or its view's valid rows and
  lanes is not bounded.
* **One register tile, two maps.**  The carries-nothing map (rows by
  columns) and the element-parallel map (run positions by tile) each
  describe a thread's elements as a :class:`RegisterTile`, two axes, outer
  then inner, and keep their own thread mapping, passes, staged copies,
  load bounds and stores.  One emitter (``tile_program``) writes either
  tile's programs: an op once for each element of an axis whose variables
  it reads, once for the axis otherwise, and a reduction's chain with each
  element's sum in a register, every run of terms that differ only in
  constants one loop; a panel-staged weight's chain is the same terms,
  over each panel in turn.

What bounds it on the H100: a stencil group does a few operations per byte
of f32 image, so it is bound by HBM bytes (``KernelGroup.hbm_bytes`` over
3.35 TB/s); a convolution over channels or a matmul does hundreds of f32
operations per element and is bound by operations (67 TFLOP/s without
tensor cores, half of it without fused multiply-adds).  A row-carried group
runs as many bands per slot as fill the 132 SMs with blocks (up to four of
512 threads an SM, as its shared memory allows), each band at least eight
times its halo in rows, so the rows warmed up again stay under an eighth;
inside a block each row step still lands, syncs and computes in turn, with
no copy in flight.  A column-carried group runs one block per row step and
slot.  The carried and fused groups re-read view taps from global memory
(through L1/L2) once per tap; every group uses scalar f32 operations.  An
element-parallel convolution or matmul on the two-axis tile issues, a
reduction term and thread, ``run`` global loads and ``tile / 4`` 16-byte
shared loads for ``2 * run * tile`` FP32 instructions (resnet: 6 loads for
64), where the one-axis map issued ``1 + tile`` loads for ``2 * tile``; so
it is bound by the FP32 pipe, not by load issue, as long as an SM holds
enough of its warps to hide the loads' latency.

The library is compiled by ``build.py`` with ``-fmad=false`` and IEEE
division, so the kernel and the plain PyTorch version (``eager.py``) run the
same f32 operations in the same order and agree bit for bit; a masked
K-tail term is added as ``+ 0.0f``, as Pallas adds its zero.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

from .eager import (
    AxisIndex, Bounds, EagerKernel, GroupKernel, LoweredGroup, Op, Tap, _resized, block_tap,
    record_eval_sites,
)
from .errors import EmitError
from .plan import CHAIN_THREADS, KernelGroup, StagePlan, chain_tile_shape, staged_strides

# threads per block: a carried group sweeps its steps inside one block, so
# it takes the most threads a block may have at a comfortable register
# budget
THREADS_CARRIED = 512
THREADS_GRID = 256
# a row-carried group cuts its row sweep into bands of consecutive row
# steps, one block per (band, slot): enough bands that bands x slots fill
# the H100's SM_COUNT SMs with as many blocks as fit on one (at most
# BLOCKS_PER_SM of THREADS_CARRIED threads, fewer where the group's shared
# memory takes SMEM_PER_SM first), but every band at least
# BAND_HALO_RATIO times as many rows as the halo it loads or recomputes
# again at its start.  BAND_STEPS, when set, forces the band length in
# row steps (the tests shorten the bands with it).
SM_COUNT = 132
SMEM_PER_SM = 228 * 1024
BLOCKS_PER_SM = 2048 // THREADS_CARRIED
BAND_HALO_RATIO = 8
BAND_STEPS: Optional[int] = None
# an element-parallel group: threads per block, the most output elements
# one thread evaluates together, and a cap on blocks per slot past which
# threads stride over more work items
THREADS_ELEMENT = 128
TILE_MAX = 8
MAX_BLOCKS_PER_SLOT = 4096
# one with a reduction and a load that does not vary along its thread axis
# takes a two-axis tile: the inputs read along the tile staged in shared
# memory a block (at most TILED_SMEM_MAX bytes), each thread up to RUN_MAX
# positions of the thread axis by its tile while the launch leaves every SM
# WARPS_SM warps, and blocks cut so that it gives each SM FILL_BLOCKS blocks
# where the slots allow
RUN_MAX = 4
WARPS_SM = 20
FILL_BLOCKS = 8
TILED_SMEM_MAX = 48 * 1024
# a run of at least ROLL_MIN reduction terms that differ only in constants
# is emitted as a loop, unrolled ROLL_UNROLL times
ROLL_MIN = 8
ROLL_UNROLL = 4
# a fused panel of a group that carries nothing is emitted one element a
# thread with its chain rolled where the chain has at least ROLL_PANEL_MIN
# terms; a shorter one (a stencil's taps, a 7x7 depthwise window) stays
# straight-line code
ROLL_PANEL_MIN = 64
# a chain read four terms a 16-byte load unrolls VECTOR_UNROLL such steps of
# one element's chain, shared by the elements of a thread's tile (at least one)
VECTOR_UNROLL = 2
# a group that carries nothing and is not element-parallel evaluates its
# output panel in register tiles: OUT_LANES threads along the panel's
# innermost axis, each thread at most OUT_TILE_MAX output elements
OUT_LANES = 32
OUT_TILE_MAX = 16
# a group whose weight is staged in panels keeps every accumulator of its
# tile across the panels: at most this many a thread
PANEL_TILE_MAX = 32
# blocks an SM a window-attention group's kernel asks registers for
# (``__launch_bounds__``'s second argument)
WINDOW_BLOCKS = 2

# the TPU kernel this emitter replaces, for reports
REPLACES = "src/repro/backend/codegen.py:755"

_BIN_FN = {
    "div": "ub_div",
    "min": "ub_min",
    "max": "ub_max",
    "shr": "ub_shr",
    "lt": "ub_lt",
    "gt": "ub_gt",
}
_BIN_INFIX = {"add": "+", "sub": "-", "mul": "*"}
# the device library's square root (IEEE, as torch's), erf and exp (within 2
# ulp of the exact value, as the library documents; torch's CUDA erf and exp
# call the same functions; not the intrinsic ``__expf``)
_UN_FN = {"sqrt": "sqrtf", "erf": "erff", "exp": "expf"}


def _flit(v: float) -> str:
    """An exact C literal of ``v`` rounded to f32."""
    with np.errstate(over="ignore"):
        f = float(np.float32(v))        # round to nearest, inf past the range
    if math.isnan(f):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(f):
        return "__int_as_float(0x7f800000)" if f > 0 else "__int_as_float(0xff800000)"
    return f"{f.hex()}f"


def _rhs(op: Op, ref: Callable[[int], str], index: Callable[[AxisIndex], str],
         load: Callable[[Tap], str], conds: Callable[[Bounds], List[str]], acc: str = "acc") -> str:
    """Op ``op``'s value as a C expression: ``ref(j)`` names op ``j``'s
    value; ``index``, ``load`` and ``conds`` write an index, a load and a
    mask's bounds that can fail; ``acc`` is the running accumulator."""
    kind = op[0]
    if kind == "const":
        return _flit(op[1])
    if kind == "iter":
        return f"(float)({index(op[1])})"
    if kind == "tap":
        return load(op[1])
    if kind == "bin":
        a, b = ref(op[2]), ref(op[3])
        return f"{a} {_BIN_INFIX[op[1]]} {b}" if op[1] in _BIN_INFIX else f"{_BIN_FN[op[1]]}({a}, {b})"
    if kind == "sel":
        return f"ub_sel({ref(op[1])}, {ref(op[2])}, {ref(op[3])})"
    if kind == "un":
        return f"{_UN_FN[op[1]]}({ref(op[2])})"
    if kind == "mask":
        ok = conds(op[2])
        return f"({' && '.join(ok)}) ? {ref(op[1])} : 0.f" if ok else ref(op[1])
    return acc


def _affine(const: int, terms: Sequence[Tuple[int, str]]) -> str:
    """``const + sum(coeff * var)`` as a C int expression."""
    parts = [str(const)] if const or not terms else []
    for c, v in terms:
        if c == 0:
            continue
        parts.append(v if c == 1 else f"{c} * {v}")
    return " + ".join(parts) if parts else "0"


def _horner(idx: Sequence[str], dims: Sequence[object]) -> str:
    """Row-major linear index of ``idx`` in an array of extents ``dims``."""
    lin = f"({idx[0]})"
    for a, d in zip(idx[1:], dims[1:]):
        lin = f"({lin} * {d} + ({a}))"
    return lin


def _indent(lines: Sequence[str]) -> List[str]:
    return ["  " + ln for ln in lines]


@dataclass(frozen=True)
class ShiftPanel:
    """One shared-memory array of a lane-carried group that several column
    rings of one buffer, or the lane line buffers of one stage, share: they
    differ only by row shift, so member ``members[i]`` (a ring or
    scratch-entry index) is the array from row ``offsets[i]`` on, and a
    physical row is held once, not once per shift.  A single ring or line
    buffer is a panel of one member."""

    members: Tuple[int, ...]
    offsets: Tuple[int, ...]
    bh: int

    @property
    def rows(self) -> int:
        return self.offsets[-1] + self.bh

    def segments(self) -> List[Tuple[int, int]]:
        """``(member, rows)``: the member of the largest row shift holding
        each row lands or evaluates it, its first ``rows`` rows (up to the
        next member's first row).  A row that no member holds is never
        read."""
        out = []
        for i, m in enumerate(self.members):
            gap = self.offsets[i + 1] - self.offsets[i] if i + 1 < len(self.members) else self.bh
            out.append((m, min(self.bh, gap)))
        return out


def _panels(by_shift: Mapping[object, List[Tuple[int, int]]], bh: int) -> List[ShiftPanel]:
    out = []
    for members in by_shift.values():
        members = sorted(members)
        lo = members[0][0]
        out.append(ShiftPanel(tuple(i for _s, i in members),
                              tuple(s - lo for s, _i in members), bh))
    return out


def shift_panels(kg: KernelGroup) -> Tuple[List[ShiftPanel], List[ShiftPanel]]:
    """A lane-carried group's panels: those of its lane line buffers (one
    per stage) and of its column rings (one per buffer and view, rings whose
    delivered views differ only by their row start); none for any other
    group.  Rings merge where their rows are the leading axis at stride 1."""
    if kg.lane_grid is None or not (kg.rings or kg.line_buffered):
        return [], []
    lbs: Dict[object, List[Tuple[int, int]]] = {}
    for i, (sp, key) in enumerate(kg.scratch_entries()):
        if isinstance(key, tuple) and key[1] is None:
            lbs.setdefault(sp.name, []).append((key[0], i))

    def unshifted(gi: int, k: int) -> tuple:
        """View group ``gi``'s fields with ``k`` rows of shift taken out."""
        g = kg.groups[gi]
        fields = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
        fields["k0"] -= k
        fields["base"] = [b - k if j == g.blocked_axis else b for j, b in enumerate(g.base)]
        return tuple((n, tuple(v) if isinstance(v, list) else v) for n, v in fields.items())

    rings: Dict[object, List[Tuple[int, int]]] = {}
    for i, r in enumerate(kg.rings):
        if r.lane and r.row_axis == 0 and r.row_stride == 1:
            key: object = (r.buffer, r.axis, r.stride0, r.lo, r.hi, r.ndim, tuple(r.span),
                           tuple(r.base[1:]), unshifted(r.steady, r.row_k0),
                           unshifted(r.prefix, r.row_k0))
        else:
            key = i
        rings.setdefault(key, []).append((r.row_k0, i))
    return _panels(lbs, kg.bh), _panels(rings, kg.bh)


def smem_layout(kg: KernelGroup) -> Tuple[List[int], List[int], int]:
    """Shared-memory float offsets of each scratch entry and each input
    ring, and the total bytes: ``kg.scratch_bytes``, less in a lane-carried
    group whose shift panels (``shift_panels``) hold rows once for several
    members (a member's offset is its first row in the panel), and in a
    chained group whose panels take dead panels' words (``kg.chain.reuse``:
    the taker at the dead panel's offset)."""
    lb_panels, ring_panels = shift_panels(kg)
    entries = kg.scratch_entries()
    taken = dict(kg.chain.reuse) if kg.chain is not None else {}
    names = [sp.name for sp, _k in entries]
    shapes = [kg.scratch_shape(sp, key) for sp, key in entries]
    shapes += [r.ring_shape(kg.bh, kg.bw) for r in kg.rings]
    n = len(entries)
    panel_of = {m: pan for pan in lb_panels for m in pan.members}
    panel_of.update({n + m: ShiftPanel(tuple(n + i for i in pan.members), pan.offsets, pan.bh)
                     for pan in ring_panels for m in pan.members})
    offs: List[Optional[int]] = [None] * len(shapes)
    off = 0
    for i, shape in enumerate(shapes):
        if offs[i] is not None:
            continue
        if i < n and names[i] in taken:
            offs[i] = offs[names.index(taken[names[i]])]
            continue
        pan = panel_of.get(i)
        if pan is None:
            offs[i] = off
            off += math.prod(shape)
            continue
        row = math.prod(shape[1:])
        for m, o in zip(pan.members, pan.offsets):
            offs[m] = off + o * row
        off += pan.rows * row
    return offs[:n], offs[n:], 4 * off


@dataclass(frozen=True)
class RolledIndex(AxisIndex):
    """An index inside a loop over ``r``: ``rstep * r`` more than the
    :class:`AxisIndex` it extends."""

    rstep: int = 0


def _operands(op: Op) -> Tuple[int, ...]:
    if op[0] == "bin":
        return (op[2], op[3])
    if op[0] == "sel":
        return tuple(op[1:4])
    if op[0] in ("mask", "un"):
        return (op[2] if op[0] == "un" else op[1],)
    return ()


def _chain(ops: Sequence[Op]) -> Optional[Tuple[int, List[int]]]:
    """A reduction's accumulation chain: ``(head, ends)`` where
    ``ops[:head]`` come first, ``ops[head - 1]`` is the initial value, and
    each term ``ops[end_before + 1 .. end]`` reads only its own ops and the
    head, and ends adding itself to the chain's previous value (which no
    other op reads).  None for a program that is not such a chain of two
    or more terms."""
    ends = []
    i = len(ops) - 1
    while ops[i][0] == "bin" and ops[i][1] == "add" and ops[i][2] < ops[i][3] < i:
        ends.append(i)
        i = ops[i][2]
    if len(ends) < 2:
        return None
    ends.reverse()
    head, prev = i + 1, i
    for e in ends:
        for j in range(prev + 1, e + 1):
            for x in _operands(ops[j]):
                if x == prev:
                    if j != e:
                        return None
                elif not (x < head or prev < x < j):
                    return None
        prev = e
    return head, ends


def _roll_op(op: Op, it) -> Op:
    """``op`` inside a loop over ``r``: each index constant, in signature
    order, advances by the next step of ``it`` per iteration."""
    def roll(axs):
        return tuple(RolledIndex(**vars(ax), rstep=next(it)) for ax in axs)

    def bounds(bnd):
        return tuple(zip(roll([ax for ax, _l in bnd]), (lim for _a, lim in bnd)))

    if op[0] == "iter":
        return ("iter", roll([op[1]])[0])
    if op[0] == "tap":
        t = op[1]
        return ("tap", Tap(t.kind, t.src, roll(t.axes), bounds(t.bounds)))
    if op[0] == "mask":
        return ("mask", op[1], bounds(op[2]))
    return op


def _term_signature(ops: Sequence[Op], a: int, e: int, head: int,
                    checks: Callable[[Op], List[bool]]) -> Tuple[tuple, tuple]:
    """What must agree for a chain's terms ``ops[a..e]`` to share a loop
    body, and their constants: every op's kind and operands (relative to the
    term, the chain's previous value or the head), every index's variables,
    every bound's limit, and which checks of each load and mask the emitter
    writes (``checks``)."""
    sig: List[object] = []
    consts: List[int] = []
    kept: List[bool] = []

    def axes(axs):
        for ax in axs:
            sig.append((ax.q, ax.stride, ax.step, ax.lstep, ax.kstep))
            consts.append(ax.const)

    def ref(x: int):
        return ("acc",) if x == a - 1 else ("h", x) if x < head else ("l", x - a)

    for j in range(a, e + 1):
        op = ops[j]
        kind = op[0]
        if kind == "const":
            sig.append(("const", _flit(op[1])))
        elif kind == "iter":
            sig.append("iter")
            axes([op[1]])
        elif kind == "tap":
            t = op[1]
            sig.append(("tap", t.kind, t.src, len(t.axes), tuple(lim for _a, lim in t.bounds)))
            axes(t.axes)
            axes([ax for ax, _l in t.bounds])
            kept += checks(op)
        elif kind == "mask":
            sig.append(("mask", ref(op[1]), tuple(lim for _a, lim in op[2])))
            axes([ax for ax, _l in op[2]])
            kept += checks(op)
        elif kind in ("bin", "sel", "un"):
            sig.append((kind, op[1] if kind in ("bin", "un") else None,
                        tuple(ref(x) for x in _operands(op))))
        else:
            sig.append(("acc",))
    sig.append(tuple(kept))
    return tuple(sig), tuple(consts)


def _chain_runs(
    ops: Sequence[Op], chain: Tuple[int, List[int]], checks: Callable[[Op], List[bool]],
) -> List[Tuple[List[Tuple[int, int]], Optional[tuple]]]:
    """A chain's terms, as ``(first op, last op)``, in runs ``(terms,
    step)``: each the longest run of terms whose signatures
    (``_term_signature``) agree and whose constants advance by the same
    ``step`` a term (None for a run of one)."""
    head, ends = chain
    terms = list(zip([head] + [e + 1 for e in ends[:-1]], ends))
    sigs = [_term_signature(ops, a, e, head, checks) for a, e in terms]
    out = []
    s = 0
    while s < len(sigs):
        n, step = 1, None
        while s + n < len(sigs) and sigs[s + n][0] == sigs[s][0]:
            d = tuple(y - x for x, y in zip(sigs[s][1], sigs[s + n][1]))
            if step is None:
                step = d
            if d != tuple(n * x for x in step):
                break
            n += 1
        out.append((terms[s:s + n], step))
        s += n
    return out


@dataclass(frozen=True)
class TileAxis:
    """One axis of a thread's register tile: ``extent`` elements; element
    ``i`` renames each C variable of ``vars`` to ``<var>_<i>`` in an index,
    and a value that varies along the axis carries ``_<tag><i>`` in its
    name."""

    extent: int
    vars: Tuple[str, ...]
    tag: str


@dataclass(frozen=True)
class RegisterTile:
    """The output elements one thread evaluates together, ``outer`` by
    ``inner``, outer-major: an element map's run positions by its tile, an
    output tile's rows by its columns."""

    outer: TileAxis
    inner: TileAxis

    @property
    def elems(self) -> List[Tuple[int, int]]:
        return [(o, i) for o in range(self.outer.extent) for i in range(self.inner.extent)]

    def sub(self, o: int, i: int) -> Dict[str, str]:
        """The variables of element ``(o, i)``."""
        return {**{v: f"{v}_{o}" for v in self.outer.vars},
                **{v: f"{v}_{i}" for v in self.inner.vars}}

    def name(self, k: int, dep: Tuple[bool, bool], o: int, i: int) -> str:
        """Op ``k``'s value for element ``(o, i)``, varying along the axes
        ``dep`` marks."""
        return (f"v{k}" + (f"_{self.outer.tag}{o}" if dep[0] else "")
                + (f"_{self.inner.tag}{i}" if dep[1] else ""))


class _TileIO(NamedTuple):
    """How a map writes its register tile's loads (``load(tap, sub)``) and
    masks (``bounds(bounds, sub)``), and which checks of a load or mask it
    writes (``checks(op)``, for ``_term_signature``)."""

    load: Callable[[Tap, Mapping[str, str]], str]
    bounds: Callable[[Bounds, Mapping[str, str]], List[str]]
    checks: Callable[[Op], List[bool]]


def element_parallel(lg: LoweredGroup) -> bool:
    """A group whose blocks carry nothing and share nothing: no rings, no
    fused scratch, no row or lane carry (a grid reduction's chunks are a
    loop inside each output element, so it may have one)."""
    return not (lg.row_carried or lg.lane_carried or lg.kg.rings or lg.entries)


@dataclass(frozen=True)
class TiledInput:
    """An input of an element-parallel group whose loads do not vary with
    the thread axis (a convolution's weights, a matmul's A), staged in
    shared memory once a block.  A block holds one value of each work axis
    the input's loads vary with (``ElementMap.chunk``), so it copies only
    what that chunk reads: the buffer's ``dims`` from ``lo`` over
    ``extents`` (their indices move with the reduction alone), then,
    innermost, ``entries`` values of ``tile_dim``, whose index
    (``index``, the same in every load) moves with the chunk's axes: the
    tile's ``tile`` elements where it moves with the tile axis, else one.
    So one reduction term's values for the whole tile are contiguous, read
    as 16-byte broadcasts.  The copy is ``w<slot>`` at float ``offset`` of
    the block's shared memory; indices outside the buffer hold 0, as the
    bounded global load reads."""

    buffer: str
    slot: int
    dims: Tuple[int, ...]
    lo: Tuple[int, ...]
    extents: Tuple[int, ...]
    tile_dim: Optional[int]
    index: Optional[AxisIndex]
    entries: int
    offset: int

    @property
    def size(self) -> int:
        """Floats of the copy."""
        return math.prod(self.extents) * self.entries

    @property
    def nbytes(self) -> int:
        return 4 * self.size


@dataclass(frozen=True)
class ElementMap:
    """How an element-parallel group's output elements map to threads.

    ``axes`` are the work axes of one block's chunk, fastest first, each a
    C variable (``i0``, ``j`` or a panel coordinate ``p<q>``) and its
    extent: the thread axis ``axes[0]``, then the other axes in the
    output's memory order; the tile axis ``tile_axis`` appears divided by
    ``tile``.  ``chunk`` are the axes a block holds one value of (those
    its staged inputs, ``staged``, vary with), decoded from the block
    index; ``fixed`` variables have one value.  Work item ``w`` of a chunk
    is decoded from ``axes``; its thread evaluates ``run`` positions of the
    thread axis, ``lanes`` apart (the thread axis appears as its ``lanes``
    first positions; a position past ``extent`` is evaluated at the last
    and not stored) by the ``tile`` output elements ``tile_axis = (w's
    tile index) * tile + t``, their programs interleaved statement by
    statement.  ``work`` items of a slot, ``blocks`` blocks of
    ``threads`` per slot, ``blocks / chunks`` of them a chunk."""

    axes: Tuple[Tuple[str, int], ...]
    tile_axis: Optional[str]
    tile: int
    fixed: Tuple[Tuple[str, int], ...]
    work: int
    threads: int
    blocks: int
    run: int = 1
    extent: int = 1
    chunk: Tuple[Tuple[str, int], ...] = ()
    staged: Tuple[TiledInput, ...] = ()

    @property
    def thread_axis(self) -> str:
        return self.axes[0][0] if self.axes else "none"

    @property
    def lanes(self) -> int:
        return -(-self.extent // self.run)

    @property
    def chunks(self) -> int:
        return math.prod(e for _v, e in self.chunk)

    @property
    def tiled(self) -> bool:
        """Whether the group took the two-axis tile: a run of positions
        a thread, or an input staged a block."""
        return self.run > 1 or bool(self.staged)

    @property
    def register_tile(self) -> RegisterTile:
        """A thread's ``run`` positions of the thread axis by its ``tile``
        elements of the tile axis."""
        return RegisterTile(
            TileAxis(self.run, (self.thread_axis,) if self.run > 1 else (), "r"),
            TileAxis(self.tile, (self.tile_axis,) if self.tile > 1 else (), "t"),
        )


def _terms(ax: AxisIndex) -> List[Tuple[int, str]]:
    """The variables of ``ax`` (a panel coordinate as ``p<q>``), each
    with its coefficient, where that is not 0."""
    terms = [(ax.step, "i0"), (ax.lstep, "j"), (ax.kstep, "k"), (getattr(ax, "rstep", 0), "r")]
    if ax.q is not None:
        terms.append((ax.stride, f"p{ax.q}"))
    return [(c, v) for c, v in terms if c]


def _span(ax: AxisIndex, rng: Mapping[str, Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest and largest value of ``ax`` over the variables' ranges."""
    lo = hi = ax.const
    for c, v in _terms(ax):
        a, b = rng[v]
        lo += min(c * a, c * b)
        hi += max(c * a, c * b)
    return lo, hi


def _uses(ax: AxisIndex, var: str) -> bool:
    if var == "i0":
        return ax.step != 0
    if var == "j":
        return ax.lstep != 0
    return ax.q is not None and ax.stride != 0 and var == f"p{ax.q}"


def _unit(ax: AxisIndex, var: str) -> bool:
    """Whether ``ax`` advances by one per step of ``var``, alone."""
    coef = {"i0": ax.step, "j": ax.lstep}.get(var)
    if coef is None:
        coef = ax.stride if ax.q is not None and var == f"p{ax.q}" else 0
    return abs(coef) == 1


def _output_taps(lg: LoweredGroup) -> List[Tap]:
    progs = [lg.programs[(lg.kg.output.name, 0, 0)]]
    if lg.init_program is not None:
        progs.append(lg.init_program)
    return [op[1] for prog in progs for op in prog if op[0] == "tap"]


def element_map(lg: LoweredGroup) -> Optional[ElementMap]:
    """The thread map of an element-parallel group (None for any other).
    Deterministic in the plan:

    * the thread axis is the work axis along which the most loads (the
      output store counted as one) advance by one in their buffer's
      innermost dimension, ties to the output's innermost axis, so a warp
      reads and writes consecutive floats;
    * the tile axis is the panel axis (not the thread axis) along which the
      most loads that vary with the thread axis stay the same, then the
      most loads of any kind, then the longest; each such load is issued
      once for ``tile`` output elements.  The tile is the largest divisor
      of the axis's extent up to ``TILE_MAX``; with no load to share, or no
      such divisor above 1, there is no tile axis."""
    if not element_parallel(lg):
        return None
    kg = lg.kg
    out = kg.output
    shape = lg.panel_shape(out)
    n = len(shape)
    # the output's axes, outermost first
    order: List[Tuple[str, int]] = [("i0", lg.steps)]
    if lg.lane_blocked(out):
        order += [(f"p{q}", shape[q]) for q in range(n - 1)]
        order += [("j", lg.lane_steps), (f"p{n - 1}", shape[n - 1])]
    else:
        order += [(f"p{q}", shape[q]) for q in range(n)]
    fixed = [(v, 0) for v, e in order if e == 1]
    if not lg.lane_blocked(out):
        fixed.append(("j", 0))
    inner = [(v, e) for v, e in reversed(order) if e > 1]
    taps = [t for t in _output_taps(lg) if t.kind == "view"]

    def unit_loads(var: str) -> int:
        return sum(1 for t in taps if t.axes and _unit(t.axes[-1], var))

    # the output store advances by one along its innermost axis
    store_axis = inner[0][0] if inner else None
    best = None
    for rank, (v, _e) in enumerate(inner):
        score = (unit_loads(v) + (v == store_axis), -rank)
        if best is None or score > best[0]:
            best = (score, v)
    thread = best[1] if best else None

    def varies(t: Tap, var: str) -> bool:
        return any(_uses(ax, var) for ax in t.axes) or any(
            _uses(ax, var) for ax, _lim in t.bounds
        )

    heavy = [t for t in taps if thread is not None and varies(t, thread)]
    tile_axis, tile = None, 1
    best = None
    for v, e in inner:
        if v == thread or not v.startswith("p"):
            continue
        score = (
            sum(1 for t in heavy if not varies(t, v)),
            sum(1 for t in taps if not varies(t, v)),
            e,
        )
        if score[1] and (best is None or score > best[0]):
            best = (score, v, e)
    if best is not None:
        tile = max(d for d in range(1, min(TILE_MAX, best[2]) + 1) if best[2] % d == 0)
        tile_axis = best[1] if tile > 1 else None
    axes = []
    for v, e in inner:
        if v == tile_axis:
            e //= tile
        if e > 1 or v == thread:
            axes.append((v, e))
    axes.sort(key=lambda a: a[0] != thread)     # stable: the thread axis first
    reduces = kg.red_grid is not None or _chain(lg.programs[(out.name, 0, 0)]) is not None
    if thread is None or not reduces or all(varies(t, thread) for t in taps):
        # nothing a run of positions could share
        work = math.prod(e for _v, e in axes)
        blocks = min(-(-work // THREADS_ELEMENT), MAX_BLOCKS_PER_SLOT)
        return ElementMap(
            tuple(axes), tile_axis, tile, tuple(fixed), work, THREADS_ELEMENT, blocks,
            extent=axes[0][1] if axes else 1,
        )
    staged, moved = _tiled_inputs(lg, axes, tile_axis, tile, fixed, taps, varies)
    chunk = tuple((v, e) for v, e in axes[1:] if v in moved)
    free = [(v, e) for v, e in axes[1:] if v not in moved]
    extent = axes[0][1]
    nchunks = math.prod(e for _v, e in chunk)
    run, threads, per_chunk = _run_shape(
        extent, math.prod(e for _v, e in free), nchunks, kg.batch_steps,
        sum(st.nbytes for st in staged),
    )
    lanes = -(-extent // run)
    work = lanes * math.prod(e for _v, e in free) * nchunks
    return ElementMap(
        ((thread, lanes), *free), tile_axis, tile, tuple(fixed), work, threads,
        per_chunk * nchunks, run, extent, chunk, tuple(staged),
    )


def _tiled_inputs(lg: LoweredGroup, axes, tile_axis: Optional[str], tile: int, fixed,
                  taps: Sequence[Tap], varies) -> Tuple[List[TiledInput], set]:
    """The inputs an element-parallel group stages a block (``TiledInput``),
    and the work axes they vary with, which each block then holds one
    value of.  An input qualifies where no load of it varies with the
    thread axis, the indices of all but one of its dimensions move with the
    reduction alone, and that one (the tile dimension) has the same index
    in every load, moving with no reduction chunk; while the copies fit in
    ``TILED_SMEM_MAX`` bytes a block."""
    kg = lg.kg
    thread = axes[0][0]
    moving = [v for v, _e in axes[1:]]
    if tile > 1 and tile_axis not in moving:
        moving.append(tile_axis)
    rng: Dict[str, Tuple[int, int]] = {v: (val, val) for v, val in fixed}
    rng["k"] = (0, lg.red_steps - 1)
    by_slot: Dict[int, List[Tap]] = {}
    for t in taps:
        by_slot.setdefault(lg.slot_of[kg.groups[t.src].buffer], []).append(t)
    out: List[TiledInput] = []
    moved: set = set()
    off = 0
    for b, ts in sorted(by_slot.items()):
        if any(varies(t, thread) for t in ts):
            continue
        dims_moving = {d for t in ts for d, ax in enumerate(t.axes)
                       if any(_uses(ax, v) for v in moving)}
        if len(dims_moving) > 1:
            continue
        td = next(iter(dims_moving), None)
        index = ts[0].axes[td] if td is not None else None
        if index is not None and (index.kstep or any(t.axes[td] != index for t in ts)):
            continue
        dims = tuple(d for d in range(len(ts[0].axes)) if d != td)
        spans = [[_span(t.axes[d], rng) for t in ts] for d in dims]
        lo = tuple(min(a for a, _b in sp) for sp in spans)
        ext = tuple(max(b_ for _a, b_ in sp) - low + 1 for sp, low in zip(spans, lo))
        entries = tile if index is not None and tile > 1 and _uses(index, tile_axis) else 1
        st = TiledInput(kg.groups[ts[0].src].buffer, b, dims, lo, ext, td, index, entries, off)
        if 4 * (off + st.size) > TILED_SMEM_MAX:
            continue
        out.append(st)
        off += -(-st.size // 4) * 4          # the next copy on a 16-byte boundary
        moved |= {v for t in ts for v in moving if varies(t, v)}
    return out, moved


def _run_shape(extent: int, free: int, chunks: int, slots: int,
               smem: int) -> Tuple[int, int, int]:
    """``(run, threads, blocks a chunk)`` of a tiled element map, from the
    shape alone.  The run is the longest up to ``RUN_MAX`` (each of its
    positions valid for some lane) whose launch still gives the SMs
    ``WARPS_SM`` warps each to hide the loads' latency with; where none
    does, a run of one.  A block has the most threads up to
    ``THREADS_ELEMENT``, and no fewer than the blocks its staged bytes let
    an SM hold (``smem``, with the 1 KiB the runtime keeps back for each)
    need to carry ``WARPS_SM`` warps, that still give the launch
    ``FILL_BLOCKS`` blocks an SM (one slot asks for one an SM, ``n`` slots
    for ``n``, up to ``FILL_BLOCKS``), so waves stay short and even; else
    the fewest.  ``free`` work items of a chunk besides the thread axis's
    lanes; a chunk's blocks at most fill ``MAX_BLOCKS_PER_SLOT``."""
    def lanes(run: int) -> int:
        return -(-extent // run)

    runs = [r for r in range(min(RUN_MAX, extent), 1, -1) if lanes(r) * (r - 1) < extent]
    run = next((r for r in runs if lanes(r) * free * chunks * slots
                >= SM_COUNT * 32 * WARPS_SM), 1)
    per_sm = max(SMEM_PER_SM // (smem + 1024), 1)
    least = min(max(32 * -(-WARPS_SM // per_sm), 32), THREADS_ELEMENT)
    want = SM_COUNT * min(slots, FILL_BLOCKS)

    def per_chunk(threads: int) -> int:
        return min(-(-lanes(run) * free // threads), max(MAX_BLOCKS_PER_SLOT // chunks, 1))
    sizes = range(THREADS_ELEMENT, least - 1, -32)
    threads = next((t for t in sizes if per_chunk(t) * chunks * slots >= want), sizes[-1])
    return run, threads, per_chunk(threads)


def _row_halos(kg: KernelGroup) -> Tuple[int, int]:
    """The widest halo a row step carries to the next through an input
    ring, and through a row line buffer (0 where there is none)."""
    rings = max((r.halo for r in kg.rings if not r.lane), default=0)
    lbs = max(
        (sp.line_buffer.halo for sp in kg.stages
         if sp.line_buffer is not None and not sp.line_buffer.lane),
        default=0,
    )
    return rings, lbs


def row_bands(lg: LoweredGroup) -> List[Tuple[int, int]]:
    """The bands ``[begin, end)`` of row steps into which a row-carried
    group's sweep is cut, one block each per batch slot, in order; they
    cover ``[0, steps)`` once.  Every band but the last has ``L`` steps:
    ``BAND_STEPS`` if set, else the shortest length that makes enough bands
    to fill the card (see ``BAND_*`` above) and is at least
    ``BAND_HALO_RATIO`` times the halo in rows.  A band never starts at
    the last row step when that step holds fewer valid rows than a line
    buffer's halo: the warm-up panel there would read rows past the valid
    extent as padding, where rotation carries the rows it computed (the
    last two bands merge instead)."""
    kg = lg.kg
    steps = lg.steps
    ring_halo, lb_halo = _row_halos(kg)
    if BAND_STEPS is not None:
        length = BAND_STEPS
    else:
        per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (kg.scratch_bytes + 1024))
        want = -(-SM_COUNT * max(per_sm, 1) // kg.batch_steps)
        halo_steps = -(-BAND_HALO_RATIO * max(ring_halo, lb_halo) // kg.bh)
        length = max(-(-steps // want), halo_steps, 1)
    length = min(length, steps)
    n = -(-steps // length)
    if n > 1 and (n - 1) * length * kg.bh + lb_halo > kg.e0:
        n -= 1
    return [(b * length, steps if b == n - 1 else (b + 1) * length) for b in range(n)]


def grid_x(lg: LoweredGroup) -> int:
    """Thread blocks per batch slot (the launch's ``gridDim.x``)."""
    em = element_map(lg)
    if em is not None:
        return em.blocks
    if lg.row_carried:
        return len(row_bands(lg))
    if lg.lane_carried:
        return lg.steps
    return lg.steps * lg.lane_steps


def carries_nothing(lg: LoweredGroup) -> bool:
    """A group that is neither row-carried, lane-carried nor
    element-parallel: fused recompute panels, one block per row step (and
    lane step), nothing carried from one block to the next."""
    return not (lg.row_carried or lg.lane_carried) and element_map(lg) is None


def _stage_programs(lg: LoweredGroup) -> List[Tuple[Sequence[Op], Tuple[int, ...]]]:
    """Every program the group evaluates, with its panel's shape."""
    kg = lg.kg
    out = [(prog, lg.panel_shape(kg.stage_plan(name))) for (name, _s, _t), prog in lg.programs.items()]
    if lg.init_program is not None:
        out.append((lg.init_program, lg.panel_shape(kg.output)))
    return out


def _panel_ranges(shape: Sequence[int]) -> Dict[str, Tuple[int, int]]:
    return {f"p{q}": (0, e - 1) for q, e in enumerate(shape)}


@dataclass(frozen=True)
class StagedInput:
    """A grid-invariant input of a group that carries nothing (the weights
    of a convolution: no load of it moves with the row step, lane step or
    chunk), which every block copies into shared memory over its required
    ``extents``, before its first panel, with a coalesced copy.  The copy
    is ``w<slot>`` at float ``offset`` of the block's shared memory, axis
    ``a`` at float stride ``strides[a]``: each extent after the first
    padded to an odd count, so that 32 threads reading 32 consecutive
    indices of any one axis hit 32 banks.  A weight staged in panels
    (``KernelGroup.panels``) has ``panel`` = (axis, block): the copy holds
    ``block`` entries of that axis, panel ``kc`` of the reduction the block
    is accumulating, and is made again for each panel."""

    buffer: str
    slot: int
    extents: Tuple[int, ...]
    strides: Tuple[int, ...]
    offset: int
    panel: Optional[Tuple[int, int]] = None

    @property
    def nbytes(self) -> int:
        """The bytes of the copy (one slot's)."""
        return 4 * math.prod(self.extents)

    @property
    def smem_bytes(self) -> int:
        """Its shared memory, padding included."""
        return 4 * self.extents[0] * self.strides[0]


def staged_inputs(lg: LoweredGroup) -> List[StagedInput]:
    """The inputs a group that carries nothing stages in shared memory
    (none for any other group), while they fit beside the group's scratch
    in the H100's shared memory per block: each buffer all of whose loads
    vary with no row step, lane step or chunk and stay inside its required
    extents.  A group planned against shared memory (``kg.panels``,
    ``kg.chain``) stages every buffer its plan counts, each panel buffer
    one panel at a time, or raises :class:`EmitError`."""
    if not carries_nothing(lg):
        return []
    kg = lg.kg
    cut = kg.panel_axes()
    need = kg.required_extents()
    taps: Dict[int, List[Tuple[Tap, Tuple[int, ...]]]] = {}
    for prog, shape in _stage_programs(lg):
        for op in prog:
            if op[0] == "tap" and op[1].kind == "view":
                b = lg.slot_of[kg.groups[op[1].src].buffer]
                taps.setdefault(b, []).append((op[1], shape))

    def invariant(t: Tap) -> bool:
        axes = list(t.axes) + [ax for ax, _l in t.bounds]
        return all(ax.step == 0 and ax.lstep == 0 and ax.kstep == 0 for ax in axes)

    def inside(t: Tap, shape: Tuple[int, ...], ext: Tuple[int, ...]) -> bool:
        rng = _panel_ranges(shape)
        return len(t.axes) == len(ext) and all(
            0 <= _span(ax, rng)[0] and _span(ax, rng)[1] < e for ax, e in zip(t.axes, ext))

    off = smem_layout(kg)[2]
    skip = kg.chain.unstaged if kg.chain is not None else ()
    out: List[StagedInput] = []
    for b, buf in enumerate(lg.buffer_order):
        ext = tuple(need[buf])
        if b not in taps or not all(invariant(t) and inside(t, sh, ext) for t, sh in taps[b]):
            continue
        if buf in skip:
            continue
        panel = cut.get(buf)
        if panel is not None:
            ext = tuple(panel[1] if a == panel[0] else e for a, e in enumerate(ext))
        st = StagedInput(buf, b, ext, staged_strides(ext, kg.staged_vector(buf)), off // 4, panel)
        if off + st.smem_bytes <= H100_SMEM_PER_BLOCK:
            out.append(st)
            off += st.smem_bytes
    if cut:
        got = {st.buffer: st.extents for st in out}
        if got != kg.staged_extents():
            raise EmitError(
                f"stages {got}, where the plan counts {kg.staged_extents()}",
                kernel=kg.name,
            )
    return out



@dataclass(frozen=True)
class OutputTile:
    """How the output panel of a group that carries nothing maps to its
    block's threads.  The panel is ``outer`` positions (its axes but the
    innermost, flattened) by ``inner`` (its innermost axis, the output's
    contiguous one).  ``lanes`` consecutive threads run along the innermost
    axis, each evaluating ``cols`` elements ``lanes`` apart, so every store
    of a warp is one run of memory; the block's ``groups`` rows of threads
    each take ``rows`` outer positions ``groups`` apart.  A thread's
    ``rows`` x ``cols`` programs are interleaved statement by statement, so
    a load that does not vary along the innermost axis (a fused panel's
    value) is issued once for its ``cols`` elements, and one that varies
    only along it (a weight) once for its ``rows``.  Threads loop over the
    panel in passes of ``groups * rows`` by ``lanes * cols`` elements; an
    element past the panel is evaluated at the last position and not
    stored."""

    lanes: int
    cols: int
    groups: int
    rows: int
    outer: int
    inner: int

    def register_tile(self, rank: int) -> RegisterTile:
        """A thread's ``rows`` by ``cols``, over a panel of ``rank`` axes
        ``p0`` .. ``p<rank - 1>``."""
        return RegisterTile(
            TileAxis(self.rows, tuple(f"p{q}" for q in range(rank - 1)), ""),
            TileAxis(self.cols, (f"p{rank - 1}",), "c"),
        )


def output_tile(lg: LoweredGroup) -> Optional[OutputTile]:
    """The register tile of a group that carries nothing (None for any
    other group, under a grid reduction, or where no load of the output
    panel could be shared): ``OUT_LANES`` threads along the innermost axis
    (fewer where it is shorter), as many columns as cover it where some
    load does not vary along it, then as many rows as the block's groups of
    threads need to cover the outer positions in as few passes as
    ``OUT_TILE_MAX`` elements a thread allow, where some load varies only
    along the innermost axis."""
    if not carries_nothing(lg) or lg.kg.red_grid is not None:
        return None
    shape = lg.panel_shape(lg.kg.output)
    n = len(shape)
    outer, inner = math.prod(shape[:-1]), shape[-1]
    if lg.kg.panels is not None:
        return _panel_tile(outer, inner)
    last = f"p{n - 1}"
    taps = [op[1] for op in lg.programs[(lg.kg.output.name, 0, 0)] if op[0] == "tap"]

    def varies(t: Tap, var: str) -> bool:
        return any(_uses(ax, var) for ax in t.axes) or any(_uses(ax, var) for ax, _l in t.bounds)

    share_cols = any(not varies(t, last) for t in taps)
    share_rows = any(not any(varies(t, f"p{q}") for q in range(n - 1)) for t in taps)
    if not (share_cols or share_rows):
        return None
    lanes = min(OUT_LANES, inner)
    groups = THREADS_GRID // lanes
    cols = min(-(-inner // lanes), OUT_TILE_MAX) if share_cols else 1
    rows = 1
    if share_rows:
        want = -(-outer // groups)
        passes = -(-want // max(OUT_TILE_MAX // cols, 1))
        rows = -(-want // passes)
    return OutputTile(lanes, cols, groups, rows, outer, inner)


def _panel_tile(outer: int, inner: int) -> OutputTile:
    """The register tile of a group whose weight is staged in panels: each
    thread's accumulators live across all the panels, so the tile covers
    the output panel in as few passes as ``PANEL_TILE_MAX`` elements a
    thread allow, and among those with the fewest loads a reduction step
    (a thread loads ``rows`` fused values and ``cols`` weights for ``rows``
    x ``cols`` products), then the fewest idle elements.  Runs of 32 lanes
    or more, so that a warp shares its fused value."""
    best = None
    for lanes in (32, 64, 128, 256):
        groups = THREADS_GRID // lanes
        cols = min(-(-inner // lanes), PANEL_TILE_MAX)
        rows = max(1, min(-(-outer // groups), PANEL_TILE_MAX // cols))
        passes = -(-outer // (groups * rows)) * -(-inner // (lanes * cols))
        idle = passes * groups * rows * lanes * cols - outer * inner
        key = (passes, rows + cols, idle, lanes)
        if best is None or key < best[0]:
            best = (key, OutputTile(lanes, cols, groups, rows, outer, inner))
    return best[1]


def chain_tile(lg: LoweredGroup) -> Optional[OutputTile]:
    """The register tile of a chained group's consumer (``kg.chain``; None
    for any other group): its sums stay in registers while the block walks
    the hidden panels, so the tile covers the consumer's panel in one pass
    of the block's threads, as ``plan.chain_tile_shape`` shapes it."""
    ch = lg.kg.chain
    if ch is None:
        return None
    shape = lg.panel_shape(lg.kg.stage_plan(ch.consumer))
    outer, inner = math.prod(shape[:-1]), shape[-1]
    found = chain_tile_shape(outer, inner)
    if found is None:
        raise EmitError(f"the chain's consumer panel of {outer} x {inner} fits no register "
                        f"tile", kernel=lg.kg.name)
    lanes, cols, groups, rows = found
    return OutputTile(lanes, cols, groups, rows, outer, inner)


def hidden_tile(lg: LoweredGroup) -> Optional[OutputTile]:
    """The register tile of a chained group's hidden panel (``kg.chain``;
    None for any other group): the plan's ``rows`` positions by ``cols``
    hidden entries a thread (``HiddenChain.tile``), ``ceil(block / cols)``
    lanes along the hidden axis by ``ceil(positions / rows)`` groups of
    threads; the block's threads loop over those in passes where they are
    more than ``CHAIN_THREADS``."""
    ch = lg.kg.chain
    if ch is None:
        return None
    shape = lg.kg.scratch_shape(lg.kg.stage_plan(ch.hidden[0]), 0)
    outer = math.prod(shape[:-1])
    rows, cols = ch.tile
    return OutputTile(-(-ch.block // cols), cols, -(-outer // rows), rows, outer, ch.block)


def _tiled_bytes(em: Optional[ElementMap]) -> int:
    """The shared memory of an element map's staged inputs."""
    if em is None or not em.staged:
        return 0
    return 4 * max(st.offset + st.size for st in em.staged)


def shared_bytes(lg: LoweredGroup) -> int:
    """A group's dynamic shared memory: its scratch (``smem_layout``) and
    its staged inputs (``staged_inputs``, or an element map's)."""
    return (smem_layout(lg.kg)[2] + sum(st.smem_bytes for st in staged_inputs(lg))
            + _tiled_bytes(element_map(lg)))


def lane_layout(lg: LoweredGroup) -> Optional[Tuple[int, int]]:
    """A lane-carried group's shared-memory bytes (``smem_layout``) and
    ``__syncthreads()`` per lane step of its kernel; None for any other
    group."""
    if not lg.lane_carried:
        return None
    em = _GroupEmitter(lg, "0")
    return em.smem, em.lane_step()[1]


def block_threads(lg: LoweredGroup) -> int:
    """Threads per block of the group's launch (``blockDim.x``); a chained
    group's, the threads that evaluate a hidden panel in one pass
    (``plan.CHAIN_THREADS``)."""
    em = element_map(lg)
    if em is not None:
        return em.threads
    if lg.kg.chain is not None:
        return CHAIN_THREADS
    return THREADS_CARRIED if lg.row_carried or lg.lane_carried else THREADS_GRID


class _GroupEmitter:
    def __init__(self, lg: LoweredGroup, tag: str):
        self.lg = lg
        self.kg = lg.kg
        self.tag = tag
        kg = self.kg
        self.em = element_map(lg)
        self.nt = block_threads(lg)
        # the ranges of the variables of the code being emitted: an element
        # map's over the whole launch, else each panel's as it is emitted
        self.rng: Dict[str, Tuple[int, int]] = {}
        self.tiled: Dict[int, TiledInput] = {}
        if self.em is not None:
            self.rng = self.ep_ranges()
            req = kg.required_extents()
            self.need = [req[b] for b in lg.buffer_order]
            self.tiled = {st.slot: st for st in self.em.staged}
        self.ranks = []
        for b in lg.buffer_order:
            self.ranks.append(next(g.ndim for g in kg.groups if g.buffer == b))
        self.max_rank = max(self.ranks) if self.ranks else 1
        self.lb_panels, self.ring_panels = shift_panels(kg)
        self.s_off, self.r_off, self.smem = smem_layout(kg)
        if self.smem > H100_SMEM_PER_BLOCK:
            raise EmitError(
                f"scratch of {self.smem} bytes exceeds the H100's "
                f"{H100_SMEM_PER_BLOCK}-byte shared memory per block",
                kernel=kg.name, witness=(self.smem, H100_SMEM_PER_BLOCK),
            )
        self.s_shapes = [kg.scratch_shape(sp, key) for sp, key in lg.entries]
        self.r_shapes = [r.ring_shape(kg.bh, kg.bw) for r in kg.rings]
        self.staged = {st.slot: st for st in staged_inputs(lg)}
        self.smem += sum(st.smem_bytes for st in self.staged.values()) + _tiled_bytes(self.em)
        self.tile = output_tile(lg)
        # a chain's hidden stages' scratch entries
        self.hidden = {si for si, (sp, _k) in enumerate(lg.entries)
                       if kg.chain is not None and sp.name in kg.chain.hidden}

    # -- loads --------------------------------------------------------------

    def block_ranges(self, shape: Sequence[int]) -> Dict[str, Tuple[int, int]]:
        """The ranges of a panel's coordinates and of the row and lane step."""
        lg = self.lg
        return {**_panel_ranges(shape), "i0": (0, lg.steps - 1), "j": (0, lg.lane_steps - 1)}

    def staging(self) -> List[str]:
        """The staged inputs' coalesced copies into shared memory, each over
        its required extents, then a barrier."""
        out: List[str] = []
        for b, st in self.staged.items():
            if st.panel is None:
                out += self.copy(b, st)
        return out + ["__syncthreads();"]

    def copy(self, b: int, st: StagedInput, kc: str = "kc") -> List[str]:
        """The copy of staged input ``b``; of a panel weight, panel ``kc``."""
        n = len(st.extents)
        dims = [f"D{b}_{a}" for a in range(n)]
        lin = _affine(0, [(s, f"p{a}") for a, s in enumerate(st.strides)])
        src = [f"p{a}" for a in range(n)]
        if st.panel is None:
            val = f"g{b}[{_horner(src, dims)}]"
            return self.loop(st.extents, [f"w{b}[{lin}] = {val};"])
        # a panel's copies all in flight at once, then waited for
        axis, block = st.panel
        src[axis] = f"{kc} * {block} + p{axis}"
        body = [f"ub_copy_async(w{b} + {lin}, g{b} + {_horner(src, dims)});"]
        return self.loop(st.extents, body) + ["ub_copy_wait();"]

    @staticmethod
    def index(ax: AxisIndex, sub: Optional[Mapping[str, str]] = None) -> str:
        """``ax`` as a C int expression; ``sub`` renames variables."""
        sub = sub or {}
        return _affine(ax.const, [(c, sub.get(v, v)) for c, v in _terms(ax)])

    def bounds(self, bounds: Bounds, sub: Optional[Mapping[str, str]] = None) -> List[str]:
        return [f"{self.index(ax, sub)} < {limit}" for ax, limit in bounds]

    def tap(self, t: Tap, sub: Optional[Mapping[str, str]] = None) -> str:
        idx = [self.index(ax, sub) for ax in t.axes]
        if t.kind == "ring":
            return f"r{t.src}[{_horner(idx, self.r_shapes[t.src])}]"
        if t.kind == "scratch":
            if t.src in self.hidden:
                # a hidden stage holds panel ``kc`` of its innermost axis
                idx[-1] = f"{idx[-1]} - kc * {self.kg.chain.block}"
            return f"s{t.src}[{_horner(idx, self.s_shapes[t.src])}]"
        b = self.lg.slot_of[self.kg.groups[t.src].buffer]
        st = self.staged.get(b)
        if st is not None:
            # the shared copy: every index lies inside the required extents
            # (``staged_inputs``), so the buffer's bounds cannot fail and
            # are dropped; a valid-row bound that some element of the
            # launch fails keeps its 0
            coef: Dict[str, int] = {}
            const = 0
            for ax, s in zip(t.axes, st.strides):
                const += s * ax.const
                for c, v in _terms(ax):
                    coef[v] = coef.get(v, 0) + s * c
            if st.panel is not None:
                # the copy holds panel ``kc`` of the axis
                axis, block = st.panel
                coef["kc"] = -st.strides[axis] * block
            sub = sub or {}
            val = f"w{b}[{_affine(const, [(c, sub.get(v, v)) for v, c in sorted(coef.items())])}]"
            ok = [f"{self.index(ax, sub)} < {lim}" for ax, lim in t.bounds
                  if _span(ax, self.rng)[1] >= lim]
            return f"(({' && '.join(ok)}) ? {val} : 0.f)" if ok else val
        dims = [f"D{b}_{j}" for j in range(len(idx))]
        ok = [f"(unsigned)({a}) < (unsigned){d}" for a, d in zip(idx, dims)]
        ok += self.bounds(t.bounds, sub)
        return f"ub_load(g{b}, {' && '.join(ok)}, {_horner(idx, dims)})"

    def program(self, ops: Sequence[Op]) -> Tuple[List[str], str]:
        lines = [f"const float v{k} = {_rhs(op, 'v{}'.format, self.index, self.tap, self.bounds)};"
                 for k, op in enumerate(ops)]
        return lines, f"v{len(ops) - 1}"

    # -- loops --------------------------------------------------------------

    @staticmethod
    def decode(shape: Sequence[int]) -> List[str]:
        """The coordinates ``p<d>`` of element ``e`` of ``shape``."""
        if len(shape) == 1:
            return ["const int p0 = e;"]
        out = ["int rem = e;"]
        for d in range(len(shape) - 1, 0, -1):
            out.append(f"const int p{d} = rem % {shape[d]}; rem /= {shape[d]};")
        return out + ["const int p0 = rem;"]

    def loop(self, shape: Sequence[int], body: List[str]) -> List[str]:
        n = math.prod(shape)
        out = [f"for (int e = threadIdx.x; e < {n}; e += {self.nt}) {{"]
        out += _indent(self.decode(shape) + body)
        out.append("}")
        return out

    def loops(self, parts: Sequence[Tuple[Sequence[int], List[str]]]) -> List[str]:
        """One loop of the block's threads over the elements of each part
        ``(shape, body)`` in turn, so that no thread waits on a short part;
        a body sees its own element index ``e`` and coordinates."""
        if len(parts) == 1:
            return self.loop(*parts[0])
        total = sum(math.prod(shape) for shape, _b in parts)
        out = [f"for (int f = threadIdx.x; f < {total}; f += {self.nt}) {{"]
        start = 0
        for i, (shape, body) in enumerate(parts):
            n = math.prod(shape)
            if i == 0:
                out.append(f"  if (f < {n}) {{")
            elif i < len(parts) - 1:
                out.append(f"  }} else if (f < {start + n}) {{")
            else:
                out.append("  } else {")
            out += _indent(_indent([f"const int e = f - {start};"] + self.decode(shape) + body))
            start += n
        return out + ["  }", "}"]

    @staticmethod
    def at(
        name: str, dims: Sequence[int], shape: Sequence[int],
        offsets: Optional[Dict[int, int]] = None,
    ) -> str:
        """``name`` (extents ``dims``) at the coordinates of a loop over
        ``shape``, shifted by ``offsets``: the flat loop index where only
        the leading axis is shifted and the trailing extents agree."""
        offsets = offsets or {}
        if set(offsets) <= {0} and tuple(shape[1:]) == tuple(dims[1:]):
            off = offsets.get(0, 0) * math.prod(dims[1:])
            return f"{name}[{off} + e]" if off else f"{name}[e]"
        idx = [_affine(offsets.get(d, 0), [(1, f"p{d}")]) for d in range(len(dims))]
        return f"{name}[{_horner(idx, dims)}]"

    def panel(
        self, sp: StagePlan, shift: int, lshift: int,
        store: Callable[[Sequence[int], str], List[str]],
        rows: Optional[int] = None, cols: Optional[int] = None,
    ) -> Tuple[Tuple[int, ...], List[str]]:
        """Stage ``sp``'s panel at row and lane shift ``(shift, lshift)``
        (``rows`` leading rows, ``cols`` trailing lanes), stored by
        ``store``: the ``(shape, body)`` of a ``loop`` or a part of
        ``loops``."""
        shape = self.lg.panel_shape(sp, rows, cols)
        self.rng = self.block_ranges(shape)
        body, val = self.program(self.lg.programs[(sp.name, shift, lshift)])
        return shape, body + store(shape, val)

    def rotate_rows(self, name: str, dims: Sequence[int], halo: int, n: int) -> List[str]:
        """Carry the ring's tail rows ``[n, n + halo)`` into its head."""
        inner = math.prod(dims[1:])
        return [
            f"for (int e = threadIdx.x; e < {halo * inner}; e += {self.nt}) "
            f"{name}[e] = {name}[{n * inner} + e];"
        ]

    def rotate_lanes(self, name: str, dims: Sequence[int], axis: int, halo: int,
                     n: int) -> Tuple[Tuple[int, ...], List[str]]:
        """Carry ``name``'s lane tail ``[n, n + halo)`` on ``axis`` into its
        head, as a part of ``loops``."""
        shape = _resized(dims, axis, halo)
        return shape, [f"{self.at(name, dims, shape)} = {self.at(name, dims, shape, {axis: n})};"]

    def land(
        self, r: int, offset: int, gi: int, n: int, rows: Optional[int] = None, back: int = 0,
    ) -> Tuple[Tuple[int, ...], List[str]]:
        """Land view group ``gi``'s block into ring ``r``, ``n`` of it at
        ``offset`` on the ring's axis (only its first ``rows`` rows where
        given): the ``(shape, body)`` of a ``loop`` or a part of ``loops``.
        With ``back``, rows from ``bh - back`` on of its block at the step
        before: what a ring of halo ``back`` would have carried into this
        step, loaded (and bounded by the view's valid rows) as that step
        loaded them."""
        dims, axis = self.r_shapes[r], self.kg.rings[r].axis
        tap = block_tap(self.kg, gi)
        if back:
            def at(ax: AxisIndex) -> AxisIndex:
                rows = ax.stride * (self.kg.bh - back) if ax.q == axis else 0
                return dataclasses.replace(ax, const=ax.const - ax.step + rows)
            tap = Tap(tap.kind, tap.src, tuple(at(ax) for ax in tap.axes),
                      tuple((at(ax), lim) for ax, lim in tap.bounds))
        val = self.tap(tap)
        shape = _resized(dims, axis, n)
        if rows is not None:
            shape = _resized(shape, 0, rows)
        return shape, [f"{self.at(f'r{r}', dims, shape, {axis: offset})} = {val};"]

    # -- lane-carried groups ------------------------------------------------

    def _sources(self, progs) -> set:
        """The shared arrays ``progs`` read: ``("r", ring)`` and ``("s", entry)``."""
        return {("r" if op[1].kind == "ring" else "s", op[1].src)
                for prog in progs for op in prog if op[0] == "tap" and op[1].kind != "view"}

    def lane_step(self) -> Tuple[List[str], int]:
        """One lane step ``j`` of a lane-carried group, and its barriers.

        Each panel (``shift_panels``) holds a physical row once; the member
        of the largest row shift holding it lands or evaluates it.  The
        step runs in phases, one barrier after each: every column ring and
        lane line buffer rotates (at ``j == 0`` the rings land their
        warm-up lanes instead), then each level of producers (the rings'
        steady lanes; a stage one level above every array it reads, with
        its warm-up lanes at ``j == 0``), then the output.  No barrier
        follows the output unless it reads an array that the next step's
        rotation writes."""
        lg, kg = self.lg, self.kg
        bw = kg.bw
        sync = "__syncthreads();"
        rotate, warm = [], []
        level: Dict[Tuple[str, int], int] = {}
        phases: Dict[int, Tuple[List, List]] = {}
        for pan in self.ring_panels:
            r0 = pan.members[0]
            ring = kg.rings[r0]
            dims = (pan.rows,) + tuple(self.r_shapes[r0][1:])
            rotate.append(self.rotate_lanes(f"r{r0}", dims, ring.axis, ring.halo, bw))
            for r, rows in pan.segments():
                ring = kg.rings[r]
                warm.append(self.land(r, 0, ring.prefix, ring.halo, rows))
                phases.setdefault(1, ([], []))[1].append(
                    self.land(r, ring.halo, ring.steady, bw, rows))
            level.update({("r", r): 1 for r in pan.members})
        # a lane line buffer's panel is emitted at its first member, a fused
        # panel alone
        first = {pan.members[0]: pan for pan in self.lb_panels}
        later = {m for pan in self.lb_panels for m in pan.members[1:]}
        for si, (sp, key) in enumerate(lg.entries):
            if si in later:
                continue
            pan = first.get(si, ShiftPanel((si,), (0,), kg.bh))
            lb = sp.line_buffer if si in first else None
            part_warm, part_main = [], []
            if lb is None:
                s, t = key if isinstance(key, tuple) else (key, 0)
                progs = [lg.programs[(sp.name, s, t)]]
                part_main.append(self.panel(sp, s, t, lambda sh, v, n=f"s{si}": [f"{n}[e] = {v};"]))
            else:
                dims = (pan.rows,) + tuple(self.s_shapes[si][1:])
                ax, h = len(dims) - 1, lb.halo
                rotate.append(self.rotate_lanes(f"s{si}", dims, ax, h, bw))
                progs = []
                for m, rows in pan.segments():
                    s = lg.entries[m][1][0]
                    name, mdims = f"s{m}", self.s_shapes[m]
                    progs += [lg.programs[(sp.name, s, lb.lo)], lg.programs[(sp.name, s, lb.hi)]]
                    part_warm.append(self.panel(
                        sp, s, lb.lo,
                        lambda sh, v, n=name, d=mdims: [f"{self.at(n, d, sh)} = {v};"],
                        rows=rows, cols=h))
                    part_main.append(self.panel(
                        sp, s, lb.hi,
                        lambda sh, v, n=name, d=mdims, o={ax: h}: [
                            f"{self.at(n, d, sh, o)} = {v};"],
                        rows=rows))
            lv = 1 + max((level[src] for src in self._sources(progs)), default=0)
            level.update({("s", m): lv for m in pan.members})
            ph = phases.setdefault(lv, ([], []))
            ph[0].extend(part_warm)
            ph[1].extend(part_main)
        out: List[str] = []
        if rotate:
            out += ["if (j > 0) {"] + _indent(self.loops(rotate))
            out += (["} else {"] + _indent(self.loops(warm)) + ["}"]) if warm else ["}"]
            out.append(sync)
        for lv in sorted(phases):
            part_warm, part_main = phases[lv]
            if part_warm:
                out += ["if (j == 0) {"] + _indent(self.loops(part_warm)) + ["}"]
            out += self.loops(part_main)
            out.append(sync)
        out += self.output_panel()
        progs = [lg.programs[(kg.output.name, 0, 0)]] + (
            [lg.init_program] if lg.init_program is not None else [])
        rotated = {("r", r) for r in range(len(kg.rings))}
        rotated |= {("s", m) for pan in self.lb_panels for m in pan.members}
        if self._sources(progs) & rotated:
            out.append(sync)
        return out, sum(ln.strip() == sync for ln in out)

    # -- register tiles -----------------------------------------------------

    def tile_deps(self, rt: RegisterTile, ops: Sequence[Op]) -> List[Tuple[bool, bool]]:
        """Whether each op varies along the tile's outer and inner axis: it
        is evaluated once for each element of an axis it varies along, once
        for the whole axis otherwise."""
        def varies(axes) -> Tuple[bool, bool]:
            axes = list(axes)
            return (any(_uses(ax, v) for ax in axes for v in rt.outer.vars),
                    any(_uses(ax, v) for ax in axes for v in rt.inner.vars))

        dep: List[Tuple[bool, bool]] = []
        for op in ops:
            kind = op[0]
            if kind == "iter":
                d = varies([op[1]])
            elif kind == "tap":
                d = varies(list(op[1].axes) + [ax for ax, _l in op[1].bounds])
            elif kind == "mask":
                o, i = varies(ax for ax, _l in op[2])
                d = (o or dep[op[1]][0], i or dep[op[1]][1])
            elif kind in ("bin", "sel", "un"):
                xs = _operands(op)
                d = (any(dep[x][0] for x in xs), any(dep[x][1] for x in xs))
            else:
                d = (kind == "acc" and bool(rt.outer.vars), kind == "acc" and bool(rt.inner.vars))
            dep.append(d)
        return dep

    def tile_op(self, rt: RegisterTile, io: _TileIO, k: int, op: Op,
                dep: Sequence[Tuple[bool, bool]], chained: Optional[int] = None,
                acc: Optional[Mapping[Tuple[int, int], str]] = None,
                extra: Optional[Mapping[str, str]] = None) -> List[str]:
        """Op ``k`` for each element it varies across: op ``chained``'s
        value is the element's sum ``ch<o>_<i>``, an ``acc`` op's its
        accumulator; ``extra`` renames more variables."""
        if op[0] == "tap" and op[1].kind == "view":
            st = self.tiled.get(self.lg.slot_of[self.kg.groups[op[1].src].buffer])
            if st is not None:
                return self.ep_staged(rt, op[1], k, st, dep[k])

        def ref(x: int, o: int, i: int) -> str:
            return f"ch{o}_{i}" if x == chained else rt.name(x, dep[x], o, i)
        lines = []
        for o in range(rt.outer.extent) if dep[k][0] else (0,):
            for i in range(rt.inner.extent) if dep[k][1] else (0,):
                sub = {**rt.sub(o, i), **(extra or {})}
                rhs = _rhs(op, lambda x: ref(x, o, i), lambda ax: self.index(ax, sub),
                           lambda tp: io.load(tp, sub), lambda b: io.bounds(b, sub),
                           acc[(o, i)] if op[0] == "acc" else "")
                lines.append(f"const float {ref(k, o, i)} = {rhs};")
        return lines

    def tile_head(self, rt: RegisterTile, io: _TileIO, ops: Sequence[Op], head: int,
                  dep: Sequence[Tuple[bool, bool]],
                  acc: Optional[Mapping[Tuple[int, int], str]] = None,
                  extra: Optional[Mapping[str, str]] = None) -> List[str]:
        """A chain's head, then each element's sum ``ch<o>_<i>`` from its
        initial value."""
        lines = [ln for k in range(head)
                 for ln in self.tile_op(rt, io, k, ops[k], dep, acc=acc, extra=extra)]
        return lines + ["float " + ", ".join(
            f"ch{o}_{i} = {rt.name(head - 1, dep[head - 1], o, i)}" for o, i in rt.elems) + ";"]

    def tile_term(self, rt: RegisterTile, io: _TileIO, ops: Sequence[Op], a: int, e: int,
                  dep: Sequence[Tuple[bool, bool]], step: Optional[tuple] = None, n: int = 1,
                  extra: Optional[Mapping[str, str]] = None) -> List[str]:
        """Term ``ops[a..e]`` for each element, then its addition to the
        element's sum.  With ``step``, the body of a loop over ``r`` in
        ``[0, n)``: every index constant of the term advances by its step
        per iteration."""
        it = iter(step or ())
        self.rng["r"] = (0, n - 1)
        body = []
        for k in range(a, e + 1):
            op = ops[k] if step is None else _roll_op(ops[k], it)
            body += self.tile_op(rt, io, k, op, dep, chained=a - 1, extra=extra)
        del self.rng["r"]
        return body + [f"ch{o}_{i} = {rt.name(e, dep[e], o, i)};" for o, i in rt.elems]

    def tile_program(
        self, rt: RegisterTile, io: _TileIO, ops: Sequence[Op],
        acc: Optional[Mapping[Tuple[int, int], str]] = None,
        extra: Optional[Mapping[str, str]] = None,
    ) -> Tuple[List[str], List[str]]:
        """``ops`` for each element of the tile, interleaved statement by
        statement, each op once for the elements it does not vary across
        (``tile_deps``).  A reduction's accumulation chain keeps each
        element's sum in ``ch<o>_<i>``, and each run of at least
        ``ROLL_MIN`` terms that differ only in constants advancing by the
        same step is one loop over ``r``, unrolled ``ROLL_UNROLL`` times
        (written out, nvcc hoisted a whole chain's loads into registers: one
        block an SM).  ``extra`` renames more variables.  Returns the lines
        and each element's value, in the order of ``rt.elems``."""
        dep = self.tile_deps(rt, ops)
        chain = _chain(ops)
        if chain is None:
            lines = [ln for k, op in enumerate(ops)
                     for ln in self.tile_op(rt, io, k, op, dep, acc=acc, extra=extra)]
            return lines, [rt.name(len(ops) - 1, dep[-1], o, i) for o, i in rt.elems]
        lines = self.tile_head(rt, io, ops, chain[0], dep, acc, extra)
        for terms, step in _chain_runs(ops, chain, io.checks):
            n = len(terms)
            if n >= ROLL_MIN:
                lines += [f"#pragma unroll {ROLL_UNROLL}", f"for (int r = 0; r < {n}; ++r) {{"]
                lines += _indent(self.tile_term(rt, io, ops, *terms[0], dep, step, n,
                                                extra)) + ["}"]
            else:
                for a, e in terms:
                    lines += ["{"] + _indent(self.tile_term(rt, io, ops, a, e, dep,
                                                            extra=extra)) + ["}"]
        return lines, [f"ch{o}_{i}" for o, i in rt.elems]

    # -- element-parallel groups --------------------------------------------

    def ep_ranges(self) -> Dict[str, Tuple[int, int]]:
        """Each variable's range over the whole launch."""
        lg = self.lg
        rng = {
            "i0": (0, lg.steps - 1), "j": (0, lg.lane_steps - 1), "k": (0, lg.red_steps - 1),
        }
        for q, e in enumerate(lg.panel_shape(self.kg.output)):
            rng[f"p{q}"] = (0, e - 1)
        for v, val in self.em.fixed:
            rng[v] = (val, val)
        return rng

    def ep_load(self, t: Tap, sub: Mapping[str, str]) -> str:
        """A view load, bounded only where some element of the launch can
        fall outside the buffer's required extents or the view's valid
        rows and lanes (the buffer is at least that large, so a load that
        never does reads what the bounded load reads)."""
        b = self.lg.slot_of[self.kg.groups[t.src].buffer]
        idx = [self.index(ax, sub) for ax in t.axes]
        dims = [f"D{b}_{j}" for j in range(len(idx))]
        keep = self.ep_checks(("tap", t))
        ok = [f"(unsigned)({a}) < (unsigned){d}" for a, d, c in zip(idx, dims, keep) if c]
        ok += self.ep_bounds(t.bounds, sub)
        lin = _horner(idx, dims)
        return f"ub_load(g{b}, {' && '.join(ok)}, {lin})" if ok else f"g{b}[{lin}]"

    def ep_bounds(self, bounds: Bounds, sub: Mapping[str, str]) -> List[str]:
        """The bounds some element of the launch can fail."""
        return [
            f"{self.index(ax, sub)} < {limit}"
            for ax, limit in bounds if _span(ax, self.rng)[1] >= limit
        ]

    def ep_staged(self, rt: RegisterTile, tap: Tap, k: int, st: TiledInput,
                  dep: Tuple[bool, bool]) -> List[str]:
        """Op ``k``, a load of a staged input: the term's ``entries``
        values, which lie together in the shared copy, read 16 (or 8) bytes
        at a time that the whole warp reads alike; a valid-row bound that
        some element of the launch fails keeps its 0."""
        b = st.slot
        strides = [math.prod(st.extents[a + 1:]) * st.entries for a in range(len(st.dims))]
        coef: Dict[str, int] = {}
        const = 0
        for d, s, low in zip(st.dims, strides, st.lo):
            ax = tap.axes[d]
            const += s * (ax.const - low)
            for c, v in _terms(ax):
                coef[v] = coef.get(v, 0) + s * c
        at = _affine(const, [(c, v) for v, c in sorted(coef.items())])
        if not dep[1]:
            ok = self.ep_bounds(tap.bounds, {})
            val = f"w{b}[{at}]"
            val = f"({' && '.join(ok)}) ? {val} : 0.f" if ok else val
            return [f"const float {rt.name(k, dep, 0, 0)} = {val};"]
        width = 4 if st.entries % 4 == 0 else 2 if st.entries % 2 == 0 else 1
        lines = []
        if width > 1:
            vec = f"float{width}"
            for g in range(st.entries // width):
                ptr = f"w{b} + {at}" + (f" + {g * width}" if g else "")
                lines.append(f"const {vec} v{k}q{g} = *reinterpret_cast<const {vec}*>({ptr});")
        for t in range(st.entries):
            val = (f"v{k}q{t // width}.{'xyzw'[t % width]}" if width > 1
                   else f"w{b}[{at} + {t}]")
            ok = self.ep_bounds(tap.bounds, rt.sub(0, t))
            val = f"({' && '.join(ok)}) ? {val} : 0.f" if ok else val
            lines.append(f"const float {rt.name(k, dep, 0, t)} = {val};")
        return lines

    def ep_checks(self, op: Op) -> List[bool]:
        """Which of a load's or mask's checks some element of the launch
        can fail."""
        if op[0] == "tap":
            t = op[1]
            b = self.lg.slot_of[self.kg.groups[t.src].buffer]
            out = []
            for ax, n in zip(t.axes, self.need[b]):
                lo, hi = _span(ax, self.rng)
                out.append(lo < 0 or hi >= n)
            return out + [_span(ax, self.rng)[1] >= lim for ax, lim in t.bounds]
        return [_span(ax, self.rng)[1] >= lim for ax, lim in op[2]]

    def ep_store(self, rt: RegisterTile, vals: Sequence[str]) -> List[str]:
        """Each element's value into its place in the output, where the
        element lies inside the output's extents (and its run position
        inside the thread axis)."""
        lg, kg, em = self.lg, self.kg, self.em
        out_sp = kg.output
        ext = out_sp.nstage.pure_extents
        n = len(ext)
        lines = []
        for (u, t), v in zip(rt.elems, vals):
            sub = rt.sub(u, t)
            ps = [sub.get(f"p{q}", f"p{q}") for q in range(n)]
            bounds = []
            if lg.streamed(out_sp):
                ps[0] = f"{sub.get('i0', 'i0')} * {kg.bh} + {ps[0]}"
                bounds.append((AxisIndex(0, 0, 1, kg.bh), kg.e0))
            if lg.lane_blocked(out_sp):
                ps[-1] = f"{sub.get('j', 'j')} * {kg.bw} + {ps[-1]}"
                bounds.append((AxisIndex(n - 1, 0, 1, lstep=kg.bw), kg.e1))
            ok = self.ep_bounds(tuple(bounds), sub)
            if em.lanes * (u + 1) > em.extent:
                ok.insert(0, f"{em.thread_axis}l + {em.lanes * u} < {em.extent}")
            st = f"out[{_horner(ps, ext)}] = {v};"
            lines.append(f"if ({' && '.join(ok)}) {st}" if ok else st)
        return lines

    def ep_var(self, v: str) -> str:
        """The C variable a work or chunk axis is decoded into: the tile
        axis's tile index, the thread axis's lane under a run."""
        em = self.em
        if v == em.tile_axis:
            return f"{v}t"
        if v == em.thread_axis and em.run > 1:
            return f"{v}l"
        return v

    def ep_decode(self, src: str, rem: str, axes) -> List[str]:
        """Decode ``src`` into ``axes``, fastest first."""
        out = [f"int {rem} = {src};"] if len(axes) > 1 else []
        for i, (v, e) in enumerate(axes):
            var = self.ep_var(v)
            if i == len(axes) - 1:
                out.append(f"const int {var} = {rem if len(axes) > 1 else src};")
            else:
                out.append(f"const int {var} = {rem} % {e}; {rem} /= {e};")
        return out

    def ep_tile_value(self, t: str) -> str:
        """The tile axis at element ``t`` of the tile."""
        em = self.em
        held = any(v == em.tile_axis for v, _e in em.axes + em.chunk)
        return f"{em.tile_axis}t * {em.tile} + {t}" if held else t

    def ep_tiles(self) -> List[str]:
        """The tile's values of the tile axis."""
        em = self.em
        return [f"const int {em.tile_axis}_{t} = {self.ep_tile_value(str(t))};"
                for t in range(em.tile) if em.tile > 1]

    def ep_copy(self, st: TiledInput) -> List[str]:
        """The block's coalesced, asynchronous copy of staged input ``st``:
        entry ``e`` reads the buffer in its own order (the tile dimension
        outermost); an index outside the buffer writes 0."""
        em = self.em
        b = st.slot
        size = math.prod(st.extents)
        body: List[str] = []
        if st.entries > 1:
            body += [f"const int t = e / {size};", f"const int at = e - t * {size};"]
            dst = f"at * {st.entries} + t"
        else:
            body.append("const int at = e;")
            dst = "at"
        body += self.ep_decode("at", "rem", [(f"c{a}", n) for a, n in reversed(
            list(enumerate(st.extents)))])
        idx: Dict[int, str] = {}
        ok = []
        for a, (d, low) in enumerate(zip(st.dims, st.lo)):
            idx[d] = _affine(low, [(1, f"c{a}")])
            if low < 0 or low + st.extents[a] > self.need[b][d]:
                ok.append(f"(unsigned)({idx[d]}) < (unsigned)D{b}_{d}")
        if st.index is not None:
            sub = {em.tile_axis: f"({self.ep_tile_value('t')})"} if st.entries > 1 else {}
            idx[st.tile_dim] = self.index(st.index, sub)
            lo, hi = _span(st.index, self.rng)
            if lo < 0 or hi >= self.need[b][st.tile_dim]:
                ok.append(f"(unsigned)({idx[st.tile_dim]}) < (unsigned)D{b}_{st.tile_dim}")
        rank = len(st.dims) + (st.index is not None)
        src = _horner([idx[d] for d in range(rank)], [f"D{b}_{d}" for d in range(rank)])
        copy = f"ub_copy_async(w{b} + {dst}, g{b} + {src});"
        if ok:
            body += [f"if ({' && '.join(ok)}) {copy}", f"else w{b}[{dst}] = 0.f;"]
        else:
            body.append(copy)
        return ([f"for (int e = threadIdx.x; e < {st.size}; e += {em.threads}) {{"]
                + _indent(body) + ["}"])

    def ep_kernel(self) -> List[str]:
        """The kernel body of an element-parallel group: under staged
        inputs, the block's chunk, its copies and a barrier; then the
        threads stride over the chunk's work items."""
        em = self.em
        out: List[str] = []
        items = em.work // em.chunks
        per_chunk = em.blocks // em.chunks
        if not em.staged:
            out.append(
                f"for (int w = blockIdx.x * {em.threads} + threadIdx.x; w < {items}; "
                f"w += gridDim.x * {em.threads}) {{"
            )
            return out + _indent(self.ep_body(True))
        if em.chunk:
            src = f"blockIdx.x / {per_chunk}" if per_chunk > 1 else "blockIdx.x"
            out += self.ep_decode(src, "crem", em.chunk)
        out += [f"const int {v} = {val};" for v, val in em.fixed]
        if not any(v == em.tile_axis for v, _e in em.axes):
            out += self.ep_tiles()
        for st in em.staged:
            out += self.ep_copy(st)
        out += ["ub_copy_wait();", "__syncthreads();"]
        first = (f"blockIdx.x % {per_chunk} * {em.threads} + threadIdx.x" if per_chunk > 1
                 else "threadIdx.x")
        out.append(f"for (int w = {first}; w < {items}; w += {per_chunk * em.threads}) {{")
        return out + _indent(self.ep_body(False))

    def ep_body(self, whole: bool) -> List[str]:
        """One work item: decode it, evaluate its elements, store them.
        ``whole``: the block holds no chunk, so the fixed variables and the
        tile's values are set here."""
        lg, kg, em = self.lg, self.kg, self.em
        out = self.ep_decode("w", "rem", em.axes)
        if whole:
            out += [f"const int {v} = {val};" for v, val in em.fixed]
        if whole or any(v == em.tile_axis for v, _e in em.axes):
            out += self.ep_tiles()
        if em.run > 1:
            xa = em.thread_axis
            for u in range(em.run):
                pos = f"{xa}l + {em.lanes * u}" if u else f"{xa}l"
                if em.lanes * (u + 1) > em.extent:
                    pos = f"min({pos}, {em.extent - 1})"
                out.append(f"const int {xa}_{u} = {pos};")
        rt = em.register_tile
        io = _TileIO(self.ep_load, self.ep_bounds, self.ep_checks)
        rg = kg.red_grid
        if rg is None:
            body, vals = self.tile_program(rt, io, lg.programs[(kg.output.name, 0, 0)])
            return out + body + self.ep_store(rt, vals)
        accs = [f"acc{u}_{t}" for u, t in rt.elems]
        init, iv = self.tile_program(rt, io, lg.init_program)
        chunk, cv = self.tile_program(rt, io, lg.programs[(kg.output.name, 0, 0)],
                                      dict(zip(rt.elems, accs)))
        out.append(f"float {', '.join(accs)};")
        out += ["{"] + _indent(init + [f"{a} = {v};" for a, v in zip(accs, iv)]) + ["}"]
        out.append(f"for (int k = 0; k < {rg.steps}; ++k) {{")
        out += _indent(chunk + [f"{a} = {v};" for a, v in zip(accs, cv)]) + ["}"]
        return out + self.ep_store(rt, accs)

    # -- kernel -------------------------------------------------------------

    def step(self) -> List[str]:
        """One grid step of the Pallas kernel body, at ``(i0, j)``, of a
        row-carried group or one that carries nothing."""
        lg, kg = self.lg, self.kg
        bh = kg.bh
        sync = "__syncthreads();"
        # a group that carries nothing, but weight panels, rolls the chain of
        # a window-attention group's fused panels (its score tile and row
        # statistics) and of any other fused panel whose reduction is at
        # least ROLL_PANEL_MIN terms long (a LayerNorm's channel sums)
        rolled = carries_nothing(lg) and kg.panels is None
        out: List[str] = self.staging() if self.staged else []
        if kg.rings:
            # rotate the carried halo (or warm up at the first step), then
            # land the steady block; a band's first step after step 0 lands
            # the steady rows the step before would have rotated in
            for r, ring in enumerate(kg.rings):
                h = ring.halo
                rotate = _indent(self.rotate_rows(f"r{r}", self.r_shapes[r], h, bh))
                prefix = _indent(self.loop(*self.land(r, 0, ring.prefix, h)))
                back = _indent(self.loop(*self.land(r, 0, ring.steady, h, back=h)))
                out += (["if (i0 > band_begin) {"] + rotate + ["} else if (i0 == 0) {"]
                        + prefix + ["} else {"] + back + ["}"])
            out.append(sync)
            for r, ring in enumerate(kg.rings):
                out += self.loop(*self.land(r, ring.halo, ring.steady, bh))
            out.append(sync)
        for si, (sp, key) in enumerate(lg.entries):
            name, dims, lb = f"s{si}", self.s_shapes[si], sp.line_buffer
            if key is None:
                # a row line buffer: it warms up at its band's first step
                h = lb.halo
                out.append("if (i0 > band_begin) {")
                out += _indent(self.rotate_rows(name, dims, h, bh))
                out.append("}")
                out.append(sync)
                out.append("if (i0 == band_begin) {")
                out += _indent(self.loop(*self.panel(
                    sp, lb.lo, 0, lambda sh, v, n=name, d=dims: [f"{self.at(n, d, sh)} = {v};"],
                    rows=h,
                )))
                out.append("}")
                out += self.loop(*self.panel(
                    sp, lb.hi, 0,
                    lambda sh, v, n=name, d=dims, o={0: h}: [f"{self.at(n, d, sh, o)} = {v};"],
                ))
            elif rolled and not isinstance(key, tuple) and (
                    kg.window is not None or self.long_chain(sp, key)):
                out += self.rolled_panel(si)
            else:
                s, t = key if isinstance(key, tuple) else (key, 0)
                out += self.loop(*self.panel(sp, s, t, lambda sh, v, n=name: [f"{n}[e] = {v};"]))
            out.append(sync)
        out += self.output_panel()
        if lg.row_carried:
            out.append(sync)
        return out

    def long_chain(self, sp, key) -> bool:
        """Whether the panel of stage ``sp`` computes a reduction's chain of
        at least ``ROLL_PANEL_MIN`` terms."""
        ch = _chain(self.lg.programs[(sp.name, key, 0)])
        return ch is not None and len(ch[1]) >= ROLL_PANEL_MIN

    def rolled_panel(self, si: int) -> List[str]:
        """Scratch entry ``si``'s panel, one element a thread at a time, a
        reduction's chain rolled as ``tile_program`` rolls it."""
        sp, key = self.lg.entries[si]
        self.rng = self.block_ranges(self.lg.panel_shape(sp))
        one = RegisterTile(TileAxis(1, (), ""), TileAxis(1, (), "c"))
        io = _TileIO(self.tap, self.bounds, self.tile_checks)
        ops = self.lg.programs[(sp.name, key, 0)]
        lines, (val,) = self.vector_chain(one, io, ops) or self.tile_program(one, io, ops)
        return self.loop(self.s_shapes[si], lines + [f"s{si}[e] = {val};"])

    def _word_aligned(self, t: Tap) -> Optional[bool]:
        """Whether a shared-memory tap's flat index advances by one float an
        ``r`` (True: four terms are one 16-byte load, aligned for every
        value of its other variables) or not at all (False); None for any
        other tap."""
        if t.kind == "scratch":
            dims, base = self.s_shapes[t.src], self.s_off[t.src]
            strides = [math.prod(dims[a + 1:]) for a in range(len(dims))]
            kc = -self.kg.chain.block * strides[-1] if t.src in self.hidden else 0
        elif t.kind == "view" and self.lg.slot_of[self.kg.groups[t.src].buffer] in self.staged:
            st = self.staged[self.lg.slot_of[self.kg.groups[t.src].buffer]]
            if any(_span(ax, self.rng)[1] >= lim for ax, lim in t.bounds):
                return None
            strides, base = st.strides, st.offset
            kc = -st.strides[st.panel[0]] * st.panel[1] if st.panel is not None else 0
        else:
            return None
        coef: Dict[str, int] = {"kc": kc, "r": 0}
        const = base
        for ax, stride in zip(t.axes, strides):
            const += stride * ax.const
            for c, v in _terms(ax):
                coef[v] = coef.get(v, 0) + stride * c
        step = coef.pop("r")
        if step == 0:
            return False
        ok = step == 1 and const % 4 == 0 and all(c % 4 == 0 for c in coef.values())
        return True if ok else None

    def vector_chain(self, rt: RegisterTile, io: _TileIO, ops: Sequence[Op],
                     ) -> Optional[Tuple[List[str], List[str]]]:
        """``tile_program`` for a program that is a reduction's chain of one
        run, a multiple of four terms long, whose loads all read shared
        memory, each either one float further an ``r`` from a
        16-byte-aligned start (``_word_aligned``) or the same float every
        ``r``: the loop steps four terms at a time, the first kind loaded
        once a step as one ``float4`` for each element of the tile it varies
        across (so each word feeds every element that reads it), and adds
        the four terms to each element's sum in turn, as the rolled loop
        adds them.  An unrolled step holds ``VECTOR_UNROLL`` steps of one
        element's chain, shared by the tile's elements.  None for any other
        program."""
        chain = _chain(ops)
        if chain is None:
            return None
        self.rng["r"] = (0, 0)
        runs = _chain_runs(ops, chain, io.checks)
        if len(runs) != 1 or len(runs[0][0]) % 4 or len(runs[0][0]) < ROLL_MIN:
            del self.rng["r"]
            return None
        ((terms, step),) = runs
        n = len(terms)
        self.rng["r"] = (0, n - 1)
        a, e = terms[0]
        it = iter(step)
        rolled = {k: _roll_op(ops[k], it) for k in range(a, e + 1)}
        taps = {k: op[1] for k, op in rolled.items() if op[0] == "tap"}
        kinds = {k: self._word_aligned(t) for k, t in taps.items()}
        if None in kinds.values() or True not in kinds.values():
            del self.rng["r"]
            return None
        dep = self.tile_deps(rt, ops)
        lines = self.tile_head(rt, io, ops, chain[0], dep)
        words = {id(taps[k]): k for k, word in kinds.items() if word}

        def word(k: int, o: int, i: int) -> str:
            return f"q{k}" + (f"_{o}" if dep[k][0] else "") + (f"_c{i}" if dep[k][1] else "")

        body = [f"const float4 {word(k, o, i)} = "
                f"*reinterpret_cast<const float4*>(&{self.tap(taps[k], rt.sub(o, i))});"
                for k in sorted(words.values())
                for o in (range(rt.outer.extent) if dep[k][0] else (0,))
                for i in (range(rt.inner.extent) if dep[k][1] else (0,))]
        for u, comp in enumerate("xyzw"):
            def load(t: Tap, sub: Mapping[str, str], comp=comp) -> str:
                k = words.get(id(t))
                if k is None:
                    return self.tap(t, sub)
                o, i = next((o, i) for o, i in rt.elems
                            if all(sub.get(v) == w for v, w in rt.sub(o, i).items()))
                return f"{word(k, o, i)}.{comp}"
            part = [ln for k in range(a, e + 1)
                    for ln in self.tile_op(rt, _TileIO(load, io.bounds, io.checks), k, rolled[k],
                                           dep, chained=a - 1, extra={"r": f"(r + {u})"})]
            body += ["{"] + _indent(part + [f"ch{o}_{i} = {rt.name(e, dep[e], o, i)};"
                                            for o, i in rt.elems]) + ["}"]
        del self.rng["r"]
        unroll = max(1, VECTOR_UNROLL // len(rt.elems))
        lines += [f"#pragma unroll {unroll}", f"for (int r = 0; r < {n}; r += 4) {{"]
        return lines + _indent(body) + ["}"], [f"ch{o}_{i}" for o, i in rt.elems]

    def chain_step(self) -> List[str]:
        """One row step of a chained group (``kg.chain``): the staged
        copies, each fused panel before the chain in turn (a barrier after
        each), then the chain (``chain_panels``), the fused panels after it,
        and the output panel."""
        lg, kg = self.lg, self.kg
        ch = kg.chain
        sync = "__syncthreads();"
        cons = next(si for si, (sp, _k) in enumerate(lg.entries) if sp.name == ch.consumer)
        out = self.staging()
        for si in range(len(lg.entries)):
            if si in self.hidden:
                continue
            out += self.chain_panels(cons) if si == cons else self.rolled_panel(si)
            out.append(sync)
        return out + self.output_panel()

    def chain_panels(self, cons: int) -> List[str]:
        """The chain: each thread's register tile of the consumer's sums
        (``chain_tile``) from their initial values, then for each hidden
        panel ``kc`` in turn the hidden stages' panels (their innermost
        index ``kc * block + p``, held at ``p``) in register tiles
        (``hidden_panel``), and the consumer's terms over the panel, one loop
        over ``r``, a barrier after each; the panels of the inputs staged
        along the hidden axis copied in ahead, those only the hidden stages
        read during the consumer's terms before, the others during the
        hidden stages (``cp.async`` groups, each waited for before its
        reader's barrier); then the sums (masked on a padded grid) into the
        consumer's scratch.  The consumer's chain
        must be one run of terms over the whole hidden axis."""
        lg, kg = self.lg, self.kg
        ch = kg.chain
        sp, _key = lg.entries[cons]
        ops = lg.programs[(sp.name, 0, 0)]
        shape = lg.panel_shape(sp)
        n = len(shape)
        ot = chain_tile(lg)
        rt = ot.register_tile(n)
        io = _TileIO(self.tap, self.bounds, self.tile_checks)
        self.rng = self.block_ranges(shape)
        k = len(ops) - 1
        masked = ops[k][0] == "mask" and ops[k][1] == k - 1
        chain = _chain(ops[:k] if masked else ops)
        runs = _chain_runs(ops, chain, io.checks) if chain is not None else []
        if len(runs) != 1 or len(runs[0][0]) != ch.extent:
            raise EmitError(
                f"the consumer's chain runs of {[len(t) for t, _s in runs]} terms are not one "
                f"run over the {ch.extent} steps of the hidden axis", kernel=kg.name)
        ((terms, step),) = runs
        dep = self.tile_deps(rt, ops)
        term = self.tile_term(rt, io, ops, *terms[0], dep, step, ch.extent,
                              {"r": f"(kc * {ch.block} + r)"})
        rag_o, rag_i = ot.groups * ot.rows != ot.outer, ot.lanes * ot.cols != ot.inner
        body = [f"const int ob = threadIdx.x / {ot.lanes};",
                f"const int cb = threadIdx.x % {ot.lanes};"]
        body += self.tile_coords(ot, shape, rag_o, rag_i)
        body += self.tile_head(rt, io, ops, chain[0], dep)
        # the panels only the hidden stages read are copied in while the
        # consumer adds the panel before, the others while the hidden
        # stages evaluate theirs: two groups of copies in flight in turn
        hidden = sorted(self.hidden)
        early = {self.lg.slot_of[self.kg.groups[op[1].src].buffer]
                 for si in hidden for op in lg.programs[(lg.entries[si][0].name, 0, 0)]
                 if op[0] == "tap" and op[1].kind == "view"}
        early -= {self.lg.slot_of[self.kg.groups[op[1].src].buffer]
                  for op in ops if op[0] == "tap" and op[1].kind == "view"}

        def copies(first: bool, kc: str) -> List[str]:
            out = [ln for b, st in self.staged.items()
                   if st.panel is not None and (b in early) == first
                   for ln in self.copy(b, st, kc)[:-1]]
            return out + ["ub_copy_commit();"]

        body += copies(True, "0") + copies(False, "0")
        walk = ["ub_copy_wait_group<1>();", "__syncthreads();"]
        walk += self.hidden_panel()
        walk += ["__syncthreads();", f"if (kc + 1 < {ch.count}) {{"]
        walk += _indent(copies(True, "(kc + 1)") + ["ub_copy_wait_group<1>();"])
        walk += ["} else {", "  ub_copy_wait_group<0>();", "}", "__syncthreads();"]
        self.rng = self.block_ranges(shape)
        walk += [f"#pragma unroll {ROLL_UNROLL}", f"for (int r = 0; r < {ch.block}; ++r) {{"]
        walk += _indent(term) + ["}", "__syncthreads();", f"if (kc + 1 < {ch.count}) {{"]
        walk += _indent(copies(False, "(kc + 1)")) + ["}"]
        body += [f"for (int kc = 0; kc < {ch.count}; ++kc) {{"] + _indent(walk) + ["}"]
        vals = [f"ch{o}_{i}" for o, i in rt.elems]
        if masked:
            body += self.tile_op(rt, io, k, ops[k], dep, chained=k - 1)
            vals = [rt.name(k, dep[k], o, i) for o, i in rt.elems]
        body += self.tile_stores(ot, cons, vals, rag_o, rag_i)
        return ["{"] + _indent(body) + ["}"]

    def hidden_panel(self) -> List[str]:
        """The hidden stages' panel ``kc`` (``kg.chain``), each thread a
        register tile of ``rows`` positions by ``cols`` hidden entries
        (``HiddenChain.tile``, as ``hidden_tile``): each stage in turn by
        ``tile_program`` (a chain four terms a 16-byte load where
        ``vector_chain`` can: fc1's, each float4 of a LayerNorm row or a
        weight row feeding every element of the tile that reads it), each
        element's value stored at its place in the panel.  An element's
        innermost coordinate is its hidden index ``kc * block + c``.  Every
        hidden stage reads the others only at its own element, which the
        same thread stored, so one barrier follows the whole panel."""
        lg = self.lg
        hidden = sorted(self.hidden)
        shape = self.s_shapes[hidden[0]]
        ot = hidden_tile(lg)
        rag_o = ot.groups * ot.rows != ot.outer
        rag_i = ot.lanes * ot.cols != ot.inner
        rt = ot.register_tile(len(shape))
        io = _TileIO(self.tap, self.bounds, self.tile_checks)
        body = [f"const int ob = w / {ot.lanes};", f"const int cb = w % {ot.lanes};"]
        body += self.tile_coords(ot, shape, rag_o, rag_i, f"kc * {ot.inner} + ")
        for si in hidden:
            sp, key = lg.entries[si]
            self.rng = self.block_ranges(lg.panel_shape(sp))
            ops = lg.programs[(sp.name, key, 0)]
            lines, vals = self.vector_chain(rt, io, ops) or self.tile_program(rt, io, ops)
            body += ["{"] + _indent(lines + self.tile_stores(ot, si, vals, rag_o, rag_i)) + ["}"]
        return ([f"for (int w = threadIdx.x; w < {ot.groups * ot.lanes}; w += {self.nt}) {{"]
                + _indent(body) + ["}"])

    @staticmethod
    def tile_stores(ot: OutputTile, si: int, vals: Sequence[str], rag_o: bool,
                    rag_i: bool) -> List[str]:
        """Each element's value of a thread's tile into scratch entry
        ``si``, a panel of ``ot.outer`` by ``ot.inner``, where the element
        lies inside it."""
        out = []
        for (t, u), v in zip([(t, u) for t in range(ot.rows) for u in range(ot.cols)], vals):
            conds = ([f"o{t} < {ot.outer}"] if rag_o else []) + (
                [f"c{u} < {ot.inner}"] if rag_i else [])
            st = f"s{si}[o{t} * {ot.inner} + c{u}] = {v};"
            out.append(f"if ({' && '.join(conds)}) {st}" if conds else st)
        return out

    def output_panel(self) -> List[str]:
        """The output stage's panel (a grid reduction's chunks summed in
        order), stored where it lies inside the output's extents."""
        lg, kg = self.lg, self.kg
        out_sp = kg.output

        def store(_shape, v):
            return self.out_store([], {}, "e", v)
        rg = kg.red_grid
        if rg is None:
            if self.tile is not None:
                return self.tiled_output()
            return self.loop(*self.panel(out_sp, 0, 0, store))
        self.rng = self.block_ranges(lg.panel_shape(out_sp))
        init, iv = self.program(lg.init_program)
        chunk, cv = self.program(lg.programs[(out_sp.name, 0, 0)])
        body = ["float acc;", "{"] + _indent(init) + [f"  acc = {iv};", "}"]
        body.append(f"for (int k = 0; k < {rg.steps}; ++k) {{")
        body += _indent(chunk) + [f"  acc = {cv};", "}"]
        return self.loop(lg.panel_shape(out_sp), body + store(None, "acc"))

    def out_store(self, conds: List[str], sub: Mapping[str, str], e: str, v: str) -> List[str]:
        """Store ``v`` at the output panel's element ``e`` (flat index;
        coordinates ``p<q>`` renamed by ``sub``) where it lies inside the
        output's extents and ``conds`` hold."""
        kg = self.kg
        bh, bw = kg.bh, kg.bw
        out_sp = kg.output
        ext = out_sp.nstage.pure_extents
        p = [sub.get(f"p{d}", f"p{d}") for d in range(len(ext))]
        conds = list(conds)
        if self.lg.lane_blocked(out_sp):
            nd = len(ext)
            idx = [f"i0 * {bh} + {p[0]}"] + p[1:nd - 1] + [f"j * {bw} + {p[nd - 1]}"]
            conds += [f"i0 * {bh} + {p[0]} < {kg.e0}", f"j * {bw} + {p[nd - 1]} < {kg.e1}"]
            target = f"out[{_horner(idx, ext)}]"
        elif self.lg.streamed(out_sp):
            conds.append(f"i0 * {bh} + {p[0]} < {kg.e0}")
            target = f"out[i0 * {bh * math.prod(ext[1:])} + {e}]"
        else:
            target = f"out[{e}]"
        st = f"{target} = {v};"
        return [f"if ({' && '.join(conds)}) {st}" if conds else st]

    @staticmethod
    def tile_coords(ot: OutputTile, shape: Sequence[int], rag_o: bool, rag_i: bool,
                    base: str = "") -> List[str]:
        """A thread's element coordinates in a panel of ``shape``, from its
        ``ob`` and ``cb``: for each row ``t`` of its tile, ``o<t>`` (``ob +
        groups * t``) and the panel coordinates ``p<q>_<t>`` of that position;
        for each column ``u``, ``c<u>`` (``cb + lanes * u``) and the innermost
        coordinate ``p<n - 1>_<u>``, ``base`` more.  Where the tile overshoots
        the positions (``rag_o``) or the innermost axis (``rag_i``), an
        element past the panel takes the last one's coordinates."""
        n = len(shape)
        out: List[str] = []
        for t in range(ot.rows):
            out.append(f"const int o{t} = ob + {ot.groups * t};")
            oc = f"min(o{t}, {ot.outer - 1})" if rag_o else f"o{t}"
            inner_ext = 1
            for q in range(n - 2, -1, -1):
                div = f"{oc} / {inner_ext}" if inner_ext > 1 else oc
                if shape[q] == 1:
                    val = "0"
                elif q == 0:
                    val = div
                else:
                    val = f"({div}) % {shape[q]}"
                out.append(f"const int p{q}_{t} = {val};")
                inner_ext *= shape[q]
        for u in range(ot.cols):
            out.append(f"const int c{u} = cb + {ot.lanes * u};")
            out.append(f"const int p{n - 1}_{u} = {base}"
                       + (f"min(c{u}, {ot.inner - 1});" if rag_i else f"c{u};"))
        return out

    def tiled_output(self) -> List[str]:
        """The output panel in register tiles (``output_tile``): each
        thread's ``rows`` x ``cols`` programs by ``tile_program``, or a
        panel-staged weight's chain by ``panel_chain``."""
        lg, ot = self.lg, self.tile
        out_sp = self.kg.output
        shape = lg.panel_shape(out_sp)
        n = len(shape)
        ops = lg.programs[(out_sp.name, 0, 0)]
        rt = ot.register_tile(n)
        io = _TileIO(self.tap, self.bounds, self.tile_checks)
        pn = self.kg.panels
        # passes over the outer positions and over the innermost axis (a
        # panel group's tile covers its panel in as few as it can; any
        # other group's threads loop until the panel is covered)
        p_o = -(-ot.outer // (ot.groups * ot.rows))
        p_i = -(-ot.inner // (ot.lanes * ot.cols))
        rag_o = p_o * ot.groups * ot.rows != ot.outer
        rag_i = p_i * ot.lanes * ot.cols != ot.inner
        body = self.tile_coords(ot, shape, rag_o, rag_i)
        self.rng = self.block_ranges(shape)
        lines, vals = (self.tile_program if pn is None else self.panel_chain)(rt, io, ops)
        body += lines
        for (t, u), v in zip(rt.elems, vals):
            conds = ([f"o{t} < {ot.outer}"] if rag_o else []) + (
                [f"c{u} < {ot.inner}"] if rag_i else [])
            body += self.out_store(conds, rt.sub(t, u), f"o{t} * {ot.inner} + c{u}", v)
        if pn is not None:
            # every thread runs every pass, to the panels' barriers
            ob = f"threadIdx.x / {ot.lanes}"
            cb = f"threadIdx.x % {ot.lanes}"
            if p_o > 1:
                ob += f" + pass / {p_i} * {ot.groups * ot.rows}"
            if p_i > 1:
                cb += f" + pass % {p_i} * {ot.lanes * ot.cols}"
            return ([f"for (int pass = 0; pass < {p_o * p_i}; ++pass) {{",
                     f"  const int ob = {ob};", f"  const int cb = {cb};"]
                    + _indent(body) + ["}"])
        loops = [
            f"for (int ob = threadIdx.x / {ot.lanes}; ob < {ot.outer}; "
            f"ob += {ot.groups * ot.rows}) {{",
            f"  for (int cb = threadIdx.x % {ot.lanes}; cb < {ot.inner}; "
            f"cb += {ot.lanes * ot.cols}) {{",
        ] + _indent(_indent(body)) + ["  }", "}"]
        if ot.groups * ot.lanes < self.nt:
            return [f"if (threadIdx.x < {ot.groups * ot.lanes}) {{"] + _indent(loops) + ["}"]
        return loops

    def panel_chain(self, rt: RegisterTile, io: _TileIO,
                    ops: Sequence[Op]) -> Tuple[List[str], List[str]]:
        """``tile_program`` for a group whose weight is staged in panels
        (``KernelGroup.panels``): the reduction chain's head, then for each
        panel ``kc`` in turn the panel's copy between two barriers and the
        chain's terms over it, one loop over ``r`` of the panel's ``block``
        reduction steps; the sums stay in ``ch<o>_<i>`` across the panels,
        each element's terms added in the chain's order; then, on a padded
        grid, the mask of the tail rows.  The chain must be one run of
        terms over the whole reduction, the run ``tile_program`` would
        roll."""
        pn = self.kg.panels
        k = len(ops) - 1
        masked = ops[k][0] == "mask" and ops[k][1] == k - 1
        chain = _chain(ops[:k] if masked else ops)
        if chain is None:
            raise EmitError("a panel-staged weight outside a reduction's chain",
                            kernel=self.kg.name)
        runs = _chain_runs(ops, chain, io.checks)
        if len(runs) != 1 or len(runs[0][0]) != pn.extent or pn.extent < 2:
            raise EmitError(
                f"the chain's runs of {[len(terms) for terms, _s in runs]} terms are not one "
                f"run over the {pn.extent} steps of the panel-staged reduction",
                kernel=self.kg.name)
        ((terms, step),) = runs
        dep = self.tile_deps(rt, ops)
        term = self.tile_term(rt, io, ops, *terms[0], dep, step, pn.extent,
                              {"r": f"(kc * {pn.block} + r)"})
        b, st = next((b, st) for b, st in self.staged.items() if st.panel is not None)
        lines = (self.tile_head(rt, io, ops, chain[0], dep)
                 + [f"for (int kc = 0; kc < {pn.count}; ++kc) {{", "  __syncthreads();"]
                 + _indent(self.copy(b, st)) + ["  __syncthreads();",
                                                f"  #pragma unroll {ROLL_UNROLL}",
                                                f"  for (int r = 0; r < {pn.block}; ++r) {{"]
                 + _indent(_indent(term)) + ["  }", "}"])
        if not masked:
            return lines, [f"ch{o}_{i}" for o, i in rt.elems]
        lines += self.tile_op(rt, io, k, ops[k], dep, chained=k - 1)
        return lines, [rt.name(k, dep[k], o, i) for o, i in rt.elems]

    def tile_checks(self, op: Op) -> List[bool]:
        """Which bounds of a staged load some element of the panel can
        fail (a global load and a mask keep all theirs)."""
        if op[0] == "tap" and op[1].kind == "view" and \
                self.lg.slot_of[self.kg.groups[op[1].src].buffer] in self.staged:
            return [_span(ax, self.rng)[1] >= lim for ax, lim in op[1].bounds]
        return []

    def source(self) -> str:
        lg, kg = self.lg, self.kg
        t = self.tag
        nb = max(len(lg.buffer_order), 1)
        R = self.max_rank
        out_tile = math.prod(kg.output.nstage.pure_extents)
        lines = [
            f"// kernel group {kg.name!r}: stages {kg.stage_names}, bh={kg.bh}, "
            f"bw={kg.bw}, grid={kg.grid}, rings={len(kg.rings)}, "
            f"line buffers={list(kg.line_buffered)}, "
            f"red_grid={kg.red_grid is not None}, "
            f"padded={kg.padded_grid is not None}, smem={self.smem} B",
        ]
        if self.em is not None:
            em = self.em
            lines.append(
                f"// element-parallel: thread axis {em.thread_axis}, tile {em.tile} along "
                f"{em.tile_axis}, work axes {list(em.axes)}, {em.work} work items in "
                f"{em.blocks} blocks of {em.threads} per slot"
                + (f"; run {em.run} of {em.extent} positions, {em.lanes} lanes apart; "
                   f"a block holds one value of {list(em.chunk)}, staged "
                   f"{[st.buffer for st in em.staged]}" if em.tiled else "")
            )
        if self.tile is not None or self.staged:
            ot = self.tile
            lines.append(
                f"// carries nothing: staged {[(st.buffer, st.strides) for st in self.staged.values()]}"
                + (f", {kg.panels.count} panels of {kg.panels.block}" if kg.panels else "")
                + (f", hidden chain {list(kg.chain.hidden)} -> {kg.chain.consumer}: "
                   f"{kg.chain.count} panels of {kg.chain.block}, hidden tile "
                   f"{kg.chain.tile[0]} x {kg.chain.tile[1]}, consumer tile "
                   f"{chain_tile(lg).rows} x {chain_tile(lg).cols}, panels reused "
                   f"{list(kg.chain.reuse)}" if kg.chain else "")
                + (f", output tile {ot.rows} x {ot.cols} a thread, {ot.lanes} lanes along the "
                   f"innermost axis, {ot.groups} groups" if ot is not None else "")
            )
        # a window-attention group's parameters carry its mark, which the
        # profiler's kernel name shows
        params = f"UbWindowParams{t}" if kg.window is not None else f"UbParams{t}"
        # a window tile's block asks for registers that leave room for a
        # second block an SM (its fully written maximum would take all)
        bounds = f"{self.nt}, {WINDOW_BLOCKS}" if kg.window is not None else f"{self.nt}"
        if kg.window is not None:
            wa = kg.window
            lines.append(
                f"// window attention: score tile {wa.score!r} and statistics {list(wa.stats)} "
                f"in shared memory, {kg.bh} head(s) a block, {wa.windows} windows of "
                f"{wa.keys} keys a head, {wa.masked} masked"
            )
        lines += [
            f"struct {params} {{",
            f"  const float* in[{nb}];",
            "  float* out;",
            f"  int dims[{nb}][{R}];",
            "};",
            "",
            f"__global__ void __launch_bounds__({bounds}) ub_kernel_{t}(const {params} P) {{",
            "  extern __shared__ float ub_smem[];",
            "  const int slot = blockIdx.y;",
        ]
        for b, rank in enumerate(self.ranks):
            for j in range(rank):
                lines.append(f"  const int D{b}_{j} = P.dims[{b}][{j}];")
            size = " * ".join(f"(long long)D{b}_{j}" for j in range(rank))
            lines.append(
                f"  const float* __restrict__ g{b} = P.in[{b}] + (long long)slot * {size};"
            )
        lines.append(
            f"  float* __restrict__ out = P.out + (long long)slot * {out_tile}LL;"
        )
        for si, off in enumerate(self.s_off):
            lines.append(f"  float* const s{si} = ub_smem + {off};  // {self.s_shapes[si]}")
        for r, off in enumerate(self.r_off):
            lines.append(f"  float* const r{r} = ub_smem + {off};  // {self.r_shapes[r]}")
        for b, st in self.staged.items():
            lines.append(f"  float* const w{b} = ub_smem + {st.offset};  // {st.buffer} "
                         f"{st.extents}, strides {st.strides}")
        em = self.em
        if em is not None:
            for st in em.staged:
                lines.append(f"  float* const w{st.slot} = ub_smem + {st.offset};  // {st.buffer} "
                             f"dims {st.dims} from {st.lo} over {st.extents}, then "
                             f"{st.entries} of dim {st.tile_dim}")
            lines += ["  " + ln for ln in self.ep_kernel()]
            body = []
        elif lg.row_carried:
            bands = row_bands(lg)
            length = bands[0][1]
            lines += [
                f"  const int band_begin = blockIdx.x * {length};",
                f"  const int band_end = blockIdx.x == {len(bands) - 1} ? {lg.steps} "
                f": band_begin + {length};",
                "  for (int i0 = band_begin; i0 < band_end; ++i0) {",
            ]
        elif lg.lane_carried:
            lines.append("  const int i0 = blockIdx.x;")
            lines.append(f"  for (int j = 0; j < {lg.lane_steps}; ++j) {{")
        elif lg.lane:
            lines.append(f"  const int i0 = blockIdx.x / {lg.lane_steps};")
            lines.append(f"  const int j = blockIdx.x % {lg.lane_steps};")
            lines.append("  {")
        else:
            lines.append("  const int i0 = blockIdx.x;")
            lines.append("  {")
        if em is None:
            body = (self.lane_step()[0] if lg.lane_carried else
                    self.chain_step() if kg.chain is not None else self.step())
        lines += ["    " + ln for ln in body]
        lines += ["  }", "}", ""]
        lines += [
            f'extern "C" int ub_launch_{t}(const void* const* in, void* out, '
            "const long long* dims, void* stream) {",
            f"  {params} p;",
            f"  for (int b = 0; b < {nb}; ++b) {{",
            f"    p.in[b] = b < {len(lg.buffer_order)} ? (const float*)in[b] : nullptr;",
            f"    for (int a = 0; a < {R}; ++a) p.dims[b][a] = (int)dims[b * {R} + a];",
            "  }",
            "  p.out = (float*)out;",
            f"  cudaError_t err = cudaFuncSetAttribute(ub_kernel_{t}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, {self.smem});",
            "  if (err != cudaSuccess) return (int)err;",
            f"  ub_kernel_{t}<<<dim3({grid_x(lg)}, {kg.batch_steps}), {self.nt}, "
            f"{self.smem}, (cudaStream_t)stream>>>(p);",
            "  return (int)cudaGetLastError();",
            "}",
            "",
            "// the blocks of this kernel an SM of the current card holds at once",
            f'extern "C" int ub_occupancy_{t}(int* blocks_per_sm) {{',
            f"  cudaError_t err = cudaFuncSetAttribute(ub_kernel_{t}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, {self.smem});",
            "  if (err != cudaSuccess) return (int)err;",
            f"  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, "
            f"ub_kernel_{t}, {self.nt}, {self.smem});",
            "}",
            "",
        ]
        return "\n".join(lines)


def emit_kernel(kg: KernelGroup, tag: str = "0", lowered: Optional[LoweredGroup] = None) -> str:
    """CUDA C++ for one kernel group: a ``__global__`` kernel, its
    ``extern "C"`` launcher ``ub_launch_<tag>`` and its occupancy query
    ``ub_occupancy_<tag>``.  Deterministic in the plan.
    Raises :class:`EmitError` for a plan the port cannot run
    (``eager.check_supported``) or a scratch footprint over the H100's
    shared memory per block."""
    lg = lowered if lowered is not None else LoweredGroup(kg)
    return _GroupEmitter(lg, tag).source()


_PREAMBLE = """// Generated by repro_torch.backend.cuda_codegen; do not edit.
#include "ub_kernel.cuh"

extern "C" const char* ub_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

"""


def emit_library(lowered: Sequence[LoweredGroup]) -> str:
    """One ``.cu`` source holding every group of a pipeline (group ``i``
    launches through ``ub_launch_<i>``), so a pipeline builds with one
    ``nvcc`` call."""
    return _PREAMBLE + "\n".join(
        emit_kernel(lg.kg, str(i), lg) for i, lg in enumerate(lowered)
    )


def output_shape(kg: KernelGroup) -> Tuple[int, ...]:
    """The launch's output: the group's output extents, after the batch
    slots when batched."""
    ext = tuple(kg.output.nstage.pure_extents)
    return ((kg.batch_steps,) + ext) if kg.batch_grid is not None else ext


def launch_dims(lg: LoweredGroup, ts: Sequence[torch.Tensor]) -> List[int]:
    """The launcher's ``dims``: each buffer's per-tile extents (after the
    batch dim when batched), padded with 1 to the group's largest rank."""
    kg = lg.kg
    lead = 1 if kg.batch_grid is not None else 0
    rank = max((g.ndim for g in kg.groups), default=1)
    dims: List[int] = []
    for t in ts:
        ext = list(t.shape[lead:])
        if math.prod(ext) >= 2 ** 31:
            raise ValueError(f"kernel {kg.name!r}: tile of {ext} exceeds int32 indexing")
        dims += ext + [1] * (rank - len(ext))
    return dims


class CudaKernel(GroupKernel):
    """The wrapper of one generated CUDA kernel.

    It takes CUDA tensors only: it launches the kernel on the current
    stream and counts the launch in ``launches``; a refused launch raises
    :class:`EmitError`, and tensors on any other device raise
    ``ValueError`` (the plain version, ``plain``, is an
    :class:`~repro_torch.backend.eager.EagerKernel` that callers on the
    CPU ask for by name, ``kernels="eager"``)."""

    def __init__(self, lg: LoweredGroup, lib: ctypes.CDLL, tag: str):
        super().__init__(lg)
        self.plain = EagerKernel(lg)
        self.launches = 0
        fn = getattr(lib, f"ub_launch_{tag}")
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        self._fn = fn
        self._lib, self._tag = lib, tag
        self._err = lib.ub_error_string
        self._err.argtypes = [ctypes.c_int]
        self._err.restype = ctypes.c_char_p

    def blocks_per_sm(self) -> int:
        """The blocks of this kernel an SM of the current card holds at
        once, by the CUDA runtime's occupancy calculator on the kernel as
        built (its threads, registers and shared memory)."""
        fn = getattr(self._lib, f"ub_occupancy_{self._tag}")
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        n = ctypes.c_int()
        rc = fn(ctypes.byref(n))
        if rc != 0:
            raise EmitError(f"occupancy query failed: {self._err(rc).decode()} (cudaError {rc})",
                            kernel=self.kg.name)
        return n.value

    def __call__(self, buffers: Mapping[str, torch.Tensor]) -> torch.Tensor:
        lg, kg = self.lg, self.kg
        kg.validate_buffers(buffers)
        ts = [buffers[b] for b in lg.buffer_order]
        devs = {t.device for t in ts}
        if len(devs) != 1:
            raise ValueError(f"kernel {kg.name!r}: buffers on several devices {devs}")
        dev = devs.pop()
        if dev.type != "cuda":
            raise ValueError(
                f"kernel {kg.name!r}: the CUDA kernel takes CUDA tensors, got "
                f"{dev}; use kernels='eager' for the plain version on the CPU"
            )
        for b, t in zip(lg.buffer_order, ts):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(
                    f"kernel {kg.name!r}: buffer {b!r} must be a contiguous "
                    f"float32 tensor, got {t.dtype} contiguous={t.is_contiguous()}"
                )
        record_eval_sites(self)
        dims = launch_dims(lg, ts)
        out = torch.empty(output_shape(kg), dtype=torch.float32, device=dev)
        ptrs = (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])
        cdims = (ctypes.c_longlong * max(len(dims), 1))(*dims)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(ptrs, out.data_ptr(), cdims, stream)
        if rc != 0:
            raise EmitError(
                f"launch refused: {self._err(rc).decode()} (cudaError {rc})",
                kernel=kg.name,
            )
        self.launches += 1
        return out


__all__ = [
    "CudaKernel",
    "ElementMap",
    "OutputTile",
    "REPLACES",
    "StagedInput",
    "block_threads",
    "carries_nothing",
    "chain_tile",
    "hidden_tile",
    "element_map",
    "emit_kernel",
    "emit_library",
    "grid_x",
    "lane_layout",
    "launch_dims",
    "output_shape",
    "output_tile",
    "row_bands",
    "shared_bytes",
    "shift_panels",
    "smem_layout",
    "staged_inputs",
]
