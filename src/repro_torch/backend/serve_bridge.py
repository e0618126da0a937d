"""Continuous-batching serve bridge for compiled batched pipelines (port).

A :class:`PipelineServer` owns one pipeline compiled at full slot capacity
(``batch = batch_capacity = batch_slots``, so every service step reuses the
same cached kernels), queues :class:`TileRequest`\\ s, and each ``step()``
packs up to ``batch_slots`` pending tiles into a single batched dispatch:
one kernel launch per kernel group instead of one per tile.  Each shape
keeps its transfer buffers for the server's life (:class:`_Staging`, pinned
on a CUDA device): a dispatch casts its live tiles into their slots of the
host buffer, copies those slots in with one copy per input name, and
copies those slots of each kernel's output back with one copy per kernel,
into arrays the requests then own.

Raggedness is handled by the serve layer, not the kernel: a short batch
runs at capacity with its filler slots zeroed on the device on every
dispatch, and their outputs are never copied back, so a valid slot's
result is the per-tile pipeline's, bit for bit.

One server can juggle several tile shapes: :meth:`PipelineServer.register`
adds another pipeline to a per-shape dispatch table, ``submit`` routes each
request to its registered shape, and ``step`` dispatches the longest
same-shape run at the head of the FIFO queue, so drain order is preserved.

Fault tolerance, as in the JAX package's serve bridge: every failure
surfaces as a named class from :mod:`backend.errors`, and no fault in one
request can corrupt another's result — admission validation
(:class:`MissingInputError`, :class:`RequestError`,
:class:`NonFiniteInputError`), backpressure (:class:`QueueFullError`),
deadlines (:class:`DeadlineExceededError`), a retry-with-recompile ladder
(:class:`DegradedModeWarning`) and quarantine by bisection
(:class:`PoisonedTileError`).  ``stats()`` reports the serving counters,
the per-fault-class counters and the pipeline-cache counters in one dict.

The non-finite guard decides "all finite" without a host array the size of
a tile: admission clears a float input by one sum of it, and each dispatch
flags its live slots' outputs on the device before they are copied back.
The full host scan (``np.isfinite``) runs only where the sum or a flag
could not clear the data, to confirm it and to name the witness.
"""

from __future__ import annotations

import itertools
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import (
    Callable,
    Deque,
    Dict,
    List,
    Mapping,
    Optional,
    Tuple,
    Union,
)

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.frontend.lower import Pipeline

from .errors import (
    BackendError,
    DeadlineExceededError,
    DegradedModeWarning,
    MissingInputError,
    NonFiniteInputError,
    PoisonedTileError,
    QueueFullError,
    RequestError,
)
from .runner import (
    TUNABLE_KEYS,
    TorchPipeline,
    compile_pipeline,
    drop_pipeline_cache_entry,
    pipeline_cache_stats,
)

# dtypes a tile may arrive in: anything real-numeric casts losslessly
# enough to the pipelines' f32 element type; everything else (object,
# strings, complex, datetimes) would surface as a deep conversion error at
# drain time and is rejected at submit instead
_NUMERIC_KINDS = frozenset("fiub")

_request_ids = itertools.count()


# -- the non-finite guard: nothing non-finite is admitted or returned ------

# from this many bytes up, torch's intra-op threads sum an input faster than
# the calling thread alone: on an 8-core H100 host, waking them costs ~0.4 ms
# and one thread sums ~5 GB/s (a 16.8 MB frame 0.7 against 3.1 ms, a 1 MB
# request 0.46 against 0.30 ms)
_POOLED_SUM_BYTES = 1 << 22


def _sum_is_finite(a: np.ndarray) -> bool:
    """Whether one sum of ``a``, which builds no temporary its size, is
    finite.  NaN and ±Inf reach the sum, so a finite sum proves every value
    finite; a non-finite one may still be finite values whose sum overflows
    (f16 is summed in f32, so only f32 and wider can)."""
    # torch views no read-only array
    if a.nbytes >= _POOLED_SUM_BYTES and a.flags.writeable:
        try:
            t = torch.from_numpy(a)
        except (TypeError, ValueError):     # a dtype or strides torch cannot view
            pass
        else:
            return bool(t.sum(dtype=torch.promote_types(t.dtype, torch.float32)).isfinite())
    with np.errstate(over="ignore", invalid="ignore"):
        return bool(np.isfinite(
            np.add.reduce(a, axis=None, dtype=np.promote_types(a.dtype, np.float32))
        ))


def _nonfinite(a: np.ndarray) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """The full host scan, for the witness: the count of ``a``'s non-finite
    values and the index of the first, or None where every value is
    finite."""
    finite = np.isfinite(a)
    if finite.all():
        return None
    first = tuple(int(i) for i in np.unravel_index(int(np.argmin(finite)), a.shape))
    return int(a.size - int(finite.sum())), first


def _finite_slots(x: torch.Tensor) -> torch.Tensor:
    """One exact flag per leading slot of ``x``, on its device: True where
    every value of the slot is finite."""
    return torch.isfinite(x).reshape(len(x), -1).all(1)


@dataclass
class TileRequest:
    """One tile of work: per-tile input arrays in, per-tile outputs out.

    ``done`` flips once the request leaves the system — successfully
    (``outputs`` set, ``error`` None) or failed closed (``outputs`` None,
    ``error`` a named :class:`~repro_torch.backend.errors.BackendError`).
    ``deadline`` is an absolute server-clock time; ``None`` means no
    deadline.  ``rid`` is unique in the process; the spans of
    :mod:`repro_torch.telemetry` name a request by it."""

    inputs: Dict[str, np.ndarray]
    outputs: Optional[Dict[str, np.ndarray]] = None
    done: bool = False
    error: Optional[BackendError] = None
    deadline: Optional[float] = None
    submitted_at: Optional[float] = None
    rid: int = field(default_factory=_request_ids.__next__, compare=False)
    # ``time.time_ns()`` at admission, kept only while spans record
    queued_ns: Optional[int] = field(default=None, repr=False, compare=False)

    @property
    def ok(self) -> bool:
        """Completed successfully (serviced and not failed)."""
        return self.done and self.error is None


def _fault_counter_zeros() -> Dict[str, int]:
    return {
        "validation_rejects": 0,       # submit() refused the request
        "backpressure_rejects": 0,     # QueueFullError under admission=reject
        "deadline_misses": 0,          # expired in queue or completed late
        "dispatch_failures": 0,        # a batched dispatch raised
        "recompiles": 0,               # recovery-ladder recompiles
        "degraded_dispatches": 0,      # dispatches served off the ladder
        "quarantine_dispatches": 0,    # bisection probe dispatches
        "poisoned_tiles": 0,           # requests failed as poisoned
    }


class _Staging:
    """One dispatch-table entry's transfer buffers, kept for the server's
    life: a host buffer and a device tensor per input name, each
    ``[slots, *tile]`` f32, a host buffer per kernel output, made on its
    first copy back, and a host flag a slot.  On a CUDA device the host
    buffers are pinned, so the copies run asynchronously to the host; on
    the CPU they are plain tensors and the same steps run in order."""

    def __init__(self, pipe: Pipeline, slots: int, device: torch.device) -> None:
        self.device = device
        self.pinned = device.type == "cuda"
        self.host = {
            n: torch.empty(
                (slots, *PipelineServer._tile_shape(pipe, n)),
                dtype=torch.float32, pin_memory=self.pinned,
            )
            for n in pipe.inputs
        }
        self.views = {n: t.numpy() for n, t in self.host.items()}
        self.dev = {n: torch.empty_like(t, device=device) for n, t in self.host.items()}
        self.out: Dict[str, torch.Tensor] = {}
        self.finite = torch.empty(slots, dtype=torch.bool, pin_memory=self.pinned)
        # recorded after each dispatch's copies in: the host buffers are
        # rewritten only once it has passed, raise or no raise in between
        self._h2d: Optional[torch.cuda.Event] = None

    def stage(self, reqs: List[TileRequest]) -> None:
        """Cast each live request's inputs into its slot of the host
        buffers (``np.asarray(x, np.float32)``'s values)."""
        if self._h2d is not None:
            self._h2d.synchronize()
            self._h2d = None
        for n, view in self.views.items():
            for b, req in enumerate(reqs):
                np.copyto(view[b], req.inputs[n], casting="unsafe")

    def to_device(self, n_live: int) -> Dict[str, torch.Tensor]:
        """Copy the live slots in and zero the filler slots on the device,
        so no slot carries one dispatch's data into the next."""
        for n, host in self.host.items():
            dev = self.dev[n]
            dev[:n_live].copy_(host[:n_live], non_blocking=True)
            dev[n_live:].zero_()
        if self.pinned:
            self._h2d = torch.cuda.Event()
            self._h2d.record(torch.cuda.current_stream(self.device))
        return dict(self.dev)

    def from_device(
        self, bufs: Mapping[str, torch.Tensor], names: List[str], n_live: int
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Flag on the device each live slot whose named buffers are all
        finite, copy the flags and the live slots of each named buffer
        back, wait for them (and so for the dispatch's kernels), and return
        fresh host arrays — a request's outputs never alias a buffer the
        next dispatch reuses — and the flags."""
        finite = _finite_slots(bufs[names[0]][:n_live])
        for name in names[1:]:
            finite &= _finite_slots(bufs[name][:n_live])
        for name in names:
            buf = bufs[name]
            out = self.out.get(name)
            if out is None:
                out = self.out[name] = torch.empty(
                    buf.shape, dtype=buf.dtype, pin_memory=self.pinned
                )
            out[:n_live].copy_(buf[:n_live], non_blocking=True)
        self.finite[:n_live].copy_(finite, non_blocking=True)
        if self.pinned:
            torch.cuda.current_stream(self.device).synchronize()
        outs = {name: self.out[name][:n_live].numpy().copy() for name in names}
        return outs, self.finite[:n_live].numpy().copy()


class PipelineServer:
    """Fixed-slot batched pipeline execution (continuous-batching lite).

    Submit tiles with :meth:`submit`; :meth:`step` services one batch —
    up to ``batch_slots`` pending requests in a single batched pipeline
    dispatch — and :meth:`run` drains the queue.  Completed requests carry
    ``outputs`` (one array per pipeline kernel) and ``done=True``; a
    request that failed carries a named ``error`` instead (see the module
    docstring for the full fault-tolerance contract).

    :meth:`register` adds further pipelines (other tile shapes) to the
    server's per-shape dispatch table; ``submit`` routes each request by
    its input tile shapes and rejects anything unregistered.  ``step``
    always dispatches the longest consecutive same-shape run at the head
    of the queue, so completion order stays submission order even under
    mixed-shape traffic.

    ``max_pending`` bounds the queue (``None`` = unbounded);
    ``admission`` picks the full-queue policy (``"reject"`` raises
    :class:`QueueFullError`, ``"block"`` services batches until there is
    room).  ``default_deadline`` (seconds) applies to every request that
    does not carry its own.  ``validate`` controls admission checks:
    ``True`` (default) = shape + dtype + finite values, ``"shape"`` =
    skip only the finite-values guard (poison is then caught by output
    quarantine instead — defense in depth), ``False`` = shape routing
    only.  ``clock`` injects a time source (default
    ``time.monotonic``)."""

    def __init__(
        self,
        pipe: Pipeline,
        batch_slots: int,
        *,
        max_pending: Optional[int] = None,
        admission: str = "reject",
        default_deadline: Optional[float] = None,
        validate: object = True,
        clock: Optional[Callable[[], float]] = None,
        **compile_kwargs,
    ) -> None:
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if admission not in ("reject", "block"):
            raise ValueError(
                f"admission must be 'reject' or 'block', got {admission!r}"
            )
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if validate not in (True, False, "shape"):
            raise ValueError(
                f"validate must be True, False, or 'shape': {validate!r}"
            )
        self.pipe = pipe
        self.batch_slots = batch_slots
        self.max_pending = max_pending
        self.admission = admission
        self.default_deadline = default_deadline
        self.validate = validate
        self._clock = clock if clock is not None else time.monotonic
        # per-shape dispatch table: shape signature -> (pipeline source,
        # compiled full-capacity batched pipeline, its compile kwargs —
        # kept so the recovery ladder can recompile the same problem)
        self._table: Dict[
            Tuple, Tuple[Pipeline, TorchPipeline, Dict]
        ] = {}
        # per shape signature: the transfer buffers, made on its first
        # dispatch and dropped when the shape is registered again
        self._staging: Dict[Tuple, _Staging] = {}
        self.staging_allocs = 0
        self.filler_slots = 0
        # the non-finite guard's counts of where it engaged: inputs the sum
        # could not clear, live slots whose device flag was raised
        self.finite_full_scans = 0
        self.flagged_slots = 0
        telemetry.add("serve.finite_full_scans", 0)
        telemetry.add("serve.flagged_slots", 0)
        self.pipeline: TorchPipeline = self.register(pipe, **compile_kwargs)
        self.pending: Deque[Tuple[Tuple, TileRequest]] = deque()
        self.served = 0
        self.failed = 0
        self.dispatches = 0
        self.fault_counters: Dict[str, int] = _fault_counter_zeros()

    # -- request lifecycle --------------------------------------------------

    @staticmethod
    def _tile_shape(pipe: Pipeline, name: str) -> tuple:
        return tuple(pipe.buffer_boxes[name].extents)

    @classmethod
    def _shape_key(cls, pipe: Pipeline) -> Tuple:
        """A pipeline's serving signature: its sorted (input, shape) pairs."""
        return tuple(sorted(
            (n, cls._tile_shape(pipe, n)) for n in pipe.inputs
        ))

    def register(self, pipe: Pipeline, **compile_kwargs) -> TorchPipeline:
        """Add ``pipe`` (another tile shape of the serving contract) to the
        dispatch table, compiled at full slot capacity.  Returns the
        compiled pipeline; the batch-keyed plan cache (on by default) makes
        re-registering a shape — here or on another server — a cache hit
        instead of a recompile."""
        # full-capacity plan: ragged service steps pad to capacity instead
        # of recompiling at a smaller batch, so the warm path is one cache
        # hit per dispatch
        compile_kwargs.setdefault("cache", True)
        pp = compile_pipeline(
            pipe,
            batch=self.batch_slots,
            batch_capacity=self.batch_slots,
            **compile_kwargs,
        )
        key = self._shape_key(pipe)
        self._table[key] = (pipe, pp, dict(compile_kwargs))
        self._staging.pop(key, None)
        return pp

    def _validate_request(self, req: TileRequest) -> Tuple:
        """Admission checks; returns the routed shape key or raises a
        named :class:`RequestError` subclass.  Nothing invalid is ever
        queued, so a bad request can only fail itself."""
        for n in self.pipe.inputs:
            if n not in req.inputs:
                raise MissingInputError(
                    f"request is missing input {n!r}; the pipeline requires "
                    f"{sorted(self.pipe.inputs)}",
                    stage=n,
                )
        if self.validate is False:
            return self._route(req)
        arrs = [(n, np.asarray(req.inputs[n])) for n in sorted(self.pipe.inputs)]
        for n, arr in arrs:
            if arr.dtype.kind not in _NUMERIC_KINDS:
                raise RequestError(
                    f"input {n!r}: dtype {arr.dtype} is not castable to "
                    f"the pipeline element type; expected float32 (or "
                    f"any real numeric dtype), got {arr.dtype}",
                    stage=n,
                )
        key = self._route(req)
        if self.validate is True:
            # integer inputs are finite by type; a float input is cleared by
            # one sum, and scanned in full only where the sum is not finite
            for n, arr in arrs:
                if arr.dtype.kind != "f" or _sum_is_finite(arr):
                    continue
                self.finite_full_scans += 1
                telemetry.add("serve.finite_full_scans", 1)
                found = _nonfinite(arr)
                if found is not None:
                    bad, first = found
                    raise NonFiniteInputError(
                        f"input {n!r}: {bad} non-finite value(s) "
                        f"(first at {first}); rejecting at submit so "
                        f"the poison never enters a batched dispatch",
                        stage=n,
                        witness=first,
                    )
        return key

    def _route(self, req: TileRequest) -> Tuple:
        """Dispatch-table routing by input tile shapes."""
        for key, (pipe, _pp, _kw) in self._table.items():
            want = dict(key)
            if all(
                n in req.inputs
                and tuple(np.shape(req.inputs[n])) == want[n]
                for n in pipe.inputs
            ):
                return key
        got = {
            n: tuple(np.shape(req.inputs[n]))
            for n in sorted(self.pipe.inputs)
            if n in req.inputs
        }
        raise RequestError(
            f"request input tile shape {got} matches no registered "
            f"pipeline; registered shapes: "
            f"{[dict(k) for k in self._table]}"
        )

    def submit(
        self,
        request: Union[TileRequest, Mapping[str, np.ndarray]],
        *,
        deadline: Optional[float] = None,
    ) -> TileRequest:
        """Queue one tile; returns the (possibly wrapped) request object.
        The request is routed by its input tile shapes; admission
        validation and the bounded-queue policy run first (see the class
        docstring).  ``deadline`` is seconds from now (overrides the
        server's ``default_deadline``)."""
        req = (
            request
            if isinstance(request, TileRequest)
            else TileRequest(inputs=dict(request))
        )
        with telemetry.span("serve.admit", rid=req.rid):
            try:
                key = self._validate_request(req)
            except RequestError:
                self.fault_counters["validation_rejects"] += 1
                raise
        if self.max_pending is not None:
            if self.admission == "reject":
                if len(self.pending) >= self.max_pending:
                    self.fault_counters["backpressure_rejects"] += 1
                    raise QueueFullError(
                        f"queue is full ({len(self.pending)} pending >= "
                        f"max_pending={self.max_pending}); resubmit after a "
                        f"step() or use admission='block'",
                        witness=(len(self.pending), self.max_pending),
                    )
            else:                                # admission == "block"
                while len(self.pending) >= self.max_pending:
                    self.step()
        now = self._clock()
        req.submitted_at = now
        budget = deadline if deadline is not None else self.default_deadline
        if budget is not None:
            req.deadline = now + budget
        self.pending.append((key, req))
        if telemetry.recording():
            req.queued_ns = time.time_ns()
        return req

    # -- dispatch + fault handling ------------------------------------------

    def _run_pipeline(
        self, pp: TorchPipeline, ins: Dict[str, torch.Tensor]
    ) -> Mapping[str, torch.Tensor]:
        """The single seam every batched execution goes through — a
        fault-injection harness wraps this bound method to simulate kernel
        raises, poisoned outputs, and slow dispatches without touching
        kernel code."""
        return pp.run(ins)

    def _dispatch(
        self, key: Tuple, pp: TorchPipeline, reqs: List[TileRequest]
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """One capacity-wide batched execution of ``reqs`` through the
        shape's staging buffers (made on its first dispatch); returns
        per-kernel host arrays of the live slots only, and a flag per live
        slot, True where all its outputs are finite.  Raises whatever the
        kernels raise — fault handling is the caller's (``_service``) job.

        Spans: ``serve.stack`` (the live tiles cast into the host buffers),
        ``serve.h2d`` (the live slots' copies in, the fillers zeroed on the
        device) and ``serve.d2h`` (the slots' finite flags taken on the
        device, the flags' and the live slots' copies out, the wait for the
        dispatch's kernels, the copy into the returned arrays)."""
        st = self._staging.get(key)
        if st is None:
            st = self._staging[key] = _Staging(self._table[key][0], self.batch_slots, pp.device)
            self.staging_allocs += 1
        n_live = len(reqs)
        with telemetry.span("serve.stack"):
            st.stage(reqs)
        with telemetry.span("serve.h2d"):
            ins = st.to_device(n_live)
        self.filler_slots += self.batch_slots - n_live
        bufs = self._run_pipeline(pp, ins)
        self.dispatches += 1
        with telemetry.span("serve.d2h"):
            return st.from_device(bufs, [k.name for k in pp.kernels], n_live)

    def _poisoned_slots(self, finite: np.ndarray) -> List[int]:
        """Live slot indices whose device flag says an output holds NaN/Inf
        (filler slots run on zero inputs and are never flagged)."""
        bad = np.flatnonzero(~finite).tolist()
        if bad:
            self.flagged_slots += len(bad)
            telemetry.add("serve.flagged_slots", len(bad))
        return bad

    def _complete(
        self, reqs: List[TileRequest], outs: Dict[str, np.ndarray]
    ) -> None:
        for b, req in enumerate(reqs):
            req.outputs = {name: a[b] for name, a in outs.items()}
            req.error = None
            req.done = True

    def _fail(self, req: TileRequest, err: BackendError) -> None:
        req.outputs = None
        req.error = err
        req.done = True
        self.failed += 1

    def _recompile(self, key: Tuple, heuristic: bool = False) -> TorchPipeline:
        """Recovery-ladder recompile: drop the (possibly poisoned) cache
        entry first so the fresh compile can never be handed the broken
        pipeline back as a cache hit.  ``heuristic=True`` strips every
        tunable kwarg and disables the schedule db — the most conservative
        plan the heuristic planner produces for this problem."""
        pipe, pp, ckw = self._table[key]
        drop_pipeline_cache_entry(pp.cache_key)
        kw = dict(ckw)
        if heuristic:
            for k in TUNABLE_KEYS:
                kw.pop(k, None)
            kw["tune"] = False
        self.fault_counters["recompiles"] += 1
        fresh = compile_pipeline(
            pipe,
            batch=self.batch_slots,
            batch_capacity=self.batch_slots,
            **kw,
        )
        self._table[key] = (pipe, fresh, ckw)
        if pipe is self.pipe:
            self.pipeline = fresh
        return fresh

    def _quarantine(self, key: Tuple, reqs: List[TileRequest]) -> None:
        """Bisect a failing/poisoned batch down to the poisoned tile(s).

        Every subset is re-dispatched padded to capacity; a clean subset
        completes from *its own clean dispatch* (so healthy tiles are
        bit-exact vs the per-tile pipeline — no value from a poisoned
        dispatch is ever returned), a dirty subset splits and recurses,
        and a single tile that still fails or produces non-finite output
        is failed closed with :class:`PoisonedTileError`."""
        pipe, pp, _kw = self._table[key]
        self.fault_counters["quarantine_dispatches"] += 1
        try:
            outs, finite = self._dispatch(key, pp, reqs)
        except Exception as e:
            if len(reqs) == 1:
                self.fault_counters["poisoned_tiles"] += 1
                self._fail(reqs[0], PoisonedTileError(
                    f"tile fails even dispatched alone "
                    f"({type(e).__name__}: {e})",
                    kernel=pipe.output,
                ))
                return
            mid = len(reqs) // 2
            self._quarantine(key, reqs[:mid])
            self._quarantine(key, reqs[mid:])
            return
        bad = self._poisoned_slots(finite)
        if not bad:
            self._complete(reqs, outs)
            return
        if len(reqs) == 1:
            name, first = self._first_nonfinite(outs, 0)
            self.fault_counters["poisoned_tiles"] += 1
            self._fail(reqs[0], PoisonedTileError(
                f"output {name!r} is non-finite even dispatched alone "
                f"(first at {first}); the fault travels with the tile",
                kernel=name,
                witness=first,
            ))
            return
        mid = len(reqs) // 2
        self._quarantine(key, reqs[:mid])
        self._quarantine(key, reqs[mid:])

    @staticmethod
    def _first_nonfinite(
        outs: Dict[str, np.ndarray], b: int
    ) -> Tuple[str, Tuple[int, ...]]:
        """The host witness search of a flagged slot: its first output that
        holds a non-finite value, and that value's index."""
        for name, arr in outs.items():
            found = _nonfinite(arr[b])
            if found is not None:
                return name, found[1]
        return next(iter(outs)), ()

    def _service(self, key: Tuple, reqs: List[TileRequest]) -> None:
        """Service one same-shape batch with the full recovery ladder:
        dispatch → (on raise) recompile fresh → recompile heuristic →
        quarantine bisection.  On return every request in ``reqs`` is
        ``done`` — completed or failed closed with a named error."""
        pp = self._table[key][1]
        outs: Optional[Dict[str, np.ndarray]] = None
        try:
            outs, finite = self._dispatch(key, pp, reqs)
        except Exception as first_err:
            self.fault_counters["dispatch_failures"] += 1
            for heuristic in (False, True):
                try:
                    fresh = self._recompile(key, heuristic=heuristic)
                    outs, finite = self._dispatch(key, fresh, reqs)
                except Exception:
                    continue
                self.fault_counters["degraded_dispatches"] += 1
                warnings.warn(
                    f"dispatch of {len(reqs)} tile(s) failed "
                    f"({type(first_err).__name__}: {first_err}); recovered "
                    f"after dropping the cache entry and recompiling"
                    + (" on the heuristic schedule" if heuristic else ""),
                    DegradedModeWarning,
                    stacklevel=4,
                )
                break
        if outs is None:
            # ladder exhausted: isolate the poison per tile
            self._quarantine(key, reqs)
            return
        with telemetry.span("serve.scan"):
            poisoned = self._poisoned_slots(finite)
        if poisoned:
            # non-finite output in a live slot: nothing from this dispatch
            # is trustworthy — re-serve every tile from clean bisection
            # dispatches so healthy tiles stay bit-exact
            self._quarantine(key, reqs)
            return
        self._complete(reqs, outs)

    def _expire(self, now: float) -> List[TileRequest]:
        """Fail every queued request whose deadline has passed."""
        expired: List[TileRequest] = []
        if not any(r.deadline is not None for _k, r in self.pending):
            return expired
        keep: Deque[Tuple[Tuple, TileRequest]] = deque()
        for key, req in self.pending:
            if req.deadline is not None and now > req.deadline:
                self.fault_counters["deadline_misses"] += 1
                self._fail(req, DeadlineExceededError(
                    f"deadline expired in queue ({now - req.deadline:.3f}s "
                    f"past; waited {now - (req.submitted_at or now):.3f}s)",
                    witness=(),
                ))
                expired.append(req)
            else:
                keep.append((key, req))
        self.pending = keep
        return expired

    def step(self) -> List[TileRequest]:
        """Service one batch; returns the requests that *left the system*
        this step — completed, failed closed, or expired (empty when the
        queue is empty).  One dispatch serves one shape: the longest
        consecutive same-shape run at the head of the queue (up to
        ``batch_slots``), so mixed-shape traffic completes in submission
        order.

        Spans: ``serve.step`` (the whole call; ``live``, the requests it
        took, and their ``rids``) and, for each request admitted while
        spans recorded, ``serve.queued`` from its admission to this call's
        start, kept only where this call records too: a wait across the
        end of a profiler session would hold the profiler's own stop."""
        with telemetry.span("serve.step", live=0) as sp:
            now = self._clock()
            finished: List[TileRequest] = list(self._expire(now))
            if not self.pending:
                return finished
            key = self.pending[0][0]
            reqs: List[TileRequest] = []
            while (
                self.pending
                and len(reqs) < self.batch_slots
                and self.pending[0][0] == key
            ):
                reqs.append(self.pending.popleft()[1])
            if sp:
                sp.set(live=len(reqs), rids=[r.rid for r in reqs])
            for req in reqs:
                if sp and req.queued_ns is not None:
                    telemetry.record("serve.queued", req.queued_ns, sp.start_ns, rid=req.rid)
                req.queued_ns = None
            self._service(key, reqs)
            # completed-late check: a request whose deadline passed during the
            # dispatch fails closed — its computed outputs are discarded, not
            # returned late as if on time
            end = self._clock()
            for req in reqs:
                if req.ok and req.deadline is not None and end > req.deadline:
                    self.fault_counters["deadline_misses"] += 1
                    self._fail(req, DeadlineExceededError(
                        f"completed {end - req.deadline:.3f}s past the "
                        f"deadline; late results are discarded",
                    ))
            self.served += len(reqs)
            finished.extend(reqs)
            return finished

    def run(
        self, requests: List[Union[TileRequest, Mapping[str, np.ndarray]]]
    ) -> List[TileRequest]:
        """Submit ``requests`` and drain the queue; returns them completed
        (or failed closed), in submission order."""
        out = [self.submit(r) for r in requests]
        while self.pending:
            self.step()
        return out

    # -- observability ------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Serving counters, per-fault-class health counters, plus the
        process-wide pipeline-cache stats (hits/misses/evictions/entries)
        the warm path depends on.  ``staging_allocs`` counts the staging
        sets made (one per registered shape, on its first dispatch),
        ``filler_slots`` the slots zeroed on the device instead of staged
        and copied, ``finite_full_scans`` the float inputs whose sum could
        not clear them at admission (scanned in full), ``flagged_slots``
        the live slots whose device flag sent them to the host witness
        search."""
        return {
            "served": self.served,
            "failed": self.failed,
            "dispatches": self.dispatches,
            "staging_allocs": self.staging_allocs,
            "filler_slots": self.filler_slots,
            "finite_full_scans": self.finite_full_scans,
            "flagged_slots": self.flagged_slots,
            "batch_slots": self.batch_slots,
            "shapes": len(self._table),
            "pending": len(self.pending),
            **self.fault_counters,
            **pipeline_cache_stats(),
        }


__all__ = ["TileRequest", "PipelineServer"]
