"""Seeded fault injection on the port's serving stack, on the CPU.

Replays ``tests/test_faults.py`` on ``repro_torch.backend.faults`` with
``device="cpu", kernels="eager"``: every injected fault — NaN/Inf inputs, a
marked tile whose outputs are poisoned, a kernel raise at dispatch N or on
a marked tile, a poisoned plan-cache entry, a slow dispatch, a full queue —
either fully recovers (every healthy request bit-equal to the per-tile
pipeline) or fails closed with its named class from ``backend.errors``,
across the serving compositions of the JAX suite (batched, ragged final
dispatch, lane grids, carried line buffers, lane x carry).  The schedule
database cases replay ``corrupt_schedule_db`` in its four modes, a
truncated file on disk, malformed rows and the db warnings' stack levels
through ``compile_pipeline(tune=...)``; the recovery ladder's heuristic
rung compiles with the db off.  One case poisons a tile on the card
(``gpu``).
"""

import os
import warnings

import numpy as np
import pytest
import torch

from conftest import SWEEP_SEED, sweep_inputs
from repro_torch.apps import make_app
from repro_torch.backend import (
    DeadlineExceededError,
    DegradedModeWarning,
    LaneCarryDegradeWarning,
    MissingInputError,
    NonFiniteInputError,
    PipelineServer,
    PoisonedTileError,
    QueueFullError,
    RequestError,
    ScheduleDBCorruptWarning,
    TunedModeMismatchWarning,
    clear_pipeline_cache,
    compile_pipeline,
    drop_pipeline_cache_entry,
    pipeline_cache_stats,
)
from repro_torch.backend import runner
from repro_torch.backend.autotune import ScheduleDB, lookup_schedule
from repro_torch.backend.autotune import search as autotune_search
from repro_torch.backend.faults import (
    DB_CORRUPTIONS,
    POISON_MARKER,
    FaultClock,
    InjectedFault,
    _marked_slots,
    corrupt_schedule_db,
    kernel_raise,
    mark_poison,
    nan_input,
    poison_cache_entry,
    poison_output,
    slow_dispatch,
)
from repro_torch.backend.runner import schedule_db_key

pytestmark = pytest.mark.torch

CPU = dict(device="cpu", kernels="eager")


def _tiles(app, n, seed=SWEEP_SEED):
    return [sweep_inputs(app, seed + i, "u4") for i in range(n)]


def _assert_bit_exact(req, tile, ref_pp, out_name):
    assert req.ok, f"expected ok, got error: {req.error}"
    assert np.array_equal(req.outputs[out_name], ref_pp.run(tile)[out_name].cpu().numpy())


# ---------------------------------------------------------------------------
# Admission validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_nonfinite_input_rejected_at_submit(kind):
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=4, block_h=4, **CPU)
    tiles = _tiles(app, 8)
    bad = nan_input(tiles, frac=0.25, seed=3, kind=kind)
    assert bad, "injector must poison at least one tile"
    accepted, rejected = [], []
    for i, t in enumerate(tiles):
        try:
            accepted.append((i, srv.submit(t)))
        except NonFiniteInputError as e:
            assert e.code == "REQ-NONFINITE"
            assert "[REQ-NONFINITE]" in str(e) and "first at" in str(e)
            assert isinstance(e, ValueError)
            rejected.append(i)
    assert rejected == bad
    while srv.pending:
        srv.step()
    ref = compile_pipeline(app.pipeline, block_h=4, **CPU)
    out = app.pipeline.output
    for i, req in accepted:
        _assert_bit_exact(req, tiles[i], ref, out)
    s = srv.stats()
    assert s["validation_rejects"] == len(bad)
    assert s["poisoned_tiles"] == 0 and s["quarantine_dispatches"] == 0


def test_submit_rejects_bad_dtype_by_name():
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=2, block_h=4, **CPU)
    shape = tuple(app.pipeline.buffer_boxes["input"].extents)
    for bad in (
        np.full(shape, "x", dtype="<U4"),
        np.zeros(shape, np.complex64),
        np.zeros(shape, "datetime64[s]"),
    ):
        with pytest.raises(RequestError, match="expected float32") as ei:
            srv.submit({"input": bad})
        assert ei.value.code == "REQ"
        assert str(bad.dtype) in str(ei.value)
        assert isinstance(ei.value, ValueError)
    with pytest.raises(MissingInputError, match="missing input") as ei:
        srv.submit({})
    assert ei.value.code == "REQ-MISSING"
    assert isinstance(ei.value, KeyError)
    assert srv.stats()["validation_rejects"] == 4
    assert srv.stats()["pending"] == 0


# ---------------------------------------------------------------------------
# Quarantine bisection
# ---------------------------------------------------------------------------

QUARANTINE_CASES = [
    pytest.param(("gaussian", dict(size=13)), dict(block_h=4), 4, 6, [1], id="batched"),
    pytest.param(("gaussian", dict(size=13)), dict(block_h=4), 4, 6, [5],
                 id="ragged-final-dispatch"),
    pytest.param(("gaussian", dict(size=21)), dict(block_w=8), 3, 4, [0], id="lane-blocked"),
    pytest.param(("unsharp", dict(size=15)), dict(fuse=True, block_h=5, line_buffer=True),
                 3, 5, [2], id="carried-line-buffer"),
    pytest.param(("harris", dict(schedule="sch3", size=20)), dict(block_w=8, line_buffer=True),
                 3, 4, [1, 3], id="lane-carry-rings-two-poisoned"),
]


@pytest.mark.parametrize("mk, ckw, slots, n, marks", QUARANTINE_CASES)
def test_quarantine_isolates_poison_bit_exact(mk, ckw, slots, n, marks):
    name, kwargs = mk
    app = make_app(name, **kwargs)
    srv = PipelineServer(app.pipeline, batch_slots=slots, **CPU, **ckw)
    tiles = _tiles(app, n)
    for i in marks:
        mark_poison(tiles[i])
    with poison_output(srv):
        done = srv.run(tiles)
    assert "_run_pipeline" not in srv.__dict__
    ref = compile_pipeline(app.pipeline, **CPU, **ckw)
    out = app.pipeline.output
    for i, (req, tile) in enumerate(zip(done, tiles)):
        if i in marks:
            assert req.done and not req.ok and req.outputs is None
            assert isinstance(req.error, PoisonedTileError)
            assert req.error.code == "REQ-POISONED"
            assert "dispatched alone" in str(req.error)
        else:
            _assert_bit_exact(req, tile, ref, out)
    s = srv.stats()
    assert s["poisoned_tiles"] == len(marks)
    assert s["quarantine_dispatches"] >= 1
    assert s["failed"] == len(marks)
    redo = srv.run([tiles[i] for i in marks])
    for i, req in zip(marks, redo):
        _assert_bit_exact(req, tiles[i], ref, out)


def test_poison_output_splats_marked_slots_of_a_clone():
    """The injector finds the marked slots where the inputs lie and splats
    NaN (or Inf) over those slots of a clone of each output: the real
    output is untouched and every other slot keeps its bytes."""
    app = make_app("camera", size=6)
    srv = PipelineServer(app.pipeline, batch_slots=3, **CPU)
    tiles = _tiles(app, 3)
    mark_poison(tiles[1])
    ins = {n: torch.from_numpy(np.stack([t[n] for t in tiles])) for n in app.pipeline.inputs}
    assert _marked_slots(ins) == [1]
    real = srv.pipeline.run(ins)
    kept = {k.name: real[k.name].clone() for k in srv.pipeline.kernels}
    for kind, val in (("nan", np.nan), ("inf", np.inf)):
        with poison_output(srv, kind=kind):
            got = srv._run_pipeline(srv.pipeline, ins)
        for k in srv.pipeline.kernels:
            g = got[k.name].numpy()
            assert np.array_equal(g[1], np.full_like(g[1], val), equal_nan=True)
            assert np.array_equal(g[[0, 2]], kept[k.name].numpy()[[0, 2]])
            assert torch.equal(real[k.name], kept[k.name])
    assert POISON_MARKER == np.float32(2.0 ** 60)


def test_nan_admitted_under_shape_validation_is_quarantined():
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=4, block_h=4, validate="shape", **CPU)
    tiles = _tiles(app, 4)
    bad = nan_input(tiles, frac=0.3, seed=7)
    done = srv.run(tiles)
    ref = compile_pipeline(app.pipeline, block_h=4, **CPU)
    out = app.pipeline.output
    for i, (req, tile) in enumerate(zip(done, tiles)):
        if i in bad:
            assert isinstance(req.error, PoisonedTileError)
            assert "non-finite" in str(req.error)
        else:
            _assert_bit_exact(req, tile, ref, out)
    assert srv.stats()["validation_rejects"] == 0
    assert srv.stats()["poisoned_tiles"] == len(bad)


# ---------------------------------------------------------------------------
# The non-finite guard: a sum clears an input, a device flag a slot, and the
# full scan runs only to name the witness
# ---------------------------------------------------------------------------

GUARD_DTYPES = [np.float16, np.float32, np.float64]
GUARD_KINDS = {"nan": (np.nan, np.nan), "+inf": (np.inf,), "-inf": (-np.inf,),
               "+inf-inf": (np.inf, -np.inf)}


def _layout(tile, dtype, layout):
    """``tile`` cast to ``dtype`` in the memory layout a caller might hand
    over: contiguous, a strided or a transposed view, a view with negative
    strides, or read-only (the last two are views torch cannot take)."""
    a = np.asarray(tile, dtype)
    if layout == "strided":
        big = np.zeros((2 * a.shape[0], 3 * a.shape[1]), dtype)
        big[::2, ::3] = a
        a = big[::2, ::3]
    elif layout == "transposed":
        a = np.ascontiguousarray(a.T).T
    elif layout == "reversed":
        a = a[::-1].copy()[::-1]
    return a


@pytest.mark.parametrize("layout", ["contiguous", "strided", "transposed", "reversed", "read-only"])
@pytest.mark.parametrize("kind", list(GUARD_KINDS))
@pytest.mark.parametrize("dtype,size", [
    (np.float16, 13), (np.float32, 13), (np.float64, 13), (np.float32, 1040), (np.float64, 1040),
], ids=["float16", "float32", "float64", "float32-pooled", "float64-pooled"])
def test_nonfinite_input_rejected_with_the_full_scans_witness(dtype, size, kind, layout):
    """NaN, +Inf, -Inf, and +Inf with -Inf in one input (whose sum is NaN)
    are rejected at submit with the count, first index and message of the
    full ``np.isfinite`` scan, in every dtype and layout, summed on the
    calling thread or (from ``_POOLED_SUM_BYTES`` up, where torch can view
    the array) by torch's threads; the sum that could not clear the input
    is counted."""
    app = make_app("gaussian", size=size)
    srv = PipelineServer(app.pipeline, batch_slots=4, block_h=4, **CPU)
    arr = _layout(_tiles(app, 1)[0]["input"], dtype, layout)
    rng = np.random.default_rng(11)
    for v, flat in zip(GUARD_KINDS[kind], rng.choice(arr.size, 2, replace=False)):
        arr[np.unravel_index(int(flat), arr.shape)] = v
    if layout == "read-only":
        arr.flags.writeable = False
    finite = np.isfinite(arr)
    bad = int(arr.size - finite.sum())
    first = tuple(int(i) for i in np.unravel_index(int(np.argmin(finite)), arr.shape))
    with pytest.raises(NonFiniteInputError) as ei:
        srv.submit({"input": arr})
    assert (f"input 'input': {bad} non-finite value(s) (first at {first}); rejecting "
            f"at submit so the poison never enters a batched dispatch") in str(ei.value)
    assert ei.value.witness == first and ei.value.stage == "input"
    s = srv.stats()
    assert s["validation_rejects"] == 1 and s["pending"] == 0
    assert s["finite_full_scans"] == 1


@pytest.mark.parametrize("dtype,value,read_only,scans", [
    (np.float32, 3e38, False, 1),
    (np.float32, 3e38, True, 1),
    (np.float64, 1e308, False, 1),
    (np.float16, 65504.0, False, 0),
], ids=["f32", "f32-read-only", "f64", "f16-summed-in-f32"])
def test_finite_input_whose_sum_overflows_is_admitted(dtype, value, read_only, scans):
    """An input of finite values whose sum overflows is scanned in full,
    found finite and admitted, with no warning; f16 is summed in f32,
    where its largest values cannot overflow."""
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=4, block_h=4, **CPU)
    arr = np.full(app.input_extents["input"], value, dtype)
    arr.flags.writeable = not read_only
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        req = srv.submit({"input": arr})
    s = srv.stats()
    assert s["pending"] == 1 and s["validation_rejects"] == 0
    assert s["finite_full_scans"] == scans
    assert not req.done


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8, np.bool_],
                         ids=lambda d: np.dtype(d).name)
def test_integer_inputs_are_not_scanned(dtype, monkeypatch):
    """Integer and bool inputs are finite by type: neither the sum nor the
    full scan runs, and they serve bit for bit as their f32 values."""
    from repro_torch.backend import serve_bridge

    def never(a):
        raise AssertionError("an integer input was scanned")

    monkeypatch.setattr(serve_bridge, "_sum_is_finite", never)
    monkeypatch.setattr(serve_bridge, "_nonfinite", never)
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=4, block_h=4, **CPU)
    tiles = [{"input": np.asarray(t["input"] % 2 if dtype is np.bool_ else t["input"], dtype)}
             for t in _tiles(app, 5)]
    done = srv.run(tiles)
    ref = compile_pipeline(app.pipeline, block_h=4, **CPU)
    for req, tile in zip(done, tiles):
        _assert_bit_exact(req, {"input": tile["input"].astype(np.float32)}, ref, "gaussian")
    assert srv.stats()["finite_full_scans"] == 0


@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("mk, slots, n, mark", [
    (("gaussian", dict(size=13)), 4, 4, 1),
    (("camera", dict(size=6)), 3, 3, 2),
], ids=["gaussian", "camera-two-kernels"])
def test_flagged_slot_bisects_to_the_marked_tile_with_its_witness(kind, mk, slots, n, mark):
    """A marked tile's outputs splatted with NaN or Inf raise its slot's
    device flag; bisection fails it closed with the host search's witness
    (its first kernel's output, first at the origin) and serves the rest
    bit for bit.  The flag is raised on each of the four dispatches that
    hold the tile: the batch, quarantine's whole batch, the half, the tile
    alone."""
    name, kwargs = mk
    app = make_app(name, **kwargs)
    srv = PipelineServer(app.pipeline, batch_slots=slots, **CPU)
    tiles = _tiles(app, n)
    mark_poison(tiles[mark])
    with poison_output(srv, kind=kind):
        done = srv.run(tiles)
    ref = compile_pipeline(app.pipeline, **CPU)
    first_kernel = ref.kernels[0].name
    origin = (0,) * ref.run(tiles[0])[first_kernel].ndim
    for i, (req, tile) in enumerate(zip(done, tiles)):
        if i == mark:
            assert isinstance(req.error, PoisonedTileError)
            assert (f"output {first_kernel!r} is non-finite even dispatched alone (first "
                    f"at {origin}); the fault travels with the tile") in str(req.error)
            assert req.error.witness == origin and req.error.kernel == first_kernel
        else:
            _assert_bit_exact(req, tile, ref, app.pipeline.output)
    s = srv.stats()
    assert s["poisoned_tiles"] == 1 and s["flagged_slots"] == 4
    assert s["finite_full_scans"] == 0


@pytest.mark.parametrize("mk", [("gaussian", dict(size=13)), ("camera", dict(size=6))],
                         ids=["gaussian", "camera-two-kernels"])
def test_large_finite_outputs_are_not_quarantined(mk):
    """Outputs of 1e37 are finite though each slot's sum overflows f32:
    the device flag is exact, so nothing is flagged or quarantined and
    every tile serves bit for bit (the inputs' sums overflow too, so
    admission scans each in full and admits it)."""
    name, kwargs = mk
    app = make_app(name, **kwargs)
    srv = PipelineServer(app.pipeline, batch_slots=3, **CPU)
    tiles = [{n: np.full(s, 1e37, np.float32) for n, s in app.input_extents.items()}
             for _ in range(4)]
    done = srv.run(tiles)
    ref = compile_pipeline(app.pipeline, **CPU)
    for req, tile in zip(done, tiles):
        _assert_bit_exact(req, tile, ref, app.pipeline.output)
    with np.errstate(over="ignore"):
        assert not all(np.isfinite(a.sum()) for a in done[0].outputs.values())
    s = srv.stats()
    assert s["flagged_slots"] == 0 and s["quarantine_dispatches"] == 0
    assert s["finite_full_scans"] == len(tiles) * len(app.input_extents)


@pytest.mark.parametrize("kind", list(GUARD_KINDS))
@pytest.mark.parametrize("dtype", GUARD_DTYPES, ids=lambda d: np.dtype(d).name)
def test_guard_helpers_against_the_elementwise_scan(dtype, kind):
    """Planted at every index of an array whose length is no multiple of a
    vector's, the values of ``kind`` keep numpy's sum from clearing the
    array, and each slot's device flag equals ``np.isfinite(...).all()`` of
    that slot; planted at the ends, the middle and the tail of an array of
    ``_POOLED_SUM_BYTES`` and more, they keep torch's pooled sum (and numpy's,
    read-only) from clearing it."""
    from repro_torch.backend.serve_bridge import (
        _POOLED_SUM_BYTES, _finite_slots, _nonfinite, _sum_is_finite,
    )

    rng = np.random.default_rng(5)
    vals = GUARD_KINDS[kind]

    def planted(clean, i):
        a = clean.copy()
        spots = {(i + 17 * k) % a.size for k in range(len(vals))}
        for k, v in enumerate(vals):
            a.flat[(i + 17 * k) % a.size] = v
        return a, spots

    clean = rng.uniform(-4, 4, (3, 67)).astype(dtype)
    assert _sum_is_finite(clean) and _nonfinite(clean) is None
    assert _finite_slots(torch.from_numpy(clean)).tolist() == [True] * 3
    for i in range(clean.size):
        a, spots = planted(clean, i)
        assert not _sum_is_finite(a)
        want = [bool(np.isfinite(a[b]).all()) for b in range(a.shape[0])]
        assert _finite_slots(torch.from_numpy(a)).tolist() == want
        assert _nonfinite(a) == (len(spots), np.unravel_index(min(spots), a.shape))

    n = _POOLED_SUM_BYTES // np.dtype(dtype).itemsize + 67
    big = rng.uniform(-4, 4, n).astype(dtype)
    assert _sum_is_finite(big)
    for i in (0, 1, n // 2, n - 67, n - 1):
        a, _ = planted(big, i)
        assert not _sum_is_finite(a)
        a.flags.writeable = False
        assert not _sum_is_finite(a)


# ---------------------------------------------------------------------------
# Retry-with-recompile ladder
# ---------------------------------------------------------------------------


def test_transient_kernel_raise_recovers_bit_exact():
    app = make_app("gaussian", size=13)
    ckw = dict(block_h=4)
    srv = PipelineServer(app.pipeline, batch_slots=4, **CPU, **ckw)
    tiles = _tiles(app, 6)
    with kernel_raise(srv, at_dispatch=1):
        with pytest.warns(DegradedModeWarning, match="recovered"):
            done = srv.run(tiles)
    assert "_run_pipeline" not in srv.__dict__
    ref = compile_pipeline(app.pipeline, **CPU, **ckw)
    out = app.pipeline.output
    for req, tile in zip(done, tiles):
        _assert_bit_exact(req, tile, ref, out)
    s = srv.stats()
    assert s["dispatch_failures"] == 1
    assert s["recompiles"] == 1
    assert s["degraded_dispatches"] == 1
    assert s["quarantine_dispatches"] == 0 and s["poisoned_tiles"] == 0


def test_kernel_raise_takes_exactly_one_trigger():
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=2, block_h=4, **CPU)
    for kw in ({}, {"at_dispatch": 1, "on_marker": True}):
        with pytest.raises(ValueError, match="exactly one"):
            with kernel_raise(srv, **kw):
                pass
    assert "_run_pipeline" not in srv.__dict__


def test_recovery_ladder_reaches_heuristic_schedule():
    app = make_app("matmul", m=16, n=16, k=16)
    srv = PipelineServer(app.pipeline, batch_slots=2, block_h=4, **CPU)
    tiles = _tiles(app, 2)
    real = srv._run_pipeline
    calls = {"n": 0}

    def flaky(pp, ins):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise InjectedFault(f"flaky dispatch {calls['n']}")
        return real(pp, ins)

    srv._run_pipeline = flaky
    try:
        with pytest.warns(DegradedModeWarning, match="heuristic"):
            done = srv.run(tiles)
    finally:
        del srv.__dict__["_run_pipeline"]
    s = srv.stats()
    assert s["dispatch_failures"] == 1 and s["recompiles"] == 2
    assert s["degraded_dispatches"] == 1
    for req, tile in zip(done, tiles):
        assert req.ok
        want = tile["A"].astype(np.float64) @ tile["B"].astype(np.float64)
        assert np.array_equal(req.outputs["matmul"].astype(np.float64), want)


def test_poisoned_cache_entry_recovers():
    app = make_app("gaussian", size=13)
    ckw = dict(block_h=4)
    srv = PipelineServer(app.pipeline, batch_slots=3, **CPU, **ckw)
    broken = srv.pipeline
    tiles = _tiles(app, 5)
    with poison_cache_entry(broken):
        with pytest.raises(InjectedFault):
            broken.run(tiles[0])
        with pytest.warns(DegradedModeWarning, match="recovered"):
            done = srv.run(tiles)
    assert "run" not in broken.__dict__
    assert srv.pipeline is not broken
    assert srv.stats()["recompiles"] >= 1
    ref = compile_pipeline(app.pipeline, **CPU, **ckw)
    out = app.pipeline.output
    for req, tile in zip(done, tiles):
        _assert_bit_exact(req, tile, ref, out)


def test_marker_raise_isolated_by_bisection():
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=4, block_h=4, **CPU)
    tiles = _tiles(app, 4)
    mark_poison(tiles[2])
    with kernel_raise(srv, on_marker=True):
        done = srv.run(tiles)
    ref = compile_pipeline(app.pipeline, block_h=4, **CPU)
    out = app.pipeline.output
    for i, (req, tile) in enumerate(zip(done, tiles)):
        if i == 2:
            assert isinstance(req.error, PoisonedTileError)
            assert "dispatched alone" in str(req.error)
        else:
            _assert_bit_exact(req, tile, ref, out)
    s = srv.stats()
    assert s["dispatch_failures"] == 1 and s["recompiles"] == 2
    assert s["degraded_dispatches"] == 0
    assert s["poisoned_tiles"] == 1 and s["quarantine_dispatches"] >= 1


# ---------------------------------------------------------------------------
# Deadlines and backpressure
# ---------------------------------------------------------------------------


def test_deadline_expires_in_queue():
    app = make_app("gaussian", size=13)
    clock = FaultClock()
    srv = PipelineServer(app.pipeline, batch_slots=2, block_h=4, clock=clock, **CPU)
    tiles = _tiles(app, 3)
    late = srv.submit(tiles[0], deadline=5.0)
    ok1 = srv.submit(tiles[1], deadline=50.0)
    ok2 = srv.submit(tiles[2])
    clock.advance(10.0)
    finished = srv.step()
    assert late in finished and late.outputs is None
    assert isinstance(late.error, DeadlineExceededError)
    assert late.error.code == "REQ-DEADLINE"
    assert "expired in queue" in str(late.error)
    while srv.pending:
        srv.step()
    assert ok1.ok and ok2.ok
    assert srv.stats()["deadline_misses"] == 1


def test_slow_dispatch_discards_late_results():
    app = make_app("gaussian", size=13)
    clock = FaultClock()
    srv = PipelineServer(app.pipeline, batch_slots=2, block_h=4, clock=clock,
                         default_deadline=5.0, **CPU)
    tiles = _tiles(app, 2)
    tight = srv.submit(tiles[0])
    roomy = srv.submit(tiles[1], deadline=100.0)
    with slow_dispatch(srv, clock, dispatch_s=10.0):
        srv.step()
    assert tight.done and not tight.ok and tight.outputs is None
    assert isinstance(tight.error, DeadlineExceededError)
    assert "late results are discarded" in str(tight.error)
    assert roomy.ok
    assert srv.stats()["deadline_misses"] == 1


def test_backpressure_reject_and_block():
    app = make_app("gaussian", size=13)
    tiles = _tiles(app, 4)
    srv = PipelineServer(app.pipeline, batch_slots=2, block_h=4, max_pending=2,
                         admission="reject", **CPU)
    srv.submit(tiles[0])
    srv.submit(tiles[1])
    with pytest.raises(QueueFullError, match="max_pending=2") as ei:
        srv.submit(tiles[2])
    assert ei.value.code == "SERVE-QUEUE-FULL"
    assert ei.value.witness == (2, 2)
    assert srv.stats()["backpressure_rejects"] == 1
    srv.step()
    srv.submit(tiles[2])

    blk = PipelineServer(app.pipeline, batch_slots=2, block_h=4, max_pending=2,
                         admission="block", **CPU)
    reqs = [blk.submit(t) for t in tiles]
    assert len(blk.pending) <= 2
    while blk.pending:
        blk.step()
    assert all(r.ok for r in reqs)
    assert blk.stats()["backpressure_rejects"] == 0


# ---------------------------------------------------------------------------
# Every named warning points at the caller
# ---------------------------------------------------------------------------


def _only(record, category):
    msgs = [w for w in record if issubclass(w.category, category)]
    assert msgs, f"no {category.__name__} raised"
    return msgs


def test_warning_stacklevels_point_at_caller():
    """The port's named warnings (those without a schedule database) name
    this file, the caller's, not a frame inside the backend."""
    me = os.path.basename(__file__)
    app = make_app("gaussian", size=13)
    wide = make_app("gaussian", size=24, width=40)
    with pytest.warns(LaneCarryDegradeWarning) as rec:  # stacklevel=3
        compile_pipeline(wide.pipeline, block_w=1, line_buffer=True, **CPU)
    assert all(os.path.basename(w.filename) == me for w in _only(rec, LaneCarryDegradeWarning))

    srv = PipelineServer(app.pipeline, batch_slots=2, block_h=4, **CPU)
    with kernel_raise(srv, at_dispatch=1):
        with pytest.warns(DegradedModeWarning) as rec:  # stacklevel=4
            srv.run(_tiles(app, 2))
    assert all(os.path.basename(w.filename) == me for w in _only(rec, DegradedModeWarning))


def test_schedule_db_warning_stacklevels_point_at_caller(tmp_path):
    """The schedule database's two warnings, replayed from the JAX
    test_warning_stacklevels_point_at_caller: a corrupt db through
    ``lookup_schedule`` and through ``compile_pipeline(tune=...)``, and a
    row measured otherwise, each name this file."""
    me = os.path.basename(__file__)
    app = make_app("gaussian", size=13)
    bad = str(tmp_path / "bad_db.json")
    with open(bad, "w") as f:
        f.write("not json")
    with pytest.warns(ScheduleDBCorruptWarning) as rec:
        lookup_schedule(app.pipeline, {}, db=bad)
    assert all(os.path.basename(w.filename) == me for w in _only(rec, ScheduleDBCorruptWarning))
    with pytest.warns(ScheduleDBCorruptWarning) as rec:
        compile_pipeline(app.pipeline, tune=bad, **CPU)
    assert all(os.path.basename(w.filename) == me for w in _only(rec, ScheduleDBCorruptWarning))

    tuned = str(tmp_path / "mode_db.json")
    ScheduleDB(
        path=tuned,
        entries={schedule_db_key(app.pipeline, {}): {"schedule": {}, "mode": "cuda"}},
    ).save()
    with pytest.warns(TunedModeMismatchWarning) as rec:
        compile_pipeline(app.pipeline, tune=tuned, **CPU)
    assert all(os.path.basename(w.filename) == me for w in _only(rec, TunedModeMismatchWarning))


# ---------------------------------------------------------------------------
# Schedule-db corruption: tune=... degrades, never raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", DB_CORRUPTIONS)
def test_schedule_db_corruption_degrades_and_round_trips(tmp_path, mode):
    """Every corruption mode: the tuned compile degrades to the heuristic
    schedule with a named ``ScheduleDBCorruptWarning`` (bit for bit with a
    plain heuristic compile), and once the bytes are restored the stored
    winner serves again warning-free."""
    app = make_app("gaussian", size=13)
    path = str(tmp_path / "schedule_db.json")
    res = autotune_search(app.pipeline, label="g13", db=path, measure=False, **CPU)
    assert lookup_schedule(app.pipeline, {}, db=path) == res.schedule
    ins = sweep_inputs(app, SWEEP_SEED)
    out = app.pipeline.output
    with corrupt_schedule_db(path, mode):
        with pytest.warns(ScheduleDBCorruptWarning):
            assert lookup_schedule(app.pipeline, {}, db=path) is None
        with pytest.warns(ScheduleDBCorruptWarning, match="heuristic"):
            pp = compile_pipeline(app.pipeline, tune=path, **CPU)
        heur = compile_pipeline(app.pipeline, **CPU)
        assert torch.equal(pp.run(ins)[out], heur.run(ins)[out])
    with warnings.catch_warnings():
        warnings.simplefilter("error", ScheduleDBCorruptWarning)
        assert lookup_schedule(app.pipeline, {}, db=path) == res.schedule
        compile_pipeline(app.pipeline, tune=path, **CPU)


def test_truncated_db_on_disk_round_trip(tmp_path):
    """A truncated db loads strict as the original error, non-strict as an
    empty db with the reason recorded, and a fresh ``search`` rewrites it
    into a servable db again."""
    app = make_app("gaussian", size=13)
    path = str(tmp_path / "schedule_db.json")
    autotune_search(app.pipeline, label="g13", db=path, measure=False, **CPU)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError):
        ScheduleDB.load(path)
    db = ScheduleDB.load(path, strict=False)
    assert db.entries == {} and db.corrupt and "JSONDecodeError" in db.corrupt
    with pytest.warns(ScheduleDBCorruptWarning, match="rewriting"):
        res = autotune_search(app.pipeline, label="g13", db=path, measure=False, **CPU)
    assert lookup_schedule(app.pipeline, {}, db=path) == res.schedule


def test_malformed_rows_degrade_by_name(tmp_path):
    """Unknown ``row_version``, non-tunable schedule keys, a row that is not
    an object and a row without a schedule each degrade to a miss with the
    reason in the warning."""
    app = make_app("gaussian", size=13)
    key = schedule_db_key(app.pipeline, {})
    for row, reason in [
        ({"schedule": {"block_h": 4}, "row_version": 99}, "row_version"),
        ({"schedule": {"warp_speed": 9}}, "non-tunable"),
        ("not an object", "not an object"),
        ({"measurements": []}, "no 'schedule'"),
    ]:
        path = str(tmp_path / f"db_{reason[:4].strip()}.json")
        ScheduleDB(path=path, entries={key: row}).save()
        with pytest.warns(ScheduleDBCorruptWarning, match=reason):
            assert lookup_schedule(app.pipeline, {}, db=path) is None


def test_heuristic_rung_turns_the_db_off(tmp_path):
    """A server compiled with a stored schedule (``tune=``) reaches the
    ladder's heuristic rung: that recompile plans the heuristic schedule,
    not the stored one, and warns nothing about the db."""
    app = make_app("gaussian", size=13)
    path = str(tmp_path / "db.json")
    ScheduleDB(path=path, entries={
        schedule_db_key(app.pipeline, {"batch": 2, "batch_capacity": 2}): {
            "schedule": {"block_h": 2}, "mode": "eager", "device": "cpu",
        },
    }).save()
    srv = PipelineServer(app.pipeline, batch_slots=2, tune=path, **CPU)
    assert srv.pipeline.kernels[0].bh == 2
    heur_bh = compile_pipeline(app.pipeline, batch=2, batch_capacity=2, **CPU).kernels[0].bh
    assert heur_bh != 2
    tiles = _tiles(app, 2)
    real = srv._run_pipeline
    calls = {"n": 0}

    def flaky(pp, ins):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise InjectedFault(f"flaky dispatch {calls['n']}")
        return real(pp, ins)

    srv._run_pipeline = flaky
    try:
        with pytest.warns(DegradedModeWarning, match="heuristic"):
            done = srv.run(tiles)
    finally:
        del srv.__dict__["_run_pipeline"]
    assert srv.stats()["degraded_dispatches"] == 1
    assert srv.pipeline.kernels[0].bh == heur_bh
    ref = compile_pipeline(app.pipeline, **CPU)
    for req, tile in zip(done, tiles):
        _assert_bit_exact(req, tile, ref, app.pipeline.output)


# ---------------------------------------------------------------------------
# Cache-stats counters under eviction and clear with live servers
# ---------------------------------------------------------------------------


def test_cache_stats_across_eviction_and_clear(monkeypatch):
    clear_pipeline_cache(reset_stats=True)
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=2, block_h=4, **CPU)
    assert pipeline_cache_stats() == {"hits": 0, "misses": 1, "evictions": 0, "entries": 1}

    monkeypatch.setattr(runner, "_PIPELINE_CACHE_MAX", 1)
    compile_pipeline(app.pipeline, block_h=2, cache=True, **CPU)
    compile_pipeline(app.pipeline, block_h=8, cache=True, **CPU)
    assert pipeline_cache_stats() == {"hits": 0, "misses": 3, "evictions": 2, "entries": 1}
    assert drop_pipeline_cache_entry(srv.pipeline.cache_key) is False
    assert pipeline_cache_stats()["evictions"] == 2

    tiles = _tiles(app, 3)
    done = srv.run(tiles)
    ref = compile_pipeline(app.pipeline, block_h=4, **CPU)
    out = app.pipeline.output
    for req, tile in zip(done, tiles):
        _assert_bit_exact(req, tile, ref, out)
    s2 = pipeline_cache_stats()
    assert s2["misses"] == 3 and s2["hits"] == 0

    clear_pipeline_cache(reset_stats=False)
    assert pipeline_cache_stats() == {"hits": 0, "misses": 3, "evictions": 2, "entries": 0}
    done2 = srv.run(_tiles(app, 2, seed=SWEEP_SEED + 9))
    assert all(r.ok for r in done2)
    assert pipeline_cache_stats()["misses"] == 3
    clear_pipeline_cache(reset_stats=True)
    assert pipeline_cache_stats() == {"hits": 0, "misses": 0, "evictions": 0, "entries": 0}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_poisoned_tile_quarantined_on_card():
    """The marked tile's outputs are poisoned on the device by the CUDA
    kernels' own server; bisection fails it closed and every other tile is
    bit for bit the per-tile pipeline's, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=4, block_h=4)
    tiles = _tiles(app, 6)
    mark_poison(tiles[2])
    with poison_output(srv):
        done = srv.run(tiles)
    ref = compile_pipeline(app.pipeline, block_h=4)
    out = app.pipeline.output
    for i, (req, tile) in enumerate(zip(done, tiles)):
        if i == 2:
            assert isinstance(req.error, PoisonedTileError)
        else:
            _assert_bit_exact(req, tile, ref, out)
    assert srv.stats()["poisoned_tiles"] == 1


@pytest.mark.gpu
def test_pinned_staging_on_card_through_raises_and_ragged_subsets():
    """On the card the staging is pinned and its copies run asynchronously:
    a marker raise after the copies in, the ladder's recompiles and
    quarantine's ragged subsets all reuse the one staging set, and every
    clean tile is bit for bit the per-tile pipeline's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    app = make_app("gaussian", size=13)
    srv = PipelineServer(app.pipeline, batch_slots=4, block_h=4)
    tiles = _tiles(app, 7)
    mark_poison(tiles[5])
    with kernel_raise(srv, on_marker=True):
        done = srv.run(tiles)
    ref = compile_pipeline(app.pipeline, block_h=4)
    out = app.pipeline.output
    for i, (req, tile) in enumerate(zip(done, tiles)):
        if i == 5:
            assert isinstance(req.error, PoisonedTileError)
        else:
            _assert_bit_exact(req, tile, ref, out)
    (st,) = srv._staging.values()
    assert all(t.is_pinned() for t in (*st.host.values(), *st.out.values()))
    s = srv.stats()
    assert s["staging_allocs"] == 1 and s["recompiles"] == 2
    assert s["poisoned_tiles"] == 1
