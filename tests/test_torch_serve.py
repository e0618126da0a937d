"""The port's ``PipelineServer`` on the CPU, held against the JAX package's.

Tiles are served by the port with ``device="cpu", kernels="eager"`` (the
plain version — the only one the CPU runs).  The contract is the JAX serve
bridge's: ragged drain order is kept, every served tile is bit-exact
against the per-tile port pipeline and against the JAX ``PipelineServer``
on integer inputs, admission errors carry the same named classes, and the
recovery ladder and quarantine behave alike.  The port's own staging
(buffers reused for the server's life, fillers zeroed on the device, only
live slots copied) is held to the same per-tile results, to outputs that
never alias it, and to its two counters.
"""

import contextlib
import warnings

import numpy as np
import pytest

from conftest import SWEEP_SEED, sweep_inputs
from repro.apps.paper_apps import make_app as jax_make_app
from repro.backend import PipelineServer as JaxServer
from repro_torch.apps import make_app
from repro_torch.backend import (
    DegradedModeWarning,
    PipelineServer,
    PoisonedTileError,
    compile_pipeline,
    pipeline_cache_stats,
)
from repro_torch.backend.faults import kernel_raise, mark_poison, poison_output
from repro_torch.serve import pad_to_slots

pytestmark = pytest.mark.torch

CPU = dict(device="cpu", kernels="eager")


def _tiles(app, n, seed=SWEEP_SEED):
    return [sweep_inputs(app, seed + i, "u4") for i in range(n)]


@pytest.mark.parametrize("name,kw,ckw", [
    ("gaussian", {"size": 13}, {"block_h": 4}),
    ("unsharp", {"size": 15}, {"block_h": 5, "line_buffer": True}),
    ("camera", {"size": 6}, {}),
], ids=["gaussian-padded", "unsharp-carried", "camera-two-kernels"])
def test_ragged_drain_bit_exact_vs_port_and_jax(name, kw, ckw):
    """Seven tiles through three slots: three dispatches (3 + 3 + ragged
    1), completions in submission order, every buffer bit-equal to the
    per-tile port pipeline and to the JAX server's."""
    app = make_app(name, **kw)
    srv = PipelineServer(app.pipeline, batch_slots=3, **CPU, **ckw)
    tiles = _tiles(app, 7)
    done = srv.run(tiles)
    assert [r.inputs for r in done] == tiles
    assert all(r.ok for r in done)
    assert srv.dispatches == 3 and srv.served == 7
    jsrv = JaxServer(jax_make_app(name, **kw).pipeline, batch_slots=3, **ckw)
    jdone = jsrv.run(tiles)
    per_tile = compile_pipeline(app.pipeline, **CPU, **ckw)
    for req, jreq, tile in zip(done, jdone, tiles):
        ref = per_tile.run(tile)
        assert set(req.outputs) == {k.name for k in per_tile.kernels}
        for kname, arr in req.outputs.items():
            assert isinstance(arr, np.ndarray)
            assert np.array_equal(arr, ref[kname].numpy())
            assert np.array_equal(arr, np.asarray(jreq.outputs[kname]))


def test_step_returns_finished_in_order():
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=4, **CPU)
    reqs = [srv.submit(t) for t in _tiles(app, 6)]
    first = srv.step()
    assert first == reqs[:4] and all(r.ok for r in first)
    assert not reqs[4].done
    assert srv.step() == reqs[4:]
    assert srv.step() == []


def _admission_errors(server_cls, app, **ckw):
    srv = server_cls(app.pipeline, batch_slots=2, max_pending=1, **ckw)
    good = _tiles(app, 1)[0]
    bad_nan = {"input": good["input"].copy()}
    bad_nan["input"][0, 0] = np.nan
    probes = [
        {},                                              # missing input
        {"input": good["input"].astype(np.complex64)},   # non-real dtype
        {"input": good["input"][1:]},                    # unregistered shape
        bad_nan,                                         # non-finite value
    ]
    names = []
    for p in probes:
        with pytest.raises(Exception) as ei:
            srv.submit(p)
        names.append(type(ei.value).__name__)
    srv.submit(good)
    with pytest.raises(Exception) as ei:
        srv.submit(good)                                 # queue full
    names.append(type(ei.value).__name__)
    return names, srv.stats()


def test_admission_errors_carry_the_same_named_classes():
    app = make_app("gaussian", size=9)
    ours, stats = _admission_errors(PipelineServer, app, **CPU)
    theirs, jstats = _admission_errors(JaxServer, jax_make_app("gaussian", size=9))
    assert ours == theirs == [
        "MissingInputError", "RequestError", "RequestError",
        "NonFiniteInputError", "QueueFullError",
    ]
    for key in ("validation_rejects", "backpressure_rejects"):
        assert stats[key] == jstats[key]


def test_recovery_ladder_recompiles_and_stays_exact():
    """A dispatch that raises once recovers by dropping the cache entry and
    recompiling; the result is still bit-exact."""
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=2, **CPU)
    calls = {"n": 0}
    real = srv._run_pipeline

    def flaky(pp, ins):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected launch failure")
        return real(pp, ins)

    srv._run_pipeline = flaky
    tiles = _tiles(app, 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        done = srv.run(tiles)
    assert any(issubclass(w.category, DegradedModeWarning) for w in caught)
    stats = srv.stats()
    assert stats["dispatch_failures"] == 1 and stats["recompiles"] == 1
    per_tile = compile_pipeline(app.pipeline, **CPU)
    for req, tile in zip(done, tiles):
        assert np.array_equal(req.outputs["gaussian"], per_tile(tile).numpy())


def test_quarantine_isolates_poisoned_tile():
    """A tile whose output is non-finite (validation off) is bisected out
    and failed alone; its batch neighbours complete exactly."""
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=4, validate="shape", **CPU)
    tiles = _tiles(app, 4)
    tiles[2] = {"input": tiles[2]["input"].copy()}
    tiles[2]["input"][3, 3] = np.inf
    done = srv.run(tiles)
    assert isinstance(done[2].error, PoisonedTileError)
    per_tile = compile_pipeline(app.pipeline, **CPU)
    for i in (0, 1, 3):
        assert done[i].ok
        assert np.array_equal(done[i].outputs["gaussian"], per_tile(tiles[i]).numpy())
    assert srv.stats()["poisoned_tiles"] == 1


@pytest.mark.parametrize("dtype", [np.uint8, np.int64], ids=["uint8", "int64"])
@pytest.mark.parametrize("live", range(1, 9))
def test_every_live_count_is_bit_exact_vs_per_tile(live, dtype):
    """After a full dispatch of other data, ``live`` integer tiles through
    eight slots: each is cast into its slot as ``np.asarray(x, float32)``
    would, and comes back bit-equal to the per-tile pipeline."""
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=8, **CPU)
    assert all(r.ok for r in srv.run(_tiles(app, 8, seed=SWEEP_SEED + 100)))
    tiles = [{n: a.astype(dtype) for n, a in t.items()} for t in _tiles(app, live)]
    done = srv.run(tiles)
    per_tile = compile_pipeline(app.pipeline, **CPU)
    for req, tile in zip(done, tiles):
        assert req.ok
        assert np.array_equal(req.outputs["gaussian"], per_tile(tile).numpy())
    assert srv.stats()["filler_slots"] == 8 - live


@pytest.mark.parametrize("later", [1, 3, 8], ids=["then-1", "then-3", "then-8"])
def test_outputs_survive_later_dispatches(later):
    """A request owns its outputs: dispatches of other data through the
    same staging leave them as they were, and they share no memory with
    the staging buffers."""
    app = make_app("camera", size=6)
    srv = PipelineServer(app.pipeline, batch_slots=4, **CPU)
    first = srv.run(_tiles(app, 3))
    kept = [{k: a.copy() for k, a in r.outputs.items()} for r in first]
    for i in range(3):
        srv.run(_tiles(app, later, seed=SWEEP_SEED + 50 + 10 * i))
    (st,) = srv._staging.values()
    staged = [t.numpy() for t in (*st.host.values(), *st.dev.values(), *st.out.values())]
    for req, want in zip(first, kept):
        assert req.outputs.keys() == want.keys()
        for k, a in req.outputs.items():
            assert np.array_equal(a, want[k])
            assert not any(np.shares_memory(a, s) for s in staged)


@pytest.mark.parametrize("inject", [
    lambda srv: kernel_raise(srv, on_marker=True),
    lambda srv: poison_output(srv),
], ids=["kernel-raise", "poison-output"])
def test_filler_slots_are_zeroed_every_dispatch(inject):
    """A marker staged in slot 7 by a full dispatch must not survive into
    the next, ragged dispatch's filler slots: under the marker-driven
    fault, three clean tiles complete from one clean dispatch.  A marked
    tile in a later full dispatch is still failed alone by quarantine."""
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=8, **CPU)
    tiles = _tiles(app, 8)
    mark_poison(tiles[7])
    assert all(r.ok for r in srv.run(tiles))
    per_tile = compile_pipeline(app.pipeline, **CPU)
    with inject(srv):
        clean = _tiles(app, 3, seed=SWEEP_SEED + 40)
        done = srv.run(clean)
        assert all(r.ok for r in done)
        assert srv.stats()["dispatch_failures"] == 0
        assert srv.stats()["quarantine_dispatches"] == 0
        again = _tiles(app, 8, seed=SWEEP_SEED + 60)
        mark_poison(again[5])
        done += srv.run(again)
    clean += again
    for i, (req, tile) in enumerate(zip(done, clean)):
        if i == 3 + 5:
            assert isinstance(req.error, PoisonedTileError)
        else:
            assert req.ok
            assert np.array_equal(req.outputs["gaussian"], per_tile(tile).numpy())
    assert srv.stats()["poisoned_tiles"] == 1


@pytest.mark.parametrize("case,allocs", [
    ("one-shape", 1), ("two-shapes", 2), ("recompiled", 1), ("re-registered", 2),
])
def test_staging_counters(case, allocs):
    """``staging_allocs`` stays at one set per shape across many
    dispatches, recompiles included, and a shape registered again starts
    a fresh set; ``filler_slots`` is the sum of the slots each dispatch
    left empty."""
    app = make_app("gaussian", size=9)
    srv = PipelineServer(app.pipeline, batch_slots=4, **CPU)
    tiles = _tiles(app, 11)
    if case == "two-shapes":
        other = make_app("gaussian", size=11)
        srv.register(other.pipeline, **CPU)
        wide = _tiles(other, 11)
        # runs of 5, 2, 3 and 1 tiles of each shape in turn
        tiles = tiles[:5] + wide[:2] + tiles[5:8] + wide[2:3] + wide[3:9] + tiles[8:]
    for t in tiles:
        srv.submit(t)
    fault = (kernel_raise(srv, at_dispatch=2) if case == "recompiled"
             else contextlib.nullcontext())
    empty = 0
    with fault, warnings.catch_warnings():
        warnings.simplefilter("ignore", DegradedModeWarning)
        while srv.pending:
            empty += 4 - len(srv.step())
            if case == "re-registered" and srv.dispatches == 1:
                srv.register(app.pipeline, **CPU)
    s = srv.stats()
    assert s["served"] == len(tiles) and s["failed"] == 0
    assert s["recompiles"] == (case == "recompiled")
    assert s["staging_allocs"] == allocs
    assert s["shapes"] == (2 if case == "two-shapes" else 1)
    assert s["filler_slots"] == empty


@pytest.mark.parametrize("name,kw,validate", [
    ("gaussian", {"size": 13}, True),
    ("camera", {"size": 6}, True),
    ("gaussian", {"size": 13}, "shape"),
], ids=["gaussian", "camera-two-kernels", "shape-validation"])
def test_clean_traffic_leaves_the_finite_guard_counters_at_zero(name, kw, validate):
    """Clean tiles through full and ragged dispatches: every input's sum
    clears it and no slot's device flag is raised, so ``finite_full_scans``
    and ``flagged_slots`` read 0 in ``stats()`` and in the telemetry
    counters, which a server starts at 0."""
    from repro_torch import telemetry

    keys = ("serve.finite_full_scans", "serve.flagged_slots")
    before = telemetry.counters()
    app = make_app(name, **kw)
    srv = PipelineServer(app.pipeline, batch_slots=3, validate=validate, **CPU)
    done = srv.run(_tiles(app, 7))
    assert all(r.ok for r in done) and srv.dispatches == 3
    s = srv.stats()
    assert s["finite_full_scans"] == 0 and s["flagged_slots"] == 0
    after = telemetry.counters()
    assert all(after[k] == before.get(k, 0.0) for k in keys)


def test_register_hits_the_plan_cache():
    app = make_app("gaussian", size=11)
    before = pipeline_cache_stats()
    PipelineServer(app.pipeline, batch_slots=2, **CPU)
    PipelineServer(app.pipeline, batch_slots=2, **CPU)
    after = pipeline_cache_stats()
    assert after["hits"] >= before["hits"] + 1


def test_pad_to_slots_contract():
    assert pad_to_slots([1, 2], 4, lambda: 0) == [1, 2, 0, 0]
    with pytest.raises(ValueError, match="exceed"):
        pad_to_slots([1, 2, 3], 2, lambda: 0)
