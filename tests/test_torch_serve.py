"""The port's ``PipelineServer`` on the CPU, held against the JAX package's.

Tiles are served by the port with ``device="cpu", kernels="eager"`` (the
plain version — the only one the CPU runs).  The contract is the JAX serve
bridge's: ragged drain order is kept, every served tile is bit-exact
against the per-tile port pipeline and against the JAX ``PipelineServer``
on integer inputs, admission errors carry the same named classes, and the
recovery ladder and quarantine behave alike.
"""

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
