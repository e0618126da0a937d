"""The port's schedule autotuner on the CPU, held against the JAX package.

Replays the nine tests of ``tests/test_autotune.py`` on
``repro_torch.backend.autotune`` with ``device="cpu", kernels="eager"``
(the plain version timed by the host clock): determinism, the schedule-db
round trip into ``compile_pipeline(tune=...)``, the caller-wins rule, the
stored row's ``mode`` / ``device`` warning and the verifier gate.  Then
holds ``enumerate_candidates`` and ``search(measure=False)`` equal to the
JAX package's on harris sch3 20², unsharp 18² and matmul 16×16×2048 under
one explicit ``vmem_budget``.  The ``gpu`` cases time candidates on the card.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

from repro_torch.apps import make_app
from repro_torch.backend import (
    TunedModeMismatchWarning,
    clear_pipeline_cache,
    compile_pipeline,
)
from repro_torch.backend.autotune import (
    ScheduleDB,
    _plan_fingerprint,
    default_db_path,
    enumerate_candidates,
    lookup_schedule,
    lookup_schedule_entry,
    search,
)
from repro_torch.backend.plan import build_pipeline_plan
from repro_torch.backend.runner import TUNABLE_KEYS, schedule_db_key
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

pytestmark = [pytest.mark.torch, pytest.mark.tune]

CPU = dict(device="cpu", kernels="eager")


def _int_inputs(app, seed=0):
    rng = np.random.default_rng(seed)
    return {
        n: rng.integers(0, 16, tuple(app.pipeline.buffer_boxes[n].extents)).astype(np.float32)
        for n in app.pipeline.inputs
    }


# ---------------------------------------------------------------------------
# Enumeration + determinism
# ---------------------------------------------------------------------------


def test_enumerate_candidates_spans_every_axis():
    """Replays the JAX test: the heuristic {} leads; multi-stage apps get a
    fusion cut; big-K reductions get chunk candidates; every schedule names
    only tunable knobs and the list is deterministic."""
    uns = make_app("unsharp", size=18)
    cands = enumerate_candidates(uns.pipeline)
    assert cands[0] == {}
    assert cands == enumerate_candidates(uns.pipeline)
    keys = {k for s in cands for k in s}
    assert keys <= set(TUNABLE_KEYS)
    assert {"fuse": False} in cands
    assert any("block_h" in s and "line_buffer" in s for s in cands)

    mm = make_app("matmul", m=16, n=16, k=2048)
    mm_keys = {k for s in enumerate_candidates(mm.pipeline) for k in s}
    assert "red_chunk" in mm_keys
    short = enumerate_candidates(uns.pipeline, max_candidates=5)
    assert len(short) == 5 and short[0] == {}


def test_enumerate_unflattens_lane_carry_axis():
    """Replays the JAX test: both carry modes coexist for every lane width,
    and the fingerprint tells the carried lane plan from its recompute twin."""
    app = make_app("harris", schedule="sch3", size=20)
    cands = enumerate_candidates(app.pipeline)
    pairs = {
        (s["block_w"], s["line_buffer"])
        for s in cands if set(s) == {"block_w", "line_buffer"}
    }
    assert pairs, cands
    for bw in {bw for bw, _ in pairs}:
        assert (bw, True) in pairs and (bw, False) in pairs
    bw = sorted(pairs)[0][0]
    fp_lb = _plan_fingerprint(build_pipeline_plan(app.pipeline, block_w=bw, line_buffer=True))
    fp_rc = _plan_fingerprint(build_pipeline_plan(app.pipeline, block_w=bw, line_buffer=False))
    assert fp_lb != fp_rc


def test_search_is_deterministic_without_measurement():
    """Replays the JAX test: measure=False is the pure model path, on no
    device (the defaults ask for the card, and nothing runs)."""
    app = make_app("unsharp", size=15)
    r1 = search(app.pipeline, label="unsharp", measure=False)
    r2 = search(app.pipeline, label="unsharp", measure=False)
    assert r1.schedule == r2.schedule
    assert r1.key == r2.key
    assert [c.schedule for c in r1.candidates] == [c.schedule for c in r2.candidates]
    assert r1.model_cycles == r2.model_cycles
    assert not r1.measured and r1.warm_us is None and r1.build_s is None
    assert r1.model_cycles == min(
        c.model_cycles for c in r1.candidates if c.model_cycles is not None
    )
    assert r1.model_cycles <= r1.heuristic_model_cycles
    assert r1.entry["device"] == "cpu"


# ---------------------------------------------------------------------------
# Schedule-db round trip
# ---------------------------------------------------------------------------


def test_schedule_db_roundtrip_into_compile_pipeline(tmp_path):
    """Replays the JAX test: search writes the db; a reload serves the
    stored schedule through compile_pipeline(tune=...), re-compiles hit the
    cache, tuned and heuristic compiles never share a cache entry.  The row
    records the kernels and the device it was measured with."""
    dbp = str(tmp_path / "schedule_db.json")
    app = make_app("unsharp", size=15)
    clear_pipeline_cache(reset_stats=True)
    r = search(app.pipeline, label="unsharp", db=dbp, reps=2, measure_top=4, **CPU)
    assert r.warm_us is not None and r.heuristic_warm_us is not None
    assert r.warm_us <= r.heuristic_warm_us
    assert all(c.launches is None for c in r.measured)     # eager counts none

    doc = json.loads(open(dbp).read())
    assert doc["version"] == 1 and len(doc["entries"]) == 1
    entry = doc["entries"][r.key]
    assert entry["schedule"] == r.schedule
    assert set(entry["schedule"]) <= set(TUNABLE_KEYS)
    assert entry["mode"] == "eager" and entry["device"] == "cpu"

    reloaded = ScheduleDB.load(dbp)
    assert reloaded.lookup(r.key) == r.schedule
    assert lookup_schedule(app.pipeline, {}, db=dbp) == r.schedule

    clear_pipeline_cache(reset_stats=True)
    tuned = compile_pipeline(app.pipeline, cache=True, tune=dbp, **CPU)
    heur = compile_pipeline(app.pipeline, cache=True, **CPU)
    for k, v in r.schedule.items():
        if k == "block_h":
            k0 = tuned.kernels[0]
            assert k0.bh == min(v, app.pipeline.buffer_boxes[k0.name].extents[0])
    if r.schedule:
        assert tuned is not heur
    again = compile_pipeline(app.pipeline, cache=True, tune=dbp, **CPU)
    assert again is tuned


def test_stored_schedule_applies_and_caller_overrides_win(tmp_path):
    """Replays the JAX test: a hand-written row plans, an explicit caller
    keyword beats the db, another pipeline misses, and a non-tunable key is
    refused at store time."""
    app = make_app("gaussian", size=18)
    key = schedule_db_key(app.pipeline, {})
    db = ScheduleDB(path=str(tmp_path / "db.json"))
    db.store(key, {
        "app": "gaussian", "schedule": {"block_h": 2}, "warm_us": 1.0,
        "heuristic_warm_us": 2.0, "speedup": 2.0, "model_cycles": 1.0,
        "heuristic_model_cycles": 2.0, "mode": "eager", "device": "cpu",
        "candidates": 1, "measured": 1, "rejected": 0,
    })
    db.save()

    tuned = compile_pipeline(app.pipeline, tune=db, **CPU)
    assert tuned.kernels[0].bh == 2
    explicit = compile_pipeline(app.pipeline, tune=db, block_h=5, **CPU)
    assert explicit.kernels[0].bh == 5
    other = make_app("gaussian", size=20)
    assert lookup_schedule(other.pipeline, {}, db=db) is None
    heur = compile_pipeline(other.pipeline, tune=db, **CPU)
    assert heur.kernels[0].bh == compile_pipeline(other.pipeline, **CPU).kernels[0].bh

    with pytest.raises(ValueError, match="non-tunable"):
        db.store(key, {"schedule": {"vmem_budget": 64}})


def test_measured_elsewhere_winner_warns(tmp_path):
    """Replays the JAX mode-mismatch test on the port's two fields: a row
    measured with the CUDA kernels, or on another device, warns when served
    to an eager CPU compile (the schedule still applies); a row measured as
    this compile runs stays silent."""
    app = make_app("gaussian", size=18)
    key = schedule_db_key(app.pipeline, {})

    def db_with(**row):
        db = ScheduleDB(path=str(tmp_path / "db.json"))
        db.store(key, {"app": "gaussian", "schedule": {"block_h": 2}, **row})
        return db

    same = db_with(mode="eager", device="cpu")
    assert lookup_schedule_entry(app.pipeline, {}, db=same)["mode"] == "eager"
    with warnings.catch_warnings():
        warnings.simplefilter("error", TunedModeMismatchWarning)
        pp = compile_pipeline(app.pipeline, tune=same, **CPU)
    assert pp.kernels[0].bh == 2

    with pytest.warns(TunedModeMismatchWarning, match="mode 'cuda'.*mode 'eager'"):
        pp = compile_pipeline(app.pipeline, tune=db_with(mode="cuda", device="cpu"), **CPU)
    assert pp.kernels[0].bh == 2
    with pytest.warns(TunedModeMismatchWarning, match="device 'NVIDIA H100.*device 'cpu'"):
        compile_pipeline(
            app.pipeline, tune=db_with(mode="eager", device="NVIDIA H100 80GB HBM3"), **CPU
        )


def test_tuned_numerics_match_heuristic(tmp_path):
    """Replays the JAX test: the tuned plan computes the same function,
    bit for bit with the heuristic plan on integer inputs."""
    dbp = str(tmp_path / "db.json")
    app = make_app("harris", schedule="sch3", size=20)
    search(app.pipeline, label="harris", db=dbp, reps=1, measure_top=4, max_candidates=16, **CPU)
    inputs = _int_inputs(app)
    tuned = compile_pipeline(app.pipeline, tune=dbp, **CPU)
    heur = compile_pipeline(app.pipeline, **CPU)
    assert torch.equal(tuned(inputs), heur(inputs))


# ---------------------------------------------------------------------------
# The verifier gate
# ---------------------------------------------------------------------------


def test_corrupted_candidate_is_rejected_and_never_emitted():
    """Replays the JAX test: every non-heuristic survivor's working set is
    misstated before certification; all land in ``rejected`` with UB403,
    none is measured, and the heuristic wins."""
    app = make_app("gaussian", size=18)
    corrupted = []

    def hook(schedule, plan):
        if schedule == {}:
            return plan
        kg = plan.kernels[0]
        kg.ws = (kg.ws[0] + 16, kg.ws[1])
        corrupted.append(schedule)
        return plan

    r = search(app.pipeline, label="gaussian", reps=1, measure_top=4, plan_hook=hook, **CPU)
    assert corrupted, "hook never fired"
    assert len(r.rejected) == len(corrupted)
    for cand in r.rejected:
        assert cand.verified is False
        assert "UB403" in cand.rules
        assert cand.warm_us is None
    assert [c.schedule for c in r.measured] == [{}]
    assert r.schedule == {}


def test_every_measured_candidate_was_certified(tmp_path):
    """Replays the JAX test: everything measured passed verify_plan first,
    and the audit counters reach the db row."""
    app = make_app("matmul", m=16, n=16, k=2048)
    r = search(app.pipeline, label="matmul", db=str(tmp_path / "db.json"),
               reps=1, measure_top=4, max_candidates=16, **CPU)
    assert r.measured and all(c.verified for c in r.measured)
    assert all(c.verified is False for c in r.rejected)
    assert r.warm_us <= r.heuristic_warm_us
    assert r.entry["measured"] == len(r.measured)
    assert r.entry["rejected"] == len(r.rejected)


# ---------------------------------------------------------------------------
# Parity with the JAX package, the contract, the db file
# ---------------------------------------------------------------------------

PARITY_APPS = [
    ("harris", dict(schedule="sch3", size=20), {}),
    ("unsharp", dict(size=18), {}),
    ("matmul", dict(m=16, n=16, k=2048), {}),
    # the card's phase-9 search, planned only: two of its survivors fail
    # the verifier (UB402) in both packages
    ("harris", dict(schedule="sch3", size=1024), {"batch": 8, "batch_capacity": 8}),
]


@pytest.mark.parametrize("name,kw,extra", PARITY_APPS,
                         ids=["harris20", "unsharp18", "matmul2048", "harris1024-batch8"])
def test_candidates_and_model_winner_match_jax(name, kw, extra):
    """Under one explicit budget both packages enumerate the same
    schedules, keep the same candidates after the fingerprint dedup, give
    them the same modeled cycles, reject the same survivors by the same
    rules and pick the same ``measure=False`` winner.  The db keys differ:
    the port hashes its own problem."""
    jax_apps = pytest.importorskip("repro.apps.paper_apps")
    jax_autotune = pytest.importorskip("repro.backend.autotune")
    jax_runner = pytest.importorskip("repro.backend.runner")
    fixed = {"vmem_budget": H100_SMEM_PER_BLOCK, **extra}
    jpipe = jax_apps.make_app(name, **kw).pipeline
    tpipe = make_app(name, **kw).pipeline
    assert enumerate_candidates(tpipe, fixed) == jax_autotune.enumerate_candidates(jpipe, fixed)
    rt = search(tpipe, label=name, plan_kwargs=fixed, measure=False)
    rj = jax_autotune.search(jpipe, label=name, plan_kwargs=fixed, measure=False)
    assert [c.schedule for c in rt.candidates] == [c.schedule for c in rj.candidates]
    assert [c.model_cycles for c in rt.candidates] == [c.model_cycles for c in rj.candidates]
    assert [(c.schedule, c.rules) for c in rt.rejected] == [
        (c.schedule, c.rules) for c in rj.rejected
    ]
    if extra:
        assert len(rt.rejected) == 2
    assert rt.schedule == rj.schedule
    assert rt.model_cycles == rj.model_cycles
    assert rt.heuristic_model_cycles == rj.heuristic_model_cycles
    assert rt.key != rj.key
    assert schedule_db_key(tpipe, {}) != jax_runner.schedule_db_key(jpipe, {})


def test_search_defaults_refuse_the_cpu(monkeypatch):
    """No fallback: a measured search with its defaults raises where no GPU
    is visible, and ``kernels="cuda"`` on the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    app = make_app("gaussian", size=18)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search(app.pipeline, label="gaussian")
    with pytest.raises(ValueError, match="kernels='cuda' needs device='cuda'"):
        search(app.pipeline, label="gaussian", device="cpu")
    with pytest.raises(ValueError, match="fixes tunable knobs"):
        search(app.pipeline, plan_kwargs={"block_h": 4}, measure=False)


def test_default_db_is_the_ports_own(monkeypatch, tmp_path):
    """The default db is ``schedule_db_torch.json`` at the repo root,
    overridable by ``$REPRO_TORCH_SCHEDULE_DB``; never the JAX package's."""
    monkeypatch.delenv("REPRO_TORCH_SCHEDULE_DB", raising=False)
    assert default_db_path().endswith("schedule_db_torch.json")
    p = str(tmp_path / "mine.json")
    monkeypatch.setenv("REPRO_TORCH_SCHEDULE_DB", p)
    assert default_db_path() == p
    app = make_app("gaussian", size=13)
    r = search(app.pipeline, label="g13", db="auto", measure=False)
    assert lookup_schedule(app.pipeline, {}, db="auto") == r.schedule
    assert ScheduleDB.load(p).entries[r.key]["mode"] == "cuda"


@pytest.mark.gpu
def test_search_on_card_serves_winner_bit_for_bit(tmp_path):
    """On the card: the survivors are built in one batch, timed by CUDA
    events with their launches counted, and the stored winner is served
    bit for bit with the heuristic plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the search times CUDA kernels)")
    dbp = str(tmp_path / "db.json")
    app = make_app("harris", schedule="sch3", size=36)
    r = search(app.pipeline, label="harris", db=dbp, reps=3, measure_top=4, max_candidates=16,
               plan_kwargs={"batch": 2, "batch_capacity": 2})
    assert r.build_s is not None and r.measured
    assert all(c.launches == len(c.plan.kernels) for c in r.measured)
    assert r.entry["mode"] == "cuda" and r.entry["device"] == torch.cuda.get_device_name()
    rng = np.random.default_rng(1)
    ins = {n: rng.integers(0, 16, (2,) + tuple(app.pipeline.buffer_boxes[n].extents))
           .astype(np.float32) for n in app.pipeline.inputs}
    tuned = compile_pipeline(app.pipeline, tune=dbp, batch=2, batch_capacity=2)
    heur = compile_pipeline(app.pipeline, batch=2, batch_capacity=2)
    assert torch.equal(tuned(ins), heur(ins))
    with pytest.warns(TunedModeMismatchWarning, match="mode 'cuda'.*mode 'eager'"):
        compile_pipeline(app.pipeline, tune=dbp, batch=2, batch_capacity=2,
                         device="cuda", kernels="eager")
