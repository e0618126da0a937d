"""Verifier-gated schedule autotuner: search the plan space, certify, time
on the card.

The port's counterpart of the JAX package's ``backend/autotune.py``.  The
schedule database, the lookups with their degradations, the candidate
enumeration, the symbolic pruning and the verifier gate are its code with
the imports rewritten; :func:`search` differs in its measurement only:

1. **enumerate** candidate schedules over the planner's tunable knobs —
   joint (bh, bw) pairs (``lane_width_candidates(order="joint")``), the
   fusion cut, ``line_buffer`` mode, and the grid-reduction chunk,
2. **prune** with the cycle model: every candidate plan is built
   symbolically (no kernel is emitted) and ranked by its summed
   ``model_cycles``; only the modeled-cheapest survivors are measured,
3. **certify** every surviving plan with the static verifier
   (``verify.verify_plan``) *before* it is emitted or measured — a
   candidate that fails certification is logged in the result's
   ``rejected`` list with its named rules and never runs,
4. **measure** survivors on the card: every certified survivor's CUDA
   library is built first, all ``nvcc`` processes started together
   (``build.build_many``), then each candidate's ``pp.run`` is timed by
   CUDA events on inputs already resident on the card (one warm-up run,
   the median of ``reps``); ``kernels="eager"`` times the plain version
   with the host clock,
5. **persist** the winner in a JSON schedule database keyed by
   :func:`runner.schedule_db_key` (the ``plan_cache_key`` inputs minus the
   schedule, the device and the kernel choice), so
   ``compile_pipeline(tune=...)`` finds the stored schedule before falling
   back to the heuristic planner.

The heuristic plan (the empty schedule ``{}``) is always candidate 0 and
is always measured, so the stored winner's time is ≤ the heuristic's by
construction.  With ``measure=False`` the search is fully deterministic —
the winner is the modeled-cheapest certified candidate — and runs on no
device.  The port's database is its own file (``schedule_db_torch.json``),
and its keys hash under a prefix of the port's own
(:func:`runner.schedule_db_key`): the port's planner defaults differ (the
H100's shared memory per block as ``vmem_budget``), so no JAX row is ever
served to it.
"""

from __future__ import annotations

import json
import os
import statistics
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ubplan import lane_width_candidates
from repro_torch.frontend.lower import Pipeline, normalize_pipeline

from .access import UnsupportedAccessError
from .build import build_many
from .cuda_codegen import emit_library
from .eager import LoweredGroup
from .errors import ScheduleDBCorruptWarning
from .plan import FusionInfeasible, PipelinePlan, build_pipeline_plan
from .runner import (
    _PLAN_KWARG_DEFAULTS,
    TUNABLE_KEYS,
    _check_contract,
    compile_pipeline,
    schedule_db_key,
)
from .verify import verify_plan

# a schedule is a dict over the tunable knobs only (TUNABLE_KEYS); the
# empty dict is the heuristic planner's own choice
Schedule = Dict[str, object]

DB_VERSION = 1
DB_ENV_VAR = "REPRO_TORCH_SCHEDULE_DB"


def default_db_path() -> str:
    """Repo-root ``schedule_db_torch.json`` (override via
    ``$REPRO_TORCH_SCHEDULE_DB``); created only when a search stores into it."""
    env = os.environ.get(DB_ENV_VAR)
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(
        os.path.join(here, "..", "..", "..", "schedule_db_torch.json")
    )


# ---------------------------------------------------------------------------
# Schedule database
# ---------------------------------------------------------------------------


@dataclass
class ScheduleDB:
    """JSON-backed winner store: ``{"version": 1, "entries": {key: entry}}``.

    Keys are :func:`runner.schedule_db_key` hashes; each entry records the
    winning ``schedule`` (tunable kwargs only) plus the measurements that
    justified it (``warm_us``, ``heuristic_warm_us``, ``speedup``,
    ``model_cycles``) and the search's audit counters (``candidates``,
    ``measured``, ``rejected``).  A missing file loads as an empty db.

    A *corrupt* file (truncated write, garbage bytes, wrong version, no
    ``entries`` object) raises under ``strict=True`` (the default — tools
    editing the db want the loud failure) but loads as an *empty* db with
    the reason recorded in ``corrupt`` under ``strict=False`` — the
    serving path (``compile_pipeline(tune=...)``) uses that to degrade to
    the heuristic planner with a named
    :class:`~repro_torch.backend.errors.ScheduleDBCorruptWarning` instead of
    raising ``json.JSONDecodeError`` mid-compile."""

    path: Optional[str] = None
    entries: Dict[str, Dict] = field(default_factory=dict)
    corrupt: Optional[str] = None      # strict=False: why the db is empty

    @classmethod
    def load(cls, path: Optional[str] = None, strict: bool = True) -> "ScheduleDB":
        p = path or default_db_path()
        if not os.path.exists(p):
            return cls(path=p)
        try:
            with open(p) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or "entries" not in doc:
                raise ValueError(f"{p}: not a schedule db (no 'entries' key)")
            version = doc.get("version")
            if version != DB_VERSION:
                raise ValueError(
                    f"{p}: schedule db version {version!r} != {DB_VERSION}"
                )
            entries = doc["entries"]
            if not isinstance(entries, dict):
                raise ValueError(f"{p}: 'entries' is not an object")
        except (ValueError, UnicodeDecodeError, OSError) as e:
            # json.JSONDecodeError subclasses ValueError: truncated and
            # garbage files land here together with the structural checks
            if strict:
                raise
            return cls(path=p, corrupt=f"{type(e).__name__}: {e}")
        return cls(path=p, entries=dict(entries))

    def save(self, path: Optional[str] = None) -> str:
        p = path or self.path or default_db_path()
        with open(p, "w") as f:
            json.dump(
                {"version": DB_VERSION, "entries": self.entries},
                f, indent=2, sort_keys=True,
            )
            f.write("\n")
        self.path = p
        return p

    def lookup(self, key: str) -> Optional[Schedule]:
        entry = self.lookup_entry(key)
        if entry is None:
            return None
        return dict(entry["schedule"])

    def lookup_entry(self, key: str) -> Optional[Dict]:
        """Full stored row (schedule + measurements + ``mode``), or None."""
        entry = self.entries.get(key)
        if entry is None:
            return None
        # a malformed (non-object) row is returned as-is so the caller's
        # validity check can name it instead of dict() raising here
        return dict(entry) if isinstance(entry, dict) else entry

    def store(self, key: str, entry: Dict) -> None:
        bad = set(entry["schedule"]) - set(TUNABLE_KEYS)
        if bad:
            raise ValueError(
                f"schedule contains non-tunable keys {sorted(bad)}"
            )
        self.entries[key] = entry


# mtime-keyed load cache: ``compile_pipeline(tune=...)`` resolves the db on
# every tuned compile, which must not re-read JSON from disk each time
_DB_CACHE: Dict[str, Tuple[float, ScheduleDB]] = {}


def _resolve_db(db: object, strict: bool = True) -> ScheduleDB:
    if isinstance(db, ScheduleDB):
        return db
    if db in (True, "auto", None):
        path = default_db_path()
    elif isinstance(db, (str, os.PathLike)):
        path = os.fspath(db)
    else:
        raise TypeError(
            f"db must be a ScheduleDB, a path, or 'auto': {db!r}"
        )
    mtime = os.path.getmtime(path) if os.path.exists(path) else -1.0
    cached = _DB_CACHE.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    loaded = ScheduleDB.load(path, strict=strict)
    _DB_CACHE[path] = (mtime, loaded)
    return loaded


def _valid_entry_or_reason(entry: object) -> Optional[str]:
    """Why a stored row cannot be served, or ``None`` when it can.  Rows
    written by a future writer (``row_version``), rows that are not
    objects, and rows whose schedule names non-tunable knobs all degrade
    to a miss rather than poisoning the compile."""
    if not isinstance(entry, dict):
        return f"row is {type(entry).__name__}, not an object"
    rv = entry.get("row_version")
    if rv is not None and rv != DB_VERSION:
        return f"unknown row_version {rv!r} (this reader is {DB_VERSION})"
    sched = entry.get("schedule")
    if not isinstance(sched, dict):
        return "row has no 'schedule' object"
    bad = sorted(set(sched) - set(TUNABLE_KEYS))
    if bad:
        return f"schedule names non-tunable keys {bad}"
    return None


def _serveable_entry(
    pipe: Pipeline, plan_kwargs: Mapping, db: object, stacklevel: int
) -> Optional[Dict]:
    """Shared lookup with degradation: a corrupt db or malformed row is a
    *miss* plus a named :class:`ScheduleDBCorruptWarning` — the caller
    (ultimately ``compile_pipeline(tune=...)``) falls back to the
    heuristic planner instead of raising mid-compile."""
    resolved = _resolve_db(db, strict=False)
    if resolved.corrupt:
        warnings.warn(
            f"schedule db {resolved.path}: {resolved.corrupt}; "
            f"degrading to the heuristic schedule (db treated as empty)",
            ScheduleDBCorruptWarning,
            stacklevel=stacklevel,
        )
        return None
    key = schedule_db_key(pipe, plan_kwargs)
    entry = resolved.lookup_entry(key)
    if entry is None:
        return None
    reason = _valid_entry_or_reason(entry)
    if reason is not None:
        warnings.warn(
            f"schedule db {resolved.path}: stored row {key[:12]}… is "
            f"malformed ({reason}); degrading to the heuristic schedule",
            ScheduleDBCorruptWarning,
            stacklevel=stacklevel,
        )
        return None
    return entry


def lookup_schedule(
    pipe: Pipeline, plan_kwargs: Mapping, db: object = "auto"
) -> Optional[Schedule]:
    """The ``compile_pipeline(tune=...)`` hook: stored winning schedule for
    this pipeline + non-tunable kwargs, or ``None`` on a db miss (the
    caller falls back to the heuristic planner).  A corrupt db or
    malformed row is a miss with a :class:`ScheduleDBCorruptWarning`."""
    entry = _serveable_entry(pipe, plan_kwargs, db, stacklevel=3)
    if entry is None:
        return None
    return dict(entry["schedule"])


def lookup_schedule_entry(
    pipe: Pipeline, plan_kwargs: Mapping, db: object = "auto"
) -> Optional[Dict]:
    """Like :func:`lookup_schedule` but returns the full stored row — the
    runner reads ``entry["mode"]`` and ``entry["device"]`` to warn when a
    winner measured one way is served to a compile of another.
    ``stacklevel`` walks lookup → ``compile_pipeline`` → the user's compile
    call, so the degradation warning points at the tuned compile that
    degraded."""
    return _serveable_entry(pipe, plan_kwargs, db, stacklevel=4)


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def enumerate_candidates(
    pipe: Pipeline,
    plan_kwargs: Optional[Mapping] = None,
    max_candidates: int = 32,
) -> List[Schedule]:
    """Deterministic candidate schedules for one pipeline, heuristic first.

    The axes come straight from the lowered extents (no plan is built):
    block heights (powers of two up to 64 plus the low-padding ceil
    divisions of the output row extent), joint lane widths
    (``lane_width_candidates(order="joint")``), the ``line_buffer`` mode,
    the fusion cut (multi-stage pipelines only), and grid-reduction chunks
    (pipelines with a large leading reduction dim only).  Single knobs are
    tried before pairs so a truncated list still spans every axis; the
    list is capped at ``max_candidates`` with the heuristic ``{}`` always
    kept at index 0."""
    nstages = [ns for ns in normalize_pipeline(pipe) if not ns.on_host]
    out_ns = next(ns for ns in nstages if ns.name == pipe.output)
    e0 = out_ns.pure_extents[0]
    e1 = out_ns.pure_extents[-1] if len(out_ns.pure_extents) >= 2 else None
    multi = len(nstages) > 1
    red_ext = max(
        (ns.red_extents[0] for ns in nstages if ns.red_dims), default=0
    )
    threshold = dict(plan_kwargs or {}).get("red_grid_threshold")
    if threshold is None:
        from .plan import RED_GRID_THRESHOLD

        threshold = RED_GRID_THRESHOLD

    bh_pool: List[int] = []
    b = 2
    while b <= min(e0, 64):
        bh_pool.append(b)
        b *= 2
    for s in (4, 2):
        bh_pool.append(max(1, _cdiv(e0, s)))
    bh_pool.append(e0)
    bh_pool = sorted(set(bh_pool))[:6]

    bw_pool: List[int] = []
    if e1 is not None and e1 > 8:
        bw_pool = lane_width_candidates(e1, order="joint")[:3]

    rc_pool: List[int] = []
    if red_ext >= threshold:
        rc_pool = [c for c in (32, 64, 128, 256) if c < red_ext][:3]

    scheds: List[Schedule] = [{}]
    scheds += [{"line_buffer": True}, {"line_buffer": False}]
    if multi:
        scheds.append({"fuse": False})
    scheds += [{"red_chunk": c} for c in rc_pool]
    scheds += [{"block_h": bh} for bh in bh_pool]
    scheds += [{"block_w": bw} for bw in bw_pool]
    scheds += [
        {"block_h": bh, "line_buffer": lb}
        for bh in bh_pool[-3:] for lb in (True, False)
    ]
    scheds += [
        {"block_h": bh, "block_w": bw}
        for bh in bh_pool[-2:] for bw in bw_pool[:2]
    ]
    # lane × carry is a real axis now that the planner composes column
    # rings with lane grids: a lane-blocked candidate with carry forced
    # on/off plans differently (and _plan_fingerprint sees the rings), so
    # enumerate the pairs instead of leaving the axis flattened
    scheds += [
        {"block_w": bw, "line_buffer": lb}
        for bw in bw_pool[:2] for lb in (True, False)
    ]
    scheds += [
        {"block_h": bh, "red_chunk": c}
        for bh in bh_pool[-2:] for c in rc_pool[:2]
    ]

    seen = set()
    out: List[Schedule] = []
    for s in scheds:
        key = tuple(sorted(s.items()))
        if key in seen:
            continue
        seen.add(key)
        out.append(s)
        if len(out) >= max_candidates:
            break
    return out


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


@dataclass
class Candidate:
    """One enumerated schedule and everything the search learned about it."""

    schedule: Schedule
    plan: Optional[PipelinePlan] = None
    model_cycles: Optional[float] = None
    fingerprint: Optional[Tuple] = None
    verified: Optional[bool] = None          # None: pruned before the gate
    rules: Tuple[str, ...] = ()
    warm_us: Optional[float] = None
    cold_us: Optional[float] = None
    launches: Optional[int] = None           # kernel launches of one run


@dataclass
class TuneResult:
    """Outcome of one :func:`search`: the winner plus the full audit trail."""

    key: str
    label: str
    schedule: Schedule
    warm_us: Optional[float]
    heuristic_warm_us: Optional[float]
    model_cycles: Optional[float]
    heuristic_model_cycles: Optional[float]
    candidates: List[Candidate]
    measured: List[Candidate]
    rejected: List[Candidate]
    entry: Dict
    build_s: Optional[float] = None          # wall of the survivors' nvcc build

    @property
    def speedup(self) -> Optional[float]:
        if not self.warm_us or not self.heuristic_warm_us:
            return None
        return self.heuristic_warm_us / self.warm_us


def _plan_cycles(plan: PipelinePlan) -> Optional[float]:
    total = 0.0
    for kg in plan.kernels:
        c = kg.notes.get("model_cycles")
        if c is None:
            return None
        total += float(c)
    return total


def _plan_fingerprint(plan: PipelinePlan) -> Tuple:
    """Two schedules that produce byte-identical plan decisions are one
    candidate: measuring both wastes a slot and the simpler (earlier)
    schedule wins the dedup."""
    return tuple(
        (
            kg.bh, kg.bw, tuple(kg.grid),
            tuple(sorted(
                sp.name for sp in kg.stages if sp.line_buffer is not None
            )),
            len(kg.rings),
            (kg.red_grid.chunk, kg.red_grid.steps) if kg.red_grid else None,
            tuple(kg.stage_names),
        )
        for kg in plan.kernels
    )


def _seeded_inputs(
    pipe: Pipeline, seed: int, batch: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Integer inputs in [0, 16); ``batch`` prepends the batched pipeline's
    leading dim of that many tiles."""
    rng = np.random.default_rng(seed)
    lead = (batch,) if batch else ()
    return {
        name: rng.integers(
            0, 16, lead + tuple(pipe.buffer_boxes[name].extents)
        ).astype(np.float32)
        for name in sorted(pipe.inputs)
    }


def _time_run(pp, inputs, dev: torch.device, kernels: str, reps: int) -> Tuple[float, float]:
    """(cold µs, warm µs) of ``pp.run``.  The first run is timed by the
    host clock (it builds nothing: the libraries are built before).  The
    CUDA kernels' warm time is the median of ``reps`` runs between CUDA
    events; the plain version's is the best of ``reps`` by the host clock,
    as the JAX package times its runs."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    pp.run(inputs)
    sync()
    cold = (time.perf_counter() - t0) * 1e6
    runs = []
    for _ in range(max(1, reps)):
        if kernels == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            pp.run(inputs)
            b.record()
            b.synchronize()
            runs.append(a.elapsed_time(b) * 1e3)
        else:
            t0 = time.perf_counter()
            pp.run(inputs)
            sync()
            runs.append((time.perf_counter() - t0) * 1e6)
    return cold, statistics.median(runs) if kernels == "cuda" else min(runs)


def search(
    pipe: Pipeline,
    *,
    label: str = "pipeline",
    db: object = None,
    device: object = "cuda",
    kernels: str = "cuda",
    plan_kwargs: Optional[Mapping] = None,
    max_candidates: int = 32,
    measure_top: int = 8,
    measure: bool = True,
    reps: int = 3,
    seed: int = 0,
    plan_hook: Optional[
        Callable[[Schedule, PipelinePlan], Optional[PipelinePlan]]
    ] = None,
    log: Optional[Callable[[str], None]] = None,
) -> TuneResult:
    """Autotune one pipeline: enumerate → prune → certify → measure → store.

    ``plan_kwargs`` fixes the non-tunable side of the problem (budget,
    batching, alignment); it must not name tunable knobs — those are the
    search's to vary.  Unnamed planner keywords take the port's defaults
    (``runner._PLAN_KWARG_DEFAULTS``), so every candidate plans as
    ``compile_pipeline`` will.  ``measure_top`` caps how many certified
    candidates are actually compiled and timed (the heuristic plan is always
    one of them); ``measure=False`` skips execution entirely and the winner
    is the modeled-cheapest certified candidate — fully deterministic, on
    no device.  ``plan_hook(schedule, plan)`` (tests) may replace/mutate a
    candidate plan just before certification — it is how the
    seeded-corruption suite proves a candidate failing ``verify_plan`` is
    never emitted.

    ``device`` and ``kernels`` are ``compile_pipeline``'s execution
    contract: the defaults time the CUDA kernels on the card and raise when
    no GPU is visible; ``device="cpu", kernels="eager"`` times the plain
    version on the CPU.

    ``db``: a :class:`ScheduleDB`, a path, or ``"auto"``/``True`` for the
    default db — the winner is stored and the db saved; ``None`` skips
    persistence.  Returns the :class:`TuneResult` audit trail either way.
    """
    fixed = dict(plan_kwargs or {})
    bad = sorted(set(fixed) & set(TUNABLE_KEYS))
    if bad:
        raise ValueError(
            f"plan_kwargs fixes tunable knobs {bad}; pass a narrower "
            f"search via max_candidates instead"
        )
    say = log or (lambda _msg: None)
    dev = _check_contract(device, kernels) if measure else None

    def plan_of(sched: Schedule) -> PipelinePlan:
        return build_pipeline_plan(
            pipe, **{**_PLAN_KWARG_DEFAULTS, **fixed, **sched}
        )

    # -- enumerate + symbolic build + model pruning --------------------------
    candidates: List[Candidate] = []
    seen_fp: set = set()
    for sched in enumerate_candidates(pipe, fixed, max_candidates):
        cand = Candidate(schedule=sched)
        try:
            cand.plan = plan_of(sched)
        except (FusionInfeasible, UnsupportedAccessError, ValueError) as e:
            say(f"{label}: {sched or '{heuristic}'} does not plan: {e}")
            continue
        cand.fingerprint = _plan_fingerprint(cand.plan)
        if cand.fingerprint in seen_fp:
            continue                              # same plan, earlier schedule
        seen_fp.add(cand.fingerprint)
        cand.model_cycles = _plan_cycles(cand.plan)
        candidates.append(cand)
    if not candidates:
        raise FusionInfeasible(f"{label}: no candidate schedule plans")

    baseline = candidates[0]
    ranked = sorted(
        candidates[1:],
        key=lambda c: (
            c.model_cycles if c.model_cycles is not None else float("inf")
        ),
    )
    survivors = [baseline] + ranked[: max(0, measure_top - 1)]

    # -- verifier gate: certify before anything is emitted or measured -------
    certified: List[Candidate] = []
    rejected: List[Candidate] = []
    for cand in survivors:
        plan = cand.plan
        if plan_hook is not None:
            plan = plan_hook(cand.schedule, plan) or plan
            cand.plan = plan
        violations = verify_plan(plan)
        if violations:
            cand.verified = False
            cand.rules = tuple(sorted({v.rule for v in violations}))
            rejected.append(cand)
            say(
                f"{label}: REJECTED {cand.schedule or '{heuristic}'} — "
                f"verify_plan rules {list(cand.rules)}; never emitted"
            )
            continue
        cand.verified = True
        certified.append(cand)
    if not certified:
        raise FusionInfeasible(
            f"{label}: every surviving candidate failed verification"
        )

    # -- measure the certified survivors -------------------------------------
    measured: List[Candidate] = []
    build_s: Optional[float] = None
    if measure:
        if kernels == "cuda":
            # every survivor's library in one parallel nvcc build; the
            # sources are those compile_pipeline emits for each schedule
            t0 = time.perf_counter()
            build_many([
                emit_library([LoweredGroup(kg) for kg in plan_of(c.schedule).kernels])
                for c in certified
            ])
            build_s = time.perf_counter() - t0
            say(f"{label}: built {len(certified)} candidates in {build_s:.1f} s")
        inputs = {
            n: torch.from_numpy(a).to(dev)
            for n, a in _seeded_inputs(pipe, seed, fixed.get("batch")).items()
        }
        for cand in certified:
            pp = compile_pipeline(
                pipe, cache=True, device=dev, kernels=kernels,
                **{**fixed, **cand.schedule},
            )
            # a CUDA kernel counts its launches; the plain version does not
            before = sum(getattr(k, "launches", 0) for k in pp.kernels)
            cand.cold_us, cand.warm_us = _time_run(pp, inputs, dev, kernels, reps)
            if kernels == "cuda":
                after = sum(k.launches for k in pp.kernels)
                cand.launches = (after - before) // (max(1, reps) + 1)
            measured.append(cand)
        winner = min(
            measured,
            key=lambda c: (c.warm_us, c is not baseline),
        )
    else:
        winner = min(
            certified,
            key=lambda c: (
                c.model_cycles if c.model_cycles is not None else float("inf"),
                c is not baseline,
            ),
        )

    key = schedule_db_key(pipe, fixed)
    entry = {
        "app": label,
        "schedule": dict(winner.schedule),
        "warm_us": winner.warm_us,
        "heuristic_warm_us": baseline.warm_us,
        "speedup": (
            round(baseline.warm_us / winner.warm_us, 3)
            if winner.warm_us and baseline.warm_us else None
        ),
        "model_cycles": winner.model_cycles,
        "heuristic_model_cycles": baseline.model_cycles,
        "mode": kernels,
        "device": (
            torch.cuda.get_device_name(dev) if dev is not None and dev.type == "cuda"
            else "cpu"
        ),
        "candidates": len(candidates),
        "measured": len(measured),
        "rejected": len(rejected),
    }
    result = TuneResult(
        key=key,
        label=label,
        schedule=dict(winner.schedule),
        warm_us=winner.warm_us,
        heuristic_warm_us=baseline.warm_us,
        model_cycles=winner.model_cycles,
        heuristic_model_cycles=baseline.model_cycles,
        candidates=candidates,
        measured=measured,
        rejected=rejected,
        entry=entry,
        build_s=build_s,
    )
    if db is not None and db is not False:
        store = _resolve_db(db, strict=False)
        if store.corrupt:
            warnings.warn(
                f"schedule db {store.path}: {store.corrupt}; rewriting it "
                f"fresh with this search's winner",
                ScheduleDBCorruptWarning,
                stacklevel=2,
            )
            store.corrupt = None
        store.store(key, entry)
        store.save()
        _DB_CACHE.pop(store.path, None)           # force fresh mtime on reload
        say(f"{label}: stored winner {winner.schedule or '{heuristic}'} "
            f"in {store.path}")
    return result


__all__ = [
    "Candidate",
    "ScheduleDB",
    "TuneResult",
    "default_db_path",
    "enumerate_candidates",
    "lookup_schedule",
    "lookup_schedule_entry",
    "search",
]
