"""Golden plan-shape table: the planner's CI contract in one place.

``backend/demo.py`` (the CI smoke test) and ``tests/test_backend.py`` both
assert that multi-stage paper apps keep compiling to *fused* plans — fewer
``pallas_call``s than stages, intermediates in VMEM scratch.  Those
expectations used to be hardcoded in each consumer; with padded-grid
planning now free to pick any block height, keeping them in one table means
a planner change that shifts a kernel count fails CI in exactly one,
obvious place instead of silently drifting the contract.

Keys are ``(app name, schedule or None)``; values are
``(n_stages, n_kernels)`` of the default fused plan.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# (app, schedule) -> (stages, kernels) under the default fused plan.  A
# regression to per-stage compilation (or an unexpected extra fusion) on
# any of these fails both the demo and the pytest suite.
GOLDEN_PLAN_SHAPES: Dict[Tuple[str, Optional[str]], Tuple[int, int]] = {
    ("harris", "sch3"): (6, 1),
    ("harris", "sch2"): (3, 1),
    ("unsharp", None): (4, 1),
    ("camera", None): (5, 2),      # stride-2 demosaic pins denoise in HBM
    ("mobilenet", None): (2, 1),
}


def expected_plan_shape(
    name: str, schedule: Optional[str] = None
) -> Optional[Tuple[int, int]]:
    """The golden (stages, kernels) for an app, or None when the app has no
    plan-shape contract (single-stage apps, matmul workloads)."""
    return GOLDEN_PLAN_SHAPES.get((name, schedule))


# ---------------------------------------------------------------------------
# Line-buffer decisions (cross-grid-step carry, PR 4)
# ---------------------------------------------------------------------------

# (app, schedule) -> the default plan's carry decisions at the demo sizes:
#   stages        fused intermediates held in line-buffer rings (exact set)
#   rings         input delivery classes collapsed into rings (exact count)
#   max_hbm       hbm_bytes(default) / hbm_bytes(line_buffer=False) ceiling
#   max_eval      eval_rows(default) / eval_rows(line_buffer=False) ceiling
# The ratio ceilings carry ~25% headroom over the measured values so minor
# block-height retuning passes, but a silent fallback to recompute fusion
# (ratio 1.0 where a drop is promised) fails the demo and the pytest suite.
GOLDEN_LINEBUF: Dict[Tuple[str, Optional[str]], Dict[str, object]] = {
    # grad_x/grad_y recomputed 3x per step -> carried; 5 input views -> 2
    ("harris", "sch3"): {
        "stages": ("grad_x", "grad_y"), "rings": 1,
        "max_hbm": 0.50, "max_eval": 0.80,
    },
    ("harris", "sch2"): {
        "stages": ("grad_x", "grad_y"), "rings": 1,
        "max_hbm": 0.50, "max_eval": 0.70,
    },
    # blur_x recomputed 3x per step -> carried; 3 input views -> 2
    ("unsharp", None): {
        "stages": ("blur_x",), "rings": 1,
        "max_hbm": 0.70, "max_eval": 0.85,
    },
    # no row-shifted intermediates (demosaic reads are same-row); denoise's
    # 3 stride-1 raw taps still collapse to 1 ring, but the demosaic
    # kernel's odd-parity *stride-2* denoise taps no longer do: strided
    # rotations cannot coalesce into wide vector moves, so scheduler_cost
    # prices them serially (rotate_cycles) and "auto" declines that ring —
    # the camera_linebuf bench regression (ring-delivery slower than its
    # recompute baseline).  Decision pinned at the demo/bench size (16).
    # no recompute to remove (stages: ()), so eval is expected to tie —
    # the 1.1 ceiling is pure block-height-retune headroom, the real
    # regression signals here are the ring count and the hbm ratio
    ("camera", None): {
        "stages": (), "rings": 1,
        "max_hbm": 0.85, "max_eval": 1.1,
    },
    # dw_conv is consumed at shift 0 only, but its 3 ifmap taps ring
    ("mobilenet", None): {
        "stages": (), "rings": 1,
        "max_hbm": 0.70, "max_eval": 1.1,
    },
}


def expected_linebuf(
    name: str, schedule: Optional[str] = None
) -> Optional[Dict[str, object]]:
    return GOLDEN_LINEBUF.get((name, schedule))


def check_linebuf_plan(name, schedule, plan, plan_recompute) -> list:
    """Compare a default plan against its ``line_buffer=False`` twin and the
    golden carry contract; returns a list of problem strings (empty = ok).
    Shared by ``repro_torch.backend.demo`` (CI) and the pytest suite so a silent
    fallback to recompute fusion fails in one obvious place."""
    want = expected_linebuf(name, schedule)
    if want is None:
        return []
    problems = []
    got_stages = tuple(
        n for names in plan.line_buffered.values() for n in names
    )
    if tuple(sorted(got_stages)) != tuple(sorted(want["stages"])):
        problems.append(
            f"line-buffered stages {sorted(got_stages)} != golden "
            f"{sorted(want['stages'])}"
        )
    if plan.n_rings != want["rings"]:
        problems.append(
            f"{plan.n_rings} input rings != golden {want['rings']}"
        )
    hbm_ratio = plan.hbm_bytes() / max(plan_recompute.hbm_bytes(), 1)
    if hbm_ratio > want["max_hbm"]:
        problems.append(
            f"hbm ratio {hbm_ratio:.2f} vs recompute exceeds golden "
            f"{want['max_hbm']} (traffic drop regressed)"
        )
    eval_ratio = plan.total_eval_rows() / max(plan_recompute.total_eval_rows(), 1)
    if eval_ratio > want["max_eval"]:
        problems.append(
            f"eval-row ratio {eval_ratio:.2f} vs recompute exceeds golden "
            f"{want['max_eval']} (recompute reduction regressed)"
        )
    return problems


def check_plan_verified(name, plan) -> list:
    """Static certification contract: every golden app's default plan must
    pass the full ``backend.verify`` rule catalog (bounds, mask soundness,
    exactly-once writes, budget audit).  Returns one problem string per
    violation (empty = certified); the demo folds these into ``plan_notes``
    so a single violating plan fails the smoke test — and CI — even when
    the numerics happen to still match."""
    from repro_torch.backend.verify import verify_plan

    return [f"plan verification: {v}" for v in verify_plan(plan)]


__all__ = [
    "GOLDEN_PLAN_SHAPES",
    "GOLDEN_LINEBUF",
    "expected_plan_shape",
    "expected_linebuf",
    "check_linebuf_plan",
    "check_plan_verified",
]
