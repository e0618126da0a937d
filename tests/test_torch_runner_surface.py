"""The runner surface the JAX tests reach kernels through, in the port.

``compile_stage`` (one normalized stage compiled to one kernel of the
port's kernel class), ``TorchPipeline.stages`` / ``.stage(name)`` and
``pipeline_cache_size``, replayed on ``device="cpu", kernels="eager"``
from the cases of ``tests/test_backend.py`` that reach a kernel through
``.stage`` and from ``tests/test_compiled_path.py``'s cache contract; the
kernel a stage compiles to is held against the JAX package's
``compile_stage`` (the same planned group, the same values).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.apps.paper_apps import make_app as jax_make_app
from repro.backend.codegen import compile_stage as jax_compile_stage
from repro.frontend.lower import normalize_pipeline as jax_normalize
from repro_torch.apps import make_app
from repro_torch.backend import (
    EagerKernel,
    GroupKernel,
    RULES,
    LaneCarryDegradeWarning,
    UnsupportedAccessError,
    clear_pipeline_cache,
    compile_pipeline,
    compile_stage,
    eval_trace,
    max_abs_error,
    pipeline_cache_size,
    scheduler_cost,
)
from repro_torch.backend.errors import BackendWarning
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK, VMEM_BYTES
from repro_torch.frontend.expr import BinOp, FuncRef
from repro_torch.frontend.lower import normalize_pipeline

pytestmark = pytest.mark.torch

CPU = dict(device="cpu", kernels="eager")


def _inputs(app, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.integers(0, 16, s).astype(np.float32) for n, s in app.input_extents.items()}


# ---------------------------------------------------------------------------
# tests/test_backend.py cases that reach a kernel through .stage
# ---------------------------------------------------------------------------


def test_gaussian_generates_row_shifted_streams():
    app = make_app("gaussian")
    pp = compile_pipeline(app.pipeline, line_buffer=False, **CPU)
    cs = pp.stage("gaussian")
    assert cs.streamed and cs.grid[0] > 1
    assert len(cs.groups) == 3
    assert sorted(g.k0 for g in cs.groups) == [0, 1, 2]
    assert all(g.blocked_axis == 0 for g in cs.groups)
    assert all(g.span[1] == 64 for g in cs.groups)

    pp = compile_pipeline(app.pipeline, **CPU)
    cs = pp.stage("gaussian")
    assert len(cs.rings) == 1
    ring = cs.rings[0]
    assert (ring.lo, ring.hi, ring.halo) == (0, 2, 2)
    steady, prefix = cs.groups[ring.steady], cs.groups[ring.prefix]
    assert steady.k0 == 2 and not steady.pinned
    assert prefix.k0 == 0 and prefix.pinned and prefix.rows0 == 2
    assert len(cs.groups) == 2
    lb_bytes = pp.plan.hbm_bytes()
    rc_bytes = compile_pipeline(app.pipeline, line_buffer=False, **CPU).plan.hbm_bytes()
    assert lb_bytes < rc_bytes


def test_matmul_broadcast_stream():
    app = make_app("matmul", m=24, n=16, k=8)
    cs = compile_pipeline(app.pipeline, **CPU).stage("matmul")
    kinds = {g.buffer: g.blocked_axis for g in cs.groups}
    assert kinds["A"] == 0 and kinds["B"] is None


def test_block_h_override():
    app = make_app("gaussian", size=18)
    pp = compile_pipeline(app.pipeline, block_h=4, **CPU)
    cs = pp.stage("gaussian")
    assert cs.bh == 4 and cs.grid == (4,)
    errs = max_abs_error(pp, _inputs(app))
    assert max(errs.values()) == 0.0


def test_padded_grid_metadata_threaded():
    app = make_app("gaussian", size=13)
    pp = compile_pipeline(app.pipeline, **CPU)
    ck = pp.stage("gaussian")
    pg = ck.padded_grid
    assert pg is not None and pg.extent == 11
    for g in ck.groups:
        if g.pinned:
            continue
        assert g.blocked_axis is not None and g.valid0 == 11
    sp = ck.kg.output
    assert sp.valid_e0 == 11
    rows = [sp.valid_rows(ck.bh, s) for s in range(pg.steps)]
    assert sum(rows) == 11 and rows[-1] == ck.bh - pg.pad
    assert ck.plan.notes.get("padded_grid") == (pg.extent, pg.block, pg.steps)


def test_kernel_validates_view_extents():
    app = make_app("gaussian", size=18)
    pp = compile_pipeline(app.pipeline, **CPU)
    ck = pp.stage("gaussian")
    need = ck.kg.required_extents()
    assert need == {"input": (18, 18)}
    with pytest.raises(ValueError, match=r"buffer 'input' axis 0.*>= 18"):
        ck({"input": torch.zeros((17, 18))})
    with pytest.raises(KeyError, match="missing input buffer 'input'"):
        ck({})


def test_stages_and_stage_lookup():
    """``.stages`` is the kernel list; ``.stage`` finds a kernel by the
    buffer it writes or by a stage it fuses (``.kernel`` is the same
    lookup), and an unknown name raises ``KeyError``."""
    app = make_app("harris", schedule="sch3", size=20)
    pp = compile_pipeline(app.pipeline, **CPU)
    assert pp.stages is pp.kernels and len(pp.stages) == 1
    ck = pp.kernels[0]
    assert isinstance(ck, GroupKernel) and ck.fused
    assert pp.stage(ck.name) is ck
    for name in ck.stage_names:
        assert pp.stage(name) is ck and pp.kernel(name) is ck
    assert ck.line_buffered == pp.plan.line_buffered[ck.name]
    assert ck.block == ck.kg.output.panel_shape(ck.bh)
    with pytest.raises(KeyError):
        pp.stage("no_such_stage")


# ---------------------------------------------------------------------------
# compile_stage
# ---------------------------------------------------------------------------

STAGE_CASES = [
    ("gaussian", {"size": 13}, {"block_h": 4}),
    ("matmul", {"m": 19, "n": 13, "k": 150}, {"grid_reduction": True, "red_grid_threshold": 64}),
    ("resnet", {"img": 7, "cin": 3, "cout": 3}, {"block_w": 3, "block_h": 2}),
    ("upsample", {"size": 11}, {}),
]


def _stage_digest(kg):
    return (kg.bh, tuple(kg.grid), kg.bw, tuple(kg.stage_names), repr(kg.groups),
            repr(kg.rings), repr(kg.padded_grid), repr(kg.lane_grid), repr(kg.red_grid))


@pytest.mark.parametrize("name,kw,skw", STAGE_CASES, ids=[c[0] for c in STAGE_CASES])
def test_compile_stage_matches_jax(name, kw, skw):
    """The first normalized stage of each app, compiled alone on the same
    budget by both packages: the same planned group, and the port's eager
    kernel gives the JAX kernel's values bit for bit on integer inputs."""
    app = make_app(name, **kw)
    japp = jax_make_app(name, **kw)
    ns = normalize_pipeline(app.pipeline)[0]
    jns = jax_normalize(japp.pipeline)[0]
    shapes = {b: tuple(box.extents) for b, box in app.pipeline.buffer_boxes.items()}
    ck = compile_stage(ns, shapes, vmem_budget=VMEM_BYTES, **CPU, **skw)
    jck = jax_compile_stage(jns, shapes, vmem_budget=VMEM_BYTES, **skw)
    assert isinstance(ck, EagerKernel) and ck.name == jck.name == ns.name
    assert _stage_digest(ck.kg) == _stage_digest(jck.kg)
    ins = _inputs(app)
    got = ck({n: torch.from_numpy(a) for n, a in ins.items()})
    want = np.asarray(jck(ins))
    assert np.array_equal(got.numpy(), want)


def test_compile_stage_defaults_to_the_h100_budget_and_the_card():
    app = make_app("gaussian", size=18)
    ns = normalize_pipeline(app.pipeline)[0]
    shapes = {"input": (18, 18)}
    ck = compile_stage(ns, shapes, **CPU)
    assert ck.kg.vmem_bytes <= H100_SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="kernels='cuda' needs device='cuda'"):
        compile_stage(ns, shapes, device="cpu", kernels="cuda")
    with pytest.raises(ValueError, match="kernels must be one of"):
        compile_stage(ns, shapes, device="cpu", kernels="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            compile_stage(ns, shapes)


def test_compile_stage_refuses_a_reduction_init_that_reads_buffers():
    """As the JAX package does: an init that reads a buffer is refused
    before planning."""
    app = make_app("matmul", m=8, n=8, k=8)
    ns = normalize_pipeline(app.pipeline)[0]
    ld = ns.loads[0]
    bad = dataclasses.replace(ns, init=BinOp("add", FuncRef(ld[0], ()), ns.init))
    shapes = {b: tuple(box.extents) for b, box in app.pipeline.buffer_boxes.items()}
    with pytest.raises(UnsupportedAccessError, match="reduction init with buffer reads"):
        compile_stage(bad, shapes, **CPU)


def test_compile_stage_kernel_records_its_eval_sites():
    app = make_app("gaussian", size=13)
    ns = normalize_pipeline(app.pipeline)[0]
    ck = compile_stage(ns, {"input": (13, 13)}, **CPU)
    with eval_trace() as trace:
        ck({"input": torch.zeros((13, 13))})
    assert trace == ck.lg.eval_sites() and trace[-1]["stage"] == "gaussian"


# ---------------------------------------------------------------------------
# Re-exports and the plan-keyed cache (tests/test_compiled_path.py)
# ---------------------------------------------------------------------------


def test_backend_reexports():
    assert callable(scheduler_cost) and RULES
    assert issubclass(LaneCarryDegradeWarning, BackendWarning)


def test_pipeline_cache_hit_and_key_contract():
    clear_pipeline_cache()
    try:
        app = make_app("gaussian", size=18)
        pp1 = compile_pipeline(app.pipeline, cache=True, **CPU)
        assert pipeline_cache_size() == 1 and pp1.cache_key is not None
        assert compile_pipeline(app.pipeline, cache=True, **CPU) is pp1

        app_again = make_app("gaussian", size=18)
        assert compile_pipeline(app_again.pipeline, cache=True, **CPU) is pp1

        pp_bh = compile_pipeline(app.pipeline, cache=True, block_h=4, **CPU)
        assert pp_bh is not pp1
        app32 = make_app("gaussian", size=32)
        pp32 = compile_pipeline(app32.pipeline, cache=True, **CPU)
        assert pp32 is not pp1
        assert pipeline_cache_size() == 3

        pp_raw = compile_pipeline(app.pipeline, **CPU)
        assert pp_raw is not pp1 and pp_raw.cache_key is None
        assert pipeline_cache_size() == 3
    finally:
        clear_pipeline_cache()


@pytest.mark.gpu
def test_compile_stage_on_card():
    """``compile_stage`` on its defaults builds and launches the CUDA
    kernel once a call, bit for bit with its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    app = make_app("gaussian", size=34)
    ns = normalize_pipeline(app.pipeline)[0]
    ck = compile_stage(ns, {"input": (34, 34)})
    x = {"input": torch.from_numpy(_inputs(app)["input"]).cuda()}
    got = ck(x)
    assert ck.launches == 1
    assert torch.equal(got, ck.plain(x))
