"""The port's copy of the paper's compiler core computes what the JAX
package's computes.

``repro_torch.core`` keeps its own copies of the scheduler, the unified
buffer extraction, the memory mapping, the hardware cost model and the
cycle-accurate simulator (it imports nothing of ``repro``), so on every
paper app at its published size and on the six Harris schedules of Table V
the two packages must agree: the same policy, initiation interval and
completion cycles (pipelined and sequential), the same extracted buffers
(every port's domain, access map and schedule, the capacity bound), the
same ``map_design`` result (shift-register taps, MEM tiles, SRAM words,
bank configurations) and the same ``design_cost`` and ``table2_variants``
rows — the numbers behind ``benchmarks/paper_tables.py``'s tables 2 and
4-7.  Objects of the two packages are distinct classes with the same names,
so they are compared through their ``repr``.
"""

import numpy as np
import pytest

from repro.apps import make_app as jax_make_app
from repro.core import extraction as jax_extraction
from repro.core import hwmodel as jax_hwmodel
from repro.core import mapping as jax_mapping
from repro.core import scheduling as jax_scheduling
from repro.core import simulator as jax_simulator
from repro_torch.apps import make_app
from repro_torch.core import extraction, hwmodel, mapping, scheduling, simulator

pytestmark = pytest.mark.torch

APPS = ["gaussian", "harris", "upsample", "unsharp", "camera", "resnet", "mobilenet"]
CASES = [(name, {}) for name in APPS] + [
    ("harris", {"schedule": f"sch{i}"}) for i in range(1, 7)
]
IDS = APPS + [f"harris-sch{i}" for i in range(1, 7)]

JAX = (jax_make_app, jax_scheduling, jax_extraction, jax_mapping, jax_hwmodel)
PORT = (make_app, scheduling, extraction, mapping, hwmodel)


def compile_digest(pkg, name, kw):
    """What ``benchmarks/paper_tables.py`` computes for one app, as plain
    values: schedules, buffers, mapping and cost."""
    mk, sch, ext, mp, hw = pkg
    app = mk(name, **kw)
    opt = sch.schedule_pipeline(app.pipeline, tile_count=app.tile_count)
    seq = sch.schedule_sequential(app.pipeline, tile_count=app.tile_count)
    ex = ext.extract_buffers(app.pipeline, opt)
    mapped = mp.map_design(ex.buffers)
    statements = app.pipeline.stages[-1].domain.size() * app.tile_count
    cost = hw.design_cost(
        ex.total_pe_ops(), mapped, opt.total_completion or opt.completion, statements
    )
    buffers = {
        b: (
            [repr(p) for p in ub.ports],
            ub.capacity_bound(),
            ub.ports_per_cycle(),
            ub.validate(),
        )
        for b, ub in ex.buffers.items()
    }
    return {
        "policy": (opt.policy, opt.ii, opt.completion, opt.total_completion),
        "sequential": (seq.policy, seq.completion, seq.total_completion),
        "schedule": repr(opt),
        "buffers": buffers,
        "output_streams": repr(ex.output_streams),
        "pe_ops": ex.total_pe_ops(),
        "mapped": {b: repr(m) for b, m in mapped.items()},
        "mem_tiles": sum(m.mem_tiles for m in mapped.values()),
        "sram_words": sum(m.sram_words for m in mapped.values()),
        "cost": repr(cost),
    }


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_schedules_buffers_mapping_and_cost_agree(name, kw):
    jx = compile_digest(JAX, name, kw)
    pt = compile_digest(PORT, name, kw)
    assert jx["policy"] == pt["policy"]
    assert jx["sequential"] == pt["sequential"]
    assert jx["schedule"] == pt["schedule"]
    assert jx["buffers"] == pt["buffers"]
    assert jx["output_streams"] == pt["output_streams"]
    assert jx["pe_ops"] == pt["pe_ops"]
    assert jx["mapped"] == pt["mapped"]
    assert (jx["mem_tiles"], jx["sram_words"]) == (pt["mem_tiles"], pt["sram_words"])
    assert jx["cost"] == pt["cost"]


def test_table2_variants_agree():
    jx = jax_hwmodel.table2_variants()
    pt = hwmodel.table2_variants()
    assert list(jx) == list(pt)
    assert {k: repr(v) for k, v in jx.items()} == {k: repr(v) for k, v in pt.items()}


@pytest.mark.parametrize("name,kw", [
    ("gaussian", dict(size=12)),
    ("harris", dict(size=14)),
    ("camera", dict(size=5)),
    ("resnet", dict(img=5, cin=2, cout=2)),
], ids=["gaussian", "harris", "camera", "resnet"])
def test_simulations_agree(name, kw):
    """The cycle-accurate simulator: the same cycle count and the same
    stream values from the same integer inputs."""
    rng = np.random.default_rng(11)
    app_j = jax_make_app(name, **kw)
    inputs = {
        n: rng.integers(1, 40, shape).astype(float)
        for n, shape in app_j.input_extents.items()
    }
    app_p = make_app(name, **kw)
    sch_j = jax_scheduling.schedule_pipeline(app_j.pipeline, tile_count=1)
    sch_p = scheduling.schedule_pipeline(app_p.pipeline, tile_count=1)
    sim_j = jax_simulator.simulate(app_j.pipeline, sch_j, inputs)
    sim_p = simulator.simulate(app_p.pipeline, sch_p, inputs)
    assert (sim_j.cycles, sim_j.reads, sim_j.writes) == (sim_p.cycles, sim_p.reads, sim_p.writes)
    assert sim_j.output_stream == sim_p.output_stream
    assert sim_j.hazards == sim_p.hazards == []
