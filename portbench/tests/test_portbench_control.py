"""How ``correct`` is decided, at a size the CPU holds: the program's gap
stays under each cell's limit on three seeds while the control (the plain
reference in the precision below the configuration's, put in the program's
place) goes over it; and a run whose timed path is broken underneath comes
out not correct, for each fault a cell can have: an answer altered where it
is produced, and half of a dispatch's batch left out."""

import pytest

from .conftest import CELLS, run_tiny, tiny_cell

SEEDS = (101, 2 ** 31 + 3, 2 ** 33 + 1)


@pytest.mark.parametrize("name", CELLS)
def test_program_under_the_limit_control_over_it(name):
    cell = tiny_cell(name)
    control, limit = cell["config"]["control"], cell["check"]["max_rel_gap"]
    for seed in SEEDS:
        res = run_tiny(cell, seed=seed, controls=[control])
        assert res["correct"], res["checks"]
        assert res["checks"]["max_rel_gap"]["value"] <= limit / 3
        assert res["_controls"][control] >= 3 * limit


def _altered(out):
    """One element of every image moved by 1% of that image's range."""
    out = out.clone()
    flat = out.view(out.shape[0], -1)
    flat[:, flat.shape[1] // 2] += 0.01 * flat.abs().amax(1)
    return out


def _half_left_out(out):
    """Every other slot never computed: its output left as zeros."""
    out = out.clone()
    out[1::2] = 0
    return out


def _break(monkeypatch, kind, fault):
    from repro_torch.backend import PipelineServer, TorchPipeline

    if kind == "resident":
        run = TorchPipeline.run

        def broken(self, inputs):
            bufs = dict(run(self, inputs))
            for k in self.kernels:
                bufs[k.name] = fault(bufs[k.name])
            return bufs

        monkeypatch.setattr(TorchPipeline, "run", broken)
    else:
        seam = PipelineServer._run_pipeline

        def broken(self, pp, ins):
            bufs = dict(seam(self, pp, ins))
            for k in pp.kernels:
                bufs[k.name] = fault(bufs[k.name])
            return bufs

        monkeypatch.setattr(PipelineServer, "_run_pipeline", broken)


@pytest.mark.parametrize("fault", [_altered, _half_left_out], ids=["altered", "half_left_out"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    # full batches in the open loop too, so that a left-out slot holds a request
    cell = tiny_cell(name, **({"rate_per_s": 2000.0} if name.endswith(".open") else {}))
    assert run_tiny(cell)["correct"]
    _break(monkeypatch, cell["traffic"]["kind"], fault)
    res = run_tiny(cell)
    assert not res["correct"]
    assert res["checks"]["max_rel_gap"]["value"] >= 1e-3


def test_a_request_that_fails_is_missing(monkeypatch):
    from repro_torch.backend import PipelineServer

    cell = tiny_cell("resnet18-conv2x.closed")
    seam = PipelineServer._run_pipeline
    calls = []

    def failing(self, pp, ins):
        calls.append(1)
        if len(calls) > 8:             # warm-up and a few dispatches, then every one raises
            raise RuntimeError("planted dispatch failure")
        return seam(self, pp, ins)

    monkeypatch.setattr(PipelineServer, "_run_pipeline", failing)
    res = run_tiny(cell)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["missing"]["value"] == res["failed"]
