"""The traffic generators: seeded schedules that repeat, the open loop's
Poisson rate, the closed loop's callers and the resident pool."""

import numpy as np
import pytest
import torch

from portbench.harness import Run
from portbench.traffic import open as open_loop

from .conftest import CELLS, run_tiny, tiny_cell


def _schedule(seed, rate=26.0, seconds=20.0, pool=16):
    run = Run(tiny_cell("harris2048.open"), seed, seconds, 0.0, device="cpu")
    return open_loop.schedule(rate, pool, seconds, run.rng(0), run.rng(1))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 3])
def test_open_schedule_repeats_for_a_seed(seed):
    (a, p), (b, q) = _schedule(seed), _schedule(seed)
    assert np.array_equal(a, b) and np.array_equal(p, q)
    c, _ = _schedule(seed + 1)
    assert not np.array_equal(a, c)


def test_open_schedule_offers_the_same_work_on_every_seed():
    gaps = set()
    for s in range(20):
        arr, picks = _schedule(s)
        assert len(arr) == 520 and np.all(np.diff(arr) > 0)
        assert arr[0] == 0.0 and arr[-1] < 20.0
        assert picks.min() >= 0 and picks.max() < 16
        gaps.add(tuple(np.round(np.sort(np.diff(np.append(arr, 20.0))), 9)))
    assert len(gaps) == 1                          # one set of gaps, another order a seed


def test_open_schedule_is_poisson_at_its_rate():
    arr, _ = _schedule(11, rate=1000.0, seconds=40.0)
    gaps = np.diff(arr)
    # exponential gaps: mean 1/rate, coefficient of variation 1
    assert abs(gaps.mean() * 1000.0 - 1.0) < 0.01
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.03
    # counts in 1 s bins: Poisson, variance equal to the mean
    counts = np.histogram(arr, bins=40, range=(0, 40))[0]
    assert abs(counts.var() / counts.mean() - 1.0) < 0.6


@pytest.mark.parametrize("name", CELLS)
def test_pool_repeats_for_a_seed(name):
    cell = tiny_cell(name)
    a = Run(cell, 2 ** 31 + 9, 1.0, 0.0, device="cpu").pool(5)
    b = Run(cell, 2 ** 31 + 9, 1.0, 0.0, device="cpu").pool(5)
    c = Run(cell, 2 ** 31 + 10, 1.0, 0.0, device="cpu").pool(5)
    for n in a:
        assert torch.equal(a[n], b[n]) and not torch.equal(a[n], c[n])
        shared = cell["config"]["inputs"][n].get("shared")
        assert a[n].shape[0] == (1 if shared else 5)


def test_open_loop_serves_every_request_it_offers():
    res = run_tiny(tiny_cell("harris2048.open", rate_per_s=60.0), seconds=0.5)
    rec = res["_record"]
    assert rec["offered"] == 30 == res["attempted"] == rec["images"]
    assert len(rec["latencies_s"]) == 30 and min(rec["latencies_s"]) > 0
    assert len(rec["lateness_s"]) == 30


def test_closed_loop_keeps_its_callers_busy():
    cell = tiny_cell("resnet18-conv2x.closed")
    rec = run_tiny(cell)["_record"]
    clients, slots = cell["traffic"]["clients"], cell["config"]["batch_slots"]
    # every dispatch after the first serves a full batch of waiting callers
    assert rec["served"] == rec["dispatches"] * slots
    assert rec["attempted"] == rec["images"] and rec["attempted"] >= clients
    assert rec["missing"] == 0


def test_resident_runs_whole_batches():
    cell = tiny_cell("resnet18-conv2x.resident")
    res = run_tiny(cell, trace=True)
    rec = res["_record"]
    assert rec["attempted"] == rec["dispatches"] * cell["config"]["batch_slots"] > 0
    assert len(rec["launch_host_s"]) == 200
