"""The port's examples on the card (``gpu``; skipped where no CUDA device is
visible), each ``main`` with its defaults' route (``--device cuda
--kernels cuda``) at a small size, its hand-written launches counted.  No
JAX import: a card test runs where only PyTorch is installed."""

from __future__ import annotations

import json
import math

import pytest
import torch

from repro_torch.examples import schedule_explorer, serve_demo, train_lm
from repro_torch.kernels import KERNELS

pytestmark = [pytest.mark.torch, pytest.mark.gpu]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the examples' kernels run only there)")


def _launches():
    torch.cuda.synchronize()
    return {name: k.launches for name, k in KERNELS.items() if k.launches}


def _zero():
    for k in KERNELS.values():
        k.launches = 0


def test_serve_demo_on_card():
    """Decoding launches no hand-written kernel; the failure paths' healthy
    tiles equal the per-tile pipeline bit for bit, with the JAX script's
    counters."""
    _card()
    res = serve_demo.main([])
    assert res["serve"]["deterministic"] and res["serve"]["tokens"] == 4 * serve_demo.MAX_NEW
    f = res["faults"]
    assert f["exact"] and set(f["errors"]) == {"submit", "quarantine", "deadline", "backpressure"}
    s = f["stats"]
    assert (s["poisoned_tiles"], s["deadline_misses"], s["served"], s["failed"]) == (1, 1, 7, 2)


def test_train_lm_on_card_launches_attention_twice_a_layer_and_microbatch():
    """Two steps of llama-100m at batch 4, seq 128: the f32 SIMT attention
    kernel 12 layers x 2 microbatches x 2 (forward, remat's recompute) = 48
    times a step; finite losses."""
    _card()
    _zero()
    res = train_lm.main(["--steps", "2"])
    assert _launches() == {"flash_attention": 2 * 48}
    assert len(res["losses"]) == 2 and all(math.isfinite(x) for x in res["losses"])


def test_schedule_explorer_measured_on_card(tmp_path):
    """A measured search of gaussian on the card: a row of mode ``cuda``
    with the card's name, in the given db only; the winner no slower than
    the heuristic."""
    _card()
    db = tmp_path / "db.json"
    res = schedule_explorer.main(["--apps", "gaussian", "--db", str(db)])
    assert res["rc"] == 0
    r = res["results"]["gaussian"]
    assert r.warm_us <= r.heuristic_warm_us
    (row,) = json.loads(db.read_text())["entries"].values()
    assert row["mode"] == "cuda" and row["device"] == torch.cuda.get_device_name(0)
