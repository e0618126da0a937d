"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``) on reduced configurations, with
``get_config`` and ``SHAPES`` monkeypatched in both packages.

* On a (1, 1) mesh (a fake world of one rank; JAX's one CPU device): the
  same status, plan and model FLOPs; the same argument bytes, but for
  JAX's PRNG key (a uint32[2], 8 B, in the train state; the port's
  generator holds no tensor) and the decode position (an int32 scalar,
  4 B, a Python int in the port); the same dot FLOPs in decode; in prefill
  JAX's less the attention term's difference, by formula: the port's
  prefill runs ``ops.attention_op`` (``models/layers.py``, the kernel,
  charged the causal scores it keeps, S(S+1)/2 a head) where JAX's runs the
  chunked XLA path over all S² scores, so the port counts
  4·head_dim·B·Hq·S(S−1)/2 fewer FLOPs a layer; in train within
  ``TRAIN_TOL``: the port's attention backward is the plain version's
  gradient (blockwise, its forward recomputed, blocks above the diagonal
  skipped) where JAX differentiates the chunked path, and remat's
  recompute is XLA's to schedule (it keeps dbrx's MoE combine rather than
  recomputing it); measured 0.980 (tinyllama) and 1.055 (dbrx) of JAX's.
* On a (2, 2) mesh, one rank's FLOPs against JAX's per-device FLOPs on 4
  forced host devices (a subprocess, ``torch_dist_cases.run_jax``): prefill
  by the same formula over the ranks, within ``PREFILL_TOL`` (XLA also
  splits the MoE routing's queue-position product over the experts, 8192
  FLOPs of dbrx's 210 M), train within ``TRAIN_TOL`` (measured 0.980 and
  1.103).
* A cell that raises is recorded as an ``error`` and fails the CLI.

Fake worlds live in this process only inside ``dryrun.fake_world``
(destroyed on exit); ``import repro.launch.dryrun`` sets ``XLA_FLAGS`` to
512 host devices, so it is imported after JAX has initialised, with the
variable restored."""

from __future__ import annotations

import json
import os
from pathlib import Path

import jax
import pytest
import torch

import repro_torch.launch.dryrun as td
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline import dispatch_cost
from repro_torch.roofline.kernel_cost import kernel_work
from torch_dist_cases import run_jax

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
# small cells of each kind: the train cell in 2 microbatches
CELLS = {
    "p": dict(kind="prefill", seq=64, batch=2),
    "t": dict(kind="train", seq=64, batch=4),
    "d": dict(kind="decode", seq=64, batch=2),
}
# two MoE token groups of 512, one on each data rank
CELLS_2X2 = {"p": dict(kind="prefill", seq=128, batch=8), "t": dict(kind="train", seq=128, batch=16)}
KW = {"p": {}, "t": {"microbatches": 2}, "d": {}}
KV_CHUNK = 16
TRAIN_TOL = 0.15
PREFILL_TOL = 1e-4
ARCHS = ("tinyllama_1_1b", "dbrx_132b")
EXTRA_ARG_BYTES = {"p": 0, "t": 8, "d": 4}     # JAX's PRNG key; its decode position


def _attention_gap(arch: str, batch: int, seq: int, ranks: int = 1) -> float:
    """The prefill FLOPs JAX's chunked attention computes above the causal
    diagonal, on one of ``ranks`` ranks that split batch and heads evenly."""
    cfg = torch_get_config(arch).reduced()
    return 4 * cfg.head_dim * batch * cfg.n_heads * seq * (seq - 1) / 2 * cfg.n_layers / ranks


def _reduced(monkeypatch):
    monkeypatch.setattr(td, "get_config", lambda a: torch_get_config(a).reduced())
    monkeypatch.setitem(td.SHAPES, "p", CELLS["p"])
    monkeypatch.setitem(td.SHAPES, "t", CELLS["t"])
    monkeypatch.setitem(td.SHAPES, "d", CELLS["d"])


@pytest.fixture(scope="module")
def jax_dryrun():
    jax.devices()                      # JAX initialised before XLA_FLAGS is touched
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


@pytest.fixture(scope="module")
def jax_1x1(jax_dryrun):
    """JAX's reports of every reduced cell on a (1, 1) mesh."""
    from repro.launch.mesh import make_mesh as jax_make_mesh

    jd = jax_dryrun
    mp = pytest.MonkeyPatch()
    mp.setattr(jd, "get_config", lambda a: jax_get_config(a).reduced())
    for k, v in CELLS.items():
        mp.setitem(jd.SHAPES, k, v)
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    try:
        return {(a, s): jd.lower_cell(a, s, mesh=mesh, kv_chunk=KV_CHUNK, **KW[s])[1]
                for a in ARCHS for s in CELLS}
    finally:
        mp.undo()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", list(CELLS))
def test_reduced_cell_on_1x1_matches_jax(monkeypatch, jax_1x1, arch, kind):
    _reduced(monkeypatch)
    with td.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="fake")
        cost, got = td.lower_cell(arch, kind, mesh=mesh, kv_chunk=KV_CHUNK, **KW[kind])
    want = jax_1x1[(arch, kind)]
    assert got["status"] == want["status"] == "ok"
    assert got["plan"] == want["plan"]
    assert got["roofline"]["model_flops"] == want["roofline"]["model_flops"]
    assert got["memory"]["argument_bytes_per_chip"] + EXTRA_ARG_BYTES[kind] == \
        want["memory"]["argument_bytes_per_chip"]
    flops, jflops = got["roofline"]["flops"], want["roofline"]["flops"]
    if kind == "p":
        assert flops == jflops - _attention_gap(arch, CELLS["p"]["batch"], CELLS["p"]["seq"])
        assert cost.kernels == {"flash_attention": torch_get_config(arch).reduced().n_layers}
    elif kind == "d":
        assert flops == jflops and cost.kernels == {}
    else:
        assert flops == pytest.approx(jflops, rel=TRAIN_TOL)
        assert got["microbatches"] == 2
    assert got["memory"]["fits_80gb"] and got["memory"]["temp_bytes_per_chip"] > 0


JAX_2X2 = r"""
import json, os
import jax
import numpy as np
jax.devices()
import repro.launch.dryrun as jd
from repro.configs import get_config
from repro.launch.mesh import make_mesh
cells = json.loads(os.environ["DRYRUN_CELLS"])
jd.get_config = lambda a: get_config(a).reduced()
jd.SHAPES.update(cells)
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch in json.loads(os.environ["DRYRUN_ARCHS"]):
    for s in cells:
        _, rep = jd.lower_cell(arch, s, mesh=mesh, kv_chunk=16,
                               **({"microbatches": 2} if s == "t" else {}))
        out[f"{arch}/{s}"] = rep["roofline"]["flops"]
np.savez(ROOT_DIR + "/jax_out.npz", **{k: np.array(v) for k, v in out.items()})
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def jax_2x2(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun-2x2")
    os.environ["DRYRUN_CELLS"], os.environ["DRYRUN_ARCHS"] = json.dumps(CELLS_2X2), \
        json.dumps(ARCHS)
    try:
        return run_jax(JAX_2X2, root, devices=4)
    finally:
        del os.environ["DRYRUN_CELLS"], os.environ["DRYRUN_ARCHS"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", list(CELLS_2X2))
def test_per_rank_flops_on_2x2_match_jax(monkeypatch, jax_2x2, arch, kind):
    monkeypatch.setattr(td, "get_config", lambda a: torch_get_config(a).reduced())
    monkeypatch.setitem(td.SHAPES, kind, CELLS_2X2[kind])
    with td.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="fake")
        _, got = td.lower_cell(arch, kind, mesh=mesh, kv_chunk=KV_CHUNK, **KW[kind])
    assert got["chips"] == 4 and got["mesh"] == {"data": 2, "model": 2}
    flops, jflops = got["roofline"]["flops"], float(jax_2x2[f"{arch}/{kind}"])
    if kind == "p":
        info = CELLS_2X2["p"]
        gap = _attention_gap(arch, info["batch"], info["seq"], ranks=4)
        assert flops == pytest.approx(jflops - gap, rel=PREFILL_TOL)
    else:
        assert flops == pytest.approx(jflops, rel=TRAIN_TOL)
    assert sum(got["roofline"]["collective_bytes"].values()) > 0


def test_a_failing_cell_is_an_error_and_fails_the_cli(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(td, "RESULTS_DIR", str(tmp_path))

    def broken(*a, **k):
        raise RuntimeError("planner fault")

    monkeypatch.setattr(td, "make_plan", broken)
    rc = td.main(["--arch", "tinyllama-1.1b", "--shape", "prefill_32k", "--force"])
    assert rc == 1
    assert "ERROR RuntimeError: planner fault" in capsys.readouterr().out
    rep = json.loads((tmp_path / "tinyllama_1_1b__prefill_32k__sp.json").read_text())
    assert rep["status"] == "error" and "planner fault" in rep["trace"]


def test_full_attention_long_context_is_skipped(monkeypatch, tmp_path):
    monkeypatch.setattr(td, "RESULTS_DIR", str(tmp_path))
    assert td.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k", "--force"]) == 0
    rep = json.loads((tmp_path / "tinyllama_1_1b__long_500k__sp.json").read_text())
    assert rep["status"] == "skipped" and "sub-quadratic" in rep["why"]


def test_dryrun_results_exist_and_are_complete():
    """The 40-cell x 2-mesh set the sweep writes (``--all``, ``--all
    --multi-pod``): 14 full-attention ``long_500k`` cells skipped, every
    other cell ``ok`` with FLOPs and a memory verdict."""
    d = ROOT / "results" / "dryrun_torch"
    if not d.is_dir() or len(os.listdir(d)) < 80:
        pytest.skip("full dry-run sweep artifacts not present")
    n_ok = n_skip = 0
    for f in sorted(os.listdir(d)):
        r = json.loads((d / f).read_text())
        assert r["status"] in ("ok", "skipped"), (f, r.get("error"))
        if r["status"] == "ok":
            n_ok += 1
            assert r["roofline"]["flops"] > 0, f
            assert isinstance(r["memory"]["fits_80gb"], bool), f
        else:
            n_skip += 1
    assert n_ok == 66 and n_skip == 14


UNEVEN = {"heads": {}, "context": {"n_heads": 6}}


@pytest.mark.parametrize("strategy", list(UNEVEN))
@pytest.mark.parametrize("kind", list(CELLS))
def test_cells_trace_where_heads_do_not_divide_the_model_axis(monkeypatch, strategy, kind):
    """Reduced tinyllama on a fake (1, 4) world: its 2 KV heads split over 4
    model ranks (``layers.split_heads`` gathers the projection first, and
    decode's query and output where they are reshaped); with 6 query heads
    the plan is ``context`` and the output projection's gradient is gathered
    before its heads are unflattened (``layers.merge_heads``).  The full-size
    sweep meets both (tinyllama's 4 KV heads, qwen3-14b's 40 heads, over 16).

    The context plan's model ranks each run their own 16 query rows of the
    64 at their offset (``layers.on_local_heads``); the cell is traced as
    the last one (offset 48), which the report names, and is refused on
    rank 0.  Its attention kernels are charged ``kernel_work`` at offset 48:
    16·48 + 16·17/2 scores a head against the whole sequence's 64·65/2
    that each rank ran before, 0.435 of it (7/16 as S grows)."""
    monkeypatch.setattr(td, "get_config",
                        lambda a: torch_get_config(a).reduced(**UNEVEN[strategy]))
    monkeypatch.setitem(td.SHAPES, kind, CELLS[kind])
    charged = []

    def work(name, args, out, *a, **kw):
        res = kernel_work(name, args, out, *a, **kw)
        charged.append((tuple(args[0].shape), tuple(args[1].shape), kw.get("q_offset"), res[1]))
        return res

    monkeypatch.setattr(dispatch_cost, "kernel_work", work)
    last = 3 if strategy == "context" else 0
    with td.fake_world(4, rank=last):
        mesh = make_mesh((1, 4), ("data", "model"), device_type="fake")
        cost, got = td.lower_cell("tinyllama_1_1b", kind, mesh=mesh, kv_chunk=KV_CHUNK,
                                  **KW[kind])
    # the plan's note on a context plan takes the "attn" key, as in the JAX report
    assert got["status"] == "ok" and strategy in got["plan"]["attn"]
    assert cost.total_flops > 0 and got["memory"]["fits_80gb"]
    assert got["rank"] == {"rank": last, "coordinate": {"data": 0, "model": last}}
    if strategy == "heads":
        return
    with td.fake_world(4):
        mesh = make_mesh((1, 4), ("data", "model"), device_type="fake")
        with pytest.raises(ValueError, match="trace_rank"):
            td.lower_cell("tinyllama_1_1b", kind, mesh=mesh, kv_chunk=KV_CHUNK, **KW[kind])
    if kind == "d":
        assert not charged        # decode reads the cache, not the kernel
        return
    seq = CELLS[kind]["seq"]
    assert charged and len(charged) == sum(cost.kernels.values())
    for q_shape, k_shape, off, ops_ in charged:
        bh, sq, d = q_shape
        assert (sq, k_shape[1], off) == (seq // 4, seq, 3 * seq // 4)
        meta = [torch.empty(sh, device="meta") for sh in (q_shape, k_shape, k_shape)]
        assert ops_ == kernel_work("flash_attention", meta, meta[0], q_offset=off)[1]
        replicated = 4 * d * bh * seq * (seq + 1) // 2
        assert ops_ / replicated == pytest.approx((16 * 48 + 16 * 17 / 2) / (64 * 65 / 2))
        assert ops_ < replicated / 2
