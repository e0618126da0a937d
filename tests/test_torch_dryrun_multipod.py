"""The port's models with the batch split over two mesh dims, (pod, data),
and the vocabulary, heads and cached positions over ``model``: the layout
of the dry run's (2, 16, 16) cells, cut to a fake (2, 2, 2) world.

* Per-rank peak bytes (``launch.dryrun.lower_cell`` on meta tensors): a
  reduced train cell (qwen3-14b, a vocabulary of 4096 so that the logits
  weigh) and the SSM prefill cells (mamba2-2.7b, zamba2-7b) on (2, 2, 2)
  with twice the batch of the same cell on a fake (2, 2) (data, model)
  world.  Each rank then holds the same rows in both, so its peak must be
  no higher on (2, 2, 2).  It was higher where a rank held more than its
  rows: the loss's logits gradient, whole over the batch and the
  vocabulary (DTensor's ``logsumexp`` over a batch split over two mesh
  dims; now ``model._vocab_parallel_nll``), and ``ssm.causal_conv1d``'s
  zero accumulator and tail, made as plain tensors of the global shape
  (whole on every rank, and the ``cat`` took the input whole over
  ``data``; now made like the input).  With the same global batch on both
  worlds the data axis of 2 hides the second fault (the input gathered
  over ``data`` is the (2, 2) rank's rows), which the (2, 16, 16) cells
  showed 16-fold.  The FLOPs a rank runs are the same on both worlds.
* The decode cell (reduced dbrx-132b, its cache's batch over (pod, data))
  traces: decode attention runs on each rank's own rows and positions
  (``layers.decode_attention``), where DTensor's rules took that
  batch to a partial layout torch 2.11 refuses.
* On 8 gloo ranks (``tests/torch_dist_worker.py multipod``, a (2, 2, 2)
  mesh): the loss and every gradient of reduced tinyllama, of tinyllama
  with one KV head (whole on the model ranks, which split the q heads) and
  of mamba2 (its heads over the model ranks), and tinyllama's greedy
  decode with the cache's batch over (pod, data) and its positions over
  ``model``, against the unsharded port: the loss within 1e-5 of
  max(1, |loss|) as the other gloo cases, each gradient leaf within 1e-5
  of its own largest value (a leaf of small values is held to its own
  scale: mamba2's B, C and decay gradients, 1e-7 to 1e-5, took a model
  rank's or a data rank's part of a sum for the whole,
  ``ssm._ssd_rows``); and each loss within 1e-4 of the JAX package's on
  the same parameters and batch."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import repro_torch.launch.dryrun as td
from repro.models import model as jm
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from torch_dist_cases import JAX_TOL, SHARD_TOL, close, model_inputs, run_worker
from torch_dist_worker import KV_CHUNK as WORKER_KV_CHUNK, MULTIPOD_B, MULTIPOD_RUNS, S

pytestmark = pytest.mark.torch

WORLDS = {"2x2": ((2, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (arch, overrides of ``reduced()``, the cell on (2, 2); (2, 2, 2) takes twice the batch)
PEAK_CELLS = {
    "train-qwen3": ("qwen3_14b", {"vocab": 4096}, dict(kind="train", seq=64, batch=16)),
    "prefill-mamba2": ("mamba2_2_7b", {}, dict(kind="prefill", seq=128, batch=8)),
    "prefill-zamba2": ("zamba2_7b", {}, dict(kind="prefill", seq=128, batch=8)),
}
KV_CHUNK = 16


def _cell(monkeypatch, arch, over, info, world):
    """(the rank's ``Cost``, the report) of a reduced cell on a fake world."""
    monkeypatch.setattr(td, "get_config", lambda a: get_config(a).reduced(**over))
    monkeypatch.setitem(td.SHAPES, "x", info)
    shape, names = WORLDS[world]
    with td.fake_world(int(np.prod(shape))):
        mesh = make_mesh(shape, names, device_type="fake")
        return td.lower_cell(arch, "x", mesh=mesh, kv_chunk=KV_CHUNK,
                             **({"microbatches": 2} if info["kind"] == "train" else {}))


@pytest.mark.parametrize("cell", list(PEAK_CELLS))
def test_peak_on_2x2x2_no_higher_than_on_2x2_at_the_same_rows(monkeypatch, cell):
    arch, over, info = PEAK_CELLS[cell]
    cost, rep = _cell(monkeypatch, arch, over, info, "2x2")
    cost_mp, rep_mp = _cell(monkeypatch, arch, over, {**info, "batch": 2 * info["batch"]},
                            "2x2x2")
    assert rep["status"] == rep_mp["status"] == "ok"
    assert rep_mp["memory"]["argument_bytes_per_chip"] <= rep["memory"]["argument_bytes_per_chip"]
    assert cost_mp.peak_live_bytes <= cost.peak_live_bytes, (cost_mp.peak_live_bytes,
                                                             cost.peak_live_bytes)
    assert cost_mp.total_flops == cost.total_flops
    if info["kind"] == "prefill":
        assert cost_mp.bytes <= cost.bytes


def test_decode_cell_traces_on_2x2x2(monkeypatch):
    cost, rep = _cell(monkeypatch, "dbrx_132b", {}, dict(kind="decode", seq=64, batch=8),
                      "2x2x2")
    assert rep["status"] == "ok" and rep["plan"]["moe"] == "ep"
    assert cost.total_flops > 0 and cost.collectives.get("all-reduce", 0) > 0


@pytest.fixture(scope="module")
def multipod(tmp_path_factory):
    """(rank 0's output of the worker's case, the JAX package's loss of
    each run on the same parameters and batch)."""
    inputs, losses = {}, {}
    for i, (label, arch, over) in enumerate(MULTIPOD_RUNS):
        cfg, params, batch, ins = model_inputs(label, arch, over, 10 + i, MULTIPOD_B, S)
        inputs.update(ins)
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
        losses[label] = np.asarray(jm.forward_train(cfg, params, jb, kv_chunk=WORKER_KV_CHUNK,
                                                    remat=False)[0])
    return run_worker("multipod", tmp_path_factory.mktemp("multipod"), inputs), losses


@pytest.mark.parametrize("label", [r[0] for r in MULTIPOD_RUNS])
def test_multipod_loss_matches_jax(multipod, label):
    out, losses = multipod
    close(out[f"{label}/loss"], losses[label], JAX_TOL)


@pytest.mark.parametrize("label", [r[0] for r in MULTIPOD_RUNS])
def test_multipod_loss_and_gradients_match_unsharded(multipod, label):
    multipod = multipod[0]
    close(multipod[f"{label}/loss"], multipod[f"{label}/loss_unsharded"], SHARD_TOL)
    n = sum(k.startswith(f"{label}/grad/") for k in multipod)
    assert n and n == sum(k.startswith(f"{label}/grad_unsharded/") for k in multipod)
    for i in range(n):
        got, want = multipod[f"{label}/grad/{i}"], multipod[f"{label}/grad_unsharded/{i}"]
        assert got.shape == want.shape
        err = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
        assert err <= SHARD_TOL, (i, err)


def test_multipod_decode_matches_unsharded(multipod):
    multipod = multipod[0]
    assert list(multipod["tinyllama/cache_k_placements"]) == [
        "Shard(dim=1)", "Shard(dim=1)", "Shard(dim=3)"]
    got, want = multipod["tinyllama/decode_tokens"], multipod["tinyllama/decode_tokens_unsharded"]
    assert got.shape == (MULTIPOD_B, 5) and np.array_equal(got, want)
