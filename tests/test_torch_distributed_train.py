"""The port's ``distributed/`` on 3 and 4 gloo ranks: three reduced models on
a 1×3 ``model`` mesh (the sequence divides 3) — tinyllama under the
``context`` strategy on the attention kernel's route and on ring attention,
qwen2-moe with tensor parallelism inside its experts (``tp``) — against the
unsharded port and the JAX package; a two-microbatch AdamW step of
tinyllama on a 2×2 (data, model) mesh with ZeRO gradient layouts
(``zero_shardings``) against the unsharded step; greedy decoding of its
weights with the cache placed by ``kv_cache_specs``, token for token with
the unsharded engine; the checkpoint that step wrote on 2×2 restored on
1×3 bit for bit; and the loss and gradients of reduced tinyllama on the
1×3 mesh under the ``context`` plan, where each model rank runs the
attention on its own S/3 query rows at offsets 0, 8 and 16, against the
unsharded port and JAX (each gradient leaf relative to its own largest
value, as the (2, 2, 2) case of ``test_torch_dryrun_multipod.py``).

Tolerances as in ``test_torch_distributed_ranks.py``: 1e-5 against the
unsharded port, 1e-4 against JAX; the sharded step's loss, gradient norm
and first moments within 1e-5 of the unsharded step's (each relative to
its largest value: the reductions over shards run in another order), its
parameters within 1e-4: AdamW's first step divides each gradient entry by
its own magnitude, so an entry near zero carries its large relative
rounding difference into a step of up to ``lr`` (1.14e-5 measured)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import model as jm
from torch_dist_cases import (
    JAX_TOL, SHARD_TOL, check_model, close, flat, model_inputs, models_case, run_worker,
)
from torch_dist_worker import B, CONTEXT_ARCH, KV_CHUNK, MOE_ARCH, S, TRAIN_ARCH, TRAIN_OVER

pytestmark = pytest.mark.torch

CASES_1X3 = [
    ("tinyllama", "context/none", "attention_op=4"),
    ("tinyllama-ring", "context/none", "ring=4"),
    ("qwen2moe", "context/tp", "attention_op=4"),
]


@pytest.fixture(scope="module")
def models_1x3(tmp_path_factory):
    return models_case("models-1x3", tmp_path_factory.mktemp("models-1x3"))


@pytest.mark.parametrize("label,strategy,routes", CASES_1X3, ids=[c[0] for c in CASES_1X3])
def test_sharded_models_on_1x3_match_unsharded_and_jax(models_1x3, label, strategy, routes):
    check_model(*models_1x3, label, strategy, routes)


@pytest.fixture(scope="module")
def train_and_restore(tmp_path_factory):
    cfg = jax_get_config(TRAIN_ARCH).reduced(**TRAIN_OVER)
    params = jm.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    rng = np.random.default_rng(4)
    b = 2 * B        # two microbatches of B, each split over data
    inputs = flat(params, "params")
    inputs["batch/tokens"] = rng.integers(0, cfg.vocab, (b, S)).astype(np.int64)
    inputs["batch/labels"] = rng.integers(0, cfg.vocab, (b, S)).astype(np.int64)
    root = tmp_path_factory.mktemp("train")
    trained = run_worker("train", root, inputs)
    restored = run_worker("restore", root, {"unused": np.zeros(1)})
    return trained, restored


@pytest.fixture(scope="module")
def moe_step(tmp_path_factory):
    """Reduced dbrx's parameters and two seeded batches of two microbatches
    of B rows: S 24 (48 tokens, one MoE group, whole on both data ranks)
    and S 512 (two groups of 512, one on each data rank)."""
    cfg = jax_get_config(MOE_ARCH).reduced()
    params = jm.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    rng = np.random.default_rng(6)
    inputs = flat(params, "params")
    for tag, s in (("batch", S), ("batch-long", 512)):
        for k in ("tokens", "labels"):
            inputs[f"{tag}/{k}"] = rng.integers(0, cfg.vocab, (2 * B, s)).astype(np.int64)
    return run_worker("train-moe", tmp_path_factory.mktemp("train-moe"), inputs)


@pytest.mark.parametrize("batch", ["batch", "batch-long"])
@pytest.mark.parametrize("tree,tol", [("loss", SHARD_TOL), ("grad_norm", SHARD_TOL),
                                      ("params", JAX_TOL), ("m", SHARD_TOL)])
def test_moe_zero_step_under_expert_parallelism_matches_unsharded(moe_step, batch, tree, tol):
    """Reduced dbrx's step on 2x2 ranks, its 4 experts over the 2 model
    ranks: the expert pass runs on each rank's own experts and each
    gradient is summed over the ranks that did not compute it
    (``moe._on_local_experts``), whether the tokens are whole on the data
    ranks or split over them; the same tolerances as the dense step."""
    out = _leaves(moe_step, batch)
    assert str(out["strategy"]) == "heads/ep"
    if tree in ("loss", "grad_norm"):
        close(out[tree], out[f"{tree}_unsharded"], tol)
        return
    got, want = _leaves(out, tree), _leaves(out, f"{tree}_unsharded")
    assert sorted(got) == sorted(want) and any("moe" in k for k in got)
    for k in got:
        close(got[k], want[k], tol)


def _leaves(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


@pytest.mark.parametrize("what", ["loss", "grad_norm"])
def test_zero_grad_step_metrics_match_unsharded(train_and_restore, what):
    trained, _ = train_and_restore
    close(trained[what], trained[f"{what}_unsharded"], SHARD_TOL)


@pytest.mark.parametrize("tree,tol", [("params", JAX_TOL), ("m", SHARD_TOL)])
def test_zero_grad_step_state_matches_unsharded(train_and_restore, tree, tol):
    trained, _ = train_and_restore
    got, want = _leaves(trained, tree), _leaves(trained, f"{tree}_unsharded")
    assert sorted(got) == sorted(want) and got
    for k in got:
        close(got[k], want[k], tol)


def test_zero_grad_layouts(train_and_restore):
    """The gradient accumulator of ``wq`` (L 2, 64, 64 on data 2 x model 2)
    is split over data on its largest free dim, on top of its column split
    over model; its AdamW moment keeps the parameter's layout."""
    trained, _ = train_and_restore
    assert str(trained["zero_wq_spec"]) == "PartitionSpec(None, 'data', 'model')"
    assert list(trained["m_wq_placements"]) == ["Replicate()", "Shard(dim=2)"]


def test_sharded_cache_decode_matches_unsharded(train_and_restore):
    """``ServeEngine`` with the plan: the cache (L, B 4, H, S 12, D) laid out
    by ``kv_cache_specs`` (batch over data, the sequence over model), every
    greedy token equal to the unsharded engine's on the same weights (the
    sharded step's, gathered)."""
    trained, _ = train_and_restore
    assert list(trained["cache_k_placements"]) == ["Shard(dim=1)", "Shard(dim=3)"]
    assert np.array_equal(trained["decode_tokens"], trained["decode_tokens_unsharded"])
    assert trained["decode_tokens"].shape == (4, 5)


def test_checkpoint_from_2x2_restores_on_1x3(train_and_restore):
    trained, restored = train_and_restore
    assert int(restored["step"]) == 1 and int(restored["meta_step"]) == 1
    # w1 (L 2, 64, 96) column-split over model: 3 ranks of 32 columns
    assert list(restored["w1_placements"]) == ["Replicate()", "Shard(dim=2)"]
    assert list(restored["w1_local_shape"]) == [2, 64, 32]
    for tree in ("params", "m"):
        got, want = _leaves(restored, tree), _leaves(trained, tree)
        assert sorted(got) == sorted(want) and got
        for k in got:
            assert np.array_equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def train_context(tmp_path_factory):
    """(rank 0's output of the worker's ``train-context`` case, the JAX
    package's loss and gradient leaves on the same parameters and batch)."""
    cfg, params, batch, inputs = model_inputs("context", CONTEXT_ARCH, {}, 20, B, S)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: jm.forward_train(cfg, p, jb, kv_chunk=KV_CHUNK, remat=False)[0])(params)
    out = run_worker("train-context", tmp_path_factory.mktemp("train-context"), inputs)
    return out, np.asarray(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def test_context_step_runs_each_ranks_own_query_rows(train_context):
    """Each of the 3 model ranks runs the attention on its own S/3 = 8
    query rows over the 24 keys, at offsets 0, 8 and 16 (every layer)."""
    out = train_context[0]
    assert str(out["strategy"]) == "context/none"
    assert out["attention_calls"].tolist() == [[[S // 3, S, r * S // 3]] for r in range(3)]


@pytest.mark.parametrize("against,tol", [("unsharded", SHARD_TOL), ("jax", JAX_TOL)])
def test_context_step_loss_matches(train_context, against, tol):
    out, jax_loss, _ = train_context
    close(out["loss"], out["loss_unsharded"] if against == "unsharded" else jax_loss, tol)


@pytest.mark.parametrize("against,tol", [("unsharded", SHARD_TOL), ("jax", JAX_TOL)])
def test_context_step_gradients_match(train_context, against, tol):
    """Every gradient leaf within ``tol`` of its own largest value: the K
    and V projections' among them, each rank's part of a sum over the model
    ranks (a ``Partial`` gradient placement in ``on_local_heads``)."""
    out, _, jax_grads = train_context
    n = sum(k.startswith("grad/") for k in out)
    assert n == len(jax_grads) and n == sum(k.startswith("grad_unsharded/") for k in out)
    for i in range(n):
        got = out[f"grad/{i}"]
        want = out[f"grad_unsharded/{i}"] if against == "unsharded" else jax_grads[i]
        assert got.shape == want.shape and np.abs(want).max() > 0
        err = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
        assert err <= tol, (i, err)
