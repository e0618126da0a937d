"""The port's ``distributed/`` on 4 gloo ranks against the JAX package on 4
forced host devices: ring attention (plain and windowed) and the GPipe
schedule over ``pod``; then four reduced models sharded on a 2×2 (data,
model) mesh — tinyllama (heads, KV sharded), gemma3 (heads, its one KV head
replicated), dbrx (MoE ``ep``), mamba2 (SSM heads) — their ``forward_train``
loss and ``forward_prefill`` logits against the unsharded port and against
the JAX package's ``forward_train`` / ``forward_prefill`` on the same
parameters, all on the ``kernels="eager"`` route, whose local launches are
the kernel route's (``ops.attention_op`` / ``ops.ssd_op`` on each rank's
shards).

Tolerances: the sharded port against the unsharded port within 1e-5
relative to the largest value (the same f32 math, with the reductions over
shards in another order); against JAX within 1e-4, the model parity tests'
``TOL``; ring attention and the pipeline within the JAX tests' own 2e-4 and
2e-5."""

from __future__ import annotations

import numpy as np
import pytest

from torch_dist_cases import check_model, models_case, run_jax, run_worker

pytestmark = pytest.mark.torch

RING_JAX = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.ring_attention import ring_attention
from repro.distributed.pipeline import pipeline_forward
from repro.launch.mesh import make_mesh, mesh_context

ins = dict(np.load(ROOT_DIR + "/inputs.npz"))
q, k, v = (jnp.asarray(ins[n]) for n in ("q", "k", "v"))
mesh = make_mesh((4,), ("model",))
with mesh_context(mesh):
    plain = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh))(q, k, v)
    window = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh, window=16))(q, k, v)
pmesh = make_mesh((4,), ("pod",))
fn = pipeline_forward(lambda w, x, stage: jnp.tanh(x @ w), pmesh)
with mesh_context(pmesh):
    outs = jax.jit(fn)(jnp.asarray(ins["ws"]), jnp.asarray(ins["micro"]))
np.savez(ROOT_DIR + "/jax_out.npz", plain=np.asarray(plain), window=np.asarray(window),
         outs=np.asarray(outs))
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def ring_and_pipeline(tmp_path_factory):
    """The port's ring attention and pipeline on 4 gloo ranks and the JAX
    package's on 4 forced host devices, on the same seeded inputs (the JAX
    tests' shapes: b 2, s 64, hq 4, hkv 2, d 16; 4 stages of 16×16, 6
    microbatches of 8)."""
    rng = np.random.default_rng(0)
    b, s, hq, hkv, d = 2, 64, 4, 2, 16
    inputs = {
        "q": rng.standard_normal((b, s, hq, d)).astype(np.float32),
        "k": rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        "v": rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        "ws": (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
        "micro": rng.standard_normal((6, 8, 16)).astype(np.float32),
    }
    root = tmp_path_factory.mktemp("ring")
    ring = run_worker("ring", root / "ring", inputs)
    pipe = run_worker("pipeline", root / "pipeline", inputs)
    np.savez(root / "inputs.npz", **inputs)
    return {**ring, **pipe}, run_jax(RING_JAX, root), inputs


@pytest.mark.parametrize("variant", ["plain", "window"])
def test_ring_attention_matches_jax(ring_and_pipeline, variant):
    got, want, _ = ring_and_pipeline
    np.testing.assert_allclose(got[variant], want[variant], rtol=2e-4, atol=2e-4)


def test_pipeline_matches_jax(ring_and_pipeline):
    got, want, ins = ring_and_pipeline
    np.testing.assert_allclose(got["outs"], want["outs"], rtol=2e-5, atol=2e-5)
    # and the 4 stages applied in turn to every microbatch
    ref = ins["micro"]
    for st in range(4):
        ref = np.tanh(ref @ ins["ws"][st])
    np.testing.assert_allclose(got["outs"], ref, rtol=2e-5, atol=2e-5)


# (label, the plan's attention/moe strategies, the routes a sharded
# forward_train + forward_prefill of the 2-layer model takes)
CASES_2X2 = [
    ("tinyllama", "heads/none", "attention_op=4"),
    ("gemma3", "heads/none", "attention_op=2,windowed=2"),
    ("dbrx", "heads/ep", "attention_op=4"),
    # ssd_op counts the rows a rank launches: 1 of B 2 on each data rank,
    # 2 layers x 2 forwards
    ("mamba2", "none/none", "ssd_op=4"),
]


@pytest.fixture(scope="module")
def models_2x2(tmp_path_factory):
    return models_case("models-2x2", tmp_path_factory.mktemp("models-2x2"))


@pytest.mark.parametrize("label,strategy,routes", CASES_2X2, ids=[c[0] for c in CASES_2X2])
def test_sharded_models_on_2x2_match_unsharded_and_jax(models_2x2, label, strategy, routes):
    check_model(*models_2x2, label, strategy, routes)
