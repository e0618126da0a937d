"""The port's MoE, VLM, audio, hybrid and SSM architectures held against
the JAX package, in f32.

Each of qwen2-moe-a2.7b, dbrx-132b, pixtral-12b, musicgen-medium,
zamba2-7b and mamba2-2.7b at its ``reduced()`` width, with the JAX
package's parameters carried over by ``params_from_jax``:
``forward_train``'s loss, nll and aux, ``forward_prefill``'s logits and 4
``decode_step``s with their caches, within 1e-4 relative
(``torch_model_cases``).  Also the replayed
``test_decode_matches_forward_ssm`` and the routes: a mamba2 block calls
``ops.ssd_op`` once per batch row, zamba2's shared attention and every
MoE, VLM and audio layer ``ops.attention_op``.
"""

from __future__ import annotations

import pytest

from torch_model_cases import check_decode_matches_forward, check_train_prefill_decode, count_routes

pytestmark = pytest.mark.torch

OTHER = ["qwen2_moe_a2_7b", "dbrx_132b", "pixtral_12b", "musicgen_medium", "zamba2_7b",
         "mamba2_2_7b"]


@pytest.mark.parametrize("arch", OTHER)
def test_reduced_train_prefill_decode_match_jax(arch):
    check_train_prefill_decode(arch)


def test_decode_matches_forward_ssm():
    check_decode_matches_forward("mamba2_2_7b", 6)


def test_decode_matches_forward_hybrid():
    """The same equivalence for zamba2's shared-attention cache, indexed by
    application (4 layers, the shared block after layers 1 and 3)."""
    check_decode_matches_forward("zamba2_7b", 7)


@pytest.mark.parametrize(
    "arch,overrides,calls,routes",
    [
        ("mamba2_2_7b", {}, {"attention_op": 0, "ssd_op": 4}, {"ssd_op": 4}),
        ("zamba2_7b", {"n_layers": 4}, {"attention_op": 2, "ssd_op": 8},
         {"ssd_op": 8, "attention_op": 2}),
        ("qwen2_moe_a2_7b", {}, {"attention_op": 2, "ssd_op": 0}, {"attention_op": 2}),
        ("pixtral_12b", {}, {"attention_op": 2, "ssd_op": 0}, {"attention_op": 2}),
        ("musicgen_medium", {}, {"attention_op": 2, "ssd_op": 0}, {"attention_op": 2}),
    ],
)
def test_routes(arch, overrides, calls, routes, monkeypatch):
    """One eager prefill of batch 2: the ``ops`` calls match the route rule."""
    got_calls, got_routes = count_routes(arch, monkeypatch, **overrides)
    assert got_calls == calls
    assert got_routes == routes

