"""The port's sharding planner, mesh helpers and sharding context on the
CPU: ``tests/test_distributed.py``'s seven tests replayed on the port, the
planner held against the JAX package's spec for spec for all ten
architectures on the (16, 16) and (2, 16, 16) production meshes (abstract:
no devices), ``kv_cache_specs`` likewise, and the single-rank cases of the
sharded path (a 1-rank gloo group on a ``FileStore`` under ``tmp_path``):
a sharded forward equal to the unsharded one, ring attention and the
pipeline on one rank, the refusals."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as js
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.models import model as jm
from repro.serve.engine import kv_cache_specs as jax_kv_cache_specs
from repro_torch.configs import get_config
from repro_torch.distributed import context as tctx
from repro_torch.distributed.sharding import (
    P, dp_axes, make_plan, param_shardings, placements, zero_shardings,
)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import model as tm
from repro_torch.serve.engine import kv_cache_specs

pytestmark = pytest.mark.torch

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def fake_mesh(shape=(16, 16), axes=("data", "model")):
    """Abstract mesh for spec math (no devices needed)."""
    return make_abstract_mesh(shape, axes)


def _meta_params(arch):
    return tm.init_params(get_config(arch), None, torch.bfloat16, "meta")


# ---------------------------------------------------------------------------
# tests/test_distributed.py, replayed on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_strategies_are_divisible(arch):
    cfg = get_config(arch)
    plan = make_plan(cfg, fake_mesh())
    if plan.attn_strategy == "heads":
        assert cfg.n_heads % 16 == 0
    if plan.moe_strategy == "ep":
        assert cfg.n_experts % 16 == 0
    if cfg.attention_free:
        assert plan.attn_strategy == "none"


def test_expected_strategies_from_design_doc():
    mesh = fake_mesh()
    expected = {
        "qwen3_14b": ("context", "none"),
        "gemma3_1b": ("context", "none"),
        "glm4_9b": ("heads", "none"),
        "tinyllama_1_1b": ("heads", "none"),
        "qwen2_moe_a2_7b": ("heads", "tp"),
        "dbrx_132b": ("heads", "ep"),
        "pixtral_12b": ("heads", "none"),
        "musicgen_medium": ("context", "none"),
        "zamba2_7b": ("heads", "none"),
        "mamba2_2_7b": ("none", "none"),
    }
    for arch, (attn, moe) in expected.items():
        plan = make_plan(get_config(arch), mesh)
        assert (plan.attn_strategy, plan.moe_strategy) == (attn, moe), arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divide_shapes(arch):
    """Every sharded dim must divide the axis size: DTensor would take an
    uneven shard, so the planner's checks are the only guard."""
    mesh = fake_mesh()
    plan = make_plan(get_config(arch), mesh)
    params = _meta_params(arch)
    shardings = param_shardings(plan, params)
    for (_, leaf), (_, sh) in zip(tm._leaves(params), tm._leaves(shardings)):
        for dim, entry in enumerate(sh.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = 1
            for a in axes:
                n *= mesh.shape[a]
            assert leaf.shape[dim] % n == 0, (arch, leaf.shape, sh.spec)


def test_fsdp_activates_only_for_huge_models():
    mesh = fake_mesh()
    assert make_plan(get_config("dbrx_132b"), mesh).fsdp
    assert not make_plan(get_config("tinyllama_1_1b"), mesh).fsdp


def test_zero_spec_adds_data_once():
    plan = make_plan(get_config("dbrx_132b"), fake_mesh())
    spec = plan.param_spec(("layers", "moe", "w1"), (40, 16, 6144, 10752))
    z = plan.zero_spec(spec, (40, 16, 6144, 10752))
    flat = [e for ent in z if ent for e in (ent if isinstance(ent, tuple) else (ent,))]
    assert flat.count("data") <= 1 and flat.count("model") <= 1


@pytest.fixture
def one_rank(tmp_path):
    """A 1-rank gloo process group (a ``FileStore`` under ``tmp_path``) and
    its (1, 1) host mesh with the production axis names."""
    tmesh.init_distributed("cpu", init_method=f"file://{tmp_path / 'store'}", rank=0,
                           world_size=1)
    try:
        yield tmesh.make_host_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_spmd_forward_on_local_mesh(one_rank):
    """Actually execute a sharded forward on a 1x1 mesh with hints."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import distribute_batch, distribute_tree

    cfg = get_config("tinyllama_1_1b").reduced()
    plan = make_plan(cfg, one_rank)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))),
        "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))),
    }
    with tctx.sharding_context(one_rank, plan), torch.no_grad():
        loss, _ = tm.forward_train(cfg, distribute_tree(params, param_shardings(plan, params)),
                                   distribute_batch(plan, batch), kv_chunk=8, remat=False,
                                   kernels="eager")
    assert isinstance(loss, DTensor)
    # identical to the un-sharded value
    with torch.no_grad():
        loss2, _ = tm.forward_train(cfg, params, batch, kv_chunk=8, remat=False, kernels="eager")
    np.testing.assert_allclose(float(loss.full_tensor()), float(loss2), rtol=1e-6)


def test_kv_cache_specs_shapes():
    cfg = get_config("qwen3_14b")
    plan = make_plan(cfg, fake_mesh())
    cache = tm.init_kv_cache(cfg, 128, 32768, device="meta")
    specs = kv_cache_specs(plan, cache)
    # batch 128 over 16-way data, seq over model (flash-decoding/chaining)
    assert specs["k"][1] in ("data", ("data",))
    assert specs["k"][3] == "model"
    # batch-1 long context: seq over every axis
    cache1 = tm.init_kv_cache(cfg, 1, 524288, device="meta")
    specs1 = kv_cache_specs(plan, cache1)
    assert specs1["k"][3] == ("data", "model")


# ---------------------------------------------------------------------------
# the planner, spec for spec against the JAX package's
# ---------------------------------------------------------------------------

KINDS = ("act", "q_heads", "kv_heads", "attn_out", "logits", "mlp_hidden", "moe_groups",
         "expert_in", "expert_hidden", "ssm_inner", "ssm_heads", "kv_cache", "decode_tokens",
         "no_such_kind")
NDIM = {"act": 3, "q_heads": 4, "kv_heads": 4, "attn_out": 3, "logits": 3, "mlp_hidden": 3,
        "moe_groups": 3, "expert_in": 4, "expert_hidden": 4, "ssm_inner": 3, "ssm_heads": 4,
        "kv_cache": 5, "decode_tokens": 1, "no_such_kind": 2}
# dims that divide none, some and all of the axes (1, 2, 16, 32, 512)
DIMS = (1, 3, 16, 32, 48, 512)


def _plans(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    return (make_plan(get_config(arch), make_abstract_mesh(shape, names)),
            js.make_plan(jax_get_config(arch), jax_abstract_mesh(shape, names)))


def _jax_param_shapes(arch):
    tree = jax.eval_shape(
        lambda: jm.init_params(jax_get_config(arch), jax.random.PRNGKey(0), jnp.bfloat16))
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_matches_jax(arch, mesh_name):
    """Strategies, FSDP and notes; ``param_spec`` and ``zero_spec`` of every
    parameter of the full configuration (the port's meta tree against
    JAX's ``eval_shape``); ``activation_spec`` of every kind and
    ``batch_spec`` over shapes that divide none, some and all axes."""
    plan, jplan = _plans(arch, mesh_name)
    assert (plan.attn_strategy, plan.moe_strategy, plan.fsdp, plan.seq_parallel, plan.notes) == (
        jplan.attn_strategy, jplan.moe_strategy, jplan.fsdp, jplan.seq_parallel, jplan.notes)
    assert dp_axes(plan.mesh) == js.dp_axes(jplan.mesh)
    shapes = _jax_param_shapes(arch)
    ours = {tuple(path.split("/")): tuple(t.shape) for path, t in tm._leaves(_meta_params(arch))}
    assert ours == shapes
    for path, shape in shapes.items():
        spec, jspec = plan.param_spec(path, shape), jplan.param_spec(path, shape)
        assert tuple(spec) == tuple(jspec), (path, shape, spec, jspec)
        assert tuple(plan.zero_spec(spec, shape)) == tuple(jplan.zero_spec(jspec, shape)), path
    for kind in KINDS:
        for shape in itertools.product(DIMS, repeat=NDIM[kind]):
            got, want = plan.activation_spec(kind, shape), jplan.activation_spec(kind, shape)
            assert (got is None) == (want is None), (kind, shape)
            if got is not None:
                assert tuple(got) == tuple(want), (kind, shape, got, want)
    for shape in itertools.product(DIMS, repeat=2):
        assert tuple(plan.batch_spec("tokens", shape)) == tuple(jplan.batch_spec("tokens", shape))


@pytest.mark.parametrize("batch,seq", [(128, 32768), (1, 524288)])
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kv_cache_specs_match_jax(arch, mesh_name, batch, seq):
    plan, jplan = _plans(arch, mesh_name)
    cache = tm.init_kv_cache(get_config(arch), batch, seq, device="meta")
    jcache = jax.eval_shape(lambda: jm.init_kv_cache(jax_get_config(arch), batch, seq))
    specs, jspecs = kv_cache_specs(plan, cache), jax_kv_cache_specs(jplan, jcache)
    assert sorted(specs) == sorted(jspecs)
    for k in specs:
        assert tuple(specs[k]) == tuple(jspecs[k]), (k, specs[k], jspecs[k])
    # every tuple entry names its axes in mesh order: placements take it
    for k, spec in specs.items():
        placements(spec, plan.mesh)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stacked_dims_are_never_sharded(arch, mesh_name):
    """No parameter layout the planner gives a full configuration splits
    the stacked layer dim of a stacked leaf, which DTensor cannot unbind
    (``model._layers`` takes the layers by ``unbind``).  A ZeRO layout may (mamba2's
    ``conv_x``, (64, 4, 5120), takes ``data`` on its 64 layers): it lays
    out gradient accumulators, which are never unbound."""
    plan, _ = _plans(arch, mesh_name)
    params = _meta_params(arch)
    for path, sh in tm._leaves(param_shardings(plan, params)):
        if path.startswith("layers/"):
            assert not sh.spec or sh.spec[0] is None, (path, sh.spec)
    if arch == "mamba2_2_7b":
        zero = dict(tm._leaves(zero_shardings(plan, params)))
        assert zero["layers/mixer/conv_x"].spec[0] == "data"


# ---------------------------------------------------------------------------
# specs to placements, meshes, the context
# ---------------------------------------------------------------------------


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as JP

    for entries in [(("data",), None, ()), (("pod", "data"), "model"), (None,), ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def test_placements_follow_the_spec_and_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_mesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0), Shard(2)]
    assert placements(P(None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        placements(P("expert"), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        placements(P("data", "data"), mesh)
    # a mesh dim of size 1 is the same layout replicated
    assert placements(P("data", "model"), fake_mesh((1, 4))) == [Replicate(), Shard(1)]


def test_abstract_mesh_is_jaxs():
    ours = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    theirs = jax_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert dict(ours.shape) == dict(theirs.shape)
    assert ours.axis_names == theirs.axis_names and ours.size == theirs.size == 512


def test_meshes_refuse_without_a_matching_group(one_rank):
    """make_mesh needs a group of exactly its size: the production meshes
    need 256 / 512 ranks; a second group, and a CUDA mesh or group where no
    GPU is visible, are refused."""
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="already initialised"):
        tmesh.init_distributed("cpu", init_method="file:///nonexistent", rank=0, world_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_host_mesh()
    assert tuple(one_rank.mesh_dim_names) == ("data", "model")


def test_init_distributed_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_distributed()
    with pytest.raises(ValueError, match="device_type"):
        tmesh.init_distributed("tpu")
    assert not dist.is_initialized()


def test_hint_is_identity_without_a_context_or_a_dtensor():
    x = torch.randn(2, 8, 16)
    assert tctx.hint(x, "act") is x
    plan = make_plan(get_config("tinyllama_1_1b"), fake_mesh())
    with tctx.sharding_context(fake_mesh(), plan):
        assert tctx.hint(x, "act") is x               # a plain tensor
        assert tctx.current().plan is plan
    assert tctx.current() is None


def test_hint_redistributes_to_the_plan(one_rank):
    from torch.distributed.tensor import Replicate, distribute_tensor

    plan = make_plan(get_config("tinyllama_1_1b").reduced(), one_rank)
    x = distribute_tensor(torch.randn(2, 8, 16), one_rank, [Replicate(), Replicate()])
    with tctx.sharding_context(one_rank, plan):
        y = tctx.hint(x, "q_heads")
        assert tctx.hint(x, "no_such_kind") is x
    assert torch.equal(y.full_tensor(), x.full_tensor())


def test_ring_attention_on_one_rank_equals_chunked(one_rank):
    """A 1-rank ring sends nothing and is the chunked attention, with and
    without a window; under autograd it raises."""
    from repro_torch.distributed.ring_attention import ring_attention
    from repro_torch.models.layers import chunked_gqa_attention

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 32, 4, 8), (1, 32, 2, 8), (1, 32, 2, 8)))
    with torch.no_grad():
        for window in (None, 8):
            got = ring_attention(q, k, v, one_rank, window=window).full_tensor()
            want = chunked_gqa_attention(q, k, v, window=window, kv_chunk=8)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="forward only"):
        ring_attention(q.requires_grad_(), k, v, one_rank)


def test_pipeline_on_one_stage_is_the_stage(tmp_path):
    from repro_torch.distributed.pipeline import pipeline_forward

    tmesh.init_distributed("cpu", init_method=f"file://{tmp_path / 'store'}", rank=0,
                           world_size=1)
    try:
        mesh = tmesh.make_mesh((1,), ("pod",), device_type="cpu")
        w = torch.randn(1, 8, 8)
        micro = torch.randn(3, 4, 8)
        fn = pipeline_forward(lambda ws, x, stage: torch.tanh(x @ ws), mesh)
        with torch.no_grad():
            assert torch.equal(fn(w, micro), torch.tanh(micro @ w[0]))
        with pytest.raises(NotImplementedError, match="forward only"):
            fn(w.requires_grad_(), micro)
    finally:
        dist.destroy_process_group()
