"""The port's roofline (``repro_torch.roofline``): the tests of
``tests/test_roofline.py`` in the port's terms, with the dot FLOPs of the
same small programs held against the JAX package's HLO cost model.

The port counts the ops a rank dispatches (``dispatch_cost``), so a Python
loop is counted as it runs: there is no trip count to recover.  Programs
run on ``meta`` tensors; fake worlds live in this process only inside
``fake_world`` (destroyed on exit)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.roofline.hlo_cost import analyze_hlo
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline import RooflineReport, trace_cost
from repro_torch.roofline.analysis import HBM_BW, NET_BW, NVLINK_BW, PEAK_F32_FLOPS, PEAK_FLOPS
from repro_torch.roofline.kernel_cost import kernel_work, ssd_scan_work

pytestmark = pytest.mark.torch

N = 256


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _port_loop(n_outer, n_inner=0):
    """The JAX test's scanned tanh(c @ w), as Python loops on meta tensors."""
    def f(x, w):
        for _ in range(n_outer):
            x = torch.tanh(x @ w)
        for _ in range(2 if n_inner else 0):
            for _ in range(n_inner):
                x = torch.tanh(x @ w)
        return x

    return trace_cost(f, meta(N, N), meta(N, N))[1]


def _jax_loop(n_outer, n_inner=0):
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None

        y, _ = jax.lax.scan(body, x, None, length=n_outer)
        if n_inner:
            def outer(c, _):
                c, _ = jax.lax.scan(body, c, None, length=n_inner)
                return c, None

            y, _ = jax.lax.scan(outer, y, None, length=2)
        return y

    x = jax.ShapeDtypeStruct((N, N), jnp.float32)
    return analyze_hlo(jax.jit(f).lower(x, x).compile().as_text())


@pytest.mark.parametrize("n", [1, 8])
def test_python_loop_counts_every_product(n):
    cost = _port_loop(n)
    assert cost.flops == {"f32": pytest.approx(n * 2 * N ** 3)}
    assert cost.total_flops == pytest.approx(_jax_loop(n).flops, rel=1e-9)


def test_nested_loops_count_exactly():
    # 8 + 2*4 = 16 products, as the JAX model counts the nested scans
    cost = _port_loop(8, n_inner=4)
    assert cost.total_flops == pytest.approx(16 * 2 * N ** 3)
    assert cost.total_flops == pytest.approx(_jax_loop(8, n_inner=4).flops, rel=1e-9)


def test_einsum_and_batched_products_match_jax():
    """einsum decomposes into bmm/mm; its dot FLOPs equal XLA's dots'."""
    def port(q, k, w):
        s = torch.einsum("bqd,bkd->bqk", q, k)
        return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), k) @ w

    def jx(q, k, w):
        s = jnp.einsum("bqd,bkd->bqk", q, k)
        return jnp.einsum("bqk,bkd->bqd", jax.nn.softmax(s, -1), k) @ w

    shapes = ((4, 64, 32), (4, 48, 32), (32, 16))
    cost = trace_cost(port, *(meta(*s) for s in shapes))[1]
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    want = analyze_hlo(jax.jit(jx).lower(*sds).compile().as_text()).flops
    assert cost.total_flops == pytest.approx(want, rel=1e-9)
    assert cost.total_flops == 2 * (4 * 64 * 48 * 32) * 2 + 2 * 4 * 64 * 32 * 16


def test_remat_recompute_is_counted():
    """A checkpointed layer's forward runs again in the backward: forward
    (1 product), recompute (1), backward (2: both operands' gradients)."""
    w = meta(N, N).requires_grad_()
    x = meta(N, N).requires_grad_()

    def step(remat):
        def layer(h):
            return torch.tanh(h @ w)

        def f():
            y = torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False) if remat \
                else layer(x)
            torch.autograd.grad(y.sum(), [x, w])

        return trace_cost(f)[1].total_flops

    assert step(False) == pytest.approx(3 * 2 * N ** 3)
    assert step(True) == pytest.approx(4 * 2 * N ** 3)


def test_unbind_slice_charges_the_slice_not_the_stack():
    """One ``torch.unbind`` slice per step of a (64, 128, 128) stack (the
    model's ``_layers``): a view, so each step's product reads its 64 KiB
    slice, not the 4 MiB stack."""
    def f(x, ws):
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
        return x

    cost = trace_cost(f, meta(128, 128), meta(64, 128, 128))[1]
    tile = 128 * 128 * 4
    # per step: the product reads x and the slice and writes its result;
    # tanh reads and writes one tile
    assert cost.bytes == 64 * (3 * tile + 2 * tile)
    assert cost.bytes < 64 * 4 * 2 ** 20     # the stack per step would be 268 MB


def test_peak_live_bytes_follow_storages():
    """Temporaries freed as the loop goes hold the peak at a few tiles;
    results kept in a list hold all of them."""
    tile = N * N * 4

    def dropped(x, w):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    def kept(x, w):
        return [torch.tanh(x @ w) for _ in range(8)]

    assert trace_cost(dropped, meta(N, N), meta(N, N))[1].peak_live_bytes <= 3 * tile
    assert trace_cost(kept, meta(N, N), meta(N, N))[1].peak_live_bytes >= 8 * tile


def test_sharding_propagation_is_not_counted():
    """(256, 4096) @ (4096, 4096) sharded [Shard(0), Replicate()] x
    [Replicate(), Shard(1)] on a fake (16, 16) world: each rank multiplies
    (16, 4096) by (4096, 256), 3.36e7 FLOPs, not the global 8.59e9.
    DTensor's sharding propagation runs the product once on global fake
    tensors for a new signature (skipped, ``propagation_ops``); a second
    identical product hits its cache and adds only the local work."""
    with fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), device_type="fake")
        a = distribute_tensor(meta(256, 4096), mesh, [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(meta(4096, 4096), mesh, [Replicate(), Shard(1)],
                              src_data_rank=None)
        # a shape no other test multiplies: its signature is new to the cache
        first = trace_cost(lambda: a @ b)[1]
        second = trace_cost(lambda: a @ b)[1]
    local = 2 * 16 * 4096 * 256
    assert local == 33554432 and 2 * 256 * 4096 * 4096 == 8589934592
    assert first.total_flops == local and second.total_flops == local
    assert first.propagation_ops > 0 and second.propagation_ops == 0


def test_collectives_charge_result_bytes_by_kind_and_scope():
    """An all-gather over the 16 ``model`` ranks of a (16, 16) world (16
    consecutive ranks: two nodes of 8) charges its result bytes to the
    network; over a (2, 8) world's ``model`` axis (one node) to NVLink.  In
    a loop of 4, 4x."""
    def gathered(shape, names, n):
        with fake_world(shape[0] * shape[1]):
            mesh = make_mesh(shape, names, device_type="fake")
            x = distribute_tensor(meta(64, 128), mesh, [Replicate(), Shard(0)],
                                  src_data_rank=None)

            def f():
                for _ in range(n):
                    x.redistribute(mesh, [Replicate(), Replicate()])

            return trace_cost(f)[1]

    full = 64 * 128 * 4
    cost = gathered((16, 16), ("data", "model"), 1)
    assert cost.collectives == {"all-gather": full} and cost.network == {"all-gather": full}
    cost = gathered((2, 8), ("data", "model"), 4)
    assert cost.collectives == {"all-gather": 4 * full} and cost.network == {}


def test_roofline_report_terms_on_h100_constants():
    rep = RooflineReport(
        "t", chips=256, flops=PEAK_FLOPS * 0.01, hbm_bytes=HBM_BW * 0.02,
        collective_bytes={"all-reduce": int(NVLINK_BW * 0.001 + NET_BW * 0.004)},
        model_flops=PEAK_FLOPS * 0.01 * 256 * 0.5, network_bytes=int(NET_BW * 0.004),
    )
    assert rep.t_compute == pytest.approx(0.01)
    assert rep.t_memory == pytest.approx(0.02)
    assert rep.t_collective == pytest.approx(0.005)
    assert rep.dominant == "memory"
    assert rep.useful_flops_ratio == pytest.approx(0.5)
    assert rep.roofline_fraction == pytest.approx(0.25)
    # f32 products are charged at the f32 rate
    mixed = RooflineReport("t", 1, 2e12, 0.0, {}, flops_by_unit={"bf16": 1e12, "f32": 1e12})
    assert mixed.t_compute == pytest.approx(1e12 / PEAK_FLOPS + 1e12 / PEAK_F32_FLOPS)
    assert {PEAK_FLOPS, PEAK_F32_FLOPS, HBM_BW, NVLINK_BW, NET_BW} == \
        {989.4e12, 67e12, 3.35e12, 900e9, 100e9}


def test_kernels_on_meta_give_shapes_and_are_charged_their_work():
    """``kernels="cuda"`` on meta tensors runs the operators' fake
    implementations; the cost is the kernels' own work (``kernel_work``),
    one launch each (the SSD op four kernels)."""
    q = meta(8, 256, 64, dtype=torch.bfloat16)
    out, cost, _ = trace_cost(ops.attention_op, q, q, q, kernels="cuda")
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.device.type == "meta"
    nbytes, flops, peak = kernel_work("flash_attention", (q, q, q), out)
    assert flops == 4 * 64 * 8 * 256 * 257 // 2 and peak == PEAK_FLOPS
    assert cost.kernels == {"flash_attention": 1}
    assert cost.flops == {"bf16": flops} and cost.bytes == nbytes == 4 * q.numel() * 2

    x, dt, a, b = meta(512, 8, 16), meta(512, 8), meta(8), meta(512, 32)
    y, cost, _ = trace_cost(ops.ssd_op, x, dt, a, b, b, kernels="cuda", chunk=128)
    assert y.shape == x.shape and y.device.type == "meta"
    works = ssd_scan_work(x, dt, a, b, b, 128)
    assert [w[0] for w in works] == ["ssd_gram", "ssd_chunk_state", "ssd_state_pass",
                                     "ssd_chunk_out"]
    assert cost.kernels == {name: 1 for name, *_ in works}
    assert cost.total_flops == sum(w[2] for w in works)


@pytest.mark.parametrize("op", ["attention", "ssd"])
def test_cuda_kernels_on_cpu_tensors_still_raise(op):
    with pytest.raises(ValueError, match="CUDA tensors"):
        if op == "attention":
            q = torch.zeros(2, 64, 16)
            ops.attention_op(q, q, q, kernels="cuda")
        else:
            ops.ssd_op(torch.zeros(64, 2, 4), torch.ones(64, 2), -torch.ones(2),
                       torch.zeros(64, 8), torch.zeros(64, 8), kernels="cuda")


def test_plain_backward_traced_once_a_signature_is_charged_as_traced(monkeypatch):
    """The attention Function's backward (the plain version's gradient) is
    traced once a signature and replayed: the same FLOPs, bytes and peak as
    tracing every call, on two layers' worth of calls."""
    def step():
        q = meta(4, 256, 32, dtype=torch.bfloat16).requires_grad_()
        for _ in range(2):
            o = ops.attention_op(q, q, q, kernels="cuda")
            torch.autograd.grad(o.float().sum(), [q])

    from repro_torch.kernels import flash_attention as fa

    runs = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain", lambda *a, **kw: runs.append(1) or
                        plain(*a, **kw))
    replayed = trace_cost(step)[1]
    assert len(runs) == 1
    monkeypatch.setattr("repro_torch.roofline.dispatch_cost.DispatchCostMode.plain_vjp",
                        lambda self, run, *a, **kw: run(*a, **kw))
    traced = trace_cost(step)[1]
    assert len(runs) == 3
    assert replayed.flops == traced.flops and replayed.flops["f32"] > 0
    assert replayed.bytes == traced.bytes and replayed.kernels == {"flash_attention": 2}
    assert replayed.peak_live_bytes == traced.peak_live_bytes
