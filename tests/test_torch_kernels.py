"""The port's hand-written kernels against the JAX package, on the CPU.

The same seeded numpy inputs (f32, cast in each framework for bf16: both
round to nearest even) go through the JAX package's Pallas kernels
(interpret mode, as ``tests/test_kernels.py`` runs them) and through
``repro_torch.kernels.ops`` with ``kernels="eager"`` (the plain PyTorch
version of each CUDA kernel) on CPU tensors, on every case of
``tests/test_kernels.py``, at its tolerances; the plain versions are also
run at the JAX call's own blocks.  The torch oracles are held against the
JAX oracles, and the contract is checked: CUDA wrappers refuse CPU
tensors, arguments the JAX kernels refuse are refused, unsupported dtypes
raise ``TypeError``, and the route of ``matmul`` and ``flash_attention``
(tensor cores or SIMT) follows its documented rule.  The Hopper header
``csrc/sm90.cuh`` is spliced into the sources it is named in, and its
descriptor function is compiled with g++ and held against the bit fields.
The one test that builds and launches the CUDA kernels is marked ``gpu``
and skips here.
"""

import contextlib
import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from repro_torch.backend import build
from repro_torch.kernels import KERNELS, _cuda, flash_attention as fa_mod, matmul as mm_mod, ops, ref
from repro_torch.kernels import ssd as ssd_mod, stencil as st_mod
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.matmul import matmul, matmul_plain
from repro_torch.kernels.ssd import (
    ssd_chunk_out, ssd_chunk_out_plain, ssd_chunk_scan, ssd_chunk_scan_plain, ssd_chunk_state,
    ssd_chunk_state_plain, ssd_gram, ssd_gram_plain, ssd_scan, ssd_scan_plain, ssd_state_pass,
    ssd_state_pass_plain,
)
from repro_torch.kernels.stencil import stencil3x3, stencil3x3_plain

pytestmark = pytest.mark.torch

GAUSS = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def jaxk():
    """The JAX package's kernels and oracles, imported on first use: the
    GPU machine has no JAX and runs only this file's card test."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.apps import make_app
    from repro.frontend import execute_pipeline
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.matmul import matmul
    from repro.kernels.ssd import ssd_scan
    from repro.kernels.stencil import stencil3x3

    def both(arr, dtype="f32"):
        """The same f32 values as a JAX array and a CPU tensor of ``dtype``."""
        jdtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
        return jnp.asarray(arr, jdtype), ops.to_tensor(arr, DTYPES[dtype], device="cpu")

    return types.SimpleNamespace(
        jnp=jnp, ref=jref, make_app=make_app, execute_pipeline=execute_pipeline,
        flash=flash_attention, matmul=matmul, ssd=ssd_scan, stencil=stencil3x3, both=both,
    )


def close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def ssd_arrays(rng, s, h, p, n):
    """The distributions of the JAX package's SSD tests."""
    return (
        rng.standard_normal((s, h, p)).astype(np.float32),
        (np.abs(rng.standard_normal((s, h))) * 0.1 + 0.01).astype(np.float32),
        (-np.abs(rng.standard_normal(h)) - 0.1).astype(np.float32),
        rng.standard_normal((s, n)).astype(np.float32),
        rng.standard_normal((s, n)).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# parity with the JAX kernels, on the cases of tests/test_kernels.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k", [(32, 32, 32), (64, 128, 32), (128, 64, 256), (16, 16, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul_matches_jax(m, n, k, dtype, jaxk):
    rng = np.random.default_rng(0)
    (ja, ta), (jb, tb) = jaxk.both(rng.standard_normal((m, k)), dtype), jaxk.both(rng.standard_normal((k, n)), dtype)
    want = jaxk.matmul(ja, jb, block_m=16, block_n=16, block_k=16, interpret=True)
    tol = 1e-4 if dtype == "f32" else 2e-2
    got = ops.matmul_op(ta, tb, kernels="eager")
    assert got.dtype == DTYPES[dtype] and got.shape == (m, n)
    close(got, want, tol)
    close(matmul_plain(ta, tb, block_m=16, block_n=16, block_k=16), want, tol)


STENCIL_JAX = [(16, 16, "f32"), (32, 64, "f32"), (64, 62, "f32"),
               (16, 16, "bf16"), (32, 64, "bf16"), (64, 62, "bf16")]


@pytest.mark.parametrize("h,w,dtype", STENCIL_JAX,
                         ids=[f"{h}-{w}" + ("" if d == "f32" else f"-{d}") for h, w, d in STENCIL_JAX])
def test_stencil_matches_jax(h, w, dtype, jaxk):
    """The plain version and the oracle against the JAX kernel, f32 and
    bf16 x (the weights f32): the f32 sums cast once to x's dtype."""
    rng = np.random.default_rng(1)
    jx, tx = jaxk.both(rng.standard_normal((h + 2, w + 2)), dtype)
    jw, tw = jaxk.both(GAUSS)
    want = np.asarray(jaxk.stencil(jx, jw, block_h=8, interpret=True).astype(jaxk.jnp.float32))
    # f32: the JAX tolerance; bf16: one rounding to bf16 apart at most, one
    # bf16 ulp (2**-7 of the value)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=2 ** -7, atol=0)
    for got in (ops.stencil3x3_op(tx, tw, kernels="eager"), stencil3x3_plain(tx, tw, block_h=8),
                ref.stencil3x3_ref(tx, tw).to(DTYPES[dtype])):
        assert got.dtype == DTYPES[dtype]
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # integer inputs, gaussian weights: every product and sum is exact, so
    # the one rounding to x's dtype is the same on both sides
    jx, tx = jaxk.both(rng.integers(0, 256, (h + 2, w + 2)), dtype)
    want = np.asarray(jaxk.stencil(jx, jw, block_h=8, interpret=True).astype(jaxk.jnp.float32))
    for got in (ops.stencil3x3_op(tx, tw, kernels="eager"), stencil3x3_plain(tx, tw, block_h=8),
                ref.stencil3x3_ref(tx, tw).to(DTYPES[dtype])):
        assert np.array_equal(got.float().numpy(), want)


def test_stencil_matches_paper_gaussian_app(jaxk):
    """The plain version computes the CGRA pipeline's gaussian bit for bit,
    as the JAX stencil kernel does."""
    app = jaxk.make_app("gaussian", size=18)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 64, (18, 18)).astype(np.float32)
    cgra = np.zeros((16, 16), np.float32)
    for idx, v in jaxk.execute_pipeline(app.pipeline, {"input": img})["gaussian"].items():
        cgra[idx] = v
    (jx, tx), (jw, tw) = jaxk.both(img), jaxk.both(GAUSS)
    got = ops.stencil3x3_op(tx, tw, kernels="eager").numpy()
    assert np.array_equal(got, cgra)
    assert np.array_equal(got, np.asarray(jaxk.stencil(jx, jw, block_h=8, interpret=True)))


@pytest.mark.parametrize("b,s,d", [(2, 128, 64), (1, 256, 32), (4, 64, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_jax(b, s, d, causal, dtype, jaxk):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (jaxk.both(rng.standard_normal((b, s, d)), dtype) for _ in range(3))
    want = jaxk.flash(jq, jk, jv, causal=causal, block_q=32, block_kv=32, interpret=True)
    tol = 2e-3 if dtype == "f32" else 3e-2
    got = ops.attention_op(tq, tk, tv, causal=causal, kernels="eager")
    assert got.dtype == DTYPES[dtype]
    close(got, want, tol)
    close(flash_attention_plain(tq, tk, tv, causal=causal, block_q=32, block_kv=32), want, tol)


def test_flash_cross_attention_rectangular(jaxk):
    rng = np.random.default_rng(4)
    (jq, tq), (jk, tk), (jv, tv) = (
        jaxk.both(rng.standard_normal(shape)) for shape in ((2, 64, 32), (2, 256, 32), (2, 256, 32))
    )
    want = jaxk.flash(jq, jk, jv, causal=False, block_q=32, block_kv=64, interpret=True)
    close(ops.attention_op(tq, tk, tv, causal=False, kernels="eager"), want, 2e-3)
    close(flash_attention_plain(tq, tk, tv, causal=False, block_q=32, block_kv=64), want, 2e-3)


@pytest.mark.parametrize("s,h,p,n", [(64, 2, 8, 16), (128, 4, 16, 32), (32, 1, 4, 8)])
def test_ssd_matches_jax(s, h, p, n, jaxk):
    rng = np.random.default_rng(5)
    pairs = [jaxk.both(arr) for arr in ssd_arrays(rng, s, h, p, n)]
    jins, tins = [j for j, _ in pairs], [t for _, t in pairs]
    want = jaxk.ssd(*jins, chunk=16, interpret=True)
    close(ssd_scan_plain(*tins, chunk=16), want, 1e-3)
    close(ops.ssd_op(*tins, kernels="eager"), want, 1e-3)
    close(ops.ssd_op(*tins, kernels="eager"), jaxk.ref.ssd_ref(*jins), 1e-3)


def test_ssd_chunk_invariance(jaxk):
    """The chunk length does not change the result, in either package."""
    rng = np.random.default_rng(6)
    pairs = [jaxk.both(arr) for arr in ssd_arrays(rng, 64, 2, 8, 16)]
    jins, tins = [j for j, _ in pairs], [t for _, t in pairs]
    y8 = ssd_scan_plain(*tins, chunk=8)
    close(y8, ssd_scan_plain(*tins, chunk=32).numpy(), 1e-4)
    close(y8, jaxk.ssd(*jins, chunk=32, interpret=True), 1e-4)


# ---------------------------------------------------------------------------
# the torch oracles against the JAX oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stencil_and_matmul_oracles_match_jax(dtype, jaxk):
    rng = np.random.default_rng(7)
    jx, tx = jaxk.both(rng.standard_normal((18, 30)), dtype)
    jw, tw = jaxk.both(GAUSS)
    want = jaxk.ref.stencil3x3_ref(jx, jw)
    got = ref.stencil3x3_ref(tx, tw)
    assert got.dtype == torch.float32 and np.dtype(want.dtype) == np.float32  # promoted by the f32 weights
    close(got, want, 1e-6)
    (ja, ta), (jb, tb) = jaxk.both(rng.standard_normal((24, 40)), dtype), jaxk.both(rng.standard_normal((40, 8)), dtype)
    got, want = ref.matmul_ref(ta, tb), jaxk.ref.matmul_ref(ja, jb)
    assert got.dtype == DTYPES[dtype]
    close(got, want, 1e-5 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("sq,skv,causal", [(64, 64, True), (32, 96, True), (48, 80, False)])
def test_attention_oracle_matches_jax(sq, skv, causal, jaxk):
    """Including the causal diagonal aligned to the end of a longer KV window."""
    rng = np.random.default_rng(8)
    (jq, tq), (jk, tk), (jv, tv) = (
        jaxk.both(rng.standard_normal(shape)) for shape in ((2, sq, 16), (2, skv, 16), (2, skv, 16))
    )
    close(ref.attention_ref(tq, tk, tv, causal=causal), jaxk.ref.attention_ref(jq, jk, jv, causal=causal), 1e-5)


def test_ssd_oracle_matches_jax(jaxk):
    rng = np.random.default_rng(9)
    pairs = [jaxk.both(arr) for arr in ssd_arrays(rng, 48, 3, 4, 8)]
    close(ref.ssd_ref(*[t for _, t in pairs]), jaxk.ref.ssd_ref(*[j for j, _ in pairs]), 1e-5)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_ssd_split_into_gram_and_chunk_scan(chunk):
    """The two plain versions the SSD op is made of: the chunks' C Bᵀ,
    lower triangle, zeros above; the scan given it equals the whole op."""
    rng = np.random.default_rng(14)
    arrs = ssd_arrays(rng, 48, 3, 4, 8)
    b, c = arrs[3].reshape(-1, chunk, 8), arrs[4].reshape(-1, chunk, 8)
    want = np.tril(np.einsum("kln,kmn->klm", c.astype(np.float64), b.astype(np.float64)))
    ins = [torch.from_numpy(a) for a in arrs]
    g = ssd_gram_plain(ins[3], ins[4], chunk)
    assert g.dtype == torch.float32 and g.shape == (48 // chunk, chunk, chunk)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(np.triu(g.numpy(), 1), np.zeros_like(want))
    torch.testing.assert_close(ssd_chunk_scan_plain(*ins, g, chunk=chunk),
                               ssd_scan_plain(*ins, chunk=chunk), rtol=0, atol=0)
    for fn in (ssd_chunk_scan, ssd_chunk_scan_plain):
        with pytest.raises(ValueError, match="g must be"):
            fn(*ins, g[:, :-1], chunk=chunk)
    for fn in (ssd_gram, ssd_gram_plain):
        with pytest.raises(ValueError, match="chunk 5 dividing"):
            fn(ins[3], ins[4], 5)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ssd_chunk_scan(*ins, g, chunk=chunk)


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


def _cpu_calls(dtype=torch.float32):
    """One small valid call of each CUDA wrapper and each op, on CPU tensors."""
    rng = np.random.default_rng(10)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    x, w = t(10, 12), torch.from_numpy(GAUSS)
    a, b = t(16, 32), t(32, 16)
    # a long K on one tile: the SIMT kernel splits it and reduces
    a_split, b_split = t(16, 256), t(256, 16)
    q, k, v = t(2, 32, 16), t(2, 32, 16), t(2, 32, 16)
    s_in = (t(32, 2, 4), t(32, 2).abs() * 0.1 + 0.01, -t(2).abs() - 0.1, t(32, 8), t(32, 8))
    return {
        "stencil3x3": ((stencil3x3, (x, w)), (ops.stencil3x3_op, (x, w))),
        "matmul": ((matmul, (a, b)), (ops.matmul_op, (a, b))),
        "matmul_reduce": ((matmul, (a_split, b_split)), (ops.matmul_op, (a_split, b_split))),
        "matmul_wgmma": ((matmul, (a, b)), (ops.matmul_op, (a, b))),
        "flash_attention": ((flash_attention, (q, k, v)), (ops.attention_op, (q, k, v))),
        "flash_attention_wgmma": ((flash_attention, (q, k, v)), (ops.attention_op, (q, k, v))),
        "ssd_gram": ((ssd_gram, (s_in[3], s_in[4], 16)), (ops.ssd_op, s_in)),
        "ssd_chunk_state": ((ssd_chunk_state, (*s_in[:4], 16)), (ops.ssd_op, s_in)),
        "ssd_state_pass": ((ssd_state_pass, (t(2, 2, 8, 4), t(32, 2), 16)), (ops.ssd_op, s_in)),
        "ssd_chunk_out": ((ssd_chunk_out, (s_in[0], s_in[1], s_in[4], t(2, 16, 16), t(32, 2),
                                           t(2, 2, 8, 4), 16)), (ops.ssd_op, s_in)),
    }


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """The CUDA path takes CUDA tensors only: the wrapper and its op raise
    on CPU tensors, count no launch, and never run the plain version."""
    (wrapper, args), (op, op_args) = _cpu_calls()[name]
    before = KERNELS[name].launches
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        wrapper(*args)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        op(*op_args)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        op(*op_args, kernels="cuda")
    with pytest.raises(ValueError, match="kernels must be one of"):
        op(*op_args, kernels="pallas")
    assert KERNELS[name].launches == before
    assert KERNELS[name].path.is_file() and KERNELS[name].replaces.startswith("src/repro/kernels/")


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_unsupported_dtype_raises_type_error(name, dtype):
    (wrapper, args), (op, op_args) = _cpu_calls(dtype)[name]
    with pytest.raises(TypeError, match="not supported"):
        wrapper(*args)
    with pytest.raises(TypeError, match="not supported"):
        op(*op_args, kernels="eager")


def test_mixed_dtypes_raise_type_error():
    a = torch.zeros(16, 16)
    with pytest.raises(TypeError, match="share one dtype"):
        matmul_plain(a, a.to(torch.bfloat16))


def test_refused_arguments_match_jax(jaxk):
    """A call the JAX kernel refuses is refused here too, by both versions."""
    z = np.zeros
    cases = [
        (jaxk.matmul, (z((48, 32)), z((32, 16))), dict(block_m=32),
         (matmul, matmul_plain), "must divide"),
        (jaxk.flash, (z((1, 32, 8)), z((1, 64, 8)), z((1, 64, 8))), dict(causal=True),
         (flash_attention, flash_attention_plain), "causal"),
        (jaxk.flash, (z((1, 64, 8)),) * 3, dict(causal=False, block_q=48),
         (flash_attention, flash_attention_plain), "must divide"),
        (jaxk.ssd, (z((48, 2, 4)), z((48, 2)), z(2), z((48, 8)), z((48, 8))), dict(chunk=32),
         (ssd_scan, ssd_scan_plain), "must divide"),
    ]
    for jax_fn, arrays, kw, port_fns, msg in cases:
        jarrs = [jaxk.jnp.asarray(a, jaxk.jnp.float32) for a in arrays]
        with pytest.raises(AssertionError):
            jax_fn(*jarrs, interpret=True, **kw)
        tarrs = [ops.to_tensor(a, torch.float32, device="cpu") for a in arrays]
        for fn in port_fns:
            with pytest.raises(ValueError, match=msg):
                fn(*tarrs, **kw)


def test_stencil_block_height_falls_back_as_jax(jaxk):
    """A block height that does not divide H falls back to the largest
    divisor, as the JAX kernel does, so the call is accepted."""
    rng = np.random.default_rng(11)
    jx, tx = jaxk.both(rng.integers(0, 256, (14, 20)))
    jw, tw = jaxk.both(GAUSS)
    want = np.asarray(jaxk.stencil(jx, jw, block_h=5, interpret=True))
    assert np.array_equal(stencil3x3_plain(tx, tw, block_h=5).numpy(), want)


def test_to_tensor_carries_bfloat16_bit_for_bit(jaxk):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    vals = np.array([0.0, -0.0, 1.0, -2.5, 3.0e38, 1e-40, np.inf, -np.inf, 0.1], np.float32)
    arr = vals.astype(ml_dtypes.bfloat16)
    for src in (arr, jaxk.jnp.asarray(arr)):
        t = ops.to_tensor(src, device="cpu")
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(), np.asarray(src).view(np.int16))
    nan = ops.to_tensor(np.array([np.nan], np.float32).astype(ml_dtypes.bfloat16), device="cpu")
    assert torch.isnan(nan).all()
    # cast on the way: round to nearest even, as numpy and JAX do
    x = np.random.default_rng(12).standard_normal(64).astype(np.float32)
    t = ops.to_tensor(x, torch.bfloat16, device="cpu")
    assert np.array_equal(t.view(torch.int16).numpy(), x.astype(ml_dtypes.bfloat16).view(np.int16))
    assert ops.to_tensor(x, device="cpu").dtype == torch.float32


def _bf16(*shape, offset=0):
    """A contiguous bf16 CPU tensor whose data starts ``offset`` elements
    past a fresh allocation (so 2 * offset bytes off its alignment)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


@pytest.mark.parametrize("a,b,want", [
    (_bf16(64, 48), _bf16(48, 80), "wgmma"),
    (_bf16(130, 72), _bf16(72, 136), "wgmma"),
    (_bf16(64, 48).float(), _bf16(48, 80).float(), "simt"),
    (_bf16(64, 44), _bf16(44, 80), "simt"),                # K not a multiple of 8
    (_bf16(64, 48), _bf16(48, 84), "simt"),                # N not a multiple of 8
    (_bf16(64, 48, offset=1), _bf16(48, 80), "wgmma"),     # A 2 bytes off 16: copied
    (_bf16(64, 48), _bf16(48, 80, offset=4), "wgmma"),     # B 8 bytes off 16: copied
    (_bf16(64, 48), _bf16(80, 48).t(), "wgmma"),           # made contiguous first
], ids=["bf16", "bf16-ragged", "f32", "k44", "n84", "a-unaligned", "b-unaligned", "b-strided"])
def test_matmul_route(a, b, want, monkeypatch):
    """The tensor cores take bf16 operands whose rows TMA can read (K and N
    multiples of 8), wherever their data sits; every other call goes to the
    SIMT kernel.  The device check is lifted: the rule is the same on the
    card."""
    monkeypatch.setattr(mm_mod, "require_cuda", lambda *a: torch.device("cpu"))
    assert mm_mod.route(a, b) == want


@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((2, 128, 64), torch.bfloat16, 0, "wgmma"),
    ((2, 64, 128), torch.bfloat16, 0, "wgmma"),
    ((1, 256, 32), torch.bfloat16, 0, "wgmma"),
    ((2, 128, 64), torch.float32, 0, "simt"),
    ((2, 64, 136), torch.bfloat16, 0, "wgmma"),             # D above 128: the D 256 kernel
    ((2, 64, 60), torch.bfloat16, 0, "simt"),               # D not a multiple of 8
    ((2, 64, 256), torch.bfloat16, 0, "wgmma"),
    ((2, 64, 64), torch.bfloat16, 3, "wgmma"),              # 6 bytes off 16: copied
    ((2, 64, 30), torch.bfloat16, 0, "simt"),
    ((2, 64, 256), torch.float32, 0, "simt"),
    ((2, 64, 264), torch.bfloat16, 0, "simt"),              # above 256: refused by both
], ids=["d64", "d128", "d32", "f32", "d136", "d60", "d256", "unaligned", "d30", "f32-d256",
        "d264"])
def test_flash_attention_route(shape, dtype, offset, want, monkeypatch):
    monkeypatch.setattr(fa_mod, "require_cuda", lambda *a: torch.device("cpu"))
    q = _bf16(*shape, offset=offset).to(dtype)  # a no-op for bf16: the offset stays
    k, v = _bf16(*shape).to(dtype), _bf16(*shape).to(dtype)
    assert fa_mod.route(q, k, v) == want
    assert fa_mod.route(k, q, v) == want and fa_mod.route(k, v, q) == want


@pytest.fixture(scope="module")
def host_wgmma_tile(tmp_path_factory):
    """``csrc/flash_attention_wgmma.cu``'s host part compiled by g++ (its
    CUDA part is nvcc's alone): the tiles, shared-memory layouts and the
    ``flash_attention_wgmma_tile`` entry, with an occupancy entry that
    stands in for the card's and reports 7 blocks an SM."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the layouts cannot be compiled on the host")
    root = tmp_path_factory.mktemp("wgmma_tile")
    (root / "layout.cpp").write_text(
        "#define __host__\n#define __device__\n"
        '#include "flash_attention_wgmma.cu"\n'
        'extern "C" int flash_attention_wgmma_occupancy(int, int* n) { *n = 7; return 0; }\n')
    so = root / "liblayout.so"
    run = subprocess.run([gxx, "-std=c++17", "-shared", "-fPIC", "-I", str(_cuda.CSRC),
                          "-o", str(so), str(root / "layout.cpp")], capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    return ctypes.CDLL(str(so))


def _wgmma_tile(lib, d):
    out = (ctypes.c_int * 6)()
    assert lib.flash_attention_wgmma_tile(d, out) == 0
    return tuple(out)


@pytest.mark.parametrize("d,tile", [
    (64, (64, 128, 128, 2, 288)), (128, (128, 128, 128, 2, 288)),
    (136, (256, 64, 64, 1, 160)), (256, (256, 64, 64, 1, 160)),
])
def test_wgmma_plan_tiles(host_wgmma_tile, d, tile, monkeypatch):
    """The tensor-core attention's plan by head dim, read from
    ``flash_attention_wgmma.cu``'s ``Tile<DMAX>`` through its library's
    tile entry (here the host build, with ``require_cuda`` and the device
    context patched): 128 query rows and two consumer warpgroups up to
    D 128, 64 rows and one warpgroup above; blocks are query tiles times
    heads."""
    lib = host_wgmma_tile

    class Library:
        @staticmethod
        def symbol(name, argtypes, restype=ctypes.c_int):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), restype
            return fn

    monkeypatch.setattr(fa_mod, "WGMMA", Library)
    monkeypatch.setattr(fa_mod, "require_cuda", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    q = _bf16(3, 200, d)
    plan = fa_mod.wgmma_plan(q, q, q)
    assert (plan["dmax"], plan["block_q"], plan["block_kv"], plan["consumers"],
            plan["threads"]) == tile
    assert plan["smem_bytes"] == _wgmma_tile(lib, d)[5]
    assert plan["blocks"] == 3 * -(-200 // tile[1])
    assert plan["blocks_per_sm"] == 7


def test_tma_aligned_copies_only_unaligned_data():
    """An operand whose data starts off a 16-byte boundary is copied to a
    fresh, aligned allocation with the same values; any other is left as
    ``contiguous()`` gives it."""
    x = _bf16(4, 24)
    assert _cuda.tma_aligned(x) is x
    for offset in (1, 3, 4):
        y = _bf16(4, 24, offset=offset)
        y.copy_(torch.arange(96, dtype=torch.bfloat16).view(4, 24))
        z = _cuda.tma_aligned(y)
        assert y.data_ptr() % 16 and z.data_ptr() % 16 == 0 and z.is_contiguous()
        assert torch.equal(z, y)
    t = _bf16(24, 4).t()
    assert _cuda.tma_aligned(t).is_contiguous() and torch.equal(_cuda.tma_aligned(t), t)


@pytest.mark.parametrize("op", ["matmul", "flash_attention"])
def test_wgmma_route_launches_on_aligned_data(op, monkeypatch):
    """The tensor-core wrappers hand their launcher 16-byte-aligned
    pointers, even for inputs that start off a boundary.  The device check
    is lifted and the launcher recorded, so the wiring shows on the CPU."""
    mod = {"matmul": mm_mod, "flash_attention": fa_mod}[op]
    seen = []
    monkeypatch.setattr(mod, "require_cuda", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(mod, "WGMMA", lambda dev, *args: seen.append(args))
    if op == "matmul":
        mm_mod.matmul(_bf16(64, 48, offset=1), _bf16(48, 80, offset=4))
        ptrs = seen[0][:3]
    else:
        fa_mod.flash_attention(_bf16(2, 64, 64, offset=3), _bf16(2, 64, 64), _bf16(2, 64, 64, offset=5))
        ptrs = seen[0][:4]
    assert len(seen) == 1 and all(p % 16 == 0 for p in ptrs)


def test_routes_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        mm_mod.route(_bf16(64, 48), _bf16(48, 80))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa_mod.route(*(_bf16(2, 64, 64) for _ in range(3)))
    with pytest.raises(TypeError, match="not supported"):
        mm_mod.route(torch.zeros(8, 8, dtype=torch.float16), torch.zeros(8, 8, dtype=torch.float16))


def test_kernels_lists_the_tensor_core_launchers():
    """Each op's two kernels port the same Pallas kernel and count apart."""
    assert KERNELS["matmul_wgmma"] is mm_mod.WGMMA and KERNELS["matmul"] is mm_mod.KERNEL
    assert KERNELS["flash_attention_wgmma"] is fa_mod.WGMMA
    assert KERNELS["flash_attention"] is fa_mod.KERNEL
    for op in ("matmul", "flash_attention"):
        simt, tc = KERNELS[op], KERNELS[f"{op}_wgmma"]
        assert tc.replaces == simt.replaces == f"src/repro/kernels/{op}.py:" + {
            "matmul": "22", "flash_attention": "29"}[op]
        assert tc.path.name == f"{op}_wgmma.cu" and tc.path.is_file()
        assert tc is not simt and tc.path != simt.path


def test_source_inlines_the_hopper_header(tmp_path, monkeypatch):
    """``source()`` puts ``sm90.cuh`` in place of its ``#include`` line, so
    the build (which compiles the text alone) has it and the build's digest
    changes with it, and ``cp_async.cuh`` into the SIMT matmul's; sources
    that name no header are read as they are."""
    header = (_cuda.CSRC / "sm90.cuh").read_text()
    for name in ("matmul_wgmma", "flash_attention_wgmma"):
        src = KERNELS[name].source()
        assert '#include "sm90.cuh"' not in src.splitlines() and header in src
    assert KERNELS["stencil3x3"].source() == KERNELS["stencil3x3"].path.read_text()
    cp_async = (_cuda.CSRC / "cp_async.cuh").read_text()
    assert cp_async in KERNELS["matmul"].source() == KERNELS["matmul_reduce"].source()
    for f in ("matmul_wgmma.cu", "sm90.cuh"):
        shutil.copy(_cuda.CSRC / f, tmp_path / f)
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = build.digest(KERNELS["matmul_wgmma"].source())
    (tmp_path / "sm90.cuh").write_text(header + "\n// changed\n")
    assert build.digest(KERNELS["matmul_wgmma"].source()) != before


def test_wgmma_descriptor_bit_fields(tmp_path):
    """``sm90::smem_desc`` compiled by g++: start address, LBO and SBO in
    16-byte units at bits 0, 16 and 32 (14 bits each), base offset 0 and
    the 128-byte swizzle (1) at bits 62-63."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the header cannot be compiled on the host")
    (tmp_path / "desc.cpp").write_text(
        "#define __host__\n#define __device__\n"
        '#include "sm90.cuh"\n'
        'extern "C" unsigned long long desc(unsigned a, unsigned l, unsigned s) {\n'
        "  static_assert(sm90::smem_desc(1024, 16, 1024) == ((1ull << 62) | (64ull << 32) | (1 << 16) | 64));\n"
        "  return sm90::smem_desc(a, l, s);\n}\n")
    so = tmp_path / "libdesc.so"
    run = subprocess.run([gxx, "-std=c++17", "-shared", "-fPIC", "-I", str(_cuda.CSRC),
                          "-o", str(so), str(tmp_path / "desc.cpp")], capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    fn = ctypes.CDLL(str(so)).desc
    fn.argtypes = [ctypes.c_uint] * 3
    fn.restype = ctypes.c_ulonglong

    def fields(addr, lbo, sbo):
        return ((addr >> 4) & 0x3FFF) | (((lbo >> 4) & 0x3FFF) << 16) \
            | (((sbo >> 4) & 0x3FFF) << 32) | (1 << 62)

    # the kernels' own: A and Q rows (K-major), B and V atoms (MN-major)
    cases = [(0x400, 16, 1024), (0x8420, 16, 1024), (0x20800, 8192, 1024),
             (0x3C000 + 96, 16384, 1024), (0x3FFF0, 0x3FFF0, 0x3FFF0), (0x7, 0xF, 0x1F)]
    for addr, lbo, sbo in cases:
        got = fn(addr, lbo, sbo)
        assert got == fields(addr, lbo, sbo), (hex(got), hex(fields(addr, lbo, sbo)))
        assert (got >> 49) & 0x7 == 0 and got >> 62 == 1


def test_flash_attention_wgmma_shared_memory(host_wgmma_tile):
    """``csrc/flash_attention_wgmma.cu``'s tiles compiled by g++, read
    through its tile entry: at D 256 a block is one consumer warpgroup and a
    producer warp on 64 query rows, whose Q, two stages of 64-row K and V,
    7 barriers and 1024 bytes of alignment fit the 227 KB a block may use;
    D 64 and D 128 keep their 128-row tiles, two consumer warpgroups and
    their sizes; a head dim past 256 is refused."""
    lib = host_wgmma_tile
    limit = 232448  # fa_wgmma::SMEM_PER_BLOCK
    d64, d128, d256 = (_wgmma_tile(lib, d) for d in (64, 128, 256))
    assert d256 == (256, 64, 64, 1, 160, 64 * 512 + 2 * 2 * 64 * 512 + 7 * 8 + 1024)
    assert d256[5] == 164920 <= limit
    assert d64 == (64, 128, 128, 2, 288, 16384 + 4 * 16384 + 7 * 8 + 1024)
    assert d128 == (128, 128, 128, 2, 288, 2 * (16384 + 4 * 16384) + 7 * 8 + 1024)
    assert _wgmma_tile(lib, 65) == d128 and _wgmma_tile(lib, 136) == d256
    assert lib.flash_attention_wgmma_tile(264, (ctypes.c_int * 6)()) != 0


@pytest.mark.parametrize("name,shapes,dtype,chunk,bound_ms,by", [
    ("stencil3x3", [(1082, 1922), (3, 3)], torch.float32, None, 0.0050, "bytes"),
    # the same image in bf16, the weights f32: 8,306,444 B
    ("stencil3x3", [(1082, 1922), (3, 3)], torch.bfloat16, None, 0.0025, "bytes"),
    ("matmul", [(2048, 2048), (2048, 5632)], torch.bfloat16, None, 0.048, "operations"),
    ("matmul", [(2048, 2048), (2048, 5632)], torch.float32, None, 0.705, "operations"),
    ("matmul", [(256, 1000), (1000, 256)], torch.float32, None, 0.00196, "operations"),
    # the tile's 16 f32 splits read once, the output written once
    ("matmul_reduce", [(16, 256, 256)], torch.float32, None, 0.00133, "bytes"),
    ("flash_attention", [(32, 2048, 64)] * 3, torch.bfloat16, None, 0.0174, "operations"),
    ("flash_attention", [(40, 4096, 128)] * 3, torch.bfloat16, None, 0.174, "operations"),
    # gemma3-1b's global layer, D 256: the tensor cores' bound of its work
    ("flash_attention", [(4, 2048, 256)] * 3, torch.bfloat16, None, 0.00869, "operations"),
    ("ssd_gram", [(2048, 128), (2048, 128)], torch.float32, 256, 0.00125, "bytes"),
    # mamba2-2.7b: the chunk-local products at the f32 FMA rate (the read-out
    # of chunks 1..7 only: the state entering chunk 0 is zero), the state
    # pass by its bytes, the workspace among them (8 chunks' states written,
    # 7 chunks' contributions read: the last chunk's is never used)
    ("ssd_chunk_state", [(2048, 80, 64), (2048, 80), (80,), (2048, 128)], torch.float32, 256,
     0.0401, "operations"),
    ("ssd_state_pass", [(8, 80, 128, 64), (2048, 80)], torch.float32, 256, 0.01174, "bytes"),
    ("ssd_chunk_out", [(2048, 80, 64), (2048, 80), (2048, 128), (8, 256, 256), (2048, 80),
                       (8, 80, 128, 64)], torch.float32, 256, 0.0753, "operations"),
])
def test_chip_smoke_bounds(name, shapes, dtype, chunk, bound_ms, by):
    """``kernel_work`` (``repro_torch.roofline.kernel_cost``, which
    ``chip_smoke.py`` reads) gives each phase-7 configuration the bound that
    PERF.md reports (shapes on the meta device: nothing is allocated)."""
    from pathlib import Path

    from repro_torch.roofline.analysis import HBM_BW
    from repro_torch.roofline.kernel_cost import kernel_work

    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert "from repro_torch.roofline.kernel_cost import kernel_work" in smoke
    # the stencil's weights and the SSD operands after x are f32 whatever x's dtype
    f32_after_x = name.startswith(("ssd_", "stencil"))
    args = [torch.empty(sh, dtype=dtype if i == 0 or not f32_after_x else torch.float32,
                        device="meta") for i, sh in enumerate(shapes)]
    if name == "matmul_reduce":
        out_shape = shapes[0][1:]
    else:
        out_shape = {"stencil3x3": (1080, 1920), "matmul": (shapes[0][0], shapes[1][1]),
                     "ssd_gram": (8, 256, 256), "ssd_chunk_state": (8, 80, 128, 64)}.get(name, shapes[0])
    nbytes, ops_, peak = kernel_work(name, args, torch.empty(out_shape, dtype=dtype, device="meta"), chunk)
    t_bytes, t_ops = 1e3 * nbytes / HBM_BW, 1e3 * ops_ / peak
    assert ("bytes" if t_bytes >= t_ops else "operations") == by
    assert max(t_bytes, t_ops) == pytest.approx(bound_ms, rel=0.02)


# ---------------------------------------------------------------------------
# the SIMT matmul under g++, through its wrapper
# ---------------------------------------------------------------------------

BF16_SHIM = r"""
#pragma once
// Host stand-in for cuda_bf16.h: bf16 as its 16 bits, rounded to nearest even.
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
inline float __bfloat162float(__nv_bfloat16 v) {
  unsigned u = (unsigned)v.x << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
"""
# cp.async as a plain copy (zeros where the copy is masked), its waits no-ops;
# a copy from a source off 16 bytes, which faults on the card, is counted
CP_ASYNC_SHIM = r"""
#pragma once
#include <cstdint>
#include <cstring>
extern "C" int cp_async_misaligned;
int cp_async_misaligned = 0;
inline void cp_async16(void* dst, const void* src, bool full) {
  if (full && (uintptr_t)src % 16) ++cp_async_misaligned;
  if (full) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
"""


class _HostLauncher:
    """A launcher of a SIMT kernel built for the host: the same C entry and
    arguments as the CUDA launcher it stands for, and a count.  Each of
    ``outs``, ``(i, nbytes)``, names an output, argument ``i``, whose
    ``nbytes(*args)`` bytes are set to NaN before the launch, so an element
    the kernel leaves unwritten shows.  A launch that issues a ``cp.async``
    from a source off 16 bytes, a fault on the card, fails."""

    def __init__(self, lib, launcher, *outs):
        self.misaligned = ctypes.c_int.in_dll(lib, "cp_async_misaligned")
        self.fn = getattr(lib, f"{launcher.name}_launch")
        self.fn.argtypes = launcher._argtypes + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        self.outs = outs
        self.launches = 0

    def __call__(self, device, *args):
        for i, nbytes in self.outs:
            ctypes.memset(args[i], 0xFF, nbytes(*args))
        self.misaligned.value = 0
        assert device.type == "cpu" and self.fn(*args, None) == 0
        assert self.misaligned.value == 0, "cp.async from a source off 16 bytes"
        self.launches += 1


@pytest.fixture(scope="module")
def host_matmul(tmp_path_factory):
    """``csrc/matmul.cu`` compiled by g++ against the emitted-kernel shim of
    ``tests/test_torch_emit_host.py`` (a host thread per CUDA thread, the
    blocks in turn, shared memory NaN before each), with ``cp.async`` a
    plain copy."""
    from test_torch_emit_host import SHIM, host_source

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the kernel cannot be built on the host")
    root = tmp_path_factory.mktemp("matmul_host")
    for name, text in (("cuda_runtime.h", SHIM), ("cuda_bf16.h", BF16_SHIM),
                       ("cp_async.cuh", CP_ASYNC_SHIM)):
        (root / name).write_text(text)
    src = root / "matmul.cpp"
    src.write_text(host_source(mm_mod.KERNEL.path.read_text()))
    so = root / "libmatmul.so"
    run = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread", "-w",
         "-Dmatmul_smem=ub_smem", "-I", str(root), "-o", str(so), str(src)],
        capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-4000:]
    return ctypes.CDLL(str(so))


# (m, n, k, dtype): the way each fills the ring and splits K is asserted
HOST_MATMULS = [
    # K and N not multiples of 4: loaded through registers, ragged edges
    (37, 53, 29, torch.float32),
    # cp.async with M and N edges inside a 64-tile and a K tail of 4
    (70, 76, 52, torch.float32),
    # the 256 x 1000 @ 1000 x 256 tile scaled down: K split in 3 (cp.async)
    (32, 40, 200, torch.float32),
    # K split in 3 and not a multiple of 4: registers
    (40, 36, 250, torch.float32),
    # 128-tiles, 9 x 17 of them, ragged at both edges
    (1030, 2052, 20, torch.float32),
    # bf16 with N not a multiple of 8: the SIMT route, converted to f32
    (64, 84, 48, torch.bfloat16),
    # bf16, K split: f32 partial sums, cast once by the reduction
    (48, 36, 200, torch.bfloat16),
]


@pytest.mark.parametrize("m,n,k,dtype", HOST_MATMULS,
                         ids=[f"{m}x{n}x{k}-{str(d)[6:]}" for m, n, k, d in HOST_MATMULS])
@pytest.mark.parametrize("values", ["integer", "normal"])
def test_simt_matmul_on_host_matches_plain_version(host_matmul, m, n, k, dtype, values,
                                                   monkeypatch):
    """The SIMT kernel's source run on the CPU through ``matmul`` (its
    device check lifted, its two launchers built for the host): integer
    inputs, whose every sum is exact, bit for bit against the plain
    version; normal ones at the JAX package's tolerance (1e-4 f32, 2e-2
    bf16), since the kernel fuses each multiply-add.  One launch of the
    kernel per call, and one of ``matmul_reduce`` where ``simt_plan``
    splits K."""
    kernel = _HostLauncher(host_matmul, mm_mod.KERNEL)
    reduce = _HostLauncher(host_matmul, mm_mod.REDUCE)
    monkeypatch.setattr(mm_mod, "require_cuda", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(mm_mod, "KERNEL", kernel)
    monkeypatch.setattr(mm_mod, "REDUCE", reduce)
    rng = np.random.default_rng(m * n + k)
    if values == "integer":
        a_np, b_np = (rng.integers(-8, 8, sh).astype(np.float32) for sh in ((m, k), (k, n)))
    else:
        a_np, b_np = (rng.standard_normal(sh).astype(np.float32) for sh in ((m, k), (k, n)))
    a, b = ops.to_tensor(a_np, dtype, "cpu"), ops.to_tensor(b_np, dtype, "cpu")
    blocks = dict(block_m=m, block_n=n)
    got = mm_mod.matmul(a, b, **blocks)
    want = matmul_plain(a, b, **blocks)
    tile, k_split, splits = mm_mod.simt_plan(m, n, k)
    assert (kernel.launches, reduce.launches) == (1, int(splits > 1))
    assert got.dtype == dtype and got.shape == (m, n)
    if values == "integer":
        assert torch.equal(got, want)
    else:
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_simt_plan_fills_the_card():
    """Tiles and splits come from the shape alone: 128-tiles where they
    reach 132 blocks (the f32 MLP up-projection), else 64-tiles, with K
    split, in ranges that are multiples of 16 and at least 64 deep, until
    the blocks reach 264 (the 256 x 1000 @ 1000 x 256 tile: 16 tiles, 16
    splits of 64)."""
    assert mm_mod.simt_plan(2048, 5632, 2048) == (128, 2048, 1)
    assert mm_mod.simt_plan(256, 256, 1000) == (64, 64, 16)
    assert mm_mod.simt_plan(64, 84, 48) == (64, 48, 1)
    for m, n, k in [(256, 256, 1000), (64, 84, 48), (40, 36, 250), (16, 16, 4096), (8, 8, 7)]:
        tile, k_split, splits = mm_mod.simt_plan(m, n, k)
        blocks = -(-m // tile) * -(-n // tile) * splits
        assert (splits - 1) * k_split < k <= splits * k_split
        assert splits == 1 or (k_split % 16 == 0 and k_split >= 64)
        assert blocks >= 132 or tile == 64
        assert splits == 1 or blocks >= 264 or k_split == 64
    # a long K on one tile: split as far as 64-deep ranges allow
    assert mm_mod.simt_plan(16, 16, 4096) == (64, 64, 64)


# ---------------------------------------------------------------------------
# the SIMT flash_attention and ssd_gram under g++, through their wrappers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_simt(tmp_path_factory):
    """``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu`` compiled by g++
    against the shim of ``tests/test_torch_emit_host.py`` (a host thread per
    CUDA thread, ``__shfl_xor_sync`` through a block-wide exchange array,
    shared memory NaN before each block), with ``cp.async`` a plain copy and
    each kernel's dynamic shared memory the shim's array; both built
    together.  Returns ``{file: library}``."""
    import re

    from test_torch_emit_host import SHIM, host_source

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the kernels cannot be built on the host")
    root = tmp_path_factory.mktemp("simt_host")
    for name, text in (("cuda_runtime.h", SHIM), ("cuda_bf16.h", BF16_SHIM),
                       ("cp_async.cuh", CP_ASYNC_SHIM)):
        (root / name).write_text(text)
    jobs = {}
    for launcher in (fa_mod.KERNEL, ssd_mod.GRAM):
        text = re.sub(r"extern __shared__ (?:__align__\(16\) )?float (\w+)\[\];",
                      r"float* const \1 = ub_smem;", launcher.path.read_text())
        src = root / f"{launcher.file}.cpp"
        src.write_text(host_source(text))
        so = root / f"lib{launcher.file}.so"
        jobs[launcher.file] = (so, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread", "-w",
             "-I", str(root), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for file, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log[-4000:]
        libs[file] = ctypes.CDLL(str(so))
    return libs


# the output (b, sq, d) of dtype code `dt`, argument 3 of the SIMT launch
FLASH_OUT = (3, lambda q, k, v, o, b, sq, skv, d, scale, causal, off, dt:
             b * sq * d * (4 - 2 * dt))

# (batch, Sq, Skv, D, causal, dtype): how each reaches shared memory follows
# from dtype, D and alignment (cp.async for f32 with D % 4 == 0, else through
# registers; bf16 rows as 8-byte quads where D % 4 == 0)
HOST_FLASH = [
    # cp.async, both tiles cut (96 = 64 + 32)
    (2, 96, 96, 64, True, torch.float32),
    # non-causal, Sq != Skv, the last KV tile cut
    (1, 96, 192, 64, False, torch.float32),
    # D 30: f32 through registers, columns zero-padded to 32
    (2, 96, 96, 30, True, torch.float32),
    (1, 64, 192, 30, False, torch.bfloat16),
    # the 128 instantiation (D 100, not a multiple of 8), bf16 held in
    # registers across the products
    (1, 64, 192, 100, False, torch.float32),
    (1, 96, 96, 100, True, torch.bfloat16),
    # the 256 instantiation: D 136 and 256, f32 by cp.async, bf16 quads
    (1, 96, 96, 136, True, torch.float32),
    (1, 96, 192, 136, False, torch.bfloat16),
    (1, 128, 128, 256, True, torch.bfloat16),
    (1, 64, 128, 256, False, torch.float32),
    # bf16 the tensor cores take: the SIMT kernel on the same call
    (2, 128, 128, 64, True, torch.bfloat16),
]


@pytest.mark.parametrize("b,sq,skv,d,causal,dtype", HOST_FLASH, ids=[
    f"{b}x{sq}x{skv}x{d}-{'causal' if c else 'full'}-{str(t)[6:]}"
    for b, sq, skv, d, c, t in HOST_FLASH])
def test_simt_flash_attention_on_host_matches_plain_version(host_simt, b, sq, skv, d, causal,
                                                            dtype, monkeypatch):
    """The SIMT kernel's source run on the CPU through ``flash_attention``
    (its device check lifted, its launcher built for the host, the route
    held to ``"simt"`` for bf16 the tensor cores would take), one launch a
    call, against the plain version at the card's tolerances: 2e-3 and each
    row's error within 1e-4 of its norm for f32, 3e-2 for bf16."""
    kernel = _HostLauncher(host_simt["flash_attention"], fa_mod.KERNEL, FLASH_OUT)
    monkeypatch.setattr(fa_mod, "require_cuda", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(fa_mod, "KERNEL", kernel)
    monkeypatch.setattr(fa_mod, "_route", lambda q: "simt")
    rng = np.random.default_rng(sq * d + skv)
    q, k, v = (ops.to_tensor(rng.standard_normal((b, n, d)).astype(np.float32), dtype, "cpu")
               for n in (sq, skv, skv))
    kw = dict(causal=causal, block_q=32, block_kv=32)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    assert kernel.launches == 1
    assert got.dtype == dtype and got.shape == (b, sq, d)
    plan = fa_mod.simt_plan(q, k, v)
    assert plan["blocks"] == -(-sq // 64) * b
    assert plan["threads"] == (128 if d <= 64 and plan["copy"] == "cp.async" else 256)
    assert plan["copy"] == ("cp.async" if dtype == torch.float32 and d % 4 == 0 else "registers")
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.float32:
        rows = (got - want).norm(dim=-1) / want.norm(dim=-1)
        assert float(rows.max()) <= 1e-4


# (batch, Sq, Skv, D, q_offset, dtype): a rank's query rows at their offset,
# causal: the last rows of the keys, an offset off the 64-row tile (the
# mask cuts each tile in another place), offset 0 with Sq < Skv (the first
# rank), a ragged query tile, bf16 quads at D 136
HOST_FLASH_OFFSET = [
    (2, 32, 96, 64, 64, torch.float32),
    (1, 64, 192, 64, 37, torch.float32),
    (1, 32, 96, 30, 0, torch.bfloat16),
    (1, 40, 96, 100, 56, torch.float32),
    (1, 64, 128, 136, 64, torch.bfloat16),
]


@pytest.mark.parametrize("b,sq,skv,d,off,dtype", HOST_FLASH_OFFSET, ids=[
    f"{b}x{sq}at{o}x{skv}x{d}-{str(t)[6:]}" for b, sq, skv, d, o, t in HOST_FLASH_OFFSET])
def test_simt_flash_attention_on_host_at_an_offset(host_simt, b, sq, skv, d, off, dtype,
                                                   monkeypatch):
    """The SIMT kernel's source on the CPU (as above) on query rows [off,
    off + Sq) of a causal self-attention over Skv keys, at ``q_offset=off``:
    against the plain version at the same offset and against those rows of
    the whole call's plain version, at the card's tolerances."""
    kernel = _HostLauncher(host_simt["flash_attention"], fa_mod.KERNEL, FLASH_OUT)
    monkeypatch.setattr(fa_mod, "require_cuda", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(fa_mod, "KERNEL", kernel)
    monkeypatch.setattr(fa_mod, "_route", lambda q: "simt")
    rng = np.random.default_rng(sq * d + skv + off)
    qa, k, v = (ops.to_tensor(rng.standard_normal((b, skv, d)).astype(np.float32), dtype, "cpu")
                for _ in range(3))
    q = qa[:, off : off + sq]
    kw = dict(causal=True, block_q=8, block_kv=32)
    got = flash_attention(q, k, v, q_offset=off, **kw)
    want = flash_attention_plain(q, k, v, q_offset=off, **kw)
    assert kernel.launches == 1 and got.shape == (b, sq, d) and got.dtype == dtype
    assert torch.equal(want, flash_attention_plain(qa, k, v, **kw)[:, off : off + sq])
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.float32:
        rows = (got - want).norm(dim=-1) / want.norm(dim=-1)
        assert float(rows.max()) <= 1e-4


# (chunk, N): S = 96 (84 for chunk 42); chunk 48 and 42 take two row tiles
# of 32, so a block writes the zero tile mirroring it above the diagonal
# (float4 stores where the chunk is a multiple of 4); N 18 goes through
# registers, the others by cp.async
HOST_GRAMS = [(ch, n) for ch in (8, 16, 48) for n in (16, 20, 32)] + [(48, 18), (42, 20)]


@pytest.mark.parametrize("chunk,n", HOST_GRAMS, ids=[f"chunk{c}-n{n}" for c, n in HOST_GRAMS])
@pytest.mark.parametrize("values", ["integer", "normal"])
def test_ssd_gram_on_host_matches_plain_version(host_simt, chunk, n, values, monkeypatch):
    """``ssd_gram``'s kernel run on the CPU through its wrapper, one launch
    a call: integer inputs, whose every sum is exact, bit for bit against
    ``ssd_gram_plain``; normal ones within 1e-4 of an f64 product."""
    # the output (s_len / L, L, L) f32
    gram = _HostLauncher(host_simt["ssd_scan"], ssd_mod.GRAM,
                         (2, lambda b, c, g, s_len, n, L: 4 * s_len * L))
    monkeypatch.setattr(ssd_mod, "require_cuda", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(ssd_mod, "GRAM", gram)
    s = 84 if chunk == 42 else 96
    rng = np.random.default_rng(chunk * n)
    if values == "integer":
        b_np, c_np = (rng.integers(-8, 8, (s, n)).astype(np.float32) for _ in range(2))
    else:
        b_np, c_np = (rng.standard_normal((s, n)).astype(np.float32) for _ in range(2))
    b, c = torch.from_numpy(b_np), torch.from_numpy(c_np)
    got = ssd_mod.ssd_gram(b, c, chunk)
    assert gram.launches == 1 and got.shape == (s // chunk, chunk, chunk)
    if values == "integer":
        assert torch.equal(got, ssd_gram_plain(b, c, chunk))
    else:
        g64 = torch.matmul(c.double().view(-1, chunk, n),
                           b.double().view(-1, chunk, n).transpose(1, 2)).tril()
        torch.testing.assert_close(got.double(), g64, rtol=1e-4, atol=1e-4)


# (chunk, P, N, dtype) over S 96 and H 3: chunk 8 and 16 leave most of a
# 64-row tile empty, chunk 48 cuts one; P 40 cuts the 64-wide P tile; N 18
# brings B in through registers (not a multiple of 4) and N 20 cuts a
# 16-deep slice; bf16 x goes through registers everywhere; P 5 takes f32 x
# through registers too, and N * P 90 and 85 a state pass without float4s
HOST_SSD = [(ch, p, n, dtype) for ch in (8, 16, 48) for p in (8, 40) for n in (16, 18, 20)
            for dtype in (torch.float32, torch.bfloat16)]
HOST_SSD += [(16, 5, 18, torch.float32), (48, 5, 17, torch.bfloat16)]


@pytest.mark.parametrize("chunk,p,n,dtype", HOST_SSD, ids=[
    f"chunk{c}-p{p}-n{n}-{str(d)[6:]}" for c, p, n, d in HOST_SSD])
def test_ssd_chunk_kernels_on_host_match_plain_versions(host_simt, chunk, p, n, dtype,
                                                         monkeypatch):
    """``ssd_chunk_state``, ``ssd_state_pass`` and ``ssd_chunk_out`` run on
    the CPU through their wrappers (outputs NaN first), one launch each a
    call, each within 1e-4 of its plain version on the same inputs (a bf16
    y within one bf16 rounding, 2**-8 relative, of the plain version's f32
    value), and ``ssd_chunk_scan``, which launches the three, within 1e-4
    of ``ssd_chunk_scan_plain`` (its f32 sums reordered: the scan of s,
    the chunk-local products)."""
    lib = host_simt["ssd_scan"]
    # outputs: the states (S / L, H, N, P) and s (S, H), f32; y (S, H, P) of x's dtype
    state = _HostLauncher(lib, ssd_mod.STATE,
                          (4, lambda *a: 4 * a[6] // a[10] * a[7] * a[8] * a[9]),
                          (5, lambda *a: 4 * a[6] * a[7]))
    pass_ = _HostLauncher(lib, ssd_mod.PASS)
    out = _HostLauncher(lib, ssd_mod.OUT, (6, lambda *a: a[7] * a[8] * a[9] * (4 - 2 * a[12])))
    monkeypatch.setattr(ssd_mod, "require_cuda", lambda *a: torch.device("cpu"))
    for name, launcher in (("STATE", state), ("PASS", pass_), ("OUT", out)):
        monkeypatch.setattr(ssd_mod, name, launcher)
    rng = np.random.default_rng(chunk * 1000 + p * n)
    arrs = ssd_arrays(rng, 96, 3, p, n)
    x = ops.to_tensor(arrs[0], dtype, "cpu")
    dt, a, b, c = (torch.from_numpy(v) for v in arrs[1:])
    g = ssd_gram_plain(b, c, chunk)

    def close(got, want, tol=1e-4):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)

    states, s = ssd_chunk_state(x, dt, a, b, chunk)
    want_states, want_s = ssd_chunk_state_plain(x, dt, a, b, chunk)
    assert states.shape == (96 // chunk, 3, n, p) and s.shape == (96, 3)
    close(s, want_s)
    close(states, want_states)
    entering = ssd_state_pass(states.clone(), s, chunk)
    close(entering, ssd_state_pass_plain(states, s, chunk))
    y = ssd_chunk_out(x, dt, c, g, s, entering, chunk)
    assert y.dtype == dtype and y.shape == (96, 3, p)
    want_y = ssd_chunk_out_plain(x.float(), dt, c, g, s, entering, chunk)
    close(y.float(), want_y, 1e-4 if dtype == torch.float32 else 2 ** -8)
    assert (state.launches, pass_.launches, out.launches) == (1, 1, 1)
    y = ssd_chunk_scan(x, dt, a, b, c, g, chunk=chunk)
    assert (state.launches, pass_.launches, out.launches) == (2, 2, 2)
    want = ssd_chunk_scan_plain(x.float(), dt, a, b, c, g, chunk=chunk)
    close(y.float(), want, 1e-4 if dtype == torch.float32 else 2 ** -8)


@pytest.mark.parametrize("n,p", [(16, 8), (18, 5)], ids=["float4", "scalar"])
def test_ssd_state_pass_on_host_ignores_the_last_chunk(host_simt, n, p, monkeypatch):
    """The last chunk's contribution and s make only the state after the
    sequence, which nothing reads: ``ssd_state_pass`` gives the same
    entering states, all finite, with them NaN (float4 and scalar
    threads)."""
    pass_ = _HostLauncher(host_simt["ssd_scan"], ssd_mod.PASS)
    monkeypatch.setattr(ssd_mod, "require_cuda", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(ssd_mod, "PASS", pass_)
    rng = np.random.default_rng(n * p)
    chunk, nc, h = 16, 4, 3
    states = torch.from_numpy(rng.standard_normal((nc, h, n, p)).astype(np.float32))
    s = torch.from_numpy(-rng.random((nc * chunk, h)).astype(np.float32))
    want = ssd_state_pass_plain(states, s, chunk)
    states[-1], s[-chunk:] = float("nan"), float("nan")
    got = ssd_state_pass(states.clone(), s, chunk)
    assert pass_.launches == 1 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_ssd_chunk_out_on_host_takes_states_off_16_bytes(host_simt, monkeypatch):
    """``ssd_chunk_out`` on f32 x whose states start one float past a
    16-byte boundary: the launcher must not take them by ``cp.async``
    (``_HostLauncher`` fails the launch), and y is within 1e-4 of its plain
    version."""
    out = _HostLauncher(host_simt["ssd_scan"], ssd_mod.OUT,
                        (6, lambda *a: a[7] * a[8] * a[9] * (4 - 2 * a[12])))
    monkeypatch.setattr(ssd_mod, "require_cuda", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(ssd_mod, "OUT", out)
    chunk, p, n = 16, 8, 16
    rng = np.random.default_rng(7)
    arrs = ssd_arrays(rng, 96, 3, p, n)
    x, dt, a, b, c = (torch.from_numpy(v) for v in arrs)
    g = ssd_gram_plain(b, c, chunk)
    states, s = ssd_chunk_state_plain(x, dt, a, b, chunk)
    entering = ssd_state_pass_plain(states, s, chunk)
    flat = torch.empty(entering.numel() + 1)
    off = flat[1:].view(entering.shape)
    off.copy_(entering)
    assert off.data_ptr() % 16 != 0
    y = ssd_chunk_out(x, dt, c, g, s, off, chunk)
    assert out.launches == 1
    torch.testing.assert_close(y, ssd_chunk_out_plain(x, dt, c, g, s, entering, chunk),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the stencil under g++, through its wrapper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_stencil(tmp_path_factory):
    """``csrc/stencil3x3.cu`` compiled by g++ against the shim of
    ``tests/test_torch_emit_host.py`` (a host thread per CUDA thread, the
    blocks in turn) and its bf16 stand-in."""
    from test_torch_emit_host import SHIM, host_source

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the kernel cannot be built on the host")
    root = tmp_path_factory.mktemp("stencil_host")
    for name, text in (("cuda_runtime.h", SHIM), ("cuda_bf16.h", BF16_SHIM),
                       ("cp_async.cuh", CP_ASYNC_SHIM)):
        (root / name).write_text(text)
    src = root / "stencil3x3.cpp"
    # the shim's copy counter, which ``_HostLauncher`` reads (the kernel
    # issues no cp.async: it stays 0)
    src.write_text('#include "cp_async.cuh"\n' + host_source(st_mod.KERNEL.source()))
    so = root / "libstencil3x3.so"
    run = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread", "-w",
         "-I", str(root), "-o", str(so), str(src)],
        capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-4000:]
    return ctypes.CDLL(str(so))


# (H, W, bytes the input's data starts past a 16-byte boundary): odd W with
# H not a multiple of a band; W + 2 a multiple of neither 4 nor 8; one
# output; 16-byte output rows (f32 and bf16); input rows of element pairs
# (8 B f32, 4 B bf16) on a view off 16 bytes, and of single elements on a
# view off by one element; W past one strip of 256 threads (f32: 3 strips
# of 96)
HOST_STENCILS = [(13, 37, 0), (16, 20, 0), (1, 1, 0), (9, 24, 0), (12, 30, 8), (12, 30, 1),
                 (6, 1030, 0)]


def _stencil_input(h, w, dtype, off, values, rng, device="cpu"):
    """An (H + 2, W + 2) input of ``dtype`` on ``device`` whose data starts
    ``off`` bytes past a 16-byte boundary (``off`` 1: one element)."""
    if values == "integer":
        arr = rng.integers(0, 256, (h + 2, w + 2)).astype(np.float32)
    else:
        arr = rng.standard_normal((h + 2, w + 2)).astype(np.float32)
    size = torch.empty((), dtype=dtype).element_size()
    skip = 1 if off == 1 else off // size
    flat = torch.empty((h + 2) * (w + 2) + 16, dtype=dtype, device=device)
    lead = (-flat.data_ptr() % 16) // size + skip
    x = flat[lead:lead + (h + 2) * (w + 2)].view(h + 2, w + 2)
    x.copy_(ops.to_tensor(arr, dtype, device))
    assert x.data_ptr() % 16 == (size if off == 1 else off)
    return x


@pytest.mark.parametrize("h,w,off", HOST_STENCILS,
                         ids=[f"{h}x{w}-off{o}" for h, w, o in HOST_STENCILS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("values", ["integer", "normal"])
def test_stencil3x3_on_host_matches_plain_version(host_stencil, h, w, off, dtype, values,
                                                  monkeypatch):
    """The stencil's source run on the CPU through ``stencil3x3`` (its
    device check lifted, its launcher built for the host, the output NaN
    first), one launch a call: integer inputs bit for bit against ``stencil3x3_plain``, normal ones
    within 1e-5 (bf16: one bf16 rounding, 2**-8 relative)."""
    # the output (h, wd) of dtype code `dt`
    kernel = _HostLauncher(host_stencil, st_mod.KERNEL,
                           (2, lambda x, w_, o, h_, wd, dt, t: h_ * wd * (4 - 2 * dt)))
    monkeypatch.setattr(st_mod, "require_cuda", lambda *a: torch.device("cpu"))
    monkeypatch.setattr(st_mod, "KERNEL", kernel)
    rng = np.random.default_rng(h * w + off)
    x = _stencil_input(h, w, dtype, off, values, rng)
    wts = torch.from_numpy(GAUSS)
    got = stencil3x3(x, wts)
    assert kernel.launches == 1
    assert got.dtype == dtype and got.shape == (h, w)
    want = stencil3x3_plain(x, wts)
    if values == "integer":
        assert torch.equal(got, want)
    else:
        tol = 1e-5 if dtype == torch.float32 else 2 ** -8
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("h,w", [(h, w) for h, w, _ in HOST_STENCILS] + [(1080, 1920)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stencil_plan_covers_every_output_once(h, w, dtype):
    """``stencil.plan`` from shape and dtype alone: whole warps, at most 256
    threads, the band height the kernel is compiled for; its strips and
    bands cover every output once (the last of each ragged at most)."""
    p = st_mod.plan(h, w, dtype)
    assert p["v"] == (4 if dtype == torch.float32 else 8)
    assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= 256
    src = st_mod.KERNEL.path.read_text()
    assert p["rows"] == st_mod.ROWS and f"constexpr int ROWS = {st_mod.ROWS};" in src
    cols = p["threads"] * p["v"]
    assert (p["strips"] - 1) * cols < w <= p["strips"] * cols
    assert (p["bands"] - 1) * p["rows"] < h <= p["bands"] * p["rows"]
    assert p["blocks"] == p["strips"] * p["bands"]
    covered = torch.zeros(p["bands"] * p["rows"], p["strips"] * cols, dtype=torch.int32)
    for band in range(p["bands"]):
        for strip in range(p["strips"]):
            covered[band * p["rows"]:(band + 1) * p["rows"], strip * cols:(strip + 1) * cols] += 1
    assert torch.equal(covered[:h, :w], torch.ones(h, w, dtype=torch.int32))
    if (h, w) == (1080, 1920):
        # 1080p: 3 strips of 160 threads (f32), one strip of 256 (bf16), 270
        # bands of 4 rows
        want = (160, 810) if dtype == torch.float32 else (256, 270)
        assert (p["threads"], p["blocks"]) == want


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_kernels_match_plain_version_on_card():
    """Build and launch the ten kernels on small shapes; hold each against
    its plain version (stencil, f32 and bf16, ragged and off 16 bytes,
    integer matmuls and grams bit for bit), one launch
    per call of the kernel its route names (the SSD op: one of each of its
    four kernels; a SIMT matmul that splits K: one of the kernel and one of
    ``matmul_reduce``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    rng = np.random.default_rng(13)

    def t(*shape, dtype=torch.float32):
        return ops.to_tensor(rng.standard_normal(shape).astype(np.float32), dtype)

    bf16 = torch.bfloat16

    def ints(*shape):
        return ops.to_tensor(rng.integers(-8, 8, shape).astype(np.float32), bf16)

    def off16(x):
        """``x``'s values in a view whose data starts 2 bytes off 16."""
        y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        return y.copy_(x)

    x, w = t(34, 50), ops.to_tensor(GAUSS)
    ssd_in = tuple(ops.to_tensor(a) for a in ssd_arrays(rng, 128, 3, 40, 16))
    cases = [
        ("stencil3x3", stencil3x3, stencil3x3_plain, (x, w), {}, 0.0),
        ("matmul", matmul, matmul_plain, (t(64, 48), t(48, 80)), {}, 1e-4),
        ("matmul_wgmma", matmul, matmul_plain,
         (t(64, 48, dtype=bf16), t(48, 80, dtype=bf16)), {}, 2e-2),
        # integers: every sum exact, so the tensor cores must agree bit for
        # bit, ragged M and N edges and a K tail included
        ("matmul_wgmma", matmul, matmul_plain, (ints(64, 48), ints(48, 80)), {}, 0.0),
        ("matmul_wgmma", matmul, matmul_plain, (ints(130, 72), ints(72, 136)), {}, 0.0),
        # N not a multiple of 8: TMA cannot read B, the SIMT kernel does
        ("matmul", matmul, matmul_plain, (ints(64, 48), ints(48, 84)), {}, 0.0),
        # data off a 16-byte boundary is copied, not sent to the SIMT kernel
        ("matmul_wgmma", matmul, matmul_plain, (off16(ints(64, 48)), off16(ints(48, 80))), {}, 0.0),
        ("flash_attention", flash_attention, flash_attention_plain,
         (t(2, 128, 64), t(2, 128, 64), t(2, 128, 64)), {"causal": True}, 2e-3),
        ("flash_attention", flash_attention, flash_attention_plain,
         (t(2, 64, 128), t(2, 256, 128), t(2, 256, 128)), {"causal": False}, 2e-3),
        ("flash_attention_wgmma", flash_attention, flash_attention_plain,
         tuple(t(2, 128, 64, dtype=bf16) for _ in range(3)), {"causal": True}, 3e-2),
        ("flash_attention_wgmma", flash_attention, flash_attention_plain,
         (t(2, 64, 128, dtype=bf16), t(2, 256, 128, dtype=bf16), t(2, 256, 128, dtype=bf16)),
         {"causal": False}, 3e-2),
        ("flash_attention_wgmma", flash_attention, flash_attention_plain,
         tuple(t(1, 256, 32, dtype=bf16) for _ in range(3)), {"causal": True}, 3e-2),
        ("flash_attention_wgmma", flash_attention, flash_attention_plain,
         tuple(off16(t(2, 128, 64, dtype=bf16)) for _ in range(3)), {"causal": True}, 3e-2),
        # head dims above 128: bf16 on the D 256 tensor-core kernel, its
        # 64-row query and KV tiles cut (S 96; Skv 192 non-causal)
        ("flash_attention_wgmma", flash_attention, flash_attention_plain,
         tuple(t(2, 64, 136, dtype=bf16) for _ in range(3)), {"causal": True}, 3e-2),
        ("flash_attention_wgmma", flash_attention, flash_attention_plain,
         tuple(t(2, 96, 256, dtype=bf16) for _ in range(3)),
         {"causal": True, "block_q": 32, "block_kv": 32}, 3e-2),
        ("flash_attention_wgmma", flash_attention, flash_attention_plain,
         (t(2, 64, 256, dtype=bf16), t(2, 192, 256, dtype=bf16), t(2, 192, 256, dtype=bf16)),
         {"causal": False, "block_q": 32, "block_kv": 32}, 3e-2),
        # D not a multiple of 8: bf16 on the SIMT kernel
        ("flash_attention", flash_attention, flash_attention_plain,
         tuple(t(2, 64, 60, dtype=bf16) for _ in range(3)), {"causal": True}, 3e-2),
        ("ssd_gram", ssd_gram, ssd_gram_plain, (ssd_in[3], ssd_in[4], 32), {}, 1e-4),
        ("ssd_scan", ssd_scan, ssd_scan_plain, ssd_in, {"chunk": 32}, 1e-3),
        # mamba2-like: P 64, N 128, the default chunk of 256, two chunks
        ("ssd_scan", ssd_scan, ssd_scan_plain,
         tuple(ops.to_tensor(a) for a in ssd_arrays(rng, 512, 4, 64, 128)), {}, 1e-3),
    ]
    # the stencil's host cases on the card, f32 and bf16, integer and normal
    # inputs, each bit for bit
    for h, w, off in HOST_STENCILS:
        for dtype in (torch.float32, bf16):
            for values in ("integer", "normal"):
                cases.append(("stencil3x3", stencil3x3, stencil3x3_plain,
                              (_stencil_input(h, w, dtype, off, values, rng, "cuda"),
                               ops.to_tensor(GAUSS)), {}, 0.0))
    # the SIMT matmul's host cases on the card: random at the JAX
    # tolerances, integers bit for bit
    for m, n, k, dtype in HOST_MATMULS:
        kw = dict(block_m=m, block_n=n)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        cases.append(("matmul", matmul, matmul_plain, (t(m, k, dtype=dtype), t(k, n, dtype=dtype)),
                      kw, tol))
        if dtype == torch.bfloat16:
            cases.append(("matmul", matmul, matmul_plain, (ints(m, k), ints(k, n)), kw, 0.0))
        else:
            cases.append(("matmul", matmul, matmul_plain,
                          (ints(m, k).float(), ints(k, n).float()), kw, 0.0))
    # the SIMT attention's and the gram's host cases on the card (bf16 that
    # the tensor cores take goes there, by its route)
    for b, sq, skv, d, causal, dtype in HOST_FLASH:
        qkv = (t(b, sq, d, dtype=dtype), t(b, skv, d, dtype=dtype), t(b, skv, d, dtype=dtype))
        name = "flash_attention_wgmma" if fa_mod._route(qkv[0]) == "wgmma" else "flash_attention"
        cases.append((name, flash_attention, flash_attention_plain, qkv,
                      dict(causal=causal, block_q=32, block_kv=32),
                      2e-3 if dtype == torch.float32 else 3e-2))
    for chunk, n in HOST_GRAMS:
        s_len = 84 if chunk == 42 else 96
        cases.append(("ssd_gram", ssd_gram, ssd_gram_plain,
                      (ints(s_len, n).float(), ints(s_len, n).float(), chunk), {}, 0.0))
    # the SSD kernels' host cases on the card, through the op (a bf16 y
    # within a bf16 rounding of the plain version's)
    for chunk, p, n, dtype in HOST_SSD:
        arrs = ssd_arrays(rng, 96, 3, p, n)
        cases.append(("ssd_scan", ssd_scan, ssd_scan_plain,
                      (ops.to_tensor(arrs[0], dtype), *(ops.to_tensor(v) for v in arrs[1:])),
                      {"chunk": chunk}, 1e-3 if dtype == torch.float32 else 1e-2))
    for name, fn, plain, args, kw, tol in cases:
        before = {k: launcher.launches for k, launcher in KERNELS.items()}
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        launched = {"ssd_scan": {"ssd_gram", "ssd_chunk_state", "ssd_state_pass",
                                 "ssd_chunk_out"}}.get(name, {name})
        if name == "matmul":
            (m, k), n = args[0].shape, args[1].shape[1]
            if mm_mod.simt_plan(m, n, k)[2] > 1:
                launched = {"matmul", "matmul_reduce"}
        assert got.is_cuda and all(
            launcher.launches == before[k] + (k in launched) for k, launcher in KERNELS.items()
        ), (name, [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)])
        if tol == 0.0:
            assert torch.equal(got, want), name
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
