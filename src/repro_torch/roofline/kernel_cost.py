"""The work of a hand-written kernel call: the bytes it must move and the
operations it does on these inputs, from their shapes alone (meta tensors
do).  ``chip_smoke.py`` divides them by the H100's peaks for each kernel's
bound; the dry run (``dispatch_cost``) charges each kernel call on its
path with them."""

from __future__ import annotations

import torch

from .analysis import PEAK_F32_FLOPS, PEAK_FLOPS


def kernel_work(name: str, args, out, chunk=None, causal: bool = True,
                q_offset: int = 0) -> tuple:
    """Bytes a hand-written kernel must move (each input read once, the
    output written once), the operations it does on these inputs (only the
    scores a causal mask keeps: Sq·q_offset + Sq(Sq+1)/2 a head for query
    rows at ``q_offset``; only the lower triangle of each SSD chunk,
    whose C B^T the SSD read-out kernel reads only there; the additions of
    a split-K matmul's reduction) and the peak rate of the unit they could
    use: bf16 tensor cores for bf16 products, else IEEE f32 (the SSD
    kernels' products are f32 whatever x's dtype)."""
    name = name.removesuffix("_wgmma")         # the tensor-core kernels do the op's work
    nbytes = sum(t.numel() * t.element_size() for t in args) + out.numel() * out.element_size()
    peak = PEAK_FLOPS if out.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    if name == "matmul_reduce":                  # the f32 splits (S, M, N) added in order
        ops = (args[0].shape[0] - 1) * out.numel()
        peak = PEAK_F32_FLOPS
    elif name == "stencil3x3":
        ops = 18 * out.numel()                      # 9 products and 9 sums per output
        peak = PEAK_F32_FLOPS
    elif name == "matmul":
        (m, k), n = args[0].shape, args[1].shape[1]
        ops = 2 * m * n * k
    elif name == "flash_attention":               # q.k and p.v per kept score
        b, sq, d = args[0].shape
        kept = sq * q_offset + sq * (sq + 1) // 2 if causal else sq * args[1].shape[1]
        ops = 4 * d * b * kept
    elif name == "ssd_gram":                      # C B^T of each chunk, lower triangle
        s, n = args[0].shape
        ops = 2 * (s // chunk) * (chunk * (chunk + 1) // 2) * n
    elif name == "ssd_chunk_state":               # (x, dt, a, b): each chunk's contribution
        s, h, p = args[0].shape
        n = args[3].shape[1]
        nbytes += 4 * s * h                         # and s, written beside it
        ops = 2 * s * h * p * n
        peak = PEAK_F32_FLOPS
    elif name == "ssd_state_pass":                # (states, s): the states rewritten in place
        nc, h, n, p = args[0].shape
        # every chunk's entering state written; the contributions and s (its
        # last step) of every chunk but the last read: the last makes only
        # the state after the sequence, which nothing reads
        nbytes = 4 * (2 * nc - 1) * h * n * p + 4 * (nc - 1) * h
        ops = 2 * (nc - 1) * h * n * p
        peak = PEAK_F32_FLOPS
    else:                                         # ssd_chunk_out: (x, dt, c, g, s, states)
        s, h, p = args[0].shape
        n = args[2].shape[1]
        tri, n_chunks = chunk * (chunk + 1) // 2, s // chunk
        nbytes -= 4 * (args[3].numel() - n_chunks * tri)    # reads G's lower triangles only
        nbytes -= 4 * h * n * p                             # and no state entering chunk 0 (zero)
        # the intra-chunk sum, and the read-out of every chunk but the first
        ops = 2 * n_chunks * tri * h * p + 2 * (s - chunk) * h * p * n
        peak = PEAK_F32_FLOPS
    return nbytes, ops, peak


def ssd_scan_work(x, dt, a, b, c, chunk: int) -> list:
    """``kernel_work`` of each of the four kernels ``ssd_scan`` launches on
    these inputs, ``[(name, bytes, ops, peak), ...]``: ``ssd_gram`` on the
    f32 B and C, ``ssd_chunk_state``, ``ssd_state_pass``, ``ssd_chunk_out``
    on their f32 workspaces (the wrapper reads dt, a, B, C as f32)."""
    s_len, h, p = x.shape
    n, nc = b.shape[1], s_len // chunk

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    bf, cf, dtf, af = f32(s_len, n), f32(s_len, n), f32(s_len, h), f32(h)
    g, states, sl = f32(nc, chunk, chunk), f32(nc, h, n, p), f32(s_len, h)
    calls = [("ssd_gram", (bf, cf), g), ("ssd_chunk_state", (x, dtf, af, bf), states),
             ("ssd_state_pass", (states, sl), states),
             ("ssd_chunk_out", (x, dtf, cf, g, sl, states), torch.empty_like(x, device="meta"))]
    return [(name, *kernel_work(name, args, out, chunk)) for name, args, out in calls]


__all__ = ["kernel_work", "ssd_scan_work"]
