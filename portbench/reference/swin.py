"""Swin Transformer's block pair (Liu et al., "Swin Transformer:
Hierarchical Vision Transformer using Shifted Windows", arXiv:2103.14030,
§3.1–3.3) as the port's ``swin`` app defines it: a block over regular
windows (W-MSA), then one over windows shifted by half a window (SW-MSA),
each ``x + proj(WindowAttention(LN1(x)))`` then ``x + fc2(GELU(fc1(LN2(
x))))``.  The inputs are the app's: ``ifmap`` [wy][py][wx][px][c], the
[y][x][c] map with rows and columns split into (window, position); per
block ``b1_`` / ``b2_``: ``ln1_weight``, ``ln1_bias``, ``qkv_w`` [3
heads][d][c] (the (3 c, c) weight of ``nn.Linear``), ``qkv_b`` [3
heads][d], ``rel_bias`` [2M-1][2M-1][heads] (Swin's (2M-1)^2 x heads
table), ``proj_w`` [heads][d][c] (input-major: the transpose of
``nn.Linear``'s (c, c) weight), ``proj_b``, ``ln2_*``, ``fc1_w``
[hidden][c], ``fc1_b``, ``fc2_w`` [c][hidden], ``fc2_b``.  It follows
Swin's official modules step by step: ``F.layer_norm`` (eps 1e-5),
``torch.roll`` by (-M // 2, -M // 2), window partition, ``F.linear``,
``q * scale @ k^T``, the bias gathered by the relative position index,
the region mask at -100, ``F.softmax``, ``@ v``, the projection, window
reverse, the roll back, the exact ``F.gelu``; in float32 with TF32 off,
one image at a time with the weights its slot carried."""

import torch
import torch.nn.functional as F

from ._precision import no_tf32, round_tf32

BLOCK = ("ln1_weight", "ln1_bias", "qkv_w", "qkv_b", "rel_bias", "proj_w", "proj_b",
         "ln2_weight", "ln2_bias", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def relative_position_index(m: int) -> torch.Tensor:
    """Swin's (M^2, M^2) index into its bias table: ``(qy - ky + M - 1)
    (2M - 1) + qx - kx + M - 1``."""
    coords = torch.stack(torch.meshgrid(torch.arange(m), torch.arange(m), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += m - 1
    rel[:, :, 1] += m - 1
    rel[:, :, 0] *= 2 * m - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, m: int) -> torch.Tensor:
    """(H, W, C) -> (windows, M^2, C), windows in row-major order."""
    h, w, c = x.shape
    x = x.view(h // m, m, w // m, m, c).permute(0, 2, 1, 3, 4)
    return x.reshape(-1, m * m, c)


def window_reverse(windows: torch.Tensor, m: int, h: int, w: int) -> torch.Tensor:
    c = windows.shape[-1]
    x = windows.view(h // m, w // m, m, m, c).permute(0, 2, 1, 3, 4)
    return x.reshape(h, w, c)


def attention_mask(h: int, w: int, m: int, s: int) -> torch.Tensor:
    """Swin's mask of the shifted windows: (windows, M^2, M^2), -100 where
    the query and the key lie in different regions of the rolled map."""
    img = torch.zeros(h, w)
    cnt = 0
    for hs in (slice(0, -m), slice(-m, -s), slice(-s, None)):
        for ws in (slice(0, -m), slice(-m, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = window_partition(img[:, :, None], m)[:, :, 0]
    mask = mw[:, None, :] - mw[:, :, None]
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def block(x: torch.Tensor, w: dict, m: int, shift: int, tf32) -> torch.Tensor:
    """One Swin block on the (H, W, C) map ``x``."""
    h, wd, c = x.shape
    heads = w["rel_bias"].shape[-1]
    hd = c // heads
    n = m * m
    t = F.layer_norm(x, (c,), w["ln1_weight"], w["ln1_bias"], eps=1e-5)
    if shift:
        t = torch.roll(t, shifts=(-shift, -shift), dims=(0, 1))
    win = window_partition(t, m)
    qkv = F.linear(tf32(win), tf32(w["qkv_w"].reshape(3 * c, c)), w["qkv_b"].reshape(3 * c))
    qkv = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * hd ** -0.5
    attn = tf32(q) @ tf32(k).transpose(-2, -1)
    table = w["rel_bias"].reshape(-1, heads)
    bias = table[relative_position_index(m).to(table.device).view(-1)].view(n, n, heads)
    attn = attn + bias.permute(2, 0, 1)[None]
    if shift:
        attn = attn + attention_mask(h, wd, m, shift).to(attn.device)[:, None]
    attn = F.softmax(attn, dim=-1)
    out = (tf32(attn) @ tf32(v)).transpose(1, 2).reshape(-1, n, c)
    out = F.linear(tf32(out), tf32(w["proj_w"].reshape(c, c).t()), w["proj_b"])
    out = window_reverse(out, m, h, wd)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(0, 1))
    x = x + out
    t = F.layer_norm(x, (c,), w["ln2_weight"], w["ln2_bias"], eps=1e-5)
    t = F.gelu(F.linear(tf32(t), tf32(w["fc1_w"]), w["fc1_b"]), approximate="none")
    return x + F.linear(tf32(t), tf32(w["fc2_w"]), w["fc2_b"])


def reference(inputs, precision="float32"):
    """``float32``, or the control ``tf32``: both operands of every linear
    layer and of both attention products rounded to TF32, as a tensor core
    takes them, products summed in float32; LayerNorm, softmax and GELU in
    float32."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"swin reference: no precision {precision!r}")
    tf32 = round_tf32 if precision == "tf32" else (lambda t: t)
    x = inputs["ifmap"].float()                       # [b][wy][py][wx][px][c]
    nb, n, m, _, _, c = x.shape
    ws = {f"b{k}_{name}": inputs[f"b{k}_{name}"].float() for k in (1, 2) for name in BLOCK}
    outs = []
    with no_tf32():
        for b in range(nb):
            w = {k: t[b if t.shape[0] > 1 else 0] for k, t in ws.items()}
            y = x[b].reshape(n * m, n * m, c)
            for k, shift in ((1, 0), (2, m // 2)):
                y = block(y, {name: w[f"b{k}_{name}"] for name in BLOCK}, m, shift, tf32)
            outs.append(y.reshape(n, m, n, m, c))
    return {"swin": torch.stack(outs)}


def _attention_flops(img: int, dim: int, heads: int, window: int, shifted: bool) -> int:
    """The window attention of one block on one image, as Swin's module
    computes it (see ``work``): per pixel and channel the query's scale
    (1); per head, query and key of a window the score ``q . k`` (2 a head
    dimension), the bias added (1), Swin's mask added in the shifted block
    (1), softmax's maximum, difference, ``exp``, sum and division (5), and
    the output's ``p . v`` (2 a head dimension)."""
    px, n, d = img * img, window * window, dim // heads
    pairs = heads * px * n
    return px * dim + pairs * (4 * d + 6 + (1 if shifted else 0))


def work(img: int, dim: int, heads: int, window: int, hidden: int, shift: int = 1,
         **_tiles):
    """The work of one image (see ``work.py``), counted from the function
    Swin's modules compute, whatever the app recomputes: an op once a
    point (a unary, such as ``sqrt``, ``erf`` or ``exp``, is one).  The app
    evaluates a softmax weight again for each head dimension of its output,
    Swin's mask from the positions at each pair and the rolls as
    reductions of one-hot terms; a floor counts none of that, and a roll
    moves data with no arithmetic.  Per block: per pixel and channel
    LayerNorm's sum (1), centring (1), squared sum (2) and affine (3),
    twice, the projection's bias and the residual (2), the MLP's second
    bias and residual (2); per pixel the mean (1) and 1 / sqrt(var / dim +
    eps) (4), twice; per pixel, output and input channel the qkv,
    projection and MLP linears' multiply and add (2 each); per pixel and
    qkv channel the bias (1); per pixel and hidden channel GELU as
    convnext's ``work`` counts it (7, the first bias included); the window
    attention as ``_attention_flops`` counts it.  Bytes: the ifmap, every
    weight and bias of both blocks the slot carries, and the ofmap."""
    px = img * img
    per_block = (px * (2 * (7 * dim + 5) + 4 * dim + 2 * dim * 3 * dim + 3 * dim
                       + 2 * dim * dim + 4 * hidden * dim + 7 * hidden))
    flops = (2 * per_block + _attention_flops(img, dim, heads, window, False)
             + _attention_flops(img, dim, heads, window, True))
    m = 2 * window - 1
    weights = (4 * dim + 3 * dim * dim + 3 * dim + m * m * heads + dim * dim + dim
               + 2 * hidden * dim + hidden + dim)
    return {"flops_per_img": flops, "bytes_per_img": 4 * (2 * dim * px + 2 * weights)}


def work_attention(img: int, dim: int, heads: int, window: int, **_rest):
    """The work of the window attention alone, one image, both blocks: its
    FLOPs as ``_attention_flops`` counts them (from the scaled query to the
    weighted sum of the values), and the bytes it must move: the queries,
    keys and values read once, its output written once and the relative
    position bias table read once."""
    px = img * img
    m = 2 * window - 1
    flops = (_attention_flops(img, dim, heads, window, False)
             + _attention_flops(img, dim, heads, window, True))
    return {"flops_per_img": flops,
            "bytes_per_img": 2 * 4 * (3 * dim * px + dim * px + m * m * heads)}
