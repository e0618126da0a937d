"""ConvNeXt's block (Liu et al., "A ConvNet for the 2020s",
arXiv:2201.03545, §3) as the port's ``convnext`` app defines it:
``ifmap`` [y][x][c] with its 3-pixel halo, ``dw_weights`` [ky][kx][c] and
``dw_bias`` [c], ``ln_weight`` and ``ln_bias`` [c], ``w1`` [hidden][c] and
``b1`` [hidden], ``w2`` [c][hidden] and ``b2`` [c], ``layer_scale`` [c];
out [y][x][c] = ifmap at the centre + layer_scale * (w2 . GELU(w1 . LN(
dwconv7x7(ifmap) + dw_bias) + b1) + b2), the 7x7 depthwise convolution
without padding, LayerNorm over the channels (eps 1e-6), the exact GELU.
Plain ``F.conv2d``, ``F.layer_norm``, ``F.linear`` and ``F.gelu`` in
float32 with TF32 off, one image at a time with the weights its slot
carried."""

import torch
import torch.nn.functional as F

from ._precision import no_tf32, round_tf32

NAMES = ("dw_weights", "dw_bias", "ln_weight", "ln_bias", "w1", "b1", "w2", "b2", "layer_scale")


def reference(inputs, precision="float32"):
    """``float32``, or the control ``tf32``: both operands of the depthwise
    convolution and of each linear layer rounded to TF32, as a tensor core
    takes them, products summed in float32; LayerNorm and GELU in float32."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"convnext reference: no precision {precision!r}")
    tf32 = round_tf32 if precision == "tf32" else (lambda t: t)
    x = inputs["ifmap"].float().permute(0, 3, 1, 2)          # [b][c][y][x]
    ws = {n: inputs[n].float() for n in NAMES}
    c = x.shape[1]
    outs = []
    with no_tf32():
        for b in range(x.shape[0]):
            w = {n: t[b if t.shape[0] > 1 else 0] for n, t in ws.items()}
            wd = w["dw_weights"].permute(2, 0, 1).reshape(c, 1, 7, 7)
            dw = F.conv2d(tf32(x[b:b + 1]), tf32(wd),
                          w["dw_bias"], groups=c)
            h = F.layer_norm(dw[0].permute(1, 2, 0), (c,), w["ln_weight"], w["ln_bias"],
                             eps=1e-6)
            h = F.gelu(F.linear(tf32(h), tf32(w["w1"]), w["b1"]), approximate="none")
            h = F.linear(tf32(h), tf32(w["w2"]), w["b2"])
            outs.append(x[b, :, 3:-3, 3:-3].permute(1, 2, 0) + w["layer_scale"] * h)
    return {"convnext": torch.stack(outs)}


def work(img: int, dim: int, hidden: int, **_tiles):
    """The work of one image (see ``work.py``), each of the app's funcs
    once on its points, an op of its definition (a unary, such as ``sqrt``
    or ``erf``, is one) once a point, an inlined func counted once, not at
    each use: per pixel and channel the depthwise 7x7 (a multiply and an
    add a tap, 98), its bias (1), LayerNorm's sum (1), centring (1),
    squared sum (2) and affine (3), the bias, scale and residual (3); per
    pixel the mean (1) and 1 / sqrt(var / dim + eps) (4); per pixel and
    hidden channel GELU as written, ``z * 0.5 * (1 + erf(z * c))`` with
    ``z = fc1 + b1`` at each of its two uses (7); per pixel, hidden and
    input channel the two linears' multiply and add (2 + 2).  Bytes: the
    ifmap with its halo, every weight and bias the slot carries, and the
    ofmap."""
    px = img * img
    flops = px * (109 * dim + 5 + 7 * hidden + 4 * hidden * dim)
    weights = dim * 49 + 5 * dim + 2 * hidden * dim + hidden
    return {"flops_per_img": flops,
            "bytes_per_img": 4 * (dim * (img + 6) ** 2 + weights + dim * px)}
