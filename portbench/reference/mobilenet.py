"""MobileNet v1's depthwise-separable block (Howard et al., arXiv:1704.04861,
Table 1) as the paper's DNN layer app defines it: ``ifmap`` [y][x][c] with
its 1-pixel halo, ``dw_weights`` [c][ky][kx], ``pw_weights`` [co][c]; a 3x3
depthwise convolution per channel, no padding, then a 1x1 convolution over
the channels, no bias; out [y][x][co].  Plain ``F.conv2d`` in float32 with
TF32 off, one image at a time with the weights its slot carried."""

import torch
import torch.nn.functional as F

from ._precision import no_tf32, round_tf32


def reference(inputs, precision="float32"):
    """``float32``, or the control ``tf32``: both operands of each
    convolution rounded to TF32, as a tensor core takes them, products
    summed in float32."""
    x = inputs["ifmap"].float().permute(0, 3, 1, 2)          # [b][c][y][x]
    wd, wp = inputs["dw_weights"].float(), inputs["pw_weights"].float()
    if precision not in ("float32", "tf32"):
        raise ValueError(f"mobilenet reference: no precision {precision!r}")
    tf32 = round_tf32 if precision == "tf32" else (lambda t: t)
    outs = []
    with no_tf32():
        for b in range(x.shape[0]):
            c = wd.shape[1]
            dw = F.conv2d(tf32(x[b:b + 1]), tf32(wd[b].reshape(c, 1, 3, 3)), groups=c)
            pw = F.conv2d(tf32(dw), tf32(wp[b].reshape(wp.shape[1], c, 1, 1)))
            outs.append(pw[0].permute(1, 2, 0))
    return {"mobilenet": torch.stack(outs)}


def work(img: int, cin: int, cout: int, **_tiles):
    """The work of one image (see ``work.py``): the depthwise 3x3, a
    multiply and an add a tap on ``cin`` channels of an ``img``² output
    (input ``img + 2``² with its halo), then the pointwise ``cin`` →
    ``cout``, a multiply and an add a channel; the ifmap, both weights the
    slot carries and the ofmap."""
    dw = 2 * img * img * cin * 9
    pw = 2 * img * img * cin * cout
    return {"flops_per_img": dw + pw,
            "bytes_per_img": 4 * (cin * (img + 2) ** 2 + cin * 9 + cout * cin + cout * img * img)}
