"""ResNet-18 conv2_x's 3×3 convolution (He et al., arXiv:1512.03385,
Table 1) as the paper's DNN layer app defines it: ``ifmap`` [ci][y][x] with
its halo, ``weights`` [co][ci][ky][kx], no padding, no bias, out [co][y][x]
= sum over ci, ky, kx of weights * ifmap[ci][y+ky][x+kx].  Plain
``F.conv2d`` in float32 with TF32 off, one image at a time with the
weights its request carried."""

import torch
import torch.nn.functional as F

from ._precision import no_tf32, round_tf32


def reference(inputs, precision="float32"):
    """``float32``, or the control ``tf32``: both operands rounded to TF32,
    as a tensor core takes them, products summed in float32."""
    x, w = inputs["ifmap"].float(), inputs["weights"].float()
    if precision == "tf32":
        x, w = round_tf32(x), round_tf32(w)
    elif precision != "float32":
        raise ValueError(f"resnet reference: no precision {precision!r}")
    with no_tf32():
        out = torch.stack([F.conv2d(x[b:b + 1], w[b])[0] for b in range(x.shape[0])])
    return {"resnet": out}


def work(img: int, cin: int, cout: int, **_tiles):
    """The work of one image (see ``work.py``): a 3×3 convolution, ``cin``
    → ``cout`` channels on an ``img``² output (input ``img + 2``² with its
    halo), a multiply and an add a tap; the ifmap, the weights the request
    carries and the ofmap."""
    return {"flops_per_img": 2 * cout * img * img * cin * 9,
            "bytes_per_img": 4 * (cin * (img + 2) ** 2 + cout * cin * 9 + cout * img * img)}
