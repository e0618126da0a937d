"""MobileNet v1's depthwise-separable block: the plain reference against the
port's plain route, and its work count."""

import pytest
import torch

from portbench import reference


def _port(kwargs, inputs):
    from repro_torch.apps import make_app
    from repro_torch.backend import compile_pipeline

    app = make_app("mobilenet", **kwargs)
    b = inputs["ifmap"].shape[0]
    pp = compile_pipeline(app.pipeline, device="cpu", kernels="eager", batch=b, batch_capacity=b)
    return pp.run(inputs)


@pytest.mark.parametrize("img,cin,cout", [(4, 8, 8), (4, 64, 64)])
def test_mobilenet_reference_agrees_with_the_port(img, cin, cout):
    g = torch.Generator().manual_seed(img * cin)
    x = torch.rand((2, img + 2, img + 2, cin), generator=g)
    wd = torch.randn((cin, 3, 3), generator=g) * (2 / 9) ** 0.5
    wp = torch.randn((cout, cin), generator=g) * (2 / cin) ** 0.5
    ins = {"ifmap": x, "dw_weights": wd.expand(2, -1, -1, -1).contiguous(),
           "pw_weights": wp.expand(2, -1, -1).contiguous()}
    got = _port({"img": img, "cin": cin, "cout": cout}, ins)["mobilenet"]
    want = reference.get("mobilenet")(ins)["mobilenet"]
    assert got.shape == want.shape == (2, img, img, cout)
    # the same f32 products, summed in another order: a few units in the
    # last place of the widest output
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    ctl = reference.get("mobilenet")(ins, "tf32")["mobilenet"]
    assert float((ctl - want).abs().max() / want.abs().max()) > 1e-4


def test_mobilenet_work_count():
    # 14x14x512: depthwise 1.81 MFLOP, pointwise 102.8 MFLOP; 1.99 MB an image
    assert reference.module("mobilenet").work(14, 512, 512) == {
        "flops_per_img": 2 * 14 * 14 * 512 * 9 + 2 * 14 * 14 * 512 * 512,
        "bytes_per_img": 4 * (16 * 16 * 512 + 512 * 9 + 512 * 512 + 14 * 14 * 512)}
