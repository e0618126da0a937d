"""ConvNeXt-T's stage-3 block: the plain reference against the port's plain
route, the TF32 control against the cell's limit, and the work count."""

import pytest
import torch

from portbench import reference, spec

from .conftest import ROOT

CELL = "convnext-t-stage3-14x384.resident"


def _port(kwargs, inputs):
    from repro_torch.apps import make_app
    from repro_torch.backend import compile_pipeline

    app = make_app("convnext", **kwargs)
    b = inputs["ifmap"].shape[0]
    pp = compile_pipeline(app.pipeline, device="cpu", kernels="eager", batch=b, batch_capacity=b)
    return pp.run(inputs)


def _inputs(img, dim, hidden, seed):
    """Two slots drawn as the configuration draws them (its stds and
    ranges), the weights shared by both."""
    cfg = spec.load_json(ROOT / "portbench" / "configs" / "convnext-t-stage3-14x384.json")
    g = torch.Generator().manual_seed(seed)
    shapes = {"ifmap": (img + 6, img + 6, dim), "dw_weights": (7, 7, dim), "dw_bias": (dim,),
              "ln_weight": (dim,), "ln_bias": (dim,), "w1": (hidden, dim), "b1": (hidden,),
              "w2": (dim, hidden), "b2": (dim,), "layer_scale": (dim,)}
    out = {}
    for name, shape in shapes.items():
        d = cfg["inputs"][name]
        std = d.get("std", 1.0)
        if name == "dw_weights":
            std = (2 / 49) ** 0.5
        elif name in ("w1", "w2"):
            std = (2 / shape[1]) ** 0.5
        n = 1 if d.get("shared") else 2
        if d["draw"] == "uniform":
            t = d["low"] + (d["high"] - d["low"]) * torch.rand((n, *shape), generator=g)
        else:
            t = std * torch.randn((n, *shape), generator=g)
        out[name] = t.expand(2, *shape).contiguous()
    return out


@pytest.mark.parametrize("img,dim,hidden", [(4, 8, 32), (2, 64, 256)])
def test_convnext_reference_agrees_with_the_port(img, dim, hidden):
    ins = _inputs(img, dim, hidden, img * dim)
    got = _port({"img": img, "dim": dim, "hidden": hidden}, ins)["convnext"]
    want = reference.get("convnext")(ins)["convnext"]
    assert got.shape == want.shape == (2, img, img, dim)
    # the same f32 operations, LayerNorm's moments and the linears' sums in
    # other orders: a few units in the last place of the widest output
    gap = float((got - want).abs().max() / want.abs().max())
    limit = spec.cell(CELL)["check"]["max_rel_gap"]
    assert gap < limit / 3
    ctl = reference.get("convnext")(ins, "tf32")["convnext"]
    assert float((ctl - want).abs().max() / want.abs().max()) > limit


def test_convnext_work_count():
    # 14x14x384, hidden 1536: the two linears 462.4 MFLOP of 472.7; 5.72 MB
    # an image, the weights counted per slot
    w = reference.module("convnext").work(14, 384, 1536)
    assert w == {"flops_per_img": 472734164, "bytes_per_img": 5723136}
    assert 4 * 14 * 14 * 384 * 1536 == 462422016
    assert w == spec.cell(CELL)["config"]["work"]
