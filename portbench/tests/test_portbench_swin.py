"""Swin-T's stage-3 block pair: the configuration, the plain reference
against the port's plain route, the TF32 control against the cell's limit,
and the work counts (the whole pair's and the window attention's)."""

import math

import pytest
import torch

from portbench import reference, spec

from .conftest import ROOT

CELL = "swin-t-stage3-14x384.resident"
CONFIG = ROOT / "portbench" / "configs" / "swin-t-stage3-14x384.json"


def _port(kwargs, inputs):
    from repro_torch.apps import make_app
    from repro_torch.backend import compile_pipeline

    app = make_app("swin", **kwargs)
    b = inputs["ifmap"].shape[0]
    pp = compile_pipeline(app.pipeline, device="cpu", kernels="eager", batch=b, batch_capacity=b)
    return pp.run(inputs)


def _inputs(kwargs, seed):
    """Two slots drawn as the configuration draws them (its stds and
    ranges, each linear's He-normal std at these widths), the weights
    shared by both."""
    from repro_torch.apps import make_app

    cfg = spec.load_json(CONFIG)
    app = make_app("swin", **kwargs)
    g = torch.Generator().manual_seed(seed)
    dim, hidden = kwargs["dim"], kwargs["hidden"]
    out = {}
    for name, shape in app.input_extents.items():
        d = cfg["inputs"][name]
        std = d.get("std", 1.0)
        if name.endswith(("qkv_w", "proj_w", "fc1_w")):
            std = (2 / dim) ** 0.5
        elif name.endswith("fc2_w"):
            std = (2 / hidden) ** 0.5
        n = 1 if d.get("shared") else 2
        if d["draw"] == "uniform":
            t = d["low"] + (d["high"] - d["low"]) * torch.rand((n, *shape), generator=g)
        else:
            t = std * torch.randn((n, *shape), generator=g)
        out[name] = t.expand(2, *shape).contiguous()
    return out


def test_swin_configuration_names_the_app_and_its_inputs():
    from repro_torch.apps import make_app

    cfg = spec.load_json(CONFIG)
    app = make_app(cfg["app"], **cfg["kwargs"])
    assert {n: tuple(s["shape"]) for n, s in cfg["inputs"].items()} == app.input_extents
    assert all(s.get("shared") for n, s in cfg["inputs"].items() if n != "ifmap")
    assert cfg["reduced"] == [] and cfg["kwargs"]["shift"] == cfg["kwargs"]["window"] // 2
    params = sum(math.prod(s["shape"]) for n, s in cfg["inputs"].items() if n.startswith("b1_"))
    assert params == 1776492


@pytest.mark.parametrize("kw", [{"img": 4, "dim": 16, "heads": 2, "window": 2, "hidden": 64,
                                 "shift": 1},
                                {"img": 6, "dim": 24, "heads": 3, "window": 3, "hidden": 96,
                                 "shift": 1}], ids=["tiny", "three-windows"])
def test_swin_reference_agrees_with_the_port(kw):
    ins = _inputs(kw, sum(kw.values()))
    got = _port(kw, ins)["swin"]
    want = reference.get("swin")(ins)["swin"]
    n = kw["img"] // kw["window"]
    assert got.shape == want.shape == (2, n, kw["window"], n, kw["window"], kw["dim"])
    # the same f32 operations, LayerNorm's moments, the linears', the
    # products' and softmax's sums in other orders: a few units in the last
    # place of the widest output
    gap = float((got - want).abs().max() / want.abs().max())
    limit = spec.cell(CELL)["check"]["max_rel_gap"]
    assert gap < limit / 3
    ctl = reference.get("swin")(ins, "tf32")["swin"]
    assert float((ctl - want).abs().max() / want.abs().max()) > limit


def test_swin_work_counts():
    # 14x14x384, 12 heads, windows of 7, hidden 1536: 1.426 GFLOP and
    # 14.8 MB an image (the weights of both blocks counted per slot), the
    # window attention 31.2 MFLOP and 2.4 MB of it
    cfg = spec.load_json(CONFIG)
    mod = reference.module("swin")
    w, a = mod.work(**cfg["kwargs"]), mod.work_attention(**cfg["kwargs"])
    assert w == {"flops_per_img": 1425798080, "bytes_per_img": 14814048}
    assert a == {"flops_per_img": 31152240, "bytes_per_img": 2424672}
    assert (cfg["work"], cfg["attention_work"]) == (w, a)
    # derived again from Swin's modules at the published shapes: 196
    # tokens, 4 windows of 49, 12 heads of 32; a linear 2 FLOPs a weight
    # and 1 a bias, an elementwise op 1, no FLOPs for a roll
    tokens, c, heads, hd, n, hidden = 196, 384, 12, 32, 49, 1536
    pairs = heads * tokens * n                  # (head, query, key) in a window
    layer_norm = tokens * (7 * c + 5)           # moments, centring, affine
    qkv = tokens * 3 * c * (2 * c + 1)
    attention = {
        "scale": tokens * c,                    # q * hd ** -0.5
        "q @ k^T": pairs * 2 * hd,
        "+ bias": pairs,
        "softmax": pairs * 5,                   # max, subtract, exp, sum, divide
        "@ v": pairs * 2 * hd,
    }
    mask = pairs                                # + mask, shifted block only
    proj = tokens * c * (2 * c + 1) + tokens * c              # and the residual
    mlp = (tokens * hidden * 2 * c + tokens * hidden * 7      # fc1, GELU with its bias
           + tokens * c * (2 * hidden + 1) + tokens * c)      # fc2, the residual
    assert qkv - tokens * 3 * c == 173408256                # each part a block
    assert attention["q @ k^T"] + attention["@ v"] == 14751744
    assert proj - 2 * tokens * c == 57802752
    assert 2 * tokens * c * hidden * 2 == 462422016
    block = 2 * layer_norm + qkv + sum(attention.values()) + proj + mlp
    assert 2 * block + mask == w["flops_per_img"]
    assert 2 * sum(attention.values()) + mask == a["flops_per_img"]
    # the attention's bytes: q, k, v in and its output out, the bias table
    assert a["bytes_per_img"] == 2 * 4 * (4 * tokens * c + 13 * 13 * heads)
