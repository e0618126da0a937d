"""The frozen references against the port's plain route at tiny sizes, the
work counts frozen in the configuration files, and what the references may
import."""

import ast

import pytest
import torch

from portbench import reference, spec, work
from portbench.reference._precision import round_tf32

from .conftest import tiny_cell


def _port(app_name, kwargs, inputs):
    from repro_torch.apps import make_app
    from repro_torch.backend import compile_pipeline

    app = make_app(app_name, **kwargs)
    b = next(iter(inputs.values())).shape[0]
    pp = compile_pipeline(app.pipeline, device="cpu", kernels="eager", batch=b, batch_capacity=b)
    return pp.run(inputs)


@pytest.mark.parametrize("size", [16, 25, 36])
def test_harris_reference_is_the_port_bit_for_bit(size):
    g = torch.Generator().manual_seed(size)
    x = torch.rand((3, size, size), generator=g) * 256
    got = _port("harris", {"schedule": "sch3", "size": size}, {"input": x})["harris"]
    want = reference.get("harris")({"input": x})["harris"]
    assert torch.equal(got, want)
    assert (want > 0).any() and (want == 0).any()      # the threshold cuts both ways


@pytest.mark.parametrize("img,cin,cout", [(8, 4, 4), (6, 64, 64)])
def test_resnet_reference_agrees_with_the_port(img, cin, cout):
    g = torch.Generator().manual_seed(img)
    x = torch.rand((2, cin, img + 2, img + 2), generator=g)
    w = torch.randn((cout, cin, 3, 3), generator=g) * (2 / (9 * cin)) ** 0.5
    ins = {"ifmap": x, "weights": w.expand(2, -1, -1, -1, -1).contiguous()}
    got = _port("resnet", {"img": img, "cin": cin, "cout": cout}, ins)["resnet"]
    want = reference.get("resnet")(ins)["resnet"]
    assert got.shape == want.shape == (2, cout, img, img)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12, -1 - 2 ** -11, 3.0e-3])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1 + 2 ** -10
    assert r[2] == 1 + 2 ** -10 and r[3] == 1.0 and r[4] == -1 - 2 ** -10
    assert abs(float(r[5]) / 3.0e-3 - 1) < 2 ** -11


@pytest.mark.parametrize("name", [c["name"] for c in spec.benchmark()["configs"]])
def test_work_counts_frozen_in_the_configs(name):
    cfg = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    assert cfg["work"] == work.count(cfg)


def test_work_counts_from_the_definitions():
    # harris 2048: 2046^2 gradient points of 28 operations, 2044^2 outputs of 32
    assert reference.module("harris").work(2048) == {
        "flops_per_img": 2046 ** 2 * 28 + 2044 ** 2 * 32,
        "bytes_per_img": 4 * (2048 ** 2 + 2044 ** 2)}
    # ResNet-18 conv2_x: 231.2 MFLOP, 1.81 MB an image
    assert reference.module("resnet").work(56, 64, 64) == {
        "flops_per_img": 231211008, "bytes_per_img": 1811456}
    peaks = spec.peaks()
    h = spec.load_json(spec.HERE / "configs" / "harris2048.json")
    r = spec.load_json(spec.HERE / "configs" / "resnet18-conv2x.json")
    assert work.floor_s_per_img(h, peaks) == pytest.approx(33488960 / 3.35e12)      # bytes
    assert work.floor_s_per_img(r, peaks) == pytest.approx(231211008 / 67e12)       # FLOPs


def test_config_inputs_match_the_apps():
    from repro_torch.apps import make_app

    for c in spec.benchmark()["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        app = make_app(cfg["app"], **cfg["kwargs"])
        assert {n: list(s) for n, s in app.input_extents.items()} == \
            {n: i["shape"] for n, i in cfg["inputs"].items()}


def test_tiny_cells_keep_the_inputs_consistent():
    for name in ("harris2048.open", "resnet18-conv2x.closed"):
        cell = tiny_cell(name)
        from portbench.harness import Run

        Run(cell, 1, 1.0, 0.0, device="cpu").app()     # raises on a shape mismatch


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port_or_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in {"repro_torch", "repro", "jax", "jaxlib", "flax", "portbench"}, name
