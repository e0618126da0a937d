"""The CUDA source the port emits for each configuration the benchmark
measured before Swin's cell, and for each configuration ``chip_smoke.py``
holds at full size, byte for byte as recorded.

A change to the value language, the planner or the emitter for one app
must not move another's kernels: each configuration's library, planned at
its cell's size and batch as ``TorchPipeline`` plans it, hashes to the
digest recorded when its cell was last measured.  A change that means to
move a configuration's kernels (a ``perf_opt`` of that configuration)
records the new digest here, with the cell's measurement beside it.
"""

import hashlib
import json
from pathlib import Path

import pytest

from repro_torch.apps import make_app
from repro_torch.backend.cuda_codegen import emit_library
from repro_torch.backend.eager import LoweredGroup
from repro_torch.backend.plan import build_pipeline_plan
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

pytestmark = pytest.mark.torch

CONFIGS = Path(__file__).resolve().parents[1] / "portbench" / "configs"

# sha256 of each configuration's emitted library
DIGESTS = {
    "harris2048": "39c7b446b8ca2bef2a3f03faf0fea1a9637618c111073138c002696100c5f351",
    "resnet18-conv2x": "879ad1ed5dffa6e16a460b9c269938598e438191bd6a670db4c0b4b140007312",
    "mobilenet-v1-dws14x512": "4a04c89cb5e678dc3116c49d021fb18a82f491229caf2a922085dbe5d2360c8f",
    "convnext-t-stage3-14x384":
        "eecfb47dde42abbcfaaa21a2aba20df77f8ec42c9be3c6cfd819b414fc081dec",
}


# sha256 of the library of each of chip_smoke.py's full-size configurations
# (phase 4: app, kwargs) but the benchmark's, planned as phase 4 plans it,
# 8 batch slots
SMOKE_DIGESTS = {
    "gaussian": ("gaussian", {"size": 1082, "width": 1922},
                 "e42391c69016bd649f150123d8452724c65e7163153dc3dfca8c3573300be04d"),
    "harris": ("harris", {"schedule": "sch3", "size": 1024},
               "1ea6a19e72a22277e7dce3deb3761e0c87157b298e4e55a113d0d3edb85343f5"),
    "unsharp": ("unsharp", {"size": 1024},
                "e59d2facce6934094b9428c27e751cfc0698d83962d0a0e3c54e9de9cc3b5ddf"),
    "camera": ("camera", {"size": 512},
               "f7135830bf49c771d73fb2f989e8d34494138e5c26115056a3947673a5bcccd8"),
    "upsample": ("upsample", {"size": 1024},
                 "20923c1359df5e297aa831ee659569eb7c5c4d9829f558e1766dffbb1737d344"),
    "resnet": ("resnet", {"img": 56, "cin": 64, "cout": 64},
               "879ad1ed5dffa6e16a460b9c269938598e438191bd6a670db4c0b4b140007312"),
    "mobilenet": ("mobilenet", {"img": 112, "cin": 32, "cout": 64},
                  "3a96e635ad07e85c776fcc637d3840e068508b07832f53401f862809e36f9ba5"),
    "mobilenet14x512": ("mobilenet", {"img": 14, "cin": 512, "cout": 512},
                        "f442f1c1bd14b60d2377dcea76e5c04eacdcf9b4441d04e83e2e689a37e8683b"),
    "matmul": ("matmul", {"m": 256, "n": 256, "k": 1000},
               "70070915458df750c18d0a4474740c2d68726d6c55892b9bc784c46362df69ac"),
    "convnext": ("convnext", {"img": 14, "dim": 384, "hidden": 1536},
                 "2f17c1095cc2e245fe1a70488d3df2702c45af6856840949033aa8e33af7fea1"),
}


def _digest(app, kwargs, slots):
    plan = build_pipeline_plan(make_app(app, **kwargs).pipeline,
                               vmem_budget=H100_SMEM_PER_BLOCK, batch=slots,
                               batch_capacity=slots)
    src = emit_library([LoweredGroup(kg) for kg in plan.kernels])
    return hashlib.sha256(src.encode()).hexdigest()


@pytest.mark.parametrize("config", sorted(DIGESTS))
def test_emitted_library_is_byte_for_byte_as_recorded(config):
    cfg = json.loads((CONFIGS / f"{config}.json").read_text())
    assert _digest(cfg["app"], cfg["kwargs"], cfg["batch_slots"]) == DIGESTS[config]


@pytest.mark.parametrize("label", sorted(SMOKE_DIGESTS))
def test_smoke_library_is_byte_for_byte_as_recorded(label):
    app, kwargs, want = SMOKE_DIGESTS[label]
    assert _digest(app, kwargs, 8) == want
