"""The window-attention kernels' share of their roofline: the floor of the
dispatches' images for the attention alone (the larger of its FLOPs at the
f32 peak and its bytes at the HBM peak, from the Swin configuration's
``attention_work``, counted by ``work_attention`` in ``reference/swin.py``)
over the device time of the generated kernels whose parameter struct marks
a window-attention group (``ub_kernel_<n>(UbWindowParams<n>)``) in the
profiled stretch; nothing where the trace saw none."""

import re

from portbench import spec

NAME = re.compile(r"\bub_kernel_\d+\(UbWindowParams\d+\)")
CONFIG = "swin-t-stage3-14x384"


def floor_s_per_img():
    w = spec.load_json(spec.HERE / "configs" / f"{CONFIG}.json")["attention_work"]
    p = spec.peaks()
    return max(w["flops_per_img"] / p["f32_flops_per_s"], w["bytes_per_img"] / p["hbm_bytes_per_s"])


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["calls"]:
        return None
    busy = sum(s for name, s in prof["device_s"].items() if NAME.search(name))
    if not busy:
        return None
    return 100.0 * prof["calls"] * rec["batch_slots"] * floor_s_per_img() / busy
