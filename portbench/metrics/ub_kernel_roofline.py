"""The generated kernels' share of their roofline: the floor of the
dispatches' images (``work.py``) over the device time of the kernels named
``ub_kernel_<n>`` in the profiled stretch; nothing where the trace saw none."""

import re

NAME = re.compile(r"\bub_kernel_\d+\b")


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["calls"]:
        return None
    busy = sum(s for name, s in prof["device_s"].items() if NAME.search(name))
    if not busy:
        return None
    return 100.0 * prof["calls"] * rec["batch_slots"] * rec["floor_s_per_img"] / busy
