"""The work of one image, counted from each app's definition and shapes.

Bytes are f32 bytes that must move: every input read once and the output
written once, whatever a kernel reads again.  FLOPs are the arithmetic the
app's definition writes (``apps/paper_apps.py``; a comparison counts, a
select does not), each stage evaluated once on the points its consumers
need.  Neither count reads the port's plan, so a change to fusion or to the
kernels leaves them as they are.  Each app's count is ``work(**kwargs)`` in
its ``reference/<app>.py``, beside the math it counts;
``configs/<config>.json`` freezes it under ``work``, and a test derives it
again.
"""

from __future__ import annotations

from typing import Dict

from portbench import reference


def count(config: dict) -> Dict[str, int]:
    return reference.module(config["app"]).work(**config["kwargs"])


def floor_s_per_img(config: dict, peaks: dict) -> float:
    """The least time the card could take for one image: the larger of the
    FLOPs at the f32 peak outside the tensor cores and the bytes at the
    HBM peak, from the counts frozen in the configuration's file."""
    w = config["work"]
    return max(w["flops_per_img"] / peaks["f32_flops_per_s"],
               w["bytes_per_img"] / peaks["hbm_bytes_per_s"])
