"""How ``correct`` is decided: the port's outputs for a sample of the
window's work, drawn from the seed, against the plain reference."""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import torch

Item = Tuple[Hashable, Dict[str, object]]     # (what the inputs were, outputs by kernel)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, in an order drawn
    from ``seed`` (Vitter's algorithm R): the count need not be known
    before the window closes, and an item costs one draw."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: List[Item] = []
        self.seen = 0

    def offer(self, item: Item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def max_rel_gap(items: Sequence[Item], inputs_of: Callable[[Hashable], Dict[str, object]],
                reference: Callable, device, control: str = None) -> Tuple[float, int]:
    """The widest gap between an output and the reference's, over every
    image of every item: max |got - want| over the image, as a share of
    max |want| over the image (so a share of the output's range, which a
    threshold's flip near 100 or a cancellation in a small value cannot
    blow up).  ``control`` puts the reference computed in that precision in
    the outputs' place.  A missing, misshapen or non-finite output reads
    ``inf``.  Returns the gap and the number of images compared."""
    worst, images = 0.0, 0
    for key, outputs in items:
        ins = {n: torch.as_tensor(a).to(device, torch.float32) for n, a in inputs_of(key).items()}
        want = reference(ins, "float32")
        got = reference(ins, control) if control else outputs
        for name, w in want.items():
            if name not in got:
                return math.inf, images
            g = torch.as_tensor(got[name]).to(device, torch.float32)
            if g.shape != w.shape:
                return math.inf, images
            gap = (g - w).abs().flatten(1).amax(1) / w.abs().flatten(1).amax(1).clamp_min(
                torch.finfo(torch.float32).tiny)
            if not torch.isfinite(gap).all():
                return math.inf, images
            worst = max(worst, float(gap.max()))
        images += len(gap)
    return worst, images


def checks(gap: float, limit: float, missing: int, compared: int) -> Tuple[bool, dict]:
    """Each number compared beside its limit, and whether all hold: the
    widest gap, the requests due in the window that never came back right
    (failed or never returned), and the images compared."""
    out = {"max_rel_gap": {"value": gap if math.isfinite(gap) else None, "max": limit},
           "missing": {"value": missing, "max": 0},
           "compared": {"value": compared, "min": 1}}
    return gap <= limit and missing == 0 and compared >= 1, out
