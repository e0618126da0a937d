"""Harris corner detector (sch3, the paper's Table III/V app) written
directly as whole-image expressions in the app's order of operations: the
balanced adder trees of ``paper_apps.balanced_sum``, the divisions by 64
and 16, the threshold at 100.  A frozen copy of the repository's
independent on-card check, generalized to a leading image axis."""

import torch


def _bsum(terms):
    terms = list(terms)
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _sh(t, dx, dy, h, w):
    return t[..., dy:dy + h, dx:dx + w]


def harris(a: torch.Tensor) -> torch.Tensor:
    """``a``: (..., size, size) in ``[y, x]``; returns (..., size-4, size-4)."""
    n = a.shape[-1] - 4
    g = n + 2
    gx = _bsum([_sh(a, 0, 0, g, g) * -1, _sh(a, 2, 0, g, g) * 1,
                _sh(a, 0, 1, g, g) * -2, _sh(a, 2, 1, g, g) * 2,
                _sh(a, 0, 2, g, g) * -1, _sh(a, 2, 2, g, g) * 1])
    gy = _bsum([_sh(a, 0, 0, g, g) * -1, _sh(a, 1, 0, g, g) * -2,
                _sh(a, 2, 0, g, g) * -1, _sh(a, 0, 2, g, g) * 1,
                _sh(a, 1, 2, g, g) * 2, _sh(a, 2, 2, g, g) * 1])

    def box3(t):
        return _bsum([_sh(t, dx, dy, n, n) for dy in range(3) for dx in range(3)])

    sxx, syy, sxy = box3(gx * gx / 64), box3(gy * gy / 64), box3(gx * gy / 64)
    trace = sxx + syy
    resp = (sxx * syy - sxy * sxy) - (trace * trace) / 16
    return torch.where(resp > 100, resp, torch.zeros_like(resp))


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def reference(inputs, precision="float32"):
    """Every operation in ``precision`` (``float32`` or the control's
    ``bfloat16``); the output as float32."""
    return {"harris": harris(inputs["input"].to(DTYPES[precision])).float()}


def work(size: int, **_schedule):
    """The work of one ``size``² input tile, output ``size - 4``² (see
    ``work.py``).  Sobel gx and gy (6 products and 5 adds each) and the
    three products over 64 (a product and a division each) on the
    gradients' ``size - 2``² points; three 3×3 box sums (8 adds each), the
    response (det: 2 products, a subtraction; trace: an add; trace²/16: a
    product and a division; a subtraction) and the threshold's comparison
    on the output's points."""
    n = size - 4
    g = n + 2
    return {"flops_per_img": g * g * (11 + 11 + 3 * 2) + n * n * (3 * 8 + 7 + 1),
            "bytes_per_img": 4 * (size * size + n * n)}
