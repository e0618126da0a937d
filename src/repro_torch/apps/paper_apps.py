"""The paper's seven evaluation applications (Table III) in the mini-Halide DSL.

Each builder returns an ``AppBundle``: the scheduled func graph, the lowered
pipeline, and metadata used by the benchmark harness.  Schedule variants for
Harris reproduce Table V (sch1..sch6).

Sizes follow the paper's "modest problem sizes" methodology (§VI-B): 64x64
accelerator tiles for the stencil pipelines, small channel counts for the DNN
layers.

Conventions:
  * ``f[x, y]`` — x is the fastest (innermost) dimension, as in Halide.
  * Input arrays / extents are given in **loop order** (outermost first),
    i.e. a 2-D image is indexed ``[y, x]`` (row-major).
  * Rate-changing stages (upsample, demosaic) are written with explicit
    phase vars so every access map stays affine (see DESIGN.md §5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from repro_torch.frontend.expr import Const, IterVal, Select, erf, exp, maximum, minimum, sqrt
from repro_torch.frontend.func import Func, RDom, Var
from repro_torch.frontend.lower import Pipeline, lower_pipeline

x, y = Var("x"), Var("y")


def balanced_sum(terms):
    """Balanced adder tree — matches the paper's HLS latency model (a chain
    of adds would give gaussian a depth-10 body; the paper's sequential
    completion times imply log-depth trees)."""
    terms = list(terms)
    while len(terms) > 1:
        nxt = []
        for i in range(0, len(terms) - 1, 2):
            nxt.append(terms[i] + terms[i + 1])
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]
xi, yi = Var("xi"), Var("yi")   # phase vars (upsample / demosaic)
co = Var("co")                  # output-channel var
ch = Var("ch")                  # per-channel var
hc = Var("hc")                  # hidden-channel var (an MLP's wide axis)


@dataclass
class AppBundle:
    name: str
    kind: str                    # "stencil" | "dnn"
    pipeline: Pipeline
    funcs: List[Func]
    output: Func
    output_extents: Dict[str, int]
    input_extents: Dict[str, Tuple[int, ...]]   # loop order (outermost first)
    tile_count: int = 1          # coarse-pipeline trip count (DNN apps)
    description: str = ""


# ---------------------------------------------------------------------------
# gaussian — 3x3 convolutional blur
# ---------------------------------------------------------------------------


def build_gaussian(size: int = 64, width: int = None) -> AppBundle:
    """``size`` is the *input tile* edge (the paper's convention); the output
    shrinks by the stencil halo.  ``width`` makes the tile rectangular
    (``size`` rows x ``width`` columns) — the wide-extent shape the
    lane-blocked 2-D grids exist for."""
    if width is None:
        width = size
    out_h, out_w = size - 2, width - 2
    inp = Func.input("input", 2)
    blur = Func("gaussian")
    w = [1, 2, 1, 2, 4, 2, 1, 2, 1]
    terms = []
    k = 0
    for dy in range(3):
        for dx in range(3):
            terms.append(inp[x + dx, y + dy] * w[k])
            k += 1
    blur[x, y] = balanced_sum(terms) / 16
    blur.hw_accelerate()
    funcs = [inp, blur]
    pipe = lower_pipeline(blur, funcs, {"x": out_w, "y": out_h})
    return AppBundle(
        "gaussian", "stencil", pipe, funcs, blur,
        {"x": out_w, "y": out_h},
        {"input": (size, width)},
        description="3x3 convolutional blur",
    )


# ---------------------------------------------------------------------------
# harris — corner detector, six schedules (Table V)
# ---------------------------------------------------------------------------


def build_harris(schedule: str = "sch3", size: int = 64) -> AppBundle:
    """Schedules (paper Table V):
    sch1 recompute all | sch2 recompute some | sch3 no recompute |
    sch4 unroll by 2 | sch5 4x larger tile | sch6 last stage on host
    """
    inp = Func.input("input", 2)

    gx = Func("grad_x")      # sobel x
    gx[x, y] = balanced_sum([
        inp[x, y] * -1, inp[x + 2, y] * 1,
        inp[x, y + 1] * -2, inp[x + 2, y + 1] * 2,
        inp[x, y + 2] * -1, inp[x + 2, y + 2] * 1,
    ])
    gy = Func("grad_y")      # sobel y
    gy[x, y] = balanced_sum([
        inp[x, y] * -1, inp[x + 1, y] * -2, inp[x + 2, y] * -1,
        inp[x, y + 2] * 1, inp[x + 1, y + 2] * 2, inp[x + 2, y + 2] * 1,
    ])

    lxx, lyy, lxy = Func("lxx"), Func("lyy"), Func("lxy")
    lxx[x, y] = gx[x, y] * gx[x, y] / 64
    lyy[x, y] = gy[x, y] * gy[x, y] / 64
    lxy[x, y] = gx[x, y] * gy[x, y] / 64

    def box3(name: str, src: Func) -> Func:
        f = Func(name)
        f[x, y] = balanced_sum(
            [src[x + dx, y + dy] for dy in range(3) for dx in range(3)]
        )
        return f

    sxx, syy, sxy = box3("sxx", lxx), box3("syy", lyy), box3("sxy", lxy)

    resp = Func("response")
    det = sxx[x, y] * syy[x, y] - sxy[x, y] * sxy[x, y]
    trace = sxx[x, y] + syy[x, y]
    resp[x, y] = det - (trace * trace) / 16

    out = Func("harris")
    out[x, y] = Select(resp[x, y] > 100, resp[x, y], Const(0))

    funcs = [inp, gx, gy, lxx, lyy, lxy, sxx, syy, sxy, resp, out]
    tile = size - 4          # input tile convention: 3x3 over 3x3 halo

    if schedule == "sch1":          # recompute all: everything inlined
        pass
    elif schedule == "sch2":        # recompute some: buffer gradients only
        gx.store_root(); gy.store_root()
    elif schedule in ("sch3", "sch4", "sch5", "sch6"):  # no recompute
        gx.store_root(); gy.store_root()
        sxx.store_root(); syy.store_root(); sxy.store_root()
        if schedule == "sch4":      # unroll by 2 -> 2 output pixels / cycle
            for f in (out, gx, gy, sxx, syy, sxy):
                f.unroll(x, 2)
        if schedule == "sch5":      # tile 2x larger in each dimension
            tile = 2 * size - 4
        if schedule == "sch6":      # last stage on the host processor
            out.compute_on_host()
            resp.store_root()
    else:
        raise ValueError(f"unknown harris schedule {schedule}")

    out.hw_accelerate()
    pipe = lower_pipeline(out, funcs, {"x": tile, "y": tile})
    return AppBundle(
        "harris" if schedule == "sch3" else f"harris-{schedule}",
        "stencil", pipe, funcs, out,
        {"x": tile, "y": tile},
        {"input": (tile + 4, tile + 4)},
        description=f"corner detector ({schedule})",
    )


# ---------------------------------------------------------------------------
# upsample — x2 nearest-neighbour (phase dims keep accesses affine)
# ---------------------------------------------------------------------------


def build_upsample(size: int = 64) -> AppBundle:
    inp = Func.input("input", 2)
    up = Func("upsample")
    # up[(xi, x), (yi, y)] = in[x, y]; logical output is (2*size) x (2*size)
    up[xi, x, yi, y] = inp[x, y] + 0
    up.hw_accelerate()
    funcs = [inp, up]
    pipe = lower_pipeline(up, funcs, {"xi": 2, "x": size, "yi": 2, "y": size})
    return AppBundle(
        "upsample", "stencil", pipe, funcs, up,
        {"xi": 2, "x": size, "yi": 2, "y": size},
        {"input": (size, size)},
        description="up sampling by repeating pixels",
    )


# ---------------------------------------------------------------------------
# unsharp — separable blur + sharpening mask
# ---------------------------------------------------------------------------


def build_unsharp(size: int = 64) -> AppBundle:
    out_sz = size - 2
    inp = Func.input("input", 2)
    blur_x = Func("blur_x")
    blur_x[x, y] = (inp[x, y] + inp[x + 1, y] * 2 + inp[x + 2, y]) / 4
    blur_y = Func("blur_y")
    blur_y[x, y] = (blur_x[x, y] + blur_x[x, y + 1] * 2 + blur_x[x, y + 2]) / 4
    sharp = Func("sharpen")
    center = inp[x + 1, y + 1]
    sharp[x, y] = center * 2 - blur_y[x, y]
    ratio = Func("ratio")
    ratio[x, y] = sharp[x, y] / maximum(center, 1)
    out = Func("unsharp")
    out[x, y] = minimum(maximum(ratio[x, y] * center, 0), 255)

    blur_x.store_root()
    blur_y.store_root()
    sharp.store_root()
    out.hw_accelerate()
    funcs = [inp, blur_x, blur_y, sharp, ratio, out]
    pipe = lower_pipeline(out, funcs, {"x": out_sz, "y": out_sz})
    return AppBundle(
        "unsharp", "stencil", pipe, funcs, out,
        {"x": out_sz, "y": out_sz},
        {"input": (size, size)},
        description="mask to sharpen the image",
    )


# ---------------------------------------------------------------------------
# camera — denoise + demosaic (bayer phases) + colour-correction + gamma
# ---------------------------------------------------------------------------


def _is_phase(px: int, py: int):
    """1.0 iff (xi, yi) == (px, py), as 16-bit-friendly arithmetic."""
    tx = IterVal("xi") if px == 1 else (Const(1) - IterVal("xi"))
    ty = IterVal("yi") if py == 1 else (Const(1) - IterVal("yi"))
    return tx * ty


def build_camera(size: int = 30) -> AppBundle:
    raw = Func.input("raw", 2)

    # hot-pixel suppression: clamp centre pixel into the neighbourhood range
    dn = Func("denoise")
    neigh_max = maximum(
        maximum(raw[x, y + 1], raw[x + 2, y + 1]),
        maximum(raw[x + 1, y], raw[x + 1, y + 2]),
    )
    neigh_min = minimum(
        minimum(raw[x, y + 1], raw[x + 2, y + 1]),
        minimum(raw[x + 1, y], raw[x + 1, y + 2]),
    )
    dn[x, y] = minimum(maximum(raw[x + 1, y + 1], neigh_min), neigh_max)

    # demosaic over bayer phases (GRBG): all taps forward-shifted so access
    # maps stay inside the (positive) required box
    def at(dx: int, dy: int):
        return dn[x * 2 + dx, y * 2 + dy]

    g = Func("demosaic_g")
    g[xi, x, yi, y] = (
        _is_phase(0, 0) * at(0, 0)
        + _is_phase(1, 1) * at(1, 1)
        + (_is_phase(1, 0) + _is_phase(0, 1)) * ((at(0, 0) + at(1, 1)) / 2)
    )
    r = Func("demosaic_r")
    r[xi, x, yi, y] = (
        _is_phase(1, 0) * at(1, 0)
        + (Const(1) - _is_phase(1, 0)) * ((at(1, 0) + at(3, 0)) / 2)
    )
    b = Func("demosaic_b")
    b[xi, x, yi, y] = (
        _is_phase(0, 1) * at(0, 1)
        + (Const(1) - _is_phase(0, 1)) * ((at(0, 1) + at(0, 3)) / 2)
    )

    # colour-correction matrix + gamma (quadratic approx), luminance output
    ccm_r, ccm_g, ccm_b = Func("ccm_r"), Func("ccm_g"), Func("ccm_b")
    ccm_r[xi, x, yi, y] = (r[xi, x, yi, y] * 14 + g[xi, x, yi, y] * 2 - b[xi, x, yi, y]) / 16
    ccm_g[xi, x, yi, y] = (r[xi, x, yi, y] * -1 + g[xi, x, yi, y] * 14 + b[xi, x, yi, y] * 2) / 16
    ccm_b[xi, x, yi, y] = (r[xi, x, yi, y] * 2 - g[xi, x, yi, y] + b[xi, x, yi, y] * 14) / 16

    out = Func("camera")
    lum = (ccm_r[xi, x, yi, y] * 5 + ccm_g[xi, x, yi, y] * 9 + ccm_b[xi, x, yi, y] * 2) / 16
    out[xi, x, yi, y] = minimum(maximum(lum + lum * lum / 256, 0), 255)

    dn.store_root()
    g.store_root(); r.store_root(); b.store_root()
    out.hw_accelerate()
    funcs = [raw, dn, g, r, b, ccm_r, ccm_g, ccm_b, out]
    pipe = lower_pipeline(out, funcs, {"xi": 2, "x": size, "yi": 2, "y": size})
    return AppBundle(
        "camera", "stencil", pipe, funcs, out,
        {"xi": 2, "x": size, "yi": 2, "y": size},
        {"raw": (2 * size + 4, 2 * size + 4)},
        description="demosaicing and image correction",
    )


# ---------------------------------------------------------------------------
# resnet — multi-channel 3x3 convolution layer (DNN pipeline, §V-B Fig. 7)
# ---------------------------------------------------------------------------


def build_resnet(
    img: int = 16, cin: int = 8, cout: int = 8, tiles: int = 4
) -> AppBundle:
    inp = Func.input("ifmap", 3)     # indexed [x, y, ci]
    wgt = Func.input("weights", 4)   # indexed [kx, ky, ci, co]
    r = RDom(3, 3, cin, name="r")    # (kx, ky, ci) reduction
    rx, ry, rc = r[0], r[1], r[2]

    conv = Func("resnet")
    conv[x, y, co] = 0
    conv.update(
        (x, y, co),
        conv[x, y, co] + inp[x + rx, y + ry, rc] * wgt[rx, ry, rc, co],
        r,
    )
    # unroll the channel MACs (64 multipliers), keep spatial reduction loops
    # rolled -> the paper's DNN scheduling policy is selected
    conv.unroll(rc, cin)
    conv.unroll(co, cout)
    conv.hw_accelerate()
    funcs = [inp, wgt, conv]
    pipe = lower_pipeline(conv, funcs, {"x": img, "y": img, "co": cout})
    return AppBundle(
        "resnet", "dnn", pipe, funcs, conv,
        {"x": img, "y": img, "co": cout},
        {"ifmap": (cin, img + 2, img + 2), "weights": (cout, cin, 3, 3)},
        tile_count=tiles,
        description="layer using multi-channel convolution",
    )


# ---------------------------------------------------------------------------
# mobilenet — depthwise-separable convolution layer (DNN pipeline)
# ---------------------------------------------------------------------------


def build_mobilenet(
    img: int = 16, cin: int = 8, cout: int = 8, tiles: int = 4
) -> AppBundle:
    inp = Func.input("ifmap", 3)      # [c, x, y] — channel fastest
    wdw = Func.input("dw_weights", 3)  # [kx, ky, c]
    wpw = Func.input("pw_weights", 2)  # [c, co]

    rs = RDom(3, 3, name="s")          # spatial reduction (depthwise)
    sx, sy = rs[0], rs[1]
    # channels indexed *innermost* -> the fused stream interleaves channels
    # per pixel, which is what lets the pointwise stage consume immediately
    dw = Func("dw_conv")
    dw[ch, x, y] = 0
    dw.update(
        (ch, x, y),
        dw[ch, x, y] + inp[ch, x + sx, y + sy] * wdw[sx, sy, ch],
        rs,
    )
    # every reduction loop fully unrolled -> the paper's *stencil* policy is
    # selected (mobilenet "is structurally similar to a stencil pipeline",
    # §VI-D), with 2 channels of MACs in parallel
    dw.unroll(sx, 3).unroll(sy, 3).unroll(ch, 2)
    dw.store_root()

    rc_dom = RDom(cin, name="q")       # channel reduction (pointwise)
    q = rc_dom[0]
    pw = Func("mobilenet")
    pw[co, x, y] = 0
    pw.update((co, x, y), pw[co, x, y] + dw[q, x, y] * wpw[q, co], rc_dom)
    pw.unroll(q, cin).unroll(co, 2)
    pw.hw_accelerate()

    funcs = [inp, wdw, wpw, dw, pw]
    pipe = lower_pipeline(pw, funcs, {"co": cout, "x": img, "y": img})
    return AppBundle(
        "mobilenet", "dnn", pipe, funcs, pw,
        {"co": cout, "x": img, "y": img},
        {
            "ifmap": (img + 2, img + 2, cin),   # loop order (y, x, c)
            "dw_weights": (cin, 3, 3),
            "pw_weights": (cout, cin),
        },
        tile_count=tiles,
        description="layer using separable, multi-channel convolution",
    )


# ---------------------------------------------------------------------------
# matmul — (M, K) x (K, N) tile, the GEMM-shaped workload for the backend
# ---------------------------------------------------------------------------


def build_matmul(m: int = 32, n: int = 32, k: int = 32) -> AppBundle:
    """One accelerator tile of C = A @ B (loop order: A is (M, K), B is
    (K, N), C is (M, N)).  Not one of the paper's seven Table III apps — it
    exists so the generated-kernel backend is exercised on a matmul-shaped
    iteration space (reduction-only operand axes, broadcast streams)."""
    a = Func.input("A", 2)
    b = Func.input("B", 2)
    i, j = Var("i"), Var("j")
    r = RDom(k, name="k")
    c = Func("matmul")
    c[j, i] = 0                      # j fastest -> loop order (i, j)
    c.update((j, i), c[j, i] + a[r[0], i] * b[j, r[0]], r)
    c.hw_accelerate()
    funcs = [a, b, c]
    pipe = lower_pipeline(c, funcs, {"j": n, "i": m})
    return AppBundle(
        "matmul", "dnn", pipe, funcs, c,
        {"j": n, "i": m},
        {"A": (m, k), "B": (k, n)},
        description="dense matmul tile (backend workload)",
    )


# ---------------------------------------------------------------------------
# convnext — ConvNeXt's block: depthwise 7x7, LayerNorm, a 4x GELU MLP, a
# layer scale and the residual (a transformer block's anatomy, channels last)
# ---------------------------------------------------------------------------


def build_convnext(
    img: int = 4, dim: int = 8, hidden: int = 32, tiles: int = 4
) -> AppBundle:
    """One block of ConvNeXt (Liu et al., "A ConvNet for the 2020s",
    arXiv:2201.03545) on an ``img`` x ``img`` tile of ``dim`` channels::

        x + layer_scale * (w2 . GELU(w1 . LN(dwconv7x7(x) + dw_bias) + b1) + b2)

    Channels are innermost, as in mobilenet, in the ifmap and in the
    depthwise weights (``[ky][kx][c]``, so that threads along the channels
    read consecutive weights), and ``ifmap`` carries its 3-pixel halo
    (``img + 6`` square, no padding); the residual reads it at the centre.  LayerNorm runs over the channels of each pixel (mean, then
    the variance about it, eps 1e-6, then the affine), GELU is the exact
    ``erf`` form in torch's order, ``w1`` is ``dim`` -> ``hidden`` and
    ``w2`` ``hidden`` -> ``dim``, each laid out as ``nn.Linear``'s weight
    (out, in).  The defaults are tiny: the reference interpreter is
    pointwise Python."""
    inp = Func.input("ifmap", 3)          # [c, x, y]
    wdw = Func.input("dw_weights", 3)     # [c, kx, ky]: channels innermost
    bdw = Func.input("dw_bias", 1)
    lnw = Func.input("ln_weight", 1)
    lnb = Func.input("ln_bias", 1)
    w1 = Func.input("w1", 2)              # [c, hc]: loop order (hidden, dim)
    b1 = Func.input("b1", 1)
    w2 = Func.input("w2", 2)              # [hc, co]: loop order (dim, hidden)
    b2 = Func.input("b2", 1)
    gamma = Func.input("layer_scale", 1)

    rs = RDom(7, 7, name="s")             # the depthwise window
    sx, sy = rs[0], rs[1]
    dw = Func("dw_conv")
    dw[ch, x, y] = 0
    dw.update(
        (ch, x, y),
        dw[ch, x, y] + inp[ch, x + sx, y + sy] * wdw[ch, sx, sy],
        rs,
    )
    dw.unroll(sx, 7).unroll(sy, 7)
    dw.store_root()
    t = Func("dw_out")                    # inlined: the depthwise with its bias
    t[ch, x, y] = dw[ch, x, y] + bdw[ch]

    # LayerNorm over the channels of a pixel: two per-pixel reductions
    def channel_sum(name: str, term) -> Func:
        r = RDom(dim, name="q")
        f = Func(name)
        f[x, y] = 0
        f.update((x, y), f[x, y] + term(r[0]), r)
        f.unroll(r[0], dim)
        f.store_root()
        return f

    ssum = channel_sum("ln_sum", lambda q: t[q, x, y])
    mean = Func("ln_mean")
    mean[x, y] = ssum[x, y] / dim
    mean.store_root()
    centred = Func("ln_centred")          # inlined
    centred[ch, x, y] = t[ch, x, y] - mean[x, y]
    vsum = channel_sum("ln_var_sum", lambda q: centred[q, x, y] * centred[q, x, y])
    rstd = Func("ln_rstd")
    rstd[x, y] = Const(1) / sqrt(vsum[x, y] / dim + 1e-6)
    rstd.store_root()
    ln = Func("ln")
    ln[ch, x, y] = centred[ch, x, y] * rstd[x, y] * lnw[ch] + lnb[ch]
    ln.store_root()

    # the MLP: dim -> hidden -> dim, the hidden axis chained between them
    rq = RDom(dim, name="q")
    fc1 = Func("fc1")
    fc1[hc, x, y] = 0
    fc1.update((hc, x, y), fc1[hc, x, y] + ln[rq[0], x, y] * w1[rq[0], hc], rq)
    fc1.unroll(rq[0], dim)
    fc1.store_root()
    z = fc1[hc, x, y] + b1[hc]
    act = Func("gelu")
    act[hc, x, y] = z * 0.5 * (1 + erf(z * 0.7071067811865476))
    act.store_root()
    rh = RDom(hidden, name="h")
    fc2 = Func("fc2")
    fc2[co, x, y] = 0
    fc2.update((co, x, y), fc2[co, x, y] + act[rh[0], x, y] * w2[rh[0], co], rh)
    fc2.unroll(rh[0], hidden)
    fc2.store_root()

    out = Func("convnext")
    out[co, x, y] = inp[co, x + 3, y + 3] + gamma[co] * (fc2[co, x, y] + b2[co])
    out.hw_accelerate()

    funcs = [inp, wdw, bdw, lnw, lnb, w1, b1, w2, b2, gamma,
             dw, t, ssum, mean, centred, vsum, rstd, ln, fc1, act, fc2, out]
    pipe = lower_pipeline(out, funcs, {"co": dim, "x": img, "y": img})
    return AppBundle(
        "convnext", "dnn", pipe, funcs, out,
        {"co": dim, "x": img, "y": img},
        {
            "ifmap": (img + 6, img + 6, dim),     # loop order (y, x, c)
            "dw_weights": (7, 7, dim),            # loop order (ky, kx, c)
            "dw_bias": (dim,),
            "ln_weight": (dim,),
            "ln_bias": (dim,),
            "w1": (hidden, dim),
            "b1": (hidden,),
            "w2": (dim, hidden),
            "b2": (dim,),
            "layer_scale": (dim,),
        },
        tile_count=tiles,
        description="ConvNeXt block: depthwise 7x7, LayerNorm, GELU MLP, layer scale",
    )


# ---------------------------------------------------------------------------
# swin — Swin Transformer's block pair: windowed multi-head self-attention
# with a relative position bias (W-MSA), then the same over windows shifted
# by half a window (SW-MSA), each followed by a GELU MLP; channels last
# ---------------------------------------------------------------------------


def build_swin(
    img: int = 4, dim: int = 16, heads: int = 2, window: int = 2, hidden: int = 64,
    shift: int = 1, tiles: int = 4,
) -> AppBundle:
    """Two consecutive blocks of Swin Transformer (Liu et al., "Swin
    Transformer: Hierarchical Vision Transformer using Shifted Windows",
    arXiv:2103.14030, §3.1–3.3) on an ``img`` x ``img`` map of ``dim``
    channels, ``heads`` heads of ``dim // heads``, ``window`` x ``window``
    windows; the first block attends within the regular windows, the second
    within windows shifted by ``shift``, each block::

        x = x + proj(WindowAttention(LN1(x)))     # LN eps 1e-5
        x = x + fc2(GELU(fc1(LN2(x))))            # exact erf GELU

    Each window and head computes ``softmax(q . k^T / sqrt(d) + B + mask)
    . v``, ``B`` the relative position bias read from a ``(2 window - 1)^2``
    x ``heads`` table at the query's and key's offset inside the window.

    The index language is affine, with one pure variable an axis, so every
    map is held with its rows and columns split into (window, position):
    ``ifmap`` and the output are ``[wy][py][wx][px][c]``, row ``window * wy
    + py``, a view of the ``[y][x][c]`` map (the same bytes).  A window's
    query and keys are then read at affine positions.  The shifted block
    runs on the map rolled by ``(-shift, -shift)``, as Swin's module does
    (``torch.roll``), and rolls its output back; a roll wraps, so it is a
    reduction over the rows (then the columns) of one-hot terms, exact in
    f32 (one term is the value, the others +0).  Swin's region mask (-100
    on a pair of positions from different regions of a shifted window) is
    computed from the positions, as the scores' initial value.  Weights
    are views of Swin's and ``nn.Linear``'s: ``qkv_w`` [3 heads][d][dim] of
    the (3 dim, dim) weight, ``rel_bias`` [2M-1][2M-1][heads] of the
    (2M-1)^2 x heads table (row ``(qy - ky + M - 1) (2M - 1) + qx - kx + M
    - 1``), ``fc1_w`` and ``fc2_w`` as they are; ``proj_w`` [heads][d][dim]
    is input-major, the transpose of the (dim, dim) weight, so that threads
    along the output channels read consecutive words.  Inside a block the per-pixel
    stages run rows position-major (``[py][wy][px][wx][c]``) and the
    attention head-major (``[h][wy][wx][py][px]...``), so that a block of
    the generated kernels takes a few rows or a few heads.  The defaults are
    tiny: the reference interpreter is pointwise Python."""
    if img % window or dim % heads or not 0 < shift < window:
        raise ValueError(f"swin: img {img} a multiple of window {window}, dim {dim} of "
                         f"heads {heads}, 0 < shift {shift} < window")
    n, M, hd = img // window, window, dim // heads
    wx, px, wy, py = Var("wx"), Var("px"), Var("wy"), Var("py")
    kx, ky, h, d, h3 = Var("kx"), Var("ky"), Var("h"), Var("d"), Var("h3")
    inp = Func.input("ifmap", 5)          # [c, px, wx, py, wy]
    funcs: List[Func] = [inp]
    input_extents: Dict[str, Tuple[int, ...]] = {"ifmap": (n, M, n, M, dim)}

    def pix(f: Func, c):
        """``f`` (a per-pixel stage) at the current pixel, channel ``c``."""
        return f[c, wx, px, wy, py]

    def weight(name: str, ndim: int, extents: Tuple[int, ...]) -> Func:
        f = Func.input(name, ndim)
        funcs.append(f)
        input_extents[name] = extents
        return f

    def stage(name: str) -> Func:
        f = Func(name)
        funcs.append(f)
        return f

    def layer_norm(pre: str, x) -> Func:
        """LayerNorm over the channels of a pixel, eps 1e-5: ``x(c)`` is
        the input at the current pixel."""
        lw = weight(f"{pre}_weight", 1, (dim,))
        lb = weight(f"{pre}_bias", 1, (dim,))

        def channel_sum(name: str, term) -> Func:
            r = RDom(dim, name="q")
            f = stage(name)
            f[wx, px, wy, py] = 0
            f.update((wx, px, wy, py), f[wx, px, wy, py] + term(r[0]), r)
            f.unroll(r[0], dim)
            f.store_root()
            return f

        ssum = channel_sum(f"{pre}_sum", x)
        mean = stage(f"{pre}_mean")
        mean[wx, px, wy, py] = ssum[wx, px, wy, py] / dim
        mean.store_root()
        centred = stage(f"{pre}_centred")     # inlined
        centred[ch, wx, px, wy, py] = x(ch) - mean[wx, px, wy, py]
        vsum = channel_sum(f"{pre}_var_sum",
                           lambda q: centred[q, wx, px, wy, py] * centred[q, wx, px, wy, py])
        rstd = stage(f"{pre}_rstd")
        rstd[wx, px, wy, py] = Const(1) / sqrt(vsum[wx, px, wy, py] / dim + 1e-5)
        rstd.store_root()
        ln = stage(pre)
        ln[ch, wx, px, wy, py] = (centred[ch, wx, px, wy, py] * rstd[wx, px, wy, py]
                                  * lw[ch] + lb[ch])
        ln.store_root()
        return ln

    def region(pos):
        """The region of Swin's shifted-window mask a rolled row (or
        column) ``pos`` falls in: 0, 1 or 2 (``img - M`` and ``img - shift``
        start the second and third)."""
        return (pos > img - M - 1) + (pos > img - shift - 1)

    def block(b: int, x, shifted: bool) -> Func:
        """One block on ``x(c)``, the input at the current pixel."""
        pre = f"b{b}"
        ln1 = layer_norm(f"{pre}_ln1", x)
        wqkv = weight(f"{pre}_qkv_w", 3, (3 * heads, hd, dim))    # [c, d, h3]
        bqkv = weight(f"{pre}_qkv_b", 2, (3 * heads, hd))        # [d, h3]
        rq = RDom(dim, name="q")
        qkv = stage(f"{pre}_qkv")             # [d, px, py, wx, wy, h3]: head-major
        qkv[d, px, py, wx, wy, h3] = 0
        qkv.update((d, px, py, wx, wy, h3), qkv[d, px, py, wx, wy, h3]
                   + ln1[rq[0], wx, px, wy, py] * wqkv[rq[0], d, h3], rq)
        qkv.unroll(rq[0], dim)
        qkv.store_root()

        # scores: the query at (py, px) of window (wy, wx), the key at (ky, kx)
        rd = RDom(hd, name="e")
        e = rd[0]
        score = stage(f"{pre}_score")         # [kx, ky, px, py, wx, wy, h]
        q_ = (qkv[e, px, py, wx, wy, h] + bqkv[e, h]) * (hd ** -0.5)
        k_ = qkv[e, kx, ky, wx, wy, h + heads] + bqkv[e, h + heads]
        if shifted:
            # Swin's mask of the shifted windows, from the positions alone:
            # -100 where the query and the key lie in different regions; the
            # scores' initial value, so each pair's is added once
            qlab = (region(M * IterVal("wy") + IterVal("py")) * 3
                    + region(M * IterVal("wx") + IterVal("px")))
            klab = (region(M * IterVal("wy") + IterVal("ky")) * 3
                    + region(M * IterVal("wx") + IterVal("kx")))
            score[kx, ky, px, py, wx, wy, h] = Select(qlab - klab, Const(-100.0), Const(0.0))
        else:
            score[kx, ky, px, py, wx, wy, h] = 0
        score.update((kx, ky, px, py, wx, wy, h),
                     score[kx, ky, px, py, wx, wy, h] + q_ * k_, rd)
        score.unroll(e, hd)
        score.store_root()
        rb = weight(f"{pre}_rel_bias", 3, (2 * M - 1, 2 * M - 1, heads))   # [h, dx, dy]

        def logit(rk):
            """The key (ky, kx) = ``rk``'s score (its mask included) with
            its relative position bias."""
            ry, rx = rk[0], rk[1]
            return (score[rx, ry, px, py, wx, wy, h]
                    + rb[h, px - rx + (M - 1), py - ry + (M - 1)])

        rk = RDom(M, M, name="k")             # (ky, kx): the window's keys
        mx = stage(f"{pre}_max")
        mx[px, py, wx, wy, h] = Const(-math.inf)
        mx.update((px, py, wx, wy, h), maximum(mx[px, py, wx, wy, h], logit(rk)), rk)
        mx.store_root()
        rk = RDom(M, M, name="k")
        den = stage(f"{pre}_den")
        den[px, py, wx, wy, h] = 0
        den.update((px, py, wx, wy, h),
                   den[px, py, wx, wy, h] + exp(logit(rk) - mx[px, py, wx, wy, h]), rk)
        den.store_root()
        rk = RDom(M, M, name="k")
        attn = stage(f"{pre}_attn")           # [d, px, py, wx, wy, h]
        p_ = exp(logit(rk) - mx[px, py, wx, wy, h]) / den[px, py, wx, wy, h]
        v_ = qkv[d, rk[1], rk[0], wx, wy, h + 2 * heads] + bqkv[d, h + 2 * heads]
        attn[d, px, py, wx, wy, h] = 0
        attn.update((d, px, py, wx, wy, h), attn[d, px, py, wx, wy, h] + p_ * v_, rk)
        attn.store_root()

        wproj = weight(f"{pre}_proj_w", 3, (heads, hd, dim))     # [co, d, h]: input-major
        bproj = weight(f"{pre}_proj_b", 1, (dim,))
        rp = RDom(heads, hd, name="p")
        proj = stage(f"{pre}_proj")
        proj[co, wx, px, wy, py] = 0
        proj.update((co, wx, px, wy, py), proj[co, wx, px, wy, py]
                    + attn[rp[1], px, py, wx, wy, rp[0]] * wproj[co, rp[1], rp[0]], rp)
        proj.unroll(rp[1], hd)
        proj.store_root()
        res = stage(f"{pre}_res")             # the first residual
        res[ch, wx, px, wy, py] = x(ch) + (pix(proj, ch) + bproj[ch])
        res.store_root()

        ln2 = layer_norm(f"{pre}_ln2", lambda c: pix(res, c))
        w1 = weight(f"{pre}_fc1_w", 2, (hidden, dim))            # [c, hc]
        b1 = weight(f"{pre}_fc1_b", 1, (hidden,))
        w2 = weight(f"{pre}_fc2_w", 2, (dim, hidden))            # [hc, co]
        b2 = weight(f"{pre}_fc2_b", 1, (dim,))
        rq = RDom(dim, name="q")
        fc1 = stage(f"{pre}_fc1")
        fc1[hc, wx, px, wy, py] = 0
        fc1.update((hc, wx, px, wy, py), fc1[hc, wx, px, wy, py]
                   + pix(ln2, rq[0]) * w1[rq[0], hc], rq)
        fc1.unroll(rq[0], dim)
        fc1.store_root()
        z = pix(fc1, hc) + b1[hc]
        act = stage(f"{pre}_gelu")
        act[hc, wx, px, wy, py] = z * 0.5 * (1 + erf(z * 0.7071067811865476))
        act.store_root()
        rh = RDom(hidden, name="h")
        fc2 = stage(f"{pre}_fc2")
        fc2[co, wx, px, wy, py] = 0
        fc2.update((co, wx, px, wy, py), fc2[co, wx, px, wy, py]
                   + pix(act, rh[0]) * w2[rh[0], co], rh)
        fc2.unroll(rh[0], hidden)
        fc2.store_root()
        out = stage(f"{pre}_out")
        out[co, wx, px, wy, py] = pix(res, co) + (pix(fc2, co) + b2[co])
        out.store_root()
        return out

    def wrong(rr, w_: str, p_: str, by: int):
        """Nonzero unless the source row (column) ``rr`` is ``(r + by) mod
        img``, ``r`` the stage's own: ``t (t + img)``, ``t`` the source less
        ``r + by``, which is 0 or ``-img`` where they match."""
        t = M * IterVal(rr[0].name) + IterVal(rr[1].name) - (M * IterVal(w_) + IterVal(p_) + by)
        return t * (t + img)

    def roll(name: str, src, by: int, axis: str, index) -> Func:
        """``src`` rolled by ``-by`` along ``axis`` (``"y"`` or ``"x"``):
        the value at row (column) ``r`` is the source's at ``(r + by) mod
        img``, a reduction over the source's (window, position) of one-hot
        terms.  ``src(c, w, p)`` reads the source at the current pixel with
        that axis's window and position replaced; ``index`` is the stage's
        own index order."""
        rr = RDom(n, M, name=f"r{axis}")
        w_, p_ = ("wy", "py") if axis == "y" else ("wx", "px")
        f = stage(name)
        f[index] = 0
        f.update(index, f[index] + Select(wrong(rr, w_, p_, by), Const(0.0),
                                          src(rr[0], rr[1])), rr)
        f.store_root()
        return f

    own = (ch, wx, px, wy, py)
    x1 = block(1, lambda c: inp[c, px, wx, py, wy], shifted=False)
    ry = roll("roll_y", lambda w_, p_: x1[ch, wx, px, w_, p_], shift, "y", own)
    rx = roll("roll_x", lambda w_, p_: ry[ch, w_, p_, wy, py], shift, "x", own)
    x2 = block(2, lambda c: pix(rx, c), shifted=True)
    uy = roll("unroll_y", lambda w_, p_: x2[ch, wx, px, w_, p_], img - shift, "y", own)
    out = Func("swin")                    # [c, px, wx, py, wy]: the map's layout
    funcs.append(out)
    rr = RDom(n, M, name="rx")
    out[ch, px, wx, py, wy] = 0
    out.update((ch, px, wx, py, wy), out[ch, px, wx, py, wy] + Select(
        wrong(rr, "wx", "px", img - shift), Const(0.0), uy[ch, rr[0], rr[1], wy, py]), rr)
    out.hw_accelerate()

    ext = {"ch": dim, "px": M, "wx": n, "py": M, "wy": n}
    pipe = lower_pipeline(out, funcs, ext)
    return AppBundle(
        "swin", "dnn", pipe, funcs, out, ext, input_extents,
        tile_count=tiles,
        description="Swin block pair: W-MSA and SW-MSA with relative position bias, GELU MLPs",
    )


# ---------------------------------------------------------------------------
ALL_APPS = ["gaussian", "harris", "upsample", "unsharp", "camera", "resnet", "mobilenet"]
# additional backend workloads, not part of the paper's Table III set
EXTRA_APPS = ["matmul", "convnext", "swin"]


def make_app(name: str, **kw) -> AppBundle:
    builders: Dict[str, Callable[..., AppBundle]] = {
        "gaussian": build_gaussian,
        "harris": build_harris,
        "upsample": build_upsample,
        "unsharp": build_unsharp,
        "camera": build_camera,
        "resnet": build_resnet,
        "mobilenet": build_mobilenet,
        "matmul": build_matmul,
        "convnext": build_convnext,
        "swin": build_swin,
    }
    if name not in builders:
        raise ValueError(f"no app {name!r}; the apps are {sorted(builders)}")
    return builders[name](**kw)


__all__ = ["AppBundle", "ALL_APPS", "EXTRA_APPS", "make_app"] + [
    f"build_{n}" for n in ALL_APPS + EXTRA_APPS
]
