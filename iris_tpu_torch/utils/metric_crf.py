"""CRF recovery metric + curve plots (counterpart of
iris_tpu/utils/metric_crf.py; reference utils/metric_crf.py).

L2 between predicted and GT response curves. The JAX package draws its
plots with matplotlib, which the card's machine lacks; the port draws the
same figures with PIL's ImageDraw: the files, their size (matplotlib's
12 x 4 and 6 x 4 inches at 100 dpi) and their content (three panels of
the predicted curve, red, over the GT curve, blue and dashed, where one
is given; a bar chart of the weights), not matplotlib's pixels.
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
from PIL import Image, ImageDraw

_RED, _BLUE, _GREY, _BLACK = (214, 39, 40), (31, 119, 180), (190, 190, 190), \
    (0, 0, 0)
_MARGIN = (50, 20, 20, 40)          # left, top, right, bottom pixels


def crf_l2(crf_gt: np.ndarray, crf_pred: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(crf_gt) - np.asarray(crf_pred)))


def _panel(draw, box, title):
    """Frame one plot panel of [0, 1] x [0, 1]; returns a mapper from data
    coordinates to pixels."""
    x0, y0, x1, y1 = box
    draw.rectangle(box, outline=_BLACK)
    for t in (0.25, 0.5, 0.75):
        gx = x0 + t * (x1 - x0)
        gy = y1 - t * (y1 - y0)
        draw.line([(gx, y0), (gx, y1)], fill=_GREY)
        draw.line([(x0, gy), (x1, gy)], fill=_GREY)
    for t in (0.0, 0.5, 1.0):
        draw.text((x0 + t * (x1 - x0) - 8, y1 + 4), f"{t:.1f}", fill=_BLACK)
        draw.text((x0 - 26, y1 - t * (y1 - y0) - 6), f"{t:.1f}",
                  fill=_BLACK)
    draw.text((x0 + (x1 - x0) / 2 - 25, y1 + 18), title, fill=_BLACK)

    def to_px(x, y):
        return (x0 + np.clip(x, 0, 1) * (x1 - x0),
                y1 - np.clip(y, 0, 1) * (y1 - y0))

    return to_px


def _polyline(draw, to_px, y, color, dashed=False):
    x = np.linspace(0, 1, len(y))
    px, py = to_px(x, np.asarray(y, np.float64))
    pts = list(zip(px.tolist(), py.tolist()))
    step = max(len(pts) // 64, 1) if dashed else 0
    for i in range(len(pts) - 1):
        if dashed and (i // step) % 2:
            continue
        draw.line([pts[i], pts[i + 1]], fill=color, width=2)


def plot_crfs(crf_pred, crf_gt, path: str) -> None:
    """One panel per colour channel: LDR against irradiance, the predicted
    curve and, where given, the GT curve; a legend names both."""
    crf_pred = np.asarray(crf_pred)
    w, h = 1200, 400
    img = Image.new("RGB", (w, h), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    pw = w // 3
    left, top, right, bottom = _MARGIN
    for c in range(3):
        box = (c * pw + left, top, (c + 1) * pw - right, h - bottom)
        to_px = _panel(draw, box, "Irradiance")
        if crf_gt is not None:
            _polyline(draw, to_px, np.asarray(crf_gt)[c], _BLUE, dashed=True)
        _polyline(draw, to_px, crf_pred[c], _RED)
        lx, ly = box[0] + 10, box[1] + 8
        draw.line([(lx, ly + 6), (lx + 20, ly + 6)], fill=_RED, width=2)
        draw.text((lx + 26, ly), "Pred.", fill=_BLACK)
        if crf_gt is not None:
            draw.line([(lx, ly + 22), (lx + 20, ly + 22)], fill=_BLUE,
                      width=2)
            draw.text((lx + 26, ly + 16), "GT", fill=_BLACK)
        draw.text((c * pw + 4, top + (h - top - bottom) // 2), "LDR",
                  fill=_BLACK)
    img.save(path)


def plot_weights(w_pred, w_gt, path: str) -> None:
    """A bar per weight, the predicted beside the GT where given."""
    w_pred = np.asarray(w_pred, np.float64).reshape(-1)
    w_gt = None if w_gt is None else np.asarray(w_gt,
                                                np.float64).reshape(-1)
    w, h = 600, 400
    img = Image.new("RGB", (w, h), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    left, top, right, bottom = _MARGIN
    x0, y0, x1, y1 = left, top, w - right, h - bottom
    draw.rectangle((x0, y0, x1, y1), outline=_BLACK)
    vals = w_pred if w_gt is None else np.concatenate([w_pred, w_gt])
    lo, hi = min(float(vals.min()), 0.0), max(float(vals.max()), 0.0)
    span = max(hi - lo, 1e-12)

    def ypx(v):
        return y1 - (v - lo) / span * (y1 - y0)

    draw.line([(x0, ypx(0.0)), (x1, ypx(0.0))], fill=_BLACK)
    slot = (x1 - x0) / max(w_pred.size, 1)
    for i, v in enumerate(w_pred):
        cx = x0 + (i + 0.5) * slot
        bars = [(cx - 0.4 * slot, v, _BLUE)]
        if w_gt is not None:
            bars.append((cx, w_gt[i], (255, 127, 14)))
        for bx, bv, color in bars:
            ya, yb = sorted((ypx(0.0), ypx(bv)))
            draw.rectangle((bx, ya, bx + 0.4 * slot, yb), fill=color)
    draw.text((x0 + 8, y0 + 6), "Pred.", fill=_BLUE)
    if w_gt is not None:
        draw.text((x0 + 8, y0 + 22), "GT", fill=(255, 127, 14))
    img.save(path)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--crf_gt", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--crf_basis", type=int, default=3)
    parser.add_argument("--plot", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from dataclasses import replace as dc_replace

    from iris_tpu_torch.device import resolve_device
    from iris_tpu_torch.models.crf import get_crf, init_emor_crf
    from iris_tpu_torch.train.checkpoint import load_pytree

    dev = resolve_device(args.device)
    crf_gt = np.load(args.crf_gt)
    ckpt = load_pytree(args.ckpt, dev)
    crf = init_emor_crf(dim=args.crf_basis, device=dev)
    crf = dc_replace(crf, weight=ckpt["crf_weight"].to(crf.weight.dtype))
    crf_pred = get_crf(crf).detach().cpu().numpy()
    print(f"L2: {crf_l2(crf_gt, crf_pred):.5f}")
    if args.plot:
        plot_crfs(crf_pred, crf_gt, args.plot)


if __name__ == "__main__":
    main()
