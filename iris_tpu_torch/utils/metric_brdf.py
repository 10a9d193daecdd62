"""BRDF recovery metrics on FIPT-synthetic ground truth (counterpart of
iris_tpu/utils/metric_brdf.py, numpy; reference utils/metric_brdf.py):
PSNR of kd, albedo (a') and roughness with the reference's masks
(quantized GT, emission masked, roughness clamped to [0.2, 1], kd scored
on fully diffuse pixels only), emission IoU and log-MSE, over the files
that pipeline/render.py writes.

Usage: python -m iris_tpu_torch.utils.metric_brdf --gt <scene>/val
           --method outputs/x/render/val [--max_frames N]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from iris_tpu_torch.utils.exr import read_exr
from iris_tpu_torch.utils.image import open_png


def _quantize(x):
    return np.round(np.clip(x, 0, 1) * 255) / 255.0


def brdf_metrics(gt_path: str, method_path: str,
                 max_frames: int = 0) -> dict:
    image_num = len([f for f in os.listdir(os.path.join(gt_path, "Image"))
                     if not f.startswith(".") and f.endswith(".exr")])
    if max_frames:
        image_num = min(image_num, max_frames)
    mses = {"roughness": [], "albedo": [], "kd": []}
    ious, log_mses = [], []
    for i in range(image_num):
        emission_gt = read_exr(os.path.join(gt_path, "Emit",
                                            f"{i:03d}_0001.exr"))[..., :3]
        emission_mask = emission_gt.sum(-1) > 0

        albedo_gt = _quantize(read_exr(os.path.join(
            gt_path, "albedo", f"{i:03d}.exr"))[..., :3])
        albedo_gt[emission_mask] = 0
        kd_gt = _quantize(read_exr(os.path.join(
            gt_path, "DiffCol", f"{i:03d}_0001.exr"))[..., :3])
        kd_gt[emission_mask] = 0
        rough_gt = np.clip(_quantize(read_exr(os.path.join(
            gt_path, "Roughness", f"{i:03d}_0001.exr"))[..., 0]), 0.2, 1.0)
        rough_gt[emission_mask] = 0
        diff_mask = rough_gt == 1
        kd_gt[~diff_mask] = 0

        emission = read_exr(os.path.join(
            method_path, "emission", f"{i:05d}_emission.exr"))[..., :3]
        albedo = open_png(os.path.join(method_path, "a_prime",
                                       f"{i:05d}_a_prime.png"))
        albedo[emission_mask] = 0
        kd = open_png(os.path.join(method_path, "diffuse",
                                   f"{i:05d}_diffuse.png"))
        kd[emission_mask] = 0
        kd[~diff_mask] = 0
        rough = read_exr(os.path.join(
            method_path, "roughness", f"{i:05d}_roughness.exr"))[..., 0]
        rough = np.clip(rough, 0.2, 1.0)
        rough[emission_mask] = 0

        est_mask = emission.sum(-1) > 0
        if emission_mask.any():
            ious.append((emission_mask & est_mask).sum()
                        / max((emission_mask | est_mask).sum(), 1))
            log_mses.append(np.mean(
                (np.log(emission + 1) - np.log(emission_gt + 1)) ** 2))
        mses["roughness"].append(np.mean((rough - rough_gt) ** 2))
        mses["albedo"].append(np.mean((albedo - albedo_gt) ** 2))
        mses["kd"].append(np.mean((kd - kd_gt) ** 2))

    def psnr_of(v):
        return float(np.mean(-10 * np.log10(np.maximum(v, 1e-10))))

    return {
        "kd_psnr": psnr_of(mses["kd"]),
        "albedo_psnr": psnr_of(mses["albedo"]),
        "roughness_psnr": psnr_of(mses["roughness"]),
        "emission_iou": float(np.mean(ious)) if ious else float("nan"),
        "emission_log_mse": float(np.mean(log_mses)) if log_mses
        else float("nan"),
    }


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--gt", type=str, required=True,
                        help="GT split dir (e.g. scene/train)")
    parser.add_argument("--method", type=str, required=True,
                        help="render output split dir")
    parser.add_argument("--max_frames", type=int, default=0,
                        help="score only the first N frames (0 = all)")
    args = parser.parse_args(argv)
    m = brdf_metrics(args.gt, args.method, args.max_frames)
    for k, v in m.items():
        print(f"{k:18s} {v:.5f}")


if __name__ == "__main__":
    main()
