"""COLMAP reconstruction readers (text + binary), host numpy (counterpart
of iris_tpu/data/colmap.py, the same records).

Parity: reference utils/dataset/scannetpp/colmap_utils.py — cameras.txt /
images.txt (and .bin) readers with qvec->rotmat. Superseded upstream by
transforms_all.json (scannetpp/dataset.py:110-124 keeps them commented) but
kept for datasets that only ship COLMAP output.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str

    def rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)

    def c2w(self) -> np.ndarray:
        """3x4 cam-to-world (COLMAP stores world-to-cam)."""
        r = self.rotmat()
        t = self.tvec.reshape(3, 1)
        return np.hstack([r.T, -r.T @ t]).astype(np.float32)


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.asarray([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x * x - 2 * y * y],
    ])


def read_images_text(path: str) -> dict[int, ColmapImage]:
    """Each image is two lines: its pose, then its 2D points, which is
    empty for an image with none. As COLMAP's own reader does, only the
    pose line is looked for past blank and comment lines; the line after
    it is the points line, whatever it holds."""
    images = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            f.readline()                 # the 2D points, unused
            images[int(e[0])] = ColmapImage(
                image_id=int(e[0]),
                qvec=np.asarray(e[1:5], np.float64),
                tvec=np.asarray(e[5:8], np.float64),
                camera_id=int(e[8]),
                name=e[9],
            )
    return images


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            e = struct.unpack("<idddddddi", f.read(64))
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n2d)
            images[e[0]] = ColmapImage(
                image_id=e[0],
                qvec=np.asarray(e[1:5]),
                tvec=np.asarray(e[5:8]),
                camera_id=e[8],
                name=name.decode(),
            )
    return images


def read_cameras_text(path: str) -> dict[int, dict]:
    cams = {}
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            e = ln.split()
            cams[int(e[0])] = {
                "model": e[1], "width": int(e[2]), "height": int(e[3]),
                "params": np.asarray(e[4:], np.float64),
            }
    return cams


def read_cameras_binary(path: str) -> dict[int, dict]:
    models_nparams = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5,
                      8: 4, 9: 5, 10: 12}
    model_names = {0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL",
                   3: "RADIAL", 4: "OPENCV", 5: "OPENCV_FISHEYE",
                   6: "FULL_OPENCV", 7: "FOV", 8: "SIMPLE_RADIAL_FISHEYE",
                   9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE"}
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, model, w, h = struct.unpack("<iiQQ", f.read(24))
            k = models_nparams[model]
            params = struct.unpack("<" + "d" * k, f.read(8 * k))
            cams[cid] = {"model": model_names[model], "width": w,
                         "height": h, "params": np.asarray(params)}
    return cams


def intrinsics_from_camera(cam: dict) -> np.ndarray:
    """3x3 K from a PINHOLE/SIMPLE_PINHOLE camera record."""
    p = cam["params"]
    if cam["model"] == "SIMPLE_PINHOLE":
        f, cx, cy = p[:3]
        fx = fy = f
    else:
        fx, fy, cx, cy = p[:4]
    return np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
