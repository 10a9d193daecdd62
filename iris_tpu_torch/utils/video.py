"""Video assembly utilities (frames <-> mp4, transitions, overlays;
counterpart of iris_tpu/utils/video.py).

Parity surface: reference utils/video.py:1-215 — extract_frames,
read_video_frames, generate_video (frames-dir -> mp4 with boomerang),
add_text (label box overlay), switch_video (animated diagonal wipe
between two videos), merge_video (side-by-side), loop (boomerang) —
without the cv2 dependency: PIL for images and text, and every function
accepts and produces either an .mp4 or a frames directory of numbered
PNGs.

The writer's backend is chosen before writing, not by catching its
failure (the JAX package catches any exception of imageio and writes the
frames instead): an mp4 when imageio and its ffmpeg plugin
(imageio_ffmpeg) import, else a `<name>_frames/` directory; write_video
prints which, and an error inside the chosen writer raises.

CLI parity (reference runs these as editable __main__ entry points):
    python -m iris_tpu_torch.utils.video generate -dir F/ -out v.mp4 [-fps 30]
    python -m iris_tpu_torch.utils.video extract -video v.mp4 -outdir F/
    python -m iris_tpu_torch.utils.video merge -first a -second b -out o \
        [-axis 0]
    python -m iris_tpu_torch.utils.video switch --video_in a b --video_out o \
        --mid 320 [--slope 1.0 --window 30 --flip]
    python -m iris_tpu_torch.utils.video add_text --video_in a --video_out o \
        --text label [--right --bottom --font_size 2.0]
    python -m iris_tpu_torch.utils.video loop --video_in a --video_out o
"""

from __future__ import annotations

import argparse
import os

import numpy as np

_IMAGE_EXTS = (".jpg", ".png", ".JPG", ".PNG")


def _to_uint8(frame: np.ndarray) -> np.ndarray:
    f = np.asarray(frame)
    if f.dtype != np.uint8:
        f = (np.clip(f, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = f.shape[:2]
    return f[: h - h % 2, : w - w % 2]  # even dims for yuv420p


def is_image_name(name: str) -> bool:
    return name.endswith(_IMAGE_EXTS)


def video_backend() -> str:
    """"mp4" when imageio and its ffmpeg plugin import, else "frames"."""
    try:
        import imageio  # noqa: F401
        import imageio_ffmpeg  # noqa: F401
    except ImportError:
        return "frames"
    return "mp4"


def write_video(path: str, frames, fps: int = 30) -> str:
    """frames: iterable of (H, W, 3) float [0,1] or uint8 arrays. Writes
    an mp4 through imageio's ffmpeg plugin where it imports, else a
    `<path>_frames/` PNG directory (readable back by read_video_frames),
    and prints which. Returns the path written."""
    frames = [_to_uint8(f) for f in frames]
    backend = video_backend()
    if backend == "mp4":
        import imageio

        imageio.mimwrite(path, frames, fps=fps, codec="libx264",
                         output_params=["-pix_fmt", "yuv420p"])
        out = path
    else:
        from PIL import Image

        out = os.path.splitext(path)[0] + "_frames"
        os.makedirs(out, exist_ok=True)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(out, f"{i:05d}.png"))
        with open(os.path.join(out, "INDEX.txt"), "w") as fh:
            fh.write(f"{len(frames)} frames @ {fps} fps (no ffmpeg backend)\n")
    print(f"[video] {backend}: {len(frames)} frames -> {out}")
    return out


def read_video_frames(path: str) -> list[np.ndarray]:
    """Reference read_video_frames (:36-49): returns RGB uint8 frames.
    Accepts an .mp4 (imageio backend) OR a frames directory (the
    write_video fallback / extract_frames output). Raises
    FileNotFoundError where there is no frame to return: an empty frames
    directory, or an empty or undecodable video (the JAX package returns
    an empty list)."""
    if os.path.isdir(path):
        from PIL import Image

        names = sorted(n for n in os.listdir(path) if is_image_name(n))
        if not names:
            raise FileNotFoundError(f"no frames in {path}")
        return [np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
                for n in names]
    frames_dir = os.path.splitext(path)[0] + "_frames"
    if not os.path.exists(path) and os.path.isdir(frames_dir):
        return read_video_frames(frames_dir)
    import imageio

    reader = imageio.get_reader(path)
    frames = [np.asarray(f)[..., :3] for f in reader]
    reader.close()
    if not frames:
        raise FileNotFoundError(f"no frames decoded from {path}")
    return frames


def extract_frames(video: str, outdir: str) -> int:
    """Reference extract_frames (:19-34): video -> numbered PNGs."""
    os.makedirs(outdir, exist_ok=True)
    from PIL import Image

    frames = read_video_frames(video)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(outdir, f"{i:0>5d}.png"))
    return len(frames)


def frames_dir_to_video(frames_dir: str, out: str, fps: int = 30,
                        boomerang: bool = True) -> str:
    """Reference generate_video (:57-70): sorted images in a directory ->
    mp4, appending the reversed sequence (boomerang) like the reference."""
    frames = read_video_frames(frames_dir)
    if boomerang:
        frames = frames + frames[::-1]
    return write_video(out, frames, fps=fps)


def loop_video(video_in: str, video_out: str, fps: int = 30) -> str:
    """Reference loop (:195-205): forward + reversed playback."""
    frames = read_video_frames(video_in)
    return write_video(video_out, frames + frames[::-1], fps=fps)


def side_by_side(a: np.ndarray, b: np.ndarray, axis: int = 1) -> np.ndarray:
    return np.concatenate([a, b], axis=axis)


def merge_videos(first: str, second: str, out: str, axis: int = 0,
                 fps: int = 30) -> str:
    """Reference merge_video (:169-193): concatenate two videos frame by
    frame along `axis` (0 = stacked, 1 = side by side)."""
    fa = read_video_frames(first)
    fb = read_video_frames(second)
    n = min(len(fa), len(fb))
    return write_video(out, [np.concatenate([fa[i], fb[i]], axis=axis)
                             for i in range(n)], fps=fps)


def wipe(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Left-to-right wipe transition at fraction t in [0,1]."""
    w = a.shape[1]
    cut = int(w * t)
    out = a.copy()
    out[:, cut:] = b[:, cut:]
    return out


def switch_videos(video_a: str, video_b: str, out: str, mid: int,
                  slope: float = 1.0, window: int = 30,
                  linewidth: int = 0, flip: bool = False,
                  fps: int = 30) -> str:
    """Reference switch_video (:122-167): an animated diagonal wipe — a
    line of slope `slope` sweeps across over `window` frames centred on
    frame `mid`, revealing video B over video A (A where the sweep has
    not reached). `linewidth` draws a black divider on the sweep line."""
    fa = read_video_frames(video_a)
    fb = read_video_frames(video_b)
    n = min(len(fa), len(fb))
    h, w = fa[0].shape[:2]
    v_start = 0.0
    v_end = (w - 1) + (h - 1) * slope
    v_slope = (v_end - v_start) / window
    if flip:
        v_slope *= -1
    v_const = (v_end + v_start) / 2 - mid * v_slope
    gy, gx = np.meshgrid(np.arange(w), np.arange(h))
    grid_value = gy + gx * slope
    frames = []
    for i in range(n):
        thr = i * v_slope + v_const
        mask = grid_value > thr
        f = np.where(mask[..., None], fa[i], fb[i])
        if linewidth > 0:
            f = np.where((np.abs(grid_value - thr)
                          <= linewidth / 2)[..., None], 0, f)
        frames.append(f.astype(np.uint8))
    return write_video(out, frames, fps=fps)


def add_text(video_in: str, video_out: str, text: str,
             font_size: float = 2.0, right: bool = False,
             bottom: bool = False, fps: int = 30) -> str:
    """Reference add_text (:76-120): burn a white-on-black label box
    into a corner of every frame. PIL instead of cv2.putText; font_size
    2.0 ~ the reference's HERSHEY scale (~55 px line height)."""
    from PIL import Image, ImageDraw, ImageFont

    frames = read_video_frames(video_in)
    h, w = frames[0].shape[:2]
    px = int(28 * font_size)
    try:
        font = ImageFont.truetype(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf", px)
    except OSError:   # the font file is missing
        font = ImageFont.load_default()
    probe = ImageDraw.Draw(Image.new("RGB", (8, 8)))
    tbox = probe.textbbox((0, 0), text, font=font)
    tw, th = tbox[2] - tbox[0], tbox[3] - tbox[1]
    border, buf = 10, 30
    x, y = border, border
    x2, y2 = x + tw + buf, y + th + buf
    if right:
        x2 = w - border
        x = x2 - tw - buf
    if bottom:
        y2 = h - border
        y = y2 - th - buf
    out = []
    for f in frames:
        img = Image.fromarray(f)
        draw = ImageDraw.Draw(img)
        draw.rectangle([x, y, x2, y2], fill=(0, 0, 0))
        draw.text((x + buf // 2 - tbox[0], y + buf // 2 - tbox[1]), text,
                  fill=(255, 255, 255), font=font)
        out.append(np.asarray(img))
    return write_video(video_out, out, fps=fps)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="iris_tpu_torch.utils.video")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate")
    g.add_argument("-dir", dest="dir", required=True)
    g.add_argument("-out", dest="out", required=True)
    g.add_argument("-fps", type=int, default=30)

    e = sub.add_parser("extract")
    e.add_argument("-video", required=True)
    e.add_argument("-outdir", required=True)

    m = sub.add_parser("merge")
    m.add_argument("-first", required=True)
    m.add_argument("-second", required=True)
    m.add_argument("-out", required=True)
    m.add_argument("-axis", type=int, default=0)
    m.add_argument("-fps", type=int, default=30)

    s = sub.add_parser("switch")
    s.add_argument("--video_in", nargs=2, required=True)
    s.add_argument("--video_out", required=True)
    s.add_argument("--mid", type=int, required=True)
    s.add_argument("--slope", type=float, default=1.0)
    s.add_argument("--window", type=int, default=30)
    s.add_argument("--linewidth", type=int, default=0)
    s.add_argument("--flip", action="store_true")
    s.add_argument("-fps", type=int, default=30)

    t = sub.add_parser("add_text")
    t.add_argument("--video_in", required=True)
    t.add_argument("--video_out", required=True)
    t.add_argument("--text", required=True)
    t.add_argument("--font_size", type=float, default=2.0)
    t.add_argument("--right", action="store_true")
    t.add_argument("--bottom", action="store_true")
    t.add_argument("--fps", type=int, default=30)

    lp = sub.add_parser("loop")
    lp.add_argument("--video_in", required=True)
    lp.add_argument("--video_out", required=True)
    lp.add_argument("-fps", type=int, default=30)

    a = p.parse_args(argv)
    if a.cmd == "generate":
        frames_dir_to_video(a.dir, a.out, fps=a.fps)
    elif a.cmd == "extract":
        extract_frames(a.video, a.outdir)
    elif a.cmd == "merge":
        merge_videos(a.first, a.second, a.out, axis=a.axis, fps=a.fps)
    elif a.cmd == "switch":
        switch_videos(a.video_in[0], a.video_in[1], a.video_out, a.mid,
                      a.slope, a.window, a.linewidth, a.flip, a.fps)
    elif a.cmd == "add_text":
        add_text(a.video_in, a.video_out, a.text, a.font_size, a.right,
                 a.bottom, a.fps)
    elif a.cmd == "loop":
        loop_video(a.video_in, a.video_out, fps=a.fps)


if __name__ == "__main__":
    main()
