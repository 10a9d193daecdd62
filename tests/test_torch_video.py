"""utils/gen_path.py and utils/video.py of the PyTorch port against the
JAX package's: the trajectory helpers bit for bit, write_video's frames
directory and every command of the video CLI giving the same PNG bytes,
and the writer's explicit backend choice (an mp4 only where imageio and
its ffmpeg plugin import; an error inside the chosen writer raises)."""

import os
import sys
import types

import numpy as np
import pytest

from iris_tpu.utils import gen_path as JG
from iris_tpu.utils import video as JV
from iris_tpu_torch.utils import gen_path as TG
from iris_tpu_torch.utils import video as TV


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pos = rng.uniform(-1, 1, 3)
        out.append(TG.viewmatrix(-pos + rng.normal(0, 0.1, 3),
                                 np.asarray([0.0, 0.0, 1.0]), pos))
    return np.stack(out).astype(np.float32)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,n_interp", [(2, 3), (3, 2), (7, 4)])
def test_generate_interpolated_path_same_bits(n, n_interp):
    poses = _poses(n, seed=n)
    _same(TG.generate_interpolated_path(poses, n_interp),
          JG.generate_interpolated_path(poses, n_interp))


def test_pose_helpers_same_bits():
    poses = _poses(6, seed=3).astype(np.float64)
    pts = np.random.default_rng(2).normal(0, 1, (50, 3))
    _same(TG.average_pose(poses), JG.average_pose(poses))
    _same(TG.average_poses(poses), JG.average_poses(poses))
    _same(TG.average_poses(poses, pts), JG.average_poses(poses, pts))
    _same(TG.center_poses(poses), JG.center_poses(poses))
    for a, b in zip(TG.center_poses(poses, pts), JG.center_poses(poses, pts)):
        _same(a, b)
    _same(TG.create_spheric_poses(1.5, 0.4, 12),
          JG.create_spheric_poses(1.5, 0.4, 12))


def _frames(n=4, h=16, w=20, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
            for _ in range(n)]


def _tree_bytes(path):
    """{relative name: bytes} of every file under path (or of path)."""
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return {"": f.read()}
    out = {}
    for dirpath, _, files in os.walk(path):
        for n in files:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def test_write_video_frames_same_bytes(tmp_path, capsys):
    frames = _frames(5, h=17, w=21)     # odd sizes: both crop to even
    want = JV.write_video(str(tmp_path / "j" / "v.mp4"), frames, fps=24)
    got = TV.write_video(str(tmp_path / "t" / "v.mp4"), frames, fps=24)
    assert os.path.basename(got) == os.path.basename(want)
    assert _tree_bytes(got) == _tree_bytes(want)
    if TV.video_backend() == "frames":
        assert "[video] frames: 5 frames" in capsys.readouterr().out


def _run_both(tmp_path, argv_of):
    """Run one video command in each package on copies of the same
    inputs; returns {package: bytes of every file written}."""
    out = {}
    for tag, module in (("j", JV), ("t", TV)):
        d = tmp_path / tag
        d.mkdir()
        a = JV.write_video(str(d / "a.mp4"), _frames(4, seed=1), fps=30)
        b = JV.write_video(str(d / "b.mp4"), _frames(6, seed=2), fps=30)
        before = set(os.listdir(d))
        module.main(argv_of(str(d), a, b))
        out[tag] = {n: _tree_bytes(str(d / n))
                    for n in sorted(set(os.listdir(d)) - before)}
    assert out["t"] and out["t"] == out["j"]
    return out["t"]


@pytest.mark.parametrize("cmd", [
    lambda d, a, b: ["generate", "-dir", a, "-out", f"{d}/g.mp4"],
    lambda d, a, b: ["extract", "-video", a, "-outdir", f"{d}/x"],
    lambda d, a, b: ["merge", "-first", a, "-second", b, "-out",
                     f"{d}/m.mp4", "-axis", "1"],
    lambda d, a, b: ["switch", "--video_in", a, b, "--video_out",
                     f"{d}/s.mp4", "--mid", "2", "--window", "3",
                     "--linewidth", "2", "--flip"],
    lambda d, a, b: ["add_text", "--video_in", a, "--video_out",
                     f"{d}/t.mp4", "--text", "GT", "--font_size", "0.3",
                     "--right", "--bottom"],
    lambda d, a, b: ["loop", "--video_in", b, "--video_out", f"{d}/l.mp4"],
], ids=["generate", "extract", "merge", "switch", "add_text", "loop"])
def test_video_commands_same_bytes(tmp_path, cmd):
    _run_both(tmp_path, cmd)


def test_read_video_frames_resolves_the_frames_directory(tmp_path):
    frames = _frames(3)
    TV.write_video(str(tmp_path / "a.mp4"), frames)
    if TV.video_backend() == "frames":
        back = TV.read_video_frames(str(tmp_path / "a.mp4"))
        assert len(back) == 3 and back[0].dtype == np.uint8


def test_read_video_frames_raises_on_an_empty_directory(tmp_path):
    """No frame to return is an error, not an empty list (the JAX package
    returns [] and the caller fails later on frames[0])."""
    (tmp_path / "empty_frames").mkdir()
    with pytest.raises(FileNotFoundError, match="no frames"):
        TV.read_video_frames(str(tmp_path / "empty_frames"))
    with pytest.raises(FileNotFoundError, match="no frames"):
        TV.read_video_frames(str(tmp_path / "empty.mp4"))
    assert JV.read_video_frames(str(tmp_path / "empty_frames")) == []


def _fake_imageio(monkeypatch, mimwrite):
    fake = types.ModuleType("imageio")
    fake.mimwrite = mimwrite
    monkeypatch.setitem(sys.modules, "imageio", fake)
    monkeypatch.setitem(sys.modules, "imageio_ffmpeg",
                        types.ModuleType("imageio_ffmpeg"))


def test_mp4_backend_when_the_plugin_imports(tmp_path, monkeypatch):
    calls = []
    _fake_imageio(monkeypatch, lambda path, frames, **kw: calls.append(
        (path, len(frames), kw)))
    assert TV.video_backend() == "mp4"
    path = str(tmp_path / "v.mp4")
    assert TV.write_video(path, _frames(3), fps=12) == path
    assert calls == [(path, 3, {"fps": 12, "codec": "libx264",
                                "output_params": ["-pix_fmt", "yuv420p"]})]
    assert not os.path.exists(str(tmp_path / "v_frames"))


def test_an_error_in_the_chosen_writer_raises(tmp_path, monkeypatch):
    """The JAX package would write the frames instead (except Exception,
    iris_tpu/utils/video.py:53); the port lets the error through."""
    def broken(path, frames, **kw):
        raise OSError("ffmpeg failed")

    _fake_imageio(monkeypatch, broken)
    with pytest.raises(OSError, match="ffmpeg failed"):
        TV.write_video(str(tmp_path / "v.mp4"), _frames(2))
    assert not os.path.exists(str(tmp_path / "v_frames"))


def test_frames_backend_without_the_plugin(monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio_ffmpeg", None)
    assert TV.video_backend() == "frames"
