"""The port's dataset-preparation tools against the JAX package's, on the
CPU: extract_geometry, render_semantic, fuse_segmentation, hdr2ldr and
process_images.

One 24 x 32 dataset written by the port's generator (3 train frames and 1
val frame, 398 faces): under 8,192 rays the JAX package takes its XLA walk,
the port the plain version of trace_union. Each package's arrays are taken
where its module hands them to write_exr. Tolerances, each stated again at
its comparison: the label tools' labels and fused labels equal on every
pixel and face and their EXRs the same bytes; the geometry within atol
1e-5 and its files within one half-float step of each other; hdr2ldr's and
process_images' files the same bytes."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from iris_tpu.geometry.bvh import build_bvh as jax_build_bvh
from iris_tpu.utils import extract_geometry as jgeom
from iris_tpu.utils import fuse_segmentation as jfuse
from iris_tpu.utils import hdr2ldr as jhdr
from iris_tpu.utils import process_images as jproc
from iris_tpu.utils import render_semantic as jsem
from iris_tpu_torch.data.datasets import SyntheticDataset
from iris_tpu_torch.data.make_demo_dataset import make_dataset
from iris_tpu_torch.geometry import intersect as tintersect
from iris_tpu_torch.geometry.bvh import build_bvh
from iris_tpu_torch.geometry.mesh import load_mesh
from iris_tpu_torch.utils import extract_geometry as tgeom
from iris_tpu_torch.utils import fuse_segmentation as tfuse
from iris_tpu_torch.utils import hdr2ldr as thdr
from iris_tpu_torch.utils import process_images as tproc
from iris_tpu_torch.utils import render_semantic as tsem
from iris_tpu_torch.utils.exr import read_exr, write_exr
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

HW = (24, 32)
N_TRAIN = 3


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools_ds"))
    make_dataset(root, img_hw=HW, n_train=N_TRAIN, n_val=1, spp=8,
                 indir_depth=1, seed=0, device="cpu")
    mesh = load_mesh(os.path.join(root, "scene.obj"))
    return {"root": root, "mesh": mesh,
            "jax_tracer": jax_build_bvh(mesh.triangles()),
            "tracer": build_bvh(mesh.triangles(), device="cpu"),
            "args": ["--dataset", "synthetic", "--scene", root,
                     "--ldr_img_dir", "ldr"]}


def _dataset(root, **kw):
    return SyntheticDataset(root, img_dir="ldr", split="train",
                            load_gt=False, **kw)


class capture_writes:
    """While active, every write_exr of `module` is recorded ({file name:
    float32 array}) and, with write=True, also written."""

    def __init__(self, monkeypatch, module, write=False):
        self.arrays = {}
        real = module.write_exr

        def record(path, img, *a, **k):
            self.arrays[os.path.basename(path)] = np.array(img, np.float32)
            if write:
                real(path, img, *a, **k)

        monkeypatch.setattr(module, "write_exr", record)


class count_traces:
    """Counts the port's traversal calls (geometry.intersect.ray_trace),
    which on a CUDA tensor each launch one kernel."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = tintersect.ray_trace

        def counting(*a, **k):
            self.calls += 1
            return real(*a, **k)

        monkeypatch.setattr(tintersect, "ray_trace", counting)


def _half_step(x):
    """One half-float step at |x| (the spacing of float16 there)."""
    return np.spacing(np.abs(x).astype(np.float16)).astype(np.float32)


# ------------------------------------------------------- extract_geometry

def test_extract_geometry_arrays_match_jax(demo, monkeypatch, tmp_path):
    """Positions, normals and depths of every frame within atol 1e-5; a
    miss is 0 in all three in both packages."""
    ds = _dataset(demo["root"])
    got = capture_writes(monkeypatch, tgeom)
    want = capture_writes(monkeypatch, jgeom)
    traces = count_traces(monkeypatch)
    tgeom.extract_geometry(demo["tracer"], ds, str(tmp_path / "port"))
    jgeom.extract_geometry(demo["jax_tracer"], ds, str(tmp_path / "jax"))
    assert traces.calls == N_TRAIN              # one traversal a frame
    names = [f"{i:03d}_{k}.exr" for i in range(N_TRAIN)
             for k in ("position", "normal", "depth")]
    assert sorted(got.arrays) == sorted(want.arrays) == sorted(names)
    for name in names:
        a, b = got.arrays[name], want.arrays[name]
        assert a.shape == b.shape == (HW + ((3,) if "depth" not in name
                                            else ()))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
    depth = got.arrays["000_depth.exr"]
    miss = np.all(got.arrays["000_normal.exr"] == 0, -1)
    assert np.isfinite(depth).all() and (depth >= 0).all()
    assert np.array_equal(depth == 0, miss)
    assert (~miss).mean() > 0.95


def test_extract_geometry_cli_files(demo, monkeypatch, tmp_path):
    """Both CLIs end to end: each port file reads back within half a
    half-float step of the array it was given (the half rounding), and
    within one step of the JAX package's file."""
    got = capture_writes(monkeypatch, tgeom, write=True)
    tgeom.main(demo["args"] + ["--output", str(tmp_path / "port"),
                               "--device", "cpu"])
    jgeom.main(demo["args"] + ["--output", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 3 * N_TRAIN
    for name in names:
        p = read_exr(str(tmp_path / "port" / name))
        j = read_exr(str(tmp_path / "jax" / name))
        a = got.arrays[name].reshape(p.shape)
        assert np.all(np.abs(p - a) <= 0.5 * _half_step(a)), name
        assert np.all(np.abs(p - j) <= _half_step(j)), name


# -------------------------------------------------------- render_semantic

# labels past the cap of the fusion, past 2048 (the half float's integer
# range) and past 65504 (its largest finite value), and -1
SPECIAL = np.array([-1, 0, 5, 127, 128, 2047, 2048, 2049, 2051, 4097,
                    65504, 70000], np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_render_semantic_matches_jax(demo, monkeypatch, tmp_path, seed):
    """Labels from a seeded draw (the special values included) equal on
    every pixel, -1 where the ray misses; the EXRs the same bytes."""
    n = demo["mesh"].n_faces
    rng = np.random.default_rng(seed)
    labels = rng.choice(np.concatenate([SPECIAL, rng.integers(
        -1, 5000, 64)]), n)
    ds = _dataset(demo["root"])
    got = capture_writes(monkeypatch, tsem, write=True)
    want = capture_writes(monkeypatch, jsem, write=True)
    traces = count_traces(monkeypatch)
    tsem.render_semantic(demo["tracer"], labels, ds, str(tmp_path / "p"))
    jsem.render_semantic(demo["jax_tracer"], labels, ds, str(tmp_path / "j"))
    assert traces.calls == N_TRAIN
    assert sorted(got.arrays) == [f"{i:03d}.exr" for i in range(N_TRAIN)]
    for name, a in got.arrays.items():
        assert np.array_equal(a, want.arrays[name]), name
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    # every label seen is the label of a face or -1 (a miss)
    seen = np.unique(got.arrays["000.exr"])
    assert set(seen.astype(np.int64)) <= set(labels) | {-1}


def test_render_semantic_cli_bytes_equal(demo, tmp_path):
    n = demo["mesh"].n_faces
    labels = (np.arange(n) // 12) % 128
    np.save(tmp_path / "labels.npy", labels)
    tsem.main(demo["args"] + ["--labels", str(tmp_path / "labels.npy"),
                              "--output", str(tmp_path / "p"),
                              "--device", "cpu"])
    jsem.main(demo["args"] + ["--labels", str(tmp_path / "labels.npy"),
                              "--output", str(tmp_path / "j")])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) and len(names) == 3
    for name in names:
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


def test_half_float_labels_past_2048(demo, tmp_path):
    """What the label maps' half-float format does to large labels, in
    both packages alike: every integer up to 2048 reads back, larger ones
    round to the half grid (to even on a tie), and past 65504 to inf."""
    n = demo["mesh"].n_faces
    ds = _dataset(demo["root"])
    cases = {2047: 2047, 2048: 2048, 2049: 2048, 2051: 2052, 4097: 4096,
             65504: 65504, 65519: 65504, 70000: np.inf}
    for label, back in cases.items():
        labels = np.full(n, label)
        tsem.render_semantic(demo["tracer"], labels, ds, str(tmp_path / "p"))
        jsem.render_semantic(demo["jax_tracer"], labels, ds,
                             str(tmp_path / "j"))
        p = read_exr(str(tmp_path / "p" / "000.exr"))[..., 0]
        j = read_exr(str(tmp_path / "j" / "000.exr"))[..., 0]
        assert np.array_equal(p, j)
        hit = p != -1
        assert hit.mean() > 0.95 and np.all(p[hit] == back), (label, back)


def test_render_semantic_refuses_short_labels(demo, tmp_path):
    """One label a face: the JAX gather clamps a short array's face ids
    to its last label; the port raises before it traces."""
    ds = _dataset(demo["root"])
    with pytest.raises(ValueError, match="one label a face"):
        tsem.render_semantic(demo["tracer"], np.zeros(10, np.int64), ds,
                             str(tmp_path / "p"))


# ------------------------------------------------------ fuse_segmentation

def _frames(ds, segs):
    return [{"rays": ds.frame(i)["rays"], "segmentation": s}
            for i, s in segs]


def test_has_part_without_a_part_layout_says_so(demo, tmp_path, capsys):
    """has_part asked of a split with no IndexMA directory reads the
    semantic segmentation, as before, and now prints one notice that
    names the missing directory (the JAX package falls back in silence).
    Where the directory is there, nothing is printed."""
    import shutil

    root = str(tmp_path / "ds")
    shutil.copytree(demo["root"], root,
                    ignore=shutil.ignore_patterns("IndexMA"))
    _dataset(demo["root"], load_inverse=True, has_part=True)
    assert "no part layout" not in capsys.readouterr().out
    ds = _dataset(root, load_inverse=True, has_part=True)
    out = capsys.readouterr().out
    missing = os.path.join(root, "train", "IndexMA")
    assert out.count("no part layout") == 1 and missing in out
    assert not ds.has_part
    ref = _dataset(demo["root"], load_inverse=True, has_part=False)
    for i in range(ds.n_frames):
        a, b = ds.frame(i), ref.frame(i)
        for k in ("rays", "rgbs", "segmentation", "int_albedo"):
            assert np.array_equal(a[k], b[k]), k


def _special_segs(ds, seed, n_labels):
    """Each train frame's rays with a seeded segmentation drawn from the
    labels that the fusion treats apart and that both packages read alike:
    -0.5, fractions, NaN (each truncates to a label) and labels up to the
    cap. A label outside [0, n_labels) after truncation casts no vote in
    the port and is clipped by the JAX package, so the pool leaves those
    out (test_fuse_segmentation_ties holds them)."""
    rng = np.random.default_rng(seed)
    pool = np.array([-1, -0.5, 0, 0.7, 1, 2, 3, 7.9, 15, 16, 17, 127, 128,
                     2049, 5000, np.inf, -np.inf, np.nan], np.float32)
    lab = tfuse.float_to_int32(torch.from_numpy(pool)).numpy()
    pool = pool[(lab >= 0) & (lab < n_labels)]
    hw = HW[0] * HW[1]
    return [(i, rng.choice(pool, hw).astype(np.float32))
            for i in range(ds.n_frames)]


@pytest.mark.parametrize("n_labels,seed", [(16, 0), (128, 1)])
def test_fuse_segmentation_matches_jax(demo, monkeypatch, tmp_path,
                                       n_labels, seed):
    """Fused labels equal on every face and the rewritten views on every
    pixel (their EXRs the same bytes), with two traversals a frame."""
    ds = _dataset(demo["root"])
    frames = _frames(ds, _special_segs(ds, seed, n_labels))
    n = demo["mesh"].n_faces
    traces = count_traces(monkeypatch)
    got = tfuse.fuse_segmentation(demo["tracer"], n, frames, n_labels)
    want = jfuse.fuse_segmentation(demo["jax_tracer"], n, frames, n_labels)
    assert got.dtype == np.int32 and got.shape == (n,)
    assert np.array_equal(got, np.asarray(want))
    assert (got >= 0).sum() > 0 and (got < 0).sum() > 0
    assert got.max() < n_labels
    wrote = capture_writes(monkeypatch, tfuse, write=True)
    jwrote = capture_writes(monkeypatch, jfuse, write=True)
    tfuse.rewrite_views(demo["tracer"], got, frames, str(tmp_path / "p"),
                        HW)
    jfuse.rewrite_views(demo["jax_tracer"], want, frames,
                        str(tmp_path / "j"), HW)
    assert traces.calls == 2 * len(frames)
    for name, a in wrote.arrays.items():
        assert np.array_equal(a, jwrote.arrays[name]), name
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


@pytest.mark.parametrize("first,second,winner", [
    (7, 3, 3), (3, 7, 3), (-1, 3, 3), (7.5, -1, 7), (20, 16, -1)])
def test_fuse_segmentation_ties(demo, first, second, winner):
    """One frame's rays twice with two labels: where both lie in [0, 16),
    every face it sees has as many votes for each and takes the lower
    label (the first maximum), whichever frame came first, as in the JAX
    package. A label outside [0, 16) casts no vote: -1 beside 3 leaves 3,
    -1 beside 7.5 leaves 7, and 20 beside 16 leaves every face unobserved
    (-1). The JAX package clips those labels instead, to 0 and 15."""
    ds = _dataset(demo["root"])
    hw = HW[0] * HW[1]
    frames = _frames(ds, [(0, np.full(hw, first, np.float32)),
                          (0, np.full(hw, second, np.float32))])
    n = demo["mesh"].n_faces
    got = tfuse.fuse_segmentation(demo["tracer"], n, frames, 16)
    want = np.asarray(jfuse.fuse_segmentation(demo["jax_tracer"], n,
                                              frames, 16))
    seen = want >= 0
    assert seen.sum() > 10
    if winner == -1:
        assert np.all(got == -1)
    else:
        assert np.array_equal(got >= 0, seen)
        assert np.all(got[seen] == winner)
    if min(first, second) >= 0 and max(first, second) < 16:
        assert np.array_equal(got, want)
    else:
        assert np.all(want[seen] == min(np.clip(int(first), 0, 15),
                                        np.clip(int(second), 0, 15)))


def test_fuse_segmentation_cli(demo, monkeypatch, tmp_path):
    """Both CLIs end to end on the generator's part maps: the same bytes,
    and the observed faces carry their own part id (face // 12 % 16) on
    more than 90% of them, as tests/test_data_tools.py asks of the JAX
    tool; fused twice, the same labels."""
    fused = []
    real = tfuse.fuse_segmentation
    monkeypatch.setattr(tfuse, "fuse_segmentation",
                        lambda *a: fused.append(real(*a)) or fused[-1])
    tfuse.main(demo["args"] + ["--output", str(tmp_path / "p"),
                               "--device", "cpu"])
    jfuse.main(demo["args"] + ["--output", str(tmp_path / "j")])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) and len(names) == 3
    for name in names:
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    labels = fused[0]
    seen = np.flatnonzero(labels >= 0)
    assert len(seen) > 0
    assert (labels[seen] == (seen // 12) % 16).mean() > 0.9
    ds = _dataset(demo["root"], load_inverse=True)
    again = real(demo["tracer"], demo["mesh"].n_faces, ds.frames(), 128)
    assert np.array_equal(again, labels)


def test_float_to_int32_is_xla_conversion():
    """The labels' float-to-int conversion equals JAX's .astype(int32)
    (XLA's: truncation, NaN to 0, saturation) on every special value."""
    x = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.0 ** 31,
                  -2.0 ** 31, -0.5, -1.5, 0.99, 2049.7, 65504.0],
                 np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = tfuse.float_to_int32(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


# ----------------------------------------------------------------- hdr2ldr

def _files_equal(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _files_equal(pa, pb)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), pa
    return names


@pytest.mark.parametrize("seed", [0, 3])
def test_hdr2ldr_bytes_equal_and_loadable(demo, seed):
    """The demo's train renders through both packages: cam/crf.npy,
    cam/exposure.npy and every PNG the same bytes; the port's directory
    loads back as the dataset's LDR images with its cam/ files."""
    split = os.path.join(demo["root"], "train")
    src = os.path.join(split, "Image")
    tgt = os.path.join(split, f"ldr_port_{seed}")
    thdr.main(["--dir_src", src, "--dir_tgt", tgt, "--seed", str(seed)])
    jhdr.main(["--dir_src", src, "--dir_tgt",
               os.path.join(split, f"ldr_jax_{seed}"), "--seed", str(seed)])
    names = _files_equal(tgt, os.path.join(split, f"ldr_jax_{seed}"))
    assert names == ["000_0001.png", "001_0001.png", "002_0001.png", "cam"]
    ds = SyntheticDataset(demo["root"], img_dir=f"ldr_port_{seed}",
                          split="train", load_gt=False)
    assert ds.exposures.shape == (N_TRAIN,) and ds.crfs.shape == (3, 1024)
    rgbs = ds.frame(0)["rgbs"]
    assert rgbs.shape == (HW[0] * HW[1], 3) and 0 < rgbs.mean() <= 1


@pytest.mark.parametrize("n_images", [4, 12])
def test_hdr2ldr_exposure_bins(tmp_path, n_images):
    """More images than exposure levels: the brightest get the smallest
    exposure, in bins of n // 5, the rest the last level; the same bytes
    as the JAX package's."""
    rng = np.random.default_rng(n_images)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(n_images):
        write_exr(str(src / f"{i:03d}_0001.exr"),
                  rng.uniform(0, 2 * (i + 1) / n_images, (6, 8, 3)))
    (src / "notes.txt").write_text("not an EXR")
    curves = thdr.sample_crfs(5)
    assert np.array_equal(curves, jhdr.sample_crfs(5))
    thdr.convert(str(src), str(tmp_path / "p"), curves)
    jhdr.convert(str(src), str(tmp_path / "j"), curves)
    _files_equal(str(tmp_path / "p"), str(tmp_path / "j"))
    exp = np.load(tmp_path / "p" / "cam" / "exposure.npy")
    assert exp.shape == (n_images,) and set(exp) <= {4, 2, 1, 0.5, 0.25}


# ---------------------------------------------------------- process_images

def _images(d, seed):
    rng = np.random.default_rng(seed)
    d.mkdir()
    Image.fromarray(rng.integers(0, 256, (60, 200, 3), np.uint8)).save(
        d / "a.png")
    Image.fromarray(rng.integers(0, 256, (30, 40, 3), np.uint8)).save(
        d / "b.png")
    Image.fromarray(rng.integers(0, 16, (90, 301), np.uint8)).save(
        d / "c_labels.png")
    Image.fromarray(rng.integers(0, 256, (41, 150, 4), np.uint8)).save(
        d / "d.png")
    Image.fromarray(rng.integers(0, 256, (50, 120, 3), np.uint8)).save(
        d / "e.jpg", quality=90)


@pytest.mark.parametrize("nearest", [False, True])
def test_process_images_bytes_equal(tmp_path, nearest):
    _images(tmp_path / "in", 0)
    flag = ["--nearest"] if nearest else []
    argv = ["--input", str(tmp_path / "in"), "--max_width", "100"] + flag
    tproc.main(argv + ["--output", str(tmp_path / "p")])
    jproc.main(argv + ["--output", str(tmp_path / "j")])
    names = _files_equal(str(tmp_path / "p"), str(tmp_path / "j"))
    assert names == ["a.png", "b.png", "c_labels.png", "d.png", "e.jpg"]
    a = np.asarray(Image.open(tmp_path / "p" / "a.png"))
    assert a.shape == (30, 100, 3)
    b = np.asarray(Image.open(tmp_path / "p" / "b.png"))
    assert np.array_equal(b, np.asarray(Image.open(tmp_path / "in" /
                                                   "b.png")))
    if nearest:   # no label a mask did not hold
        c = np.asarray(Image.open(tmp_path / "p" / "c_labels.png"))
        assert c.shape == (29, 100) and c.max() < 16


def test_process_images_skips_directories_and_non_images(tmp_path, capsys):
    _images(tmp_path / "in", 1)
    (tmp_path / "in" / "cam").mkdir()
    (tmp_path / "in" / "notes.txt").write_text("not an image")
    tproc.main(["--input", str(tmp_path / "in"), "--output",
                str(tmp_path / "p"), "--max_width", "100"])
    assert sorted(os.listdir(tmp_path / "p")) == [
        "a.png", "b.png", "c_labels.png", "d.png", "e.jpg"]
    assert "wrote 5 images" in capsys.readouterr().out


def test_process_images_raises_on_a_damaged_image(tmp_path):
    """The narrowed catch: a file PIL identifies but cannot read (a
    truncated PNG) raises in the port; the JAX tool drops it silently."""
    _images(tmp_path / "in", 2)
    whole = (tmp_path / "in" / "a.png").read_bytes()
    (tmp_path / "in" / "a.png").write_bytes(whole[: len(whole) // 2])
    argv = ["--input", str(tmp_path / "in"), "--max_width", "100"]
    with pytest.raises(OSError):
        tproc.main(argv + ["--output", str(tmp_path / "p")])
    jproc.main(argv + ["--output", str(tmp_path / "j")])
    assert "a.png" not in os.listdir(tmp_path / "j")
