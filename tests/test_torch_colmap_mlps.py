"""The port's COLMAP readers, implicit MLP, timing and profiling helpers on
the CPU: the readers against the JAX package's on text and binary files
written here (unsorted ids included); positional_encoding and the implicit
MLP against JAX through convert.implicit_mlp within rtol 1e-5 (for values
near 0, the encoding within atol 1e-6, where float32 sines of arguments up
to 2^9 pi differ in the last bits, and the MLP within 1e-5 of its output's
largest magnitude, its sums adding in another order); apply_mlp's bf16
path bit for bit as it was; device_trace writing a trace; and what the
timing helpers do that a CPU can check (the card's events faked)."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.data import colmap as jcolmap
from iris_tpu.models import mlps as jmlps
from iris_tpu.models.mlp import apply_mlp as jax_apply_mlp
from iris_tpu_torch import convert
from iris_tpu_torch.data import colmap as tcolmap
from iris_tpu_torch.models import mlps as tmlps
from iris_tpu_torch.models.mlp import apply_mlp, init_mlp
from iris_tpu_torch.utils import profiling, timing
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

# ------------------------------------------------------------------ COLMAP


def _write_text(tmp_path):
    imgs = tmp_path / "images.txt"
    imgs.write_text(
        "# Image list with two lines of data per image:\n"
        "12 0.8 0.1 -0.3 0.5 0.5 1.5 2.5 3 frame_012.jpg\n"
        "10 20 -1 11.5 3.0 7\n"
        "2 0.7071 0.7071 0 0 0 0 1 1 frame_001.jpg\n"
        "1.0 2.0 -1\n"
        "\n"
        "7 1 0 0 0 -1 -2 -3 3 frame_007.jpg\n"
        "5 6 -1\n")
    cams = tmp_path / "cameras.txt"
    cams.write_text("# Camera list\n"
                    "3 PINHOLE 640 480 500 510 320 240\n"
                    "1 SIMPLE_PINHOLE 1752 1168 1400.5 876 584\n"
                    "\n")
    return str(imgs), str(cams)


def _write_binary(tmp_path, seed):
    rng = np.random.default_rng(seed)
    cam_path = str(tmp_path / "cameras.bin")
    cams = [(7, 1, (500.0, 505.0, 320.0, 240.0)), (2, 0, (900.0, 10, 20)),
            (41, 4, tuple(rng.normal(size=8)))]     # unsorted, gaps
    with open(cam_path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, model, params in cams:
            f.write(struct.pack("<iiQQ", cid, model, 640 + cid, 480))
            f.write(struct.pack("<" + "d" * len(params), *params))
    img_path = str(tmp_path / "images.bin")
    ids = [9, 3, 27]
    with open(img_path, "wb") as f:
        f.write(struct.pack("<Q", len(ids)))
        for n2d, iid in enumerate(ids):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<idddddddi", iid, *q, *rng.normal(size=3),
                                7))
            f.write(f"frame_{iid}.jpg".encode() + b"\x00")
            f.write(struct.pack("<Q", n2d))
            for _ in range(n2d):
                f.write(struct.pack("<ddq", 1.0, 2.0, -1))
    return img_path, cam_path


def _same_images(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert (g.image_id, g.camera_id, g.name) == (w.image_id, w.camera_id,
                                                     w.name)
        assert np.array_equal(g.qvec, w.qvec) and np.array_equal(g.tvec,
                                                                 w.tvec)
        assert np.array_equal(g.rotmat(), w.rotmat())
        assert g.c2w().dtype == np.float32
        assert np.array_equal(g.c2w(), w.c2w())


def _same_cameras(got, want):
    assert list(got) == list(want)
    for k in want:
        assert {f: v for f, v in got[k].items() if f != "params"} == {
            f: v for f, v in want[k].items() if f != "params"}
        assert np.array_equal(got[k]["params"], want[k]["params"])


def test_colmap_text_readers_match_jax(tmp_path):
    imgs, cams = _write_text(tmp_path)
    got, want = tcolmap.read_images_text(imgs), jcolmap.read_images_text(imgs)
    assert sorted(got) == [2, 7, 12]
    _same_images(got, want)
    # identity rotation: c2w translation = -t
    assert np.allclose(got[7].c2w()[:, 3], [1, 2, 3])
    _same_cameras(tcolmap.read_cameras_text(cams),
                  jcolmap.read_cameras_text(cams))


def test_colmap_text_reader_takes_an_image_without_points(tmp_path):
    """An image with no 2D points has an empty second line. The port reads
    it and every image after it; the JAX package drops empty lines before
    it pairs the records, and reads them out of step."""
    imgs = tmp_path / "images.txt"
    imgs.write_text(
        "# Image list with two lines of data per image:\n"
        "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
        "4 1 0 0 0 1 2 3 1 frame_004.jpg\n"
        "10.0 20.0 -1 11.5 3.0 7\n"
        "5 0 1 0 0 4 5 6 2 frame_005.jpg\n"
        "\n"
        "6 0 0 1 0 7 8 9 1 frame_006.jpg\n"
        "1.0 2.0 -1\n")
    got = tcolmap.read_images_text(str(imgs))
    assert sorted(got) == [4, 5, 6]
    for iid, cam, q, t in ((4, 1, [1, 0, 0, 0], [1, 2, 3]),
                           (5, 2, [0, 1, 0, 0], [4, 5, 6]),
                           (6, 1, [0, 0, 1, 0], [7, 8, 9])):
        im = got[iid]
        assert (im.camera_id, im.name) == (cam, f"frame_{iid:03d}.jpg")
        assert np.array_equal(im.qvec, q) and np.array_equal(im.tvec, t)


@pytest.mark.parametrize("seed", [0, 1])
def test_colmap_binary_readers_unsorted_ids(tmp_path, seed):
    imgs, cams = _write_binary(tmp_path, seed)
    got = tcolmap.read_images_binary(imgs)
    assert list(got) == [9, 3, 27] and got[27].name == "frame_27.jpg"
    _same_images(got, jcolmap.read_images_binary(imgs))
    cams_got = tcolmap.read_cameras_binary(cams)
    assert list(cams_got) == [7, 2, 41]
    assert [c["model"] for c in cams_got.values()] == [
        "PINHOLE", "SIMPLE_PINHOLE", "OPENCV"]
    _same_cameras(cams_got, jcolmap.read_cameras_binary(cams))


@pytest.mark.parametrize("model,params", [
    ("PINHOLE", [500.0, 510.0, 320.0, 240.0]),
    ("SIMPLE_PINHOLE", [1400.5, 876.0, 584.0]),
    ("OPENCV", [600.0, 601.0, 300.0, 200.0, 0.1, -0.01, 0.0, 0.0])])
def test_intrinsics_and_rotations_match_jax(model, params):
    cam = {"model": model, "width": 1, "height": 1,
           "params": np.asarray(params)}
    k = tcolmap.intrinsics_from_camera(cam)
    assert k.dtype == np.float32
    assert np.array_equal(k, jcolmap.intrinsics_from_camera(cam))
    rng = np.random.default_rng(len(params))
    for _ in range(4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r = tcolmap.qvec2rotmat(q)
        assert np.array_equal(r, jcolmap.qvec2rotmat(q))
        assert np.allclose(r @ r.T, np.eye(3), atol=1e-12)
        assert np.isclose(np.linalg.det(r), 1.0)


# ------------------------------------------------------------ implicit MLP

def _points(seed, n=257):
    return np.random.default_rng(seed).uniform(
        -1.1, 2.1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("n_freqs,include_input", [(4, True), (10, True),
                                                   (10, False)])
def test_positional_encoding_matches_jax(n_freqs, include_input):
    x = _points(n_freqs)
    got = tmlps.positional_encoding(torch.from_numpy(x), n_freqs,
                                    include_input).numpy()
    want = np.asarray(jmlps.positional_encoding(jnp.asarray(x), n_freqs,
                                                include_input))
    assert got.shape == want.shape == (len(x), 3 * (int(include_input)
                                                    + 2 * n_freqs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _jax_mlp(seed, **kw):
    params = jmlps.init_implicit_mlp(jax.random.PRNGKey(seed), **kw)
    port = convert.implicit_mlp(
        [np.asarray(w) for w in params["trunk"]["w"]],
        [np.asarray(b) for b in params["trunk"]["b"]],
        [np.asarray(w) for w in params["head"]["w"]],
        [np.asarray(b) for b in params["head"]["b"]],
        params["n_freqs"], device="cpu")
    return params, port


@pytest.mark.parametrize("seed,kw", [
    (0, dict(width=64, depth=4, skip_at=2, n_freqs=6)),
    (1, dict()),                       # the JAX defaults: 256 wide, 8 deep
    (2, dict(in_dim=2, out_dim=3, width=32, depth=3, skip_at=1,
             n_freqs=4))])
def test_implicit_mlp_matches_jax(seed, kw):
    params, port = _jax_mlp(seed, **kw)
    x = _points(seed)[:, :kw.get("in_dim", 3)]
    want = np.asarray(jmlps.apply_implicit_mlp(params, jnp.asarray(x)))
    got = tmlps.apply_implicit_mlp(port, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (len(x), kw.get("out_dim", 5))
    # float32 sums of up to 319 products a layer, in another order: rtol
    # 1e-5, and for values near 0 1e-5 of the output's largest magnitude
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # the module gives the function's bits, and its parameters are the
    # converted tensors
    module = tmlps.ImplicitMLP(port)
    assert torch.equal(module(torch.from_numpy(x)),
                       torch.from_numpy(got))
    n = sum(p.numel() for p in module.parameters())
    assert n == sum(np.asarray(a).size for part in ("trunk", "head")
                    for k in ("w", "b") for a in params[part][k])


def test_implicit_mlp_module_trains():
    gen = torch.Generator().manual_seed(0)
    params = tmlps.init_implicit_mlp(gen, width=32, depth=4, skip_at=2,
                                     n_freqs=4, device="cpu")
    assert [tuple(w.shape) for w in params["trunk"]["w"]] == [(27, 32),
                                                              (32, 32)]
    assert [tuple(w.shape) for w in params["head"]["w"]] == [
        (59, 32), (32, 32), (32, 5)]
    again = tmlps.init_implicit_mlp(torch.Generator().manual_seed(0),
                                    width=32, depth=4, skip_at=2,
                                    n_freqs=4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        params["head"]["w"], again["head"]["w"]))
    module = tmlps.ImplicitMLP(params)
    x = torch.from_numpy(_points(3))
    loss = module(x).square().mean()
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in module.parameters())
    opt = torch.optim.SGD(module.parameters(), lr=1e-2)
    opt.step()
    assert module(x).square().mean() < loss


def test_implicit_mlp_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmlps.init_implicit_mlp(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.implicit_mlp([], [], [], [], 4)


def _old_apply_mlp(params, x):
    """apply_mlp as it was before its bf16 keyword."""
    def bf16_round(t):
        return t.to(torch.bfloat16).to(torch.float32)

    n = len(params["w"])
    h = x
    for i in range(n):
        h = bf16_round(h) @ bf16_round(params["w"][i]) + params["b"][i]
        if i < n - 1:
            h = torch.relu(h)
    return h


@pytest.mark.parametrize("sizes", [[32, 64, 64, 64, 5], [7, 16, 3]])
def test_apply_mlp_bf16_path_unchanged(sizes):
    """The default (bf16=True, every existing caller) gives the same bits
    as before the keyword; bf16=False is the plain float32 chain, within
    1e-5 of the JAX package's."""
    gen = torch.Generator().manual_seed(len(sizes))
    params = init_mlp(gen, sizes, "cpu")
    for b in params["b"]:
        b.uniform_(-0.1, 0.1, generator=gen)
    x = torch.rand((300, sizes[0]), generator=gen) * 2 - 1
    old = _old_apply_mlp(params, x)
    assert torch.equal(apply_mlp(params, x), old)
    assert torch.equal(apply_mlp(params, x, bf16=True), old)
    f32 = apply_mlp(params, x, bf16=False)
    assert not torch.equal(f32, old)
    jparams = {k: [jnp.asarray(t.numpy()) for t in v]
               for k, v in params.items()}
    want = np.asarray(jax_apply_mlp(jparams, jnp.asarray(x.numpy()),
                                    bf16=False))
    np.testing.assert_allclose(f32.numpy(), want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- profiling

def test_device_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace_cpu"
    with profiling.device_trace(str(logdir), "unit", device="cpu") as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert profiling.available()
    with open(logdir / "unit.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_device_trace_raises(tmp_path, monkeypatch):
    """Where the JAX helper runs unprofiled with a warning, the port's
    raises: a log directory that cannot be made, or no card."""
    (tmp_path / "taken").write_text("a file")
    with pytest.raises(FileExistsError):
        with profiling.device_trace(str(tmp_path / "taken"), device="cpu"):
            pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.device_trace(str(tmp_path / "card")):
            pass
    assert not (tmp_path / "card").exists()


# ------------------------------------------------------------------ timing

HELPERS = {
    "bench_keyed": lambda d: timing.bench_keyed(lambda g: None, 0,
                                                device=d),
    "bench_chained": lambda d: timing.bench_chained(lambda i, c: c,
                                                    device=d),
    "bench_chained_keyed": lambda d: timing.bench_chained_keyed(
        lambda g: torch.zeros(()), 0, device=d),
    "bench_scan": lambda d: timing.bench_scan(lambda g: torch.zeros(()), 0,
                                              device=d),
    "bench_batched": lambda d: timing.bench_batched(lambda x: x, lambda i: i,
                                                    device=d),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_timing_needs_the_card(name, monkeypatch):
    """A device time is never taken on the CPU: an explicit CPU device
    raises, and so does the default without a card."""
    with pytest.raises(RuntimeError, match="needs the card"):
        HELPERS[name]("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HELPERS[name](None)


@pytest.fixture
def fake_card(monkeypatch):
    """The helpers' loops on the CPU: the card check and the event pair
    replaced, so that what each call gets and which calls fall inside the
    timed stretch can be read. `timed` lists the calls made inside it."""
    log = {"calls": [], "timed": None}

    def elapsed(run):
        start = len(log["calls"])
        run()
        log["timed"] = log["calls"][start:]
        return 2.0

    monkeypatch.setattr(timing, "_card", lambda device: torch.device("cpu"))
    monkeypatch.setattr(timing, "_elapsed_s", elapsed)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return log


def test_bench_keyed_fresh_generator_per_call(fake_card):
    seen = fake_card["calls"]
    s = timing.bench_keyed(lambda g: seen.append(g.initial_seed()), 40,
                           iters=4, warmup=2)
    assert s == 0.5                       # seconds a call
    assert seen == [1040, 1041, 40, 41, 42, 43]
    assert fake_card["timed"] == [40, 41, 42, 43]


def test_bench_chained_threads_the_carry(fake_card):
    seen = fake_card["calls"]

    def step(i, carry):
        seen.append((i, float(carry)))
        return carry + 1

    assert timing.bench_chained(step, iters=3, warmup=2) == 2.0 / 3
    # the warm-up chain, then a fresh carry from 0 through the timed calls
    assert seen == [(0, 0.0), (1, 1.0), (2, 0.0), (3, 1.0), (4, 2.0)]
    assert fake_card["timed"] == [(2, 0.0), (3, 1.0), (4, 2.0)]


@pytest.mark.parametrize("helper,warmup", [("bench_chained_keyed", 2),
                                           ("bench_scan", 1)])
def test_bench_chained_keyed_accumulates(fake_card, helper, warmup):
    seen = fake_card["calls"]

    def fn(g):
        seen.append(g.initial_seed())
        return torch.tensor(1.0)

    iters = 4
    s = getattr(timing, helper)(fn, 7, iters=iters)
    assert s == 2.0 / iters
    assert seen == [1007 + i for i in range(warmup)] + [7, 8, 9, 10]
    assert fake_card["timed"] == [7, 8, 9, 10]


def test_bench_batched_fresh_inputs(fake_card):
    made, seen = [], fake_card["calls"]

    def make_input(i):
        made.append(i)
        return torch.full((2,), float(i))

    timing.bench_batched(lambda x: seen.append(float(x[0])), make_input,
                         iters=3, warmup=1)
    assert made == [0, 1, 2, 3]           # all made before the clock
    assert seen == [0.0, 1.0, 2.0, 3.0]
    assert fake_card["timed"] == [1.0, 2.0, 3.0]


def test_time_ms_is_chip_smokes_yardstick():
    """chip_smoke.py times every kernel with this function, and it needs
    the card's spin kernel: on the CPU it raises before it times."""
    import chip_smoke

    assert chip_smoke.time_ms is timing.time_ms
    assert timing.SPIN_CYCLES == 500_000
    with pytest.raises((RuntimeError, AttributeError, AssertionError)):
        timing.time_ms(lambda: None, 1, torch.zeros(4))
