"""One-dispatch rendering of the PyTorch port on the CPU: the render round,
the relight round and the validation chunk as utils.graphs.GraphedUnit
runs them on the card (an eager warm-up, one capture a ray count,
replays), with tests/torch_graph_stand_in.py in place of the CUDA calls.
A stand-in replay re-runs the captured function against the tensors the
capture read and writes its results into the captured outputs, so a unit
that reads a stale input (a scene rebuilt rather than updated, parameters
replaced rather than updated, a ray buffer not refilled) or a caller that
keeps an output past the next replay differs from the eager run here.
The same units on the card, bit for bit against eager rounds, are
tests/test_torch_cuda.py's and chip_smoke.py's phase 19."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_graph_stand_in
from iris_tpu.pipeline.render import make_render_fns as jax_render_fns
from iris_tpu.render import relight as JR
from iris_tpu_torch.demo import demo_mat_fn, make_demo_scene
from iris_tpu_torch.geometry.procedural import camera_rays, make_box_scene
from iris_tpu_torch.models.crf import init_emor_crf
from iris_tpu_torch.pipeline import render_relight
from iris_tpu_torch.pipeline.render import (
    make_render_fns, make_render_round, render_frame)
from iris_tpu_torch.render import relight as TR
from iris_tpu_torch.train import validation
from iris_tpu_torch.utils import graphs
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from test_torch_slice import (  # noqa: F401 (the JAX scene fixture)
    DEPTH, SPP, _close, _jax_render_draws, _map, scene)
from test_torch_relight import DISCO, _scenes, room  # noqa: F401


def _rays(n_side=8, **kw):
    return torch.from_numpy(np.concatenate(
        camera_rays(n_side, **kw), -1).astype(np.float32))


@pytest.fixture(scope="module")
def demo():
    """A small port demo scene on the CPU (4 clutter boxes, 2 levels x 16
    features) with a nonzero radiance cache."""
    tracer, em, ngp, crf, mesh = make_demo_scene(
        n_clutter=4, slf_res=8, hash_levels=2, hash_features=16,
        per_level_scale=-1.0, log2_table=10, device="cpu")
    em.slf.radiance = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, em.slf.radiance.shape).astype(np.float32))
    return tracer, em, ngp, crf, mesh


def _eager_frame(render_chunk, aov_chunk, rays, n_rounds, seed):
    """render_frame as the eager rounds made it: one generator seeded
    `seed`, drawn round after round."""
    gen = torch.Generator().manual_seed(seed)
    acc = None
    for _ in range(n_rounds):
        out = [render_chunk(rays, gen)] + list(aov_chunk(rays, gen))
        acc = out if acc is None else [a + b for a, b in zip(acc, out)]
    return [(x / n_rounds).numpy() for x in acc]


def test_graphed_render_frame_matches_eager(monkeypatch, demo):
    """render_frame through a graphed make_render_round, 2 frames x 2
    rounds (the warm-up, the capture, then replays of one graph): the
    image and the six AOVs of the eager rounds, every bit; the frame's
    stream is Generator().manual_seed(frame) drawn round after round."""
    made = torch_graph_stand_in.use(monkeypatch)
    tracer, em, ngp, _, _ = demo
    rc, ac = make_render_fns(tracer, em, demo_mat_fn(ngp), 2, 2)
    unit = make_render_round(rc, ac, "cpu", graphs.GraphContext("cpu"))
    for frame in (0, 1):
        rays = _rays(origin=(1.0, 0.25 + 0.1 * frame, 0.5))
        l_img, aovs = render_frame(unit, rays, 2, frame)
        want = _eager_frame(rc, ac, rays, 2, frame)
        assert len(aovs) == 6
        for got, ref in zip([l_img] + aovs, want):
            np.testing.assert_array_equal(got, ref)
    assert len(made) == 1 and made[0].replays == 3
    assert made[0].generators == [unit.generator]


def test_render_round_on_the_cpu_is_eager(demo):
    """With no context on the CPU a call runs the round itself, and
    render_frame's bits are the eager rounds'."""
    tracer, em, ngp, _, _ = demo
    rc, ac = make_render_fns(tracer, em, demo_mat_fn(ngp), 2, 1)
    unit = make_render_round(rc, ac, "cpu")
    assert unit.ctx is None
    rays = _rays(6)
    l_img, aovs = render_frame(unit, rays, 3, 5)
    for got, ref in zip([l_img] + aovs, _eager_frame(rc, ac, rays, 3, 5)):
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def disco_room():
    """A port relight scene: a box room with the learned material's stand-in
    (diffuse), an emitter and a 20-spot disco ball as a sub-scene."""
    mesh, is_em = make_box_scene(n_clutter=2, seed=0)
    disco, spots = TR.make_disco_ball(**DISCO, device="cpu")
    scene0 = TR.build_relight_scene(
        [{"kind": "mesh", "tris": mesh.triangles(),
          "bsdf": {"type": "diffuse", "reflectance": [0.6, 0.6, 0.6]}}],
        main_is_emitter=is_em,
        main_emitter_radiance=np.full((int(is_em.sum()), 3), 4.0,
                                      np.float32),
        dynamic_shapes=disco, dynamic_center=DISCO["position"], device="cpu")
    return scene0, spots


def test_relight_frames_across_disco_phases_match_eager(monkeypatch,
                                                        disco_room):
    """render_relight.relight_frames with a graphed round: two frames at
    two disco phases, two rounds each, equal the eager rounds on
    set_disco_phase's new scene of each frame under relight_generator,
    every bit. The pose is written into the tensors the captured round
    reads; a round captured on a scene that set_disco_phase replaced
    instead (the frame-0 pose kept) renders frame 1 otherwise."""
    made = torch_graph_stand_in.use(monkeypatch)
    scene0, spots = disco_room
    spp, depth, n_rounds, disco_t = 1, 2, 2, 5.0
    rays = [_rays(5, origin=(1.0, 0.3, 0.8), look=(0.0, 0.7, -0.5))
            .numpy()] * 2
    got = list(render_relight.relight_frames(
        scene0, spots, rays, n_rounds, spp, depth, "cpu", disco_t,
        graphs.GraphContext("cpu")))
    assert len(made) == 1 and made[0].replays == 3
    want = []
    for i, r in enumerate(rays):
        moved = TR.set_disco_phase(scene0, spots, 2 * np.pi * i / disco_t)
        r = torch.from_numpy(r)
        l = torch.zeros((r.shape[0], 3))
        for rd in range(n_rounds):
            l += TR.relight_path_tracing(
                render_relight.relight_generator(i, rd, "cpu"), moved,
                r[:, :3], r[:, 3:6], r[:, 6:9], r[:, 9:12], spp, depth)
        want.append((l / n_rounds).numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(want[0], want[1])

    # the replaced scene: the captured round keeps frame 0's pose
    torch_graph_stand_in.use(monkeypatch)
    stale = TR.set_disco_phase(scene0, spots, 0.0)
    unit = render_relight.make_relight_round(
        stale, spp, depth, "cpu", graphs.GraphContext("cpu"))
    r = torch.from_numpy(rays[1])
    for rd in range(2):
        unit(r, seed=render_relight.relight_seed(0, rd))
    TR.set_disco_phase(scene0, spots, 2 * np.pi / disco_t)   # a new scene
    l = unit(r, seed=render_relight.relight_seed(1, 0)).clone()
    l += unit(r, seed=render_relight.relight_seed(1, 1))
    assert not np.array_equal((l / 2).numpy(), want[1])


@pytest.mark.parametrize("phase", [0.0, 0.7, 2.0])
def test_disco_phase_in_place_matches_jax(room, phase):
    """set_disco_phase(..., out=) writes the JAX package's pose into the
    tensors of the scene it returned for phase 0 (the emitter vertices,
    the spots, the rays' rotation) and returns that scene; the new-scene
    form gives the same bits."""
    js, jspots, ts, tspots = _scenes(room, "diffuse")
    live = TR.set_disco_phase(ts, tspots, 0.0)
    tensors = (live.emitter.emitter_vertices, live.spots.position,
               live.spots.direction, live.dyn_rot)
    assert TR.set_disco_phase(ts, tspots, phase, out=live) is live
    assert all(a is b for a, b in zip(tensors, (
        live.emitter.emitter_vertices, live.spots.position,
        live.spots.direction, live.dyn_rot)))
    j = JR.set_disco_phase(js, jspots, phase)
    moved = TR.set_disco_phase(ts, tspots, phase)
    for got, new, want in (
            (live.emitter.emitter_vertices, moved.emitter.emitter_vertices,
             j.emitter.emitter_vertices),
            (live.spots.position, moved.spots.position, j.spots.position),
            (live.spots.direction, moved.spots.direction,
             j.spots.direction), (live.dyn_rot, moved.dyn_rot, j.dyn_rot)):
        assert torch.equal(got, new)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def _val_params(ngp, em, crf):
    return {"material": dataclasses.replace(
                ngp, table=ngp.table.clone(),
                mlp={k: [t.clone() for t in v] for k, v in ngp.mlp.items()}),
            "radiance": em.radiance.clone(), "crf_weight": crf.weight.clone()}


@pytest.mark.parametrize("log_space", [False, True])
def test_validation_render_graphed_matches_eager(monkeypatch, tmp_path, demo,
                                                 log_space):
    """hook.render with graphed chunks (64-ray chunks and a short last
    one: two captures) at two steps, the parameters changed in place
    between them (and param_tx = exp under log space, applied inside the
    unit): the eager hook's L_train and L_full, every bit; parameters
    that are other tensors raise."""
    made = torch_graph_stand_in.use(monkeypatch)
    monkeypatch.setattr(validation, "VAL_CHUNK", 64)
    tracer, em, ngp, crf, _ = demo
    rays = _rays(12).numpy()                 # 144 rays: 64 + 64 + 16
    batch = {"rays": rays, "rgbs": np.zeros_like(rays[:, :3])}
    tx = ((lambda p: {**p, "radiance": torch.exp(p["radiance"])})
          if log_space else None)
    kw = dict(spp=2, indir_depth=2, param_tx=tx)
    hooks = [validation.make_validation_hook(
        tracer, em, crf, batch, (12, 12), str(tmp_path / name), **kw,
        graphs=ctx) for name, ctx in (("g", graphs.GraphContext("cpu")),
                                      ("e", None))]
    params = _val_params(ngp, em, crf)
    if log_space:
        params["radiance"] = torch.log(params["radiance"])
    for step in (2, 4, 6):
        got = hooks[0].render(params, step)
        want = hooks[1].render(params, step)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        with torch.no_grad():
            params["radiance"].mul_(0.9)
            params["material"].table.add_(0.05)
            params["crf_weight"].add_(0.01)
    assert len(made) == 2 and [g.replays for g in made] == [5, 2]
    other = _val_params(ngp, em, crf)
    with pytest.raises(ValueError, match="parameter tensors"):
        hooks[0].render(other, 8)


def test_failed_capture_raises_and_nothing_renders_eagerly(monkeypatch,
                                                           demo):
    """A capture that fails raises out of the call, and so does every
    later call at that shape: no round runs eagerly in its place. A
    replay that fails raises too."""
    torch_graph_stand_in.use(monkeypatch)
    tracer, em, ngp, _, _ = demo
    rc, ac = make_render_fns(tracer, em, demo_mat_fn(ngp), 1, 1)
    calls = []

    def counted(rays, gen):
        calls.append(1)
        return rc(rays, gen)

    unit = make_render_round(counted, ac, "cpu", graphs.GraphContext("cpu"))
    rays = _rays(4)
    unit(rays, seed=0)                        # the warm-up
    assert len(calls) == 1

    def refuse(graph, pool, stream, fn):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphs, "_cuda_capture", refuse)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            unit(rays)
    assert len(calls) == 1 and unit.graphs == {}

    torch_graph_stand_in.use(monkeypatch)
    unit = make_render_round(rc, ac, "cpu", graphs.GraphContext("cpu"))
    unit(rays, seed=0)
    unit(rays)
    graph = next(iter(unit.graphs.values()))[0]

    def fail():
        raise RuntimeError("replay failed")

    monkeypatch.setattr(graph.graph, "replay", fail)
    with pytest.raises(RuntimeError, match="replay failed"):
        unit(rays)


def test_graphed_round_matches_jax_under_replayed_draws(monkeypatch, scene):
    """A GraphedUnit of the JAX package's render unit (render_chunk then
    aov_chunk, make_render_fns) under the JAX package's draws, read in
    place by the captured round: the warm-up, the capture's replay and a
    replay with the draws of another key refilled in place each equal the
    jitted JAX functions on that key (rtol 2e-3, atol 1e-4, as
    test_torch_slice.py)."""
    torch_graph_stand_in.use(monkeypatch)
    (jt, je, jm), (pt, pe, pm), rays = scene
    b = rays.shape[0]
    j_render, j_aov = jax_render_fns(jt, je, jm, SPP, DEPTH)
    rc, ac = make_render_fns(pt, pe, pm, SPP, DEPTH)

    def draws(key):
        s = _jax_render_draws(key, b, SPP, DEPTH)
        a = {"dudv": jax.random.uniform(key, (2, b, SPP, 1)),
             "s2": jax.random.uniform(jax.random.fold_in(key, 1),
                                      (b * SPP, 2))}
        return (_map(lambda x: torch.from_numpy(np.array(x)), s),
                _map(lambda x: torch.from_numpy(np.array(x)), a))

    s_r, s_a = draws(jax.random.PRNGKey(1))

    def round_(gen, r):
        return (rc(r, samples=s_r),) + tuple(ac(r, samples=s_a))

    unit = graphs.GraphedUnit(round_, "cpu", graphs.GraphContext("cpu"))
    t_rays = torch.from_numpy(rays)
    for i, key in enumerate((1, 1, 2)):
        k = jax.random.PRNGKey(key)
        if i == 2:
            new_r, new_a = draws(k)
            for d, n in ((s_r, new_r), (s_a, new_a)):
                _map_pairs(lambda x, y: x.copy_(y), d, n)
        got = [x.clone() for x in unit(t_rays)]
        want = [j_render(jnp.asarray(rays), k)] + list(
            j_aov(jnp.asarray(rays), k))
        for g, w in zip(got, want):
            _close(g, w)


def _map_pairs(f, a, b):
    for k in a:
        if isinstance(a[k], dict):
            _map_pairs(f, a[k], b[k])
        else:
            f(a[k], b[k])


def test_validation_pngs_with_graphs(monkeypatch, tmp_path, demo):
    """The validation hook with graphed chunks writes the four PNGs of each
    validation step, the images byte for byte the eager hook's."""
    torch_graph_stand_in.use(monkeypatch)
    monkeypatch.setattr(validation, "VAL_CHUNK", 64)
    tracer, em, ngp, crf, _ = demo
    rays = _rays(10).numpy()
    batch = {"rays": rays, "rgbs": np.full_like(rays[:, :3], 0.5)}
    params = _val_params(ngp, em, crf)
    out = {}
    for name, ctx in (("g", graphs.GraphContext("cpu")), ("e", None)):
        hook = validation.make_validation_hook(
            tracer, em, init_emor_crf(device="cpu"), batch, (10, 10),
            str(tmp_path / name), val_step=2, spp=1, indir_depth=1,
            graphs=ctx)
        for step in range(5):
            hook(step, params, 0.0, {})
        out[name] = tmp_path / name
    names = sorted(p.name for p in out["g"].iterdir())
    assert names == sorted(p.name for p in out["e"].iterdir())
    assert len(names) == 12
    for n in names:
        if not n.endswith("_crfs.png"):
            assert (out["g"] / n).read_bytes() == \
                (out["e"] / n).read_bytes(), n

