"""The relight integrator, PyTorch port vs the JAX package
(iris_tpu/render/relight.py): the host geometry bit for bit, the merged
scene's per-face arrays and emitter, scene_intersect on the static and the
rigid sub-scene, set_disco_phase, and relight_path_tracing under the JAX
package's replayed draws (torch_parity.jax_relight_draws) on a small room
(2 clutter boxes, 256 pixels, spp 4, depth 3, a 20-spot disco ball).

Tolerances of the image, by material class:
- diffuse only (no hash-grid material): 99% of values within rtol 1e-4 /
  atol 1e-6 and every value within rtol 1e-3 / atol 1e-5 (the spots' sum
  and the normalizations add in other orders; the worst value seen was
  1.8e-4 apart);
- with conductors (roughness 0.05 and a roughconductor): the share rule
  of the bakes' sharpest level, for the GGX sampler's cancellation in
  1 - u (1 - alpha^2), which XLA rounds once and PyTorch twice (ROADMAP
  Queue 3, "The sharpest roughness level"): 90% of values within rtol
  1e-4 / atol 1e-6 and the mean within 1%;
- the fipt material (the NGP BRDF): the bf16 rule, 95% of values within
  rtol 2e-3 / atol 1e-4 (ROADMAP Queue 3, "bf16 MLP sums")."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.geometry.procedural import camera_rays, make_box_scene
from iris_tpu.models.brdf import init_ngp_brdf
from iris_tpu.models.hashgrid import HashGridConfig
from iris_tpu.render import relight as JR
from iris_tpu_torch.render import relight as TR
from torch_parity import (  # noqa: F401
    jax_relight_draws, port_ngp, tt, one_torch_thread)

DISCO = dict(position=[1.0, 1.0, 0.6], radius=0.12, light_intensity=60.0,
             light_num=20, spot_intensity=20.0)
SPP, DEPTH = 4, 3
EMITTER_SPHERE = {
    "kind": "sphere", "subdiv": 1,
    "to_world": [{"type": "translate", "value": [0.6, 0.6, 0.5]},
                 {"type": "scale", "value": 0.1}],
    "bsdf": {"type": "diffuse", "reflectance": [0, 0, 0]},
    "emitter": {"radiance": [30.0, 25.0, 20.0]}}
DIFFUSE_SPHERE = {
    "kind": "sphere", "subdiv": 1,
    "to_world": [{"type": "translate", "value": [1.0, 1.4, 0.25]},
                 {"type": "scale", "value": 0.12}],
    "bsdf": {"type": "diffuse", "reflectance": [0.2, 0.25, 0.7]}}
CONDUCTORS = [
    {"kind": "sphere", "subdiv": 1,
     "to_world": [{"type": "translate", "value": [1.4, 1.0, 0.3]},
                  {"type": "scale", "value": 0.15}],
     "bsdf": {"type": "conductor", "reflectance": [1.0, 0.86, 0.57],
              "roughness": 0.05}},
    {"kind": "sphere", "subdiv": 1,
     "to_world": [{"type": "translate", "value": [0.5, 1.3, 0.2]},
                  {"type": "scale", "value": 0.15}],
     "bsdf": {"type": "conductor", "reflectance": [0.2, 0.15, 0.1],
              "roughness": float((0.05 * 0.3) ** 0.25)}},
]


def _ngp():
    """A 4-level x 2^8 grid whose coarse level varies over the room (the
    fine levels keep their init scale, or ~1e-7 position noise would move
    the field by ~1e-2)."""
    ngp = init_ngp_brdf(jax.random.PRNGKey(0), -0.1, 2.1,
                        HashGridConfig(n_levels=4, log2_table_size=8))
    table = np.asarray(ngp.table).copy()
    rng = np.random.default_rng(0)
    n0 = table.size // 4
    table[:n0] = rng.uniform(-1, 1, n0)
    return dataclasses.replace(ngp, table=jnp.asarray(table))


@pytest.fixture(scope="module")
def room():
    mesh, is_em = make_box_scene(n_clutter=2, seed=0)
    rad = np.full((int(is_em.sum()), 3), 4.0, np.float32)
    ngp = _ngp()
    return mesh, is_em, rad, ngp, port_ngp(ngp)


def _main(mesh, kind):
    bsdf = ({"type": "fipt"} if kind == "fipt"
            else {"type": "diffuse", "reflectance": [0.6, 0.6, 0.6]})
    return {"kind": "mesh", "tris": mesh.triangles(), "bsdf": bsdf}


def _shapes(mesh, kind):
    """The room, an emitter, a diffuse sphere and two more spheres: the
    conductors, or diffuse in the diffuse-only class (the same faces, so
    that the jitted JAX integrator is compiled once for both classes)."""
    others = CONDUCTORS
    if kind == "diffuse":
        others = [dict(c, bsdf=DIFFUSE_SPHERE["bsdf"]) for c in CONDUCTORS]
    return [_main(mesh, kind), EMITTER_SPHERE, DIFFUSE_SPHERE] + others


def _scenes(room, kind, disco=True):
    """(JAX scene, JAX spots, port scene, port spots) of one material
    class, the disco ball a sub-scene of its own."""
    mesh, is_em, rad, jngp, tngp = room
    shapes = _shapes(mesh, kind)
    kw = dict(main_is_emitter=is_em, main_emitter_radiance=rad)
    jd = td = js = ts = None
    if disco:
        jd, js = JR.make_disco_ball(**DISCO)
        td, ts = TR.make_disco_ball(**DISCO, device="cpu")
    jscene = JR.build_relight_scene(
        shapes, ngp=jngp if kind == "fipt" else None, dynamic_shapes=jd,
        dynamic_center=DISCO["position"] if disco else None, **kw)
    tscene = TR.build_relight_scene(
        shapes, ngp=tngp if kind == "fipt" else None, dynamic_shapes=td,
        dynamic_center=DISCO["position"] if disco else None, device="cpu",
        **kw)
    return jscene, js, tscene, ts


def _rays(n_side=16, origin=(1.0, 0.3, 0.8), look=(0.0, 0.7, -0.5)):
    return camera_rays(n_side, origin=origin, look=look)


# ------------------------------------------------------------ host side

def test_empty_spots():
    """No spot lights: five empty arrays of the JAX package's shapes, on
    the device asked for."""
    j, t = JR.empty_spots(), TR.empty_spots(device="cpu")
    for name in ("position", "direction", "intensity", "cutoff_cos",
                 "beam_cos"):
        a, b = getattr(j, name), getattr(t, name)
        assert tuple(b.shape) == tuple(a.shape) and b.device.type == "cpu"
        assert b.dtype == torch.float32


@pytest.mark.parametrize("subdiv", [0, 1, 2])
def test_icosphere_same_bits(subdiv):
    a, b = JR.icosphere(subdiv), TR.icosphere(subdiv)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("transforms", [
    [{"type": "translate", "value": [5, 0, 0]},
     {"type": "scale", "value": 2.0}],
    [{"type": "translate", "value": [-0.56, -0.32, 0.08]},
     {"type": "scale", "value": [0.2, 0.3, 0.2]},
     {"type": "rotate", "axis": [1, 0, 0], "angle": -90},
     {"type": "rotate", "axis": [0, 1, 1], "angle": 33.0}],
])
def test_apply_to_world_same_bits(transforms):
    tris = JR.icosphere(1)
    a = JR.apply_to_world(tris, transforms)
    b = TR.apply_to_world(tris, transforms)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("light_num,phase", [(20, 0.0), (40, 0.3)])
def test_disco_ball_same_bits(light_num, phase):
    a = JR.fibonacci_sphere(light_num, phase)
    assert a.tobytes() == TR.fibonacci_sphere(light_num, phase).tobytes()
    kw = dict(position=[0.0, 0.3, -0.5], radius=0.2, light_intensity=40.0,
              light_num=light_num, light_radius_rate=0.1, spot_intensity=0.5,
              spot_cutoff_angle=20.0, phase=phase)
    js, jspots = JR.make_disco_ball(**kw)
    ts, tspots = TR.make_disco_ball(**kw, device="cpu")
    assert js == ts
    for f in dataclasses.fields(jspots):
        got = getattr(tspots, f.name).numpy()
        want = np.asarray(getattr(jspots, f.name))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ---------------------------------------------------------- scene build

@pytest.mark.parametrize("kind", ["diffuse", "fipt"])
def test_build_relight_scene_arrays(room, kind):
    js, _, ts, _ = _scenes(room, kind)
    for name in ("face_albedo", "face_roughness", "face_metallic",
                 "face_use_ngp", "dyn_center", "dyn_rot"):
        got, want = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert ts.dyn_face_offset == js.dyn_face_offset
    assert ts.tracer.n_faces == js.tracer.n_faces
    assert ts.dyn_tracer.n_faces == js.dyn_tracer.n_faces
    for f in dataclasses.fields(js.emitter):
        if f.name == "slf":
            continue
        got = getattr(ts.emitter, f.name).numpy()
        want = np.asarray(getattr(js.emitter, f.name))
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f.name)


def test_build_relight_scene_builds_each_tree_once(room, monkeypatch):
    built = []
    real = TR.build_bvh

    def counting(tris, **kw):
        built.append(len(tris))
        return real(tris, **kw)

    monkeypatch.setattr(TR, "build_bvh", counting)
    _, _, ts, spots = _scenes(room, "diffuse")
    assert sorted(built) == sorted([ts.tracer.n_faces, ts.dyn_tracer.n_faces])
    built.clear()
    TR.set_disco_phase(ts, spots, 1.0)
    assert built == []


# ---------------------------------------------------- scene_intersect

def _hold_hits(jout, tout):
    jp, jn, _, jt, jv = (np.asarray(x) for x in jout)
    tp, tn, _, tt_, tv = (x.numpy() for x in tout)
    assert np.array_equal(jv, tv)
    assert np.array_equal(jt, tt_)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-5)
    return jt


@pytest.mark.parametrize("disco,phase", [
    (False, None), (True, 0.0), (True, np.pi / 2)])
def test_scene_intersect(room, disco, phase):
    js, jspots, ts, tspots = _scenes(room, "diffuse", disco)
    if phase is not None:
        js = JR.set_disco_phase(js, jspots, phase)
        ts = TR.set_disco_phase(ts, tspots, phase)
    o, d, *_ = _rays(24)
    tri = _hold_hits(JR.scene_intersect(js, jnp.asarray(o), jnp.asarray(d)),
                     TR.scene_intersect(ts, tt(o), tt(d)))
    assert (tri >= 0).mean() > 0.9
    if disco:
        hit_ball = tri >= ts.dyn_face_offset
        assert hit_ball.any() and not hit_ball.all()


def test_sub_scene_equals_the_merged_build(room):
    """At phase 0 (the identity rotation), tracing the static tree and the
    sub-scene's tree equals tracing one tree of the merged soup."""
    mesh, is_em, rad, _, _ = room
    main = _main(mesh, "diffuse")
    ball = dict(DIFFUSE_SPHERE, to_world=[
        {"type": "translate", "value": [1.0, 1.0, 0.5]},
        {"type": "scale", "value": 0.2}])
    kw = dict(main_is_emitter=is_em, main_emitter_radiance=rad,
              device="cpu")
    merged = TR.build_relight_scene([main, ball], **kw)
    split = TR.build_relight_scene([main], dynamic_shapes=[ball],
                                   dynamic_center=[1.0, 1.0, 0.5], **kw)
    o, d, *_ = camera_rays(24, origin=(1.0, 0.3, 0.5), look=(0.0, 1.0, 0.0))
    pm, nm, _, tm, vm = TR.scene_intersect(merged, tt(o), tt(d))
    ps, ns, _, ts_, vs = TR.scene_intersect(split, tt(o), tt(d))
    assert torch.equal(vm, vs) and torch.equal(tm, ts_)
    torch.testing.assert_close(pm, ps, rtol=0, atol=1e-5)
    torch.testing.assert_close(nm, ns, rtol=0, atol=1e-5)
    hit_ball = ts_ >= split.dyn_face_offset
    assert hit_ball.any() and not hit_ball.all()


@pytest.mark.parametrize("phase", [0.0, np.pi / 2, 2.0])
def test_set_disco_phase(room, phase):
    js, jspots, ts, tspots = _scenes(room, "diffuse")
    j = JR.set_disco_phase(js, jspots, phase)
    t = TR.set_disco_phase(ts, tspots, phase)
    for got, want in (
            (t.emitter.emitter_vertices, j.emitter.emitter_vertices),
            (t.spots.position, j.spots.position),
            (t.spots.direction, j.spots.direction), (t.dyn_rot, j.dyn_rot)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    for name in ("intensity", "cutoff_cos", "beam_cos"):
        assert torch.equal(getattr(t.spots, name), getattr(tspots, name))
    moved = ~torch.isclose(t.emitter.emitter_vertices,
                           ts.emitter.emitter_vertices).all(-1).all(-1)
    dyn = ts.emitter.triangle_idx >= ts.dyn_face_offset
    assert not moved[~dyn].any()
    assert moved[dyn].all() == (phase != 0.0)


# ------------------------------------------------ relight_path_tracing

def _hold(got, want, rtol, atol, share):
    close = np.abs(got - want) <= atol + rtol * np.abs(want)
    assert close.mean() >= share, (close.mean(), np.abs(got - want).max())
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-2)


_jax_relight = jax.jit(functools.partial(JR.relight_path_tracing, spp=SPP,
                                         max_depth=DEPTH))
BARS = {"diffuse": (1e-4, 1e-6, 0.99), "conductor": (1e-4, 1e-6, 0.90),
        "fipt": (2e-3, 1e-4, 0.95)}


@pytest.mark.parametrize("kind", ["diffuse", "conductor", "fipt"])
def test_relight_path_tracing(room, kind):
    js, jspots, ts, tspots = _scenes(room, kind)
    js = JR.set_disco_phase(js, jspots, 0.7)
    ts = TR.set_disco_phase(ts, tspots, 0.7)
    o, d, dxdu, dydv = _rays()
    key = jax.random.PRNGKey(3)
    want = np.asarray(_jax_relight(key, js,
                                   *map(jnp.asarray, (o, d, dxdu, dydv))))
    got = TR.relight_path_tracing(
        None, ts, *map(tt, (o, d, dxdu, dydv)), SPP, DEPTH,
        samples=jax_relight_draws(key, o.shape[0], SPP, DEPTH)).numpy()
    assert np.isfinite(want).all() and want.max() > 1e-2
    _hold(got, want, *BARS[kind])
    if kind == "diffuse":
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
