"""Scene integrator for relighting and object insertion (counterpart of
iris_tpu/render/relight.py; reference render_relight.py +
model/fipt_bsdf.py, where Mitsuba drives the learned BRDF as a plugin).

The whole scene, the main mesh with the learned FIPT BSDF, inserted
objects and tessellated sphere emitters, is merged into one triangle soup
with per-face material records, and an NEE+MIS path tracer renders it.
Every surface maps onto the training model's (albedo, roughness,
metallic) GGX+Lambert lobes:

  diffuse   -> (reflectance, 1.0, 0)
  conductor -> (tint, 0.05, 1)
  fipt      -> the hash-grid BRDF, selected per lane by a use_ngp flag

Spot lights are delta emitters with an NEE term of their own, whose
shadow rays for all S spots go out as one trace of S x n rays. An
optional rigid sub-scene (the disco ball) has a BVH of its own, built
once; a frame's motion rotates the rays into its frame instead of
rebuilding any tree.

The host-side geometry (icosphere, apply_to_world, fibonacci_sphere,
make_disco_ball) is the JAX package's numpy, bit for bit. The rotations
applied to tensors are written as elementwise products and sums (no
matrix product), so that the card and the CPU give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from iris_tpu_torch.const import RAY_EPS
from iris_tpu_torch.core.vecmath import dot, normalize
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.geometry.bvh import Tracer, build_bvh
from iris_tpu_torch.geometry.intersect import ray_intersect
from iris_tpu_torch.models import brdf as B
from iris_tpu_torch.models.brdf import NGPBRDF, ngp_brdf_apply
from iris_tpu_torch.models.emitter import (
    Emitter, eval_emitter, make_emitter, sample_emitter,
)
from iris_tpu_torch.render.integrator import _mis_power2, draw_uniform


# ------------------------------------------------------------- geometry

def icosphere(subdiv: int = 2) -> np.ndarray:
    """Unit icosphere triangles (F, 3, 3)."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    tris = verts[faces]
    for _ in range(subdiv):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab = a + b
        bc = b + c
        ca = c + a
        ab /= np.linalg.norm(ab, axis=-1, keepdims=True)
        bc /= np.linalg.norm(bc, axis=-1, keepdims=True)
        ca /= np.linalg.norm(ca, axis=-1, keepdims=True)
        tris = np.concatenate([
            np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
            np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1),
        ], 0)
    return tris.astype(np.float32)


def apply_to_world(tris: np.ndarray, transforms: list[dict]) -> np.ndarray:
    """Mitsuba-style to_world list: translate/scale/rotate applied in
    REVERSE list order (T1.translate(a).scale(b) scales first)."""
    m = np.eye(4)
    for tr in transforms:
        t = np.eye(4)
        if tr["type"] == "translate":
            t[:3, 3] = tr["value"]
        elif tr["type"] == "scale":
            v = tr["value"]
            v = [v, v, v] if np.isscalar(v) else v
            t[0, 0], t[1, 1], t[2, 2] = v
        elif tr["type"] == "rotate":
            axis = np.asarray(tr["axis"], np.float64)
            axis = axis / np.linalg.norm(axis)
            ang = np.radians(tr["angle"])
            k = np.asarray([[0, -axis[2], axis[1]],
                            [axis[2], 0, -axis[0]],
                            [-axis[1], axis[0], 0]])
            t[:3, :3] = (np.eye(3) + np.sin(ang) * k
                         + (1 - np.cos(ang)) * k @ k)
        m = m @ t
    p = tris.reshape(-1, 3)
    p = p @ m[:3, :3].T + m[:3, 3]
    return p.reshape(-1, 3, 3).astype(np.float32)


def _times(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (N, 3) @ m (3, 3) as products and sums in a fixed order: the same
    bits on every device (a matrix product's order is the library's)."""
    return x[:, 0:1] * m[0] + x[:, 1:2] * m[1] + x[:, 2:3] * m[2]


# ------------------------------------------------------ scene container

@dataclass
class SpotLights:
    position: torch.Tensor      # (S, 3)
    direction: torch.Tensor     # (S, 3) unit
    intensity: torch.Tensor     # (S, 3)
    cutoff_cos: torch.Tensor    # (S,)
    beam_cos: torch.Tensor      # (S,)


@dataclass
class RelightScene:
    tracer: Tracer
    emitter: Emitter              # merged area emitters (mesh + spheres)
    face_albedo: torch.Tensor     # (F, 3)
    face_roughness: torch.Tensor  # (F, 1)
    face_metallic: torch.Tensor   # (F, 1)
    face_use_ngp: torch.Tensor    # (F,) bool
    ngp: NGPBRDF | None
    spots: SpotLights | None
    # Optional rigid sub-scene (the disco ball): its own small BVH, built
    # once at phase 0; a frame rotates the RAYS into its frame (world ->
    # local) instead of rebuilding a tree. Its face ids sit at
    # [dyn_face_offset, F) in the per-face arrays.
    dyn_tracer: Tracer | None = None
    dyn_center: torch.Tensor | None = None   # (3,) rotation pivot
    dyn_rot: torch.Tensor | None = None      # (3, 3) local -> world
    dyn_face_offset: int = 0


def scene_intersect(scene: RelightScene, o: torch.Tensor, d: torch.Tensor):
    """Nearest hit over the static and (optionally) the rigid sub-scene:
    one trace of each tree. The sub-scene is traced in its local frame
    (local = R^T (world - c) + c) and its hits rotated back to world; a
    sub-scene hit wins where the static trace missed or lies farther."""
    pos, nrm, uv, tri, valid = ray_intersect(scene.tracer, o, d)
    if scene.dyn_tracer is None:
        return pos, nrm, uv, tri, valid
    c, r = scene.dyn_center, scene.dyn_rot
    o_l = _times(o - c, r) + c
    d_l = _times(d, r)
    p2, n2, uv2, t2, v2 = ray_intersect(scene.dyn_tracer, o_l, d_l)
    rt = r.t()
    p2 = _times(p2 - c, rt) + c
    n2 = _times(n2, rt)
    d1 = torch.sum((pos - o) ** 2, -1)
    d2 = torch.sum((p2 - o) ** 2, -1)
    use2 = v2 & ((~valid) | (d2 < d1))
    u2 = use2[:, None]
    return (torch.where(u2, p2, pos), torch.where(u2, n2, nrm),
            torch.where(u2, uv2, uv),
            torch.where(use2, t2 + scene.dyn_face_offset, tri),
            valid | v2)


def rot_z(phase: float) -> np.ndarray:
    """The (3, 3) rotation by `phase` about z, float32, made on the host
    (so that every device gets the same matrix)."""
    c, s = np.cos(phase), np.sin(phase)
    return np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                      np.float32)


def set_disco_phase(base: RelightScene, base_spots: SpotLights | None,
                    phase: float, out: RelightScene | None = None
                    ) -> RelightScene:
    """A frame's disco-ball pose: the sub-scene of `base` (phase 0)
    rotated by `phase` about its center by data updates alone (its emitter
    vertices, the spots and the rays' rotation); no BVH is built. Returns
    a new scene; with `out` (a scene this function returned for the same
    base), writes the pose into out's tensors in place and returns out,
    so that a captured round that reads them renders the new pose."""
    if base.dyn_tracer is None:
        raise ValueError("set_disco_phase: the scene has no sub-scene")
    c = base.dyn_center
    rot = torch.as_tensor(rot_z(phase), device=c.device)
    rt = rot.t()
    em = base.emitter
    dyn = (em.triangle_idx >= base.dyn_face_offset)[:, None, None]
    v = em.emitter_vertices
    v_w = _times((v - c).reshape(-1, 3), rt).reshape(v.shape) + c
    em = replace(em, emitter_vertices=torch.where(dyn, v_w, v))
    spots = None
    if base_spots is not None and base_spots.position.shape[0] > 0:
        spots = replace(base_spots,
                        position=_times(base_spots.position - c, rt) + c,
                        direction=_times(base_spots.direction, rt))
    if out is None:
        return replace(base, emitter=em, spots=spots, dyn_rot=rot)
    out.emitter.emitter_vertices.copy_(em.emitter_vertices)
    if spots is not None:
        out.spots.position.copy_(spots.position)
        out.spots.direction.copy_(spots.direction)
    out.dyn_rot.copy_(rot)
    return out


def empty_spots(device=None) -> SpotLights:
    """No spot lights, on `device` (default the card)."""
    dev = resolve_device(device)
    z3 = torch.zeros((0, 3), device=dev)
    z1 = torch.zeros((0,), device=dev)
    return SpotLights(z3, z3, z3, z1, z1)


def build_relight_scene(
    shapes: list[dict],
    ngp: NGPBRDF | None = None,
    main_is_emitter: np.ndarray | None = None,
    main_emitter_radiance: np.ndarray | None = None,
    dynamic_shapes: list[dict] | None = None,
    dynamic_center=None,
    device=None,
) -> RelightScene:
    """shapes: dicts with keys
      kind: 'mesh' | 'sphere', tris (mesh) or to_world (sphere),
      bsdf: {'type': 'fipt' | 'diffuse' | 'conductor', 'reflectance': rgb,
             'roughness': float}
      emitter: None | {'radiance': rgb}
    Spot lights are set on the scene afterwards (set_disco_phase).

    dynamic_shapes (the disco ball at phase 0) get a BVH of their own; the
    static BVH and that one are each built exactly once here."""
    dev = resolve_device(device)
    all_tris, alb, rough, metal, use_ngp = [], [], [], [], []
    is_em, radiance = [], []
    n_static_shapes = len(shapes)
    shapes = list(shapes) + list(dynamic_shapes or [])
    n_static_faces = 0
    for shape_i, sh in enumerate(shapes):
        tris = sh["tris"] if sh["kind"] == "mesh" else apply_to_world(
            icosphere(sh.get("subdiv", 2)), sh["to_world"])
        f = len(tris)
        all_tris.append(tris)
        if shape_i < n_static_shapes:
            n_static_faces += f
        bsdf = sh.get("bsdf", {"type": "diffuse", "reflectance": [0, 0, 0]})
        kind = bsdf.get("type", "diffuse")
        if kind == "fipt":
            alb.append(np.zeros((f, 3), np.float32))
            rough.append(np.ones((f, 1), np.float32))
            metal.append(np.zeros((f, 1), np.float32))
            use_ngp.append(np.ones(f, bool))
        elif kind == "conductor":
            tint = np.asarray(bsdf.get("reflectance", [1.0, 1.0, 1.0]),
                              np.float32)
            alb.append(np.tile(tint, (f, 1)))
            rough.append(np.full((f, 1), bsdf.get("roughness", 0.05),
                                 np.float32))
            metal.append(np.ones((f, 1), np.float32))
            use_ngp.append(np.zeros(f, bool))
        else:  # diffuse
            refl = np.asarray(bsdf.get("reflectance", [0.5, 0.5, 0.5]),
                              np.float32)
            alb.append(np.tile(refl, (f, 1)))
            rough.append(np.ones((f, 1), np.float32))
            metal.append(np.zeros((f, 1), np.float32))
            use_ngp.append(np.zeros(f, bool))
        em_cfg = sh.get("emitter")
        if sh["kind"] == "mesh" and main_is_emitter is not None and \
                kind == "fipt":
            is_em.append(np.asarray(main_is_emitter, bool))
            r = np.zeros((f, 3), np.float32)
            r[np.asarray(main_is_emitter, bool)] = main_emitter_radiance
            radiance.append(r)
        elif em_cfg is not None:
            is_em.append(np.ones(f, bool))
            radiance.append(np.tile(np.asarray(em_cfg["radiance"],
                                               np.float32), (f, 1)))
        else:
            is_em.append(np.zeros(f, bool))
            radiance.append(np.zeros((f, 3), np.float32))

    tris = np.concatenate(all_tris, 0)
    is_em = np.concatenate(is_em)
    rad_per_face = np.concatenate(radiance, 0)
    emitter = make_emitter(is_em, tris, radiance=rad_per_face[is_em]
                           if is_em.any() else None, device=dev)
    dyn_tracer = dyn_center = dyn_rot = None
    if dynamic_shapes:
        dyn_tris = tris[n_static_faces:]
        dyn_tracer = build_bvh(dyn_tris, device=dev)
        if dynamic_center is None:
            dynamic_center = dyn_tris.reshape(-1, 3).mean(0)
        dyn_center = torch.as_tensor(np.asarray(dynamic_center, np.float32),
                                     device=dev)
        dyn_rot = torch.eye(3, device=dev)

    def t(parts, dtype=torch.float32):
        return torch.as_tensor(np.concatenate(parts, 0), dtype=dtype,
                               device=dev)

    return RelightScene(
        tracer=build_bvh(tris[:n_static_faces], device=dev),
        emitter=emitter,
        face_albedo=t(alb),
        face_roughness=t(rough),
        face_metallic=t(metal),
        face_use_ngp=t(use_ngp, torch.bool),
        ngp=ngp,
        spots=None,
        dyn_tracer=dyn_tracer,
        dyn_center=dyn_center,
        dyn_rot=dyn_rot,
        dyn_face_offset=n_static_faces,
    )


def _surface_mat(scene: RelightScene, position, tri_idx) -> dict:
    """Per-lane material: the NGP output where the face says so, else the
    per-face constants."""
    safe = torch.clamp(tri_idx, min=0)
    alb = scene.face_albedo[safe]
    rough = scene.face_roughness[safe]
    metal = scene.face_metallic[safe]
    if scene.ngp is not None:
        ngp_mat = ngp_brdf_apply(scene.ngp, position)
        use = scene.face_use_ngp[safe][:, None]
        alb = torch.where(use, ngp_mat["albedo"], alb)
        rough = torch.where(use, ngp_mat["roughness"], rough)
        metal = torch.where(use, ngp_mat["metallic"], metal)
    return {"albedo": alb, "roughness": rough, "metallic": metal}


def _spot_nee(scene: RelightScene, position, wo, normal, mat, active):
    """Delta spot-light NEE: every spot's shadow ray in ONE (S*n)-ray
    trace, spot-major (row s*n + i is spot s from lane i). Each (n, k)
    input is tiled by S once, and the trace's bookkeeping is freed before
    the BRDF runs: at 40 spots and 614,400 lanes each (S*n, 3) float
    tensor is 295 MB."""
    spots = scene.spots
    if spots is None or spots.position.shape[0] == 0:
        return torch.zeros_like(position)
    b = position.shape[0]
    s = spots.position.shape[0]
    delta = spots.position[None] - position[:, None]             # (n, S, 3)
    dist2 = torch.clamp(torch.sum(delta ** 2, -1), min=1e-8)     # (n, S)
    wi = delta / torch.sqrt(dist2)[..., None]
    # spot cone falloff
    cos_d = torch.sum(-wi * spots.direction[None], -1)            # (n, S)
    t = (cos_d - spots.cutoff_cos[None]) / torch.clamp(
        spots.beam_cos[None] - spots.cutoff_cos[None], min=1e-6)
    falloff = torch.clamp(t, 0.0, 1.0)
    del delta, cos_d, t

    w_flat = wi.transpose(0, 1).reshape(-1, 3)                    # (S*n, 3)
    del wi
    pos_flat = position.repeat(s, 1)
    hit_pos, _, _, _, hit_valid = scene_intersect(
        scene, pos_flat + RAY_EPS * w_flat, w_flat)
    hit_d2 = torch.sum((hit_pos - pos_flat) ** 2, -1)
    del hit_pos, pos_flat
    d2_flat = dist2.t().reshape(-1)
    visible = (~hit_valid) | (hit_d2 >= d2_flat - 1e-4)           # (S*n,)
    del hit_d2, hit_valid

    brdf, _ = B.eval_brdf(w_flat, wo.repeat(s, 1), normal.repeat(s, 1),
                          {k: v.repeat(s, 1) for k, v in mat.items()})
    li = torch.repeat_interleave(spots.intensity, b, dim=0) \
        * falloff.t().reshape(-1, 1) / d2_flat[:, None]
    gate = (active.repeat(s) & visible)[:, None]
    contrib = torch.where(gate, brdf * li, 0.0)
    return contrib.reshape(s, b, 3).sum(0)


@torch.no_grad()
def relight_path_tracing(gen: torch.Generator | None, scene: RelightScene,
                         rays_o, rays_d, dx_du, dy_dv, spp: int,
                         max_depth: int, samples: dict | None = None):
    """Full-throughput NEE+MIS path tracer over the merged scene: (B, 3).
    Unlike the training integrators, every bounce contributes through the
    running throughput (no radiance cache).

    Traces per call, one kernel each and again on the sub-scene's tree
    where there is one: the camera rays, then per depth the emitter
    shadow rays, the spots' S x n shadow rays (where spots exist) and the
    bounce rays: (1 + D (2 + [spots])) (1 + [sub-scene]).

    Draws, in order, from `gen`: 'dudv' (2, B, spp, 1) in [-0.5, 0.5),
    then per depth 's1' (n,), 's2' (n, 2), 's1b' (n,), 's2b' (n, 2).
    `samples` replaces them all: 'dudv' and the per-depth draws stacked
    (D, ...), the JAX package's key stream replayed."""
    b = rays_o.shape[0]
    dev = rays_o.device
    if samples is None:
        dudv = draw_uniform(gen, (2, b, spp, 1), dev, -0.5, 0.5)
    else:
        dudv = samples["dudv"]
    du, dv = dudv[0], dudv[1]
    wi = normalize(rays_d[:, None] + dx_du[:, None] * du
                   + dy_dv[:, None] * dv).reshape(-1, 3)
    position = torch.repeat_interleave(rays_o, spp, dim=0)
    n = position.shape[0]

    position, normal, _, tri, _ = scene_intersect(scene, position, wi)
    l, _, active = eval_emitter(scene.emitter, position, wi, tri)
    wo = -wi
    throughput = torch.ones((n, 3), device=dev)
    mat = _surface_mat(scene, position, tri)

    for depth in range(max_depth):
        if samples is None:
            s1 = draw_uniform(gen, (n,), dev)
            s2 = draw_uniform(gen, (n, 2), dev)
            s1b = draw_uniform(gen, (n,), dev)
            s2b = draw_uniform(gen, (n, 2), dev)
        else:
            s1, s2 = samples["s1"][depth], samples["s2"][depth]
            s1b, s2b = samples["s1b"][depth], samples["s2b"][depth]

        # NEE on area emitters
        wi_e, e_pdf, e_tri = sample_emitter(scene.emitter, s1, s2, position)
        e_pos, e_nrm, _, hit_tri, e_valid = scene_intersect(
            scene, position + RAY_EPS * wi_e, wi_e)
        e_vis = (~e_valid) | (e_tri == hit_tri)
        e_weight, _, _ = eval_emitter(scene.emitter, e_pos, wi_e, hit_tri)
        g = torch.abs(dot(-wi_e, e_nrm, keepdims=False)) / torch.clamp(
            torch.sum((e_pos - position) ** 2, -1), min=1e-8)
        g = torch.where(e_valid, g, 1.0)[:, None]
        e_weight = e_weight * e_vis[:, None] * g / torch.clamp(e_pdf,
                                                               min=1e-8)
        e_brdf, b_pdf = B.eval_brdf(wi_e, wo, normal, mat)
        w_mis = _mis_power2(e_pdf, b_pdf * g, 0.0)
        dl = throughput * e_brdf * e_weight * w_mis
        l = l + torch.where(active[:, None]
                            & torch.isfinite(dl).all(-1)[:, None], dl, 0.0)

        # spot lights (delta): no MIS partner
        l = l + throughput * _spot_nee(scene, position, wo, normal, mat,
                                       active)

        # BRDF bounce
        wi_b, b_pdf2, b_weight = B.sample_brdf(s1b, s2b, wo, normal, mat)
        p_next, nrm_next, _, tri_next, _ = scene_intersect(
            scene, position + RAY_EPS * wi_b, wi_b)
        le, e_pdf2, valid_next = eval_emitter(scene.emitter, p_next, wi_b,
                                              tri_next)
        g2 = torch.abs(dot(-nrm_next, wi_b, keepdims=False)) / torch.clamp(
            torch.sum((position - p_next) ** 2, -1), min=1e-8)
        g2 = torch.where(valid_next, g2, 1.0)
        w_mis2 = _mis_power2(b_pdf2 * g2[:, None], e_pdf2, 0.0)
        throughput = throughput * b_weight
        dl = throughput * le * w_mis2
        l = l + torch.where(active[:, None]
                            & torch.isfinite(dl).all(-1)[:, None], dl, 0.0)

        if depth + 1 < max_depth:   # the last bounce's material is unused
            mat = _surface_mat(scene, p_next, tri_next)
        active = active & valid_next
        position, wo, normal = p_next, -wi_b, nrm_next
    return l.reshape(b, spp, 3).mean(1)


# ----------------------------------------------------------- disco ball

def fibonacci_sphere(n: int, phase: float = 0.0) -> np.ndarray:
    """Fibonacci-lattice points on the unit sphere (disco_ball.py:10-24)."""
    phi = (1 + 5 ** 0.5) / 2
    i = np.arange(n)
    theta = 2 * np.pi * i / phi
    z = 1 - (2 * i + 1) / n
    r = np.sqrt(np.maximum(1 - z * z, 0.0))
    return np.stack([r * np.cos(theta + phase), r * np.sin(theta + phase),
                     z], -1)


DISCO_COLORS = np.asarray([
    [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1],
], np.float32)


def make_disco_ball(position, radius, light_intensity, light_num=20,
                    light_radius_rate=0.1, spot_intensity=10,
                    spot_cutoff_angle=20.0, phase=0.0, device=None):
    """(shape dicts, SpotLights on `device`): the reference's procedural
    disco ball (utils/disco_ball.py:26-108) as native scene elements."""
    dev = resolve_device(device)
    position = np.asarray(position, np.float64)
    pts = fibonacci_sphere(light_num, phase)
    light_r = radius * light_radius_rate
    dist = radius - light_r * 0.6
    shapes = [{
        "kind": "sphere", "subdiv": 2,
        "to_world": [{"type": "translate", "value": position.tolist()},
                     {"type": "scale", "value": radius}],
        "bsdf": {"type": "diffuse", "reflectance": [0.2, 0.2, 0.2]},
    }]
    for i in range(light_num):
        color = DISCO_COLORS[i % len(DISCO_COLORS)]
        shapes.append({
            "kind": "sphere", "subdiv": 1,
            "to_world": [
                {"type": "translate",
                 "value": (pts[i] * dist + position).tolist()},
                {"type": "scale", "value": light_r}],
            "bsdf": {"type": "diffuse", "reflectance": [0, 0, 0]},
            "emitter": {"radiance": (color * light_intensity).tolist()},
        })
    spot_o = pts * (radius + light_r) + position
    cutoff = np.cos(np.radians(spot_cutoff_angle))
    beam = np.cos(np.radians(spot_cutoff_angle * 0.75))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    spots = SpotLights(
        position=t(spot_o),
        direction=t(pts),
        intensity=t(DISCO_COLORS[np.arange(light_num) % len(DISCO_COLORS)]
                    * spot_intensity),
        cutoff_cos=t(np.full((light_num,), cutoff)),
        beam_cos=t(np.full((light_num,), beam)),
    )
    return shapes, spots
