"""PyTorch port vs the JAX package: vector math, GGX and the BRDF lobes
(f32 on both sides, atol 1e-5; for quantities that carry the GGX peak,
~1/(pi alpha^2) up to ~1e6, 1e-5 of their largest magnitude)."""

import jax.numpy as jnp
import numpy as np
import pytest

from iris_tpu.core import ggx as jggx
from iris_tpu.core import vecmath as jvm
from iris_tpu.models import brdf as jbrdf
from iris_tpu_torch.core import ggx as tggx
from iris_tpu_torch.core import vecmath as tvm
from iris_tpu_torch.models import brdf as tbrdf
from torch_parity import tt

ATOL = 1e-5
N = 512


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0,
                               atol=atol)


@pytest.fixture
def data():
    rng = np.random.default_rng(7)
    n = _unit(rng, N)
    n[:8, 0] = 0.05                  # the |n.x| <= 0.1 tangent branch
    n[:8] /= np.linalg.norm(n[:8], axis=-1, keepdims=True)
    wo = _unit(rng, N)
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)
    wi = _unit(rng, N)
    wi = np.where((wi * n).sum(-1, keepdims=True) < 0, -wi, wi)
    mat = {
        "albedo": rng.uniform(0, 1, (N, 3)).astype(np.float32),
        "roughness": rng.uniform(0.02, 1, (N, 1)).astype(np.float32),
        "metallic": rng.uniform(0, 1, (N, 1)).astype(np.float32),
    }
    return dict(n=n.astype(np.float32), wo=wo.astype(np.float32),
                wi=wi.astype(np.float32), mat=mat,
                s1=rng.uniform(0, 1, N).astype(np.float32),
                s2=rng.uniform(0, 1, (N, 2)).astype(np.float32),
                v=rng.normal(size=(N, 3)).astype(np.float32) * 3)


def _j(d, k):
    return jnp.asarray(d[k])


def test_vecmath(data):
    v, n, wo = data["v"], data["n"], data["wo"]
    _close(jvm.normalize(jnp.asarray(v)), tvm.normalize(tt(v)))
    _close(jvm.dot(jnp.asarray(v), jnp.asarray(n)), tvm.dot(tt(v), tt(n)))
    _close(jvm.get_normal_space(jnp.asarray(n)),
           tvm.get_normal_space(tt(n)))
    _close(jvm.to_world(jvm.get_normal_space(jnp.asarray(n)),
                        jnp.asarray(wo)),
           tvm.to_world(tvm.get_normal_space(tt(n)), tt(wo)))
    th, ph = data["s2"][:, 0] * 3, data["s2"][:, 1] * 6
    _close(jvm.angle2xyz(jnp.asarray(th), jnp.asarray(ph)),
           tvm.angle2xyz(tt(th), tt(ph)))
    _close(jvm.double_sided(jnp.asarray(v), jnp.asarray(n)),
           tvm.double_sided(tt(v), tt(n)))
    _close(jvm.reflect(jnp.asarray(wo), jnp.asarray(n)),
           tvm.reflect(tt(wo), tt(n)))


def test_luminance(data):
    """Rec. 709 weights over the last axis: 1e-6 (three products summed in
    another order)."""
    rgb = np.abs(data["v"])
    _close(jvm.luminance(jnp.asarray(rgb)), tvm.luminance(tt(rgb)), 1e-6)
    assert tvm.luminance(tt(rgb)).shape == (N, 1)


def test_ggx(data):
    x = data["s2"][:, :1]
    r = data["mat"]["roughness"]
    jd = jggx.d_ggx(jnp.asarray(x), jnp.asarray(r))
    # the NDF peaks near 1/(pi alpha^2): compare relative to its scale
    _close(jd, tggx.d_ggx(tt(x), tt(r)),
           atol=ATOL * max(1.0, float(np.abs(jd).max())))
    _close(jggx.g_smith(jnp.asarray(x), jnp.asarray(data["s1"][:, None]),
                        jnp.asarray(r)),
           tggx.g_smith(tt(x), tt(data["s1"][:, None]), tt(r)))
    _close(jggx.fresnel_schlick(jnp.asarray(x), jnp.asarray(r)),
           tggx.fresnel_schlick(tt(x), tt(r)))
    for a, b in zip(jggx.fresnel_schlick_sep(jnp.asarray(x)),
                    tggx.fresnel_schlick_sep(tt(x))):
        _close(a, b)


def test_eval_brdf(data):
    jm = {k: jnp.asarray(v) for k, v in data["mat"].items()}
    tm = {k: tt(v) for k, v in data["mat"].items()}
    jb, jp = jbrdf.eval_brdf(_j(data, "wi"), _j(data, "wo"), _j(data, "n"),
                             jm)
    tb, tp = tbrdf.eval_brdf(tt(data["wi"]), tt(data["wo"]), tt(data["n"]),
                             tm)
    # brdf and pdf carry the GGX peak: compare relative to their scale
    _close(jb, tb, atol=ATOL * max(1.0, float(np.abs(jb).max())))
    _close(jp, tp, atol=ATOL * max(1.0, float(np.abs(jp).max())))


def test_sample_brdf(data):
    jm = {k: jnp.asarray(v) for k, v in data["mat"].items()}
    tm = {k: tt(v) for k, v in data["mat"].items()}
    jwi, jpdf, jw = jbrdf.sample_brdf(_j(data, "s1"), _j(data, "s2"),
                                      _j(data, "wo"), _j(data, "n"), jm)
    twi, tpdf, tw = tbrdf.sample_brdf(tt(data["s1"]), tt(data["s2"]),
                                      tt(data["wo"]), tt(data["n"]), tm)
    _close(jwi, twi)
    # pdf and brdf/pdf grow like the GGX peak: compare relative to scale
    _close(jpdf, tpdf, atol=ATOL * max(1.0, float(np.abs(jpdf).max())))
    _close(jw, tw, atol=ATOL * max(1.0, float(np.abs(jw).max())))


@pytest.mark.parametrize("rough", ["per_ray", "scalar"])
def test_sample_specular(data, rough):
    r = data["mat"]["roughness"] if rough == "per_ray" else 0.3
    jr = jnp.asarray(r) if rough == "per_ray" else r
    tr = tt(r) if rough == "per_ray" else r
    j = jbrdf.sample_specular(_j(data, "s2"), _j(data, "wo"), _j(data, "n"),
                              jr)
    t = tbrdf.sample_specular(tt(data["s2"]), tt(data["wo"]), tt(data["n"]),
                              tr)
    for a, b in zip(j, t):
        _close(a, b, atol=ATOL * max(1.0, float(np.abs(a).max())))
