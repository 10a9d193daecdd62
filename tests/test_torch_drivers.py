"""The port's twins of the root scripts (iris_tpu_torch.bench,
bench_components, bench_scaling, graft_entry) against the JAX package's
scripts, on the CPU at small sizes.

- the benchmark loss and its gradients against bench.py's, under replayed
  keys, with test_torch_train's tolerances (loss rtol 2e-3; each gradient
  leaf cosine >= 0.9999 and within 2% in norm, the bf16 compact scatter);
- bench.main's JSON line, with the timing stubbed (a CPU time is no device
  time: unstubbed, it raises);
- graft_entry.entry()'s forward against __graft_entry__.entry()'s, under
  the JAX key's draws, at the render tolerance (rtol 2e-3, atol 1e-4);
- dryrun_multichip over two gloo ranks against the same step with no
  group (1e-4 relative), and its refusal of NCCL ranks without cards;
- the components' scalars against the JAX expressions;
- bench_scaling's lines over one and two gloo ranks.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tpu.demo import make_demo_scene as jax_demo_scene
from iris_tpu.geometry.intersect import ray_intersect as jax_intersect
from iris_tpu.geometry.procedural import camera_rays
from iris_tpu.models import hashgrid as jhash
from iris_tpu_torch import (bench, bench_components, bench_scaling, demo,
                            graft_entry)
from iris_tpu_torch.models import hashgrid as thash
from iris_tpu_torch.train.loop import value_and_grad
from test_torch_train import _bench_draws, _bench_loss_jax, _check_grads
from torch_parity import (jax_single_draws, one_torch_thread,  # noqa: F401
                          port_crf, port_emitter, port_ngp, port_tracer, tt)

JAX_BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
                  "rays_per_s_102k_faces", "kernel_mode_102k"}


def _ported_scene(asked):
    """A stand-in for iris_tpu_torch.demo.make_demo_scene: the JAX demo
    scene of the same arguments, carried into the port; each call's
    arguments are appended to `asked`."""

    def make(n_clutter=8, device=None, **kw):
        asked.append(dict(n_clutter=n_clutter, **kw))
        tracer, em, ngp, crf, mesh = jax_demo_scene(n_clutter=n_clutter,
                                                    **kw)
        return (port_tracer(tracer), port_emitter(em), port_ngp(ngp),
                port_crf(crf), mesh), (tracer, em, ngp, crf)

    return make


@pytest.fixture
def small_bench(monkeypatch):
    """The benchmark at 64 rays, spp 2 and a 2^10 table."""
    monkeypatch.setattr(bench, "BATCH", 64)
    monkeypatch.setattr(bench, "SPP", 2)
    monkeypatch.setattr(bench, "LOG2_TABLE", 10)


def test_bench_loss_matches_jax(small_bench, monkeypatch):
    """bench.setup's loss and gradients on the JAX bench's scene and model
    (carried across) against bench.py's loss under the same key's draws:
    loss rtol 2e-3, the nine gradient leaves by _check_grads at the bf16
    compact scatter's bound; one level block of the table gradient
    nonzero (bwd_level_sample = 1 of 4 levels)."""
    asked, jax_side = [], {}
    make = _ported_scene(asked)

    def scene(*a, **kw):
        port, jax_side["scene"] = make(*a, **kw)
        return port

    monkeypatch.setattr(demo, "make_demo_scene", scene)
    _, _, rays, params, loss_fn = bench.setup(bench.FLAGSHIP, "cpu")
    assert asked == [dict(n_clutter=32, slf_res=64, hash_levels=4,
                          log2_table=10, hash_features=16,
                          per_level_scale=-1.0)]
    assert rays.shape == (64, 12)
    jt, je, jn, jc = jax_side["scene"]
    # bench.py's train config: stochastic corners, auto level blocks
    jn = dataclasses.replace(jn, cfg=dataclasses.replace(
        jn.cfg, stochastic_fwd=True, stochastic_bwd=True,
        bwd_level_sample=jhash.auto_bwd_level_sample(4)))
    assert params["material"].cfg == thash.HashGridConfig(**{
        f: getattr(jn.cfg, f) for f in
        (x.name for x in dataclasses.fields(thash.HashGridConfig))})
    key = jax.random.PRNGKey(8)
    jparams = {"material": jn, "radiance": je.radiance, "crf_w": jc.weight}
    (val, _), grads = jax.jit(jax.value_and_grad(
        _bench_loss_jax(jt, je, jn.cfg, jc, rays.numpy(), 0.5),
        has_aux=True))(jparams, {}, key)
    loss, _, pgrads = value_and_grad(loss_fn, params, {}, None,
                                     _bench_draws(key, jn.cfg, 64))
    np.testing.assert_allclose(float(loss), float(val), rtol=2e-3)
    assert _check_grads(pgrads, grads, rel=0.02) == 9
    blocks = pgrads["material.table"].abs().reshape(4, -1).sum(1) > 0
    assert int(blocks.sum()) == 1


def _one_call(fn, seed, iters=16, device=None, call_times=None):
    """bench_scan cut to one call of fn, with a stand-in time."""
    out = fn(torch.Generator().manual_seed(seed))
    assert out.dim() == 0 and torch.isfinite(out)
    call_times.append(0.25)
    return 0.25


@pytest.mark.parametrize("small_only", [True, False])
def test_bench_main_prints_the_jax_keys(small_bench, monkeypatch, capsys,
                                        small_only):
    """One JSON line: the JAX keys without vs_baseline, plus device and the
    runs' details; the 102K keys only without --small-only (here a
    600-box scene past resident gates lowered to 2 MB, so that it takes
    the 102K scene's kernel)."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    monkeypatch.setattr(bench, "bench_scan", _one_call)
    monkeypatch.setattr(bench, "CLUTTER_102K", 600)
    for gate in ("PAIRED_RESIDENT_BYTES", "DENSE_RESIDENT_BYTES",
                 "RESIDENT_BYTES"):
        monkeypatch.setattr(ci, gate, 2_000_000)
    argv = ["--device", "cpu"] + (["--small-only"] if small_only else [])
    out = bench.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    want = JAX_BENCH_KEYS - {"vs_baseline"}
    if small_only:
        want -= {"rays_per_s_102k_faces", "kernel_mode_102k"}
    assert set(out) == want | {"device", "runs"}
    assert out["metric"] == "train_fwd_bwd_rays_per_s"
    assert out["unit"] == "rays/s/chip"
    assert out["value"] == 64 * 2 / 0.25
    assert out["device"] == {"name": "cpu"}
    head = out["runs"]["flagship"]
    assert head["faces"] == 398 and head["kernel_mode"] == "trace_union"
    assert head["calls"] == bench.ITERS + 1 and head["s_per_call"] == [0.25]
    # the plain walks on CPU tensors launch nothing
    assert head["launches"] == {}
    if not small_only:
        assert out["kernel_mode_102k"] == "trace_paired_streamed"
        assert out["runs"]["clutter102k"]["faces"] == 12 * 601 + 2


def test_bench_refuses_to_time_the_cpu(small_bench):
    with pytest.raises(RuntimeError, match="needs the card"):
        bench.main(["--small-only", "--device", "cpu"])


def test_graft_entry_forward_matches_jax(monkeypatch):
    """entry(device="cpu")'s fn on the JAX entry's scene and model (carried
    across), under the draws of the JAX entry's key: the LDR within rtol
    2e-3 / atol 1e-4, in [0, 1]; the example rays the JAX entry's."""
    import __graft_entry__ as jentry

    asked = []
    make = _ported_scene(asked)
    monkeypatch.setattr(graft_entry, "make_demo_scene",
                        lambda *a, **kw: make(*a, **kw)[0])
    fn, args = graft_entry.entry(device="cpu")
    assert asked == [dict(n_clutter=8, hash_levels=8, hash_features=8,
                          log2_table=15)]
    jfn, jargs = jentry.entry()
    for a, j in zip(args[:4], jargs[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    assert isinstance(args[4], torch.Generator)
    ref = np.asarray(jax.jit(jfn)(*jargs))
    with torch.no_grad():
        out = fn(*args[:4], None, samples=jax_single_draws(
            jargs[4], args[0].shape[0], 4)).numpy()
    assert out.shape == (1024, 3)
    assert out.min() >= 0 and out.max() <= 1
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=1e-4)


def test_dryrun_multichip_matches_no_group(capsys):
    """Two gloo ranks on the CPU, each a spawned process: the loss finite
    and within 1e-4 relative of the same step in one process."""
    loss = graft_entry.dryrun_multichip(2, device="cpu")
    ref = graft_entry.dryrun_step(2, device="cpu")
    assert np.isfinite(loss)
    assert abs(loss - ref) <= 1e-4 * abs(ref)
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"dryrun_multichip(2): OK  loss={loss:.6f}")


@pytest.mark.parametrize("cards", [0, 1])
def test_dryrun_multichip_refuses_missing_cards(monkeypatch, cards):
    """NCCL ranks take one card each: with no card, or one for two ranks,
    the dry run raises before it starts a rank (the JAX dry run falls back
    to CPU devices)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    match = "need a card each" if cards else "no CUDA device"
    with pytest.raises(RuntimeError, match=match):
        graft_entry.dryrun_multichip(2)


N_QUERIES = 4096


def _jax_table_and_x(levels=16):
    cfg = jhash.HashGridConfig(n_levels=levels, log2_table_size=10,
                               stochastic_bwd=False)
    table = jhash.init_hashgrid(jax.random.PRNGKey(7), cfg)
    x = jax.random.uniform(jax.random.PRNGKey(1), (N_QUERIES, 3))
    pcfg = thash.HashGridConfig(**{
        f.name: getattr(cfg, f.name) for f in
        dataclasses.fields(thash.HashGridConfig)})
    return cfg, table, x, pcfg


def test_component_traversal_face_sum():
    """traversal_rays_per_s's scalar: the face ids' sum on jittered camera
    rays of the flagship tree, the JAX expression's exactly."""
    jt = jax_demo_scene(n_clutter=32, slf_res=8, hash_levels=2,
                        log2_table=8)[0]
    o, d, *_ = camera_rays(16)
    u = jax.random.uniform(jax.random.PRNGKey(0), (1, 3))
    ref = int(jax_intersect(jt, jnp.asarray(o) + u * 0.2,
                            jnp.asarray(d))[3].sum())
    got = bench_components.face_sum(port_tracer(jt),
                                    tt(o) + tt(np.asarray(u)) * 0.2, tt(d))
    assert int(got) == ref


def test_component_exact_encode_forward():
    """hashgrid16_fwd_queries_per_s's scalar: the exact packed encode of
    4,096 positions, features within 1e-6 (bf16 words read alike) and the
    sum within 1e-5 of the features' absolute sum (float32 sums in
    another order)."""
    cfg, table, x, pcfg = _jax_table_and_x()
    feats = np.asarray(jhash.hashgrid_encode(table, cfg, x))
    got = thash.hashgrid_encode(tt(np.asarray(table)), pcfg,
                                tt(np.asarray(x))).numpy()
    np.testing.assert_allclose(got, feats, atol=1e-6)
    s = float(bench_components.encode_sum(tt(np.asarray(table)), pcfg,
                                          tt(np.asarray(x))))
    assert abs(s - float(feats.sum())) <= 1e-5 * np.abs(feats).sum()


def test_component_exact_encode_table_gradient():
    """hashgrid16_exact_fwd_bwd_queries_per_s: the whole table gradient of
    the feature sum, entry by entry within 1e-5 (segment sums in another
    order than JAX's scatter), and its sum."""
    cfg, table, x, pcfg = _jax_table_and_x()
    ref = np.asarray(jax.grad(
        lambda t: jhash.hashgrid_encode(t, cfg, x).sum())(table))
    t = tt(np.asarray(table)).requires_grad_(True)
    (g,) = torch.autograd.grad(bench_components.encode_sum(
        t, pcfg, tt(np.asarray(x))), t)
    np.testing.assert_allclose(g.numpy(), ref, atol=1e-5)
    s = float(bench_components.encode_grad_sum(tt(np.asarray(table)), pcfg,
                                               tt(np.asarray(x))))
    np.testing.assert_allclose(s, float(jnp.sum(ref)), rtol=1e-5)


def test_bench_scaling_lines_over_gloo_ranks(capsys):
    """--device cpu --max_ranks 2: one line a rank count (1, 2), with the
    JAX harness's keys, backend gloo and the device."""
    out = bench_scaling.main(["--device", "cpu", "--max_ranks", "2",
                              "--batch", "64", "--spp", "2", "--iters",
                              "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == out
    assert [ln["devices"] for ln in lines] == [1, 2]
    for ln in lines:
        assert set(ln) == {"metric", "devices", "value", "unit",
                           "efficiency_vs_linear", "backend", "device"}
        assert ln["metric"] == "scaling_rays_per_s"
        assert ln["unit"] == "rays/s" and ln["backend"] == "gloo"
        assert ln["device"] == {"name": "cpu"} and ln["value"] > 0
    assert lines[0]["efficiency_vs_linear"] == 1.0


def test_bench_scaling_rank_counts(monkeypatch):
    """Powers of two up to --max_ranks; by default the cards visible for
    NCCL ranks, one rank otherwise."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert bench_scaling.rank_counts("cuda", None, None) == [1, 2, 4]
    assert bench_scaling.rank_counts("cuda", "gloo", None) == [1]
    assert bench_scaling.rank_counts("cpu", None, 6) == [1, 2, 4]
    assert bench_scaling.rank_counts("cpu", "gloo", None) == [1]
