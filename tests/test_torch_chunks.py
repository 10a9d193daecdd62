"""One-dispatch training chunks of the PyTorch port on the CPU: the
update math every device runs (the device schedule, Adam over tensor
rates) inside a chunk against optax across a milestone and through a
resume, the kernels' launch counts as read from a stand-in library, the
replays, observers and static batches of utils/graphs.py with stand-ins
for the CUDA calls, and the hooks that refuse what a graph cannot run.
The graphed chunk against eager steps bit for bit is a card test
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_graph_stand_in
from iris_tpu_torch.train import checkpoint as ck
from iris_tpu_torch.train import loop
from iris_tpu_torch.train.loop import make_train_chunk
from iris_tpu_torch.train.optim import DeviceSchedule, make_optimizer
from iris_tpu_torch.utils import graphs

TARGET = np.linspace(-1.0, 2.0, 12).astype(np.float32).reshape(3, 4)


def _loss(p, batch, gen, samples=None):
    """A quadratic pulled toward the batch's target, with a drawn weight."""
    w = torch.rand((), generator=gen) + 0.5
    loss = torch.sum(w * (p["w"] - torch.as_tensor(batch["t"])) ** 2) \
        + torch.sum(p["b"] ** 2)
    return loss, {"w": w}


def _batches(n):
    return [{"t": TARGET * (1 + 0.1 * i)} for i in range(n)]


def _device_opt(**kw):
    return make_optimizer(learning_rate=0.1, milestones=(2, 5),
                          scheduler_rate=0.3, **kw)


def _params():
    return {"w": torch.zeros(3, 4), "b": torch.ones(2)}


def test_device_schedule_in_a_chunk_matches_optax():
    """A chunk of 7 steps straddling two milestones, with the update the
    card runs (DeviceSchedule, Adam over tensor rates) on the CPU: the
    rates are optax.piecewise_constant_schedule's at every step and the
    parameters optax.adam's over them, to float32 rounding."""
    opt = _device_opt()
    params = _params()
    state = opt.init(params)
    assert isinstance(state["sched"], DeviceSchedule)
    chunk = make_train_chunk(_loss, opt, 7)
    _, _, losses, auxes = chunk(params, state, _batches(7), 3, 0)
    assert losses.shape == (7,) and set(auxes) == {"w"}
    assert int(state["sched"].last_epoch) == 7

    sched = optax.piecewise_constant_schedule(0.1, {2: 0.3, 5: 0.3})
    rates = [float(sched(i)) for i in range(8)]
    assert float(state["opt"].param_groups[0]["lr"]) == pytest.approx(
        rates[7], rel=1e-6)
    tx = optax.adam(sched)
    jp = {"w": jnp.zeros((3, 4)), "b": jnp.ones(2)}
    jo = tx.init(jp)
    for i, (batch, w) in enumerate(zip(_batches(7), auxes["w"].numpy())):
        g = {"w": 2 * w * (jp["w"] - batch["t"]), "b": 2 * jp["b"]}
        upd, jo = tx.update(g, jo, jp)
        jp = optax.apply_updates(jp, upd)
    for name in ("w", "b"):
        np.testing.assert_allclose(params[name].numpy(),
                                   np.asarray(jp[name]), rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("chunk_steps", [1, 3])
def test_device_state_resume_is_bit_for_bit(tmp_path, chunk_steps):
    """The card's optimizer state (tensor rates and the schedule's step
    count) saved after 4 of 7 steps and restored gives the uninterrupted
    run's parameters, moments and rates, every bit."""
    opt = _device_opt()
    kw = dict(seed=3, log_fn=None, chunk_steps=chunk_steps,
              return_state=True)
    full, full_state = loop.run_training(_loss, _params(), iter(_batches(7)),
                                         opt, 7, **kw)
    path = str(tmp_path / "state.pkl")
    loop.run_training(_loss, _params(), iter(_batches(4)), opt, 4,
                      state_hooks=[ck.make_state_saver(path, every=4)], **kw)
    params, state, start = ck.load_train_state(
        path, str(tmp_path / "none.pkl"), _params(), optimizer=opt,
        device="cpu")
    assert start == 4 and int(state["sched"].last_epoch) == 4
    assert state["opt"].param_groups[0]["lr"] is state["sched"].lrs[0]
    resumed, res_state = loop.run_training(
        _loss, params, iter(_batches(7)[4:]), opt, 7, opt_state=state,
        start_step=4, **kw)
    for name in ("w", "b"):
        assert torch.equal(resumed[name], full[name])
    a = ck.opt_state_to_numpy(res_state)
    b = ck.opt_state_to_numpy(full_state)
    assert a["sched"]["last_epoch"] == b["sched"]["last_epoch"] == 7
    for i in a["opt"]["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            np.testing.assert_array_equal(a["opt"]["state"][i][key],
                                          b["opt"]["state"][i][key])
    assert float(res_state["opt"].param_groups[0]["lr"]) == \
        float(full_state["opt"].param_groups[0]["lr"])


def test_device_sgd_steps_at_the_schedules_rate():
    opt = _device_opt(optimizer="SGD")
    params = _params()
    state = opt.init(params)
    grads = {"w": torch.ones(3, 4), "b": torch.full((2,), 2.0)}
    for _ in range(3):
        opt.update(params, grads, state)
    # rates 0.1, 0.1, 0.03 (the milestone at step 2)
    np.testing.assert_allclose(params["w"].numpy(), -0.23, rtol=1e-6)
    np.testing.assert_allclose(params["b"].numpy(), 1 - 0.46, rtol=1e-6)


class _CountingLibrary:
    """What the traversal library's count entries do on the card: its
    kernels add to {launches, rays} rows, in KERNELS order, that
    iris_read_counts copies out and iris_reset_counts clears."""

    def __init__(self, rows):
        self.rows = rows

    def iris_read_counts(self, out):
        for i, (n, rays) in enumerate(self.rows):
            out[2 * i], out[2 * i + 1] = n, rays
        return 0

    def iris_reset_counts(self):
        self.rows = [(0, 0)] * len(self.rows)
        return 0


def test_kernel_counts_read_the_kernels_rows(monkeypatch):
    """The launch and ray counts the kernels keep on the card, read by
    wrapper name in KERNELS order and cleared; zero while the library is
    not loaded and for a CPU device; a failed read raises."""
    from iris_tpu_torch.geometry import cuda_intersect as ci

    monkeypatch.setattr(ci, "_LIB", None)
    assert ci.launch_counts() == dict.fromkeys(ci.KERNELS, 0)
    lib = _CountingLibrary([(i, 1000 * i + 7) for i in
                            range(len(ci.KERNELS))])
    monkeypatch.setattr(ci, "_LIB", lib)
    got = ci.kernel_counts()
    assert list(got) == list(ci.KERNELS)
    assert got["trace_union"] == (0, 7)
    assert got["trace_paired_streamed"] == (4, 4007)
    assert ci.launch_counts()["trace_dense_streamed"] == 6
    assert ci.launch_counts("cpu") == dict.fromkeys(ci.KERNELS, 0)
    ci.reset_kernel_counts()
    assert ci.kernel_counts() == dict.fromkeys(ci.KERNELS, (0, 0))
    monkeypatch.setattr(lib, "iris_read_counts", lambda out: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ci.kernel_counts()


class _Observer:
    def __init__(self):
        self.seen = []

    def captured(self, graph):
        self.seen.append(("captured", graph.capture_s >= 0))

    def replayed(self, graph, seeds, start, end):
        self.seen.append(("replayed", list(seeds), start.enable_timing,
                          end.enable_timing))


def test_replay_reseeds_and_tells_its_observers(monkeypatch):
    """A capture needs a warm context; the generators are registered and
    reseeded before each replay, which re-issues the recorded work and
    nothing else; an observer is told of the capture and of each replay
    with its seeds and timing events, and of nothing once it has left."""
    made = torch_graph_stand_in.use(monkeypatch, rerun=False)
    calls = []

    def fn():
        calls.append(1)
        return "out"

    ctx = graphs.GraphContext("cpu")
    with pytest.raises(RuntimeError, match="warm-up"):
        ctx.capture(fn)
    ctx.warm = True
    gens = [torch.Generator(), torch.Generator()]
    with graphs.observing(_Observer()) as ob:
        g = ctx.capture(fn, gens)
        assert made[0].generators == gens
        for i in range(3):
            assert g.replay([10 + i, 20 + i]) == "out"
            assert [x.initial_seed() for x in gens] == [10 + i, 20 + i]
    assert g.replay([1, 2]) == "out"
    assert made[0].replays == 4 and len(calls) == 1
    assert ob.seen == [("captured", True)] + [
        ("replayed", [10 + i, 20 + i], True, True) for i in range(3)]
    with pytest.raises(ValueError, match="1 seeds for 2"):
        g.replay([1])


def test_static_batches_one_copy_and_views(monkeypatch):
    """A chunk's columns stacked into one buffer, read back as each step's
    batch; None stays None; a column that changes shape raises."""
    torch_graph_stand_in.use(monkeypatch)
    rng = np.random.default_rng(0)

    def chunk():
        return [{"rays": rng.normal(size=(5, 12)).astype(np.float32),
                 "seg": rng.integers(0, 9, 5).astype(np.int32),
                 "exposure": None} for _ in range(3)]

    first = chunk()
    sb = graphs.StaticBatches(first, "cpu")
    # 720 bytes of rays and 60 of ids, each column 256-byte aligned
    assert sb.buf.numel() == 768 + 256
    for batches in (first, chunk()):
        sb.fill(batches)
        for j, b in enumerate(batches):
            v = sb.views[j]
            assert v["exposure"] is None
            assert torch.equal(v["rays"], torch.from_numpy(b["rays"]))
            assert v["seg"].dtype == torch.int32
            assert torch.equal(v["seg"], torch.from_numpy(b["seg"]))
    bad = chunk()
    bad[1]["rays"] = bad[1]["rays"][:4]
    with pytest.raises(ValueError, match="rays"):
        sb.fill(bad)
    with pytest.raises(ValueError, match="2 batches"):
        sb.fill(first[:2])


def test_replayed_draws_refuse_a_graph(monkeypatch):
    """samples_for_step replays draws into eager steps; a chunk on the
    card is a graph with generators of its own, so it raises there."""
    monkeypatch.setattr(loop, "_params_device",
                        lambda p: torch.device("cuda"))
    chunk = make_train_chunk(_loss, _device_opt(), 2)
    with pytest.raises(ValueError, match="samples_for_step"):
        chunk(_params(), None, _batches(2), 0, 0,
              samples_for_step=lambda s: None)
    with pytest.raises(ValueError, match="3 batches for a chunk of 2"):
        chunk(_params(), None, _batches(3), 0, 0)
