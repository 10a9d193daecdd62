"""Process groups for data-parallel training (counterpart of
iris_tpu/parallel/distributed.py).

The JAX package joins hosts with jax.distributed.initialize, from the
IRIS_TPU_MULTIHOST, IRIS_TPU_NUM_PROCESSES and IRIS_TPU_MULTIHOST_TIMEOUT
environment variables, and lets GSPMD route the gradient psum. The port
reads no environment variable: ensure_multihost takes the coordinator, the
process count, this process's id and the timeout as arguments (the
trainer CLIs' --coordinator, --num_processes, --process_id and
--dist_backend), joins a torch.distributed process group and returns a
RankGroup, the object that run_training and the losses' gather take.

Failure policy (as the JAX package's): once a coordinator is given, any
failure to reach the expected process count is a RuntimeError that names
the coordinator; a run asked to spread never goes on alone, on fewer
ranks or on the CPU in its place.

Backends: NCCL on the card, gloo on the CPU, or the one the caller names.
Gloo also takes CUDA tensors for the three collectives a step uses (torch
2.11 on the H100: all-reduce, broadcast and all-gather), which is how two
ranks share one card: NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from iris_tpu_torch.train.optim import named_leaves


def _all_gather_single(out, x, group):
    # torch 2.13 renamed all_gather_into_tensor, and warns on the old name
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


@dataclass
class RankGroup:
    """One process of a data-parallel run: its rank, the world size, the
    device its tensors live on, the backend and the torch.distributed
    process group. Its three collectives are all a step sends; each call
    is appended to `calls` as (kind, bytes) while `calls` is a list
    (parallel/comms_report.py counts them so)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    process_group: object = None
    owned: bool = False               # this group started torch.distributed
    calls: list | None = field(default=None, repr=False)

    def _run(self, kind, t, op):
        """op(t), in place. NCCL takes device tensors only: a host tensor
        (Adam's step count) goes through the group's device and back."""
        if self.calls is not None:
            self.calls.append((kind, t.numel() * t.element_size()))
        if self.backend != "nccl" or t.device.type == "cuda":
            op(t)
            return
        tmp = t.to(self.device)
        op(tmp)
        t.copy_(tmp)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, in place."""
        self._run("all_reduce", t, lambda x: dist.all_reduce(
            x, group=self.process_group))
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """t replaced by rank src's, in place."""
        self._run("broadcast", t, lambda x: dist.broadcast(
            x, src, group=self.process_group))
        return t

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(N*B, ...): every rank's (B, ...) rows, rank 0's first."""
        x = x.contiguous()
        if self.calls is not None:
            self.calls.append(("all_gather",
                               self.world_size * x.numel() * x.element_size()))
        out = x.new_empty((self.world_size * x.shape[0],) + x.shape[1:])
        _all_gather_single(out, x, self.process_group)
        return out

    def close(self) -> None:
        """End torch.distributed if this group started it."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        self.owned = False


def is_lead(group: RankGroup | None) -> bool:
    """True on the process that writes files and logs: rank 0, or the one
    process of a run without a group."""
    return group is None or group.rank == 0


def ensure_multihost(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout_s: float = 300.0, backend: str | None = None,
                     device=None) -> RankGroup | None:
    """Join the data-parallel run that `coordinator` names (a
    torch.distributed init_method: tcp://host:port or file://path) as
    process `process_id` of `num_processes`, on `device` (default the
    card), with `backend` (default NCCL on the card, gloo on the CPU).
    Returns the RankGroup, or None without a coordinator (a plain
    one-process run: nothing is started).

    Raises RuntimeError, naming the coordinator, when the group cannot be
    joined within timeout_s (a dead coordinator, fewer processes than
    asked) or has another size. Called again while a group is up (a second
    stage in the same process), it re-validates the count and returns
    that group, not owned."""
    if coordinator is None:
        if num_processes not in (None, 1) or process_id not in (None, 0):
            raise ValueError(
                f"num_processes={num_processes}, process_id={process_id} "
                "need a coordinator")
        return None
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator={coordinator!r} needs num_processes "
                         "and process_id")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"multihost requested (coordinator={coordinator!r}) on "
                f"{dev}, but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    owned = not dist.is_initialized()
    if owned:
        try:
            dist.init_process_group(
                backend, init_method=coordinator,
                world_size=int(num_processes), rank=int(process_id),
                timeout=datetime.timedelta(seconds=timeout_s))
        except (RuntimeError, ValueError, OSError) as e:
            raise RuntimeError(
                f"multihost requested (coordinator={coordinator!r}, "
                f"{num_processes} processes) but "
                f"torch.distributed.init_process_group failed: {e}") from e
    got = dist.get_world_size()
    if got != int(num_processes) or dist.get_rank() != int(process_id):
        raise RuntimeError(
            f"multihost requested with {num_processes} processes (this one "
            f"{process_id}) but the process group has {got} (this one "
            f"{dist.get_rank()}); refusing to train on a part of the data")
    return RankGroup(rank=dist.get_rank(), world_size=got, device=dev,
                     backend=dist.get_backend(), owned=owned)


def spawn_ranks(fn, devices, backend: str, args=()) -> list:
    """fn(group, *args) on len(devices) spawned processes, rank r on
    devices[r], joined in one `backend` group through a file:// rendezvous
    in a temporary directory (no port to pick); each rank's return value,
    by rank. fn must be a module-level function (a spawned process imports
    it by name), its result picklable. A rank that raises fails the call.
    Each rank gets an equal share of this process's intra-op threads."""
    import os
    import pickle
    import shutil
    import tempfile

    n = len(devices)
    tmp = tempfile.mkdtemp(prefix="iris_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _spawned_rank,
            args=(fn, "file://" + os.path.join(tmp, "rendezvous"), devices,
                  backend, args, tmp, max(1, torch.get_num_threads() // n)),
            nprocs=n, join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spawned_rank(rank, fn, coordinator, devices, backend, args, out_dir,
                  n_threads):
    import os
    import pickle

    torch.set_num_threads(n_threads)
    group = ensure_multihost(coordinator, len(devices), rank,
                             backend=backend, device=devices[rank])
    try:
        out = fn(group, *args)
    finally:
        group.close()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows, one all-gather. Backward: the rank's
    rows of the incoming gradient times N, and no communication. Every
    rank computes the same loss from the same gathered rows, so the
    gradient of its own rows is that slice; the factor N undoes the
    average that the gradient all-reduce takes after the backward, so that
    the per-ray terms add up over the ranks as over one batch while a
    term of the parameters alone counts once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        m = g.shape[0] // group.world_size
        return g.narrow(0, group.rank * m, m) * group.world_size, None


def gather_rows(rows: dict, group: RankGroup | None) -> dict:
    """A dict of per-ray tensors (B, ...) of this rank -> the same dict
    over every rank's rows (N*B, ...), rank 0's first, with the gradient
    path of _GatherRows. The tensors go as the columns of one float32
    (B, C) tensor, so that a step makes one all-gather; a bool column
    comes back as bool, any other as float32. With no group, `rows`
    itself."""
    if group is None:
        return rows
    names = list(rows)
    b = rows[names[0]].shape[0]
    cols = [rows[k].reshape(b, -1).to(torch.float32) for k in names]
    widths = [c.shape[1] for c in cols]
    every = _GatherRows.apply(torch.cat(cols, 1), group)
    out, at = {}, 0
    for k, w in zip(names, widths):
        t = rows[k]
        col = every[:, at:at + w].reshape((-1,) + tuple(t.shape[1:]))
        out[k] = col > 0.5 if t.dtype == torch.bool else col
        at += w
    return out


def host_summary(group: RankGroup | None) -> str:
    if group is None:
        return "one process, no group"
    return (f"process {group.rank}/{group.world_size} on {group.device}, "
            f"backend {group.backend}")


def _state_tensors(params, opt_state):
    """Every parameter leaf, then every tensor of the optimizer's state, in
    an order every rank shares (named_leaves order; keys sorted)."""
    leaves = [t for _, t in named_leaves(params)]
    out = list(leaves)
    if opt_state is not None:
        state = opt_state["opt"].state
        for leaf in leaves:
            st = state.get(leaf, {})
            out += [st[k] for k in sorted(st)
                    if isinstance(st[k], torch.Tensor)]
    return out


def global_replicate(params, opt_state, group: RankGroup) -> None:
    """Rank 0's parameters and optimizer state on every rank, in place (the
    JAX package's global_replicate places one host's values on every
    device): at the start of a run, and after a resume that every rank
    loaded. Then checks that every rank holds the same bits."""
    with torch.no_grad():
        for t in _state_tensors(params, opt_state):
            group.broadcast_(t)
    check_replicated(params, opt_state, group)


def bits_digest(t: torch.Tensor) -> torch.Tensor:
    """An int64 digest (1,) of t's bits, a position-weighted sum of its
    32-bit or byte words (wrapping), computed on t's device without a host
    sync: equal bits give equal digests."""
    t = t.detach().contiguous().reshape(-1)
    if t.element_size() == 4:
        words = t.view(torch.int32).to(torch.int64)
    else:
        words = t.view(torch.uint8).to(torch.int64)
    weight = torch.arange(1, words.numel() + 1, device=words.device,
                          dtype=torch.int64) % 1_000_003 + 1
    return torch.sum(words * weight).reshape(1)


def check_replicated(params, opt_state, group: RankGroup) -> None:
    """Raise RuntimeError unless every rank holds the same bits in every
    parameter and optimizer-state tensor (one gather of a digest each)."""
    tensors = _state_tensors(params, opt_state)
    if not tensors:
        return
    mine = torch.cat([bits_digest(t).to(group.device) for t in tensors])
    every = group.all_gather_rows(mine[None]).reshape(group.world_size, -1)
    differ = (every != every[:1]).any(0)
    if bool(differ.any()):
        raise RuntimeError(
            f"[parallel] {int(differ.sum())} of {len(tensors)} state tensors "
            "differ between the ranks after the broadcast")
