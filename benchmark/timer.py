"""The measured window: CUDA events on the caller's stream, one at the
window's start and one after each completed unit (a training chunk or a
render round), read once after a single synchronisation. A unit counts
when its event lies within the window's length; the window's time is that
of the last unit counted, so no partial unit enters a rate. Off the card
(the CPU tests) the marks are host times."""

from __future__ import annotations

import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class WindowTimer:
    def __init__(self, seconds: float, device):
        self.seconds = float(seconds)
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.marks: list = []
        self.start_event = None
        self.t0 = None

    def start(self) -> None:
        sync(self.device)
        if self.cuda:
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record()
        self.t0 = time.perf_counter()

    def host_elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def expired(self) -> bool:
        return self.host_elapsed() >= self.seconds

    def mark(self, work: int) -> None:
        """A unit of `work` (steps, samples) ends here on the stream."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append((ev, work))

    def finish(self) -> tuple[int, int, float]:
        """(units, work, seconds) of the units that ended in the window
        (at least the first unit, where the window is shorter than it)."""
        sync(self.device)
        units = work = 0
        last = 0.0
        for ev, w in self.marks:
            s = (self.start_event.elapsed_time(ev) / 1e3 if self.cuda
                 else ev - self.t0)
            if s > self.seconds and units:
                break
            units, work, last = units + 1, work + w, s
        return units, work, last
