"""Per-program counters of the host pipeline: how often each program ran,
the host seconds spent dispatching it, and on the card its device span
(CUDA events recorded around the dispatch on the current stream; the span
includes any time the card waited for the host inside it)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch


class ProgramTimer:
    def __init__(self, device, names=()):
        self.runs: Dict[str, int] = {n: 0 for n in names}
        self.host_s: Dict[str, float] = {n: 0.0 for n in names}
        self._events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {}
        self._cuda = torch.device(device).type == "cuda"

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        start = None
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        try:
            yield
        finally:
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._events.setdefault(name, []).append((start, end))
            self.runs[name] = self.runs.get(name, 0) + 1
            self.host_s[name] = self.host_s.get(name, 0.0) + time.perf_counter() - t0

    def device_ms(self) -> Dict[str, float]:
        """Summed device span per program (milliseconds; empty off the card)."""
        if not self._cuda:
            return {}
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in evs) for n, evs in self._events.items()}
