"""Fault-tolerant training supervisor: checkpoint/restart + straggler watch,
as ``repro.runtime.fault_tolerance``.

A worker failure surfaces as a ``RuntimeError`` out of the step; recovery
restores the latest checkpoint and resumes from its step.  Failures here are
injected (:class:`FailureInjector`), so the whole recovery path runs in
tests.  On the card a CUDA error or an out-of-memory error is a
``RuntimeError`` too and is recovered the same way, so a caller that must
not mistake a fault for an injected failure compares
``report.failures_recovered`` with the failures it injected.

Straggler mitigation: per-step wall times feed a median tracker; steps
slower than ``threshold x median`` are flagged, and ``evict_after``
consecutive flags count as an eviction.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.backend import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore


class FailureInjector:
    """Deterministic failure schedule for tests/examples."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerPolicy:
    threshold: float = 2.5          # x median
    window: int = 32
    evict_after: int = 3            # consecutive flags -> evict

    def __post_init__(self):
        self.times = deque(maxlen=self.window)
        self.consecutive = 0
        self.flags = 0

    def observe(self, step_time: float) -> str:
        """Returns 'ok' | 'straggle' | 'evict'."""
        self.times.append(step_time)
        if len(self.times) < 8:
            return "ok"
        med = float(np.median(self.times))
        if step_time > self.threshold * med:
            self.flags += 1
            self.consecutive += 1
            if self.consecutive >= self.evict_after:
                self.consecutive = 0
                return "evict"
            return "straggle"
        self.consecutive = 0
        return "ok"


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    failures_recovered: int = 0
    stragglers_flagged: int = 0
    evictions: int = 0
    checkpoints_written: int = 0


class TrainSupervisor:
    """Run a step function with checkpoint/restart and straggler tracking.

    ``state`` is a tree of tensors; ``step_fn(state, batch) -> (state,
    metrics)``.  Restored state lands on ``device`` (the card unless the
    caller names another).  Checkpoints are written and read in ``layout``
    (``repro_torch.checkpoint``; the tree as it is when None).
    """

    def __init__(self, ckpt_dir: str, *, ckpt_every: int = 10,
                 injector: Optional[FailureInjector] = None,
                 straggler: Optional[StragglerPolicy] = None,
                 max_restarts: int = 8, device=None,
                 layout: Optional[Callable] = None):
        self.ckpt = AsyncCheckpointer(ckpt_dir, layout=layout)
        self.layout = layout
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.injector = injector
        self.straggler = straggler or StragglerPolicy()
        self.max_restarts = max_restarts
        self.device = resolve_device(device)
        self.report = SupervisorReport()

    def run(self, state: Any, batches: Callable[[int], Any], n_steps: int,
            step_fn: Callable) -> Any:
        step = 0
        restarts = 0
        # resume if a checkpoint exists (restart-from-failure entry point)
        if latest_step(self.ckpt_dir) is not None:
            state = restore(self.ckpt_dir, state, device=self.device,
                            layout=self.layout)
            step = latest_step(self.ckpt_dir)
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if self.injector:
                    self.injector.maybe_fail(step)
                state, metrics = step_fn(state, batches(step))
                dt = time.perf_counter() - t0
                verdict = self.straggler.observe(dt)
                if verdict == "straggle":
                    self.report.stragglers_flagged += 1
                elif verdict == "evict":
                    self.report.evictions += 1
                step += 1
                self.report.steps_run += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, state)
                    self.report.checkpoints_written += 1
            except RuntimeError:
                # node failure: restore latest checkpoint and resume
                restarts += 1
                self.report.failures_recovered += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                last = latest_step(self.ckpt_dir)
                if last is not None:
                    state = restore(self.ckpt_dir, state,
                                    device=self.device, layout=self.layout)
                    step = last
                # else: restart from step 0 with current state
        self.ckpt.wait()
        return state
