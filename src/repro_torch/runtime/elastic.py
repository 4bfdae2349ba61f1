"""Step-level fault tolerance and the elasticity rule (the reference's
``repro/runtime/elastic.py``).

:class:`TrainSupervisor` checkpoints every ``ckpt_every`` steps
(atomically, :mod:`.checkpoint`), and on a failure (here an exception from
the step, or one injected at ``fail_at``) restores the last complete
checkpoint, the params, the optimizer state and the data pipeline's step
all together, and continues: the run ends with the uninterrupted run's
params bit for bit, as long as the step itself is deterministic (the SSD
backward kernel sums in a fixed order for that reason).
:func:`scale_batch_rule` keeps the global batch across a resize by
scaling gradient accumulation.  Restoring onto another mesh waits for
ROADMAP A11.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from . import checkpoint as ckpt
from .tree import tree_leaves


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    max_restarts: int = 10
    step_deadline_s: Optional[float] = None   # straggler watchdog (prod)


def scale_batch_rule(global_batch: int, micro_batches: int,
                     old_chips: int, new_chips: int) -> int:
    """Keep the global batch constant across a resize by scaling
    grad-accumulation (micro-batch count)."""
    scaled = micro_batches * old_chips / new_chips
    return max(1, int(math.ceil(scaled)))


class TrainSupervisor:
    """Checkpoint/restart loop around a step function
    ``step_fn(params, opt, batch) -> (params, opt, metrics)``."""

    def __init__(self, cfg: SupervisorConfig, state, dataset,
                 step_fn: Callable, shardings=None):
        if shardings is not None:
            raise NotImplementedError(
                "TrainSupervisor: shardings need ROADMAP A11, sharding on "
                "torch.distributed")
        self.cfg = cfg
        self.state = state          # (params, opt)
        self.dataset = dataset
        self.step_fn = step_fn
        self.restarts = 0
        self.metrics_log: list = []

    def _save(self, step: int):
        ckpt.save(self.cfg.ckpt_dir, step,
                  {"params": self.state[0], "opt": self.state[1]},
                  extra={"data": self.dataset.state_dict(), "step": step})

    def _restore(self) -> int:
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return 0
        like = {"params": self.state[0], "opt": self.state[1]}
        dev = tree_leaves(like)[0].device
        tree, extra = ckpt.restore(self.cfg.ckpt_dir, last, like, device=dev)
        self.state = (tree["params"], tree["opt"])
        self.dataset.load_state_dict(extra["data"])
        return int(extra["step"])

    def run(self, n_steps: int, fail_at: Optional[set] = None,
            resume: bool = False):
        """fail_at: steps at which to inject a simulated node failure.
        resume: a restarted process, which goes on from the last complete
        checkpoint in ``ckpt_dir`` (the state it was built with is only
        the checkpoint's template); with none there it starts at 0."""
        step = self._restore() if resume else 0
        if not resume or ckpt.latest_step(self.cfg.ckpt_dir) is None:
            self._save(0)
        while step < n_steps:
            try:
                if fail_at and step in fail_at:
                    fail_at = fail_at - {step}
                    raise RuntimeError(f"injected node failure @ {step}")
                batch = self.dataset.batch_at(step)
                params, opt, metrics = self.step_fn(self.state[0],
                                                    self.state[1], batch)
                self.state = (params, opt)
                self.dataset.step = step + 1
                self.metrics_log.append((step, float(metrics["loss"])))
                step += 1
                if step % self.cfg.ckpt_every == 0:
                    self._save(step)
            except RuntimeError:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                step = self._restore()
        self._save(n_steps)
        return self.state
