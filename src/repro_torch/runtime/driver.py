"""Fault-tolerant training driver; port of repro.runtime.driver.

* auto-resume from the latest complete checkpoint (atomic manager),
* periodic checkpointing, and at the last step,
* straggler/hang watchdog wiring,
* a crash-injection hook for the restart test,
* preemption-style graceful stop (save + return) on request.

A checkpoint holds the train state as a nested dict: ``params`` the
model's ``state_dict()``, ``opt`` (``m``, ``v``, ``count``) and ``step``;
restoring loads the params back into the model in place.  One device:
re-sharding on restore comes with the multi-GPU slice.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Callable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.watchdog import Watchdog


# the reference's /tmp/repro_ckpt, under the temporary directory in use
DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class DriverConfig:
    total_steps: int
    checkpoint_every: int = 50
    checkpoint_dir: str = DEFAULT_DIR
    keep: int = 3
    log_every: int = 10


@dataclass
class CrashInjector:
    """Test hook: raises at a given step, once."""
    at_step: int = -1
    fired: bool = False

    def maybe_crash(self, step: int):
        if step == self.at_step and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected crash at step {step}")


def _tree(state: dict) -> dict:
    return {"params": state["params"].state_dict(), "opt": state["opt"],
            "step": state["step"]}


def _restore(ckpt: CheckpointManager, step: int, state: dict) -> dict:
    tree = ckpt.restore(step, _tree(state))
    state["params"].load_state_dict(tree["params"])
    return {"params": state["params"], "opt": tree["opt"],
            "step": tree["step"]}


def run(state: dict, step_fn: Callable, data, dcfg: DriverConfig, *,
        device=None, crash: CrashInjector | None = None,
        stop_flag: list | None = None, log: Callable = print) -> dict:
    """Run (or resume) training: ``step_fn(state, batch) -> (state,
    metrics)`` on ``data.device_batch(step, device=device)`` for the
    steps not yet done.  Returns {'state', 'metrics' (one dict a step:
    its number and every 0-d metric as a float), 'resumed_at',
    'preempted', and 'watchdog' when it ran to the end}."""
    ckpt = CheckpointManager(dcfg.checkpoint_dir, keep=dcfg.keep)
    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state = _restore(ckpt, latest, state)
        start = latest
        log(f"[driver] resumed from checkpoint step {latest}")
    wd = Watchdog()
    history = []
    for step in range(start, dcfg.total_steps):
        if stop_flag and stop_flag[0]:  # preemption signal
            ckpt.save(step, _tree(state))
            ckpt.wait()
            log(f"[driver] preempted; saved at step {step}")
            return {"state": state, "metrics": history, "resumed_at": start,
                    "preempted": True}
        batch = data.device_batch(step, device=device)
        wd.step_started()
        if crash is not None:
            crash.maybe_crash(step)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        info = wd.step_finished()
        if (step + 1) % dcfg.log_every == 0 or step == start:
            log(f"[driver] step {step + 1} loss={loss:.4f} "
                f"t={info['step_time'] * 1e3:.1f}ms"
                + (" STRAGGLER" if info["straggler"] else ""))
        history.append({"step": step + 1, "loss": loss,
                        **{k: float(v) for k, v in metrics.items()
                           if hasattr(v, "shape") and v.shape == ()}})
        if (step + 1) % dcfg.checkpoint_every == 0 \
                or step + 1 == dcfg.total_steps:
            ckpt.save(step + 1, _tree(state))
    ckpt.wait()
    return {"state": state, "metrics": history, "resumed_at": start,
            "preempted": False, "watchdog": {"stragglers": wd.straggler_count,
                                             "hangs": wd.hang_count}}
