"""Fault-tolerant training driver; port of repro.runtime.driver.

* auto-resume from the latest complete checkpoint (atomic manager),
* periodic checkpointing, and at the last step,
* straggler/hang watchdog wiring,
* a crash-injection hook for the restart test,
* preemption-style graceful stop (save + return) on request.

A checkpoint holds the train state as a nested dict: ``params`` the
model's ``state_dict()``, ``opt`` (``m``, ``v``, ``count``, and
``residual`` with ``int8_pod``) and ``step``; restoring loads the params
back into the model in place.  The residual is each pod's own
quantization error, so it is saved with a leading axis of one entry a
pod (split over 'pod'): a restore onto a mesh with the same pod count
gives every pod its own back, and one onto another pod count raises.  On a mesh (a state from
``runtime.train.init_state(..., mesh=)``, every rank running ``run``)
the checkpoint holds the whole leaves, written by rank 0; a run resumes
from the latest step onto whatever mesh its state lies on (each rank
cuts its blocks), takes its rows of each batch, and stops on a crash or
a preemption at the same step on every rank, so no rank waits on a
collective another will never issue.
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


def _quiet(*args) -> None:
    pass


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
    opt = state["opt"]
    if "residual" in opt:  # one block a pod (:func:`shardings`)
        opt = dict(opt, residual={n: r[None]
                                  for n, r in opt["residual"].items()})
    return {"params": state["params"].state_dict(), "opt": opt,
            "step": state["step"]}


def shardings(state: dict):
    """The ``TreeSharding`` of a state's checkpoint tree on its mesh (None
    on one device): params and the moments under the leaves' specs, the
    residual's leading axis over 'pod' (where the mesh has one) before
    them, the two-halves leaves (``sharding.HALVES``) marked; ``count``
    and ``step`` whole."""
    mesh = state.get("mesh")
    if mesh is None:
        return None
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import TreeSharding, is_halves

    pod = "pod" if "pod" in compat.axes_of(mesh) else None
    specs, halves = {}, {}
    for key, lead in (("params", ()), ("opt/m", ()), ("opt/v", ()),
                      ("opt/residual", (pod,))):
        specs.update({f"{key}/{n}": lead + tuple(s)
                      for n, s in state["specs"].items()})
        halves.update({f"{key}/{n}": len(lead) for n in state["specs"]
                       if is_halves(n)})
    return TreeSharding(mesh, specs, halves)


def _restore(ckpt: CheckpointManager, step: int, state: dict) -> dict:
    tree = ckpt.restore(step, _tree(state), shardings=shardings(state))
    state["params"].load_state_dict(tree["params"])
    opt = tree["opt"]
    if "residual" in opt:
        opt["residual"] = {n: r[0] for n, r in opt["residual"].items()}
    return dict(state, opt=opt, step=tree["step"])


def _stopping(stop_flag, mesh) -> bool:
    """The preemption flag, raised on every rank when any rank's is."""
    if not stop_flag:
        return False
    if mesh is None:
        return bool(stop_flag[0])
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import compat

    t = torch.tensor(float(bool(stop_flag[0])))
    for a in compat.axes_of(mesh):
        t = coll.pmax(t, a, mesh=mesh)
    return bool(t)


def run(state: dict, step_fn: Callable, data, dcfg: DriverConfig, *,
        device=None, crash: CrashInjector | None = None,
        stop_flag: list | None = None, log: Callable = print,
        microbatches: int = 1) -> dict:
    """Run (or resume) training: ``step_fn(state, batch) -> (state,
    metrics)`` on ``data.device_batch(step, device=device)`` for the
    steps not yet done (on a mesh, this rank's share of each of the
    step's ``microbatches``, which must be ``step_fn``'s).  Returns
    {'state', 'metrics' (one dict a step:
    its number and every 0-d metric as a float), 'resumed_at',
    'preempted', and 'watchdog' when it ran to the end}.  On a mesh
    (``state["mesh"]``) every rank calls it; only rank 0 logs."""
    mesh = state.get("mesh")
    tree_sh = shardings(state)
    if mesh is not None:
        from repro_torch.distributed.sharding import is_lead

        if not is_lead(mesh):
            log = _quiet
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
        if _stopping(stop_flag, mesh):  # preemption signal
            ckpt.save(step, _tree(state), shardings=tree_sh)
            ckpt.wait()
            log(f"[driver] preempted; saved at step {step}")
            return {"state": state, "metrics": history, "resumed_at": start,
                    "preempted": True}
        batch = data.device_batch(step, device=device, mesh=mesh,
                                  microbatches=microbatches)
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
            ckpt.save(step + 1, _tree(state), shardings=tree_sh)
    ckpt.wait()
    return {"state": state, "metrics": history, "resumed_at": start,
            "preempted": False, "watchdog": {"stragglers": wd.straggler_count,
                                             "hangs": wd.hang_count}}
