"""Device meshes and the processes behind them; port of
repro.launch.mesh.

A mesh of the port is one process a mesh device (a "rank"), joined by a
process group whose backend ``distributed.collectives.backend_for``
picks by layout: NCCL when each rank has a card of its own, gloo (a
CUDA tensor staged through host memory) when ranks share one card or run
on the CPU.
:func:`run_ranks` starts the ranks with ``torch.multiprocessing`` (spawn),
each initialising the group through a ``FileStore`` under a temporary
directory of its own, so parallel test workers never fight over a port.
Inside a rank, :func:`make_mesh` lays the group out as a
``torch.distributed.device_mesh.DeviceMesh`` with named axes.

* :func:`force_host_devices` — ``n`` CPU ranks may be started where no
  card is (the reference fakes ``n`` host devices through XLA_FLAGS); the
  serve CLI's ``--force-host-devices``;
* :func:`visible_devices` — the devices a mesh may span without it;
* :func:`make_production_mesh` — the reference's (16, 16) and
  (2, 16, 16) shapes, over a world of exactly that size;
* :func:`parse_mesh` — the serve CLI's 'axis=N,...' spelling;
  :func:`parse_train_mesh` — the train CLI's 'DxM' / 'PxDxM'.

A rank's device is given explicitly (``cuda:<n>`` or ``cpu``); a rank
that cannot reach its device fails the run, and a mesh never quietly
becomes one device.
"""

from __future__ import annotations

import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import NamedTuple

import torch

HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"


def force_host_devices(n: int) -> None:
    """Allow meshes of up to ``n`` CPU ranks (0 leaves the setting)."""
    if n:
        os.environ[HOST_DEVICES_ENV] = str(int(n))


def host_devices() -> int:
    """The CPU ranks :func:`force_host_devices` allows (0: none)."""
    return int(os.environ.get(HOST_DEVICES_ENV, "0") or 0)


def visible_devices(device_type: str) -> int:
    """Devices of ``device_type`` a mesh may span: the cards, or the
    forced host devices for ``cpu`` (0 without them)."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return host_devices()


def make_mesh(shape: tuple, axes: tuple):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    first ``prod(shape)`` ranks of the initialised process group (like
    the reference, it may use fewer ranks than there are).  Its device
    type is 'cpu' whatever the ranks' devices: the port's ranks hold
    plain tensors, so the mesh serves for its axis groups (each with the
    world's backends, NCCL among them on a card a rank) and this rank's
    coordinates."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the ranks' process group "
                           "(launch.mesh.run_ranks starts them)")
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                         f"the process group has {world}")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh("cpu", ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
    data=16, model=16) = 512; 'pod' is the data-parallel-only axis.  Built
    only over a world of exactly that size."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs a world of {math.prod(shape)} ranks, not "
                         f"{world}")
    return make_mesh(shape, axes)


class MeshShape(NamedTuple):
    """A mesh's shape alone, ``{axis: size}``, where a check needs no
    process group (``compat.axes_of`` reads it as a mesh's)."""

    shape: dict


def mesh_devices(mesh) -> int:
    from repro_torch.distributed import compat

    return math.prod(compat.axes_of(mesh).values())


TRAIN_AXES = {1: ("data",), 2: ("data", "model"),
              3: ("pod", "data", "model")}


def parse_train_mesh(s: str) -> tuple[tuple, tuple]:
    """The train CLI's spelling, the reference's: '1x1', 'DxM' for
    (data, model), 'PxDxM' for (pod, data, model) (and 'D' for data
    alone): '2x2' -> ((2, 2), ('data', 'model'))."""
    parts = s.split("x")
    if len(parts) not in TRAIN_AXES or not all(
            p.isdigit() and int(p) >= 1 for p in parts):
        raise ValueError(f"--mesh {s!r}: expected 'DxM' (data x model) or "
                         "'PxDxM' (pod x data x model), e.g. 2x2")
    return tuple(int(p) for p in parts), TRAIN_AXES[len(parts)]


def parse_mesh(s: str) -> tuple[tuple, tuple]:
    """'model=4,data=2' -> ((4, 2), ('model', 'data'))."""
    axes, shape = [], []
    for part in s.split(","):
        name, _, size = part.partition("=")
        if not name or not size.isdigit() or int(size) < 1:
            raise ValueError(f"--mesh {s!r}: expected 'axis=N,...'")
        axes.append(name.strip())
        shape.append(int(size))
    return tuple(shape), tuple(axes)


# ------------------------------------------------------------------ ranks
def _rank_main(rank, world, store_path, device, backend, out):
    try:
        import torch.distributed as dist

        # the function and its arguments come through a file: a large
        # argument in the process object would block the parent's start()
        # on a full pipe should the child die before reading it
        with open(os.path.join(os.path.dirname(store_path), "call"),
                  "rb") as f:
            fn, args = pickle.load(f)

        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available() or \
                    (dev.index or 0) >= torch.cuda.device_count():
                raise RuntimeError(f"rank {rank}: no device {dev}")
            torch.cuda.set_device(dev)
        torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            result = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        # pickled here, by value: a tensor put on the queue as it is
        # would travel as a handle into this process's shared memory,
        # which ends with it
        out.put((rank, True, pickle.dumps(result)))
    except Exception:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, devices=None, timeout: float = 600.0
              ) -> list:
    """Run ``fn(rank, device, *args)`` in ``world`` new processes, one a
    rank, joined by a process group (``collectives.backend_for`` the
    devices); returns their results in rank order.  ``fn`` and ``args``
    must pickle (a module-level function).  ``devices``: one device a
    rank, or one for all (default ``cpu``).  A
    rank that raises, dies or outlives ``timeout`` fails the run, and
    every process started here is stopped before this returns."""
    import torch.multiprocessing as mp

    from repro_torch.distributed.collectives import backend_for

    if isinstance(devices, (list, tuple)):
        devs = [str(d) for d in devices]
    else:
        devs = [str(devices or "cpu")] * world
    if len(devs) != world:
        raise ValueError(f"{len(devs)} devices for {world} ranks")
    backend = backend_for(devs)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro-ranks-")
    store = os.path.join(tmp, "store")
    with open(os.path.join(tmp, "call"), "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, devs[r], backend, out),
                         daemon=True)
             for r in range(world)]
    results: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    late = sorted(set(range(world)) - set(results))
                    raise TimeoutError(f"ranks {late} gave no result in "
                                       f"{timeout:.0f}s")
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=30)
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
