"""Training entry point of the port; port of repro.launch.train.

On the card (the default device):

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \\
        --smoke --steps 100 --checkpoint-dir ckpt/

and on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \\
        --smoke --device cpu --steps 3 --checkpoint-dir ckpt/

A dense model from ``--seed`` trains on the lcg ``SyntheticStream`` of the
same seed (``--global-batch`` sequences of ``--seq-len`` tokens; whisper
gets ``max(seq_len // 2, 8)`` stub frames, phi-3-vision its patches with
IGNORE labels over them) under AdamW with ``warmup_cosine(lr, 10,
steps)``, through ``runtime.driver.run``: a run resumes from the latest
checkpoint in ``--checkpoint-dir`` and saves every ``--checkpoint-every``
steps and at the last.

``--mesh DxM`` (data x model) or ``PxDxM`` (pod x data x model) trains
FSDP x TP from one process a mesh device (``launch.mesh.run_ranks``),
one card a rank; a mesh larger than the visible cards is refused.  On
the CPU, ``--device cpu --force-host-devices N`` allows up to N gloo
ranks:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \
        --smoke --device cpu --mesh 2x2 --force-host-devices 4 --steps 3

Every architecture trains on a mesh (MoE blocks expert-parallel or each
expert tensor-parallel, Mamba and mLSTM blocks on their channels and
heads, the sLSTM whole, whisper's encoder, phi-3's patches), e.g.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_moe \
        --smoke --device cpu --mesh 2x2 --force-host-devices 4 --steps 3

A mesh a config cannot split is refused before any rank starts
(``transformer.check_train_mesh``).  With ``--microbatches`` A each rank
takes its share of each of the A microbatches, so a mesh step computes
the single device's.  A checkpoint holds whole leaves, so a run resumes
onto any mesh (or ``1x1``) whose rules divide the shapes.  ``final
loss`` is rank 0's (the whole batch's).
"""

from __future__ import annotations

import argparse
import math

import torch

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.device import generator, resolve
from repro_torch.launch import mesh as MS
from repro_torch.launch.mesh import parse_train_mesh
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig, schedules
from repro_torch.runtime import train as RT
from repro_torch.runtime.driver import DEFAULT_DIR, DriverConfig, run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM (data x model) or PxDxM (pod x data x "
                         "model): one process a mesh device")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    help="allow a mesh of up to N CPU ranks (--device cpu)")
    ap.add_argument("--checkpoint-dir", default=DEFAULT_DIR)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no fallback")
    args = ap.parse_args(argv)
    try:
        args.mesh_shape, args.mesh_axes = parse_train_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    kind = torch.device(args.device).type
    if args.force_host_devices and kind != "cpu":
        ap.error("--force-host-devices starts CPU ranks: pass --device cpu")
    need = math.prod(args.mesh_shape)
    have = max(MS.visible_devices(kind),
               args.force_host_devices if kind == "cpu" else 0)
    if need > 1 and need > have:
        ap.error(f"--mesh {args.mesh} needs {need} devices but only {have} "
                 f"are visible ({kind}); pass --force-host-devices {need} "
                 "with --device cpu for CPU ranks")
    return args


def _train(args, dev, mesh=None) -> dict:
    """Build the state from ``--seed`` (on ``mesh``: this rank's blocks)
    and run the driver; returns its result."""
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    tcfg = RT.TrainConfig(
        optimizer=AdamWConfig(
            lr=schedules.warmup_cosine(args.lr, 10, args.steps)),
        microbatches=args.microbatches)
    data = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len + 1,
        global_batch=args.global_batch, seed=args.seed,
        frontend=cfg.frontend, d_model=cfg.d_model,
        num_frames=max(args.seq_len // 2, 8), num_patches=cfg.num_patches))
    state = RT.init_state(cfg, tcfg, generator=generator(args.seed, dev),
                          device=dev, mesh=mesh)
    return run(state, RT.make_train_step(cfg, tcfg), data,
               DriverConfig(total_steps=args.steps,
                            checkpoint_every=args.checkpoint_every,
                            checkpoint_dir=args.checkpoint_dir),
               device=dev, microbatches=args.microbatches)


def _mesh_devices(args) -> list[str]:
    """One device a rank of ``--mesh`` (``parse_args`` checked there are
    enough): cards ``cuda:0..n-1``, or CPU ranks."""
    need = math.prod(args.mesh_shape)
    return ["cpu"] * need if resolve(args.device).type == "cpu" else \
        [f"cuda:{r}" for r in range(need)]


def _mesh_rank(rank, device, args) -> dict:
    """One rank of ``--mesh``: its blocks of the state, the driver over
    its rows; rank 0 logs.  Returns the run's metrics."""
    mesh = MS.make_mesh(args.mesh_shape, args.mesh_axes)
    res = _train(args, device, mesh)
    return {k: res[k] for k in ("metrics", "resumed_at", "preempted")}


def main(argv=None) -> dict:
    """Run the CLI on ``argv``.  Returns ``driver.run``'s result (on a
    mesh, rank 0's metrics, ``resumed_at`` and ``preempted``)."""
    args = parse_args(argv)
    if math.prod(args.mesh_shape) == 1:
        res = _train(args, resolve(args.device))
    else:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get_config(args.arch))
        transformer.check_train_mesh(cfg, MS.MeshShape(
            dict(zip(args.mesh_axes, args.mesh_shape))))
        devices = _mesh_devices(args)
        print(f"[train] {len(devices)} ranks on {devices} for mesh "
              f"{dict(zip(args.mesh_axes, args.mesh_shape))}", flush=True)
        # a training run outlives run_ranks' default timeout
        res = MS.run_ranks(_mesh_rank, len(devices), args, devices=devices,
                           timeout=24 * 3600.0)[0]
    if res["metrics"]:
        print(f"final loss: {res['metrics'][-1]['loss']:.4f} "
              f"(resumed_at={res['resumed_at']})")
    return res


if __name__ == "__main__":
    main()
