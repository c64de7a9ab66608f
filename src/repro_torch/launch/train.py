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
steps and at the last.  One device: ``--mesh`` takes only ``1x1`` (its
default) until the multi-GPU slice.
"""

from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.device import generator, resolve
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
                    help="only 1x1: multi-GPU meshes are not ported yet")
    ap.add_argument("--checkpoint-dir", default=DEFAULT_DIR)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no fallback")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: only 1x1 runs until the multi-GPU "
                 "slice is ported")
    return args


def main(argv=None) -> dict:
    """Run the CLI on ``argv``.  Returns ``driver.run``'s result."""
    args = parse_args(argv)
    dev = resolve(args.device)
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
                          device=dev)
    res = run(state, RT.make_train_step(cfg, tcfg), data,
              DriverConfig(total_steps=args.steps,
                           checkpoint_every=args.checkpoint_every,
                           checkpoint_dir=args.checkpoint_dir),
              device=dev)
    if res["metrics"]:
        print(f"final loss: {res['metrics'][-1]['loss']:.4f} "
              f"(resumed_at={res['resumed_at']})")
    return res


if __name__ == "__main__":
    main()
