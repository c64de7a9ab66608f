"""Deterministic synthetic data; port of repro.data.pipeline.

Every batch is a pure function of (seed, step), drawn with numpy, so the
port and the reference see the same tokens and labels, and a resumed run
sees the same stream with no iterator state to persist.  A learnable
'lcg' mode gives training and quality runs sequences with structure;
'uniform' draws tokens uniformly.  ``device_batch`` places a step's batch
on a device (on a mesh, this rank's rows of it); a background thread
(``prefetch``) overlaps host generation with compute.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve

IGNORE = -100  # label id excluded from the loss (e.g. vlm patch positions)


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "lcg"  # lcg | uniform
    frontend: str = ""  # '' | 'audio_frames' | 'image_patches'
    d_model: int = 0  # frontend embedding dim
    num_frames: int = 0
    num_patches: int = 0


class SyntheticStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def _lcg(self, rng: np.random.Generator):
        """Draw each row's lcg coefficients from ``rng``; returns the rule:
        positions (broadcast against (global_batch, 1)) -> each row's
        token there."""
        B, V = self.cfg.global_batch, self.cfg.vocab_size
        a = rng.integers(1, 17, size=(B, 1))
        c = rng.integers(0, 23, size=(B, 1))
        x0 = rng.integers(0, V, size=(B, 1))
        return lambda i: (x0 + a * i + c * (i // 7)) % min(V, 251)

    def lcg_rule(self, step: int):
        """Batch ``step``'s lcg rule ('lcg' mode): positions -> each row's
        noise-free token there, at any position, past ``seq_len`` too."""
        return self._lcg(self._rng(step))

    def host_batch(self, step: int) -> dict:
        """{"tokens", "labels"}: (global_batch, seq_len - 1) int32 numpy
        arrays, labels the tokens shifted by one; with a frontend also
        "frames" (global_batch, num_frames, d_model) or "patch_embeds"
        (global_batch, num_patches, d_model), f32 normals drawn after the
        tokens from the same stream."""
        cfg = self.cfg
        rng = self._rng(step)
        B, S = cfg.global_batch, cfg.seq_len
        if cfg.mode == "lcg":
            # learnable sequences: affine recurrence over a small alphabet
            # with occasional noise tokens
            toks = self._lcg(rng)(np.arange(S)[None, :])
            noise = rng.random((B, S)) < 0.02
            toks = np.where(noise,
                            rng.integers(0, cfg.vocab_size, size=(B, S)),
                            toks)
        else:
            toks = rng.integers(0, cfg.vocab_size, size=(B, S))
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if cfg.frontend == "audio_frames":
            batch["frames"] = rng.standard_normal(
                (B, cfg.num_frames, cfg.d_model)).astype(np.float32)
        elif cfg.frontend == "image_patches":
            batch["patch_embeds"] = rng.standard_normal(
                (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        return batch

    def device_batch(self, step: int, device=None, mesh=None,
                     microbatches: int = 1) -> dict:
        """:meth:`host_batch` as torch tensors on ``device`` (default the
        GPU, ``device.resolve``): tokens and labels int32, frames and
        patches f32.  With an 'image_patches' frontend the labels get
        ``num_patches`` IGNORE labels in front, so they span the logits
        (patches, then text); the reference's ``host_batch`` leaves that
        to its caller.  On ``mesh``, this rank's rows: block ``pod x
        data`` coordinate of the batch split over those axes
        (``sharding.batch_rows``; the reference's 'batch' rule folds
        both), so the ranks' rows together are the whole batch; with
        ``microbatches`` A, that block of each of the A microbatches
        (``sharding.local_rows``), so the ranks' microbatch i is the
        single device's."""
        dev = resolve(device)
        hb = self.host_batch(step)
        if mesh is not None:
            from repro_torch.distributed.sharding import local_rows

            hb = {k: local_rows(v, mesh, microbatches)
                  for k, v in hb.items()}
        if self.cfg.frontend == "image_patches":
            lab = hb["labels"]
            pad = np.full((lab.shape[0], self.cfg.num_patches), IGNORE,
                          lab.dtype)
            hb["labels"] = np.concatenate([pad, lab], axis=1)
        return {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}

    def prefetch(self, start_step: int, depth: int = 2):
        """Generator of (step, host_batch(step)) from ``start_step`` on,
        produced ``depth`` ahead on a background thread (stopped when the
        generator is closed)."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                try:
                    q.put((s, self.host_batch(s)), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
