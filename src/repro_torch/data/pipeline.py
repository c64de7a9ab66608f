"""Deterministic synthetic data; port of repro.data.pipeline (the host
side only: ``DataConfig`` and ``SyntheticStream.host_batch``).

Every batch is a pure function of (seed, step), drawn with numpy, so the
port and the reference see the same tokens and labels.  A learnable
'lcg' mode gives calibration and quality runs sequences with structure;
'uniform' draws tokens uniformly.  Device placement and the prefetch
thread come with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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

    def host_batch(self, step: int) -> dict:
        """{"tokens", "labels"}: (global_batch, seq_len - 1) int32 numpy
        arrays, labels the tokens shifted by one; with a frontend also
        "frames" (global_batch, num_frames, d_model) or "patch_embeds"
        (global_batch, num_patches, d_model), f32 normals drawn after the
        tokens from the same stream."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        B, S = cfg.global_batch, cfg.seq_len
        if cfg.mode == "lcg":
            # learnable sequences: affine recurrence over a small alphabet
            # with occasional noise tokens
            a = rng.integers(1, 17, size=(B, 1))
            c = rng.integers(0, 23, size=(B, 1))
            x0 = rng.integers(0, cfg.vocab_size, size=(B, 1))
            idx = np.arange(S)[None, :]
            toks = (x0 + a * idx + c * (idx // 7)) % min(cfg.vocab_size, 251)
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
