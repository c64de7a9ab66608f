"""Fault-tolerant checkpointing: atomic save, keep-last-k GC, auto-resume;
port of repro.checkpoint.manager.

Layout (one directory per step)::

    <dir>/step_000000123.tmp/...   # written first
    <dir>/step_000000123/          # atomic os.replace when complete
        manifest.json              # step, leaf index (names), extra
        leaf_00000.npy ...         # one file per leaf

Atomicity = write-to-tmp + rename, so a crash mid-save never corrupts the
latest checkpoint; ``latest_step`` only ever sees complete directories.
Manifests carry a CRC32 per leaf file and one over the manifest itself: a
bit-rotted or truncated checkpoint fails verification on restore, the
whole step directory is quarantined aside (``step_N.quarantined``,
counted by ``artifact_quarantined_total{artifact="checkpoint"}``), and
``restore_latest`` falls back to the newest step that verifies.

A tree is a torch ``state_dict()`` or a nested dict of tensors or numpy
arrays; the manifest keeps each leaf's name (nested keys joined with
``/``).  Leaves are saved from the host; bf16 leaves are stored as f32,
as in the reference, and restore casts back exactly.  ``restore`` places
tensor leaves on ``device`` (default: the target leaf's device).

On a mesh (``shardings``, a :class:`~repro_torch.distributed.sharding.
TreeSharding`: the mesh and each leaf's spec) the tree holds this rank's
blocks: ``save`` gathers every leaf whole (each rank takes part), rank 0
writes the same files a single device writes, and every rank waits for
it; ``restore`` cuts each whole leaf to this rank's block (a two-halves
leaf's, ``TreeSharding.halves``, from both halves).  So a restore
is elastic: a checkpoint of any mesh, or of one device, restores onto
any mesh whose rules divide its shapes.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import zlib
from collections.abc import Mapping

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def _file_crc(path: str) -> str:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(name, leaf) pairs of a nested dict in its own key order."""
    if isinstance(tree, Mapping):
        out = []
        for key, value in tree.items():
            out += _flatten(value, f"{prefix}{key}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(like, leaves):
    """``like``'s nested-dict structure filled from the ``leaves``
    iterator, in :func:`_flatten`'s order."""
    if isinstance(like, Mapping):
        return {key: _unflatten(value, leaves) for key, value in like.items()}
    return next(leaves)


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array to store and the dtype name to restore."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:  # numpy has no bf16
            t = t.float()
        return t.numpy(), dtype
    a = np.asarray(leaf)
    return a, str(a.dtype)


class CheckpointCorrupt(ValueError):
    """A checkpoint step failed manifest/CRC verification."""


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- paths
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            # strict match skips .tmp dirs, quarantined corpses
            # (step_N.quarantined), and any stray files
            m = _STEP_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, *, extra: dict | None = None,
             shardings=None) -> None:
        """Write ``tree`` as step ``step``.  The leaves are copied to the
        host here; with ``async_save`` the files are written on a thread
        (one in flight at a time; :meth:`wait` joins it).  With
        ``shardings`` (every rank calls it) the leaves are assembled whole
        by rank 0, which alone writes the step, at once
        (:meth:`_save_sharded`); every rank returns when it is
        published."""
        if self._thread is not None:
            self._thread.join()  # one in-flight async save at a time
            self._thread = None
        named = _flatten(tree)
        if shardings is not None:
            self._save_sharded(step, named, extra, shardings)
            return
        host = [(name, *_host(leaf)) for name, leaf in named]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra)

    def _save_sharded(self, step: int, named: list, extra, shardings):
        """The blocks cross through the checkpoint directory, which every
        rank reads on restore anyway: each rank but the first writes the
        blocks no other rank writes (those at coordinate 0 on the axes
        that do not split their leaf) into ``step_N.shards/``; rank 0
        assembles every whole leaf from them and its own and writes the
        step as one device does, then removes the blocks.  (Through the
        process group every rank would receive every leaf: gigabytes
        through host memory when ranks share a card.)"""
        import torch.distributed as dist

        from repro_torch.distributed import sharding

        mesh = shardings.mesh
        shards = self._step_dir(step) + ".shards"
        me, lead = dist.get_rank(), sharding.is_lead(mesh)
        if lead:
            shutil.rmtree(shards, ignore_errors=True)
            os.makedirs(shards)
        sharding.mesh_barrier(mesh)
        for i, (name, leaf) in enumerate(named):
            spec = shardings.specs.get(name)
            if spec and not lead and sharding.writes_block(spec, mesh):
                np.save(os.path.join(shards, f"{i:05d}.{me}.npy"),
                        _host(leaf)[0])
        sharding.mesh_barrier(mesh)
        if lead:
            host = []
            for i, (name, leaf) in enumerate(named):
                a, dtype = _host(leaf)
                spec = shardings.specs.get(name)
                if spec:
                    whole = np.empty(sharding.whole_shape(a.shape, spec,
                                                          mesh), a.dtype)
                    for rank, coords in sharding.block_owners(spec, mesh):
                        block = a if rank == me else np.load(os.path.join(
                            shards, f"{i:05d}.{rank}.npy"), mmap_mode="r")
                        whole[sharding.local_index(whole.shape, spec, mesh,
                                                   coords=coords)] = block
                    a = self._halves(whole, name, shardings, sharding
                                     .from_blocks)
                host.append((name, a, dtype))
            self._write(step, host, extra)
            shutil.rmtree(shards)
        sharding.mesh_barrier(mesh)

    @staticmethod
    def _halves(a, name: str, shardings, fn):
        """``fn`` (``sharding.to_blocks`` / ``from_blocks``) of a
        two-halves leaf's whole array (the single-device order on disk);
        ``a`` itself for any other leaf."""
        from repro_torch.distributed import sharding

        dim = shardings.halves.get(name)
        if dim is None:
            return a
        return fn(a, sharding.halves_parts(shardings.specs[name],
                                           shardings.mesh, dim), dim)

    def _write(self, step: int, host: list, extra: dict | None) -> None:
        """Write the (name, array, dtype) leaves ``host`` as step ``step``:
        into the step's .tmp directory, then published by one rename."""

        from repro_torch import faults
        from repro_torch.obs import artifacts

        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = []
        for i, (name, a, dtype) in enumerate(host):
            file = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, file), a)
            index.append({"file": file, "name": name,
                          "shape": list(a.shape), "dtype": dtype,
                          "crc": _file_crc(os.path.join(tmp, file))})
        manifest = {"step": step, "leaves": index, "extra": extra or {}}
        artifacts.stamp_crc(manifest)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        ev = faults.fire("corrupt_checkpoint")
        if ev is not None:
            faults.corrupt_file(os.path.join(final, "manifest.json"), ev)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------- load
    def restore(self, step: int, target_tree, *, device=None,
                shardings=None):
        """Restore into the structure of ``target_tree`` (names, shapes
        and dtypes validated; the target's dtypes are restored).  Tensor
        leaves go to ``device``, default the target leaf's device; numpy
        leaves come back as numpy arrays.  With ``shardings`` the target
        holds this rank's blocks: each saved (whole) leaf is cut to this
        rank's block of its spec, whose shape the target's must be."""
        self.wait()
        d = self._step_dir(step)
        manifest = self._verify(step)
        named = _flatten(target_tree)
        names = [name for name, _ in named]
        saved = [meta.get("name") for meta in manifest["leaves"]]
        if saved != names:
            raise ValueError(
                f"checkpoint leaves {saved[:4]}... ({len(saved)}) do not "
                f"match the target's {names[:4]}... ({len(names)})")
        out = []
        for meta, (name, tgt) in zip(manifest["leaves"], named):
            spec = shardings.specs.get(name) if shardings is not None \
                else None
            a = np.load(os.path.join(d, meta["file"]),
                        mmap_mode="r" if spec else None)
            if spec:
                from repro_torch.distributed import sharding

                a = self._halves(a, name, shardings, sharding.to_blocks)
                idx = sharding.local_index(a.shape, spec, shardings.mesh)
                if idx is None or tuple(i.stop - i.start for i in idx) \
                        != tuple(tgt.shape):
                    raise ValueError(
                        f"{name}: the saved {tuple(a.shape)} does not cut "
                        f"to this rank's {tuple(tgt.shape)} under {spec}")
                a = np.array(a[idx])  # a copy: the file is mapped read-only
            elif list(a.shape) != list(tgt.shape):
                raise ValueError(f"{name}: shape mismatch {a.shape} vs "
                                 f"{tuple(tgt.shape)}")
            if isinstance(tgt, torch.Tensor):
                # bf16 leaves round-trip exactly through f32
                out.append(torch.from_numpy(a).to(
                    device=tgt.device if device is None else device,
                    dtype=tgt.dtype))
            else:
                out.append(a.astype(np.asarray(tgt).dtype))
        return _unflatten(target_tree, iter(out))

    def _verify(self, step: int) -> dict:
        """Parse + CRC-verify a step's manifest and leaf files; returns
        the manifest or raises :class:`CheckpointCorrupt`."""
        from repro_torch.obs import artifacts

        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            if not isinstance(manifest, dict) or \
                    not isinstance(manifest.get("leaves"), list):
                raise ValueError("bad manifest schema")
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(
                f"step {step}: unreadable manifest ({e})") from None
        if not artifacts.check_crc(manifest):
            raise CheckpointCorrupt(f"step {step}: manifest CRC mismatch")
        for meta in manifest["leaves"]:
            want = meta.get("crc")
            path = os.path.join(d, meta["file"])
            try:
                got = _file_crc(path)
            except OSError:
                raise CheckpointCorrupt(
                    f"step {step}: missing leaf {meta['file']}") from None
            if got != want:
                raise CheckpointCorrupt(
                    f"step {step}: leaf {meta['file']} CRC "
                    f"{got} != {want}")
        return manifest

    def quarantine(self, step: int, reason: str = "corrupt"):
        """Move a corrupt step directory aside and count it."""
        from repro_torch.obs import artifacts

        return artifacts.quarantine(
            self._step_dir(step), "checkpoint", reason=reason)

    def restore_latest(self, target_tree, *, device=None, shardings=None):
        """Restore the newest step that passes verification.  Corrupt
        steps are quarantined aside and the next older one is tried;
        ``(None, None)`` only when no step verifies."""
        self.wait()
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, target_tree, device=device,
                                          shardings=shardings)
            except CheckpointCorrupt as e:
                self.quarantine(step)
                logging.getLogger(__name__).warning(
                    "quarantined corrupt checkpoint: %s", e)
        return None, None
