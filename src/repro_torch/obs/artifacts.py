"""Persisted-artifact integrity: CRC stamps, atomic writes, quarantine;
port of repro.obs.artifacts (the same CRC function, so a payload stamped
by either package passes the other's :func:`check_crc`).

The serving stack persists JSON artifacts it must be able to warm-start
from — the dispatch plan cache and the perf-model ``calibration.json``.
A half-written or bit-rotted file must never take the server down: loads
verify a CRC32 stamp (and basic schema) and, on any mismatch,
*quarantine* the file — rename it aside, bump
``artifact_quarantined_total{artifact=...}`` — so the caller rebuilds
from scratch while the corpse stays on disk for post-mortem.

Legacy files without a ``crc`` field still parse (the stamp is
additive); only files that fail to parse or carry a *wrong* stamp are
quarantined.
"""

from __future__ import annotations

import json
import os
import zlib
from pathlib import Path

from repro_torch import obs

CRC_FIELD = "crc"


def payload_crc(payload: dict) -> str:
    """CRC32 over the canonical JSON encoding of ``payload`` minus the
    stamp field itself (so the stamp can live inside the document)."""
    body = {k: v for k, v in payload.items() if k != CRC_FIELD}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return f"{zlib.crc32(blob.encode()) & 0xFFFFFFFF:08x}"


def stamp_crc(payload: dict) -> dict:
    payload[CRC_FIELD] = payload_crc(payload)
    return payload


def check_crc(payload: dict) -> bool:
    """True when the stamp matches or is absent (legacy file)."""
    stamp = payload.get(CRC_FIELD)
    return stamp is None or stamp == payload_crc(payload)


def atomic_write_json(path: str | os.PathLike, payload: dict, *,
                      indent: int | None = 1) -> None:
    """Crash-safe JSON publish: pid-unique tmp file in the same
    directory, fsync, then atomic rename over the target."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)


def quarantine(path: str | os.PathLike, artifact: str,
               reason: str = "corrupt") -> Path | None:
    """Move a corrupt artifact aside (``<name>.quarantined[.N]``) and
    count it.  Returns the quarantine path, or None when the file was
    already gone.  Never raises — a quarantine that itself fails just
    deletes the file so the rebuild can proceed."""
    path = Path(path)
    if not path.exists():
        return None
    dest = path.with_name(path.name + ".quarantined")
    n = 0
    while dest.exists():
        n += 1
        dest = path.with_name(f"{path.name}.quarantined.{n}")
    try:
        path.replace(dest)
    except OSError:
        try:
            path.unlink()
        except OSError:
            return None
        dest = None
    obs.registry().counter(
        "artifact_quarantined_total",
        help="corrupt persisted artifacts moved aside on load",
        artifact=artifact, reason=reason).inc()
    return dest


def load_json_checked(path: str | os.PathLike, artifact: str
                      ) -> dict | None:
    """Parse + CRC-verify a JSON artifact.  Returns the payload dict, or
    None after quarantining an unreadable/corrupt file.  A missing file
    returns None without quarantine."""
    path = Path(path)
    try:
        text = path.read_text()
    except FileNotFoundError:
        return None
    except (OSError, ValueError):  # ValueError covers non-UTF8 garbage
        quarantine(path, artifact, reason="unreadable")
        return None
    try:
        payload = json.loads(text)
        if not isinstance(payload, dict):
            raise ValueError("artifact root must be a JSON object")
    except ValueError:
        quarantine(path, artifact, reason="parse")
        return None
    if not check_crc(payload):
        quarantine(path, artifact, reason="crc")
        return None
    return payload
