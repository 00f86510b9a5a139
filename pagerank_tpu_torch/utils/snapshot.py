"""Checkpoint / resume.

Port of ``pagerank_tpu/utils/snapshot.py:40-264, 650-704``
(``Snapshotter``, ``SnapshotCorruptError``, ``resume_engine``) without
its metrics, tracer and async writer. The on-disk format is the JAX
package's, byte for byte in meaning: ``ranks_iter{i}.npz`` with members
``ranks``, ``iteration``, ``fingerprint``, ``semantics``, ``checksum``
and an optional ``mesh``, and the same sha256 ``_digest``. So a
snapshot directory written by either package resumes in the other.

Every save is atomic (tmp + rename) and every load verifies the
checksum, so a torn or bit-flipped snapshot is detected and skipped by
``load_latest_valid`` instead of being resumed into.
"""

from __future__ import annotations

import hashlib
import json
import re
import warnings
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from pagerank_tpu_torch.utils import fsio

_PAT = re.compile(r"^ranks_iter(\d+)\.npz$")


class SnapshotCorruptError(RuntimeError):
    """A snapshot file exists but cannot be trusted: unreadable npz,
    missing members, or checksum mismatch."""


def _digest(ranks: np.ndarray, iteration: int, fingerprint: str,
            semantics: str, mesh: str = "") -> str:
    """sha256 over the rank payload and its identifying metadata."""
    h = hashlib.sha256()
    h.update(
        f"{iteration}|{fingerprint}|{semantics}|"
        f"{ranks.dtype.str}|{ranks.shape}|".encode()
    )
    if mesh:
        h.update(f"mesh:{mesh}|".encode())
    h.update(np.ascontiguousarray(ranks).tobytes())
    return h.hexdigest()


def _to_host(ranks) -> np.ndarray:
    """One contiguous host array from a numpy array or a torch tensor."""
    if hasattr(ranks, "detach"):
        ranks = ranks.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(ranks))


class Snapshotter:
    """Writes ``ranks_iter{i}.npz`` files into a local ``directory``.

    The payload is the host-order rank vector (original vertex ids);
    ``mesh_meta`` is provenance JSON covered by the checksum."""

    def __init__(self, directory: str, graph_fingerprint: str,
                 semantics: str, mesh_meta: Optional[Dict] = None):
        self.directory = directory
        self.fingerprint = graph_fingerprint
        self.semantics = semantics
        self.mesh_meta = mesh_meta
        fsio.makedirs(directory, exist_ok=True)

    def path(self, iteration: int) -> str:
        return fsio.join(self.directory, f"ranks_iter{iteration}.npz")

    def save(self, iteration: int, ranks) -> str:
        p = self.path(iteration)
        ranks = _to_host(ranks)
        mesh_json = (json.dumps(self.mesh_meta, sort_keys=True)
                     if self.mesh_meta else "")
        members = {}
        if mesh_json:
            members["mesh"] = np.bytes_(mesh_json.encode())
        with fsio.atomic_write(p, "wb", suffix=".tmp.npz") as f:
            np.savez(
                f,
                ranks=ranks,
                iteration=np.int64(iteration),
                fingerprint=np.bytes_(self.fingerprint.encode()),
                semantics=np.bytes_(self.semantics.encode()),
                checksum=np.bytes_(
                    _digest(ranks, iteration, self.fingerprint,
                            self.semantics, mesh_json).encode()
                ),
                **members,
            )
        return p

    def iterations(self) -> List[int]:
        """All snapshot iterations present, ascending (by name only)."""
        try:
            entries = fsio.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for m in map(_PAT.match, entries) if m)

    def load(self, iteration: int, verify: bool = True
             ) -> Tuple[np.ndarray, Dict[str, object]]:
        """Load one snapshot. Raises FileNotFoundError when absent and
        :class:`SnapshotCorruptError` when present but unreadable or
        failing its checksum."""
        path = self.path(iteration)
        try:
            with fsio.fopen(path, "rb") as f, np.load(f) as z:
                meta = {
                    "fingerprint": bytes(z["fingerprint"]).decode(),
                    "semantics": bytes(z["semantics"]).decode(),
                    "iteration": int(z["iteration"]),
                }
                mesh_json = (
                    bytes(z["mesh"]).decode() if "mesh" in z.files else ""
                )
                meta["mesh"] = json.loads(mesh_json) if mesh_json else None
                ranks = z["ranks"].copy()
                stored = (
                    bytes(z["checksum"]).decode()
                    if "checksum" in z.files else None
                )
        except FileNotFoundError:
            raise
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            raise SnapshotCorruptError(
                f"snapshot {path} is unreadable: {e!r}"
            ) from e
        if verify:
            if stored is None:
                warnings.warn(
                    f"snapshot {path} predates content checksums; "
                    f"integrity not verifiable", RuntimeWarning,
                )
            else:
                want = _digest(ranks, meta["iteration"],
                               meta["fingerprint"], meta["semantics"],
                               mesh_json)
                if stored != want:
                    raise SnapshotCorruptError(
                        f"snapshot {path} failed its checksum "
                        f"(stored {stored[:12]}…, computed {want[:12]}…)"
                    )
        return ranks, meta

    def load_latest_valid(
        self, max_iteration: Optional[int] = None, match: bool = False
    ) -> Optional[Tuple[int, np.ndarray, Dict[str, object]]]:
        """Newest loadable, checksum-valid snapshot (optionally at or
        below ``max_iteration``): ``(iteration, ranks, meta)`` or None.
        Corrupt files are skipped with a warning. ``match=True`` also
        skips snapshots of another graph or semantics (the rollback
        contract); the resume path keeps ``match=False`` so a mismatch
        raises in :func:`resume_engine` instead."""
        for it in reversed(self.iterations()):
            if max_iteration is not None and it > max_iteration:
                continue
            try:
                ranks, meta = self.load(it)
            except FileNotFoundError:
                continue  # raced with cleanup
            except SnapshotCorruptError as e:
                warnings.warn(
                    f"skipping corrupt snapshot for iteration {it}: {e}",
                    RuntimeWarning,
                )
                continue
            if match and (meta["fingerprint"] != self.fingerprint
                          or meta["semantics"] != self.semantics):
                warnings.warn(
                    f"skipping snapshot for iteration {it}: taken on a "
                    f"different graph/semantics "
                    f"({meta['fingerprint'][:12]}…/{meta['semantics']} vs "
                    f"{self.fingerprint[:12]}…/{self.semantics})",
                    RuntimeWarning,
                )
                continue
            return it, ranks, meta
        return None


def resume_engine(engine, snap: Snapshotter) -> int:
    """Restore the latest valid snapshot into ``engine``; returns the
    iteration resumed from (0 if none found). Corrupt snapshots are
    skipped; a snapshot of a different graph or semantics raises."""
    found = snap.load_latest_valid()
    if found is None:
        return 0
    _it, ranks, meta = found
    if meta["fingerprint"] != snap.fingerprint:
        raise ValueError(
            f"snapshot graph fingerprint {meta['fingerprint']} != current "
            f"{snap.fingerprint}; refusing to resume"
        )
    if meta["semantics"] != snap.semantics:
        raise ValueError(
            f"snapshot semantics {meta['semantics']!r} != current "
            f"{snap.semantics!r}"
        )
    engine.set_ranks(ranks, iteration=meta["iteration"])
    return meta["iteration"]
