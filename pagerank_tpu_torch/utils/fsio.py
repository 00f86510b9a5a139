"""Pluggable URI-scheme file I/O (L1/L4 edges of the system).

The reference's literal inputs are 301 ``s3n://`` URIs and its output an
S3 bucket (``Sparky.java:44-58,237``) — the Hadoop
filesystem layer resolves the scheme and streams bytes. This module is
that seam for the TPU build: every loader (edge lists, .npz, crawl TSV,
SequenceFiles) and every sink (Snapshotter, TextDumper, rank TSV, JSONL
metrics) opens paths through here, so an object-store backend plugs in
by registering a :class:`FileSystem` for its scheme — no loader changes.

Scheme-less paths use the local OS filesystem unchanged. Two non-local
backends exist: :class:`MemoryFileSystem` (an object-store-semantics
in-memory store) under ``mock://`` in tests/test_fsio.py, and the real
S3-protocol client (utils/s3.py — stdlib HTTP + SigV4 signing,
auto-registered for ``s3://``/``s3n://``/``s3a://`` when
``PAGERANK_TPU_S3_ENDPOINT`` is set; exercised against an in-process
stub server in tests/test_s3.py, since this environment has zero
egress). Both round-trip ingest -> snapshot -> resume through the CLI.

Copy of ``pagerank_tpu/utils/fsio.py``.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import threading
from typing import Dict, List, Optional

# Two+ characters: a single letter before :// is Windows drive syntax,
# not a URI scheme.
_SCHEME_RE = re.compile(r"^([A-Za-z][A-Za-z0-9+.-]+)://")


def scheme_of(path: str) -> Optional[str]:
    """URI scheme of ``path``, or None for a plain local path. Single-
    letter "schemes" are never URIs (Windows drive syntax), and this
    codebase treats anything without ``://`` as local."""
    m = _SCHEME_RE.match(path)
    return m.group(1).lower() if m else None


def registered(scheme: Optional[str]) -> bool:
    """Whether a filesystem is registered for ``scheme`` (None — local —
    is always available)."""
    return scheme is None or scheme.lower() in _REGISTRY


class FileSystem:
    """Minimal filesystem interface the loaders/sinks need. Implementors
    receive FULL paths (scheme included) — an object store keys by URI.

    ``replace`` must be atomic within the store (the Snapshotter's
    torn-file guarantee rides on it; a backend without native rename can
    implement copy+delete only if readers never see partial objects,
    which object stores guarantee per-object).

    ``COMMIT_ON_FLUSH``: whether buffered writers publish their bytes
    on every ``flush()`` (crash durability for incremental sinks) or
    only at close (real object stores, where a per-flush re-PUT of the
    whole object is O(records^2) network bytes — see _MemWriter)."""

    COMMIT_ON_FLUSH = True

    def open(self, path: str, mode: str = "r", **kwargs):
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError

    def isfile(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        raise NotImplementedError

    def replace(self, src: str, dst: str) -> None:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def open(self, path, mode="r", **kwargs):
        return open(path, mode, **kwargs)

    def exists(self, path):
        return os.path.exists(path)

    def isdir(self, path):
        return os.path.isdir(path)

    def isfile(self, path):
        return os.path.isfile(path)

    def listdir(self, path):
        return os.listdir(path)

    def makedirs(self, path, exist_ok=True):
        os.makedirs(path, exist_ok=exist_ok)

    def replace(self, src, dst):
        os.replace(src, dst)


class _MemWriter(io.BytesIO):
    """Write buffer that commits to the store atomically on clean close —
    object-store PUT semantics (readers never see a partial object).
    Exiting a ``with`` block on an exception ABORTS the put (a real
    store abandons the upload), so a writer that dies mid-serialization
    never publishes a torn object.

    An explicit ``flush()`` ALSO commits the bytes so far when the
    owning filesystem opts in (``COMMIT_ON_FLUSH``, default True):
    incremental sinks (the JSONL metrics logger) flush after every
    record precisely so a killed run keeps its records, and for
    in-memory stores that crash behavior must match the local backend.
    A REAL object store sets it False — re-PUTting the whole object
    per record is O(records^2) network bytes, so there durability
    arrives at close (utils/s3.py). Writers that need torn-object
    protection get it by never flushing mid-serialization (none in
    this codebase do) — the atomic rename in the Snapshotter guards
    the rest."""

    def __init__(self, fs: "MemoryFileSystem", path: str, initial: bytes = b""):
        super().__init__()
        self.write(initial)
        self._fs = fs
        self._path = path
        self._aborted = False

    def abort(self):
        self._aborted = True

    def flush(self):
        super().flush()
        if (not self.closed and not self._aborted
                and getattr(self._fs, "COMMIT_ON_FLUSH", True)):
            self._fs._commit(self._path, self.getvalue())

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        return super().__exit__(exc_type, exc, tb)

    def close(self):
        if not self.closed and not self._aborted:
            self._fs._commit(self._path, self.getvalue())
        super().close()


class _MemTextWrapper(io.TextIOWrapper):
    """Text wrapper that propagates with-block exceptions to the
    underlying writer's abort-on-error semantics."""

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and isinstance(self.buffer, _MemWriter):
            self.buffer.abort()
        return super().__exit__(exc_type, exc, tb)


class MemoryFileSystem(FileSystem):
    """In-memory object store: flat ``{uri: bytes}`` plus implicit
    directories (any key prefix), mirroring S3-style stores closely
    enough to exercise every loader/sink contract. Thread-safe — the
    async snapshot writer commits from a worker thread."""

    def __init__(self):
        self._lock = threading.RLock()
        self.files: Dict[str, bytes] = {}
        self.dirs = set()

    def _commit(self, path: str, data: bytes) -> None:
        with self._lock:
            self.files[path] = data

    def open(self, path, mode="r", **kwargs):
        binary = "b" in mode
        kind = mode.replace("b", "").replace("t", "") or "r"
        with self._lock:
            if kind == "r":
                if path not in self.files:
                    raise FileNotFoundError(path)
                raw: io.IOBase = io.BytesIO(self.files[path])
            elif kind in ("w", "x"):
                if kind == "x" and path in self.files:
                    raise FileExistsError(path)
                raw = _MemWriter(self, path)
            elif kind == "a":
                raw = _MemWriter(self, path, self.files.get(path, b""))
                raw.seek(0, io.SEEK_END)
            else:
                raise ValueError(f"unsupported mode {mode!r}")
        if binary:
            return raw
        kwargs.pop("newline", None)
        kwargs.setdefault("encoding", "utf-8")
        return _MemTextWrapper(raw, **kwargs)

    def exists(self, path):
        return self.isfile(path) or self.isdir(path)

    def isfile(self, path):
        with self._lock:
            return path in self.files

    def isdir(self, path):
        prefix = path.rstrip("/") + "/"
        with self._lock:
            return path.rstrip("/") in self.dirs or any(
                k.startswith(prefix) for k in self.files
            )

    def listdir(self, path):
        prefix = path.rstrip("/") + "/"
        names = set()
        with self._lock:
            if not (path.rstrip("/") in self.dirs
                    or any(k.startswith(prefix) for k in self.files)):
                raise FileNotFoundError(path)
            for k in list(self.files) + list(self.dirs):
                if k.startswith(prefix):
                    names.add(k[len(prefix):].split("/", 1)[0])
        return sorted(n for n in names if n)

    def makedirs(self, path, exist_ok=True):
        key = path.rstrip("/")
        with self._lock:
            if not exist_ok and key in self.dirs:
                raise FileExistsError(path)
            self.dirs.add(key)

    def replace(self, src, dst):
        with self._lock:
            if src not in self.files:
                raise FileNotFoundError(src)
            self.files[dst] = self.files.pop(src)


_LOCAL = LocalFileSystem()
_REGISTRY: Dict[str, FileSystem] = {}


def register(scheme: str, fs: FileSystem) -> None:
    """Make ``scheme://...`` paths resolve through ``fs`` everywhere
    (loaders, snapshots, text dumps, CLI outputs)."""
    _REGISTRY[scheme.lower()] = fs


def unregister(scheme: str) -> None:
    _REGISTRY.pop(scheme.lower(), None)


def get_fs(path: str) -> FileSystem:
    scheme = scheme_of(path)
    if scheme is None:
        return _LOCAL
    fs = _REGISTRY.get(scheme)
    if fs is None and scheme in ("s3", "s3n", "s3a"):
        # Lazy S3 auto-registration from the environment (utils/s3):
        # with PAGERANK_TPU_S3_ENDPOINT set, s3:// paths work with no
        # wiring — the reference's inputs are s3n:// URIs
        # (Sparky.java:44-58). Fills only MISSING schemes, never
        # replacing an explicit registration.
        from pagerank_tpu_torch.utils import s3 as s3_mod

        s3_mod.register_s3(only_missing=True)
        fs = _REGISTRY.get(scheme)
    if fs is None:
        hint = (
            "set PAGERANK_TPU_S3_ENDPOINT (and AWS_* credentials "
            "if the store needs them) or "
            if scheme in ("s3", "s3n", "s3a") else ""
        )
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} "
            f"(path {path!r}); {hint}register one with "
            f"pagerank_tpu_torch.utils.fsio.register({scheme!r}, fs) "
            f"(registered: {sorted(_REGISTRY) or 'none'})"
        )
    return fs


# -- module-level conveniences (the loader/sink call surface) -------------


def fopen(path: str, mode: str = "r", **kwargs):
    return get_fs(path).open(path, mode, **kwargs)


def exists(path: str) -> bool:
    return get_fs(path).exists(path)


def isdir(path: str) -> bool:
    return get_fs(path).isdir(path)


def isfile(path: str) -> bool:
    return get_fs(path).isfile(path)


def listdir(path: str) -> List[str]:
    return get_fs(path).listdir(path)


def makedirs(path: str, exist_ok: bool = True) -> None:
    get_fs(path).makedirs(path, exist_ok=exist_ok)


def replace(src: str, dst: str) -> None:
    """Atomic rename within ONE store. A cross-scheme pair would silently
    rename inside src's store (creating a key spelled with the other
    scheme), so it is rejected up front — callers that really mean
    copy-across-stores must stream bytes explicitly."""
    if scheme_of(src) != scheme_of(dst):
        raise ValueError(
            f"fsio.replace is same-store only: {src!r} -> {dst!r} "
            f"cross schemes ({scheme_of(src)!r} vs {scheme_of(dst)!r})"
        )
    get_fs(src).replace(src, dst)


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb", suffix: str = ".tmp", **kwargs):
    """Write-then-rename: bytes land at ``path`` only when the writer
    body completes — THE one torn-file guard for every sink that must
    never publish a parseable-looking partial file (Snapshotter.save and
    TextDumper.dump both ride this path; docs/ROBUSTNESS.md). A kill or
    exception mid-write leaves at worst a ``path + suffix`` temp the
    consumers' name patterns never match (object-store backends abort
    the upload outright — nothing is published at all)."""
    if any(c in mode for c in "ra+"):
        raise ValueError(f"atomic_write is write-only, got mode {mode!r}")
    tmp = path + suffix
    with fopen(tmp, mode, **kwargs) as f:
        yield f
    replace(tmp, path)


def join(base: str, *parts: str) -> str:
    """Path join that preserves URI schemes. Scheme paths are joined with
    literal '/' — os.path.join would insert the OS separator on Windows
    and silently discard the scheme/base for a part starting with '/'.
    Local paths keep os.path.join semantics."""
    scheme = scheme_of(base)
    if scheme is None:
        return os.path.join(base, *parts)
    # Never strip into the '//' of the scheme authority: a bare root
    # like 'mock://' must stay a URI ('mock://a', not 'mock:/a' which
    # would silently resolve to the LOCAL filesystem).
    root = len(scheme) + 3
    out = base
    for part in parts:
        head = out[:root] + out[root:].rstrip("/")
        out = head + ("" if head.endswith("/") else "/") + part.lstrip("/")
    return out
