"""ctypes bindings for the native ingestion sources (``native/*.cpp``).

Port of ``pagerank_tpu/ingest/native.py``. The C++ sources at the root
of the repo are compiled, unedited, with ``g++`` into two shared
libraries under ``build/native/`` at the root of the checkout:

- ``fast_ingest`` (``native/fast_ingest.cpp``): the radix sort-dedup
  behind ``build_graph`` and the mmap edge-list parser; needs no zlib;
- ``crawl_ingest`` (``native/crawl_ingest.cpp``, linked with ``-lz``):
  the crawl L1 (SequenceFile decode + JSON link extraction + interning).

So a host without ``zlib.h`` still gets the sorter. Each library's name
carries a hash of its source, the compiler flags and the host's CPU
feature flags (``-march=native``), so an edited source rebuilds and a
library built for another CPU is never loaded. Nothing is built at
import: the first call that needs a library builds it. A library that
cannot be built leaves its entry points returning None, and
:func:`build_error` says why; the JAX package's ``native/libfast_ingest.so``
is never read or written here.

Every entry point returns None when its library is unavailable, as in
the JAX package, and the callers (``graph.py``, ``ingest/*.py``) then
take the Python route and report which route ran.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

REPO_DIR = Path(__file__).resolve().parent.parent.parent
NATIVE_SRC_DIR = REPO_DIR / "native"
BUILD_DIR = REPO_DIR / "build" / "native"

CXX_FLAGS = ("-std=c++17", "-O3", "-march=native", "-shared", "-fPIC")
#: library name -> (source under native/, link libraries).
LIBRARIES = {
    "fast_ingest": ("fast_ingest.cpp", ("-lpthread",)),
    "crawl_ingest": ("crawl_ingest.cpp", ("-lpthread", "-lz")),
}

_lock = threading.Lock()
_loaded: Dict[str, Optional[ctypes.CDLL]] = {}
_errors: Dict[str, str] = {}


def _cpu_flags() -> bytes:
    """The host CPU's feature flags, which ``-march=native`` compiles
    for (first ``flags`` line of /proc/cpuinfo; empty elsewhere)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path(name: str) -> Path:
    """Where library ``name`` is built: keyed by a hash of its source,
    the flags, the link libraries and the host CPU's feature flags."""
    src, libs = LIBRARIES[name]
    h = hashlib.sha256((NATIVE_SRC_DIR / src).read_bytes())
    h.update(" ".join(CXX_FLAGS + libs).encode())
    h.update(_cpu_flags())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    """Compile library ``name`` (when missing) into a temp file and
    rename it into place; raises RuntimeError with the compiler output."""
    out = library_path(name)
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    src, libs = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [gxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC_DIR / src), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except subprocess.TimeoutExpired:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ timed out on native/{src}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/{src} (exit "
                           f"{proc.returncode}):\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


class _ParseResult(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.POINTER(ctypes.c_int64)),
        ("dst", ctypes.POINTER(ctypes.c_int64)),
        ("count", ctypes.c_int64),
        ("error", ctypes.c_int64),
    ]


def _i32p():
    return np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _bind_fast_ingest(lib: ctypes.CDLL) -> None:
    lib.parse_edgelist.restype = _ParseResult
    lib.parse_edgelist.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.free_edges.restype = None
    lib.free_edges.argtypes = [ctypes.POINTER(ctypes.c_int64),
                               ctypes.POINTER(ctypes.c_int64)]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.sort_dedup_degrees.restype = ctypes.c_int64
    lib.sort_dedup_degrees.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        _i32p(), _i32p(), _i32p(), _i32p(),
    ]


def _bind_crawl_ingest(lib: ctypes.CDLL) -> None:
    lib.crawl_new.restype = ctypes.c_void_p
    lib.crawl_new.argtypes = []
    lib.crawl_free.restype = None
    lib.crawl_free.argtypes = [ctypes.c_void_p]
    lib.crawl_ingest_files.restype = ctypes.c_int64
    lib.crawl_ingest_files.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.crawl_error.restype = ctypes.c_char_p
    lib.crawl_error.argtypes = [ctypes.c_void_p]
    for fn in ("crawl_num_edges", "crawl_num_vertices", "crawl_num_records",
               "crawl_names_blob_size", "crawl_failed_index"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.crawl_copy_edges.restype = None
    lib.crawl_copy_edges.argtypes = [ctypes.c_void_p, _i32p(), _i32p()]
    lib.crawl_drain_edges.restype = ctypes.c_int64
    lib.crawl_drain_edges.argtypes = [ctypes.c_void_p, _i32p(), _i32p()]
    lib.crawl_copy_crawled.restype = None
    lib.crawl_copy_crawled.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    lib.crawl_copy_names.restype = None
    lib.crawl_copy_names.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]


_BINDERS = {"fast_ingest": _bind_fast_ingest,
            "crawl_ingest": _bind_crawl_ingest}


def get_lib(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library ``name`` ("fast_ingest" or "crawl_ingest"),
    building it at first use; None when it cannot be built or loaded
    (the reason is in :func:`build_error`). Tried once per process."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        lib = None
        try:
            lib = ctypes.CDLL(str(_build(name)))
            _BINDERS[name](lib)
        except (OSError, RuntimeError, AttributeError) as e:
            lib = None
            _errors[name] = str(e)
        _loaded[name] = lib
        return lib


def available(name: str = "crawl_ingest") -> bool:
    """Whether library ``name`` builds and loads on this host."""
    return get_lib(name) is not None


def build_error(name: str) -> Optional[str]:
    """Why library ``name`` is unavailable (None when it loaded or was
    never asked for)."""
    return _errors.get(name)


def parse_edgelist_native(path: str, num_threads: int = 0):
    """mmap + multithreaded text edge-list parse. Returns (src, dst)
    int64 arrays, or None if the library is unavailable."""
    lib = get_lib("fast_ingest")
    if lib is None:
        return None
    res = lib.parse_edgelist(os.fsencode(path), num_threads)
    if res.error == 1:
        raise FileNotFoundError(path)
    if res.error == 2:
        lib.free_edges(res.src, res.dst)
        raise ValueError(f"{path}: odd token count; not a src/dst list")
    if res.error == 3:
        lib.free_edges(res.src, res.dst)
        raise ValueError(f"{path}: non-integer token; not a src/dst list")
    e = res.count
    if e == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    src = np.ctypeslib.as_array(res.src, shape=(e,)).copy()
    dst = np.ctypeslib.as_array(res.dst, shape=(e,)).copy()
    lib.free_edges(res.src, res.dst)
    return src, dst


def sort_dedup_degrees_native(
    src: np.ndarray, dst: np.ndarray, n: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """dst-major radix sort + dedup + degree count. Returns (src32,
    dst32, out_degree, in_degree) or None if unavailable. Endpoints must
    lie in [0, n) (``build_graph`` checks that first)."""
    lib = get_lib("fast_ingest")
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst length mismatch: {src.shape} vs {dst.shape}")
    e = src.shape[0]
    out_src = np.empty(max(e, 1), np.int32)
    out_dst = np.empty(max(e, 1), np.int32)
    out_deg = np.empty(n, np.int32)
    in_deg = np.empty(n, np.int32)
    k = lib.sort_dedup_degrees(src, dst, e, n, out_src, out_dst, out_deg,
                               in_deg)
    return out_src[:k].copy(), out_dst[:k].copy(), out_deg, in_deg


#: crawl_ingest_files input kinds.
_CRAWL_KIND_SEQFILE = 0
_CRAWL_KIND_TSV = 1


class NativeUnsupported(Exception):
    """Input is valid for the Python path but unrepresentable natively
    (e.g. a non-string JSONL url, which Python keeps as a non-str dict
    key). Callers take the Python path."""


def _crawl_raise(cat: int, msg: str, path: str):
    """Raise the exception class the Python ingest path raises for the
    same input (crawl_ingest_files error category -> class)."""
    if cat == 2:
        raise json.JSONDecodeError(f"{msg} (in {path})", "", 0)
    if cat == 3:
        raise KeyError(msg)
    if cat == 4:
        raise TypeError(f"{msg} (in {path})")
    if cat == 6:
        raise RuntimeError(f"{msg} (in {path})")
    if cat == 7:
        raise EOFError(f"{path}: {msg}")
    if cat == 8:
        raise zlib.error(f"{path}: {msg}")
    if cat == 9:
        raise NativeUnsupported(f"{path}: {msg}")
    raise ValueError(f"{path}: {msg}")


def try_crawl_load(paths, kind: str, strict: bool = True,
                   threads: Optional[int] = None, raw: bool = False):
    """:func:`crawl_load`, or None when the library is unavailable or
    the input is valid but unrepresentable natively (NativeUnsupported):
    callers then take the Python path."""
    try:
        return crawl_load(paths, kind, strict=strict, threads=threads,
                          raw=raw)
    except NativeUnsupported:
        return None


def iter_read_batches(paths, window: int, byte_cap: int):
    """Yield ``(batch_paths, datas)`` groups of whole-file reads bounded
    by ``window`` files and ``byte_cap`` total bytes a batch. The cap is
    checked before appending, so a batch exceeds it only when a single
    file does."""
    from pagerank_tpu_torch.utils import fsio

    batch_paths, datas, nbytes = [], [], 0
    for path in paths:
        with fsio.fopen(path, "rb") as f:
            data = f.read()
        if datas and nbytes + len(data) > byte_cap:
            yield batch_paths, datas
            batch_paths, datas, nbytes = [], [], 0
        batch_paths.append(path)
        datas.append(data)
        nbytes += len(data)
        if len(datas) >= window:
            yield batch_paths, datas
            batch_paths, datas, nbytes = [], [], 0
    if datas:
        yield batch_paths, datas


def _iter_ingest_batches(lib, h, paths, window, byte_cap, kind_code,
                         strict, threads):
    """Read file batches (the next one read while the native call parses
    the current: ctypes releases the GIL) and ingest each into crawl
    handle ``h``, yielding after every batch. Raises the Python path's
    exception classes on malformed input, naming the culprit file."""
    gen = iter_read_batches(paths, window, byte_cap)
    with concurrent.futures.ThreadPoolExecutor(1) as prefetch:
        fut = prefetch.submit(next, gen, None)
        while True:
            item = fut.result()
            if item is None:
                return
            fut = prefetch.submit(next, gen, None)
            batch, datas = item
            arr = (ctypes.c_char_p * len(datas))(*datas)
            lens = (ctypes.c_int64 * len(datas))(*[len(d) for d in datas])
            cat = lib.crawl_ingest_files(h, len(datas), arr, lens, kind_code,
                                         1 if strict else 0, threads)
            if cat != 0:
                msg = (lib.crawl_error(h) or b"").decode("utf-8", "replace")
                bad = lib.crawl_failed_index(h)
                culprit = batch[bad] if 0 <= bad < len(batch) else batch[0]
                _crawl_raise(cat, msg, culprit)
            yield batch


def default_threads(paths, threads: Optional[int] = None) -> int:
    """The native L1's thread count for ``paths``: ``threads``, or one
    per core, at most one per file."""
    if threads is None:
        threads = min(len(paths), os.cpu_count() or 1)
    return max(int(threads), 1)


def _copy_names(lib, h, n):
    """Interned vertex names out of a crawl handle (surrogatepass: lone
    surrogates from \\uXXXX escapes round-trip, stored WTF-8)."""
    blob_size = lib.crawl_names_blob_size(h)
    blob = ctypes.create_string_buffer(max(blob_size, 1))
    offsets = np.empty(n + 1, np.int64)
    lib.crawl_copy_names(h, blob, offsets)
    blob_bytes = blob.raw[:blob_size]
    return [blob_bytes[offsets[i]:offsets[i + 1]].decode("utf-8",
                                                         "surrogatepass")
            for i in range(n)]


def _copy_crawled(lib, h, n):
    crawled = np.zeros(max(n, 1), np.uint8)
    if n:
        lib.crawl_copy_crawled(h, crawled)
    return crawled[:n].astype(bool)


def crawl_load(paths, kind: str, strict: bool = True,
               threads: Optional[int] = None, raw: bool = False):
    """Native L1: parse crawl inputs (``kind`` "seqfile" or "tsv") into
    a (Graph, IdMap) with the record and id order and the quirks of the
    Python path (crawljson.py + seqfile.py). Returns None when the
    library is unavailable; raises the Python path's exception classes
    on malformed input.

    Files parse across ``threads`` C++ threads (default one per core,
    at most one per file) with file-ordered interning, so the result is
    the same at any thread count. Each file is read whole; batches hold
    at most 2 x threads files and ~256 MB.

    ``raw=True`` skips the graph build and returns ``(src, dst,
    crawled_mask, IdMap)``."""
    lib = get_lib("crawl_ingest")
    if lib is None:
        return None
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.ingest.ids import IdMap

    kind_code = _CRAWL_KIND_SEQFILE if kind == "seqfile" else _CRAWL_KIND_TSV
    paths = list(paths)
    threads = default_threads(paths, threads)
    h = lib.crawl_new()
    try:
        for _ in _iter_ingest_batches(lib, h, paths, 2 * threads, 256 << 20,
                                      kind_code, strict, threads):
            pass
        n = lib.crawl_num_vertices(h)
        e = lib.crawl_num_edges(h)
        src = np.empty(max(e, 1), np.int32)
        dst = np.empty(max(e, 1), np.int32)
        lib.crawl_copy_edges(h, src, dst)
        crawled = _copy_crawled(lib, h, n)
        names = _copy_names(lib, h, n)
    finally:
        lib.crawl_free(h)
    if raw:
        return src[:e], dst[:e], crawled, IdMap.from_names(names)
    graph = build_graph(src[:e], dst[:e], n=n, dangling_mask=~crawled,
                        vertex_names=names)
    return graph, IdMap.from_names(names)


def crawl_load_external(paths, kind: str, mem_cap_bytes: int = 2 << 30,
                        strict: bool = True, threads: Optional[int] = None,
                        tmp_dir: Optional[str] = None):
    """Out-of-core crawl ingest: the native L1 parses file batches as in
    :func:`crawl_load`, and after every batch the edges are drained out
    of the C++ state into the external-sort build
    (``ingest/external.build_graph_external``), so the edge set is never
    resident at once. The interner (url table, O(vertices)) stays in
    RAM. Two file batches (current + prefetched) come out of
    ``mem_cap_bytes`` before the sort gets the rest.

    Returns (Graph, IdMap) field-identical to :func:`crawl_load` on the
    same inputs, or None when the library is unavailable."""
    if mem_cap_bytes < (128 << 20):
        raise ValueError(
            "mem_cap_bytes must be at least 128 MiB for crawl inputs "
            "(2 file-batch buffers + the external sort's 64 MiB floor)"
        )
    lib = get_lib("crawl_ingest")
    if lib is None:
        return None
    from pagerank_tpu_torch.ingest.external import build_graph_external
    from pagerank_tpu_torch.ingest.ids import IdMap

    kind_code = _CRAWL_KIND_SEQFILE if kind == "seqfile" else _CRAWL_KIND_TSV
    paths = list(paths)
    threads = default_threads(paths, threads)
    byte_cap = min(256 << 20, max(16 << 20, mem_cap_bytes // 4))
    sort_cap = max(64 << 20, mem_cap_bytes - 2 * byte_cap)
    final = {}
    h = lib.crawl_new()
    try:
        def chunk_gen():
            for _ in _iter_ingest_batches(lib, h, paths, 2 * threads,
                                          byte_cap, kind_code, strict,
                                          threads):
                e = lib.crawl_num_edges(h)
                src = np.empty(max(e, 1), np.int32)
                dst = np.empty(max(e, 1), np.int32)
                got = lib.crawl_drain_edges(h, src, dst)
                if got != e:
                    raise RuntimeError(f"crawl_drain_edges gave {got} "
                                       f"edges, expected {e}")
                if e:
                    yield src[:e], dst[:e]

        def final_n():
            final["n"] = lib.crawl_num_vertices(h)
            final["crawled"] = _copy_crawled(lib, h, final["n"])
            return final["n"]

        graph = build_graph_external(
            chunk_gen(), n=final_n, mem_cap_bytes=sort_cap, tmp_dir=tmp_dir,
            dangling_mask=lambda: ~final["crawled"],
        )
        names = _copy_names(lib, h, final["n"])
    finally:
        lib.crawl_free(h)
    graph.vertex_names = names
    return graph, IdMap.from_names(names)
