"""Out-of-core host graph build.

Copy of ``pagerank_tpu/ingest/external.py``; the graph it returns has
``sort_route == "external"``.

`graph.build_graph` materializes the raw edges, the packed sort keys,
and the sort's working set in one address space (~48 B/edge). The reference
never holds the edge set in one space: Spark streams partitions from S3
through the shuffle (Sparky.java:61,124). This module is the host-side
analogue: an external-sort dedup whose WORKING memory is bounded by a
configurable cap, independent of edge count.

Pipeline (classic external sort, numpy-vectorized):

  1. **Spill**: stream (src, dst) chunks sized from the cap; pack each
     into ``(dst << 32) | src`` uint64 keys (exactly the (dst, src)
     total order build_graph sorts by), `np.unique` the chunk, spill
     the sorted run to a temp file.
  2. **Merge**: windowed k-way merge of the sorted runs — load bounded
     blocks per run, cut at the smallest loaded block-max, sort+unique
     the window (duplicates across runs collapse here), stream the
     window out: accumulate out/in-degrees and append the final int32
     (src, dst) arrays.

Peak RSS = the final Graph arrays (16 B/edge src+dst int32 + 8 B/edge
weight + degrees) + O(cap) transients — vs ~48 B/edge transient in the
in-memory path. The output Graph is FIELD-IDENTICAL to
`build_graph(src, dst)` (pinned by tests/test_torch_external.py).

"""

from __future__ import annotations

import os
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np

from pagerank_tpu_torch.graph import Graph, inv_out_degree

# Working-memory budget split: a spill chunk at flush holds the pending
# key (8 B/edge), np.unique's internal sort copy (~8), its output (~8),
# and the live input chunk views — 60 B/edge peak measured for the JAX
# package's copy of this module (docs/PERF_NOTES.md "Host ingest"), so
# 64 keeps the working set within the caller's cap.
_SPILL_BYTES_PER_EDGE = 64
_MERGE_FRACTION = 0.25
_MIN_CHUNK_EDGES = 1 << 16  # spill-chunk floor (module-level so tests
# can force many tiny runs without gigabyte inputs)


def iter_text_chunks(path: str, chunk_edges: int,
                     comments: str = "#") -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream a SNAP-style text edge list in ~``chunk_edges`` chunks
    without loading the file (1 line = 1 edge; ``#`` comments)."""
    from pagerank_tpu_torch.utils import fsio

    buf = b""
    # Text lines run ~8-20 bytes/edge; read enough for one chunk.
    block = max(1 << 20, chunk_edges * 16)
    with fsio.fopen(path, "rb") as f:
        while True:
            data = f.read(block)
            if not data:
                break
            data = buf + data
            cut = data.rfind(b"\n")
            if cut == -1:
                buf = data
                continue
            buf = data[cut + 1:]
            yield _parse_lines(data[:cut], path, comments)
    if buf.strip():
        yield _parse_lines(buf, path, comments)


def _parse_lines(data: bytes, path: str, comments: str):
    lines = [
        ln for ln in data.splitlines()
        if ln and not ln.lstrip().startswith(comments.encode())
    ]
    flat = np.array(b" ".join(lines).split(), dtype=np.int64)
    if flat.size % 2:
        raise ValueError(f"{path}: odd token count; not a src/dst list")
    pairs = flat.reshape(-1, 2)
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def _iter_array_chunks(src, dst, chunk_edges):
    for lo in range(0, len(src), chunk_edges):
        yield src[lo : lo + chunk_edges], dst[lo : lo + chunk_edges]


def _npy_stream_header(f, path):
    """Parse the npy magic+header off a streaming member and return
    (count, dtype). Rejects shapes the edge-member contract excludes."""
    from numpy.lib import format as npy_format

    version = npy_format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = npy_format.read_array_header_1_0(f)
    else:
        shape, fortran, dtype = npy_format.read_array_header_2_0(f)
    if len(shape) != 1 or dtype.hasobject:
        raise ValueError(
            f"{path}: edge members must be 1-D numeric arrays "
            f"(got shape {shape}, dtype {dtype})"
        )
    return shape[0], dtype


def iter_npz_chunks(path: str, chunk_edges: int):
    """Stream the ``src``/``dst`` members of a local ``.npz`` in
    parallel ~``chunk_edges`` chunks with bounded RSS.

    numpy's npz is a zip of ``.npy`` members; ``zipfile`` reads a
    member incrementally (stored copies bytes, deflated inflates with
    an O(window) state), so after parsing each member's npy header off
    the stream the element bytes can be consumed chunkwise — the input
    file never materializes in RAM, stored or compressed. Two members
    are streamed in lockstep via independent ``ZipFile.open`` handles
    (concurrent member reads are supported when the archive is opened
    by name). Returns (iterator, n_hint)."""
    import zipfile

    from numpy.lib import format as npy_format

    if chunk_edges <= 0:
        raise ValueError(f"chunk_edges must be positive, got {chunk_edges}")
    zf = zipfile.ZipFile(path, "r")
    fs = fd = None
    try:
        names = set(zf.namelist())

        def member(base):
            nm = base + ".npy"
            if nm in names:
                return nm
            if base in names:
                return base
            raise ValueError(f"{path}: .npz is missing member {base!r}")

        n = None
        if "n.npy" in names or "n" in names:
            with zf.open(member("n")) as f:
                n = int(npy_format.read_array(f))

        fs = zf.open(member("src"))
        fd = zf.open(member("dst"))
        ns, dt_s = _npy_stream_header(fs, path)
        nd, dt_d = _npy_stream_header(fd, path)
        if ns != nd:
            raise ValueError(
                f"{path}: src/dst length mismatch: {ns} vs {nd}"
            )
    except BaseException:
        for h in (fs, fd, zf):
            if h is not None:
                h.close()
        raise

    def gen():
        with zf, fs, fd:
            left = ns
            while left:
                k = min(chunk_edges, left)
                sb = fs.read(k * dt_s.itemsize)
                db = fd.read(k * dt_d.itemsize)
                if len(sb) != k * dt_s.itemsize or len(db) != k * dt_d.itemsize:
                    raise ValueError(f"{path}: truncated .npy member data")
                yield (
                    np.frombuffer(sb, dt_s),
                    np.frombuffer(db, dt_d),
                )
                left -= k

    return gen(), n


def open_edge_chunks(path: str, chunk_edges: int):
    """Chunk iterator for a path: .npz binary (members streamed through
    zipfile with bounded RSS — :func:`iter_npz_chunks`; remote URIs
    still load whole, a seekable local file is required to stream zip
    members) or text (truly streamed). Returns (iterator, n_hint)."""
    from pagerank_tpu_torch.utils import fsio

    if os.path.splitext(path)[1] == ".npz":
        if fsio.scheme_of(path) is None:
            return iter_npz_chunks(path, chunk_edges)
        from pagerank_tpu_torch.ingest.edgelist import load_binary_edges

        src, dst, n = load_binary_edges(path)
        return _iter_array_chunks(src, dst, chunk_edges), n
    return iter_text_chunks(path, chunk_edges), None


def build_graph_external(
    edges,
    n: Optional[int] = None,
    mem_cap_bytes: int = 2 << 30,
    tmp_dir: Optional[str] = None,
    dangling_mask: Optional[np.ndarray] = None,
) -> Graph:
    """`graph.build_graph` semantics under a bounded working-memory cap.

    Args:
      edges: a path (text / .npz — see :func:`open_edge_chunks`) or an
        iterable of (src, dst) int array chunks (any chunking; re-cut
        internally to the cap).
      n: vertex count; discovered as max id + 1 when omitted (ids must
        fit int32 either way, like build_graph's device contract). May
        be a CALLABLE resolved after the input is fully consumed — for
        producers whose vertex count is only known at end of stream
        (the crawl interner, ingest/native.crawl_load_external).
      mem_cap_bytes: working-memory budget for the build's transients
        (spill chunks, merge windows). The final Graph arrays are
        excluded — they are the caller's product, not working state.
      tmp_dir: where sorted runs spill (default: a fresh tempdir,
        removed on return).
      dangling_mask: explicit mass mask (crawl semantics), as in
        build_graph; may be a callable like ``n``.

    Returns a Graph FIELD-IDENTICAL to ``build_graph(src, dst, n=n)``
    on the concatenated input.
    """
    if mem_cap_bytes < (64 << 20):
        raise ValueError("mem_cap_bytes must be at least 64 MiB")
    chunk_edges = max(_MIN_CHUNK_EDGES, mem_cap_bytes // _SPILL_BYTES_PER_EDGE)
    if isinstance(edges, (str, os.PathLike)):
        chunks, n_hint = open_edge_chunks(str(edges), chunk_edges)
        if n is None:
            n = n_hint
    else:
        chunks = iter(edges)
    n_lazy = n if callable(n) else None

    own_tmp = tmp_dir is None
    tmp = tmp_dir or tempfile.mkdtemp(prefix="pagerank_extsort_")
    runs = []
    max_id = -1
    try:
        # -- spill phase ------------------------------------------------
        pend = []
        pend_n = 0

        def flush_run():
            nonlocal pend, pend_n, max_id
            if not pend_n:
                return
            key = np.concatenate(pend) if len(pend) > 1 else pend[0]
            pend, pend_n = [], 0
            key = np.unique(key)
            hi = int(key[-1] >> 32)
            lo_max = int((key & np.uint64(0xFFFFFFFF)).max())
            max_id = max(max_id, hi, lo_max)
            path = os.path.join(tmp, f"run{len(runs):05d}.npy")
            np.save(path, key)
            runs.append(path)
            del key

        for s, d in chunks:
            s = np.ascontiguousarray(s, dtype=np.int64)
            d = np.ascontiguousarray(d, dtype=np.int64)
            if s.shape != d.shape:
                raise ValueError(
                    f"src/dst length mismatch: {s.shape} vs {d.shape}"
                )
            if len(s) == 0:
                continue
            if s.min() < 0 or d.min() < 0:
                raise ValueError("edge endpoint out of range [0, n)")
            if max(int(s.max()), int(d.max())) >= (1 << 31):
                raise ValueError("vertex ids must fit int32")
            # Re-cut to the cap regardless of input chunking.
            for lo in range(0, len(s), chunk_edges):
                key = (
                    d[lo : lo + chunk_edges].astype(np.uint64) << np.uint64(32)
                ) | s[lo : lo + chunk_edges].astype(np.uint64)
                pend.append(key)
                pend_n += len(key)
                if pend_n >= chunk_edges:
                    flush_run()
        flush_run()

        if n_lazy is not None:
            n = n_lazy()  # producer's count, known at end of stream
        if n is None:
            n = max_id + 1 if max_id >= 0 else 0
        n = int(n)
        if n == 0:
            raise ValueError("empty graph: no vertices")
        if max_id >= n:
            raise ValueError("edge endpoint out of range [0, n)")

        out_degree = np.zeros(n, np.int32)
        in_degree = np.zeros(n, np.int32)
        if not runs:
            src_s = np.zeros(0, np.int32)
            dst_s = np.zeros(0, np.int32)
        else:
            # -- merge phase --------------------------------------------
            block = max(
                1 << 14,
                int(mem_cap_bytes * _MERGE_FRACTION) // (16 * len(runs)),
            )
            # Merged keys buffer to DISK, not to growing in-RAM parts:
            # a list-of-parts + final concatenate would peak at final
            # arrays + one full extra copy (measured +1.6 GB at 2^27
            # edges); the file costs one 8 B/edge write+read and keeps
            # the peak at final arrays + O(block).
            merged_path = os.path.join(tmp, "merged.bin")
            merged_f = open(merged_path, "wb")
            n_unique = 0
            mms = [np.load(p, mmap_mode="r") for p in runs]
            loaded = [m[:block].copy() for m in mms]
            pos = [b.size for b in loaded]  # next unread offset per run
            while True:
                live = [i for i in range(len(runs))
                        if loaded[i].size or pos[i] < mms[i].size]
                if not live:
                    break
                # Refill empties, then cut at the smallest loaded
                # block-max among runs that still have unloaded data
                # (everything <= that bound is globally complete).
                for i in live:
                    if not loaded[i].size:
                        p = pos[i]
                        loaded[i] = mms[i][p : p + block].copy()
                        pos[i] = p + loaded[i].size
                bound = None
                for i in live:
                    if pos[i] < mms[i].size or loaded[i].size:
                        m = int(loaded[i][-1]) if loaded[i].size else None
                        if m is not None and (
                            pos[i] < mms[i].size
                        ):
                            bound = m if bound is None else min(bound, m)
                take = []
                for i in live:
                    if bound is None:
                        cut = loaded[i].size
                    else:
                        cut = int(np.searchsorted(
                            loaded[i], np.uint64(bound), side="right"
                        ))
                    if cut:
                        take.append(loaded[i][:cut])
                        loaded[i] = loaded[i][cut:]
                if not take:
                    continue
                window = np.concatenate(take) if len(take) > 1 else take[0]
                window = np.unique(window)
                # Cross-WINDOW duplicates cannot exist (windows are
                # disjoint key ranges), so emit directly.
                np.add.at(
                    out_degree,
                    (window & np.uint64(0xFFFFFFFF)).astype(np.int32), 1,
                )
                np.add.at(
                    in_degree, (window >> np.uint64(32)).astype(np.int32), 1,
                )
                merged_f.write(window.tobytes())
                n_unique += window.size
            merged_f.close()
            del mms
            # Decode the merged key stream into exactly-sized arrays.
            src_s = np.empty(n_unique, np.int32)
            dst_s = np.empty(n_unique, np.int32)
            keys = np.memmap(merged_path, dtype=np.uint64, mode="r")
            dec_block = max(1 << 16, int(mem_cap_bytes * _MERGE_FRACTION) // 16)
            for lo in range(0, n_unique, dec_block):
                kb = np.array(keys[lo : lo + dec_block])
                src_s[lo : lo + kb.size] = (
                    kb & np.uint64(0xFFFFFFFF)
                ).astype(np.int32)
                dst_s[lo : lo + kb.size] = (kb >> np.uint64(32)).astype(np.int32)
            del keys
            os.remove(merged_path)
    finally:
        for p in runs:
            try:
                os.remove(p)
            except OSError:
                pass
        if own_tmp:
            try:
                os.rmdir(tmp)
            except OSError:
                pass

    if callable(dangling_mask):
        dangling_mask = dangling_mask()
    if dangling_mask is None:
        dangling_mask = out_degree == 0
    else:
        dangling_mask = np.ascontiguousarray(dangling_mask, dtype=bool)
        if dangling_mask.shape != (n,):
            raise ValueError(
                f"dangling_mask shape {dangling_mask.shape} != ({n},)"
            )
        if np.any(dangling_mask & (out_degree > 0)):
            raise ValueError("dangling_mask marks a vertex that has out-edges")

    return Graph(
        n=n,
        src=src_s,
        dst=dst_s,
        out_degree=out_degree,
        in_degree=in_degree,
        dangling_mask=dangling_mask,
        zero_in_mask=in_degree == 0,
        edge_weight=inv_out_degree(out_degree)[src_s],
        vertex_names=None,
        sort_route="external",
    )
