"""The port's ctypes layer over ``native/*.cpp`` (``ingest/native.py``)
and the native sort route of ``build_graph``: the native and Python
routes of the port bit-equal to each other and to the JAX package's
native route, on the cases of ``tests/test_native_crawl.py`` and
``tests/test_native.py``."""

import json
import math
import os
import struct

import numpy as np
import pytest

from pagerank_tpu import build_graph as jax_build_graph
from pagerank_tpu.ingest import native as jax_native
from pagerank_tpu.ingest.crawljson import load_crawl_file as jax_crawl_file
from pagerank_tpu.ingest.seqfile import load_crawl_seqfile as jax_seqfile

from pagerank_tpu_torch import graph as graph_mod
from pagerank_tpu_torch.graph import build_graph, native_sort_auto
from pagerank_tpu_torch.ingest import native
from pagerank_tpu_torch.ingest.crawljson import load_crawl_file_routed
from pagerank_tpu_torch.ingest.seqfile import (load_crawl_seqfile,
                                               load_crawl_seqfile_routed,
                                               write_sequence_file)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("src", "dst", "out_degree", "in_degree", "dangling_mask",
          "zero_in_mask", "edge_weight")


def assert_same(a, b):
    g1, im1 = a
    g2, im2 = b
    assert im1.names == im2.names
    assert g1.n == g2.n
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(g1, f), getattr(g2, f),
                                      err_msg=f)
    for name in im1.names[:50]:
        assert im1.get(name) == im2.get(name)


def three_routes(load_ours, load_theirs, path, strict=True, **python_kw):
    """The port's Python and native routes and the JAX package's native
    route on one input; all three must agree."""
    py, r_py = load_ours(path, strict=strict, native="off", **python_kw)
    nat, r_nat = load_ours(path, strict=strict, native="auto")
    assert (r_py, r_nat) == ("python", "native")
    theirs = load_theirs(path, strict=strict, native="auto")
    assert_same(py, nat)
    assert_same(theirs, nat)
    return py, nat


def both_seqfile(tmp_path, records, compression="none", strict=True):
    p = str(tmp_path / f"seg-{compression}")
    write_sequence_file(p, records, compression=compression, sync_every=3)
    return three_routes(load_crawl_seqfile_routed, jax_seqfile, p, strict,
                        workers=1)


def both_tsv(tmp_path, lines, strict=True):
    p = str(tmp_path / "crawl.tsv")
    with open(p, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return three_routes(load_crawl_file_routed, jax_crawl_file, p, strict)


def meta(targets, types=None):
    links = [{"type": ("a" if types is None else types[i]), "href": t}
             for i, t in enumerate(targets)]
    return json.dumps({"content": {"links": links}}, ensure_ascii=False)


# -- the libraries ------------------------------------------------------------

def test_libraries_build_under_build_native_and_leave_the_jax_one(
        tmp_path, monkeypatch):
    jax_so = os.path.join(REPO, "native", "libfast_ingest.so")
    jax_native.get_lib()  # the JAX package's own build, done first

    def state():
        if not os.path.exists(jax_so):
            return None
        st = os.stat(jax_so)
        return st.st_mtime_ns, open(jax_so, "rb").read()

    before = state()
    assert native.BUILD_DIR == __import__("pathlib").Path(REPO) / "build" / \
        "native"
    fresh = tmp_path / "build" / "native"
    monkeypatch.setattr(native, "BUILD_DIR", fresh)
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_errors", {})
    for name in ("fast_ingest", "crawl_ingest"):
        path = native.library_path(name)
        assert path.parent == fresh and path.name.startswith(f"lib{name}-")
        assert not path.exists()
        assert native.available(name), native.build_error(name)
        assert path.is_file()
    assert sorted(p.name.split("-")[0] for p in fresh.iterdir()) == [
        "libcrawl_ingest", "libfast_ingest"]
    out = native.sort_dedup_degrees_native(np.array([1, 0]),
                                           np.array([0, 1]), 2)
    assert out[0].tolist() == [1, 0]
    assert state() == before


def test_the_library_key_covers_source_flags_and_cpu(monkeypatch):
    a = native.library_path("fast_ingest")
    assert a != native.library_path("crawl_ingest")
    monkeypatch.setattr(native, "_cpu_flags", lambda: b"flags : other")
    assert native.library_path("fast_ingest") != a
    monkeypatch.undo()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path("fast_ingest") != a


def test_without_a_compiler_the_routes_are_python(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_errors", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.get_lib("fast_ingest") is None
    assert "g++ not found" in native.build_error("fast_ingest")
    assert native.sort_dedup_degrees_native(np.zeros(1), np.zeros(1),
                                            1) is None
    p = str(tmp_path / "seg")
    write_sequence_file(p, [("http://a/", meta(["http://b/"]))])
    (g, ids), route = load_crawl_seqfile_routed(p)
    assert route == "python" and ids.names == ["http://a/", "http://b/"]
    rng = np.random.default_rng(0)
    g = build_graph(rng.integers(0, 9, 50), rng.integers(0, 9, 50), n=9,
                    use_native_sort=True)
    assert g.sort_route == "numpy"


# -- the sorter ---------------------------------------------------------------

@pytest.mark.parametrize("n,e,seed", [
    (500, 20000, 1),     # heavy duplicates
    (1, 7, 2),           # one vertex: every edge a self-loop duplicate
    (1009, 3000, 3),     # n not a power of two
    (70000, 1 << 17, 4),
])
def test_sort_dedup_matches_np_unique_and_jax(n, e, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ns, nd, odeg, ideg = native.sort_dedup_degrees_native(src, dst, n)
    key = np.unique(dst * np.int64(n) + src)
    np.testing.assert_array_equal(nd, (key // n).astype(np.int32))
    np.testing.assert_array_equal(ns, (key % n).astype(np.int32))
    np.testing.assert_array_equal(odeg, np.bincount(ns, minlength=n))
    np.testing.assert_array_equal(ideg, np.bincount(nd, minlength=n))
    theirs = jax_native.sort_dedup_degrees_native(src, dst, n)
    for a, b in zip(theirs, (ns, nd, odeg, ideg)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sort_dedup_empty_input():
    ns, nd, odeg, ideg = native.sort_dedup_degrees_native(
        np.zeros(0, np.int64), np.zeros(0, np.int64), 5)
    assert len(ns) == len(nd) == 0
    assert odeg.tolist() == ideg.tolist() == [0] * 5
    g = build_graph(np.zeros(0), np.zeros(0), n=5, use_native_sort=True)
    assert g.num_edges == 0 and g.sort_route == ""


@pytest.mark.parametrize("cores,edges,want", [
    (8, (1 << 22) - 1, False), (8, 1 << 22, True), (2, 1 << 22, True),
    (1, 1 << 22, False), (1, (1 << 27) - 1, False), (1, 1 << 27, True),
    (None, 1 << 22, False),
])
def test_auto_rule_threshold(monkeypatch, cores, edges, want):
    monkeypatch.setattr(graph_mod.os, "cpu_count", lambda: cores)
    assert native_sort_auto(edges) is want


def test_build_graph_takes_the_native_route_at_the_threshold(monkeypatch):
    monkeypatch.setattr(graph_mod.os, "cpu_count", lambda: 4)
    rng = np.random.default_rng(2)
    n, e = 5000, 1 << 22
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    g_native = build_graph(src, dst, n=n)
    g_numpy = build_graph(src[:-1], dst[:-1], n=n)
    assert (g_native.sort_route, g_numpy.sort_route) == ("native", "numpy")
    g_ref = build_graph(src, dst, n=n, use_native_sort=False)
    theirs = jax_build_graph(src, dst, n=n, use_native_sort=False)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(g_native, f), getattr(g_ref, f))
        np.testing.assert_array_equal(getattr(g_native, f),
                                      getattr(theirs, f))
    assert g_native.fingerprint() == theirs.fingerprint()


# -- the edge-list parser -----------------------------------------------------

def test_parse_matches_python_and_jax(tmp_path):
    from pagerank_tpu_torch.ingest.edgelist import load_edgelist_routed

    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 1000, 5000), rng.integers(0, 1000, 5000)
    lines = ["# header comment"]
    for i, (s, d) in enumerate(zip(src, dst)):
        lines.append(f"{s}\t{d}" if i % 2 else f"{s} {d}")
        if i % 97 == 0:
            lines.append("# interior comment")
    p = tmp_path / "edges.txt"
    p.write_text("\n".join(lines) + "\n")
    (ns, nd), route = load_edgelist_routed(str(p))
    assert route == "native"
    np.testing.assert_array_equal(ns, src)
    np.testing.assert_array_equal(nd, dst)
    (ps, pd), route = load_edgelist_routed(str(p), comments="# ")
    assert route == "python"
    np.testing.assert_array_equal(ps, src)
    js, jd = jax_native.parse_edgelist_native(str(p))
    np.testing.assert_array_equal(js, ns)


@pytest.mark.parametrize("text,exc", [
    ("0 1\n2\n", ValueError), ("0 1\nx y\n", ValueError), (None, FileNotFoundError),
])
def test_parse_errors(tmp_path, text, exc):
    p = tmp_path / "bad.txt"
    if text is not None:
        p.write_text(text)
    with pytest.raises(exc):
        native.parse_edgelist_native(str(p))


def test_parse_empty(tmp_path):
    p = tmp_path / "empty.txt"
    p.write_text("# nothing\n")
    s, d = native.parse_edgelist_native(str(p))
    assert len(s) == 0 and len(d) == 0


# -- the crawl L1 (the cases of tests/test_native_crawl.py) ---------------------

ADVERSARIAL_HREFS = [
    "http://plain/", 'quo"ted', "back\\slash", "tab\there", "new\nline",
    "bell\x07gamma\x01", "unicode: é中\U0001F600", "mixed\"\\\"x", "",
    "sp ace", "\x1f\x7f",
]


def test_string_quirks(tmp_path):
    py, _ = both_seqfile(tmp_path, [("http://src/", meta(ADVERSARIAL_HREFS))])
    assert "quo\\ted" in py[1].names and "back\\\\slash" in py[1].names


def test_nonstring_href_rendering(tmp_path):
    payload = {"content": {"links": [
        {"type": "a", "href": v} for v in
        (42, -0, 123456789012345678901234567890, True, False, None,
         [1, "two", {"three": 3.5}], {"k": [None, -7], "j": "s"})]}}
    both_seqfile(tmp_path, [("http://src/", json.dumps(payload))])


def test_float_repr(tmp_path):
    floats = [0.0, -0.0, 1.0, 100.0, 1e15, 1e16, 9999999999999998.0, 1e-4,
              1e-5, 1.5e-5, 123.456, 0.1, 2.675, 1e300, -1e300, 5e-324,
              1.7976931348623157e308, 3.141592653589793, 1e22, 1e23,
              -7.066e-9]
    rng = np.random.default_rng(7)
    floats += [float(x) for x in rng.standard_normal(60)
               * 10.0 ** rng.integers(-30, 30, 60).astype(float)]
    links = ", ".join('{"type": "a", "href": %s}' % repr(f) for f in floats
                      if math.isfinite(f))
    both_tsv(tmp_path, ["http://src/\t" + '{"content": {"links": [%s]}}'
                        % links])


def test_escapes_surrogates_and_duplicate_keys(tmp_path):
    doc = ('{"content": {"links": ['
           '{"type": "a", "href": "esc\\u0041\\u00e9\\ud83d\\ude00"},'
           '{"type": "a", "href": "lone\\ud800tail"},'
           '{"type": "a", "href": "low\\udc3ax"},'
           '{"type": "a", "href": "\\/slash\\b\\f\\n\\r\\t"}]}}')
    dup = ('{"content": {"links": [{"type": "x", "href": "skipme", '
           '"type": "a", "href": "kept"}]}, "content": {"links": '
           '[{"type": "a", "href": "outer-dup"}]}}')
    py, _ = both_tsv(tmp_path, ["http://src/\t" + doc, "http://d/\t" + dup])
    assert "outer-dup" in py[1].names and "kept" not in py[1].names


def test_structure_tolerance_and_json_oddities(tmp_path):
    docs = ["{}", "null", "[]", '"str"', "7", "true", '{"content": null}',
            '{"content": 5}', '{"content": []}', '{"content": {"links": null}}',
            '{"content": {"links": {}}}', '{"content": {"links": "zz"}}',
            '{"content": {"links": [{"type": "A", "href": "x"}]}}',
            '{"content": {"links": [{"type": 1, "href": "x"}]}}',
            '{"content": {"links": [{"type": "a", "href": NaN}]}}',
            '{"content": {"links": [{"type": "a", "href": -Infinity}]}}',
            ' \t\n\r{ "content" : { "links" : [ ] } } \n']
    both_seqfile(tmp_path, [(f"http://u{i}/", d) for i, d in enumerate(docs)])


BAD_RECORDS = [
    ('{"content": {"links": [{"href": "x"}]}}', KeyError),
    ('{"content": {"links": [{"type": "a"}]}}', KeyError),
    ('{"content": {"links": ["notdict"]}}', TypeError),
    ('{"content": {"links": [5]}}', TypeError),
    ('{broken', json.JSONDecodeError),
    ('{"a": 01}', json.JSONDecodeError),
    ('{"a": "un\x01escaped"}', json.JSONDecodeError),
    ("", json.JSONDecodeError),
]


@pytest.mark.parametrize("doc,exc", BAD_RECORDS)
def test_strict_error_class(tmp_path, doc, exc):
    p = str(tmp_path / "seg")
    write_sequence_file(p, [("http://ok/", meta(["http://t/"])),
                            ("http://bad/", doc)])
    for native_mode in ("off", "auto"):
        with pytest.raises(exc):
            load_crawl_seqfile(p, strict=True, native=native_mode)


def test_nonstrict_skips(tmp_path):
    records = [("http://ok/", meta(["http://t/"]))]
    records += [(f"http://bad{i}/", d) for i, (d, _) in enumerate(BAD_RECORDS)]
    records += [("http://mixed/",
                 '{"content": {"links": [{"type": "a", "href": "good1"}, '
                 '{"href": "nope"}, "str", {"type": "a", "href": "good2"}]}}')]
    py, _ = both_seqfile(tmp_path, records, strict=False)
    assert "good1" in py[1].names and "good2" in py[1].names


def test_jsonl_lines_and_errors(tmp_path):
    lines = [
        json.dumps({"url": "http://a/", "metadata": {"content": {"links": [
            {"type": "a", "href": "http://b/"}]}}}),
        json.dumps({"url": "http://c/", "json": {"content": {"links": [
            {"type": "a", "href": "http://a/"}]}}}),
        json.dumps({"url": "http://d/"}),
        json.dumps({"url": "http://e/", "metadata": None}),
        "http://tsv/\t" + meta(["http://a/"]),
    ]
    both_tsv(tmp_path, lines)
    for bad, exc in [("{notjson", json.JSONDecodeError),
                     ('{"nourl": 1}', KeyError), ("[1, 2]", TypeError)]:
        for strict in (True, False):
            with pytest.raises(exc):
                both_tsv(tmp_path, [bad], strict=strict)


def test_jsonl_nonstring_url_takes_the_python_route(tmp_path):
    p = str(tmp_path / "crawl.jsonl")
    with open(p, "w") as f:
        f.write(json.dumps({"url": 5, "metadata": {"content": {"links": [
            {"type": "a", "href": "http://t/"}]}}}) + "\n")
    (g, ids), route = load_crawl_file_routed(p, native="auto")
    assert route == "python" and ids.names == [5, "http://t/"]


@pytest.mark.parametrize("compression", ["none", "record", "block"])
def test_compression_layouts(tmp_path, compression):
    rng = np.random.default_rng(3)
    records = [(f"http://u{rng.integers(0, 120)}/",
                meta([f"http://t{rng.integers(0, 300)}/"
                      for _ in range(rng.integers(0, 8))]))
               for _ in range(200)]
    both_seqfile(tmp_path, records, compression=compression)


def test_invalid_utf8_replacement(tmp_path):
    bad_urls = [b"http://x/\xff\xfe", b"http://y/\xc2", b"http://z/\xe0\xa0",
                b"http://w/\xe0\x80\x80", b"http://v/\xed\xa0\x80",
                b"http://u/\xf0\x9f\x98\x80ok", b"http://t/\xf4\x90\x80\x80",
                b"http://s/\x80tail"]

    def text_bytes(payload):
        return struct.pack("b", len(payload)) + payload

    cls = b"org.apache.hadoop.io.Text"
    p = str(tmp_path / "rawseq")
    with open(p, "wb") as f:
        f.write(b"SEQ\x06" + text_bytes(cls) + text_bytes(cls) + b"\x00\x00")
        f.write(struct.pack(">i", 0) + bytes(range(16)))
        for url in bad_urls:
            k = text_bytes(url)
            v = text_bytes(meta(["t"]).encode())
            f.write(struct.pack(">i", len(k) + len(v)))
            f.write(struct.pack(">i", len(k)) + k + v)
    py, _ = three_routes(load_crawl_seqfile_routed, jax_seqfile, p)
    assert any("�" in nm for nm in py[1].names)


def test_randomized_fuzz(tmp_path):
    rng = np.random.default_rng(11)
    pool = ADVERSARIAL_HREFS + ["http://t/", "x", "ümläut"]

    def value(depth=0):
        k = rng.integers(0, 9 if depth < 3 else 6)
        if k == 0:
            return pool[rng.integers(0, len(pool))]
        if k == 1:
            return int(rng.integers(-10**9, 10**9))
        if k == 2:
            return float(rng.standard_normal() * 10.0 ** rng.integers(-20, 20))
        if k == 3:
            return bool(rng.integers(0, 2))
        if k == 4:
            return None
        if k == 5:
            return int(rng.integers(0, 10)) * 10**18
        if k == 6:
            return [value(depth + 1) for _ in range(rng.integers(0, 4))]
        return {f"k{rng.integers(0, 5)}": value(depth + 1)
                for _ in range(rng.integers(0, 4))}

    records = []
    for _ in range(300):
        links = []
        for _ in range(rng.integers(0, 6)):
            entry = {}
            if rng.random() < 0.9:
                entry["type"] = "a" if rng.random() < 0.7 else value()
            if rng.random() < 0.9:
                entry["href"] = value()
            links.append(entry if rng.random() < 0.9 else value())
        doc = {"content": {"links": links}}
        if rng.random() < 0.1:
            doc = value()
        records.append((f"http://u{rng.integers(0, 100)}/",
                        json.dumps(doc, ensure_ascii=False)))
    both_seqfile(tmp_path, records, strict=False, compression="block")


def test_container_mutation_fuzz(tmp_path):
    """Random corruptions of the container in all three layouts: the
    port's two routes and the JAX package's native route agree on the
    result or the exception class."""
    rng = np.random.default_rng(29)
    bases = {}
    for comp in ("none", "record", "block"):
        p = str(tmp_path / f"base-{comp}")
        write_sequence_file(p, [(f"u{i}", meta([f"t{j}" for j in range(i % 4)]))
                                for i in range(12)],
                            compression=comp, sync_every=5)
        bases[comp] = open(p, "rb").read()

    def run(load, path, strict, **kw):
        try:
            g, im = load(path, strict=strict, **kw)
            return im.names, g.src.tolist(), g.dst.tolist()
        except Exception as e:  # noqa: BLE001 - class parity
            return ("ValueError" if isinstance(e, UnicodeDecodeError)
                    else type(e).__name__)

    p = str(tmp_path / "mut")
    for trial in range(60):
        data = bytearray(bases[("none", "record", "block")[trial % 3]])
        for _ in range(int(rng.integers(1, 5))):
            op, pos = rng.integers(0, 3), int(rng.integers(0, len(data)))
            if op == 0:
                data[pos] = int(rng.integers(0, 256))
            elif op == 1:
                data.insert(pos, int(rng.integers(0, 256)))
            else:
                del data[pos]
        with open(p, "wb") as f:
            f.write(bytes(data))
        for strict in (False, True):
            got = [run(load_crawl_seqfile, p, strict, native="off"),
                   run(load_crawl_seqfile, p, strict, native="auto"),
                   run(jax_seqfile, p, strict, native="auto")]
            assert got[0] == got[1] == got[2], (trial, strict)


def _segment(tmp_path, files, seed):
    seg = tmp_path / "seg"
    seg.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(files):
        records = [(f"http://u{rng.integers(0, 50)}/",
                    meta([f"http://t{rng.integers(0, 90)}/"
                          for _ in range(rng.integers(0, 6))]))
                   for _ in range(25)]
        write_sequence_file(str(seg / f"metadata-{i:05d}"), records,
                            compression="block")
    return seg, [str(seg / f"metadata-{i:05d}") for i in range(files)]


def test_multifile_threads_keep_the_order(tmp_path):
    seg, paths = _segment(tmp_path, 11, 17)
    one = native.crawl_load(paths, "seqfile", threads=1)
    for threads in (2, 4, 16):
        assert_same(one, native.crawl_load(paths, "seqfile", threads=threads))
    assert_same(one, jax_native.crawl_load(paths, "seqfile", threads=3))
    three_routes(load_crawl_seqfile_routed, jax_seqfile, str(seg),
                 workers=1)
    raw = native.crawl_load(paths, "seqfile", raw=True)
    np.testing.assert_array_equal(~raw[2], one[0].dangling_mask)


def test_threads_report_the_earliest_error(tmp_path):
    seg = tmp_path / "seg"
    seg.mkdir()
    for i in range(8):
        recs = ([("http://bad3/", "{broken")] if i == 3 else
                [("http://bad6/", '{"content": {"links": [{"href": "x"}]}}')]
                if i == 6 else [(f"http://ok{i}/", meta(["http://t/"]))])
        write_sequence_file(str(seg / f"metadata-{i:05d}"), recs)
    paths = [str(seg / f"metadata-{i:05d}") for i in range(8)]
    for threads in (4, 1):
        with pytest.raises(json.JSONDecodeError, match="metadata-00003"):
            native.crawl_load(paths, "seqfile", strict=True, threads=threads)
    g, im = native.crawl_load(paths, "seqfile", strict=False, threads=4)
    assert im.names == load_crawl_seqfile(str(seg), strict=False,
                                          native="off", workers=1)[1].names


def test_explicit_workers_select_the_python_pool(tmp_path, monkeypatch):
    p = str(tmp_path / "seg")
    write_sequence_file(p, [("http://a/", meta(["http://b/"]))])

    def boom(*a, **k):
        raise AssertionError("native path used despite explicit workers")

    monkeypatch.setattr(native, "crawl_load", boom)
    (g, im), route = load_crawl_seqfile_routed(p, workers=1)
    assert route == "python" and im.names == ["http://a/", "http://b/"]


def test_nothing_builds_at_import():
    import subprocess
    import sys

    code = ("import pagerank_tpu_torch, pagerank_tpu_torch.cli, "
            "pagerank_tpu_torch.ingest, pagerank_tpu_torch.ingest.external, "
            "pagerank_tpu_torch.scripts.host_ingest_bench\n"
            "from pagerank_tpu_torch.ingest import native\n"
            "assert native._loaded == {} and native._errors == {}\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
