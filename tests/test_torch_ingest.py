"""The port's crawl ingest (``ingest/ids.py``, ``crawljson.py``,
``seqfile.py``, ``utils/synth.crawl_segment``) against the JAX package:
the same files, made from a numpy seed, go through both packages, and
the ids, edges, crawled masks, names and graph arrays must be bit-equal
on the port's native and Python routes."""

import io
import json
import zlib

import numpy as np
import pytest

from pagerank_tpu.ingest import crawljson as jax_crawljson
from pagerank_tpu.ingest import ids as jax_ids
from pagerank_tpu.ingest import seqfile as jax_seqfile

from pagerank_tpu_torch.ingest import crawljson, ids, seqfile
from pagerank_tpu_torch.ingest.native import iter_read_batches
from pagerank_tpu_torch.utils.synth import crawl_segment

GRAPH_FIELDS = ("src", "dst", "out_degree", "in_degree", "dangling_mask",
                "zero_in_mask", "edge_weight")


def assert_same(theirs, ours):
    """(Graph, IdMap) of the JAX package against the port's: every
    array field, n, the names and the fingerprint bit-equal."""
    g1, im1 = theirs
    g2, im2 = ours
    assert im1.names == im2.names
    assert g1.n == g2.n
    for f in GRAPH_FIELDS:
        a, b = getattr(g1, f), getattr(g2, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert list(g1.vertex_names) == list(g2.vertex_names)
    assert g1.fingerprint() == g2.fingerprint()


def meta(targets, url=None):
    doc = {"content": {"links": [{"type": "a", "href": t} for t in targets]}}
    if url is not None:
        doc = {"url": url, **doc}
    return json.dumps(doc)


def random_records(seed, count, n_src=60, n_dst=120, max_links=6):
    rng = np.random.default_rng(seed)
    return [(f"http://u{rng.integers(0, n_src)}/",
             meta([f"http://t{rng.integers(0, n_dst)}/"
                   for _ in range(rng.integers(0, max_links))]))
            for _ in range(count)]


def seqfile_routes(path, strict=True):
    """The JAX package's Python route, then the port's Python and
    native routes, on one SequenceFile spec (the Python routes serial:
    the pool has its own tests)."""
    theirs = jax_seqfile.load_crawl_seqfile(path, strict=strict,
                                            native="off", workers=1)
    ours_py = seqfile.load_crawl_seqfile_routed(path, strict, workers=1,
                                                native="off")
    ours_nat = seqfile.load_crawl_seqfile_routed(path, strict,
                                                 native="auto")
    assert ours_py[1] == "python" and ours_nat[1] == "native"
    return theirs, ours_py[0], ours_nat[0]


# -- crawljson: Gson quirks, strict and lenient ------------------------------

QUIRK_DOCS = [
    # only type == "a" counts (Sparky.java:103)
    json.dumps({"content": {"links": [
        {"href": "http://x/1", "type": "a"}, {"href": "http://x/2",
                                              "type": "img"},
        {"href": "http://x/3", "type": "a"}]}}),
    # a non-string type never matches
    json.dumps({"content": {"links": [{"href": "h", "type": 1},
                                      {"href": "h2", "type": None}]}}),
    # every quote stripped from the Gson rendering (Sparky.java:105)
    json.dumps({"content": {"links": [{"href": 'a"b"c', "type": "a"}]}}),
    json.dumps({"content": {"links": [{"href": 7.5, "type": "a"},
                                      {"href": [1, "x"], "type": "a"}]}}),
    # no content or links: linkless
    json.dumps({"content": {}}), json.dumps({}),
    json.dumps({"content": None}), json.dumps({"content": {"links": []}}),
    # a bad entry: raises under strict, skipped otherwise
    json.dumps({"content": {"links": [{"type": "a"},
                                      {"href": "ok", "type": "a"}]}}),
    json.dumps({"content": {"links": ["notdict", {"href": "ok",
                                                  "type": "a"}]}}),
    "{not json",
]


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - class and message parity
        return type(e).__name__, str(e)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("doc", QUIRK_DOCS)
def test_parse_metadata_record_matches_jax(doc, strict):
    ours = _outcome(crawljson.parse_metadata_record, "http://src/", doc,
                    strict=strict)
    theirs = _outcome(jax_crawljson.parse_metadata_record, "http://src/",
                      doc, strict=strict)
    assert ours == theirs


@pytest.mark.parametrize("records", [
    [("a", ["b", "c"]), ("b", ["a"])],       # c uncrawled: dangling
    [("a", ["b"]), ("b", [])],               # b crawled, linkless: not
    [("a", ["a", "a", "b"]), ("c", []), ("b", ["c", "d", "c"])],
])
def test_records_to_graph_matches_jax(records):
    assert_same(jax_ids.records_to_graph(records),
                ids.records_to_graph(records))
    theirs = jax_ids.records_to_arrays(records)
    ours = ids.records_to_arrays(records)
    for a, b in zip(theirs[:3], ours[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert theirs[3].names == ours[3].names


def test_crawled_linkless_page_carries_no_dangling_mass():
    graph, idmap = ids.records_to_graph([("a", ["b", "d"]), ("b", []),
                                         ("c", ["a"])])
    b, d = idmap.get("b"), idmap.get("d")
    assert graph.out_degree[b] == 0 and not graph.dangling_mask[b]
    assert graph.out_degree[d] == 0 and graph.dangling_mask[d]


def test_idmap_roundtrip():
    m = ids.IdMap()
    assert [m.get_or_add(x) for x in "xyx"] == [0, 1, 0]
    assert "y" in m and m.get("z") is None and len(m) == 2
    assert ids.IdMap.from_names(m.names).names == ["x", "y"]


def test_crawl_tsv_and_jsonl_file_match_jax(tmp_path):
    lines = [
        "http://a/\t" + meta(["http://b/", "http://c/"]),
        json.dumps({"url": "http://b/", "metadata": json.loads(
            meta(["http://a/"]))}),
        json.dumps({"url": "http://c/", "json": {}}),
        "http://d/\t" + meta([]),
    ]
    p = tmp_path / "crawl.tsv"
    p.write_text("\n".join(lines) + "\n")
    theirs = jax_crawljson.load_crawl_file(str(p), native="off")
    for native in ("off", "auto"):
        ours, route = crawljson.load_crawl_file_routed(str(p), native=native)
        assert route == ("python" if native == "off" else "native")
        assert_same(theirs, ours)
    src, dst, crawled, idmap = crawljson.load_crawl_file_arrays(str(p))
    np.testing.assert_array_equal(crawled, [True, True, True, True])


# -- seqfile: container, compression, segments -------------------------------

@pytest.mark.parametrize("value", [0, 1, -1, 127, -112, 128, -113, 255, 256,
                                   65535, -65536, 2**31 - 1, -(2**31), 2**53])
def test_vint_bytes_match_jax(value):
    ours, theirs = io.BytesIO(), io.BytesIO()
    seqfile._write_vint(ours, value)
    jax_seqfile._write_vint(theirs, value)
    assert ours.getvalue() == theirs.getvalue()
    assert seqfile._read_vint(io.BytesIO(ours.getvalue())) == value


@pytest.mark.parametrize("compression", ["none", "record", "block"])
def test_writer_bytes_and_reader_match_jax(tmp_path, compression):
    records = random_records(3, 150)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert seqfile.write_sequence_file(ours, records, sync_every=7,
                                       compression=compression,
                                       block_size=4096) == 150
    jax_seqfile.write_sequence_file(theirs, records, sync_every=7,
                                    compression=compression,
                                    block_size=4096)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert list(seqfile.read_sequence_file(theirs)) == records
    assert list(jax_seqfile.read_sequence_file(ours)) == records


@pytest.mark.parametrize("compression", ["none", "record", "block"])
def test_graph_matches_jax_on_both_routes(tmp_path, compression):
    p = str(tmp_path / "seg")
    seqfile.write_sequence_file(p, random_records(5, 200), sync_every=3,
                                compression=compression)
    theirs, ours_py, ours_nat = seqfile_routes(p)
    assert_same(theirs, ours_py)
    assert_same(theirs, ours_nat)
    raw = seqfile.load_crawl_seqfile_arrays(p)
    np.testing.assert_array_equal(~raw[2], theirs[0].dangling_mask)


def test_segment_directory_and_comma_list(tmp_path):
    d = tmp_path / "segment"
    d.mkdir()
    for i in range(5):
        seqfile.write_sequence_file(str(d / f"metadata-{i:05d}"),
                                    random_records(10 + i, 20))
    (d / "_SUCCESS").write_text("")   # a Hadoop job marker: skipped
    (d / ".hidden").write_text("")    # hidden: skipped
    (d / "sub").mkdir()               # a subdirectory: skipped
    ours = seqfile.expand_seqfile_paths(str(d))
    assert ours == jax_seqfile.expand_seqfile_paths(str(d))
    assert [p.rsplit("/", 1)[1] for p in ours] == [
        f"metadata-{i:05d}" for i in range(5)]
    comma = ",".join(ours[::-1]) + ","
    assert seqfile.expand_seqfile_paths(comma) == ours[::-1]
    for spec in (str(d), comma):
        theirs, ours_py, ours_nat = seqfile_routes(spec)
        assert_same(theirs, ours_py)
        assert_same(theirs, ours_nat)
    with pytest.raises(ValueError, match="no input files"):
        seqfile.expand_seqfile_paths(",")


BAD_DOCS = [
    '{"content": {"links": [{"href": "x"}]}}',      # no type
    '{"content": {"links": [{"type": "a"}]}}',      # no href
    '{"content": {"links": ["notdict"]}}',
    '{"content": {"links": [[1]]}}',
    "{broken",
    '{"a": 01}',
    "",
]


@pytest.mark.parametrize("doc", BAD_DOCS)
def test_strict_errors_and_lenient_skips_match_jax(tmp_path, doc):
    p = str(tmp_path / "seg")
    seqfile.write_sequence_file(p, [("http://ok/", meta(["http://t/"])),
                                    ("http://bad/", doc)])

    def outcome(load, **kw):
        try:
            load(p, strict=True, **kw)
        except Exception as e:  # noqa: BLE001 - class and message parity
            return type(e), str(e)
        raise AssertionError("strict load accepted a bad record")

    jax_py = outcome(jax_seqfile.load_crawl_seqfile, native="off")
    jax_nat = outcome(jax_seqfile.load_crawl_seqfile, native="auto")
    assert outcome(seqfile.load_crawl_seqfile, native="off") == jax_py
    assert outcome(seqfile.load_crawl_seqfile, native="auto") == jax_nat
    assert jax_py[0] == jax_nat[0]
    theirs, ours_py, ours_nat = seqfile_routes(p, strict=False)
    assert_same(theirs, ours_py)
    assert_same(theirs, ours_nat)


def test_container_errors_match_jax(tmp_path):
    p = str(tmp_path / "seg")
    seqfile.write_sequence_file(p, [("http://a/", meta(["http://b/"]))] * 5)
    whole = open(p, "rb").read()
    cases = {"trunc": (whole[:-7], EOFError),
             "garb": (b"SEQ\x07" + whole[4:], ValueError),
             "magic": (b"SEQ", ValueError)}
    rec = str(tmp_path / "rec")
    seqfile.write_sequence_file(rec, [("http://a/", meta(["http://b/"]))],
                                compression="record")
    data = bytearray(open(rec, "rb").read())
    data[-3] ^= 0xFF
    cases["badz"] = (bytes(data), zlib.error)
    for name, (blob, exc) in cases.items():
        path = str(tmp_path / name)
        open(path, "wb").write(blob)
        for native in ("off", "auto"):
            with pytest.raises(exc) as ours:
                seqfile.load_crawl_seqfile(path, native=native)
            with pytest.raises(exc) as theirs:
                jax_seqfile.load_crawl_seqfile(path, native=native)
            assert str(ours.value) == str(theirs.value), (name, native)


def test_pool_of_two_workers_keeps_the_serial_order(tmp_path):
    d = tmp_path / "segment"
    d.mkdir()
    for i in range(9):
        seqfile.write_sequence_file(str(d / f"metadata-{i:05d}"),
                                    random_records(40 + i, 12),
                                    compression="block")
    serial, r1 = seqfile.load_crawl_seqfile_routed(str(d), workers=1)
    pooled, r2 = seqfile.load_crawl_seqfile_routed(str(d), workers=2)
    assert r1 == r2 == "python"
    assert_same(serial, pooled)
    assert_same(jax_seqfile.load_crawl_seqfile(str(d), workers=1), pooled)
    paths = seqfile.expand_seqfile_paths(str(d))
    assert (list(seqfile.iter_segment_records(paths, workers=2))
            == list(seqfile.iter_segment_records(paths, workers=1)))


def test_pool_propagates_strict_errors(tmp_path):
    d = tmp_path / "segment"
    d.mkdir()
    for i in range(4):
        seqfile.write_sequence_file(str(d / f"metadata-{i:05d}"),
                                    [("http://ok/", meta(["http://t/"]))])
    seqfile.write_sequence_file(str(d / "metadata-00004"),
                                [("http://bad/", "{not json")])
    with pytest.raises(json.JSONDecodeError):
        seqfile.load_crawl_seqfile(str(d), strict=True, workers=2)
    g, _ = seqfile.load_crawl_seqfile(str(d), strict=False, workers=2)
    assert g.n == 3


def test_crawl_segment_is_read_by_the_jax_reader(tmp_path):
    seg = str(tmp_path / "seg")
    made = crawl_segment(seg, files=3, per_file=400, seed=5)
    assert made["files"] == 3 and made["records"] == 1200
    theirs, ours_py, ours_nat = seqfile_routes(seg)
    assert_same(theirs, ours_py)
    assert_same(theirs, ours_nat)
    g, idmap = ours_nat
    assert int((~g.dangling_mask).sum()) == 1200   # every page crawled
    assert g.out_degree.sum() == g.num_edges
    # linkless crawled pages exist, and carry no dangling mass
    assert int((g.out_degree == 0).sum()) > int(g.dangling_mask.sum())
    first = next(jax_seqfile.read_sequence_file(seg + "/metadata-00000"))
    assert first[0] == "http://site0.test/p0"
    assert json.loads(first[1])["url"] == first[0]
    again = str(tmp_path / "again")
    crawl_segment(again, files=3, per_file=400, seed=5)
    for i in range(3):
        name = f"/metadata-{i:05d}"
        assert open(seg + name, "rb").read() == open(again + name, "rb").read()


def test_crawl_segment_shape():
    """8% linkless pages, 3-12 links otherwise, 15% uncrawled targets,
    997 hosts: the statistics of scripts/acceptance.py _gen_segment."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        crawl_segment(d, files=2, per_file=3000, seed=1,
                      compression="none")
        recs = [json.loads(v) for i in range(2)
                for _, v in seqfile.read_sequence_file(
                    f"{d}/metadata-{i:05d}")]
    counts = np.array([len(r["content"]["links"]) for r in recs])
    assert abs((counts == 0).mean() - 0.08) < 0.02
    assert counts[counts > 0].min() == 3 and counts.max() == 12
    hrefs = [ln["href"] for r in recs for ln in r["content"]["links"]]
    unc = np.mean([h.startswith("http://uncrawled") for h in hrefs])
    assert abs(unc - 0.15) < 0.02
    hosts = {h.split("/")[2] for h in hrefs if "site" in h}
    assert len(hosts) == 997


def test_iter_read_batches_cap_checked_before_append(tmp_path):
    sizes = [40, 40, 100, 10, 10]
    paths = []
    for i, size in enumerate(sizes):
        p = tmp_path / f"f{i}"
        p.write_bytes(b"x" * size)
        paths.append(str(p))
    got = [[len(d) for d in datas]
           for _, datas in iter_read_batches(paths, window=10, byte_cap=90)]
    assert got == [[40, 40], [100], [10, 10]]
