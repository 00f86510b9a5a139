"""The port's out-of-core build (``ingest/external.py``) and its crawl
drain (``ingest/native.crawl_load_external``): field-identical to
``build_graph`` (and to the JAX package's external build) at small
caps, for array chunks, text, ``.npz`` and crawl segments (the cases
of ``tests/test_external_build.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from pagerank_tpu.graph import build_graph as jax_build_graph
from pagerank_tpu.ingest import external as jax_external

from pagerank_tpu_torch import PageRankConfig, TorchEngine
from pagerank_tpu_torch.graph import build_graph
from pagerank_tpu_torch.ingest import external, native
from pagerank_tpu_torch.ingest.edgelist import save_binary_edges
from pagerank_tpu_torch.ingest.seqfile import (expand_seqfile_paths,
                                               write_sequence_file)

FIELDS = ("src", "dst", "out_degree", "in_degree", "dangling_mask",
          "zero_in_mask", "edge_weight")


def assert_fields_equal(a, b):
    assert a.n == b.n
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def random_edges(n, e, seed, dup_frac=0.3):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    k = int(e * dup_frac)
    src[:k], dst[:k] = src[e - k:], dst[e - k:]
    return src, dst


def test_many_spill_runs_match_build_graph_and_jax(monkeypatch):
    n, e = 500, 20000
    src, dst = random_edges(n, e, 1)
    monkeypatch.setattr(external, "_SPILL_BYTES_PER_EDGE", 40 * 300)
    monkeypatch.setattr(jax_external, "_SPILL_BYTES_PER_EDGE", 40 * 300)
    g = external.build_graph_external([(src, dst)], n=n,
                                      mem_cap_bytes=64 << 20)
    assert g.sort_route == "external"
    assert_fields_equal(g, build_graph(src, dst, n=n))
    assert_fields_equal(g, jax_external.build_graph_external(
        [(src, dst)], n=n, mem_cap_bytes=64 << 20))
    assert g.fingerprint() == jax_build_graph(src, dst, n=n).fingerprint()


@pytest.mark.parametrize("k", [1, 3, 7])
def test_any_chunking_matches(k):
    n, e = 300, 5000
    src, dst = random_edges(n, e, 2)
    chunks = [(src[c], dst[c]) for c in np.array_split(np.arange(e), k)]
    assert_fields_equal(external.build_graph_external(chunks, n=n),
                        build_graph(src, dst, n=n))


def test_n_inference_and_bounds():
    src, dst = np.array([0, 5, 5, 3]), np.array([1, 2, 2, 9])
    g = external.build_graph_external([(src, dst)])
    assert g.n == 10 and g.num_edges == 3
    with pytest.raises(ValueError, match="out of range"):
        external.build_graph_external([(src, dst)], n=5)
    with pytest.raises(ValueError, match="empty graph"):
        external.build_graph_external([])
    with pytest.raises(ValueError, match="64 MiB"):
        external.build_graph_external([(src, dst)], mem_cap_bytes=1 << 20)


def test_text_streaming(tmp_path, monkeypatch):
    n, e = 200, 3000
    src, dst = random_edges(n, e, 3)
    p = str(tmp_path / "edges.txt")
    with open(p, "w") as f:
        f.write("# comment line\n")
        f.writelines(f"{s} {d}\n" for s, d in zip(src, dst))
    monkeypatch.setattr(external, "_SPILL_BYTES_PER_EDGE", 40 * 500)
    g = external.build_graph_external(p, n=n, mem_cap_bytes=64 << 20)
    assert_fields_equal(g, build_graph(src, dst, n=n))


@pytest.mark.parametrize("compressed", [False, True])
def test_npz_input_streams_in_chunks(tmp_path, compressed):
    n, e = 300, 10_000
    src, dst = random_edges(n, e, 6)
    p = str(tmp_path / "edges.npz")
    (np.savez_compressed if compressed else np.savez)(
        p, src=src, dst=dst, n=np.int64(n))
    it, n_hint = external.iter_npz_chunks(p, chunk_edges=1024)
    parts = list(it)
    assert n_hint == n and len(parts) == 10
    np.testing.assert_array_equal(np.concatenate([a for a, _ in parts]), src)
    np.testing.assert_array_equal(np.concatenate([b for _, b in parts]), dst)
    q = str(tmp_path / "saved.npz")
    save_binary_edges(q, src, dst, n=n)
    g = external.build_graph_external(q)
    assert_fields_equal(g, build_graph(src, dst, n=n))
    assert_fields_equal(g, jax_external.build_graph_external(q))


def test_npz_rejects_mismatched_members(tmp_path):
    p = str(tmp_path / "bad.npz")
    np.savez(p, src=np.arange(5), dst=np.arange(4))
    with pytest.raises(ValueError, match="length mismatch"):
        external.iter_npz_chunks(p, chunk_edges=16)


def test_dangling_mask_override():
    src, dst = np.array([0, 1]), np.array([1, 2])
    mask = np.array([False, False, True, True])
    g = external.build_graph_external([(src, dst)], n=4, dangling_mask=mask)
    assert_fields_equal(g, build_graph(src, dst, n=4, dangling_mask=mask))
    with pytest.raises(ValueError, match="out-edges"):
        external.build_graph_external(
            [(src, dst)], n=4,
            dangling_mask=np.array([True, False, False, False]))


def test_external_graph_feeds_the_solver_identically():
    n, e = 400, 6000
    src, dst = random_edges(n, e, 5)
    cfg = PageRankConfig(num_iters=8)
    a = TorchEngine(cfg, device="cpu").build(build_graph(src, dst, n=n)).run()
    b = TorchEngine(cfg, device="cpu").build(
        external.build_graph_external([(src, dst)], n=n)).run()
    np.testing.assert_array_equal(a, b)


def mini_segment(seg, files=5, per_file=40, seed=7):
    """A tiny crawl segment with linkless pages and uncrawled targets."""
    rng = np.random.default_rng(seed)
    n_crawled = files * per_file
    for fi in range(files):
        pairs = []
        for ri in range(per_file):
            u = f"http://site{(fi * per_file + ri) % 97}.test/p{fi * per_file + ri}"
            links = []
            if rng.random() >= 0.1:
                for t in rng.integers(0, n_crawled, rng.integers(1, 6)):
                    links.append(f"http://uncrawled{int(t)}.test/"
                                 if rng.random() < 0.2 else
                                 f"http://site{int(t) % 97}.test/p{int(t)}")
            pairs.append((u, json.dumps({"content": {"links": [
                {"type": "a", "href": h} for h in links]}})))
        write_sequence_file(str(seg / f"metadata-{fi:05d}"), pairs,
                            sync_every=7)


def test_crawl_drain_matches_the_in_memory_build(tmp_path, monkeypatch):
    seg = tmp_path / "seg"
    seg.mkdir()
    mini_segment(seg)
    paths = expand_seqfile_paths(str(seg))
    g_ref, ids_ref = native.crawl_load(paths, "seqfile")
    # Many ingest batches (one file each) and many spill runs.
    monkeypatch.setattr(external, "_MIN_CHUNK_EDGES", 64)
    monkeypatch.setattr(external, "_SPILL_BYTES_PER_EDGE", 1 << 20)
    orig = native.iter_read_batches
    monkeypatch.setattr(native, "iter_read_batches",
                        lambda p, window, cap: orig(p, 1, 1))
    saves = []
    orig_save = external.np.save
    monkeypatch.setattr(external.np, "save",
                        lambda p, a: (saves.append(p), orig_save(p, a))[1])
    with pytest.raises(ValueError, match="128 MiB"):
        native.crawl_load_external(paths, "seqfile", mem_cap_bytes=64 << 20)
    g, ids = native.crawl_load_external(paths, "seqfile",
                                        mem_cap_bytes=128 << 20)
    assert len(saves) > 1
    assert_fields_equal(g, g_ref)
    assert ids.names == ids_ref.names and g.vertex_names == g_ref.vertex_names
    from pagerank_tpu.ingest.seqfile import load_crawl_seqfile

    theirs, their_ids = load_crawl_seqfile(str(seg), native="off",
                                           workers=1)
    assert_fields_equal(g, theirs)
    assert ids.names == their_ids.names


def test_crawl_drain_error_cleans_its_spill_dir(tmp_path):
    seg = tmp_path / "seg"
    seg.mkdir()
    write_sequence_file(str(seg / "metadata-00000"), [("http://a/", json.dumps(
        {"content": {"links": [{"type": "a", "href": "http://b/"}]}}))])
    write_sequence_file(str(seg / "metadata-00001"),
                        [("http://c/", "{not json")])
    paths = expand_seqfile_paths(str(seg))
    spill = tmp_path / "spill"
    spill.mkdir()
    with pytest.raises(json.JSONDecodeError):
        native.crawl_load_external(paths, "seqfile", mem_cap_bytes=128 << 20,
                                   tmp_dir=str(spill))
    assert os.listdir(spill) == []


def test_crawl_drain_through_the_cli_matches(tmp_path):
    from pagerank_tpu_torch import cli

    seg = tmp_path / "seg"
    seg.mkdir()
    mini_segment(seg, files=3, per_file=20)
    outs = []
    for extra in (["--host-mem-cap-gb", "0.125"], []):
        out = str(tmp_path / f"r{len(outs)}.tsv")
        s = cli.run(["--input", str(seg), "--iters", "5", "--log-every", "0",
                     "--device", "cpu", "--out", out, *extra])
        assert s["ingest_route"] == "native"
        outs.append((open(out).read(), s["sort_route"]))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == "external"
    assert torch.get_default_dtype() == torch.float32
