"""The port's device build (``pagerank_tpu_torch/ops/device_build.py``,
``TorchEngine.build_device``, ``--device-build``) on the CPU against the
JAX package's (``pagerank_tpu/ops/device_build.py``) on the same host
edges, and against the port's own host pack and host-built solve."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagerank_tpu import PageRankConfig as JaxConfig
from pagerank_tpu.cli import main as jax_main
from pagerank_tpu.ops import device_build as jdb
from pagerank_tpu.utils.snapshot import Snapshotter as JaxSnapshotter

from pagerank_tpu_torch import (PageRankConfig, ReferenceCpuEngine,
                                TorchEngine, build_graph, cli)
from pagerank_tpu_torch.ingest import write_sequence_file
from pagerank_tpu_torch.ingest.edgelist import save_binary_edges
from pagerank_tpu_torch.ops import device_build as db
from pagerank_tpu_torch.ops import ell as ell_lib
from pagerank_tpu_torch.utils import synth
from pagerank_tpu_torch.utils.metrics import oracle_l1

N = 1 << 12


def _edges(dedup, scale=12, seed=0):
    """R-MAT edges of ``scale`` (duplicates in), or their unique set."""
    src, dst = synth.rmat_edges(scale, seed=seed)
    if dedup:
        n = 1 << scale
        key = np.unique(src.astype(np.int64) * n + dst)
        src, dst = (key // n).astype(np.int32), (key % n).astype(np.int32)
    return src, dst


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _planes_equal(mine, theirs):
    """Every plane and count of a port build equal to a JAX build's."""
    for f in ("src", "weight", "row_block"):
        a, b = db._as_list(getattr(mine, f)), db._as_list(getattr(theirs, f))
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            assert (x is None) == (y is None), f
            if x is not None:
                assert _np(x).dtype == np.asarray(y).dtype, f
                _eq(x, y)
    for f in ("perm", "dangling_mask", "zero_in_mask", "out_degree"):
        _eq(getattr(mine, f), getattr(theirs, f))
    for f in ("n", "n_padded", "num_blocks", "num_edges", "num_rows",
              "group", "stripe_size", "presentinel"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.fingerprint() == theirs.fingerprint()


@pytest.mark.parametrize("stripe", [0, 1024])
@pytest.mark.parametrize("dedup", [False, True], ids=["raw", "dedup"])
def test_each_stage_bit_equal_to_jax(dedup, stripe):
    src, dst = _edges(dedup)
    n_padded = N
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    in_t = db._raw_in_degree(td, n=N)
    in_j = jdb._raw_in_degree(jd, n=N)
    _eq(in_t, in_j)
    (perm_t, inv_t), (perm_j, inv_j) = (db._relabel_perm(in_t),
                                        jdb._relabel_perm(in_j))
    _eq(perm_t, perm_j)
    _eq(inv_t, inv_j)
    sorted_t = db._relabel_sort([ts, td], inv_t, n_padded=n_padded,
                                stripe_size=stripe)
    sorted_j = jdb._relabel_sort(js, jd, inv_j, n_padded=n_padded,
                                 stripe_size=stripe)
    for a, b in zip(sorted_t, sorted_j):
        assert _np(a).dtype == np.int32
        _eq(a, b)
    n_stripes = N // (stripe or N)
    for weights in (True, False):
        kw = dict(n=N, n_padded=n_padded, group=1, stripe_size=stripe,
                  with_weights=weights)
        out_t = db._slot_coords(*sorted_t, weight_dtype=torch.float32, **kw)
        out_j = jdb._slot_coords(*sorted_j, weight_dtype=jnp.float32, **kw)
        for name, a, b in zip(("word", "w", "row_idx", "pos", "sb_rows",
                               "row_offset", "out_degree_rel", "num_edges"),
                              out_t, out_j):
            assert (a is None) == (b is None), name
            if a is not None:
                _eq(a, b)
        word, w, row_idx, pos, sb_rows, row_offset, out_rel, _ = out_t
        _eq(db._unrelabel_degree(out_rel, perm_t),
            jdb._unrelabel_degree(out_j[6], perm_j))
        rows = int(row_offset[-1])
        fill = 0 if weights else (stripe or n_padded)
        scat = dict(rows_total=rows, num_blocks=N // 128,
                    n_stripes=n_stripes, fill=fill)
        got = db._scatter_slots(word, row_idx, pos, sb_rows, w, **scat)
        want = jdb._scatter_slots(out_j[0], out_j[2], out_j[3], out_j[4],
                                  out_j[1], **scat)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                _eq(a, b)


@pytest.mark.parametrize("dedup", [False, True], ids=["raw", "dedup"])
@pytest.mark.parametrize("weights", [True, False], ids=["w", "presentinel"])
@pytest.mark.parametrize("stripe", [0, 1024, 2048])
def test_build_bit_equal_to_jax(stripe, weights, dedup):
    src, dst = _edges(dedup)
    mine = db.build_ell_device(src, dst, N, stripe_size=stripe,
                               with_weights=weights, device="cpu")
    theirs = jdb.build_ell_device(src, dst, N, stripe_size=stripe,
                                  with_weights=weights)
    _planes_equal(mine, theirs)
    if stripe and not dedup:
        # the per-stripe lists are views of one buffer, back to back
        whole = db.joined(mine.src)
        assert whole.data_ptr() == mine.src[0].data_ptr()
        _eq(whole, np.concatenate([np.asarray(s) for s in theirs.src]))


def test_raw_edges_pack_more_rows_than_the_host_pack():
    """The relabel goes by raw in-degree and duplicates keep a slot each:
    at rmat:12 the raw build packs 2,787 rows where the host pack of the
    deduplicated graph has 1,247 (and the dedup build has the same)."""
    raw = db.build_ell_device(*_edges(False), N, with_weights=False,
                              device="cpu")
    uniq = db.build_ell_device(*_edges(True), N, with_weights=False,
                               device="cpu")
    pack = ell_lib.ell_pack(build_graph(*_edges(False), n=N))
    assert (raw.num_rows, uniq.num_rows, pack.num_rows) == (2787, 1247, 1247)
    assert raw.num_edges == uniq.num_edges == pack.num_real_edges


@pytest.mark.parametrize("stripe", [0, 1024])
def test_dangling_mask_build_bit_equal_to_jax(stripe):
    """A crawl-style mask (uncrawled targets only; some sinks crawled)
    changes the fingerprint the same way in both packages, and a mask
    that marks a vertex with out-edges is refused."""
    rng = np.random.default_rng(5)
    n, e = 1000, 6000
    src = rng.integers(0, n // 2, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    crawled = np.zeros(n, bool)
    crawled[: n // 2 + 30] = True
    mine = db.build_ell_device(src, dst, n, stripe_size=stripe,
                               with_weights=False, dangling_mask=~crawled,
                               device="cpu")
    theirs = jdb.build_ell_device(src, dst, n, stripe_size=stripe,
                                  with_weights=False, dangling_mask=~crawled)
    _planes_equal(mine, theirs)
    plain = db.build_ell_device(src, dst, n, stripe_size=stripe,
                                with_weights=False, device="cpu")
    assert plain.fingerprint() != mine.fingerprint()
    bad = ~crawled
    bad[int(src[0])] = True
    with pytest.raises(ValueError, match="has out-edges"):
        db.build_ell_device(src, dst, n, dangling_mask=bad, device="cpu")


@pytest.mark.parametrize("stripe", [0, 1024, 2048])
def test_dedup_build_equals_the_host_pack(stripe):
    """On deduplicated edges the device build IS the port's host pack:
    the sentinel-ized slots, row blocks and perm, flat and striped."""
    src, dst = _edges(True)
    g = build_graph(src, dst, n=N)
    dg = db.build_ell_device(src, dst, N, stripe_size=stripe,
                             with_weights=False, device="cpu")
    _eq(dg.perm, ell_lib.ell_pack(g).perm)
    if not stripe:
        pack = ell_lib.ell_pack(g)
        _eq(dg.src, ell_lib.sentinel_slots(pack))
        _eq(dg.row_block, pack.row_block)
        return
    pack = ell_lib.ell_pack_striped(g, stripe_size=stripe)
    assert len(dg.src) == pack.n_stripes
    for p in range(pack.n_stripes):
        _eq(dg.src[p], np.where(pack.weight[p] != 0, pack.src[p], stripe))
        _eq(dg.row_block[p], pack.row_block[p])


ENGINE_CASES = {
    "flat-f32": dict(),
    "flat-f32-f64": dict(accum_dtype="float64"),
    "flat-f64": dict(dtype="float64", accum_dtype="float64"),
    "K2": dict(partition_span=2048),
    "K4": dict(partition_span=1024),
    "K4-bf16": dict(partition_span=1024, stream_dtype="bfloat16"),
    "textbook": dict(semantics="textbook"),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_build_device_ranks_bit_equal_to_build(case):
    src, dst = _edges(True)
    cfg = PageRankConfig(num_iters=6, **ENGINE_CASES[case])
    host = TorchEngine(cfg, device="cpu").build(build_graph(src, dst, n=N))
    dg = db.build_ell_device(src, dst, N, stripe_size=cfg.partition_span,
                             with_weights=False, device="cpu")
    fp = dg.fingerprint()
    dev = TorchEngine(cfg, device="cpu").build_device(dg)
    np.testing.assert_array_equal(dev.run(), host.run())
    a, b = host.layout_info(), dev.layout_info()
    assert (a["build"], b["build"]) == ("host", "device")
    assert a["num_rows"] == b["num_rows"] and a["form"] == b["form"]
    assert b["fingerprint"] == fp and dg.fingerprint() == fp
    # The graph is left whole; the flat engine runs its plane, uncopied.
    assert db.restore_device_graph(*db.checkpoint_arrays(dg),
                                   device="cpu").fingerprint() == fp
    if not cfg.partition_span:
        assert dev._arrays["src"].data_ptr() == dg.src.data_ptr()
    for k in a:
        if k not in ("build", "build_seconds"):
            assert a[k] == b[k], k
    for k, t in host._arrays.items():
        assert torch.equal(t, dev._arrays[k]), k


@pytest.mark.parametrize("case, tol", [("flat-f64", 1e-12), ("flat-f32", 1e-5),
                                       ("K4", 1e-5)])
def test_build_device_on_raw_edges_within_the_oracle_gate(case, tol):
    src, dst = _edges(False)
    cfg = PageRankConfig(num_iters=10, **ENGINE_CASES[case])
    dg = db.build_ell_device(src, dst, N, stripe_size=cfg.partition_span,
                             with_weights=False, device="cpu")
    ranks = TorchEngine(cfg, device="cpu").build_device(dg).run()
    oracle = ReferenceCpuEngine(PageRankConfig(num_iters=10)).build(
        build_graph(src, dst, n=N)).run()
    if tol < 1e-6:
        np.testing.assert_allclose(ranks, oracle, rtol=0, atol=tol)
    else:
        assert oracle_l1(ranks, oracle)[2] <= tol


def test_build_device_with_a_weight_plane_equals_presentinel():
    src, dst = _edges(False)
    cfg = PageRankConfig(num_iters=5, partition_span=1024)
    a = TorchEngine(cfg, device="cpu").build_device(db.build_ell_device(
        src, dst, N, stripe_size=1024, device="cpu")).run()
    b = TorchEngine(cfg, device="cpu").build_device(db.build_ell_device(
        src, dst, N, stripe_size=1024, with_weights=False, device="cpu")).run()
    np.testing.assert_array_equal(a, b)


def test_build_device_refusals():
    src, dst = _edges(True, scale=10)
    n = 1 << 10
    with pytest.raises(ValueError, match="group must be 1"):
        db.build_ell_device(src, dst, n, group=8, device="cpu")
    striped = db.build_ell_device(src, dst, n, stripe_size=256,
                                  with_weights=False, device="cpu")
    with pytest.raises(ValueError, match="single-stripe"):
        TorchEngine(PageRankConfig(), device="cpu").build_device(striped)
    with pytest.raises(ValueError, match="stripe_size=512"):
        TorchEngine(PageRankConfig(partition_span=512),
                    device="cpu").build_device(striped)
    with pytest.raises(ValueError, match="300 partitions"):
        TorchEngine(PageRankConfig(partition_span=128), device="cpu") \
            .build_device(db.build_ell_device(src, dst, 300 * 128,
                                              stripe_size=128,
                                              device="cpu"))
    with pytest.raises(ValueError, match="stripe_size must be"):
        db.build_ell_device(src, dst, n, stripe_size=100, device="cpu")
    # A graph builds a second engine, and checkpoints, after a build.
    cfg = PageRankConfig(num_iters=3, partition_span=256)
    first = TorchEngine(cfg, device="cpu").build_device(striped).run()
    np.testing.assert_array_equal(
        TorchEngine(cfg, device="cpu").build_device(striped).run(), first)
    assert db.checkpoint_arrays(striped)[1]["fingerprint"] == \
        striped.fingerprint()
    with pytest.raises(TypeError, match="DeviceEllGraph"):
        TorchEngine(PageRankConfig(), device="cpu").build_device(
            build_graph(src, dst, n=n))


def test_edge_free_build_matches_jax():
    empty = np.zeros(0, np.int32)
    for stripe in (0, 256):
        mine = db.build_ell_device(empty, empty, 300, stripe_size=stripe,
                                   with_weights=False, device="cpu")
        _planes_equal(mine, jdb.build_ell_device(
            empty, empty, 300, stripe_size=stripe, with_weights=False))
        assert mine.num_rows == 0 and mine.num_edges == 0


@pytest.mark.parametrize("stripe", [0, 1024])
def test_jax_checkpoint_restores_in_the_port(stripe):
    src, dst = _edges(False)
    jdg = jdb.build_ell_device(src, dst, N, stripe_size=stripe,
                               with_weights=False)
    arrays, meta = jdb.checkpoint_arrays(jdg)
    dg = db.restore_device_graph(arrays, meta, device="cpu")
    assert dg.fingerprint() == meta["fingerprint"] == jdg.fingerprint()
    _planes_equal(dg, jdg)
    # and back: the port's checkpoint restores in the JAX package
    mine, their_meta = db.checkpoint_arrays(dg)
    assert their_meta == meta
    assert jdb.restore_device_graph(mine, their_meta).fingerprint() \
        == meta["fingerprint"]
    damaged = dict(arrays)
    key = "src_0"
    damaged[key] = np.array(arrays[key])
    damaged[key].reshape(-1)[7] ^= 1
    with pytest.raises(ValueError, match="fingerprint"):
        db.restore_device_graph(damaged, meta, device="cpu")


def test_restored_graph_solves_bit_equal():
    src, dst = _edges(False)
    cfg = PageRankConfig(num_iters=5)
    dg = db.build_ell_device(src, dst, N, with_weights=False, device="cpu")
    restored = db.restore_device_graph(*db.checkpoint_arrays(dg),
                                       device="cpu")
    a = TorchEngine(cfg, device="cpu").build_device(dg).run()
    b = TorchEngine(cfg, device="cpu").build_device(restored).run()
    np.testing.assert_array_equal(a, b)


def test_generators_are_seeded_int32_and_skewed(monkeypatch):
    s1, d1 = db.rmat_edges_device(10, seed=3, device="cpu")
    s2, d2 = db.rmat_edges_device(10, seed=3, device="cpu")
    s3, _ = db.rmat_edges_device(10, seed=4, device="cpu")
    assert s1.dtype == d1.dtype == torch.int32 and s1.shape == (16 << 10,)
    assert torch.equal(s1, s2) and torch.equal(d1, d2)
    assert not torch.equal(s1, s3)
    assert 0 <= int(s1.min()) and int(max(s1.max(), d1.max())) < 1 << 10
    indeg = torch.bincount(d1, minlength=1 << 10)
    assert int(indeg.max()) > 8 * float(indeg.float().mean())  # power law
    u, v = db.uniform_edges_device(500, 4000, seed=1, device="cpu")
    assert u.dtype == torch.int32 and u.shape == v.shape == (4000,)
    assert 0 <= int(u.min()) and int(max(u.max(), v.max())) < 500
    assert torch.equal(u, db.uniform_edges_device(500, 4000, seed=1,
                                                  device="cpu")[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        db.rmat_edges_device(4)  # cuda by default


def test_plan_build_resolves_the_span_over_raw_edges():
    cfg = PageRankConfig()
    # rmat:22: 67,108,864 raw edges make exactly 512 edges a cell at
    # span 2^20 (K = 4); the 65,241,817 unique ones need 2^21 (K = 2).
    assert TorchEngine.partition_span(1 << 22, 67_108_864) == 1 << 20
    assert TorchEngine.partition_span(1 << 22, 65_241_817) == 1 << 21
    assert db.plan_partition_span(cfg, 1 << 22, 67_108_864, -1) == 1 << 20
    assert db.plan_partition_span(cfg, 1 << 22, 67_108_864, 0) == 0
    assert db.plan_partition_span(cfg, 5000, 10, 1000) == 896
    f64 = PageRankConfig(dtype="float64", accum_dtype="float64")
    assert db.plan_partition_span(f64, 1 << 22, 67_108_864, -1) == 0
    jspan = jdb.plan_build(JaxConfig(kernel="pallas", num_devices=1),
                           1 << 22, num_edges=67_108_864,
                           partition_span=-1)[2]
    assert jspan == 1 << 20


# ---------------------------------------------------------------- the CLI


@pytest.fixture
def edge_file(tmp_path):
    rng = np.random.default_rng(31)
    src, dst = rng.integers(0, 400, 3000), rng.integers(0, 400, 3000)
    p = tmp_path / "e.txt"
    p.write_text("# src dst\n" + "".join(f"{s} {d}\n"
                                         for s, d in zip(src, dst)))
    npz = str(tmp_path / "e.npz")
    save_binary_edges(npz, src, dst, n=400)
    return str(p), npz


def _tsv(path):
    keys, ranks = [], []
    for line in open(path):
        k, r = line.rstrip("\n").split("\t")
        keys.append(k)
        ranks.append(float(r))
    return keys, np.array(ranks)


F64 = ["--dtype", "float64", "--accum-dtype", "float64", "--iters", "8",
       "--log-every", "0"]


@pytest.mark.parametrize("which", ["edgelist", "npz"])
def test_cli_device_build_matches_host_build_and_the_jax_cli(
        edge_file, tmp_path, which):
    path = edge_file[which == "npz"]
    outs = {k: str(tmp_path / f"{k}.tsv") for k in ("host", "dev", "jax")}
    host = cli.run(["--input", path, "--device", "cpu", "--out",
                    outs["host"]] + F64)
    dev = cli.run(["--input", path, "--device", "cpu", "--device-build",
                   "--out", outs["dev"]] + F64)
    assert jax_main(["--input", path, "--device-build", "--num-devices", "1",
                     "--out", outs["jax"]] + F64) == 0
    assert (dev["sort_route"], host["sort_route"]) == ("device", "numpy")
    assert dev["format"] == which and dev["upload_seconds"] is not None
    assert set(dev["device_build_seconds"]) == {"relabel_s", "sort_s",
                                                "slots_s", "scatter_s"}
    assert dev["num_rows"] == dev["engine"].layout_info()["num_rows"]
    assert dev["graph"].num_edges == host["graph"].num_edges
    assert host["device_build_seconds"] is host["upload_seconds"] is None
    k_h, r_h = _tsv(outs["host"])
    for k in ("dev", "jax"):
        keys, ranks = _tsv(outs[k])
        assert keys == k_h
        np.testing.assert_allclose(ranks, r_h, rtol=0, atol=1e-12)


def test_cli_device_build_partitioned_resolves_the_span_first(edge_file):
    s = cli.run(["--synthetic", "rmat:10", "--device", "cpu",
                 "--device-build", "--partition-span", "256",
                 "--log-every", "0", "--iters", "4"])
    assert (s["form"], s["partition_span"], s["partitions"]) == (
        "pallas_partitioned", 256, 4)
    assert s["graph"].stripe_size == 256
    assert s["engine"].layout_info()["build"] == "device"
    assert set(s["engine"].layout_info()["build_seconds"]) == {
        "relabel", "sort", "slots", "scatter", "plan", "place"}
    assert s["upload_seconds"] is None and s["ingest_route"] == "device"
    # the f64 planner turns the span off: the build and engine run flat
    f = cli.run(["--synthetic", "rmat:10", "--device", "cpu",
                 "--device-build", "--partition-span", "-1", "--dtype",
                 "float64", "--log-every", "0", "--iters", "2"])
    assert f["form"] == "flat_ell" and f["graph"].stripe_size == 0


@pytest.mark.parametrize("which", ["synthetic", "edgelist"])
def test_cli_device_build_frees_the_raw_edges_before_the_sort(
        edge_file, monkeypatch, which):
    """The CLI leaves the raw edges to the build alone, and the build
    drops them before its one sort (8 B an edge off the sort's peak)."""
    import weakref

    seen = {}
    relabel_sort, sort = db._relabel_sort, torch.sort

    def spy_relabel_sort(edges, *a, **k):
        refs = [weakref.ref(t) for t in edges]

        def spy_sort(*sa, **sk):
            seen["alive"] = [r() is not None for r in refs]
            return sort(*sa, **sk)

        monkeypatch.setattr(torch, "sort", spy_sort)
        try:
            return relabel_sort(edges, *a, **k)
        finally:
            monkeypatch.setattr(torch, "sort", sort)

    monkeypatch.setattr(db, "_relabel_sort", spy_relabel_sort)
    inp = (["--synthetic", "rmat:8"] if which == "synthetic"
           else ["--input", edge_file[0]])
    cli.run(inp + ["--device", "cpu", "--device-build", "--iters", "1",
                   "--log-every", "0"])
    assert seen["alive"] == [False, False]


def _crawl_records():
    import json

    def rec(url, links):
        return url, json.dumps({"url": url, "content": {"links": [
            {"type": "a", "href": h} for h in links]}})

    return [rec("http://a/", ["http://b/", "http://c/", "http://x/"]),
            rec("http://b/", ["http://a/", "http://y/", "http://a/"]),
            rec("http://c/", []),
            rec("http://d/", ["http://a/", "http://c/", "http://z/"])]


@pytest.mark.parametrize("fmt", ["crawl", "seqfile"])
def test_cli_device_build_crawl_inputs_write_urls(tmp_path, fmt):
    records = _crawl_records()
    if fmt == "crawl":
        path = tmp_path / "c.tsv"
        path.write_text("".join(f"{u}\t{j}\n" for u, j in records))
    else:
        path = tmp_path / "seg"
        path.mkdir()
        write_sequence_file(str(path / "metadata-00000"), records[:2])
        write_sequence_file(str(path / "metadata-00001"), records[2:],
                            compression="block")
    outs = {k: str(tmp_path / f"{k}.tsv") for k in ("host", "dev")}
    base = ["--input", str(path), "--device", "cpu"] + F64
    host = cli.run(base + ["--out", outs["host"]])
    dev = cli.run(base + ["--device-build", "--out", outs["dev"]])
    assert dev["format"] == fmt and dev["sort_route"] == "device"
    k_h, r_h = _tsv(outs["host"])
    k_d, r_d = _tsv(outs["dev"])
    assert k_d == k_h and "http://c/" in k_d and "http://z/" in k_d
    np.testing.assert_allclose(r_d, r_h, rtol=0, atol=1e-12)
    # dangling = the uncrawled targets: the crawled linkless http://c/
    # carries none
    g = dev["graph"]
    c = dev["ids"].names.index("http://c/")
    assert not bool(g.dangling_mask[c]) and int(g.out_degree[c]) == 0
    assert torch.equal(g.dangling_mask, torch.from_numpy(
        host["graph"].dangling_mask))


def test_cli_device_build_resume_is_bit_equal(tmp_path, capsys):
    cut, ctrl = str(tmp_path / "cut"), str(tmp_path / "ctrl")
    base = ["--synthetic", "rmat:8", "--device-build", "--device", "cpu",
            "--log-every", "0"]
    cli.run(base + ["--iters", "4", "--snapshot-dir", cut])
    capsys.readouterr()
    s = cli.run(base + ["--iters", "8", "--snapshot-dir", cut, "--resume"])
    assert "resumed from iteration 4" in capsys.readouterr().err
    c = cli.run(base + ["--iters", "8", "--snapshot-dir", ctrl])
    assert s["resumed_from"] == 4
    fp = s["graph"].fingerprint()
    assert fp.startswith("dev-") and fp == c["graph"].fingerprint()
    a = np.load(os.path.join(cut, "ranks_iter8.npz"))
    b = np.load(os.path.join(ctrl, "ranks_iter8.npz"))
    np.testing.assert_array_equal(a["ranks"], b["ranks"])
    assert a["fingerprint"].astype(str).item() == fp
    # a host-built run of the same edges does not resume from them
    with pytest.raises(ValueError, match="fingerprint"):
        cli.run(["--synthetic", "rmat:8", "--device", "cpu", "--iters", "9",
                 "--log-every", "0", "--snapshot-dir", cut, "--resume"])


def test_jax_device_build_snapshot_resumes_in_the_port(edge_file, tmp_path,
                                                       capsys):
    path = edge_file[0]
    sd, ctrl = str(tmp_path / "jax"), str(tmp_path / "ctrl")
    assert jax_main(["--input", path, "--device-build", "--lane-group", "1",
                     "--num-devices", "1", "--iters", "4", "--snapshot-dir",
                     sd] + F64[:4] + F64[6:]) == 0
    capsys.readouterr()
    s = cli.run(["--input", path, "--device-build", "--device", "cpu",
                 "--snapshot-dir", sd, "--resume"] + F64)
    assert "resumed from iteration 4" in capsys.readouterr().err
    fp = s["graph"].fingerprint()
    z = np.load(os.path.join(sd, "ranks_iter4.npz"))
    assert z["fingerprint"].astype(str).item() == fp
    theirs = JaxSnapshotter(sd, fp, "reference")
    np.testing.assert_array_equal(theirs.load(8)[0], s["ranks"])
    c = cli.run(["--input", path, "--device-build", "--device", "cpu",
                 "--snapshot-dir", ctrl] + F64)
    np.testing.assert_allclose(s["ranks"], c["ranks"], rtol=0, atol=1e-12)


def test_cli_device_build_refusals(edge_file, tmp_path):
    path = edge_file[0]
    with pytest.raises(SystemExit, match="requires --engine torch"):
        cli.main(["--input", path, "--device-build", "--engine", "cpu"])
    with pytest.raises(SystemExit, match="cannot combine with --device-build"):
        cli.main(["--input", path, "--device-build", "--device", "cpu",
                  "--host-mem-cap-gb", "1"])
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    none = str(tmp_path / "none.npz")
    save_binary_edges(none, np.zeros(0, np.int32), np.zeros(0, np.int32))
    for p in (str(empty), none):
        with pytest.raises(SystemExit, match="empty graph"):
            cli.main(["--input", p, "--device-build", "--device", "cpu"])
    with pytest.raises(SystemExit, match="32-bit accumulation"):
        cli.main(["--input", path, "--device-build", "--device", "cpu",
                  "--partition-span", "256", "--dtype", "float64",
                  "--log-every", "0"])
