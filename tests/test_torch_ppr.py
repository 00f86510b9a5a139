"""Personalized PageRank in the port on the CPU: ``PprTorchEngine``
against the JAX package's ``PprJaxEngine`` and ``ppr_cpu`` at the gates
of tests/test_ppr.py, ``ell_contrib_spmm``'s plain version against the
JAX op on the same pack, and the CLI's ``--ppr-*`` path against the JAX
CLI (tests/test_cli.py:146, 233-330)."""

import json

import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu.cli import main as jax_main
from pagerank_tpu.engines import ppr as jax_ppr
from pagerank_tpu.ops import ell as jax_ell
from pagerank_tpu.ops import spmv as jax_spmv

import pagerank_tpu_torch
from pagerank_tpu_torch import cli
from pagerank_tpu_torch.engines.ppr import (PprTorchEngine, ppr_cpu,
                                            ppr_cpu_topk)
from pagerank_tpu_torch.models import ppr as ppr_model
from pagerank_tpu_torch.ops import ell as torch_ell
from pagerank_tpu_torch.ops import ell_spmv
from pagerank_tpu_torch.utils import synth


def graphs(seed=0, n=150, e=1200):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def cfg(iters=20, dtype="float64", accum="float64"):
    return pagerank_tpu_torch.PageRankConfig(
        num_iters=iters, dtype=dtype, accum_dtype=accum)


def jax_engine(gj, iters=20, dtype="float64", accum="float64", **kw):
    return jax_ppr.PprJaxEngine(pagerank_tpu.PageRankConfig(
        num_iters=iters, dtype=dtype, accum_dtype=accum, num_devices=1),
        **kw).build(gj)


def port_engine(gt, iters=20, dtype="float64", accum="float64", **kw):
    return PprTorchEngine(cfg(iters, dtype, accum), device="cpu",
                          **kw).build(gt)


def full(res, j, n):
    out = np.zeros(n)
    out[res.topk_ids[j]] = res.topk_scores[j]
    return out


# -- the engine against PprJaxEngine and the f64 oracle ----------------------

@pytest.mark.parametrize("dtype,accum,tol", [
    ("float64", "float64", 1e-12),   # tests/test_ppr.py:32-43
    ("float32", "float64", 3e-7),    # tests/test_ppr.py:69-82
])
@pytest.mark.parametrize("dangling", ["source", "uniform"])
def test_engine_matches_jax_engine_and_oracle(dtype, accum, tol, dangling):
    gj, gt = graphs(seed=4)
    srcs = np.array([1, 7, 42, 99])
    expected = jax_ppr.ppr_cpu(gj, srcs, num_iters=25, dangling_to=dangling)
    res = port_engine(gt, 25, dtype, accum, dangling_to=dangling).run(
        srcs, topk=gt.n, chunk=3)  # chunk < len: two chunks
    jres = jax_engine(gj, 25, dtype, accum, dangling_to=dangling).run(
        srcs, topk=gj.n, chunk=3)
    assert res.topk_scores.dtype == np.dtype(dtype)
    for j in range(len(srcs)):
        np.testing.assert_allclose(full(res, j, gt.n), expected[:, j],
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(full(res, j, gt.n), full(jres, j, gj.n),
                                   rtol=0, atol=tol)


def test_ppr_cpu_is_bit_equal_to_the_jax_oracle():
    gj, gt = graphs(seed=12, n=400, e=4000)
    srcs = np.array([5, 250, 5])
    for mode in ("source", "uniform"):
        np.testing.assert_array_equal(
            ppr_cpu(gt, srcs, num_iters=20, dangling_to=mode),
            jax_ppr.ppr_cpu(gj, srcs, num_iters=20, dangling_to=mode))
    a = ppr_cpu_topk(gt, cfg(), srcs, topk=10)
    b = jax_ppr.ppr_cpu_topk(gj, pagerank_tpu.PageRankConfig(num_iters=20),
                             srcs, topk=10)
    np.testing.assert_array_equal(a.topk_ids, b.topk_ids)
    np.testing.assert_array_equal(a.topk_scores, b.topk_scores)


def test_columns_are_distributions_and_localize():
    _, gt = graphs(seed=2)
    srcs = np.array([3, 5, 17])
    res = port_engine(gt, 50).run(srcs, topk=gt.n)
    for j, s in enumerate(srcs):
        f = full(res, j, gt.n)
        np.testing.assert_allclose(f.sum(), 1.0, atol=1e-9)
        assert np.all(f >= 0) and f[s] >= 0.15 - 1e-9


def test_topk_ordering_f32():
    gj, gt = graphs(seed=6)
    res = port_engine(gt, 20, "float32", "float32").run(np.array([10]),
                                                        topk=10)
    assert np.all(np.diff(res.topk_scores[0]) <= 1e-12)
    jres = jax_engine(gj, 20, "float32", "float32").run(np.array([10]),
                                                        topk=10)
    np.testing.assert_allclose(res.topk_scores, jres.topk_scores, rtol=1e-5)


def test_topk_k_clamped_to_n():
    gj, gt = graphs(seed=20, n=60, e=500)
    srcs = np.array([3])
    expected = jax_ppr.ppr_cpu(gj, srcs, num_iters=20)
    res = port_engine(gt).run(srcs, topk=10 * gt.n)
    assert res.topk_ids.shape == (1, gt.n)
    assert sorted(res.topk_ids[0].tolist()) == list(range(gt.n))
    np.testing.assert_allclose(full(res, 0, gt.n), expected[:, 0], rtol=0,
                               atol=1e-12)
    jres = jax_engine(gj).run(srcs, topk=10 * gj.n)
    np.testing.assert_array_equal(res.topk_ids, jres.topk_ids)


def test_topk_tied_scores_keep_the_lower_relabeled_id_first():
    """tests/test_ppr.py::test_ppr_topk_tied_scores: vertices 1 and 3 of
    a bidirectional 4-cycle tie exactly; both come back with bit-equal
    scores, in the order lax.top_k gives (the JAX engine's ids)."""
    fwd_src, fwd_dst = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0])
    src = np.concatenate([fwd_src, fwd_dst])
    dst = np.concatenate([fwd_dst, fwd_src])
    gj = pagerank_tpu.build_graph(src, dst, n=4)
    gt = pagerank_tpu_torch.build_graph(src, dst, n=4)
    expected = jax_ppr.ppr_cpu(gj, np.array([0]), num_iters=30)[:, 0]
    res = port_engine(gt, 30).run(np.array([0]), topk=4)
    ids, scores = res.topk_ids[0], res.topk_scores[0]
    assert np.all(np.diff(scores) <= 0)
    np.testing.assert_allclose(scores, expected[ids], rtol=0, atol=1e-12)
    assert expected[1] == expected[3]
    by_id = dict(zip(ids.tolist(), scores.tolist()))
    assert by_id[1] == by_id[3]
    jres = jax_engine(gj, 30).run(np.array([0]), topk=4)
    np.testing.assert_array_equal(ids, jres.topk_ids[0])


def test_dangling_heavy_graph_both_modes():
    rng = np.random.default_rng(21)
    n = 120
    src = rng.integers(0, 10, 400)  # only vertices 0..9 have out-edges
    dst = rng.integers(0, n, 400)
    gj = pagerank_tpu.build_graph(src, dst, n=n)
    gt = pagerank_tpu_torch.build_graph(src, dst, n=n)
    assert (gt.out_degree == 0).sum() >= n - 10
    srcs = np.array([4, 57])
    for mode in ("source", "uniform"):
        expected = jax_ppr.ppr_cpu(gj, srcs, num_iters=25, dangling_to=mode)
        res = port_engine(gt, 25, dangling_to=mode).run(srcs, topk=n)
        for j in range(len(srcs)):
            np.testing.assert_allclose(full(res, j, n), expected[:, j],
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batch_with_repeated_source_equals_the_source_alone(dtype):
    """A source in a batch gives what it gives alone, bit for bit (the
    serving batcher pads with repeats)."""
    gj, gt = graphs(seed=22)
    eng = port_engine(gt, 20, dtype, dtype)
    res = eng.run(np.array([9, 9, 40]), topk=20)
    np.testing.assert_array_equal(res.topk_ids[0], res.topk_ids[1])
    np.testing.assert_array_equal(res.topk_scores[0], res.topk_scores[1])
    solo = port_engine(gt, 20, dtype, dtype).run(np.array([9]), topk=20)
    np.testing.assert_array_equal(res.topk_ids[0], solo.topk_ids[0])
    np.testing.assert_array_equal(res.topk_scores[0], solo.topk_scores[0])
    if dtype == "float64":
        expected = jax_ppr.ppr_cpu(gj, np.array([9]), num_iters=20)[:, 0]
        np.testing.assert_allclose(res.topk_scores[0],
                                   expected[res.topk_ids[0]], rtol=0,
                                   atol=1e-12)


def test_many_chunks_and_a_larger_graph_match_the_oracle():
    """tests/test_ppr.py::test_ppr_multi_stripe's graph (the JAX engine
    forces stripes there; the port has none) through chunks of 2."""
    gj, gt = graphs(seed=13, n=500, e=5000)
    srcs = np.array([7, 123, 480, 0, 499])
    expected = jax_ppr.ppr_cpu(gj, srcs, num_iters=15)
    eng = port_engine(gt, 15)
    res = eng.run(srcs, topk=gt.n, chunk=2)
    assert len(eng.chunk_seconds) == 3
    assert eng.layout_info()["width"] == 2
    for j in range(len(srcs)):
        np.testing.assert_allclose(full(res, j, gt.n), expected[:, j],
                                   rtol=0, atol=1e-12)


def test_concurrent_runs_take_turns_and_agree():
    """Runs from many threads (a server's abandoned dispatch and the
    next) take turns on the engine's buffers: each equals a run alone.
    More threads than cores, and a short switch interval."""
    import sys
    import threading

    _, gt = graphs(seed=8)
    eng = port_engine(gt, 15)
    batches = [np.array([1, 2, 3]), np.array([4, 5]), np.array([6])]
    wants = [port_engine(gt, 15).run(b, topk=10) for b in batches]
    got, errors = {}, []

    def go(i):
        try:
            for _ in range(3):
                got[i] = eng.run(batches[i % 3], topk=10)
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=go, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts) and not errors
    for i in range(16):
        np.testing.assert_array_equal(got[i].topk_ids, wants[i % 3].topk_ids)
        np.testing.assert_array_equal(got[i].topk_scores,
                                      wants[i % 3].topk_scores)


def test_engine_contract():
    _, gt = graphs()
    eng = PprTorchEngine(cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        eng.run(np.array([0]))
    with pytest.raises(ValueError, match="dangling_to"):
        PprTorchEngine(cfg(), dangling_to="nowhere", device="cpu")
    eng.build(gt)
    info = eng.layout_info()
    assert info["form"] == "ppr_flat_ell"
    assert info["kernel"] == "ell_contrib:reference"
    assert info["n_state"] == 256 and info["z_dtype"] == "float64"
    assert PprTorchEngine(cfg(dtype="float32", accum="float64"),
                          device="cpu").build(gt).layout_info()[
        "z_dtype"] == "float64"
    with pytest.raises(ValueError, match="chunk"):
        eng.run(np.array([0]), chunk=0)


def test_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PprTorchEngine(cfg())


# -- ell_contrib_spmm: the batched contribution, column by column -------------

@pytest.mark.parametrize("dtype,acc,tol", [
    (torch.float64, torch.float64, 1e-12),
    (torch.float32, torch.float64, 1e-7),
    (torch.float32, torch.float32, 1e-5),
])
def test_spmm_plain_version_matches_the_jax_op_on_the_same_pack(dtype, acc,
                                                                tol):
    import jax.numpy as jnp

    src, dst = synth.rmat_edges(10, seed=2)
    gj = pagerank_tpu.build_graph(src, dst, n=1 << 10)
    gt = pagerank_tpu_torch.build_graph(src, dst, n=1 << 10)
    pj, pt = jax_ell.ell_pack(gj), torch_ell.ell_pack(gt)
    np.testing.assert_array_equal(pj.src, pt.src)
    k, n_pad = 5, pt.n_padded
    z = np.zeros((k, n_pad + 8))
    z[:, : pt.n] = np.random.default_rng(0).random((k, pt.n))
    z_cols = torch.from_numpy(z).to(dtype)
    slots = torch_ell.sentinel_slots(pt)
    plan = torch_ell.segment_plan(pt.row_block, pt.num_blocks)
    got = ell_spmv.ell_contrib_spmm(
        z_cols, torch.from_numpy(slots), torch.from_numpy(pt.row_block),
        pt.num_blocks, accum_dtype=acc, plan=plan)
    assert got.shape == (k, pt.num_blocks * 128) and got.dtype == dtype
    # The JAX op: the batch is the row, sentinel row n_pad is zero.
    want = np.asarray(jax_spmv.ell_contrib_spmm(
        jnp.asarray(z_cols.numpy()[:, : n_pad + 1].T), jnp.asarray(slots),
        jnp.asarray(pj.row_block), pj.num_blocks,
        accum_dtype=jnp.float64 if acc == torch.float64 else jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy().T, want, rtol=0, atol=tol * scale)
    # Each row is K1's plain plan-order version of that column alone.
    for j in range(k):
        assert torch.equal(got[j], ell_spmv.ell_contrib_plan_reference(
            z_cols[j], torch.from_numpy(slots), accum_dtype=acc, plan=plan))


def test_spmm_refuses_what_k1_refuses():
    _, gt = graphs()
    pt = torch_ell.ell_pack(gt)
    plan = torch_ell.segment_plan(pt.row_block, pt.num_blocks)
    slots = torch.from_numpy(torch_ell.sentinel_slots(pt))
    rb = torch.from_numpy(pt.row_block)
    z = torch.zeros((2, pt.n_padded + 8))
    with pytest.raises(ValueError, match="contiguous rows"):
        ell_spmv.ell_contrib_spmm(z.T, slots, rb, pt.num_blocks,
                                  accum_dtype=torch.float32, plan=plan)
    with pytest.raises(TypeError, match="narrower"):
        ell_spmv.ell_contrib_spmm(z.double(), slots, rb, pt.num_blocks,
                                  accum_dtype=torch.float32, plan=plan)
    with pytest.raises(ValueError, match="on cuda"):
        ell_spmv.bind_columns(z, slots, pt.num_blocks,
                              accum_dtype=torch.float32, plan=plan)
    empty = ell_spmv.ell_contrib_spmm(z[:0], slots, rb, pt.num_blocks,
                                      accum_dtype=torch.float32, plan=plan)
    assert empty.shape == (0, pt.num_blocks * 128)


def test_model_matches_the_jax_model():
    from pagerank_tpu.models import ppr as jax_model

    rng = np.random.default_rng(0)
    c, p, m = rng.random((6, 3)), rng.random((6, 3)), rng.random(3)
    for mode in ("source", "uniform"):
        np.testing.assert_array_equal(
            ppr_model.apply_ppr_update(
                torch.from_numpy(c), torch.from_numpy(p), torch.from_numpy(m),
                6, 0.85, mode, torch).numpy(),
            jax_model.apply_ppr_update(c, p, m, 6, 0.85, mode, np))
    with pytest.raises(ValueError, match="dangling_to"):
        ppr_model.apply_ppr_update(c, p, m, 6, 0.85, "x", np)


# -- the CLI against the JAX CLI ---------------------------------------------

@pytest.fixture
def edges_file(tmp_path):
    """tests/test_cli.py's fixture: 200 edges over 40 vertices, seed 0."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    p = tmp_path / "edges.txt"
    p.write_text("\n".join(["# test graph"] + [
        f"{a} {b}" for a, b in zip(src, dst)]) + "\n")
    return str(p)


def _rows(text):
    return [ln.split("\t") for ln in text.splitlines() if ln.count("\t") == 2]


def _same_rankings(a, b, tol=1e-12):
    """Two PPR TSVs agree: the same sources and scores within ``tol``
    row by row, the same ids where a score is not tied (within ``tol``)
    with a neighbour, and the same id set over each tied run that ends
    inside the top-k."""
    ra, rb = _rows(a), _rows(b)
    assert len(ra) == len(rb) and ra
    assert [r[0] for r in ra] == [r[0] for r in rb]
    sa = np.array([float(r[2]) for r in ra])
    np.testing.assert_allclose(sa, [float(r[2]) for r in rb], rtol=0,
                               atol=tol)
    i = 0
    while i < len(ra):
        j = i + 1
        while (j < len(ra) and ra[j][0] == ra[i][0]
               and abs(sa[j] - sa[j - 1]) <= tol):
            j += 1
        run_a = {r[1] for r in ra[i:j]}
        run_b = {r[1] for r in rb[i:j]}
        last_of_source = j == len(ra) or ra[j][0] != ra[i][0]
        if j - i == 1 or not last_of_source:
            assert run_a == run_b, (i, ra[i:j], rb[i:j])
        i = j


def _both(tmp_path, argv, name, port_extra=("--device", "cpu")):
    ours, theirs = tmp_path / f"{name}.port", tmp_path / f"{name}.jax"
    assert jax_main(argv + ["--num-devices", "1", "--log-every", "0",
                            "--out", str(theirs)]) == 0
    s = cli.run(argv + list(port_extra) + ["--out", str(ours)])
    return ours.read_text(), theirs.read_text(), s


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cli_ppr_matches_the_jax_cli(tmp_path, edges_file, capsys, dtype):
    argv = ["--input", edges_file, "--iters", "10", "--ppr-sources", "0,3",
            "--ppr-topk", "5", "--dtype", dtype]
    ours, theirs, s = _both(tmp_path, argv, f"ppr-{dtype}")
    assert len(_rows(ours)) == 2 * 5
    _same_rankings(ours, theirs, 1e-12 if dtype == "float64" else 1e-6)
    assert s["ppr"].topk_ids.shape == (2, 5)
    assert s["engine"].layout_info()["kernel"] == "ell_contrib:reference"
    err = capsys.readouterr().err
    assert "ppr: 2 sources x 10 iters, top-5 in" in err
    assert "edge·vectors/s" in err and "wrote 2x5 ppr rows to" in err


def test_cli_ppr_random_sources_match_the_jax_cli(tmp_path, edges_file):
    argv = ["--input", edges_file, "--iters", "5", "--ppr-sources",
            "random:4", "--ppr-topk", "3", "--dtype", "float64"]
    ours, theirs, s = _both(tmp_path, argv, "random")
    assert len(_rows(ours)) == 4 * 3
    _same_rankings(ours, theirs)
    assert len(set(s["sources"].tolist())) == 4


def test_cli_ppr_to_stdout_and_uniform_dangling(edges_file, capsys):
    argv = ["--input", edges_file, "--iters", "6", "--ppr-sources", "1",
            "--ppr-topk", "4", "--ppr-dangling", "uniform", "--dtype",
            "float64"]
    assert jax_main(argv + ["--num-devices", "1", "--log-every", "0"]) == 0
    theirs = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    _same_rankings(ours, theirs)


def test_cli_ppr_engine_cpu_matches_the_jax_cli(tmp_path, edges_file,
                                               capsys, monkeypatch):
    """``--engine cpu`` runs the f64 oracle, with no card: its rows
    equal the JAX CLI's --engine cpu rows, and the torch engine's."""
    argv = ["--input", edges_file, "--iters", "8", "--ppr-sources", "0,3",
            "--ppr-topk", "4", "--dtype", "float64", "--engine", "cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ours, theirs, s = _both(tmp_path, argv, "cpu", port_extra=())
    assert ours == theirs and s["engine"] is None
    assert "runs the float64 numpy oracle" in capsys.readouterr().err
    monkeypatch.undo()
    torch_rows = cli.run(argv[:-2] + ["--device", "cpu", "--out",
                                      str(tmp_path / "t.tsv")])
    _same_rankings((tmp_path / "t.tsv").read_text(), ours, 1e-9)
    assert torch_rows["engine"] is not None


def test_cli_ppr_url_sources_resolve_through_the_id_map(tmp_path, capsys):
    p = tmp_path / "crawl.tsv"
    meta = {s: json.dumps({"content": {"links": [{"href": t, "type": "a"}
                                                 for t in ts]}})
            for s, ts in (("http://a", ["http://b", "http://c"]),
                          ("http://b", ["http://a"]),
                          ("http://c", ["http://a", "http://d"]))}
    p.write_text("".join(f"{s}\t{m}\n" for s, m in meta.items()))
    argv = ["--input", str(p), "--iters", "5", "--ppr-sources",
            "http://a,http://c", "--ppr-topk", "2", "--dtype", "float64"]
    ours, theirs, s = _both(tmp_path, argv, "urls")
    rows = _rows(ours)
    assert len(rows) == 2 * 2 and rows[0][0] == "http://a"
    assert rows[2][0] == "http://c"
    _same_rankings(ours, theirs)
    src_file = tmp_path / "sources.txt"
    src_file.write_text("http://c\n\nhttp://a\n")
    s2 = cli.run(["--input", str(p), "--iters", "5", "--ppr-sources",
                  str(src_file), "--device", "cpu", "--ppr-topk", "2"])
    assert s2["sources"].tolist() == [s["ids"].get("http://c"),
                                      s["ids"].get("http://a")]


def test_cli_ppr_topk_clamped_message(edges_file, capsys):
    assert cli.main(["--input", edges_file, "--iters", "3", "--ppr-sources",
                     "0", "--ppr-topk", "100000", "--device", "cpu"]) == 0
    assert "top-40" in capsys.readouterr().err


def _jax_refusal(argv, capsys):
    """The JAX CLI's refusal text for ``argv``: its SystemExit message,
    or what it wrote to stderr before returning 2."""
    try:
        rc = jax_main(argv + ["--num-devices", "1", "--log-every", "0"])
    except SystemExit as e:
        return str(e.code)
    assert rc == 2
    return capsys.readouterr().err.strip()


@pytest.mark.parametrize("extra", [
    ["--semantics", "textbook"],
    ["--tol", "0.001"],
    ["--snapshot-dir", "SNAPS"],
    ["--jsonl", "m.jsonl"],
    ["--snapshot-dir", "SNAPS", "--semantics", "textbook", "--tol", "0.1"],
    ["--ppr-chunk", "0"],
    ["--ppr-sources", "999999"],
    ["--ppr-sources", "random:abc"],
    ["--ppr-sources", "random:-3"],
    ["--ppr-sources", "random:0"],
    ["--ppr-sources", "http://nowhere"],
    ["--device-build"],
])
def test_cli_ppr_refusals_carry_the_jax_messages(tmp_path, edges_file,
                                                 capsys, extra):
    extra = [str(tmp_path / a) if a in ("SNAPS", "m.jsonl") else a
             for a in extra]
    argv = ["--input", edges_file, "--ppr-sources", "0", *extra]
    theirs = _jax_refusal(argv, capsys)
    with pytest.raises(SystemExit) as ours:
        cli.main(argv + ["--device", "cpu"])
    assert str(ours.value.code) == theirs
    assert theirs  # a message, not a bare code


@pytest.mark.parametrize("extra,flag", [
    (["--partition-span", "256"], "--partition-span"),
    (["--stream-dtype", "bfloat16"], "--stream-dtype"),
])
def test_cli_ppr_refuses_the_global_layout_flags(edges_file, extra, flag):
    with pytest.raises(SystemExit, match=f"ppr mode does not support: {flag}"):
        cli.main(["--input", edges_file, "--ppr-sources", "0", "--device",
                  "cpu", *extra])
