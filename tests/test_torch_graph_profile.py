"""The port's data-plane profile (``pagerank_tpu_torch/obs/
graph_profile.py`` and the armed pass of ``ops/device_build.
build_ell_device``) held against the JAX package: the device-built
profile's integer stats bit-equal to the JAX device build's from the
same host edges (flat and striped, raw and deduplicated, and a graph
whose hub degrees tie), the host profile equal to the JAX host
profile, the zero-computation contract of a disarmed build, and the
checksummed job artifact crossing packages."""

import numpy as np
import pytest

from pagerank_tpu import build_graph as jax_build_graph
from pagerank_tpu import jobs as jax_jobs
from pagerank_tpu.obs import graph_profile as jgp
from pagerank_tpu.ops import device_build as jdb
from pagerank_tpu_torch import build_graph, jobs
from pagerank_tpu_torch.obs import graph_profile as gp
from pagerank_tpu_torch.ops import device_build as db
from pagerank_tpu_torch.utils import synth

N = 1 << 11


@pytest.fixture(autouse=True)
def _disarmed():
    gp.disarm(), gp.reset(), jgp.disarm(), jgp.reset()
    yield
    gp.disarm(), gp.reset(), jgp.disarm(), jgp.reset()


def _rmat(dedup, seed=0):
    src, dst = synth.rmat_edges(11, seed=seed)
    if dedup:
        key = np.unique(src.astype(np.int64) * N + dst)
        src, dst = (key // N).astype(np.int32), (key % N).astype(np.int32)
    return src, dst


def _tied_hubs(n=N, hubs=40, fan=12):
    """``hubs`` vertices each fed by exactly ``fan`` sources: the
    top-16 hub degrees all tie."""
    rng = np.random.default_rng(3)
    dst = np.repeat(np.arange(100, 100 + hubs), fan)
    src = rng.integers(0, n, dst.shape[0])
    tail_src = rng.integers(0, n, 3000)
    tail_dst = rng.integers(200, n, 3000)
    keep = np.bincount(tail_dst, minlength=n) < fan
    tail = keep[tail_dst] & (np.cumsum(np.ones_like(tail_dst)) < 1500)
    return (np.concatenate([src, tail_src[tail]]).astype(np.int32),
            np.concatenate([dst, tail_dst[tail]]).astype(np.int32))


INT_FIELDS = ("n", "num_edges", "raw_edges", "duplicate_edges",
              "self_loops", "dangling_count", "zero_in_count", "in_hist",
              "out_hist", "top_hub_ids", "top_hub_in_degrees",
              "partition_edges", "stripe_span", "group", "fingerprint")


def _assert_profiles_equal(mine, theirs):
    a, b = mine.summary(), theirs.summary()
    for key in INT_FIELDS:
        assert a[key] == b[key], key
    np.testing.assert_array_equal(mine.block_edges, theirs.block_edges)
    np.testing.assert_array_equal(mine.block_rows, theirs.block_rows)
    assert a["source"] == b["source"] == "device_build"


def _device_profiles(src, dst, stripe, mask=None):
    gp.arm()
    jgp.arm()
    db.build_ell_device(src, dst, N, stripe_size=stripe, with_weights=False,
                        dangling_mask=mask, device="cpu")
    jdb.build_ell_device(src, dst, N, stripe_size=stripe, with_weights=False,
                         dangling_mask=mask)
    return gp.get_profile(), jgp.get_profile()


@pytest.mark.parametrize("dedup", [False, True], ids=["raw", "dedup"])
@pytest.mark.parametrize("stripe", [0, 512])
def test_device_profile_bit_equal_to_the_jax_device_build(stripe, dedup):
    mine, theirs = _device_profiles(*_rmat(dedup), stripe)
    _assert_profiles_equal(mine, theirs)
    if stripe:
        assert len(mine.partition_edges) == N // stripe


def test_tied_hub_degrees_take_the_lowest_ids_as_lax_top_k():
    src, dst = _tied_hubs()
    mine, theirs = _device_profiles(src, dst, 0)
    assert len(set(mine.top_hub_in_degrees)) == 1  # all 16 tie
    _assert_profiles_equal(mine, theirs)


def test_crawl_mask_overrides_the_dangling_count():
    src, dst = _rmat(False, seed=4)
    mask = np.zeros(N, bool)
    out = np.bincount(src, minlength=N)
    mask[np.flatnonzero(out == 0)[:7]] = True
    mine, theirs = _device_profiles(src, dst, 0, mask=mask)
    assert mine.dangling_count == 7
    _assert_profiles_equal(mine, theirs)


def test_host_profile_equals_the_jax_host_profile():
    src, dst = _rmat(False, seed=2)
    for span in (0, 512):
        mine = gp.profile_graph(build_graph(src, dst, n=N),
                                partition_span=span, raw_edges=len(src))
        theirs = jgp.profile_graph(jax_build_graph(src, dst, n=N),
                                   partition_span=span, raw_edges=len(src))
        assert mine.summary() == theirs.summary()
        np.testing.assert_array_equal(mine.block_rows, theirs.block_rows)


def test_disarmed_build_makes_zero_profile_computations(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("profile computed on a disarmed build")

    monkeypatch.setattr(gp, "device_stats", boom)
    monkeypatch.setattr(gp, "finish_device_profile", boom)
    monkeypatch.setattr(gp, "publish", boom)
    dg = db.build_ell_device(*_rmat(False), N, with_weights=False,
                             device="cpu")
    assert dg.num_edges > 0 and gp.get_profile() is None


def test_profile_artifact_crosses_packages(tmp_path):
    src, dst = _rmat(True)
    prof = gp.profile_graph(build_graph(src, dst, n=N))
    jobs.JobSupervisor(str(tmp_path / "a")).save_profile(prof)
    back = jax_jobs.JobSupervisor(str(tmp_path / "a")).load_profile(
        prof.fingerprint)
    assert back is not None and back.summary() == prof.summary()
    jprof = jgp.profile_graph(jax_build_graph(src, dst, n=N))
    jax_jobs.JobSupervisor(str(tmp_path / "b")).save_profile(jprof)
    mine = jobs.JobSupervisor(str(tmp_path / "b")).load_profile(
        jprof.fingerprint)
    assert mine is not None and mine.summary() == jprof.summary()
    with pytest.warns(RuntimeWarning, match="different graph"):
        assert jobs.JobSupervisor(str(tmp_path / "b")).load_profile(
            "other") is None
