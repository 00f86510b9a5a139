"""The port's device plane on one card (``pagerank_tpu_torch/obs/
devices.py``, ``parallel/mesh.device_stats``): the CPU's "no memory
stats" record and the watchdog's device line as the JAX package gives
them, the sampler's gauges, watermark and counter tracks over a card's
values, the report section without a sampler, and the analytic fit
check's verdicts and limit resolution."""

import json

import pytest

from pagerank_tpu.parallel import mesh as jax_mesh
from pagerank_tpu_torch import obs
from pagerank_tpu_torch.obs import devices as obs_devices
from pagerank_tpu_torch.obs import live
from pagerank_tpu_torch.parallel import mesh


@pytest.fixture(autouse=True)
def _clean():
    obs.disable_tracing()
    obs.get_registry().reset()
    obs.disarm_sampler()
    yield
    obs.disable_tracing()
    obs.get_registry().reset()
    obs.disarm_sampler()


def test_cpu_stats_have_the_jax_no_memory_shape():
    (mine,) = mesh.device_stats(["cpu"])
    theirs = jax_mesh.device_stats()[0]
    assert mine.to_json() == theirs.to_json()
    assert json.dumps(mine.to_json())
    assert mesh.device_view(["cpu"]) == [jax_mesh._render_device_line(theirs)]


def test_device_line_renders_as_the_jax_line():
    for kw in ({}, {"bytes_in_use": 1234567890},
               {"bytes_in_use": 8 << 30, "bytes_limit": 80 << 30},
               {"bytes_limit": 16 << 30}):
        mine = mesh.DeviceStats(id=0, platform="gpu", kind="NVIDIA H100",
                                process_index=0, **kw)
        theirs = jax_mesh.DeviceStats(id=0, platform="gpu",
                                      kind="NVIDIA H100", process_index=0,
                                      **kw)
        assert (mesh._render_device_line(mine)
                == jax_mesh._render_device_line(theirs))


def _fake_card(samples):
    it = iter(samples)

    def stats(devs=None):
        use, peak = next(it)
        return [mesh.DeviceStats(id=0, platform="gpu", kind="NVIDIA H100",
                                 process_index=0, bytes_in_use=use,
                                 bytes_limit=80 << 30,
                                 peak_bytes_in_use=peak)]
    return stats


def test_sampler_gauges_watermark_and_tracks(monkeypatch):
    monkeypatch.setattr(mesh, "device_stats", _fake_card(
        [(100, 150), (300, 320), (200, 320), (50, 320)]))
    tr = obs.enable_tracing()
    s = obs.arm_sampler(obs_devices.DeviceSampler(every=2))
    for i in range(4):
        s.on_step(i)  # samples at 0 and 2
    sec = obs_devices.report_section()  # one final sample
    assert sec["samples"] == 4
    assert sec["hbm_high_water_bytes"] == 320
    assert sec["per_device_peak_bytes"] == {"0": 320}
    gauges = obs.get_registry().snapshot()["gauges"]
    assert gauges["device.0.bytes_in_use"] == 50
    assert gauges["device.0.peak_bytes"] == 320
    assert gauges["device.0.bytes_limit"] == 80 << 30
    counters = [e for e in tr.chrome_events() if e.get("ph") == "C"]
    assert len(counters) == 4
    assert counters[0]["pid"] == obs_devices.TRACK_PID_BASE
    text = live.render_prometheus()
    assert "pagerank_device_0_peak_bytes 320" in text


def test_report_section_without_an_armed_sampler():
    sec = obs_devices.report_section()
    assert sec["samples"] == 1 and sec["hbm_high_water_bytes"] is None
    assert obs.build_run_report()["devices"]["samples"] == 1


def test_fit_check_verdicts_at_a_small_and_an_impossible_scale():
    h100 = 80 * 10**9
    small = obs_devices.fit_check(14, limit_bytes=h100)
    assert small.fits and small.peak_stage.stage == "build/sort"
    assert [s.stage for s in small.stages] == [
        "build/gen", "build/relabel", "build/sort", "build/slots",
        "build/scatter", "solve/step"]
    # the sort's 49 B an edge + 13 B a vertex
    assert small.peak_stage.bytes == 49 * (16 << 14) + 13 * (1 << 14)
    big = obs_devices.fit_check(26, limit_bytes=h100)
    assert big.fits
    over = obs_devices.fit_check(27, limit_bytes=h100)
    assert not over.fits
    assert any(s.source == "error" for s in over.stages)
    refused = obs_devices.fit_check(26, limit_bytes=40 * 10**9)
    assert not refused.fits
    assert "OVER" in obs_devices.render_fit(refused)
    assert "DOES NOT FIT" in obs_devices.render_fit(refused)
    # a host-built graph: the solve alone; a file input: the upload
    host = obs_devices.fit_check(n=1 << 20, num_edges=16 << 20,
                                 device_build=False, limit_bytes=h100)
    assert [s.stage for s in host.stages] == ["solve/step"] and host.fits
    up = obs_devices.fit_check(n=1 << 12, num_edges=1 << 16,
                               limit_bytes=h100)
    assert up.stages[0].stage == "build/upload"
    part = obs_devices.fit_check(22, partition_span=1 << 21,
                                 stream_dtype="bfloat16", limit_bytes=h100)
    assert part.fits and "planes" in part.stages[-1].detail


def test_fit_limit_resolution_order():
    assert obs_devices.resolve_hbm_limit(123) == (123, "explicit")
    lim, src = obs_devices.resolve_hbm_limit(device_kind="NVIDIA H200")
    assert lim == 141 * 10**9 and "H200" in src
    lim, src = obs_devices.resolve_hbm_limit()  # the CPU: the table
    assert lim == 80 * 10**9 and src.startswith("default")
    with pytest.raises(ValueError):
        obs_devices.fit_check()
    res = obs_devices.fit_check(10)
    assert json.dumps(res.to_json())
