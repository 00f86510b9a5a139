"""A rank's side of the elastic-solve checks: the cases one spawned,
rescue-armed process group runs (``parallel/distributed.spawn_group``
with ``rescue=True`` and target
``pagerank_tpu_torch.testing.elastic:run_cases``), each process writing
what it ends with to ``.npz`` files for the caller to compare.

Every case runs in a group generation of its own: before case k every
process (the survivors of case k-1 and the members that left it) re-forms
the whole group at generation ``10 * (k + 1)`` (``distributed.reform``),
so that each case starts at the full world and its rescues take the
generations after it. Every process installs the fault shim with the
same seeded schedule (``testing/faults.DeviceFaultSchedule``), so each
sees the same kill, delay, poison and flip at the same iteration, and
drives an :class:`~pagerank_tpu_torch.parallel.elastic.ElasticRunner`
whose classification is the group's roll call.

``payload``: ``{"edges": path of an .npz with src, dst, n; "out": a
directory; "device": the engines' device; "cases": [case, ...]}``, a
case ``{"name": str, "config": PageRankConfig fields, "iters": int,
"schedule": DeviceFaultSchedule keywords, "max_rescues": int}`` plus,
optionally, ``"snapshots"`` (the new rank 0 saves every iteration; the
runner warm-starts from them), ``"virtual_monitor"`` (a
DeviceHealthMonitor on a virtual clock that the shim's delays advance)
and ``"liveness_timeout_s"``. Per case and process it writes
``<name>.m<member>.npz`` with ``status`` (``ok``, ``left`` or
``exhausted``), ``ranks`` (``ok`` only), ``rescues``, ``restarts``,
``lost``, ``quarantined``, ``members`` (the final mesh's),
``log`` (the schedule's, as JSON), ``walls`` (the rescues' walls, as
JSON), ``slow_steps``, ``snap_meta`` (the newest snapshot's mesh
metadata, as JSON, read by the final rank 0) and, on the halo forms,
``plan`` (the final engine's halo plan: summary and tables, as JSON).
"""

from __future__ import annotations

import json
import os

import numpy as np


def _plan_record(plan) -> dict:
    return {"summary": plan.summary(), "ndev": int(plan.ndev),
            "n_vs": int(plan.n_vs),
            "send_idx": [a.tolist() for a in plan.send_idx],
            "recv_ids": [a.tolist() for a in plan.recv_ids],
            "wsend_start": [a.tolist() for a in plan.wsend_start],
            "wrecv_start": [a.tolist() for a in plan.wrecv_start]}


def run_cases(payload) -> int:
    import torch

    from pagerank_tpu_torch import sdc as sdc_mod
    from pagerank_tpu_torch.engines.torch_engine import TorchEngine
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.obs import metrics as obs_metrics
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel.elastic import (
        DeviceHealthMonitor, ElasticExhaustedError, ElasticRunner,
        RankLeftError, snapshot_meta_after)
    from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                                   install_device_faults)
    from pagerank_tpu_torch.utils.config import PageRankConfig
    from pagerank_tpu_torch.utils.snapshot import Snapshotter

    torch.set_num_threads(1)  # several ranks share the host's cores
    world = distributed.process_info()[1]
    me = distributed.member()
    with np.load(payload["edges"]) as f:
        graph = build_graph(f["src"], f["dst"], n=int(f["n"]))

    for k, case in enumerate(payload["cases"]):
        distributed.reform(10 * (k + 1), range(world))
        sdc_mod.reset()
        obs_metrics.get_registry().reset()
        cfg = PageRankConfig(num_iters=case["iters"], **case["config"])
        sched = DeviceFaultSchedule(**case.get("schedule", {}))
        clock = {"now": 0.0}
        monitor, shim_kw = None, {}
        if case.get("virtual_monitor"):
            monitor = DeviceHealthMonitor(straggler_factor=3.0,
                                          warmup_steps=1,
                                          clock=lambda: clock["now"])
            shim_kw = dict(monitor=monitor, sleep=lambda s: clock.update(
                now=clock["now"] + s))

        def build(members):
            return TorchEngine(cfg.replace(num_devices=len(members)),
                               device=payload["device"]).build(graph)

        snap = None
        if case.get("snapshots"):
            snap = Snapshotter(os.path.join(payload["out"], case["name"]),
                               graph.fingerprint(), cfg.semantics)
        eng = build(range(world))
        install_device_faults(eng, sched, **shim_kw)
        box = {}

        def rebound(e2):
            install_device_faults(e2, sched, **shim_kw)
            if snap is not None:
                snap.mesh_meta = snapshot_meta_after(e2, box["runner"])

        runner = ElasticRunner(
            eng, build, snapshotter=snap,
            max_rescues=case.get("max_rescues", 2), monitor=monitor,
            on_rebuild=rebound,
            liveness_timeout_s=case.get("liveness_timeout_s", 20.0))
        box["runner"] = runner
        if snap is not None:
            snap.mesh_meta = snapshot_meta_after(eng, runner)

        def on_iteration(i, info):
            if snap is None:
                return
            e = runner.engine
            r = e.ranks()  # every rank: a collective on the sharded forms
            if e.mesh.rank == 0:
                snap.save(i + 1, r)

        out = {"status": "ok", "lost": [], "ranks": np.zeros(0)}
        try:
            out["ranks"] = runner.run(on_iteration=on_iteration)
        except RankLeftError:
            out["status"] = "left"
        except ElasticExhaustedError as e:
            out["status"] = "exhausted"
            out["lost"] = list(e.lost_device_ids)
        final = runner.engine
        if out["status"] == "ok":
            out["lost"] = list(runner.lost_device_ids)
            if snap is not None and final.mesh.rank == 0:
                newest = snap.iterations()[-1]
                out["snap_meta"] = np.array(json.dumps(
                    snap.load(newest)[1].get("mesh")))
                out["snap_iterations"] = np.array(snap.iterations())
            if final._halo_plan is not None:
                out["plan"] = np.array(json.dumps(_plan_record(
                    final._halo_plan)))
        np.savez(
            os.path.join(payload["out"], f"{case['name']}.m{me}.npz"),
            **out, rescues=np.int64(runner.rescues),
            restarts=np.int64(runner.restarts),
            quarantined=np.array(runner.quarantined_device_ids,
                                 dtype=np.int64),
            members=np.array(final.device_ids(), dtype=np.int64),
            log=np.array(json.dumps(sched.log)),
            walls=np.array(json.dumps(runner.rescue_walls)),
            slow_steps=np.int64(monitor.slow_steps if monitor else 0))
    return 0
