"""A rank's side of the sharded-engine checks: the cases a spawned
process group runs (``parallel/distributed.spawn_group`` with target
``pagerank_tpu_torch.testing.sharded:run_cases``), each rank writing
what it holds to ``.npz`` files for the caller to compare.

The ranks import torch and the port only; the caller holds their
results against the JAX engine (or anything else) in its own process.

``payload``: ``{"edges": path of an .npz with src, dst, n; "out": a
directory; "device": the engines' device; "cases": [case, ...]}``, a
case ``{"name": str, "config": PageRankConfig fields, "iters": int}``
plus, optionally, ``"edges"`` (another graph's .npz for this case),
``"save_dir"`` (rank 0 snapshots the state after 4 steps there),
``"resume_dir"`` (every rank resumes from the newest snapshot there
before running on), ``"retain"`` (after 4 steps, ``retain_state``, 3
steps, ``restore_state`` and the same 3 steps again),
``"attribute"`` (``obs/devices.attribute_exchange`` after the run) and
``"fused"`` (each run to 1, 4 and ``iters`` steps made by
``run_fused``, ``run_fused_chunked(every=2)`` or ``run_fused_tol`` at
the config's tol, else 1e-30: "run_fused", "chunked" or "tol") and
``"after"`` (two more stepwise iterations after ``ranks``),
``"probe"`` (``{"every": e, "topk": k}``: every run through
``ConvergenceProbes`` of that cadence, one object across the runs),
``"device_build"`` (the engine built by ``build_device`` from a graph
that ``ops/device_build.build_ell_device`` made on ``device`` from the
case graph's deduplicated edges: the host pack's planes, bit for bit;
the stripe span is the config's partition span) and ``"planes"``.
Per case and rank it writes ``<name>.r<rank>.npz`` with ``ranks`` (the
whole vector, original order, after ``iters``), ``first`` (after one
step from r0), ``at4`` (after 4), ``resumed`` (the iteration resumed
from), ``local`` (the rank's own state length), ``steps`` (the steps
taken up to ``ranks``), ``bytes`` (``comms.bytes_exchanged`` then) and
``bpi`` (the comms model's bytes a step, 0 without one),
``roundtrip`` (``set_ranks`` of a seeded vector, read back), ``after``
when the case asks,
``stepped`` (one step from that vector), ``layout`` (``layout_info``
as JSON) and, when the case asks, ``retain_a``/``retain_b`` (the 3
steps before and after the restore), ``attribution`` (JSON) with
``attributed`` (the ranks read after it), ``sdc`` (the SDC section
as JSON) when the case checks, ``probes`` (each probe's record with
its top-k original ids, as JSON) when it probes, and ``planes_src`` /
``planes_rows`` (the rank's slot words and row groups as the engine
holds them) when it asks for ``planes``.
"""

from __future__ import annotations

import json
import os

import numpy as np


def run_cases(payload) -> int:
    import torch

    from pagerank_tpu_torch import sdc as sdc_mod
    from pagerank_tpu_torch.engines.torch_engine import TorchEngine
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.obs import devices as obs_devices
    from pagerank_tpu_torch.obs import metrics as obs_metrics
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.utils.config import PageRankConfig
    from pagerank_tpu_torch.utils.snapshot import Snapshotter, resume_engine

    # Several ranks share the host's cores: one thread each.
    torch.set_num_threads(1)
    rank, world = distributed.process_info()
    graphs = {}

    def load(path):
        if path not in graphs:
            with np.load(path) as f:
                graphs[path] = build_graph(f["src"], f["dst"], n=int(f["n"]))
        return graphs[path]

    for case in payload["cases"]:
        graph = load(case.get("edges", payload["edges"]))
        cfg = PageRankConfig(**case["config"], num_devices=world)
        sdc_mod.reset()
        obs_metrics.get_registry().reset()
        eng = TorchEngine(cfg, device=payload["device"])
        if case.get("device_build"):
            eng.build_device(_device_graph(graph, cfg, payload["device"]))
        else:
            eng.build(graph)
        steps = [0]

        def tick(i, info):
            steps[0] += 1

        fused = case.get("fused")
        probes = (recorded_probes(case["probe"]["every"],
                                  case["probe"]["topk"])
                  if case.get("probe") else None)

        def advance(k):
            if not fused:
                return eng.run(k, on_iteration=tick, probes=probes)
            before = eng.iteration
            if fused == "run_fused":
                r = eng.run_fused(k)
            elif fused == "chunked":
                r = eng.run_fused_chunked(k, every=2)
            else:
                r = eng.run_fused_tol(
                    tol=1e-30 if cfg.tol is None else cfg.tol, num_iters=k)
            steps[0] += eng.iteration - before
            return r

        first = advance(1)
        at4 = advance(4)
        extra = {}
        if case.get("retain"):
            token = eng.retain_state()
            extra["retain_a"] = eng.run(7, on_iteration=tick)
            eng.restore_state(token)
            extra["retain_b"] = eng.run(7, on_iteration=tick)
        resumed = 0
        if case.get("save_dir") and rank == 0:
            Snapshotter(case["save_dir"], graph.fingerprint(), cfg.semantics,
                        mesh_meta=eng.snapshot_meta()).save(4, at4)
        if case.get("resume_dir"):
            resumed = resume_engine(eng, Snapshotter(
                case["resume_dir"], graph.fingerprint(), cfg.semantics))
        ranks = advance(case["iters"])
        counters = obs_metrics.get_registry().snapshot()["counters"]
        if case.get("after"):
            extra["after"] = eng.run(eng.iteration + 2)
        model = eng.comms_model() or {}
        if case.get("attribute"):
            extra["attribution"] = np.array(json.dumps(
                obs_devices.attribute_exchange(eng, iters=2, warmup=1)))
            extra["attributed"] = eng.ranks()
        seeded = np.random.default_rng(7).random(graph.n).astype(
            ranks.dtype)
        eng.set_ranks(seeded, iteration=0)
        roundtrip = eng.ranks()
        eng.step()
        out = {"ranks": ranks, "first": first, "at4": at4,
               "resumed": np.int64(resumed),
               "local": np.int64(eng._r.shape[0]),
               "steps": np.int64(steps[0]),
               "bytes": np.int64(counters.get("comms.bytes_exchanged", 0)),
               "bpi": np.int64(model.get("bytes_per_iter") or 0),
               "roundtrip": roundtrip, "stepped": eng.ranks(), **extra,
               "layout": np.array(json.dumps(eng.layout_info(),
                                             default=str))}
        if cfg.sdc_check_every:
            out["sdc"] = np.array(json.dumps(sdc_mod.report_section(),
                                             default=str))
        if probes is not None:
            out["probes"] = np.array(json.dumps(probes.records))
        if case.get("planes"):
            out["planes_src"] = eng._arrays["src"].cpu().numpy()
            rows = eng._arrays.get("row_block", eng._arrays.get("row_pair"))
            out["planes_rows"] = rows.cpu().numpy()
        np.savez(os.path.join(payload["out"], f"{case['name']}.r{rank}.npz"),
                 **out)
    return 0


def _device_graph(graph, cfg, device):
    """The case graph built on ``device`` by the device build from its
    deduplicated edges, as the engine's build wants it (no weight
    plane, the partition span as the stripe span)."""
    import torch

    from pagerank_tpu_torch.ops import device_build as db

    return db.build_ell_device(
        torch.from_numpy(graph.src), torch.from_numpy(graph.dst), graph.n,
        stripe_size=int(cfg.partition_span or 0), with_weights=False,
        device=device)


def recorded_probes(every, topk, on_probe=None):
    """``obs.ConvergenceProbes`` that also keeps each probe's record
    with its top-k original ids (``records``); ``on_probe(iteration)``,
    when given, runs after each probe."""
    from pagerank_tpu_torch.obs.probes import ConvergenceProbes

    class Recorded(ConvergenceProbes):
        def __init__(self):
            super().__init__(every, topk=topk)
            self.records = []

        def commit(self, iteration, info, ids_engine, ids_original):
            rec = super().commit(iteration, info, ids_engine, ids_original)
            self.records.append(dict(
                {k: v for k, v in rec.items() if k != "mass_ledger"},
                ids=[int(i) for i in ids_original]))
            if on_probe is not None:
                on_probe(iteration)
            return rec

    return Recorded()


def drain_in_ingest(payload) -> int:
    """The CLI's rank of a spawned mesh (``payload["argv"]``), with
    SIGTERM sent to rank ``payload["rank"]`` alone while it loads its
    input: a drain asked during ingest, which every rank must agree on
    at the next stage boundary."""
    import signal

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.parallel import distributed

    rank, _ = distributed.process_info()
    load = cli.load_graph

    def load_with_signal(args, cfg):
        if rank == payload["rank"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return load(args, cfg)

    cli.load_graph = load_with_signal
    return cli._rank_main(payload["argv"])


def fail_on_rank_1(payload) -> int:
    """Rank 1 raises before the collective rank 0 waits in: the case the
    group's timeout must end (a hung collective never outlives it)."""
    from pagerank_tpu_torch.parallel import distributed

    rank, _ = distributed.process_info()
    if rank == 1:
        raise RuntimeError("rank 1 fails before the collective")
    import torch.distributed as dist

    dist.barrier()
    return 0


def drain_one_rank(payload) -> int:
    """The CLI's rank of a spawned mesh (``payload["argv"]``), with
    SIGTERM sent to rank ``payload["rank"]`` alone from inside its
    ``payload["at"]``-th step: a drain that one rank is asked for and
    every rank must stop for after the same step."""
    import signal

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.engines.torch_engine import TorchEngine
    from pagerank_tpu_torch.parallel import distributed

    rank, _ = distributed.process_info()
    step, calls = TorchEngine.step, [0]

    def step_then_signal(self):
        info = step(self)
        calls[0] += 1
        if rank == payload["rank"] and calls[0] == payload["at"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return info

    TorchEngine.step = step_then_signal
    return cli._rank_main(payload["argv"])
