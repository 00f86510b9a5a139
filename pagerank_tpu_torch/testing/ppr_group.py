"""A rank's side of the PPR-over-a-group checks: what one spawned
process group runs (``parallel/distributed.spawn_group`` with target
``pagerank_tpu_torch.testing.ppr_group:run_engine_cases`` or
``:serve_plan``), each rank writing what it ends with to ``.npz`` files
for the caller to compare. The ranks import torch and the port only.

``run_engine_cases(payload)``: ``{"out": a directory, "device": the
engines' device, "cases": [case, ...]}``, a case ``{"name": str,
"edges": path of an .npz with src, dst, n; "config": PageRankConfig
fields; "sources": [int]; "topk": int; "chunk": int; "dangling_to":
str}``. Each rank builds ``PprTorchEngine`` over the whole group (a
group of one through an explicit mesh of it, so that the mesh path runs
at world 1 too) and writes ``<name>.r<rank>.npz`` with ``ids``,
``scores``, ``calls`` (the ``torch.distributed`` calls of the run, by
name, as JSON) and ``layout`` (``layout_info`` as JSON).

``serve_plan(payload)``: ``{"edges": ..., "out": ..., "device": ...,
"config": PageRankConfig fields, "serve": ServeConfig fields,
"batches": [[source, ...], ...], "kill": ProcessKillPlan env spec or
None}``. Every rank builds one ``PprServer`` over the group (a virtual
clock on rank 0); the other ranks follow, rank 0 serves each batch in
pump mode (``max_batch`` queries, so each closes full) and drains.
Rank 0 writes ``serve.npz``: ``outcomes`` (one a query, in order),
``ids`` and ``scores`` [queries, k], ``device_ids``, ``rescues``,
``walls`` (the rescues' parts, as JSON) and ``counters`` (the
``serve.*`` counters, as JSON); a follower writes ``follower.m<member>
.npz`` with its ``status`` (``stopped``, ``left`` or ``terminal``).
"""

from __future__ import annotations

import json
import os

import numpy as np


def _graph(path):
    from pagerank_tpu_torch.graph import build_graph

    with np.load(path) as f:
        return build_graph(f["src"], f["dst"], n=int(f["n"]))


def _count_calls(dist, names):
    """Wrap ``dist``'s collectives in counters; returns the counts and
    a function that takes the wrappers off."""
    calls, originals = {}, {}

    def wrap(name):
        fn = originals[name] = getattr(dist, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        setattr(dist, name, counted)

    for name in names:
        if hasattr(dist, name):
            wrap(name)
    return calls, lambda: [setattr(dist, n, f) for n, f in originals.items()]


COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor",
               "barrier", "batch_isend_irecv", "send", "recv")


def run_engine_cases(payload) -> int:
    import torch
    import torch.distributed as dist

    from pagerank_tpu_torch.engines.ppr import PprTorchEngine
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel import mesh as mesh_lib
    from pagerank_tpu_torch.utils.config import PageRankConfig

    torch.set_num_threads(1)  # several ranks share the host's cores
    rank, world = distributed.process_info()
    graphs = {}
    for case in payload["cases"]:
        if case["edges"] not in graphs:
            graphs[case["edges"]] = _graph(case["edges"])
        cfg = PageRankConfig(**case["config"], num_devices=world)
        mesh = (mesh_lib.make_mesh(device=payload["device"]) if world == 1
                else None)
        eng = PprTorchEngine(cfg, dangling_to=case["dangling_to"],
                             device=payload["device"], mesh=mesh).build(
            graphs[case["edges"]])
        calls, unwrap = _count_calls(dist, COLLECTIVES)
        try:
            res = eng.run(np.asarray(case["sources"]), topk=case["topk"],
                          chunk=case["chunk"])
        finally:
            unwrap()
        np.savez(os.path.join(payload["out"], f"{case['name']}.r{rank}.npz"),
                 ids=res.topk_ids, scores=res.topk_scores,
                 calls=np.array(json.dumps(calls)),
                 layout=np.array(json.dumps(eng.layout_info(), default=str)))
    return 0


def serve_plan(payload) -> int:
    import torch

    from pagerank_tpu_torch.obs import metrics as obs_metrics
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel.elastic import (ElasticExhaustedError,
                                                     RankLeftError)
    from pagerank_tpu_torch.serving.daemon import PprServer, ServeConfig
    from pagerank_tpu_torch.testing.faults import ProcessKillPlan
    from pagerank_tpu_torch.testing.schedules import VirtualClock
    from pagerank_tpu_torch.utils.config import PageRankConfig

    torch.set_num_threads(1)
    rank, world = distributed.process_info()
    me = distributed.member()
    if payload.get("kill"):
        os.environ[ProcessKillPlan.ENV] = payload["kill"]
    graph = _graph(payload["edges"])
    obs_metrics.get_registry().reset()
    clock = VirtualClock()
    srv = PprServer(graph,
                    config=PageRankConfig(**payload["config"],
                                          num_devices=world),
                    serve_config=ServeConfig(**payload["serve"]),
                    devices=[payload["device"]], clock=clock)
    if rank != 0:
        status = "stopped"
        try:
            srv.follow()
        except RankLeftError:
            status = "left"
        except ElasticExhaustedError:
            status = "terminal"
        np.savez(os.path.join(payload["out"], f"follower.m{me}.npz"),
                 status=np.array(status))
        return 0
    srv.start(dispatcher=False)
    handles = []
    for batch in payload["batches"]:
        handles += [srv.submit(int(s)) for s in batch]
        srv.pump()
    srv.drain()
    k = srv.serve_config.topk
    ids = np.full((len(handles), k), -1, np.int64)
    scores = np.zeros((len(handles), k))
    for i, q in enumerate(handles):
        if (q.outcome or "").startswith("answered"):
            ids[i], scores[i] = q.result(timeout=0)
    counters = obs_metrics.get_registry().snapshot()["counters"]
    np.savez(os.path.join(payload["out"], "serve.npz"),
             outcomes=np.array([q.outcome or "<unsettled>"
                                for q in handles]),
             ids=ids, scores=scores,
             device_ids=np.array(srv.device_ids(), np.int64),
             rescues=np.int64(srv.rescues_done),
             walls=np.array(json.dumps(srv.rescue_walls)),
             counters=np.array(json.dumps(
                 {n: v for n, v in counters.items()
                  if n.startswith("serve.")})))
    return 0
