"""Counts of the packed layouts that decide K1's and K2's design.

    python -m pagerank_tpu_torch.scripts.layout_counts --scale 21
    python -m pagerank_tpu_torch.scripts.layout_counts --scale 19 --parts 2 36 72

On the R-MAT graph of ``--scale`` (``utils/synth.rmat_edges``, edge
factor 16, ``--seed``), built as the CLI builds it, prints one JSON line:

- ``head``: for each head size H (``--heads``; default the sizes that
  matter on the H100: 8,192, 40,960, 58,104 = the f32 head a CTA stages
  next to no ring, 116,208 = the bf16 one), the share of the flat pack's
  real slots whose relabeled source is below H (the gathers the staged
  head serves on chip), and the share of slots that are sentinels;
- ``partitions``: for each partition count K (``--parts``), the span
  ceil(n_pad / K) rounded up to 128, and the slot rows and (dst block,
  partition) pairs of the partition-centric pack at that span, beside
  the flat pack's rows: what cutting the source range finer costs in
  padding and in pairs.

Counts only, computed on the host; nothing here is a time.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from pagerank_tpu_torch import graph as graph_mod
from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops import ell as ell_lib
from pagerank_tpu_torch.utils import synth

HEADS = (8_192, 40_960, 58_104, 116_208)


def head_shares(pack, heads):
    """{H: share of real slots below H}, and the sentinel share."""
    real = pack.weight != 0
    src = pack.src[real]
    n_real = max(int(src.size), 1)
    return ({int(h): int((src < h).sum()) / n_real for h in heads},
            1 - n_real / pack.src.size)


def partition_counts(graph, n_pad, parts):
    """{K: (span, slot rows, pairs)} of the striped pack."""
    out = {}
    for k in parts:
        span = -(-n_pad // k // LANES) * LANES
        sp = ell_lib.ell_pack_striped(graph, stripe_size=span)
        pairs = sum(ell_lib.dense_block_ranks(rb, sp.num_blocks)[2]
                    for rb in sp.row_block)
        out[int(k)] = (span, sp.num_rows, int(pairs))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=19)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--heads", type=int, nargs="*", default=list(HEADS))
    p.add_argument("--parts", type=int, nargs="*", default=[],
                   help="partition counts K to pack at (none: skip)")
    args = p.parse_args(argv)
    n = 1 << args.scale
    src, dst = synth.rmat_edges(args.scale, seed=args.seed)
    g = graph_mod.build_graph(src, dst, n=n)
    del src, dst
    pack = ell_lib.ell_pack(g)
    shares, sentinels = head_shares(pack, args.heads)
    doc = {"scale": args.scale, "seed": args.seed, "n": g.n,
           "edges": int(g.num_edges), "flat_rows": pack.num_rows,
           "head": shares, "sentinel_share": sentinels}
    del pack
    if args.parts:
        doc["partitions"] = {
            k: {"span": s, "rows": r, "pairs": q}
            for k, (s, r, q) in partition_counts(g, -(-n // LANES) * LANES,
                                                 args.parts).items()}
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
