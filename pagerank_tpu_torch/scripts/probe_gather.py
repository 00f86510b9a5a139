"""Micro-benchmark: the gather forms of out = z[src]·w on the card.

Port of ``scripts/probe_gather.py``. The SpMV's hot op is, per ELL
slot, ``z[src[row, lane]] * w``; the gather of z at arbitrary indices
is what bounds it. Forms probed:

  take1d            : z[src] * w                       (plain PyTorch)
  onehot8/16/32     : z.view(-1, W)[src >> s] one-hot select of src & (W-1)
  onehot128mxu      : z.view(-1, 128)[src >> 7], take_along_dim of src & 127
  probe_take        : P1, CUDA kernel, a direct gather      (pallas_take1d)
  probe_group8      : P2, CUDA kernel, group of 8 + select  (pallas_onehot8)
  probe_rowsel_smem : P3, CUDA kernel, z in shared memory   (pallas_rowgather_taa)

The plain forms are the kernels' plain versions
(``ops/gather_probe.py``). The script's chunked ``onehot{W}c`` forms
are not carried over: they sum all rows into 128 lanes, a TPU memory
workaround that does not compute the probe's function.

Run: python -m pagerank_tpu_torch.scripts.probe_gather [--rows 65536]
     [--n 1048576] [--dtype float32|bfloat16] [--iters 20]
     [--device cuda|cpu] [--seed 0]

Times are medians of ``--iters`` calls after warm-up: CUDA events on
the card, ``time.perf_counter`` on the CPU (where the kernel forms run
their plain versions and no bound applies). z stays L2-resident between
calls where it fits, as it does from one solver step to the next.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import time

import numpy as np
import torch

from pagerank_tpu_torch.analysis.kernels import probe_cost
from pagerank_tpu_torch.obs import costs
from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops import gather_probe as gp

WARMUP = 3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: Form name -> function(z, src, w).
FORMS = {
    "take1d": gp.gather_take_reference,
    **{f"onehot{w}": functools.partial(gp.gather_group_reference, width=w)
       for w in (8, 16, 32)},
    "onehot128mxu": gp.gather_rowsel_reference,
    "probe_take": gp.gather_take,
    "probe_group8": gp.gather_group8,
    "probe_rowsel_smem": gp.gather_rowsel,
}
#: The kernel forms, by the name of their wrapper's launch counter.
KERNELS = {"probe_take": "gather_take", "probe_group8": "gather_group8",
           "probe_rowsel_smem": "gather_rowsel"}
_WIDTH = {"onehot8": 8, "onehot16": 16, "onehot32": 32,
          "onehot128mxu": LANES, "probe_group8": 8,
          "probe_rowsel_smem": LANES}


def skip_reason(form: str, n: int, dtype: torch.dtype):
    """Why ``form`` does not apply to z [n] of ``dtype`` (the script's
    ``SKIP`` wording), or None."""
    if n % _WIDTH.get(form, 1):
        return "SKIP width does not divide n"
    if form == "probe_rowsel_smem" and not gp.rowsel_fits(n, dtype):
        return (f"SKIP z takes {n * dtype.itemsize} B, more than the "
                f"{gp.SMEM_LIMIT} B of shared memory")
    return None


def make_inputs(rows: int, n: int, dtype: torch.dtype, seed: int, device):
    """(z, src, w) as ``scripts/probe_gather.py:51-54`` makes them: the
    same numpy draws, cast to bf16 with round-to-nearest-even."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, (rows, LANES)).astype(np.int32)
    w = rng.random((rows, LANES), np.float32)
    z = rng.random(n, np.float32)
    return (torch.from_numpy(z).to(device=device, dtype=dtype),
            torch.from_numpy(src).to(device),
            torch.from_numpy(w).to(device=device, dtype=dtype))


def time_ms(fn, iters: int, device) -> float:
    """Median milliseconds of ``iters`` calls of ``fn`` after WARMUP."""
    for _ in range(WARMUP):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_probe(z, src, w, *, iters: int = 20, forms=None):
    """Time each form (default all of FORMS) on these inputs: ``{form:
    median ms}``, or ``{form: "SKIP <reason>"}`` where its geometry does
    not apply. A kernel form launches WARMUP + iters times."""
    results = {}
    for name in FORMS if forms is None else forms:
        reason = skip_reason(name, z.shape[0], z.dtype)
        fn = FORMS[name]
        results[name] = reason or time_ms(lambda: fn(z, src, w), iters,
                                          z.device)
    return results


def report(results, rows: int, n: int, dtype: torch.dtype, device):
    """The script's lines (ms, Gslot/s, stream GB/s) plus the share of
    the byte bound on the card; returns the JSON record."""
    slots = rows * LANES
    gb = slots * (4 + 2 * dtype.itemsize) / 1e9  # src + w + out
    bound_ms = None
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if device.type == "cuda":
        bound_ms = (probe_cost(rows, n, dtype.itemsize)["bytes"]
                    / costs.device_spec(name).hbm_bytes_per_s * 1e3)
    dt = str(dtype).removeprefix("torch.")
    print(f"\nrows={rows} slots={slots:,} n={n:,} dtype={dt} on {name}; "
          + (f"byte bound {bound_ms:.4f} ms" if bound_ms is not None
             else "no byte bound on the cpu"))
    for k, v in results.items():
        if isinstance(v, float):
            share = (f"  {bound_ms / v:6.1%} of bound" if bound_ms is not None
                     else "")
            print(f"  {k:24s} {v:8.3f} ms  {slots / v / 1e6:7.3f} Gslot/s  "
                  f"{gb / v * 1e3:6.1f} GB/s(stream){share}")
        else:
            print(f"  {k:24s} {v}")
    return {"rows": rows, "n": n, "dtype": dt,
            "device": name, "bound_ms": bound_ms, "forms": results}


def main(argv=None) -> int:
    from pagerank_tpu_torch.engines.torch_engine import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m pagerank_tpu_torch.scripts.probe_gather",
        description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=1 << 16,
                   help="rows of 128 slots")
    p.add_argument("--n", type=int, default=1 << 20, help="length of z")
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="default cuda; cpu only when asked")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    z, src, w = make_inputs(args.rows, args.n, dtype, args.seed, device)
    results = run_probe(z, src, w, iters=args.iters)
    print(json.dumps(report(results, args.rows, args.n, dtype, device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
