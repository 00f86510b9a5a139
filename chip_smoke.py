#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full check (R-MAT scale 22)
    python3 chip_smoke.py --scale 16      # a quicker rehearsal

What it does, in order:

  1. prints the card's name and power limit (nvidia-smi) and
     torch.cuda.get_device_name(0);
  2. builds every kernel under pagerank_tpu_torch/csrc/ with nvcc for
     sm_90a (one nvcc per source, all at once) and prints the build
     seconds and the ptxas register report;
  3. drives the flat main path through the CLI entry point in-process
     (``pagerank_tpu_torch.cli.run``): --synthetic rmat:SCALE, reference
     semantics, 10 iterations, f32, --snapshot-dir and --out in a temp
     dir, on cuda. Every kernel's launch count is set to 0 just before
     and read just after: K1's must equal the number of steps, K2's 0.
     build_graph must take the native radix sorter where the JAX
     package's auto rule does (rmat:22 on a host of more than one
     core); the host build split and the host facts (numpy, cores,
     MemAvailable, peak RSS) are printed.
     The ranks are checked against the port's f64 ReferenceCpuEngine on
     the same graph (mass-normalised L1 <= 1e-4), and the last snapshot
     and the --out file against the returned ranks;
  4. holds K1 (ell_contrib, one persistent launch a call) on the card
     at the main path's own shapes (the engine's packed slots, the
     prescaled final ranks) in every entry (f32/f32, f32/f64, f64/f64)
     and on a small adversarial pack (a hub block hundreds of segments
     deep, empty blocks, all-sentinel rows): torch.equal to its plain
     plan-order version computed on the CPU from the same inputs; two
     launches on one workspace and a head of 0 bit-identical; normalised max error against exact (f64) sums <=
     1e-5 (f32), 1e-6 (f32/f64), 1e-12 (f64). Prints the share of real
     slots below the head and of sentinels. Times the wrapper call
     (CUDA events, median of 30), the bare launch of the bound launcher
     (50 launches between two events, median of 7 rounds) with the
     largest head and a head of 0, in turns, the
     twin and one torch.sparse.mm of the same matrix as a yardstick,
     beside K1's byte bound; then splits a main-path step's time by
     kernel with torch.profiler (K1 once a step, no pass-2 kernel, the
     elementwise kernels, the device's idle share; K1's wrapper must
     count one launch a profiled step, and a window where the profiler
     shows fewer, a record it dropped, is profiled again, up to three
     windows);
  5. the partition-centric path on the graph phase 3 built: the span
     from the CLI's resolver at -1, a TorchEngine on cuda for 10
     iterations in f32 and again with the bf16 window stream. The
     counts are set to 0 before each run and read after: K2's must be
     10, K1's 0. Normalised L1 against phase 3's f64 oracle <= 1e-4
     (f32), and in (1e-7, 5e-3) for bf16 (a real bf16 run, inside
     quantization grade);
  6. holds K2 (ell_contrib_partitioned, which now writes the block sums
     itself) the same way at that path's shapes in every entry (f32 and
     bf16 windows, 3-byte and int32 words) and on adversarial packs
     (deep hub pairs, empty partitions, empty blocks, all-sentinel
     rows; at 59 partitions a hub block fed by more than 32 pairs),
     against its plain plan-order version on the CPU and exact
     (f64) sums of the same widened values (<= 1e-5). Prints the head's
     share of partition 0's slots. Times the wrapper call, the bare
     launches in turns (largest head and 0, f32 and bf16 windows), the twin and one torch.sparse.mm of the same
     block-row x windowed-z matrix (f32) beside K2's byte bound, and
     splits the partitioned step (f32 and bf16 windows) by kernel with
     torch.profiler: K2 once a step, no expansion kernel;
  7. the gather probe (P1-P3, ``pagerank_tpu_torch.scripts.
     probe_gather.run_probe``): out = z[src]*w through each of the
     three gather kernels and its plain version, (a) on the main path's
     own slot arrays: K1's flat pack with z_ext (taken in phase 3) and
     K2's windowed pack as global indices into the flattened windows,
     f32 and bf16 windows (taken in phase 6), each printed beside that
     kernel's profiled device time; (b) a uniform sweep, 2^19 rows x 128
     slots, n in {2^15, 2^20, 2^22, 2^24}, f32 and bf16. At every point
     the counts are set to 0 before run_probe and read after (each
     kernel that applies launched warm-up + 30 times, the others 0);
     each kernel is torch.equal to its plain version and bit-identical
     on repeat; times are CUDA-event medians of 30 beside the byte
     bound, the plain version, one F.embedding_bag (the same function),
     index_select then mul, and index_select alone. P3 runs
     where z fits shared memory (n = 2^15 here), P2 where n % 8 == 0;
  8. resume determinism on the card, for the flat form and through the
     CLI's --partition-span -1, and for the coo form through
     ``TorchEngine(kernel="coo")`` and the snapshot API (``Snapshotter``,
     ``resume_engine``): 6 iterations with snapshots, a resume to 10,
     and an uninterrupted 10 give bit-equal ranks, the form's kernel
     launched once a step (20 times) and the other kernels not (the coo
     form launches none);
  9. the crawl job (the reference's own input, Sparky.java:44-124): a
     101-file block-compressed SequenceFile segment of 10,000 records
     a file (``utils/synth.crawl_segment``, seed 23) written under
     build/, then through ``cli.run`` on cuda: format detected as
     seqfile, ingested by the native L1 (the Python route, said on a
     line, where the host cannot build it), 10 iterations flat with
     --snapshot-every 1, --jsonl, --top 1000 and --out. K1 launches 10
     and K2 0; dangling = the uncrawled targets (not out-degree 0);
     mass-normalised L1 <= 1e-4 against the f64 oracle; --out is the
     top 1000 by (rank desc, id asc) keyed by URL, the JSONL has 10
     records, snapshots 1-10 exist and the last equals the ranks. Then
     the same segment at --partition-span 2^20 (K = 2; K2 10, K1 0,
     <= 1e-4), and with --host-mem-cap-gb 0.25 (the out-of-core build:
     every graph field identical, ranks bit-equal), and the native and
     serial Python routes bit-equal on the first 10 files. Each run
     prints its stages: ingest (threads), build_graph (sort route),
     pack, median ms/iter and edges/s, snapshot save, --out write;
 10. the graph built on the card (``ops/device_build.py``,
     ``TorchEngine.build_device``, ``--device-build``): (a) phase 3's
     deduplicated host edges uploaded and built flat and at phase 5's
     span: the engines' slot planes, row blocks/pairs and perm
     torch.equal to the host pack's, ranks bit-equal to phase 3's K1 and
     phase 5's K2 ranks; a checkpoint_arrays -> restore_device_graph
     round trip on the card keeps the fingerprint and the ranks bit for
     bit; (b) ``cli.run --synthetic rmat:SCALE --device-build`` flat
     (snapshots, --out) and at --partition-span -1 (span resolved over
     the raw edge count), each against the f64 oracle of the same
     generated edges (copied to the host first; normalised L1 <= 1e-4),
     K1 10 and K2 0, then the reverse; the stage split, slot rows
     against the host pack's, K, peak device memory, ms/iter, edges/s;
     the plain f64 PageRank on the card of (e) is held there to the
     f64 oracle on the same edges (normalised L1 <= 1e-12); (c) phase
     8's resume check with --device-build, both forms; (d) phase 9's
     segment once more, flat, with --device-build, within 1e-4 of that
     phase's oracle and beside the host-built ranks; (e) rmat:24 (past
     L2) flat from a seed, K1 10: K1 at that path's own slots and plan
     torch.equal to its plain plan-order version on the CPU and within
     1e-5 of exact f64 sums, and the ranks within 1e-4 (normalised L1)
     of a plain f64 PageRank on the card over the same seed's edges
     (torch.unique dedup, one index_add_ a step: no pack, plan or
     kernel of the port), whose unique edges and out-degrees equal the
     device graph's;
 11. the kernel-plane check (``pagerank_tpu_torch.analysis``): (a)
     ``python -m pagerank_tpu_torch.analysis --select PTK --compiled
     --json`` as subprocesses, all at once: the shipped registry exits
     0 with no finding and each ``--kernel-fixture NAME`` exits 1 with
     exactly its rule, with the compile facts read from the built
     libraries (every shipped symbol's registers, shared bytes, local
     memory and stack frame printed); (b) F1-F6 on the card at the JAX fixtures'
     shapes, the counts set to 0 before and read after: F1 at its
     geometry refused with no error left pending, and equal to its
     plain copy at 2^15 and at a ragged 2^15 + 1, F2 and F5 equal, F3
     equal with NaN at exactly the elements PTK003 names, F2 and F3 so
     again at [300, 192] and [32, 128], an input off 16 bytes refused
     by every fixture of ``VECTOR``, F4 one of its two writers in every
     element (at [64, 128] NaN at exactly the PTK003 gaps), F6 within
     1e-5 of an f64 matmul at [256, 128] x [128, 128] and [512, 256] x
     [256, 128], bit-identical on repeat; each timed as a wrapper call
     (median of 30) and as a bare launch of its bound C entry (50
     launches between two events, median of 7 rounds, in turns; and its
     host clock) beside its bound, its plain version, the one library
     call of its function (``x.clone()``, F3 ``F.pad``, F4
     ``x[-16:].clone()``, F6 ``torch.matmul``; each checked against the
     plain version) and the preallocated ``Tensor.copy_`` /
     ``torch.matmul(out=)``; F4's wrapper host time split; the phase's
     seconds;
 12. personalized PageRank and its daemon at the size of the repo's
     PPR acceptance runs (BASELINE.md:154-160), and the coo form:
     (a) ``cli.run --synthetic rmat:20 --ppr-sources random:256
     --ppr-topk 100 --ppr-chunk 64 --iters 20 --dtype float32 --out``
     on cuda: K1w (ell_contrib_spmm) launched exactly 80 times (one an
     iteration a chunk, 20 x 4 chunks), K1, K2 and the probe kernels 0;
     held to a plain f64 PPR on the card over all 256 sources
     (``torch.sparse.mm`` of A_T, none of the port's pack, plans or
     kernels; itself within 1e-12 of the host ``ppr_cpu`` on 4
     sources) by the acceptance gates: per-source top-100 id overlap
     >= 0.999 and score L1 <= 1e-4; prints ms an iteration a chunk,
     edge·vectors/s, the host build split and the peak device memory;
     (b) K1w at (a)'s shapes (its bound launcher and z2) torch.equal to
     its plain version on the CPU and to K1's 64 column launches at k =
     1, 8 and 64 in f32/f32 and f64/f64 and at 64 in f32/f64 (max error
     against f64 sums <= 1e-5), its fold of block 0's lanes (the
     dangling mass) torch.equal to the plain fold, PTK001-005 clean on
     that plan at k = 64, 8 and 1; the 64-column SpMM at every built
     tile (4 to 64), and over f64 sums at tiles 16, 32 and 64, each
     torch.equal to the plain version and timed; the same batch twice bit-equal, a source alone bit-equal
     (ids and scores) to the same source in its batch, an f64/f64 run
     within 1e-12 of ``ppr_cpu`` on 4 sources; one chunk iteration
     (CUDA events, and split by kernel with torch.profiler, K1w's
     launches counted by its wrapper) and K1w's launch beside K1's 64
     column launches, the
     byte bound of the 64-column SpMM (``k1_cost(columns=64)``: the
     slots and plan once, each column's z and output once), the plain
     version on the card and one ``torch.sparse.mm`` of A_T with a
     dense [n, 64] f32 matrix; (c) ``serve.main(["--serve-smoke", "64",
     "--scale", "20", "--iters", "20", "--topk", "100", "--max-batch",
     "8"])`` in process: exit 0, no query unsettled, every outcome
     answered, K1w launched 20 times a dispatched batch (its live
     columns only) plus 20 for the warm-up, K1 0;
     then a ``PprServer`` behind ``QueryIngress`` on an ephemeral port:
     16 concurrent HTTP queries whose ids equal ``PprTorchEngine.run``,
     a repeat answered from the cache with equal ids and scores, and
     ``/healthz``, then a lone query (one column: 20 K1w launches at a
     4-column tile); prints the warm-up and the batch walls (first, p50,
     p99, lone), and one of the lone query's iterations split by kernel
     (torch.profiler) with its K1w launch timed alone; (d) (run right after phase 5, on phase 3's graph) the
     coo form on cuda for 10 iterations, twice: torch.equal, K1 and K2
     0, within 1e-4 of the f64 oracle, its median step beside the flat
     form's (phase 3's engine, 10 more steps through ``engine.run``,
     timed the same way) and the partitioned form's;
 13. the robustness plane: (a) rmat:22 built on the card, flat, 10
     iterations through ``cli.run`` three times — no sink;
     ``--snapshot-dir`` + ``--dump-text-dir`` with the async writer
     (the copy to pinned memory on a side stream); the same with
     ``--sync-io``; ``--snapshot-dir`` alone with each writer: the rank
     vectors bit-equal, each ``PageRank{i}/part-00000`` byte-identical
     between async and sync with its ``_SUCCESS``, formatted by the
     native route, the tenth dump parsed back to the ranks exactly, the
     last snapshot loaded equal to them, the snapshots byte-identical
     between the writers, K1 10 launches a run; each run's median ms/iter,
     solve wall to the last flushed write, per-save and per-dump ms and
     the writer's queue wait; then the no-sink run and the async runs
     once more each under torch.profiler, every step split into the
     host's wait in its two syncs, the rest of its host time, and the
     device time on the compute stream and on the payload's side
     stream; (b) ``--snapshot-dir s3://...`` and
     ``--dump-text-dir s3://...`` against ``tests/s3stub.py`` in this
     process (localhost) at rmat:16, 6 iterations, then ``--resume`` to
     10: bit-equal to an uninterrupted run; (c) ``--job-dir`` at rmat:18
     built on the card as a subprocess, SIGKILLed at solve iteration 5
     by ``ProcessKillPlan``, then rerun: ingest and build skipped, the
     solve resumed, ranks and ``--out`` bit-equal to an uninterrupted
     job; (d) ``--sdc-check-every 1`` at rmat:22, flat and partitioned
     f32: no breach, bit-equal to the unchecked runs, the checked
     step's ms beside the plain step's, the detection floor (the copy
     tolerance times n) held above the largest change a one-element
     exponent flip at iteration 4 could make there, and a one-shot sign
     flip of the largest rank at iteration 4 (twice that rank, past the
     floor) detected, classified transient and redone to the unchecked
     run's bits with K1/K2 launched steps + 1; at rmat:18 (where
     such flips clear the floor), on engines over the CLI's device graph,
     a one-shot exponent flip at iteration 4 (``DeviceFaultSchedule``,
     its seed the first whose flipped element moves w·r past twice the
     floor) detected, classified transient and redone to the clean bits
     with K1/K2 launched steps + 1, and a sticky one raising
     ``DeviceQuarantinedError`` after its redo also breaches (K1/K2 6
     launches);
 14. the run's own observability (``obs/``): (a) rmat:22 built on the
     card, flat (K1) and at --partition-span -1 (K2, f32 windows),
     ``engine.run(probes=ConvergenceProbes(1, topk=64))``: the ranks
     bit-equal to the unprobed run, every probe's engine-space ids,
     churn and top-k mass equal to a stable argsort of the engine-space
     ranks on the host, the ledger clean, K1/K2 10 launches, the probed
     step beside the plain step (CUDA events); (b) one flat rmat:22
     ``cli.run`` with --run-report, --trace, --metrics-textfile,
     --metrics-port (scraped once over HTTP), --device-sample-every 1,
     --graph-profile and --history: every report section, one
     solve/step span an iteration, the sampler's watermark at or above
     ``max_memory_allocated``, the device profile's integer stats equal
     to ``profile_graph`` over the same edges on the host; (c)
     --preflight's predicted peak within [1, FIT_BAND] of the measured
     ``max_memory_allocated`` of the device-built runs at rmat:22 and
     rmat:24, and the smallest refused R-MAT scale exiting 3 with
     nothing allocated; (d) a step stalled 2 s by ``testing/faults.py``
     under --stall-timeout 0.5: ``raise`` drains and exits 75 with the
     JAX CLI's diagnostic, ``warn`` logs and finishes; (e)
     --profile-dir writes a trace naming ``ell_contrib_kernel``; (f)
     the daemon as a process with --metrics-port (OpenMetrics, scraped
     once) and --run-report (written on the SIGTERM drain, exit 75);
 15. sharded execution (run after phase 14, on phases 3 and 5's graph
     and ranks): (a)
     the engine API in a gloo group of SHARD_WORLD ranks spawned on the
     one card (``parallel/distributed.spawn_group``; gloo takes CUDA
     tensors for all_reduce, all_gather_into_tensor and
     reduce_scatter_tensor, where NCCL refuses two ranks of one
     device), at rmat:SHARD_SCALE (20; rmat:SCALE's phase 3 edges until
     the cut that made room for phase 19), 10 iterations: the
     edge-sharded flat form (K1), the edge-sharded partitioned form at
     phase 5's span in f32 and bf16 windows (K2), the vertex-sharded
     form (K1) unchecked and with ``sdc_check_every=1``, and f32 ranks
     over f64 sums edge-sharded and vertex-sharded. Rank by rank: the
     first
     step's kernel output on its own rows torch.equal to the kernel's
     plain plan-order version on the CPU; 10 launches of K1 or K2; the
     ms/iter, the collectives' CUDA-event time a step and the bare
     launch (the ranks in turns). The final ranks within the gates
     of one-device runs on cuda on the same graph (flat, and the
     partitioned form at its span in f32 and bf16 windows; normalised
     L1 <= 1e-4; bf16 5e-3), the
     f64-sum pair bit-equal, the checked run bit-equal to the unchecked
     one with 10 clean checks; a snapshot at iteration 4
     at world 2 resumed at world 2 (bit-equal to the uninterrupted run)
     and on a one-device engine (within the gate); (c) in the same
     group: vs_halo over f32 and over f64 sums, vs_halo_async at lag 1
     (gate open, ``halo_async_min_gain=0``) and at lag 0, vs_halo
     checked, and vs_bounded. Each rank's K1 torch.equal to its plain
     version on the rank's own inputs (the halo image, the local dst
     rows), 10 launches a rank; vs_halo bit-equal to the dense
     vertex-sharded form (f32 and f64 sums), lag 0 and the checked run
     bit-equal to vs_halo, lag 1 within 1e-5 of a plain PyTorch run of
     the same stale schedule (``torch.sparse.mm``); the layout's form and
     halo fields, ``comms.bytes_exchanged`` = 10 x the model's bytes a
     step, the plan's summary, ``obs/devices.attribute_exchange`` of the
     dense form and vs_halo, and the point-to-point rounds' CUDA-event
     time; (b) the CLI under NCCL on (a)'s rmat:SHARD_SCALE edges
     (phase 3's rmat:SCALE edges until the cut that made room for phase
     20): ``--num-devices 1 --vertex-sharded`` (a group of one)
     bit-equal to (a)'s one-device flat ranks with no
     ``torch.distributed`` call in its steps, its step beside that
     one-device run's step, the same with ``--halo-exchange`` and with
     ``--vs-bounded`` bit-equal too, and ``--num-devices 2`` on a
     one-card host refused with the JAX ``make_mesh`` error before any
     allocation;
 16. the elastic solve (run after phase 15): (a) on phase 15(a)'s
     rmat:SHARD_SCALE graph and its one-device references (rmat:SCALE
     until the cut that made room for phase 19), three gloo ranks
     sharing cuda:0, spawned
     rescue-armed (``spawn_group(..., rescue=True)``: the script hosts
     the group's store), each running ``ElasticRunner`` over the
     vertex-sharded form (K1) and then the edge-sharded partitioned
     form at that graph's span (K2), f32/f32, 10 iterations, a snapshot
     every iteration written by the current rank 0; the fault shim
     kills member 1 at iteration ELASTIC_KILL. The world goes 3 -> 2
     (members [0, 2]), member 1 leaves, each survivor's K1/K2 is
     torch.equal to its plain version on its NEW rows after the run, its
     launches count the steps before and after the rescue (10; the
     victim's ELASTIC_KILL), the ranks are within 1e-6 normalised L1 of
     one-device ranks of (a)'s graph, the later snapshots name the
     degraded mesh, and the rescue's wall is printed by part (roll call,
     regroup, rebuild, warm start); (b) the CLI over three gloo ranks on
     the host (``--device cpu``: under ``--device cuda`` the CLI picks
     NCCL, which cannot put three ranks on one card) at rmat:16 f64,
     rank 1 SIGKILLed at its fifth step boundary by a seeded
     ``ProcessKillPlan``: exit 0, one rescue in the run report, the
     ranks within 1e-12 of the one-device run; (c) the CLI under NCCL
     in a group of one, ``--num-devices 1 --vertex-sharded
     --stall-action rescue`` on (a)'s edges (phase 3's until the cut
     that kept the script inside its limit with phase 21): K1 10
     launches, ranks bit-equal to (a)'s one-device flat run; then a loss of its only device injected in
     a subprocess ends in ElasticExhaustedError, a non-zero exit, no
     hang;
 17. PPR and its daemon over a process group (run after phase 16, on
     phase 12's rmat:20 edges, its first PPR_CHUNK sources and their
     one-device top-k, kept on disk by ``ppr_group_inputs``): (a)
     ``PprTorchEngine`` at world 2, two gloo ranks sharing cuda:0 and
     spawned rescue-armed, one PPR_CHUNK-column chunk of PPR_ITERS
     iterations in f32/f32: each rank's K1w launches are counted (one an
     iteration, over its share of the rows) and its launch on its share
     is torch.equal to its plain version on the CPU (sums and folded
     mass); the top-k is within PPR_GROUP_RTOL of phase 12's with equal
     ids where phase 12's scores are not tied; the psum's CUDA-event
     time an iteration and its share of the chunk iteration are
     printed; (b) the CLI under NCCL in a group of one, ``--ppr-sources
     <those sources> --num-devices 1`` on the same edges: K1w one launch
     an iteration, no ``torch.distributed`` call in the solve, the rows
     bit-equal to phase 12's; (c) the daemon over (a)'s two ranks: a
     few batches answered within the tolerance of phase 12's answers,
     then member 1 SIGKILLs itself on receiving a batch (a seeded
     ``ProcessKillPlan``), the survivor regroups to world 1 and re-runs
     it (``answered_degraded``); the rescue's wall by part (roll call,
     regroup, rebuild, re-run) is printed;
 18. the fused run (run after phase 14 and before phase 15, so that
     its profiler splits come before any NCCL group; the graph built on
     the card at rmat:SCALE): (a) the flat f32/f32 engine:
     ``run_fused()`` of 10 iterations (K1 10 launches, counted from 0
     just before) torch.equal to a stepwise ``run()``'s ranks with equal
     traces, ``run_fast()`` the same ranks; (b) the same through K2 at
     --partition-span -1, f32 and bf16 windows; (c) the flat form with
     f32 ranks over f64 sums; (d) ``run_fused_tol`` at rmat:18, f64:
     the stop iteration the host-checked run's, its final delta <= tol,
     its ranks bit-equal; (e) the CLI ``--fused --device-build`` with
     ``--snapshot-dir --snapshot-every 2`` through the async writer:
     snapshot files byte-equal to the stepwise CLI run's, ``"fused":
     true`` in its report, and the same run under NCCL in a group of
     one (``--num-devices 1``) with bit-equal ranks; (f) ms/iter of
     ``run()``, ``run_fast()`` and ``run_fused()`` flat, K2 and bf16
     (host wall of 2k minus k iterations over k, each call ending in its
     fetch of the ranks) with the device's busy time an iteration and
     idle share from torch.profiler (the same difference);
 19. probes, the device build, the coo form, the resumable job and the
     async writer over a process group (run after phase 17, on an
     rmat:MESH5_SCALE (18) graph of its own): (a)-(c) two gloo ranks
     sharing cuda:0 run the edge-sharded flat form (K1), the
     edge-sharded partitioned form at the resolver's span in f32
     windows (K2) and the vertex-sharded form (K1), each plain and with
     ``ConvergenceProbes`` every 2 steps, top 64: each rank's
     first-step K1/K2 torch.equal to its plain version on the CPU, 10
     launches a rank, the probed ranks bit-equal to the plain ones, the
     probe history the same on every rank and held to the one-device
     probed run of the form (rank mass within 1e-6 relative, top-k ids
     equal wherever a value is not within 1e-6 of a neighbour's, the
     churn equal where no such tie touches the k-th place); the
     edge-sharded flat and vertex-sharded forms built by
     ``build_device`` from a graph each rank built on the card: each
     rank's slot planes torch.equal to its share of the host pack, the
     ranks bit-equal to the host-built run; the coo form over the
     group within normalised L1 1e-5 of the one-device coo run, its
     ms/iter beside one device's; (d) the CLI under NCCL in a group of
     one, ``--synthetic rmat:18 --device-build --num-devices 1
     --vertex-sharded --job-dir --probe-every 2 --snapshot-every 2``
     with the async writer and again with ``--sync-io`` (exit 0, K1
     10 launches each, the snapshots byte-equal), then the async job
     rerun: every stage skipped, K1 0, the ranks equal; the phase
     prints its seconds;
 20. the daemon's member 0, the quarantined group job and the offline
     tools (run after phase 19): (a) the daemon over three gloo ranks
     sharing cuda:0, spawned rescue-armed, on phase 12's rmat:20 edges
     and its first sources (``ppr_group_inputs``), f32/f32: batch 0
     answered over the three ranks, then the fault shim loses member
     0's DEVICE at batch 1 (``DeviceFaultSchedule(seed=11, kill={0:
     1})``, JAX's daemon test): member 0 stays up as the front, the
     in-flight batch re-runs ``answered_degraded`` over members [1, 2]
     and every answer is within PPR_GROUP_RTOL of phase 12's; member
     0's K1w launches stop at the loss while each survivor's go on (one
     an iteration of every batch), each survivor's launch on its new
     share torch.equal to its plain version; the rescue's wall by part
     is printed; (b) the CLI over three gloo ranks on the host
     (``--device cpu``, as 16(b)) at rmat:16 f64 on a job whose manifest
     quarantines member 1: members 0 and 2 print the JAX line
     ``excluding quarantined device(s) [1] (job manifest); building on
     2 device(s)`` and finish within 1e-12 of the one-device run, member
     1 leaves with exit 1 (this part launches no kernel); (c) the offline
     tools on the card's machine: ``obs report`` of (b)'s two run
     reports, ``obs history ingest`` then ``gate`` over them in a temp
     ledger, ``obs fit --scale 22`` (its predicted peak beside phase
     14(c)'s measured ``max_memory_allocated``), ``obs graph --scale 18
     --device-build`` on the card (the mass ledger reconciled), and
     ``analysis --select PTL,PTR`` (exit 0); the phase prints its
     seconds;
 21. the standing acceptance runs on the card (run after phase 20;
     ``pagerank_tpu_torch.scripts.acceptance``, each key's runner in
     this process at the JAX script's sizes and under its gates and the
     card's budgets): A (rmat:20, 20 iterations) in f64/f64 against the
     f64 oracle (raw and mass-normalised L1 <= 1e-6), the smokes F, G,
     H, K, R, U and W, and the group smoke L (three gloo ranks on
     cuda:0, member 2 lost at iteration 6). The counts are set to 0
     before each key and read after: K1 launched iterations + 1 (the
     warm step) in A through its ``ell_contrib_f64_f64`` entry, K2 the
     steps of K (K1 0 there), K1w and the probe and fixture kernels 0
     in every key; L's K1 launches are its ranks', each counted from 0
     before the chaos run: 12 on each survivor (6 at world 3, 6 at
     world 2, no step recomputed), 6 on the victim, none in this
     process; every record passed; P's gates are phase 12's and T (A's
     graph, textbook) is the script's, not run here; the phase prints
     its seconds;
 22. the port's bench CLI and the measurement campaign (run after phase
     21; ``pagerank_tpu_torch.bench``, ``obs/campaign.py`` and the
     acceptance keys D, N and AA, each in this process): (a)
     ``bench.main`` in single mode, f32, rmat:BENCH_SCALE (20) built on
     the card, 10 iterations after 2 of warm-up, ``--no-accuracy``: the
     counts set to 0 before and read after, K1 launched warm-up +
     iterations times (and its layout record says so), K2, K1w and the
     probe and fixture kernels 0, the step's roofline fraction in (0,
     1]; prints ms/iter and edges/s with the card's name and power
     limit; (b) key D: the f64/f64 device build at rmat:18 with every
     ``BUILD_STAGE_KEYS`` stage; (c) key N: a fresh bench subprocess
     into a copy of the history ledger, the gate's drift and regression
     verdicts; (d) key AA: ``obs campaign run --fake-devices 2`` on the
     card, its multichip leg over two gloo ranks sharing cuda:0, every
     leg done and the four verdicts ``defer``; each bench leg's
     ``layout`` (rank 0's for the group legs) names the kernel that
     ``acceptance.AA_LEGS`` gives it (couple f64 and fast_f32, the
     vertex-sharded legs: K1; partitioned_f32, fast_bf16,
     pallas_partitioned: K2; ppr_serve: K1w) and counts exactly one
     launch of it a step, its steps those of ``AA_LEGS`` (warm-up,
     timed and attribution steps; the daemon's, its warm-up's and
     batches' iterations), and no launch of the other two. Every record
     passed; the phase prints its seconds;
 23. prints one JSON line with every kernel's numbers (K1, K2, K1w on
     the PPR path with its tile sweep and its record over a group, P1
     and P2 at K1's slots, P3 at n = 2^15 f32, F1-F6; K1 and K2 with
     phase 21's ``acceptance`` record, K1, K2 and K1w with phase 22's
     ``bench`` record), then last ``{"ok": true, "device": {...}}``.

Every byte bound comes from the registry's cost models
(``pagerank_tpu_torch/analysis/kernels.py``: ``k1_cost``, ``k2_cost``,
``probe_cost``; K1w's is ``k1_cost(columns=64)``) and the card's memory
rate from the device table
(``pagerank_tpu_torch/obs/costs.py``; F6's operations at its TF32
tensor-core rate, three passes); K1's and K2's cases are also
held to PTK001-005 on the main path's own rmat:22 plans.

Any failed check raises; the script then exits non-zero and prints no
result line. It also exits non-zero when no CUDA device is available,
and when it is not run from a checkout of the repo.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
ITERS = 10


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _median_ms(fn, repeats, warmup=3):
    """Median over ``repeats`` CUDA-event-timed calls of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _card():
    """The device table's entry of the card (obs/costs.py)."""
    import torch

    from pagerank_tpu_torch.obs import costs

    return costs.device_spec(torch.cuda.get_device_name(0))


def _bound_ms(cost):
    """The least time for a cost model {flops, bytes[, tf32_flops]} on
    this card: the larger of bytes over the memory rate and the
    operations' time, ``flops`` at the f32 rate outside the tensor cores
    plus ``tf32_flops`` at the TF32 tensor-core rate; returns (ms,
    "bytes" or "operations")."""
    card = _card()
    t_bytes = cost["bytes"] / card.hbm_bytes_per_s * 1e3
    t_ops = (cost["flops"] / card.fp32_flops_per_s
             + cost.get("tf32_flops", 0.0) / card.tf32_flops_per_s) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dt(t):
    """A tensor's dtype as its short name (float32, bfloat16, ...)."""
    return str(t.dtype).removeprefix("torch.")


def card_identity():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return line


def build_kernels():
    from pagerank_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all(extra_flags=("-Xptxas", "-v"))
    secs = time.perf_counter() - t0
    for name in build.sources():
        build.load(name)
    print(f"kernels built in {secs:.3f} s: {', '.join(build.sources())}")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "entry function" in ln or "registers" in ln:
                print(f"  {name}: {ln.strip()}")
    return secs


def _reset_counts():
    from pagerank_tpu_torch.ops import (defect_fixtures, ell_spmm, ell_spmv,
                                        ell_spmv_partitioned, gather_probe)

    ell_spmv.launches = 0
    ell_spmv_partitioned.launches = 0
    ell_spmm.launches = 0
    for counts in (gather_probe.launches, defect_fixtures.launches):
        for name in counts:
            counts[name] = 0


def _read_counts():
    """(K1 launches, K2 launches, {P1-P3 wrapper: launches}) since the
    last reset; the F1-F6 counts join P1-P3's dict, keyed fx:<name>,
    and K1w's, keyed K1w."""
    from pagerank_tpu_torch.ops import (defect_fixtures, ell_spmm, ell_spmv,
                                        ell_spmv_partitioned, gather_probe)

    return (ell_spmv.launches, ell_spmv_partitioned.launches,
            {**gather_probe.launches,
             **{f"fx:{k}": v for k, v in defect_fixtures.launches.items()},
             "K1w": ell_spmm.launches})


def _check_case(case):
    """Hold one launch case of a path's real plan to PTK001-005."""
    from pagerank_tpu_torch.analysis import kernels

    found = kernels.check_kernel_case(case)
    _check(not found, f"{case.label}: " + "; ".join(f.render()
                                                     for f in found))


def main_path(scale, tmp):
    """Phase 3: the CLI's main path on cuda; returns (summary, report,
    the f64 oracle's ranks)."""
    import numpy as np

    from pagerank_tpu_torch import PageRankConfig, ReferenceCpuEngine, cli
    from pagerank_tpu_torch.graph import native_sort_auto
    from pagerank_tpu_torch.ingest import native

    snap_dir = os.path.join(tmp, "snaps")
    out = os.path.join(tmp, "ranks.tsv")
    _reset_counts()
    summary = cli.run([
        "--synthetic", f"rmat:{scale}", "--iters", str(ITERS),
        "--semantics", "reference", "--dtype", "float32",
        "--snapshot-dir", snap_dir, "--out", out,
    ])
    launches, k2_launches, probe = _read_counts()
    graph, ranks = summary["graph"], summary["ranks"]
    _check(summary["engine"].device.type == "cuda", "main path not on cuda")
    _check(summary["form"] == "flat_ell", f"main path ran {summary['form']}")
    _check(launches == summary["iterations"] == ITERS and k2_launches == 0
           and not any(probe.values()),
           f"ell_contrib launched {launches} times (ell_contrib_partitioned "
           f"{k2_launches}, the probe kernels {probe}) in "
           f"{summary['iterations']} steps (want one K1 launch per step, "
           f"{ITERS} steps, no other kernel)")
    _check(ranks.shape == (graph.n,) and np.isfinite(ranks).all(),
           "ranks are not finite of shape (n,)")
    t0 = time.perf_counter()
    oracle = ReferenceCpuEngine(PageRankConfig(num_iters=ITERS)).build(
        graph).run()
    oracle_s = time.perf_counter() - t0
    l1 = float(np.abs(ranks - oracle).sum() / np.abs(oracle).sum())
    _check(l1 <= 1e-4, f"main path vs f64 oracle: normalised L1 {l1} > 1e-4")
    snap = np.load(os.path.join(snap_dir, f"ranks_iter{ITERS}.npz"))
    _check(np.array_equal(snap["ranks"], ranks), "last snapshot != ranks")
    with open(out) as f:
        lines = sum(1 for _ in f)
    _check(lines == graph.n, f"--out has {lines} lines, want {graph.n}")
    ms = statistics.median(summary["step_seconds"]) * 1e3
    bs = summary["engine"].layout_info()["build_seconds"]
    host_s = (summary["input_seconds"] + summary["graph_seconds"]
              + summary["engine_build_seconds"])
    want_sort = "native" if native_sort_auto(16 << scale) else "numpy"
    _check(summary["sort_route"] == want_sort,
           f"build_graph took the {summary['sort_route']} sort at rmat:"
           f"{scale}, not {want_sort} (native sorter: "
           f"{native.build_error('fast_ingest')})")
    print(f"main path rmat:{scale}: n={graph.n} edges={graph.num_edges} "
          f"{ms:.3f} ms/iter {graph.num_edges / (ms / 1e3):.6g} edges/s, "
          f"ell_contrib launches {launches} in {ITERS} steps, f64 oracle "
          f"normalised L1 {l1:.3e} ({oracle_s:.1f} s)")
    print(f"host build {host_s:.3f} s: R-MAT edges "
          f"{summary['input_seconds']:.3f} s, build_graph "
          f"{summary['graph_seconds']:.3f} s ({summary['sort_route']} "
          f"sort), ELL pack {bs['pack']:.3f} s, planes + sentinels + "
          f"segment plan {bs['plan']:.3f} s, placement {bs['place']:.3f} s")
    _host_facts_line()
    return summary, {"launches": launches, "ms_per_iter": ms, "l1": l1}, \
        oracle


def _launch_ms(launchers, launches=50, rounds=7):
    """Per-launch device time of bound launchers, in turns on one card:
    each round times ``launches`` back-to-back calls of each launcher
    between two CUDA events, the order reversed every other round;
    returns {name: median over the rounds}."""
    import torch

    for fn in launchers.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in launchers}
    names = list(launchers)
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(launches):
                launchers[k]()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b) / launches)
    return {k: statistics.median(v) for k, v in times.items()}


def _host_ms(fn, repeats=200):
    """Mean host-clock time of ``fn`` over ``repeats`` calls (what a call
    costs the host before the card sees its launch)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) * 1e3 / repeats


def _held(label, got, want, exact, tol):
    """``got`` (a kernel's output on the card) torch.equal to ``want``
    (its plain plan-order version computed on the CPU), and its
    normalised distance to ``exact`` (f64 sums of the same values) within
    ``tol``. Returns the max abs error against ``exact``."""
    _check(_equal(got, want),
           f"{label}: the kernel differs from its plain plan-order version "
           f"computed on the CPU")
    scale = max(float(exact.abs().max()), 1e-300)
    err = float((got.double().cpu() - exact.cpu()).abs().max())
    _check(err / scale <= tol,
           f"{label}: normalised max error {err / scale:.3e} > {tol:g}")
    return err


def _equal(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _variants(bind):
    """The two launchers of one kernel's inputs: the largest head (what
    the path uses) and a head of 0. ``bind(head)`` binds one."""
    return {"head max": bind(None), "head 0": bind(0)}


def _k1_entry(z_ext, src, rb, nb, plan, accum, tol, label):
    """K1 at one entry: torch.equal to the plain plan-order sums computed
    on the CPU from the same inputs; two launches on one workspace
    bit-identical, its counters left zero; a head of 0 bit-identical too;
    within ``tol`` of the exact (f64) sums.
    Returns K1's max abs error against the exact sums."""
    import torch

    from pagerank_tpu_torch.ops import ell_spmv

    work = ell_spmv.workspace(plan, accum, z_ext.device)

    def run(**kw):
        return ell_spmv.ell_contrib(z_ext, src, rb, nb, accum_dtype=accum,
                                    plan=plan, work=work, **kw)

    a, b, c = run(), run(), run(head=0)
    torch.cuda.synchronize()
    _check(torch.equal(a, b), f"K1 {label}: two launches differ")
    _check(not work.counter.any(), f"K1 {label}: counters left non-zero")
    _check(torch.equal(a, c), f"K1 {label}: a head of 0 changed bits")
    want = ell_spmv.ell_contrib_plan_reference(
        z_ext.cpu(), src.cpu(), accum_dtype=accum,
        plan=ell_spmv.plan_to(plan, "cpu"))
    exact = ell_spmv.ell_contrib_reference(z_ext.double(), src, rb, nb,
                                           accum_dtype=torch.float64)
    err = _held(f"K1 {label}", a, want, exact, tol)
    print(f"K1 {label}: torch.equal to the CPU plan-order sums; repeat "
          f"and head 0 bit-identical; vs exact f64 sums max abs err "
          f"{err:.3e} (normalised <= {tol:g})")
    return err


def adversarial_pack():
    """A graph whose pack has a hub block hundreds of segments deep,
    empty dst blocks (kernel_checks appends all-sentinel rows)."""
    import numpy as np

    from pagerank_tpu_torch import build_graph

    rng = np.random.default_rng(5)
    n = 40000
    hub_src = np.arange(1, n)  # every vertex links to vertex 0
    src = np.concatenate([hub_src, rng.integers(0, n, 60000)])
    dst = np.concatenate([np.zeros(n - 1, np.int64),
                          rng.integers(0, n // 4, 60000)])
    return build_graph(src, dst, n=n)


def _shares(words, real, below):
    """'x% of real slots below the head, y% of slots sentinels'."""
    n_real = max(int(real.sum()), 1)
    return (f"{int(below.sum()) / n_real:.1%} of real slots below the head, "
            f"{1 - n_real / words.numel():.1%} of slots sentinels")


def kernel_checks(engine):
    """Phase 4: K1 against its plain versions, the head's share, and its
    timings; returns the K1 record."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.analysis import kernels
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops.ell import segment_plan

    # -- at the main path's own shapes, every entry on the same slots
    z_ext, src, rb, nb, plan = engine.contrib_inputs()
    f32, f64 = torch.float32, torch.float64
    max_err = _k1_entry(z_ext, src, rb, nb, plan, f32, 1e-5,
                        "main-path f32/f32")
    _k1_entry(z_ext, src, rb, nb, plan, f64, 1e-6, "main-path f32/f64")
    _k1_entry(z_ext.double(), src, rb, nb, plan, f64, 1e-12,
              "main-path f64/f64")

    # -- the adversarial pack, in every entry
    g = adversarial_pack()
    eng = TorchEngine(PageRankConfig(), device="cuda").build(g)
    eng.set_ranks(np.random.default_rng(9).random(g.n).astype(np.float32))
    za, sa, ra, na, _ = eng.contrib_inputs()
    # A packed block always has a real slot in each row; append rows of
    # sentinels only (the JAX engine's row padding) to the last block.
    sent = torch.full((100, 128), za.shape[0] - 8, dtype=torch.int32,
                      device=sa.device)
    sa = torch.cat([sa, sent])
    ra = torch.cat([ra, torch.full((100,), na - 1, dtype=torch.int32,
                                   device=ra.device)])
    pa = ell_spmv.plan_to(segment_plan(ra.cpu().numpy(), na), sa.device)
    segs = torch.diff(pa.block_seg_start)
    _check(int(segs[0]) >= 100 and int((segs == 0).sum()) > 0,
           "adversarial pack lacks a deep hub block or an empty block")
    _k1_entry(za, sa, ra, na, pa, f32, 1e-5, "adversarial f32/f32")
    _k1_entry(za, sa, ra, na, pa, f64, 1e-6, "adversarial f32/f64")
    _k1_entry(za.double(), sa, ra, na, pa, f64, 1e-12,
              "adversarial f64/f64")
    del za, sa, ra, pa, eng

    # -- the head's share of the main path's slots
    n_state = z_ext.shape[0] - 8
    real = src != n_state
    head = ell_spmv.check_head(None, 4, n_state,
                               torch.cuda.get_device_name(0))
    print(f"K1 head {head} (f32): " + _shares(src, real, real & (src < head)))

    # -- times at the main path's shapes (f32/f32, as the main path runs)
    work = ell_spmv.workspace(plan, f32, z_ext.device)

    def k1():
        ell_spmv.ell_contrib(z_ext, src, rb, nb, accum_dtype=f32, plan=plan,
                             work=work)

    def twin():
        ell_spmv.ell_contrib_reference(z_ext, src, rb, nb, accum_dtype=f32)

    mask = src != n_state
    lanes = torch.arange(128, device=src.device)
    rows = (rb.long()[:, None] * 128 + lanes)[mask]
    ncols = z_ext.shape[0]
    key, _ = torch.sort(rows * ncols + src.long()[mask])
    rows, cols = key // ncols, key % ncols
    del key, mask
    crow = torch.zeros(nb * 128 + 1, dtype=torch.long, device=src.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=nb * 128), 0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_t = torch.sparse_csr_tensor(
            crow, cols,
            torch.ones(cols.shape[0], dtype=f32, device=src.device),
            size=(nb * 128, ncols))
    del rows
    zcol = z_ext[:, None]

    def library():
        torch.sparse.mm(a_t, zcol)

    lib_out = torch.sparse.mm(a_t, zcol)[:, 0]
    k_out = ell_spmv.ell_contrib(z_ext, src, rb, nb, accum_dtype=f32,
                                 plan=plan)
    lib_err = float((lib_out - k_out).abs().max()
                    / max(float(k_out.abs().max()), 1e-300))
    _check(lib_err <= 1e-5, f"torch.sparse.mm disagrees with K1: {lib_err}")

    ms = _median_ms(k1, 30)
    bind_ms = _host_ms(lambda: ell_spmv.bind(z_ext, src, nb, accum_dtype=f32,
                                             plan=plan, work=work))
    plain_ms = _median_ms(twin, 20)
    library_ms = _median_ms(library, 20)
    bare = _launch_ms(_variants(
        lambda head: ell_spmv.bind(z_ext, src, nb, accum_dtype=f32,
                                   plan=plan, head=head)))
    used = "head max"
    rows_n = src.shape[0]
    case = kernels.k1_case_from_inputs(
        "ell_contrib@main-path", z_ext, src, rb, nb, plan,
        device_kind=torch.cuda.get_device_name(0))
    _check_case(case)
    bytes_moved = int(case.cost_model["bytes"])
    bound_ms, bound_by = _bound_ms(case.cost_model)
    print(f"K1 timing at main-path shapes ({rows_n} rows x 128, "
          f"{plan.num_segments} segments, {nb} blocks, "
          f"{plan.empty_groups.shape[0]} empty): wrapper call {ms:.4f} ms "
          f"(its bind alone {bind_ms:.4f} ms on the host clock); "
          f"bare launch (bound launcher, 50 launches between two events, "
          f"median of 7 rounds in turns): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in bare.items())
          + f"; twin {plain_ms:.4f} ms, torch.sparse.mm {library_ms:.4f} ms, "
          f"{bound_by} bound {bound_ms:.4f} ms ({bytes_moved} B at "
          f"{_card().hbm_bytes_per_s / 1e12:g} TB/s; {bound_ms / ms:.1%} of "
          f"bound for the wrapper call, {bound_ms / bare[used]:.1%} for the "
          f"bare launch); PTK001-005 clean on the main path's plan")
    return {
        "name": "ell_contrib", "route": "cuda",
        "source": "pagerank_tpu_torch/csrc/ell_contrib.cu",
        "replaces": "pagerank_tpu/ops/pallas_spmv.py:98",
        "checked": True, "max_abs_err": max_err, "ms": ms,
        "launch_ms": bare[used], "variants_ms": bare,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shapes": f"z_ext {_dt(z_ext)}[{z_ext.shape[0]}], src int32"
                  f"[{rows_n},128], {plan.num_segments} segments, {nb} "
                  f"blocks, head {head}",
    }


#: The old passes' kernel names: none may run in a step now.
OLD_PASSES = ("segment_partials", "block_sums", "pair_segment_partials",
              "pair_sums")


def _profile_steps(step, steps, wrapper=None):
    """(host wall ms a step over ``steps`` unprofiled steps, then over
    as many steps under torch.profiler: {kernel: device ms a step},
    {kernel: launches}, the host ops' names, and the launches that a
    kernel's ``wrapper`` module counted in the profiled steps, None
    without one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # One warm-up step inside the profiler, whose events are dropped: the
    # first launch after the tracer starts can go unrecorded. The active
    # steps' events are taken when their cycle ends.
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for i in range(steps + 1):
            if i == 1 and wrapper is not None:
                before = wrapper.launches
            step()
            torch.cuda.synchronize()
            prof.step()
    _check(len(traced) == 1, f"the profiler closed {len(traced)} cycles")
    per_kernel, calls, ops = {}, {}, set()
    for ev in traced[0]:
        if str(getattr(ev, "device_type", "")) != "DeviceType.CUDA":
            ops.add(ev.key)
            continue
        if ev.key.startswith("ProfilerStep"):
            continue  # the schedule's step ranges, not kernels
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3 / steps
        calls[ev.key] = calls.get(ev.key, 0) + ev.count
    counted = None if wrapper is None else wrapper.launches - before
    return wall_ms, per_kernel, calls, ops, counted


def _named(k, p):
    """Whether kernel name ``k`` has ``p`` not preceded by a letter or
    "_"."""
    return re.search(rf"(?<![A-Za-z_]){p}", k) is not None


#: Profiled windows a step breakdown or a K1w split may take:
#: torch.profiler now and then shows fewer of a window's kernel records
#: than the wrapper launched (PERF.md §7), so such a window is profiled
#: again.
PROFILE_TRIES = 3


def step_breakdown(engine, kernel="K1", symbol="ell_contrib_kernel",
                   steps=10):
    """Where a step's time goes, on a path's engine: the host wall per
    step of ``steps`` unprofiled steps, then the device time per kernel
    over as many steps under torch.profiler — the path's one kernel
    ``symbol`` (launched once a step), the step's other (elementwise)
    kernels — and the device's idle share of the unprofiled wall. Fails
    if a pass-2 kernel of the first form, an ``index_add_`` or a slice
    add of the old pair expansion runs in the step, or if a window shows
    more of the path's launches than steps. The kernel's wrapper must
    count exactly one launch a profiled step; a window where it does but
    the profiler shows fewer (a record the profiler dropped) is
    profiled again, up to PROFILE_TRIES windows, and fails the check
    when every one is short. ``short_windows`` counts the short
    windows."""
    from pagerank_tpu_torch.ops import ell_spmv, ell_spmv_partitioned

    wrapper = {"ell_contrib_kernel": ell_spmv,
               "ell_contrib_part_kernel": ell_spmv_partitioned}[symbol]
    engine.step()
    short = 0
    while True:
        wall_ms, per_kernel, calls, ops, counted = _profile_steps(
            engine.step, steps, wrapper)
        _check(counted == steps,
               f"{kernel}: the wrapper counted {counted} launches in "
               f"{steps} profiled steps")
        mine = [k for k in per_kernel if _named(k, symbol)]
        seen = sum(calls[k] for k in mine)
        if seen >= steps:
            break
        short += 1
        if short == PROFILE_TRIES:
            break
        print(f"{kernel}: the profiled window shows {seen} launches for "
              f"the wrapper's {counted}; profiling again")
    k_ms = sum(per_kernel[k] for k in mine)
    old = [k for k in per_kernel if any(_named(k, p) for p in OLD_PASSES)
           or "index" in k.lower()]
    expand_ops = sorted(o for o in ops if o in ("aten::index_add_",
                                               "aten::add_"))
    busy = sum(per_kernel.values())
    other = busy - k_ms
    top = sorted(((v, k) for k, v in per_kernel.items() if k not in mine),
                 reverse=True)[:6]
    print(f"{kernel} step breakdown over {steps} steps: wall {wall_ms:.4f} "
          f"ms/step; device busy {busy:.4f} ms/step = {kernel} {k_ms:.4f} "
          f"({seen} launches) + other kernels "
          f"{other:.4f}; device idle {1 - busy / wall_ms:.1%} of the wall")
    for v, k in top:
        print(f"  other kernel {v:.4f} ms/step: {k[:100]}")
    _check(k_ms > 0 and seen == steps,
           f"the profiled steps show {seen} {kernel} launches for {steps} "
           f"steps")
    _check(not old and not expand_ops,
           f"a pass-2 or expansion kernel runs in the {kernel} step: "
           f"{old} {expand_ops}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "kernel_ms": k_ms,
            "other_ms": other, "short_windows": short}


def partitioned_path(graph, oracle, flat_rows):
    """Phase 5: the partition-centric path on the main path's graph, in
    f32 and with the bf16 window stream; returns (f32 engine, bf16
    engine, report)."""
    import numpy as np

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, cli

    span = cli.plan_partition_span(PageRankConfig(), graph.n,
                                   graph.num_edges, -1)
    _check(span > 0, f"the auto rule turned the partitioned form off at "
           f"n={graph.n} edges={graph.num_edges}")
    engines, report = [], {}
    for stream in ("", "bfloat16"):
        cfg = PageRankConfig(num_iters=ITERS, partition_span=span,
                             stream_dtype=stream)
        eng = TorchEngine(cfg, device="cuda")
        t0 = time.perf_counter()
        eng.build(graph)
        build_s = time.perf_counter() - t0
        lay = eng.layout_info()
        step_s = []
        t_last = [time.perf_counter()]

        def on_iteration(i, info):
            now = time.perf_counter()
            step_s.append(now - t_last[0])
            t_last[0] = now

        _reset_counts()
        ranks = eng.run(on_iteration=on_iteration)
        k1, k2, probe = _read_counts()
        label = f"partitioned {stream or 'f32'}"
        _check(k2 == ITERS == eng.iteration and k1 == 0
               and not any(probe.values()),
               f"{label}: ell_contrib_partitioned launched {k2} times "
               f"(ell_contrib {k1}, the probe kernels {probe}) in "
               f"{eng.iteration} steps")
        _check(ranks.shape == (graph.n,) and np.isfinite(ranks).all(),
               f"{label}: ranks are not finite of shape (n,)")
        l1 = float(np.abs(ranks - oracle).sum() / np.abs(oracle).sum())
        if stream:
            _check(1e-7 < l1 < 5e-3, f"{label}: normalised L1 {l1} vs the "
                   f"f64 oracle outside (1e-7, 5e-3)")
        else:
            _check(l1 <= 1e-4, f"{label}: normalised L1 {l1} > 1e-4")
        ms = statistics.median(step_s) * 1e3
        bs = lay["build_seconds"]
        print(f"{label} rmat path: span {lay['partition_span']} K="
              f"{lay['partitions']} pairs {lay['pairs']} slot rows "
              f"{lay['slot_rows']} ({lay['slot_rows'] / flat_rows:.4f}x the "
              f"flat pack's {flat_rows}), {lay['num_segments']} segments, "
              f"words24 {lay['words24']}, {lay['z_dtype']} windows; "
              f"{ms:.3f} ms/iter {graph.num_edges / (ms / 1e3):.6g} edges/s, "
              f"K2 launches {k2} in {ITERS} steps, f64 oracle normalised "
              f"L1 {l1:.3e}; build {build_s:.3f} s = pack {bs['pack']:.3f} "
              f"+ planes/pair ranks/words/plan {bs['plan']:.3f} + placement "
              f"{bs['place']:.3f}")
        engines.append(eng)
        report[stream or "f32"] = {"launches": k2, "ms_per_iter": ms,
                                   "l1": l1, "ranks": ranks}
    return engines[0], engines[1], report


def _k2_entry(inputs, label, tol=1e-5):
    """K2 at one entry: its block sums torch.equal to the plain
    plan-order sums computed on the CPU from the same inputs; repeat and a
    head of 0 bit-identical on one workspace, its counters left zero; within ``tol`` of the exact (f64) sums of the
    same widened values. Returns K2's max abs error."""
    import torch

    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops import ell_spmv_partitioned as k2

    zw, slots, rp, pp, npairs, plan = inputs
    work = k2.workspace(plan, zw.device)

    def run(**kw):
        return k2.ell_contrib_partitioned(zw, slots, rp, pp, npairs,
                                          plan=plan, work=work, **kw)

    a, b, c = run(), run(), run(head=0)
    torch.cuda.synchronize()
    _check(torch.equal(a, b), f"K2 {label}: two launches differ")
    _check(not work.counter.any(), f"K2 {label}: counters left non-zero")
    _check(torch.equal(a, c), f"K2 {label}: a head of 0 changed bits")
    want = k2.ell_contrib_partitioned_plan_reference(
        zw.cpu(), slots.cpu(), pp.cpu(), plan=ell_spmv.plan_to(plan, "cpu"))
    exact = k2.expand_pairs(
        k2.ell_contrib_partitioned_reference(zw.double(), slots, rp, pp,
                                             npairs),
        pp, plan.pair_block, plan.num_blocks)
    err = _held(f"K2 {label}", a, want, exact, tol)
    print(f"K2 {label}: block sums torch.equal to the CPU plan-order sums; "
          f"repeat and head 0 bit-identical; vs exact f64 sums max abs err "
          f"{err:.3e} (normalised <= {tol:g})")
    return err


def adversarial_partitioned(span=4096, deep=50):
    """Inputs of K2 on a pack with deep hub pairs (the hub's in-edges
    cut over every partition; at least ``deep`` segments), empty
    partitions (isolated vertices relabeled last), empty blocks and
    appended all-sentinel rows. At a span of 1024 (59 partitions, hub
    pairs of 16 segments) the hub's block is fed by 40 pairs, more than
    the 32 segments of a finisher's chunk."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, build_graph
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops.ell import pair_plan
    from pagerank_tpu_torch.ops.spmv import pack_words24

    rng = np.random.default_rng(5)
    n, live = 60000, 40000  # ids >= 40000 are isolated
    src = np.concatenate([np.arange(1, live), rng.integers(0, live, 60000)])
    dst = np.concatenate([np.zeros(live - 1, np.int64),
                          rng.integers(0, live // 4, 60000)])
    g = build_graph(src, dst, n=n)
    eng = TorchEngine(PageRankConfig(partition_span=span),
                      device="cuda").build(g)
    eng.set_ranks(rng.random(n).astype(np.float32))
    zw, slots, rp, pp, npairs, plan = eng.contrib_inputs()
    # 100 rows of sentinels only, appended to the last pair.
    sent = torch.full((1, 128), plan.sentinel, dtype=torch.int32,
                      device=zw.device)
    slots = torch.cat([slots, pack_words24(sent).expand(100, -1)]).contiguous()
    rp = torch.cat([rp, torch.full((100,), npairs - 1, dtype=torch.int32,
                                   device=rp.device)])
    plan = ell_spmv.plan_to(pair_plan(
        rp.cpu().numpy(), npairs, plan.pair_block.cpu().numpy(),
        plan.num_blocks, plan.sentinel), zw.device)
    segs = torch.diff(plan.block_seg_start)
    part_rows = torch.bincount(pp[rp.long()].long(), minlength=zw.shape[0])
    _check(int(segs.max()) >= deep and int((part_rows == 0).sum()) > 0
           and plan.empty_blocks.shape[0] > 0
           and int(torch.diff(plan.block_pair_start).max()) > 1,
           "adversarial partitioned pack lacks a deep pair, an empty "
           "partition, an empty block or a block of several pairs")
    return zw, slots, rp, pp, npairs, plan


def _block_csr(zw, slots, rp, pp, plan):
    """K2's function as a CSR matrix: row block*128 + lane, column
    part*W + word, one 1 per real slot (block sums = matrix x windows)."""
    import torch

    from pagerank_tpu_torch.ops.spmv import unpack_words24

    words = unpack_words24(slots).long()
    mask = words != plan.sentinel
    lanes = torch.arange(128, device=slots.device)
    rows = (plan.pair_block.long()[rp.long()][:, None] * 128 + lanes)[mask]
    ncols = zw.numel()
    cols = (pp.long()[rp.long()][:, None] * zw.shape[1] + words)[mask]
    del words, mask
    key, _ = torch.sort(rows * ncols + cols)
    rows, cols = key // ncols, key % ncols
    del key
    nrows = plan.num_blocks * 128
    crow = torch.zeros(nrows + 1, dtype=torch.long, device=slots.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=nrows), 0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            crow, cols, torch.ones(cols.shape[0], dtype=torch.float32,
                                   device=slots.device),
            size=(nrows, ncols))


def k2_checks(eng32, eng16):
    """Phase 6: K2 against its plain versions in every entry, the head's
    share, and its timings; returns the K2 record."""
    import torch

    from pagerank_tpu_torch.analysis import kernels
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops import ell_spmv_partitioned as k2
    from pagerank_tpu_torch.ops import spmv

    inputs = eng32.contrib_inputs()
    zw, slots, rp, pp, npairs, plan = inputs
    max_err = _k2_entry(inputs, "path f32 windows, words24")
    int32 = (zw, spmv.unpack_words24(slots).contiguous()) + inputs[2:]
    _k2_entry(int32, "path f32 windows, int32 words")
    in16 = eng16.contrib_inputs()
    _k2_entry(in16, "path bf16 windows, words24")
    _k2_entry((in16[0],) + int32[1:], "path bf16 windows, int32 words")
    adv = adversarial_partitioned()
    _k2_entry(adv, "adversarial f32 windows, words24")
    _k2_entry((adv[0].to(torch.bfloat16),) + adv[1:],
              "adversarial bf16 windows, words24")
    adv = adversarial_partitioned(1024, deep=16)
    _check(int(torch.diff(adv[5].block_pair_start).max()) > ell_spmv.CHUNK,
           "the 59-partition pack has no block of more than 32 pairs")
    _k2_entry(adv, "adversarial 59 partitions, f32 windows, words24")
    del adv

    words = spmv.unpack_words24(slots)
    real = words != plan.sentinel
    part0 = (pp.long()[rp.long()] == 0)[:, None]
    kind = torch.cuda.get_device_name(0)
    for table, item in (("f32", 4), ("bf16", 2)):
        h = ell_spmv.check_head(None, item, plan.sentinel, kind)
        print(f"K2 head {h} of partition 0 ({table} windows, words24): "
              + _shares(words, real, real & part0 & (words < h)))
    del words, real, part0

    work = k2.workspace(plan, zw.device)

    def kernel(args):
        return lambda: k2.ell_contrib_partitioned(*args[:5], plan=args[5],
                                                  work=work)

    def twin():
        k2.expand_pairs(k2.ell_contrib_partitioned_reference(*inputs[:5]),
                        pp, plan.pair_block, plan.num_blocks)

    a_t = _block_csr(zw, slots, rp, pp, plan)
    zcol = zw.reshape(-1, 1)

    def library():
        torch.sparse.mm(a_t, zcol)

    lib_out = torch.sparse.mm(a_t, zcol)[:, 0]
    k_out = kernel(inputs)()
    lib_err = float((lib_out - k_out).abs().max()
                    / max(float(k_out.abs().max()), 1e-300))
    _check(lib_err <= 1e-5, f"torch.sparse.mm disagrees with K2: {lib_err}")

    ms = _median_ms(kernel(inputs), 30)
    bind_ms = _host_ms(lambda: k2.bind(zw, slots, pp, npairs, plan=plan,
                                       work=work))
    ms_int32 = _median_ms(kernel(int32), 30)
    ms_bf16 = _median_ms(kernel(in16), 30)
    plain_ms = _median_ms(twin, 20)
    library_ms = _median_ms(library, 20)

    def binder(args):
        return lambda head: k2.bind(args[0], args[1], args[3], args[4],
                                    plan=args[5], head=head)

    bare = _launch_ms(_variants(binder(inputs)))
    bare16 = _launch_ms(_variants(binder(in16)))
    used = "head max"
    rows = slots.shape[0]
    case = kernels.k2_case_from_inputs("ell_contrib_partitioned@path",
                                       *inputs, device_kind=kind)
    case16 = kernels.k2_case_from_inputs(
        "ell_contrib_partitioned@path-bf16", *in16, device_kind=kind)
    for c in (case, case16,
              kernels.k2_case_from_inputs("ell_contrib_partitioned@int32",
                                          *int32, device_kind=kind)):
        _check_case(c)
    bytes_moved = int(case.cost_model["bytes"])
    bound_ms, bound_by = _bound_ms(case.cost_model)
    print(f"K2 timing at path shapes ({rows} rows x 384 B, {zw.shape[0]} "
          f"windows of {zw.shape[1]}, {plan.num_segments} segments, {npairs} "
          f"pairs, {plan.num_blocks} blocks, {plan.empty_blocks.shape[0]} "
          f"empty): wrapper call {ms:.4f} ms (f32 windows, words24; block "
          f"sums, the expansion included; its bind alone {bind_ms:.4f} ms "
          f"on the host clock), {ms_int32:.4f} ms (int32 words), "
          f"{ms_bf16:.4f} ms (bf16 windows; byte bound "
          f"{_bound_ms(case16.cost_model)[0]:.4f} ms); bare launch (50 "
          f"between two events, median of 7 rounds in turns), f32: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in bare.items())
          + "; bf16: " + ", ".join(f"{k} {v:.4f} ms"
                                   for k, v in bare16.items())
          + f"; twin + expansion {plain_ms:.4f} ms, torch.sparse.mm "
          f"{library_ms:.4f} ms, {bound_by} bound {bound_ms:.4f} ms "
          f"({bytes_moved} B at {_card().hbm_bytes_per_s / 1e12:g} TB/s; "
          f"{bound_ms / ms:.1%} of bound for the wrapper call, "
          f"{bound_ms / bare[used]:.1%} for the bare launch); PTK001-005 "
          f"clean on the path's plans (f32, bf16, int32 words)")
    return {
        "name": "ell_contrib_partitioned", "route": "cuda",
        "source": "pagerank_tpu_torch/csrc/ell_contrib_partitioned.cu",
        "replaces": "pagerank_tpu/ops/pallas_spmv.py:241",
        "checked": True, "max_abs_err": max_err, "ms": ms,
        "launch_ms": bare[used], "variants_ms": bare,
        "variants_bf16_ms": bare16,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shapes": f"z_windows {_dt(zw)}[{zw.shape[0]},{zw.shape[1]}], "
                  f"words24 int8[{rows},384], {plan.num_segments} "
                  f"segments, {npairs} pairs, {plan.num_blocks} blocks",
    }


# (kernel form, its plain form) of the gather probe, P1-P3.
PROBE_PAIRS = (("probe_take", "take1d"), ("probe_group8", "onehot8"),
               ("probe_rowsel_smem", "onehot128mxu"))
PROBE_ITERS = 30
# The Pallas body each kernel form replaces.
PROBE_REPLACES = {"probe_take": "scripts/probe_gather.py:169",
                  "probe_group8": "scripts/probe_gather.py:174",
                  "probe_rowsel_smem": "scripts/probe_gather.py:183"}


def _probe_point(label, z, src, w):
    """One point of the gather probe: ``run_probe`` over P1-P3 (where
    each applies) and their plain forms, with every count set to 0 just
    before and read just after; then each kernel that ran against its
    plain version (torch.equal), twice (bit-identical, counted).
    ``F.embedding_bag`` computes ``z[src] * w`` in one PyTorch call (bags
    of one slot, weighted by w, the offsets made once): its time is the
    records' ``library_ms``, checked against P1's plain version.
    ``index_select`` then ``mul`` into a w-shaped output computes it in
    two calls, and ``torch.index_select`` alone (the gather without w) is
    timed too, each beside its share of its own byte bound (the pair's
    and embedding_bag's is the kernels'). Returns {kernel form:
    numbers}."""
    import torch
    import torch.nn.functional as F

    from pagerank_tpu_torch.analysis.kernels import probe_cost
    from pagerank_tpu_torch.ops import gather_probe as gp
    from pagerank_tpu_torch.scripts import probe_gather as pg

    rows, n = src.shape[0], z.shape[0]
    ran = [k for k, _ in PROBE_PAIRS if pg.skip_reason(k, n, z.dtype) is None]
    forms = [f for k, plain in PROBE_PAIRS
             for f in ((k, plain) if k in ran else (k,))]
    _reset_counts()
    times = pg.run_probe(z, src, w, iters=PROBE_ITERS, forms=forms)
    k1, k2, counts = _read_counts()
    want = {pg.KERNELS[k]: pg.WARMUP + PROBE_ITERS if k in ran else 0
            for k, _ in PROBE_PAIRS}
    want.update({k: 0 for k in counts if k.startswith("fx:")}, K1w=0)
    _check(counts == want and k1 == 0 and k2 == 0,
           f"probe {label}: launches {counts} (K1 {k1}, K2 {k2}), want "
           f"{want} and no K1 or K2")
    bound_ms = _bound_ms(probe_cost(rows, n, z.element_size()))[0]
    slots = src.numel()
    select_ms = _median_ms(lambda: torch.index_select(z, 0, src.view(-1)),
                           PROBE_ITERS)
    # index_select's own bound: src and its output once, z once.
    select_bound_ms = _bound_ms({"bytes": float(
        slots * (4 + z.element_size()) + n * z.element_size()),
        "flops": 0.0})[0]
    pair_ms = _median_ms(lambda: torch.index_select(
        z, 0, src.view(-1)).view(w.shape).mul_(w), PROBE_ITERS)
    offsets = torch.arange(slots, dtype=src.dtype, device=src.device)
    zt = z.view(-1, 1)

    def bag():
        return F.embedding_bag(src.view(-1), zt, offsets, mode="sum",
                               per_sample_weights=w.view(-1)).view(w.shape)

    bag_ms = _median_ms(bag, 5, warmup=1)  # ~27 ms a call on an H100
    # The same function: within one rounding of P1's plain version.
    got, ref = bag().float(), gp.gather_take_reference(z, src, w).float()
    bag_err = float((got - ref).abs().max())
    _check(bool(((got - ref).abs() <= torch.finfo(z.dtype).eps
                 * ref.abs()).all()),
           f"probe {label}: embedding_bag differs from P1's plain version "
           f"by up to {bag_err}")
    del offsets, got, ref
    out, parts = {}, []
    for kform, plain in PROBE_PAIRS:
        if kform not in ran:
            parts.append(f"{kform} {times[kform]}")
            continue
        name = pg.KERNELS[kform]
        before = gp.launches[name]
        a = pg.FORMS[kform](z, src, w)
        b = pg.FORMS[kform](z, src, w)
        ref = pg.FORMS[plain](z, src, w)
        torch.cuda.synchronize()
        _check(gp.launches[name] == before + 2,
               f"probe {label}: {name} counted {gp.launches[name] - before} "
               f"of 2 launches")
        _check(torch.equal(a, b), f"probe {label}: two {name} launches differ")
        _check(torch.equal(a, ref),
               f"probe {label}: {name} differs from its plain version")
        ms = times[kform]
        out[kform] = {"ms": ms, "plain_ms": times[plain],
                      "library_ms": bag_ms, "library_err": bag_err,
                      "index_select_ms": select_ms,
                      "index_select_bound_ms": select_bound_ms,
                      "index_select_mul_ms": pair_ms, "bound_ms": bound_ms,
                      "launches": counts[name],
                      "max_abs_err": float((a.float() - ref.float()).abs()
                                           .max()),
                      "shapes": f"z {_dt(z)}[{n}], src int32[{rows},128], "
                                f"w {_dt(w)}[{rows},128]"}
        parts.append(f"{kform} {ms:.4f} ms ({bound_ms / ms:.1%} of bound; "
                     f"plain {times[plain]:.4f} ms)")
    print(f"probe {label}: rows {rows} x 128, z {_dt(z)}[{n}]; byte bound "
          f"{bound_ms:.4f} ms; same function, embedding_bag {bag_ms:.4f} "
          f"ms ({bound_ms / bag_ms:.1%} of the bound; max diff to P1's plain "
          f"version {bag_err}), "
          f"index_select then mul {pair_ms:.4f} ms ({bound_ms / pair_ms:.1%}"
          f" of the bound); the "
          f"gather without w, index_select {select_ms:.4f} ms "
          f"({select_bound_ms / select_ms:.1%} of its own bound "
          f"{select_bound_ms:.4f} ms); "
          + "; ".join(parts) + "; each kernel torch.equal to its plain "
          "version, repeat bit-identical, launches counted")
    return out


def _k2_global_slots(eng):
    """K2's slots of ``eng`` as global indices into its flattened
    windows: (z [K*W], src int32 [rows, 128])."""
    import torch

    from pagerank_tpu_torch.ops.spmv import unpack_words24

    zw, slots, rp, pp, _, _ = eng.contrib_inputs()
    base = pp.long()[rp.long()] * zw.shape[1]
    src = (base[:, None] + unpack_words24(slots).long()).to(torch.int32)
    return zw.reshape(-1), src


def probe_sweep(gen, log_ns=(15, 20, 22, 24)):
    """Phase 7(b): :func:`_probe_point` on uniform src, 2^19 rows x 128
    slots, at each n = 2^log_n in f32 and bf16, drawn from ``gen``.
    Returns {(log_n, dtype): numbers}."""
    import torch

    rows = 1 << 19
    w32 = torch.rand((rows, 128), generator=gen, device="cuda")
    sweep = {}
    for log_n in log_ns:
        n = 1 << log_n
        src = torch.randint(0, n, (rows, 128), generator=gen, device="cuda",
                            dtype=torch.int32)
        z32 = torch.rand(n, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            sweep[log_n, dtype] = _probe_point(
                f"uniform n=2^{log_n}", z32.to(dtype), src, w32.to(dtype))
        del src, z32
    return sweep


def gather_probe_phase(k1_slots, k2_slots, step_ms):
    """Phase 7: P1-P3 on the main path's own slot arrays (K1's flat
    pack, K2's windowed pack as global indices, f32 and bf16 windows)
    beside each kernel's device time in a profiled step, then the
    uniform sweep at 2^19 rows. Returns the P1, P2, P3 records."""
    import torch

    from pagerank_tpu_torch.scripts.probe_gather import KERNELS

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)

    def weights(src, dtype):
        return torch.rand(src.shape, generator=gen, device="cuda").to(dtype)

    t0 = time.perf_counter()
    z, src = k1_slots
    at_k1 = _probe_point("on K1's slots (flat pack, rmat:22)", z, src,
                         weights(src, z.dtype))
    print(f"  K1 (profiled step) {step_ms['K1']:.4f} ms against P1 "
          f"{at_k1['probe_take']['ms']:.4f} ms and P2 "
          f"{at_k1['probe_group8']['ms']:.4f} ms on the same slots")
    for label, (z, src) in k2_slots.items():
        at = _probe_point(f"on {label}'s slots (windowed pack, rmat:22)", z,
                          src, weights(src, z.dtype))
        print(f"  {label} (profiled step) {step_ms[label]:.4f} ms "
              f"against P1 {at['probe_take']['ms']:.4f} ms and P2 "
              f"{at['probe_group8']['ms']:.4f} ms on the same slots")
    sweep = probe_sweep(gen)
    for dtype in (torch.float32, torch.bfloat16):
        _check("probe_rowsel_smem" in sweep[15, dtype],
               f"P3 did not run at n=2^15 {dtype}")
    print(f"gather probe phase took {time.perf_counter() - t0:.1f} s")
    picks = (("probe_take", at_k1), ("probe_group8", at_k1),
             ("probe_rowsel_smem", sweep[15, torch.float32]))
    return [{"name": KERNELS[k], "route": "cuda",
             "source": "pagerank_tpu_torch/csrc/gather_probe.cu",
             "replaces": PROBE_REPLACES[k], "checked": True,
             "bound_by": "bytes", **at[k]} for k, at in picks]


def _analysis(*args):
    """Start ``python -m pagerank_tpu_torch.analysis --select PTK
    --compiled --json`` with ``args``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "pagerank_tpu_torch.analysis", "--select",
         "PTK", "--compiled", "--json", *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def analysis_phase():
    """Phase 10a: the kernel-plane check with the compile facts read from
    the built libraries: the shipped registry exits 0 with no finding,
    each defect fixture exits 1 with exactly its rule. Prints every
    shipped symbol's registers, shared bytes and spills."""
    from pagerank_tpu_torch.analysis import kernels

    t0 = time.perf_counter()
    fixtures = {c.label.split(":")[1]: c for c in kernels.defect_cases()}
    procs = {"shipped": _analysis()}
    procs.update({n: _analysis("--kernel-fixture", n) for n in fixtures})
    docs = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        want = 0 if name == "shipped" else 1
        _check(proc.returncode == want,
               f"analysis --compiled {name}: exit {proc.returncode}, want "
               f"{want}\n{out[-2000:]}\n{err[-2000:]}")
        docs[name] = json.loads(out)
        _check(docs[name]["compiled"], f"analysis {name}: no compile facts")
    _check(not docs["shipped"]["findings"],
           f"shipped kernels have findings: {docs['shipped']['findings']}")
    rules = {}
    for name, case in fixtures.items():
        got = {f["rule"] for f in docs[name]["findings"]}
        want = {f.rule for f in kernels.check_kernel_case(case)}
        _check(len(want) == 1 and got == want,
               f"fixture {name}: rules {sorted(got)} with compile facts, "
               f"want exactly {sorted(want)}")
        rules[name] = got.pop()
    dyn = {}
    shipped = kernels.shipped_cases()
    for case in shipped:
        for ln in case.launches:
            dyn[ln.key] = max(dyn.get(ln.key, 0), ln.dynamic_smem)
    facts = docs["shipped"]["compile_facts"]
    print(f"kernel-plane check with compile facts (cuobjdump): "
          f"{len(shipped)} shipped cases clean over "
          f"{len(facts)} symbols; fixtures trip "
          + ", ".join(f"{n} {r}" for n, r in rules.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    for key, f in sorted(facts.items()):
        print(f"  {key}: {f['regs']} registers, {f['shared']} B static "
              f"shared, up to {dyn[key]} B dynamic, {f['local']} B local, "
              f"{f['stack']} B stack frame, launch bounds {f['max_threads']}, f64 ops "
              f"{list(f['f64_ops']) or 'none'}")
    return rules


# F1-F6: the JAX fixture's pl.pallas_call each kernel replaces.
FIXTURE_REPLACES = {
    "vmem_overflow": "pagerank_tpu/analysis/kernels.py:358",
    "misaligned_tile": "pagerank_tpu/analysis/kernels.py:371",
    "index_gap": "pagerank_tpu/analysis/kernels.py:384",
    "index_overlap": "pagerank_tpu/analysis/kernels.py:398",
    "f64_scratch": "pagerank_tpu/analysis/kernels.py:411",
    "cost_mismatch": "pagerank_tpu/analysis/kernels.py:425",
}


def _library_calls(name, args, out):
    """((label, call) of the one PyTorch call that computes fixture
    ``name``'s function on ``args``, its output allocated as the
    wrapper's is (F3: ``F.pad`` of x's tiles with a NaN tile after
    each); (label, call) of a call into a buffer made once, a copy of
    all of x for F3 and F4, whose functions differ from it)."""
    import torch
    import torch.nn.functional as F

    from pagerank_tpu_torch.ops import defect_fixtures as fx

    x = args[0]
    if name == "cost_mismatch":
        buf = torch.empty_like(out)
        return (("torch.matmul(x, y)", lambda: torch.matmul(*args)),
                ("torch.matmul(x, y, out=)",
                 lambda: torch.matmul(*args, out=buf)))
    buf = torch.empty_like(x)

    def copy():
        return buf.copy_(x)

    if name == "index_gap":
        tiles = x.view(-1, 1, *fx.TILE)
        return (("F.pad(x tiles, a NaN tile after each)",
                 lambda: F.pad(tiles, (0, 0, 0, 0, 0, 1),
                               value=float("nan")).view(-1, x.shape[1])),
                ("Tensor.copy_ of x (not F3's function)", copy))
    if name == "index_overlap":
        return (("x[-16:].clone()", lambda: x[-16:].clone()),
                ("Tensor.copy_ of all of x (not F4's function)", copy))
    return ("x.clone()", lambda: x.clone()), ("Tensor.copy_ of x", copy)


def _one_writer(got, x):
    """F4's race on the card: every element of out tiles 0 and 1 holds
    one of its writers' values (x tiles t, t + 2, ...). Returns (whether
    it does, the max distance to the nearest writer)."""
    import torch

    ok, dist = True, 0.0
    for t in range(2):
        o = got[t * 8:(t + 1) * 8]
        ws = torch.stack([x[u * 8:(u + 1) * 8]
                          for u in range(t, x.shape[0] // 8, 2)])
        ok &= bool((ws == o).any(0).all())
        dist = max(dist, float((ws - o).abs().min(0).values.max()))
    return ok, dist


def fixture_phase(rules):
    """Phase 11b: F1-F6 on the card at the JAX fixtures' shapes, the counts
    set to 0 before and read after. F1 at its geometry must be refused
    and leave no error pending; at 2^15 and at a ragged 2^15 + 1 it
    equals its plain copy. F2 and F5 equal their plain versions; F3 too,
    with NaN at exactly the elements PTK003 names; F2, F3, F4 and F6
    again at a wider shape ([300, 192], [32, 128], [64, 128], [512,
    256] x [256, 128]); an x (F6: or y) off 16 bytes must raise for
    every fixture of ``VECTOR``. F4 holds one of its writers in every
    element, at [64, 128] with NaN at exactly the PTK003 gaps; F6 is
    within 1e-5 (normalised) of an f64 matmul at both shapes and
    bit-identical on repeat. Each is timed as a wrapper call and as a
    bare launch of its bound C entry, beside its bound, its plain
    version, the one library call of the same function with its
    allocation and the preallocated call earlier yardsticks timed (also
    as the bare launches are, in turns with them); the host time (mean
    host clock a call) of the wrapper call, of the bound entry alone and
    of the library calls say what of a call is the host's, and F4's
    wrapper host time is split into its checks, its allocation and
    arguments, the entry and the rest (dispatch). Returns the
    records."""
    import torch

    from pagerank_tpu_torch.analysis import kernels
    from pagerank_tpu_torch.ops import defect_fixtures as fx

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    cases = {c.label.split(":")[1]: c for c in kernels.defect_cases()}
    inputs = {"vmem_overflow": (rnd(1 << 15),),
              "misaligned_tile": (rnd(200, 128),),
              "index_gap": (rnd(16, 128),), "index_overlap": (rnd(32, 128),),
              "f64_scratch": (rnd(16, 128),),
              "cost_mismatch": (rnd(256, 128), rnd(128, 128))}
    ragged = rnd((1 << 15) + 1)
    wide = {"misaligned_tile": (rnd(300, 192),), "index_gap": (rnd(32, 128),),
            "index_overlap": (rnd(64, 128),),
            "cost_mismatch": (rnd(512, 256), rnd(256, 128))}
    skews = {}
    for name in fx.VECTOR:
        for i, t in enumerate(inputs[name]):
            skew = torch.empty(t.numel() + 1, device="cuda")[1:].view(
                t.shape)
            skew.copy_(t)
            skews[name, i] = inputs[name][:i] + (skew,) + inputs[name][i + 1:]
    big = rnd(fx.OVERFLOW_N)
    _reset_counts()
    try:
        fx.vmem_overflow(big)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    torch.cuda.synchronize()
    pending = fx.last_error()
    off16 = {}
    for (name, i), args in skews.items():
        try:
            getattr(fx, name)(*args)
        except ValueError as e:
            off16[name, i] = str(e)
    outs = {n: getattr(fx, n)(*a) for n, a in inputs.items()}
    ragged_out = fx.vmem_overflow(ragged)
    wide_outs = {n: getattr(fx, n)(*a) for n, a in wide.items()}
    repeats = [fx.cost_mismatch(*inputs["cost_mismatch"]),
               fx.cost_mismatch(*wide["cost_mismatch"])]
    torch.cuda.synchronize()
    k1, k2, counts = _read_counts()
    del big
    _check(refused is not None, "F1 launched 32 MiB of shared memory")
    _check(pending == 0, f"F1's refusal left CUDA error {pending} pending")
    _check(set(off16) == set(skews),
           f"took an input off 16 bytes: {sorted(set(skews) - set(off16))}")
    want = {f"fx:{n}": 1 for n in inputs}
    for name in ("vmem_overflow", *wide):
        want[f"fx:{name}"] = 2
    want["fx:cost_mismatch"] += len(repeats)
    _check({k: v for k, v in counts.items() if k.startswith("fx:")} == want
           and k1 == k2 == 0
           and not any(v for k, v in counts.items()
                       if not k.startswith("fx:")),
           f"fixture launches {counts} (K1 {k1}, K2 {k2}), want {want}")
    _check(torch.equal(ragged_out, ragged),
           f"F1 at the ragged [{ragged.numel()}] differs from its plain copy")
    print(f"F1 at its geometry (x f32 [{fx.OVERFLOW_N}], "
          f"{fx.OVERFLOW_N * 4} B of shared memory; the checker says "
          f"{rules['vmem_overflow']}) refused: {refused}; no error pending "
          f"after it; at [{1 << 15}] and the ragged [{ragged.numel()}] "
          f"equal to its plain copy; an input off 16 bytes refused by "
          + ", ".join(sorted({n for n, _ in off16}))
          + f": {off16['cost_mismatch', 1]}")

    def gap_nan(name, got, x):
        """``got`` NaN at exactly the gaps PTK003 names at x's shape."""
        nan = torch.zeros(got.numel(), dtype=torch.bool, device="cuda")
        for a, b in kernels.write_gaps(
                kernels.defect_case(name, tuple(x.shape)), "out"):
            nan[a:b] = True
        _check(torch.equal(got.reshape(-1).isnan(), nan),
               f"{name} at {list(x.shape)}: NaN elements differ from the "
               f"gaps PTK003 names")

    def same(name, got, x):
        """``got`` equal to the plain version on ``x`` bit for bit where
        it is a number, NaN where it is NaN; F3's NaN at exactly the
        gaps PTK003 names at x's shape."""
        ref = getattr(fx, f"{name}_reference")(x)
        _check(got.shape == ref.shape and torch.equal(
            torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(ref, nan=-1.0))
            and torch.equal(got.isnan(), ref.isnan()),
            f"{name} at {list(x.shape)} differs from its plain version")
        if name == "index_gap":
            gap_nan(name, got, x)

    def matmul_err(got, x, y):
        exact = x.double() @ y.double()
        err = float((got.double() - exact).abs().max())
        _check(err <= 1e-5 * float(exact.abs().max()),
               f"F6 at {list(x.shape)} x {list(y.shape)}: max error {err} "
               f"vs the f64 matmul")
        return err

    errs = {}
    for name, args in wide.items():
        if name == "index_overlap":
            ok, dist = _one_writer(wide_outs[name], args[0])
            _check(ok, f"F4 at {list(args[0].shape)}: an element holds "
                       f"none of its writers")
            gap_nan(name, wide_outs[name], args[0])
            errs["index_overlap wide"] = dist
        elif name == "cost_mismatch":
            errs["cost_mismatch wide"] = matmul_err(wide_outs[name], *args)
            _check(torch.equal(repeats[1], wide_outs[name]),
                   "F6: two launches at the wide shape differ")
        else:
            same(name, wide_outs[name], args[0])
    for name, args in inputs.items():
        got = outs[name]
        if name == "index_overlap":
            ok, errs[name] = _one_writer(got, args[0])
            _check(ok, "F4: an element holds neither writer")
        elif name == "cost_mismatch":
            errs[name] = matmul_err(got, *args)
            _check(torch.equal(repeats[0], got),
                   "F6: two launches at the fixture's shape differ")
        else:
            same(name, got, args[0])
            errs[name] = 0.0
    f4_gaps = kernels.write_gaps(
        kernels.defect_case("index_overlap", tuple(wide["index_overlap"][0]
                                                   .shape)), "out")
    print("F2, F3 (NaN at exactly the PTK003 gaps "
          f"{kernels.write_gaps(cases['index_gap'], 'out')}) and F5 equal "
          f"their plain versions, F2 and F3 also at "
          + " and ".join(f"{list(wide[n][0].shape)}"
                         for n in ("misaligned_tile", "index_gap"))
          + f"; F4 holds one writer per element (max distance to the "
          f"nearer writer {errs['index_overlap']}; at "
          f"{list(wide['index_overlap'][0].shape)} "
          f"{errs['index_overlap wide']}, NaN at exactly the PTK003 gaps "
          f"{f4_gaps}); "
          f"F6 max abs error {errs['cost_mismatch']:.3e} vs an f64 matmul, "
          f"{errs['cost_mismatch wide']:.3e} at "
          f"{list(wide['cost_mismatch'][0].shape)} x "
          f"{list(wide['cost_mismatch'][1].shape)}, each bit-identical "
          f"on repeat")
    # The bare launches: each fixture's bound C entry, 50 launches
    # between two events, median of 7 rounds, in turns with each other
    # and with the preallocated library calls; and the bound entry's
    # host clock alone (the wrapper's less it: the checks, the
    # allocation and the dispatch).
    bound = {n: fx.bind(n, *a) for n, a in inputs.items()}
    libs = {n: _library_calls(n, a, outs[n]) for n, a in inputs.items()}
    bare = _launch_ms({**bound, **{f"lib:{n}": pre
                                   for n, (_, (_, pre)) in libs.items()}})
    bare_host = {n: _host_ms(fn) for n, fn in bound.items()}
    # Each same-function library call computes its fixture's function:
    # equal to the plain version (NaN where it is NaN), F6's within the
    # gate of the f64 matmul.
    for name, args in inputs.items():
        got = libs[name][0][1]()
        if name == "cost_mismatch":
            matmul_err(got, *args)
        else:
            same(name, got, args[0])
    print("each same-function library call equals its fixture's plain "
          "version (F6's within 1e-5 of the f64 matmul): "
          + ", ".join(libs[n][0][0] for n in inputs))
    torch.cuda.synchronize()
    records = []
    for name, args in inputs.items():
        fn = getattr(fx, name)
        ref = getattr(fx, f"{name}_reference")
        (same_name, same_fn), (pre_name, prealloc) = libs[name]
        before = fx.launches[name]
        ms = _median_ms(lambda: fn(*args), 30)
        timed = fx.launches[name] - before
        plain_ms = _median_ms(lambda: ref(*args), 30)
        library_ms = _median_ms(same_fn, 30)
        prealloc_ms = _median_ms(prealloc, 30)
        # What a call costs the host before the card sees its launch.
        host_ms = _host_ms(lambda: fn(*args))
        library_host_ms = _host_ms(same_fn)
        prealloc_host_ms = _host_ms(prealloc)
        split = None
        if name == "index_overlap":
            x = args[0]
            check_ms = _host_ms(lambda: (
                fx._check(name, x),
                fx._rows_of(name, x, 2 * fx.TILE[0], least=2)))
            alloc_ms = _host_ms(lambda: fx._launch_args(name, x))
            split = {"check_ms": check_ms, "alloc_args_ms": alloc_ms,
                     "entry_ms": bare_host[name],
                     "dispatch_ms": host_ms - check_ms - alloc_ms
                     - bare_host[name]}
        torch.cuda.synchronize()
        # Each input read once and the output written once; F6 also its
        # 2mkn FLOPs three times on the tensor cores in TF32 (3xTF32).
        cost = {"bytes": float(sum(a.numel() for a in args)
                               + outs[name].numel()) * 4,
                "flops": 0.0,
                "tf32_flops": (3 * 2.0 * args[0].shape[0] * args[0].shape[1]
                               * args[1].shape[1]
                               if name == "cost_mismatch" else 0.0)}
        bound_ms, bound_by = _bound_ms(cost)
        fill = ("its NaN fill included" if fx.leaves_gaps(
            name, args[0].shape[0]) else "no NaN fill")
        same_txt = (f"{same_name} {library_ms:.4f} ms (host "
                    f"{library_host_ms:.4f} ms)")
        print(f"F {name}: {ms:.4f} ms a wrapper call ({fill}; {timed} "
              f"launches timed; host {host_ms:.4f} ms), bare launch "
              f"{bare[name]:.4f} ms (host {bare_host[name]:.4f} ms), "
              f"plain {plain_ms:.4f} ms; same function: {same_txt}; "
              f"preallocated {pre_name} {prealloc_ms:.4f} ms (host "
              f"{prealloc_host_ms:.4f} ms; 50 back to back "
              f"{bare[f'lib:{name}']:.4f} ms); {bound_by} bound "
              f"{bound_ms:.6f} ms ({int(cost['bytes'])} B, "
              f"{int(cost['tf32_flops'])} TF32 FLOP)")
        if split:
            print(f"  F {name} wrapper host {host_ms:.4f} ms = checks "
                  f"{split['check_ms']:.4f} + allocation and arguments "
                  f"{split['alloc_args_ms']:.4f} + the bound entry "
                  f"{split['entry_ms']:.4f} + dispatch (device, stream, "
                  f"count) {split['dispatch_ms']:.4f}")
        records.append({
            "name": f"fx_{name}", "route": "cuda",
            "source": "pagerank_tpu_torch/csrc/defect_fixtures.cu",
            "replaces": FIXTURE_REPLACES[name], "checked": True,
            "launches": counts[f"fx:{name}"], "max_abs_err": errs[name],
            "ms": ms, "bare_ms": bare[name], "host_ms": host_ms,
            "bare_host_ms": bare_host[name],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_host_ms": library_host_ms,
            "library_call": same_name,
            "prealloc_ms": prealloc_ms, "prealloc_host_ms": prealloc_host_ms,
            "prealloc_bare_ms": bare[f"lib:{name}"],
            "prealloc_call": pre_name,
            **({"host_split": split} if split else {}),
            "rule": rules[name],
            "shapes": ", ".join(f"{_dt(a)}{list(a.shape)}" for a in args)})
    seconds = time.perf_counter() - t0
    records[0]["phase_s"] = seconds
    print(f"phase 11b (F1-F6 on the card) took {seconds:.1f} s")
    return records


def resume_determinism(scale, tmp, extra=()):
    """Phase 8: 6 iterations + resume to 10 == 10 uninterrupted, through
    the CLI with ``extra`` flags."""
    import numpy as np

    from pagerank_tpu_torch import cli

    base = ["--synthetic", f"rmat:{scale}", "--dtype", "float32", *extra]
    tag = "-".join(extra) or "flat"
    cut = os.path.join(tmp, f"cut{tag}")
    ctrl = os.path.join(tmp, f"ctrl{tag}")
    _reset_counts()
    cli.run(base + ["--iters", "6", "--snapshot-dir", cut])
    s = cli.run(base + ["--iters", str(ITERS), "--snapshot-dir", cut,
                        "--resume"])
    _check(s["resumed_from"] == 6, f"resumed from {s['resumed_from']}, not 6")
    cli.run(base + ["--iters", str(ITERS), "--snapshot-dir", ctrl])
    k1, k2, probe = _read_counts()
    steps = 6 + (ITERS - 6) + ITERS
    want = (steps, 0) if s["form"] == "flat_ell" else (0, steps)
    _check((k1, k2) == want and not any(probe.values()),
           f"resume rmat:{scale} {' '.join(extra)}: K1 {k1}, K2 {k2} "
           f"launches in {steps} steps (want {want})")
    a = np.load(os.path.join(cut, f"ranks_iter{ITERS}.npz"))["ranks"]
    b = np.load(os.path.join(ctrl, f"ranks_iter{ITERS}.npz"))["ranks"]
    _check(np.array_equal(a, b), "resumed run differs from uninterrupted")
    print(f"resume rmat:{scale} {' '.join(extra)} ({s['form']}, span "
          f"{s['partition_span']}, K={s['partitions']}): 6 + resume to "
          f"{ITERS} is bit-equal to an uninterrupted {ITERS}; K1 {k1} K2 "
          f"{k2} launches in {steps} steps")
    return s["form"]


def coo_resume_determinism(scale, tmp):
    """Phase 8 for the coo form: 6 iterations + resume to 10 == 10
    uninterrupted, through ``TorchEngine(kernel="coo")`` and the
    snapshot API, on the CLI's ``--synthetic rmat:SCALE`` graph."""
    import numpy as np

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, build_graph
    from pagerank_tpu_torch.utils import synth
    from pagerank_tpu_torch.utils.snapshot import Snapshotter, resume_engine

    src, dst = synth.rmat_edges(scale)
    graph = build_graph(src, dst, n=1 << scale)
    del src, dst

    def solve(iters, directory, resume=False):
        cfg = PageRankConfig(num_iters=iters, dtype="float32",
                             accum_dtype="float32", kernel="coo")
        eng = TorchEngine(cfg, device="cuda").build(graph)
        snap = Snapshotter(directory, graph.fingerprint(), cfg.semantics,
                           mesh_meta=eng.snapshot_meta())
        resumed = resume_engine(eng, snap) if resume else 0
        eng.run(on_iteration=lambda i, info: snap.save(i + 1, eng.ranks()),
                snapshotter=snap)
        _check(eng.layout_info()["form"] == "coo" and eng.iteration == iters
               and eng.device.type == "cuda",
               f"coo resume: form {eng.layout_info()['form']}, "
               f"{eng.iteration} steps on {eng.device}")
        return resumed

    cut = os.path.join(tmp, "cut-coo")
    ctrl = os.path.join(tmp, "ctrl-coo")
    _reset_counts()
    solve(6, cut)
    resumed = solve(ITERS, cut, resume=True)
    _check(resumed == 6, f"coo: resumed from {resumed}, not 6")
    solve(ITERS, ctrl)
    k1, k2, probe = _read_counts()
    _check(k1 == 0 and k2 == 0 and not any(probe.values()),
           f"coo resume rmat:{scale}: K1 {k1}, K2 {k2}, probes {probe} "
           f"(want none)")
    a = np.load(os.path.join(cut, f"ranks_iter{ITERS}.npz"))["ranks"]
    b = np.load(os.path.join(ctrl, f"ranks_iter{ITERS}.npz"))["ranks"]
    _check(np.array_equal(a, b), "coo: resumed run differs from "
           "uninterrupted")
    print(f"resume rmat:{scale} coo (TorchEngine(kernel=\"coo\") + "
          f"Snapshotter/resume_engine, {graph.num_edges} dst-sorted edges): "
          f"6 + resume to {ITERS} is bit-equal to an uninterrupted "
          f"{ITERS}; K1 0 K2 0 launches in {6 + (ITERS - 6) + ITERS} steps")


def _host_facts_line():
    from pagerank_tpu_torch.scripts.host_ingest_bench import host_facts, rss_gb

    f = host_facts()
    print(f"host: numpy {f['numpy']}, os.cpu_count() {f['cpu_count']}, "
          f"usable cores {f['usable_cores']}, MemAvailable "
          f"{f['mem_available_gb']:.3f} GB, peak RSS so far {rss_gb():.3f} GB")


# The crawl job: the reference's segment shape (Sparky.java:44-58), cut
# from its 301 files to 101 to hold the script inside its time limit
# (phase 9 took 190-259 s at 301 files on the card's host).
CRAWL_FILES = 101
CRAWL_RECORDS = 10_000
CRAWL_SEED = 23
CRAWL_SPAN = 1 << 20  # K = 2 partitions on the segment's 1.66M vertices


def _graph_digest(graph):
    """sha256 of every array field of a graph and of its names."""
    import hashlib

    d = {f: hashlib.sha256(getattr(graph, f).tobytes()).hexdigest()
         for f in ("src", "dst", "out_degree", "in_degree", "dangling_mask",
                   "zero_in_mask", "edge_weight")}
    d["n"] = graph.n
    if graph.vertex_names is not None:
        d["names"] = hashlib.sha256("\n".join(graph.vertex_names).encode(
            "utf-8", "surrogatepass")).hexdigest()
    return d


def _stage_line(label, s):
    bs = s["engine"].layout_info()["build_seconds"]
    ms = statistics.median(s["step_seconds"]) * 1e3
    saves = (f", snapshot save median {statistics.median(s['snapshot_seconds']) * 1e3:.3f} ms "
             f"(max {max(s['snapshot_seconds']) * 1e3:.3f})"
             if s["snapshot_seconds"] else "")
    out = (f", --out write {s['out_seconds']:.3f} s"
           if s["out_seconds"] is not None else "")
    threads = (f" on {s['ingest_threads']} threads"
               if s["ingest_threads"] else "")
    print(f"{label} stages: ingest ({s['ingest_route']}{threads}) "
          f"{s['input_seconds']:.3f} s, build_graph ({s['sort_route']} sort) "
          f"{s['graph_seconds']:.3f} s, pack {bs['pack']:.3f} s, planes + "
          f"plans {bs['plan']:.3f} s, placement {bs['place']:.3f} s, solve "
          f"median {ms:.3f} ms/iter "
          f"{s['graph'].num_edges / (ms / 1e3):.6g} edges/s{saves}{out}")


def crawl_phase(tmp):
    """Phase 9: the crawl job through ``cli.run`` on cuda: a 101-file
    block-compressed segment ingested (native route unless the card's
    host cannot build the crawl L1), solved flat through K1 and at span
    2^21 through K2, each within 1e-4 (mass-normalised L1) of the f64
    oracle; --top/--out, --jsonl and snapshots checked; the out-of-core
    build field-identical with bit-equal ranks; the native and the
    serial Python routes bit-equal on the first 10 files."""
    import numpy as np

    from pagerank_tpu_torch import PageRankConfig, ReferenceCpuEngine, cli
    from pagerank_tpu_torch.ingest import native
    from pagerank_tpu_torch.ingest.edgelist import save_binary_edges
    from pagerank_tpu_torch.ingest.seqfile import load_crawl_seqfile_routed
    from pagerank_tpu_torch.utils.metrics import oracle_l1
    from pagerank_tpu_torch.utils.synth import crawl_segment

    t_phase = time.perf_counter()
    seg = os.path.join(tmp, "segment")
    t0 = time.perf_counter()
    made = crawl_segment(seg, files=CRAWL_FILES, per_file=CRAWL_RECORDS,
                         seed=CRAWL_SEED, compression="block")
    print(f"crawl segment: {made['files']} block-compressed SequenceFiles "
          f"(metadata-%05d) x {CRAWL_RECORDS} records, {made['links']:,} "
          f"links, {made['bytes']:,} B written in "
          f"{time.perf_counter() - t0:.3f} s")
    want_route, crawl_input = "native", ["--input", seg]
    if not native.available("crawl_ingest"):
        # The serial Python parser: no fork once CUDA is up.
        want_route, crawl_input = "python", ["--input", seg,
                                             "--ingest-workers", "1"]
        print(f"the native crawl L1 does not build on this host "
              f"({native.build_error('crawl_ingest')}): the crawl job runs "
              f"the Python route")
    snaps = os.path.join(tmp, "crawl_snaps")
    jsonl = os.path.join(tmp, "crawl.jsonl")
    out = os.path.join(tmp, "crawl_top.tsv")
    _reset_counts()
    s = cli.run(crawl_input + ["--iters", str(ITERS), "--snapshot-dir",
                 snaps, "--snapshot-every", "1", "--jsonl", jsonl,
                 "--log-every", "0", "--top", "1000", "--out", out])
    k1, k2, probe = _read_counts()
    graph, ranks = s["graph"], s["ranks"]
    _check(s["engine"].device.type == "cuda" and s["form"] == "flat_ell",
           f"crawl job ran {s['form']} on {s['engine'].device}")
    _check(k1 == ITERS == s["iterations"] and k2 == 0
           and not any(probe.values()),
           f"crawl job: ell_contrib launched {k1} times "
           f"(ell_contrib_partitioned {k2}, the probe kernels {probe}) in "
           f"{s['iterations']} steps")
    _check(s["format"] == "seqfile" and s["ingest_route"] == want_route,
           f"crawl job: format {s['format']}, ingest route "
           f"{s['ingest_route']} (want seqfile, {want_route})")
    crawled = int((~graph.dangling_mask).sum())
    dangling = int(graph.dangling_mask.sum())
    zero_out = int((graph.out_degree == 0).sum())
    _check(crawled == CRAWL_FILES * CRAWL_RECORDS
           and crawled + dangling == graph.n and dangling != zero_out,
           f"crawl job: {crawled} crawled, {dangling} dangling, {zero_out} "
           f"with out-degree 0 of n={graph.n}")
    _check(ranks.shape == (graph.n,) and np.isfinite(ranks).all(),
           "crawl job: ranks are not finite of shape (n,)")
    t0 = time.perf_counter()
    oracle = ReferenceCpuEngine(PageRankConfig(num_iters=ITERS)).build(
        graph).run()
    oracle_s = time.perf_counter() - t0
    raw_l1, norm_l1, mass_l1 = oracle_l1(ranks, oracle)
    _check(mass_l1 <= 1e-4, f"crawl job vs the f64 oracle: mass-normalised "
           f"L1 {mass_l1} > 1e-4")
    names = graph.vertex_names
    order = np.lexsort((np.arange(graph.n), -ranks))[:1000]
    with open(out) as f:
        lines = f.read().splitlines()
    want = [f"{names[i]}\t{float(ranks[i])!r}" for i in order]
    _check(lines == want, "crawl job: --out is not the top 1000 by (rank "
           "desc, id asc) keyed by URL")
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    _check(len(recs) == ITERS and [r["iter"] for r in recs]
           == list(range(ITERS)), f"crawl job: {len(recs)} JSONL records")
    have = sorted(int(re.match(r"ranks_iter(\d+)\.npz$", f).group(1))
                  for f in os.listdir(snaps) if f.endswith(".npz"))
    _check(have == list(range(1, ITERS + 1)),
           f"crawl job: snapshots at iterations {have}")
    last = np.load(os.path.join(snaps, f"ranks_iter{ITERS}.npz"))["ranks"]
    _check(np.array_equal(last, ranks), "crawl job: last snapshot != ranks")
    print(f"crawl job: n={graph.n} edges={graph.num_edges} crawled={crawled} "
          f"dangling (uncrawled targets)={dangling} out-degree 0={zero_out}; "
          f"K1 launches {k1} in {ITERS} steps, f64 oracle mass-normalised L1 "
          f"{mass_l1:.3e} (normalised {norm_l1:.3e}; oracle {oracle_s:.1f} s)")
    _stage_line("crawl job", s)
    digest = _graph_digest(graph)
    fingerprint = graph.fingerprint()
    flat_ranks, flat_rows = ranks, s["num_rows"]
    del s, graph, ranks, names, order, want

    # The same segment, partition-centric at CRAWL_SPAN.
    parts = -(-digest["n"] // CRAWL_SPAN)
    _reset_counts()
    s = cli.run(crawl_input + ["--iters", str(ITERS), "--partition-span",
                               str(CRAWL_SPAN), "--log-every", "0"])
    k1, k2, probe = _read_counts()
    _check(s["graph"].fingerprint() == fingerprint,
           "partitioned crawl run built another graph")
    _check(s["form"] == "pallas_partitioned" and s["partitions"] == parts,
           f"partitioned crawl run: {s['form']}, K={s['partitions']} "
           f"(want {parts})")
    _check(k2 == ITERS == s["iterations"] and k1 == 0
           and not any(probe.values()),
           f"partitioned crawl run: ell_contrib_partitioned launched {k2} "
           f"times (ell_contrib {k1}, the probe kernels {probe})")
    part_l1 = oracle_l1(s["ranks"], oracle)[2]
    _check(part_l1 <= 1e-4, f"partitioned crawl run vs the f64 oracle: "
           f"mass-normalised L1 {part_l1} > 1e-4")
    print(f"crawl job partitioned: span {s['partition_span']} K="
          f"{s['partitions']}, K2 launches {k2} in {ITERS} steps, f64 oracle "
          f"mass-normalised L1 {part_l1:.3e}")
    _stage_line("crawl job partitioned", s)
    if want_route != "native":
        # The crawl drain needs the native L1: hold the out-of-core
        # build on the crawl graph's edges saved as .npz instead.
        g = s["graph"]
        ooc_input = os.path.join(tmp, "crawl_edges.npz")
        save_binary_edges(ooc_input, g.src, g.dst, n=g.n)
        del g
    del s

    # Out-of-core: the same job under a 0.25 GiB working-memory cap.
    ooc = crawl_input if want_route == "native" else ["--input", ooc_input]
    _reset_counts()
    s = cli.run(ooc + ["--iters", str(ITERS), "--host-mem-cap-gb", "0.25",
                       "--log-every", "0"])
    k1, _, _ = _read_counts()
    if want_route == "native":
        same = _graph_digest(s["graph"]) == digest
        ranks_equal = np.array_equal(s["ranks"], flat_ranks)
    else:  # no names and no crawl mask on an .npz input
        g = s["graph"]
        same = all(_graph_digest(g)[f] == digest[f] for f in ("src", "dst"))
        ranks_equal = True
    _check(s["sort_route"] == "external" and same and ranks_equal
           and k1 == ITERS,
           f"out-of-core crawl build: sort {s['sort_route']}, field-identical "
           f"{same}, ranks bit-equal {ranks_equal}, K1 launches {k1}")
    held = ("every graph field identical to the in-memory build, ranks "
            "bit-equal" if want_route == "native" else "src and dst "
            "identical to the in-memory build (its edges as .npz)")
    print(f"crawl job out-of-core (--host-mem-cap-gb 0.25, {s['ingest_route']}"
          f" ingest + external sort {s['input_seconds']:.3f} s): {held}")
    del s

    # Route parity on the first 10 files: native threads against the
    # serial Python parser (no fork: CUDA is up).
    first = ",".join(os.path.join(seg, f"metadata-{i:05d}")
                     for i in range(10))
    runs = {}
    for label, kw in (("native", {"native": "auto"}),
                      ("python", {"native": "off", "workers": 1})):
        if label == "native" and want_route != "native":
            continue
        t0 = time.perf_counter()
        (src, dst, crawled_mask, ids), route = load_crawl_seqfile_routed(
            first, raw=True, **kw)
        _check(route == label, f"asked for the {label} route, ran {route}")
        runs[label] = (src, dst, crawled_mask, ids.names,
                       time.perf_counter() - t0)
    if len(runs) == 2:
        a, b = runs["native"], runs["python"]
        _check(all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
               and a[3] == b[3], "native and Python routes differ on the "
               "first 10 files")
        print(f"crawl route parity, first 10 files: native ({a[4]:.3f} s) "
              f"and serial Python ({b[4]:.3f} s) bit-equal in src, dst, "
              f"crawled mask and names ({len(a[0]):,} raw edges, "
              f"{len(a[3]):,} vertices)")
    print(f"crawl phase took {time.perf_counter() - t_phase:.1f} s")
    return {"input": crawl_input, "oracle": oracle, "ranks": flat_ranks,
            "rows": flat_rows}


def _peak_gb(base):
    """Peak device memory since the last reset, above ``base`` bytes."""
    import torch

    return (torch.cuda.max_memory_allocated() - base) / 1e9


def _device_stages(s):
    """A cli.run summary's device-build line: generation or ingest,
    upload, the four build stages, the engine's plans and placement."""
    d = s["device_build_seconds"]
    bs = s["engine"].layout_info()["build_seconds"]
    up = (f"upload {s['upload_seconds']:.3f} s, "
          if s["upload_seconds"] is not None else "")
    return (f"{s['ingest_route']} input {s['input_seconds']:.3f} s, {up}"
            f"device build {s['graph_seconds']:.3f} s (relabel "
            f"{d['relabel_s']:.3f}, sort {d['sort_s']:.3f}, slots "
            f"{d['slots_s']:.3f}, scatter {d['scatter_s']:.3f}), plans "
            f"{bs['plan']:.3f} s, placement {bs['place']:.3f} s")


def _parity(label, dg, cfg, host):
    """10(a) for one form: a TorchEngine built from ``dg`` on the card
    has the host-built engine's planes (torch.equal, kernel inputs and
    perm) and its ranks, bit for bit."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import TorchEngine

    eng = TorchEngine(cfg, device=dg.device).build_device(dg)
    _check(np.array_equal(eng._perm, host["perm"]), f"{label}: perm differs")
    _check(eng._arrays.keys() == host["arrays"].keys() and all(
        torch.equal(eng._arrays[k], host["arrays"][k]) for k in eng._arrays),
        f"{label}: the device-built planes differ from the host pack's")
    _reset_counts()
    ranks = eng.run()
    k1, k2, _ = _read_counts()
    want = (ITERS, 0) if not cfg.partition_span else (0, ITERS)
    _check((k1, k2) == want, f"{label}: launches K1 {k1} K2 {k2}, want {want}")
    _check(np.array_equal(ranks, host["ranks"]),
           f"{label}: ranks are not bit-equal to the host-built run's")
    return eng


def _plain_pagerank(src, dst, n):
    """An independent plain f64 PageRank (reference semantics, ITERS
    steps, ReferenceCpuEngine's update) on the device of the raw edges
    ``src``/``dst``: dedup by torch.unique, degrees by bincount, each
    step's A^T r by one index_add_; nothing of the port's pack, plans
    or kernels. Returns the host ranks, the unique edge count and the
    host out-degrees."""
    import torch

    from pagerank_tpu_torch import PageRankConfig

    d = PageRankConfig().damping
    key = torch.unique(src.to(torch.int64) * n + dst)
    s, t = key // n, key % n
    del key
    out = torch.bincount(s, minlength=n)
    zero_in = (torch.bincount(t, minlength=n) == 0).double()
    dangling = out == 0
    w = 1.0 / out[s].double()
    r = torch.ones(n, dtype=torch.float64, device=src.device)
    for _ in range(ITERS):
        contrib = torch.zeros_like(r).index_add_(0, t, r[s] * w)
        r = (1.0 - d) + d * (contrib + zero_in * r + r[dangling].sum() / n)
    return r.cpu().numpy(), s.numel(), out.cpu().numpy()


#: Phase 10(e)'s R-MAT scale: the first solve past L2.
BIG_SCALE = 24


def device_build_phase(scale, resume_scale, tmp, flat, part, crawl):
    """Phase 10: the graph built on the card (ops/device_build.py,
    TorchEngine.build_device, --device-build); see the module docstring."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import (PageRankConfig, ReferenceCpuEngine,
                                    build_graph, cli)
    from pagerank_tpu_torch.ops import device_build as db
    from pagerank_tpu_torch.utils.metrics import oracle_l1

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")

    # (a) The host edges of phase 3 (deduplicated) uploaded and built on
    # the card, flat and at phase 5's span: the host pack's planes and
    # the host-built ranks, bit for bit.
    g = flat["graph"]
    t0 = time.perf_counter()
    src = torch.from_numpy(g.src).to(cuda)
    dst = torch.from_numpy(g.dst).to(cuda)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    builds, splits = {}, {}
    for label, stripe in (("flat", 0), ("span", part["span"])):
        splits[label] = {}
        builds[label] = db.build_ell_device(src, dst, g.n, stripe_size=stripe,
                                            with_weights=False,
                                            timings=splits[label])
    del src, dst
    dg = builds["flat"]
    rows = {k: b.num_rows for k, b in builds.items()}
    _check(torch.equal(dg.src, flat["arrays"]["src"])
           and torch.equal(dg.row_block, flat["arrays"]["row_block"]),
           "device build: flat slots/row blocks differ from the host pack")
    # (c, restore) checkpoint_arrays -> restore_device_graph on the card
    t0 = time.perf_counter()
    restored = db.restore_device_graph(*db.checkpoint_arrays(dg),
                                       device=cuda)
    ck_s = time.perf_counter() - t0
    _check(restored.fingerprint() == dg.fingerprint(),
           "restored device graph: another fingerprint")
    cfg = PageRankConfig(num_iters=ITERS)
    _parity("device build flat (host edges)", dg, cfg, flat)
    _parity("restored device graph", restored, cfg, flat)
    del restored
    _parity(f"device build span {part['span']} (host edges)",
            builds["span"], cfg.replace(partition_span=part["span"]), part)
    split = {k: ", ".join(f"{n[:-2]} {v:.3f}" for n, v in t.items())
             for k, t in splits.items()}
    print(f"device build of phase 3's {g.num_edges:,} host edges (upload "
          f"{up_s:.3f} s): flat {rows['flat']:,} rows ({split['flat']} s) "
          f"and span {part['span']:,} {rows['span']:,} rows "
          f"({split['span']} s), planes torch.equal to the host pack's, "
          f"ranks bit-equal to phase 3's K1 and phase 5's K2; checkpoint -> "
          f"restore on the card {ck_s:.3f} s, fingerprint {dg.fingerprint()} "
          f"kept, ranks bit-equal")
    del builds, dg, g, flat, part

    # (b) From a seed: the CLI with --device-build, flat with snapshots
    # and --out, then at --partition-span -1, against the f64 oracle of
    # the same generated edges (copied to the host before the build).
    t0 = time.perf_counter()
    src, dst = db.rmat_edges_device(scale, device=cuda)
    hs, hd = src.cpu().numpy(), dst.cpu().numpy()
    g = build_graph(hs, hd, n=1 << scale)
    # The host pack's rows: a device build of the deduplicated edges is
    # the host pack (tests/test_torch_device_build.py).
    host_rows = db.build_ell_device(torch.from_numpy(g.src).to(cuda),
                                    torch.from_numpy(g.dst).to(cuda), g.n,
                                    with_weights=False).num_rows
    oracle = ReferenceCpuEngine(PageRankConfig(num_iters=ITERS)).build(
        g).run()
    t_oracle = time.perf_counter() - t0
    # (e)'s plain f64 PageRank on the card, held here to the f64 oracle.
    t0 = time.perf_counter()
    plain, plain_edges, plain_out = _plain_pagerank(src, dst, g.n)
    t_plain = time.perf_counter() - t0
    del src, dst, hs, hd
    plain_l1 = oracle_l1(plain, oracle)[1]
    _check(plain_edges == g.num_edges
           and np.array_equal(plain_out, g.out_degree)
           and plain_l1 <= 1e-12, f"the plain f64 PageRank on the card: "
           f"{plain_edges} edges, normalised L1 {plain_l1} to the oracle")
    print(f"seed rmat:{scale} on the card: {16 << scale:,} raw edges, "
          f"{g.num_edges:,} unique; host pack {host_rows:,} rows; the f64 "
          f"oracle took {t_oracle:.1f} s; the plain f64 PageRank on the "
          f"card {t_plain:.3f} s, normalised L1 {plain_l1:.3e} to it")
    snaps = os.path.join(tmp, "dev_snaps")
    out = os.path.join(tmp, "dev_ranks.tsv")
    for extra in ((), ("--partition-span", "-1")):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        flags = (["--snapshot-dir", snaps, "--out", out] if not extra
                 else ["--log-every", "0"])
        s = cli.run(["--synthetic", f"rmat:{scale}", "--device-build",
                     "--iters", str(ITERS), "--dtype", "float32",
                     *extra, *flags])
        k1, k2, probe = _read_counts()
        peak = _peak_gb(base)
        dg, ranks = s["graph"], s["ranks"]
        want = (ITERS, 0) if not extra else (0, ITERS)
        label = f"--device-build rmat:{scale} {' '.join(extra) or 'flat'}"
        _check((k1, k2) == want and not any(probe.values()),
               f"{label}: K1 {k1}, K2 {k2} launches (want {want}), probe "
               f"{probe}")
        _check(s["sort_route"] == "device" and dg.num_edges == g.num_edges
               and np.array_equal(dg.out_degree.cpu().numpy(), g.out_degree),
               f"{label}: not the generated graph ({dg.num_edges} edges)")
        l1 = oracle_l1(ranks, oracle)[1]
        _check(l1 <= 1e-4, f"{label}: normalised L1 {l1} > 1e-4")
        if not extra:
            last = np.load(os.path.join(snaps, f"ranks_iter{ITERS}.npz"))
            _check(np.array_equal(last["ranks"], ranks)
                   and last["fingerprint"].astype(str).item()
                   == dg.fingerprint(), f"{label}: last snapshot")
            with open(out) as f:
                _check(sum(1 for _ in f) == g.n, f"{label}: --out lines")
        else:
            _check(s["form"] == "pallas_partitioned",
                   f"{label}: ran {s['form']}")
        ms = statistics.median(s["step_seconds"]) * 1e3
        print(f"{label}: {s['form']}, span {s['partition_span']:,} K="
              f"{s['partitions']}, {s['num_rows']:,} slot rows "
              f"({s['num_rows'] / host_rows:.4f}x the host pack's "
              f"{host_rows:,}); {_device_stages(s)}; peak device memory "
              f"{peak:.3f} GB; {ms:.3f} ms/iter "
              f"{g.num_edges / (ms / 1e3):.6g} edges/s; K1 {k1} K2 {k2}; "
              f"f64 oracle normalised L1 {l1:.3e}")
        del s, dg, ranks
    del g, oracle

    # (c) Resume through the CLI with --device-build, both forms.
    resume_determinism(resume_scale, tmp, ("--device-build",))
    form = resume_determinism(resume_scale, tmp, ("--device-build",
                                                  "--partition-span", "-1"))
    _check(form == "pallas_partitioned", f"--device-build --partition-span "
           f"-1 at rmat:{resume_scale} ran {form}")

    # (d) The crawl segment of phase 9, flat, built on the card.
    _reset_counts()
    s = cli.run(crawl["input"] + ["--device-build", "--iters", str(ITERS),
                                  "--log-every", "0"])
    k1, k2, _ = _read_counts()
    _check((k1, k2) == (ITERS, 0) and s["format"] == "seqfile",
           f"crawl --device-build: K1 {k1} K2 {k2}, format {s['format']}")
    mass_l1 = oracle_l1(s["ranks"], crawl["oracle"])[2]
    _check(mass_l1 <= 1e-4, f"crawl --device-build vs the f64 oracle: "
           f"mass-normalised L1 {mass_l1} > 1e-4")
    vs_host = oracle_l1(s["ranks"], crawl["ranks"])[2]
    ms = statistics.median(s["step_seconds"]) * 1e3
    print(f"crawl job --device-build: {s['num_rows']:,} slot rows "
          f"({s['num_rows'] / crawl['rows']:.4f}x the host pack's "
          f"{crawl['rows']:,}); "
          f"{_device_stages(s)}; {ms:.3f} ms/iter; K1 {k1}; f64 oracle "
          f"mass-normalised L1 {mass_l1:.3e}, against the host-built run "
          f"{vs_host:.3e}")
    del s

    # (e) rmat:24 flat from a seed (past L2): K1 at this path's own
    # slots and plan against its plain version, and the ranks against a
    # plain f64 PageRank on the card over the same seed's edges.
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    s = cli.run(["--synthetic", f"rmat:{BIG_SCALE}", "--device-build",
                 "--iters", str(ITERS), "--dtype", "float32", "--log-every",
                 "0"])
    k1, k2, _ = _read_counts()
    peak = _peak_gb(base)
    label = f"--device-build rmat:{BIG_SCALE} flat"
    _check((k1, k2) == (ITERS, 0) and s["form"] == "flat_ell",
           f"{label}: {s['form']}, K1 {k1} K2 {k2}")
    dg, ranks = s["graph"], s["ranks"]
    ms = statistics.median(s["step_seconds"]) * 1e3
    t0 = time.perf_counter()
    z_ext, src, rb, nb, plan = s["engine"].contrib_inputs()
    _k1_entry(z_ext, src, rb, nb, plan, torch.float32, 1e-5,
              f"rmat:{BIG_SCALE} f32/f32")
    t_k1 = time.perf_counter() - t0
    stages, rows = _device_stages(s), s["num_rows"]
    del s, z_ext, src, rb, plan
    t0 = time.perf_counter()
    ref, ref_edges, ref_out = _plain_pagerank(
        *db.rmat_edges_device(BIG_SCALE, device=cuda), dg.n)
    t_ref = time.perf_counter() - t0
    _check(ref_edges == dg.num_edges and np.array_equal(
        ref_out, dg.out_degree.cpu().numpy()), f"{label}: the seed's "
        f"edges give {ref_edges} unique edges, the graph has {dg.num_edges}")
    l1 = oracle_l1(ranks, ref)[1]
    _check(l1 <= 1e-4, f"{label} vs the plain f64 PageRank: normalised "
           f"L1 {l1} > 1e-4")
    print(f"{label}: n={dg.n:,}, {16 << BIG_SCALE:,} raw edges, "
          f"{dg.num_edges:,} unique, {rows:,} slot rows; {stages}; peak "
          f"device memory {peak:.3f} GB; {ms:.3f} ms/iter "
          f"{dg.num_edges / (ms / 1e3):.6g} edges/s; K1 {k1}; K1 check "
          f"{t_k1:.1f} s; plain f64 PageRank on the card ({t_ref:.1f} s) "
          f"normalised L1 {l1:.3e}")
    del dg
    print(f"device build phase took {time.perf_counter() - t_phase:.1f} s")


# Phase 12: personalized PageRank and its daemon, at the size of the
# repo's PPR acceptance runs (BASELINE.md:154-160; scripts/acceptance.py
# "P" and its gates, :369-371).
PPR_SCALE = 20
PPR_SOURCES = 256
PPR_CHUNK = 64
PPR_ITERS = 20
PPR_TOPK = 100
PPR_TIE_EPS = 1e-6
PPR_OVERLAP_GATE = 0.999
PPR_SCORE_L1_GATE = 1e-4
# Sources the host f64 oracle solves (cut from 16: ~2 s a source on the
# card's host).
PPR_ORACLE_SOURCES = 4


def _csr_transpose(graph, dtype):
    """A_T = the row-normalised adjacency transposed, as a CSR tensor on
    the card from the graph's own edges (no pack, plan or kernel of the
    port)."""
    import numpy as np
    import torch

    dev = "cuda"
    idx = torch.stack([torch.from_numpy(graph.dst.astype(np.int64)),
                       torch.from_numpy(graph.src.astype(np.int64))]).to(dev)
    w = torch.from_numpy(graph.edge_weight).to(dev, dtype)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, w, (graph.n, graph.n)
                                       ).coalesce().to_sparse_csr()


def _plain_ppr(graph, sources, iters, damping=0.85):
    """Plain f64 PPR on the card (dangling mass back to the source): one
    torch.sparse.mm of A_T a step over all the sources at once, the
    dangling mass by one matrix-vector product. [n, s] f64."""
    import numpy as np
    import torch

    a_t = _csr_transpose(graph, torch.float64)
    s = len(sources)
    p = torch.zeros((graph.n, s), dtype=torch.float64, device="cuda")
    p[torch.from_numpy(np.asarray(sources)).cuda(),
      torch.arange(s, device="cuda")] = 1.0
    d = torch.from_numpy((graph.out_degree == 0).astype(np.float64)).cuda()
    r = p.clone()
    for _ in range(iters):
        contrib = torch.sparse.mm(a_t, r)
        mass = d @ r
        r = (1.0 - damping) * p + damping * (contrib + p * mass[None, :])
        del contrib
    return r


def ppr_cli_phase(tmp):
    """Phase 12(a): PPR through the CLI on cuda at the acceptance size;
    returns (summary, the host oracle's columns of the first sources,
    report)."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.engines.ppr import ppr_cpu

    out = os.path.join(tmp, "ppr.tsv")
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    s = cli.run(["--synthetic", f"rmat:{PPR_SCALE}", "--ppr-sources",
                 f"random:{PPR_SOURCES}", "--ppr-topk", str(PPR_TOPK),
                 "--ppr-chunk", str(PPR_CHUNK), "--iters", str(PPR_ITERS),
                 "--dtype", "float32", "--out", out])
    wall = time.perf_counter() - t0
    k1, k2, probe = _read_counts()
    k1w = probe.pop("K1w")
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    graph, res, eng = s["graph"], s["ppr"], s["engine"]
    want = PPR_ITERS * (PPR_SOURCES // PPR_CHUNK)
    _check(eng.device.type == "cuda", "the PPR path did not run on cuda")
    _check(k1w == want and k1 == 0 and k2 == 0 and not any(probe.values()),
           f"PPR: ell_contrib_spmm launched {k1w} times (want {want}: one "
           f"an iteration, {PPR_ITERS} iterations x "
           f"{PPR_SOURCES // PPR_CHUNK} chunks of {PPR_CHUNK}), ell_contrib "
           f"{k1}, ell_contrib_partitioned {k2}, the probe kernels {probe}")
    _check(eng.layout_info()["kernel"] == "ell_contrib_spmm:cuda",
           f"PPR ran {eng.layout_info()['kernel']}")
    ids, scores = res.topk_ids, res.topk_scores
    _check(ids.shape == scores.shape == (PPR_SOURCES, PPR_TOPK)
           and np.isfinite(scores).all() and (ids >= 0).all()
           and (ids < graph.n).all(), "PPR result not finite of shape "
           f"({PPR_SOURCES}, {PPR_TOPK}) with ids in range")
    with open(out) as f:
        rows = sum(1 for _ in f)
    _check(rows == PPR_SOURCES * PPR_TOPK, f"--out has {rows} rows")
    # The reference: plain f64 PPR on the card over all the sources,
    # itself held to the host oracle on the first PPR_ORACLE_SOURCES.
    t1 = time.perf_counter()
    ref = _plain_ppr(graph, res.sources, PPR_ITERS)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t1
    t1 = time.perf_counter()
    host = ppr_cpu(graph, res.sources[:PPR_ORACLE_SOURCES],
                   num_iters=PPR_ITERS)
    t_host = time.perf_counter() - t1
    ref_err = float(np.abs(ref[:, :PPR_ORACLE_SOURCES].cpu().numpy()
                           - host).max())
    _check(ref_err <= 1e-12, f"plain f64 PPR on the card vs the host "
           f"oracle: max abs {ref_err:.3e} > 1e-12")
    # The acceptance gates: top-k id overlap (a device id counts when
    # its reference score reaches the k-th within PPR_TIE_EPS) and the
    # L1 over the sorted top-k scores, per source.
    top = torch.topk(ref, PPR_TOPK, dim=0).values  # [k, s] descending
    kth = top[-1]
    cols = torch.arange(PPR_SOURCES, device="cuda")
    ids_t = torch.from_numpy(ids.astype(np.int64)).cuda()
    true = ref[ids_t, cols[:, None]]  # [s, k]
    overlap = (true >= kth[:, None] - PPR_TIE_EPS).double().mean(1)
    l1 = (torch.from_numpy(scores.astype(np.float64)).cuda()
          - top.T).abs().sum(1)
    ov_min, ov_mean = float(overlap.min()), float(overlap.mean())
    l1_max = float(l1.max())
    del ref, top, true, ids_t
    _check(ov_min >= PPR_OVERLAP_GATE and l1_max <= PPR_SCORE_L1_GATE,
           f"PPR vs the plain f64 reference: min top-k overlap {ov_min} "
           f"(gate >= {PPR_OVERLAP_GATE}), max score L1 {l1_max} (gate <= "
           f"{PPR_SCORE_L1_GATE})")
    solve_s = sum(eng.chunk_seconds)
    per_iter = [c / PPR_ITERS * 1e3 for c in eng.chunk_seconds]
    evs = graph.num_edges * PPR_SOURCES * PPR_ITERS / solve_s
    bs = eng.layout_info()["build_seconds"]
    print(f"PPR rmat:{PPR_SCALE} through the CLI on cuda: n={graph.n} "
          f"edges={graph.num_edges}, {PPR_SOURCES} sources x {PPR_ITERS} "
          f"iterations in chunks of {PPR_CHUNK}, top-{PPR_TOPK}; K1w "
          f"launches {k1w} (one an iteration a chunk, tile "
          f"{eng.layout_info()['kt']}), K1 {k1}, K2 {k2}; wall {wall:.3f} "
          f"s; solve "
          f"{solve_s:.3f} s over {len(eng.chunk_seconds)} chunks ("
          + ", ".join(f"{c:.4f}" for c in eng.chunk_seconds)
          + f" s; {statistics.median(per_iter):.4f} ms an iteration a "
          f"{PPR_CHUNK}-column chunk, top-k and fetch included), "
          f"{evs:.6g} edge·vectors/s; peak device memory {peak:.3f} GB "
          f"above the process's baseline")
    print(f"PPR host build: R-MAT edges {s['input_seconds']:.3f} s, "
          f"build_graph {s['graph_seconds']:.3f} s ({s['sort_route']} "
          f"sort), ELL pack {bs['pack']:.3f} s, sentinels + segment plan "
          f"{bs['plan']:.3f} s, placement {bs['place']:.3f} s, K1w bound "
          f"at {PPR_CHUNK} columns {eng.layout_info()['bind_seconds']:.3f} "
          f"s; {eng.layout_info()['num_rows']} slot rows")
    print(f"PPR vs a plain f64 PPR on the card (torch.sparse.mm, "
          f"{t_ref:.1f} s; {ref_err:.3e} max abs from the host oracle on "
          f"{PPR_ORACLE_SOURCES} sources, {t_host:.1f} s): top-{PPR_TOPK} "
          f"overlap min {ov_min:.4f} mean {ov_mean:.4f} (gate >= "
          f"{PPR_OVERLAP_GATE}), max score L1 {l1_max:.3e} (gate <= "
          f"{PPR_SCORE_L1_GATE})")
    return s, host, {"launches": k1w, "solve_s": solve_s, "evs": evs,
                     "chunk_iter_ms": statistics.median(per_iter),
                     "overlap_min": ov_min, "l1_max": l1_max,
                     "peak_gb": peak}


def _k1w_step_split(label, step, steps):
    """A PPR step's time by kernel: the host wall a step over ``steps``
    back-to-back steps, then as many under torch.profiler (after a
    warm-up step): device busy, K1w's share and the other kernels, the
    idle share; prints it and returns it. The launch count is the
    wrapper's; the profiler may miss an event of a kernel launched from
    outside PyTorch, so K1w's device time a step is taken per recorded
    launch, and the recorded count is printed. A window in which it
    recorded none of them is profiled again, up to PROFILE_TRIES
    windows, the wrapper's count checked in each."""
    from pagerank_tpu_torch.ops import ell_spmm

    for tries in range(1, PROFILE_TRIES + 1):
        before = ell_spmm.launches
        wall_ms, per_kernel, calls, _, _ = _profile_steps(step, steps)
        _check(ell_spmm.launches - before == 2 * steps + 1,
               f"{2 * steps + 1} PPR steps launched K1w "
               f"{ell_spmm.launches - before} times")
        mine = [n for n in per_kernel
                if _named(n, "ell_contrib_spmm_kernel")]
        seen = sum(calls[n] for n in mine)
        if seen >= 1 or tries == PROFILE_TRIES:
            break
        print(f"{label}: the profiled window recorded none of the "
              f"wrapper's {2 * steps + 1} K1w launches; profiling again")
    _check(seen >= 1, f"the profiler recorded no K1w launch in {tries} "
                      f"windows")
    k1w_dev = sum(per_kernel[n] for n in mine) * steps / seen
    busy = sum(per_kernel.values()) - sum(per_kernel[n] for n in mine) \
        + k1w_dev
    kernels = (sum(calls.values()) - seen) // steps + 1
    print(f"{label} breakdown over {steps} steps (torch.profiler, {seen} "
          f"of {steps} K1w launches recorded; K1w's device time scaled "
          f"per recorded launch): wall {wall_ms:.4f} ms/step; device busy "
          f"{busy:.4f} ms/step = K1w {k1w_dev:.4f} + other kernels "
          f"{busy - k1w_dev:.4f} ({kernels} kernels a step); device idle "
          f"{1 - busy / wall_ms:.1%} of the wall")
    top = sorted(((v, n) for n, v in per_kernel.items() if n not in mine),
                 reverse=True)[:6]
    for v, n in top:
        print(f"  other kernel {v:.4f} ms/step ({calls[n] // steps} a "
              f"step): {n[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "k1w_ms": k1w_dev,
            "seen": seen, "kernels": kernels}


def ppr_kernel_phase(s, host):
    """Phase 12(b): K1w on the PPR path at (a)'s shapes against its plain
    version and K1's column launchers, in every entry; PTK001-005 on its
    plan; run-to-run and batch-to-alone bit-identity, f64 against the
    host oracle; the tile sweep, the chunk iteration, K1's 64 launches
    and torch.sparse.mm."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig
    from pagerank_tpu_torch.analysis import kernels
    from pagerank_tpu_torch.engines.ppr import PprTorchEngine
    from pagerank_tpu_torch.ops import ell as ell_lib
    from pagerank_tpu_torch.ops import ell_spmm, ell_spmv

    eng, graph, res = s["engine"], s["graph"], s["ppr"]
    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    launcher, z2 = eng._launcher, eng._z2  # (a)'s last prescaled chunk
    src, rb, nb, plan = eng._src, eng._row_block, eng._num_blocks, eng._plan
    k = PPR_CHUNK
    _check(launcher is not None and launcher.width == k
           and z2.shape[1] == k, f"K1w bound at {launcher and launcher.width} "
           f"columns over z2 {tuple(z2.shape)}, want {k}")
    plan_cpu = ell_lib.segment_plan(rb.cpu().numpy(), nb)
    src_cpu = src.cpu()

    def plain(z, acc):
        """The plain version on the CPU, 8 columns at a time (any tile
        gives the same bits; 8 keeps the host's gather at ~1 GB): the
        sums, and block 0's lanes folded (the dangling mass)."""
        kw = {"accum_dtype": acc, "plan": plan_cpu, "k": k, "kt": 8}
        return (ell_spmm.ell_contrib_spmm_rows_reference(z.cpu(), src_cpu,
                                                         **kw),
                ell_spmm.mass_reference(z.cpu(), src_cpu, **kw))

    def columns(z, acc):
        """K1 once a column (the yardstick), bound over z's columns."""
        return ell_spmv.bind_columns(z.T.contiguous(), src, nb,
                                     accum_dtype=acc, plan=plan)

    # Each entry at k = 1, 8 and 64 (f32/f64 at 64) against its plain
    # version on the CPU and against K1's 64 column launches.
    z64 = z2.to(f64)
    held, wants = [], {}
    for z, acc, ks in ((z2, f32, (1, 8, k)), (z64, f64, (1, 8, k)),
                       (z2, f64, (k,))):
        want, mass = wants[z.dtype, acc] = plain(z, acc)
        cols = columns(z, acc)
        for ln in cols:
            ln()
        _check(torch.equal(cols[0].out_cols.cpu().T, want),
               f"K1's column launchers ({_dt(z)}/{acc}) differ from the "
               f"plain version")
        wide = ell_spmm.bind_spmm(z, src, nb, accum_dtype=acc, plan=plan)
        for kc in ks:
            got = wide(kc)[:, :kc].cpu()
            _check(torch.equal(got, want[:, :kc])
                   and torch.equal(wide.mass[:kc].cpu(), mass[:kc]),
                   f"K1w ({_dt(z)}/{acc}, k={kc}, tile {wide.last_tile}) "
                   f"differs from its plain version and K1's columns, or "
                   f"its folded mass from the plain fold")
            held.append(f"{_dt(z)}/{str(acc)[6:]} k={kc} (tile "
                        f"{wide.last_tile})")
        del cols, wide
    # z2's f32 values are exact in f64: the f64/f64 sums are exact sums.
    (exact, _), (want32, mass32) = wants[f64, f64], wants[f32, f32]
    got = launcher(k).cpu()
    err = float((got.double() - exact).abs().max())
    scale = max(float(exact.abs().max()), 1e-300)
    _check(err / scale <= 1e-5, f"K1w vs exact f64 sums: normalised "
           f"{err / scale:.3e} > 1e-5")
    kind = torch.cuda.get_device_name(0)
    for kc in (k, 8, 1):
        _check_case(kernels.k1w_case_from_inputs(
            f"ell_contrib_spmm@ppr-k{kc}", z2, src, rb, nb, plan, k=kc,
            device_kind=kind))
    # The bound of the function, one 64-column SpMM (the slots and plan
    # once, each column's z and output once).
    num_empty = int(plan.empty_groups.numel())
    spmm_cost = kernels.k1_cost(int(src.shape[0]), eng._n_state, nb,
                                plan_cpu.num_segments, num_empty,
                                z2.element_size(), columns=k)
    bound_ms, bound_by = _bound_ms(spmm_cost)
    # The tile sweep: the 64-column SpMM at every built tile, each
    # torch.equal to the plain version.
    sweep = {}
    for kt in ell_spmm.TILES:
        ln = ell_spmm.bind_spmm(z2, src, nb, accum_dtype=f32, plan=plan,
                                kt=kt)
        _check(torch.equal(ln(k).cpu(), want32)
               and torch.equal(ln.mass[:k].cpu(), mass32),
               f"K1w at tile {kt} differs from its plain version")
        sweep[f"kt{kt}"] = _median_ms(lambda: ln(k), 20)
        del ln
    # Over f64 sums (z2 in f64) at the tiles that hold the most sums a
    # thread: what KT_F64 was chosen by.
    want64, mass64 = wants[f64, f64]
    for kt in (16, 32, 64):
        ln = ell_spmm.bind_spmm(z64, src, nb, accum_dtype=f64, plan=plan,
                                kt=kt)
        _check(torch.equal(ln(k).cpu(), want64)
               and torch.equal(ln.mass[:k].cpu(), mass64),
               f"K1w f64/f64 at tile {kt} differs from its plain version")
        sweep[f"f64-kt{kt}"] = _median_ms(lambda: ln(k), 20)
        del ln
    # The same 64-column batch twice, and one source alone.
    batch = res.sources[:k]
    r1 = eng.solve_chunk(batch, PPR_ITERS)
    r2 = eng.solve_chunk(batch, PPR_ITERS)
    _check(torch.equal(r1, r2), "the same PPR batch twice differs")
    ids_b, sc_b = eng.topk(r1, PPR_TOPK)
    alone = eng.run(batch[5:6], topk=PPR_TOPK)
    _check(np.array_equal(alone.topk_ids[0],
                          eng._perm[ids_b[5].cpu().numpy()])
           and np.array_equal(alone.topk_scores[0], sc_b[5].cpu().numpy()),
           "a source alone gives other ids or score bits than in its batch")
    # f64/f64 against the host oracle.
    e64 = PprTorchEngine(PageRankConfig(num_iters=PPR_ITERS,
                                        dtype="float64",
                                        accum_dtype="float64")).build(graph)
    r64 = e64.solve_chunk(res.sources[:PPR_ORACLE_SOURCES], PPR_ITERS)
    full = np.empty((graph.n, PPR_ORACLE_SOURCES))
    full[e64._perm] = r64[: graph.n].cpu().numpy()
    err64 = float(np.abs(full - host).max())
    _check(err64 <= 1e-12, f"f64/f64 PPR vs the host oracle on "
           f"{PPR_ORACLE_SOURCES} sources: max abs {err64:.3e} > 1e-12")
    del e64, r64
    # Times: one iteration of a 64-column chunk (CUDA events), its K1w
    # launch, K1's 64 column launches, the plain version and the
    # library yardstick.
    p = torch.zeros_like(r1)
    p[torch.from_numpy(eng._inv_perm[batch].astype(np.int64)).cuda(),
      torch.arange(k, device="cuda")] = 1.0
    p_acc, r = p.to(eng._accum), r1.clone()
    step_ms = _median_ms(lambda: eng._step(r, p_acc), 20)
    split = _k1w_step_split(f"PPR chunk iteration ({k} columns)",
                            lambda: eng._step(r, p_acc), 10)
    wall_ms, busy = split["wall_ms"], split["busy_ms"]
    k1w_ms = _median_ms(lambda: launcher(k), 20)
    cols = columns(z2, f32)
    k1_ms = _median_ms(lambda: [ln() for ln in cols], 20)
    del cols
    plain_ms = _median_ms(lambda: ell_spmm.ell_contrib_spmm_rows_reference(
        z2, src, accum_dtype=f32, plan=plan, k=k), 5, warmup=1)
    a_t = _csr_transpose(graph, f32)
    zd = torch.rand((graph.n, k), dtype=f32, device="cuda")
    lib_ms = _median_ms(lambda: torch.sparse.mm(a_t, zd), 20)
    del a_t, zd
    print(f"K1w on the PPR path ({launcher.grid} CTAs, tile {launcher.kt}, "
          f"{eng.layout_info()['num_rows']} rows x "
          f"128, {plan_cpu.num_segments} segments, workspace "
          f"{launcher.work.seg_stride} segments a tile): torch.equal to its "
          f"plain version on the CPU and to K1's {k} column launches in "
          + ", ".join(held) + f"; max abs {err:.3e} from exact f64 sums; "
          f"PTK001-005 clean on this plan at k = {k}, 8, 1; the same "
          f"{k}-column batch twice bit-equal; a source alone: ids and "
          f"scores bit-equal; f64/f64 {err64:.3e} max abs from the host "
          f"oracle on {PPR_ORACLE_SOURCES} sources")
    print(f"K1w tile sweep, the {k}-column SpMM (CUDA events, median of "
          f"20; each torch.equal to the plain version): "
          + ", ".join(f"{t} {v:.4f} ms" for t, v in sweep.items()))
    print(f"PPR chunk iteration ({k} columns, CUDA events, median of 20): "
          f"{step_ms:.4f} ms, of which the K1w launch {k1w_ms:.4f} ms; "
          f"K1's {k} column launches {k1_ms:.4f} ms ({k1_ms / k1w_ms:.2f}x "
          f"K1w); the {k}-column SpMM's {bound_by} bound {bound_ms:.4f} ms "
          f"({spmm_cost['bytes']:.0f} B; {bound_ms / k1w_ms:.1%} of bound "
          f"for K1w, {bound_ms / k1_ms:.1%} for the {k} launches); the "
          f"plain version on the card {plain_ms:.4f} ms; one "
          f"torch.sparse.mm of A_T (CSR, f32) with a dense [n, {k}] f32 "
          f"matrix {lib_ms:.4f} ms ({k1w_ms / lib_ms:.2f}x) "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"chunk_iter_ms": step_ms, "chunk_iter_wall_ms": wall_ms,
            "chunk_iter_busy_ms": busy, "k1w_ms": k1w_ms,
            "k1_chunk_ms": k1_ms,
            "plain_ms": plain_ms, "sparse_mm_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "kt": launcher.kt, "sweep_ms": sweep}


def serve_phase(s):
    """Phase 12(c): the daemon — the serve smoke in process at the
    acceptance size, then a PprServer behind QueryIngress on an
    ephemeral port."""
    import contextlib
    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, serve
    from pagerank_tpu_torch.serving import PprServer, QueryIngress, ServeConfig

    t0 = time.perf_counter()
    buf = io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--serve-smoke", "64", "--scale", str(PPR_SCALE),
                         "--iters", str(PPR_ITERS), "--topk",
                         str(PPR_TOPK), "--max-batch", "8"])
    k1, k2, probe = _read_counts()
    k1w = probe["K1w"]
    text = buf.getvalue().strip()
    print(f"serve smoke: {text.splitlines()[-1] if text else '(no output)'}")
    _check(rc == 0, f"serve --serve-smoke exited {rc}")
    doc = json.loads(text.splitlines()[-1])
    _check(doc["unsettled"] == 0 and all(
        o.startswith("answered") for o in doc["outcomes"]),
        f"serve smoke outcomes {doc['outcomes']}, unsettled "
        f"{doc['unsettled']}")
    # One K1w launch an iteration a dispatched batch (over its live
    # columns only), plus the warm-up batch; cached answers launch
    # nothing.
    want = (doc["batches"] + 1) * PPR_ITERS
    _check(k1w == want and k1 == 0 and k2 == 0,
           f"serve smoke: K1w launched {k1w} times (want {want}: "
           f"{doc['batches']} batches + the warm-up, x {PPR_ITERS} "
           f"iterations), K1 {k1}, K2 {k2}")
    smoke_s = time.perf_counter() - t0
    walls = doc["batch_wall_ms"]
    print(f"serve smoke at rmat:{PPR_SCALE}: warm-up {doc['warmup_s']:.3f} s "
          f"(engine build, kernel load, K1w bound at 8 columns), "
          f"{doc['batches']} batches, batch wall first {walls['first']:.3f} "
          f"ms, p50 {walls['p50']:.3f} ms, p99 {walls['p99']:.3f} ms; K1w "
          f"launches {k1w} for {doc['outcomes'].get('answered', 0)} "
          f"computed answers in {doc['batches']} batches + warm-up "
          f"({smoke_s:.1f} s with the graph build)")
    # The HTTP ingress over the graph of (a).
    graph, res, eng = s["graph"], s["ppr"], s["engine"]
    srv = PprServer(graph, config=PageRankConfig(num_iters=PPR_ITERS),
                    serve_config=ServeConfig(max_batch=8, topk=PPR_TOPK,
                                             deadline_ms=5000.0))
    srv.start()
    try:
        with QueryIngress(srv, port=0) as ing:
            base = f"http://127.0.0.1:{ing.port}"

            def get(path):
                with urllib.request.urlopen(base + path, timeout=60) as r:
                    return r.status, json.loads(r.read())

            sources = [int(x) for x in res.sources[:16]]
            with ThreadPoolExecutor(16) as pool:
                bodies = list(pool.map(
                    lambda v: get(f"/ppr?source={v}&k={PPR_TOPK}"), sources))
            want = eng.run(np.array(sources), topk=PPR_TOPK)
            for i, (status, body) in enumerate(bodies):
                _check(status == 200 and body["outcome"] == "answered",
                       f"HTTP query {i}: {status} {body.get('outcome')}")
                _check(body["ids"] == want.topk_ids[i].tolist(),
                       f"HTTP query {i} (source {sources[i]}): ids differ "
                       f"from PprTorchEngine.run")
            exact = all(b["scores"] == want.topk_scores[i].tolist()
                        for i, (_, b) in enumerate(bodies))
            status, again = get(f"/ppr?source={sources[3]}&k={PPR_TOPK}")
            _check(status == 200 and again["outcome"] == "answered_cache"
                   and json.dumps(again["ids"]) == json.dumps(
                       bodies[3][1]["ids"])
                   and json.dumps(again["scores"]) == json.dumps(
                       bodies[3][1]["scores"]),
                   "the repeat query was not answered from the cache with "
                   "equal bytes")
            status, health = get("/healthz")
            _check(status == 200 and health["status"] == "serving",
                   f"/healthz: {status} {health}")
        # A lone query runs one column: a K1w launch an iteration at a
        # 4-column tile, no padding.
        walls_before = len(srv.batch_walls)
        _reset_counts()
        lone_src = next(int(v) for v in res.sources if int(v) not in sources)
        lone = srv.submit(lone_src, k=PPR_TOPK, deadline_s=1.0)
        lone.wait(30)
        k1, _, probe = _read_counts()
        k1w_lone, tile = probe["K1w"], srv._engine._launcher.last_tile
        _check(lone.outcome == "answered" and k1w_lone == PPR_ITERS
               and k1 == 0 and tile == 4
               and len(srv.batch_walls) == walls_before + 1,
               f"a lone query: {lone.outcome}, K1w {k1w_lone} launches at "
               f"tile {tile} (want {PPR_ITERS} at 4: one column), K1 {k1}")
        # Four more lone queries, each a source not asked before: the
        # first pays for what a 1-column call allocates.
        asked, more = set(sources) | {lone_src}, []
        for v in map(int, res.sources):
            if v not in asked and len(more) < 4:
                asked.add(v)
                more.append(v)
        for v in more:
            q = srv.submit(v, k=PPR_TOPK, deadline_s=1.0)
            q.wait(30)
            _check(q.outcome == "answered", f"lone query {v}: {q.outcome}")
        lone_walls = [w * 1e3 for w in srv.batch_walls[walls_before:]]
        _check(len(lone_walls) == 1 + len(more),
               f"{len(lone_walls)} batch walls for {1 + len(more)} lone "
               f"queries")
        lone_ms = statistics.median(lone_walls)
        # What bounds it: the same query through the engine alone (host
        # wall, top-k and fetch included), one of its iterations split
        # by kernel on the daemon's engine (bound at 8 columns), its K1w
        # launch and its top-k.
        eng1 = srv._engine
        run_ms = []
        for v in more:
            t1 = time.perf_counter()
            eng1.run(np.array([v]), topk=PPR_TOPK)
            run_ms.append((time.perf_counter() - t1) * 1e3)
        with eng1._run_lock:
            p1 = torch.zeros((eng1._n_state, 1), dtype=eng1._dtype,
                             device="cuda")
            p1[int(eng1._inv_perm[lone_src]), 0] = 1.0
            p1_acc, r1 = p1.to(eng1._accum), p1.clone()
            lone_split = _k1w_step_split(
                "a lone query's iteration (1 column, the daemon's engine)",
                lambda: eng1._step(r1, p1_acc), 20)
            lone_k1w_ms = _median_ms(lambda: eng1._launcher(1), 20)
            topk_ms = _median_ms(lambda: eng1.topk(r1, PPR_TOPK), 20)
    finally:
        srv.drain()
    print(f"HTTP ingress: 16 concurrent queries answered in "
          f"{walls_before} batches, ids equal to PprTorchEngine.run (scores "
          f"{'bit-equal' if exact else 'not bit-equal'}), the repeat "
          f"answered from the cache with equal ids and scores, /healthz "
          f"{health['status']}; warm-up {srv.warmup_seconds:.3f} s, batch "
          f"walls " + ", ".join(f"{w * 1e3:.3f}" for w in
                                srv.batch_walls[:walls_before])
          + f" ms; a lone query after them: one column, K1w {k1w_lone} "
          f"launches at tile {tile}; {len(lone_walls)} lone queries' batch "
          f"walls " + ", ".join(f"{w:.3f}" for w in lone_walls)
          + f" ms (median {lone_ms:.3f}); the same queries through "
          f"PprTorchEngine.run alone " + ", ".join(f"{w:.3f}" for w in run_ms)
          + f" ms (host wall, top-k and fetch included); its K1w launch "
          f"alone {lone_k1w_ms:.4f} ms, its top-k {topk_ms:.4f} ms (CUDA "
          f"events, median of 20)")
    return {"warmup_s": doc["warmup_s"],
            "batch_wall_ms": dict(doc["batch_wall_ms"], lone=lone_ms),
            "http_warmup_s": srv.warmup_seconds,
            "lone_walls_ms": lone_walls,
            "lone_run_ms": run_ms, "lone_k1w_ms": lone_k1w_ms,
            "lone_topk_ms": topk_ms,
            "lone_step": {k: lone_split[k] for k in
                          ("wall_ms", "busy_ms", "k1w_ms", "kernels")}}


def coo_phase(graph, oracle, flat_eng, part_ms):
    """Phase 12(d): the coo form on phase 3's graph, on cuda, twice,
    beside ``ITERS`` more steps of phase 3's flat engine, each timed
    through ``engine.run`` by the same per-step host clock."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine

    def timed_run(eng, num_iters):
        """eng.run to ``num_iters``; the median host wall of a step."""
        step_s = []
        t_last = [time.perf_counter()]

        def on_iteration(i, info):
            now = time.perf_counter()
            step_s.append(now - t_last[0])
            t_last[0] = now

        ranks = eng.run(num_iters, on_iteration=on_iteration)
        return ranks, statistics.median(step_s) * 1e3

    _reset_counts()
    _, flat_ms = timed_run(flat_eng, flat_eng.iteration + ITERS)
    k1, _, _ = _read_counts()
    _check(k1 == ITERS, f"flat form: K1 launched {k1} times in {ITERS} steps")
    cfg = PageRankConfig(num_iters=ITERS, kernel="coo")
    runs = []
    for _ in range(2):
        eng = TorchEngine(cfg, device="cuda")
        t0 = time.perf_counter()
        eng.build(graph)
        build_s = time.perf_counter() - t0
        _reset_counts()
        ranks, ms_run = timed_run(eng, ITERS)
        k1, k2, probe = _read_counts()
        _check(eng.layout_info()["form"] == "coo" and k1 == 0 and k2 == 0
               and not any(probe.values()) and eng.iteration == ITERS,
               f"coo: K1 {k1}, K2 {k2}, probes {probe} in {eng.iteration} "
               f"steps (want none)")
        runs.append((eng._r.clone(), ranks, ms_run, build_s))
        del eng
    (ra, ranks, ms, build_s), (rb, _, ms2, _) = runs
    _check(torch.equal(ra, rb), "coo: two runs on the card differ")
    l1 = float(np.abs(ranks - oracle).sum() / np.abs(oracle).sum())
    _check(l1 <= 1e-4, f"coo vs the f64 oracle: normalised L1 {l1} > 1e-4")
    print(f"coo form rmat path ({graph.num_edges} dst-sorted edges, "
          f"segment_reduce): two runs torch.equal, K1 0 K2 0 launches, f64 "
          f"oracle normalised L1 {l1:.3e}; median step {ms:.3f} / {ms2:.3f} "
          f"ms/iter ({graph.num_edges / (ms / 1e3):.6g} edges/s) beside the "
          f"flat form's {flat_ms:.3f} in the same phase ({ms / flat_ms:.2f}x; "
          f"both engine.run, no snapshots) and the partitioned f32 form's "
          f"{part_ms:.3f} (engine.run, phase 5); build {build_s:.3f} s")
    return {"ms_per_iter": ms, "flat_ms_per_iter": flat_ms, "l1": l1}


SINK_SCALE = 22
S3_SCALE = 16
JOB_SCALE = 18
FLIP_ITER = 4


def _tree_digest(root):
    """{relative path: sha256} of every file under ``root``."""
    import hashlib

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            h = hashlib.sha256()
            with open(p, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 24), b""):
                    h.update(block)
            out[os.path.relpath(p, root)] = h.hexdigest()
    return out


def _parse_dump(path, n):
    """The ranks of a ``(key,rank)`` text dump with integer keys 0..n-1
    in order, as float64."""
    import numpy as np

    with open(path, "rb") as f:
        text = f.read()
    tok = text.replace(b"(", b"").replace(b")", b"").replace(
        b",", b" ").split()
    a = np.array(tok, dtype=np.float64).reshape(-1, 2)
    _check(a.shape[0] == n and np.array_equal(a[:, 0], np.arange(n)),
           f"{path}: keys are not 0..{n - 1} in order")
    return a[:, 1]


def _sink_run(label, argv):
    """One cli.run of the flat main path with K1's launches counted;
    returns the summary."""
    from pagerank_tpu_torch import cli

    _reset_counts()
    s = cli.run(argv)
    k1, k2, probe = _read_counts()
    _check(k1 == ITERS and k2 == 0 and not any(probe.values()),
           f"{label}: K1 {k1}, K2 {k2}, others {probe} in {ITERS} steps "
           f"(want one K1 launch a step)")
    _check(s["form"] == "flat_ell" and s["engine"].device.type == "cuda",
           f"{label}: ran {s['form']} on {s['engine'].device}")
    med = statistics.median
    saves = (f", save {med(s['snapshot_seconds']) * 1e3:.3f} ms median of "
             f"{len(s['snapshot_seconds'])}" if s["snapshot_seconds"] else "")
    dumps = (f", dump {med(s['dump_seconds']) * 1e3:.3f} ms median of "
             f"{len(s['dump_seconds'])} ({s['dump_route']})"
             if s["dump_seconds"] else "")
    wait = (f", queue wait {sum(s['queue_wait_seconds']) * 1e3:.3f} ms "
            f"over {len(s['queue_wait_seconds'])} submits (max "
            f"{max(s['queue_wait_seconds']) * 1e3:.3f}), writer items "
            f"{[round(x * 1e3, 1) for x in s['writer_item_seconds']]} ms"
            if s["queue_wait_seconds"] else "")
    fetch = (f", fetch to the host {med(s['decode_seconds']) * 1e3:.3f} ms "
             f"median" if s["decode_seconds"] else "")
    print(f"  {label}: {med(s['step_seconds']) * 1e3:.4f} ms/iter median "
          f"(steps {[round(x * 1e3, 3) for x in s['step_seconds']]}), "
          f"solve wall to the last write {s['solve_seconds']:.4f} s, "
          f"writer {s['writer']}{fetch}{saves}{dumps}{wait}; K1 {ITERS} "
          f"launches")
    return s


def _step_split(label, argv):
    """cli.run of ``argv`` once more, under torch.profiler: the solve's
    steps split, as means a step, into the host's wait in the step's two
    syncs (``float(delta)`` and ``float(m)``: the
    ``aten::_local_scalar_dense`` spans from the first K1 launch on),
    the rest of the step's host wall, the device time on K1's stream
    (K1 and the update) and, a payload, that on the other streams (the
    async writer's relabel scatter and copy into pinned memory), each
    with its largest names; K1's launches one by one."""
    from torch.profiler import ProfilerActivity, profile

    from pagerank_tpu_torch import cli

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = cli.run(argv)
    card, host = [], []
    for e in prof.events():
        if str(e.device_type) == "DeviceType.CUDA":
            card.append((e.time_range.start, e.time_range.end, e.name,
                         e.device_resource_id))
        else:
            host.append((e.time_range.start, e.time_range.end, e.name,
                         e.thread))
    k1 = sorted(x for x in card if _named(x[2], "ell_contrib_kernel"))
    _check(k1, f"{label}: the profiler recorded no K1 launch")
    lo, k1_end, stream = k1[0][0], k1[-1][1], k1[0][3]
    # The last step's syncs follow its K1 by the update's few kernels.
    syncs = sorted(x for x in host if x[2] == "aten::_local_scalar_dense"
                   and lo <= x[0] <= k1_end + 5000)
    _check(syncs, f"{label}: no step's syncs in the profile")
    steps, main, hi = ITERS, syncs[0][3], syncs[-1][1]
    comp, side, on_host = {}, {}, {}
    payloads = 0
    for a, b, name, sid in card:
        if a < lo or (sid == stream and a >= hi):
            continue  # the build's, or after the solve
        into = comp if sid == stream else side
        into[name] = into.get(name, 0.0) + (b - a) / 1e3
        payloads += sid != stream and "Memcpy" in name
    for a, b, name, tid in host:
        if tid == main and lo <= a < hi:
            on_host[name] = on_host.get(name, 0.0) + (b - a) / 1e3

    def top(d, per, k):
        return "; ".join(f"{v / per:.4f} {n[:48]}" for v, n in sorted(
            ((v, n) for n, v in d.items()), reverse=True)[:k])

    wall = statistics.fmean(s["step_seconds"]) * 1e3
    sync = sum(b - a for a, b, _, _ in syncs) / 1e3 / steps
    k1_ms = [(b - a) / 1e3 for a, b, _, _ in k1]
    out = {"wall_ms": wall, "sync_ms": sync, "host_ms": wall - sync,
           "compute_ms": sum(comp.values()) / steps,
           "k1_ms": statistics.fmean(k1_ms),
           "side_ms_per_payload": (sum(side.values()) / payloads
                                   if payloads else 0.0)}
    print(f"  profiler split, {label}: {steps} steps ({len(k1)} K1 "
          f"launches and {len(syncs)} syncs recorded), wall {wall:.4f} "
          f"ms/step (mean) = sync wait {sync:.4f} + other host time "
          f"{wall - sync:.4f}; device: K1's stream {out['compute_ms']:.4f} "
          f"ms/step (idle {1 - out['compute_ms'] / wall:.1%} of the wall), "
          f"other streams {out['side_ms_per_payload']:.4f} ms a payload "
          f"over {payloads} payloads")
    print(f"    K1 launches (ms): {[round(x, 4) for x in k1_ms]}; steps "
          f"(ms): {[round(x * 1e3, 3) for x in s['step_seconds']]}")
    print(f"    K1's stream a step (ms): {top(comp, steps, 5)}")
    if side:
        print(f"    other streams a payload (ms): "
              f"{top(side, payloads, 3)}")
    print(f"    main thread a step, inclusive (ms): "
          f"{top(on_host, steps, 6)}")
    return out


def sinks_phase(tmp):
    """Phase 13(a): rmat:SINK_SCALE built on the card, flat, 10
    iterations through cli.run five times — no sink; --snapshot-dir +
    --dump-text-dir with the async writer; the same with --sync-io;
    --snapshot-dir alone with each writer."""
    import shutil

    import numpy as np

    from pagerank_tpu_torch.utils.snapshot import Snapshotter

    base = ["--synthetic", f"rmat:{SINK_SCALE}", "--device-build",
            "--iters", str(ITERS), "--dtype", "float32", "--log-every", "0"]
    print(f"phase 13(a): the sinks at rmat:{SINK_SCALE} (device build, "
          f"flat, {ITERS} iterations)")
    plain = _sink_run("no sink", base)
    runs = {}
    digests = {}
    for label, extra in (("async", []), ("sync", ["--sync-io"])):
        d = os.path.join(tmp, f"sinks-{label}")
        s = _sink_run(
            f"{label} writer", base + ["--snapshot-dir", f"{d}/snaps",
                                       "--dump-text-dir", f"{d}/dumps",
                                       *extra])
        _check(s["writer"] == label, f"{label}: writer {s['writer']}")
        _check(s["dump_route"] == "native",
               f"{label}: text dumps took the {s['dump_route']} route")
        _check(np.array_equal(s["ranks"], plain["ranks"]),
               f"{label} writer: ranks differ from the run with no sink")
        snap = Snapshotter(f"{d}/snaps", s["graph"].fingerprint(),
                           "reference")
        last, _meta = snap.load(ITERS)
        _check(np.array_equal(last, s["ranks"]),
               f"{label}: snapshot {ITERS} != the returned ranks")
        n = s["graph"].n
        for i in range(ITERS):
            _check(os.path.exists(f"{d}/dumps/PageRank{i}/_SUCCESS"),
                   f"{label}: PageRank{i}/_SUCCESS missing")
        back = _parse_dump(f"{d}/dumps/PageRank{ITERS - 1}/part-00000", n)
        _check(np.array_equal(back, s["ranks"].astype(np.float64)),
               f"{label}: the last dump does not parse back to the ranks")
        digests[label] = _tree_digest(f"{d}/dumps")
        runs[label] = s
        shutil.rmtree(d)
    _check(len(digests["async"]) == 2 * ITERS
           and digests["async"] == digests["sync"],
           "async and sync text dumps differ")
    # Snapshots alone (phase 3's sinks): does the async writer hide the
    # save from the solve?
    snaps = {}
    for label, extra in (("async", []), ("sync", ["--sync-io"])):
        d = os.path.join(tmp, f"snaps-{label}")
        runs[f"snap_{label}"] = _sink_run(
            f"{label} writer, snapshots only",
            base + ["--snapshot-dir", d, *extra])
        _check(np.array_equal(runs[f"snap_{label}"]["ranks"], plain["ranks"]),
               f"{label} writer, snapshots only: ranks differ")
        snaps[label] = _tree_digest(d)
        shutil.rmtree(d)
    _check(len(snaps["async"]) == ITERS and snaps["async"] == snaps["sync"],
           "async and sync snapshots differ")
    print(f"  the five rank vectors bit-equal; {ITERS} dumps byte-identical "
          f"between async and sync, each with _SUCCESS; the last dump "
          f"parses back to the ranks; snapshot {ITERS} loads to them; the "
          f"snapshots-only runs' files byte-identical")
    # Where the async run's steps lose time against the no-sink steps:
    # the syncs, the host between them, or the device.
    d = os.path.join(tmp, "split")
    split = {}
    for key, label, extra in (
            ("no_sink", "no sink", []),
            ("async", "async writer",
             ["--snapshot-dir", f"{d}/snaps", "--dump-text-dir",
              f"{d}/dumps"]),
            ("snap_async", "async writer, snapshots only",
             ["--snapshot-dir", f"{d}/snaps"])):
        split[key] = _step_split(label, base + extra)
        shutil.rmtree(d, ignore_errors=True)

    def row(s):
        med = statistics.median
        return {"ms_per_iter": med(s["step_seconds"]) * 1e3,
                "solve_s": s["solve_seconds"],
                "save_ms": (med(s["snapshot_seconds"]) * 1e3
                            if s["snapshot_seconds"] else None),
                "dump_ms": (med(s["dump_seconds"]) * 1e3
                            if s["dump_seconds"] else None),
                "queue_wait_ms": sum(s["queue_wait_seconds"]) * 1e3,
                "fetch_ms": (med(s["decode_seconds"]) * 1e3
                             if s["decode_seconds"] else None),
                "writer_item_ms": (med(s["writer_item_seconds"]) * 1e3
                                   if s["writer_item_seconds"] else None)}

    return {"no_sink": row(plain), "async": row(runs["async"]),
            "sync": row(runs["sync"]), "snap_async": row(runs["snap_async"]),
            "snap_sync": row(runs["snap_sync"]), "split": split,
            "launches": 5 * ITERS}


def s3_phase(tmp):
    """Phase 13(b): snapshots and text dumps to s3:// URIs served by
    tests/s3stub.py in this process (localhost), then --resume from
    them: bit-equal to an uninterrupted run."""
    import numpy as np

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.utils import fsio

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from s3stub import S3Stub

    base = ["--synthetic", f"rmat:{S3_SCALE}", "--dtype", "float32",
            "--log-every", "0"]
    with S3Stub() as stub:
        os.environ["PAGERANK_TPU_S3_ENDPOINT"] = stub.endpoint
        for scheme in ("s3", "s3n", "s3a"):
            fsio.unregister(scheme)
        try:
            sinks = ["--snapshot-dir", "s3://bucket/snaps",
                     "--dump-text-dir", "s3://bucket/dumps"]
            _reset_counts()
            cli.run(base + ["--iters", "6", *sinks])
            s = cli.run(base + ["--iters", str(ITERS), *sinks, "--resume"])
            ctrl = cli.run(base + ["--iters", str(ITERS)])
            k1, k2, _ = _read_counts()
            _check(s["resumed_from"] == 6,
                   f"s3: resumed from {s['resumed_from']}, not 6")
            _check(np.array_equal(s["ranks"], ctrl["ranks"]),
                   "s3: the resumed run differs from an uninterrupted one")
            keys = sorted(stub.objects)
            _check(f"/bucket/snaps/ranks_iter{ITERS}.npz" in keys
                   and f"/bucket/dumps/PageRank{ITERS - 1}/_SUCCESS" in keys,
                   f"s3: objects missing ({len(keys)} objects)")
            _check(k1 == 2 * ITERS and k2 == 0,
                   f"s3: K1 {k1}, K2 {k2} (want {2 * ITERS}, 0)")
        finally:
            os.environ.pop("PAGERANK_TPU_S3_ENDPOINT", None)
            for scheme in ("s3", "s3n", "s3a"):
                fsio.unregister(scheme)
    print(f"phase 13(b): s3 at rmat:{S3_SCALE}: 6 iterations + --resume to "
          f"{ITERS} through the stub ({len(keys)} objects) bit-equal to an "
          f"uninterrupted {ITERS}; K1 {k1} launches")
    return k1


def job_phase(tmp):
    """Phase 13(c): a --job-dir run at rmat:JOB_SCALE built on the card,
    as a subprocess SIGKILLed at solve iteration 5 by ProcessKillPlan,
    then rerun: ingest and build skipped, the solve resumed, the ranks
    and --out bit-equal to an uninterrupted job (in this process)."""
    import signal

    import numpy as np

    from pagerank_tpu_torch import cli, jobs
    from pagerank_tpu_torch.testing.faults import (ProcessKillPlan,
                                                   run_job_subprocess)

    jd, ctrl = os.path.join(tmp, "job"), os.path.join(tmp, "job-ctrl")
    argv = ["--synthetic", f"rmat:{JOB_SCALE}", "--device-build",
            "--dtype", "float32", "--iters", str(ITERS), "--log-every", "0"]
    env = {"PYTHONPATH": ROOT}
    t0 = time.perf_counter()
    # --sync-io in the killed run: its snapshots of iterations 1-6 are
    # on disk when the kill lands (the async writer's queue dies with
    # the process, so the resume point would depend on timing).
    killed = run_job_subprocess(
        argv + ["--job-dir", jd, "--out", f"{jd}/out.tsv", "--sync-io"],
        kill=ProcessKillPlan("solve", 5, signum=int(signal.SIGKILL)),
        env=env, timeout=300)
    t1 = time.perf_counter()
    _check(killed.returncode == -signal.SIGKILL,
           f"job: the killed run exited {killed.returncode}: "
           f"{killed.stderr[-800:]}")
    _check(os.path.exists(f"{jd}/build.npz")
           and not os.path.exists(f"{jd}/solve.npz"),
           "job: after the kill, want build.npz and no solve.npz")
    again = run_job_subprocess(
        argv + ["--job-dir", jd, "--out", f"{jd}/out.tsv"], env=env,
        timeout=300)
    t2 = time.perf_counter()
    _check(again.returncode == 0,
           f"job: the rerun exited {again.returncode}: "
           f"{again.stderr[-800:]}")
    m = re.search(r"resumed from iteration (\d+)", again.stderr)
    _check(m is not None and int(m.group(1)) == 6,
           f"job: the rerun did not resume the solve: {again.stderr[-800:]}")
    _check("2 stage(s) satisfied by durable artifacts: ingest, build"
           in again.stderr, f"job: ingest and build not skipped: "
           f"{again.stderr[-800:]}")
    _reset_counts()
    s = cli.run(argv + ["--job-dir", ctrl, "--out", f"{ctrl}/out.tsv"])
    k1, _, _ = _read_counts()
    arrays, _meta = jobs.load_artifact(f"{jd}/solve.npz")
    _check(np.array_equal(arrays["ranks"], s["ranks"]),
           "job: the resumed job's ranks differ from an uninterrupted job")
    with open(f"{jd}/out.tsv", "rb") as a, open(f"{ctrl}/out.tsv", "rb") as b:
        _check(a.read() == b.read(), "job: --out differs")
    print(f"phase 13(c): job at rmat:{JOB_SCALE} (device build): SIGKILL "
          f"at solve iteration 5 ({t1 - t0:.1f} s), rerun resumed from "
          f"iteration {m.group(1)} with ingest and build skipped "
          f"({t2 - t1:.1f} s); ranks and --out bit-equal to an "
          f"uninterrupted job (K1 {k1} launches in it)")
    return int(m.group(1))


def _flip_changes(state, n):
    """What a one-shot exponent flip of each of the first n elements of
    ``state`` moves w·r by: the lowest exponent bit set halves the
    value, clear doubles it."""
    import numpy as np

    r = state.detach().cpu().numpy()[:n]
    half = (r.astype(np.float32).view(np.int32) & (1 << 23)) != 0
    r = r.astype(np.float64)
    return np.where(half, r / 2, r)


def _flip_seed(changes, floor, iteration=FLIP_ITER):
    """The first DeviceFaultSchedule seed whose one-shot exponent flip
    at ``iteration`` lands on an element whose change exceeds twice the
    detection floor (the copy tolerance times n: an element far below
    it is rounding by construction); returns (seed, element,
    change)."""
    from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                                   flip_element)

    n = len(changes)
    for seed in range(1 << 22):
        frac = DeviceFaultSchedule(seed=seed).flip_fraction(iteration)
        e = flip_element(frac, n, n)
        if changes[e] > 2 * floor:
            return seed, e, float(changes[e])
    raise AssertionError("no flip seed reaches the detection floor")


def _floor(eng, n):
    from pagerank_tpu_torch import sdc as sdc_mod

    return sdc_mod.copy_tolerance(eng._ledger_eps(), n) * n


def sdc_phase(tmp):
    """Phase 13(d): --sdc-check-every 1 at rmat:SINK_SCALE, flat and
    partitioned f32, through the CLI (no breach, bit-equal to the
    unchecked runs), with the detection floor there held above the
    largest change a one-shot exponent flip at FLIP_ITER could make and
    below that of a sign flip of the largest rank, which is then
    injected (detected, transient, redone to the unchecked bits); then, at
    rmat:JOB_SCALE (where such flips clear the floor), on engines over
    the CLI's device graph a one-shot exponent flip at FLIP_ITER
    (detected, transient, redone to the clean bits; K1/K2 launched
    steps + the redo) and a sticky one (DeviceQuarantinedError after
    its redo also breaches)."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, cli
    from pagerank_tpu_torch import sdc as sdc_mod
    from pagerank_tpu_torch.parallel.elastic import DeviceQuarantinedError
    from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                                   install_device_faults)

    out = {}
    for form, extra, idx in (("flat", [], 0),
                             ("partitioned", ["--partition-span", "-1"], 1)):
        kname = "K1" if idx == 0 else "K2"
        want_form = "flat_ell" if form == "flat" else "pallas_partitioned"
        base = ["--synthetic", f"rmat:{SINK_SCALE}", "--device-build",
                "--iters", str(ITERS), "--dtype", "float32",
                "--log-every", "0", *extra]
        _reset_counts()
        plain = cli.run(base)
        checked = cli.run(base + ["--sdc-check-every", "1"])
        counts = _read_counts()[:2]
        _check(checked["form"] == want_form,
               f"sdc {form}: ran {checked['form']}")
        _check(counts[idx] == 2 * ITERS and counts[1 - idx] == 0,
               f"sdc {form}: launches {counts} (want {2 * ITERS} of {kname})")
        rep = checked["sdc"]
        _check(rep["checks"] == ITERS and rep["flips_detected"] == 0,
               f"sdc {form}: {rep}")
        _check(np.array_equal(plain["ranks"], checked["ranks"]),
               f"sdc {form}: the checked run differs from the unchecked")
        med = statistics.median
        ms_plain = med(plain["step_seconds"]) * 1e3
        ms_chk = med(checked["step_seconds"]) * 1e3
        graph = checked["graph"]
        cfg = PageRankConfig(num_iters=ITERS,
                             partition_span=checked["partition_span"])
        eng = TorchEngine(cfg, device="cuda").build_device(graph)
        eng.run(num_iters=FLIP_ITER)
        big_floor = _floor(eng, graph.n)
        big_max = float(_flip_changes(eng._r, graph.n).max())
        # The reference's tolerance is blind to every one-element
        # exponent flip here (ROADMAP queue 3): held, so that a change
        # to the tolerance or the flip kinds shows.
        _check(big_max < big_floor,
               f"sdc {form}: a one-element exponent flip at iteration "
               f"{FLIP_ITER} now moves w·r by up to {big_max:.6g}, past the "
               f"floor {big_floor:.6g}: the blind spot phase 13(d) holds "
               f"has closed")
        # What the tolerance does see here: the sign of the largest rank,
        # which moves w·r by twice that rank.
        hub = int(torch.argmax(eng._r[:graph.n]))
        sign_change = 2 * float(eng._r[hub])
        _check(sign_change > big_floor,
               f"sdc {form}: the largest rank's sign flip moves w·r by "
               f"{sign_change:.6g}, under the floor {big_floor:.6g}")
        del eng
        sdc_mod.reset()
        _reset_counts()
        eng = TorchEngine(cfg.replace(sdc_check_every=1),
                          device="cuda").build_device(graph)
        install_device_faults(eng, DeviceFaultSchedule(
            flip={FLIP_ITER: (0, "sign", (hub + 0.5) / graph.n)}))
        ranks = eng.run()
        counts = _read_counts()[:2]
        rep = sdc_mod.report_section()
        sdc_mod.reset()
        _check(rep["flips_detected"] == 1 and rep["transient"] == 1
               and rep["redos"] == 1 and rep["sticky"] == 0,
               f"sdc {form} rmat:{SINK_SCALE} sign flip: {rep}")
        _check(np.array_equal(ranks, plain["ranks"]),
               f"sdc {form} rmat:{SINK_SCALE}: the redone run differs from "
               f"the unchecked run")
        _check(counts[idx] == ITERS + 1 and counts[1 - idx] == 0,
               f"sdc {form} rmat:{SINK_SCALE} sign flip: launches {counts} "
               f"(want {ITERS} steps + 1 redo)")
        print(f"phase 13(d) {form} rmat:{SINK_SCALE} (span "
              f"{checked['partition_span']}): --sdc-check-every 1: {ITERS} "
              f"checks, no breach, ranks bit-equal to the unchecked run; "
              f"checked step {ms_chk:.4f} ms/iter median against the plain "
              f"step's {ms_plain:.4f} ({ms_chk / ms_plain:.2f}x); detection "
              f"floor {big_floor:.6g} above the largest one-element "
              f"exponent-flip change at iteration {FLIP_ITER} "
              f"{big_max:.6g}; the sign flip of the largest rank (element "
              f"{hub}, change {sign_change:.6g}) detected, transient, "
              f"redone to the unchecked run's bits, {kname} {ITERS} + 1 "
              f"launches")
        del plain, checked, graph, eng

        # The flips, at a scale where one element's flip clears the floor.
        small = ["--synthetic", f"rmat:{JOB_SCALE}", "--device-build",
                 "--iters", str(ITERS), "--dtype", "float32",
                 "--log-every", "0", *extra]
        clean = cli.run(small)
        graph = clean["graph"]
        cfg = PageRankConfig(num_iters=ITERS, sdc_check_every=1,
                             partition_span=clean["partition_span"])
        _check(clean["form"] == want_form, f"sdc {form} rmat:{JOB_SCALE}: "
               f"ran {clean['form']}")
        probe = TorchEngine(cfg.replace(sdc_check_every=0),
                            device="cuda").build_device(graph)
        probe.run(num_iters=FLIP_ITER)
        floor = _floor(probe, graph.n)
        seed, elem, change = _flip_seed(_flip_changes(probe._r, graph.n),
                                        floor)
        del probe
        sdc_mod.reset()
        _reset_counts()
        eng = TorchEngine(cfg, device="cuda").build_device(graph)
        install_device_faults(eng, DeviceFaultSchedule(
            seed=seed, flip={FLIP_ITER: (0, "exponent")}))
        ranks = eng.run()
        counts = _read_counts()[:2]
        rep = sdc_mod.report_section()
        _check(rep["flips_detected"] == 1 and rep["transient"] == 1
               and rep["redos"] == 1 and rep["sticky"] == 0,
               f"sdc {form} one-shot flip: {rep}")
        _check(np.array_equal(ranks, clean["ranks"]),
               f"sdc {form}: the redone run differs from the clean run")
        _check(counts[idx] == ITERS + 1 and counts[1 - idx] == 0,
               f"sdc {form} one-shot flip: launches {counts} (want "
               f"{ITERS} steps + 1 redo)")
        sdc_mod.reset()
        _reset_counts()
        eng = TorchEngine(cfg, device="cuda").build_device(graph)
        install_device_faults(eng, DeviceFaultSchedule(
            seed=seed, flip={FLIP_ITER: (0, "exponent")},
            sticky_flips=[FLIP_ITER]))
        try:
            eng.run()
            raise AssertionError(f"sdc {form}: a sticky flip did not "
                                 f"raise DeviceQuarantinedError")
        except DeviceQuarantinedError as e:
            sticky = _read_counts()[idx]
            _check(e.device_ids == (0,), f"sdc {form}: convicted {e}")
        rep = sdc_mod.report_section()
        _check(rep["sticky"] == 1 and rep["quarantined_devices"] == [0],
               f"sdc {form} sticky: {rep}")
        _check(sticky == FLIP_ITER + 2,
               f"sdc {form} sticky: {kname} {sticky} launches (want "
               f"{FLIP_ITER} steps + the breached step + its redo)")
        sdc_mod.reset()
        print(f"  rmat:{JOB_SCALE}: one-shot exponent flip at iteration "
              f"{FLIP_ITER} (seed {seed}, element {elem}, change "
              f"{change:.6g}, floor {floor:.6g}): detected, transient, "
              f"redone, ranks bit-equal to the clean run, {kname} {ITERS} "
              f"+ 1 launches; the sticky flip raised DeviceQuarantinedError "
              f"on device 0 after {sticky} launches")
        out[form] = {"checked_ms": ms_chk, "plain_ms": ms_plain,
                     "floor": big_floor, "max_flip_change": big_max,
                     "sign_flip_change": sign_change,
                     "launches": {"clean": 2 * ITERS, "one_shot": ITERS + 1,
                                  "sign_flip": ITERS + 1, "sticky": sticky}}
        del graph, clean, eng
    return out


def robustness_phase(tmp):
    """Phase 13: the sinks, S3, a resumable job and the SDC-checked
    step on the card."""
    t0 = time.perf_counter()
    rep = {"sinks": sinks_phase(tmp)}
    rep["s3_launches"] = s3_phase(tmp)
    rep["job_resumed_from"] = job_phase(tmp)
    rep["sdc"] = sdc_phase(tmp)
    print(f"robustness phase took {time.perf_counter() - t0:.1f} s")
    return rep


# Phase 14: the run's own observability, at rmat:OBS_SCALE built on the
# card (flat through K1, partitioned through K2 with f32 windows).

OBS_SCALE = 22
OBS_TOPK = 64
#: The fit check's band: the predicted peak must hold the measured one
#: (an upper bound) and stay within this factor of it.
FIT_BAND = 1.25
STALL_SCALE = 16
DAEMON_SCALE = 16


def _obs_graph(scale, span):
    """rmat:``scale`` generated and built on the card (the CLI's
    --device-build graph: raw edges, no weight plane)."""
    import torch

    from pagerank_tpu_torch.ops import device_build as db

    cuda = torch.device("cuda")
    src, dst = db.rmat_edges_device(scale, device=cuda)
    return db.build_ell_device(src, dst, 1 << scale, stripe_size=span,
                               with_weights=False, device=cuda)


def probes_phase():
    """14(a): ``engine.run(probes=ConvergenceProbes(1, 64))`` flat (K1)
    and at --partition-span -1 (K2, f32 windows): the ranks bit-equal
    to the unprobed run's; every probe's engine-space ids, churn and
    top-k mass equal to a stable argsort of the engine-space rank
    vector on the host; the ledger names no leak; K1/K2 10 launches a
    run; the probed step beside the plain step (CUDA events)."""
    import numpy as np

    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.obs.probes import ConvergenceProbes
    from pagerank_tpu_torch.ops.device_build import plan_partition_span

    n = 1 << OBS_SCALE
    out = {}
    for label, part in (("flat (K1)", 0), ("partitioned (K2)", -1)):
        cfg = PageRankConfig(num_iters=ITERS)
        span = plan_partition_span(cfg, n, 16 << OBS_SCALE, part) if part \
            else 0
        cfg = cfg.replace(partition_span=span)
        dg = _obs_graph(OBS_SCALE, span)
        plain = TorchEngine(cfg).build_device(dg).run()
        eng = TorchEngine(cfg).build_device(dg)
        held = {"probes": 0, "prev": None}

        class HeldProbes(ConvergenceProbes):
            def commit(self, iteration, info, ids_engine, ids_original):
                r = eng._r[:n].double().cpu().numpy()
                want = np.argsort(-r, kind="stable")[:OBS_TOPK]
                got = ids_engine.cpu().numpy()
                _check(np.array_equal(got, want),
                       f"14(a) {label}: probe {iteration}'s ids differ from "
                       f"the host's stable argsort")
                _check(np.array_equal(eng._perm[want], ids_original),
                       f"14(a) {label}: original-space ids differ")
                churn = (0 if held["prev"] is None else
                         int(OBS_TOPK - np.isin(want, held["prev"]).sum()))
                _check(info["topk_churn"] == churn,
                       f"14(a) {label}: churn {info['topk_churn']} != "
                       f"{churn}")
                tm = float(r[want].sum())
                _check(abs(info["topk_mass"] - tm) <= 1e-5 * abs(tm),
                       f"14(a) {label}: top-k mass {info['topk_mass']} vs "
                       f"{tm}")
                _check(info["mass_ledger"]["leak"] is None,
                       f"14(a) {label}: the ledger names "
                       f"{info['mass_ledger']['leak']}")
                held["prev"], held["probes"] = want, held["probes"] + 1
                return super().commit(iteration, info, ids_engine,
                                      ids_original)

        _reset_counts()
        probed = eng.run(probes=HeldProbes(1, topk=OBS_TOPK))
        k1, k2, others = _read_counts()
        launches = k2 if part else k1
        _check(launches == ITERS and (k1 if part else k2) == 0
               and not any(others.values()),
               f"14(a) {label}: K1 {k1}, K2 {k2}, others {others}")
        _check(np.array_equal(probed, plain),
               f"14(a) {label}: probed ranks differ from the unprobed run")
        _check(held["probes"] == ITERS, f"14(a) {label}: {held} probes")
        # The probed step beside the plain step, on one engine.
        timer = TorchEngine(cfg).build_device(dg)
        tp = ConvergenceProbes(1, topk=OBS_TOPK)
        plain_ms = _median_ms(timer.step, 21)
        probed_ms = _median_ms(lambda: timer.step_probed(tp), 21)
        print(f"14(a) {label} rmat:{OBS_SCALE} (span {span}): probed ranks "
              f"bit-equal to the unprobed run; {held['probes']} probes' "
              f"ids, churn and top-{OBS_TOPK} mass equal to the host's "
              f"stable argsort, ledger clean; {'K2' if part else 'K1'} "
              f"{launches} launches; step {plain_ms:.4f} ms plain, "
              f"{probed_ms:.4f} ms probed ({probed_ms / plain_ms:.2f}x; "
              f"CUDA events, median of 21)")
        # Where the probed step's time goes, beside the plain step's.
        sym = "ell_contrib_part_kernel" if part else "ell_contrib_kernel"
        split = {}
        for name, fn in (("plain", timer.step),
                         ("probed", lambda: timer.step_probed(tp))):
            wall, per_kernel, calls, _, _ = _profile_steps(fn, 10)
            busy = sum(per_kernel.values())
            k_ms = sum(v for k, v in per_kernel.items() if _named(k, sym))
            top = sorted(((v, k) for k, v in per_kernel.items()
                          if not _named(k, sym)), reverse=True)[:6]
            split[name] = {"wall_ms": wall, "busy_ms": busy,
                           "kernel_ms": k_ms}
            print(f"  {name} step split: wall {wall:.4f} ms/step; device "
                  f"busy {busy:.4f} = {'K2' if part else 'K1'} {k_ms:.4f} "
                  f"+ other {busy - k_ms:.4f} ms in "
                  f"{sum(calls.values()) / 10:.1f} kernels a step; idle "
                  f"{1 - busy / wall:.1%}; largest others (ms/step): "
                  + "; ".join(f"{v:.4f} {k[:40]}" for v, k in top))
        out["K2" if part else "K1"] = {
            "launches": launches, "plain_ms": plain_ms,
            "probed_ms": probed_ms, "span": span, "split": split}
        del dg, eng, timer, plain, probed
    return out


def _host_graph_of(dg):
    """The deduplicated edges of a flat device graph, fetched to the
    host and built into a host Graph (original ids)."""
    import numpy as np

    from pagerank_tpu_torch import build_graph
    from pagerank_tpu_torch.ops import LANES

    src = dg.src.cpu().numpy()
    rb = dg.row_block.cpu().numpy().astype(np.int64)
    perm = dg.perm.cpu().numpy().astype(np.int64)
    live = src != dg.n_padded
    lane = np.broadcast_to(np.arange(LANES), src.shape)
    dst_rel = (rb[:, None] * LANES + lane)[live]
    return build_graph(perm[src[live]], perm[dst_rel], n=dg.n)


def full_obs_phase(tmp):
    """14(b): one flat rmat:OBS_SCALE run through cli.run with
    --run-report, --trace, --metrics-textfile, --metrics-port,
    --device-sample-every 1, --graph-profile and --history."""
    import urllib.request

    import torch

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.obs import graph_profile, live, report

    rep_p, tr_p, prom_p, hist_p = (os.path.join(tmp, x) for x in (
        "obs_report.json", "obs_trace.json", "obs.prom", "obs_hist.jsonl"))
    scraped = {}
    close = live.MetricsExporter.close

    def scrape_then_close(self):
        # One HTTP scrape of the live endpoint, before it shuts down.
        if self.port is not None and "body" not in scraped:
            url = f"http://127.0.0.1:{self.port}/metrics"
            with urllib.request.urlopen(url, timeout=30) as r:
                scraped["body"] = r.read().decode()
        close(self)

    live.MetricsExporter.close = scrape_then_close
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    try:
        s = cli.run(["--synthetic", f"rmat:{OBS_SCALE}", "--device-build",
                     "--iters", str(ITERS), "--log-every", "0",
                     "--run-report", rep_p, "--trace", tr_p,
                     "--metrics-textfile", prom_p, "--metrics-port", "0",
                     "--device-sample-every", "1", "--graph-profile",
                     "--history", hist_p])
    finally:
        live.MetricsExporter.close = close
    peak = torch.cuda.max_memory_allocated()
    k1, k2, _ = _read_counts()
    _check(k1 == ITERS and k2 == 0, f"14(b): K1 {k1}, K2 {k2}")
    with open(rep_p) as f:
        rep = json.load(f)
    missing = [k for k in report.REPORT_KEYS if k not in rep]
    _check(not missing, f"14(b): report lacks {missing}")
    for key in ("environment", "config", "spans", "metrics", "iterations",
                "summary", "robustness", "costs", "devices", "graph"):
        _check(rep[key], f"14(b): report section {key} is empty")
    env = rep["environment"]
    _check(env["backend"] == "cuda" and env["power_limit"],
           f"14(b): environment {env}")
    with open(tr_p) as f:
        chrome = json.load(f)
    steps = [e for e in chrome["traceEvents"]
             if e.get("name") == "solve/step" and e.get("ph") == "X"]
    _check(len(steps) == ITERS, f"14(b): {len(steps)} solve/step spans")
    body = scraped.get("body", "")
    samples = [ln for ln in body.splitlines() if ln and ln[0] != "#"]
    for ln in samples:
        name, value = ln.rsplit(" ", 1)
        float(value)  # every sample parses
    _check(f"pagerank_solve_iteration {ITERS}" in samples,
           f"14(b): the scrape ({len(samples)} samples) lacks the solve "
           f"gauge")
    dev = rep["devices"]
    _check(dev["hbm_high_water_bytes"] is not None
           and dev["hbm_high_water_bytes"] >= peak,
           f"14(b): watermark {dev['hbm_high_water_bytes']} < "
           f"max_memory_allocated {peak}")
    # The device profile's integer stats against profile_graph over the
    # same graph on the host.
    t0 = time.perf_counter()
    prof = rep["graph"]["profile"]
    host = graph_profile.profile_graph(_host_graph_of(s["graph"]),
                                       raw_edges=16 << OBS_SCALE).summary()
    for key in ("n", "num_edges", "raw_edges", "duplicate_edges",
                "self_loops", "dangling_count", "zero_in_count", "in_hist",
                "out_hist", "top_hub_in_degrees", "partition_edges"):
        _check(prof[key] == host[key], f"14(b): profile {key} differs "
               f"from the host's")
    kth = prof["top_hub_in_degrees"][-1]
    for a, b, d in zip(prof["top_hub_ids"], host["top_hub_ids"],
                       prof["top_hub_in_degrees"]):
        _check(a == b or d == kth, f"14(b): hub {a} != {b} (degree {d})")
    host_s = time.perf_counter() - t0
    costs = rep["costs"]["step"]
    with open(hist_p) as f:
        rec = json.loads(f.readline())
    print(f"14(b) full observability, rmat:{OBS_SCALE} flat: report "
          f"sections {len(rep)} (every REPORT_KEYS), {len(steps)} "
          f"solve/step spans, one scrape of {len(samples)} samples, "
          f"watermark {dev['hbm_high_water_bytes'] / 1e9:.3f} GB >= "
          f"max_memory_allocated {peak / 1e9:.3f} GB over "
          f"{dev['samples']} samples; step "
          f"{rep['summary']['mean_iter_seconds'] * 1e3:.4f} ms/iter mean "
          f"(median {statistics.median(s['step_seconds']) * 1e3:.4f}); "
          f"K1 bytes {costs['bytes_per_iter']:.0f}, achieved share of the "
          f"byte bound {costs['roofline_fraction']:.1%}; device profile = "
          f"the host's ({host_s:.1f} s); history leg {list(rec['legs'])}")
    return {"launches": k1, "step_ms": statistics.median(
        s["step_seconds"]) * 1e3, "watermark": dev["hbm_high_water_bytes"],
        "peak": peak, "share": costs["roofline_fraction"]}


def preflight_phase():
    """14(c): --preflight's predicted peak against the measured
    max_memory_allocated of device builds at rmat:22 and rmat:24, and
    the smallest R-MAT scale it refuses exiting 3 with nothing
    allocated."""
    import contextlib
    import io

    import torch

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.obs import devices as obs_devices

    out = {}
    for scale in (22, 24):
        res = obs_devices.fit_check(scale)
        pred = res.peak_stage.bytes
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            cli.run(["--synthetic", f"rmat:{scale}", "--device-build",
                     "--iters", "1", "--log-every", "0", "--preflight"])
        meas = torch.cuda.max_memory_allocated() - base
        _check("FITS" in err.getvalue(), f"14(c) rmat:{scale}: no FITS "
               f"table on stderr")
        _check(meas <= pred <= FIT_BAND * meas,
               f"14(c) rmat:{scale}: predicted {pred} B outside [measured "
               f"{meas}, {FIT_BAND} x measured]")
        print(f"14(c) --preflight rmat:{scale}: predicted peak {pred / 1e9:.3f}"
              f" GB ({res.peak_stage.stage}), measured max_memory_allocated "
              f"{meas / 1e9:.3f} GB ({pred / meas:.4f}x; band [1, "
              f"{FIT_BAND}]); limit {res.limit_bytes / 1e9:.3f} GB "
              f"[{res.limit_source}]")
        out[scale] = {"predicted": pred, "measured": meas}
    refused = next(s for s in range(20, 40)
                   if not obs_devices.fit_check(s).fits)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            cli.run(["--synthetic", f"rmat:{refused}", "--device-build",
                     "--preflight"])
        code = 0
    except SystemExit as e:
        code = e.code
    _check(code == 3, f"14(c) rmat:{refused}: exit {code}, want 3")
    _check(torch.cuda.max_memory_allocated() == before
           and torch.cuda.memory_allocated() == before,
           f"14(c) rmat:{refused}: the refused run allocated on the card")
    verdict = err.getvalue().strip().splitlines()[-1]
    print(f"14(c) smallest refused scale rmat:{refused}: exit 3, nothing "
          f"allocated; {verdict}")
    out["refused"] = refused
    return out


def stall_phase(tmp):
    """14(d): a step stalled by testing/faults.py (a 2 s delay at
    iteration 3) under --stall-timeout 0.5: ``raise`` ends the run as
    the JAX CLI does (the SIGINT drain, exit 75, the diagnostic);
    ``warn`` logs and finishes."""
    import contextlib
    import io

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.engines.torch_engine import TorchEngine
    from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                                   install_device_faults)

    build = TorchEngine.build_device

    def stalled_build(self, dg):
        build(self, dg)
        install_device_faults(self, DeviceFaultSchedule(delay={3: (0, 2.0)}))
        return self

    TorchEngine.build_device = stalled_build
    out = {}
    try:
        for action, want in (("raise", 75), ("warn", 0)):
            err = io.StringIO()
            _reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["--synthetic", f"rmat:{STALL_SCALE}",
                               "--device-build", "--iters", str(ITERS),
                               "--log-every", "0", "--stall-timeout", "0.5",
                               "--stall-action", action])
            wall = time.perf_counter() - t0
            text = err.getvalue()
            k1 = _read_counts()[0]
            diag = [ln for ln in text.splitlines() if "STALL WATCHDOG" in ln]
            _check(rc == want and diag, f"14(d) {action}: exit {rc} (want "
                   f"{want}), stall lines {diag}")
            if action == "raise":
                _check("interrupted by SIGINT; drained" in text and k1 < ITERS,
                       f"14(d) raise: no drain ({k1} launches)")
            else:
                _check(k1 == ITERS, f"14(d) warn: K1 {k1}")
            print(f"14(d) --stall-action {action}: exit {rc} in {wall:.2f} s, "
                  f"K1 {k1} launches; {diag[0].strip()}")
            out[action] = k1
    finally:
        TorchEngine.build_device = build
    return out


def profiler_phase(tmp):
    """14(e): --profile-dir writes a torch.profiler Chrome trace that
    names K1."""
    from pagerank_tpu_torch import cli

    pdir = os.path.join(tmp, "profile")
    _reset_counts()
    cli.run(["--synthetic", f"rmat:{STALL_SCALE}", "--device-build",
             "--iters", str(ITERS), "--log-every", "0", "--profile-dir",
             pdir])
    k1 = _read_counts()[0]
    with open(os.path.join(pdir, "trace.json")) as f:
        doc = json.load(f)
    names = [e.get("name", "") for e in doc["traceEvents"]]
    # CUPTI may drop a launch or two at the start of a trace (phase 4's
    # profiler split skips one warm-up step for that): the trace must
    # name K1, not hold every launch.
    hits = sum("ell_contrib_kernel" in nm for nm in names)
    _check(hits >= 1 and k1 == ITERS,
           f"14(e): {hits} ell_contrib_kernel events, K1 {k1}")
    print(f"14(e) --profile-dir: trace.json of {len(names)} events, "
          f"{hits} name ell_contrib_kernel; K1 {k1} launches")
    return k1


def daemon_obs_phase(tmp):
    """14(f): the daemon as a process on the card with --metrics-port
    (OpenMetrics, scraped once) and --run-report (written on the
    SIGTERM drain, with the serving section)."""
    import signal
    import urllib.request

    rep_p = os.path.join(tmp, "serve_report.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pagerank_tpu_torch.serve", "--scale",
         str(DAEMON_SCALE), "--iters", str(PPR_ITERS), "--port", "0",
         "--metrics-port", "0", "--metrics-format", "openmetrics",
         "--run-report", rep_p],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    try:
        line = proc.stdout.readline()
        _check("serving PPR on" in line, f"14(f): daemon said {line!r}: "
               f"{proc.stderr.read()[-2000:] if proc.poll() is not None else ''}")
        port = int(line.split("127.0.0.1:")[1].split("/")[0])
        mport = int(line.split("metrics :")[1].split(")")[0])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/ppr?source=5", timeout=60) as r:
            ans = json.loads(r.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/metrics", timeout=60) as r:
            body = r.read().decode()
        samples = [ln for ln in body.splitlines() if ln and ln[0] != "#"]
        for ln in samples:
            float(ln.split(" # ")[0].rsplit(" ", 1)[1])
        _check(body.endswith("# EOF\n") and any(
            "pagerank_serve_" in ln for ln in samples),
            f"14(f): the scrape has no serve samples")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(rep_p) as f:
        rep = json.load(f)
    _check(rc == 75 and rep["serving"]["enabled"]
           and rep["environment"]["backend"] == "cuda",
           f"14(f): exit {rc}, serving {rep['serving']}")
    print(f"14(f) daemon rmat:{DAEMON_SCALE}: one query answered "
          f"({len(ans.get('ids', ans.get('topk_ids', [])))} ids), one "
          f"OpenMetrics scrape of {len(samples)} samples, SIGTERM -> exit "
          f"{rc} with the run report (serving: {rep['serving'].get('settled')}"
          f" settled)")
    return rc


def observability_phase(tmp):
    """Phase 14: probes, the full observability run, the preflight, the
    stall watchdog, the profiler and the daemon's exporter."""
    t0 = time.perf_counter()
    rep = {"probes": probes_phase(), "full": full_obs_phase(tmp),
           "preflight": preflight_phase(), "stall": stall_phase(tmp),
           "profiler_launches": profiler_phase(tmp),
           "daemon_rc": daemon_obs_phase(tmp)}
    print(f"observability phase took {time.perf_counter() - t0:.1f} s")
    return rep


# Phase 18: the fused run. (d) runs textbook semantics: under the
# reference semantics a raw device-built R-MAT graph's ranks grow every
# step (zero-in retention and dangling mass), so no tol is reached; in
# textbook semantics the f64 delta falls about tenfold every two steps,
# so each of FUSED_TOLS stops it in the twenties of FUSED_TOL_BUDGET: at
# 24 for 1e-10 on the card (a chunk edge, no masked step) and before it
# for 1e-9 (masked steps). (f) times calls of FUSED_K and 2 x FUSED_K
# iterations, FUSED_REPEATS times each in turns.
FUSED_TOL_SCALE = 18
FUSED_TOLS = (1e-9, 1e-10)
FUSED_TOL_BUDGET = 100
FUSED_K = 40
FUSED_REPEATS = 5


def _fused_forms(scale):
    """The configurations of 18(a)-(c): {label: (config, kernel)}, the
    K2 forms at the span --partition-span -1 resolves at rmat:scale."""
    from pagerank_tpu_torch import PageRankConfig
    from pagerank_tpu_torch.ops.device_build import plan_partition_span

    cfg = PageRankConfig(num_iters=ITERS)
    span = plan_partition_span(cfg, 1 << scale, 16 << scale, -1)
    part = cfg.replace(partition_span=span)
    return {"flat": (cfg, "K1"),
            "K2": (part, "K2"),
            "K2 (bf16 windows)": (part.replace(stream_dtype="bfloat16"),
                                  "K2"),
            "flat, f64 sums": (cfg.replace(accum_dtype="float64"), "K1")}


def _fused_against_stepwise(label, eng, kernel):
    """18(a)-(c) on one engine: a stepwise ``run()`` of ITERS from r0
    with its traces, then ``run_fused()`` from r0 with every launch
    count set to 0 just before and read just after, then ``run_fast()``
    from r0; the engine is left at r0. Returns run_fused's launches of
    ``kernel``."""
    import numpy as np

    r0 = eng.ranks()
    infos = []
    want = eng.run(on_iteration=lambda i, info: infos.append(
        (info["l1_delta"], info["dangling_mass"])))
    eng.set_ranks(r0, 0)
    _reset_counts()
    got = eng.run_fused()
    k1, k2, others = _read_counts()
    mine, theirs = (k2, k1) if kernel == "K2" else (k1, k2)
    _check(mine == ITERS and theirs == 0 and not any(others.values()),
           f"18 {label}: run_fused of {ITERS} made K1 {k1}, K2 {k2}, "
           f"others {others}")
    _check(np.array_equal(got, want),
           f"18 {label}: run_fused's ranks differ from run()'s")
    tr = eng.last_run_metrics
    traces = np.stack([tr["l1_delta"].cpu().numpy(),
                       tr["dangling_mass"].cpu().numpy()], 1)
    _check(tr["l1_delta"].device.type == "cuda"
           and np.array_equal(traces.astype(np.float64), np.array(infos)),
           f"18 {label}: run_fused's traces differ from run()'s")
    eng.set_ranks(r0, 0)
    _check(np.array_equal(eng.run_fast(), want),
           f"18 {label}: run_fast's ranks differ from run()'s")
    eng.set_ranks(r0, 0)
    print(f"18 {label}: run_fused() of {ITERS} torch.equal to run(), "
          f"traces equal, {kernel} {mine} launches; run_fast() equal")
    return mine


def _fused_timing(label, eng, kernel, symbol):
    """18(f): ms/iter of ``run()``, ``run_fast()`` and ``run_fused()`` on
    ``eng``. Each call starts from the state the engine holds now,
    restored on the card (the reference semantics' ranks grow without
    bound on a raw R-MAT graph: f32 overflows after some 370 steps), and
    ends in a device sync in place of its fetch of the ranks, so that a
    call's host wall is its steps. ms/iter: the wall of a call of 2 x
    FUSED_K iterations less one of FUSED_K, over FUSED_K, the median of
    FUSED_REPEATS, the modes in turns, each call's launches of ``kernel``
    counted (one a step). Busy: the device time of a call of 2 x FUSED_K
    iterations under torch.profiler over its iterations (such a call
    holds its steps' work and nothing else; the profiler's count of the
    kernel is printed: it has dropped an event at rmat:22); idle 1 -
    busy / ms."""
    import torch

    start = eng._save_solve_state()
    modes = {"run": eng.run, "run_fast": eng.run_fast,
             "run_fused": eng.run_fused}
    k = FUSED_K
    walls = {(m, n): [] for m in modes for n in (k, 2 * k)}

    def from_start(run, n):
        eng._restore_solve_state(start)
        run(n)

    eng.ranks = lambda: torch.cuda.synchronize(eng.device)
    try:
        for run in modes.values():
            from_start(run, 2)
        for _ in range(FUSED_REPEATS):
            for m, run in modes.items():
                for n in (k, 2 * k):
                    eng._restore_solve_state(start)
                    torch.cuda.synchronize()
                    _reset_counts()
                    t = time.perf_counter()
                    run(n)
                    walls[m, n].append((time.perf_counter() - t) * 1e3)
                    k1, k2, _ = _read_counts()
                    _check((k2 if kernel == "K2" else k1) == n,
                           f"18(f) {label} {m}: K1 {k1}, K2 {k2} in {n} "
                           f"iterations")
        prof = {m: _profile_steps(
                    lambda run=run: from_start(run, 2 * k), 1)
                for m, run in modes.items()}
    finally:
        del eng.ranks
        eng._restore_solve_state(start)
    out = {}
    for m in modes:
        ms = (statistics.median(walls[m, 2 * k])
              - statistics.median(walls[m, k])) / k
        busy = sum(prof[m][1].values()) / (2 * k)
        seen = sum(c for name, c in prof[m][2].items()
                   if _named(name, symbol))
        out[m] = {"ms_per_iter": ms, "busy_ms": busy,
                  "idle": 1 - busy / ms}
        print(f"18(f) {label} {m}: {ms:.4f} ms/iter (host wall, "
              f"{2 * k} less {k} iterations, median of {FUSED_REPEATS}); "
              f"device busy {busy:.4f} ms/iter, idle "
              f"{out[m]['idle']:.1%}; {kernel} one launch a step (the "
              f"profiler saw {seen} {symbol} in {2 * k} iterations)")
    return out


def fused_phase(scale, tmp):
    """Phase 18: the fused run forms on the card (module docstring);
    returns {"K1": ..., "K2": ...} for the kernels line."""
    import shutil

    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, cli

    t0 = time.perf_counter()
    got = {"K1": {}, "K2": {}}
    dgs = {}
    for label, (cfg, kernel) in _fused_forms(scale).items():
        span = cfg.partition_span
        if span not in dgs:
            dgs[span] = _obs_graph(scale, span)
        eng = TorchEngine(cfg).build_device(dgs[span])
        got[kernel][label] = {
            "run_fused_launches": _fused_against_stepwise(label, eng,
                                                          kernel)}
        if "f64" not in label:
            got[kernel][label].update(_fused_timing(
                label, eng, kernel, "ell_contrib_part_kernel"
                if kernel == "K2" else "ell_contrib_kernel"))
        del eng
    del dgs
    torch.cuda.empty_cache()
    print(f"18(a)-(c), (f) took {time.perf_counter() - t0:.1f} s")

    # (d) the tol form against the host-checked run.
    dg = _obs_graph(FUSED_TOL_SCALE, 0)
    chunk = TorchEngine.FUSED_TOL_CHUNK
    for tol in FUSED_TOLS:
        cfg = PageRankConfig(num_iters=FUSED_TOL_BUDGET, dtype="float64",
                             accum_dtype="float64", semantics="textbook",
                             tol=tol)
        host = TorchEngine(cfg).build_device(dg)
        want = host.run()
        fused = TorchEngine(cfg).build_device(dg)
        _reset_counts()
        r = fused.run_fused_tol()
        k1, _, _ = _read_counts()
        stop = fused.iteration
        final = float(fused.last_run_metrics["l1_delta"][0])
        queued = min(FUSED_TOL_BUDGET, -(-stop // chunk) * chunk)
        _check(0 < stop == host.iteration < FUSED_TOL_BUDGET
               and final <= tol and np.array_equal(r, want)
               and k1 == queued,
               f"18(d) tol {tol:g}: stop {stop} vs the host's "
               f"{host.iteration}, final delta {final}, K1 {k1} (want "
               f"{queued}), ranks equal {np.array_equal(r, want)}")
        print(f"18(d) run_fused_tol rmat:{FUSED_TOL_SCALE} f64 textbook, "
              f"tol {tol:g}: stops at iteration {stop} as the host-checked "
              f"run(), final delta {final:.6g}, ranks torch.equal; K1 {k1} "
              f"launches ({stop} live + {k1 - stop} masked, chunks of "
              f"{chunk})")
        got["K1"][f"tol {tol:g}"] = {"stop": stop, "launches": k1}
        del host, fused
    del dg

    # (e) the CLI: fused against stepwise, then in an NCCL group of one.
    t_cli = time.perf_counter()
    d = os.path.join(tmp, "fused_cli")
    base = ["--synthetic", f"rmat:{scale}", "--device-build", "--iters",
            str(ITERS), "--snapshot-every", "2", "--log-every", "0"]
    runs = {}
    for label, extra in (("fused", ["--fused"]), ("stepwise", [])):
        sd = os.path.join(d, label)
        _reset_counts()
        s = cli.run(base + extra + ["--snapshot-dir", sd, "--run-report",
                                    os.path.join(d, f"{label}.json")])
        k1, k2, others = _read_counts()
        want_k1 = ITERS + (1 if extra else 0)  # + prepare_fused's step
        _check(k1 == want_k1 and k2 == 0 and not any(others.values())
               and s["writer"] == "async"
               and s["report"]["fused"] is bool(extra),
               f"18(e) CLI {label}: K1 {k1}, K2 {k2}, writer {s['writer']}, "
               f"report fused {s['report']['fused']}")
        runs[label] = (s, _tree_digest(sd))
    files = runs["stepwise"][1]
    _check(len(files) == ITERS // 2 and runs["fused"][1] == files
           and np.array_equal(runs["fused"][0]["ranks"],
                              runs["stepwise"][0]["ranks"]),
           "18(e): the fused CLI's snapshots differ from the stepwise one's")
    fused_ms = runs["fused"][0]["report"]["summary"]["mean_iter_seconds"]
    step_ms = statistics.median(runs["stepwise"][0]["step_seconds"])
    walls = {k: v[0]["solve_seconds"] for k, v in runs.items()}
    sinks = "; ".join(
        f"{k} save median "
        f"{statistics.median(v[0]['snapshot_seconds']) * 1e3:.3f} ms, "
        f"queue wait {sum(v[0]['queue_wait_seconds']) * 1e3:.3f} ms"
        for k, v in runs.items())
    sd = os.path.join(d, "nccl")
    _reset_counts()
    rc = cli.main(base + ["--fused", "--num-devices", "1", "--snapshot-dir",
                          sd])
    k1, _, _ = _read_counts()
    last = np.load(os.path.join(sd, f"ranks_iter{ITERS}.npz"))["ranks"]
    _check(rc == 0 and k1 == ITERS + 1
           and np.array_equal(last, runs["fused"][0]["ranks"]),
           f"18(e) CLI --fused --num-devices 1: rc {rc}, K1 {k1}, ranks "
           f"equal {np.array_equal(last, runs['fused'][0]['ranks'])}")
    print(f"18(e) CLI --fused --device-build rmat:{scale}, --snapshot-every "
          f"2 through the async writer: {len(files)} snapshot files "
          f"byte-equal to the stepwise run's, report fused true, K1 "
          f"{ITERS} + 1 (prepare_fused) launches; solve wall to the last "
          f"write {walls['fused']:.4f} s fused ({fused_ms * 1e3:.4f} ms/iter "
          f"averaged: the fused wall holds the final fetch of the ranks) "
          f"against {walls['stepwise']:.4f} s stepwise (median step "
          f"{step_ms * 1e3:.4f} ms; {sinks}); under NCCL in a group of one "
          f"the same ranks bit for bit; {time.perf_counter() - t_cli:.1f} s")
    got["K1"]["cli_launches"] = ITERS + 1
    got["K1"]["cli_solve_s"] = walls
    got["K1"]["cli_ms_per_iter"] = fused_ms * 1e3
    got["K1"]["cli_stepwise_ms"] = step_ms * 1e3
    shutil.rmtree(d, ignore_errors=True)
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    return got


# Phase 15: sharded execution. The card has one GPU, and NCCL refuses
# two ranks of one device, so the ranks share cuda:0 under gloo (which
# stages each collective through host memory: its times say nothing of
# NCCL across cards); NCCL runs at world 1 through the CLI.
SHARD_WORLD = 2
#: The R-MAT scale of phase 15, cut from the main path's 22 to make
#: room for phase 19 ((a), (c)) and phase 20 ((b)).
SHARD_SCALE = 20


def _shard_refs(d):
    """Phase 15(a)'s graph (rmat:SHARD_SCALE, its deduplicated edges
    written to ``edges_a.npz`` in ``d``), its span from the CLI's
    resolver at -1 and the one-device runs on cuda that its forms are
    held to: the flat form and the partitioned form in f32 and bf16
    windows. Returns (n, span, {flat, part_f32, part_bf16: ranks})."""
    import numpy as np

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, cli
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.utils.synth import rmat_edges

    graph = build_graph(*rmat_edges(SHARD_SCALE), n=1 << SHARD_SCALE)
    np.savez(os.path.join(d, "edges_a.npz"), src=graph.src, dst=graph.dst,
             n=graph.n)
    span = cli.plan_partition_span(PageRankConfig(), graph.n,
                                   graph.num_edges, -1)
    refs, step_s = {}, []
    t_last = [0.0]

    def on_iteration(i, info):
        now = time.perf_counter()
        step_s.append(now - t_last[0])
        t_last[0] = now

    for key, kw in (("flat", {}), ("part_f32", {"partition_span": span}),
                    ("part_bf16", {"partition_span": span,
                                   "stream_dtype": "bfloat16"})):
        eng = TorchEngine(PageRankConfig(num_iters=ITERS, **kw),
                          device="cuda").build(graph)
        t_last[0] = time.perf_counter()
        refs[key] = eng.run(on_iteration=on_iteration if key == "flat"
                            else None)
    # The flat run's median host wall of a step (engine.run, two host
    # fetches a step), what 15(b)'s CLI step is set beside.
    return graph.n, span, refs, statistics.median(step_s[1:]) * 1e3


def _shard_forms(span):
    """(name, config fields, kernel) of each phase-15(a) run."""
    return [
        ("edge_flat", {}, "K1"),
        ("edge_part_f32", {"partition_span": span}, "K2"),
        ("edge_part_bf16", {"partition_span": span,
                            "stream_dtype": "bfloat16"}, "K2"),
        ("vertex_sharded", {"vertex_sharded": True}, "K1"),
        ("vertex_sharded_checked", {"vertex_sharded": True,
                                    "sdc_check_every": 1}, "K1"),
        ("edge_flat_f64sums", {"accum_dtype": "float64"}, "K1"),
        ("vertex_sharded_f64sums", {"accum_dtype": "float64",
                                    "vertex_sharded": True}, "K1"),
        # Phase 15(c): the vertex-sharded exchange forms.
        ("vs_halo", dict(HALO), "K1"),
        ("vs_halo_f64sums", dict(HALO, accum_dtype="float64"), "K1"),
        ("vs_halo_async", dict(HALO, halo_async=True,
                               halo_async_min_gain=0.0), "K1"),
        ("vs_halo_lag0", dict(HALO, halo_async=True, stale_max_lag=0),
         "K1"),
        ("vs_halo_checked", dict(HALO, sdc_check_every=1), "K1"),
        ("vs_bounded", {"vertex_sharded": True, "vs_bounded": True}, "K1"),
    ]


HALO = {"vertex_sharded": True, "halo_exchange": True}
#: The forms whose exchange phase 15(c) attributes.
ATTRIBUTED = ("vertex_sharded", "vs_halo")


def _plain_lag1(graph, pack, world, iters, dev):
    """vs_halo_async's schedule in plain PyTorch, f32 as the run: each
    slot row's sums read z of this iteration at sources its rank owns
    and z of the last iteration elsewhere (the first iteration reads
    its own z: the primed slot), by ``torch.sparse.mm`` over the slots
    split so; then the engine's update. The rows are shared as
    ``TorchEngine._pad_rows`` shares them. Returns the ranks in
    original order."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import graph as graph_mod
    from pagerank_tpu_torch.models import pagerank as pr_model
    from pagerank_tpu_torch.ops import spmv

    n, n_pad = graph.n, pack.n_padded
    per = -(-pack.num_rows // (world * 256)) * 256
    unit = 128 * world
    blk = -(-n_pad // unit) * unit // world
    r_idx, lane = np.nonzero(pack.weight != 0)
    src = pack.src[r_idx, lane].astype(np.int64)
    dst = pack.row_block[r_idx].astype(np.int64) * 128 + lane
    local = (r_idx // per) == (src // blk)
    del r_idx, lane

    def csr(sel):
        idx = torch.from_numpy(np.stack([dst[sel], src[sel]])).to(dev)
        a = torch.sparse_coo_tensor(
            idx, torch.ones(idx.shape[1], dtype=torch.float32, device=dev),
            (n_pad, n_pad))
        return a.coalesce().to_sparse_csr()

    a_own, a_rest = csr(local), csr(~local)
    perm = pack.perm

    def relabel(a, dtype):
        out = torch.zeros(n_pad, dtype=dtype, device=dev)
        out[:n] = torch.from_numpy(np.asarray(a)[perm]).to(dev).to(dtype)
        return out

    inv = relabel(graph_mod.inv_out_degree(graph.out_degree), torch.float32)
    dangling = relabel(graph.dangling_mask, torch.bool)
    zero_in = relabel(graph.zero_in_mask, torch.bool)
    valid = relabel(np.ones(n, bool), torch.bool)
    r = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    r[:n] = pr_model.initial_rank(n, "reference", torch.float32, dev)
    z_last = None
    for _ in range(iters):
        z = r * inv
        stale = z if z_last is None else z_last
        contrib = (torch.sparse.mm(a_own, z[:, None])
                   + torch.sparse.mm(a_rest, stale[:, None]))[:, 0]
        m = spmv.dangling_mass(r, dangling, torch.float32)
        r_new = pr_model.apply_update(contrib, r, zero_in.float(), m, n,
                                      0.85, "reference")
        z_last, r = z, r_new * valid.float()
    out = np.empty(n, np.float32)
    out[perm] = r[:n].cpu().numpy()
    return out


def phase15_rank(payload) -> int:
    """One rank of phase 15(a) (spawned; joined to the gloo group): every
    form of ``_shard_forms`` on cuda:0 over this rank's rows; rank 0
    writes the final ranks, every rank its numbers as JSON."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch import sdc as sdc_mod
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.obs import devices as obs_devices
    from pagerank_tpu_torch.obs import metrics as obs_metrics
    from pagerank_tpu_torch.ops import ell as ell_lib
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops import ell_spmv_partitioned as k2
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel import mesh as mesh_lib
    from pagerank_tpu_torch.parallel import partition
    from pagerank_tpu_torch.utils.snapshot import Snapshotter, resume_engine

    import torch.distributed as dist

    torch.set_num_threads(4)
    rank, world = distributed.process_info()
    dev = torch.device("cuda", 0)
    out = payload["out"]
    with np.load(payload["edges"]) as f:
        graph = build_graph(f["src"], f["dst"], n=int(f["n"]))
    # The collectives the forms call, timed by CUDA events around each
    # call (the engine calls them through the module, so the wrappers
    # see every one).
    spans = []

    def timed(fn, name):
        def call(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            r = fn(*a, **kw)
            e.record()
            spans.append((s, e, name))
            return r
        return call

    # (An asynchronous call's events span its call only; its wait lands
    # in the step's wall.)
    for name in ("psum", "all_gather", "psum_scatter", "ppermute"):
        setattr(mesh_lib, name, timed(getattr(mesh_lib, name), name))
    # One halo plan per byte model: the vs_halo forms over f32 sums share
    # one (~10 s of host work a build at rmat:22).
    plans = {}

    def plan_once(*a, **kw):
        key = tuple(sorted((k, v) for k, v in kw.items()))
        if key not in plans:
            plans[key] = build_halo_plan(*a, **kw)
        return plans[key]

    build_halo_plan = partition.build_halo_plan
    partition.build_halo_plan = plan_once
    # One host pack of rmat:22 per packer and span for the whole phase
    # (~15 s each): the engine packs through the module, and the forms
    # that pack alike (flat and vertex-sharded; two window dtypes of one
    # span) get the same pack of this one graph.
    packs = {}

    def reused(fn):
        def call(g, **kw):
            assert g is graph
            key = (fn.__name__, tuple(sorted(kw.items())))
            if key not in packs:
                packs[key] = fn(g, **kw)
            return packs[key]
        return call

    for name in ("ell_pack", "ell_pack_striped"):
        setattr(ell_lib, name, reused(getattr(ell_lib, name)))
    rep = {}
    for name, kw, kernel in _shard_forms(payload["span"]):
        cfg = PageRankConfig(num_iters=ITERS, num_devices=world, **kw)
        obs_metrics.get_registry().reset()
        eng = TorchEngine(cfg, device=dev)
        t0 = time.perf_counter()
        eng.build(graph)
        build_s = time.perf_counter() - t0
        lay = eng.layout_info()
        # The first step's kernel on this rank's rows against its plain
        # version on the CPU, from the same inputs (r0 prescaled).
        inputs = eng.contrib_inputs()
        got = eng._launch().clone().cpu()
        if kernel == "K1":
            z, src, _, _, plan = inputs
            want = ell_spmv.ell_contrib_plan_reference(
                z.cpu(), src.cpu(), accum_dtype=eng._accum,
                plan=ell_spmv.plan_to(plan, "cpu"))
        else:
            zw, slots, _, pp, _, plan = inputs
            want = k2.ell_contrib_partitioned_plan_reference(
                zw.cpu(), slots.cpu(), pp.cpu(),
                plan=ell_spmv.plan_to(plan, "cpu"))
        err = float((got.double() - want.double()).abs().max())
        equal = bool(torch.equal(got, want))
        del inputs, got, want
        sdc_mod.reset()
        step_s, t_last, marks = [], [0.0], [0]

        def on_iteration(i, info):
            now = time.perf_counter()
            step_s.append(now - t_last[0])
            t_last[0] = now
            marks.append(len(spans))

        ell_spmv.launches = k2.launches = 0
        spans.clear()
        torch.cuda.synchronize()
        t_last[0] = time.perf_counter()
        ranks = eng.run(on_iteration=on_iteration)
        torch.cuda.synchronize()
        launches = ell_spmv.launches if kernel == "K1" else k2.launches
        other = k2.launches if kernel == "K1" else ell_spmv.launches
        # A step's collectives, median over the steps (the first carries
        # the group's warm-up); both ranks share the card, so an event
        # pair also spans whatever the other rank ran between them.
        coll_ms = statistics.median(
            sum(s.elapsed_time(e) for s, e, _ in spans[a:b])
            for a, b in zip(marks, marks[1:]))
        p2p_ms = statistics.median(
            sum(s.elapsed_time(e) for s, e, k in spans[a:b] if k == "ppermute")
            for a, b in zip(marks, marks[1:]))
        ncoll = marks[-1] / ITERS
        counters = obs_metrics.get_registry().snapshot()["counters"]
        model = eng.comms_model() or {}
        # The bare launch on this rank's rows, the ranks in turns (they
        # share the card).
        bare = None
        for turn in range(world):
            dist.barrier()
            if turn == rank:
                bare = _median_ms(eng._launch, 20)
            dist.barrier()
        r = {"kernel": kernel, "kernel_equal": equal, "kernel_err": err,
             "launches": launches, "other_launches": other,
             "ms_per_iter": statistics.median(step_s) * 1e3,
             "collective_ms_per_step": coll_ms,
             "collectives_per_step": ncoll, "bare_launch_ms": bare,
             "build_s": build_s, "rows": lay["num_rows"],
             "slot_rows": lay["slot_rows"], "form": lay["form"],
             "kernel_name": lay["kernel"], "backend": lay.get("backend"),
             "local": int(eng._r.shape[0]), "p2p_ms_per_step": p2p_ms,
             "bytes_exchanged": int(counters.get("comms.bytes_exchanged",
                                                 0)),
             "model_bytes_per_iter": int(model.get("bytes_per_iter") or 0),
             "model_mode": model.get("mode")}
        for key in ("halo", "halo_async", "halo_buffer_width",
                    "local_blocks"):
            if key in lay:
                r[key] = lay[key]
        if cfg.sdc_check_every:
            r["sdc"] = sdc_mod.report_section()
        if name in ATTRIBUTED:
            r["attribution"] = obs_devices.attribute_exchange(eng, iters=5)
        if name == "vs_halo_async" and rank == 0:
            t1 = time.perf_counter()
            plain = _plain_lag1(graph, packs[("ell_pack", ())], world,
                                ITERS, dev)
            r["plain_lag1_l1"] = float(np.abs(ranks - plain).sum()
                                       / np.abs(plain).sum())
            r["plain_lag1_s"] = time.perf_counter() - t1
        if name == "vertex_sharded":
            # A snapshot at iteration 4 (rank 0 writes it), resumed here
            # at world 2: the resumed run must equal the uninterrupted
            # one bit for bit.
            snap_dir = os.path.join(out, "snap")
            eng.set_ranks(np.ones(graph.n, np.float32), iteration=0)
            at4 = eng.run(4)
            if rank == 0:
                Snapshotter(snap_dir, graph.fingerprint(), cfg.semantics,
                            mesh_meta=eng.snapshot_meta()).save(4, at4)
            dist.barrier()
            r["resumed_from"] = resume_engine(eng, Snapshotter(
                snap_dir, graph.fingerprint(), cfg.semantics))
            r["resume_bit_equal"] = bool(np.array_equal(eng.run(), ranks))
        if rank == 0:
            np.save(os.path.join(out, f"{name}.npy"), ranks)
        rep[name] = r
        del eng
        torch.cuda.empty_cache()
    if rank == 0:
        # The world-2 snapshot resumed at world 1: the one-device flat
        # engine (num_devices=1 builds it inside the group).
        one = TorchEngine(PageRankConfig(num_iters=ITERS, num_devices=1),
                          device=dev).build(graph)
        rep["resume_world1_from"] = resume_engine(one, Snapshotter(
            os.path.join(out, "snap"), graph.fingerprint(), "reference"))
        rep["resume_world1_mesh"] = one.mesh is not None
        np.save(os.path.join(out, "resume_world1.npy"), one.run())
        del one
    dist.barrier()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    return 0


def sharded_phase(tmp):
    """Phase 15 (see the module docstring), on its own rmat:SHARD_SCALE
    graph, whose files phase 16 reads too. Returns the phase's numbers
    for the kernels line."""
    import numpy as np

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    card = card_identity()
    d = os.path.join(tmp, "sharded")
    os.makedirs(d, exist_ok=True)
    # (a), (b) and (c) on their own rmat:SHARD_SCALE graph and
    # references, which phase 16(a) and (c) read too.
    n, span, refs, flat_ms = _shard_refs(d)
    np.savez(os.path.join(d, "refs_a.npz"), span=span, **refs)
    codes = distributed.spawn_group(
        "chip_smoke:phase15_rank", SHARD_WORLD,
        {"edges": os.path.join(d, "edges_a.npz"), "out": d, "span": span},
        d, backend="gloo", timeout_s=300.0, deadline_s=900.0)
    _check(codes == [0] * SHARD_WORLD, f"phase 15 rank exit codes {codes}")
    ranks_of = [json.load(open(os.path.join(d, f"rank{r}.json")))
                for r in range(SHARD_WORLD)]

    def l1(a, b):
        return float(np.abs(a - b).sum() / np.abs(b).sum())

    print(f"phase 15(a) on {card} (gloo, {SHARD_WORLD} ranks sharing "
          f"cuda:0; gloo stages collectives through host memory, so these "
          f"times are not NCCL's across cards; rmat:{SHARD_SCALE}, span "
          f"{span}):")
    ref_of = {"edge_part_f32": ("part_f32", 1e-4),
              "edge_part_bf16": ("part_bf16", 5e-3),
              # Lag 1 reads a one-step-stale boundary: it is held to its
              # plain schedule below, not to the synchronous run.
              "vs_halo_async": ("flat", None)}
    got = {}
    for name, _, kernel in _shard_forms(span):
        final = np.load(os.path.join(d, f"{name}.npy"))
        ref, gate = ref_of.get(name, ("flat", 1e-4))
        dist_l1 = l1(final, refs[ref])
        _check(final.shape == (n,) and np.isfinite(final).all(),
               f"{name}: ranks not finite of shape (n,)")
        _check(gate is None or dist_l1 <= gate, f"{name}: normalised L1 "
               f"{dist_l1} vs the one-device {ref} run > {gate}")
        for r, rep in enumerate(ranks_of):
            x = rep[name]
            _check(x["kernel_equal"], f"{name} rank {r}: {kernel} != its "
                   f"plain version on its rows (max err {x['kernel_err']})")
            _check(x["launches"] == ITERS and x["other_launches"] == 0,
                   f"{name} rank {r}: {kernel} launched {x['launches']} "
                   f"times (the other kernel {x['other_launches']}) in "
                   f"{ITERS} steps")
            _check(x["bytes_exchanged"] == ITERS * x["model_bytes_per_iter"],
                   f"{name} rank {r}: comms.bytes_exchanged "
                   f"{x['bytes_exchanged']} != {ITERS} x "
                   f"{x['model_bytes_per_iter']}")
            print(f"  {name} rank {r}: {x['form']} {x['kernel_name']}, "
                  f"{x['rows']} of {x['slot_rows']} slot rows, state "
                  f"{x['local']}; first-step {kernel} torch.equal to its "
                  f"plain version; {x['launches']} launches; "
                  f"{x['ms_per_iter']:.3f} ms/iter, collectives "
                  f"{x['collective_ms_per_step']:.3f} ms a step "
                  f"({x['collectives_per_step']:g} calls), bare {kernel} "
                  f"{x['bare_launch_ms']:.4f} ms; build {x['build_s']:.1f} "
                  f"s")
        print(f"  {name}: final ranks vs the one-device {ref} run "
              f"normalised L1 {dist_l1:.3e} (gate {gate}); model "
              f"{x['model_mode']} {x['model_bytes_per_iter']} B a step a "
              f"rank, comms.bytes_exchanged {x['bytes_exchanged']}")
        got[name] = {"l1_vs_one_device": dist_l1, "ranks": [
            {k: x[name][k] for k in ("launches", "ms_per_iter",
                                     "collective_ms_per_step",
                                     "p2p_ms_per_step", "bare_launch_ms",
                                     "rows", "kernel_err")}
            for x in ranks_of]}
    pair = [np.load(os.path.join(d, f"{n}.npy")) for n in (
        "edge_flat_f64sums", "vertex_sharded_f64sums")]
    _check(np.array_equal(*pair), "f32 ranks over f64 sums: the "
           "vertex-sharded run != the edge-sharded run")
    f32 = [np.load(os.path.join(d, f"{n}.npy")) for n in (
        "edge_flat", "vertex_sharded", "vertex_sharded_checked")]
    _check(np.array_equal(f32[2], f32[1]),
           "the checked vertex-sharded run != the unchecked one")
    print(f"  bitwise: f32 ranks over f64 sums vertex-sharded == "
          f"edge-sharded; the checked vertex-sharded run == the unchecked "
          f"one; f32 over f32 sums vertex-sharded vs edge-sharded "
          f"normalised L1 {l1(f32[1], f32[0]):.3e} (the dangling mass and "
          f"delta regroup in f32), bit-equal {np.array_equal(f32[0], f32[1])}")
    for r, rep in enumerate(ranks_of):
        sec = rep["vertex_sharded_checked"]["sdc"]
        _check(sec["checks"] == ITERS and sec["flips_detected"] == 0,
               f"checked run rank {r}: {sec}")
        vs = rep["vertex_sharded"]
        _check(vs["resumed_from"] == 4 and vs["resume_bit_equal"],
               f"rank {r}: world-2 resume from iteration "
               f"{vs['resumed_from']} bit-equal {vs['resume_bit_equal']}")
    # The world-2 snapshot resumed at world 1 (rank 0's one-device engine).
    _check(ranks_of[0]["resume_world1_from"] == 4
           and not ranks_of[0]["resume_world1_mesh"],
           "world-1 resume: no snapshot, or not a one-device engine")
    resume_l1 = l1(np.load(os.path.join(d, "resume_world1.npy")), f32[1])
    _check(resume_l1 <= 1e-4, f"world-1 resume of the world-2 snapshot: "
           f"normalised L1 {resume_l1} vs the uninterrupted run")
    print(f"  snapshot at iteration 4 (world 2): resumed at world 2 "
          f"bit-equal, at world 1 (one device) normalised L1 "
          f"{resume_l1:.3e}; {ITERS} checks, no breach on the checked run")
    for name, want in (("vs_halo", "vertex_sharded"),
                       ("vs_halo_f64sums", "vertex_sharded_f64sums"),
                       ("vs_halo_lag0", "vs_halo"),
                       ("vs_halo_checked", "vs_halo")):
        _check(np.array_equal(np.load(os.path.join(d, f"{name}.npy")),
                              np.load(os.path.join(d, f"{want}.npy"))),
               f"{name}'s ranks != {want}'s")
    for r, rep in enumerate(ranks_of):
        h, a, z = rep["vs_halo"], rep["vs_halo_async"], rep["vs_halo_lag0"]
        _check(h["form"] == "vs_halo" and a["form"] == "vs_halo_async"
               and z["form"] == "vs_halo"
               and rep["vs_bounded"]["form"] == "vs_bounded",
               f"rank {r}: forms {h['form']}, {a['form']}, {z['form']}, "
               f"{rep['vs_bounded']['form']}")
        _check(a["halo_async"] == "on:lag1"
               and z["halo_async"] == "off:stale_max_lag=0",
               f"rank {r}: halo_async {a['halo_async']} / {z['halo_async']}")
        _check(a["model_mode"] == "sparse_async"
               and h["model_mode"] == "sparse"
               and rep["vertex_sharded"]["model_mode"] == "dense",
               f"rank {r}: comms models {h['model_mode']}, "
               f"{a['model_mode']}")
        sec = rep["vs_halo_checked"]["sdc"]
        _check(sec["checks"] == ITERS and sec["flips_detected"] == 0,
               f"checked vs_halo rank {r}: {sec}")
        for name in ATTRIBUTED:
            att = rep[name]["attribution"]
            _check(att is not None and att["step_s"] > 0,
                   f"{name} rank {r}: attribution {att}")
            print(f"  {name} rank {r}: attribute_exchange exchange "
                  f"{att['exchange_s'] * 1e3:.3f} ms, step "
                  f"{att['step_s'] * 1e3:.3f} ms a step (fraction "
                  f"{att['exchange_fraction']:.3f}), "
                  f"{att['model_bytes_per_iter']} B a step at "
                  f"{(att['achieved_bytes_per_sec'] or 0) / 1e9:.3f} GB/s "
                  f"(through host memory under gloo)")
    lag1 = ranks_of[0]["vs_halo_async"]["plain_lag1_l1"]
    _check(lag1 <= 1e-5, f"vs_halo_async (lag 1) vs its plain schedule: "
           f"normalised L1 {lag1} > 1e-5")
    plan = ranks_of[0]["vs_halo"]["halo"]
    print(f"phase 15(c): the halo plan at rmat:{n.bit_length() - 1}, "
          f"{SHARD_WORLD} ranks: head K {plan['head_k']}, "
          f"{plan['read_rounds']} read round(s) of {plan['read_width_total']}"
          f" entries, {plan['write_rounds']} write round(s) of "
          f"{plan['write_width_total']}, halo fraction "
          f"{plan['halo_fraction']:.4f}, {plan['sparse_bytes_per_iter']} B "
          f"a step a rank against the dense form's "
          f"{plan['dense_bytes_per_iter']}; async buffer "
          f"{ranks_of[0]['vs_halo_async']['halo_buffer_width']} entries; "
          f"vs_bounded {ranks_of[0]['vs_bounded']['local_blocks']} local "
          f"blocks a rank + 1 trash. Bitwise: vs_halo == vertex_sharded "
          f"(f32 and f64 sums), lag 0 == vs_halo, checked == vs_halo; lag "
          f"1 vs its plain schedule normalised L1 {lag1:.3e} (gate 1e-5, "
          f"{ranks_of[0]['vs_halo_async']['plain_lag1_s']:.1f} s)")
    # (b) the CLI under NCCL in a group of one: no collective reaches
    # torch.distributed in a step (every mesh collective is the identity
    # at world 1), each step's host wall (it ends on the host's read of
    # delta) beside 12(d)'s one-device step; then the halo and bounded
    # forms' flags, each bit-equal to phase 3's ranks.
    import torch
    import torch.distributed as dist

    from pagerank_tpu_torch import TorchEngine

    calls, step_ms, forms, stepping = [], [], [], [False]

    def counted(name, fn):
        def call(*a, **kw):
            calls.append((name, stepping[0]))
            return fn(*a, **kw)
        return call

    def timed_step(self):
        stepping[0] = True
        t = time.perf_counter()
        try:
            info = step(self)
        finally:
            stepping[0] = False
        step_ms.append((time.perf_counter() - t) * 1e3)
        return info

    def noted_build(self, graph):
        out = build(self, graph)
        forms.append(self.layout_info()["form"])
        return out

    names = [k for k in ("all_reduce", "all_gather_into_tensor",
                         "all_gather_single", "reduce_scatter_tensor",
                         "reduce_scatter_single", "batch_isend_irecv",
                         "isend", "irecv", "broadcast", "barrier")
             if hasattr(dist, k)]
    originals = {k: getattr(dist, k) for k in names}
    step, build = TorchEngine.step, TorchEngine.build

    def cli_run(label, extra):
        out = os.path.join(d, f"cli_{label}.tsv")
        calls.clear()
        step_ms.clear()
        _reset_counts()
        t1 = time.perf_counter()
        try:
            for k in names:
                setattr(dist, k, counted(k, originals[k]))
            TorchEngine.step, TorchEngine.build = timed_step, noted_build
            rc = cli.main(["--input", os.path.join(d, "edges_a.npz"),
                           "--iters", str(ITERS), "--dtype", "float32",
                           "--num-devices", "1", "--vertex-sharded",
                           *extra, "--out", out, "--log-every", "0"])
        finally:
            TorchEngine.step, TorchEngine.build = step, build
            for k in names:
                setattr(dist, k, originals[k])
        cli_s = time.perf_counter() - t1
        k1, k2n, _ = _read_counts()
        in_steps = [c for c in calls if c[1]]
        ranks = np.array([float(ln.split("\t")[1]) for ln in open(out)],
                         np.float32)
        _check(rc == 0 and k1 == ITERS and k2n == 0,
               f"CLI --num-devices 1 --vertex-sharded {' '.join(extra)}: rc "
               f"{rc}, K1 {k1}, K2 {k2n}")
        _check(len(step_ms) == ITERS and not in_steps,
               f"CLI {label}: {len(step_ms)} steps, torch.distributed "
               f"calls in them: {in_steps[:4]}")
        _check(np.array_equal(ranks, refs["flat"]),
               f"CLI --num-devices 1 --vertex-sharded {' '.join(extra)} "
               f"(NCCL) != (a)'s one-device flat ranks")
        return statistics.median(step_ms[1:]), cli_s, k1, len(calls)

    step_med, cli_s, k1, n_calls = cli_run("dense", [])
    print(f"phase 15(b) on {card}, CLI --num-devices 1 --vertex-sharded "
          f"under NCCL (a group of one; form {forms[-1]}; rmat:"
          f"{SHARD_SCALE}): step {step_med:.4f} ms (host wall, median of "
          f"steps 2-{ITERS}) against the one-device flat step "
          f"{flat_ms:.4f} ms on the same graph ((a)'s reference, "
          f"engine.run), ratio "
          f"{step_med / flat_ms:.3f}; torch.distributed calls in the steps: "
          f"0 ({n_calls} in the whole run)")
    for label, extra, form in (
            ("halo", ["--halo-exchange"], "vs_halo"),
            ("bounded", ["--vs-bounded"], "vs_bounded")):
        ms, s_, k1x, _ = cli_run(label, extra)
        _check(forms[-1] == form, f"CLI {extra}: form {forms[-1]}")
        print(f"phase 15(b): CLI --num-devices 1 --vertex-sharded "
              f"{' '.join(extra)} ({form}, NCCL, a group of one) bit-equal "
              f"to (a)'s one-device ranks, K1 {k1x} launches, step "
              f"{ms:.4f} ms, no torch.distributed call in a step, "
              f"{s_:.1f} s")
    before = torch.cuda.memory_allocated(0)
    try:
        cli.main(["--synthetic", "rmat:10", "--num-devices", "2"])
        refused = None
    except SystemExit as e:
        refused = str(e.code)
    _check(refused is not None and "requested 2 devices, only 1 visible"
           in refused and torch.cuda.memory_allocated(0) == before,
           f"--num-devices 2 on one card: {refused!r}")
    print(f"phase 15(b): CLI --num-devices 1 --vertex-sharded under NCCL "
          f"(a group of one) bit-equal to (a)'s one-device ranks, K1 {k1} "
          f"launches, {cli_s:.1f} s; --num-devices 2 refused: {refused}")
    got["world1_step_ms"] = step_med
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return got


ELASTIC_WORLD = 3
#: The iteration at whose start the fault shim kills member 1.
ELASTIC_KILL = 5
ELASTIC_CLI_SCALE = 16


def _elastic_forms(span):
    """(name, config fields, kernel, phase-15 reference) of each phase
    16(a) run."""
    return [("vertex_sharded", {"vertex_sharded": True}, "K1", "flat"),
            ("edge_part_f32", {"partition_span": span}, "K2", "part_f32")]


def phase16_rank(payload) -> int:
    """One process of phase 16(a) (spawned rescue-armed, joined to the
    gloo group through the script's store): each form of
    ``_elastic_forms`` on cuda:0 under ``ElasticRunner``, member 1
    killed by the fault shim at ELASTIC_KILL. Each form re-forms the
    whole group first (its own generation). The final rank 0 writes the
    ranks; every process its numbers as JSON."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops import ell_spmv_partitioned as k2
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel.elastic import (ElasticRunner,
                                                     RankLeftError,
                                                     snapshot_meta_after)
    from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                                   install_device_faults)
    from pagerank_tpu_torch.utils.snapshot import Snapshotter

    torch.set_num_threads(2)
    world = distributed.process_info()[1]
    me = distributed.member()
    dev = torch.device("cuda", 0)
    out = payload["out"]
    with np.load(payload["edges"]) as f:
        graph = build_graph(f["src"], f["dst"], n=int(f["n"]))
    rep = {}
    for k, (name, kw, kernel, _) in enumerate(_elastic_forms(
            payload["span"])):
        distributed.reform(10 * (k + 1), range(world))
        cfg = PageRankConfig(num_iters=ITERS, **kw)
        sched = DeviceFaultSchedule(seed=5, kill={ELASTIC_KILL: 1})
        snap = Snapshotter(os.path.join(out, name), graph.fingerprint(),
                           cfg.semantics)
        builds, box = [], {}

        def build(members):
            t = time.perf_counter()
            e = TorchEngine(cfg.replace(num_devices=len(members)),
                            device=dev).build(graph)
            builds.append({"world": len(members),
                           "rows": e.layout_info()["num_rows"],
                           "s": time.perf_counter() - t})
            return e

        def rebound(e2):
            install_device_faults(e2, sched)
            snap.mesh_meta = snapshot_meta_after(e2, box["runner"])

        eng = build(range(world))
        install_device_faults(eng, sched)
        runner = ElasticRunner(eng, build, snapshotter=snap, max_rescues=1,
                               on_rebuild=rebound, liveness_timeout_s=60.0)
        box["runner"] = runner
        snap.mesh_meta = snapshot_meta_after(eng, runner)
        del eng
        walls, t_last = {}, [0.0]

        def on_iteration(i, info):
            walls[i] = time.perf_counter() - t_last[0]
            e = runner.engine
            r = e.ranks()  # every rank: a collective (vertex-sharded)
            if e.mesh.rank == 0:
                snap.save(i + 1, r)
            t_last[0] = time.perf_counter()

        ell_spmv.launches = k2.launches = 0
        torch.cuda.synchronize()
        t_last[0] = time.perf_counter()
        status, ranks = "ok", None
        try:
            ranks = runner.run(on_iteration=on_iteration)
        except RankLeftError:
            status = "left"
        torch.cuda.synchronize()
        launches = ell_spmv.launches if kernel == "K1" else k2.launches
        other = k2.launches if kernel == "K1" else ell_spmv.launches
        final = runner.engine
        r = {"status": status, "launches": launches,
             "other_launches": other, "builds": builds,
             "rescue_walls": runner.rescue_walls,
             "lost": list(runner.lost_device_ids),
             "members": [int(m) for m in final.device_ids()],
             "ms_world3": statistics.median(
                 [w * 1e3 for i, w in walls.items() if i < ELASTIC_KILL]),
             "ms_world2": statistics.median(
                 [w * 1e3 for i, w in walls.items() if i > ELASTIC_KILL]
                 or [float("nan")])}
        if status == "ok":
            # The survivor's kernel on its NEW rows against its plain
            # version on the CPU, from the same inputs (after the run:
            # its launches were read above).
            lay = final.layout_info()
            inputs = final.contrib_inputs()
            got = final._launch().clone().cpu()
            if kernel == "K1":
                z, src, _, _, plan = inputs
                want = ell_spmv.ell_contrib_plan_reference(
                    z.cpu(), src.cpu(), accum_dtype=final._accum,
                    plan=ell_spmv.plan_to(plan, "cpu"))
            else:
                zw, slots, _, pp, _, plan = inputs
                want = k2.ell_contrib_partitioned_plan_reference(
                    zw.cpu(), slots.cpu(), pp.cpu(),
                    plan=ell_spmv.plan_to(plan, "cpu"))
            r["kernel_equal"] = bool(torch.equal(got, want))
            r["kernel_err"] = float((got.double() - want.double())
                                    .abs().max())
            r["rows"], r["form"] = lay["num_rows"], lay["form"]
            r["iteration"] = int(final.iteration)
            del inputs, got, want
            if final.mesh.rank == 0:
                np.save(os.path.join(out, f"{name}.npy"), ranks)
                r["snap_meta"] = snap.load(snap.iterations()[-1])[1]["mesh"]
                r["snap_iterations"] = snap.iterations()
        rep[name] = r
        del runner, final
        torch.cuda.empty_cache()
    with open(os.path.join(out, f"member{me}.json"), "w") as f:
        json.dump(rep, f)
    return 0


def elastic_phase(tmp):
    """Phase 16 (see the module docstring), on phase 15's files. Returns
    the numbers for the kernels line."""
    import numpy as np

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.testing.faults import ProcessKillPlan

    t0 = time.perf_counter()
    card = card_identity()
    d = os.path.join(tmp, "sharded")
    # (a) and (c) on phase 15(a)'s rmat:SHARD_SCALE graph and references.
    with np.load(os.path.join(d, "refs_a.npz")) as f:
        refs_a = {k: f[k] for k in f.files}
    span = int(refs_a.pop("span"))
    edges = os.path.join(d, "edges_a.npz")
    d16 = os.path.join(tmp, "elastic")
    os.makedirs(d16, exist_ok=True)

    def l1(a, b):
        return float(np.abs(a - b).sum() / np.abs(b).sum())

    # (a) three gloo ranks on the card; member 1 killed by the shim.
    ta = time.perf_counter()
    codes = distributed.spawn_group(
        "chip_smoke:phase16_rank", ELASTIC_WORLD,
        {"edges": os.path.join(d, "edges_a.npz"), "out": d16, "span": span},
        d16, backend="gloo", timeout_s=300.0, deadline_s=600.0,
        rescue=True)
    _check(list(codes) == [0] * ELASTIC_WORLD,
           f"phase 16(a) process exit codes {list(codes)}")
    reps = [json.load(open(os.path.join(d16, f"member{m}.json")))
            for m in range(ELASTIC_WORLD)]
    print(f"phase 16(a) on {card} ({ELASTIC_WORLD} gloo ranks sharing "
          f"cuda:0, rescue armed; member 1 killed by the fault shim at "
          f"iteration {ELASTIC_KILL} of {ITERS}; rmat:{SHARD_SCALE}; "
          f"{time.perf_counter() - ta:.1f} s):")
    got = {}
    for name, _, kernel, ref in _elastic_forms(span):
        final = np.load(os.path.join(d16, f"{name}.npy"))
        dist_l1 = l1(final, refs_a[ref])
        _check(final.shape == refs_a[ref].shape
               and np.isfinite(final).all(),
               f"{name}: ranks not finite of shape (n,)")
        _check(dist_l1 <= 1e-6, f"{name}: the rescued run vs the one-device "
               f"{ref} run normalised L1 {dist_l1} > 1e-6")
        victim = reps[1][name]
        _check(victim["status"] == "left"
               and victim["launches"] == ELASTIC_KILL,
               f"{name} member 1: {victim['status']}, {kernel} launched "
               f"{victim['launches']} times")
        for m in (0, 2):
            x = reps[m][name]
            _check(x["status"] == "ok" and x["members"] == [0, 2]
                   and x["lost"] == [1] and len(x["rescue_walls"]) == 1
                   and x["iteration"] == ITERS,
                   f"{name} member {m}: {x['status']}, members "
                   f"{x['members']}, lost {x['lost']}")
            _check(x["kernel_equal"], f"{name} member {m}: {kernel} on its "
                   f"new rows != its plain version (max err "
                   f"{x['kernel_err']})")
            _check(x["launches"] == ITERS and x["other_launches"] == 0,
                   f"{name} member {m}: {kernel} launched {x['launches']} "
                   f"times (the other kernel {x['other_launches']}) over "
                   f"{ELASTIC_KILL} steps at world 3 and "
                   f"{ITERS - ELASTIC_KILL} at world 2")
            w = x["rescue_walls"][0]
            _check(w["resumed_iteration"] == ELASTIC_KILL
                   and w["world_before"] == 3 and w["world_after"] == 2,
                   f"{name} member {m}: rescue {w}")
            b0, b1 = x["builds"]
            print(f"  {name} member {m}: {kernel} on its new rows "
                  f"torch.equal to its plain version; {x['launches']} "
                  f"launches ({ELASTIC_KILL} at world 3, "
                  f"{ITERS - ELASTIC_KILL} at world 2); rows a rank "
                  f"{b0['rows']} -> {x['rows']}; ms/iter {x['ms_world3']:.3f}"
                  f" at world 3, {x['ms_world2']:.3f} at world 2; rescue "
                  f"wall: roll call {w['roll_call']:.4f} s, regroup "
                  f"{w['regroup']:.4f} s, rebuild {w['rebuild']:.3f} s "
                  f"(first build {b0['s']:.3f} s), warm start "
                  f"{w['warm_start']:.3f} s")
        meta = reps[0][name]["snap_meta"]
        _check(meta["num_devices"] == 2 and meta["device_ids"] == [0, 2]
               and reps[0][name]["snap_iterations"] == list(
                   range(1, ITERS + 1)),
               f"{name}: newest snapshot's mesh {meta}")
        print(f"  {name}: final ranks vs the one-device {ref} run normalised "
              f"L1 {dist_l1:.3e} (gate 1e-6); snapshots 1-{ITERS}, the "
              f"newest naming {meta['num_devices']} devices "
              f"{meta['device_ids']}")
        got[name] = {"l1_vs_one_device": dist_l1, "members": {
            m: {k: reps[m][name][k] for k in (
                "status", "launches", "ms_world3", "ms_world2",
                "rescue_walls")} for m in range(ELASTIC_WORLD)}}
    # (b) the CLI over three host ranks, rank 1 SIGKILLed.
    tb = time.perf_counter()
    dc = os.path.join(tmp, "elastic_cli")
    os.makedirs(dc, exist_ok=True)
    base = ["--synthetic", f"rmat:{ELASTIC_CLI_SCALE}", "--device", "cpu",
            "--iters", "12", "--dtype", "float64", "--log-every", "0"]

    def tsv(path):
        return np.array([float(ln.split("\t")[1]) for ln in open(path)])

    one, three = os.path.join(dc, "one.tsv"), os.path.join(dc, "three.tsv")
    _check(cli.main(base + ["--out", one]) == 0, "16(b): one-device run")
    plan = ProcessKillPlan("solve", iteration=4, signum=9, rank=1)
    os.environ.update(plan.to_env())
    try:
        rc = cli.main(base + [
            "--num-devices", "3", "--vertex-sharded", "--stall-action",
            "rescue", "--stall-timeout", "120", "--sync-io",
            "--snapshot-dir", os.path.join(dc, "snap"), "--out", three,
            "--run-report", os.path.join(dc, "report.json")])
    finally:
        os.environ.pop(ProcessKillPlan.ENV, None)
    report = json.load(open(os.path.join(dc, "report.json")))
    rob = report["robustness"]
    diff = float(np.abs(tsv(three) - tsv(one)).max())
    _check(rc == 0 and rob["rescues"] == 1 and rob["devices_lost"] == 1
           and diff <= 1e-12, f"16(b): rc {rc}, robustness {rob}, max "
           f"|diff| {diff}")
    print(f"phase 16(b): CLI --device cpu --num-devices 3 --vertex-sharded "
          f"--stall-action rescue at rmat:{ELASTIC_CLI_SCALE} f64, rank 1 "
          f"SIGKILLed at its fifth step boundary: exit 0, "
          f"{rob['rescues']} rescue, {rob['devices_lost']} rank lost, ranks "
          f"vs the one-device run max |diff| {diff:.3e} (gate 1e-12); "
          f"{time.perf_counter() - tb:.1f} s")
    # (c) NCCL, a group of one: clean, then its only device lost.
    tc = time.perf_counter()
    out = os.path.join(dc, "nccl1.tsv")
    _reset_counts()
    rc = cli.main(["--input", edges, "--iters", str(ITERS), "--dtype",
                   "float32", "--num-devices", "1", "--vertex-sharded",
                   "--stall-action", "rescue", "--out", out,
                   "--log-every", "0"])
    k1, k2n, _ = _read_counts()
    ranks = np.array([float(ln.split("\t")[1]) for ln in open(out)],
                     np.float32)
    _check(rc == 0 and k1 == ITERS and k2n == 0
           and np.array_equal(ranks, refs_a["flat"]),
           f"16(c): rc {rc}, K1 {k1}, K2 {k2n}, bit-equal to 15(a)'s "
           f"one-device ranks {np.array_equal(ranks, refs_a['flat'])}")
    code = (
        "import sys\n"
        "from pagerank_tpu_torch import cli\n"
        "from pagerank_tpu_torch.engines.torch_engine import TorchEngine\n"
        "from pagerank_tpu_torch.parallel.elastic import DeviceLostError\n"
        "step = TorchEngine.step\n"
        "def lost(self):\n"
        "    if self.iteration == 3:\n"
        "        raise DeviceLostError('injected loss of the only device', "
        "[0])\n"
        "    return step(self)\n"
        "TorchEngine.step = lost\n"
        f"sys.exit(cli.main(['--synthetic', 'rmat:{ELASTIC_CLI_SCALE}', "
        "'--iters', '10', '--num-devices', '1', '--vertex-sharded', "
        "'--stall-action', 'rescue', '--log-every', '0']))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    t1 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    lost_s = time.perf_counter() - t1
    _check(p.returncode != 0 and "ElasticExhaustedError" in p.stderr
           and "no surviving devices" in p.stderr,
           f"16(c): the lost device: exit {p.returncode}, stderr "
           f"{p.stderr[-600:]}")
    print(f"phase 16(c) on {card}: CLI --num-devices 1 --vertex-sharded "
          f"--stall-action rescue under NCCL (a group of one) at rmat:"
          f"{SHARD_SCALE} bit-equal to 15(a)'s one-device ranks, K1 {k1} "
          f"launches, "
          f"{time.perf_counter() - tc - lost_s:.1f} s; its only device lost "
          f"at iteration 3 (injected): exit {p.returncode}, "
          f"ElasticExhaustedError (\"no surviving devices\"), "
          f"{lost_s:.1f} s with the subprocess's start")
    got["nccl_group_of_one_launches"] = k1
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return got


PPR_GROUP_WORLD = 2
#: Top-k scores over a group against phase 12's one-device run: f32
#: sums in another order (a block split between two shares, the psum
#: of two partials) over PPR_ITERS iterations (tests/test_torch_ppr.py::
#: test_topk_ordering_f32's rtol), with an absolute floor for the
#: smallest scores of a top-k.
PPR_GROUP_RTOL = 1e-5
PPR_GROUP_ATOL = 1e-7
#: The daemon of 17(c): batches of SERVE_GROUP_BATCH sources, member 1
#: SIGKILLed on receiving dispatch SERVE_GROUP_KILL (the warm-up is 0).
SERVE_GROUP_BATCH = 8
SERVE_GROUP_BATCHES = 4
SERVE_GROUP_KILL = 3


def ppr_group_inputs(tmp, s):
    """What phase 17 needs from phase 12(a), kept on disk until it runs:
    the rmat:20 graph's edges, the first PPR_CHUNK sources and their
    one-device top-k ids and scores."""
    import numpy as np

    d = os.path.join(tmp, "ppr_group")
    os.makedirs(d, exist_ok=True)
    graph, res = s["graph"], s["ppr"]
    np.savez(os.path.join(d, "edges.npz"), src=graph.src, dst=graph.dst,
             n=graph.n)
    np.savez(os.path.join(d, "ref.npz"), sources=res.sources[:PPR_CHUNK],
             ids=res.topk_ids[:PPR_CHUNK], scores=res.topk_scores[:PPR_CHUNK])


def _held_topk(label, ids, scores, ref_ids, ref_scores):
    """Hold a top-k to phase 12's: scores within PPR_GROUP_RTOL /
    PPR_GROUP_ATOL, ids equal wherever phase 12's score is more than
    PPR_TIE_EPS from its neighbours'; returns the largest score error."""
    import numpy as np

    err = np.abs(scores.astype(np.float64) - ref_scores)
    _check(ids.shape == ref_ids.shape and np.isfinite(scores).all()
           and (err <= PPR_GROUP_ATOL + PPR_GROUP_RTOL
                * np.abs(ref_scores)).all(),
           f"{label}: top-k scores off phase 12's by up to {err.max():.3e}")
    gap = np.diff(ref_scores.astype(np.float64), axis=1)
    tied = np.zeros(ref_scores.shape, bool)
    tied[:, 1:] |= np.abs(gap) <= PPR_TIE_EPS
    tied[:, :-1] |= np.abs(gap) <= PPR_TIE_EPS
    bad = int(((ids != ref_ids) & ~tied).sum())
    _check(bad == 0, f"{label}: {bad} untied top-k ids differ from phase "
           f"12's")
    return float(err.max())


def phase17_rank(payload) -> int:
    """One rank of phase 17(a) and (c) (spawned rescue-armed; joined to
    the gloo group, on cuda:0): the engine over the group (every rank
    writes its numbers as JSON), then the daemon (rank 0 writes its
    numbers; member 1 dies on the kill plan)."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig
    from pagerank_tpu_torch.engines.ppr import PprTorchEngine
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.analysis import kernels
    from pagerank_tpu_torch.ops import ell as ell_lib
    from pagerank_tpu_torch.ops import ell_spmm
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel import mesh as mesh_lib
    from pagerank_tpu_torch.parallel.elastic import (ElasticExhaustedError,
                                                     RankLeftError)
    from pagerank_tpu_torch.serving.daemon import PprServer, ServeConfig
    from pagerank_tpu_torch.testing.faults import ProcessKillPlan
    from pagerank_tpu_torch.testing.schedules import VirtualClock

    torch.set_num_threads(4)
    rank, world = distributed.process_info()
    dev = torch.device("cuda", 0)
    d = payload["dir"]
    rep = {"rank": rank}
    t0 = time.perf_counter()
    with np.load(os.path.join(d, "edges.npz")) as f:
        graph = build_graph(f["src"], f["dst"], n=int(f["n"]))
    with np.load(os.path.join(d, "ref.npz")) as f:
        sources = f["sources"]
    rep["graph_s"] = time.perf_counter() - t0
    cfg = PageRankConfig(num_iters=PPR_ITERS, dtype="float32",
                         accum_dtype="float32", num_devices=world)
    # (a) the engine over the group.
    t0 = time.perf_counter()
    eng = PprTorchEngine(cfg, device=dev).build(graph)
    eng.bind(PPR_CHUNK)
    rep["build_s"] = time.perf_counter() - t0
    psum, events = mesh_lib.psum, []

    def timed_psum(mesh, x, async_op=False):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = psum(mesh, x, async_op)
        b.record()
        events.append((a, b))
        return out

    mesh_lib.psum = timed_psum
    torch.cuda.synchronize()
    ell_spmm.launches = 0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = eng.run(sources, topk=PPR_TOPK, chunk=PPR_CHUNK)
    b.record()
    b.synchronize()
    rep["launches"] = ell_spmm.launches
    mesh_lib.psum = psum
    rep["chunk_ms"] = a.elapsed_time(b)
    rep["psum_ms"] = [x.elapsed_time(y) for x, y in events]
    lay = eng.layout_info()
    rep.update(num_rows=lay["num_rows"], slot_rows=lay["slot_rows"],
               world=lay["world"], backend=lay["backend"])
    # The last launch's inputs (the final iteration's prescaled chunk)
    # held against the plain version on this rank's share.
    launcher, z2 = eng._launcher, eng._z2
    src, rb, nb = eng._src, eng._row_block, eng._num_blocks
    launcher(PPR_CHUNK)
    got = eng._sums[: nb * 128, :PPR_CHUNK].cpu()
    got_mass = launcher.mass[:PPR_CHUNK].cpu()
    plan_cpu = ell_lib.segment_plan(rb.cpu().numpy(), nb)
    kw = {"accum_dtype": torch.float32, "plan": plan_cpu, "k": PPR_CHUNK,
          "kt": 8}
    want = ell_spmm.ell_contrib_spmm_rows_reference(z2.cpu(), src.cpu(),
                                                    **kw)
    want_mass = ell_spmm.mass_reference(z2.cpu(), src.cpu(), **kw)
    rep["equal"] = bool(torch.equal(got, want)
                        and torch.equal(got_mass, want_mass))
    rep["max_abs_err"] = float((got.double() - want.double()).abs().max())
    rep["k1w_ms"] = _median_ms(lambda: launcher(PPR_CHUNK), 20)
    plan = eng._plan
    cost = kernels.k1_cost(int(src.shape[0]), eng._n_state, nb,
                           plan_cpu.num_segments,
                           int(plan.empty_groups.numel()),
                           z2.element_size(), columns=PPR_CHUNK)
    rep["bound_ms"], rep["bound_by"] = _bound_ms(cost)
    rep["plain_ms"] = _median_ms(
        lambda: ell_spmm.ell_contrib_spmm_rows_reference(
            z2, src, accum_dtype=torch.float32, plan=plan, k=PPR_CHUNK),
        5, warmup=1)
    if rank == 0:
        np.savez(os.path.join(d, "engine.npz"), ids=res.topk_ids,
                 scores=res.topk_scores)
    with open(os.path.join(d, f"engine{rank}.json"), "w") as f:
        json.dump(rep, f)
    del eng, launcher, z2, src, rb, res, got, want
    torch.cuda.empty_cache()
    # (c) the daemon over the group; member 1 dies on dispatch
    # SERVE_GROUP_KILL.
    os.environ.update(ProcessKillPlan("serve", iteration=SERVE_GROUP_KILL,
                                      signum=9, rank=1).to_env())
    srv = PprServer(
        graph, config=cfg,
        serve_config=ServeConfig(
            max_batch=SERVE_GROUP_BATCH, topk=PPR_TOPK, cache_capacity=0,
            queue_depth=64, deadline_ms=600_000.0, dispatch_timeout_s=600.0,
            probe_timeout_s=60.0),
        devices=[dev], clock=VirtualClock())
    if rank != 0:
        # Member 1 dies in here (the kill plan): it writes nothing more.
        try:
            srv.follow()
        except (RankLeftError, ElasticExhaustedError):
            return 1
        return 0
    rep = {}
    t0 = time.perf_counter()
    srv.start(dispatcher=False)
    rep["serve_start_s"] = time.perf_counter() - t0
    handles, worlds, walls = [], [], []
    for i in range(SERVE_GROUP_BATCHES):
        batch = sources[i * SERVE_GROUP_BATCH: (i + 1) * SERVE_GROUP_BATCH]
        handles += [srv.submit(int(x)) for x in batch]
        t0 = time.perf_counter()
        srv.pump()
        walls.append(time.perf_counter() - t0)
        worlds.append(srv.device_count)
    srv.drain()
    n = len(handles)
    rep["outcomes"] = [q.outcome for q in handles]
    rep["worlds"] = worlds
    rep["device_ids"] = srv.device_ids()
    rep["rescues"] = srv.rescues_done
    rep["walls"] = srv.rescue_walls
    # The daemon's own batch walls are on its virtual clock: the host's.
    rep["batch_walls_ms"] = [1e3 * w for w in walls]
    ids = np.full((n, PPR_TOPK), -1, np.int64)
    scores = np.zeros((n, PPR_TOPK), np.float32)
    for i, q in enumerate(handles):
        if (q.outcome or "").startswith("answered"):
            ids[i], scores[i] = q.result(timeout=0)
    np.savez(os.path.join(d, "serve.npz"), ids=ids, scores=scores)
    with open(os.path.join(d, "serve.json"), "w") as f:
        json.dump(rep, f)
    return 0


def ppr_group_phase(tmp):
    """Phase 17 (see the module docstring), from ``ppr_group_inputs``'s
    files. Returns K1w's record over a group for the kernels line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.engines.ppr import PprTorchEngine
    from pagerank_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    card = card_identity()
    d = os.path.join(tmp, "ppr_group")
    with np.load(os.path.join(d, "ref.npz")) as f:
        ref = {k: f[k] for k in f.files}
    w = PPR_GROUP_WORLD
    codes = distributed.spawn_group(
        "chip_smoke:phase17_rank", w, {"dir": d}, d, backend="gloo",
        timeout_s=300.0, deadline_s=900.0, rescue=True)
    _check(list(codes) == [0, -9] and list(codes.lost) == [1],
           f"phase 17 process exit codes {list(codes)}, lost "
           f"{list(codes.lost)}")
    reps = [json.load(open(os.path.join(d, f"engine{r}.json")))
            for r in range(w)]
    # (a)
    for r in reps:
        _check(r["launches"] == PPR_ITERS and r["equal"],
               f"17(a) rank {r['rank']}: K1w launched {r['launches']} times "
               f"(want {PPR_ITERS}), equal to its plain version on its "
               f"share: {r['equal']}")
        _check(len(r["psum_ms"]) == PPR_ITERS and r["world"] == w
               and r["backend"] == "gloo",
               f"17(a) rank {r['rank']}: {len(r['psum_ms'])} psums, world "
               f"{r['world']}, backend {r['backend']}")
    _check(sum(r["num_rows"] for r in reps) == reps[0]["slot_rows"],
           "17(a): the shares do not cover the padded table")
    with np.load(os.path.join(d, "engine.npz")) as f:
        err_a = _held_topk("17(a) world 2", f["ids"], f["scores"],
                           ref["ids"], ref["scores"])
    psum_ms = [statistics.median(r["psum_ms"]) for r in reps]
    iter_ms = [r["chunk_ms"] / PPR_ITERS for r in reps]
    for r, p_ms, i_ms in zip(reps, psum_ms, iter_ms):
        print(f"phase 17(a) on {card}, rank {r['rank']} of {w} (gloo, "
              f"cuda:0 shared): {r['num_rows']} of {r['slot_rows']} slot "
              f"rows; K1w {r['launches']} launches in the chunk, its launch "
              f"on the share torch.equal to the plain version (sums and "
              f"folded mass), {r['k1w_ms']:.4f} ms (CUDA events, median of "
              f"20; {r['bound_by']} bound {r['bound_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms); the chunk {r['chunk_ms']:.1f} ms "
              f"= {i_ms:.2f} ms an iteration, of which the psum "
              f"{p_ms:.2f} ms (median of {PPR_ITERS}, "
              f"{p_ms / i_ms:.1%}); graph {r['graph_s']:.1f} s, engine "
              f"build + bind {r['build_s']:.1f} s")
    print(f"phase 17(a): world-2 top-{PPR_TOPK} of {PPR_CHUNK} sources "
          f"within {PPR_GROUP_RTOL:g} (rtol) / {PPR_GROUP_ATOL:g} of phase "
          f"12's one-device run (max abs {err_a:.3e}), untied ids equal")
    # (c)
    r0 = json.load(open(os.path.join(d, "serve.json")))
    nq = SERVE_GROUP_BATCH * SERVE_GROUP_BATCHES
    killed = SERVE_GROUP_KILL - 1  # the batch that was in flight
    want_out = (["answered"] * (SERVE_GROUP_BATCH * killed)
                + ["answered_degraded"] * (nq - SERVE_GROUP_BATCH * killed))
    _check(r0["outcomes"] == want_out and r0["device_ids"] == [0]
           and r0["rescues"] == 1 and len(r0["walls"]) == 1,
           f"17(c): outcomes {r0['outcomes']}, device ids "
           f"{r0['device_ids']}, rescues {r0['rescues']}")
    with np.load(os.path.join(d, "serve.npz")) as f:
        err_c = _held_topk("17(c) the daemon", f["ids"], f["scores"],
                           ref["ids"][:nq], ref["scores"][:nq])
    walls = r0["walls"][0]
    bw = r0["batch_walls_ms"]
    print(f"phase 17(c) on {card}: the daemon over {w} gloo ranks "
          f"(start {r0['serve_start_s']:.1f} s with the warm-up batch), "
          f"{SERVE_GROUP_BATCHES} batches of {SERVE_GROUP_BATCH}; member 1 "
          f"SIGKILLed on batch {killed} (dispatch {SERVE_GROUP_KILL}): "
          f"worlds by batch {r0['worlds']}, outcomes "
          f"{want_out.count('answered')} answered + "
          f"{want_out.count('answered_degraded')} answered_degraded, "
          f"answers within the tolerance of phase 12's (max abs "
          f"{err_c:.3e}); the rescue: roll call {walls['roll_call']:.3f} s, "
          f"regroup {walls['regroup']:.3f} s, rebuild "
          f"{walls['rebuild']:.3f} s, re-run {walls['rerun']:.3f} s; batch "
          f"walls (host clock; batch {killed} holds the rescue) "
          + ", ".join(f"{x:.1f}" for x in bw) + " ms")
    # (b) the CLI in a group of one under NCCL.
    out = os.path.join(d, "cli.tsv")
    calls, in_solve = [], [False]
    names = [k for k in ("all_reduce", "broadcast", "all_gather_into_tensor",
                         "reduce_scatter_tensor", "barrier",
                         "batch_isend_irecv") if hasattr(dist, k)]
    originals = {k: getattr(dist, k) for k in names}

    def counted(k, fn):
        def call(*a, **kw):
            calls.append((k, in_solve[0]))
            return fn(*a, **kw)
        return call

    run = PprTorchEngine.run

    def noted_run(self, *a, **kw):
        in_solve[0] = True
        try:
            return run(self, *a, **kw)
        finally:
            in_solve[0] = False

    _reset_counts()
    t1 = time.perf_counter()
    try:
        for k in names:
            setattr(dist, k, counted(k, originals[k]))
        PprTorchEngine.run = noted_run
        rc = cli.main(["--input", os.path.join(d, "edges.npz"),
                       "--ppr-sources", ",".join(map(str, ref["sources"])),
                       "--ppr-topk", str(PPR_TOPK), "--ppr-chunk",
                       str(PPR_CHUNK), "--iters", str(PPR_ITERS), "--dtype",
                       "float32", "--num-devices", "1", "--out", out])
    finally:
        PprTorchEngine.run = run
        for k in names:
            setattr(dist, k, originals[k])
    cli_s = time.perf_counter() - t1
    _, _, counts = _read_counts()
    rows = [ln.rstrip("\n").split("\t") for ln in open(out)]
    ids = np.array([int(x[1]) for x in rows]).reshape(PPR_CHUNK, PPR_TOPK)
    scores = np.array([float(x[2]) for x in rows],
                      np.float32).reshape(PPR_CHUNK, PPR_TOPK)
    _check(rc == 0 and counts["K1w"] == PPR_ITERS
           and not [c for c in calls if c[1]],
           f"17(b): rc {rc}, K1w {counts['K1w']} launches, "
           f"torch.distributed calls in the solve "
           f"{[c for c in calls if c[1]][:4]}")
    _check(np.array_equal(ids, ref["ids"])
           and np.array_equal(scores, ref["scores"]),
           "17(b): the CLI's --num-devices 1 rows differ from phase 12's")
    print(f"phase 17(b) on {card}: CLI --ppr-sources ({PPR_CHUNK} sources) "
          f"--num-devices 1 under NCCL (a group of one): K1w "
          f"{counts['K1w']} launches, no torch.distributed call in the "
          f"solve ({len(calls)} in the whole run), the rows bit-equal to "
          f"phase 12's, {cli_s:.1f} s")
    torch.cuda.synchronize()
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    return {"world": w, "launches_per_rank": [r["launches"] for r in reps],
            "max_abs_err": max(r["max_abs_err"] for r in reps),
            "rank_ms": [r["k1w_ms"] for r in reps],
            "rank_bound_ms": [r["bound_ms"] for r in reps],
            "rank_plain_ms": [r["plain_ms"] for r in reps],
            "psum_ms": psum_ms, "chunk_iter_ms": iter_ms,
            "topk_max_abs_vs_one_device": err_a,
            "serve_rescue_s": walls, "serve_batch_walls_ms": bw,
            "nccl_group_of_one_launches": counts["K1w"]}


MESH5_SCALE = 18
MESH5_WORLD = 2
MESH5_TOPK = 64
MESH5_EVERY = 2
#: Probe values within this relative distance of a neighbour's are a
#: tie: their ids may swap between a run over a group and one device
#: (f32 sums regroup across the ranks).
MESH5_TIE_RTOL = 1e-6


def _mesh5_forms(span):
    """(name, config fields, kernel, kind) of each phase-19 run over the
    group: "plain", "probed" (ConvergenceProbes every MESH5_EVERY steps,
    top MESH5_TOPK), "device" (``build_device`` of a graph each rank
    built on the card) or "coo" (no hand kernel)."""
    return [
        ("edge_flat", {}, "K1", "plain"),
        ("edge_flat_probed", {}, "K1", "probed"),
        ("edge_part_f32", {"partition_span": span}, "K2", "plain"),
        ("edge_part_f32_probed", {"partition_span": span}, "K2", "probed"),
        ("vertex_sharded", {"vertex_sharded": True}, "K1", "plain"),
        ("vertex_sharded_probed", {"vertex_sharded": True}, "K1",
         "probed"),
        ("edge_flat_device", {}, "K1", "device"),
        ("vertex_sharded_device", {"vertex_sharded": True}, "K1", "device"),
        ("coo", {"kernel": "coo"}, None, "coo"),
    ]


def phase19_rank(payload) -> int:
    """One rank of phase 19(a)-(c) (spawned; joined to the gloo group):
    every form of ``_mesh5_forms`` over this rank's share on the
    payload's device; rank 0 writes the final ranks, every rank its
    numbers (and probe history) as JSON."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.ops import device_build as db
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops import ell_spmv_partitioned as k2
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.testing.sharded import recorded_probes

    torch.set_num_threads(4)
    rank, world = distributed.process_info()
    dev = torch.device(payload["device"])
    out = payload["out"]
    with np.load(payload["edges"]) as f:
        graph = build_graph(f["src"], f["dst"], n=int(f["n"]))
    rep, planes = {}, {}
    for name, kw, kernel, kind in _mesh5_forms(payload["span"]):
        cfg = PageRankConfig(num_iters=ITERS, num_devices=world, **kw)
        eng = TorchEngine(cfg, device=dev)
        t0 = time.perf_counter()
        if kind == "device":
            # Every rank builds the whole graph on its own card from the
            # same deduplicated edges: the host pack's planes.
            eng.build_device(db.build_ell_device(
                torch.from_numpy(graph.src), torch.from_numpy(graph.dst),
                graph.n, with_weights=False, device=dev))
        else:
            eng.build(graph)
        r = {"build_s": time.perf_counter() - t0,
             "form": eng.layout_info()["form"],
             "build": eng.layout_info()["build"],
             "rows": eng.layout_info()["num_rows"]}
        if kernel is not None:
            a = eng._arrays
            rows = a.get("row_block", a.get("row_pair"))
            if kind == "plain":
                planes[name] = (a["src"].clone(), rows.clone())
            elif kind == "device":
                host_src, host_rows = planes[name.removesuffix("_device")]
                r["planes_equal"] = bool(torch.equal(a["src"], host_src)
                                         and torch.equal(rows, host_rows))
            if dev.type == "cuda":
                # The first step's kernel on this rank's rows against
                # its plain version on the CPU (r0 prescaled).
                inputs = eng.contrib_inputs()
                got = eng._launch().clone().cpu()
                if kernel == "K1":
                    z, src, _, _, plan = inputs
                    want = ell_spmv.ell_contrib_plan_reference(
                        z.cpu(), src.cpu(), accum_dtype=eng._accum,
                        plan=ell_spmv.plan_to(plan, "cpu"))
                else:
                    zw, slots, _, pp, _, plan = inputs
                    want = k2.ell_contrib_partitioned_plan_reference(
                        zw.cpu(), slots.cpu(), pp.cpu(),
                        plan=ell_spmv.plan_to(plan, "cpu"))
                r["kernel_equal"] = bool(torch.equal(got, want))
                r["kernel_err"] = float((got.double() - want.double())
                                        .abs().max())
                del inputs, got, want
        probes = (recorded_probes(MESH5_EVERY, MESH5_TOPK)
                  if kind == "probed" else None)
        step_s, t_last = [], [0.0]

        def on_iteration(i, info):
            now = time.perf_counter()
            step_s.append(now - t_last[0])
            t_last[0] = now

        ell_spmv.launches = k2.launches = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_last[0] = time.perf_counter()
        ranks = eng.run(on_iteration=on_iteration, probes=probes)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        r.update(launches={"K1": ell_spmv.launches, "K2": k2.launches},
                 ms_per_iter=statistics.median(step_s) * 1e3,
                 ms_per_iter_1_2=statistics.median(step_s[1:]) * 1e3)
        if probes is not None:
            r["probes"] = probes.records
        if rank == 0:
            np.save(os.path.join(out, f"{name}.npy"), ranks)
        rep[name] = r
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    return 0


def _held_probes(label, got, want, ranks_at):
    """Hold a probe history over the group to the one-device run's: the
    same probe iterations, rank mass within 1e-6 relative, top-k ids
    equal wherever the one-device value is not within MESH5_TIE_RTOL of
    a neighbour's (``ranks_at[iteration]``: its ranks at each probe),
    the churn equal where no tie touches the k-th place (in this probe
    or the one before). Returns (largest mass error, tied places)."""
    import numpy as np

    _check([g["iteration"] for g in got] == [w["iteration"] for w in want],
           f"{label}: probe iterations {[g['iteration'] for g in got]}")
    worst, tied_places, edge_tied = 0.0, 0, False
    for g, w in zip(got, want):
        err = abs(g["rank_mass"] - w["rank_mass"]) / abs(w["rank_mass"])
        worst = max(worst, err)
        _check(err <= 1e-6, f"{label} probe {g['iteration']}: rank mass "
               f"{g['rank_mass']} vs one device {w['rank_mass']}")
        r = ranks_at[w["iteration"]]
        vals = np.sort(r)[::-1][: MESH5_TOPK + 1].astype(np.float64)
        near = np.abs(np.diff(vals)) <= MESH5_TIE_RTOL * np.abs(vals[1:])
        tied = np.zeros(MESH5_TOPK + 1, bool)
        tied[1:] |= near
        tied[:-1] |= near
        gi, wi = np.array(g["ids"]), np.array(w["ids"])
        bad = int(((gi != wi) & ~tied[:MESH5_TOPK]).sum())
        _check(bad == 0, f"{label} probe {g['iteration']}: {bad} untied "
               f"top-k ids differ from the one-device run's")
        tied_places += int(tied[:MESH5_TOPK].sum())
        boundary = bool(tied[MESH5_TOPK - 1])
        if not (boundary or edge_tied):
            _check(g["topk_churn"] == w["topk_churn"],
                   f"{label} probe {g['iteration']}: churn "
                   f"{g['topk_churn']} vs {w['topk_churn']}")
        edge_tied = boundary
    return worst, tied_places


def mesh_job_phase(tmp, dev="cuda"):
    """Phase 19 (see the module docstring). Returns the numbers for the
    kernels line: K1's and K2's launches a rank and ms/iter over the
    group, the coo form's ms/iter and (d)'s."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, cli
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.testing.sharded import recorded_probes
    from pagerank_tpu_torch.utils.synth import rmat_edges

    t0 = time.perf_counter()
    card = card_identity() if dev == "cuda" else "cpu"
    d = os.path.join(tmp, "mesh5")
    os.makedirs(d, exist_ok=True)
    graph = build_graph(*rmat_edges(MESH5_SCALE), n=1 << MESH5_SCALE)
    np.savez(os.path.join(d, "edges.npz"), src=graph.src, dst=graph.dst,
             n=graph.n)
    span = cli.plan_partition_span(PageRankConfig(), graph.n,
                                   graph.num_edges, -1)
    _check(span > 0, f"the auto rule turned the partitioned form off at "
           f"rmat:{MESH5_SCALE}")
    # The one-device runs the group is held to: flat and partitioned
    # probed (their ranks kept at each probe), coo.
    one = {}
    for name, kw in (("flat", {}), ("part", {"partition_span": span}),
                     ("coo", {"kernel": "coo"})):
        eng = TorchEngine(PageRankConfig(num_iters=ITERS, **kw),
                          device=dev).build(graph)
        at = {}
        probes = (recorded_probes(MESH5_EVERY, MESH5_TOPK, lambda i:
                                  at.__setitem__(i, eng.ranks()))
                  if name != "coo" else None)
        step_s, t_last = [], [time.perf_counter()]

        def on_iteration(i, info):
            now = time.perf_counter()
            step_s.append(now - t_last[0])
            t_last[0] = now

        one[name] = {"ranks": eng.run(on_iteration=on_iteration,
                                      probes=probes),
                     "probes": probes.records if probes else None,
                     "at": at,
                     "ms_per_iter": statistics.median(step_s) * 1e3}
        del eng
    codes = distributed.spawn_group(
        "chip_smoke:phase19_rank", MESH5_WORLD,
        {"edges": os.path.join(d, "edges.npz"), "out": d, "span": span,
         "device": f"{dev}:0" if dev == "cuda" else dev},
        d, backend="gloo", timeout_s=300.0, deadline_s=600.0)
    _check(codes == [0] * MESH5_WORLD, f"phase 19 rank exit codes {codes}")
    reps = [json.load(open(os.path.join(d, f"rank{r}.json")))
            for r in range(MESH5_WORLD)]

    def ranks(name):
        return np.load(os.path.join(d, f"{name}.npy"))

    def l1(a, b):
        return float(np.abs(a - b).sum() / np.abs(b).sum())

    print(f"phase 19 on {card} (gloo, {MESH5_WORLD} ranks sharing "
          f"{dev}:0; rmat:{MESH5_SCALE}, {graph.num_edges:,} edges, span "
          f"{span}):")
    got = {}
    for name, _, kernel, kind in _mesh5_forms(span):
        for r, rep in enumerate(reps):
            x = rep[name]
            want = ({"K1": 0, "K2": 0} if kernel is None else
                    {"K1": ITERS if kernel == "K1" else 0,
                     "K2": ITERS if kernel == "K2" else 0})
            # (A CPU rehearsal runs the plain versions: nothing counts.)
            _check(x["launches"] == want or dev != "cuda",
                   f"{name} rank {r}: launches "
                   f"{x['launches']}, want {want} in {ITERS} steps")
            _check(x.get("kernel_equal", True), f"{name} rank {r}: "
                   f"{kernel} != its plain version on its rows (max err "
                   f"{x.get('kernel_err')})")
            _check(x.get("planes_equal", True), f"{name} rank {r}: the "
                   f"device-built slot planes != its share of the host "
                   f"pack")
        final = ranks(name)
        _check(final.shape == (graph.n,) and np.isfinite(final).all(),
               f"{name}: ranks not finite of shape (n,)")
        base = name.removesuffix("_probed").removesuffix("_device")
        x0 = reps[0][name]
        rows = ", ".join(str(x[name]["rows"]) for x in reps)
        ms = ", ".join(f"{x[name]['ms_per_iter']:.3f}" for x in reps)
        line = (f"  {name}: {x0['form']} ({x0['build']} build), {rows} slot "
                f"rows a rank; {kernel or 'no hand kernel'} "
                f"{x0['launches'][kernel] if kernel else 0} launches a "
                f"rank; ms/iter {ms} by rank")
        if kind in ("probed", "device"):
            _check(np.array_equal(final, ranks(base)),
                   f"{name}: ranks != the {base} run's")
            line += f"; ranks bit-equal to {base}"
        if kind == "device":
            line += "; slot planes torch.equal to the host pack's share"
        if kind == "probed":
            hist = [x[name]["probes"] for x in reps]
            _check(all(h == hist[0] for h in hist),
                   f"{name}: the ranks' probe histories differ")
            ref = one["part" if "part" in name else "flat"]
            worst, tied = _held_probes(name, hist[0], ref["probes"],
                                       ref["at"])
            line += (f"; {len(hist[0])} probes, every rank the same, rank "
                     f"mass within {worst:.2e} of one device, top-{MESH5_TOPK}"
                     f" ids equal ({tied} tied places exempt), churn "
                     f"{[p['topk_churn'] for p in hist[0]]}")
        if kind == "coo":
            dist_l1 = l1(final, one["coo"]["ranks"])
            _check(dist_l1 <= 1e-5, f"coo over the group vs one device: "
                   f"normalised L1 {dist_l1}")
            line += (f"; vs the one-device coo run normalised L1 "
                     f"{dist_l1:.3e} (one device "
                     f"{one['coo']['ms_per_iter']:.3f} ms/iter)")
        print(line)
        got[name] = {"launches": [x[name]["launches"] for x in reps],
                     "ms_per_iter": [x[name]["ms_per_iter"] for x in reps]}
    # (d) the CLI under the group backend of --device, a group of one.
    argv = ["--synthetic", f"rmat:{MESH5_SCALE}", "--device-build",
            "--num-devices", "1", "--vertex-sharded", "--probe-every", "2",
            "--snapshot-every", "2", "--iters", str(ITERS), "--log-every",
            "0", "--device", dev]
    runs = {}
    for label, extra in (("async", []), ("sync", ["--sync-io"]),
                         ("rerun", [])):
        job = os.path.join(d, "job_" + ("sync" if label == "sync"
                                        else "async"))
        out = os.path.join(d, f"cli_{label}.tsv")
        _reset_counts()
        t1 = time.perf_counter()
        rc = cli.main(argv + extra + ["--job-dir", job, "--out", out])
        k1, k2n, _ = _read_counts()
        runs[label] = {"rc": rc, "K1": k1, "K2": k2n, "job": job,
                       "s": time.perf_counter() - t1,
                       "ranks": np.array([float(ln.split("\t")[1])
                                          for ln in open(out)])}
        want = 0 if label == "rerun" or dev != "cuda" else ITERS
        _check(rc == 0 and k1 == want and k2n == 0,
               f"phase 19(d) {label}: rc {rc}, K1 {k1}, K2 {k2n} (want K1 "
               f"{want})")
    a, b = (os.path.join(runs[k]["job"], "snapshots") for k in
            ("async", "sync"))
    (sa,), (sb,) = os.listdir(a), os.listdir(b)
    files = sorted(os.listdir(os.path.join(a, sa)))
    _check(sa == sb and files == sorted(os.listdir(os.path.join(b, sb)))
           and len(files) == ITERS // 2,
           f"phase 19(d): snapshot dirs {sa}/{sb}, files {files}")
    for name in files:
        with open(os.path.join(a, sa, name), "rb") as fa, \
                open(os.path.join(b, sb, name), "rb") as fb:
            _check(fa.read() == fb.read(),
                   f"phase 19(d): async snapshot {name} != --sync-io's")
    manifest = json.load(open(os.path.join(runs["rerun"]["job"],
                                           "job.json")))
    skipped = [s for s, rec in manifest["stages"].items()
               if rec.get("skipped")]
    _check(skipped == ["ingest", "build", "solve"]
           and np.array_equal(runs["rerun"]["ranks"], runs["async"]["ranks"])
           and np.array_equal(runs["sync"]["ranks"], runs["async"]["ranks"]),
           f"phase 19(d): the rerun skipped {skipped}; ranks equal "
           f"{np.array_equal(runs['rerun']['ranks'], runs['async']['ranks'])}")
    print(f"phase 19(d) on {card}: CLI --num-devices 1 --vertex-sharded "
          f"--device-build --job-dir --probe-every 2 (a group of one): the "
          f"async run {runs['async']['s']:.1f} s and the --sync-io run "
          f"{runs['sync']['s']:.1f} s exit 0 with K1 {ITERS} launches, "
          f"{len(files)} snapshots byte-equal; the rerun "
          f"({runs['rerun']['s']:.1f} s) skips {', '.join(skipped)}, K1 0, "
          f"ranks equal")
    got["cli_s"] = {k: v["s"] for k, v in runs.items()}
    secs = time.perf_counter() - t0
    got["seconds"] = secs
    print(f"phase 19 took {secs:.1f} s")
    return got


FRONT_WORLD = 3
#: Phase 20(a): JAX's daemon test schedule, the device of member 0
#: lost at batch 1 (tests/test_serving.py:190-203).
FRONT_KILL = {1: 0}
QUARANTINE_SCALE = 16
QUARANTINE_ITERS = 20


def phase20_rank(payload) -> int:
    """One rank of phase 20(a) (spawned rescue-armed; joined to the gloo
    group, on cuda:0): the daemon over the group; member 0's device is
    lost at batch 1 and it serves on as the front. Every rank writes
    its K1w launch count after each engine run; each survivor holds its
    launch on its new share against the plain version."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig
    from pagerank_tpu_torch.engines.ppr import PprTorchEngine
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.ops import ell as ell_lib
    from pagerank_tpu_torch.ops import ell_spmm
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel.elastic import (ElasticExhaustedError,
                                                     RankLeftError)
    from pagerank_tpu_torch.serving.daemon import PprServer, ServeConfig
    from pagerank_tpu_torch.testing.faults import DeviceFaultSchedule
    from pagerank_tpu_torch.testing.load import install_serve_faults
    from pagerank_tpu_torch.testing.schedules import VirtualClock

    torch.set_num_threads(2)
    rank, world = distributed.process_info()
    me = distributed.member()
    dev = torch.device(payload["device"])
    d, out = payload["dir"], payload["out"]
    with np.load(os.path.join(d, "edges.npz")) as f:
        graph = build_graph(f["src"], f["dst"], n=int(f["n"]))
    with np.load(os.path.join(d, "ref.npz")) as f:
        sources = f["sources"]
    cfg = PageRankConfig(num_iters=PPR_ITERS, dtype="float32",
                         accum_dtype="float32", num_devices=world)
    runs = []
    run = PprTorchEngine.run

    def counted(self, *a, **kw):
        res = run(self, *a, **kw)
        runs.append(ell_spmm.launches)
        return res

    PprTorchEngine.run = counted
    srv = PprServer(
        graph, config=cfg,
        serve_config=ServeConfig(
            max_batch=SERVE_GROUP_BATCH, topk=PPR_TOPK, cache_capacity=0,
            queue_depth=64, deadline_ms=600_000.0, dispatch_timeout_s=600.0,
            probe_timeout_s=60.0),
        devices=[dev], clock=VirtualClock())
    ell_spmm.launches = 0
    rep = {"member": me}
    if rank != 0:
        try:
            srv.follow()
            rep["status"] = "stopped"
        except (RankLeftError, ElasticExhaustedError) as e:
            rep["status"] = f"{type(e).__name__}: {e}"
        rep["runs"] = list(runs)
        rep["walls"] = srv.rescue_walls
        rep["device_ids"] = srv.device_ids()
        eng = srv._engine
        if eng is not None:
            rep["num_rows"] = eng.layout_info()["num_rows"]
        if rep["status"] == "stopped" and getattr(eng, "_launcher", None):
            # The last launch's inputs (the final batch's last prescaled
            # chunk) on this survivor's new share, against the plain
            # version; read after the counts, so not counted.
            kc = SERVE_GROUP_BATCH  # every batch of the plan is full
            src, rb, nb = eng._src, eng._row_block, eng._num_blocks
            eng._launcher(kc)
            got = eng._sums[: nb * 128, :kc].cpu()
            got_mass = eng._launcher.mass[:kc].cpu()
            kw = {"accum_dtype": torch.float32, "k": kc, "kt": 8,
                  "plan": ell_lib.segment_plan(rb.cpu().numpy(), nb)}
            want = ell_spmm.ell_contrib_spmm_rows_reference(
                eng._z2.cpu(), src.cpu(), **kw)
            want_mass = ell_spmm.mass_reference(eng._z2.cpu(), src.cpu(),
                                                **kw)
            rep["equal"] = bool(torch.equal(got, want)
                                and torch.equal(got_mass, want_mass))
            rep["max_abs_err"] = float((got.double()
                                        - want.double()).abs().max())
        with open(os.path.join(out, f"member{me}.json"), "w") as f:
            json.dump(rep, f)
        return 0 if rep["status"] == "stopped" else 1
    t0 = time.perf_counter()
    srv.start(dispatcher=False)
    rep["serve_start_s"] = time.perf_counter() - t0
    install_serve_faults(srv, DeviceFaultSchedule(seed=11, kill=FRONT_KILL))
    handles, worlds, walls, before = [], [], [], []
    for i in range(SERVE_GROUP_BATCHES):
        batch = sources[i * SERVE_GROUP_BATCH: (i + 1) * SERVE_GROUP_BATCH]
        before.append(ell_spmm.launches)
        handles += [srv.submit(int(x)) for x in batch]
        t0 = time.perf_counter()
        srv.pump()
        walls.append(time.perf_counter() - t0)
        worlds.append(srv.device_count)
    srv.drain()
    n = len(handles)
    rep.update(outcomes=[q.outcome for q in handles], worlds=worlds,
               device_ids=srv.device_ids(), rescues=srv.rescues_done,
               degraded=srv.degraded, walls=srv.rescue_walls,
               launches_before=before, launches=ell_spmm.launches,
               runs=list(runs), batch_walls_ms=[1e3 * w for w in walls],
               fatal=repr(srv.fatal) if srv.fatal else "")
    ids = np.full((n, PPR_TOPK), -1, np.int64)
    scores = np.zeros((n, PPR_TOPK), np.float32)
    for i, q in enumerate(handles):
        if (q.outcome or "").startswith("answered"):
            ids[i], scores[i] = q.result(timeout=0)
    np.savez(os.path.join(out, "serve.npz"), ids=ids, scores=scores)
    with open(os.path.join(out, "member0.json"), "w") as f:
        json.dump(rep, f)
    return 0


def front_phase(tmp, dev="cuda:0"):
    """20(a): the daemon survives the loss of member 0's device
    (``dev="cpu"`` rehearses it on the host: all but the launch counts
    hold there)."""
    import numpy as np

    from pagerank_tpu_torch.parallel import distributed

    card = card_identity()
    d = os.path.join(tmp, "ppr_group")
    out = os.path.join(tmp, "front")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    codes = distributed.spawn_group(
        "chip_smoke:phase20_rank", FRONT_WORLD,
        {"dir": d, "out": out, "device": dev},
        out, backend="gloo", timeout_s=300.0, deadline_s=900.0,
        rescue=True)
    wall = time.perf_counter() - t0
    _check(list(codes) == [0] * FRONT_WORLD and list(codes.lost) == [0]
           and list(codes.hosts) == [0],
           f"20(a) exit codes {list(codes)}, lost {list(codes.lost)}, "
           f"hosts {list(codes.hosts)}")
    reps = {m: json.load(open(os.path.join(out, f"member{m}.json")))
            for m in range(FRONT_WORLD)}
    r0 = reps[0]
    nb, b = SERVE_GROUP_BATCHES, SERVE_GROUP_BATCH
    want = ["answered"] * b + ["answered_degraded"] * (b * (nb - 1))
    _check(r0["outcomes"] == want and r0["device_ids"] == [1, 2]
           and r0["rescues"] == 1 and r0["degraded"]
           and r0["worlds"] == [3] + [2] * (nb - 1) and not r0["fatal"],
           f"20(a): outcomes {r0['outcomes']}, device ids "
           f"{r0['device_ids']}, rescues {r0['rescues']}, worlds "
           f"{r0['worlds']}, fatal {r0['fatal']!r}")
    # Member 0: the warm-up and batch 0, then nothing.
    _check(r0["runs"] == [PPR_ITERS, 2 * PPR_ITERS]
           and r0["launches"] == r0["launches_before"][1] == 2 * PPR_ITERS,
           f"20(a) member 0 launched K1w after its device was lost: runs "
           f"{r0['runs']}, launches {r0['launches']}, before each batch "
           f"{r0['launches_before']}")
    for m in (1, 2):
        r = reps[m]
        _check(r["status"] == "stopped"
               and r["runs"] == [PPR_ITERS * (i + 1) for i in range(nb + 1)]
               and r["device_ids"] == [1, 2] and r["equal"],
               f"20(a) member {m}: {r['status']}, K1w counts after each run "
               f"{r['runs']}, device ids {r['device_ids']}, its launch on "
               f"its new share equal to its plain version: {r.get('equal')}")
    with np.load(os.path.join(d, "ref.npz")) as f:
        ref_ids, ref_scores = f["ids"], f["scores"]
    with np.load(os.path.join(out, "serve.npz")) as f:
        err = _held_topk("20(a) the front", f["ids"], f["scores"],
                         ref_ids[: nb * b], ref_scores[: nb * b])
    w0, w1, w2 = r0["walls"][0], reps[1]["walls"][0], reps[2]["walls"][0]
    bw = r0["batch_walls_ms"]
    print(f"phase 20(a) on {card}: the daemon over {FRONT_WORLD} gloo ranks "
          f"(cuda:0 shared; start {r0['serve_start_s']:.1f} s with the "
          f"warm-up), {nb} batches of {b}; member 0's DEVICE lost at batch "
          f"1 (DeviceFaultSchedule(seed=11, kill={{0: 1}})): member 0 "
          f"serves on as the front over members {r0['device_ids']}, worlds "
          f"by batch {r0['worlds']}, outcomes {want.count('answered')} "
          f"answered + {want.count('answered_degraded')} "
          f"answered_degraded, answers within the tolerance of phase 12's "
          f"(max abs {err:.3e}); K1w launches: member 0 "
          f"{r0['runs']} (none after the loss), member 1 "
          f"{reps[1]['runs']}, member 2 {reps[2]['runs']}; each survivor's "
          f"launch on its new share ({reps[1]['num_rows']} and "
          f"{reps[2]['num_rows']} rows) torch.equal to its plain version")
    print(f"phase 20(a) the rescue by part: member 0 roll call "
          f"{w0['roll_call']:.3f} s, re-run through the survivors "
          f"{w0['rerun']:.3f} s; member 1 roll call {w1['roll_call']:.3f} "
          f"s, regroup {w1['regroup']:.3f} s, rebuild {w1['rebuild']:.3f} "
          f"s; member 2 roll call {w2['roll_call']:.3f} s, regroup "
          f"{w2['regroup']:.3f} s, rebuild {w2['rebuild']:.3f} s; batch "
          f"walls {', '.join(f'{x:.1f}' for x in bw)} ms; {wall:.1f} s")
    return {"launches": {"member0": r0["runs"], "member1": reps[1]["runs"],
                         "member2": reps[2]["runs"]},
            "max_abs_err": err, "walls": [w0, w1, w2],
            "batch_walls_ms": bw, "seconds": wall}


def _cli_subprocess(args, timeout=600):
    """``python -m <args>`` from the checkout; returns (rc, out, err)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=timeout)
    return r.returncode, r.stdout, r.stderr


def _in_process(module, argv):
    """``module``'s ``main(argv)`` in this process, as ``python -m
    module`` would run it; returns (rc, out, err)."""
    import contextlib
    import importlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = importlib.import_module(module).main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def quarantine_phase(tmp):
    """20(b): a group job whose manifest quarantines member 1."""
    import numpy as np

    from pagerank_tpu_torch import jobs

    d = os.path.join(tmp, "quarantine")
    os.makedirs(d, exist_ok=True)
    jobs.JobSupervisor(os.path.join(d, "J")).quarantine_devices([1])
    base = ["pagerank_tpu_torch.cli", "--synthetic",
            f"rmat:{QUARANTINE_SCALE}", "--device", "cpu", "--dtype",
            "float64", "--accum-dtype", "float64", "--iters",
            str(QUARANTINE_ITERS), "--log-every", "0"]
    t0 = time.perf_counter()
    rc, _, err = _cli_subprocess(base + [
        "--num-devices", str(FRONT_WORLD), "--job-dir",
        os.path.join(d, "J"), "--run-report", os.path.join(d, "a.json"),
        "--out", os.path.join(d, "group.tsv")])
    group_s = time.perf_counter() - t0
    line = ("excluding quarantined device(s) [1] (job manifest); building "
            "on 2 device(s)")
    _check(rc == 0 and line in err.splitlines()
           and "lost rank(s) [1] (exit codes {1: 1})" in err,
           f"20(b) the quarantined group job: rc {rc}, stderr "
           f"{err[-1500:]}")
    rc1, _, err1 = _in_process(base[0], base[1:] + [
        "--run-report", os.path.join(d, "b.json"),
        "--out", os.path.join(d, "one.tsv")])
    _check(rc1 == 0, f"20(b) the one-device run: rc {rc1} {err1[-800:]}")

    def tsv(name):
        return np.array([float(ln.split("\t")[1])
                         for ln in open(os.path.join(d, name))])

    group, one = tsv("group.tsv"), tsv("one.tsv")
    diff = float(np.abs(group - one).max())
    _check(group.shape == one.shape == (1 << QUARANTINE_SCALE,)
           and diff <= 1e-12,
           f"20(b) ranks off the one-device run's by {diff:.3e}")
    print(f"phase 20(b) on the card's host (three gloo ranks, --device cpu; "
          f"no kernel launches in this part): rmat:{QUARANTINE_SCALE} f64, "
          f"{QUARANTINE_ITERS} iterations, job manifest quarantining "
          f"member 1: '{line}' on stderr, member 1 left with exit 1, "
          f"members 0 and 2 within {diff:.3e} of the one-device run (max "
          f"abs); {group_s:.1f} s")
    return d


def tools_phase(reports_dir, preflight, dev="cuda"):
    """20(c): the offline tools on the card's machine, each ``main`` run
    in this process (the same code as ``python -m``, without a
    subprocess's torch import)."""
    import tempfile as tf

    def obs(*argv):
        return _in_process("pagerank_tpu_torch.obs.__main__", list(argv))

    with tf.TemporaryDirectory(prefix="obs_", dir=reports_dir) as t:
        a, b = (os.path.join(reports_dir, f"{x}.json") for x in "ab")
        rc, out, err = obs("report", a, b)
        _check(rc == 0 and "phase wall deltas (A -> B)" in out,
               f"20(c) obs report: rc {rc} {err[-800:]}")
        led = os.path.join(t, "ledger.jsonl")
        rc, out, err = obs("history", "ingest", led, a, b, "--json")
        _check(rc == 0 and json.loads(out) == {"added": 2, "deduped": 0},
               f"20(c) obs history ingest: rc {rc} {out} {err[-800:]}")
        rc, out, err = obs("history", "gate", led, "--json")
        gate = json.loads(out) if rc in (0, 1) else {}
        _check(rc == 0 and gate.get("ok") is True,
               f"20(c) obs history gate: rc {rc} {out[-800:]} {err[-800:]}")
    rc, out, err = obs("fit", "--scale", "22", "--json")
    fit = json.loads(out) if rc in (0, 1) else {}
    meas = preflight[22]["measured"]
    pred = fit.get("peak_bytes") or 0
    _check(rc == 0 and fit.get("fits") is True
           and meas <= pred <= FIT_BAND * meas,
           f"20(c) obs fit --scale 22: rc {rc}, predicted {pred} B against "
           f"phase 14(c)'s measured {meas} B ({err[-400:]})")
    t0 = time.perf_counter()
    rc, out, err = obs("graph", "--scale", "18", "--device-build",
                       "--device", dev, "--json")
    graph_s = time.perf_counter() - t0
    doc = json.loads(out) if rc in (0, 1) else {}
    led = doc.get("ledger") or {}
    prof = doc.get("profile") or {}
    _check(rc == 0 and led.get("ok") is True
           and prof.get("n") == 1 << 18,
           f"20(c) obs graph --scale 18: rc {rc} {err[-800:]}")
    t1 = time.perf_counter()
    rc, out, err = _in_process("pagerank_tpu_torch.analysis.__main__",
                               ["--select", "PTL,PTR"])
    lint_s = time.perf_counter() - t1
    _check(rc == 0, f"20(c) analysis --select PTL,PTR: rc {rc} "
           f"{(out + err)[-800:]}")
    print(f"phase 20(c): obs report of (b)'s two run reports, history "
          f"ingest (2 added) and gate (pass) in a temp ledger; obs fit "
          f"--scale 22 predicts a peak of {pred / 1e9:.3f} GB "
          f"({fit.get('peak_stage')}) against phase 14(c)'s measured "
          f"max_memory_allocated {meas / 1e9:.3f} GB ({pred / meas:.4f}x; "
          f"band [1, {FIT_BAND}]); obs graph --scale 18 --device-build on "
          f"the card: {prof.get('num_edges')} unique edges, mass ledger "
          f"{led.get('entries')}/{led.get('probes')} reconciled (max "
          f"|residual| {led.get('max_abs_residual')}), {graph_s:.1f} s; "
          f"analysis --select PTL,PTR exit 0 ({lint_s:.1f} s)")
    return {"fit_predicted": pred, "fit_measured": meas,
            "graph_s": graph_s}


def member0_phase(tmp, preflight, dev="cuda"):
    """Phase 20 (see the module docstring); ``dev="cpu"`` rehearses it on
    the host."""
    t0 = time.perf_counter()
    got = front_phase(tmp, "cuda:0" if dev == "cuda" else dev)
    got["tools"] = tools_phase(quarantine_phase(tmp), preflight, dev)
    got["phase_s"] = time.perf_counter() - t0
    print(f"phase 20 took {got['phase_s']:.1f} s")
    return got


#: Phase 21's keys of the acceptance script, in its order. T (A's graph
#: at 50 textbook steps, 16.5 s on the card) is left to the script's
#: default set, to keep the whole run well inside its limit.
ACCEPTANCE_KEYS = ("F", "A", "G", "H", "K", "R", "U", "W", "L")


def acceptance_phase(dev="cuda"):
    """Phase 21: the acceptance script's keys on the card, in process;
    returns the K1 and K2 records of the kernels line."""
    from pagerank_tpu_torch.scripts import acceptance as acc

    t_phase = time.perf_counter()
    k1, k2 = {}, {}
    for key in ACCEPTANCE_KEYS:
        _reset_counts()
        t0 = time.perf_counter()
        rec = acc.runner_of(key)(key, dev)
        wall = time.perf_counter() - t0
        l1, l2, other = _read_counts()
        _check(rec["passed"], f"21 acceptance key {key} failed: "
               f"{json.dumps(rec, default=str)[:2000]}")
        _check(not any(other.values()),
               f"21 key {key} launched K1w or a probe or fixture kernel: "
               f"{other}")
        if key == "A":
            _check(l1 == rec["iters"] + 1 == rec["k1_launches"] and l2 == 0
                   and rec["k1_entry"] == "ell_contrib_f64_f64",
                   f"21 key {key}: K1 {l1} ({rec['k1_entry']}), K2 {l2} in "
                   f"{rec['iters']} steps and the warm step")
            k1[key] = {n: rec[n] for n in (
                "scale", "iters", "semantics", "num_edges", "normalized_l1",
                "mass_normalized_l1", "device_seconds",
                "edges_per_sec_per_chip", "k1_entry")}
            k1[key].update(launches=l1, wall_s=wall)
            what = (f"{rec['form']} f64/f64 rmat:{rec['scale']} "
                    f"{rec['semantics']}, {rec['iters']} steps "
                    f"{rec['device_seconds'] * 1e3:.3f} ms "
                    f"({rec['edges_per_sec_per_chip']:.4g} edges/s), L1 "
                    f"{rec['normalized_l1']:.3e} / "
                    f"{rec['mass_normalized_l1']:.3e}")
        elif key == "K":
            want = acc.CONFIGS["K"]["iters"]
            _check(l2 == want and l1 == 0,
                   f"21 key K: K2 {l2} (want {want}), K1 {l1}")
            k2[key] = {"launches": l2, "seconds": rec["seconds"],
                       "wall_s": wall}
            what = f"partitioned CLI run, span {rec['partition_span']}"
        elif key == "L":
            # L's launches are its three ranks': each survivor's every
            # step (none recomputed after the rescue), the victim's steps
            # before the kill; none in this process.
            spec = acc.CONFIGS["L"]
            want = {str(m): spec["kill_iter"] if m == acc.LOSS_MEMBER
                    else spec["iters"] for m in range(acc.LOSS_WORLD)}
            got = {str(m): c for m, c in rec["k1_launches"].items()}
            _check(got == want and l1 == 0 and l2 == 0,
                   f"21 key L: K1 by member {got} (want {want}), in this "
                   f"process K1 {l1}, K2 {l2}")
            k1[key] = {"launches": got, "wall_s": wall}
            what = f"elastic, K1 by member {got}"
            l1 = sum(got.values())
        else:
            k1[key] = {"launches": l1, "wall_s": wall}
            what = rec["kind"]
        print(f"phase 21 [{key}] {what}: PASS; K1 {l1}, K2 {l2} launches; "
              f"{wall:.1f} s"
              + (f" (timed {rec['seconds']:.3f} s, budget "
                 f"{rec['budget_s']:g} s)" if "budget_s" in rec else ""))
    acc._GRAPHS.clear()
    acc._ORACLES.clear()
    seconds = time.perf_counter() - t_phase
    print(f"phase 21 took {seconds:.1f} s")
    k1["phase_s"] = seconds
    return {"K1": k1, "K2": k2}


# Phase 22: the port's bench CLI and the measurement campaign. (a) is one
# single-mode run at rmat:BENCH_SCALE built on the card.
BENCH_SCALE = 20
BENCH_ITERS = 10
BENCH_WARMUP = 2


def bench_phase(dev="cuda"):
    """Phase 22 (see the module docstring): returns the K1, K2 and K1w
    records of the kernels line."""
    import contextlib
    import io

    import torch

    from pagerank_tpu_torch import bench
    from pagerank_tpu_torch.scripts import acceptance as acc

    t_phase = time.perf_counter()
    card = card_identity() if dev == "cuda" else "cpu"
    out = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        doc = bench.main(["--dtype", "float32", "--scale", str(BENCH_SCALE),
                          "--iters", str(BENCH_ITERS), "--warmup",
                          str(BENCH_WARMUP), "--no-accuracy", "--device",
                          dev])
    wall_a = time.perf_counter() - t0
    l1, l2, other = _read_counts()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    lay, step = doc["layout"], doc["costs"]["step"]
    want = BENCH_WARMUP + BENCH_ITERS
    on_card = dev != "cpu"
    _check(line["value"] == doc["value"] and lay["form"] == "flat_ell"
           and lay["build"] == "device" and lay["pair"] is False,
           f"22(a) the single-mode record: {json.dumps(lay)[:800]}")
    _check(not on_card or (lay["launches"] == {"K1": want, "K2": 0, "K1w": 0}
                           and l1 == want and l2 == 0
                           and not any(other.values())),
           f"22(a) K1 {l1} (layout {lay['launches']}), K2 {l2}, others "
           f"{other}: want K1 {want}")
    roof = step["roofline_fraction"]
    _check(not on_card or (roof is not None and 0 < roof <= 1.0),
           f"22(a) the step's roofline fraction {roof}")
    ms = step["seconds_per_iter"] * 1e3
    # A smoke reading: 10 steps at rmat:20 spread 2x from call to call
    # (PERF.md §7), too few to compare versions with.
    bench_a = {"scale": BENCH_SCALE, "iters": BENCH_ITERS,
               "warmup": BENCH_WARMUP, "num_edges": step["num_edges"],
               "smoke_ms_per_iter": ms, "smoke_edges_per_s": doc["value"],
               "roofline_fraction": roof,
               "bytes_per_edge": step["bytes_per_edge"],
               "peak_bytes": step["peak_bytes"], "build_s": doc["build_s"],
               "launches": l1, "wall_s": wall_a}
    print(f"phase 22(a) on {card}: python -m pagerank_tpu_torch.bench "
          f"--dtype float32 --scale {BENCH_SCALE} --iters {BENCH_ITERS} "
          f"--warmup {BENCH_WARMUP} --no-accuracy: {step['num_edges']:,} "
          f"edges built on {dev} in {doc['build_s']:.2f} s, "
          f"{ms:.4f} ms/iter, {doc['value']:.4g} edges/s, "
          f"{step['bytes_per_edge']:.2f} B/edge, "
          f"{0 if roof is None else roof:.1%} of the memory rate, peak "
          f"{(step['peak_bytes'] or 0) / 1e9:.3f} GB; K1 {l1} launches "
          f"(warm-up {BENCH_WARMUP} + {BENCH_ITERS}); {wall_a:.1f} s")

    recs = {}
    for key, what in (("D", "22(b)"), ("N", "22(c)"), ("AA", "22(d)")):
        _reset_counts()
        t0 = time.perf_counter()
        rec = acc.runner_of(key)(key, dev)
        rec["wall_s"] = time.perf_counter() - t0
        _check(rec["passed"], f"{what} acceptance key {key} failed: "
               f"{json.dumps(rec, default=str)[:2000]}")
        recs[key] = rec
    d = recs["D"]
    _check(set(bench.BUILD_STAGE_KEYS) <= set(d["stages"])
           and d["scale"] == 18,
           f"22(b) key D's stages {sorted(d['stages'])}")
    print(f"phase 22(b) key D: f64/f64 device build at rmat:{d['scale']} "
          f"{d['build_s']:.3f} s (budget {d['budget_s']:g} s): "
          + ", ".join(f"{k} {d['stages'][k]:.3f}"
                      for k in bench.BUILD_STAGE_KEYS)
          + f"; ops lint OK; {d['wall_s']:.1f} s")
    n = recs["N"]
    print(f"phase 22(c) key N: fresh rmat:{n['scale']} bench subprocess "
          f"{n['bench_seconds']:.1f} s, gate {n['gate_seconds']:.3f} s "
          f"(budget {n['gate_budget_s']:g} s), drift warned and passed, "
          f"the injected regression failed as program-change; "
          f"{n['wall_s']:.1f} s")
    aa = recs["AA"]
    _check(set(aa["launches"]) == set(acc.AA_LEGS),
           f"22(d) the legs' layouts name {sorted(aa['launches'])}")
    by_kernel = {"K1": {}, "K2": {}, "K1w": {}}
    for leg, got in aa["launches"].items():
        kernel, steps = acc.AA_LEGS[leg]
        want = {k: 0 for k in by_kernel}
        if on_card:
            want[kernel] = got["steps"]
        _check(got["kernel"] == kernel and got["steps"] > 0
               and (steps is None or got["steps"] == steps)
               and got["counts"] == want,
               f"22(d) {leg}: layout kernel {got['kernel']}, launches "
               f"{got['counts']} in {got['steps']} steps; want {kernel} "
               f"once in each of {steps or got['steps']} steps and no "
               f"other kernel")
        by_kernel[kernel][leg] = got["launches"]
    print(f"phase 22(d) key AA over {aa['devices']} gloo ranks on {dev}: "
          f"{aa['legs_done']}/{aa['legs_total']} legs, verdicts "
          f"{aa['verdicts']} all defer, report re-rendered identical; "
          f"{aa['seconds']:.1f} s (budget {aa['budget_s']:g} s); launches "
          f"(rank 0 for the group legs) K1 {by_kernel['K1']}, K2 "
          f"{by_kernel['K2']}, K1w {by_kernel['K1w']}")
    if on_card:
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"phase 22 took {seconds:.1f} s")
    return {"K1": {"single": bench_a, "D_build_s": d["build_s"],
                   "D_stages": d["stages"], "N_gate_s": n["gate_seconds"],
                   "campaign": by_kernel["K1"], "phase_s": seconds},
            "K2": {"campaign": by_kernel["K2"]},
            "K1w": {"campaign": by_kernel["K1w"]}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=22,
                   help="R-MAT scale of the main path (default 22)")
    p.add_argument("--resume-scale", type=int, default=18,
                   help="R-MAT scale of the resume check (default 18)")
    args = p.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "pagerank_tpu_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repo "
              "(pagerank_tpu_torch/ is missing beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card_identity()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    build_kernels()
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=scratch) as tmp:
        summary, report, oracle = main_path(args.scale, tmp)
        k1 = kernel_checks(summary["engine"])
        k1["launches"] = report["launches"]
        step_ms = {"K1": step_breakdown(summary["engine"])["kernel_ms"]}
        k1_slots = summary["engine"].contrib_inputs()[:2]
        flat_eng = summary["engine"]
        graph = summary["graph"]
        flat_rows = summary["engine"].layout_info()["num_rows"]
        flat = {"graph": graph, "ranks": summary["ranks"],
                "arrays": dict(summary["engine"]._arrays),
                "perm": summary["engine"]._perm}
        del summary
        eng32, eng16, part_report = partitioned_path(graph, oracle, flat_rows)
        part = {"span": eng32.config.partition_span,
                "ranks": part_report["f32"]["ranks"],
                "arrays": dict(eng32._arrays), "perm": eng32._perm}
        coo = coo_phase(graph, oracle, flat_eng,
                        part_report["f32"]["ms_per_iter"])
        del graph, oracle, flat_eng
        k2 = k2_checks(eng32, eng16)
        k2["launches"] = part_report["f32"]["launches"]

        k2_slots = {}
        for eng, label in ((eng32, "K2"), (eng16, "K2 (bf16 windows)")):
            step_ms[label] = step_breakdown(
                eng, label, "ell_contrib_part_kernel")["kernel_ms"]
            k2_slots[label] = _k2_global_slots(eng)
        del eng32, eng16
        probe = gather_probe_phase(k1_slots, k2_slots, step_ms)
        del k1_slots, k2_slots
        resume_determinism(args.resume_scale, tmp)
        form = resume_determinism(args.resume_scale, tmp,
                                  ("--partition-span", "-1"))
        _check(form == "pallas_partitioned",
               f"--partition-span -1 at rmat:{args.resume_scale} ran {form}")
        coo_resume_determinism(args.resume_scale, tmp)
        crawl = crawl_phase(tmp)
        device_build_phase(args.scale, args.resume_scale, tmp, flat, part,
                           crawl)
        del flat, part, crawl
        t_ppr = time.perf_counter()
        ppr, host, ppr_report = ppr_cli_phase(tmp)
        ppr_report.update(ppr_kernel_phase(ppr, host))
        del host
        serving = serve_phase(ppr)
        ppr_group_inputs(tmp, ppr)
        del ppr
        print(f"PPR and serving phase took {time.perf_counter() - t_ppr:.1f} "
              f"s")
        robust = robustness_phase(tmp)
        k1["robustness"] = {
            "sinks": robust["sinks"], "s3_launches": robust["s3_launches"],
            "job_resumed_from": robust["job_resumed_from"],
            "sdc": robust["sdc"]["flat"]}
        k2["robustness"] = {"sdc": robust["sdc"]["partitioned"]}
        seen = observability_phase(tmp)
        k1["observability"] = {
            "probed_run_launches": seen["probes"]["K1"]["launches"],
            "plain_step_ms": seen["probes"]["K1"]["plain_ms"],
            "probed_step_ms": seen["probes"]["K1"]["probed_ms"],
            "full_run_launches": seen["full"]["launches"],
            "full_run_step_ms": seen["full"]["step_ms"],
            "stall_launches": seen["stall"],
            "profiler_launches": seen["profiler_launches"]}
        k2["observability"] = {
            "probed_run_launches": seen["probes"]["K2"]["launches"],
            "plain_step_ms": seen["probes"]["K2"]["plain_ms"],
            "probed_step_ms": seen["probes"]["K2"]["probed_ms"]}
        fused = fused_phase(args.scale, tmp)
        k1["fused"], k2["fused"] = fused["K1"], fused["K2"]
        # Phase 15 after every profiler split: the NCCL group of one it
        # brings up in this process is not let near one (phase 18(e)'s
        # comes after 18(f)).
        sharded = sharded_phase(tmp)
        elastic = elastic_phase(tmp)
        ppr_group = ppr_group_phase(tmp)
        mesh5 = mesh_job_phase(tmp)
        front = member0_phase(tmp, seen["preflight"])
        acceptance = acceptance_phase()
        k1["acceptance"], k2["acceptance"] = (acceptance["K1"],
                                              acceptance["K2"])
        benched = bench_phase()
        k1["bench"], k2["bench"] = benched["K1"], benched["K2"]
        k1["mesh"] = {n: mesh5[n] for n in (
            "edge_flat", "edge_flat_probed", "vertex_sharded",
            "vertex_sharded_probed", "edge_flat_device",
            "vertex_sharded_device")}
        k1["mesh"].update(coo=mesh5["coo"], cli_s=mesh5["cli_s"],
                          phase_s=mesh5["seconds"])
        k2["mesh"] = {n: mesh5[n] for n in (
            "edge_part_f32", "edge_part_f32_probed")}
        k1["elastic"] = {"vertex_sharded": elastic["vertex_sharded"],
                         "nccl_group_of_one_launches":
                             elastic["nccl_group_of_one_launches"]}
        k2["elastic"] = {"edge_part_f32": elastic["edge_part_f32"]}
        k1["sharded"] = {n: sharded[n] for n in (
            "edge_flat", "vertex_sharded", "vertex_sharded_checked",
            "edge_flat_f64sums", "vertex_sharded_f64sums", "vs_halo",
            "vs_halo_f64sums", "vs_halo_async", "vs_halo_lag0",
            "vs_halo_checked", "vs_bounded", "world1_step_ms")}
        k2["sharded"] = {n: sharded[n] for n in (
            "edge_part_f32", "edge_part_bf16")}
        k1["coo"] = {"coo_ms_per_iter": coo["ms_per_iter"],
                     "flat_ms_per_iter": coo["flat_ms_per_iter"]}
        k1w = {"name": "ell_contrib_spmm", "route": "cuda",
               "source": "pagerank_tpu_torch/csrc/ell_contrib_spmm.cu",
               "replaces": "pagerank_tpu/ops/spmv.py:380",
               "checked": True, "launches": ppr_report["launches"],
               "max_abs_err": ppr_report["max_abs_err"],
               "ms": ppr_report["k1w_ms"], "plain_ms": ppr_report["plain_ms"],
               "bound_ms": ppr_report["bound_ms"],
               "bound_by": ppr_report["bound_by"],
               "library_ms": ppr_report["sparse_mm_ms"],
               "kt": ppr_report["kt"], "sweep_ms": ppr_report["sweep_ms"],
               "k1_column_launches_ms": ppr_report["k1_chunk_ms"],
               "chunk_iter_ms": ppr_report["chunk_iter_ms"],
               "edge_vectors_per_s": ppr_report["evs"],
               "serve_warmup_s": serving["warmup_s"],
               "serve_batch_wall_ms": serving["batch_wall_ms"],
               "lone_k1w_ms": serving["lone_k1w_ms"],
               "lone_step": serving["lone_step"],
               "group": ppr_group,
               "bench": benched["K1w"],
               "front": {n: front[n] for n in (
                   "launches", "max_abs_err", "walls", "batch_walls_ms",
                   "seconds")},
               "shapes": f"z2 float32[{1 << PPR_SCALE}+8, {PPR_CHUNK}] "
                         f"(rmat:{PPR_SCALE}), {PPR_SOURCES} sources x "
                         f"{PPR_ITERS} iterations"}
    fixtures = fixture_phase(analysis_phase())
    print(f"chip smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k1w, *probe, *fixtures]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
