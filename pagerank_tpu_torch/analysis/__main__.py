"""``python -m pagerank_tpu_torch.analysis`` — the kernel-plane check of
the port's CUDA launches; nonzero exit on any non-waived finding.

Exit codes: 0 clean, 1 findings, 2 usage/configuration error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: Rule families of the JAX checker that the port does not have yet.
_LATER = {"PTL": "the AST lint", "PTR": "the concurrency pass",
          "PTC": "the jaxpr contracts", "PTH": "the HLO contracts"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pagerank_tpu_torch.analysis",
        description="Kernel-plane check of the port's CUDA launches "
        "(rule catalogue: README.md, 'PyTorch/CUDA port').",
    )
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (schema version 1)")
    p.add_argument(
        "--allowlist", default=None,
        help="waiver file (default: the checked-in "
        "pagerank_tpu_torch/analysis/allowlist.txt; 'none' disables)",
    )
    p.add_argument(
        "--select", default=None,
        help="comma-separated rule or family prefixes; only the PTK "
        "family is ported (PTL, PTR, PTC and PTH come with slice 8b)",
    )
    p.add_argument(
        "--kernel-fixture", nargs="?", const="all", default=None,
        metavar="NAME",
        help="check the seeded-defect fixtures instead of the shipped "
        "registry ('all' or one of vmem_overflow/misaligned_tile/"
        "index_gap/index_overlap/f64_scratch/cost_mismatch) — each must "
        "exit 1 with exactly its rule",
    )
    p.add_argument(
        "--compiled", action="store_true",
        help="also check the compile facts (registers, shared and local "
        "memory, __launch_bounds__, f64 SASS) read with cuobjdump from "
        "the built libraries; builds missing ones with nvcc; exits 2 "
        "where the CUDA toolkit is missing",
    )
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    return p


def _families(select):
    """The rule families ``select`` names, or None for everything."""
    if select is None:
        return None
    return {s.strip().upper()[:3] for s in select.split(",") if s.strip()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from pagerank_tpu_torch.analysis import kernels as kernels_mod
    from pagerank_tpu_torch.analysis import load_allowlist, split_allowlisted

    if args.list_rules:
        for rid, desc in sorted(kernels_mod.RULES.items()):
            print(f"{rid}  [kernel] {desc}")
        return 0

    fams = _families(args.select)
    later = sorted((fams or set()) & set(_LATER))
    unknown = sorted((fams or set()) - set(_LATER) - {"PTK"})
    if later or unknown:
        names = ", ".join(f"{f} ({_LATER[f]})" for f in later)
        print(f"analysis: only the PTK family is ported; "
              + (f"{names} come with slice 8b" if later else "")
              + ("; " if later and unknown else "")
              + (f"unknown families {', '.join(unknown)}" if unknown
                 else ""), file=sys.stderr)
        return 2

    allowlist_path = args.allowlist
    if allowlist_path is None:
        allowlist_path = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "allowlist.txt")
    waivers = []
    if allowlist_path != "none":
        try:
            waivers = load_allowlist(allowlist_path)
        except (OSError, ValueError) as e:
            print(f"analysis: bad allowlist: {e}", file=sys.stderr)
            return 2

    if args.kernel_fixture is None:
        cases = kernels_mod.shipped_cases()
    else:
        cases = kernels_mod.defect_cases()
        if args.kernel_fixture != "all":
            cases = [c for c in cases
                     if c.label == f"fixture:{args.kernel_fixture}"]
            if not cases:
                print(f"analysis: unknown kernel fixture "
                      f"'{args.kernel_fixture}'", file=sys.stderr)
                return 2

    facts = None
    if args.compiled:
        import subprocess

        from pagerank_tpu_torch.analysis import resources

        try:
            facts = resources.built_facts(
                sorted({ln.source for c in cases for ln in c.launches}))
        except (RuntimeError, subprocess.CalledProcessError) as e:
            # the toolkit missing, a build or a cuobjdump that failed
            print(f"analysis: --compiled: {e}", file=sys.stderr)
            return 2
    findings = []
    try:
        for case in cases:
            findings.extend(kernels_mod.check_kernel_case(case, facts=facts))
    except LookupError as e:
        print(f"analysis: {e}", file=sys.stderr)
        return 2
    active, waived = split_allowlisted(findings, waivers)

    if args.json:
        doc = {
            "version": 1,
            "ok": not active,
            "compiled": facts is not None,
            "counts": {"active": len(active), "waived": len(waived)},
            "findings": [f.to_json() for f in active],
            "waived": [
                {"finding": f.to_json(), "reason": w.reason}
                for f, w in waived
            ],
        }
        if facts is not None:
            keys = sorted({ln.key for c in cases for ln in c.launches})
            doc["compile_facts"] = {k: facts[k].to_json() for k in keys}
        print(json.dumps(doc, indent=2))
    else:
        for f in active:
            print(f.render())
        note = ("" if facts is not None else "; compile facts not checked "
                "(--compiled reads them from the built libraries)")
        print(f"analysis: {len(active)} finding(s), {len(waived)} waived, "
              f"{len(cases)} case(s){note}", file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
