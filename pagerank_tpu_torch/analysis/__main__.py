"""``python -m pagerank_tpu_torch.analysis`` — the AST lint (PTL), the
concurrency pass (PTR) and the kernel-plane check of the port's CUDA
launches (PTK); nonzero exit on any non-waived finding.

The JAX package's jaxpr and HLO contracts (PTC, PTH) have no
counterpart: ROADMAP.md lists them as not applicable (the port traces
no program; ``--compiled`` reads the compiler's facts instead).

Exit codes: 0 clean, 1 findings, 2 usage/configuration error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: Rule families of the JAX checker that do not apply to the port.
_NOT_APPLICABLE = {"PTC": "the jaxpr contracts", "PTH": "the HLO contracts"}
_FAMILIES = ("PTL", "PTR", "PTK")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pagerank_tpu_torch.analysis",
        description="AST lint, concurrency pass and kernel-plane check "
        "of the port (rule catalogue: README.md, 'PyTorch/CUDA port').",
    )
    p.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the pagerank_tpu_torch "
        "package). Paths outside the package are treated as fixture "
        "space: every rule applies regardless of scope",
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
        help="comma-separated rule or family prefixes to run (e.g. "
        "'PTK', 'PTL005,PTR'); passes whose families are not selected "
        "are skipped entirely. PTC and PTH (the jaxpr and HLO "
        "contracts) do not apply to the port",
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


def _selectors(select):
    return [s.strip().upper() for s in (select or "").split(",")
            if s.strip()]


def _keep(findings, select):
    """The findings whose rule a ``--select`` entry names (a family or
    a full rule id); all of them without ``--select``."""
    sels = _selectors(select)
    if not sels:
        return findings
    return [f for f in findings if any(f.rule.startswith(s) for s in sels)]


def _lint_and_ptr(paths, fams):
    """The PTL and PTR findings over the package, or over ``paths``
    (``pagerank_tpu/analysis/__main__.py:148-197``: an in-package path
    keeps package scoping, with PTR over the whole package filtered to
    it; an outside directory is its own program; an outside file is a
    standalone fixture)."""
    from pagerank_tpu_torch.analysis import concurrency as conc_mod
    from pagerank_tpu_torch.analysis import lint as lint_mod

    run_l = fams is None or "PTL" in fams
    run_r = fams is None or "PTR" in fams
    findings = []
    if not paths:
        if run_l:
            findings.extend(lint_mod.lint_tree())
        if run_r:
            findings.extend(conc_mod.analyze_package())
        return findings
    pkg = lint_mod.package_root()
    rels, prefixes = [], []
    for path in paths:
        ap = os.path.abspath(path)
        inside = ap == pkg or ap.startswith(pkg + os.sep)
        rel = os.path.relpath(ap, pkg).replace(os.sep, "/")
        if os.path.isdir(path):
            if run_l:
                findings.extend(lint_mod.lint_tree(path))
            if inside:
                prefixes.append("" if rel == "." else rel + "/")
            elif run_r:
                findings.extend(conc_mod.analyze_package(path))
            continue
        if inside:
            rels.append(rel)
        elif run_r:
            findings.extend(conc_mod.analyze_file(path))
        if run_l:
            findings.extend(lint_mod.lint_file(path, rel if inside else None))
    if run_r and (rels or prefixes):
        findings.extend(
            f for f in conc_mod.analyze_package()
            if f.path in rels or any(f.path.startswith(p) for p in prefixes))
    return findings


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from pagerank_tpu_torch.analysis import kernels as kernels_mod
    from pagerank_tpu_torch.analysis import load_allowlist, split_allowlisted

    if args.list_rules:
        from pagerank_tpu_torch.analysis import concurrency as conc_mod
        from pagerank_tpu_torch.analysis import lint as lint_mod

        for rid, (_fn, scope, desc) in sorted(lint_mod.RULES.items()):
            print(f"{rid}  [{scope:6}] {desc}")
        for rid, (_fn, desc) in sorted(conc_mod.RULES.items()):
            print(f"{rid}  [thread] {desc}")
        for rid, desc in sorted(kernels_mod.RULES.items()):
            print(f"{rid}  [kernel] {desc}")
        return 0

    fams = _families(args.select)
    na = sorted((fams or set()) & set(_NOT_APPLICABLE))
    unknown = sorted((fams or set()) - set(_NOT_APPLICABLE) - set(_FAMILIES))
    if na or unknown:
        names = ", ".join(f"{f} ({_NOT_APPLICABLE[f]})" for f in na)
        print("analysis: "
              + (f"{names}: not applicable to the port (ROADMAP.md's "
                 f"not-applicable list; --compiled reads the compiler's "
                 f"facts instead)" if na else "")
              + ("; " if na and unknown else "")
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

    run_k = fams is None or "PTK" in fams
    if not run_k:
        cases = []
    elif args.kernel_fixture is None:
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
    if fams is None or fams & {"PTL", "PTR"}:
        findings.extend(_lint_and_ptr(args.paths, fams))
    try:
        for case in cases:
            findings.extend(kernels_mod.check_kernel_case(case, facts=facts))
    except LookupError as e:
        print(f"analysis: {e}", file=sys.stderr)
        return 2
    active, waived = split_allowlisted(_keep(findings, args.select),
                                       waivers)

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
        if not run_k:
            note = ""
        print(f"analysis: {len(active)} finding(s), {len(waived)} waived, "
              f"{len(cases)} case(s){note}", file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
