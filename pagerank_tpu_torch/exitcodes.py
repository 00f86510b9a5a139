"""Exit-code taxonomy — ONE spelling of every process exit code the
CLI, bench, and tooling entry points return (docs/ROBUSTNESS.md "Exit
codes").

Copy of ``pagerank_tpu/exitcodes.py``.

The reference job communicates failure only through the Spark job's own
exit; this build's entry points had grown codes organically (preflight
2 in bench vs 3 in the CLI, gate 1, missing-ledger 2). This module is
the audited collection point: entry points return :class:`ExitCode`
members (plain ints to the shell), the docs table renders from the
same enum, and tests/test_jobs.py regression-tests that cli/bench/obs
return codes match it.

Supervisor convention (jobs.py): :data:`ExitCode.INTERRUPTED` (75,
``EX_TEMPFAIL`` — "temporary failure, retry the job") marks a run that
received SIGTERM/SIGINT and DRAINED gracefully — in-flight step
finished, sinks flushed, final snapshot + interrupted-marked run
report written. A retry of the same command against the same
``--job-dir`` resumes instead of recomputing, which is exactly what
``EX_TEMPFAIL`` tells a scheduler to do. A SECOND signal skips the
drain and hard-exits with the shell convention ``128 + signum``
(:func:`hard_exit_code`; 130 for SIGINT, 143 for SIGTERM) — the codes
a SIGKILL'd process's parent observes anyway, so supervisors see one
vocabulary for "died mid-work" regardless of how hard the kill was.
"""

from __future__ import annotations

import enum


class ExitCode(enum.IntEnum):
    """Process exit codes, one member per distinct meaning.

    =================  ====  ==================================================
    member             code  producers
    =================  ====  ==================================================
    OK                 0     every entry point: the run/gate/check succeeded.
                             A RESUMED job that completes also exits OK — the
                             resume count rides the run report's ``job``
                             section, not the exit code.
    FAILURE            1     a gate judged the work bad: ``obs history gate``
                             budget breach / program-change regression,
                             ``obs hlo`` EXPANDED-gather verdict, ``obs fit``
                             does-not-fit verdict, ``python -m
                             pagerank_tpu_torch.analysis`` findings,
                             ``scripts/acceptance.py`` failed config.
    USAGE              2     bad invocation or missing inputs: argparse
                             errors, incompatible flag combinations
                             (``--fused`` + ``--dump-text-dir``, ...),
                             ``obs history`` on a missing ledger, analysis
                             internal errors.
    PREFLIGHT_UNFIT    3     the OOM-preflight fit check refused the
                             geometry BEFORE any allocation (CLI and bench
                             ``--preflight``; bench once exited 2 for
                             this).
    INTERRUPTED        75    graceful preemption drain (jobs.py): first
                             SIGTERM/SIGINT, in-flight step finished, sinks
                             flushed, snapshot + interrupted-marked report
                             written. EX_TEMPFAIL: retry the command with the
                             same ``--job-dir`` to resume.
    SIGINT_HARD        130   second SIGINT during a drain: immediate
                             ``os._exit(128 + SIGINT)`` — no flush.
    SIGTERM_HARD       143   second SIGTERM during a drain: immediate
                             ``os._exit(128 + SIGTERM)`` — no flush.
    =================  ====  ==================================================
    """

    OK = 0
    FAILURE = 1
    USAGE = 2
    PREFLIGHT_UNFIT = 3
    INTERRUPTED = 75
    SIGINT_HARD = 130
    SIGTERM_HARD = 143


def hard_exit_code(signum: int) -> int:
    """Shell convention for death-by-signal: ``128 + signum`` (the code
    a parent observes for an un-caught signal or SIGKILL). The drain's
    second-signal hard exit uses this so supervisors need no special
    case for "the drain itself was killed"."""
    return 128 + int(signum)
