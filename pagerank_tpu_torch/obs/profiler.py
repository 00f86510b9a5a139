"""``torch.profiler`` lifecycle as a context manager, composed with the
span tracer.

Port of ``pagerank_tpu/obs/profiler.py`` over ``torch.profiler`` in
place of ``jax.profiler``: :func:`profiler_session` starts a profile of
the CPU and (on a card) the CUDA activity on entry and, on EVERY exit
path — the failure path included, where the trace of the failing run is
what the user wants — stops it and writes a Chrome trace
(``trace.json``) into the profile directory, recorded as a ``profile``
span on the active tracer. A stop or export failure never masks the
body's own exception.
"""

from __future__ import annotations

import contextlib
import os

from pagerank_tpu_torch.obs import trace as _trace

#: The Chrome trace a session writes into its directory.
TRACE_NAME = "trace.json"


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profiler_session(profile_dir, tracer=None):
    """Run the body under a ``torch.profiler`` profile whose Chrome
    trace lands in ``profile_dir/trace.json``; no-op (still yields) when
    ``profile_dir`` is falsy, so callers wrap unconditionally::

        with obs.profiler_session(args.profile_dir):
            ... the run ...

    Yields True when profiling is active, False otherwise."""
    if not profile_dir:
        yield False
        return
    from torch.profiler import profile

    tr = tracer if tracer is not None else _trace.get_tracer()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, TRACE_NAME)
    with tr.span("profile", dir=str(profile_dir)):
        prof = profile(activities=_activities())
        prof.start()
        try:
            yield True
        except BaseException:
            # The body failed: stop and write the failing run's trace,
            # but never let a secondary failure mask the primary error.
            try:
                prof.stop()
                prof.export_chrome_trace(path)
            except Exception:
                pass
            raise
        else:
            prof.stop()
            prof.export_chrome_trace(path)
