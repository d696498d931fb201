"""Profiling hooks (the counterpart of the reference's ProgressLog timing,
ref src/logger.h:57-115 -- here: torch.profiler traces viewable in
TensorBoard or chrome://tracing, plus a simple wall-clock section timer).

Usage:
    with trace_if("/tmp/trace"):           # no-op when dir is falsy
        run_dp()
    with timed("forward", logger):         # logs elapsed seconds
        run_dp()
"""

import contextlib
import time


@contextlib.contextmanager
def trace_if(trace_dir):
    """torch.profiler over the block when trace_dir is set, writing a
    Chrome trace (`*.pt.trace.json`) into trace_dir: the CPU's activity,
    and the CUDA card's where one is present. A no-op otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


@contextlib.contextmanager
def timed(label, log_fn=None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = "%s: %.3fs" % (label, dt)
    if log_fn is not None:
        log_fn(msg)
    else:
        import sys
        sys.stderr.write(msg + "\n")
