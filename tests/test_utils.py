"""Tests for the aux subsystems: profiling scopes, logging, tracing."""

import io
import re
import sys

import pytest


def test_profiling_scope_contract(capsys):
    from voxtpu.utils import profiling

    profiling.enable(True)
    try:
        with profiling.ProfilingScope("Parent::Child"):
            pass
        with profiling.ProfilingScope("Parent"):
            pass
    finally:
        profiling.enable(False)
    out = capsys.readouterr().out
    # Exact stdout contract scraped by scripts/benchmarks.py (reference
    # `profiling.h:17-25` format).
    assert re.search(r"\[Parent::Child\]: [\d.]+ ms", out)
    assert re.search(r"\[Parent\]: [\d.]+ ms", out)


def test_profiling_observe_fences():
    import jax.numpy as jnp

    from voxtpu.utils.profiling import ProfilingScope

    with ProfilingScope("Obs") as p:
        x = p.observe(jnp.ones((8, 8)) * 2)
    assert p.elapsed_ms is not None and p.elapsed_ms >= 0
    assert float(x.sum()) == 128.0


def test_logging_levels(capsys):
    from voxtpu.utils import logging as vlog

    vlog.set_level("info")
    try:
        vlog.log_debug("hidden %d", 1)
        vlog.log_info("shown %s", "yes")
        vlog.log_error("boom")
    finally:
        vlog.set_level("warn")
    err = capsys.readouterr().err
    assert "hidden" not in err
    assert "[INFO]" in err and "shown yes" in err
    assert "[ERROR]" in err and "boom" in err
    # message shape: [LEVEL] [HH:MM:SS] file:line — msg
    assert re.search(r"\[INFO\] \[\d\d:\d\d:\d\d\] test_utils\.py:\d+", err)


def test_logging_check_raises():
    from voxtpu.utils.logging import check

    check(True, "fine")
    with pytest.raises(ValueError, match="bad shape"):
        check(False, "bad shape")


def test_trace_degrades_gracefully(tmp_path):
    # On CPU the profiler may or may not be available; either way the
    # context must not raise and the wrapped computation must run.
    import jax.numpy as jnp

    from voxtpu.utils.trace import trace

    with trace(str(tmp_path / "tr")):
        y = jnp.arange(16.0).sum()
    assert float(y) == 120.0


def test_profiling_scope_reuse_resets_pending():
    """A reused scope instance (ContextDecorator / loop reuse) must not
    accumulate observed values across entries (code-review find: the
    pending list pinned every past iteration's device buffers)."""
    from voxtpu.utils.profiling import ProfilingScope

    p = ProfilingScope("Reuse")
    import jax.numpy as jnp

    for _ in range(3):
        with p:
            p.observe(jnp.ones((4,)))
        assert len(p._pending) == 1  # only this entry's value
