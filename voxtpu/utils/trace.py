"""Device-level tracing — the reference's Nsight Systems analog.

The reference ships a containerized Nsight Systems setup for kernel
traces (`nsight.Dockerfile`, `nsight.sh`). Here the equivalent is the
built-in ``jax.profiler``: :func:`trace` captures a TensorBoard/Perfetto
trace of every XLA/Pallas dispatch in the scope.

Usage::

    with trace("/tmp/voxtpu_trace"):
        grid = voxelize(mesh, spec, backend="xla")
        jax.block_until_ready(grid.words)

    # or from the CLI:  python -m voxtpu.cli bunny.obj --trace /tmp/tr

View with ``tensorboard --logdir /tmp/voxtpu_trace`` (profile plugin) or
upload ``*.trace.json.gz`` to ui.perfetto.dev.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager around `jax.profiler.trace` that degrades to a
    no-op when profiling is unsupported on the current backend."""
    import jax

    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception as e:  # pragma: no cover - backend dependent
        from voxtpu.utils.logging import log_warn

        log_warn("jax.profiler unavailable (%s); tracing disabled", e)
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def annotate(name: str):
    """Named sub-scope inside a trace (`jax.profiler.TraceAnnotation`)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
