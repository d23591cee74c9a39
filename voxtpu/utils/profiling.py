"""Profiling scopes with the reference's stdout contract.

The CUDA reference prints RAII wall-clock timers as ``[Label]: X ms`` lines
(`vplib/src/profiling.h:8-33`), and its whole benchmark harness scrapes that
stdout with a regex (`scripts/benchmarks.py:75`). We keep the exact contract
so the harness carries over: hierarchical labels ``Parent::Child``, printf
``%f``-style values (6 decimals).

Dispatch is async, so a scope fences with ``jax.block_until_ready`` on
whatever it is given via :meth:`ProfilingScope.observe` before its clock
stops.
"""

from __future__ import annotations

import os
import time
from contextlib import ContextDecorator

import jax

# Runtime toggle (the reference gates on a compile-time PROFILING define,
# `vplib/CMakeLists.txt:13`; a process-wide switch is the Python equivalent).
_ENABLED = os.environ.get("VOXTPU_PROFILING", "0") not in ("0", "", "false")


def enable(flag: bool = True) -> None:
    global _ENABLED
    _ENABLED = flag


def enabled() -> bool:
    return _ENABLED


class ProfilingScope(ContextDecorator):
    """Wall-clock scope printing ``[label]: X ms`` on exit.

    Usage::

        with ProfilingScope("TiledVox::Processing") as p:
            out = kernel(x)
            p.observe(out)   # block_until_ready before the clock stops
    """

    def __init__(self, label: str):
        self.label = label
        self._pending = []
        self.elapsed_ms = None

    def observe(self, value):
        """Register device values to fence on before the scope closes."""
        self._pending.append(value)
        return value

    def __enter__(self):
        # Reset per entry: a reused instance (ContextDecorator calls, or
        # one scope object driven in a loop) must not fence — or pin the
        # device buffers of — previous entries' observed values.
        self._pending = []
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for v in self._pending:
            try:
                jax.block_until_ready(v)
            except Exception:
                pass
        end = time.perf_counter()
        self.elapsed_ms = (end - self._start) * 1e3
        if _ENABLED:
            print(f"[{self.label}]: {self.elapsed_ms:f} ms", flush=True)
        return False


# Short alias mirroring PROFILING_SCOPE(msg)
scope = ProfilingScope
