"""The card a measurement runs on, and host-clock timing around it.

Every number the benchmark and the chip smoke test print names its
device (`describe`): JAX's platform, device kind and count, and the
card's name and power limit as ``nvidia-smi`` reports them (read by a
child process that stays off JAX). A measurement path that finds no GPU
fails (`require_gpu`); it never falls back to the CPU.
"""

from __future__ import annotations

import statistics
import subprocess
import time


# Device-memory bandwidth by `device_kind` (NVIDIA's H100 SXM data
# sheet). A device missing here gets no roofline share: no peak is
# assumed for an unknown device.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


class NoGpuError(RuntimeError):
    pass


def require_gpu():
    """The first device, which must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); measurements run on the card only")
    return dev


def nvidia_smi_name_power() -> str:
    """``name, power.limit`` of the cards, as nvidia-smi prints them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if lines else f"nvidia-smi rc={r.returncode}"


def describe() -> dict:
    """JAX's view of the devices (platform, kind, count)."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def peak_bytes(device=None) -> int | None:
    """`peak_bytes_in_use` of a device (None where not reported)."""
    import jax

    dev = device if device is not None else jax.devices()[0]
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def timed(fn, *args, iters: int = 5):
    """Seconds per call of `fn(*args)`, each call fenced by
    ``block_until_ready`` on the host clock. The first call (compile)
    is timed separately. Returns (compile_s, [call_s, ...], last_out)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return compile_s, times, out


def median_ms(times) -> float:
    return statistics.median(times) * 1e3
