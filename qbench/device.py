"""The device a measurement runs on.  A device result needs a GPU: there is
no CPU fallback, and every result names the card it was taken on."""

from __future__ import annotations

import subprocess


def require_gpu(count=1):
    """{"platform", "kind", "count"} of JAX's devices; raises unless the
    default device is a GPU and JAX sees at least ``count`` of them."""
    import jax
    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default device is {d.platform} "
                           f"({d.device_kind}); device results need a card")
    if len(devices) < count:
        raise RuntimeError(f"the cell needs {count} GPUs, JAX sees {len(devices)}")
    return describe()


def describe():
    """{"platform", "kind", "count"} of JAX's devices, as JAX reports them."""
    import jax
    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def card_lines():
    """nvidia-smi's name and power limit, one line per card.  It runs as a
    child process that never touches the card's memory."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]
