"""The device a measurement runs on.  A device result needs a GPU: there is
no CPU fallback, and every result names the card it was taken on."""

from __future__ import annotations

import subprocess


def require_gpu():
    """{"platform", "kind", "count"} of JAX's devices; raises unless the
    default device is a GPU."""
    import jax
    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default device is {d.platform} "
                           f"({d.device_kind}); device results need a card")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}


def card_lines():
    """nvidia-smi's name and power limit, one line per card.  It runs as a
    child process that never touches the card's memory."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def announce():
    """require_gpu() plus the first card's nvidia-smi line, printed once;
    returned so each result can name the device it was measured on."""
    dev = require_gpu()
    dev["card"] = card_lines()[0]
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}; "
          f"card: {dev['card']}", flush=True)
    return dev
