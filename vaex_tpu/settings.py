"""Runtime configuration for vaex_tpu.

Mirrors the reference's env-var config surface (vaex: execution.py:20-27,
multithreading.py:21-22, dataset_mmap.py:24, cache.py) but device-oriented:
the central knob is the device *tile* size (rows per jitted step) instead of
a CPU chunk size.

Env vars (all optional):
  VAEX_TPU_TILE_ROWS        rows per device tile (default 2**19)
  VAEX_TPU_TILE_ROWS_MIN    lower clamp used by auto sizing (default 1024)
  VAEX_TPU_TILE_ROWS_MAX    upper clamp (default 2**22)
  VAEX_TPU_CACHE            task-result cache backend: 'memory' | 'disabled'
  VAEX_TPU_X64              '1' (default) enable float64/int64 parity with the
                            reference; '0' keeps everything 32-bit for speed.
  VAEX_TPU_NUM_THREADS_IO   host IO thread pool size (default 8)
  VAEX_TPU_PREFETCH         chunk readahead depth in the executor (default 2;
                            0 disables the IO thread)
  JAX_COMPILATION_CACHE_DIR persistent XLA compile cache; when unset the
                            cache lives in ``.jax_cache`` at the checkout root
"""

from __future__ import annotations

import os


def _int_env(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


TILE_ROWS = _int_env("VAEX_TPU_TILE_ROWS", 1 << 19)
TILE_ROWS_MIN = _int_env("VAEX_TPU_TILE_ROWS_MIN", 1024)
TILE_ROWS_MAX = _int_env("VAEX_TPU_TILE_ROWS_MAX", 1 << 22)
CACHE = os.environ.get("VAEX_TPU_CACHE", "memory")
# persistent XLA compile cache when JAX_COMPILATION_CACHE_DIR is unset: a
# fixed directory in the checkout, so every process of this tree hits it
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
CACHE_DISK_PATH = os.environ.get("VAEX_TPU_CACHE_DISK_PATH",
                                 os.path.join(os.path.expanduser("~"), ".vaex_tpu", "cache"))
CACHE_DISK_SIZE_LIMIT = _int_env("VAEX_TPU_CACHE_DISK_SIZE_LIMIT", 10 << 30)
CACHE_MEMORY_SIZE_LIMIT = _int_env("VAEX_TPU_CACHE_MEMORY_SIZE_LIMIT", 1 << 30)
X64 = os.environ.get("VAEX_TPU_X64", "1") == "1"
NUM_THREADS_IO = _int_env("VAEX_TPU_NUM_THREADS_IO", 8)
PREFETCH = _int_env("VAEX_TPU_PREFETCH", 2)
# staged tiles device_put ahead of compute by a worker thread (0 disables)
TRANSFER_AHEAD = _int_env("VAEX_TPU_TRANSFER_AHEAD", 2)

_main = {}


def _load_yaml():
    """~/.vaex_tpu/main.yml dotted-key settings (reference: settings.py:20-65)."""
    path = os.path.join(os.path.expanduser("~"), ".vaex_tpu", "main.yml")
    if not os.path.exists(path):
        return
    try:
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f) or {}

        def flatten(prefix, d):
            for k, v in d.items():
                key = f"{prefix}.{k}" if prefix else str(k)
                if isinstance(v, dict):
                    flatten(key, v)
                else:
                    _main[key] = v
        flatten("", data)
    except Exception:  # settings must never break import
        pass


_load_yaml()


def get(key: str, default=None):
    """Dotted-key settings access (reference: vaex settings.py:20-65)."""
    return _main.get(key, default)


def store(key: str, value):
    _main[key] = value
