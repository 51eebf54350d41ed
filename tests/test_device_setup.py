"""Device-facing setup that runs the same on every backend: the memory
budget, the compile-cache placement and the small-grid sums."""

import os
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_budget_on_cpu_is_the_fixed_budget():
    from vaex_tpu.utils import CPU_MEMORY_BUDGET, device_memory_budget
    assert device_memory_budget() == CPU_MEMORY_BUDGET


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform, self.device_kind, self._stats = platform, "fake", stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform,stats,want", [
    ("gpu", {"bytes_limit": 60_000_000_000, "bytes_in_use": 0}, 60_000_000_000),
    ("cpu", {"bytes_limit": 123}, 123),
])
def test_budget_reads_bytes_limit(monkeypatch, platform, stats, want):
    import jax
    from vaex_tpu.utils import device_memory_budget
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(platform, stats)])
    assert device_memory_budget() == want


def test_budget_without_stats_off_cpu_is_an_error(monkeypatch):
    import jax
    from vaex_tpu.utils import device_memory_budget
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice("gpu", None)])
    with pytest.raises(RuntimeError, match="no memory limit"):
        device_memory_budget()


def test_budget_scales_exact_percentile_cap(monkeypatch):
    """The exact-percentile row cap follows the device budget."""
    import vaex_tpu as vt
    from vaex_tpu import agg, utils
    df = vt.from_arrays(x=np.arange(1000.0))
    desc = agg.AggregatorDescriptorPercentile("x")
    assert desc._exact_possible(df)
    monkeypatch.setattr(utils, "CPU_MEMORY_BUDGET", 1000 * 12 * 5)
    assert not desc._exact_possible(df)


def _cache_dir(env_extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    code = "import jax, vaex_tpu; print(jax.config.jax_compilation_cache_dir)"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_checkout():
    assert _cache_dir({}) == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_follows_env(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


@pytest.mark.parametrize("N,G", [(1000, 100), (5003, 7), (3000, 2048), (70000, 3)])
def test_small_g_sums_exact(N, G):
    """Integer sums exact mod 2^64 (values near 2^62 overflow float64);
    float sums to float64 rounding."""
    import jax.numpy as jnp
    from vaex_tpu.ops import gridagg
    rng = np.random.default_rng(N + G)
    idx = rng.integers(0, G, N).astype(np.int32)
    ints = np.stack([np.ones(N, np.int64),
                     rng.integers(-2 ** 62, 2 ** 62, N, dtype=np.int64)], axis=1)
    floats = rng.normal(0, 1e3, (N, 2))
    want_i = np.zeros((G, 2), np.int64)
    want_f = np.zeros((G, 2))
    for a in range(2):
        np.add.at(want_i[:, a], idx, ints[:, a])
        np.add.at(want_f[:, a], idx, floats[:, a])
    gi, gf = gridagg.small_g_sums(jnp.asarray(idx), jnp.asarray(ints),
                                  jnp.asarray(floats), G)
    npt.assert_array_equal(np.asarray(gi), want_i)
    npt.assert_allclose(np.asarray(gf), want_f, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n_rows,G,P", [(2 ** 19, 100, 256), (2 ** 19, 1003, 64),
                                        (2 ** 19, 2048, 32), (2 ** 17, 2048, 8),
                                        (1000, 100, 1), (0, 5, 1)])
def test_scatter_copies_rule(n_rows, G, P):
    from vaex_tpu.ops import gridagg
    assert gridagg.scatter_copies(n_rows, G) == P


@pytest.mark.parametrize("P", [1, 2, 16, 256])
def test_private_segment_sum_any_copy_count(P):
    import jax.numpy as jnp
    from vaex_tpu.ops import gridagg
    rng = np.random.default_rng(P)
    idx = rng.integers(0, 37, 4099).astype(np.int32)
    vals = rng.integers(-2 ** 40, 2 ** 40, (4099, 2), dtype=np.int64)
    want = np.zeros((37, 2), np.int64)
    np.add.at(want, idx, vals)
    got = gridagg._private_segment_sum(jnp.asarray(idx), jnp.asarray(vals), 37, P)
    npt.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("empty", ["int", "float"])
def test_small_g_sums_empty_side(empty):
    import jax.numpy as jnp
    from vaex_tpu.ops import gridagg
    idx = jnp.asarray(np.array([0, 2, 2], np.int32))
    ints = jnp.zeros((3, 0), jnp.int64) if empty == "int" else jnp.ones((3, 1), jnp.int64)
    floats = jnp.zeros((3, 0)) if empty == "float" else jnp.ones((3, 1))
    gi, gf = gridagg.small_g_sums(idx, ints, floats, 3)
    empty_grid, full_grid = (gi, gf) if empty == "int" else (gf, gi)
    assert empty_grid.shape == (3, 0)
    npt.assert_array_equal(np.asarray(full_grid)[:, 0], [1, 0, 2])


def test_bench_exits_nonzero_without_gpu():
    """bench.py never reports a CPU run as a device result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", VAEX_TPU_BENCH_N="1000")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert "rows_per_s" not in out.stdout
