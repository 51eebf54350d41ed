"""chip_smoke.py's phases at a tiny size on the CPU backend: the same
functions the card runs at 1e8 rows, called directly.  The device phase
itself must refuse anything but a GPU."""

import os
import sys

import numpy as np
import numpy.testing as npt
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def table():
    return cs.build_table(20_000, seed=3)


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.phase_device()


def test_script_exits_nonzero_without_gpu():
    import subprocess
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_main_phase_tiny(table):
    rows = cs.phase_main(table, "cpu", n_isin=50)
    assert [r[0] for r in rows] == ["q1", "q3", "q7", "binby_mean_1000",
                                    "isin_50", "join_20000x200"]


def test_streamed_phase_tiny(table, tmp_path):
    rows = cs.phase_streamed(table, "cpu", str(tmp_path))
    assert rows[0][0] == "q1_streamed"


def test_multichip_phase_on_virtual_devices(table):
    import jax
    assert len(jax.devices()) >= 4, "conftest provides 8 virtual devices"
    rows = cs.phase_multichip(table, "cpu", n_devices=4)
    assert [r[0] for r in rows] == ["q1_mesh", "q3_mesh", "shuffle_groupby",
                                    "shuffle_join"]


@pytest.mark.parametrize("keys", [np.array([5, 3, 5, 9, 3, 3]),
                                  np.array([2 ** 40, -7, 2 ** 40, 0])])
def test_group_index_matches_unique(keys):
    keys = keys.astype(np.int64)
    uniq, inv = cs.group_index(keys)
    u2, i2 = np.unique(keys, return_inverse=True)
    npt.assert_array_equal(uniq, u2)
    npt.assert_array_equal(inv, i2)


def test_group_extremes_oracle():
    inv = np.array([0, 1, 0, 1, 2])
    v = np.array([4, 1, 2, 7, 3], np.int64)
    mn, mx = cs.group_extremes_small_range(inv, 3, v)
    npt.assert_array_equal(mn, [2, 1, 3])
    npt.assert_array_equal(mx, [4, 7, 3])


def test_oracles_reject_what_they_cannot_check():
    with pytest.raises(ValueError):
        cs.group_extremes_small_range(np.zeros(2, np.int64), 1,
                                      np.array([0, 100], np.int64))
    with pytest.raises(ValueError):
        cs.group_sum_int(np.zeros(2, np.int64), 1, np.array([2.0 ** 53, 1.0]))


def test_check_close_contract():
    cs.check_close("ok", [1.0, np.nan], [1.0 + 5e-7, np.nan])
    with pytest.raises(AssertionError):
        cs.check_close("bad", [1.0], [1.0 + 1e-5])


@pytest.mark.gpu
def test_main_phase_on_gpu(table):
    """The card's main path at a small size (runs only with a GPU)."""
    cs.phase_main(table, "gpu", n_isin=50)
