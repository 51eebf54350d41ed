"""Test fixtures mirroring the reference's strategy (SURVEY §4,
reference tests/common.py): one small canonical dataframe exposed through a
parametrized fixture matrix that forces every storage/execution path —
in-memory, tiny tiles (multi-chunk + padding), trimmed active range,
filtered, uneven concat, arrow-backed, hdf5 round-trip — so every operator is
exercised across tile boundaries, exactly like the reference's
``small_buffer`` + backend matrix.

Tests run on the CPU backend with 8 virtual devices, the multi-device
stand-in: the flag must be in XLA_FLAGS before the backend starts.  Tests
marked ``gpu`` need a card and skip without one.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

import vaex_tpu as vt


def base_arrays():
    x = np.arange(10, dtype="f8")
    return dict(
        x=x,
        y=x ** 2,
        g=np.array([0, 0, 0, 0, 1, 1, 1, 1, 2, 2], dtype="i8"),
        m=np.ma.MaskedArray(x.copy(), x < 2),          # first 2 missing
        f=np.where(x == 9, np.nan, x),                  # last is NaN
        i=np.arange(10, dtype="i4"),
        name=np.asarray([f"n{int(v) % 3}" for v in x], dtype=object),
    )


def make_base_df():
    return vt.from_arrays(**base_arrays())


BACKENDS = ["memory", "small_tiles", "trimmed", "filtered", "concat", "arrow", "hdf5"]


@pytest.fixture(params=BACKENDS)
def df(request, tmp_path):
    kind = request.param
    arrays = base_arrays()
    if kind == "memory":
        return vt.from_arrays(**arrays)
    if kind == "small_tiles":
        out = vt.from_arrays(**arrays)
        out._tile_rows = 3
        return out
    if kind == "trimmed":
        extended = {k: np.ma.concatenate([v[:1], v]) if isinstance(v, np.ma.MaskedArray)
                    else np.concatenate([v[:1], v]) for k, v in arrays.items()}
        out = vt.from_arrays(**extended)
        out.set_active_range(1, 11)
        return out.trim()
    if kind == "filtered":
        extended = {k: np.ma.concatenate([v, v[:2]]) if isinstance(v, np.ma.MaskedArray)
                    else np.concatenate([v, v[:2]]) for k, v in arrays.items()}
        extended["keep"] = np.concatenate([np.ones(10, bool), np.zeros(2, bool)])
        out = vt.from_arrays(**extended)
        return out.filter("keep")
    if kind == "concat":
        parts = []
        bounds = [0, 3, 4, 8, 10]
        for i in range(4):
            sub = {k: v[bounds[i]:bounds[i + 1]] for k, v in arrays.items()}
            parts.append(vt.from_arrays(**sub))
        out = vt.concat(parts)
        out._tile_rows = 4  # force rechunking across sub-dataset boundaries
        return out
    if kind == "arrow":
        import pyarrow as pa
        table_data = {}
        for k, v in arrays.items():
            if isinstance(v, np.ma.MaskedArray):
                table_data[k] = pa.array(v.data, mask=np.ma.getmaskarray(v))
            elif v.dtype == object:
                table_data[k] = pa.array(list(v))
            else:
                table_data[k] = pa.array(v)
        return vt.from_arrow_table(pa.table(table_data))
    if kind == "hdf5":
        path = str(tmp_path / "base.hdf5")
        make_base_df().export_hdf5(path)
        return vt.open(path)
    raise ValueError(kind)


@pytest.fixture
def df_local():
    return make_base_df()


@pytest.fixture
def df_small():
    out = make_base_df()
    out._tile_rows = 3
    return out


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU,
    decided per test and never at import or collection time."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU")
