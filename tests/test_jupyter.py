"""Headless tests of the reactive jupyter models (reference vaex-jupyter
model.py Axis/DataArray semantics, tested without a browser or ipywidgets)."""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu as vt
from vaex_tpu.jupyter import Axis, GridModel, get_dispatcher


@pytest.fixture
def df():
    rng = np.random.default_rng(4)
    return vt.from_arrays(x=rng.random(10_000) * 10,
                          y=rng.random(10_000) * 4 - 2)


def test_axis_limits_computed(df):
    ax = Axis(df, "x", shape=32)
    assert ax.status == "no_limits"
    ax.ensure_limits()
    assert ax.status == "ready"
    assert ax.min <= 0.01 and ax.max >= 9.9
    assert len(ax.bin_centers) == 32


def test_axis_expression_change_invalidates(df):
    ax = Axis(df, "x", shape=16, min=0, max=10)
    assert ax.status == "ready"
    ax.expression = "y"
    assert ax.status == "no_limits" and ax.min is None
    ax.ensure_limits()
    assert ax.status == "ready" and ax.max <= 2.01


def test_grid_model_counts(df):
    model = df.widget.data_array(["x"], selection=None)
    assert model.status == "ready"
    # the row AT the max falls in the overflow edge (reference +3-edge
    # convention, values == vmax overflow)
    assert model.grid.sum() in (len(df), len(df) - 1)
    oracle = df.count(binby=["x"], limits=[[model.axes[0].min, model.axes[0].max]],
                      shape=64)
    npt.assert_array_equal(model.grid, np.asarray(oracle))


def test_selection_change_one_pass_two_views(df):
    """The linked-views contract: one selection change
    re-aggregates BOTH views in exactly ONE fused executor pass."""
    ax_x = Axis(df, "x", shape=16, min=0, max=10)
    ax_y = Axis(df, "y", shape=8, min=-2, max=2)
    hist = GridModel(df, [ax_x], selection=True)
    heat = GridModel(df, [ax_x, ax_y], selection=True)
    df.select("x > 5")  # triggers the dispatcher
    get_dispatcher(df).flush()
    assert hist.status == "ready" and heat.status == "ready"
    passes_before = df.executor.passes
    df.select("x > 3")  # limits known -> exactly one aggregation pass
    assert df.executor.passes == passes_before + 1
    assert hist.status == "ready" and heat.status == "ready"
    # both views reflect the new selection
    x = np.asarray(df["x"].tolist())
    assert hist.grid.sum() == (x > 3).sum()
    assert heat.grid.sum() == (x > 3).sum()
    # brushing to a narrower selection updates both again
    df.select("x > 8")
    assert hist.grid.sum() == (x > 8).sum()
    assert heat.grid.sum() == (x > 8).sum()


def test_grid_model_observer_fires(df):
    events = []
    model = df.widget.data_array(["x"], selection=True)
    model.observe(lambda change: events.append(change["name"]), "grid")
    df.select("x < 2")
    assert "grid" in events


def test_grid_model_mean_agg(df):
    model = df.widget.data_array(["x"], agg=("mean", "y"))
    oracle = df.mean("y", binby=["x"],
                     limits=[[model.axes[0].min, model.axes[0].max]], shape=64)
    npt.assert_allclose(model.grid, np.asarray(oracle), rtol=1e-12, equal_nan=True)


def test_axis_categorical_no_pass(df):
    df2 = vt.from_arrays(k=np.arange(100) % 5)
    df2 = df2.categorize("k", labels=list("abcde"))
    passes = df2.executor.passes
    ax = Axis(df2, "k")
    assert ax.status == "ready" and ax.shape == 5
    assert df2.executor.passes == passes  # category metadata, no minmax pass


def test_linked_views_brush_one_pass(df):
    """brushing the HISTOGRAM VIEW updates the heatmap view
    through exactly one fused pass — the full view->select->dispatch->
    re-grid->redraw loop, headless."""
    from vaex_tpu.jupyter_view import HeadlessBackend, HistogramView, HeatmapView
    hist = HistogramView(df, "x", shape=16, backend=HeadlessBackend())
    heat = HeatmapView(df, "x", "y", shape=8, backend=HeadlessBackend())
    hist.model.axes[0].set_limits(0, 10)  # already ready; idempotent
    assert hist.draw_count >= 1 and heat.draw_count >= 1

    hist.brush(3.0, 10.0)  # warm: creates the selection (one pass)
    passes_before = df.executor.passes
    draws_before = heat.draw_count
    hist.brush(5.0, 10.0)  # the brush: limits known -> ONE aggregation pass
    assert df.executor.passes == passes_before + 1
    assert heat.draw_count == draws_before + 1

    x = np.asarray(df["x"].tolist())
    sel_count = ((x >= 5.0) & (x <= 10.0)).sum()
    _, hist_selected = hist._grids()
    _, heat_selected = heat._grids()
    assert hist_selected.sum() == sel_count
    # rows AT an axis max fall in the overflow edge (+3-edge convention):
    # the 2-d view can lose up to one row per axis
    assert sel_count - 2 <= heat_selected.sum() <= sel_count
    # totals unaffected by the brush
    hist_total, _ = hist._grids()
    assert hist_total.sum() in (len(df), len(df) - 1)


def test_heatmap_view_brush2d(df):
    from vaex_tpu.jupyter_view import HeadlessBackend, HeatmapView
    heat = HeatmapView(df, "x", "y", shape=8, backend=HeadlessBackend())
    heat.brush2d(2.0, 8.0, -1.0, 1.0)
    x = np.asarray(df["x"].tolist())
    y = np.asarray(df["y"].tolist())
    want = ((x >= 2) & (x <= 8) & (y >= -1) & (y <= 1)).sum()
    _, selected = heat._grids()
    assert selected.sum() == want
    # the headless backend recorded the redraws
    kinds = [d[0] for d in heat.backend.draws]
    assert kinds.count("heatmap") == heat.draw_count


def test_view_backend_fallback(df):
    """pick_backend degrades bqplot -> matplotlib -> headless without
    raising, whatever is installed."""
    from vaex_tpu.jupyter_view import pick_backend
    b = pick_backend()
    assert hasattr(b, "draw_histogram")
    from vaex_tpu.jupyter_view import HeadlessBackend
    assert isinstance(pick_backend("headless"), HeadlessBackend)
