"""Linked plot views bound to the reactive GridModel layer (reference:
packages/vaex-jupyter/vaex/jupyter/view.py + bqplot.py, ~2.7 kLoC of
bqplot/ipyleaflet widgets).

Re-design: the VIEW logic — model observation, brush ->
``df.select``, redraw scheduling — is backend-independent and runs
headless; rendering is a pluggable backend resolved at construction:

* ``bqplot``  — interactive marks with a BrushIntervalSelector /
  BrushSelector writing selections back to the DataFrame;
* ``matplotlib`` — static figures redrawn into an ipywidgets Output (or
  bare pyplot when ipywidgets is absent);
* ``headless`` — records draw calls; what the tests drive.

The linked-views contract is inherited from the models: ONE brush in any
view re-aggregates every linked view in a single fused executor pass
(jupyter.py ModelDispatcher; test_jupyter.py one-pass-two-views)."""

from __future__ import annotations

import numpy as np

from .jupyter import Axis, GridModel


# ---------------------------------------------------------------------------
# backends

class HeadlessBackend:
    """Records draw calls — the testable no-op renderer."""

    interactive = False

    def __init__(self):
        self.draws = []

    def draw_histogram(self, view, centers, total, selected):
        self.draws.append(("histogram", centers, total, selected))

    def draw_heatmap(self, view, extent, grid_total, grid_selected):
        self.draws.append(("heatmap", extent, grid_total, grid_selected))

    def widget(self, view):
        return None


class MplBackend(HeadlessBackend):
    """Matplotlib rendering: redraws into an ipywidgets.Output when
    available (live updates in a notebook), else bare pyplot."""

    def __init__(self):
        super().__init__()
        import matplotlib.pyplot as plt
        self.plt = plt
        try:
            import ipywidgets as widgets
            self.out = widgets.Output()
        except Exception:
            self.out = None

    def _render(self, fn):
        if self.out is not None:
            from IPython.display import clear_output
            with self.out:
                clear_output(wait=True)
                fn()
                self.plt.show()
        else:
            fn()

    def draw_histogram(self, view, centers, total, selected):
        super().draw_histogram(view, centers, total, selected)

        def fn():
            self.plt.figure(figsize=(7, 3))
            self.plt.plot(centers, total, drawstyle="steps-mid", color="#888",
                          label="total")
            if selected is not None:
                self.plt.fill_between(centers, 0, selected, step="mid",
                                      alpha=0.6, label="selected")
            self.plt.xlabel(view.model.axes[0].expression)
            self.plt.ylabel("count")
            self.plt.legend()
        self._render(fn)

    def draw_heatmap(self, view, extent, grid_total, grid_selected):
        super().draw_heatmap(view, extent, grid_total, grid_selected)
        grid = grid_selected if grid_selected is not None else grid_total

        def fn():
            self.plt.figure(figsize=(6, 5))
            self.plt.imshow(np.log1p(np.asarray(grid, "f8")).T,
                            origin="lower", aspect="auto", extent=extent)
            self.plt.xlabel(view.model.axes[0].expression)
            self.plt.ylabel(view.model.axes[1].expression)
        self._render(fn)

    def widget(self, view):
        return self.out


class BqplotBackend(HeadlessBackend):
    """bqplot marks + brush selectors; the brush writes ``df.select`` through
    the view (the same code path the headless tests drive)."""

    interactive = True

    def __init__(self):
        super().__init__()
        import bqplot
        self.bqplot = bqplot
        self._figures = {}

    def _histogram_figure(self, view, centers, total, selected):
        bq = self.bqplot
        sx = bq.LinearScale()
        sy = bq.LinearScale()
        lines = bq.Lines(x=centers, y=total, scales={"x": sx, "y": sy},
                         colors=["#888"])
        bars = bq.Lines(x=centers, y=selected if selected is not None else total,
                        scales={"x": sx, "y": sy}, fill="bottom",
                        fill_opacities=[0.6])
        selector = bq.interacts.BrushIntervalSelector(scale=sx)

        def on_brush(*_):
            if selector.selected is not None and len(selector.selected) == 2:
                lo, hi = float(selector.selected[0]), float(selector.selected[1])
                view.brush(lo, hi)
        selector.observe(on_brush, "brushing")
        fig = bq.Figure(marks=[lines, bars], interaction=selector,
                        axes=[bq.Axis(scale=sx, label=view.model.axes[0].expression),
                              bq.Axis(scale=sy, orientation="vertical")])
        return fig, lines, bars

    def draw_histogram(self, view, centers, total, selected):
        super().draw_histogram(view, centers, total, selected)
        entry = self._figures.get(id(view))
        if entry is None:
            self._figures[id(view)] = self._histogram_figure(
                view, centers, total, selected)
        else:
            _, lines, bars = entry
            lines.x, lines.y = centers, total
            bars.x, bars.y = centers, (selected if selected is not None else total)

    def draw_heatmap(self, view, extent, grid_total, grid_selected):
        super().draw_heatmap(view, extent, grid_total, grid_selected)
        bq = self.bqplot
        grid = grid_selected if grid_selected is not None else grid_total
        values = np.log1p(np.asarray(grid, "f8")).T
        entry = self._figures.get(id(view))
        if entry is None:
            sx = bq.LinearScale(min=extent[0], max=extent[1])
            sy = bq.LinearScale(min=extent[2], max=extent[3])
            sc = bq.ColorScale(scheme="viridis")
            heat = bq.HeatMap(color=values, scales={"x": sx, "y": sy, "color": sc})
            selector = bq.interacts.BrushSelector(x_scale=sx, y_scale=sy)

            def on_brush(*_):
                sel = selector.selected
                if sel is not None and len(sel) == 2:
                    (x0, y0), (x1, y1) = sel
                    view.brush2d(float(min(x0, x1)), float(max(x0, x1)),
                                 float(min(y0, y1)), float(max(y0, y1)))
            selector.observe(on_brush, "brushing")
            fig = bq.Figure(marks=[heat], interaction=selector,
                            axes=[bq.Axis(scale=sx, label=view.model.axes[0].expression),
                                  bq.Axis(scale=sy, orientation="vertical",
                                          label=view.model.axes[1].expression)])
            self._figures[id(view)] = (fig, heat)
        else:
            _, heat = entry
            heat.color = values

    def widget(self, view):
        entry = self._figures.get(id(view))
        return entry[0] if entry else None


def pick_backend(prefer=None):
    """bqplot -> matplotlib -> headless, first importable wins."""
    if prefer is not None:
        return {"bqplot": BqplotBackend, "matplotlib": MplBackend,
                "headless": HeadlessBackend}[prefer]()
    try:
        return BqplotBackend()
    except Exception:
        pass
    try:
        return MplBackend()
    except Exception:
        return HeadlessBackend()


# ---------------------------------------------------------------------------
# views

class ViewBase:
    """Observes a GridModel's ``grid`` events and redraws through the
    backend; brushing writes a selection on the DataFrame, which the
    ModelDispatcher fans out to every linked model in ONE fused pass."""

    def __init__(self, model, backend=None):
        self.model = model
        self.backend = backend if backend is not None else pick_backend()
        self.draw_count = 0
        model.observe(self._on_grid, "grid")
        if model.grid is not None:
            self._on_grid({"new": model.grid})

    @property
    def df(self):
        return self.model.df

    def _grids(self):
        """(total, selected-or-None) from the model's stacked grid."""
        g = self.model.grid
        if isinstance(self.model.selection, (list, tuple)):
            return g[0], g[1]
        return g, None

    def _on_grid(self, change):
        self.draw_count += 1
        self.redraw()

    def redraw(self):
        raise NotImplementedError

    def widget(self):
        return self.backend.widget(self)


class HistogramView(ViewBase):
    """1-d count view with a linked interval brush (reference bqplot.py
    histogram view)."""

    def __init__(self, df, x, shape=64, backend=None, selection_name="default"):
        self.selection_name = selection_name
        model = GridModel(df, [Axis(df, x, shape=shape)],
                          selection=[None, True])
        model.compute()
        super().__init__(model, backend=backend)

    def brush(self, vmin, vmax):
        """The brush-selector callback target: select the interval on the
        frame — every linked view re-grids in one fused pass."""
        expr = self.model.axes[0].expression
        self.df.select(f"(({expr}) >= {vmin!r}) & (({expr}) <= {vmax!r})",
                       name=self.selection_name)

    def unbrush(self):
        self.df.select(None, name=self.selection_name)

    def redraw(self):
        total, selected = self._grids()
        self.backend.draw_histogram(self, self.model.axes[0].bin_centers,
                                    total, selected)


class HeatmapView(ViewBase):
    """2-d count view with a linked rectangle brush."""

    def __init__(self, df, x, y, shape=128, backend=None,
                 selection_name="default"):
        self.selection_name = selection_name
        model = GridModel(df, [Axis(df, x, shape=shape),
                               Axis(df, y, shape=shape)],
                          selection=[None, True])
        model.compute()
        super().__init__(model, backend=backend)

    def brush2d(self, x0, x1, y0, y1):
        ex = self.model.axes[0].expression
        ey = self.model.axes[1].expression
        self.df.select(f"(({ex}) >= {x0!r}) & (({ex}) <= {x1!r}) & "
                       f"(({ey}) >= {y0!r}) & (({ey}) <= {y1!r})",
                       name=self.selection_name)

    def redraw(self):
        total, selected = self._grids()
        ax, ay = self.model.axes
        self.backend.draw_heatmap(self, [ax.min, ax.max, ay.min, ay.max],
                                  total, selected)
