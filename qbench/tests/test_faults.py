"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run (``run_cell`` with the look for a GPU
skipped, at 1e5 rows) with one fault planted in the engine when the window
opens: a pass that returns its state unchanged, half of the rows left out,
the merge between devices left out, an answer altered where it is
produced."""

import gc

import jax
import numpy as np
import pytest

import qbench.run
from conftest import ROOT, SMALL_ROWS

ONE_CHIP = ["h2o_1e8.small_g", "h2o_1e8.high_g"]
ALL = ONE_CHIP + ["h2o_1e9_mesh.small_g"]


def run(workload):
    return qbench.run.run_cell(ROOT, workload, 5, 0.2, False, rows=SMALL_ROWS,
                               require_device=False)


def in_window(monkeypatch, plant):
    """Call ``plant`` as the window opens, after set-up and warm-up."""
    rounds = qbench.run.rounds

    def planted(queries, rng):
        plant()
        yield from rounds(queries, rng)
    monkeypatch.setattr(qbench.run, "rounds", planted)


def forget_compiled_passes():
    from vaex_tpu.execution import ExecutorLocal
    for obj in gc.get_objects():
        if isinstance(obj, ExecutorLocal):
            obj._step_cache.clear()


@pytest.mark.parametrize("workload", ALL)
def test_sound_run_is_correct(workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload", ALL)
def test_state_unchanged(workload, monkeypatch):
    from vaex_tpu.execution import ExecutorLocal
    orig = ExecutorLocal._get_whole_pass

    def get(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        return lambda states, cols, aux, t0, t1: states
    in_window(monkeypatch, lambda: monkeypatch.setattr(ExecutorLocal, "_get_whole_pass", get))
    assert not run(workload)["correct"]


@pytest.mark.parametrize("workload", ONE_CHIP)
def test_half_the_rows(workload, monkeypatch):
    from vaex_tpu.execution import ExecutorLocal
    orig = ExecutorLocal._get_whole_pass

    def get(self, df, device_tasks, tile_inputs, host_expr_by_slot, set_variables,
            device_filter_expr, tile_rows, n_total, **kwargs):
        return orig(self, df, device_tasks, tile_inputs, host_expr_by_slot, set_variables,
                    device_filter_expr, tile_rows, n_total // 2, **kwargs)
    in_window(monkeypatch, lambda: monkeypatch.setattr(ExecutorLocal, "_get_whole_pass", get))
    assert not run(workload)["correct"]


def test_exchange_left_out(monkeypatch):
    def plant():
        for name in ("psum", "pmin", "pmax"):
            monkeypatch.setattr(jax.lax, name, lambda x, axis_name, **kw: x)
        forget_compiled_passes()  # retrace the passes without their merge
    in_window(monkeypatch, plant)
    assert not run("h2o_1e9_mesh.small_g")["correct"]


@pytest.mark.parametrize("workload", ALL)
def test_answer_altered(workload, monkeypatch):
    from vaex_tpu.tasks import TaskAggregations
    orig = TaskAggregations.finalize

    def finalize(self, state, outputs):
        if self.binners:  # a grouped answer: one group's every aggregate is off by one
            altered = []
            for s in state:
                first = np.array(s[0])
                flat = first.reshape(-1)
                flat[np.flatnonzero(flat)[flat.astype(bool).sum() // 2]] += 1
                altered.append((first,) + tuple(s[1:]))
            state = altered
        return orig(self, state, outputs)
    in_window(monkeypatch, lambda: monkeypatch.setattr(TaskAggregations, "finalize", finalize))
    assert not run(workload)["correct"]
