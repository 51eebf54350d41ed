"""The readings a cell's limits are set from, and the control that has to fail.

    python qbench/control.py --workload <cell> --seeds 1,2,3,...

For each seed, in one process: the cell's table is made as a run makes it,
each query of the mix is answered by the engine through the same call the
window makes, on the same table, and the answer is held against the plain
reference (float64, as the configuration states).  The control is the
reference itself computed in the precision below, float32, and held
against the float64 reference in the same way.  A sound limit lies above
every seed's engine reading (the lower reading is their largest) and below
every seed's control reading (the upper reading is their smallest).  The
benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root, workload, seeds, rows=None, require_device=True):
    """[{"seed", "engine": numbers, "control": numbers}] per seed."""
    sys.path.insert(0, root)
    import numpy as np
    from qbench import compare
    from qbench.run import load_module, log, open_cell
    qdir = os.path.join(root, "qbench", "queries")
    out = []
    for seed in seeds:
        spec, _, cols, df, _ = open_cell(root, workload, seed, rows, require_device)
        config = spec["config"]
        import vaex_tpu as vt
        from vaex_tpu import cache
        engine, control = [], []
        with cache.off():
            for q in spec["traffic"]["queries"]:
                mod = load_module(os.path.join(qdir, q["op"] + ".py"))
                kinds = mod.kinds(q, config)
                got = mod.program(vt, df, q)
                want = mod.reference(cols, q, config, np.float64)
                low = mod.reference(cols, q, config, np.float32)
                engine.append(compare.compare(got, want, kinds))
                control.append(compare.compare(low, want, kinds))
        row = {"seed": seed, "engine": compare.fold(engine), "control": compare.fold(control)}
        log(json.dumps(row))
        out.append(row)
        del df, cols
        gc.collect()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = parser.parse_args(argv)
    rows = readings(ROOT, args.workload, [int(s) for s in args.seeds.split(",")])
    from qbench.compare import NUMBERS
    summary = {k: {"lower": max(r["engine"][k] for r in rows),
                   "upper": min(r["control"][k] for r in rows)} for k in NUMBERS}
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
