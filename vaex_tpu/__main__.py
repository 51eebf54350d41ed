"""CLI: ``python -m vaex_tpu {convert, meta, stat, webserver, benchmark, open}``.

Re-design of the reference's ``vaex-core/vaex/__main__.py`` (subcommands
webserver/convert/benchmark/meta/alias/stat/open/test, __main__.py:24-89).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser("vaex_tpu", description="DataFrame engine CLI")
    sub = parser.add_subparsers(dest="command")

    p_convert = sub.add_parser("convert", help="convert between file formats")
    p_convert.add_argument("input")
    p_convert.add_argument("output")

    p_meta = sub.add_parser("meta", help="show file metadata")
    p_meta.add_argument("path")

    p_stat = sub.add_parser("stat", help="quick statistics of a file")
    p_stat.add_argument("path")

    p_open = sub.add_parser("open", help="validate that files open")
    p_open.add_argument("paths", nargs="+")

    p_server = sub.add_parser("webserver", help="serve files over websocket/REST")
    p_server.add_argument("paths", nargs="+")
    p_server.add_argument("--port", type=int, default=9000)
    p_server.add_argument("--token", default=None, help="require this token for access")
    p_server.add_argument("--token-trusted", default=None, dest="token_trusted",
                          help="token unlocking trusted mode (pickled functions)")
    p_server.add_argument("--flavor", choices=["tornado", "asgi"], default="tornado",
                          help="tornado websocket server or the ASGI REST app "
                               "(FastAPI surface; needs uvicorn)")

    p_bench = sub.add_parser("benchmark", help="run the groupby benchmark")
    p_bench.add_argument("--n", type=float, default=1e7)
    p_bench.add_argument("--cardinality", type=int, default=100)

    args = parser.parse_args(argv)
    import vaex_tpu as vt

    if args.command == "convert":
        df = vt.open(args.input)
        df.export(args.output)
        print(f"wrote {args.output}")
    elif args.command == "meta":
        df = vt.open(args.path)
        info = {"rows": len(df),
                "columns": {name: str(df.data_type(name).name) for name in df.get_column_names()}}
        print(json.dumps(info, indent=2))
    elif args.command == "stat":
        df = vt.open(args.path)
        print(df.describe())
    elif args.command == "open":
        ok = True
        for path in args.paths:
            try:
                df = vt.open(path)
                print(f"{path}: OK ({len(df):,} rows)")
            except Exception as e:  # noqa: BLE001
                ok = False
                print(f"{path}: ERROR {e}")
        if not ok:
            sys.exit(1)
    elif args.command == "webserver":
        if args.flavor == "asgi":
            from vaex_tpu.server.asgi import serve
        else:
            from vaex_tpu.server.tornado_server import serve
        frames = {}
        import os
        for path in args.paths:
            name = os.path.splitext(os.path.basename(path))[0]
            frames[name] = vt.open(path)
        print(f"serving {list(frames)} on port {args.port}")
        serve(frames, port=args.port, token=args.token, token_trusted=args.token_trusted)
    elif args.command == "benchmark":
        import os
        os.environ["VAEX_TPU_BENCH_N"] = str(args.n)
        os.environ["VAEX_TPU_BENCH_K"] = str(args.cardinality)
        import importlib.util
        bench_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "bench.py")
        spec = importlib.util.spec_from_file_location("bench", bench_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main()
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
