"""Two-process jax.distributed smoke test: initialize_multihost over a CPU
coordinator, global mesh spanning both processes, one psum-merged groupby.

Exercises the multi-host claim (parallel/mesh.py:initialize_multihost) with
real separate controller processes — the closest CI can get to a multi-host
pod slice.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax
    sys.path.insert(0, {repo!r})
    from vaex_tpu.parallel.mesh import initialize_multihost

    pid = int(sys.argv[1]); coord = sys.argv[2]
    initialize_multihost(coordinator_address=coord, num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    devices = jax.devices()  # global: 4 cpu devices across 2 processes
    assert len(devices) == 4, devices

    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

    mesh = Mesh(np.array(devices), ("d",))
    N, G = 1024, 8
    rng = np.random.default_rng(0)
    keys_full = rng.integers(0, G, N).astype(np.int32)
    vals_full = rng.random(N)
    # each process materializes its local shard of the global array
    sharding = NamedSharding(mesh, P("d"))
    def make(full, dtype):
        def cb(index):
            return full[index].astype(dtype)
        return jax.make_array_from_callback((N,), sharding, cb)
    keys = make(keys_full, np.int32)
    vals = make(vals_full, np.float64)

    def local(k, v):
        onehot = (k[:, None] == jnp.arange(G)[None, :]).astype(jnp.float64)
        grid = onehot.T @ v[:, None]
        return jax.lax.psum(grid[:, 0], "d")

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P("d"), P("d")),
                       out_specs=P(), check_vma=False)
    out = np.asarray(jax.jit(fn)(keys, vals))[:G]
    want = np.bincount(keys_full, weights=vals_full, minlength=G)
    np.testing.assert_allclose(out, want, rtol=1e-12)
    print(f"proc {{pid}} OK", flush=True)
""")


def test_two_process_jax_distributed(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=repo))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = repo
    procs = [subprocess.Popen([sys.executable, str(script), str(i), coord],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out
