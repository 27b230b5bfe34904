#!/usr/bin/env python3
"""Single-machine multi-host launcher (validation / dev rig).

Spawns N burst_tpu CLI processes wired together with jax.distributed
(Gloo over localhost), each owning a clump shard of the database --
the same code path a real multi-host deployment runs.

    python tools/launch_multihost.py -n 2 [--port N] -- \
        -q q.fa -r db.edx -a db.acx -o out.b6 -m BEST

By default a free ephemeral port is picked at launch (bind port 0,
read it back, release) so concurrent runs never collide.

Process 0 writes the b6; the launcher exits nonzero if any process
fails. CPU backend is forced (JAX_PLATFORMS=cpu) so this runs anywhere;
on a real pod, launch one process per host with BURST_TPU_MULTIHOST set
(see burst_tpu/parallel/multihost.py).
"""
import argparse
import os
import socket
import subprocess
import sys


def free_port() -> int:
    """Pick a currently-free TCP port (bind 0, read, release)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=0,
                    help="coordinator port (0 = pick a free one)")
    ap.add_argument("cli", nargs=argparse.REMAINDER,
                    help="-- then burst_tpu.cli arguments")
    args = ap.parse_args(argv)
    cli = args.cli
    if cli and cli[0] == "--":
        cli = cli[1:]
    if not cli:
        ap.error("pass CLI arguments after --")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = args.port or free_port()
    procs = []
    for pid in range(args.nprocs):
        env = dict(os.environ)
        env["BURST_TPU_MULTIHOST"] = \
            f"{pid}/{args.nprocs}@localhost:{port}"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "burst_tpu.cli"] + cli, env=env,
            stdout=subprocess.DEVNULL if pid else None))
    rc = 0
    for p in procs:
        rc = rc or p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
