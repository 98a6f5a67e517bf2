"""Multi-process (DCN) dryrun: 2 CPU processes x 4 virtual devices each.

The sharded engine's multi-HOST story is the `comm_domain` /
`order_devices_for_ici` device-ordering policy (parallel/mesh.py): low
mesh bits stay intra-process (ICI), only the top bit crosses the process
boundary (DCN).  Until round 4 that policy was exercised only with
fabricated device objects; this script runs it FOR REAL across a process
boundary — `jax.distributed.initialize` + cross-process CPU collectives —
and checks, end to end:

  * build_mesh() over 2 processes x 4 local devices orders the 8 global
    devices process-major: ici_degree == 2 (bits 0-1 intra-process),
    mesh_degree == 3;
  * a sharded circuit whose global-qubit butterflies include the TOP mesh
    bit (a genuine cross-process collective_permute) runs and matches the
    single-device engine: same measured index under the same key, same
    norm;
  * the sharded measurement reduction (psum across processes) agrees.

Usage:
  python scripts/dcn_dryrun.py            # parent: spawns the 2 workers
  python scripts/dcn_dryrun.py --worker --process-id K --coordinator H:P

The parent prints one JSON line {"ok": true, ...} and exits 0 on success.

No reference counterpart: the reference is single-process by design
(Report §IV.D); SURVEY.md §5 names `jax.distributed` + collectives over
ICI/DCN as the rebuild's distributed-backend deliverable.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NUM_PROCESSES = 2
DEVICES_PER_PROCESS = 4


def worker(process_id: int, coordinator: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")  # before any backend init
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=NUM_PROCESSES,
        process_id=process_id,
    )
    import jax.numpy as jnp

    from quantumcomputer.models import circuit as cir
    from quantumcomputer.parallel.mesh import build_mesh, ici_degree, mesh_degree
    from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    assert len(jax.devices()) == NUM_PROCESSES * DEVICES_PER_PROCESS
    assert len(jax.local_devices()) == DEVICES_PER_PROCESS

    mesh = build_mesh()
    md, icid = mesh_degree(mesh), ici_degree(mesh)
    # Domain-major order: 4-device blocks process-pure, so bits 0-1 are
    # intra-process (ICI) and bit 2 — the top mesh bit — crosses DCN.
    procs = [d.process_index for d in mesh.devices.ravel()]
    assert procs == sorted(procs), f"mesh not process-major: {procs}"

    # Circuit with entanglement + phases touching the TOP global qubit
    # (n-1): its butterfly is a cross-process collective_permute.
    L, M = 3, 4
    n = L + M
    circ = (
        (cir.H(n - 1), cir.H(n - 2), cir.H(0))
        + (cir.CNOT(n - 1, 1), cir.CNOT(n - 2, 2), cir.CPHASE(n - 1, 0, 0.7))
        + (cir.H(n - 1), cir.T(2), cir.CZ(n - 1, n - 2), cir.H(n - 2))
    )
    key = jax.random.PRNGKey(7)

    single = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    s_state = single.run(circ, single.initial_state())
    s_idx, _ = single.measure(s_state, key)

    multi = ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, mesh=mesh)
    m_state = multi.run(circ)
    m_norm = float(multi.norm(m_state))
    m_idx, _ = multi.measure(m_state, key)

    out = {
        "process_id": process_id,
        "mesh_degree": md,
        "ici_degree": icid,
        "single_idx": int(s_idx),
        "multi_idx": int(m_idx),
        "multi_norm": m_norm,
        "match": bool(int(s_idx) == int(m_idx)),
    }
    print("DCN_RESULT " + json.dumps(out), flush=True)
    assert out["match"], out
    assert abs(m_norm - 1.0) < 1e-12, m_norm
    assert icid == 2 and md == 3, (icid, md)


def parent() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coordinator = f"localhost:{port}"

    env = dict(os.environ)
    # Both workers run on the CPU: two processes must never open one card.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={DEVICES_PER_PROCESS}"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--process-id", str(i), "--coordinator", coordinator],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(NUM_PROCESSES)
    ]
    outs = []
    ok = True
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            ok = False
        outs.append(out)
        ok = ok and p.returncode == 0

    results = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("DCN_RESULT "):
                results.append(json.loads(line[len("DCN_RESULT "):]))
    ok = ok and len(results) == NUM_PROCESSES
    if results and len(results) == NUM_PROCESSES:
        # Both processes must see the SAME replicated measurement.
        ok = ok and all(r["multi_idx"] == results[0]["multi_idx"] for r in results)
        ok = ok and all(r["match"] and r["ici_degree"] == 2 for r in results)
    summary = {
        "ok": ok,
        "num_processes": NUM_PROCESSES,
        "devices_per_process": DEVICES_PER_PROCESS,
        "results": results,
    }
    print(json.dumps(summary))
    if not ok:
        for i, out in enumerate(outs):
            sys.stderr.write(f"--- worker {i} output ---\n{out}\n")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--coordinator", type=str, default="")
    args = ap.parse_args()
    if args.worker:
        worker(args.process_id, args.coordinator)
        return 0
    return parent()


if __name__ == "__main__":
    sys.exit(main())
