"""Real multi-process (DCN) validation of the distributed backend.

Runs scripts/dcn_dryrun.py: 2 CPU processes x 4 virtual devices each,
joined via jax.distributed.initialize, one sharded circuit + measurement
crossing the process boundary (SURVEY.md §5, distributed communication
backend).  Everything before round 4 exercised the DCN ordering policy
only with fabricated device objects; this is the end-to-end check whose
failure mode (wrong mesh order -> butterflies silently on DCN) no
single-process test can see — and it caught one: distributed CPU devices
expose a uniform slice_index, which collapsed comm_domain until
parallel/mesh.py grouped real devices by process_index.

Subprocess-driven: the workers must own their own distributed runtime
(the pytest process already holds the 8-virtual-device single-process
backend from conftest).
"""

import json
import os
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "dcn_dryrun.py")


def test_dcn_two_process_dryrun():
    # bounded by the subprocess.run timeout below (pytest-timeout is not
    # in the baked-in environment)
    env = dict(os.environ)
    # The parent script builds its workers' env itself; just make sure the
    # repo is importable and nothing forces a device count on the parent.
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, SCRIPT], env=env, capture_output=True, text=True,
        timeout=440,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["ok"] is True
    assert summary["num_processes"] == 2
    res = summary["results"]
    assert len(res) == 2
    for r in res:
        assert r["mesh_degree"] == 3
        assert r["ici_degree"] == 2  # 4-device process blocks stay ICI-pure
        assert r["match"] is True    # sharded == single-device measurement
        assert abs(r["multi_norm"] - 1.0) < 1e-12
    # the replicated measurement is the SAME index in both processes
    assert res[0]["multi_idx"] == res[1]["multi_idx"]
