"""Protect the driver-facing entry points: __graft_entry__ and bench.py.

A regression in either costs the round's recorded metric even if the
library itself is healthy, so they get CI coverage on the CPU mesh.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_graft_entry_single_chip():
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as g
    import jax

    fn, args = g.entry()
    out = np.asarray(jax.jit(fn)(*args))
    assert out.shape == (4,) and np.all(np.isfinite(out))


def test_bench_quick_emits_valid_json():
    """The driver records bench.py's LAST stdout line as the metric."""
    env = {
        "PATH": "/usr/bin:/bin:/usr/local/bin",
        "HOME": "/root",
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": str(REPO),
    }
    proc = subprocess.run(
        [
            sys.executable,
            str(REPO / "bench.py"),
            "--quick",
            "--msv-impl", "xla",
            "--no-sweep", "--no-stages", "--no-m2405",
            "--reps", "1",
        ],
        capture_output=True,
        text=True,
        timeout=420,
        env=env,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = proc.stdout.strip().splitlines()[-1]
    payload = json.loads(line)
    assert payload["metric"].startswith("GCUPS")
    assert payload["value"] > 0
    assert payload["unit"] == "GCUPS"
    assert "vs_baseline" in payload
