"""chip_smoke.py is the GPU check: off a GPU it must refuse to run the
path (no CPU fallback) and print no result."""

import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(script: pathlib.Path, cwd: pathlib.Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=300, env=env, cwd=cwd,
    )


def test_chip_smoke_refuses_cpu():
    proc = _run(REPO / "chip_smoke.py", REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied without the package it exits nonzero before touching JAX."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
