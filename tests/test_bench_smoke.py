"""bench.py artifact-path smoke: the driver records this JSON line at
round end; the machinery must not rot between hardware runs."""

import json
import os
import subprocess
import sys


def test_bench_quick_emits_json_line(tmp_path):
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "bench.py", "--quick", "--msv-impl", "xla",
         "--platform", "cpu",
         "--no-sweep", "--no-stages", "--no-m2405",
         "--no-cascade", "--no-oracle"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("{")][-1]
    payload = json.loads(line)
    assert payload["metric"] == "GCUPS_M1400"
    assert payload["unit"] == "GCUPS"
    assert payload["value"] > 0
    assert "vs_baseline" in payload
    assert payload["errors"] == []
    # the printed line is compact (the driver archives only a ~2000-char
    # tail); the full per-rep detail lives in the file the line names
    with open(payload["detail_file"]) as fh:
        detail = json.load(fh)
    assert detail["errors"] == []
    assert detail["primary"]["rep_seconds"]  # per-rep record
    assert detail["primary"]["name"].startswith("headline_1400")
    # compact line stays under the driver's tail cap even with extras
    assert len(line) < 1900
