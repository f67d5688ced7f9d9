"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding paths are validated on fake CPU devices. Tests that need a CUDA
device carry the ``gpu`` marker and take the ``gpu`` fixture, which skips
them here; on a card, ``HFV_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``
runs them. Must run before any jax import.
"""

import os
import pathlib

if os.environ.get("HFV_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402

# Tests measured >= ~14 s serial (pytest --durations) carry the `slow`
# marker: end-to-end CLI/mesh runs whose fast siblings keep gate
# coverage. Default gate: `make test` (-m "not slow"); full suite:
# `make test-all`. Parameterized entries match per-param.
_SLOW = {
    "test_parallel.py::test_mesh_scanner_full_cascade_vs_oracle",
    "test_parallel.py::test_mesh_search_pipeline_matches_single_device",
    "test_parallel.py::test_multihost_two_process_smoke",
    "test_parallel.py::test_mesh_scan_many_stacked",
    "test_driver_entry.py::test_bench_quick_emits_valid_json",
    "test_pipeline.py::test_m_bucketing_parity",
    "test_msv_xla.py::test_full_profile_sweep",
    "test_backward_posterior.py::test_cli_search_domains",
    "test_bench_smoke.py::test_bench_quick_emits_json_line",
    "test_cli_and_stats.py::test_cli_mesh_scan",
    "test_pipeline.py::test_profile_cache_id_reuse_regression",
    "test_cli_and_stats.py::test_cli_scan_stream_p7_stages",
    "test_cli_and_stats.py::test_cli_search_stream_matches_whole",
    "test_build.py::test_emit_align_build_scan_loop",
    "test_search_pipeline.py::test_search_bucketed_fast_prefilter",
    "test_pipeline.py::test_scan_many_bucketed_matches_per_profile",
    "test_pipeline.py::test_fast_msv_cascade_same_hits",
    "test_search_pipeline.py::test_fast_cascade_identical_hits",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        rel = item.nodeid.split("tests/")[-1]
        if rel in _SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a CUDA card (decided when the
    test runs, never at collection: every xdist worker collects alike)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device: HFV_TESTS_ON_GPU=1 pytest -m gpu")


REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA_DIR = REPO_ROOT / "data"
PROFILE_DIR = DATA_DIR / "profile_HMMs"
FASTA_DIR = DATA_DIR / "FASTA_files"


@pytest.fixture(scope="session")
def profile_dir() -> pathlib.Path:
    return PROFILE_DIR


@pytest.fixture(scope="session")
def fasta_dir() -> pathlib.Path:
    return FASTA_DIR


@pytest.fixture(scope="session")
def all_profile_paths() -> list[pathlib.Path]:
    return sorted(PROFILE_DIR.glob("*.hmm"), key=lambda p: int(p.stem))


def consensus_tokens(hmm, repeats: int = 1, spacer: int = 0, seed: int = 0):
    """Token sequence matching the profile's consensus (argmax match
    emission per node) — a guaranteed strong hit; ``repeats`` > 1 with a
    random spacer builds multi-domain test sequences."""
    import numpy as np

    core = np.argmax(hmm.match_emissions[1:], axis=1).astype(np.int32)
    rng = np.random.default_rng(seed)
    parts = []
    for r in range(repeats):
        if r:
            parts.append(rng.integers(0, 20, size=spacer, dtype=np.int32))
        parts.append(core)
    return np.concatenate(parts) if parts else core
