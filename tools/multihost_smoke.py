"""Multi-host smoke: 2 processes x 4 virtual CPU devices, one SPMD scan.

Validates the multi-host story end to end on one machine: each process
initializes jax.distributed, builds the global (db, sp=1) mesh over all
8 devices, places its process-local batch shard with
``jax.make_array_from_process_local_data``, runs the SAME jitted scan
program, and process 0 checks the gathered scores against the NumPy
oracle.

Run (the test harness spawns both):
    python tools/multihost_smoke.py <process_id> <num_processes> <port>
"""

from __future__ import annotations

import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = int(sys.argv[3])

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hmm_fasta_viterbi import MSVProfile, msv_oracle_batch, parse_hmm
    from hmm_fasta_viterbi.ops.xla_scan import msv_scan
    from hmm_fasta_viterbi.models.msv import length_transitions
    from hmm_fasta_viterbi.parallel.mesh import make_scan_mesh, DB_AXIS

    assert jax.process_count() == num_processes
    assert len(jax.devices()) == 4 * num_processes, jax.devices()

    mesh = make_scan_mesh(db=len(jax.devices()), sp=1)
    sharding = NamedSharding(mesh, P(DB_AXIS, None))

    # deterministic global batch; every process generates the same and
    # donates only its local rows
    profile = MSVProfile.from_profile(
        parse_hmm(REPO / "data" / "profile_HMMs" / "100.hmm")
    )
    rng = np.random.default_rng(0)
    batch, seq_len = 16, 120
    tokens = rng.integers(0, 20, size=(batch, seq_len)).astype(np.int32)
    lengths = np.full(batch, seq_len, dtype=np.int32)
    lengths[1] = 37
    tr_loop, tr_move = length_transitions(lengths)

    rows = batch // num_processes
    lo = process_id * rows
    global_tokens = jax.make_array_from_process_local_data(
        sharding, tokens[lo : lo + rows], (batch, seq_len)
    )
    s1 = NamedSharding(mesh, P(DB_AXIS))
    local = slice(lo, lo + rows)
    g_lengths = jax.make_array_from_process_local_data(s1, lengths[local], (batch,))
    g_loop = jax.make_array_from_process_local_data(s1, tr_loop[local], (batch,))
    g_move = jax.make_array_from_process_local_data(s1, tr_move[local], (batch,))

    fn = jax.jit(msv_scan, out_shardings=NamedSharding(mesh, P()))
    out = fn(
        jnp.asarray(profile.scores_real),
        jnp.float32(profile.tr_B_Mk),
        jnp.float32(profile.tr_E_C),
        jnp.float32(profile.tr_E_J),
        global_tokens,
        g_lengths,
        g_loop,
        g_move,
    )
    got = np.asarray(jax.device_get(out))

    want = msv_oracle_batch(profile, tokens, lengths)
    err = np.abs(got - want).max()
    print(f"[proc {process_id}] maxerr {err:.3e}", flush=True)
    assert err < 1e-4, (got, want)
    print(f"[proc {process_id}] MULTIHOST_OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
