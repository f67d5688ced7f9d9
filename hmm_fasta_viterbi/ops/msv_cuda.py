"""MSV scan on NVIDIA Hopper: the CUDA kernel in native/msv_cuda.cu,
called through ``jax.ffi``.

One warp scores one (profile, sequence) pair across all of its residues,
with the DP row held in registers: lane ``l`` owns the match states
``[l*Q, (l+1)*Q)``. This module holds what surrounds the kernel and runs
anywhere: the states-per-lane choice (:func:`states_per_lane`), the
lane-interleaved emission table (:func:`pack_table`), and a plain-JAX
reading of exactly the kernel's operands (:func:`msv_packed_reference`)
that the CPU tests hold to the NumPy oracle. The kernel itself runs only
on a CUDA device; the library is built from the committed source into
``native/build/`` on first use (:func:`build`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import pathlib
import subprocess
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from .recurrence import MSVParams, block_scan, final_score, init_carry

logger = logging.getLogger(__name__)

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
SOURCE = _NATIVE_DIR / "msv_cuda.cu"
BUILD_DIR = _NATIVE_DIR / "build"
TARGET_NAME = "hmm_msv_scan"

WARP = 32
# states per lane the library is compiled for: multiples of 4 (float4
# table loads) up to 80, i.e. profiles of up to 2560 match states; the
# 20-row table then fills 200 KB of the 227 KB a block may hold
Q_STEP = 4
Q_MAX = 80
# the kernel reads residues 16 at a time
L_MULTIPLE = 16


def states_per_lane(num_states: int) -> int:
    """Q, the match states each of the 32 lanes owns: a multiple of 4.
    The compiled kernels take Q <= Q_MAX; a wider profile runs on XLA."""
    q = -(-max(num_states, 1) // WARP)
    return -(-q // Q_STEP) * Q_STEP


def pack_table(scores_real: np.ndarray, q: int) -> np.ndarray:
    """[20, Mr] emission scores -> [20, 32*q] f32 in the kernel's
    lane-interleaved order: element [a, (k4*32 + lane)*4 + r] is the score
    of residue a at state lane*q + 4*k4 + r. Pad states are -inf."""
    alphabet, mr = scores_real.shape
    assert mr <= WARP * q and q % Q_STEP == 0
    padded = np.full((alphabet, WARP * q), -np.inf, dtype=np.float32)
    padded[:, :mr] = scores_real
    by_lane = padded.reshape(alphabet, WARP, q // 4, 4)  # [a, lane, k4, r]
    return np.ascontiguousarray(by_lane.transpose(0, 2, 1, 3)).reshape(
        alphabet, WARP * q
    )


def unpack_table(table: jax.Array) -> jax.Array:
    """Inverse of :func:`pack_table` on a [P, 20, 32*q] stack ->
    [P, 20, 32*q] in plain state order."""
    num_p, alphabet, width = table.shape
    q = width // WARP
    t = table.reshape(num_p, alphabet, q // 4, WARP, 4)
    return t.transpose(0, 1, 3, 2, 4).reshape(num_p, alphabet, width)


@jax.jit
def msv_packed_reference(table, tokens, lengths, tr_rows, consts):
    """Plain-JAX MSV over the kernel's own operands (same signature and
    result as :func:`msv_packed`): the reference the kernel is compared
    with, and the stand-in that lets the CPU tests reach the wrapper."""
    plain = unpack_table(table)
    batch = tokens.shape[0]

    def one(scores, c):
        params = MSVParams(
            scores, c[0], c[1], c[2], lengths, tr_rows[0], tr_rows[1]
        )
        carry = init_carry(params, batch, scores.shape[1])
        carry = block_scan(params, carry, tokens, start_index=0)
        return final_score(params, carry)

    return jax.lax.map(lambda args: one(*args), (plain, consts))


def msv_packed(table, tokens, lengths, tr_rows, consts) -> jax.Array:
    """The CUDA kernel: scores [P, B] of every profile of ``table``
    ([P, 20, 32*q], :func:`pack_table`) against every row of ``tokens``
    ([B, L] int8, L % 16 == 0)."""
    register()
    num_p = table.shape[0]
    batch = tokens.shape[0]
    return jax.ffi.ffi_call(
        TARGET_NAME, jax.ShapeDtypeStruct((num_p, batch), jnp.float32)
    )(table, tokens, lengths, tr_rows, consts)


# -- build and registration ---------------------------------------------

_lock = threading.Lock()
_registered = False
build_seconds: float | None = None  # set-up time of the last build


def library_path() -> pathlib.Path:
    """Build output named by the source's hash: an edited source never
    loads a stale library."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmsv_cuda-{digest}.so"


def _nvcc() -> str:
    """The CUDA toolkit's nvcc at its standard prefix, else from PATH."""
    nvcc = pathlib.Path("/usr/local/cuda/bin/nvcc")
    return str(nvcc) if nvcc.exists() else "nvcc"


def build() -> pathlib.Path:
    """Compile native/msv_cuda.cu for sm_90a unless the library for this
    source already exists. Raises with nvcc's output on failure."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(".so.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", jax.ffi.include_dir(), "-o", str(tmp), str(SOURCE),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    tmp.replace(lib)
    build_seconds = time.perf_counter() - t0
    lib.with_suffix(".ptxas.log").write_text(proc.stderr)
    logger.info("built %s in %.1f s", lib.name, build_seconds)
    return lib


def register() -> None:
    """Build (if needed), load and register the FFI target, once."""
    global _registered
    if _registered:
        return
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(build()))
        jax.ffi.register_ffi_target(
            TARGET_NAME, jax.ffi.pycapsule(lib.HmmMsvScan), platform="CUDA"
        )
        _registered = True


@functools.lru_cache(maxsize=None)
def ptxas_report() -> str:
    """Register and spill lines nvcc printed for each kernel instance."""
    log = library_path().with_suffix(".ptxas.log")
    if not log.exists():
        return ""
    keep = [
        ln.strip() for ln in log.read_text().splitlines()
        if "registers" in ln or "spill" in ln
    ]
    return "\n".join(keep)
