// MSV max-plus scan for NVIDIA Hopper, called from JAX through the FFI.
//
// One warp scores one (profile, sequence) pair over ALL of its residues;
// the DP row never leaves registers. Lane `l` owns the contiguous match
// states [l*Q, (l+1)*Q) of the row (Farrar's striped split), so the j-1
// shift is register-local except at the lane boundary, where it is one
// __shfl_up. The E-state max is a per-lane max plus a 5-step butterfly.
// The specials J, C, N, B are warp-uniform: every lane keeps a copy.
//
// Emission scores are exact f32 lookups from a shared-memory copy of the
// profile's [20, 32*Q] table, stored "lane-interleaved" by the host
// (ops/msv_cuda.py pack_table): element [a][k4][lane][r] holds the score
// of residue a at state lane*Q + 4*k4 + r, so the float4 loads of a warp
// at fixed k4 are contiguous and free of bank conflicts. Pad states hold
// -inf and stay -inf.
//
// Every operation is the oracle's (ops/reference.py msv_oracle): f32
// adds and maxes in the same order, so scores agree bit for bit.
//
// Inputs  table   f32 [P, 20, 32*Q]   lane-interleaved emission scores
//         tokens  s8  [B, L]          residues 0..19, L % 16 == 0
//         lengths s32 [B]
//         tr_rows f32 [2, B]          tr_loop; tr_move (host-exact)
//         consts  f32 [P, 3]          tr_B_Mk, tr_E_C, tr_E_J
// Output  scores  f32 [P, B]          C_final + tr_move

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAlphabet = 20;

template <int Q, int W>
__global__ void __launch_bounds__(W * 32)
    msv_kernel(const float* __restrict__ table,
               const int8_t* __restrict__ tokens,
               const int32_t* __restrict__ lengths,
               const float* __restrict__ tr_rows,
               const float* __restrict__ consts, float* __restrict__ out,
               int num_seqs, int seq_stride) {
  static_assert(Q % 4 == 0, "Q must be a multiple of 4");
  constexpr int Q4 = Q / 4;
  constexpr int kTab4 = kAlphabet * Q4 * 32;  // float4s per profile

  extern __shared__ float4 tab[];
  const int p = blockIdx.y;
  const float4* src = reinterpret_cast<const float4*>(table) + (size_t)p * kTab4;
  for (int i = threadIdx.x; i < kTab4; i += W * 32) tab[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * W + (threadIdx.x >> 5);
  if (b >= num_seqs) return;  // whole warp leaves; no barrier follows

  const int len = lengths[b];
  const float tr_loop = tr_rows[b];
  const float tr_move = tr_rows[num_seqs + b];
  const float tr_b_mk = consts[3 * p];
  const float tr_e_c = consts[3 * p + 1];
  const float tr_e_j = consts[3 * p + 2];
  const float neg_inf = -INFINITY;

  float m[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) m[k] = neg_inf;
  float st_j = neg_inf, st_c = neg_inf, st_n = 0.0f, st_b = tr_move;

  const float4* tab_lane = tab + lane;
  const uint4* tok16 =
      reinterpret_cast<const uint4*>(tokens + (size_t)b * seq_stride);

  uint4 word = len > 0 ? __ldg(tok16) : make_uint4(0, 0, 0, 0);
  for (int t0 = 0; t0 < len; t0 += 16) {
    // prefetch the next 16 residues while these 16 are scored
    const uint4 next = t0 + 16 < len ? __ldg(tok16 + (t0 >> 4) + 1) : word;
    const int steps = min(16, len - t0);
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      if (s >= steps) break;
      const uint32_t w32 = s < 4 ? word.x : s < 8 ? word.y : s < 12 ? word.z : word.w;
      const int tok = min((int)((w32 >> (8 * (s & 3))) & 0xffu), kAlphabet - 1);
      const float4* row = tab_lane + tok * (Q4 * 32);
      const float bsc = st_b + tr_b_mk;
      // state lane*Q - 1 lives in the previous lane; lane 0's left
      // neighbour is the dummy M0, which is -inf
      float prev = __shfl_up_sync(kFull, m[Q - 1], 1);
      if (lane == 0) prev = neg_inf;
      float e0 = neg_inf, e1 = neg_inf, e2 = neg_inf, e3 = neg_inf;
#pragma unroll
      for (int k4 = Q4 - 1; k4 >= 0; --k4) {
        const float4 em = row[k4 * 32];
        const float left = k4 > 0 ? m[k4 > 0 ? 4 * k4 - 1 : 0] : prev;
        const float n3 = em.w + fmaxf(m[4 * k4 + 2], bsc);
        const float n2 = em.z + fmaxf(m[4 * k4 + 1], bsc);
        const float n1 = em.y + fmaxf(m[4 * k4], bsc);
        const float n0 = em.x + fmaxf(left, bsc);
        m[4 * k4 + 3] = n3;
        m[4 * k4 + 2] = n2;
        m[4 * k4 + 1] = n1;
        m[4 * k4] = n0;
        e3 = fmaxf(e3, n3);
        e2 = fmaxf(e2, n2);
        e1 = fmaxf(e1, n1);
        e0 = fmaxf(e0, n0);
      }
      float e = fmaxf(fmaxf(e0, e1), fmaxf(e2, e3));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        e = fmaxf(e, __shfl_xor_sync(kFull, e, off));
      st_j = fmaxf(st_j + tr_loop, e + tr_e_j);
      st_c = fmaxf(st_c + tr_loop, e + tr_e_c);
      st_n = st_n + tr_loop;
      st_b = fmaxf(st_n + tr_move, st_j + tr_move);
    }
    word = next;
  }
  if (lane == 0) out[(size_t)p * num_seqs + b] = st_c + tr_move;
}

template <int Q, int W>
ffi::Error launch(cudaStream_t stream, const float* table,
                  const int8_t* tokens, const int32_t* lengths,
                  const float* tr_rows, const float* consts, float* out,
                  int num_profiles, int num_seqs, int seq_stride) {
  const size_t smem = sizeof(float) * kAlphabet * 32 * Q;
  // per device and cheap: set on every call so each card of a mesh has it
  cudaError_t err = cudaFuncSetAttribute(
      msv_kernel<Q, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("msv: smem attribute: ") +
                                cudaGetErrorString(err));
  if (num_seqs == 0 || num_profiles == 0) return ffi::Error::Success();
  const dim3 grid((num_seqs + W - 1) / W, num_profiles);
  msv_kernel<Q, W><<<grid, W * 32, smem, stream>>>(
      table, tokens, lengths, tr_rows, consts, out, num_seqs, seq_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("msv: launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error msv_scan_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> table,
                         ffi::Buffer<ffi::S8> tokens,
                         ffi::Buffer<ffi::S32> lengths,
                         ffi::Buffer<ffi::F32> tr_rows,
                         ffi::Buffer<ffi::F32> consts,
                         ffi::ResultBuffer<ffi::F32> scores) {
  const auto td = table.dimensions();
  const auto kd = tokens.dimensions();
  if (td.size() != 3 || td[1] != kAlphabet || td[2] % 128 != 0)
    return ffi::Error::InvalidArgument("msv: table must be [P, 20, 32*Q], Q % 4 == 0");
  if (kd.size() != 2 || kd[1] % 16 != 0)
    return ffi::Error::InvalidArgument("msv: tokens must be [B, L], L % 16 == 0");
  const int num_profiles = (int)td[0];
  const int q = (int)(td[2] / 32);
  const int num_seqs = (int)kd[0];
  const int seq_stride = (int)kd[1];
  if (lengths.element_count() != (size_t)num_seqs ||
      tr_rows.element_count() != 2 * (size_t)num_seqs ||
      consts.element_count() != 3 * (size_t)num_profiles ||
      scores->element_count() != (size_t)num_profiles * num_seqs)
    return ffi::Error::InvalidArgument("msv: operand shapes disagree");

  const float* t = table.typed_data();
  const int8_t* k = tokens.typed_data();
  const int32_t* n = lengths.typed_data();
  const float* r = tr_rows.typed_data();
  const float* c = consts.typed_data();
  float* o = scores->typed_data();
#define MSV_CASE(QQ, WW) \
  case QQ:               \
    return launch<QQ, WW>(stream, t, k, n, r, c, o, num_profiles, num_seqs, seq_stride);
  switch (q) {
    MSV_CASE(4, 16)
    MSV_CASE(8, 16)
    MSV_CASE(12, 16)
    MSV_CASE(16, 16)
    MSV_CASE(20, 16)
    MSV_CASE(24, 16)
    MSV_CASE(28, 16)
    MSV_CASE(32, 16)
    MSV_CASE(36, 16)
    MSV_CASE(40, 16)
    MSV_CASE(44, 16)
    MSV_CASE(48, 16)
    MSV_CASE(52, 16)
    MSV_CASE(56, 16)
    MSV_CASE(60, 16)
    MSV_CASE(64, 16)
    MSV_CASE(68, 8)
    MSV_CASE(72, 8)
    MSV_CASE(76, 8)
    MSV_CASE(80, 8)
    default:
      return ffi::Error::InvalidArgument("msv: unsupported states per lane");
  }
#undef MSV_CASE
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(HmmMsvScan, msv_scan_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());
