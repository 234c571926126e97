// Single-step paged decode attention for Hopper (sm_90a), over plain
// (f32 / bf16) or int8 pages: the kernel template behind paged_decode.cu
// and paged_decode_quant.cu.
//
// Replaces the Pallas kernels `_paged_attn_kernel` behind
// `paged_decode_gqa_attention` and `_paged_attn_kernel_quant` behind
// `paged_decode_gqa_attention_quant` (swarmdb_tpu/ops/attention_pallas.py).
// One decode query per slot attends the slot's pages at positions
// < length (= its position + 1: the step's own token was written into its
// page before the call), read in place through the slot's page-table row,
// under an fp32 online softmax; with a window, positions at or below
// length - 1 - window are masked. A slot of length 0 outputs zeros.
//
// Work split and bound: as the two-segment kernel (paged_decode_chunked.cuh)
// without its chunk segment. One block per (KV head h, slot b) holds the G
// query heads of h and walks the live pages in tiles of KT positions; int8
// pages are widened and scaled per tile as they are loaded. Bytes bound it
// on the H100: the live K/V rows of every slot (1 byte per element for
// int8 plus a scale per page and head) dominate what the call must move.
#pragma once

#include "attn_common.cuh"

namespace swarm {

template <typename TP, int D, int TPR, int KT>
__global__ void paged_decode_kernel(
    int q_code,
    const void* __restrict__ q,      // [B, Hq, D]
    const TP* __restrict__ kp,       // [P, ps, Hkv, D]
    const float* __restrict__ ks,    // [P, Hkv] (int8 pages only)
    const TP* __restrict__ vp,
    const float* __restrict__ vs,
    const int* __restrict__ table,    // [B, maxp]
    const int* __restrict__ lengths,  // [B]
    int window, float scale, void* __restrict__ out,  // [B, Hq, D]
    int Hq, int Hkv, int P, int ps, int maxp) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + KT * D;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const bool live = row < G;
  const int length = lengths[b];
  const int qpos = length - 1;

  RowState<D, TPR> st;
  st.init(q_code, q, ((int64_t)b * Hq + h * G + (live ? row : 0)) * D, live,
          sub);

  const int* trow = table + (int64_t)b * maxp;
  const PagedRows<TP, D> kr{kp, ks, trow, P, ps, Hkv, maxp, h};
  const PagedRows<TP, D> vr{vp, vs, trow, P, ps, Hkv, maxp, h};
  int tile0 = 0;
  if (window > 0) {
    const int lo = qpos - window + 1;
    if (lo > 0) tile0 = lo / KT;
  }
  // live positions [lo, length), never past the table's coverage
  fold_pages<TP, D, TPR, KT>(
      st, Ks, Vs, kr, vr, tile0, min(length, maxp * ps), sub,
      [&](int pos) { return live && (window <= 0 || pos > qpos - window); },
      scale, tid, nthreads);

  if (live) st.store(q_code, out, ((int64_t)b * Hq + h * G + row) * D, sub);
}

template <typename TP, int D>
cudaError_t launch_paged_decode(int q_code, const void* q, const void* kp,
                                const float* ks, const void* vp,
                                const float* vs, const int* table,
                                const int* lengths, int window, float scale,
                                void* out, int B, int Hq, int Hkv, int P,
                                int ps, int maxp, cudaStream_t stream) {
  constexpr int TPR = (D / 4) < 32 ? (D / 4) : 32;
  constexpr int KT = 16;
  const int G = Hq / Hkv;
  int threads = G * TPR;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 1024) return cudaErrorInvalidConfiguration;
  const size_t smem = 2 * KT * D * sizeof(float);
  dim3 grid(Hkv, B);
  paged_decode_kernel<TP, D, TPR, KT><<<grid, threads, smem, stream>>>(
      q_code, q, static_cast<const TP*>(kp), ks, static_cast<const TP*>(vp),
      vs, table, lengths, window, scale, out, Hq, Hkv, P, ps, maxp);
  return cudaGetLastError();
}

// One instance per head dim the wrappers accept (ops/attention_cuda.py).
template <typename TP>
cudaError_t paged_decode_d(int D, int q_code, const void* q, const void* kp,
                           const float* ks, const void* vp, const float* vs,
                           const int* table, const int* lengths, int window,
                           float scale, void* out, int B, int Hq, int Hkv,
                           int P, int ps, int maxp, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
#define SWARM_CASE(DV)                                                      \
  case DV:                                                                  \
    return launch_paged_decode<TP, DV>(q_code, q, kp, ks, vp, vs, table,    \
                                       lengths, window, scale, out, B, Hq,  \
                                       Hkv, P, ps, maxp, stream);
  switch (D) {
    SWARM_CASE(16)
    SWARM_CASE(32)
    SWARM_CASE(64)
    SWARM_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef SWARM_CASE
}

}  // namespace swarm
