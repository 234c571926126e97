// Single-step decode attention for Hopper (sm_90a), over a paged pool
// (plain f32 / bf16, or int8 pages) or over a dense slot cache: the kernel
// templates behind paged_decode.cu, paged_decode_quant.cu and
// dense_decode.cu.
//
// Replaces the Pallas kernels `_paged_attn_kernel` behind
// `paged_decode_gqa_attention`, `_paged_attn_kernel_quant` behind
// `paged_decode_gqa_attention_quant`, and `_decode_attn_kernel` behind
// `decode_gqa_attention` (the dense one; swarmdb_tpu/ops/attention_pallas.py).
// One decode query per slot attends the slot's positions < length (= its
// position + 1: the step's own token was written into the cache before the
// call), read in place -- through the slot's page-table row, or straight
// from the slot's lane -- under an fp32 online softmax; with a window,
// positions at or below length - 1 - window are masked. A slot of length 0
// outputs zeros (the Pallas dense kernel returns the lane's mean value row
// there; no caller passes length 0).
//
// Work split and bound: as the two-segment kernel (paged_decode_chunked.cuh)
// without its chunk segment. One block per (KV head h, slot b) holds the G
// query heads of h and walks the live positions in tiles of KT; int8 pages
// are widened and scaled per tile as they are loaded. Bytes bound it on the
// H100: the live K/V rows of every slot (1 byte per element for int8 plus
// a scale per page and head) dominate what the call must move. The page
// walk and the lane walk differ only in the row accessor (PagedRows /
// DenseRows in attn_common.cuh), so both run the same body; the loop ends
// at the cache's coverage (maxp * ps, or S).
#pragma once

#include "attn_common.cuh"

namespace swarm {

constexpr int kDecodeKT = 16;  // positions per tile (one serving page)

template <int D> constexpr int decode_tpr() { return (D / 4) < 32 ? D / 4 : 32; }

// The body shared by the paged and the dense kernel; Cache is PagedCache
// or DenseCache. Ks / Vs are the block's two [KT][D] shared tiles.
template <typename TP, int D, int TPR, int KT, class Cache>
__device__ __forceinline__ void decode_block(
    float* Ks, float* Vs, int q_code, const void* q, const Cache& kc,
    const Cache& vc, const int* lengths, int window, float scale, void* out,
    int Hq, int Hkv) {
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

  int tile0 = 0;
  if (window > 0) {
    const int lo = qpos - window + 1;
    if (lo > 0) tile0 = lo / KT;
  }
  // live positions [lo, length), never past the cache's coverage
  fold_pages<TP, D, TPR, KT>(
      st, Ks, Vs, kc.rows(b, h), vc.rows(b, h), tile0,
      min(length, kc.coverage()), sub,
      [&](int pos) { return live && (window <= 0 || pos > qpos - window); },
      scale, tid, nthreads);

  if (live) st.store(q_code, out, ((int64_t)b * Hq + h * G + row) * D, sub);
}

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
  decode_block<TP, D, TPR, KT>(
      Ks, Ks + KT * D, q_code, q,
      PagedCache<TP, D>{kp, ks, table, P, ps, Hkv, maxp},
      PagedCache<TP, D>{vp, vs, table, P, ps, Hkv, maxp}, lengths, window,
      scale, out, Hq, Hkv);
}

template <typename TP, int D, int TPR, int KT>
__global__ void dense_decode_kernel(
    int q_code,
    const void* __restrict__ q,       // [B, Hq, D]
    const TP* __restrict__ lk,        // [B, S, Hkv, D]
    const TP* __restrict__ lv,
    const int* __restrict__ lengths,  // [B]
    int window, float scale, void* __restrict__ out,  // [B, Hq, D]
    int Hq, int Hkv, int S) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  decode_block<TP, D, TPR, KT>(Ks, Ks + KT * D, q_code, q,
                               DenseCache<TP, D>{lk, S, Hkv},
                               DenseCache<TP, D>{lv, S, Hkv}, lengths,
                               window, scale, out, Hq, Hkv);
}

// Block shape of both kernels: the G query rows of TPR lanes each, rounded
// up to whole warps, and the two shared tiles.
template <int D>
cudaError_t decode_shape(int Hq, int Hkv, int* threads, size_t* smem) {
  *threads = ((Hq / Hkv * decode_tpr<D>() + 31) / 32) * 32;
  *smem = 2 * kDecodeKT * D * sizeof(float);
  return *threads > 1024 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename TP, int D>
cudaError_t launch_paged_decode(int q_code, const void* q, const void* kp,
                                const float* ks, const void* vp,
                                const float* vs, const int* table,
                                const int* lengths, int window, float scale,
                                void* out, int B, int Hq, int Hkv, int P,
                                int ps, int maxp, cudaStream_t stream) {
  int threads;
  size_t smem;
  const cudaError_t shape = decode_shape<D>(Hq, Hkv, &threads, &smem);
  if (shape != cudaSuccess) return shape;
  dim3 grid(Hkv, B);
  paged_decode_kernel<TP, D, decode_tpr<D>(), kDecodeKT>
      <<<grid, threads, smem, stream>>>(
          q_code, q, static_cast<const TP*>(kp), ks,
          static_cast<const TP*>(vp), vs, table, lengths, window, scale, out,
          Hq, Hkv, P, ps, maxp);
  return cudaGetLastError();
}

template <typename TP, int D>
cudaError_t launch_dense_decode(int q_code, const void* q, const void* lk,
                                const void* lv, const int* lengths,
                                int window, float scale, void* out, int B,
                                int Hq, int Hkv, int S, cudaStream_t stream) {
  int threads;
  size_t smem;
  const cudaError_t shape = decode_shape<D>(Hq, Hkv, &threads, &smem);
  if (shape != cudaSuccess) return shape;
  dim3 grid(Hkv, B);
  dense_decode_kernel<TP, D, decode_tpr<D>(), kDecodeKT>
      <<<grid, threads, smem, stream>>>(
          q_code, q, static_cast<const TP*>(lk), static_cast<const TP*>(lv),
          lengths, window, scale, out, Hq, Hkv, S);
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

template <typename TP>
cudaError_t dense_decode_d(int D, int q_code, const void* q, const void* lk,
                           const void* lv, const int* lengths, int window,
                           float scale, void* out, int B, int Hq, int Hkv,
                           int S, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return cudaErrorInvalidValue;
#define SWARM_CASE(DV)                                                   \
  case DV:                                                               \
    return launch_dense_decode<TP, DV>(q_code, q, lk, lv, lengths,       \
                                       window, scale, out, B, Hq, Hkv, S, \
                                       stream);
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
