// Two-segment decode attention for Hopper (sm_90a), over a paged pool
// (plain f32 / bf16, or int8 pages) or over a dense slot cache: the kernel
// templates behind paged_decode_chunked.cu, paged_decode_chunked_quant.cu
// and dense_decode_chunked.cu.
//
// Replaces the Pallas kernels `_paged_chunk_attn_kernel` behind
// `paged_decode_gqa_attention_chunked`, `_paged_chunk_attn_kernel_quant`
// behind `paged_decode_gqa_attention_chunked_quant`, and
// `_dense_chunk_attn_kernel` behind `decode_gqa_attention_chunked`
// (swarmdb_tpu/ops/attention_pallas.py). One decode query per slot attends
// (a) the frozen cache at positions < start = pos - step, read in place --
// through the slot's page-table row, or straight from the slot's lane of a
// dense [B, S, Hkv, D] cache -- and (b) the chunk buffer entries
// idx <= step, under one fp32 online softmax; with a window, keys at or
// below pos - window are masked (chunk entry `step` is always live, entry 0
// may not be). int8 pages are widened and scaled per tile as they are
// loaded; the chunk buffer (never cache-resident) stays in its own float
// type. A dense lane holds a bucketed prefill's padding garbage at
// positions >= start: the walk ends at start, so it is never read.
//
// Work split: one block per (KV head h, slot b). The block owns the G = Hq /
// Hkv query heads of h; each query row is held by TPR lanes (TPR * 4 dims
// each, see attn_common.cuh). The block walks the slot's live positions in
// tiles of KT (one 16-row page at the serving page size), loading each K/V
// tile of head h with 16-byte vector loads into shared memory, then the
// chunk buffer, and writes acc / max(l, 1e-30). The page walk and the lane
// walk differ only in the row accessor (PagedRows / DenseRows); the frozen
// loop ends at min(start, coverage), coverage being maxp * ps or S.
//
// What bounds it on the H100: bytes. Each call must read q, the live K/V
// rows of every slot for its head (2 bytes per element in bf16, 1 in int8
// plus a 4-byte scale per page and head) and the chunk rows <= step, and
// write the output; the arithmetic is a few FLOP per byte read. Reading
// only the live rows (the loop ends at the slot's start, and a window
// skips whole tiles below it) keeps the traffic at what the data needs, not
// at the whole table or lane.
//
// Known limit of this first version: the grid is Hkv x B blocks (64 at the
// serving shape of 8 slots x 8 KV heads), which fills about half of the
// 132 SMs, and each block loads a tile before it computes on it (no
// double buffering). Splitting the live range over several blocks per
// (b, h) with a second combine pass (flash-decoding) is the next step.
#pragma once

#include "paged_decode.cuh"

namespace swarm {

// The body shared by the paged and the dense kernel; Cache is PagedCache
// or DenseCache. Ks / Vs are the block's two [KT][D] shared tiles.
template <typename TP, int D, int TPR, int KT, class Cache>
__device__ __forceinline__ void decode_chunked_block(
    float* Ks, float* Vs, int q_code, int c_code, const void* q,
    const Cache& kc, const Cache& vc, const void* ck, const void* cv,
    const int* starts, int step, int window, float scale, void* out, int Hq,
    int Hkv, int Kc) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const bool live = row < G;
  const int start = starts[b];
  const int qpos = start + step;

  RowState<D, TPR> st;
  st.init(q_code, q, ((int64_t)b * Hq + h * G + (live ? row : 0)) * D, live,
          sub);

  // frozen segment: positions [lo, start), never past the cache's coverage
  int tile0 = 0;
  if (window > 0) {
    const int lo = qpos - window + 1;
    if (lo > 0) tile0 = lo / KT;
  }
  fold_pages<TP, D, TPR, KT>(
      st, Ks, Vs, kc.rows(b, h), vc.rows(b, h), tile0,
      min(start, kc.coverage()), sub,
      [&](int pos) { return live && (window <= 0 || pos > qpos - window); },
      scale, tid, nthreads);

  // chunk segment: entries [0, step]
  const int n_chunk = min(Kc, step + 1);
  for (int c0 = 0; c0 < n_chunk; c0 += KT) {
    const int nrows = min(KT, n_chunk - c0);
    auto crow = [&](int r) {
      return (((int64_t)b * Kc + c0 + r) * Hkv + h) * D;
    };
    __syncthreads();
    load_rows<D>(c_code, Ks, nrows, ck, crow, tid, nthreads);
    load_rows<D>(c_code, Vs, nrows, cv, crow, tid, nthreads);
    __syncthreads();
    fold_tile<D, TPR, KT>(
        st, Ks, Vs, nrows, sub,
        [&](int t) {
          return live && (window <= 0 || start + c0 + t > qpos - window);
        },
        scale);
  }

  if (live) st.store(q_code, out, ((int64_t)b * Hq + h * G + row) * D, sub);
}

template <typename TP, int D, int TPR, int KT>
__global__ void paged_decode_chunked_kernel(
    int q_code, int c_code,
    const void* __restrict__ q,     // [B, Hq, D]
    const TP* __restrict__ kp,      // [P, ps, Hkv, D]
    const float* __restrict__ ks,   // [P, Hkv] (int8 pages only)
    const TP* __restrict__ vp,
    const float* __restrict__ vs,
    const int* __restrict__ table,  // [B, maxp]
    const void* __restrict__ ck,    // [B, Kc, Hkv, D]
    const void* __restrict__ cv,
    const int* __restrict__ starts,  // [B]
    int step, int window, float scale, void* __restrict__ out,  // [B, Hq, D]
    int Hq, int Hkv, int P, int ps, int maxp, int Kc) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  decode_chunked_block<TP, D, TPR, KT>(
      Ks, Ks + KT * D, q_code, c_code, q,
      PagedCache<TP, D>{kp, ks, table, P, ps, Hkv, maxp},
      PagedCache<TP, D>{vp, vs, table, P, ps, Hkv, maxp}, ck, cv, starts,
      step, window, scale, out, Hq, Hkv, Kc);
}

template <typename TP, int D, int TPR, int KT>
__global__ void dense_decode_chunked_kernel(
    int q_code, int c_code,
    const void* __restrict__ q,      // [B, Hq, D]
    const TP* __restrict__ lk,       // [B, S, Hkv, D]
    const TP* __restrict__ lv,
    const void* __restrict__ ck,     // [B, Kc, Hkv, D]
    const void* __restrict__ cv,
    const int* __restrict__ starts,  // [B]
    int step, int window, float scale, void* __restrict__ out,  // [B, Hq, D]
    int Hq, int Hkv, int S, int Kc) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  decode_chunked_block<TP, D, TPR, KT>(
      Ks, Ks + KT * D, q_code, c_code, q, DenseCache<TP, D>{lk, S, Hkv},
      DenseCache<TP, D>{lv, S, Hkv}, ck, cv, starts, step, window, scale,
      out, Hq, Hkv, Kc);
}

template <typename TP, int D>
cudaError_t launch_paged_decode_chunked(
    int q_code, int c_code, const void* q, const void* kp, const float* ks,
    const void* vp, const float* vs, const int* table, const void* ck,
    const void* cv, const int* starts, int step, int window, float scale,
    void* out, int B, int Hq, int Hkv, int P, int ps, int maxp, int Kc,
    cudaStream_t stream) {
  int threads;
  size_t smem;
  const cudaError_t shape = decode_shape<D>(Hq, Hkv, &threads, &smem);
  if (shape != cudaSuccess) return shape;
  dim3 grid(Hkv, B);
  paged_decode_chunked_kernel<TP, D, decode_tpr<D>(), kDecodeKT>
      <<<grid, threads, smem, stream>>>(
          q_code, c_code, q, static_cast<const TP*>(kp), ks,
          static_cast<const TP*>(vp), vs, table, ck, cv, starts, step,
          window, scale, out, Hq, Hkv, P, ps, maxp, Kc);
  return cudaGetLastError();
}

template <typename TP, int D>
cudaError_t launch_dense_decode_chunked(
    int q_code, int c_code, const void* q, const void* lk, const void* lv,
    const void* ck, const void* cv, const int* starts, int step, int window,
    float scale, void* out, int B, int Hq, int Hkv, int S, int Kc,
    cudaStream_t stream) {
  int threads;
  size_t smem;
  const cudaError_t shape = decode_shape<D>(Hq, Hkv, &threads, &smem);
  if (shape != cudaSuccess) return shape;
  dim3 grid(Hkv, B);
  dense_decode_chunked_kernel<TP, D, decode_tpr<D>(), kDecodeKT>
      <<<grid, threads, smem, stream>>>(
          q_code, c_code, q, static_cast<const TP*>(lk),
          static_cast<const TP*>(lv), ck, cv, starts, step, window, scale,
          out, Hq, Hkv, S, Kc);
  return cudaGetLastError();
}

// One instance per head dim the wrappers accept (ops/attention_cuda.py).
template <typename TP>
cudaError_t paged_decode_chunked_d(
    int D, int q_code, int c_code, const void* q, const void* kp,
    const float* ks, const void* vp, const float* vs, const int* table,
    const void* ck, const void* cv, const int* starts, int step, int window,
    float scale, void* out, int B, int Hq, int Hkv, int P, int ps, int maxp,
    int Kc, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
#define SWARM_CASE(DV)                                                       \
  case DV:                                                                   \
    return launch_paged_decode_chunked<TP, DV>(                              \
        q_code, c_code, q, kp, ks, vp, vs, table, ck, cv, starts, step,      \
        window, scale, out, B, Hq, Hkv, P, ps, maxp, Kc, stream);
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
cudaError_t dense_decode_chunked_d(
    int D, int q_code, int c_code, const void* q, const void* lk,
    const void* lv, const void* ck, const void* cv, const int* starts,
    int step, int window, float scale, void* out, int B, int Hq, int Hkv,
    int S, int Kc, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return cudaErrorInvalidValue;
#define SWARM_CASE(DV)                                                  \
  case DV:                                                              \
    return launch_dense_decode_chunked<TP, DV>(                         \
        q_code, c_code, q, lk, lv, ck, cv, starts, step, window, scale, \
        out, B, Hq, Hkv, S, Kc, stream);
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
