// Two-segment paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_paged_chunk_attn_kernel` behind
// `paged_decode_gqa_attention_chunked` (swarmdb_tpu/ops/attention_pallas.py).
// One decode query per slot attends (a) the frozen page pool at positions
// < start = pos - step, read in place through the slot's page-table row,
// and (b) the chunk buffer entries idx <= step, under one fp32 online
// softmax; with a window, keys at or below pos - window are masked.
//
// Work split: one block per (KV head h, slot b). The block owns the G = Hq /
// Hkv query heads of h; each query row is held by TPR lanes (TPR * 4 dims
// each, see attn_common.cuh). The block walks the slot's live positions in
// tiles of KT (one 16-row page at the serving page size), loading each K/V
// tile of head h with 16-byte vector loads into shared memory, then the
// chunk buffer, and writes acc / max(l, 1e-30).
//
// What bounds it on the H100: bytes. Each call must read q, the live K/V
// pages of every slot for its head and the chunk rows <= step (2 * live
// tokens * Hkv * D * 2 bytes in bf16), and write the output; the arithmetic
// is ~2 FLOP per byte read. Reading only the live pages (the loop ends at
// the slot's start, and a window skips whole tiles below it) keeps the
// traffic at what the data needs, not at maxp pages.
//
// Known limit of this first version: the grid is Hkv x B blocks (64 at the
// serving shape of 8 slots x 8 KV heads), which fills about half of the
// 132 SMs, and each block loads a tile before it computes on it (no
// double buffering). Splitting the live range over several blocks per
// (b, h) with a second combine pass (flash-decoding) is the next step.
#include "attn_common.cuh"

namespace {

using swarm::fold_tile;
using swarm::load_tile;
using swarm::RowState;

template <typename T, int D, int TPR, int KT>
__global__ void paged_decode_chunked_kernel(
    const T* __restrict__ q,        // [B, Hq, D]
    const T* __restrict__ kp,       // [P, ps, Hkv, D]
    const T* __restrict__ vp,
    const int* __restrict__ table,  // [B, maxp]
    const T* __restrict__ ck,       // [B, Kc, Hkv, D]
    const T* __restrict__ cv,
    const int* __restrict__ starts,  // [B]
    int step, int window, float scale, T* __restrict__ out,  // [B, Hq, D]
    int Hq, int Hkv, int P, int ps, int maxp, int Kc) {
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
  const int start = starts[b];
  const int qpos = start + step;

  RowState<D, TPR> st;
  st.init(q + ((int64_t)b * Hq + h * G + (live ? row : 0)) * D, live, sub);

  const int64_t page_stride = (int64_t)ps * Hkv * D;
  const int* trow = table + (int64_t)b * maxp;
  auto page_row = [&](const T* pool, int pos) {
    int col = pos / ps;
    col = col < maxp ? col : maxp - 1;
    int pg = trow[col];
    pg = pg < 0 ? 0 : (pg >= P ? P - 1 : pg);  // never read outside the pool
    return pool + (int64_t)pg * page_stride +
           ((int64_t)(pos % ps) * Hkv + h) * D;
  };

  // frozen segment: positions [lo, start)
  int tile0 = 0;
  if (window > 0) {
    const int lo = qpos - window + 1;
    if (lo > 0) tile0 = lo / KT;
  }
  const int n_tiles = (start + KT - 1) / KT;
  for (int tile = tile0; tile < n_tiles; ++tile) {
    const int pos0 = tile * KT;
    const int nrows = min(KT, start - pos0);
    __syncthreads();
    load_tile<T, D>(Ks, nrows, [&](int r) { return page_row(kp, pos0 + r); },
                    tid, nthreads);
    load_tile<T, D>(Vs, nrows, [&](int r) { return page_row(vp, pos0 + r); },
                    tid, nthreads);
    __syncthreads();
    fold_tile<D, TPR, KT>(
        st, Ks, Vs, nrows, sub,
        [&](int t) { return live && (window <= 0 || pos0 + t > qpos - window); },
        scale);
  }

  // chunk segment: entries [0, step]
  const int n_chunk = min(Kc, step + 1);
  for (int c0 = 0; c0 < n_chunk; c0 += KT) {
    const int nrows = min(KT, n_chunk - c0);
    auto crow = [&](const T* buf, int r) {
      return buf + (((int64_t)b * Kc + c0 + r) * Hkv + h) * D;
    };
    __syncthreads();
    load_tile<T, D>(Ks, nrows, [&](int r) { return crow(ck, r); }, tid,
                    nthreads);
    load_tile<T, D>(Vs, nrows, [&](int r) { return crow(cv, r); }, tid,
                    nthreads);
    __syncthreads();
    fold_tile<D, TPR, KT>(
        st, Ks, Vs, nrows, sub,
        [&](int t) {
          return live && (window <= 0 || start + c0 + t > qpos - window);
        },
        scale);
  }

  if (live) st.store(out + ((int64_t)b * Hq + h * G + row) * D, sub);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const void* ck, const void* cv,
                   const int* starts, int step, int window, float scale,
                   void* out, int B, int Hq, int Hkv, int P, int ps, int maxp,
                   int Kc, cudaStream_t stream) {
  constexpr int TPR = (D / 4) < 32 ? (D / 4) : 32;
  constexpr int KT = 16;
  const int G = Hq / Hkv;
  int threads = G * TPR;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 1024) return cudaErrorInvalidConfiguration;
  const size_t smem = 2 * KT * D * sizeof(float);
  dim3 grid(Hkv, B);
  paged_decode_chunked_kernel<T, D, TPR, KT><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, static_cast<const T*>(ck),
      static_cast<const T*>(cv), starts, step, window, scale,
      static_cast<T*>(out), Hq, Hkv, P, ps, maxp, Kc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp,
                       const int* table, const void* ck, const void* cv,
                       const int* starts, int step, int window, float scale,
                       void* out, int B, int Hq, int Hkv, int P, int ps,
                       int maxp, int Kc, cudaStream_t stream) {
#define SWARM_CASE(DV)                                                      \
  case DV:                                                                  \
    return launch<T, DV>(q, kp, vp, table, ck, cv, starts, step, window,    \
                         scale, out, B, Hq, Hkv, P, ps, maxp, Kc, stream);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int swarm_paged_decode_chunked(
    int dtype, const void* q, const void* kp, const void* vp,
    const int* table, const void* ck, const void* cv, const int* starts,
    int step, int window, float scale, void* out, int B, int Hq, int Hkv,
    int D, int P, int ps, int maxp, int Kc, void* stream) {
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, kp, vp, table, ck, cv, starts, step,
                             window, scale, out, B, Hq, Hkv, P, ps, maxp, Kc,
                             s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, kp, vp, table, ck, cv, starts,
                                     step, window, scale, out, B, Hq, Hkv, P,
                                     ps, maxp, Kc, s);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_paged_decode_chunked_error)
