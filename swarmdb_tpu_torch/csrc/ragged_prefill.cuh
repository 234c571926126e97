// Packed ragged paged prefill attention for Hopper (sm_90a), over plain
// (f32 / bf16) or int8 prefix pages: the fp32 body behind ragged_prefill.cu
// and ragged_prefill_quant.cu, which route every call with a float32
// operand here (f32 results held to 1e-4) and a bf16 query and suffix to
// the tensor-core body (ragged_prefill_mma.cuh).
//
// Replaces the Pallas kernels `_ragged_prefill_kernel` behind
// `ragged_paged_prefill_attention` and `_ragged_prefill_kernel_quant`
// behind `ragged_paged_prefill_attention_quant`
// (swarmdb_tpu/ops/attention_pallas.py). A wave packs R rows back to back
// into one token stream of width W; row r owns stream positions
// [starts[r], starts[r] + lens[r]) and already has prefix_lens[r] tokens of
// K/V in its pages. Every token of row r attends r's prefix pages in place
// (positions < prefix_len) plus r's suffix tokens causally, under one fp32
// online softmax; with a window, keys at or below the query's absolute
// position - window are masked. Stream positions that no row owns are left
// as the caller allocated them (zeros). int8 prefix pages are widened and
// scaled per tile as they are loaded; the packed suffix (this wave's own
// K/V, not yet in the pool) stays in its own float type.
//
// Work split: queries are tiled WITHIN each row, varlen flash-attention
// style: one block per (query tile of QT tokens of row r, KV head h, row
// r), holding the G query heads of h for those tokens (QT * G = 64 query
// rows, 4 lanes each). The block walks r's prefix positions in tiles of KT
// (through the row's page table), then r's suffix keys up to its last
// query, and never looks at another row's keys. Blocks past the end of
// their row (and every block of a dead row, lens[r] == 0) exit at once.
// The TPU kernel's layout -- the whole stream resident, every row's keys
// scored against every stream query -- is not carried over: on the H100 it
// would cost R times the arithmetic and more shared memory than a block
// has.
//
// What bounds it on the H100: arithmetic on the CUDA cores. A wave of W
// tokens with prefix P_r per row does ~4 * D * Hq * sum_r len_r *
// (P_r + len_r / 2) FLOP in fp32 FMAs while reading each prefix page and
// suffix row once per query tile; at serving waves (hundreds of tokens,
// hundreds of prefix tokens) that is far above the card's bytes-per-FLOP
// line. The products stay on the fp32 pipes, which keeps an f32 query's
// result exact; bf16 serving takes the tensor-core body.
#pragma once

#include "attn_common.cuh"

namespace swarm {

// Fold the prefix positions [tile0 * KT, end) of one row's K / V pages
// (PagedRows, element type TP) into `st`, KT positions per tile through
// the shared tiles Ks / Vs [KT][D]; valid(pos) says whether a position is
// visible to this query row. Block-wide: every thread of the block calls
// it.
template <typename TP, int D, int TPR, int KT, class Rows, class Valid>
__device__ __forceinline__ void fold_prefix(RowState<D, TPR>& st, float* Ks,
                                           float* Vs, const Rows& kr,
                                           const Rows& vr, int tile0, int end,
                                           int sub, Valid valid, float scale,
                                           int tid, int nthreads) {
  const int n_tiles = (end + KT - 1) / KT;
  for (int tile = tile0; tile < n_tiles; ++tile) {
    const int pos0 = tile * KT;
    const int nrows = min(KT, end - pos0);
    __syncthreads();
    load_tile<TP, D>(
        Ks, nrows, [&](int r) { return kr.row(pos0 + r); }, tid, nthreads,
        [&](int r) { return kr.scale(pos0 + r); });
    load_tile<TP, D>(
        Vs, nrows, [&](int r) { return vr.row(pos0 + r); }, tid, nthreads,
        [&](int r) { return vr.scale(pos0 + r); });
    __syncthreads();
    fold_tile<D, TPR, KT>(
        st, Ks, Vs, nrows, sub, [&](int t) { return valid(pos0 + t); },
        scale);
  }
}

constexpr int kPrefillTPR = 4;     // lanes per query row
constexpr int kPrefillKT = 32;     // keys per tile
constexpr int kPrefillQRows = 64;  // query rows (token x head) per block

template <typename TP, int D>
__global__ void __launch_bounds__(kPrefillQRows * kPrefillTPR)
ragged_prefill_kernel(int q_code, int s_code,
                      const void* __restrict__ q,      // [W, Hq, D]
                      const void* __restrict__ sk,     // [W, Hkv, D]
                      const void* __restrict__ sv,
                      const TP* __restrict__ kp,       // [P, ps, Hkv, D]
                      const float* __restrict__ ks,    // [P, Hkv] (int8)
                      const TP* __restrict__ vp,
                      const float* __restrict__ vs,
                      const int* __restrict__ tables,  // [R, maxp]
                      const int* __restrict__ starts,  // [R]
                      const int* __restrict__ lens,
                      const int* __restrict__ plens,
                      void* __restrict__ out,  // [W, Hq, D]
                      int W, int Hq, int Hkv, int P, int ps, int maxp,
                      int window, float scale) {
  constexpr int TPR = kPrefillTPR;
  constexpr int KT = kPrefillKT;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + KT * D;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int G = Hq / Hkv;
  const int QT = kPrefillQRows / G;  // query tokens per block
  const int len = lens[r];
  const int q_first = qt * QT;  // row-relative offset of the tile's first query
  if (q_first >= len) return;   // uniform over the block
  const int start = starts[r];
  const int plen = plens[r];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int qrow = tid / TPR;
  const int sub = tid % TPR;
  const int qi = q_first + qrow / G;  // row-relative query offset
  const int g = qrow % G;
  const int x = start + qi;  // stream index of the query
  const bool live = qrow < QT * G && qi < len && x < W;
  const int q_abs = plen + qi;  // absolute position of the query

  RowState<D, TPR> st;
  st.init(q_code, q, ((int64_t)(live ? x : 0) * Hq + h * G + g) * D, live,
          sub);

  // prefix segment: positions [lo, plen) through the row's page table,
  // never past the table's coverage
  const int* trow = tables + (int64_t)r * maxp;
  const PagedRows<TP, D> kr{kp, ks, trow, P, ps, Hkv, maxp, h};
  const PagedRows<TP, D> vr{vp, vs, trow, P, ps, Hkv, maxp, h};
  int tile0 = 0;
  if (window > 0) {
    const int lo = plen + q_first - window + 1;  // lowest key any query sees
    if (lo > 0) tile0 = lo / KT;
  }
  fold_prefix<TP, D, TPR, KT>(
      st, Ks, Vs, kr, vr, tile0, min(plen, maxp * ps), sub,
      [&](int pos) { return live && (window <= 0 || pos > q_abs - window); },
      scale, tid, nthreads);

  // suffix segment: the row's own keys, row-relative [k_lo, q_last]
  const int q_last = min(len, q_first + QT) - 1;
  int k_lo = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;
    if (lo > 0) k_lo = lo / KT * KT;
  }
  for (int k0 = k_lo; k0 <= q_last; k0 += KT) {
    const int nrows = min(KT, q_last + 1 - k0);
    auto srow = [&](int t) {
      return ((int64_t)(start + k0 + t) * Hkv + h) * D;
    };
    __syncthreads();
    load_rows<D>(s_code, Ks, nrows, sk, srow, tid, nthreads);
    load_rows<D>(s_code, Vs, nrows, sv, srow, tid, nthreads);
    __syncthreads();
    fold_tile<D, TPR, KT>(
        st, Ks, Vs, nrows, sub,
        [&](int t) {
          const int kk = k0 + t;
          return live && kk <= qi && (window <= 0 || kk > qi - window);
        },
        scale);
  }

  if (live) st.store(q_code, out, ((int64_t)x * Hq + h * G + g) * D, sub);
}

template <typename TP, int D>
cudaError_t launch_ragged_prefill(
    int q_code, int s_code, const void* q, const void* sk, const void* sv,
    const void* kp, const float* ks, const void* vp, const float* vs,
    const int* tables, const int* starts, const int* lens, const int* plens,
    void* out, int W, int R, int Hq, int Hkv, int P, int ps, int maxp,
    int window, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G > kPrefillQRows) return cudaErrorInvalidValue;
  const int QT = kPrefillQRows / G;
  dim3 grid((W + QT - 1) / QT, Hkv, R);
  const size_t smem = 2 * kPrefillKT * D * sizeof(float);
  ragged_prefill_kernel<TP, D>
      <<<grid, kPrefillQRows * kPrefillTPR, smem, stream>>>(
          q_code, s_code, q, sk, sv, static_cast<const TP*>(kp), ks,
          static_cast<const TP*>(vp), vs, tables, starts, lens, plens, out, W,
          Hq, Hkv, P, ps, maxp, window, scale);
  return cudaGetLastError();
}

// One instance per head dim the wrappers accept (ops/attention_cuda.py).
template <typename TP>
cudaError_t ragged_prefill_d(int D, int q_code, int s_code, const void* q,
                             const void* sk, const void* sv, const void* kp,
                             const float* ks, const void* vp, const float* vs,
                             const int* tables, const int* starts,
                             const int* lens, const int* plens, void* out,
                             int W, int R, int Hq, int Hkv, int P, int ps,
                             int maxp, int window, float scale,
                             cudaStream_t stream) {
  if (W == 0 || R == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
#define SWARM_CASE(DV)                                                     \
  case DV:                                                                 \
    return launch_ragged_prefill<TP, DV>(                                  \
        q_code, s_code, q, sk, sv, kp, ks, vp, vs, tables, starts, lens,   \
        plens, out, W, R, Hq, Hkv, P, ps, maxp, window, scale, stream);
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
