// Packed ragged paged prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_ragged_prefill_kernel` behind
// `ragged_paged_prefill_attention` (swarmdb_tpu/ops/attention_pallas.py).
// A wave packs R rows back to back into one token stream of width W; row r
// owns stream positions [starts[r], starts[r] + lens[r]) and already has
// prefix_lens[r] tokens of K/V in its pages. Every token of row r attends
// r's prefix pages in place (positions < prefix_len) plus r's suffix tokens
// causally, under one fp32 online softmax; with a window, keys at or below
// the query's absolute position - window are masked. Stream positions that
// no row owns are left as the caller allocated them (zeros).
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
// line. This first version keeps the products on the fp32 pipes; feeding
// them to the tensor cores (mma / wgmma on bf16 tiles) is the next step.
#include "attn_common.cuh"

namespace {

using swarm::fold_tile;
using swarm::load_tile;
using swarm::RowState;

constexpr int kTPR = 4;     // lanes per query row
constexpr int kKT = 32;     // keys per tile
constexpr int kQRows = 64;  // query rows (token x head) per block

template <typename T, int D>
__global__ void __launch_bounds__(kQRows * kTPR)
ragged_prefill_kernel(const T* __restrict__ q,     // [W, Hq, D]
                      const T* __restrict__ sk,    // [W, Hkv, D]
                      const T* __restrict__ sv,
                      const T* __restrict__ kp,    // [P, ps, Hkv, D]
                      const T* __restrict__ vp,
                      const int* __restrict__ tables,  // [R, maxp]
                      const int* __restrict__ starts,  // [R]
                      const int* __restrict__ lens,
                      const int* __restrict__ plens,
                      T* __restrict__ out,  // [W, Hq, D]
                      int W, int Hq, int Hkv, int P, int ps, int maxp,
                      int window, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kKT * D;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int G = Hq / Hkv;
  const int QT = kQRows / G;  // query tokens per block
  const int len = lens[r];
  const int q_first = qt * QT;  // row-relative offset of the tile's first query
  if (q_first >= len) return;   // uniform over the block
  const int start = starts[r];
  const int plen = plens[r];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int qrow = tid / kTPR;
  const int sub = tid % kTPR;
  const int qi = q_first + qrow / G;  // row-relative query offset
  const int g = qrow % G;
  const int x = start + qi;  // stream index of the query
  const bool live = qrow < QT * G && qi < len && x < W;
  const int q_abs = plen + qi;  // absolute position of the query

  RowState<D, kTPR> st;
  st.init(q + ((int64_t)(live ? x : 0) * Hq + h * G + g) * D, live, sub);

  // prefix segment: positions [lo, plen) through the row's page table
  const int64_t page_stride = (int64_t)ps * Hkv * D;
  const int* trow = tables + (int64_t)r * maxp;
  auto page_row = [&](const T* pool, int pos) {
    int col = pos / ps;
    col = col < maxp ? col : maxp - 1;
    int pg = trow[col];
    pg = pg < 0 ? 0 : (pg >= P ? P - 1 : pg);  // never read outside the pool
    return pool + (int64_t)pg * page_stride +
           ((int64_t)(pos % ps) * Hkv + h) * D;
  };
  int tile0 = 0;
  if (window > 0) {
    const int lo = plen + q_first - window + 1;  // lowest key any query sees
    if (lo > 0) tile0 = lo / kKT;
  }
  const int n_tiles = (plen + kKT - 1) / kKT;
  for (int tile = tile0; tile < n_tiles; ++tile) {
    const int pos0 = tile * kKT;
    const int nrows = min(kKT, plen - pos0);
    __syncthreads();
    load_tile<T, D>(Ks, nrows, [&](int t) { return page_row(kp, pos0 + t); },
                    tid, nthreads);
    load_tile<T, D>(Vs, nrows, [&](int t) { return page_row(vp, pos0 + t); },
                    tid, nthreads);
    __syncthreads();
    fold_tile<D, kTPR, kKT>(
        st, Ks, Vs, nrows, sub,
        [&](int t) {
          return live && (window <= 0 || pos0 + t > q_abs - window);
        },
        scale);
  }

  // suffix segment: the row's own keys, row-relative [k_lo, q_last]
  const int q_last = min(len, q_first + QT) - 1;
  int k_lo = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;
    if (lo > 0) k_lo = lo / kKT * kKT;
  }
  for (int k0 = k_lo; k0 <= q_last; k0 += kKT) {
    const int nrows = min(kKT, q_last + 1 - k0);
    auto srow = [&](const T* buf, int t) {
      return buf + ((int64_t)(start + k0 + t) * Hkv + h) * D;
    };
    __syncthreads();
    load_tile<T, D>(Ks, nrows, [&](int t) { return srow(sk, t); }, tid,
                    nthreads);
    load_tile<T, D>(Vs, nrows, [&](int t) { return srow(sv, t); }, tid,
                    nthreads);
    __syncthreads();
    fold_tile<D, kTPR, kKT>(
        st, Ks, Vs, nrows, sub,
        [&](int t) {
          const int kk = k0 + t;
          return live && kk <= qi && (window <= 0 || kk > qi - window);
        },
        scale);
  }

  if (live) st.store(out + ((int64_t)x * Hq + h * G + g) * D, sub);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* sk, const void* sv,
                   const void* kp, const void* vp, const int* tables,
                   const int* starts, const int* lens, const int* plens,
                   void* out, int W, int R, int Hq, int Hkv, int P, int ps,
                   int maxp, int window, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G > kQRows) return cudaErrorInvalidValue;
  const int QT = kQRows / G;
  dim3 grid((W + QT - 1) / QT, Hkv, R);
  const size_t smem = 2 * kKT * D * sizeof(float);
  ragged_prefill_kernel<T, D><<<grid, kQRows * kTPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(sk),
      static_cast<const T*>(sv), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, starts, lens, plens,
      static_cast<T*>(out), W, Hq, Hkv, P, ps, maxp, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* sk, const void* sv,
                       const void* kp, const void* vp, const int* tables,
                       const int* starts, const int* lens, const int* plens,
                       void* out, int W, int R, int Hq, int Hkv, int P,
                       int ps, int maxp, int window, float scale,
                       cudaStream_t stream) {
#define SWARM_CASE(DV)                                                     \
  case DV:                                                                 \
    return launch<T, DV>(q, sk, sv, kp, vp, tables, starts, lens, plens,   \
                         out, W, R, Hq, Hkv, P, ps, maxp, window, scale,   \
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int swarm_ragged_prefill(int dtype, const void* q, const void* sk,
                                    const void* sv, const void* kp,
                                    const void* vp, const int* tables,
                                    const int* starts, const int* lens,
                                    const int* plens, void* out, int W, int R,
                                    int Hq, int Hkv, int D, int P, int ps,
                                    int maxp, int window, float scale,
                                    void* stream) {
  if (W == 0 || R == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, sk, sv, kp, vp, tables, starts, lens,
                             plens, out, W, R, Hq, Hkv, P, ps, maxp, window,
                             scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, sk, sv, kp, vp, tables, starts,
                                     lens, plens, out, W, R, Hq, Hkv, P, ps,
                                     maxp, window, scale, s);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_ragged_prefill_error)
