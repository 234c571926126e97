// Shared pieces of the attention kernels (ragged prefill, chunked and
// single-step decode, over plain or int8 pages or over a dense slot
// cache): 16-byte tile loads into shared memory, the page-table walk, the
// dense lane walk and the fp32 online-softmax fold of one key tile into a
// query row's state.
//
// Operand types. Pages are a compile-time type TP: float, bf16, or int8
// with one f32 scale per (page, KV head), applied to each widened value as
// the Pallas kernels' `_attend_tile` does (k = k_i8 * scale in f32, then
// the dot). The query, the output, the chunk buffer and the packed suffix
// each come in their own float type, named at run time by a FloatCode
// (block-uniform branches around whole loads). Everything is computed in
// fp32.
//
// Layout of the work: a query row (one query token x one query head) is
// owned by TPR consecutive lanes of a warp. Lane `sub` of the row holds the
// head dims d = 4*sub + 4*TPR*i + e (i < D/(4*TPR), e < 4) of the query and
// of the running output, so a row reads its K/V tile rows from shared
// memory as float4s at neighbouring addresses (no bank conflicts), and the
// per-key dot product is reduced over the TPR lanes with xor shuffles.
//
// Masking follows the Pallas kernels' contract with one difference that
// keeps the result exact: a masked key contributes p = 0 (not exp(-1e30 -
// m)), and the running max starts at -1e30, so a row that has seen no live
// key yet holds m = -1e30, l = 0, acc = 0 and is rescaled to zero by the
// first live key. A row with no live key at all outputs 0 (denominator
// clamped at 1e-30, as in the Pallas kernels).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace swarm {

constexpr float kNeg = -1e30f;

// Float operand types named at run time (the wrappers' dtype codes).
enum FloatCode : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// One 16-byte vector of T widened to floats.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
  }
};

// Row scale of a plain tile: none.
struct Unit {
  __device__ __forceinline__ float operator()(int) const { return 1.f; }
};

// Copy `nrows` rows of D elements into the fp32 tile dst[row * D + d],
// each widened value times scale(row) (1 for plain tiles; the page's
// per-head scale for int8 pages). Row r starts at src(r) (16-byte aligned:
// D * sizeof(T) % 16 == 0). Each thread moves whole 16-byte vectors;
// neighbouring threads take neighbouring vectors of a row, so the global
// reads coalesce.
template <typename T, int D, class RowPtr, class RowScale = Unit>
__device__ __forceinline__ void load_tile(float* dst, int nrows, RowPtr src,
                                          int tid, int nthreads,
                                          RowScale scale = RowScale()) {
  constexpr int EPV = Vec16<T>::N;
  constexpr int VPR = D / EPV;
  static_assert(D % EPV == 0, "row must be a whole number of 16-byte vectors");
  for (int v = tid; v < nrows * VPR; v += nthreads) {
    const int r = v / VPR, c = v % VPR;
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src(r)) + c);
    float f[EPV];
    Vec16<T>::widen(u, f);
    if constexpr (!std::is_same<RowScale, Unit>::value) {
      const float sc = scale(r);
#pragma unroll
      for (int e = 0; e < EPV; ++e) f[e] *= sc;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * D + c * EPV);
#pragma unroll
    for (int e = 0; e < EPV / 4; ++e)
      d[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
  }
}

// load_tile over a float operand whose type is a run-time FloatCode; row r
// starts `off(r)` elements past `base`.
template <int D, class RowOff>
__device__ __forceinline__ void load_rows(int code, float* dst, int nrows,
                                          const void* base, RowOff off,
                                          int tid, int nthreads) {
  if (code == kBF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base);
    load_tile<__nv_bfloat16, D>(dst, nrows, [&](int r) { return p + off(r); },
                                tid, nthreads);
  } else {
    const float* p = static_cast<const float*>(base);
    load_tile<float, D>(dst, nrows, [&](int r) { return p + off(r); }, tid,
                        nthreads);
  }
}

// The rows of one KV head of a paged pool seen through one page-table row:
// position -> page id (clamped into the pool, so a bad table entry cannot
// read outside it) -> row pointer, and for int8 pages the page's scale.
template <typename TP, int D> struct PagedRows {
  const TP* pool;       // [P, ps, Hkv, D]
  const float* scales;  // [P, Hkv] for int8 pages, unused otherwise
  const int* trow;      // [maxp] page ids
  int P, ps, Hkv, maxp, h;

  __device__ __forceinline__ int page(int pos) const {
    int col = pos / ps;
    col = col < maxp ? col : maxp - 1;
    const int pg = trow[col];
    return pg < 0 ? 0 : (pg >= P ? P - 1 : pg);
  }
  __device__ __forceinline__ const TP* row(int pos) const {
    return pool + ((int64_t)page(pos) * ps + pos % ps) * Hkv * D +
           (int64_t)h * D;
  }
  __device__ __forceinline__ float scale(int pos) const {
    if constexpr (std::is_same<TP, int8_t>::value)
      return __ldg(scales + (int64_t)page(pos) * Hkv + h);
    else
      return 1.f;
  }
};

// The rows of one KV head of one slot's lane in a dense slot cache
// [B, S, Hkv, D]: position pos of slot b is row (b * S + pos) * Hkv + h,
// contiguous in pos, unscaled. Callers keep pos < S.
template <typename T, int D> struct DenseRows {
  const T* cache;  // [B, S, Hkv, D]
  int S, Hkv, b, h;

  __device__ __forceinline__ const T* row(int pos) const {
    return cache + (((int64_t)b * S + pos) * Hkv + h) * D;
  }
  __device__ __forceinline__ float scale(int) const { return 1.f; }
};

// A whole K or V cache as a decode kernel sees it: rows(b, h) walks slot
// b's positions of KV head h, coverage() is how many positions a slot can
// hold (the page table's reach, or the lane length S).
template <typename TP, int D> struct PagedCache {
  const TP* pool;       // [P, ps, Hkv, D]
  const float* scales;  // [P, Hkv] for int8 pages, unused otherwise
  const int* table;     // [B, maxp]
  int P, ps, Hkv, maxp;

  __device__ __forceinline__ PagedRows<TP, D> rows(int b, int h) const {
    return PagedRows<TP, D>{pool, scales, table + (int64_t)b * maxp,
                            P, ps, Hkv, maxp, h};
  }
  __device__ __forceinline__ int coverage() const { return maxp * ps; }
};

template <typename T, int D> struct DenseCache {
  const T* lanes;  // [B, S, Hkv, D]
  int S, Hkv;

  __device__ __forceinline__ DenseRows<T, D> rows(int b, int h) const {
    return DenseRows<T, D>{lanes, S, Hkv, b, h};
  }
  __device__ __forceinline__ int coverage() const { return S; }
};

// Running state of one query row, split over TPR lanes.
template <int D, int TPR> struct RowState {
  static constexpr int NPT = D / TPR;  // dims per lane
  static_assert(NPT % 4 == 0, "each lane owns whole float4s");
  float q[NPT];
  float acc[NPT];
  float m;
  float l;

  __device__ __forceinline__ static int dim(int sub, int j) {
    return 4 * sub + 4 * TPR * (j / 4) + (j % 4);
  }

  template <typename T>
  __device__ __forceinline__ void init(const T* qrow, bool live, int sub) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      q[j] = live ? to_f(qrow[dim(sub, j)]) : 0.f;
      acc[j] = 0.f;
    }
    m = kNeg;
    l = 0.f;
  }

  template <typename T>
  __device__ __forceinline__ void store(T* orow, int sub) const {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < NPT; ++j) orow[dim(sub, j)] = from_f<T>(acc[j] / denom);
  }

  // The same for a query / output whose type is a run-time FloatCode; the
  // row starts `off` elements past the base pointer.
  __device__ __forceinline__ void init(int code, const void* q, int64_t off,
                                       bool live, int sub) {
    if (code == kBF16)
      init(static_cast<const __nv_bfloat16*>(q) + off, live, sub);
    else
      init(static_cast<const float*>(q) + off, live, sub);
  }
  __device__ __forceinline__ void store(int code, void* out, int64_t off,
                                        int sub) const {
    if (code == kBF16)
      store(static_cast<__nv_bfloat16*>(out) + off, sub);
    else
      store(static_cast<float*>(out) + off, sub);
  }
};

// Fold the first `nrows` keys of the fp32 tiles Ks/Vs [KT][D] into `st`.
// valid(t) says whether key t is visible to this row (t < nrows is checked
// here). Every lane of the warp must call this (the shuffles are
// warp-wide); lanes of idle rows pass valid == false everywhere.
template <int D, int TPR, int KT, class Valid>
__device__ __forceinline__ void fold_tile(RowState<D, TPR>& st,
                                          const float* Ks, const float* Vs,
                                          int nrows, int sub, Valid valid,
                                          float scale) {
  static_assert(KT <= 32, "validity is kept in a 32-bit mask");
  constexpr int NPT = RowState<D, TPR>::NPT;
  float s[KT];
  unsigned ok = 0u;
  float mt = kNeg;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    float part = 0.f;
    if (t < nrows) {
      const float* krow = Ks + t * D + 4 * sub;
#pragma unroll
      for (int j = 0; j < NPT; j += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(krow + TPR * j);
        part = fmaf(st.q[j], k4.x, part);
        part = fmaf(st.q[j + 1], k4.y, part);
        part = fmaf(st.q[j + 2], k4.z, part);
        part = fmaf(st.q[j + 3], k4.w, part);
      }
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    s[t] = part * scale;
    if (t < nrows && valid(t)) {
      ok |= 1u << t;
      mt = fmaxf(mt, s[t]);
    }
  }
  const float m_new = fmaxf(st.m, mt);
  const float alpha = __expf(st.m - m_new);
  float psum = 0.f;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    s[t] = ((ok >> t) & 1u) ? __expf(s[t] - m_new) : 0.f;
    psum += s[t];
  }
  st.m = m_new;
  st.l = st.l * alpha + psum;
#pragma unroll
  for (int j = 0; j < NPT; ++j) st.acc[j] *= alpha;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    if (t < nrows) {
      const float* vrow = Vs + t * D + 4 * sub;
#pragma unroll
      for (int j = 0; j < NPT; j += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vrow + TPR * j);
        st.acc[j] = fmaf(s[t], v4.x, st.acc[j]);
        st.acc[j + 1] = fmaf(s[t], v4.y, st.acc[j + 1]);
        st.acc[j + 2] = fmaf(s[t], v4.z, st.acc[j + 2]);
        st.acc[j + 3] = fmaf(s[t], v4.w, st.acc[j + 3]);
      }
    }
  }
}

// Fold the positions [tile0 * KT, end) of one slot's K / V rows (PagedRows
// or DenseRows, element type TP) into `st`, KT positions per tile through
// the shared tiles Ks / Vs [KT][D]; valid(pos) says whether a position is
// visible to this row. Block-wide: every thread of the block calls it.
template <typename TP, int D, int TPR, int KT, class Rows, class Valid>
__device__ __forceinline__ void fold_pages(RowState<D, TPR>& st, float* Ks,
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

}  // namespace swarm

// Error text for a code returned by an entry point (ctypes side).
#define SWARM_DEFINE_ERROR_STRING(name)                 \
  extern "C" const char* name(int code) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
