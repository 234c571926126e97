// Shared pieces of the attention kernels (ragged prefill, and the decode
// body of decode.cuh): 16-byte tile loads into shared memory, the page-
// table walk, the int8 widen, the fp32 online-softmax fold of one key tile
// into a query row's state (the fp32 prefill body); and the tensor-core
// helpers of the bf16 prefill body (cp.async, ldmatrix, mma.sync, the
// int8-to-bf16 widen).
//
// Operand types. Pages are a compile-time type TP: float, bf16, or int8
// with one f32 scale per (page, KV head), applied to each widened value as
// the Pallas kernels' `_attend_tile` does (k = k_i8 * scale in f32, then
// the dot). The query, the output, the chunk buffer and the packed suffix
// each come in their own float type, named at run time by a FloatCode
// (block-uniform branches around whole loads). Everything is computed in
// fp32.
//
// Layout of the fp32 prefill's work: a query row (one query token x one
// query head) is owned by TPR consecutive lanes of a warp. Lane `sub` of
// the row holds the head dims d = 4*sub + 4*TPR*i + e (i < D/(4*TPR), e <
// 4) of the query and of the running output, so a row reads its K/V tile
// rows from shared memory as float4s at neighbouring addresses (no bank
// conflicts), and the per-key dot product is reduced over the TPR lanes
// with xor shuffles.
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
// Four int8 values (one 32-bit word) widened to floats, exactly and
// without the quarter-rate int-to-float converters: byte i, offset by 128,
// becomes the low byte of the float 2^23 + v + 128, and one subtraction
// leaves v.
__device__ __forceinline__ void widen_i8x4(uint32_t u, float* f) {
  const uint32_t w = u ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
}
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    widen_i8x4(u.x, f);
    widen_i8x4(u.y, f + 4);
    widen_i8x4(u.z, f + 8);
    widen_i8x4(u.w, f + 12);
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

#ifdef SWARM_KERNCHECK
// ---------------------------------------------------------------------
// The bounds-checked build (nvcc -DSWARM_KERNCHECK; ops/build.py builds
// it beside the plain one into lib<name>-kc-<hash>.so, and
// ops/attention_cuda.py launches it under SWARMDB_KERNCHECK=1): the card's
// counterpart of the JAX kernel sanitizer's bounds-checked refs and
// per-grid-step write diff. Every clamp of the plain build still clamps,
// so a checked launch stays memory-safe, and also records an `oob-block`
// violation; on eager launches every output store stamps a writer map
// (one entry per output row and query head) with the writing block's
// linear id, and a second block writing the same entry records a
// `write-race`. A record is written once (atomicCAS on `taken`); `hits`
// counts every further hit. Slot 0 holds the first oob-block, slot 1 the
// first write-race. The record lives in device memory and is copied to a
// page-locked host mirror on the launch's stream after every launch, so
// the host reads it at a wait it already makes, without a sync of its
// own. With the macro undefined none of this is compiled.
struct KcRecord {
  int hits, taken, entry, site;
  int bx, by, bz, rank;  // the recording block; rank -1 outside a cluster
  int raw, bound;        // the bad index and its bound (race: row, head)
  int other, ox, oy, oz;  // race: the first writer's linear id and (x, y, z)
  int pad[2];
};
enum KcSite : int {
  kKcPage = 1,      // page id outside [0, P)
  kKcColumn = 2,    // page-table column outside [0, maxp)
  kKcRowLen = 3,    // a ragged row's [start, start + len) past the stream
  kKcCoverage = 4,  // a decode walk past the cache's coverage
  kKcWriter = 5,    // two blocks wrote one output row and head
};
// What a checked kernel gets: the device record, the writer map ([rows *
// heads] int32, -1 = unwritten; null on a captured launch), the entry
// point's index in ops/build.py's KERNELS, the query heads per row.
struct KcArgs {
  KcRecord* rec;
  int* wmap;
  int entry;
  int heads;
};
// Armed by swarm_kc_arm right before each launch, on the launching
// thread (ctypes calls of one launch come from one thread).
struct KcHost {
  KcRecord* rec = nullptr;
  KcRecord* host = nullptr;
  int* wmap = nullptr;
  int entry = -1;
  int heads = 0;
};
static thread_local KcHost kc_host_state;

inline KcArgs kc_args() {
  return KcArgs{kc_host_state.rec, kc_host_state.wmap, kc_host_state.entry,
                kc_host_state.heads};
}

// After a launch: copy the record to its host mirror on the same stream.
inline cudaError_t kc_publish(cudaError_t e, cudaStream_t stream) {
  if (e != cudaSuccess || kc_host_state.rec == nullptr) return e;
  return cudaMemcpyAsync(kc_host_state.host, kc_host_state.rec,
                         2 * sizeof(KcRecord), cudaMemcpyDeviceToHost,
                         stream);
}

__device__ __forceinline__ int kc_cluster_rank() {
  unsigned n, r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return n > 1 ? static_cast<int>(r) : -1;
}

__device__ __noinline__ void kc_record(const KcArgs& kc, int slot, int site,
                                       int raw, int bound, int other) {
  if (kc.rec == nullptr) return;
  KcRecord* r = kc.rec + slot;
  atomicAdd(&r->hits, 1);
  if (atomicCAS(&r->taken, 0, 1) != 0) return;
  r->entry = kc.entry;
  r->site = site;
  r->bx = blockIdx.x, r->by = blockIdx.y, r->bz = blockIdx.z;
  r->rank = kc_cluster_rank();
  r->raw = raw, r->bound = bound, r->other = other;
  if (other >= 0) {
    r->ox = other % gridDim.x;
    r->oy = (other / gridDim.x) % gridDim.y;
    r->oz = other / (gridDim.x * gridDim.y);
  }
  __threadfence();
}

// Stamp output (row, head) with `writer` (a block's linear id); a
// different earlier writer is a write-race.
__device__ __forceinline__ void kc_stamp(const KcArgs& kc, int64_t row,
                                         int head, int writer) {
  if (kc.wmap == nullptr) return;
  const int old = atomicCAS(kc.wmap + row * kc.heads + head, -1, writer);
  if (old != -1 && old != writer)
    kc_record(kc, 1, kKcWriter, static_cast<int>(row), head, old);
}

__device__ __forceinline__ int kc_block_id() {
  return blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
}

#define SWARM_KC(...) , __VA_ARGS__
#define SWARM_KC_DONE(e, stream) swarm::kc_publish((e), (stream))
#else
#define SWARM_KC(...)
#define SWARM_KC_DONE(e, stream) (e)
#endif

// The rows of one KV head of a paged pool seen through one page-table row:
// position -> page id (clamped into the pool, so a bad table entry cannot
// read outside it) -> row pointer, and for int8 pages the page's scale.
template <typename TP, int D> struct PagedRows {
  const TP* pool;       // [P, ps, Hkv, D]
  const float* scales;  // [P, Hkv] for int8 pages, unused otherwise
  const int* trow;      // [maxp] page ids
  int P, ps, Hkv, maxp, h;
#ifdef SWARM_KERNCHECK
  KcArgs kc;
#endif

  __device__ __forceinline__ int page(int pos) const {
    int col = pos / ps;
#ifdef SWARM_KERNCHECK
    if (col >= maxp) kc_record(kc, 0, kKcColumn, col, maxp, -1);
#endif
    col = col < maxp ? col : maxp - 1;
    const int pg = trow[col];
#ifdef SWARM_KERNCHECK
    if (pg < 0 || pg >= P) kc_record(kc, 0, kKcPage, pg, P, -1);
#endif
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

// ---------------------------------------------------------------------
// Tensor-core pieces (sm_80+ warp-level instructions, all on sm_90a):
// 16-byte cp.async copies into shared memory (also the decode body's ring),
// ldmatrix fragment loads and the bf16 m16n8k16 MMA with fp32
// accumulators.
//
// Fragment layouts of mma.m16n8k16 (lane = threadIdx.x % 32, quad row
// qr = lane / 4, quad column qc = lane % 4): an A fragment (16 x 16,
// row-major) is four bf16 pairs a0..a3 at (row qr, cols 2qc..2qc+1),
// (qr + 8, same), (qr, 8 + same), (qr + 8, 8 + same); a B fragment (16 x 8,
// k x n) is b0 at (k 2qc..2qc+1, n qr) and b1 at (k 8 + same, n qr); the
// fp32 accumulator c0..c3 is (row qr, cols 2qc, 2qc+1) then (row qr + 8,
// same cols).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-fills dst when !pred (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, whose fragment lands in r[i]. `trans` delivers
// each matrix transposed (rows become the fragment's k index).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to a bf16 pair (lo in the low half, as the fragment
// layouts want the lower column there).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 int8 values widened to 16 bf16, exactly (|v| <= 128 fits bf16's 8
// significant bits), without the quarter-rate int-to-float converters:
// byte b, offset to b + 128, becomes the low byte of the float 2^23 + b +
// 128, one subtraction leaves v in fp32 with zero low 16 bits, and the
// high halves of two such floats are the bf16 pair.
__device__ __forceinline__ uint32_t widen_i8x2_bf16(uint32_t u, int b0) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u,
                                               0x7540 + b0)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u,
                                               0x7541 + b0)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ void widen_i8_bf16(const uint4& u, uint4& lo,
                                              uint4& hi) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
  lo = make_uint4(widen_i8x2_bf16(w[0], 0), widen_i8x2_bf16(w[0], 2),
                  widen_i8x2_bf16(w[1], 0), widen_i8x2_bf16(w[1], 2));
  hi = make_uint4(widen_i8x2_bf16(w[2], 0), widen_i8x2_bf16(w[2], 2),
                  widen_i8x2_bf16(w[3], 0), widen_i8x2_bf16(w[3], 2));
}

// Slots of the `swarm_<entry>_smem` queries' info array (ctypes side:
// ops/attention_cuda.py SMEM_INFO).
enum SmemInfo {
  kInfoDynamic = 0,   // dynamic shared bytes per block the launch passes
  kInfoStatic,        // static shared bytes (cudaFuncGetAttributes)
  kInfoRegs,          // registers per thread
  kInfoLocal,         // local (spill) bytes per thread
  kInfoMaxDynamic,    // the instance's dynamic limit after its opt-in
  kInfoOptin,         // the device's opt-in shared bytes per block
  kInfoThreads,       // threads per block
  kInfoGroups,        // the tensor-core prefill's NG (0 elsewhere)
  kInfoSms,           // the device's streaming multiprocessors
  kInfoSlots
};

// Fill `info` for one kernel instance: `dyn` is the dynamic shared memory
// its launch passes (the layout's bytes at the launch's dims).
template <typename K>
cudaError_t smem_info(K* kernel, size_t dyn, int threads, int groups,
                      long long* info) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  int optin = 0, sms = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  info[kInfoDynamic] = static_cast<long long>(dyn);
  info[kInfoStatic] = static_cast<long long>(fa.sharedSizeBytes);
  info[kInfoRegs] = fa.numRegs;
  info[kInfoLocal] = static_cast<long long>(fa.localSizeBytes);
  info[kInfoMaxDynamic] = fa.maxDynamicSharedSizeBytes;
  info[kInfoOptin] = optin;
  info[kInfoThreads] = threads;
  info[kInfoGroups] = groups;
  info[kInfoSms] = sms;
  return cudaSuccess;
}

}  // namespace swarm

#ifdef SWARM_KERNCHECK
// Arm the checked build for this thread's next launch: the device record
// and its page-locked host mirror, the writer map (or null), the entry
// point's index in KERNELS, the query heads per output row.
extern "C" int swarm_kc_arm(void* rec, void* host, void* wmap, int entry,
                            int heads) {
  swarm::kc_host_state.rec = static_cast<swarm::KcRecord*>(rec);
  swarm::kc_host_state.host = static_cast<swarm::KcRecord*>(host);
  swarm::kc_host_state.wmap = static_cast<int*>(wmap);
  swarm::kc_host_state.entry = entry;
  swarm::kc_host_state.heads = heads;
  return 0;
}
#endif

// Error text for a code returned by an entry point (ctypes side).
#define SWARM_DEFINE_ERROR_STRING(name)                 \
  extern "C" const char* name(int code) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
