// Decode attention for Hopper (sm_90a): the one body behind the six decode
// entry points -- single-step and two-segment (chunked), each over a paged
// pool of f32 / bf16 pages (paged_decode.cu, paged_decode_chunked.cu), of
// int8 pages (paged_decode_quant.cu, paged_decode_chunked_quant.cu), or
// over a dense slot cache (dense_decode.cu, dense_decode_chunked.cu).
//
// Replaces the Pallas kernels of swarmdb_tpu/ops/attention_pallas.py:
// `_paged_attn_kernel` / `_paged_attn_kernel_quant` (wrappers
// `paged_decode_gqa_attention` / `..._quant`), `_paged_chunk_attn_kernel`
// / `_paged_chunk_attn_kernel_quant` (`paged_decode_gqa_attention_chunked`
// / `..._quant`), `_decode_attn_kernel` (`decode_gqa_attention`) and
// `_dense_chunk_attn_kernel` (`decode_gqa_attention_chunked`).
//
// Contract. One decode query per slot b and query head attends, under one
// fp32 online softmax:
// - single step: the slot's positions < length = lengths[b] (its position
//   + 1: the step's own token is already in the cache), query position
//   length - 1;
// - chunked: the frozen positions < start = starts[b] plus the chunk
//   buffer's entries <= step ([B, Kc, Hkv, D], in its own float type),
//   query position start + step. A dense lane holds a bucketed prefill's
//   padding past start; the walk ends at start, so it is never read.
// The walk over the cache is clamped to its coverage (maxp * ps through a
// page-table row, or the lane length S); page ids are clamped into the
// pool; int8 pages are scaled per (page, KV head) in fp32. With a window,
// keys at or below qpos - window are masked. A masked key gives p = 0
// exactly, and a slot with no live key (length 0 included) outputs 0. The
// query and the output share a float type; the chunk buffer has its own.
//
// What bounds it on the H100: bytes. A call reads each live K/V row once
// (2 bytes per element in bf16, 1 in int8 plus a 4-byte scale per page
// and head), the query and the chunk rows <= step, and writes the output;
// at G = Hq / Hkv = 4 that is ~4 FLOP per byte, far below the card's
// bytes-per-FLOP line, so the products stay on the fp32 CUDA cores. At
// the serving shape (8 slots, Hkv 8) there are only 64 (slot, KV head)
// pairs for 132 SMs, and one slot's live range is up to ~1000 positions:
// the time of a call is the latency of its longest walk.
//
// Design:
// - Split of the live range over a thread-block cluster. The grid is (NS,
//   Hkv, B) with cluster dims (NS, 1, 1): the NS blocks of a cluster share
//   one (slot, KV head) and rank r folds its key tiles tile0 + r, tile0 + r
//   + NS, ... (KT positions each), so the split balances whatever the
//   slot's length and the host never reads lengths or starts (device
//   tensors). The chunk buffer's tiles continue the interleave after the
//   last page tile, so each is folded exactly once. Every rank leaves its
//   (m, l, acc[G][D]) in its own shared memory; after cluster.sync() the
//   ranks merge through distributed shared memory (map_shared_rank), each
//   writing a share of the output, and a second cluster.sync() keeps every
//   rank's shared memory alive until it has been read. A rank that saw no
//   live key holds m = -1e30, l = 0, acc = 0 and adds exactly 0. No scratch
//   tensor and no second launch: the entry points' arguments are those of
//   the single-block kernels this body replaced.
// - Loads in flight. Each block keeps a ring of NST = 2 K/V stages of raw
//   page bytes (bf16, int8 or f32: no widening on the way into shared
//   memory) filled by 16-byte cp.async copies: the next tile's copies are
//   issued before the current tile is folded. The page walk (page id, row
//   in the pool, the int8 scales) is done once per key, one tile further
//   ahead than the copies, by one thread per key, so a tile's copies never
//   wait on a table read. Stage rows are padded by 16 bytes, which spreads
//   a warp's row-per-lane reads over the banks. At the serving shape (bf16,
//   G 4, D 128) a block holds 41,008 bytes of shared memory, so five share
//   an SM and all 512 blocks of a call are resident at once; a third stage
//   (58,928 bytes, three blocks per SM) measured slower on every shape but
//   the serving one, and 4 or 16 ranks per cluster slower than 8, on the
//   H100 (PERF.md).
// - The fold widens at use. Q K^T: each warp takes a query row and each
//   lane a key (KT = 32), so a key's dot product needs no shuffles; the
//   warp reduces the tile's max and sum once per row (5 shuffles each per
//   tile, not per key). P V: each thread owns 4 dims of a query row and
//   reads the V rows' matching 4 elements. int8 codes are widened by byte
//   permutes (exact), K's scale multiplies the dot, V's scale the weight.
//   The query and the running (acc, m, l) of each row live in shared
//   memory as fp32, so G is a run-time value.
// - Shared memory above 48 KB: the ring is sized for the widest row type
//   of the call (the chunk buffer's too), and each kernel is opted in once
//   per device to the device's limit; a launch that needs more than the
//   device allows is refused and returns its error (the wrapper raises).
#pragma once

#include <cooperative_groups.h>

#include <mutex>
#include <utility>
#include <vector>

#include "attn_common.cuh"

namespace swarm {

constexpr int kDecodeSplit = 8;      // NS: cluster ranks per (slot, KV head)
constexpr int kDecodeKT = 32;        // positions per key tile: one per lane
constexpr int kDecodeStages = 2;     // NST: K/V tiles in the ring
constexpr int kDecodeThreads = 128;  // 4 warps per block

// Everything a decode kernel takes; fields a kernel does not use are 0.
struct DecodeArgs {
  int q_code, c_code;      // FloatCodes of the query / output, the chunk
  const void* q;           // [B, Hq, D]
  const void* k;           // [P, ps, Hkv, D] pages or [B, S, Hkv, D] lanes
  const void* v;
  const float* ks;         // [P, Hkv] (int8 pages only)
  const float* vs;
  const int* table;        // [B, maxp] (paged only)
  const void* ck;          // [B, Kc, Hkv, D] (chunked only)
  const void* cv;
  const int* pos;          // [B]: lengths (single step) or starts (chunked)
  int step, window;
  float scale;
  void* out;               // [B, Hq, D]
  int B, Hq, Hkv, P, ps, maxp, S, Kc;
#ifdef SWARM_KERNCHECK
  KcArgs kc;               // the checked build's record (attn_common.cuh)
#endif
};

// Where a cache keeps position pos of slot b, KV head h: a row index in
// units of D elements, and for int8 pages the page's K and V scales.
template <typename TP, int D> struct PagedCache {
  __device__ __forceinline__ static int coverage(const DecodeArgs& a) {
    return a.maxp * a.ps;
  }
  __device__ __forceinline__ static int64_t row(const DecodeArgs& a, int b,
                                                int h, int pos, float* sk,
                                                float* sv) {
    const PagedRows<TP, D> pr{static_cast<const TP*>(a.k), a.ks,
                              a.table + (int64_t)b * a.maxp,
                              a.P, a.ps, a.Hkv, a.maxp, h SWARM_KC(a.kc)};
    const int pg = pr.page(pos);
    if constexpr (std::is_same<TP, int8_t>::value) {
      *sk = __ldg(a.ks + (int64_t)pg * a.Hkv + h);
      *sv = __ldg(a.vs + (int64_t)pg * a.Hkv + h);
    }
    return ((int64_t)pg * a.ps + pos % a.ps) * a.Hkv + h;
  }
};

template <typename TP, int D> struct DenseCache {
  __device__ __forceinline__ static int coverage(const DecodeArgs& a) {
    return a.S;
  }
  __device__ __forceinline__ static int64_t row(const DecodeArgs& a, int b,
                                                int h, int pos, float*,
                                                float*) {
    return ((int64_t)b * a.S + pos) * a.Hkv + h;
  }
};

// Byte offsets of a block's dynamic shared memory; rs is the stage row
// stride (the widest row of the call + 16 bytes).
struct DecodeLayout {
  int rs, G, D;
  __host__ __device__ size_t stage(int s) const {
    return (size_t)s * 2 * kDecodeKT * rs;
  }
  __host__ __device__ size_t q() const { return stage(kDecodeStages); }
  __host__ __device__ size_t acc() const { return q() + (size_t)G * D * 4; }
  __host__ __device__ size_t rows() const {  // int64 [NST + 1][KT]
    return acc() + (size_t)G * D * 4;
  }
  __host__ __device__ size_t scales() const {  // float [NST + 1][2][KT]
    return rows() + (size_t)(kDecodeStages + 1) * kDecodeKT * 8;
  }
  __host__ __device__ size_t p() const {  // float [G][KT]
    return scales() + (size_t)(kDecodeStages + 1) * 2 * kDecodeKT * 4;
  }
  __host__ __device__ size_t stats() const {  // float [3][G]: m, l, alpha
    return p() + (size_t)G * kDecodeKT * 4;
  }
  __host__ __device__ size_t bytes() const {
    return stats() + (size_t)3 * G * 4;
  }
};

__host__ __device__ inline int decode_row_stride(int page_row_bytes,
                                                 int chunk_row_bytes) {
  return (page_row_bytes > chunk_row_bytes ? page_row_bytes
                                           : chunk_row_bytes) + 16;
}

// Four consecutive elements of a shared-memory row widened to floats.
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x, f[1] = a.y, f[2] = c.x, f[3] = c.y;
  }
};
template <> struct Vec4<int8_t> {
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    widen_i8x4(*reinterpret_cast<const uint32_t*>(p), f);
  }
};

// One key tile of a rank: the positions [first, first + nrows) of the
// cache, or the chunk entries [first, first + nrows).
struct DecodeTile {
  bool chunk;
  int first, nrows;
};

// Fold one key tile (raw rows of type TE in stage Kt / Vt) into the
// block's running state. Block-wide; ends with the P V update done.
template <typename TE, int D>
__device__ __forceinline__ void decode_fold(
    const unsigned char* Kt, const unsigned char* Vt, const float* sk,
    const float* sv, int rs, int nrows, int key0, int qpos, int window,
    float scale, int G, const float* qs, float* acc, float* ps, float* m,
    float* l, float* alpha) {
  constexpr int EPV = Vec16<TE>::N;
  constexpr int VPR = D / EPV;  // 16-byte vectors per row
  constexpr int DC = D / 4;     // 4-dim chunks per row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = kDecodeThreads / 32;
  const bool ok = lane < nrows &&
                  (window <= 0 || key0 + lane > qpos - window);
  for (int g = warp; g < G; g += NW) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, not one
    if (lane < nrows) {
      const uint4* kr = reinterpret_cast<const uint4*>(Kt + lane * rs);
      const float4* q4 = reinterpret_cast<const float4*>(qs + g * D);
#pragma unroll
      for (int v = 0; v < VPR; ++v) {
        float f[EPV];
        Vec16<TE>::widen(kr[v], f);
#pragma unroll
        for (int e = 0; e < EPV / 4; ++e) {
          const float4 qq = q4[v * (EPV / 4) + e];
          part[0] = fmaf(qq.x, f[4 * e], part[0]);
          part[1] = fmaf(qq.y, f[4 * e + 1], part[1]);
          part[2] = fmaf(qq.z, f[4 * e + 2], part[2]);
          part[3] = fmaf(qq.w, f[4 * e + 3], part[3]);
        }
      }
    }
    const float dot = (part[0] + part[1]) + (part[2] + part[3]);
    const float s = ok ? dot * sk[lane] * scale : kNeg;
    float mt = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float m_old = m[g];
    const float m_new = fmaxf(m_old, mt);
    const float p = ok ? __expf(s - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    ps[g * kDecodeKT + lane] = ok ? p * sv[lane] : 0.f;
    __syncwarp();
    if (lane == 0) {
      const float al = __expf(m_old - m_new);
      m[g] = m_new;
      l[g] = l[g] * al + psum;
      alpha[g] = al;
    }
  }
  __syncthreads();
  for (int x = tid; x < G * DC; x += kDecodeThreads) {
    const int g = x / DC, c = x % DC;
    const float al = alpha[g];
    float4* ap = reinterpret_cast<float4*>(acc + g * D) + c;
    float4 a = *ap;
    a.x *= al, a.y *= al, a.z *= al, a.w *= al;
    const float* pr = ps + g * kDecodeKT;
    const unsigned char* vp = Vt + c * 4 * sizeof(TE);
#pragma unroll 4
    for (int t = 0; t < nrows; ++t) {
      float f[4];
      Vec4<TE>::load(vp + t * rs, f);
      const float w = pr[t];
      a.x = fmaf(w, f[0], a.x);
      a.y = fmaf(w, f[1], a.y);
      a.z = fmaf(w, f[2], a.z);
      a.w = fmaf(w, f[3], a.w);
    }
    *ap = a;
  }
}

// The body of all six kernels. Cache is PagedCache or DenseCache over
// element type TP; CHUNKED adds the chunk segment.
template <class Cache, bool CHUNKED, typename TP, int D>
__device__ __forceinline__ void decode_cluster_block(const DecodeArgs& a) {
  namespace cg = cooperative_groups;
  constexpr int NS = kDecodeSplit, KT = kDecodeKT, NST = kDecodeStages;
  constexpr int T = kDecodeThreads, DC = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x;
  const int csize = CHUNKED ? (a.c_code == kBF16 ? 2 : 4) : 0;
  const int rs = decode_row_stride(D * (int)sizeof(TP), D * csize);
  const DecodeLayout lay{rs, G, D};
  float* qs = reinterpret_cast<float*>(smem + lay.q());
  float* acc = reinterpret_cast<float*>(smem + lay.acc());
  int64_t* rows = reinterpret_cast<int64_t*>(smem + lay.rows());
  float* scl = reinterpret_cast<float*>(smem + lay.scales());
  float* ps = reinterpret_cast<float*>(smem + lay.p());
  float* m = reinterpret_cast<float*>(smem + lay.stats());
  float* l = m + G;
  float* alpha = l + G;

  // The query position, the live cache range [tile0 * KT, end) and the
  // chunk entries [0, n_chunk); this rank's tiles.
  int qpos, end, start = 0, n_chunk = 0;
  if constexpr (CHUNKED) {
    start = a.pos[b];
    qpos = start + a.step;
    end = min(start, Cache::coverage(a));
    n_chunk = min(a.Kc, a.step + 1);
  } else {
    qpos = a.pos[b] - 1;
    end = min(a.pos[b], Cache::coverage(a));
  }
#ifdef SWARM_KERNCHECK
  if (tid == 0 && a.pos[b] > Cache::coverage(a))
    kc_record(a.kc, 0, kKcCoverage, a.pos[b], Cache::coverage(a), -1);
#endif
  int tile0 = 0;
  if (a.window > 0) {
    const int lo = qpos - a.window + 1;
    if (lo > 0) tile0 = lo / KT;
  }
  const int n_page = max(0, (end > 0 ? (end + KT - 1) / KT : 0) - tile0);
  const int n_total = n_page + (n_chunk + KT - 1) / KT;
  const int n_mine = rank < n_total ? (n_total - rank + NS - 1) / NS : 0;
  auto tile = [&](int i) {
    const int gi = rank + i * NS;
    DecodeTile t;
    t.chunk = CHUNKED && gi >= n_page;
    t.first = t.chunk ? (gi - n_page) * KT : (tile0 + gi) * KT;
    t.nrows = min(KT, (t.chunk ? n_chunk : end) - t.first);
    return t;
  };

  // The page walk of tiles [i0, i0 + n): one thread per key.
  auto walk = [&](int i0, int n) {
    for (int x = tid; x < n * KT; x += T) {
      const int i = i0 + x / KT, k = x % KT;
      if (i >= n_mine) continue;
      const DecodeTile t = tile(i);
      if (k >= t.nrows) continue;
      const int w = i % (NST + 1);
      float sk = 1.f, sv = 1.f;
      int64_t r;
      if (t.chunk)
        r = ((int64_t)b * a.Kc + t.first + k) * a.Hkv + h;
      else
        r = Cache::row(a, b, h, t.first + k, &sk, &sv);
      rows[w * KT + k] = r;
      scl[(2 * w) * KT + k] = sk;
      scl[(2 * w + 1) * KT + k] = sv;
    }
  };
  // The copies of tile i into stage i % NST; one commit group per tile.
  auto issue = [&](int i) {
    if (i < n_mine) {
      const DecodeTile t = tile(i);
      const int64_t* wr = rows + (i % (NST + 1)) * KT;
      unsigned char* kd = smem + lay.stage(i % NST);
      unsigned char* vd = kd + KT * rs;
      const char* kb = static_cast<const char*>(t.chunk ? a.ck : a.k);
      const char* vb = static_cast<const char*>(t.chunk ? a.cv : a.v);
      const int rb = D * (t.chunk ? csize : (int)sizeof(TP));
      const int vpr = rb / 16;
      for (int x = tid; x < t.nrows * vpr; x += T) {
        const int r = x / vpr, c = x % vpr;
        const int64_t off = wr[r] * rb + c * 16;
        cp_async16(kd + r * rs + c * 16, kb + off, true);
        cp_async16(vd + r * rs + c * 16, vb + off, true);
      }
    }
    cp_async_commit();
  };

  const int64_t qoff = ((int64_t)b * a.Hq + (int64_t)h * G) * D;
  for (int x = tid; x < G * D; x += T) {
    qs[x] = a.q_code == kBF16
                ? to_f(static_cast<const __nv_bfloat16*>(a.q)[qoff + x])
                : static_cast<const float*>(a.q)[qoff + x];
    acc[x] = 0.f;
  }
  for (int g = tid; g < G; g += T) {
    m[g] = kNeg;
    l[g] = 0.f;
  }
  walk(0, NST);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) issue(i);
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile i landed; tile i - 1's stage and walk are free
    issue(i + NST - 1);
    walk(i + NST, 1);
    const DecodeTile t = tile(i);
    const unsigned char* kt = smem + lay.stage(i % NST);
    const float* sk = scl + 2 * (i % (NST + 1)) * KT;
    if constexpr (CHUNKED) {
      if (t.chunk) {
        if (a.c_code == kBF16)
          decode_fold<__nv_bfloat16, D>(
              kt, kt + KT * rs, sk, sk + KT, rs, t.nrows, start + t.first,
              qpos, a.window, a.scale, G, qs, acc, ps, m, l, alpha);
        else
          decode_fold<float, D>(kt, kt + KT * rs, sk, sk + KT, rs, t.nrows,
                                start + t.first, qpos, a.window, a.scale, G,
                                qs, acc, ps, m, l, alpha);
        continue;
      }
    }
    decode_fold<TP, D>(kt, kt + KT * rs, sk, sk + KT, rs, t.nrows, t.first,
                       qpos, a.window, a.scale, G, qs, acc, ps, m, l, alpha);
  }
  cp_async_wait_all();

  // Merge the ranks' states through distributed shared memory; rank r
  // writes the 4-dim chunks x = r, r + NS, ... of the G output rows.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int x = rank + NS * tid; x < G * DC; x += NS * T) {
    const int g = x / DC, c = x % DC;
    float mr[NS];
    float M = kNeg;
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      mr[r] = cluster.map_shared_rank(m, r)[g];
      M = fmaxf(M, mr[r]);
    }
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      const float w = __expf(mr[r] - M);
      L = fmaf(w, cluster.map_shared_rank(l, r)[g], L);
      const float4 v =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(acc, r))[x];
      A.x = fmaf(w, v.x, A.x);
      A.y = fmaf(w, v.y, A.y);
      A.z = fmaf(w, v.z, A.z);
      A.w = fmaf(w, v.w, A.w);
    }
    const float den = fmaxf(L, 1e-30f);
    const float o[4] = {A.x / den, A.y / den, A.z / den, A.w / den};
    const int64_t off = qoff + 4 * (int64_t)x;
#ifdef SWARM_KERNCHECK
    // the writer of a (slot, head) row is its cluster: rank 0's linear id
    if (c == 0) kc_stamp(a.kc, b, h * G + g, kc_block_id() - rank);
#endif
    if (a.q_code == kBF16) {
      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.out) + off;
#pragma unroll
      for (int e = 0; e < 4; ++e) op[e] = from_f<__nv_bfloat16>(o[e]);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + off) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  cluster.sync();  // no rank leaves while another may still read it
}

// The four kernels (profiler names), each an instance of the one body.
// Launched as clusters of kDecodeSplit blocks along x (launch_decode).
#define SWARM_DECODE_KERNEL(NAME, CACHE, CHUNKED)                       \
  template <typename TP, int D>                                         \
  __global__ void __launch_bounds__(kDecodeThreads)                     \
      NAME(const DecodeArgs a) {                                        \
    decode_cluster_block<CACHE<TP, D>, CHUNKED, TP, D>(a);              \
  }
SWARM_DECODE_KERNEL(paged_decode_cluster_kernel, PagedCache, false)
SWARM_DECODE_KERNEL(paged_decode_chunked_cluster_kernel, PagedCache, true)
SWARM_DECODE_KERNEL(dense_decode_cluster_kernel, DenseCache, false)
SWARM_DECODE_KERNEL(dense_decode_chunked_cluster_kernel, DenseCache, true)
#undef SWARM_DECODE_KERNEL

template <typename TP, int D, bool DENSE, bool CHUNKED>
inline void (*decode_kernel())(DecodeArgs) {
  if constexpr (DENSE && CHUNKED)
    return dense_decode_chunked_cluster_kernel<TP, D>;
  else if constexpr (DENSE)
    return dense_decode_cluster_kernel<TP, D>;
  else if constexpr (CHUNKED)
    return paged_decode_chunked_cluster_kernel<TP, D>;
  else
    return paged_decode_cluster_kernel<TP, D>;
}

// Opt a kernel in to the device's whole dynamic shared memory once per
// device. Static: the record belongs to this library's kernels.
static cudaError_t decode_smem_opt_in(const void* kernel, int dev) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == kernel && d.second == dev) return cudaSuccess;
  int limit = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (e == cudaSuccess) done.emplace_back(kernel, dev);
  return e;
}

// One launch: a grid of (NS, Hkv, B) blocks in clusters of (NS, 1, 1).
template <typename TP, int D, bool DENSE, bool CHUNKED>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  void (*kernel)(DecodeArgs) = decode_kernel<TP, D, DENSE, CHUNKED>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = decode_smem_opt_in(reinterpret_cast<const void*>(kernel), dev);
  if (e != cudaSuccess) return e;
  const int csize = CHUNKED ? (a.c_code == kBF16 ? 2 : 4) : 0;
  const DecodeLayout lay{decode_row_stride(D * (int)sizeof(TP), D * csize),
                         a.Hq / a.Hkv, D};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kDecodeSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
#ifdef SWARM_KERNCHECK
  DecodeArgs ka = a;
  ka.kc = kc_args();
#else
  const DecodeArgs& ka = a;
#endif
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kDecodeSplit, a.Hkv, a.B);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = lay.bytes();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, ka);
  return SWARM_KC_DONE(e != cudaSuccess ? e : cudaGetLastError(), stream);
}

// One instance per head dim the wrappers accept (ops/attention_cuda.py).
// DENSE picks the lane walk; CHUNKED the chunk segment.
template <typename TP, bool DENSE, bool CHUNKED>
cudaError_t decode_d(int D, const DecodeArgs& a, cudaStream_t stream) {
  if (a.B == 0) return cudaSuccess;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || (DENSE && a.S <= 0) ||
      a.q_code < kF32 || a.q_code > kBF16 ||
      (CHUNKED && (a.c_code < kF32 || a.c_code > kBF16)))
    return cudaErrorInvalidValue;
#define SWARM_CASE(DV) \
  case DV:             \
    return launch_decode<TP, DV, DENSE, CHUNKED>(a, stream);
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

// The shared memory a launch at these dims passes (DecodeLayout::bytes),
// with the instance's attributes after the launch's own opt-in: the
// `swarm_<entry>_smem` queries (attn_common.cuh SmemInfo).
template <typename TP, int D, bool DENSE, bool CHUNKED>
cudaError_t decode_smem_info_d(int G, int c_code, long long* info) {
  void (*kernel)(DecodeArgs) = decode_kernel<TP, D, DENSE, CHUNKED>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = decode_smem_opt_in(reinterpret_cast<const void*>(kernel), dev);
  if (e != cudaSuccess) return e;
  const int csize = CHUNKED ? (c_code == kBF16 ? 2 : 4) : 0;
  const DecodeLayout lay{decode_row_stride(D * (int)sizeof(TP), D * csize),
                         G, D};
  return smem_info(kernel, lay.bytes(), kDecodeThreads, 0, info);
}

template <typename TP, bool DENSE, bool CHUNKED>
cudaError_t decode_smem_info(int D, int Hq, int Hkv, int c_code,
                             long long* info) {
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      (CHUNKED && (c_code < kF32 || c_code > kBF16)))
    return cudaErrorInvalidValue;
#define SWARM_CASE(DV) \
  case DV:             \
    return decode_smem_info_d<TP, DV, DENSE, CHUNKED>(Hq / Hkv, c_code, info);
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
