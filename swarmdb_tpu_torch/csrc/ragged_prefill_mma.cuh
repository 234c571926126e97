// Packed ragged paged prefill attention on the H100's tensor cores: the
// body that ragged_prefill.cu and ragged_prefill_quant.cu route to when
// the query, the packed suffix and the pages are bf16 (ragged_prefill) or
// the query and suffix are bf16 over int8 pages (ragged_prefill_quant).
// Every other combination (any float32 operand) stays on the fp32 body of
// ragged_prefill.cuh, whose f32 results are held to 1e-4.
//
// Replaces the Pallas kernels `_ragged_prefill_kernel` (wrapper
// `ragged_paged_prefill_attention`) and `_ragged_prefill_kernel_quant`
// (wrapper `ragged_paged_prefill_attention_quant`) of
// swarmdb_tpu/ops/attention_pallas.py, with the contract of
// ragged_prefill.cuh: row r of the wave owns stream positions [starts[r],
// starts[r] + lens[r]) and has prefix_lens[r] tokens in its pages; each of
// its tokens attends the row's prefix positions (through the table row,
// never past its coverage maxp * ps) and the row's own suffix keys
// causally, with an optional sliding window; masked keys get p = 0
// exactly and a row with no live key outputs 0; positions no row owns are
// left as allocated (zeros). int8 pages carry one f32 scale per (page, KV
// head), read through the same clamped page id as the payload.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3 at 700 W, timed by
// chip_smoke.py): at chip_smoke's 512-token wave the work is 2.26 GFLOP
// (2.3 us at the bf16 tensor-core peak) over ~14 MB of inputs and outputs
// (4.2 us at HBM rate), and the kernel takes ~37 us. It is bound by
// latency: the serial walk of the longest row's key tiles (row 4: 512
// prefix + up to 112 suffix keys, 10 tiles), under ~3.7 us a tile with
// launch, schedule and first loads included.
//
// Design:
// - Work split: one block = a query tile of QT = 64 / G tokens of one row
//   x the G query heads of one KV head, packed as M = 64 rows (token-
//   major: row m is token m / G, head m % G). The block walks its key
//   tiles (KT = 64 positions: the row's prefix pages, then its suffix keys
//   up to its last query) with one or two groups of 4 warps; in a group
//   warp w owns rows 16w..16w+15. A block's key walk is a serial chain
//   (load, Q K^T, softmax, P V; ~2.2 us per tile for a block alone on its
//   SM), so a wave takes as long as its longest row's walk. Two groups
//   take alternate tiles on their own barriers and merge their (m, l, O)
//   in shared memory at the end (flash-decoding's merge inside one block,
//   so no second kernel and no scratch buffer): that halves the chain but
//   needs 256 threads, one block per SM. The launch takes two groups when
//   the wave's query tiles x KV heads fit one block per SM, else one (two
//   4-warp blocks per SM); the host knows that bound (W) without a sync.
// - Products: S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate). Q stays in registers as A fragments; K feeds the B
//   operand through ldmatrix, V through ldmatrix.trans. mma.sync rather
//   than wgmma: the kernel is bound by the latency of that chain, not by
//   the tensor rate, and mma.sync keeps the fragments in registers where
//   the online softmax needs them.
// - Online softmax on the accumulator fragments (log2 domain): row max
//   and row sum over the 4 lanes of a quad, running m / l / O in
//   registers; P is rounded to bf16 for the PV product (the plain version
//   rounds it to the pages' bf16 too). int8 pages: the MMA sees the
//   widened int8 codes (exact in bf16); each score column is multiplied by
//   its key's K scale before the mask and the max, and each P column by
//   its key's V scale before it is rounded (l sums the unscaled P).
// - Loads overlap the products: each group has two K/V stages in shared
//   memory (rows padded by 16 bytes, so ldmatrix reads are free of bank
//   conflicts) and issues its next tile's loads before it folds the
//   current one: cp.async 16-byte copies for bf16 rows, or for int8 pages
//   16-byte register loads that are widened into the stage after the
//   fold. The page-table walk (page id, row in the pool, int8 scale
//   index) is done once per key, two tiles ahead, by the group's first KT
//   threads, so issuing a tile's copies waits on no table read.
// - Per-wave tile schedule: the grid is ceil(W / QT) + R query tiles x
//   Hkv, an upper bound of sum_r ceil(lens[r] / QT) known without a host
//   sync. Each block ranks the rows by prefix + length (heaviest first)
//   and takes its (row, tile) from the ranked prefix sums; blocks past the
//   total exit at once. Within a row the last tile (most suffix keys)
//   goes first.
// - A warp skips a key tile in which none of its rows sees a key (causal
//   tail, window), and applies no mask to a tile every one of its rows
//   sees whole.
#pragma once

#include <atomic>

#include "attn_common.cuh"

namespace swarm {

constexpr int kMmaGroupThreads = 128;  // 4 warps, 16 query rows each
constexpr int kMmaRows = 64;           // query rows per block
constexpr int kMmaKT = 64;             // keys per tile

// Dynamic shared memory of one block: the Q tile (reused to stage the
// output); per group two stages of K and V bf16 rows padded to DS
// elements, the stages' int8 K / V scales, and two slots of the page walk
// (each key's row in the pool, its scale index). After the key walk the
// stages hold the other groups' (m, l, O) for the merge.
template <int D, int NG> struct MmaSmem {
  static constexpr int DS = D + 8;
  static constexpr size_t tile = size_t(kMmaKT) * DS * 2;  // one K or V
  static constexpr size_t q_off = 0;
  static constexpr size_t kv_off = q_off + size_t(kMmaRows) * DS * 2;
  static constexpr size_t sc_off = kv_off + NG * 2 * 2 * tile;
  static constexpr size_t walk_off = sc_off + NG * 2 * 2 * kMmaKT * 4;
  static constexpr size_t bytes = walk_off + NG * 2 * 2 * kMmaKT * 4;
  static constexpr size_t merge = size_t(NG - 1) * kMmaRows * (D + 2) * 4;
  static_assert(merge <= NG * 2 * 2 * tile, "merge area fits");
};

// Barrier of one group's threads (named barrier 1 + g); the block-wide
// __syncthreads uses barrier 0.
template <int NG>
__device__ __forceinline__ void group_sync(int g) {
  if constexpr (NG == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(kMmaGroupThreads)
                 : "memory");
  }
}

template <typename TP, int D, int NG>
__global__ void __launch_bounds__(kMmaGroupThreads * NG)
ragged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,   // [W, Hq, D]
                          const __nv_bfloat16* __restrict__ sk,  // [W, Hkv, D]
                          const __nv_bfloat16* __restrict__ sv,
                          const TP* __restrict__ kp,  // [P, ps, Hkv, D]
                          const float* __restrict__ ks,  // [P, Hkv] (int8)
                          const TP* __restrict__ vp,
                          const float* __restrict__ vs,
                          const int* __restrict__ tables,  // [R, maxp]
                          const int* __restrict__ starts,  // [R]
                          const int* __restrict__ lens,
                          const int* __restrict__ plens,
                          __nv_bfloat16* __restrict__ out,  // [W, Hq, D]
                          int W, int R, int Hq, int Hkv, int P, int ps,
                          int maxp, int window,
                          float scale SWARM_KC(const KcArgs kc)) {
  using L = MmaSmem<D, NG>;
  using bf16 = __nv_bfloat16;
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr int DS = L::DS;
  constexpr int KT = kMmaKT;
  constexpr int NT = KT / 8;    // score n-tiles per key tile
  constexpr int DK = D / 16;    // k-steps of Q K^T
  constexpr int DN = D / 8;     // output n-tiles
  constexpr int CPR = D / 8;    // 16-byte chunks per bf16 row
  constexpr int TG = kMmaGroupThreads;
  constexpr int T = TG * NG;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(KT % 16 == 0 && KT <= 64 && KT <= TG && TG % CPR == 0,
                "key validity is kept in a 32-bit mask per tile");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  __shared__ int pick[2];

  const int tid = threadIdx.x;
  const int grp = tid / TG, gt = tid % TG;  // group, thread in group
  const int warp = gt / 32, lane = tid % 32;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int QT = kMmaRows / G;  // query tokens per tile
  const int cov = maxp * ps;    // positions the table row can reach

  // ---- per-wave tile schedule: rows ranked heaviest first
  auto weight = [&](int row) { return min(plens[row], cov) + lens[row]; };
  if (tid == 0) pick[0] = -1;
  __syncthreads();
  for (int r = tid; r < R; r += T) {
    const int n_r = lens[r] > 0 ? (lens[r] + QT - 1) / QT : 0;
    if (n_r == 0) continue;
    const int w_r = weight(r);
    int off = 0;  // tiles of the rows ranked before r
    for (int o = 0; o < R; ++o) {
      const int n_o = lens[o] > 0 ? (lens[o] + QT - 1) / QT : 0;
      const int w_o = weight(o);
      if (w_o > w_r || (w_o == w_r && o < r)) off += n_o;
    }
    const int b = static_cast<int>(blockIdx.x) - off;
    if (b >= 0 && b < n_r) {
      pick[0] = r;
      pick[1] = n_r - 1 - b;  // the row's last tile first
    }
  }
  __syncthreads();
  const int r = pick[0];
  if (r < 0) return;  // past the wave's tiles: uniform over the block
  const int start = starts[r];
#ifdef SWARM_KERNCHECK
  if (tid == 0 && lens[r] > W - start)
    kc_record(kc, 0, kKcRowLen, start + lens[r], W, -1);
#endif
  const int len = min(lens[r], W - start);  // never past the stream
  const int plen = plens[r];
  const int q_first = pick[1] * QT;
  if (q_first >= len) return;
  const int nq = min(QT, len - q_first);  // live tokens of the tile
  const int q_last = q_first + nq - 1;
  const int pend = min(plen, cov);

  // ---- the key tiles: prefix [p_tile0 * KT, pend), suffix [k_lo, q_last];
  // this group's are grp, grp + NG, ...
  int p_tile0 = 0, k_lo = 0;
  if (window > 0) {
    const int lo_p = plen + q_first - window + 1;  // lowest key any query sees
    if (lo_p > 0) p_tile0 = lo_p / KT;
    const int lo_s = q_first - window + 1;
    if (lo_s > 0) k_lo = lo_s / KT * KT;
  }
  const int n_pre = max(0, (pend + KT - 1) / KT - p_tile0);
  const int n_tiles = n_pre + (q_last - k_lo) / KT + 1;
  const int n_mine = (n_tiles - grp + NG - 1) / NG;

  bf16* Ks = reinterpret_cast<bf16*>(smem + L::kv_off) + grp * 4 * KT * DS;
  bf16* Vs = Ks + 2 * KT * DS;  // [stage][KT][DS] each
  float* Sc = reinterpret_cast<float*>(smem + L::sc_off) + grp * 4 * KT;
  int* walk = reinterpret_cast<int*>(smem + L::walk_off) + grp * 4 * KT;

  const int* trow = tables + static_cast<int64_t>(r) * maxp;
  const PagedRows<TP, D> kr{kp, ks, trow, P, ps, Hkv, maxp, h SWARM_KC(kc)};
  const int64_t hd = static_cast<int64_t>(h) * D;
  const int64_t rstride = static_cast<int64_t>(Hkv) * D;  // pool row stride

  auto tile_base = [&](int i) {
    return i < n_pre ? (p_tile0 + i) * KT : k_lo + (i - n_pre) * KT;
  };
  // page walk of prefix tile i into slot: each key's row in the pool (-1
  // past the prefix) and, for int8 pages, its scale index (page * Hkv + h)
  auto walk_pages = [&](int i, int slot) {
    if (i >= n_pre || gt >= KT) return;
    const int pos = tile_base(i) + gt;
    const bool ok = pos < pend;
    const int pg = kr.page(ok ? pos : 0);
    walk[slot * 2 * KT + gt] = ok ? pg * ps + pos % ps : -1;
    if constexpr (kQuant) walk[slot * 2 * KT + KT + gt] = pg * Hkv + h;
  };

  // ---- loads. bf16 rows go by cp.async straight into a stage; int8 page
  // rows are loaded into registers (prefetch) and widened into the stage
  // after the current tile's fold (land).
  constexpr int C8 = D / 16;                      // int8 chunks per row
  constexpr int NL = (KT * C8 + TG - 1) / TG;     // int8 chunks per thread
  uint4 k8[NL], v8[NL];
  float ksc = 0.f, vsc = 0.f;

  auto prefetch = [&](int i, int stage, int slot) {
    const int base = tile_base(i);
    bf16* kd = Ks + stage * KT * DS;
    bf16* vd = Vs + stage * KT * DS;
    const int* prow = walk + slot * 2 * KT;
    if (i >= n_pre) {  // suffix keys, row-relative base..base+KT-1
      for (int c = gt; c < KT * CPR; c += TG) {
        const int row = c / CPR, cc = c % CPR;
        const int kk = base + row;
        const bool ok = kk <= q_last;
        const int64_t off =
            (static_cast<int64_t>(start + (ok ? kk : 0)) * Hkv + h) * D +
            cc * 8;
        cp_async16(kd + row * DS + cc * 8, sk + off, ok);
        cp_async16(vd + row * DS + cc * 8, sv + off, ok);
      }
      cp_async_commit();
    } else if constexpr (!kQuant) {  // bf16 prefix pages
      for (int c = gt; c < KT * CPR; c += TG) {
        const int row = c / CPR, cc = c % CPR;
        const int pr = prow[row];
        const int64_t off = pr >= 0 ? pr * rstride + hd + cc * 8 : 0;
        cp_async16(kd + row * DS + cc * 8, kp + off, pr >= 0);
        cp_async16(vd + row * DS + cc * 8, vp + off, pr >= 0);
      }
      cp_async_commit();
    } else {  // int8 prefix pages: into registers
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const int c = gt + j * TG;
        const int row = min(c / C8, KT - 1), cc = c % C8;
        const int pr = prow[row];
        if (c < KT * C8 && pr >= 0) {
          const int64_t off = pr * rstride + hd + cc * 16;
          k8[j] = __ldg(reinterpret_cast<const uint4*>(kp + off));
          v8[j] = __ldg(reinterpret_cast<const uint4*>(vp + off));
        } else {
          k8[j] = make_uint4(0u, 0u, 0u, 0u);
          v8[j] = k8[j];
        }
      }
      if (gt < KT) {
        const bool ok = prow[gt] >= 0;
        const int si = prow[KT + gt];
        ksc = ok ? __ldg(ks + si) : 0.f;
        vsc = ok ? __ldg(vs + si) : 0.f;
      }
    }
  };
  auto land = [&](int i, int stage) {
    if constexpr (kQuant) {
      if (i < n_pre) {
        bf16* kd = Ks + stage * KT * DS;
        bf16* vd = Vs + stage * KT * DS;
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          const int c = gt + j * TG;
          if (c < KT * C8) {
            const int row = c / C8, cc = c % C8;
            uint4* kdst = reinterpret_cast<uint4*>(kd + row * DS + cc * 16);
            uint4* vdst = reinterpret_cast<uint4*>(vd + row * DS + cc * 16);
            widen_i8_bf16(k8[j], kdst[0], kdst[1]);
            widen_i8_bf16(v8[j], vdst[0], vdst[1]);
          }
        }
        if (gt < KT) {
          Sc[stage * 2 * KT + gt] = ksc;
          Sc[stage * 2 * KT + KT + gt] = vsc;
        }
        return;
      }
    }
    cp_async_wait_all();
  };

  // ---- the Q tile (row m = token m / G, head m % G) and each group's
  // first keys
  for (int c = tid; c < kMmaRows * CPR; c += T) {
    const int m = c / CPR, cc = c % CPR;
    const int t = m / G, g = m % G;
    const bool ok = t < nq && m < QT * G;
    const int64_t off =
        ok ? (static_cast<int64_t>(start + q_first + t) * Hq + h * G + g) *
                     D + cc * 8
           : 0;
    cp_async16(Qs + m * DS + cc * 8, q + off, ok);
  }
  cp_async_commit();
  walk_pages(grp, 0);
  walk_pages(grp + NG, 1);
  group_sync<NG>(grp);
  if (n_mine > 0) {
    prefetch(grp, 0, 0);
    land(grp, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * DS + kk * 16 +
                            (lane >> 4) * 8);

  // this thread's two rows (quad row, quad row + 8): live, and the open
  // key interval (lo, hi) of each segment
  int plo[2], phi[2], slo[2], shi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int m = warp * 16 + lane / 4 + 8 * rr;
    const int t = m / G;
    const bool live = t < nq && m < QT * G;
    const int qi = q_first + t;  // row-relative query index
    phi[rr] = live ? pend : -1;
    plo[rr] = window > 0 ? plen + qi - window : -1;
    shi[rr] = live ? qi + 1 : -1;
    slo[rr] = window > 0 ? qi - window : -1;
  }

  constexpr float kLog2e = 1.4426950408889634f;
  const float sl2 = scale * kLog2e;
  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_mine; ++j) {
    const int i = grp + j * NG;  // the tile folded now
    const int stage = j & 1;
    if (j + 1 < n_mine) prefetch(i + NG, stage ^ 1, (j + 1) & 1);

    const bool pre = i < n_pre;
    const int base = tile_base(i);
    bool any = false, full = true;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int lo = pre ? plo[rr] : slo[rr];
      const int hi = pre ? phi[rr] : shi[rr];
      any |= max(lo + 1, base) <= min(hi - 1, base + KT - 1);
      full &= lo < base && hi > base + KT - 1;
    }
    any = __any_sync(0xffffffffu, any);
    full = __all_sync(0xffffffffu, full);
    if (any) {
      const bf16* kt = Ks + stage * KT * DS;
      const bf16* vt = Vs + stage * KT * DS;
      const float* ksc_t = Sc + stage * 2 * KT;
      const float* vsc_t = ksc_t + KT;
      const bool scaled = kQuant && pre;

      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
        for (int nn = 0; nn < KT / 16; ++nn) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + (nn * 16 + (lane >> 4) * 8 + (lane & 7)) * DS +
                             kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * nn], qf[kk], b[0], b[1]);
          mma_bf16_16816(s[2 * nn + 1], qf[kk], b[2], b[3]);
        }
      }

      // scale (and dequantize K), mask, tile row max
      unsigned ok = 0xffffffffu;  // bit 4n + e: score s[n][e] is live
      float mt[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * (lane & 3) + (e & 1);
          const int rr = e >> 1;
          float v = s[n][e] * sl2;
          if (scaled) v *= ksc_t[col];
          if (!full) {
            const int key = base + col;
            const int lo = pre ? plo[rr] : slo[rr];
            const int hi = pre ? phi[rr] : shi[rr];
            if (!(key > lo && key < hi)) ok &= ~(1u << (4 * n + e));
          }
          s[n][e] = v;
          if ((ok >> (4 * n + e)) & 1u) mt[rr] = fmaxf(mt[rr], v);
        }
      }
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
        mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
        const float m_new = fmaxf(m_run[rr], mt[rr]);
        alpha[rr] = exp2f(m_run[rr] - m_new);
        m_run[rr] = m_new;
      }

      // P (masked keys exactly 0), partial row sums, P (times the V scale)
      // as bf16 A fragments
      float psum[2] = {0.f, 0.f};
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          const float p = ((ok >> (4 * n + e)) & 1u)
                              ? exp2f(s[n][e] - m_run[rr])
                              : 0.f;
          psum[rr] += p;
          pv[e] = scaled ? p * vsc_t[n * 8 + 2 * (lane & 3) + (e & 1)] : p;
        }
        pa[n / 2][(n & 1) * 2] = pack_bf16(pv[0], pv[1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l_run[rr] = l_run[rr] * alpha[rr] + psum[rr];
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * DS +
                     dd * 16 + (lane >> 4) * 8);
          mma_bf16_16816(o[2 * dd], pa[kk], b[0], b[1]);
          mma_bf16_16816(o[2 * dd + 1], pa[kk], b[2], b[3]);
        }
      }
    }

    walk_pages(i + 2 * NG, j & 1);
    if (j + 1 < n_mine) land(i + NG, stage ^ 1);
    group_sync<NG>(grp);
  }

  // ---- merge the groups' (m, l, O) into group 0, normalize, stage the
  // bf16 rows through the Q buffer, 16-byte stores of the live rows
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 1);
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 2);
  }
  const int m0 = warp * 16 + lane / 4;  // this thread's rows: m0, m0 + 8
  if constexpr (NG > 1) {
    __syncthreads();  // every group is past its key walk: stages are free
    float* mo = reinterpret_cast<float*>(smem + L::kv_off);  // [NG-1][M]
    float* lo = mo + (NG - 1) * kMmaRows;
    float* oo = lo + (NG - 1) * kMmaRows;  // [NG-1][M][D]
    if (grp > 0) {
      const int x = (grp - 1) * kMmaRows;
      if ((lane & 3) == 0) {
        mo[x + m0] = m_run[0];
        mo[x + m0 + 8] = m_run[1];
        lo[x + m0] = l_run[0];
        lo[x + m0 + 8] = l_run[1];
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const int col = n * 8 + 2 * (lane & 3);
        float* o0 = oo + (static_cast<int64_t>(x + m0) * D + col);
        float* o1 = o0 + 8 * D;
        o0[0] = o[n][0];
        o0[1] = o[n][1];
        o1[0] = o[n][2];
        o1[1] = o[n][3];
      }
    }
    __syncthreads();
    if (grp == 0) {
      for (int g2 = 1; g2 < NG; ++g2) {
        const int x = (g2 - 1) * kMmaRows;
        float a[2], b[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float mg = mo[x + m0 + 8 * rr];
          const float mn = fmaxf(m_run[rr], mg);
          a[rr] = exp2f(m_run[rr] - mn);
          b[rr] = exp2f(mg - mn);
          l_run[rr] = l_run[rr] * a[rr] + lo[x + m0 + 8 * rr] * b[rr];
          m_run[rr] = mn;
        }
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          const int col = n * 8 + 2 * (lane & 3);
          const float* o0 = oo + (static_cast<int64_t>(x + m0) * D + col);
          const float* o1 = o0 + 8 * D;
          o[n][0] = o[n][0] * a[0] + o0[0] * b[0];
          o[n][1] = o[n][1] * a[0] + o0[1] * b[0];
          o[n][2] = o[n][2] * a[1] + o1[0] * b[1];
          o[n][3] = o[n][3] * a[1] + o1[1] * b[1];
        }
      }
    }
  }
  if (grp == 0) {
    const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(Qs + m0 * DS + col) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
      *reinterpret_cast<uint32_t*>(Qs + (m0 + 8) * DS + col) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
  __syncthreads();
  for (int c = tid; c < nq * G * CPR; c += T) {
    const int m = c / CPR, cc = c % CPR;
    const int t = m / G, g = m % G;
    const int64_t off =
        (static_cast<int64_t>(start + q_first + t) * Hq + h * G + g) * D +
        cc * 8;
    *reinterpret_cast<uint4*>(out + off) =
        *reinterpret_cast<const uint4*>(Qs + m * DS + cc * 8);
#ifdef SWARM_KERNCHECK
    if (cc == 0) kc_stamp(kc, start + q_first + t, h * G + g, kc_block_id());
#endif
  }
}

// Opt the instance in to its dynamic shared memory (above the 48 KB
// default) once per device; a launch without it would be refused. Static:
// the flags must belong to this library's kernel, and a function-local
// static of an extern template is one object per process (a GNU unique
// symbol), shared by every library that instantiates it.
template <typename TP, int D, int NG>
static cudaError_t mma_smem_opt_in(int dev) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      ragged_prefill_mma_kernel<TP, D, NG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(MmaSmem<D, NG>::bytes));
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

// Streaming multiprocessors of device dev, read once.
static int sm_count(int dev) {
  static std::atomic<int> count[64];
  int n = count[dev & 63].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      n = 0;
    count[dev & 63].store(n);
  }
  return n;
}

template <typename TP, int D, int NG>
cudaError_t launch_ragged_prefill_mma(
    const void* q, const void* sk, const void* sv, const void* kp,
    const float* ks, const void* vp, const float* vs, const int* tables,
    const int* starts, const int* lens, const int* plens, void* out, int W,
    int R, int Hq, int Hkv, int P, int ps, int maxp, int window, float scale,
    int dev, cudaStream_t stream) {
  const cudaError_t e = mma_smem_opt_in<TP, D, NG>(dev);
  if (e != cudaSuccess) return e;
  const int QT = kMmaRows / (Hq / Hkv);
  dim3 grid((W + QT - 1) / QT + R, Hkv);
  using bf16 = __nv_bfloat16;
  ragged_prefill_mma_kernel<TP, D, NG>
      <<<grid, kMmaGroupThreads * NG, MmaSmem<D, NG>::bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(sk),
          static_cast<const bf16*>(sv), static_cast<const TP*>(kp), ks,
          static_cast<const TP*>(vp), vs, tables, starts, lens, plens,
          static_cast<bf16*>(out), W, R, Hq, Hkv, P, ps, maxp, window, scale
          SWARM_KC(kc_args()));
  return SWARM_KC_DONE(cudaGetLastError(), stream);
}

// Two groups per block when the wave's query tiles x KV heads (an upper
// bound of its live blocks) fit one block per SM, else one.
template <typename TP, int D>
cudaError_t launch_ragged_prefill_mma(
    const void* q, const void* sk, const void* sv, const void* kp,
    const float* ks, const void* vp, const float* vs, const int* tables,
    const int* starts, const int* lens, const int* plens, void* out, int W,
    int R, int Hq, int Hkv, int P, int ps, int maxp, int window, float scale,
    cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G > kMmaRows) return cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int QT = kMmaRows / G;
  const bool two =
      static_cast<int64_t>((W + QT - 1) / QT) * Hkv <= sm_count(dev);
  return (two ? launch_ragged_prefill_mma<TP, D, 2>
              : launch_ragged_prefill_mma<TP, D, 1>)(
      q, sk, sv, kp, ks, vp, vs, tables, starts, lens, plens, out, W, R, Hq,
      Hkv, P, ps, maxp, window, scale, dev, stream);
}

// One instance per head dim the wrappers accept (ops/attention_cuda.py),
// as for the fp32 body, so the route depends on the operand types alone.
template <typename TP>
cudaError_t ragged_prefill_mma_d(int D, const void* q, const void* sk,
                                 const void* sv, const void* kp,
                                 const float* ks, const void* vp,
                                 const float* vs, const int* tables,
                                 const int* starts, const int* lens,
                                 const int* plens, void* out, int W, int R,
                                 int Hq, int Hkv, int P, int ps, int maxp,
                                 int window, float scale,
                                 cudaStream_t stream) {
  if (W == 0 || R == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
#define SWARM_CASE(DV)                                                      \
  case DV:                                                                  \
    return launch_ragged_prefill_mma<TP, DV>(q, sk, sv, kp, ks, vp, vs,     \
                                             tables, starts, lens, plens,   \
                                             out, W, R, Hq, Hkv, P, ps,     \
                                             maxp, window, scale, stream);
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

// The shared memory a launch of W packed tokens passes (MmaSmem<D, NG>::
// bytes, NG picked as the launch picks it), with the instance's attributes
// after its opt-in: the `swarm_<entry>_smem` queries.
template <typename TP, int D>
cudaError_t ragged_prefill_mma_smem_info_d(int Hq, int Hkv, int W,
                                           long long* info) {
  const int G = Hq / Hkv;
  if (G > kMmaRows) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int QT = kMmaRows / G;
  const bool two =
      static_cast<int64_t>((W + QT - 1) / QT) * Hkv <= sm_count(dev);
  if (two) {
    e = mma_smem_opt_in<TP, D, 2>(dev);
    if (e != cudaSuccess) return e;
    return smem_info(&ragged_prefill_mma_kernel<TP, D, 2>,
                     MmaSmem<D, 2>::bytes, kMmaGroupThreads * 2, 2, info);
  }
  e = mma_smem_opt_in<TP, D, 1>(dev);
  if (e != cudaSuccess) return e;
  return smem_info(&ragged_prefill_mma_kernel<TP, D, 1>,
                   MmaSmem<D, 1>::bytes, kMmaGroupThreads, 1, info);
}

template <typename TP>
cudaError_t ragged_prefill_mma_smem_info(int D, int Hq, int Hkv, int W,
                                         long long* info) {
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
#define SWARM_CASE(DV) \
  case DV:             \
    return ragged_prefill_mma_smem_info_d<TP, DV>(Hq, Hkv, W, info);
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
