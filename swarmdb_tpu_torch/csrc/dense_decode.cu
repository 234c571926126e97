// Single-step decode over a dense slot cache [B, S, Hkv, D] (f32 / bf16):
// the entry point of `decode_gqa_attention` (ops/attention_cuda.py).
// Replaces `_decode_attn_kernel` behind `decode_gqa_attention`
// (swarmdb_tpu/ops/attention_pallas.py). It is kernel 3's page loop over a
// slot's contiguous lane instead of its page-table row: the kernel and its
// design notes are in paged_decode.cuh.
//
// Bound on the H100: bytes -- q in and the output out, plus the live K/V
// rows of every slot (positions < length, 2 bytes per element in bf16).
// Known limit, shared with kernels 2 and 3: 64 blocks at 8 slots x 8 KV
// heads, and no overlap of a tile's load with the fold of the previous one.
// Unlike the Pallas kernel, it takes a window (positions at or below
// length - 1 - window masked), so that a windowed model's dense decode step
// runs no plain ops on the card.
#include "paged_decode.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the cache and the query / output
// separately. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int swarm_dense_decode(int cache_code, int q_code, const void* q,
                                  const void* lk, const void* lv,
                                  const int* lengths, int window, float scale,
                                  void* out, int B, int Hq, int Hkv, int D,
                                  int S, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cache_code == swarm::kF32)
    return swarm::dense_decode_d<float>(D, q_code, q, lk, lv, lengths,
                                        window, scale, out, B, Hq, Hkv, S, s);
  if (cache_code == swarm::kBF16)
    return swarm::dense_decode_d<__nv_bfloat16>(D, q_code, q, lk, lv,
                                                lengths, window, scale, out,
                                                B, Hq, Hkv, S, s);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_dense_decode_error)
