// Two-segment decode over a dense slot cache [B, S, Hkv, D] (f32 / bf16)
// plus the chunk buffer: the entry point of `decode_gqa_attention_chunked`
// (ops/attention_cuda.py). Replaces `_dense_chunk_attn_kernel` behind
// `decode_gqa_attention_chunked` (swarmdb_tpu/ops/attention_pallas.py), the
// dense engine's default decode. It is kernel 2's loop over a slot's
// contiguous lane instead of its page-table row: the kernel and its design
// notes are in paged_decode_chunked.cuh.
//
// Bound on the H100: bytes -- q in and the output out, the live K/V rows of
// every slot (positions < its chunk start, 2 bytes per element in bf16) and
// the chunk rows <= step. The walk ends at min(start, S), so the padding
// garbage a bucketed prefill leaves past a slot's prompt is never read.
// Known limit, shared with kernels 2 and 3: 64 blocks at 8 slots x 8 KV
// heads, and no overlap of a tile's load with the fold of the previous one.
#include "paged_decode_chunked.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the cache, the query / output and
// the chunk buffer separately. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int swarm_dense_decode_chunked(
    int cache_code, int q_code, int c_code, const void* q, const void* lk,
    const void* lv, const void* ck, const void* cv, const int* starts,
    int step, int window, float scale, void* out, int B, int Hq, int Hkv,
    int D, int S, int Kc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cache_code == swarm::kF32)
    return swarm::dense_decode_chunked_d<float>(
        D, q_code, c_code, q, lk, lv, ck, cv, starts, step, window, scale,
        out, B, Hq, Hkv, S, Kc, s);
  if (cache_code == swarm::kBF16)
    return swarm::dense_decode_chunked_d<__nv_bfloat16>(
        D, q_code, c_code, q, lk, lv, ck, cv, starts, step, window, scale,
        out, B, Hq, Hkv, S, Kc, s);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_dense_decode_chunked_error)
