// Two-segment decode over a dense slot cache [B, S, Hkv, D] (f32 / bf16)
// plus the chunk buffer: the entry point of `decode_gqa_attention_chunked`
// (ops/attention_cuda.py). Replaces `_dense_chunk_attn_kernel` behind
// `decode_gqa_attention_chunked` (swarmdb_tpu/ops/attention_pallas.py), the
// dense engine's default decode. It is the decode body of decode.cuh
// walking a slot's contiguous lane instead of a page-table row
// (`dense_decode_chunked_cluster_kernel`); the design notes are there.
//
// Bound on the H100: bytes -- q in and the output out, the live K/V rows of
// every slot (positions < its chunk start, 2 bytes per element in bf16) and
// the chunk rows <= step. The walk ends at min(start, S), so the padding
// garbage a bucketed prefill leaves past a slot's prompt is never read.
#include "decode.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the cache, the query / output and
// the chunk buffer separately. Returns the launch's error (0 = launched).
extern "C" int swarm_dense_decode_chunked(
    int cache_code, int q_code, int c_code, const void* q, const void* lk,
    const void* lv, const void* ck, const void* cv, const int* starts,
    int step, int window, float scale, void* out, int B, int Hq, int Hkv,
    int D, int S, int Kc, void* stream) {
  swarm::DecodeArgs a{};
  a.q_code = q_code, a.c_code = c_code;
  a.q = q, a.k = lk, a.v = lv, a.ck = ck, a.cv = cv, a.pos = starts;
  a.step = step, a.window = window, a.scale = scale, a.out = out;
  a.B = B, a.Hq = Hq, a.Hkv = Hkv, a.S = S, a.Kc = Kc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cache_code == swarm::kF32)
    return swarm::decode_d<float, true, true>(D, a, s);
  if (cache_code == swarm::kBF16)
    return swarm::decode_d<__nv_bfloat16, true, true>(D, a, s);
  return cudaErrorInvalidValue;
}

// Shared memory per block and registers of the instance a launch at these
// dims runs (attn_common.cuh SmemInfo): `info` holds kInfoSlots values.
// Codes as above; unused ones are ignored. Returns the CUDA error.
extern "C" int swarm_dense_decode_chunked_smem(int page_code, int q_code,
    int c_code, int Hq, int Hkv, int D, int W, long long* info) {
  (void)q_code, (void)W;
  if (page_code == swarm::kF32)
    return swarm::decode_smem_info<float, true, true>(D, Hq, Hkv, c_code,
                                                      info);
  if (page_code == swarm::kBF16)
    return swarm::decode_smem_info<__nv_bfloat16, true, true>(D, Hq, Hkv,
                                                             c_code, info);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_dense_decode_chunked_error)
