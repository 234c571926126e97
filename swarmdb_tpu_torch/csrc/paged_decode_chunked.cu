// Two-segment paged decode over a plain (f32 / bf16) page pool: the entry
// point of `paged_decode_gqa_attention_chunked` (ops/attention_cuda.py).
// The kernel and its design notes are in paged_decode_chunked.cuh.
#include "paged_decode_chunked.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the pages, the query / output and
// the chunk buffer separately. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int swarm_paged_decode_chunked(
    int page_code, int q_code, int c_code, const void* q, const void* kp,
    const void* vp, const int* table, const void* ck, const void* cv,
    const int* starts, int step, int window, float scale, void* out, int B,
    int Hq, int Hkv, int D, int P, int ps, int maxp, int Kc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_code == swarm::kF32)
    return swarm::paged_decode_chunked_d<float>(
        D, q_code, c_code, q, kp, nullptr, vp, nullptr, table, ck, cv, starts,
        step, window, scale, out, B, Hq, Hkv, P, ps, maxp, Kc, s);
  if (page_code == swarm::kBF16)
    return swarm::paged_decode_chunked_d<__nv_bfloat16>(
        D, q_code, c_code, q, kp, nullptr, vp, nullptr, table, ck, cv, starts,
        step, window, scale, out, B, Hq, Hkv, P, ps, maxp, Kc, s);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_paged_decode_chunked_error)
