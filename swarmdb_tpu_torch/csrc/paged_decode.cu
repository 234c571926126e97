// Single-step paged decode over a plain (f32 / bf16) page pool: the entry
// point of `paged_decode_gqa_attention` (ops/attention_cuda.py). Replaces
// `_paged_attn_kernel` (swarmdb_tpu/ops/attention_pallas.py). The kernel
// and its design notes are in paged_decode.cuh.
#include "paged_decode.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the pages and the query / output
// separately. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int swarm_paged_decode(int page_code, int q_code, const void* q,
                                  const void* kp, const void* vp,
                                  const int* table, const int* lengths,
                                  int window, float scale, void* out, int B,
                                  int Hq, int Hkv, int D, int P, int ps,
                                  int maxp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_code == swarm::kF32)
    return swarm::paged_decode_d<float>(D, q_code, q, kp, nullptr, vp,
                                        nullptr, table, lengths, window,
                                        scale, out, B, Hq, Hkv, P, ps, maxp,
                                        s);
  if (page_code == swarm::kBF16)
    return swarm::paged_decode_d<__nv_bfloat16>(
        D, q_code, q, kp, nullptr, vp, nullptr, table, lengths, window, scale,
        out, B, Hq, Hkv, P, ps, maxp, s);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_paged_decode_error)
