// Single-step paged decode over an int8 page pool with f32 scales per
// (page, KV head): the entry point of `paged_decode_gqa_attention_quant`
// (ops/attention_cuda.py). Replaces `_paged_attn_kernel_quant`
// (swarmdb_tpu/ops/attention_pallas.py). The kernel and its design notes
// are in paged_decode.cuh; the pages are read at 1 byte per element and
// scaled as they are widened.
#include "paged_decode.cuh"

// q_code: 0 = float32, 1 = bfloat16, for the query / output. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int swarm_paged_decode_quant(int q_code, const void* q,
                                        const void* kp, const float* ks,
                                        const void* vp, const float* vs,
                                        const int* table, const int* lengths,
                                        int window, float scale, void* out,
                                        int B, int Hq, int Hkv, int D, int P,
                                        int ps, int maxp, void* stream) {
  return swarm::paged_decode_d<int8_t>(
      D, q_code, q, kp, ks, vp, vs, table, lengths, window, scale, out, B, Hq,
      Hkv, P, ps, maxp, static_cast<cudaStream_t>(stream));
}

SWARM_DEFINE_ERROR_STRING(swarm_paged_decode_quant_error)
