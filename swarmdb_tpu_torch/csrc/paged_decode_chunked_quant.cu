// Two-segment paged decode over an int8 page pool with f32 scales per
// (page, KV head): the entry point of
// `paged_decode_gqa_attention_chunked_quant` (ops/attention_cuda.py).
// Replaces `_paged_chunk_attn_kernel_quant`
// (swarmdb_tpu/ops/attention_pallas.py). The kernel and its design notes
// are in paged_decode_chunked.cuh; the pages are read at 1 byte per element
// and scaled as they are widened, the chunk buffer stays full precision.
#include "paged_decode_chunked.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the query / output and the chunk
// buffer. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int swarm_paged_decode_chunked_quant(
    int q_code, int c_code, const void* q, const void* kp, const float* ks,
    const void* vp, const float* vs, const int* table, const void* ck,
    const void* cv, const int* starts, int step, int window, float scale,
    void* out, int B, int Hq, int Hkv, int D, int P, int ps, int maxp, int Kc,
    void* stream) {
  return swarm::paged_decode_chunked_d<int8_t>(
      D, q_code, c_code, q, kp, ks, vp, vs, table, ck, cv, starts, step,
      window, scale, out, B, Hq, Hkv, P, ps, maxp, Kc,
      static_cast<cudaStream_t>(stream));
}

SWARM_DEFINE_ERROR_STRING(swarm_paged_decode_chunked_quant_error)
