// Two-segment paged decode over an int8 page pool with f32 scales per
// (page, KV head): the entry point of
// `paged_decode_gqa_attention_chunked_quant` (ops/attention_cuda.py).
// Replaces `_paged_chunk_attn_kernel_quant`
// (swarmdb_tpu/ops/attention_pallas.py). The kernel and its design notes
// are in decode.cuh; the pages are read at 1 byte per element and widened
// and scaled as they are folded, the chunk buffer stays full precision.
#include "decode.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the query / output and the chunk
// buffer. Returns the launch's error (0 = launched).
extern "C" int swarm_paged_decode_chunked_quant(
    int q_code, int c_code, const void* q, const void* kp, const float* ks,
    const void* vp, const float* vs, const int* table, const void* ck,
    const void* cv, const int* starts, int step, int window, float scale,
    void* out, int B, int Hq, int Hkv, int D, int P, int ps, int maxp, int Kc,
    void* stream) {
  swarm::DecodeArgs a{};
  a.q_code = q_code, a.c_code = c_code;
  a.q = q, a.k = kp, a.v = vp, a.ks = ks, a.vs = vs, a.table = table;
  a.ck = ck, a.cv = cv, a.pos = starts, a.step = step, a.window = window;
  a.scale = scale, a.out = out;
  a.B = B, a.Hq = Hq, a.Hkv = Hkv, a.P = P, a.ps = ps, a.maxp = maxp;
  a.Kc = Kc;
  return swarm::decode_d<int8_t, false, true>(
      D, a, static_cast<cudaStream_t>(stream));
}

SWARM_DEFINE_ERROR_STRING(swarm_paged_decode_chunked_quant_error)
