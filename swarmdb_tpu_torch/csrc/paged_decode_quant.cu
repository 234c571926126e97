// Single-step paged decode over an int8 page pool with f32 scales per
// (page, KV head): the entry point of `paged_decode_gqa_attention_quant`
// (ops/attention_cuda.py). Replaces `_paged_attn_kernel_quant`
// (swarmdb_tpu/ops/attention_pallas.py). The kernel and its design notes
// are in decode.cuh; the pages are read at 1 byte per element and widened
// and scaled as they are folded.
#include "decode.cuh"

// q_code: 0 = float32, 1 = bfloat16, for the query / output. Returns the
// launch's error (0 = launched).
extern "C" int swarm_paged_decode_quant(int q_code, const void* q,
                                        const void* kp, const float* ks,
                                        const void* vp, const float* vs,
                                        const int* table, const int* lengths,
                                        int window, float scale, void* out,
                                        int B, int Hq, int Hkv, int D, int P,
                                        int ps, int maxp, void* stream) {
  swarm::DecodeArgs a{};
  a.q_code = q_code;
  a.q = q, a.k = kp, a.v = vp, a.ks = ks, a.vs = vs, a.table = table;
  a.pos = lengths, a.window = window, a.scale = scale, a.out = out;
  a.B = B, a.Hq = Hq, a.Hkv = Hkv, a.P = P, a.ps = ps, a.maxp = maxp;
  return swarm::decode_d<int8_t, false, false>(
      D, a, static_cast<cudaStream_t>(stream));
}

SWARM_DEFINE_ERROR_STRING(swarm_paged_decode_quant_error)
