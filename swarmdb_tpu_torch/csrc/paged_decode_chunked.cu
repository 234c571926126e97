// Two-segment paged decode over a plain (f32 / bf16) page pool: the entry
// point of `paged_decode_gqa_attention_chunked` (ops/attention_cuda.py).
// Replaces `_paged_chunk_attn_kernel` (swarmdb_tpu/ops/attention_pallas.py).
// The kernel (`paged_decode_chunked_cluster_kernel`) and its design notes
// are in decode.cuh.
#include "decode.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the pages, the query / output and
// the chunk buffer separately. Returns the launch's error (0 = launched).
extern "C" int swarm_paged_decode_chunked(
    int page_code, int q_code, int c_code, const void* q, const void* kp,
    const void* vp, const int* table, const void* ck, const void* cv,
    const int* starts, int step, int window, float scale, void* out, int B,
    int Hq, int Hkv, int D, int P, int ps, int maxp, int Kc, void* stream) {
  swarm::DecodeArgs a{};
  a.q_code = q_code, a.c_code = c_code;
  a.q = q, a.k = kp, a.v = vp, a.table = table, a.ck = ck, a.cv = cv;
  a.pos = starts, a.step = step, a.window = window, a.scale = scale;
  a.out = out;
  a.B = B, a.Hq = Hq, a.Hkv = Hkv, a.P = P, a.ps = ps, a.maxp = maxp;
  a.Kc = Kc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_code == swarm::kF32)
    return swarm::decode_d<float, false, true>(D, a, s);
  if (page_code == swarm::kBF16)
    return swarm::decode_d<__nv_bfloat16, false, true>(D, a, s);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_paged_decode_chunked_error)
