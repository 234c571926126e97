// Single-step decode over a dense slot cache [B, S, Hkv, D] (f32 / bf16):
// the entry point of `decode_gqa_attention` (ops/attention_cuda.py).
// Replaces `_decode_attn_kernel` behind `decode_gqa_attention`
// (swarmdb_tpu/ops/attention_pallas.py). It is the decode body of
// decode.cuh walking a slot's contiguous lane instead of a page-table row
// (`dense_decode_cluster_kernel`); the design notes are there.
//
// Bound on the H100: bytes -- q in and the output out, plus the live K/V
// rows of every slot (positions < min(length, S), 2 bytes per element in
// bf16). Unlike the Pallas kernel, it takes a window (positions at or
// below length - 1 - window masked), so that a windowed model's dense
// decode step runs no plain ops on the card.
#include "decode.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the cache and the query / output
// separately. Returns the launch's error (0 = launched).
extern "C" int swarm_dense_decode(int cache_code, int q_code, const void* q,
                                  const void* lk, const void* lv,
                                  const int* lengths, int window, float scale,
                                  void* out, int B, int Hq, int Hkv, int D,
                                  int S, void* stream) {
  swarm::DecodeArgs a{};
  a.q_code = q_code;
  a.q = q, a.k = lk, a.v = lv, a.pos = lengths, a.window = window;
  a.scale = scale, a.out = out;
  a.B = B, a.Hq = Hq, a.Hkv = Hkv, a.S = S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cache_code == swarm::kF32)
    return swarm::decode_d<float, true, false>(D, a, s);
  if (cache_code == swarm::kBF16)
    return swarm::decode_d<__nv_bfloat16, true, false>(D, a, s);
  return cudaErrorInvalidValue;
}

// Shared memory per block and registers of the instance a launch at these
// dims runs (attn_common.cuh SmemInfo): `info` holds kInfoSlots values.
// Codes as above; unused ones are ignored. Returns the CUDA error.
extern "C" int swarm_dense_decode_smem(int page_code, int q_code,
    int c_code, int Hq, int Hkv, int D, int W, long long* info) {
  (void)q_code, (void)W;
  if (page_code == swarm::kF32)
    return swarm::decode_smem_info<float, true, false>(D, Hq, Hkv, c_code,
                                                       info);
  if (page_code == swarm::kBF16)
    return swarm::decode_smem_info<__nv_bfloat16, true, false>(D, Hq, Hkv,
                                                             c_code, info);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_dense_decode_error)
