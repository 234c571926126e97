// Single-step paged decode over a plain (f32 / bf16) page pool: the entry
// point of `paged_decode_gqa_attention` (ops/attention_cuda.py). Replaces
// `_paged_attn_kernel` (swarmdb_tpu/ops/attention_pallas.py). The kernel
// (`paged_decode_cluster_kernel`) and its design notes are in decode.cuh.
#include "decode.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the pages and the query / output
// separately. Returns the launch's error (0 = launched).
extern "C" int swarm_paged_decode(int page_code, int q_code, const void* q,
                                  const void* kp, const void* vp,
                                  const int* table, const int* lengths,
                                  int window, float scale, void* out, int B,
                                  int Hq, int Hkv, int D, int P, int ps,
                                  int maxp, void* stream) {
  swarm::DecodeArgs a{};
  a.q_code = q_code;
  a.q = q, a.k = kp, a.v = vp, a.table = table, a.pos = lengths;
  a.window = window, a.scale = scale, a.out = out;
  a.B = B, a.Hq = Hq, a.Hkv = Hkv, a.P = P, a.ps = ps, a.maxp = maxp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_code == swarm::kF32)
    return swarm::decode_d<float, false, false>(D, a, s);
  if (page_code == swarm::kBF16)
    return swarm::decode_d<__nv_bfloat16, false, false>(D, a, s);
  return cudaErrorInvalidValue;
}

// Shared memory per block and registers of the instance a launch at these
// dims runs (attn_common.cuh SmemInfo): `info` holds kInfoSlots values.
// Codes as above; unused ones are ignored. Returns the CUDA error.
extern "C" int swarm_paged_decode_smem(int page_code, int q_code,
    int c_code, int Hq, int Hkv, int D, int W, long long* info) {
  (void)q_code, (void)W;
  if (page_code == swarm::kF32)
    return swarm::decode_smem_info<float, false, false>(D, Hq, Hkv, c_code,
                                                        info);
  if (page_code == swarm::kBF16)
    return swarm::decode_smem_info<__nv_bfloat16, false, false>(D, Hq, Hkv,
                                                             c_code, info);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_paged_decode_error)
