// Packed ragged paged prefill over an int8 page pool with f32 scales per
// (page, KV head): the entry point of `ragged_paged_prefill_attention_quant`
// (ops/attention_cuda.py). Replaces `_ragged_prefill_kernel_quant`
// (swarmdb_tpu/ops/attention_pallas.py). The kernel and its design notes
// are in ragged_prefill.cuh; only the prefix pages are int8 (read at 1 byte
// per element and scaled as they are widened), the packed suffix stays
// full precision.
#include "ragged_prefill.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the query / output and the packed
// suffix K/V. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int swarm_ragged_prefill_quant(
    int q_code, int s_code, const void* q, const void* sk, const void* sv,
    const void* kp, const float* ks, const void* vp, const float* vs,
    const int* tables, const int* starts, const int* lens, const int* plens,
    void* out, int W, int R, int Hq, int Hkv, int D, int P, int ps, int maxp,
    int window, float scale, void* stream) {
  return swarm::ragged_prefill_d<int8_t>(
      D, q_code, s_code, q, sk, sv, kp, ks, vp, vs, tables, starts, lens,
      plens, out, W, R, Hq, Hkv, P, ps, maxp, window, scale,
      static_cast<cudaStream_t>(stream));
}

SWARM_DEFINE_ERROR_STRING(swarm_ragged_prefill_quant_error)
