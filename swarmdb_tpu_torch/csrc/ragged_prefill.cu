// Packed ragged paged prefill over a plain (f32 / bf16) page pool: the
// entry point of `ragged_paged_prefill_attention` (ops/attention_cuda.py).
// The kernel and its design notes are in ragged_prefill.cuh.
#include "ragged_prefill.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the pages, the query / output and
// the packed suffix K/V separately. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int swarm_ragged_prefill(int page_code, int q_code, int s_code,
                                    const void* q, const void* sk,
                                    const void* sv, const void* kp,
                                    const void* vp, const int* tables,
                                    const int* starts, const int* lens,
                                    const int* plens, void* out, int W, int R,
                                    int Hq, int Hkv, int D, int P, int ps,
                                    int maxp, int window, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_code == swarm::kF32)
    return swarm::ragged_prefill_d<float>(
        D, q_code, s_code, q, sk, sv, kp, nullptr, vp, nullptr, tables,
        starts, lens, plens, out, W, R, Hq, Hkv, P, ps, maxp, window, scale,
        s);
  if (page_code == swarm::kBF16)
    return swarm::ragged_prefill_d<__nv_bfloat16>(
        D, q_code, s_code, q, sk, sv, kp, nullptr, vp, nullptr, tables,
        starts, lens, plens, out, W, R, Hq, Hkv, P, ps, maxp, window, scale,
        s);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_ragged_prefill_error)
