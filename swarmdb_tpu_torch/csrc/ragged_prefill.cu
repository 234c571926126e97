// Packed ragged paged prefill over a plain (f32 / bf16) page pool: the
// entry point of `ragged_paged_prefill_attention` (ops/attention_cuda.py).
// Two bodies, chosen by the operand types: all-bf16 operands go to the
// tensor-core body (ragged_prefill_mma.cuh), any float32 operand to the
// fp32 body (ragged_prefill.cuh), which keeps f32 results exact to 1e-4.
#include "ragged_prefill.cuh"
#include "ragged_prefill_mma.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the pages, the query / output and
// the packed suffix K/V separately. Returns the launch's error (0 =
// launched), never retrying on the other body.
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
  if (page_code == swarm::kBF16 && q_code == swarm::kBF16 &&
      s_code == swarm::kBF16)
    return swarm::ragged_prefill_mma_d<__nv_bfloat16>(
        D, q, sk, sv, kp, nullptr, vp, nullptr, tables, starts, lens, plens,
        out, W, R, Hq, Hkv, P, ps, maxp, window, scale, s);
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

// Shared memory per block and registers of the instance a launch at these
// dims runs (attn_common.cuh SmemInfo): `info` holds kInfoSlots values.
// Codes as above; unused ones are ignored. Returns the CUDA error.
extern "C" int swarm_ragged_prefill_smem(int page_code, int q_code,
    int c_code, int Hq, int Hkv, int D, int W, long long* info) {
  if (page_code == swarm::kBF16 && q_code == swarm::kBF16 &&
      c_code == swarm::kBF16)
    return swarm::ragged_prefill_mma_smem_info<__nv_bfloat16>(D, Hq, Hkv, W,
                                                              info);
  if (page_code == swarm::kF32)
    return swarm::ragged_prefill_smem_info<float>(D, Hq, Hkv, info);
  if (page_code == swarm::kBF16)
    return swarm::ragged_prefill_smem_info<__nv_bfloat16>(D, Hq, Hkv, info);
  return cudaErrorInvalidValue;
}

SWARM_DEFINE_ERROR_STRING(swarm_ragged_prefill_error)
