// Packed ragged paged prefill over an int8 page pool with f32 scales per
// (page, KV head): the entry point of `ragged_paged_prefill_attention_quant`
// (ops/attention_cuda.py). Replaces `_ragged_prefill_kernel_quant`
// (swarmdb_tpu/ops/attention_pallas.py). Only the prefix pages are int8;
// the packed suffix stays in its own float type. A bf16 query and suffix
// go to the tensor-core body (ragged_prefill_mma.cuh: codes widened to
// bf16, scales applied in fp32 around the products), any float32 operand
// to the fp32 body (ragged_prefill.cuh: widened and scaled as loaded).
#include "ragged_prefill.cuh"
#include "ragged_prefill_mma.cuh"

// Codes: 0 = float32, 1 = bfloat16, for the query / output and the packed
// suffix K/V. Returns the launch's error (0 = launched), never retrying on
// the other body.
extern "C" int swarm_ragged_prefill_quant(
    int q_code, int s_code, const void* q, const void* sk, const void* sv,
    const void* kp, const float* ks, const void* vp, const float* vs,
    const int* tables, const int* starts, const int* lens, const int* plens,
    void* out, int W, int R, int Hq, int Hkv, int D, int P, int ps, int maxp,
    int window, float scale, void* stream) {
  if (q_code == swarm::kBF16 && s_code == swarm::kBF16)
    return swarm::ragged_prefill_mma_d<int8_t>(
        D, q, sk, sv, kp, ks, vp, vs, tables, starts, lens, plens, out, W, R,
        Hq, Hkv, P, ps, maxp, window, scale,
        static_cast<cudaStream_t>(stream));
  return swarm::ragged_prefill_d<int8_t>(
      D, q_code, s_code, q, sk, sv, kp, ks, vp, vs, tables, starts, lens,
      plens, out, W, R, Hq, Hkv, P, ps, maxp, window, scale,
      static_cast<cudaStream_t>(stream));
}

// Shared memory per block and registers of the instance a launch at these
// dims runs (attn_common.cuh SmemInfo): `info` holds kInfoSlots values.
// Codes as above; unused ones are ignored. Returns the CUDA error.
extern "C" int swarm_ragged_prefill_quant_smem(int page_code, int q_code,
    int c_code, int Hq, int Hkv, int D, int W, long long* info) {
  (void)page_code;
  if (q_code == swarm::kBF16 && c_code == swarm::kBF16)
    return swarm::ragged_prefill_mma_smem_info<int8_t>(D, Hq, Hkv, W, info);
  return swarm::ragged_prefill_smem_info<int8_t>(D, Hq, Hkv, info);
}

SWARM_DEFINE_ERROR_STRING(swarm_ragged_prefill_quant_error)
