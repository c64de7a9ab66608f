// The fused epilogue shared by the port's GeMM kernels (msgemm.cu,
// int4_matmul.cu) and the typed loads and stores of the attention kernel:
//   out = cast(act(acc + bias) + residual)
// with the activations of repro_torch/core/epilogue.py (gelu is the tanh
// approximation, as jax.nn.gelu).  The adds use the _rn intrinsics so that
// no FMA contraction changes the plain PyTorch version's rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace epi {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };
enum DType { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_RELU:
      return v < 0.0f ? 0.0f : v;
    case ACT_GELU: {  // tanh approximation, as jax.nn.gelu
      const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.0f + tanhf(inner));
    }
    case ACT_SILU:
      return v / (1.0f + expf(-v));
    default:
      return v;
  }
}

// v rounded to nearest-even into element `off` of a `dtype` buffer
__device__ __forceinline__ void store(void* out, long long off, int dtype,
                                      float v) {
  if (dtype == BF16) {
    reinterpret_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(v);
  } else if (dtype == F16) {
    reinterpret_cast<__half*>(out)[off] = __float2half_rn(v);
  } else {
    reinterpret_cast<float*>(out)[off] = v;
  }
}

__device__ __forceinline__ float load(const void* in, long long off,
                                      int dtype) {
  if (dtype == BF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(in)[off]);
  }
  if (dtype == F16) {
    return __half2float(reinterpret_cast<const __half*>(in)[off]);
  }
  return reinterpret_cast<const float*>(in)[off];
}

// cast(act(acc + bias) + residual) into out[off]; bias/res already read
// (pass has_* = false to skip a term)
__device__ __forceinline__ void finish(float acc, bool has_bias, float bias,
                                       int act, bool has_res, float res,
                                       void* out, long long off, int dtype) {
  float t = acc;
  if (has_bias) t = __fadd_rn(t, bias);
  t = activate(t, act);
  if (has_res) t = __fadd_rn(t, res);
  store(out, off, dtype, t);
}

}  // namespace epi
