// The NL / RACNL epilogue arithmetic every Hopper kernel of the port shares.
//
// It repeats kernels/ref.py and kernels/_epilogue.py operation for
// operation, so a kernel's output equals its plain PyTorch version bit for
// bit: every multiply, add and divide is an explicitly rounded intrinsic
// (the sources are also built with --fmad=false, so nvcc never contracts
// `x * a + b` into an FMA), rounding is rintf (half to even, like
// torch.round and jnp.round), and clamps run on the rounded float code.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

enum Act : int { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };

__device__ __forceinline__ float apply_act(float x, int act) {
  if (act == ACT_RELU) return fmaxf(x, 0.f);
  if (act == ACT_RELU6) return fminf(fmaxf(x, 0.f), 6.f);
  return x;
}

// clip(round(x / s), -127, 127) as an integer-valued float.
__device__ __forceinline__ float qdq_code(float x, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// dequant(int32 acc) -> bias -> act, in the reference's order:
// acc.f32 * a_scale * w_scale + bias.
__device__ __forceinline__ float dequant_bias_act(int acc, float a_scale,
                                                  float w_scale,
                                                  const float* bias, int col,
                                                  int act) {
  float x = __fmul_rn(__fmul_rn(__int2float_rn(acc), a_scale), w_scale);
  if (bias != nullptr) x = __fadd_rn(x, bias[col]);
  return apply_act(x, act);
}

}  // namespace repro
