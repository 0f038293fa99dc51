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

enum Act : int { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_GELU = 3 };

// apply_act takes none / relu / relu6, the acts every kernel on this header
// applies.  ACT_GELU is the int8 Conv PE's alone (csrc/conv_pe.cu act4):
// the DWC, MISC, stem and int4 kernels call apply_act inside unrolled
// loops, where a tanhf would be compiled into every copy, and their
// wrappers refuse gelu (kernels/_build.py BASIC_ACTS).
__device__ __forceinline__ float apply_act(float x, int act) {
  if (act == ACT_RELU) return fmaxf(x, 0.f);
  if (act == ACT_RELU6) return fminf(fmaxf(x, 0.f), 6.f);
  return x;
}

// torch's CUDA F.gelu(x, approximate="tanh") in f32, op for op
// (aten/src/ATen/native/cuda/GeluKernel.cu):
//   0.5 * x * (1 + tanh(kBeta * (x + kKappa * x^3))),
// kBeta = sqrt(2) * 2 / sqrt(pi) * 0.5 rounded to f32, kKappa = 0.044715f.
// torch's kernel is built with nvcc's default contraction, which fuses
// `x + kKappa * x_cube` into one FMA; these sources are built with
// --fmad=false, so that FMA is written out (__fmaf_rn) and every other
// step is an explicitly rounded multiply or add.  A sweep on the card (a
// zero-A int8 GEMM whose bias holds 2^20 values over [-12, 12], +-0,
// denormals and +-1e30: scripts/conv_pe_probe.py --gelu) is bitwise with
// torch's kernel with this FMA and differs without it.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;
  const float kKappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kBeta, __fmaf_rn(kKappa, cube, x));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
}

// clip(round(x / s), -127, 127) as an integer-valued float.
__device__ __forceinline__ float qdq_code(float x, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// float(acc) for |acc| < 2^22 on the FP32 pipe, without a conversion
// instruction: acc added to the bits of 1.5 * 2^23 (whose ulp is 1), then
// 1.5 * 2^23 taken off; both steps are exact, so it equals
// __int2float_rn(acc) there.
__device__ __forceinline__ float small_int2float(int acc) {
  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.f);
}

// An integer-valued float |v| < 2^22 as an int, without a conversion
// instruction (the bits of v + 1.5 * 2^23).
__device__ __forceinline__ int code_int(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.f)) - 0x4B400000;
}

// The reciprocal qdq_code_rcp takes: __frcp_rn(s) (correctly rounded)
// where that is a normal float, else NaN, which sends every call to the
// division.
__device__ __forceinline__ float requant_rcp(float s) {
  const float r = __frcp_rn(s);
  return fabsf(r) >= 0x1p-126f && fabsf(r) <= 0x1.fffffep127f
             ? r : __int_as_float(0x7fffffff);
}

// qdq_code(x, s) for every x, bit for bit, with rcp = requant_rcp(s) and
// one multiply in place of the IEEE division wherever that cannot move the
// code.  p = x * rcp is within 2.0000001 * 2^-24 of x / s relatively, and
// the division's own result within 2^-24, so where p lies more than 2^-14
// from every half-integer (|x / s| < 128 wherever that matters: 3 * 2^-24
// * 128 < 2^-14) both lie strictly between the same two half-integers and
// round to the same integer; the clamp to +-127 commutes with the rounding
// (NaN goes to -127 either way).  Elsewhere -- about one value in 10^4, and
// every value when rcp is NaN -- the division decides.  The rounding is
// the add of 1.5 * 2^23 (whose ulp is 1: nearest, ties to even, as rintf).
__device__ __noinline__ float qdq_code_slow(float x, float s) {
  return qdq_code(x, s);
}

__device__ __forceinline__ float qdq_code_rcp(float x, float s, float rcp) {
  const float p = __fmul_rn(x, rcp);
  const float r = __fsub_rn(
      __fadd_rn(fminf(fmaxf(p, -127.f), 127.f), 12582912.f), 12582912.f);
  const float d = fabsf(__fsub_rn(p, r));
  if (!(d < 0.5f - 0x1p-14f || d > 0.5f + 0x1p-14f))
    return qdq_code_slow(x, s);
  return r;
}

// The requant by the multiply alone: t = clamp(rint(x * rcp), +-127) + 1.5
// * 2^23 (whose bits' low byte is the int8 code), and `near`: x * rcp,
// clamped, lies within 2^-14 of a half-integer.  Where it does not, t is
// qdq_code(x, s) + 1.5 * 2^23 bit for bit (qdq_code_rcp's argument; past
// the clamp both give +-127).
__device__ __forceinline__ float requant_biased(float x, float rcp,
                                                bool& near) {
  const float pc = fminf(fmaxf(__fmul_rn(x, rcp), -127.f), 127.f);
  const float t = __fadd_rn(pc, 12582912.f);
  const float d = fabsf(__fsub_rn(pc, __fsub_rn(t, 12582912.f)));
  near = !(d < 0.5f - 0x1p-14f || d > 0.5f + 0x1p-14f);
  return t;
}

// qdq_code(x, s) + 1.5 * 2^23, bit for bit for every x, by multiplies and
// one FMA, with no branch and no division, for 2^-100 <= s <= 2^100 and
// rcp = __frcp_rn(s).  Near a half-integer h of the clamped product (|h|
// <= 126.5, at most 8 significant bits), e = x - h * s is exact as one
// FMA: x and h * s are multiples of ulp(s) / 4 and |e| <= 2^-13.5 * s, 13
// bits.  Then fl(x / s) == h exactly when |e| <= s * ulp(h) / 2 (a
// power-of-two scaling, exact in this range of s; at the bound the
// quotient's tie goes to h, whose significand is even), and rint(h) rounds
// half to even as rintf(fl(x / s)) does; else the quotient lies on e's
// side of h and rounds to h +- 0.5.  A numpy float32 emulation held it
// against fl(x / s) on 8e7 values, 3e7 of them near ties, and at the
// range's ends.
__device__ __forceinline__ float qdq_biased_exact(float x, float s,
                                                  float rcp) {
  bool near;
  const float t = requant_biased(x, rcp, near);
  const float pc = fminf(fmaxf(__fmul_rn(x, rcp), -127.f), 127.f);
  const float r = __fsub_rn(t, 12582912.f);
  const float h = __fadd_rn(r, copysignf(0.5f, __fsub_rn(pc, r)));
  const float e = __fmaf_rn(-h, s, x);
  const float half_ulp =
      __int_as_float((__float_as_int(fabsf(h)) & 0x7f800000) - (24 << 23));
  const float v = fabsf(e) <= __fmul_rn(s, half_ulp)
                      ? h : __fadd_rn(h, e > 0.f ? 0.5f : -0.5f);
  return near ? __fadd_rn(v, 12582912.f) : t;
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
