// Float/double overloads of the device math the port's kernels share, so a
// kernel templated on T calls one name for both precisions.  Exact library
// functions (erfcf/erfc, sincosf/sincos), but for the reciprocal square
// root that B2 and B5 take their reciprocals from.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float x_erfc(float x) { return erfcf(x); }
__device__ __forceinline__ double x_erfc(double x) { return erfc(x); }
__device__ __forceinline__ float x_erf(float x) { return erff(x); }
__device__ __forceinline__ double x_erf(double x) { return erf(x); }
__device__ __forceinline__ float x_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double x_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float x_rint(float x) { return rintf(x); }
__device__ __forceinline__ double x_rint(double x) { return rint(x); }
__device__ __forceinline__ float x_floor(float x) { return floorf(x); }
__device__ __forceinline__ double x_floor(double x) { return floor(x); }
__device__ __forceinline__ float x_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double x_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float x_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double x_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float x_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double x_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float x_exp(float x) { return expf(x); }
__device__ __forceinline__ double x_exp(double x) { return exp(x); }
__device__ __forceinline__ float x_sin(float x) { return sinf(x); }
__device__ __forceinline__ double x_sin(double x) { return sin(x); }
__device__ __forceinline__ float x_cos(float x) { return cosf(x); }
__device__ __forceinline__ double x_cos(double x) { return cos(x); }
__device__ __forceinline__ void x_sincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void x_sincos(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ float x_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double x_rsqrt(double x) { return rsqrt(x); }

// f - rint(f), rint half to even, for |f| < 2^22 (2^51): adding and taking
// away 1.5 * 2^23 (2^52) rounds to an integer in the FP32 (FP64) adder, as
// rint does, without the conversion unit (B2 and B5's minimum image).  The
// _rn intrinsics are never contracted into a multiply-add.
__device__ __forceinline__ float frac_image(float f) {
  return __fsub_rn(f, __fsub_rn(__fadd_rn(f, 12582912.0f), 12582912.0f));
}
__device__ __forceinline__ double frac_image(double f) {
  return __dsub_rn(
      f, __dsub_rn(__dadd_rn(f, 6755399441055744.0), 6755399441055744.0));
}

}  // namespace
