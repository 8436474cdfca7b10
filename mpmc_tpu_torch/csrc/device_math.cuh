// Float/double overloads of the device math the port's kernels share, so a
// kernel templated on T calls one name for both precisions.  Exact library
// functions only (erfcf/erfc, sincosf/sincos): no fast-math intrinsics.
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

}  // namespace
