// Device code of the kernels that evaluate Thole-damped fields: B6
// (pda_kernel.cu, the charge-field delta of a trial move).  B5
// (thole_kernel.cu) evaluates the same factors with its divisions made
// multiplications by reciprocals (damping_rcp there).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"

namespace {

// Thole screening factors: kind 0 none, 1 exponential (width lam, 1/A),
// 2 linear (screening radius lam, A).  d1 screens the charge-dipole term,
// d2 the dipole-dipole one.
template <typename T>
__device__ __forceinline__ void damping(T r, T lam, int kind, T& d1, T& d2) {
  if (kind == 1) {
    const T x = lam * r;
    const T e = x_exp(-x);
    const T p1 = T(1) + x + T(0.5) * x * x;
    d1 = T(1) - e * p1;
    d2 = T(1) - e * (p1 + x * x * x / T(6));
  } else if (kind == 2) {
    const T u = x_min(r / lam, T(1));
    const T u3 = u * u * u;
    d1 = T(4) * u3 - T(3) * u3 * u;
    d2 = u3 * u;
  } else {
    d1 = T(1);
    d2 = T(1);
  }
}

}  // namespace
