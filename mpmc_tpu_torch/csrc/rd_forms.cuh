// The RD forms of mpmc_tpu/ops/potentials.py (sg, dreiding, b14_7,
// disp_expansion) and the GWP charge smear, the one copy of their device
// formulas: the pair kernels B2 and B4 (pair_kernel.cuh) and the fused
// step loops B1, B3 and B6 (mc_cluster.cuh) include it.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"

namespace {

// The pair form, a template parameter of B1, B2, B3, B4 and B6: the
// classical instances read rd none or lj (and the Coulomb form) from their
// Opts at run time; each other RD form is an instance of its own, so that
// no form costs another registers.  FORM_GWP (B1, B3 and B6 only) is the
// classical rd with the GWP Coulomb form; the RD form instances of B1, B3
// and B6 read their Coulomb form at run time, gwp among them.
constexpr int RD_CLASSIC = 0;
constexpr int FORM_GWP = 1;      // rd none or lj, coulomb gwp
constexpr int RD_SG = 2;         // Silvera-Goldman H2-H2
constexpr int RD_DREIDING = 3;   // Dreiding exponential-6
constexpr int RD_B14_7 = 4;      // Halgren's buffered 14-7
constexpr int RD_DISP = 5;       // Born-Mayer + C6/C8/C10 dispersion

// The formulas of mpmc_tpu/ops/potentials.py (and of the plain versions,
// mpmc_tpu_torch/ops/potentials.py), operation for operation: the
// constants in double, then in T; integer powers by repeated squaring in
// the reference's order (x^3 = x x^2, x^7 = (x x^2) x^4); a real power by
// pow; exp, pow and sqrt exact (no fast-math).

template <typename T>
__device__ __forceinline__ T ipow3(T x) { return x * (x * x); }

template <typename T>
__device__ __forceinline__ T ipow7(T x) {
  const T x2 = x * x;
  const T x4 = x2 * x2;
  return (x * x2) * x4;
}

// Silvera-Goldman, r in A, in K; r floored at 0.3 bohr, where the float
// dispersion sum would overflow while the damping underflows to 0.
template <typename T>
__device__ __forceinline__ T sg_energy(T r_ang) {
  constexpr double bohr = 0.529177210903;
  constexpr double hartree_k = 4.3597447222071e-18 / 1.380649e-23;
  const T r = x_max(r_ang, T(0.3 * bohr)) / T(bohr);
  const T rep = x_exp(T(1.713) - T(1.5671) * r - T(0.00993) * r * r);
  const T r2 = r * r;
  const T r6 = r2 * r2 * r2;
  const T disp = T(12.14) / r6 + T(215.2) / (r6 * r2)
                 + T(4813.9) / (r6 * r2 * r2) - T(143.1) / (r6 * r2 * r);
  const T u = T(8.32) / r - T(1);
  const T fc = r < T(8.32) ? x_exp(-(u * u)) : T(1);
  return (rep - fc * disp) * T(hartree_k);
}

// The Tang-Toennies factors f_6, f_8, f_10 of x = B r under one exp(-x)
// and one running sum: the reference's tt_damping(x, n) sums the terms
// x^k / k! for k = 1..n in order, each term the previous times x over k,
// so its sums for n = 6 and 8 are this sum's values after k = 6 and 8 -
// the same operations in the same order, hence the same values.
template <typename T>
__device__ __forceinline__ void tt_damping3(T x, T& f6, T& f8, T& f10) {
  const T e = x_exp(-x);
  T s = T(1), term = T(1);
#pragma unroll
  for (int k = 1; k <= 10; ++k) {
    term = term * x / T(k);
    s = s + term;
    if (k == 6) f6 = T(1) - e * s;
    if (k == 8) f8 = T(1) - e * s;
  }
  f10 = T(1) - e * s;
}

// The RD energy of one pair of a form (not RD_CLASSIC), r = |r_ij| > 0,
// from the two sites' eps and sig columns and, for RD_DISP, the mixed
// C6, C8, C10; the mixing rules of potentials.rd_pair_energy_generic.
template <typename T, int RD>
__device__ __forceinline__ T rd_form(T r, T ei, T ej, T si, T sj, T c6,
                                     T c8, T c10, bool damp) {
  if constexpr (RD == RD_SG) {
    return sg_energy(r);
  } else if constexpr (RD == RD_DREIDING) {
    constexpr double zeta = 13.772;
    const T d0 = x_sqrt(ei * ej);
    const T r0 = x_max(T(0.5) * (si + sj), T(1e-6));
    const T p = r / r0;
    return d0 * (T(6.0 / (zeta - 6.0)) * x_exp(T(zeta) * (T(1) - p))
                 - T(zeta / (zeta - 6.0)) * x_pow(p, T(-6)));
  } else if constexpr (RD == RD_B14_7) {
    const T r0 = x_max((ipow3(si) + ipow3(sj))
                       / x_max(si * si + sj * sj, T(1e-12)), T(1e-6));
    const T sq = x_sqrt(ei) + x_sqrt(ej);
    const T eps = T(4) * ei * ej / x_max(sq * sq, T(1e-12));
    const T p = r / r0;
    const T t = ipow7(T(1.0 + 0.07) / (p + T(0.07)));
    return eps * t * (T(1.0 + 0.12) / (ipow7(p) + T(0.12)) - T(2));
  } else {
    static_assert(RD == RD_DISP, "unknown RD form");
    const T a = x_sqrt(x_max(ei * ej, T(0)));
    const T b = T(2) * si * sj / x_max(si + sj, T(1e-12));
    const T rep = a * x_exp(-b * r);
    const T r2 = r * r;
    const T r6 = r2 * r2 * r2;
    T f6 = T(1), f8 = T(1), f10 = T(1);
    if (damp) tt_damping3(b * r, f6, f8, f10);
    return rep - f6 * c6 / r6 - f8 * c8 / (r6 * r2)
           - f10 * c10 / (r6 * r2 * r2);
  }
}

// The geometric mean of a dispersion coefficient, sqrt(max(ci cj, 0)).
template <typename T>
__device__ __forceinline__ T disp_mix(T ci, T cj) {
  return x_sqrt(x_max(ci * cj, T(0)));
}

// The dispersion expansion's tail coefficient of a pair,
// -4 pi [C6 / (3 rc^3) + C8 / (5 rc^5) + C10 / (7 rc^7)].
template <typename T>
__device__ __forceinline__ T disp_tail(T c6, T c8, T c10, T rc) {
  const T rc3 = rc * rc * rc;
  const T rc5 = rc3 * rc * rc;
  const T rc7 = rc5 * rc * rc;
  return T(-4.0 * 3.14159265358979323846)
         * (c6 / (T(3) * rc3) + c8 / (T(5) * rc5) + c10 / (T(7) * rc7));
}

// The GWP smear of two Gaussian charges of widths s_i, s_j at distance r,
// erf(r / sqrt(2 max(s^2, 1e-12))) with s^2 = s_i^2 + s_j^2, and 1 (point
// charges) where s^2 <= 1e-12 (ops/pairs.py's gwp branch; the exact erf).
template <typename T>
__device__ __forceinline__ T gwp_smear(T r, T s_i, T s_j) {
  const T s2 = s_i * s_i + s_j * s_j;
  const T sm = x_erf(r / x_sqrt(T(2) * x_max(s2, T(1e-12))));
  return s2 > T(1e-12) ? sm : T(1);
}

}  // namespace
