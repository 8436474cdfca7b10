// Device code shared by the fused Monte Carlo step loops, B1 (uvt_kernel.cu),
// B3 (nvt_kernel.cu) and B6 (pda_kernel.cu): the minimum image and the
// per-pair evaluation, the S(k) delta and its commit, the block reduction,
// the slot pick of a µVT move, and the trial rows of an insertion and of a
// displacement (a translation plus an axis-angle rotation about the
// mass-weighted COM).
//
// Every block has NT threads: B1, B3 and B6 run one cluster of blocks per
// chain (mc_cluster.cuh).  Each thread sums its pair
// terms in double; warps reduce by shuffles and thread 0 adds the warps'
// partials in a fixed order, so a launch gives the same bits every run.
// erfc is the exact erfcf/erfc.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_math.cuh"

namespace {

constexpr int NT = 512;          // threads per block
constexpr int NW = NT / 32;
constexpr int A_PAD = 8;         // most sites per molecule
constexpr unsigned FULL = 0xffffffffu;

struct Opts {
  int rd;     // 0 none, 1 lj
  int mix;    // 0 lorentz-berthelot, 1 waldman-hagler
  int es;     // 0 none, 1 ewald, 2 wolf, 3 cutoff
  int ortho;  // 1: diagonal box, the cross terms of the minimum image dropped
};

// Minimum image (rx, ry, rz) of a displacement (dx, dy, dz).
template <typename T>
__device__ __forceinline__ void min_image(T dx, T dy, T dz,
                                          const T* __restrict__ box,
                                          const T* __restrict__ bi, int ortho,
                                          T& rx, T& ry, T& rz) {
  if (ortho) {
    T f0 = dx * bi[0], f1 = dy * bi[4], f2 = dz * bi[8];
    f0 -= x_rint(f0);   // half to even, like torch.round / jnp.round
    f1 -= x_rint(f1);
    f2 -= x_rint(f2);
    rx = f0 * box[0];
    ry = f1 * box[4];
    rz = f2 * box[8];
  } else {
    T f0 = dx * bi[0] + dy * bi[3] + dz * bi[6];
    T f1 = dx * bi[1] + dy * bi[4] + dz * bi[7];
    T f2 = dx * bi[2] + dy * bi[5] + dz * bi[8];
    f0 -= x_rint(f0);
    f1 -= x_rint(f1);
    f2 -= x_rint(f2);
    rx = f0 * box[0] + f1 * box[3] + f2 * box[6];
    ry = f0 * box[1] + f1 * box[4] + f2 * box[7];
    rz = f0 * box[2] + f1 * box[5] + f2 * box[8];
  }
}

// The unmasked (rd, es) of a pair at squared distance r2 when it lies
// within rc (both 0 otherwise).  The Coulomb constant is applied by the
// caller.
template <typename T>
__device__ __forceinline__ void pair_energy(T r2, T ei, T si, T qi, T ej,
                                            T sj, T qj, const Opts o, T rc,
                                            T rc2, T alpha, T& rd, T& es) {
  rd = T(0);
  es = T(0);
  if (!(r2 < rc2)) return;
  const T r2s = r2 > T(1e-12) ? r2 : T(1);
  if (o.rd == 1) {
    T eps, sig;
    if (o.mix == 0) {
      eps = x_sqrt(ei * ej);
      sig = T(0.5) * (si + sj);
    } else {
      const T s3i = si * si * si, s3j = sj * sj * sj;
      T denom = s3i * s3i + s3j * s3j;
      // max(x, 1e-300): the bound is 0 in float, as in the reference
      denom = denom > T(1e-300) ? denom : T(1e-300);
      sig = x_pow(T(0.5) * denom, T(1.0 / 6.0));
      eps = x_sqrt(ei * ej) * (T(2) * s3i * s3j / denom);
    }
    const T s2 = sig * sig / r2s;
    const T s6 = s2 * s2 * s2;
    rd = T(4) * eps * s6 * (s6 - T(1));
  }
  if (o.es != 0) {
    const T r = x_sqrt(r2s);
    const T qq = qi * qj;
    if (o.es == 1) {
      es = qq * x_erfc(alpha * r) / r;
    } else if (o.es == 2) {
      es = qq * (x_erfc(alpha * r) / r - x_erfc(alpha * rc) / rc);
    } else {
      es = qq / r;
    }
  }
}

// This thread's share of the S(k) delta over the k-vectors kk = t, t + NT,
// ... < nk: dS = sum_a q_a (cis(k.r_new) - cis(k.r_old)) into the scratch
// row (DSr, DSi), and kcoef (|S + dS|^2 - |S|^2) added to a_rec.
template <typename T>
__device__ __forceinline__ void sk_delta(
    const T* __restrict__ kvec, const T* __restrict__ kcoef, const T* SKr,
    const T* SKi, T* DSr, T* DSi, int nk, int na, bool has_old,
    bool has_new, const T (*s_old)[3], const T (*s_new)[3], const T* s_qi,
    double& a_rec) {
  for (int kk = threadIdx.x; kk < nk; kk += NT) {
    const T kx = kvec[3 * kk], ky = kvec[3 * kk + 1], kz = kvec[3 * kk + 2];
    T dr = T(0), di = T(0);
    for (int a = 0; a < na; ++a) {
      T sn = T(0), cn = T(0), so = T(0), co = T(0);
      if (has_new)
        x_sincos(kx * s_new[a][0] + ky * s_new[a][1] + kz * s_new[a][2],
                 &sn, &cn);
      if (has_old)
        x_sincos(kx * s_old[a][0] + ky * s_old[a][1] + kz * s_old[a][2],
                 &so, &co);
      dr += s_qi[a] * (cn - co);
      di += s_qi[a] * (sn - so);
    }
    const T sr = SKr[kk], si = SKi[kk];
    a_rec += double(kcoef[kk] * ((T(2) * sr + dr) * dr
                                 + (T(2) * si + di) * di));
    DSr[kk] = dr;
    DSi[kk] = di;
  }
}

// Commit of an accepted step's S(k) delta; each thread adds the entries it
// computed in sk_delta, so no barrier is needed between the two.
template <typename T>
__device__ __forceinline__ void sk_commit(T* SKr, T* SKi, const T* DSr,
                                          const T* DSi, int nk) {
  for (int kk = threadIdx.x; kk < nk; kk += NT) {
    SKr[kk] += DSr[kk];
    SKi[kk] += DSi[kk];
  }
}

// Warp shuffles, then each warp's partials into shared memory; ends with a
// block barrier, after which thread 0 reads the totals (block_totals).
template <typename T>
__device__ __forceinline__ void block_reduce(double a_rd, double a_es,
                                             double a_rec, T mn,
                                             double (*s_red)[NW], T* s_min) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a_rd += __shfl_down_sync(FULL, a_rd, off);
    a_es += __shfl_down_sync(FULL, a_es, off);
    a_rec += __shfl_down_sync(FULL, a_rec, off);
    mn = x_min(mn, __shfl_down_sync(FULL, mn, off));
  }
  if (lane == 0) {
    s_red[0][warp] = a_rd;
    s_red[1][warp] = a_es;
    s_red[2][warp] = a_rec;
    s_min[warp] = mn;
  }
  __syncthreads();
}

// The warps' partials added in a fixed order (thread 0, after block_reduce).
template <typename T>
__device__ __forceinline__ void block_totals(const double (*s_red)[NW],
                                             const T* s_min, double& drd,
                                             double& des, double& drec,
                                             T& mr2) {
  drd = 0.0;
  des = 0.0;
  drec = 0.0;
  mr2 = T(INFINITY);
  for (int w = 0; w < NW; ++w) {
    drd += s_red[0][w];
    des += s_red[1][w];
    drec += s_red[2][w];
    mr2 = x_min(mr2, s_min[w]);
  }
}

// Rotation matrix about a uniform axis (z = 2 u5 - 1, azimuth 2 pi u6) by
// the angle u7 * rotf.
template <typename T>
__device__ __forceinline__ void axis_angle_rotation(T u5, T u6, T u7, T rotf,
                                                    T (&R)[3][3]) {
  const T two_pi = T(6.283185307179586476925);
  const T az = T(2) * u5 - T(1);
  const T aphi = two_pi * u6;
  const T s = x_sqrt(x_max(T(1) - az * az, T(0)));
  const T ax = s * x_cos(aphi), ay = s * x_sin(aphi);
  const T ang = u7 * rotf;
  const T ca = x_cos(ang), sa = x_sin(ang);
  const T omc = T(1) - ca;
  R[0][0] = ca + ax * ax * omc;
  R[0][1] = ax * ay * omc - az * sa;
  R[0][2] = ax * az * omc + ay * sa;
  R[1][0] = ay * ax * omc + az * sa;
  R[1][1] = ca + ay * ay * omc;
  R[1][2] = ay * az * omc - ax * sa;
  R[2][0] = az * ax * omc - ay * sa;
  R[2][1] = az * ay * omc + ax * sa;
  R[2][2] = ca + az * az * omc;
}

// Mass-weighted COM of a molecule's na rows.
template <typename T>
__device__ __forceinline__ void mass_com(const T (*rows)[3], const T* m,
                                         int na, T (&com)[3]) {
  T msum = T(0);
  com[0] = com[1] = com[2] = T(0);
  for (int a = 0; a < na; ++a) msum += m[a];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    for (int a = 0; a < na; ++a) com[e] += m[a] * rows[a][e];
    com[e] = com[e] / x_max(msum, T(1e-30));
  }
}

// Rows tr + R rel_a of a rigid body placed at tr with orientation R.
template <typename T>
__device__ __forceinline__ void place_row(const T (&tr)[3],
                                          const T (&R)[3][3],
                                          const T (&rel)[3], T* out) {
#pragma unroll
  for (int e = 0; e < 3; ++e)
    out[e] = tr[e] + (R[e][0] * rel[0] + R[e][1] * rel[1] + R[e][2] * rel[2]);
}

// Thread 0: the trial rows of an insertion from the step's uniforms u: the
// COM-centred template rows tmpl [na][3] at fractional COM lanes 1-3 with a
// uniform (Shoemake) orientation from lanes 5-7; one site (A == 1) only
// translates.
template <typename T>
__device__ __forceinline__ void insert_trial(const T* u, const T* box,
                                             const T* tmpl, int A, int na,
                                             T (*s_new)[3]) {
  const T two_pi = T(6.283185307179586476925);
  T cnew[3];
#pragma unroll
  for (int e = 0; e < 3; ++e)
    cnew[e] = u[1] * box[e] + u[2] * box[3 + e] + u[3] * box[6 + e];
  if (A == 1) {
#pragma unroll
    for (int e = 0; e < 3; ++e) s_new[0][e] = cnew[e];
    return;
  }
  T R[3][3];
  const T sq1 = x_sqrt(x_max(T(1) - u[5], T(0)));
  const T sq2 = x_sqrt(x_max(u[5], T(0)));
  const T th1 = two_pi * u[6], th2 = two_pi * u[7];
  const T qx = sq1 * x_sin(th1), qy = sq1 * x_cos(th1);
  const T qz = sq2 * x_sin(th2), qw = sq2 * x_cos(th2);
  R[0][0] = 1 - 2 * (qy * qy + qz * qz);
  R[0][1] = 2 * (qx * qy - qz * qw);
  R[0][2] = 2 * (qx * qz + qy * qw);
  R[1][0] = 2 * (qx * qy + qz * qw);
  R[1][1] = 1 - 2 * (qx * qx + qz * qz);
  R[1][2] = 2 * (qy * qz - qx * qw);
  R[2][0] = 2 * (qx * qz - qy * qw);
  R[2][1] = 2 * (qy * qz + qx * qw);
  R[2][2] = 1 - 2 * (qx * qx + qy * qy);
  for (int a = 0; a < na; ++a) {
    T rel[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) rel[e] = tmpl[a * 3 + e];
    place_row<T>(cnew, R, rel, s_new[a]);
  }
}

// Block-wide (every thread calls it, with block-uniform arguments): the
// index of the (j+1)-th eligible slot of the slot table (alive flags SA,
// species slot_species, ms slots) — a free slot of species su for an
// insert, an alive one of species su for a delete, any alive slot for a
// displacement — by an inclusive scan over NT slots at a time.  The caller
// has checked that at least j + 1 slots are eligible.
__device__ __forceinline__ int pick_slot(const bool* SA,
                                         const int32_t* __restrict__
                                             slot_species,
                                         int ms, bool ins, bool del, int su,
                                         int j, int* s_scan, int* s_slot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int base = 0;
  for (int t0 = 0; t0 < ms; t0 += NT) {
    const int i = t0 + t;
    int f = 0;
    if (i < ms) {
      const bool al = SA[i];
      const bool same = slot_species[i] == su;
      f = ins ? (!al && same) : (del ? (al && same) : al);
    }
    int x = f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_scan[warp] = x;
    __syncthreads();
    int before = 0, tot = 0;
    for (int w = 0; w < NW; ++w) {
      const int v = s_scan[w];
      if (w < warp) before += v;
      tot += v;
    }
    if (f && base + before + x == j + 1) *s_slot = i;
    base += tot;
    __syncthreads();
    if (base > j) break;
  }
  return *s_slot;
}

// Thread 0: the trial rows of a displacement from the step's uniforms u
// (lanes 1-3 the translation in a cube of half-width mf, lanes 5-7 the
// rotation).  With at most one site per molecule (A == 1) a move only
// translates; otherwise the molecule turns about its mass-weighted COM.
template <typename T>
__device__ __forceinline__ void displace_trial(const T* u, T mf, T rotf,
                                               int A, int na,
                                               const T (*s_old)[3],
                                               const T* s_mi,
                                               T (*s_new)[3]) {
  T dsp[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) dsp[e] = (T(2) * u[1 + e] - T(1)) * mf;
  if (A == 1) {
#pragma unroll
    for (int e = 0; e < 3; ++e) s_new[0][e] = s_old[0][e] + dsp[e];
    return;
  }
  T com[3], R[3][3], tr[3];
  mass_com<T>(s_old, s_mi, na, com);
  axis_angle_rotation<T>(u[5], u[6], u[7], rotf, R);
#pragma unroll
  for (int e = 0; e < 3; ++e) tr[e] = com[e] + dsp[e];
  for (int a = 0; a < na; ++a) {
    T rel[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) rel[e] = s_old[a][e] - com[e];
    place_row<T>(tr, R, rel, s_new[a]);
  }
}

}  // namespace
