// Device code shared by the fused Monte Carlo step loops, B1 (uvt_kernel.cu),
// B3 (nvt_kernel.cu) and B6 (pda_kernel.cu): the minimum image, the
// Feynman-Hibbs/Kleinert pair correction, the S(k) delta and its commit,
// the block reduction,
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
  int rd;     // 0 none, 1 lj; an RD form instance: 1 damps disp_expansion
  int mix;    // 0 lorentz-berthelot, 1 waldman-hagler
  int es;     // 0 none, 1 ewald, 2 wolf, 3 cutoff, 4 gwp (form instances)
  int ortho;  // 1: diagonal box, the cross terms of the minimum image dropped
  int qc;     // 0 none, 1 Feynman-Hibbs order 2, 2 order 4, 3 Feynman-Kleinert
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

// The Feynman-Hibbs (order 2 or 4) or Feynman-Kleinert correction of a
// pair's LJ energy (ops/lj.py; the arithmetic of the reference kernel's
// _pair_terms).  Per column of a molecule's pass, quantum_column gives
// the molecule-pair reduced mass red = mm_i mm_j / max(mm_i + mm_j,
// 1e-30) - a frozen framework's huge molecular mass degrades it to mm_i -
// and the prefactors at the chain's beta; quantum_pair the correction of
// one pair from the mixed eps, s6 = (sig^2 / r2s)^3 and r2s.  hb2 is
// hbar^2 / (kB amu A^2) in K (constants.HBAR2_KB_AMU_A2).
template <typename T>
struct Quantum {
  T red, c2, c4, t;
};

template <typename T>
__device__ __forceinline__ Quantum<T> quantum_column(T mm_i, T mm_j, T beta,
                                                     T temp, double hb2,
                                                     const Opts o) {
  Quantum<T> qv;
  const T sm = mm_i + mm_j;
  qv.red = mm_i * mm_j / (sm > T(1e-30) ? sm : T(1e-30));
  qv.t = temp;
  qv.c2 = T(0);
  qv.c4 = T(0);
  if (o.qc == 1 || o.qc == 2) {
    qv.c2 = T(hb2 / 24.0) * beta / x_max(qv.red, T(1e-30));
    if (o.qc == 2)
      qv.c4 = T(hb2 * hb2 / 1152.0) * beta * beta
              / x_max(qv.red * qv.red, T(1e-30));
  }
  return qv;
}

// ln(sinh x / x) and x coth x - 1 for x >= 0 in ops/lj.py's exp/log-only
// forms, with its series below x = 0.1.
template <typename T>
__device__ __forceinline__ T ln_sinhc(T x) {
  if (x < T(0.1)) return x * x / T(6) - x * x * x * x / T(180);
  return x - x_log(T(2) * x_max(x, T(1e-30)))
         + x_log(x_max(T(1) - x_exp(T(-2) * x), T(1e-30)));
}

template <typename T>
__device__ __forceinline__ T xcothx_m1(T x) {
  if (x < T(0.1)) return x * x / T(3) - x * x * x * x / T(45);
  const T e = x_exp(T(-2) * x);
  return (x * (T(1) + e) - (T(1) - e)) / (T(1) - e);
}

// The FK correction W - V from the LJ derivatives v1..v4 at r
// (lj.feynman_kleinert_from_derivs): eight fixed-point rounds, unrolled.
// Not inlined: the kernels evaluate a pair at up to 2 x 8 unrolled call
// sites, and one body per kernel keeps the build short; its ~200
// operations dwarf the call.
template <typename T>
__device__ __noinline__ T fk_correction(T r, T v1, T v2, T v3, T v4,
                                           T red, T t, double hb2) {
  const T m = x_max(red, T(1e-30));
  const T d2 = v2 + T(2) * v1 / r;
  const T d4 = v4 + T(4) * v3 / r;
  const T c_x2 = T(hb2) / (T(4) * t * t);
  const T y_min = T(1e-12);
  T a2 = T(0);
  T y = x_max(d2 / (T(3) * m), y_min);
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const T x = x_sqrt(c_x2 * y);
    a2 = y > y_min ? t / (m * y) * xcothx_m1(x) : T(hb2) / (T(12) * m * t);
    y = x_max((d2 + T(0.5) * a2 * d4) / (T(3) * m), y_min);
  }
  const T x = x_sqrt(c_x2 * y);
  const T dva = T(0.5) * a2 * d2 + T(0.125) * a2 * a2 * d4;
  return T(3) * t * ln_sinhc(x) + dva - T(1.5) * m * y * a2;
}

template <typename T>
__device__ __forceinline__ T quantum_pair(T r2s, T eps, T s6,
                                          const Quantum<T>& qv, double hb2,
                                          const Opts o) {
  const T r = x_sqrt(r2s);
  const T inv_r = T(1) / r;
  const T s12 = s6 * s6;
  const T e4 = T(4) * eps;
  const T v1 = e4 * (T(6) * s6 - T(12) * s12) * inv_r;
  const T v2 = e4 * (T(156) * s12 - T(42) * s6) * (inv_r * inv_r);
  const T inv3 = inv_r * inv_r * inv_r;
  if (o.qc == 3) {
    const T v3 = e4 * (T(336) * s6 - T(2184) * s12) * inv3;
    const T v4 = e4 * (T(32760) * s12 - T(3024) * s6) * (inv3 * inv_r);
    return fk_correction<T>(r, v1, v2, v3, v4, qv.red, qv.t, hb2);
  }
  T u = qv.c2 * (v2 + T(2) * v1 * inv_r);
  if (o.qc == 2) {
    const T v3 = e4 * (T(336) * s6 - T(2184) * s12) * inv3;
    const T v4 = e4 * (T(32760) * s12 - T(3024) * s6) * (inv3 * inv_r);
    u += qv.c4 * (T(15) * v1 * inv3 + T(4) * v3 * inv_r + v4);
  }
  return u;
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
// COM-centred template rows tmpl [na][3] at the fractional COM fr[3] (lanes
// 1-3, or under cavity bias a point of the picked cell: cavity_frac) with a
// uniform (Shoemake) orientation from lanes 5-7; one site (A == 1) only
// translates.
template <typename T>
__device__ __forceinline__ void insert_trial(const T* fr, const T* u,
                                             const T* box, const T* tmpl,
                                             int A, int na, T (*s_new)[3]) {
  const T two_pi = T(6.283185307179586476925);
  T cnew[3];
#pragma unroll
  for (int e = 0; e < 3; ++e)
    cnew[e] = fr[0] * box[e] + fr[1] * box[3 + e] + fr[2] * box[6 + e];
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

// The µVT extras of B1 and B6 (their XT instances): cavity-biased insertion,
// in B1 the TMMC collection with its flat-histogram bias, and the spinflip
// move.
//   cavity bias (cav): an insert's COM lies in an open cell of the g^3 grid
//   of the last refresh, cav_list [C, g3] holding each chain's open cell ids
//   in rank order and cav_n [C] their count; the acceptance gains
//   +-ln(n_open / g3), and an insert with no open cell is rejected;
//   TMMC (tm, B1): every insert or delete attempt adds (1, a) to row N (the
//   insert species' alive count before the move) of the chain's [rows, 4]
//   block of tmmc (n_ins, sum a_ins, n_del, sum a_del), a the unbiased
//   min(1, e^{ln_t}), 0 on a reject; under tmmc_bias (bias) the acceptance,
//   never the collection, adds eta(N') - eta(N) of the shared eta [ke];
//   spinflip (sf): lane 11 < p_spin (the scalar header's) carves the move
//   out before the move type; the rotor is the displacement's pick, d_f =
//   F[1 - s] - F[s] from rot [C, ms, 2] (F_para, F_ortho) at its spin s,
//   accepted with ln u4 < -beta d_f; an accept flips the spin only.  B1
//   keeps a replica of its chain's spins per CTA, spin [C, G, ms] (every
//   CTA flips alike, each its own row); B6, whose state is fixed, reads
//   spin [ms].  Every CTA of a chain reads the same lane, so a spinflip
//   step skips the pass, the exchange and the barriers in every CTA.
template <typename T>
struct XtArgs {
  const int32_t* cav_list;
  const int32_t* cav_n;
  const T* eta;
  double* tmmc;
  int g, g3, ke, rows;
  int cav, tm, bias;
  const T* rot;
  int32_t* spin;
  int sf;
};

// Thread 0: whether a spinflip of the rotor with spin s_cur and free
// energies (fp, fo) = (F_para, F_ortho) is accepted at beta on the coin
// u4 (ln u4 < -beta d_f, d_f in T, as the reference's float32 table).
template <typename T>
__device__ __forceinline__ bool spinflip_accept(int s_cur, T fp, T fo,
                                                double beta, T u4) {
  const T d_f = s_cur ? fp - fo : fo - fp;
  return log(fmax(double(u4), 1e-38)) < -beta * double(d_f);
}

// Thread 0: the fractional COM of a cavity-biased insert: the open cell of
// rank j = min(floor(u10 n_open), n_open - 1) of the chain's list (n_open >
// 0), then the point (ijk + lanes 1-3) / g inside it — the reference
// kernel's arithmetic (mpmc_tpu/ops/pallas/mc_kernel.py:1166-1190).
template <typename T>
__device__ __forceinline__ void cavity_frac(const T* u, const int32_t* list,
                                            int n_open, int g, T (&fr)[3]) {
  const T nT = T(n_open);
  const int j = int(x_min(x_floor(u[10] * nT), nT - T(1)));
  const int cell = list[j];
  const int ijk[3] = {cell / (g * g), (cell / g) % g, cell % g};
#pragma unroll
  for (int e = 0; e < 3; ++e) fr[e] = (T(ijk[e]) + u[1 + e]) / T(g);
}

// ln(n_open / g3), the cavity-bias term of an insert (minus: of a delete);
// n_open = 0 gives ln(1e-30 / g3), as the reference.
__device__ __forceinline__ double cavity_lnf(int n_open, int g3) {
  return log(fmax(double(n_open), 1e-30)) - log(double(g3));
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
