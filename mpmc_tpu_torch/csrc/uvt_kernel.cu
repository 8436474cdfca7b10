// Fused µVT (GCMC) step loop, hand-written for Hopper (sm_90a).
//
// B1 run_steps_uvt replaces mpmc_tpu/ops/pallas/mc_kernel.py::_kernel_uvt
//   (wrappers run_steps_uvt / run_steps_uvt_multi): K whole GCMC steps per
//   launch for C independent chains, the system held on the card between
//   steps.  Per step: the move type (lane 8: insert below p_ins/2, delete
//   below p_ins, else displace), the species of an insert/delete (lane 9),
//   the j-th free/alive slot by a block-wide prefix scan (lane 0), the trial
//   rows (displace: translation from lanes 1-3 and an axis-angle rotation
//   from lanes 5-7 about the COM; insert: fractional COM from lanes 1-3 and
//   a Shoemake quaternion from lanes 5-7), ONE old+new pass over all N
//   columns (LJ with Lorentz-Berthelot or Waldman-Hagler mixing, the
//   real-space Ewald/Wolf/cutoff Coulomb term, the closest approach for
//   autoreject; the molecule's own columns masked), the S(k) delta over the
//   Nk k-vectors, the acceptance test with the per-species self, exclusion
//   and LRC constants, and the in-place commit of positions, atom alive
//   flags, the slot table's alive row and S(k).
//
// Design: one thread block per chain (grid = C, NT threads), the K steps a
//   loop inside the block (the TPU kernel's sequential fori_loop).  The
//   per-atom planes (pos [C,N,3], alive [C,N], eps/sig/q/mass [N]: ~0.3 MB
//   per chain at N = 10.8k) stay in device memory, where they are
//   L2-resident; shared memory holds only the step's trial rows, the
//   per-species tables, the slot-scan and the reduction scratch.  The
//   S(k) delta of the step goes to a per-chain scratch row in device memory
//   (dsk) and is committed by the thread that computed it.
//
// Bound: operations.  A step evaluates (has_old + has_new) x A x (alive
//   columns) pairs - up to 2 x 3 x 10,797 = 64.8k at the 10.8k bench
//   system - at 44 floating-point operations each, counting a square root,
//   a division, erfc and a rounding as one (displacement 3, orthorhombic
//   minimum image 12, r^2 5, cutoff test and guard 2, LJ 13, Coulomb 6,
//   sums 3), plus (has_old + has_new) x A x Nk phases of 13 and Nk
//   reciprocal-energy terms of 9: about 2.7 Mflop per step, 0.04 us at the
//   card's 67 TFLOP/s f32 peak, against 0.3 MB of planes per chain.  One
//   block per chain can use one SM, 1/132 of that peak: ~5 us per step at
//   best.  The design buys chains, not steps - C chains run on C SMs at
//   once - and leaves splitting one chain over several SMs (thread-block
//   clusters, a cooperative grid) to later work.
//
// Reductions: each thread sums its pair terms in double; warps reduce by
//   shuffles and thread 0 adds the warps' partials in a fixed order, so a
//   launch gives the same bits every run.  The chunk accumulators (the 14
//   sums) are double too.  The acceptance test runs in double on thread 0.
//   Energy deltas enter the accumulators by selection (accept ? v : 0),
//   never by multiplication: a rejected deep-core insert has an infinite
//   pair energy and 0 * inf would be NaN.  erfc is the exact erfcf/erfc.
//
// Sums [C,14] in the reference order: d_rd, d_es_real, d_es_recip,
//   d_es_self, d_es_excl, d_lrc, acc_disp, acc_ins, acc_del, att_disp,
//   att_ins, att_del, acc_spin, att_spin (the last two stay 0: spinflip is
//   not in this kernel).
//
// Scalar header scal[24]: rc, alpha, move_factor, rot_factor, thr2, p_ins,
//   box (3x3 row-major, rows are cell vectors), box^-1 (3x3 row-major).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_math.cuh"

namespace {

constexpr int NT = 512;          // threads per block (one block per chain)
constexpr int NW = NT / 32;
constexpr int A_PAD = 8;         // most sites per molecule
constexpr int S_MAX = 8;         // most insert species
constexpr int N_SUMS = 14;
constexpr unsigned FULL = 0xffffffffu;

struct Dims {
  int C, n, ms, S, A, K, nk;
};

struct Opts {
  int rd;     // 0 none, 1 lj
  int mix;    // 0 lorentz-berthelot, 1 waldman-hagler
  int es;     // 0 none, 1 ewald, 2 wolf, 3 cutoff
  int ortho;  // 1: diagonal box, the cross terms of the minimum image dropped
};

// Minimum-image r^2 of a displacement, and the unmasked (rd, es) of the pair
// when it lies within rc (both 0 otherwise).  The Coulomb constant is
// applied by the caller.
template <typename T>
__device__ __forceinline__ void pair_uvt(
    T dx, T dy, T dz, T ei, T si, T qi, T ej, T sj, T qj,
    const T* __restrict__ box, const T* __restrict__ bi, const Opts o, T rc,
    T rc2, T alpha, T& r2, T& rd, T& es) {
  T rx, ry, rz;
  if (o.ortho) {
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
  r2 = rx * rx + ry * ry + rz * rz;
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

template <typename T>
__global__ void __launch_bounds__(NT) uvt_kernel(
    T* pos, bool* alive, const T* __restrict__ eps,
    const T* __restrict__ sig, const T* __restrict__ q,
    const T* __restrict__ mass, const int32_t* __restrict__ slot_start,
    const int32_t* __restrict__ slot_species, bool* slot_alive,
    const T* __restrict__ tmpl, const int32_t* __restrict__ natoms,
    const T* __restrict__ scal, const T* __restrict__ betas,
    const T* __restrict__ lnfvs, const T* __restrict__ d_self,
    const T* __restrict__ d_excl, const T* __restrict__ c1,
    const T* __restrict__ cx, const T* __restrict__ u,
    const T* __restrict__ kvec, const T* __restrict__ kcoef, T* sk, T* dsk,
    double* __restrict__ sums, const Dims d, const Opts o,
    const double ke) {
  __shared__ T s_box[9], s_bi[9];
  __shared__ T s_tmpl[S_MAX * A_PAD * 3];
  __shared__ double s_dself[S_MAX], s_dexcl[S_MAX], s_c1[S_MAX],
      s_lnfv[S_MAX], s_cx[S_MAX * S_MAX];
  __shared__ int s_na[S_MAX], s_nvalid[S_MAX], s_nalive[S_MAX];
  __shared__ T s_u[16];
  __shared__ T s_old[A_PAD][3], s_new[A_PAD][3];
  __shared__ T s_qi[A_PAD], s_ei[A_PAD], s_si[A_PAD], s_mi[A_PAD];
  __shared__ int s_scan[NW];
  __shared__ int s_slot, s_accept;
  __shared__ double s_red[3][NW];
  __shared__ T s_min[NW];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c = blockIdx.x;
  const int n = d.n, ms = d.ms, S = d.S, A = d.A, nk = d.nk;
  T* P = pos + size_t(c) * n * 3;
  bool* AL = alive + size_t(c) * n;
  bool* SA = slot_alive + size_t(c) * ms;
  T* SKr = sk + size_t(c) * 2 * nk;
  T* SKi = SKr + nk;
  T* DSr = dsk + size_t(c) * 2 * nk;
  T* DSi = DSr + nk;
  const T* U = u + size_t(c) * d.K * 16;

  // ---- per-launch tables: box, species constants, slot counts
  if (t < 9) {
    s_box[t] = scal[6 + t];
    s_bi[t] = scal[15 + t];
  }
  if (t < S) {
    s_na[t] = natoms[t];
    s_dself[t] = double(d_self[t]);
    s_dexcl[t] = double(d_excl[t]);
    s_c1[t] = double(c1[t]);
    s_lnfv[t] = double(lnfvs[size_t(c) * S + t]);
    s_nvalid[t] = 0;
    s_nalive[t] = 0;
  }
  if (t < S * S) s_cx[t] = double(cx[t]);
  for (int i = t; i < S * A * 3; i += NT) s_tmpl[i] = tmpl[i];
  __syncthreads();
  for (int i = t; i < ms; i += NT) {
    const int sp = slot_species[i];
    atomicAdd(&s_nvalid[sp], 1);   // integer counts: exact in any order
    if (SA[i]) atomicAdd(&s_nalive[sp], 1);
  }

  const T rc = scal[0], alpha = scal[1], mf = scal[2], rotf = scal[3];
  const T thr2 = scal[4], p_ins = scal[5];
  const T p_half = T(0.5) * p_ins;
  const T rc2 = rc * rc;
  const double beta = double(betas[c]);
  const T two_pi = T(6.283185307179586476925);
  double acc[N_SUMS];
#pragma unroll
  for (int i = 0; i < N_SUMS; ++i) acc[i] = 0.0;

  for (int k = 0; k < d.K; ++k) {
    if (t < 16) s_u[t] = U[size_t(k) * 16 + t];
    __syncthreads();
    // ---- move type, species, eligible count (uniform over the block)
    const T u8 = s_u[8];
    const bool ins = u8 < p_half;
    const bool del = !ins && u8 < p_ins;
    const bool disp = !ins && !del;
    const int mt = disp ? 0 : (ins ? 1 : 2);
    const int su = S == 1 ? 0 : min(int(s_u[9] * T(S)), S - 1);
    int n_all = 0;
    for (int s = 0; s < S; ++s) n_all += s_nalive[s];
    const int cnt = ins ? s_nvalid[su] - s_nalive[su]
                        : (del ? s_nalive[su] : n_all);
    if (t == 0) acc[9 + mt] += 1.0;
    if (cnt == 0) {          // nothing to move: rejected, no pass
      __syncthreads();
      continue;
    }
    const T cntT = T(cnt);
    const int j = int(x_min(x_floor(s_u[0] * cntT), cntT - T(1)));

    // ---- the j-th eligible slot: block-wide inclusive scan, NT at a time
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
      if (f && base + before + x == j + 1) s_slot = i;
      base += tot;
      __syncthreads();
      if (base > j) break;
    }
    const int slot = s_slot;
    const int start = slot_start[slot];
    const int spf = disp ? slot_species[slot] : su;
    const int na = s_na[spf];

    // ---- the molecule's current rows, then its trial rows (thread 0)
    if (t < na) {
      const int r = start + t;
      s_old[t][0] = P[3 * r];
      s_old[t][1] = P[3 * r + 1];
      s_old[t][2] = P[3 * r + 2];
      s_qi[t] = q[r];
      s_ei[t] = eps[r];
      s_si[t] = sig[r];
      s_mi[t] = mass[r];
    }
    __syncthreads();
    if (t == 0) {
      T dsp[3], cnew[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        dsp[e] = (T(2) * s_u[1 + e] - T(1)) * mf;
        cnew[e] = s_u[1] * s_box[e] + s_u[2] * s_box[3 + e]
                  + s_u[3] * s_box[6 + e];
      }
      if (A == 1) {
#pragma unroll
        for (int e = 0; e < 3; ++e)
          s_new[0][e] = ins ? cnew[e] : s_old[0][e] + dsp[e];
      } else {
        T msum = T(0), com[3] = {T(0), T(0), T(0)};
        for (int a = 0; a < na; ++a) msum += s_mi[a];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          for (int a = 0; a < na; ++a) com[e] += s_mi[a] * s_old[a][e];
          com[e] = com[e] / x_max(msum, T(1e-30));
        }
        T R[3][3];
        if (ins) {   // uniform orientation (Shoemake) from lanes 5-7
          const T sq1 = x_sqrt(x_max(T(1) - s_u[5], T(0)));
          const T sq2 = x_sqrt(x_max(s_u[5], T(0)));
          const T th1 = two_pi * s_u[6], th2 = two_pi * s_u[7];
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
        } else {     // uniform axis, angle uniform in [0, rot_factor)
          const T az = T(2) * s_u[5] - T(1);
          const T aphi = two_pi * s_u[6];
          const T s = x_sqrt(x_max(T(1) - az * az, T(0)));
          const T ax = s * x_cos(aphi), ay = s * x_sin(aphi);
          const T ang = s_u[7] * rotf;
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
        T tr[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) tr[e] = ins ? cnew[e] : com[e] + dsp[e];
        for (int a = 0; a < na; ++a) {
          T rel[3];
#pragma unroll
          for (int e = 0; e < 3; ++e)
            rel[e] = ins ? s_tmpl[(spf * A + a) * 3 + e] : s_old[a][e] - com[e];
#pragma unroll
          for (int e = 0; e < 3; ++e)
            s_new[a][e] = tr[e] + (R[e][0] * rel[0] + R[e][1] * rel[1]
                                   + R[e][2] * rel[2]);
        }
      }
    }
    __syncthreads();

    // ---- one old+new pass over the columns, then the S(k) delta
    const bool has_old = !ins, has_new = !del;
    double a_rd = 0.0, a_es = 0.0, a_rec = 0.0;
    T mn = T(INFINITY);
    for (int jc = t; jc < n; jc += NT) {
      if (!AL[jc] || (jc >= start && jc < start + na)) continue;
      const T xj = P[3 * jc], yj = P[3 * jc + 1], zj = P[3 * jc + 2];
      const T qj = q[jc], ej = eps[jc], sj = sig[jc];
#pragma unroll
      for (int a = 0; a < A_PAD; ++a) {
        if (a >= na) break;
        T r2, rd, es;
        if (has_old) {
          pair_uvt<T>(s_old[a][0] - xj, s_old[a][1] - yj, s_old[a][2] - zj,
                      s_ei[a], s_si[a], s_qi[a], ej, sj, qj, s_box, s_bi, o,
                      rc, rc2, alpha, r2, rd, es);
          a_rd -= double(rd);
          a_es -= double(es);
        }
        if (has_new) {
          pair_uvt<T>(s_new[a][0] - xj, s_new[a][1] - yj, s_new[a][2] - zj,
                      s_ei[a], s_si[a], s_qi[a], ej, sj, qj, s_box, s_bi, o,
                      rc, rc2, alpha, r2, rd, es);
          a_rd += double(rd);
          a_es += double(es);
          mn = x_min(mn, r2);
        }
      }
    }
    if (o.es == 1) {
      for (int kk = t; kk < nk; kk += NT) {
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

    // ---- acceptance (thread 0, double)
    if (t == 0) {
      double drd = 0.0, des = 0.0, drec = 0.0;
      T mr2 = T(INFINITY);
      for (int w = 0; w < NW; ++w) {
        drd += s_red[0][w];
        des += s_red[1][w];
        drec += s_red[2][w];
        mr2 = x_min(mr2, s_min[w]);
      }
      des = ke * des;
      const double fins = ins ? 1.0 : 0.0, fdel = del ? 1.0 : 0.0;
      const double sgn = fins - fdel;
      const double dslf = sgn * s_dself[spf];
      const double dexc = sgn * s_dexcl[spf];
      double cx_dot = 0.0;
      for (int s = 0; s < S; ++s)
        cx_dot += s_cx[spf * S + s] * double(s_nalive[s]);
      const double dlrc = fins * (s_c1[spf] + cx_dot)
                          - fdel * (s_c1[spf] + cx_dot - s_cx[spf * S + spf]);
      const double du = drd + des + drec + dslf + dexc + dlrc;
      const double n_s = double(s_nalive[su]);
      double lnb = 0.0;
      if (ins) {
        lnb = s_lnfv[spf] + log(beta) - log(n_s + 1.0);
      } else if (del) {
        lnb = log(fmax(n_s, 1e-30)) - log(beta) - s_lnfv[spf];
      }
      const bool reject = thr2 > T(0) && has_new && mr2 < thr2;
      const double ln_t = lnb - beta * du;
      const bool accept = !reject && log(fmax(double(s_u[4]), 1e-38)) < ln_t;
      if (accept) {   // select, never multiply: du may be inf on a reject
        acc[0] += drd;
        acc[1] += des;
        acc[2] += drec;
        acc[3] += dslf;
        acc[4] += dexc;
        acc[5] += dlrc;
        acc[6 + mt] += 1.0;
      }
      s_accept = accept;
    }
    __syncthreads();

    // ---- commit in place
    if (s_accept) {
      if (t < na) {
        const int r = start + t;
        if (!del) {
          P[3 * r] = s_new[t][0];
          P[3 * r + 1] = s_new[t][1];
          P[3 * r + 2] = s_new[t][2];
        }
        AL[r] = !del;
      }
      if (o.es == 1) {
        for (int kk = t; kk < nk; kk += NT) {
          SKr[kk] += DSr[kk];
          SKi[kk] += DSi[kk];
        }
      }
      if (t == 0 && !disp) {
        SA[slot] = ins;
        s_nalive[su] += ins ? 1 : -1;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < N_SUMS; ++i) sums[size_t(c) * N_SUMS + i] = acc[i];
  }
}

}  // namespace

#define RUN_STEPS_UVT_ENTRY(SFX, T)                                          \
  extern "C" int run_steps_uvt_##SFX(                                       \
      void* pos, void* alive, const void* eps, const void* sig,              \
      const void* q, const void* mass, const void* slot_start,               \
      const void* slot_species, void* slot_alive, const void* tmpl,          \
      const void* natoms, const void* scal, const void* betas,               \
      const void* lnfvs, const void* d_self, const void* d_excl,             \
      const void* c1, const void* cx, const void* u, const void* kvec,       \
      const void* kcoef, void* sk, void* dsk, void* sums, int C, int n,      \
      int ms, int S, int A, int K, int nk, int rd, int mix, int es,          \
      int ortho, double ke, void* stream) {                                  \
    if (C <= 0) return 0;                                                    \
    uvt_kernel<T><<<C, NT, 0, (cudaStream_t)stream>>>(                       \
        (T*)pos, (bool*)alive, (const T*)eps, (const T*)sig, (const T*)q,    \
        (const T*)mass, (const int32_t*)slot_start,                          \
        (const int32_t*)slot_species, (bool*)slot_alive, (const T*)tmpl,     \
        (const int32_t*)natoms, (const T*)scal, (const T*)betas,             \
        (const T*)lnfvs, (const T*)d_self, (const T*)d_excl, (const T*)c1,   \
        (const T*)cx, (const T*)u, (const T*)kvec, (const T*)kcoef, (T*)sk,  \
        (T*)dsk, (double*)sums, Dims{C, n, ms, S, A, K, nk},                 \
        Opts{rd, mix, es, ortho}, ke);                                       \
    return int(cudaGetLastError());                                          \
  }

RUN_STEPS_UVT_ENTRY(f32, float)
RUN_STEPS_UVT_ENTRY(f64, double)
