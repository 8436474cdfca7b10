// B6 run_steps_uvt_pda: the propose-and-filter µVT kernel of the fused
// polar delayed acceptance, hand-written for Hopper (sm_90a).
//
// Replaces mpmc_tpu/ops/pallas/mc_kernel.py::_kernel_uvt_pda (wrapper
//   run_steps_uvt_pda).  Up to K µVT proposals per launch from ONE fixed
//   state, which the kernel reads and never writes: a stage-1 rejection
//   changes nothing, so every step proposes from the same resident planes.
//   Per step: the move type (lane 8: insert below p_ins/2, delete below
//   p_ins, else displace), the species of an insert/delete (lane 9), the
//   j-th free/alive slot (lane 0, block prefix scan), the trial rows (lanes
//   1-3 and 5-7, as B1), then ONE old+new pass over the N columns (the
//   molecule's own columns masked) that computes, per column j:
//   - the old and new pair terms (LJ with lb/waldman_hagler mixing, the
//     real-space ewald/wolf/cutoff Coulomb term) and the closest approach;
//   - the damped charge-field delta of the moved sites at j,
//     dE_j = sum_a q_a [c(r_old) dr_old - c(r_new) dr_new] with dr = r_a -
//     r_j, summed over the sites BEFORE it is squared into the surrogate
//     term alpha_j (2 E0_j.dE_j + |dE_j|^2) of the others;
//   - per trial site a, the field of the column charges at the trial row,
//     en[a] (and under polar_ewald the real-space field at the old row,
//     eo[a]).
//   c(r) is thole._field_coef: direct d1 / r^3; wolf and ewald the
//   erfc-screened kernel shifted by k_rc, plus the Thole near field
//   (d1 - 1) / r^3.  Then the S(k) delta against the resident S(k) (read
//   only), the zodid surrogate delta
//     d* = -ke/2 [z_others + z_new (has_new) - z_old (has_old)],
//   z_new = sum_a alpha_a |E_a|^2 with E_a = en[a] (under polar_ewald
//   e0_old[a] + en[a] - eo[a] for a move, anchored on the resident full
//   field), z_old = sum_a alpha_a |e0_old[a]|^2, and the stage-1 test
//   ln(max(u4, 1e-38)) < lnb - beta (du + d*) in double on thread 0.  The
//   block FREEZES at the first survivor: later rows are neither proposed
//   nor counted.
//
// Design: one thread block of NT threads for the one chain (B1's design
//   before B1 became a cluster per chain, mc_cluster.cuh), the
//   planes in device memory (L2-resident: pos, alive, eps, sig, q, polar,
//   e0 ~0.4 MB at N = 10.8k), the step's rows and tables in shared memory.
//   The per-thread sums (the 2 pair sums, z_others, the reciprocal delta,
//   en[a] and eo[a]: up to 52 doubles) reduce by warp shuffles and then one
//   thread per value over the warps in a fixed order, so a launch gives the
//   same bits every run.  Thread 0 decides and sets a shared freeze flag;
//   one barrier later every thread leaves the step loop.
//
// Bound: operations.  A step evaluates (has_old + has_new) x A x (alive
//   columns) pairs - up to 2 x 3 x 10,797 at the 10.8k polar system - and,
//   for the pairs within rc, the pair energy and a damped field coefficient
//   with an exponential (and, screened, an erfc); one block uses one SM,
//   1/132 of the card.  The design buys a launch that replaces a step's
//   host dispatch, not a fast step.
//
// Record [8,16] float64 in the reference's field order:
//   row 0: n_done, hit, mtype (0/1/2 disp/ins/del), slot_idx (slot table
//          order), species, u2 (lane 12 of the survivor's row), att_disp,
//          att_ins, att_del, d_surr, lnb, att_spin (0: not in this kernel);
//   row 1: d_rd, d_es_real, d_es_recip, d_es_self, d_es_excl, d_lrc;
//   rows 2-4: the survivor's trial rows x / y / z in lanes 0..na-1.
//   Zero where no step survived.  Energy deltas enter by selection, never
//   by a 0/1 factor (a deep-core insert's pair energy is inf).
//
// Scalar header scal[28]: rc, alpha, move_factor, rot_factor, thr2, p_ins,
//   beta, polar_damp, field alpha, field k_rc, box (3x3 row-major, rows are
//   cell vectors), box^-1 (3x3 row-major).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mc_common.cuh"
#include "thole_common.cuh"

namespace {

constexpr int S_MAX = 8;              // most insert species
constexpr int EN = 4;                 // v[EN + 3a + c]: en[a][c]
constexpr int EO = EN + 3 * A_PAD;    // v[EO + 3a + c]: eo[a][c]
constexpr int NV = EO + 3 * A_PAD;    // per-thread sums
constexpr double SQRT_PI = 1.7724538509055160273;

struct Dims {
  int n, ms, S, A, K, nk;
};

struct PolarOpts {
  int damp;    // 0 none, 1 exponential, 2 linear
  int field;   // 0 direct, 1 wolf, 2 ewald (its real-space part)
};

// Field coefficient c(r) of a pair within rc at the guarded r^2 (r2s): the
// field of a unit charge is c(r) dr (thole._field_coef).
template <typename T>
__device__ __forceinline__ T field_coef(T r2s, T lam, T paf, T pkrc,
                                        const PolarOpts po) {
  const T r = x_sqrt(r2s);
  T d1, d2;
  damping<T>(r, lam, po.damp, d1, d2);
  const T r3 = r2s * r;
  if (po.field == 0) return d1 / r3;
  const T two_a_pi = T(2) * paf / T(SQRT_PI);
  const T k_r = (x_erfc(paf * r) / r + two_a_pi * x_exp(-paf * paf * r2s))
                / r;
  return (k_r - pkrc) / r + (d1 - T(1)) / r3;
}

__device__ __forceinline__ bool used(int i, int na, bool ewf) {
  return i < EN + 3 * na || (ewf && i >= EO && i < EO + 3 * na);
}

// Block sums of each thread's v (the entries in use), by warp shuffles and
// then one thread per value over the warps in order, into s_tot; the block
// minimum of mn into *s_mr2.  Ends with a barrier.
template <typename T, bool EWF>
__device__ __forceinline__ void reduce_values(double (&v)[NV], T mn, int na,
                                              double (*s_red)[NW],
                                              double* s_tot, T* s_min,
                                              T* s_mr2) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (!used(i, na, EWF)) continue;    // uniform over the block
    double x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
    if (lane == 0) s_red[i][warp] = x;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mn = x_min(mn, __shfl_down_sync(FULL, mn, off));
  if (lane == 0) s_min[warp] = mn;
  __syncthreads();
  if (t < NV && used(t, na, EWF)) {
    double s = 0.0;
    for (int w = 0; w < NW; ++w) s += s_red[t][w];
    s_tot[t] = s;
  }
  if (t == NT - 1) {
    T m = T(INFINITY);
    for (int w = 0; w < NW; ++w) m = x_min(m, s_min[w]);
    *s_mr2 = m;
  }
  __syncthreads();
}

template <typename T, bool EWF>
__global__ void __launch_bounds__(NT) pda_kernel(
    const T* __restrict__ pos, const bool* __restrict__ alive,
    const T* __restrict__ eps, const T* __restrict__ sig,
    const T* __restrict__ q, const T* __restrict__ mass,
    const T* __restrict__ polar, const T* __restrict__ e0,
    const int32_t* __restrict__ slot_start,
    const int32_t* __restrict__ slot_species,
    const bool* __restrict__ slot_alive, const T* __restrict__ tmpl,
    const int32_t* __restrict__ natoms, const T* __restrict__ scal,
    const T* __restrict__ lnfv, const T* __restrict__ d_self,
    const T* __restrict__ d_excl, const T* __restrict__ c1,
    const T* __restrict__ cx, const T* __restrict__ u,
    const T* __restrict__ kvec, const T* __restrict__ kcoef,
    const T* __restrict__ sk, T* dsk, double* __restrict__ rec,
    const Dims d, const Opts o, const PolarOpts po, const double ke) {
  __shared__ T s_box[9], s_bi[9];
  __shared__ T s_tmpl[S_MAX * A_PAD * 3];
  __shared__ double s_dself[S_MAX], s_dexcl[S_MAX], s_c1[S_MAX],
      s_lnfv[S_MAX], s_cx[S_MAX * S_MAX];
  __shared__ int s_na[S_MAX], s_nvalid[S_MAX], s_nalive[S_MAX];
  __shared__ T s_u[16];
  __shared__ T s_old[A_PAD][3], s_new[A_PAD][3], s_e0[A_PAD][3];
  __shared__ T s_qi[A_PAD], s_ei[A_PAD], s_si[A_PAD], s_mi[A_PAD],
      s_pi[A_PAD];
  __shared__ int s_scan[NW];
  __shared__ int s_slot, s_live;
  __shared__ double s_red[NV][NW];
  __shared__ double s_tot[NV];
  __shared__ T s_min[NW];
  __shared__ T s_mr2;

  const int t = threadIdx.x;
  const int n = d.n, ms = d.ms, S = d.S, A = d.A, nk = d.nk;
  const T* SKr = sk;
  const T* SKi = sk + nk;
  T* DSr = dsk;
  T* DSi = dsk + nk;

  // ---- per-launch tables: box, species constants, slot counts
  if (t < 9) {
    s_box[t] = scal[10 + t];
    s_bi[t] = scal[19 + t];
  }
  if (t < S) {
    s_na[t] = natoms[t];
    s_dself[t] = double(d_self[t]);
    s_dexcl[t] = double(d_excl[t]);
    s_c1[t] = double(c1[t]);
    s_lnfv[t] = double(lnfv[t]);
    s_nvalid[t] = 0;
    s_nalive[t] = 0;
  }
  if (t < S * S) s_cx[t] = double(cx[t]);
  for (int i = t; i < S * A * 3; i += NT) s_tmpl[i] = tmpl[i];
  if (t == 0) s_live = 1;
  __syncthreads();
  for (int i = t; i < ms; i += NT) {
    const int sp = slot_species[i];
    atomicAdd(&s_nvalid[sp], 1);   // integer counts: exact in any order
    if (slot_alive[i]) atomicAdd(&s_nalive[sp], 1);
  }

  const T rc = scal[0], alpha = scal[1], mf = scal[2], rotf = scal[3];
  const T thr2 = scal[4], p_ins = scal[5];
  const double beta = double(scal[6]);
  const T lam = scal[7], paf = scal[8], pkrc = scal[9];
  const T p_half = T(0.5) * p_ins;
  const T rc2 = rc * rc;
  double n_done = 0.0, att[3] = {0.0, 0.0, 0.0};   // thread 0's counts

  for (int k = 0; k < d.K; ++k) {
    if (t < 16) s_u[t] = u[size_t(k) * 16 + t];
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
    if (t == 0) {
      n_done += 1.0;
      att[0] += disp ? 1.0 : 0.0;
      att[1] += ins ? 1.0 : 0.0;
      att[2] += del ? 1.0 : 0.0;
    }
    if (cnt == 0) {          // nothing to move: a stage-1 rejection
      __syncthreads();
      continue;
    }
    const T cntT = T(cnt);
    const int j = int(x_min(x_floor(s_u[0] * cntT), cntT - T(1)));
    const int slot = pick_slot(slot_alive, slot_species, ms, ins, del, su, j,
                               s_scan, &s_slot);
    const int start = slot_start[slot];
    const int spf = disp ? slot_species[slot] : su;
    const int na = s_na[spf];

    // ---- the molecule's current rows and sites, then its trial rows
    if (t < na) {
      const int r = start + t;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        s_old[t][e] = pos[3 * r + e];
        s_e0[t][e] = e0[3 * r + e];
      }
      s_qi[t] = q[r];
      s_ei[t] = eps[r];
      s_si[t] = sig[r];
      s_mi[t] = mass[r];
      s_pi[t] = polar[r];
    }
    __syncthreads();
    if (t == 0) {
      if (ins)
        insert_trial<T>(s_u, s_box, s_tmpl + spf * A * 3, A, na, s_new);
      else
        displace_trial<T>(s_u, mf, rotf, A, na, s_old, s_mi, s_new);
    }
    __syncthreads();

    // ---- one old+new pass over the columns: pair terms + field deltas
    const bool has_old = !ins, has_new = !del;
    double v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = 0.0;
    T mn = T(INFINITY);
    for (int jc = t; jc < n; jc += NT) {
      if (!alive[jc] || (jc >= start && jc < start + na)) continue;
      const T xj = pos[3 * jc], yj = pos[3 * jc + 1], zj = pos[3 * jc + 2];
      const T qj = q[jc], ej = eps[jc], sj = sig[jc];
      T dEx = T(0), dEy = T(0), dEz = T(0);
#pragma unroll
      for (int a = 0; a < A_PAD; ++a) {
        if (a >= na) break;
        T rx, ry, rz, r2, rd, es;
        if (has_old) {
          min_image<T>(s_old[a][0] - xj, s_old[a][1] - yj, s_old[a][2] - zj,
                       s_box, s_bi, o.ortho, rx, ry, rz);
          r2 = rx * rx + ry * ry + rz * rz;
          pair_energy<T>(r2, s_ei[a], s_si[a], s_qi[a], ej, sj, qj, o, rc,
                         rc2, alpha, rd, es);
          v[0] -= double(rd);
          v[1] -= double(es);
          if (r2 < rc2) {
            const T c = field_coef<T>(r2 > T(1e-12) ? r2 : T(1), lam, paf,
                                      pkrc, po);
            const T cq = s_qi[a] * c;
            dEx += cq * rx;
            dEy += cq * ry;
            dEz += cq * rz;
            if (EWF) {
              const T cj = qj * c;
              v[EO + 3 * a] += double(cj * rx);
              v[EO + 3 * a + 1] += double(cj * ry);
              v[EO + 3 * a + 2] += double(cj * rz);
            }
          }
        }
        if (has_new) {
          min_image<T>(s_new[a][0] - xj, s_new[a][1] - yj, s_new[a][2] - zj,
                       s_box, s_bi, o.ortho, rx, ry, rz);
          r2 = rx * rx + ry * ry + rz * rz;
          pair_energy<T>(r2, s_ei[a], s_si[a], s_qi[a], ej, sj, qj, o, rc,
                         rc2, alpha, rd, es);
          v[0] += double(rd);
          v[1] += double(es);
          mn = x_min(mn, r2);
          if (r2 < rc2) {
            const T c = field_coef<T>(r2 > T(1e-12) ? r2 : T(1), lam, paf,
                                      pkrc, po);
            const T cq = s_qi[a] * c;
            dEx -= cq * rx;
            dEy -= cq * ry;
            dEz -= cq * rz;
            const T cj = qj * c;
            v[EN + 3 * a] += double(cj * rx);
            v[EN + 3 * a + 1] += double(cj * ry);
            v[EN + 3 * a + 2] += double(cj * rz);
          }
        }
      }
      // the column's surrogate term (alpha 0 on non-polarizable sites)
      const T e0x = e0[3 * jc], e0y = e0[3 * jc + 1], e0z = e0[3 * jc + 2];
      v[2] += double(polar[jc] * (T(2) * (e0x * dEx + e0y * dEy + e0z * dEz)
                                  + dEx * dEx + dEy * dEy + dEz * dEz));
    }
    if (o.es == 1) {     // dsk is scratch: the state's S(k) is not changed
      double a_rec = 0.0;
      sk_delta<T>(kvec, kcoef, SKr, SKi, DSr, DSi, nk, na, has_old, has_new,
                  s_old, s_new, s_qi, a_rec);
      v[3] = a_rec;
    }
    reduce_values<T, EWF>(v, mn, na, s_red, s_tot, s_min, &s_mr2);

    // ---- surrogate, constants and the stage-1 test (thread 0, double)
    if (t == 0) {
      const double drd = s_tot[0], des = ke * s_tot[1];
      const double drec = o.es == 1 ? s_tot[3] : 0.0;
      double z_new = 0.0, z_old = 0.0;
      for (int a = 0; a < na; ++a) {
        double f[3], f0[3];
        for (int e = 0; e < 3; ++e) {
          f0[e] = double(s_e0[a][e]);
          f[e] = s_tot[EN + 3 * a + e];
          if (EWF && has_old) f[e] = f0[e] + f[e] - s_tot[EO + 3 * a + e];
        }
        const double al = double(s_pi[a]);
        z_new += al * (f[0] * f[0] + f[1] * f[1] + f[2] * f[2]);
        z_old += al * (f0[0] * f0[0] + f0[1] * f0[1] + f0[2] * f0[2]);
      }
      const double d_surr = -0.5 * ke * (s_tot[2] + (has_new ? z_new : 0.0)
                                         - (has_old ? z_old : 0.0));
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
      const bool reject = thr2 > T(0) && has_new && s_mr2 < thr2;
      const bool hit = !reject && log(fmax(double(s_u[4]), 1e-38))
                                      < lnb - beta * (du + d_surr);
      if (hit) {
        rec[1] = 1.0;
        rec[2] = double(mt);
        rec[3] = double(slot);
        rec[4] = double(spf);
        rec[5] = double(s_u[12]);
        rec[9] = d_surr;
        rec[10] = lnb;
        rec[16] = drd;
        rec[17] = des;
        rec[18] = drec;
        rec[19] = dslf;
        rec[20] = dexc;
        rec[21] = dlrc;
        for (int a = 0; a < na; ++a)
          for (int e = 0; e < 3; ++e) rec[(2 + e) * 16 + a] = s_new[a][e];
        s_live = 0;
      }
    }
    __syncthreads();
    if (!s_live) break;      // the freeze: no later row is read
  }
  if (t == 0) {
    rec[0] = n_done;
    rec[6] = att[0];
    rec[7] = att[1];
    rec[8] = att[2];
  }
}

}  // namespace

#define RUN_STEPS_UVT_PDA_ENTRY(SFX, T)                                       \
  extern "C" int run_steps_uvt_pda_##SFX(                                    \
      const void* pos, const void* alive, const void* eps, const void* sig,   \
      const void* q, const void* mass, const void* polar, const void* e0,     \
      const void* slot_start, const void* slot_species,                       \
      const void* slot_alive, const void* tmpl, const void* natoms,           \
      const void* scal, const void* lnfv, const void* d_self,                 \
      const void* d_excl, const void* c1, const void* cx, const void* u,      \
      const void* kvec, const void* kcoef, const void* sk, void* dsk,         \
      void* rec, int n, int ms, int S, int A, int K, int nk, int rd,          \
      int mix, int es, int ortho, int damp, int field, double ke,            \
      void* stream) {                                                         \
    const Dims d{n, ms, S, A, K, nk};                                         \
    const Opts o{rd, mix, es, ortho};                                         \
    const PolarOpts po{damp, field};                                          \
    if (field == 2) {                                                         \
      pda_kernel<T, true><<<1, NT, 0, (cudaStream_t)stream>>>(                \
          (const T*)pos, (const bool*)alive, (const T*)eps, (const T*)sig,    \
          (const T*)q, (const T*)mass, (const T*)polar, (const T*)e0,         \
          (const int32_t*)slot_start, (const int32_t*)slot_species,           \
          (const bool*)slot_alive, (const T*)tmpl, (const int32_t*)natoms,    \
          (const T*)scal, (const T*)lnfv, (const T*)d_self,                   \
          (const T*)d_excl, (const T*)c1, (const T*)cx, (const T*)u,          \
          (const T*)kvec, (const T*)kcoef, (const T*)sk, (T*)dsk,             \
          (double*)rec, d, o, po, ke);                                        \
    } else {                                                                  \
      pda_kernel<T, false><<<1, NT, 0, (cudaStream_t)stream>>>(               \
          (const T*)pos, (const bool*)alive, (const T*)eps, (const T*)sig,    \
          (const T*)q, (const T*)mass, (const T*)polar, (const T*)e0,         \
          (const int32_t*)slot_start, (const int32_t*)slot_species,           \
          (const bool*)slot_alive, (const T*)tmpl, (const int32_t*)natoms,    \
          (const T*)scal, (const T*)lnfv, (const T*)d_self,                   \
          (const T*)d_excl, (const T*)c1, (const T*)cx, (const T*)u,          \
          (const T*)kvec, (const T*)kcoef, (const T*)sk, (T*)dsk,             \
          (double*)rec, d, o, po, ke);                                        \
    }                                                                         \
    return int(cudaGetLastError());                                           \
  }

RUN_STEPS_UVT_PDA_ENTRY(f32, float)
RUN_STEPS_UVT_PDA_ENTRY(f64, double)
