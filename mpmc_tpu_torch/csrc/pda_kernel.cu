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
//   ln(max(u4, 1e-38)) < lnb - beta (du + d*) in double.  The kernel
//   FREEZES at the first survivor: later rows are neither proposed nor
//   counted.
//
// Design: one thread-block cluster of G CTAs for the one chain
//   (mc_cluster.cuh, B1's layer).  Rank r holds the columns [r nloc, (r +
//   1) nloc) - x, y, z, q, eps, sig, alive, polar and e0 x/y/z - and the
//   k-vectors [r kloc, (r + 1) kloc) - kvec, kcoef, S(k) and the step's dS
//   scratch - in its shared memory for the whole launch, with a replica of
//   the slot table; nothing is written back.  Every CTA derives the same
//   move, slot and trial rows from the same uniforms and tables; the
//   molecule's current rows, e0 rows and site constants come from device
//   memory, which nobody writes during the launch.  Each CTA runs the pass
//   over its slice (the LJ mixing once per (site, column) for both rows,
//   the field coefficient from the pair term's r) and the S(k) delta over
//   its k-vectors, reduces over its block, and pushes its partial vector
//   (d_rd, d_es, z_others, d_rec, en[3 na], eo[3 na] under polar_ewald,
//   min r^2) into slot [rank] of every CTA's exchange buffer; after ONE
//   cluster barrier every CTA adds the G partials in rank order, in
//   double, and makes the same stage-1 decision, so every CTA freezes at
//   the same step with no second barrier.  The exchange buffer alternates
//   between two halves per exchange (a step with nothing to move makes
//   none).  A final cluster barrier keeps every CTA resident until no
//   other may write into its buffer.  The per-thread sums are sized by a
//   template on the padded site count AP (4 covers H2's 3 sites, 8 the
//   rest), not by A_PAD.
//
// Bound: operations.  A step evaluates (has_old + has_new) x A x (alive
//   columns) pairs - up to 2 x 3 x 10,797 at the 10.8k polar system - and,
//   for the pairs within rc, the pair energy and a damped field coefficient
//   with an exponential (and, screened, an erfc).  A cluster brings G SMs
//   to the one chain, each pass over 1/G of the columns from shared
//   memory; the step pays the slot pick, the trial rows, one barrier and
//   the decision once.
//
// Reductions: each thread sums its terms in double; warps reduce by
//   shuffles, one thread per value adds the warps in a fixed order, and
//   every CTA adds the G ranks' vectors in rank order, so a launch gives
//   the same bits every run for a given G.
//
// Record [8,16] float64 in the reference's field order (rank 0 writes it):
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

#include <algorithm>
#include <mutex>
#include <vector>

#include "mc_cluster.cuh"
#include "thole_common.cuh"

namespace {

constexpr int S_MAX = 8;              // most insert species
constexpr double SQRT_PI = 1.7724538509055160273;

// The per-thread sums v[NV] of a launch of at most AP sites per molecule:
// v[0] d_rd, v[1] d_es, v[2] z_others, v[3] d_rec, v[EN + 3a + c] en[a][c],
// v[EO + 3a + c] eo[a][c]; the exchange rows hold NX = NV + 1 doubles.
template <int AP>
struct Lay {
  static constexpr int EN = 4;
  static constexpr int EO = EN + 3 * AP;
  static constexpr int NV = EO + 3 * AP;
  static constexpr int NX = NV + 1;
};

struct Dims {
  int n, ms, S, A, K, nk, G, nloc, kloc;
};

struct PolarOpts {
  int damp;    // 0 none, 1 exponential, 2 linear
  int field;   // 0 direct, 1 wolf, 2 ewald (its real-space part)
};

// Field coefficient c(r) of a pair at the guarded r^2 (r2s) and r =
// sqrt(r2s): the field of a unit charge is c(r) dr (thole._field_coef).
template <typename T>
__device__ __forceinline__ T field_coef(T r, T r2s, T lam, T paf, T pkrc,
                                        const PolarOpts po) {
  T d1, d2;
  damping<T>(r, lam, po.damp, d1, d2);
  const T r3 = r2s * r;
  if (po.field == 0) return d1 / r3;
  const T two_a_pi = T(2) * paf / T(SQRT_PI);
  const T k_r = (x_erfc(paf * r) / r + two_a_pi * x_exp(-paf * paf * r2s))
                / r;
  return (k_r - pkrc) / r + (d1 - T(1)) / r3;
}

// The partial vector's length: d_rd, d_es, z_others, d_rec, en[3 na],
// eo[3 na] (EWF), min r^2 (ops/cuda/mc_kernel.py::pda_partial_len).
template <bool EWF>
__device__ __forceinline__ int partial_len(int na) {
  return 4 + 3 * na * (EWF ? 2 : 1) + 1;
}

// Block sums of each thread's v (the entries in use), by warp shuffles and
// then one thread per value over the warps in order, into this CTA's
// compact partial vector s_part (partial_len entries; the last is the
// block minimum of mn).  Ends with a barrier.
template <typename T, bool EWF, int AP>
__device__ __forceinline__ void reduce_values(
    double (&v)[Lay<AP>::NV], T mn, int na, double (*s_red)[NW],
    T* s_min, double* s_part) {
  constexpr int EN = Lay<AP>::EN, EO = Lay<AP>::EO, NV = Lay<AP>::NV;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nen = 3 * na;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    // uniform over the block: the entries in use
    if (!(i < EN + nen || (EWF && i >= EO && i < EO + nen))) continue;
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
  const int np = partial_len<EWF>(na);
  if (t < np - 1) {
    const int i = t < EN + nen ? t : EO + (t - EN - nen);
    double s = 0.0;
    for (int w = 0; w < NW; ++w) s += s_red[i][w];
    s_part[t] = s;
  } else if (t == np - 1) {
    T m = T(INFINITY);
    for (int w = 0; w < NW; ++w) m = x_min(m, s_min[w]);
    s_part[t] = double(m);   // exact for float and double
  }
  __syncthreads();
}

template <typename T, bool EWF, int AP>
__global__ void __launch_bounds__(NT, 1) pda_kernel(
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
    const T* __restrict__ sk, double* __restrict__ rec, const Dims d,
    const Opts o, const PolarOpts po, const double ke) {
  constexpr int EN = Lay<AP>::EN, EO = Lay<AP>::EO, NV = Lay<AP>::NV;
  constexpr int NX = Lay<AP>::NX;
  __shared__ T s_box[9], s_bi[9];
  __shared__ T s_tmpl[S_MAX * AP * 3];
  __shared__ double s_dself[S_MAX], s_dexcl[S_MAX], s_c1[S_MAX],
      s_lnfv[S_MAX], s_cx[S_MAX * S_MAX];
  __shared__ int s_na[S_MAX], s_nvalid[S_MAX], s_nalive[S_MAX];
  __shared__ T s_u[16];
  __shared__ T s_old[AP][3], s_new[AP][3], s_e0[AP][3];
  __shared__ T s_qi[AP], s_ei[AP], s_si[AP], s_mi[AP], s_pi[AP];
  __shared__ int s_scan[NW];
  __shared__ int s_slot, s_live;
  __shared__ double s_red[NV][NW];
  __shared__ T s_min[NW];
  __shared__ double s_part[NX], s_tot[NX];
  __shared__ double s_xch[2][G_MAX][NX];

  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int G = d.G;
  const int rank = int(cluster.block_rank());
  const int n = d.n, ms = d.ms, S = d.S, A = d.A, nk = d.nk;
  const int nloc = d.nloc, kloc = d.kloc;
  const int base = rank * nloc, kbase = rank * kloc;
  const int cnt_j = max(0, min(nloc, n - base));
  const int cnt_k = max(0, min(kloc, nk - kbase));
  const Slice<T> sl = carve_slice<T>(nloc, kloc, ms);
  const PolarPlanes<T> pl = carve_polar<T>(nloc, kloc, ms);

  // ---- per-launch tables: this CTA's slice and polar planes, the slot
  // table, box and species constants, slot counts
  load_slice<T>(sl, pos, alive, q, eps, sig, base, cnt_j, kvec, kcoef, sk,
                sk + nk, kbase, cnt_k);
  load_polar<T>(pl, polar, e0, base, cnt_j);
  for (int i = t; i < ms; i += NT) {
    sl.sa[i] = slot_alive[i];
    sl.ssp[i] = slot_species[i];
  }
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
    const int sp = sl.ssp[i];
    atomicAdd(&s_nvalid[sp], 1);   // integer counts: exact in any order
    if (sl.sa[i]) atomicAdd(&s_nalive[sp], 1);
  }
  // every CTA has started before any writes into another's buffer
  cluster_arrive();
  cluster_wait();

  const T rc = scal[0], alpha = scal[1], mf = scal[2], rotf = scal[3];
  const T thr2 = scal[4], p_ins = scal[5];
  const double beta = double(scal[6]);
  const T lam = scal[7], paf = scal[8], pkrc = scal[9];
  const T p_half = T(0.5) * p_ins;
  const T rc2 = rc * rc;
  double n_done = 0.0, att[3] = {0.0, 0.0, 0.0};   // thread 0's counts
  int half = 0;                                      // exchange half

  for (int k = 0; k < d.K; ++k) {
    if (t < 16) s_u[t] = u[size_t(k) * 16 + t];
    __syncthreads();
    // ---- move type, species, eligible count (uniform over the cluster)
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
    const int slot = pick_slot(sl.sa, sl.ssp, ms, ins, del, su, j, s_scan,
                               &s_slot);
    const int start = slot_start[slot];
    const int spf = disp ? sl.ssp[slot] : su;
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

    // ---- one old+new pass over this CTA's columns: pair terms + field
    // deltas; every pair evaluated, the terms beyond rc selected away
    const bool has_old = !ins, has_new = !del;
    double v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = 0.0;
    T mn = T(INFINITY);
    for (int jl = t; jl < cnt_j; jl += NT) {
      const int jc = base + jl;
      if (!sl.al[jl] || (jc >= start && jc < start + na)) continue;
      const T xj = sl.x[jl], yj = sl.y[jl], zj = sl.z[jl];
      const T qj = sl.q[jl], ej = sl.e[jl], sj = sl.s[jl];
      T dEx = T(0), dEy = T(0), dEz = T(0);
#pragma unroll
      for (int a = 0; a < AP; ++a) {
        if (a >= na) break;
        T eps_m, sig2_m;
        mix_pair<T>(s_ei[a], s_si[a], ej, sj, o, eps_m, sig2_m);
        const T qq = s_qi[a] * qj;
        if (has_old) {
          T rx, ry, rz;
          min_image<T>(s_old[a][0] - xj, s_old[a][1] - yj, s_old[a][2] - zj,
                       s_box, s_bi, o.ortho, rx, ry, rz);
          const T r2 = rx * rx + ry * ry + rz * rz;
          const bool in = r2 < rc2;
          const T r2s = r2 > T(1e-12) ? r2 : T(1);
          const T r = x_sqrt(r2s);
          T rd, es;      // zero beyond rc
          pair_energy_mixed<T>(r2, eps_m, sig2_m, qq, o, rc, rc2, alpha, rd,
                               es);
          const T cf = field_coef<T>(r, r2s, lam, paf, pkrc, po);
          const T c = in ? cf : T(0);
          v[0] -= double(rd);
          v[1] -= double(es);
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
        if (has_new) {
          T rx, ry, rz;
          min_image<T>(s_new[a][0] - xj, s_new[a][1] - yj, s_new[a][2] - zj,
                       s_box, s_bi, o.ortho, rx, ry, rz);
          const T r2 = rx * rx + ry * ry + rz * rz;
          const bool in = r2 < rc2;
          const T r2s = r2 > T(1e-12) ? r2 : T(1);
          const T r = x_sqrt(r2s);
          T rd, es;      // zero beyond rc
          pair_energy_mixed<T>(r2, eps_m, sig2_m, qq, o, rc, rc2, alpha, rd,
                               es);
          const T cf = field_coef<T>(r, r2s, lam, paf, pkrc, po);
          const T c = in ? cf : T(0);
          v[0] += double(rd);
          v[1] += double(es);
          mn = x_min(mn, r2);
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
      // the column's surrogate term (alpha 0 on non-polarizable sites)
      const T e0x = pl.ex[jl], e0y = pl.ey[jl], e0z = pl.ez[jl];
      v[2] += double(pl.p[jl] * (T(2) * (e0x * dEx + e0y * dEy + e0z * dEz)
                                 + dEx * dEx + dEy * dEy + dEz * dEz));
    }
    if (o.es == 1) {     // dS is scratch: the state's S(k) is not changed
      double a_rec = 0.0;
      sk_delta<T>(sl.kv, sl.kc, sl.skr, sl.ski, sl.dsr, sl.dsi, cnt_k, na,
                  has_old, has_new, s_old, s_new, s_qi, a_rec);
      v[3] = a_rec;
    }
    reduce_values<T, EWF, AP>(v, mn, na, s_red, s_min, s_part);

    // ---- the G partial vectors, added in rank order by every CTA
    const int np = partial_len<EWF>(na);
    exchange_vector(cluster, s_part, np, &s_xch[half][0][0], NX, rank, G);
    if (t < np - 1) {
      double s = 0.0;
      for (int r = 0; r < G; ++r) s += s_xch[half][r][t];
      s_tot[t] = s;
    } else if (t == np - 1) {
      T m = T(INFINITY);
      for (int r = 0; r < G; ++r) m = x_min(m, T(s_xch[half][r][t]));
      s_tot[t] = double(m);
    }
    half ^= 1;
    __syncthreads();

    // ---- surrogate, constants and the stage-1 test (thread 0 of every
    // CTA, double, the same decision)
    if (t == 0) {
      const int nen = 3 * na;
      const double drd = s_tot[0], des = ke * s_tot[1];
      const double drec = o.es == 1 ? s_tot[3] : 0.0;
      const T mr2 = T(s_tot[np - 1]);
      double z_new = 0.0, z_old = 0.0;
      for (int a = 0; a < na; ++a) {
        double f[3], f0[3];
        for (int e = 0; e < 3; ++e) {
          f0[e] = double(s_e0[a][e]);
          f[e] = s_tot[EN + 3 * a + e];
          if (EWF && has_old)
            f[e] = f0[e] + f[e] - s_tot[EN + nen + 3 * a + e];
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
      const bool reject = thr2 > T(0) && has_new && mr2 < thr2;
      const bool hit = !reject && log(fmax(double(s_u[4]), 1e-38))
                                      < lnb - beta * (du + d_surr);
      if (hit) {
        if (rank == 0) {
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
        }
        s_live = 0;
      }
    }
    __syncthreads();
    if (!s_live) break;      // the freeze: no later row is read
  }
  if (t == 0 && rank == 0) {
    rec[0] = n_done;
    rec[6] = att[0];
    rec[7] = att[1];
    rec[8] = att[2];
  }
  // no CTA leaves while another may still write into its buffer
  cluster_arrive();
  cluster_wait();
}

// Per-CTA slice sizes of a G-CTA cluster.
inline Dims pda_dims(int n, int ms, int S, int A, int K, int nk, int G) {
  return Dims{n, ms, S, A, K, nk, G, (n + G - 1) / G, (nk + G - 1) / G};
}

// The kernel instance of a launch: polar_ewald's eo sums or not, and the
// site count padded to 4 or 8.
template <typename T>
using PdaKern = void (*)(const T*, const bool*, const T*, const T*,
                         const T*, const T*, const T*, const T*,
                         const int32_t*, const int32_t*, const bool*,
                         const T*, const int32_t*, const T*, const T*,
                         const T*, const T*, const T*, const T*, const T*,
                         const T*, const T*, const T*, double*, const Dims,
                         const Opts, const PolarOpts, const double);

template <typename T>
PdaKern<T> pda_instance(int A, int field) {
  if (field == 2)
    return A <= 4 ? pda_kernel<T, true, 4> : pda_kernel<T, true, 8>;
  return A <= 4 ? pda_kernel<T, false, 4> : pda_kernel<T, false, 8>;
}

// cudaFuncSetAttribute costs host time on every call: each (device,
// instance) gets its attributes once, and again only for a larger slice
// or G > 8 where it had G <= 8 - never lowered, so every shape queried or
// launched before still fits.
template <typename T>
cudaError_t pda_attributes(PdaKern<T> kern, int G, size_t smem) {
  struct Set {
    int dev;
    PdaKern<T> kern;
    size_t smem;
    bool wide;
  };
  static std::mutex lock;
  static std::vector<Set> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(lock);
  for (Set& s : done) {
    if (s.dev != dev || s.kern != kern) continue;
    if (s.smem >= smem && (s.wide || G <= 8)) return cudaSuccess;
    e = cluster_attributes(kern, G, std::max(smem, s.smem));
    if (e == cudaSuccess) {
      s.smem = std::max(smem, s.smem);
      s.wide = s.wide || G > 8;
    }
    return e;
  }
  e = cluster_attributes(kern, G, smem);
  if (e == cudaSuccess) done.push_back(Set{dev, kern, smem, G > 8});
  return e;
}

// How many clusters of this shape the card holds at once (0: it cannot
// launch).  The attributes go through pda_attributes, which only raises
// them, so a query never lowers what an earlier launch needs.
template <typename T>
int pda_occupancy(const Dims d, int field, int* clusters) {
  const size_t smem = polar_slice_bytes<T>(d.nloc, d.kloc, d.ms);
  const PdaKern<T> kern = pda_instance<T>(d.A, field);
  cudaError_t e = pda_attributes<T>(kern, d.G, smem);
  if (e != cudaSuccess) return int(e);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch(1, d.G, smem, 0, attr, &cfg);
  return int(cudaOccupancyMaxActiveClusters(clusters, kern, &cfg));
}

template <typename T>
int launch_pda(const T* pos, const bool* alive, const T* eps, const T* sig,
               const T* q, const T* mass, const T* polar, const T* e0,
               const int32_t* slot_start, const int32_t* slot_species,
               const bool* slot_alive, const T* tmpl, const int32_t* natoms,
               const T* scal, const T* lnfv, const T* d_self,
               const T* d_excl, const T* c1, const T* cx, const T* u,
               const T* kvec, const T* kcoef, const T* sk, double* rec,
               const Dims d, const Opts o, const PolarOpts po, double ke,
               cudaStream_t stream) {
  if (d.G < 1 || d.G > G_MAX || d.A > A_PAD) return int(cudaErrorInvalidValue);
  const size_t smem = polar_slice_bytes<T>(d.nloc, d.kloc, d.ms);
  const PdaKern<T> kern = pda_instance<T>(d.A, po.field);
  cudaError_t e = pda_attributes<T>(kern, d.G, smem);
  if (e != cudaSuccess) return int(e);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch(1, d.G, smem, stream, attr, &cfg);
  e = cudaLaunchKernelEx(&cfg, kern, pos, alive, eps, sig, q, mass, polar,
                         e0, slot_start, slot_species, slot_alive, tmpl,
                         natoms, scal, lnfv, d_self, d_excl, c1, cx, u, kvec,
                         kcoef, sk, rec, d, o, po, ke);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
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
      const void* kvec, const void* kcoef, const void* sk, void* rec, int n,  \
      int ms, int S, int A, int K, int nk, int G, int rd, int mix, int es,    \
      int ortho, int damp, int field, double ke, void* stream) {             \
    return launch_pda<T>(                                                     \
        (const T*)pos, (const bool*)alive, (const T*)eps, (const T*)sig,      \
        (const T*)q, (const T*)mass, (const T*)polar, (const T*)e0,           \
        (const int32_t*)slot_start, (const int32_t*)slot_species,             \
        (const bool*)slot_alive, (const T*)tmpl, (const int32_t*)natoms,      \
        (const T*)scal, (const T*)lnfv, (const T*)d_self, (const T*)d_excl,   \
        (const T*)c1, (const T*)cx, (const T*)u, (const T*)kvec,              \
        (const T*)kcoef, (const T*)sk, (double*)rec,                          \
        pda_dims(n, ms, S, A, K, nk, G), Opts{rd, mix, es, ortho},            \
        PolarOpts{damp, field}, ke, (cudaStream_t)stream);                    \
  }                                                                           \
  extern "C" int pda_occupancy_##SFX(int n, int nk, int ms, int A,           \
                                     int field, int G, int* clusters) {       \
    return pda_occupancy<T>(pda_dims(n, ms, 1, A, 1, nk, G), field,          \
                            clusters);                                        \
  }

RUN_STEPS_UVT_PDA_ENTRY(f32, float)
RUN_STEPS_UVT_PDA_ENTRY(f64, double)
