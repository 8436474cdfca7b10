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
//   columns (LJ with Lorentz-Berthelot or Waldman-Hagler mixing and
//   optionally its Feynman-Hibbs order 2/4 or Feynman-Kleinert correction
//   at the chain's beta with the molecule-pair reduced mass, the
//   real-space Ewald/Wolf/cutoff Coulomb term, the closest approach for
//   autoreject; the molecule's own columns masked), the S(k) delta over the
//   Nk k-vectors, the acceptance test with the per-species self, exclusion
//   and LRC constants, and the in-place commit of positions, atom alive
//   flags, the slot table's alive row and S(k).
//
// Design: one thread-block cluster of G CTAs (NT threads each) per chain,
//   grid C x G, the K steps a loop inside every CTA (the TPU kernel's
//   sequential fori_loop).  Each CTA keeps its slice of the chain's
//   columns (pos, alive, q, eps, sig, and under a quantum correction the
//   columns' molecular masses: n / G of each) and of its k-vectors
//   (kvec, kcoef, S(k), dS) in shared memory for the whole launch, and a
//   replica of the slot table; the step's partial sums meet through
//   distributed shared memory with one cluster barrier, and a second,
//   split barrier orders the commit before the next step's row reads
//   (mc_cluster.cuh).  The slices are loaded with plain coalesced loads
//   once per launch (pos arrives interleaved [N,3] and is split into
//   planes) and written back at the end.  The wrapper picks G
//   (mc_kernel.py::cluster_size): the largest G in {2, 4, 8, 16} whose
//   slice fits in shared memory and of which the card holds all C
//   clusters at once (cudaOccupancyMaxActiveClusters; a cluster lies
//   within one GPC), so on an H100 one chain runs on 16 SMs, 16 chains on
//   4 each and 32 chains on 2 each.  The kernel has two instances (QC):
//   the classical one, and one with the quantum terms and the slice's
//   molecule-mass plane, picked per launch from Opts.qc, so a classical
//   deck runs the code it ran before the corrections existed.  A second
//   flag (XT) adds the µVT extras (mc_common.cuh XtArgs): an insert's
//   COM in an open cell of the refresh's grid (lane 10 picks the cell by
//   rank), +-ln(n_open / g^3) in the acceptance, and the TMMC rows (thread
//   0 of rank 0 adds each insert or delete attempt's (1, a) to its chain's
//   block, so no atomics) with the eta tilt, and the spinflip move (lane
//   11 < p_spin before the move type: the displacement's slot pick, the
//   rotor's d_f in the acceptance, an accept flipping its spin; the step
//   makes no pass, exchange or barrier); uvt_kernel.cu builds the
//   instances without it and uvt_xt_kernel.cu those with it.  A third
//   parameter (F, rd_forms.cuh) gives the RD forms sg, dreiding, b14_7 and
//   disp_expansion and the GWP Coulomb form their own XT instances
//   (uvt_<form>_kernel.cu, entry run_steps_uvt_rd; GWP, whose rd is lj,
//   also with the quantum terms and the mass plane, FH and FK needing rd
//   lj): the
//   form's energy (the reference's _pair_terms RD branch,
//   mpmc_tpu/ops/pallas/mc_kernel.py:173-187) and the GWP smear (:201-210)
//   evaluated only where a warp vote finds a pair within rc
//   (mc_cluster.cuh slice_pass_form), the slice holding disp_expansion's
//   C6, C8, C10 and gwp's widths as column planes (the reference's rows,
//   :1154-1157, :1302-1304); the count-dependent tail is the host's c1 /
//   cx, as for LJ.  The classical instances compile the code they had.
//
// Bound: operations.  A step evaluates (has_old + has_new) x A x (alive
//   columns) pairs - up to 2 x 3 x 10,797 = 64.8k at the 10.8k bench
//   system - at 44 floating-point operations each, counting a square root,
//   a division, erfc and a rounding as one (displacement 3, orthorhombic
//   minimum image 12, r^2 5, cutoff test and guard 2, LJ 13, Coulomb 6,
//   sums 3), plus (has_old + has_new) x A x Nk phases of 13 and Nk
//   reciprocal-energy terms of 9: about 2.7 Mflop per step, 0.04 us at the
//   card's 67 TFLOP/s f32 peak.  A quantum correction adds, per pair within
//   rc, 20 operations (FH2), 41 (FH4) or 228 (FK: eight fixed-point
//   rounds of a square root, an exponential and two divisions), and 4-12
//   per column (chip_smoke.py's OPS_QC_PAIR, OPS_QC_COL).  A cluster of G CTAs brings G SMs to one
//   chain: each evaluates 1/G of the pairs from shared memory, and the
//   step pays the serial part (slot pick, trial rows, acceptance) and two
//   cluster barriers once.
//
// Reductions: each thread sums its pair terms in double; warps reduce by
//   shuffles, thread 0 adds the warps' partials in a fixed order, and
//   every CTA adds the G ranks' partials in rank order, so a launch gives
//   the same bits every run for a given G (a chain's result depends on G,
//   not on C).  The chunk accumulators (the 14 sums) are double too.  The
//   acceptance test runs in double on thread 0 of every CTA, which all
//   decide alike.  Energy deltas enter the accumulators by selection
//   (accept ? v : 0), never by multiplication: a rejected deep-core insert
//   has an infinite pair energy and 0 * inf would be NaN.  erfc is the
//   exact erfcf/erfc.
//
// Sums [C,14] in the reference order: d_rd, d_es_real, d_es_recip,
//   d_es_self, d_es_excl, d_lrc, acc_disp, acc_ins, acc_del, att_disp,
//   att_ins, att_del, acc_spin, att_spin (the last two 0 outside the XT
//   instances' spinflip).
//
// Scalar header scal[24]: rc, alpha, move_factor, rot_factor, thr2, p_ins,
//   box (3x3 row-major, rows are cell vectors), box^-1 (3x3 row-major);
//   the XT instances read p_spin at scal[24].
//
// The quantum correction, the S(k) delta, the block reduction, the slot
// pick and the trial rows are mc_common.cuh's (shared with B3 and B6), the
// cluster layer and the pair evaluation mc_cluster.cuh's (shared with B3
// and B6).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mc_cluster.cuh"

namespace {

constexpr int S_MAX = 8;         // most insert species
constexpr int N_SUMS = 14;

struct Dims {
  int C, n, ms, S, A, K, nk, G, nloc, kloc;
};

template <typename T, bool QC, bool XT, int F = RD_CLASSIC>
__global__ void __launch_bounds__(NT, 1) uvt_kernel(
    T* pos, bool* alive, const T* __restrict__ eps,
    const T* __restrict__ sig, const T* __restrict__ q,
    const T* __restrict__ mass, const T* __restrict__ mmass,
    const int32_t* __restrict__ slot_start,
    const int32_t* __restrict__ slot_species, bool* slot_alive,
    const T* __restrict__ tmpl, const int32_t* __restrict__ natoms,
    const T* __restrict__ scal, const T* __restrict__ betas,
    const T* __restrict__ lnfvs, const T* __restrict__ d_self,
    const T* __restrict__ d_excl, const T* __restrict__ c1,
    const T* __restrict__ cx, const T* __restrict__ u,
    const T* __restrict__ kvec, const T* __restrict__ kcoef, T* sk,
    double* __restrict__ sums, const Dims d, const Opts o,
    const XtArgs<T> x, const double ke, const double hb2,
    const FormCols<T> fcol) {
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
  __shared__ double s_part[N_PART];
  __shared__ double s_xch[2][G_MAX][N_PART];

  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int G = d.G;
  const int rank = int(cluster.block_rank());
  const int c = blockIdx.x / G;
  const int n = d.n, ms = d.ms, S = d.S, A = d.A, nk = d.nk;
  const int nloc = d.nloc, kloc = d.kloc;
  const int base = rank * nloc, kbase = rank * kloc;
  const int cnt_j = max(0, min(nloc, n - base));
  const int cnt_k = max(0, min(kloc, nk - kbase));
  // a form instance: its Coulomb form gwp (o.es 4) or not, and the moved
  // sites' form values (a classical instance reads neither, nor fcol)
  const bool gw = F != RD_CLASSIC && o.es == 4;
  FormRow<T>* const s_fi = form_rows<T, F>();
  const Slice<T> sl = carve_slice<T, F>(nloc, kloc, ms, QC, gw);
  T* P = pos + size_t(c) * n * 3;
  bool* AL = alive + size_t(c) * n;
  bool* SA = slot_alive + size_t(c) * ms;
  T* SKr = sk + size_t(c) * 2 * nk;
  T* SKi = SKr + nk;
  const T* U = u + size_t(c) * d.K * 16;

  // ---- per-launch tables: this CTA's slice, the slot table, box and
  // species constants, slot counts
  load_slice<T, F>(sl, P, AL, q, eps, sig, mmass, base, cnt_j, kvec, kcoef,
                   SKr, SKi, kbase, cnt_k, fcol);
  for (int i = t; i < ms; i += NT) {
    sl.sa[i] = SA[i];
    sl.ssp[i] = slot_species[i];
  }
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
    const int sp = sl.ssp[i];
    atomicAdd(&s_nvalid[sp], 1);   // integer counts: exact in any order
    if (sl.sa[i]) atomicAdd(&s_nalive[sp], 1);
  }
  // every slice is loaded before any CTA reads another's
  cluster_arrive();
  cluster_wait();

  const T rc = scal[0], alpha = scal[1], mf = scal[2], rotf = scal[3];
  const T thr2 = scal[4], p_ins = scal[5];
  const T p_half = T(0.5) * p_ins;
  const T rc2 = rc * rc;
  const double beta = double(betas[c]);
  const T beta_t = betas[c], temp = T(1) / beta_t;   // the quantum terms' beta
  // the chain's open cells (cavity bias) and its block of the TMMC matrix
  const int n_open = XT && x.cav ? x.cav_n[c] : 0;
  double* TM = XT && x.tm ? x.tmmc + size_t(c) * x.rows * 4 : nullptr;
  // spinflip: p_spin, the chain's table and this CTA's replica of its spins
  const bool sf = XT && x.sf;
  const T p_spin = sf ? scal[24] : T(0);
  const T* ROT = sf ? x.rot + size_t(c) * ms * 2 : nullptr;
  int32_t* SPN = sf ? x.spin + (size_t(c) * G + rank) * ms : nullptr;
  double acc[N_SUMS];
#pragma unroll
  for (int i = 0; i < N_SUMS; ++i) acc[i] = 0.0;
  bool pending = false;   // barrier B arrived at, not yet waited for

  MC_CLOCK_DECL
  for (int k = 0; k < d.K; ++k) {
    if (t < 16) s_u[t] = U[size_t(k) * 16 + t];
    __syncthreads();
    MC_MARK(0)
    // ---- move type, species, eligible count (uniform over the cluster)
    const T u8 = s_u[8];
    const bool spin = sf && s_u[11] < p_spin;   // XT: before the move type
    const bool ins = !spin && u8 < p_half;
    const bool del = !spin && !ins && u8 < p_ins;
    const bool disp = !spin && !ins && !del;
    const int mt = disp ? 0 : (ins ? 1 : 2);
    const int su = S == 1 ? 0 : min(int(s_u[9] * T(S)), S - 1);
    int n_all = 0;
    for (int s = 0; s < S; ++s) n_all += s_nalive[s];
    const int cnt = ins ? s_nvalid[su] - s_nalive[su]
                        : (del ? s_nalive[su] : n_all);
    if (t == 0) acc[spin ? 13 : 9 + mt] += 1.0;
    // nothing to move, or (cavity bias) no open cell to insert into:
    // rejected with no pass; TMMC collects the attempt with a = 0
    const bool cav_rej = XT && x.cav && ins && n_open == 0;
    if (cnt == 0 || cav_rej) {
      if (XT && TM != nullptr && (ins || del) && t == 0 && rank == 0)
        TM[size_t(s_nalive[su]) * 4 + (ins ? 0 : 2)] += 1.0;
      __syncthreads();
      continue;
    }
    const T cntT = T(cnt);
    const int j = int(x_min(x_floor(s_u[0] * cntT), cntT - T(1)));

    // ---- the j-th eligible slot: block-wide inclusive scan over this
    // CTA's replica of the slot table
    const int slot = pick_slot(sl.sa, sl.ssp, ms, ins, del, su, j, s_scan,
                               &s_slot);
    if (spin) {
      // ---- spinflip (XT): the rotor's d_f, its spin row only; every CTA
      // decides alike and flips its own replica, with no pass or barrier
      if (t == 0) {
        const int s_cur = SPN[slot];
        if (spinflip_accept<T>(s_cur, ROT[2 * slot], ROT[2 * slot + 1],
                               beta, s_u[4])) {
          SPN[slot] = 1 - s_cur;
          acc[12] += 1.0;
        }
      }
      __syncthreads();
      continue;
    }
    const int start = slot_start[slot];
    const int spf = disp ? sl.ssp[slot] : su;
    const int na = s_na[spf];
    MC_MARK(1)

    // ---- the molecule's current rows from their owners, then its trial
    // rows (thread 0)
    if (pending) {
      cluster_wait();
      pending = false;
    }
    MC_MARK(2)
    if (t < na) {
      const int r = start + t;
      T row[3];
      read_row<T>(cluster, sl, r, nloc, row);
      s_old[t][0] = row[0];
      s_old[t][1] = row[1];
      s_old[t][2] = row[2];
      s_qi[t] = q[r];
      s_ei[t] = eps[r];
      s_si[t] = sig[r];
      s_mi[t] = mass[r];
      if constexpr (F != RD_CLASSIC) load_form_row<T, F>(s_fi, t, r, fcol);
    }
    __syncthreads();
    MC_MARK(3)
    if (t == 0) {
      if (XT && ins && x.cav) {
        T fr[3];
        cavity_frac<T>(s_u, x.cav_list + size_t(c) * x.g3, n_open, x.g, fr);
        insert_trial<T>(fr, s_u, s_box, s_tmpl + spf * A * 3, A, na, s_new);
      } else if (ins) {
        insert_trial<T>(s_u + 1, s_u, s_box, s_tmpl + spf * A * 3, A, na,
                        s_new);
      } else
        displace_trial<T>(s_u, mf, rotf, A, na, s_old, s_mi, s_new);
    }
    __syncthreads();
    MC_MARK(4)

    // ---- the old+new pass over this CTA's columns, the S(k) delta over
    // its k-vectors, and the partials of every rank
    const bool has_old = !ins, has_new = !del;
    double a_rd = 0.0, a_es = 0.0, a_rec = 0.0;
    T mn = T(INFINITY);
    T mm_i = T(0);           // the molecule's mass (the slot's site masses)
    for (int a = 0; a < na; ++a) mm_i += s_mi[a];
    slice_pass<T, QC, F>(sl, base, cnt_j, start, na, has_old, has_new, s_old,
                         s_new, s_ei, s_si, s_qi, s_box, s_bi, o, rc, rc2,
                         alpha, mm_i, beta_t, temp, hb2, a_rd, a_es, mn,
                         s_fi);
    if (o.es == 1)
      sk_delta<T>(sl.kv, sl.kc, sl.skr, sl.ski, sl.dsr, sl.dsi, cnt_k, na,
                  has_old, has_new, s_old, s_new, s_qi, a_rec);
    block_reduce<T>(a_rd, a_es, a_rec, mn, s_red, s_min);
    MC_MARK(5)
    exchange_partials<T>(cluster, s_red, s_min, s_part, s_xch[k & 1], rank,
                         G);
    MC_MARK(6)

    // ---- acceptance (thread 0 of every CTA, double, the same decision)
    if (t == 0) {
      double drd, des, drec;
      T mr2;
      cluster_totals<T>(s_xch[k & 1], G, drd, des, drec, mr2);
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
      if (XT && x.cav) lnb += sgn * cavity_lnf(n_open, x.g3);
      const double ln_t = lnb - beta * du;   // unbiased
      double ln_eff = ln_t;
      if (XT && x.bias && !disp) {   // the flat-histogram tilt
        const int n0 = min(s_nalive[su], x.ke - 1);
        const int n1 = min(max(n0 + (ins ? 1 : -1), 0), x.ke - 1);
        ln_eff = ln_t + (double(x.eta[n1]) - double(x.eta[n0]));
      }
      const bool accept = !reject && log(fmax(double(s_u[4]), 1e-38)) < ln_eff;
      if (XT && TM != nullptr && !disp && rank == 0) {
        const double a = reject ? 0.0 : exp(fmin(ln_t, 0.0));
        double* row = TM + size_t(s_nalive[su]) * 4 + (ins ? 0 : 2);
        row[0] += 1.0;
        row[1] += a;
      }
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
    MC_MARK(7)

    // ---- commit in place: the owners their rows, every CTA its S(k)
    // slice and its slot table; then barrier B's arrive
    if (s_accept) {
      if (t < na) {
        int owner, rl;
        owner_of(start + t, nloc, owner, rl);
        if (owner == rank) {
          if (!del) {
            sl.x[rl] = s_new[t][0];
            sl.y[rl] = s_new[t][1];
            sl.z[rl] = s_new[t][2];
          }
          sl.al[rl] = !del;
        }
      }
      if (o.es == 1) sk_commit<T>(sl.skr, sl.ski, sl.dsr, sl.dsi, cnt_k);
      if (t == 0 && !disp) {
        sl.sa[slot] = ins;
        s_nalive[su] += ins ? 1 : -1;
      }
    }
    cluster_arrive();
    pending = true;
    MC_MARK(8)
  }
  MC_CLOCK_WRITE(c == 0 && rank == 0, d.K)
  if (pending) cluster_wait();   // no CTA reads another's slice after this
  __syncthreads();

  // ---- write back this CTA's slice (and, rank 0, the slot table and sums)
  for (int jl = t; jl < cnt_j; jl += NT) {
    const int jc = base + jl;
    P[3 * jc] = sl.x[jl];
    P[3 * jc + 1] = sl.y[jl];
    P[3 * jc + 2] = sl.z[jl];
    AL[jc] = sl.al[jl];
  }
  for (int kl = t; kl < cnt_k; kl += NT) {
    SKr[kbase + kl] = sl.skr[kl];
    SKi[kbase + kl] = sl.ski[kl];
  }
  if (rank == 0) {
    for (int i = t; i < ms; i += NT) SA[i] = sl.sa[i];
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < N_SUMS; ++i) sums[size_t(c) * N_SUMS + i] = acc[i];
    }
  }
}

// The kernel instance of a launch: with the quantum terms or without, so
// that a classical deck runs the code it ran before they existed; XT (the
// µVT extras) is the library's: uvt_kernel.cu builds XT = false,
// uvt_xt_kernel.cu XT = true, each with its own nvcc.
template <typename T, bool XT>
auto uvt_instance(bool qc) {
  return qc ? uvt_kernel<T, true, XT> : uvt_kernel<T, false, XT>;
}

// A form instance (F, rd_forms.cuh): the XT instance, for FORM_GWP (rd
// lj) with the quantum terms or without (FH and FK need rd lj, so the RD
// forms have none), its columns the kernel's last argument.
template <typename T, int F>
auto uvt_form_instance(bool qc) {
  if constexpr (F == FORM_GWP) {
    if (qc) return uvt_kernel<T, true, true, F>;
  }
  return uvt_kernel<T, false, true, F>;
}

// Per-CTA slice sizes of a G-CTA cluster.
inline Dims uvt_dims(int C, int n, int ms, int S, int A, int K, int nk,
                     int G) {
  return Dims{C, n, ms, S, A, K, nk, G, (n + G - 1) / G, (nk + G - 1) / G};
}

template <typename T, bool XT>
int launch_uvt(T* pos, bool* alive, const T* eps, const T* sig, const T* q,
               const T* mass, const T* mmass, const int32_t* slot_start,
               const int32_t* slot_species, bool* slot_alive, const T* tmpl,
               const int32_t* natoms, const T* scal, const T* betas,
               const T* lnfvs, const T* d_self, const T* d_excl, const T* c1,
               const T* cx, const T* u, const T* kvec, const T* kcoef, T* sk,
               double* sums, const Dims d, const Opts o, const XtArgs<T> x,
               double ke, double hb2, cudaStream_t stream) {
  if (d.G < 1 || d.G > G_MAX) return int(cudaErrorInvalidValue);
  const size_t smem = slice_bytes<T>(d.nloc, d.kloc, d.ms, o.qc != 0);
  return cluster_run(uvt_instance<T, XT>(o.qc != 0), d.C, d.G, smem, stream,
                     pos, alive, eps, sig, q, mass, mmass, slot_start,
                     slot_species, slot_alive, tmpl, natoms, scal, betas,
                     lnfvs, d_self, d_excl, c1, cx, u, kvec, kcoef, sk, sums,
                     d, o, x, ke, hb2,
                     FormCols<T>{nullptr, nullptr, nullptr, nullptr});
}

template <typename T, int F>
int launch_uvt_form(T* pos, bool* alive, const T* eps, const T* sig,
                    const T* q, const T* mass, const T* mmass,
                    const int32_t* slot_start,
                    const int32_t* slot_species, bool* slot_alive,
                    const T* tmpl, const int32_t* natoms, const T* scal,
                    const T* betas, const T* lnfvs, const T* d_self,
                    const T* d_excl, const T* c1, const T* cx, const T* u,
                    const T* kvec, const T* kcoef, T* sk, double* sums,
                    const Dims d, const Opts o, const XtArgs<T> x, double ke,
                    double hb2, const FormCols<T> fc, cudaStream_t stream) {
  if (d.G < 1 || d.G > G_MAX || (o.qc != 0 && F != FORM_GWP))
    return int(cudaErrorInvalidValue);
  const size_t smem = slice_bytes<T>(d.nloc, d.kloc, d.ms, o.qc != 0,
                                     form_planes<F>(o.es == 4));
  return cluster_run(uvt_form_instance<T, F>(o.qc != 0), d.C, d.G, smem,
                     stream, pos, alive, eps, sig, q, mass, mmass, slot_start,
                     slot_species, slot_alive, tmpl, natoms, scal, betas,
                     lnfvs, d_self, d_excl, c1, cx, u, kvec, kcoef, sk, sums,
                     d, o, x, ke, hb2, fc);
}

}  // namespace

// The C entries of one dtype of a library (XT: its instances); the
// occupancy query's xt argument is the caller's, checked against XT.
#define RUN_STEPS_UVT_ENTRY(SFX, T, XT)                                      \
  extern "C" int run_steps_uvt_##SFX(                                       \
      void* pos, void* alive, const void* eps, const void* sig,              \
      const void* q, const void* mass, const void* mmass,                    \
      const void* slot_start,                                                \
      const void* slot_species, void* slot_alive, const void* tmpl,          \
      const void* natoms, const void* scal, const void* betas,               \
      const void* lnfvs, const void* d_self, const void* d_excl,             \
      const void* c1, const void* cx, const void* u, const void* kvec,       \
      const void* kcoef, void* sk, void* sums, const void* cav_list,         \
      const void* cav_n, const void* eta, void* tmmc, const void* rot,       \
      void* spin, int C, int n, int ms,                                      \
      int S, int A, int K, int nk, int G, int rd, int mix, int es,           \
      int ortho, int qc, int g, int g3, int ke_eta, int rows, int cav,       \
      int tm, int bias, int sf, double ke, double hb2, void* stream) {       \
    if (C <= 0) return 0;                                                    \
    if ((cav || tm || sf) != XT) return int(cudaErrorInvalidValue);          \
    return launch_uvt<T, XT>(                                                \
        (T*)pos, (bool*)alive, (const T*)eps, (const T*)sig, (const T*)q,    \
        (const T*)mass, (const T*)mmass, (const int32_t*)slot_start,         \
        (const int32_t*)slot_species, (bool*)slot_alive, (const T*)tmpl,     \
        (const int32_t*)natoms, (const T*)scal, (const T*)betas,             \
        (const T*)lnfvs, (const T*)d_self, (const T*)d_excl, (const T*)c1,   \
        (const T*)cx, (const T*)u, (const T*)kvec, (const T*)kcoef, (T*)sk,  \
        (double*)sums, uvt_dims(C, n, ms, S, A, K, nk, G),                   \
        Opts{rd, mix, es, ortho, qc},                                        \
        XtArgs<T>{(const int32_t*)cav_list, (const int32_t*)cav_n,           \
                  (const T*)eta, (double*)tmmc, g, g3, ke_eta, rows, cav,    \
                  tm, bias, (const T*)rot, (int32_t*)spin, sf},              \
        ke, hb2, (cudaStream_t)stream);                                      \
  }                                                                          \
  extern "C" int uvt_occupancy_##SFX(int n, int nk, int ms, int qc, int xt,  \
                                     int G, int* clusters) {                 \
    if ((xt != 0) != XT) return int(cudaErrorInvalidValue);                  \
    const Dims d = uvt_dims(1, n, ms, 1, 1, 1, nk, G);                       \
    return cluster_occupancy(uvt_instance<T, XT>(qc != 0), G,                \
                             slice_bytes<T>(d.nloc, d.kloc, ms, qc != 0),    \
                             clusters);                                      \
  }


// The C entries of one dtype of a form library (F, rd_forms.cuh; the XT
// instance, any of its extras on or off): the classical entries' arguments
// (rd: disp_expansion's damping flag, or FORM_GWP's rd none/lj; qc 0, or
// FORM_GWP's quantum correction with the molecule-mass plane mmass) and
// the C6, C8, C10 and GWP width columns before the stream (null where the
// form reads none); the occupancy query's gw says whether the slice holds
// the width plane, its qc whether it holds the mass plane.
#define RUN_STEPS_UVT_FORM_ENTRY(F, SFX, T)                                  \
  extern "C" int run_steps_uvt_rd_##SFX(                                    \
      void* pos, void* alive, const void* eps, const void* sig,              \
      const void* q, const void* mass, const void* mmass,                    \
      const void* slot_start,                                                \
      const void* slot_species, void* slot_alive, const void* tmpl,          \
      const void* natoms, const void* scal, const void* betas,               \
      const void* lnfvs, const void* d_self, const void* d_excl,             \
      const void* c1, const void* cx, const void* u, const void* kvec,       \
      const void* kcoef, void* sk, void* sums, const void* cav_list,         \
      const void* cav_n, const void* eta, void* tmmc, const void* rot,       \
      void* spin, int C, int n, int ms,                                      \
      int S, int A, int K, int nk, int G, int rd, int mix, int es,           \
      int ortho, int qc, int g, int g3, int ke_eta, int rows, int cav,       \
      int tm, int bias, int sf, double ke, double hb2, const void* c6,       \
      const void* c8, const void* c10, const void* w, void* stream) {        \
    if (C <= 0) return 0;                                                    \
    return launch_uvt_form<T, F>(                                            \
        (T*)pos, (bool*)alive, (const T*)eps, (const T*)sig, (const T*)q,    \
        (const T*)mass, (const T*)mmass, (const int32_t*)slot_start,         \
        (const int32_t*)slot_species, (bool*)slot_alive, (const T*)tmpl,     \
        (const int32_t*)natoms, (const T*)scal, (const T*)betas,             \
        (const T*)lnfvs, (const T*)d_self, (const T*)d_excl, (const T*)c1,   \
        (const T*)cx, (const T*)u, (const T*)kvec, (const T*)kcoef, (T*)sk,  \
        (double*)sums, uvt_dims(C, n, ms, S, A, K, nk, G),                   \
        Opts{rd, mix, es, ortho, qc},                                        \
        XtArgs<T>{(const int32_t*)cav_list, (const int32_t*)cav_n,           \
                  (const T*)eta, (double*)tmmc, g, g3, ke_eta, rows, cav,    \
                  tm, bias, (const T*)rot, (int32_t*)spin, sf},              \
        ke, hb2,                                                             \
        FormCols<T>{(const T*)c6, (const T*)c8, (const T*)c10, (const T*)w}, \
        (cudaStream_t)stream);                                               \
  }                                                                          \
  extern "C" int uvt_occupancy_rd_##SFX(int n, int nk, int ms, int gw,      \
                                        int qc, int G, int* clusters) {      \
    if (qc && F != FORM_GWP) return int(cudaErrorInvalidValue);              \
    const Dims d = uvt_dims(1, n, ms, 1, 1, 1, nk, G);                       \
    return cluster_occupancy(                                                \
        uvt_form_instance<T, F>(qc != 0), G,                                 \
        slice_bytes<T>(d.nloc, d.kloc, ms, qc != 0,                          \
                       form_planes<F>(gw != 0)),                             \
        clusters);                                                           \
  }
