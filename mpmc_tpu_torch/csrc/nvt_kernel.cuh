// Fused NVT / NVE step loop, hand-written for Hopper (sm_90a).
//
// B3 run_steps_nvt replaces mpmc_tpu/ops/pallas/mc_kernel.py::_kernel
//   (wrappers run_steps / run_steps_multi): K translate+rotate Metropolis
//   steps per launch for C independent chains, the system held on the card
//   between steps.  Per step: the molecule, by a direct index into the table
//   of alive movable molecules (m = min(floor(u0 Mv), Mv - 1); aliveness
//   never changes under NVT); the trial rows (translation from lanes 1-3 in
//   a cube of half-width move_factor and, for molecules of several sites, an
//   axis-angle rotation from lanes 5-7 about the mass-weighted COM); ONE
//   old+new pass over all N columns (LJ with Lorentz-Berthelot or
//   Waldman-Hagler mixing and optionally its Feynman-Hibbs order 2/4 or
//   Feynman-Kleinert correction at the chain's beta with the
//   molecule-pair reduced mass, the real-space Ewald/Wolf/cutoff Coulomb term,
//   the closest approach for autoreject; the molecule's own columns masked);
//   the S(k) delta over the Nk k-vectors under Ewald; the acceptance test
//   (Metropolis at the chain's beta, or Ray's microcanonical rule against a
//   kinetic reservoir carried across the chunk's steps); the in-place commit
//   of positions and S(k).
//
// Design: B1's - one thread-block cluster of G CTAs per chain (grid C x G,
//   NT threads each), each CTA holding its slice of the chain's columns
//   (pos, alive, q, eps, sig, and under a quantum correction the columns'
//   molecular masses) and k-vectors (kvec, kcoef, S(k), dS) in
//   shared memory for the K steps of the launch; the molecule's rows read
//   from their owners' shared memory, the partials exchanged through
//   distributed shared memory with one cluster barrier, a split second
//   barrier after the commit (mc_cluster.cuh).  Every CTA carries the NVE
//   reservoir in step with the others, as it makes the same decisions.
//   As B1, a classical and a quantum (QC) instance, each without and with
//   the spinflip move (SF, nvt only): lane 8 < p_spin makes the step a
//   spinflip of the picked molecule, accepted with ln u4 < -beta d_f (d_f
//   = F[1 - s] - F[s] of the chain's table rot [C, mv, 2] at its spin s);
//   an accept flips the spin only, and the step skips the pass, the
//   exchange and the barriers in every CTA (all read the same lane); each
//   CTA flips its own replica of the chain's spins, spin [C, G, mv].
//   nvt_kernel.cu builds the instances without SF, nvt_sf_kernel.cu those
//   with it, each with its own nvcc.  Each RD form and coulomb gwp (F,
//   rd_forms.cuh) has an SF instance of its own (GWP, whose rd is lj, a
//   second with the quantum terms; nvt_<form>_kernel.cu, entry
//   run_steps_nvt_rd; p_spin 0 runs it
//   without spinflip, NVE and the hybrid NPT's segments among them), with
//   B1's form pass (mc_cluster.cuh slice_pass_form; the reference's
//   :260-261, :344-347, :398-400, :437-444).
//
// Bound: operations.  A step evaluates 2 x A x (alive columns) pairs - 2 x
//   3 x 10,029 = 60.2k at the 10.0k MOF + H2 system - at 44 floating-point
//   operations each (csrc/uvt_kernel.cu counts them), plus 2 x A x Nk phases
//   of 13 and Nk reciprocal terms of 9: about 2.7 Mflop per step, 0.04 us at
//   the card's 67 TFLOP/s f32 peak; a quantum correction adds B1's counts.  The cluster brings G SMs to a chain,
//   each over 1/G of the pairs, from shared memory.
//
// Reductions and numerics as in B1: per-thread pair sums in double, warp
//   shuffles, thread 0 over the warps in a fixed order, every CTA over the
//   ranks in rank order; the acceptance test and the NVE reservoir in
//   double on thread 0 of every CTA; energy deltas enter the accumulators
//   by selection, never by multiplication (a deep-core trial has an
//   infinite pair energy and 0 * inf would be NaN).
//
// Sums [C,6]: d_rd, d_es_real, d_es_recip, accepted moves, accepted and
//   attempted spinflips (0 outside SF).
//
// Scalar header scal[23]: rc, alpha, move_factor, rot_factor, thr2, box
//   (3x3 row-major, rows are cell vectors), box^-1 (3x3 row-major); the SF
//   instances read p_spin at scal[23].
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mc_cluster.cuh"

namespace {

constexpr int N_SUMS_NVT = 6;

struct DimsNvt {
  int C, n, mv, A, K, nk, G, nloc, kloc;
};

// The spinflip tables of the SF instances: rot [C, mv, 2] (F_para,
// F_ortho) and the spins' replicas spin [C, G, mv].
template <typename T>
struct SpinArgs {
  const T* rot;
  int32_t* spin;
};

template <typename T, bool QC, bool SF, int F = RD_CLASSIC>
__global__ void __launch_bounds__(NT, 1) nvt_kernel(
    T* pos, const bool* __restrict__ alive, const T* __restrict__ eps,
    const T* __restrict__ sig, const T* __restrict__ q,
    const T* __restrict__ mass, const T* __restrict__ mmass,
    const int32_t* __restrict__ mv_start,
    const int32_t* __restrict__ mv_natoms, const T* __restrict__ scal,
    const T* __restrict__ betas, const T* __restrict__ u,
    const T* __restrict__ kvec, const T* __restrict__ kcoef, T* sk,
    const double* __restrict__ nve_k0, double* __restrict__ sums,
    const SpinArgs<T> sp, const DimsNvt d, const Opts o, const int nve,
    const double ke, const double nve_g, const double hb2,
    const FormCols<T> fcol) {
  constexpr int NU = SF ? 9 : 8;     // the lanes a step reads
  __shared__ T s_box[9], s_bi[9];
  __shared__ T s_u[NU];
  __shared__ T s_old[A_PAD][3], s_new[A_PAD][3];
  __shared__ T s_qi[A_PAD], s_ei[A_PAD], s_si[A_PAD], s_mi[A_PAD];
  __shared__ int s_accept;
  __shared__ double s_red[3][NW];
  __shared__ T s_min[NW];
  __shared__ double s_part[N_PART];
  __shared__ double s_xch[2][G_MAX][N_PART];

  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int G = d.G;
  const int rank = int(cluster.block_rank());
  const int c = blockIdx.x / G;
  const int n = d.n, nk = d.nk;
  const int nloc = d.nloc, kloc = d.kloc;
  const int base = rank * nloc, kbase = rank * kloc;
  const int cnt_j = max(0, min(nloc, n - base));
  const int cnt_k = max(0, min(kloc, nk - kbase));
  // a form instance: its Coulomb form gwp (o.es 4) or not, and the moved
  // sites' form values (a classical instance reads neither, nor fcol)
  const bool gw = F != RD_CLASSIC && o.es == 4;
  FormRow<T>* const s_fi = form_rows<T, F>();
  const Slice<T> sl = carve_slice<T, F>(nloc, kloc, 0, QC, gw);
  T* P = pos + size_t(c) * n * 3;
  T* SKr = sk + size_t(c) * 2 * nk;
  T* SKi = SKr + nk;
  const T* U = u + size_t(c) * d.K * 16;

  load_slice<T, F>(sl, P, alive, q, eps, sig, mmass, base, cnt_j, kvec,
                   kcoef, SKr, SKi, kbase, cnt_k, fcol);
  if (t < 9) {
    s_box[t] = scal[5 + t];
    s_bi[t] = scal[14 + t];
  }
  // every slice is loaded before any CTA reads another's
  cluster_arrive();
  cluster_wait();

  const T rc = scal[0], alpha = scal[1], mf = scal[2], rotf = scal[3];
  const T thr2 = scal[4];
  const T rc2 = rc * rc;
  const T mvT = T(d.mv);
  const double beta = double(betas[c]);
  const T beta_t = betas[c], temp = T(1) / beta_t;   // the quantum terms' beta
  double k_cur = nve ? nve_k0[c] : 0.0;   // thread 0's kinetic reservoir
  double acc[N_SUMS_NVT] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  // spinflip (SF): p_spin, the chain's table and this CTA's spin replica
  const T p_spin = SF ? scal[23] : T(0);
  const T* ROT = SF ? sp.rot + size_t(c) * d.mv * 2 : nullptr;
  int32_t* SPN = SF ? sp.spin + (size_t(c) * G + rank) * d.mv : nullptr;
  bool pending = false;   // SF: barrier B arrived at, not yet waited for

  MC_CLOCK_DECL
  for (int k = 0; k < d.K; ++k) {
    if (t < NU) s_u[t] = U[size_t(k) * 16 + t];
    __syncthreads();
    MC_MARK(0)
    // ---- the molecule: a direct index into the alive movable table; its
    // current rows from their owners (after barrier B of the last step)
    const int m = int(x_min(x_floor(s_u[0] * mvT), mvT - T(1)));
    if constexpr (SF) {
      if (s_u[8] < p_spin) {
        // ---- spinflip: the molecule's d_f, its spin only; every CTA
        // decides alike and flips its own replica, with no barrier
        if (t == 0) {
          acc[5] += 1.0;
          const int s_cur = SPN[m];
          if (spinflip_accept<T>(s_cur, ROT[2 * m], ROT[2 * m + 1], beta,
                                 s_u[4])) {
            SPN[m] = 1 - s_cur;
            acc[4] += 1.0;
          }
        }
        __syncthreads();
        continue;
      }
    }
    const int start = mv_start[m];
    const int na = mv_natoms[m];
    MC_MARK(1)
    if constexpr (SF) {
      if (pending) cluster_wait();
    } else {
      if (k > 0) cluster_wait();
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
    if (t == 0) displace_trial<T>(s_u, mf, rotf, d.A, na, s_old, s_mi, s_new);
    __syncthreads();
    MC_MARK(4)

    // ---- the old+new pass over this CTA's columns, the S(k) delta over
    // its k-vectors, and the partials of every rank
    double a_rd = 0.0, a_es = 0.0, a_rec = 0.0;
    T mn = T(INFINITY);
    T mm_i = T(0);           // the molecule's mass (its site masses)
    for (int a = 0; a < na; ++a) mm_i += s_mi[a];
    slice_pass<T, QC, F>(sl, base, cnt_j, start, na, true, true, s_old,
                         s_new, s_ei, s_si, s_qi, s_box, s_bi, o, rc, rc2,
                         alpha, mm_i, beta_t, temp, hb2, a_rd, a_es, mn,
                         s_fi);
    if (o.es == 1)
      sk_delta<T>(sl.kv, sl.kc, sl.skr, sl.ski, sl.dsr, sl.dsi, cnt_k, na,
                  true, true, s_old, s_new, s_qi, a_rec);
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
      const double du = drd + des + drec;
      const bool reject = thr2 > T(0) && mr2 < thr2;
      const double ln_u = log(fmax(double(s_u[4]), 1e-38));
      bool accept;
      if (nve) {   // Ray: P = min(1, (K_new / K_old)^g), K_new > 0
        const double k_new = k_cur - du;
        accept = !reject && k_new > 0.0 && k_cur > 0.0
                 && ln_u < nve_g * (log(k_new) - log(k_cur));
        if (accept) k_cur = k_new;
      } else {
        accept = !reject && ln_u < -beta * du;
      }
      if (accept) {   // select, never multiply: du may be inf on a reject
        acc[0] += drd;
        acc[1] += des;
        acc[2] += drec;
        acc[3] += 1.0;
      }
      s_accept = accept;
    }
    __syncthreads();
    MC_MARK(7)

    // ---- commit in place: the owners their rows, every CTA its S(k)
    // slice; then barrier B's arrive
    if (s_accept) {
      if (t < na) {
        int owner, rl;
        owner_of(start + t, nloc, owner, rl);
        if (owner == rank) {
          sl.x[rl] = s_new[t][0];
          sl.y[rl] = s_new[t][1];
          sl.z[rl] = s_new[t][2];
        }
      }
      if (o.es == 1) sk_commit<T>(sl.skr, sl.ski, sl.dsr, sl.dsi, cnt_k);
    }
    cluster_arrive();
    if constexpr (SF) pending = true;
    MC_MARK(8)
  }
  MC_CLOCK_WRITE(c == 0 && rank == 0, d.K)
  // no CTA reads another's slice after this
  if constexpr (SF) {
    if (pending) cluster_wait();
  } else {
    if (d.K > 0) cluster_wait();
  }
  __syncthreads();

  // ---- write back this CTA's slice (and, rank 0, the sums)
  for (int jl = t; jl < cnt_j; jl += NT) {
    const int jc = base + jl;
    P[3 * jc] = sl.x[jl];
    P[3 * jc + 1] = sl.y[jl];
    P[3 * jc + 2] = sl.z[jl];
  }
  for (int kl = t; kl < cnt_k; kl += NT) {
    SKr[kbase + kl] = sl.skr[kl];
    SKi[kbase + kl] = sl.ski[kl];
  }
  if (rank == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < N_SUMS_NVT; ++i)
      sums[size_t(c) * N_SUMS_NVT + i] = acc[i];
  }
}

// The kernel instance of a launch: with the quantum terms or without (as
// B1's uvt_instance); SF is the library's (nvt_kernel.cu builds SF =
// false, nvt_sf_kernel.cu SF = true).
template <typename T, bool SF>
auto nvt_instance(bool qc) {
  return qc ? nvt_kernel<T, true, SF> : nvt_kernel<T, false, SF>;
}

// A form instance (F, rd_forms.cuh): the SF instance, for FORM_GWP (rd
// lj) with the quantum terms or without (FH and FK need rd lj, so the RD
// forms have none), its columns the kernel's last argument; p_spin 0
// (scal[23]) runs it without spinflip, NVE among them.
template <typename T, int F>
auto nvt_form_instance(bool qc) {
  if constexpr (F == FORM_GWP) {
    if (qc) return nvt_kernel<T, true, true, F>;
  }
  return nvt_kernel<T, false, true, F>;
}

// Per-CTA slice sizes of a G-CTA cluster.
inline DimsNvt nvt_dims(int C, int n, int mv, int A, int K, int nk, int G) {
  return DimsNvt{C, n, mv, A, K, nk, G, (n + G - 1) / G, (nk + G - 1) / G};
}

template <typename T, bool SF>
int launch_nvt(T* pos, const bool* alive, const T* eps, const T* sig,
               const T* q, const T* mass, const T* mmass,
               const int32_t* mv_start,
               const int32_t* mv_natoms, const T* scal, const T* betas,
               const T* u, const T* kvec, const T* kcoef, T* sk,
               const double* nve_k0, double* sums, const SpinArgs<T> sp,
               const DimsNvt d, const Opts o, int nve, double ke,
               double nve_g, double hb2, cudaStream_t stream) {
  if (d.G < 1 || d.G > G_MAX) return int(cudaErrorInvalidValue);
  const size_t smem = slice_bytes<T>(d.nloc, d.kloc, 0, o.qc != 0);
  return cluster_run(nvt_instance<T, SF>(o.qc != 0), d.C, d.G, smem, stream,
                     pos, alive, eps, sig, q, mass, mmass, mv_start,
                     mv_natoms, scal, betas, u, kvec, kcoef, sk, nve_k0, sums,
                     sp, d, o, nve, ke, nve_g, hb2,
                     FormCols<T>{nullptr, nullptr, nullptr, nullptr});
}

template <typename T, int F>
int launch_nvt_form(T* pos, const bool* alive, const T* eps, const T* sig,
                    const T* q, const T* mass, const T* mmass,
                    const int32_t* mv_start,
                    const int32_t* mv_natoms, const T* scal, const T* betas,
                    const T* u, const T* kvec, const T* kcoef, T* sk,
                    const double* nve_k0, double* sums, const SpinArgs<T> sp,
                    const DimsNvt d, const Opts o, int nve, double ke,
                    double nve_g, double hb2, const FormCols<T> fc,
                    cudaStream_t stream) {
  if (d.G < 1 || d.G > G_MAX || (o.qc != 0 && F != FORM_GWP))
    return int(cudaErrorInvalidValue);
  const size_t smem = slice_bytes<T>(d.nloc, d.kloc, 0, o.qc != 0,
                                     form_planes<F>(o.es == 4));
  return cluster_run(nvt_form_instance<T, F>(o.qc != 0), d.C, d.G, smem,
                     stream, pos, alive, eps, sig, q, mass, mmass, mv_start,
                     mv_natoms, scal, betas, u, kvec, kcoef, sk, nve_k0, sums,
                     sp, d, o, nve, ke, nve_g, hb2, fc);
}

}  // namespace

// The C entries of one dtype of a library (SF: its instances).
#define RUN_STEPS_NVT_ENTRY(SFX, T, SF)                                      \
  extern "C" int run_steps_nvt_##SFX(                                       \
      void* pos, const void* alive, const void* eps, const void* sig,        \
      const void* q, const void* mass, const void* mmass,                    \
      const void* mv_start, const void* mv_natoms, const void* scal,         \
      const void* betas,                                                     \
      const void* u, const void* kvec, const void* kcoef, void* sk,          \
      const void* nve_k0, void* sums, const void* rot, void* spin, int C,    \
      int n, int mv, int A, int K, int nk, int G, int rd, int mix, int es,   \
      int ortho, int nve, int qc, int sf, double ke, double nve_g,           \
      double hb2, void* stream) {                                            \
    if (C <= 0) return 0;                                                    \
    if ((sf != 0) != SF || (SF && nve)) return int(cudaErrorInvalidValue);   \
    return launch_nvt<T, SF>(                                                \
        (T*)pos, (const bool*)alive, (const T*)eps, (const T*)sig,           \
        (const T*)q, (const T*)mass, (const T*)mmass,                        \
        (const int32_t*)mv_start,                                            \
        (const int32_t*)mv_natoms, (const T*)scal, (const T*)betas,          \
        (const T*)u, (const T*)kvec, (const T*)kcoef, (T*)sk,                \
        (const double*)nve_k0, (double*)sums,                                \
        SpinArgs<T>{(const T*)rot, (int32_t*)spin},                          \
        nvt_dims(C, n, mv, A, K, nk, G), Opts{rd, mix, es, ortho, qc}, nve,  \
        ke, nve_g, hb2, (cudaStream_t)stream);                               \
  }                                                                          \
  extern "C" int nvt_occupancy_##SFX(int n, int nk, int qc, int G,           \
                                     int* clusters) {                        \
    const DimsNvt d = nvt_dims(1, n, 1, 1, 1, nk, G);                        \
    return cluster_occupancy(nvt_instance<T, SF>(qc != 0), G,                \
                             slice_bytes<T>(d.nloc, d.kloc, 0, qc != 0),     \
                             clusters);                                      \
  }

// The C entries of one dtype of a form library (F, rd_forms.cuh; the SF
// instance, spinflip on (sf, not under nve) or off): the classical
// entries' arguments (rd: disp_expansion's damping flag, or FORM_GWP's rd
// none/lj; qc 0, or FORM_GWP's quantum correction with the molecule-mass
// plane mmass) and the C6, C8, C10 and GWP width columns before the
// stream (null where the form reads none); the occupancy query's gw says
// whether the slice holds the width plane, its qc whether it holds the
// mass plane.
#define RUN_STEPS_NVT_FORM_ENTRY(F, SFX, T)                                  \
  extern "C" int run_steps_nvt_rd_##SFX(                                    \
      void* pos, const void* alive, const void* eps, const void* sig,        \
      const void* q, const void* mass, const void* mmass,                    \
      const void* mv_start, const void* mv_natoms, const void* scal,         \
      const void* betas,                                                     \
      const void* u, const void* kvec, const void* kcoef, void* sk,          \
      const void* nve_k0, void* sums, const void* rot, void* spin, int C,    \
      int n, int mv, int A, int K, int nk, int G, int rd, int mix, int es,   \
      int ortho, int nve, int qc, int sf, double ke, double nve_g,           \
      double hb2, const void* c6, const void* c8, const void* c10,           \
      const void* w, void* stream) {                                         \
    if (C <= 0) return 0;                                                    \
    if (sf && nve) return int(cudaErrorInvalidValue);                        \
    return launch_nvt_form<T, F>(                                            \
        (T*)pos, (const bool*)alive, (const T*)eps, (const T*)sig,           \
        (const T*)q, (const T*)mass, (const T*)mmass,                        \
        (const int32_t*)mv_start,                                            \
        (const int32_t*)mv_natoms, (const T*)scal, (const T*)betas,          \
        (const T*)u, (const T*)kvec, (const T*)kcoef, (T*)sk,                \
        (const double*)nve_k0, (double*)sums,                                \
        SpinArgs<T>{(const T*)rot, (int32_t*)spin},                          \
        nvt_dims(C, n, mv, A, K, nk, G), Opts{rd, mix, es, ortho, qc}, nve,  \
        ke, nve_g, hb2,                                                      \
        FormCols<T>{(const T*)c6, (const T*)c8, (const T*)c10, (const T*)w}, \
        (cudaStream_t)stream);                                               \
  }                                                                          \
  extern "C" int nvt_occupancy_rd_##SFX(int n, int nk, int gw, int qc,     \
                                        int G, int* clusters) {              \
    if (qc && F != FORM_GWP) return int(cudaErrorInvalidValue);              \
    const DimsNvt d = nvt_dims(1, n, 1, 1, 1, nk, G);                        \
    return cluster_occupancy(                                                \
        nvt_form_instance<T, F>(qc != 0), G,                                 \
        slice_bytes<T>(d.nloc, d.kloc, 0, qc != 0, form_planes<F>(gw != 0)), \
        clusters);                                                           \
  }
