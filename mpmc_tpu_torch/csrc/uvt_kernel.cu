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
//
// The pair evaluation, the column pass, the S(k) delta, the block
// reduction and the displacement trial are shared with B3 (nvt_kernel.cu),
// the slot pick and the insert trial with B6 (pda_kernel.cu), all in
// mc_common.cuh.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mc_common.cuh"

namespace {

constexpr int S_MAX = 8;         // most insert species
constexpr int N_SUMS = 14;

struct Dims {
  int C, n, ms, S, A, K, nk;
};

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

  const int t = threadIdx.x;
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

    // ---- the j-th eligible slot: block-wide inclusive scan
    const int slot = pick_slot(SA, slot_species, ms, ins, del, su, j, s_scan,
                               &s_slot);
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
      if (ins)
        insert_trial<T>(s_u, s_box, s_tmpl + spf * A * 3, A, na, s_new);
      else
        displace_trial<T>(s_u, mf, rotf, A, na, s_old, s_mi, s_new);
    }
    __syncthreads();

    // ---- one old+new pass over the columns, then the S(k) delta
    const bool has_old = !ins, has_new = !del;
    double a_rd = 0.0, a_es = 0.0, a_rec = 0.0;
    T mn = T(INFINITY);
    column_pass<T>(P, AL, q, eps, sig, n, start, na, has_old, has_new, s_old,
                   s_new, s_ei, s_si, s_qi, s_box, s_bi, o, rc, rc2, alpha,
                   a_rd, a_es, mn);
    if (o.es == 1)
      sk_delta<T>(kvec, kcoef, SKr, SKi, DSr, DSi, nk, na, has_old, has_new,
                  s_old, s_new, s_qi, a_rec);
    block_reduce<T>(a_rd, a_es, a_rec, mn, s_red, s_min);

    // ---- acceptance (thread 0, double)
    if (t == 0) {
      double drd, des, drec;
      T mr2;
      block_totals<T>(s_red, s_min, drd, des, drec, mr2);
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
      if (o.es == 1) sk_commit<T>(SKr, SKi, DSr, DSi, nk);
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
