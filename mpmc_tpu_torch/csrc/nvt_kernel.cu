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
//   Waldman-Hagler mixing, the real-space Ewald/Wolf/cutoff Coulomb term,
//   the closest approach for autoreject; the molecule's own columns masked);
//   the S(k) delta over the Nk k-vectors under Ewald; the acceptance test
//   (Metropolis at the chain's beta, or Ray's microcanonical rule against a
//   kinetic reservoir carried across the chunk's steps); the in-place commit
//   of positions and S(k).
//
// Design: one thread block per chain (grid = C, NT threads), the K steps a
//   loop inside the block (the TPU kernel's sequential fori_loop).  The
//   per-atom planes (pos [C,N,3], alive [N] shared by the chains,
//   eps/sig/q/mass [N]: ~0.3 MB per chain at N = 10k) stay in device memory,
//   where they are L2-resident; shared memory holds only the step's <= 8
//   current and trial rows and the reduction scratch.  The S(k) delta of the
//   step goes to a per-chain scratch row in device memory (dsk) and is
//   committed by the thread that computed it.  The pair evaluation, the
//   column pass, the S(k) delta, the block reduction and the displacement
//   trial are B1's (mc_common.cuh).
//
// Bound: operations.  A step evaluates 2 x A x (alive columns) pairs - 2 x
//   3 x 10,029 = 60.2k at the 10.0k MOF + H2 system - at 44 floating-point
//   operations each (csrc/uvt_kernel.cu counts them), plus 2 x A x Nk phases
//   of 13 and Nk reciprocal terms of 9: about 2.7 Mflop per step, 0.04 us at
//   the card's 67 TFLOP/s f32 peak.  One block per chain can use one SM,
//   1/132 of that peak; the design buys chains, not steps.
//
// Reductions and numerics as in B1: per-thread pair sums in double, warp
//   shuffles, thread 0 over the warps in a fixed order; the acceptance test
//   and the NVE reservoir in double on thread 0; energy deltas enter the
//   accumulators by selection, never by multiplication (a deep-core trial
//   has an infinite pair energy and 0 * inf would be NaN).
//
// Sums [C,4]: d_rd, d_es_real, d_es_recip, accepted moves.
//
// Scalar header scal[23]: rc, alpha, move_factor, rot_factor, thr2, box
//   (3x3 row-major, rows are cell vectors), box^-1 (3x3 row-major).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mc_common.cuh"

namespace {

constexpr int N_SUMS_NVT = 4;

struct DimsNvt {
  int C, n, mv, A, K, nk;
};

template <typename T>
__global__ void __launch_bounds__(NT) nvt_kernel(
    T* pos, const bool* __restrict__ alive, const T* __restrict__ eps,
    const T* __restrict__ sig, const T* __restrict__ q,
    const T* __restrict__ mass, const int32_t* __restrict__ mv_start,
    const int32_t* __restrict__ mv_natoms, const T* __restrict__ scal,
    const T* __restrict__ betas, const T* __restrict__ u,
    const T* __restrict__ kvec, const T* __restrict__ kcoef, T* sk, T* dsk,
    const double* __restrict__ nve_k0, double* __restrict__ sums,
    const DimsNvt d, const Opts o, const int nve, const double ke,
    const double nve_g) {
  __shared__ T s_box[9], s_bi[9];
  __shared__ T s_u[8];
  __shared__ T s_old[A_PAD][3], s_new[A_PAD][3];
  __shared__ T s_qi[A_PAD], s_ei[A_PAD], s_si[A_PAD], s_mi[A_PAD];
  __shared__ int s_accept;
  __shared__ double s_red[3][NW];
  __shared__ T s_min[NW];

  const int t = threadIdx.x;
  const int c = blockIdx.x;
  const int n = d.n, nk = d.nk;
  T* P = pos + size_t(c) * n * 3;
  T* SKr = sk + size_t(c) * 2 * nk;
  T* SKi = SKr + nk;
  T* DSr = dsk + size_t(c) * 2 * nk;
  T* DSi = DSr + nk;
  const T* U = u + size_t(c) * d.K * 16;

  if (t < 9) {
    s_box[t] = scal[5 + t];
    s_bi[t] = scal[14 + t];
  }
  const T rc = scal[0], alpha = scal[1], mf = scal[2], rotf = scal[3];
  const T thr2 = scal[4];
  const T rc2 = rc * rc;
  const T mvT = T(d.mv);
  const double beta = double(betas[c]);
  double k_cur = nve ? nve_k0[c] : 0.0;   // thread 0's kinetic reservoir
  double acc[N_SUMS_NVT] = {0.0, 0.0, 0.0, 0.0};

  for (int k = 0; k < d.K; ++k) {
    if (t < 8) s_u[t] = U[size_t(k) * 16 + t];
    __syncthreads();
    // ---- the molecule: a direct index into the alive movable table
    const int m = int(x_min(x_floor(s_u[0] * mvT), mvT - T(1)));
    const int start = mv_start[m];
    const int na = mv_natoms[m];
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
    if (t == 0) displace_trial<T>(s_u, mf, rotf, d.A, na, s_old, s_mi, s_new);
    __syncthreads();

    // ---- one old+new pass over the columns, then the S(k) delta
    double a_rd = 0.0, a_es = 0.0, a_rec = 0.0;
    T mn = T(INFINITY);
    column_pass<T>(P, alive, q, eps, sig, n, start, na, true, true, s_old,
                   s_new, s_ei, s_si, s_qi, s_box, s_bi, o, rc, rc2, alpha,
                   a_rd, a_es, mn);
    if (o.es == 1)
      sk_delta<T>(kvec, kcoef, SKr, SKi, DSr, DSi, nk, na, true, true, s_old,
                  s_new, s_qi, a_rec);
    block_reduce<T>(a_rd, a_es, a_rec, mn, s_red, s_min);

    // ---- acceptance (thread 0, double)
    if (t == 0) {
      double drd, des, drec;
      T mr2;
      block_totals<T>(s_red, s_min, drd, des, drec, mr2);
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

    // ---- commit in place
    if (s_accept) {
      if (t < na) {
        const int r = start + t;
        P[3 * r] = s_new[t][0];
        P[3 * r + 1] = s_new[t][1];
        P[3 * r + 2] = s_new[t][2];
      }
      if (o.es == 1) sk_commit<T>(SKr, SKi, DSr, DSi, nk);
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < N_SUMS_NVT; ++i)
      sums[size_t(c) * N_SUMS_NVT + i] = acc[i];
  }
}

}  // namespace

#define RUN_STEPS_NVT_ENTRY(SFX, T)                                          \
  extern "C" int run_steps_nvt_##SFX(                                       \
      void* pos, const void* alive, const void* eps, const void* sig,        \
      const void* q, const void* mass, const void* mv_start,                 \
      const void* mv_natoms, const void* scal, const void* betas,            \
      const void* u, const void* kvec, const void* kcoef, void* sk,          \
      void* dsk, const void* nve_k0, void* sums, int C, int n, int mv,       \
      int A, int K, int nk, int rd, int mix, int es, int ortho, int nve,     \
      double ke, double nve_g, void* stream) {                               \
    if (C <= 0) return 0;                                                    \
    nvt_kernel<T><<<C, NT, 0, (cudaStream_t)stream>>>(                       \
        (T*)pos, (const bool*)alive, (const T*)eps, (const T*)sig,           \
        (const T*)q, (const T*)mass, (const int32_t*)mv_start,               \
        (const int32_t*)mv_natoms, (const T*)scal, (const T*)betas,          \
        (const T*)u, (const T*)kvec, (const T*)kcoef, (T*)sk, (T*)dsk,       \
        (const double*)nve_k0, (double*)sums, DimsNvt{C, n, mv, A, K, nk},   \
        Opts{rd, mix, es, ortho}, nve, ke, nve_g);                           \
    return int(cudaGetLastError());                                          \
  }

RUN_STEPS_NVT_ENTRY(f32, float)
RUN_STEPS_NVT_ENTRY(f64, double)
