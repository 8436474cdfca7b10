// The thread-block-cluster layer of the fused step loops B1 (uvt_kernel.cu)
// and B3 (nvt_kernel.cu), and of B6 (pda_kernel.cu): one cluster of G CTAs
// per chain, each CTA holding a contiguous slice of the chain's columns and
// k-vectors in its shared memory for the K steps of a launch.  A form
// instance (F, rd_forms.cuh) adds its column planes (form_planes) and
// evaluates its pair terms only under a warp vote (slice_pass_form).  B6
// reads a fixed state: it adds the polar planes to the slice
// (polar_slice_bytes), commits nothing, and meets through one barrier per
// step (exchange_vector); the rest of this note is B1's and B3's step.
//
// Layout.  Rank r of a chain's cluster owns the columns [r nloc, (r + 1)
//   nloc) with nloc = ceil(n / G), as structure-of-arrays planes x, y, z,
//   q, eps, sig and alive - and, under a Feynman-Hibbs/Kleinert
//   correction (Opts.qc), a seventh plane, each column's molecular mass;
//   in a form instance (F, rd_forms.cuh) disp_expansion's C6, C8, C10
//   and gwp's width after them -, and the k-vectors [r kloc, (r + 1) kloc) with
//   kloc = ceil(nk / G): kvec, kcoef, S(k) and the step's dS.  B1 adds a
//   replica of the slot table (alive flags and species) in every CTA.
//   slice_bytes() gives the dynamic shared memory of one CTA; the wrapper
//   (ops/cuda/mc_kernel.py::slice_bytes) computes the same sum.
//
// A step.  Every CTA derives the move from the same uniforms and the same
//   replicated tables, so every CTA gets the same molecule and the same
//   trial rows, bit for bit.  The molecule's current rows are read from
//   the shared memory of the ranks that own them (distributed shared
//   memory, map_shared_rank).  Each CTA runs the old+new pass over its own
//   columns and the S(k) delta over its own k-vectors, reduces over its
//   block (threads -> warps in a fixed order), and pushes its partial
//   (d_rd, d_es, d_rec, min r^2) into slot [rank] of every CTA's exchange
//   buffer.  After one cluster barrier (A) every CTA adds the G partials in
//   rank order, in double, and makes the same acceptance decision; the
//   ranks that own the molecule's rows commit them into their slices, and
//   every CTA commits its S(k) slice and its copy of the slot table.  A
//   second, split cluster barrier (B: arrive after the commit, wait just
//   before the next step's remote row read) orders the commit before any
//   other rank reads those rows; the slot pick of the next step overlaps
//   its latency.  The exchange buffer alternates between two halves by
//   step parity.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_common.cuh"
#include "rd_forms.cuh"

namespace cg = cooperative_groups;

// The dynamic shared memory of a cluster kernel's CTA (carve_slice).
extern __shared__ __align__(16) unsigned char dyn_smem[];

// MC_PHASE_CLOCK, 0 in the port's build (tools/measure_step_phases.py
// builds 1): the step's phases timed by clock64 on thread 0 of chain 0's
// rank 0 (mc_phase_cycles_read).
#ifndef MC_PHASE_CLOCK
#define MC_PHASE_CLOCK 0
#endif

#if MC_PHASE_CLOCK
// cycles per step of each phase: uniforms, slot pick / molecule, barrier
// B's wait, row read, trial rows, pass + k-space + block reduction,
// exchange + barrier A, acceptance, commit + barrier B's arrive
__device__ double mc_phase_cycles[9];
extern "C" int mc_phase_cycles_read(double* out) {
  return int(cudaMemcpyFromSymbol(out, mc_phase_cycles, sizeof(double) * 9));
}
#define MC_CLOCK_DECL \
  long long mc_ph[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, mc_last = clock64();
#define MC_MARK(i)                                                  \
  if (threadIdx.x == 0) {                                           \
    const long long now = clock64();                                \
    mc_ph[i] += now - mc_last;                                      \
    mc_last = now;                                                  \
  }
#define MC_CLOCK_WRITE(first, K)                                    \
  if ((first) && threadIdx.x == 0)                                  \
    for (int i = 0; i < 9; ++i)                                     \
      mc_phase_cycles[i] = double(mc_ph[i]) / double((K) > 0 ? (K) : 1);
#else
#define MC_CLOCK_DECL
#define MC_MARK(i)
#define MC_CLOCK_WRITE(first, K)
#endif

namespace {

constexpr int G_MAX = 16;   // largest cluster (non-portable above 8)
constexpr int N_PART = 4;   // d_rd, d_es, d_rec, min r^2 per rank

__host__ __device__ inline size_t seg16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Dynamic shared memory of one CTA: six column planes (seven with the
// molecular-mass plane of a quantum correction, qc; xp more in a form
// instance, form_planes) and eight k-vector planes of T, the replicated
// slot species (int32) and the alive flags of the columns and of the
// slots (bool), each segment 16-byte aligned.
template <typename T>
__host__ __device__ inline size_t slice_bytes(int nloc, int kloc, int ms,
                                              bool qc, int xp = 0) {
  return seg16(((qc ? 7 : 6) + xp) * size_t(nloc) * sizeof(T))
         + seg16(8 * size_t(kloc) * sizeof(T)) + seg16(4 * size_t(ms))
         + seg16(size_t(nloc)) + seg16(size_t(ms));
}

// The column planes a form instance adds: C6, C8, C10 under
// disp_expansion, and the GWP width under coulomb gwp (gw).
template <int F>
__host__ __device__ inline int form_planes(bool gw) {
  return (F == RD_DISP ? 3 : 0) + (F != RD_CLASSIC && gw ? 1 : 0);
}

template <typename T>
struct Slice {
  T *x, *y, *z, *q, *e, *s;            // [nloc] column planes
  T *m;                                // [nloc] molecular mass (qc), or null
  T *c6, *c8, *c10, *w;                // [nloc] a form's planes, or null
  T *kv;                               // [kloc][3]
  T *kc, *skr, *ski, *dsr, *dsi;       // [kloc]
  int32_t* ssp;                        // [ms] slot species (B1)
  bool* al;                            // [nloc] column alive
  bool* sa;                            // [ms] slot alive (B1)
};

template <typename T, int F = RD_CLASSIC>
__device__ inline Slice<T> carve_slice(int nloc, int kloc, int ms, bool qc,
                                       bool gw = false) {
  Slice<T> sl;
  unsigned char* p = dyn_smem;
  T* f = reinterpret_cast<T*>(p);
  sl.x = f;
  sl.y = f + nloc;
  sl.z = f + 2 * nloc;
  sl.q = f + 3 * nloc;
  sl.e = f + 4 * nloc;
  sl.s = f + 5 * nloc;
  sl.m = qc ? f + 6 * nloc : nullptr;
  if constexpr (F != RD_CLASSIC) {
    T* fx = f + (qc ? 7 : 6) * nloc;
    sl.c6 = sl.c8 = sl.c10 = sl.w = nullptr;
    if constexpr (F == RD_DISP) {
      sl.c6 = fx;
      sl.c8 = fx + nloc;
      sl.c10 = fx + 2 * nloc;
      fx += 3 * nloc;
    }
    if (gw) sl.w = fx;
  }
  p += seg16(((qc ? 7 : 6) + form_planes<F>(gw)) * size_t(nloc) * sizeof(T));
  f = reinterpret_cast<T*>(p);
  sl.kv = f;
  sl.kc = f + 3 * kloc;
  sl.skr = f + 4 * kloc;
  sl.ski = f + 5 * kloc;
  sl.dsr = f + 6 * kloc;
  sl.dsi = f + 7 * kloc;
  p += seg16(8 * size_t(kloc) * sizeof(T));
  sl.ssp = reinterpret_cast<int32_t*>(p);
  p += seg16(4 * size_t(ms));
  sl.al = reinterpret_cast<bool*>(p);
  p += seg16(size_t(nloc));
  sl.sa = reinterpret_cast<bool*>(p);
  return sl;
}

// Cluster barrier halves.  arrive has release and wait acquire semantics
// (the PTX defaults), so the writes a CTA makes to its shared memory before
// it arrives are visible to every CTA's reads after its wait.  Every
// thread of every CTA calls both, in uniform control flow.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A form instance's per-atom columns in device memory: C6, C8, C10
// (disp_expansion) and the GWP widths (gwp), each [n] or null.
template <typename T>
struct FormCols {
  const T *c6, *c8, *c10, *w;
};

// The moved molecule's sites' form values, read with its rows each step.
template <typename T>
struct FormRow {
  T c6, c8, c10, w;
};

// The shared-memory rows of the moved molecule's form values: declared
// here, so that only a form instance has them (a classical one: null).
template <typename T, int F>
__device__ __forceinline__ FormRow<T>* form_rows() {
  if constexpr (F == RD_CLASSIC) {
    return nullptr;
  } else {
    __shared__ FormRow<T> rows[A_PAD];
    return rows;
  }
}

// Thread t < na of a form instance: site row r's form values into fr[t].
template <typename T, int F>
__device__ __forceinline__ void load_form_row(FormRow<T>* fr, int t, int r,
                                              const FormCols<T>& fc) {
  FormRow<T> v{T(0), T(0), T(0), T(0)};
  if constexpr (F == RD_DISP) {
    v.c6 = fc.c6[r];
    v.c8 = fc.c8[r];
    v.c10 = fc.c10[r];
  }
  if (fc.w) v.w = fc.w[r];
  fr[t] = v;
}

// Load this CTA's slice: the cnt columns from base of a chain's pos [n,3]
// (split into x/y/z planes), the per-atom planes (with the molecular mass
// mm where the slice has its plane, and a form instance's columns fc)
// and alive flags, and the kcnt k-vectors from kbase with the chain's
// S(k) rows.  Once per launch.
template <typename T, int F = RD_CLASSIC>
__device__ __forceinline__ void load_slice(
    const Slice<T>& sl, const T* P, const bool* AL,
    const T* __restrict__ q, const T* __restrict__ eps,
    const T* __restrict__ sig, const T* __restrict__ mm, int base, int cnt,
    const T* __restrict__ kvec, const T* __restrict__ kcoef, const T* SKr,
    const T* SKi, int kbase, int kcnt,
    const FormCols<T> fc = FormCols<T>{}) {
  for (int jl = threadIdx.x; jl < cnt; jl += NT) {
    const int j = base + jl;
    sl.x[jl] = P[3 * j];
    sl.y[jl] = P[3 * j + 1];
    sl.z[jl] = P[3 * j + 2];
    sl.q[jl] = q[j];
    sl.e[jl] = eps[j];
    sl.s[jl] = sig[j];
    if (sl.m) sl.m[jl] = mm[j];
    if constexpr (F == RD_DISP) {
      sl.c6[jl] = fc.c6[j];
      sl.c8[jl] = fc.c8[j];
      sl.c10[jl] = fc.c10[j];
    }
    if constexpr (F != RD_CLASSIC) {
      if (sl.w) sl.w[jl] = fc.w[j];
    }
    sl.al[jl] = AL[j];
  }
  for (int kl = threadIdx.x; kl < kcnt; kl += NT) {
    const int kk = kbase + kl;
    sl.kv[3 * kl] = kvec[3 * kk];
    sl.kv[3 * kl + 1] = kvec[3 * kk + 1];
    sl.kv[3 * kl + 2] = kvec[3 * kk + 2];
    sl.kc[kl] = kcoef[kk];
    sl.skr[kl] = SKr[kk];
    sl.ski[kl] = SKi[kk];
  }
}

// The owner of global column r and its index in the owner's slice.
__device__ __forceinline__ void owner_of(int r, int nloc, int& rank,
                                         int& local) {
  rank = r / nloc;
  local = r - rank * nloc;
}

// Thread t < na: the molecule's current row start + t, read from the
// shared memory of the rank that owns it.
template <typename T>
__device__ __forceinline__ void read_row(cg::cluster_group& cluster,
                                         const Slice<T>& sl, int r,
                                         int nloc, T (&row)[3]) {
  int owner, rl;
  owner_of(r, nloc, owner, rl);
  row[0] = cluster.map_shared_rank(sl.x, owner)[rl];
  row[1] = cluster.map_shared_rank(sl.y, owner)[rl];
  row[2] = cluster.map_shared_rank(sl.z, owner)[rl];
}

// The mixed LJ parameters (eps, sig^2) of sites i and j (Lorentz-Berthelot
// or Waldman-Hagler, lj.mix).
template <typename T>
__device__ __forceinline__ void mix_pair(T ei, T si, T ej, T sj,
                                         const Opts o, T& eps, T& sig2) {
  T sig;
  if (o.mix == 0) {
    eps = x_sqrt(ei * ej);
    sig = T(0.5) * (si + sj);
  } else {
    const T s3i = si * si * si, s3j = sj * sj * sj;
    T denom = s3i * s3i + s3j * s3j;
    denom = denom > T(1e-300) ? denom : T(1e-300);
    sig = x_pow(T(0.5) * denom, T(1.0 / 6.0));
    eps = x_sqrt(ei * ej) * (T(2) * s3i * s3j / denom);
  }
  sig2 = sig * sig;
}

// The (rd, es) of a pair at squared distance r2 from the mixed (eps,
// sig^2) and qq = qi qj, the Coulomb constant left to the caller: every
// pair is evaluated, and the terms of a pair beyond rc are replaced by 0
// (selected, never multiplied), which keeps a warp's lanes together.  The
// kernels' quantum instances (QC) add the correction o.qc with the
// column's quantum_column qv, evaluated only for a pair within rc.
template <typename T, bool QC>
__device__ __forceinline__ void pair_energy_mixed(T r2, T eps, T sig2, T qq,
                                                  const Opts o, T rc, T rc2,
                                                  T alpha,
                                                  const Quantum<T>& qv,
                                                  double hb2, T& rd, T& es) {
  const bool in = r2 < rc2;
  rd = T(0);
  es = T(0);
  const T r2s = r2 > T(1e-12) ? r2 : T(1);
  if (o.rd == 1) {
    const T s2 = sig2 / r2s;
    const T s6 = s2 * s2 * s2;
    rd = T(4) * eps * s6 * (s6 - T(1));
    if (QC && in) rd += quantum_pair<T>(r2s, eps, s6, qv, hb2, o);
  }
  if (o.es != 0) {
    const T r = x_sqrt(r2s);
    if (o.es == 1) {
      es = qq * x_erfc(alpha * r) / r;
    } else if (o.es == 2) {
      es = qq * (x_erfc(alpha * r) / r - x_erfc(alpha * rc) / rc);
    } else {
      es = qq / r;
    }
  }
  rd = in ? rd : T(0);
  es = in ? es : T(0);
}

// The (rd, es) of a pair of a form instance (F != RD_CLASSIC) at squared
// distance r2, evaluated by every lane of a warp where some lane's pair
// lies within rc: rd the form's energy (rd_forms.cuh, which mixes the
// sites' eps and sig itself; FORM_GWP the LJ of the classical instances,
// under o.rd 1) from site i's (ei, si, fi) and column j's (ej, sj, c6j,
// c8j, c10j, wj), o.rd disp_expansion's damping flag; es the Coulomb term
// of o.es (4: the GWP smear of the widths), qq = qi qj, the constant left
// to the caller.  The caller selects both where the pair is within rc
// (never a multiply: Dreiding's p^-6, b14_7's p^7 and sg's floored r
// must not reach a sum from outside rc).  FORM_GWP's quantum instance
// (QC) adds the correction o.qc to its LJ with the column's
// quantum_column qv, as pair_energy_mixed does.
template <typename T, int F, bool QC = false>
__device__ __forceinline__ void pair_energy_form(
    T r2, T ei, T si, const FormRow<T>& fi, T ej, T sj, T c6j, T c8j,
    T c10j, T wj, T qq, const Opts o, T rc, T alpha, const Quantum<T>& qv,
    double hb2, T& rd, T& es) {
  static_assert(!QC || F == FORM_GWP,
                "only FORM_GWP's LJ carries a quantum correction");
  const T r2s = r2 > T(1e-12) ? r2 : T(1);
  const T r = x_sqrt(r2s);
  rd = T(0);
  es = T(0);
  if constexpr (F == FORM_GWP) {
    if (o.rd == 1) {
      T eps, sig2;
      mix_pair<T>(ei, si, ej, sj, o, eps, sig2);
      const T s2 = sig2 / r2s;
      const T s6 = s2 * s2 * s2;
      rd = T(4) * eps * s6 * (s6 - T(1));
      if constexpr (QC) rd += quantum_pair<T>(r2s, eps, s6, qv, hb2, o);
    }
  } else {
    T c6 = T(0), c8 = T(0), c10 = T(0);
    if constexpr (F == RD_DISP) {
      c6 = disp_mix(fi.c6, c6j);
      c8 = disp_mix(fi.c8, c8j);
      c10 = disp_mix(fi.c10, c10j);
    }
    rd = rd_form<T, F>(r, ei, ej, si, sj, c6, c8, c10, o.rd != 0);
  }
  if (o.es == 1) {
    es = qq * x_erfc(alpha * r) / r;
  } else if (o.es == 2) {
    es = qq * (x_erfc(alpha * r) / r - x_erfc(alpha * rc) / rc);
  } else if (o.es == 3) {
    es = qq / r;
  } else if (o.es == 4) {
    es = qq * gwp_smear(r, fi.w, wj) / r;
  }
}

// The minimum-image r^2 of row p against column (xj, yj, zj).
template <typename T>
__device__ __forceinline__ T row_r2(const T* p, T xj, T yj, T zj,
                                    const T* s_box, const T* s_bi,
                                    const Opts o) {
  T rx, ry, rz;
  min_image<T>(p[0] - xj, p[1] - yj, p[2] - zj, s_box, s_bi, o.ortho, rx, ry,
               rz);
  return rx * rx + ry * ry + rz * rz;
}

// slice_pass of a form instance: the same sums, with the pair terms of
// pair_energy_form evaluated only where some lane of the warp has a pair
// within rc (a warp vote), so the block walks its columns in uniform
// rounds of NT (a lane past cnt, on a dead column or on one of the
// molecule's own rows takes part in the votes and adds nothing).  FORM_GWP's
// quantum instance (QC) takes each column's quantum_column once, as
// slice_pass does.
template <typename T, int F, bool QC = false>
__device__ __forceinline__ void slice_pass_form(
    const Slice<T>& sl, int base, int cnt, int start, int na, bool has_old,
    bool has_new, const T (*s_old)[3], const T (*s_new)[3], const T* s_ei,
    const T* s_si, const T* s_qi, const FormRow<T>* s_fi, const T* s_box,
    const T* s_bi, const Opts o, T rc, T rc2, T alpha, T mm_i, T beta,
    T temp, double hb2, double& a_rd, double& a_es, T& mn) {
  for (int j0 = 0; j0 < cnt; j0 += NT) {
    const int jl = j0 + int(threadIdx.x);
    const int jc = base + jl;
    const bool ok = jl < cnt && sl.al[jl] && !(jc >= start && jc < start + na);
    if (!__any_sync(FULL, ok)) continue;   // warp-uniform
    const int jr = jl < cnt ? jl : 0;
    const T xj = sl.x[jr], yj = sl.y[jr], zj = sl.z[jr];
    const T qj = sl.q[jr], ej = sl.e[jr], sj = sl.s[jr];
    T c6j = T(0), c8j = T(0), c10j = T(0);
    if constexpr (F == RD_DISP) {
      c6j = sl.c6[jr];
      c8j = sl.c8[jr];
      c10j = sl.c10[jr];
    }
    const T wj = sl.w ? sl.w[jr] : T(0);
    Quantum<T> qv{};
    if constexpr (QC)
      qv = quantum_column<T>(mm_i, sl.m[jr], beta, temp, hb2, o);
#pragma unroll
    for (int a = 0; a < A_PAD; ++a) {
      if (a >= na) break;
      const T qq = s_qi[a] * qj;
      if (has_old) {
        const T r2 = row_r2<T>(s_old[a], xj, yj, zj, s_box, s_bi, o);
        const bool in = ok && r2 < rc2;
        T rd = T(0), es = T(0);
        if (__any_sync(FULL, in))
          pair_energy_form<T, F, QC>(r2, s_ei[a], s_si[a], s_fi[a], ej, sj,
                                     c6j, c8j, c10j, wj, qq, o, rc, alpha,
                                     qv, hb2, rd, es);
        a_rd -= in ? double(rd) : 0.0;
        a_es -= in ? double(es) : 0.0;
      }
      if (has_new) {
        const T r2 = row_r2<T>(s_new[a], xj, yj, zj, s_box, s_bi, o);
        const bool in = ok && r2 < rc2;
        T rd = T(0), es = T(0);
        if (__any_sync(FULL, in))
          pair_energy_form<T, F, QC>(r2, s_ei[a], s_si[a], s_fi[a], ej, sj,
                                     c6j, c8j, c10j, wj, qq, o, rc, alpha,
                                     qv, hb2, rd, es);
        a_rd += in ? double(rd) : 0.0;
        a_es += in ? double(es) : 0.0;
        mn = ok ? x_min(mn, r2) : mn;
      }
    }
  }
}

// This thread's share of one molecule's old+new pass over the CTA's slice:
// the local columns jl = t, t + NT, ... < cnt (global base + jl) that are
// alive and not the molecule's own rows [start, start + na), against its
// current rows s_old (has_old) and its trial rows s_new (has_new).  Adds
// new - old to a_rd and a_es, and takes the closest approach of the trial
// rows into mn.  The LJ mixing of site a with column j is computed once,
// for both rows (mix_pair), and in a quantum instance (QC) the column's
// reduced mass with the molecule (mass mm_i) and prefactors at beta
// (temperature temp) once for every site (quantum_column).  A form
// instance (F, slice_pass_form) takes the site rows' form values s_fi;
// of the forms only FORM_GWP (rd lj) has a quantum instance.
template <typename T, bool QC, int F = RD_CLASSIC>
__device__ __forceinline__ void slice_pass(
    const Slice<T>& sl, int base, int cnt, int start, int na, bool has_old,
    bool has_new, const T (*s_old)[3], const T (*s_new)[3], const T* s_ei,
    const T* s_si, const T* s_qi, const T* s_box, const T* s_bi,
    const Opts o, T rc, T rc2, T alpha, T mm_i, T beta, T temp, double hb2,
    double& a_rd, double& a_es, T& mn, const FormRow<T>* s_fi = nullptr) {
  if constexpr (F != RD_CLASSIC) {
    slice_pass_form<T, F, QC>(sl, base, cnt, start, na, has_old, has_new,
                              s_old, s_new, s_ei, s_si, s_qi, s_fi, s_box,
                              s_bi, o, rc, rc2, alpha, mm_i, beta, temp, hb2,
                              a_rd, a_es, mn);
    return;
  }
  for (int jl = threadIdx.x; jl < cnt; jl += NT) {
    const int jc = base + jl;
    if (!sl.al[jl] || (jc >= start && jc < start + na)) continue;
    const T xj = sl.x[jl], yj = sl.y[jl], zj = sl.z[jl];
    const T qj = sl.q[jl], ej = sl.e[jl], sj = sl.s[jl];
    Quantum<T> qv{};
    if (QC) qv = quantum_column<T>(mm_i, sl.m[jl], beta, temp, hb2, o);
#pragma unroll
    for (int a = 0; a < A_PAD; ++a) {
      if (a >= na) break;
      T eps_m, sig2_m, r2, rd, es;
      mix_pair<T>(s_ei[a], s_si[a], ej, sj, o, eps_m, sig2_m);
      const T qq = s_qi[a] * qj;
      if (has_old) {
        r2 = row_r2<T>(s_old[a], xj, yj, zj, s_box, s_bi, o);
        pair_energy_mixed<T, QC>(r2, eps_m, sig2_m, qq, o, rc, rc2, alpha,
                                 qv, hb2, rd, es);
        a_rd -= double(rd);
        a_es -= double(es);
      }
      if (has_new) {
        r2 = row_r2<T>(s_new[a], xj, yj, zj, s_box, s_bi, o);
        pair_energy_mixed<T, QC>(r2, eps_m, sig2_m, qq, o, rc, rc2, alpha,
                                 qv, hb2, rd, es);
        a_rd += double(rd);
        a_es += double(es);
        mn = x_min(mn, r2);
      }
    }
  }
}

// After block_reduce: thread 0 folds the warps' partials (block_totals)
// and threads 0..G-1 push them into slot [rank] of CTA t's exchange half
// xch; then barrier A.  Returns with every CTA's xch holding the G
// partials of this step.
template <typename T>
__device__ __forceinline__ void exchange_partials(
    cg::cluster_group& cluster, const double (*s_red)[NW], const T* s_min,
    double* s_part, double (*xch)[N_PART], int rank, int G) {
  if (threadIdx.x == 0) {
    double drd, des, drec;
    T mr2;
    block_totals<T>(s_red, s_min, drd, des, drec, mr2);
    s_part[0] = drd;
    s_part[1] = des;
    s_part[2] = drec;
    s_part[3] = double(mr2);   // exact for float and double
  }
  __syncthreads();
  if (threadIdx.x < G) {
    double* dst = cluster.map_shared_rank(&xch[rank][0], threadIdx.x);
#pragma unroll
    for (int i = 0; i < N_PART; ++i) dst[i] = s_part[i];
  }
  cluster_arrive();
  cluster_wait();
}

// Thread 0, after exchange_partials: the G partials added in rank order.
template <typename T>
__device__ __forceinline__ void cluster_totals(const double (*xch)[N_PART],
                                               int G, double& drd,
                                               double& des, double& drec,
                                               T& mr2) {
  drd = 0.0;
  des = 0.0;
  drec = 0.0;
  mr2 = T(INFINITY);
  for (int r = 0; r < G; ++r) {
    drd += xch[r][0];
    des += xch[r][1];
    drec += xch[r][2];
    mr2 = x_min(mr2, T(xch[r][3]));
  }
}

// ---- B6 (pda_kernel.cu): the same slice with the polar planes, and an
// exchange of a wider partial vector.  B1 and B3 use neither.

// Dynamic shared memory of one B6 CTA: slice_bytes' layout (xp: a form
// instance's planes), then four more column planes of T (polarizability
// and the static field e0 x/y/z).
template <typename T>
__host__ __device__ inline size_t polar_slice_bytes(int nloc, int kloc,
                                                    int ms, bool qc,
                                                    int xp = 0) {
  return slice_bytes<T>(nloc, kloc, ms, qc, xp)
         + seg16(4 * size_t(nloc) * sizeof(T));
}

template <typename T>
struct PolarPlanes {
  T *p, *ex, *ey, *ez;                 // [nloc] polar, e0 x / y / z
};

template <typename T>
__device__ inline PolarPlanes<T> carve_polar(int nloc, int kloc, int ms,
                                             bool qc, int xp = 0) {
  T* f = reinterpret_cast<T*>(dyn_smem
                              + slice_bytes<T>(nloc, kloc, ms, qc, xp));
  return PolarPlanes<T>{f, f + nloc, f + 2 * nloc, f + 3 * nloc};
}

// Load this CTA's polar planes: the cnt columns from base of polar [n] and
// e0 [n,3].  Once per launch.
template <typename T>
__device__ __forceinline__ void load_polar(const PolarPlanes<T>& pl,
                                           const T* __restrict__ polar,
                                           const T* __restrict__ e0,
                                           int base, int cnt) {
  for (int jl = threadIdx.x; jl < cnt; jl += NT) {
    const int j = base + jl;
    pl.p[jl] = polar[j];
    pl.ex[jl] = e0[3 * j];
    pl.ey[jl] = e0[3 * j + 1];
    pl.ez[jl] = e0[3 * j + 2];
  }
}

// Every thread: the nv values of src (this CTA's partial vector, in its
// shared memory) into row [rank] of every CTA's exchange half xch (G rows
// of stride w doubles), one value per thread at a time; then one cluster
// barrier.  Returns with every CTA's xch holding the G partial vectors.
// B1 and B3 keep exchange_partials: their 4 values come from thread 0's
// fold of the warps and go out one destination CTA per thread, with no
// index arithmetic; spreading G x nv values over every thread is what
// B6's vector of up to 53 needs, and would only add work to theirs.
__device__ __forceinline__ void exchange_vector(cg::cluster_group& cluster,
                                                const double* src, int nv,
                                                double* xch, int w, int rank,
                                                int G) {
  for (int i = threadIdx.x; i < G * nv; i += NT) {
    const int dst = i / nv, e = i - dst * nv;
    cluster.map_shared_rank(xch, dst)[rank * w + e] = src[e];
  }
  cluster_arrive();
  cluster_wait();
}

// Host side: set the kernel's dynamic shared memory and (G > 8) the
// non-portable cluster size.  Returns a CUDA error code.
template <typename Kern>
inline cudaError_t cluster_attributes(Kern kern, int G, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  if (G > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// Host side: fill a launch configuration of C clusters of G CTAs.
inline void cluster_launch(int C, int G, size_t smem, cudaStream_t stream,
                           cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(unsigned(C * G));
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Host side: cluster_attributes, then cluster_launch.
template <typename Kern>
inline cudaError_t cluster_config(Kern kern, int C, int G, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr,
                                  cudaLaunchConfig_t* cfg) {
  const cudaError_t e = cluster_attributes(kern, G, smem);
  if (e != cudaSuccess) return e;
  cluster_launch(C, G, smem, stream, attr, cfg);
  return cudaSuccess;
}

// Host side: launch kern on C clusters of G CTAs with smem bytes of dynamic
// shared memory each (cluster_config), with the kernel's arguments.
template <typename Kern, typename... Args>
inline int cluster_run(Kern kern, int C, int G, size_t smem,
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(kern, C, G, smem, stream, attr, &cfg);
  if (e != cudaSuccess) return int(e);
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// Host side: how many clusters of G CTAs with smem bytes each can be
// resident on the card at once (0: the shape cannot launch).
template <typename Kern>
inline int cluster_occupancy(Kern kern, int G, size_t smem, int* clusters) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(kern, 1, G, smem, 0, attr, &cfg);
  if (e != cudaSuccess) return int(e);
  return int(cudaOccupancyMaxActiveClusters(clusters, kern, &cfg));
}

}  // namespace
