// Pair-pass kernels of the GCMC main path, hand-written for Hopper (sm_90a):
// the bodies of B2 and B4, templated on the type and the RD form.
// pair_kernel.cu builds the classical instance (rd none or lj, read at run
// time), pair_sg_kernel.cu, pair_dreiding_kernel.cu, pair_b14_7_kernel.cu
// and pair_disp_kernel.cu one other form each (the RD forms of
// mpmc_tpu/ops/potentials.py: sg, dreiding, b14_7, disp_expansion).
//
// B2 pair_terms  replaces mpmc_tpu/ops/pallas/pair_kernel.py::_kernel
//   (pair_terms_tiles / pair_pass_pallas): the triangular i<j pass over all
//   atoms, optionally restricted to rows >= row_start (the per-corrtime
//   refresh): every pair i >= row_start with j > i or j < row_start.
//   Bound: FP32 (FP64) ALU and SFU work per pair - the minimum image, one
//   reciprocal square root, erfc, the LJ and tail terms - on ~5.8e7 pairs
//   at N = 10.8k (7.4e6 at the refresh's row_start), against 0.3 MB of
//   inputs.  Design, for that bound:
//   - A tile is TI rows x TJ columns.  The tiles that hold a counted pair
//     form a work list (the upper triangle from row_start's row tile on,
//     plus every column tile below row_start; int32 I * nt + J, row-major),
//     which depends only on (n, row_start): the wrapper builds it once.  A
//     persistent grid of as many CTAs as the card holds walks it, CTA b
//     taking list positions b, b + grid, ...: the rows of a loading's
//     live slots lie in a few row tiles, whose tiles are adjacent in the
//     list, and the stride spreads them over every CTA.
//   - A thread owns R rows of the tile (register blocking: each column
//     read from shared memory serves R pairs); the NT2 threads cover the
//     TI rows NT2 R / TI times, each split walking its share of the
//     tile's columns.
//   - The pair body is branch-free: selects replace the per-pair test and
//     the intra/inter branch; the reciprocals come from one rsqrt, the
//     minimum image's rounding from the adder (frac_image), the LJ mixing
//     from per-site sqrt(eps) and sig / 2.  Warp-uniform votes skip what no
//     lane of the warp needs: a column with no counted pair (a dead
//     column, a tile's lower triangle), the LJ and Coulomb terms where no
//     lane's pair lies within rc, and erf (the exclusion term) where no
//     lane's pair is intra-molecular.
//   - One launch: each listed tile's double partials go to their own slot
//     (its position in the list); the CTA that finishes last (an atomic
//     ticket, after a __threadfence) adds the slots in a fixed order and
//     writes the nine sums - identical bits run to run, for any grid.
//
// B4 mol_pair    replaces mpmc_tpu/ops/pallas/pair_kernel.py::_mol_kernel
//   (mol_pair_tiles / mol_pair_pass_pallas): one molecule's <= 8 rows
//   against every column.  Bound: launch latency - at A = 3 and N = 10.8k
//   the whole pass is ~32k pairs, 43 blocks of 256 threads.  The rows are
//   gathered by the kernel itself (mol_atoms[mol], mol read from device
//   memory), so the wrapper issues no copies and no host sync per move.
//   One launch: the block that finishes last (an atomic ticket, after a
//   __threadfence) reduces every block's partials itself.
//   Over C chains (the batched scan chains; the reference vmaps
//   _mol_kernel over them) the chain is the grid's y axis: chain c reads
//   its own positions, aliveness, molecule index and trial rows (the
//   parameter columns are shared), has its own partial slots and its own
//   ticket, and its last block reduces them in the one-chain order - so
//   C = 1 is the one-chain launch, bit for bit.  At C = 128 on the 10.8k
//   system the pass is ~4.1e6 pairs: ~5 us of operations, ~5 us of
//   position planes (16.6 MB) - both near the launch floor.
//
// Both: per-tile (B2) or per-block (B4) partials in double, reduced by the
// last CTA in a fixed order - identical results run to run.  Templated on
// float and double.  Semantics follow the reference
// (ops/pairs.py jnp path): exact erfc/erf, half-to-even rint in the
// minimum image, the r2 > 1e-12 guard, and per-term masks (rd/es over
// inter pairs within rc, es_excl over intra pairs, the LRC coefficient
// over inter pairs at any distance, min_r2 over non-frozen-frozen inter
// pairs at any distance).  The Coulomb constant is applied by the caller.
//
// The other RD forms: a form's energy is computed only within rc (B2: where
// some lane of the warp has a pair within rc; B4: per pair), with the exact
// r = sqrt(r2) and exp/pow, and masked by selects, so that an overflow
// outside rc (dreiding's p^-6, b14_7's p^7 at short range) reaches no sum;
// disp_expansion's tail coefficient, from the three geometric means of
// C6, C8, C10, over every inter pair at any r, as the LJ tail.
//
// Scalar header scal[20] in device memory: rc, alpha, box (3x3 row-major,
// rows are cell vectors), box^-1 (3x3 row-major).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_math.cuh"

namespace {

constexpr int TI = 128;    // B2: rows per tile
constexpr int TJ = 128;    // B2: columns per tile
constexpr int R2 = 2;      // B2: rows per thread
constexpr int NT2 = 256;   // B2: threads per CTA
constexpr int GR = TI / R2;          // B2: threads per column split
constexpr int CS2 = TJ * GR / NT2;   // B2: columns per split
constexpr int NW2 = NT2 / 32;
// B2: CTAs per SM the registers must allow in float (double: half of it),
// 64 registers a thread at 256 threads
constexpr int MINB2 = 4;
static_assert(GR % 32 == 0, "a warp must lie in one column split");
static_assert(NT2 % GR == 0 && TJ % (NT2 / GR) == 0, "bad column split");
static_assert(NT2 >= 9 && NT2 <= 1024, "bad CTA");
constexpr int MT = 256;    // B4: columns per block
constexpr int A_PAD = 8;   // B4: most rows per molecule
constexpr int RT = 256;    // B4: threads of the partial reduction

// The RD form, a template parameter of both kernels: the classical instance
// reads rd none or lj from Opts at run time (pair_kernel.cu); each other
// form is an instance of its own (pair_<form>_kernel.cu), so that no form
// costs another registers.
constexpr int RD_CLASSIC = 0;
constexpr int RD_SG = 2;         // Silvera-Goldman H2-H2
constexpr int RD_DREIDING = 3;   // Dreiding exponential-6
constexpr int RD_B14_7 = 4;      // Halgren's buffered 14-7
constexpr int RD_DISP = 5;       // Born-Mayer + C6/C8/C10 dispersion

struct Opts {
  int rd;    // classical: 0 none, 1 lj; RD_DISP: 1 damps the dispersion
  int mix;   // 0 lorentz-berthelot, 1 waldman-hagler
  int es;    // 0 none, 1 ewald, 2 wolf, 3 cutoff
  int lrc;   // 1: the tail coefficient (LJ, or RD_DISP's)
};

// ---------------------------------------------------------------- RD forms
// The formulas of mpmc_tpu/ops/potentials.py (and of the plain versions,
// mpmc_tpu_torch/ops/potentials.py), operation for operation: the
// constants in double, then in T; integer powers by repeated squaring in
// the reference's order (x^3 = x x^2, x^7 = (x x^2) x^4); a real power by
// pow; exp, pow and sqrt exact (no fast-math).

template <typename T>
__device__ __forceinline__ T ipow3(T x) { return x * (x * x); }

template <typename T>
__device__ __forceinline__ T ipow7(T x) {
  const T x2 = x * x;
  const T x4 = x2 * x2;
  return (x * x2) * x4;
}

// Silvera-Goldman, r in A, in K; r floored at 0.3 bohr, where the float
// dispersion sum would overflow while the damping underflows to 0.
template <typename T>
__device__ __forceinline__ T sg_energy(T r_ang) {
  constexpr double bohr = 0.529177210903;
  constexpr double hartree_k = 4.3597447222071e-18 / 1.380649e-23;
  const T r = x_max(r_ang, T(0.3 * bohr)) / T(bohr);
  const T rep = x_exp(T(1.713) - T(1.5671) * r - T(0.00993) * r * r);
  const T r2 = r * r;
  const T r6 = r2 * r2 * r2;
  const T disp = T(12.14) / r6 + T(215.2) / (r6 * r2)
                 + T(4813.9) / (r6 * r2 * r2) - T(143.1) / (r6 * r2 * r);
  const T u = T(8.32) / r - T(1);
  const T fc = r < T(8.32) ? x_exp(-(u * u)) : T(1);
  return (rep - fc * disp) * T(hartree_k);
}

// The Tang-Toennies factors f_6, f_8, f_10 of x = B r under one exp(-x)
// and one running sum: the reference's tt_damping(x, n) sums the terms
// x^k / k! for k = 1..n in order, each term the previous times x over k,
// so its sums for n = 6 and 8 are this sum's values after k = 6 and 8 -
// the same operations in the same order, hence the same values.
template <typename T>
__device__ __forceinline__ void tt_damping3(T x, T& f6, T& f8, T& f10) {
  const T e = x_exp(-x);
  T s = T(1), term = T(1);
#pragma unroll
  for (int k = 1; k <= 10; ++k) {
    term = term * x / T(k);
    s = s + term;
    if (k == 6) f6 = T(1) - e * s;
    if (k == 8) f8 = T(1) - e * s;
  }
  f10 = T(1) - e * s;
}

// The RD energy of one pair of a form (not RD_CLASSIC), r = |r_ij| > 0,
// from the two sites' eps and sig columns and, for RD_DISP, the mixed
// C6, C8, C10; the mixing rules of potentials.rd_pair_energy_generic.
template <typename T, int RD>
__device__ __forceinline__ T rd_form(T r, T ei, T ej, T si, T sj, T c6,
                                     T c8, T c10, bool damp) {
  if constexpr (RD == RD_SG) {
    return sg_energy(r);
  } else if constexpr (RD == RD_DREIDING) {
    constexpr double zeta = 13.772;
    const T d0 = x_sqrt(ei * ej);
    const T r0 = x_max(T(0.5) * (si + sj), T(1e-6));
    const T p = r / r0;
    return d0 * (T(6.0 / (zeta - 6.0)) * x_exp(T(zeta) * (T(1) - p))
                 - T(zeta / (zeta - 6.0)) * x_pow(p, T(-6)));
  } else if constexpr (RD == RD_B14_7) {
    const T r0 = x_max((ipow3(si) + ipow3(sj))
                       / x_max(si * si + sj * sj, T(1e-12)), T(1e-6));
    const T sq = x_sqrt(ei) + x_sqrt(ej);
    const T eps = T(4) * ei * ej / x_max(sq * sq, T(1e-12));
    const T p = r / r0;
    const T t = ipow7(T(1.0 + 0.07) / (p + T(0.07)));
    return eps * t * (T(1.0 + 0.12) / (ipow7(p) + T(0.12)) - T(2));
  } else {
    static_assert(RD == RD_DISP, "unknown RD form");
    const T a = x_sqrt(x_max(ei * ej, T(0)));
    const T b = T(2) * si * sj / x_max(si + sj, T(1e-12));
    const T rep = a * x_exp(-b * r);
    const T r2 = r * r;
    const T r6 = r2 * r2 * r2;
    T f6 = T(1), f8 = T(1), f10 = T(1);
    if (damp) tt_damping3(b * r, f6, f8, f10);
    return rep - f6 * c6 / r6 - f8 * c8 / (r6 * r2)
           - f10 * c10 / (r6 * r2 * r2);
  }
}

// The geometric mean of a dispersion coefficient, sqrt(max(ci cj, 0)).
template <typename T>
__device__ __forceinline__ T disp_mix(T ci, T cj) {
  return x_sqrt(x_max(ci * cj, T(0)));
}

// The dispersion expansion's tail coefficient of a pair,
// -4 pi [C6 / (3 rc^3) + C8 / (5 rc^5) + C10 / (7 rc^7)].
template <typename T>
__device__ __forceinline__ T disp_tail(T c6, T c8, T c10, T rc) {
  const T rc3 = rc * rc * rc;
  const T rc5 = rc3 * rc * rc;
  const T rc7 = rc5 * rc * rc;
  return T(-4.0 * 3.14159265358979323846)
         * (c6 / (T(3) * rc3) + c8 / (T(5) * rc5) + c10 / (T(7) * rc7));
}

// One pair: minimum-image r2 and the unmasked term values (a form's RD
// energy only within rc; c6i..c10j its C columns, RD_DISP only).
template <typename T, int RD>
__device__ __forceinline__ void pair_eval(
    T xi, T yi, T zi, T qi, T ei, T si, T xj, T yj, T zj, T qj, T ej, T sj,
    const T* __restrict__ sc, const Opts o,
    T& r2, T& rd, T& es, T& ex, T& tc, T c6i, T c8i, T c10i, T c6j, T c8j,
    T c10j) {
  const T* box = sc + 2;
  const T* bi = sc + 11;
  const T dx = xi - xj, dy = yi - yj, dz = zi - zj;
  T f0 = dx * bi[0] + dy * bi[3] + dz * bi[6];
  T f1 = dx * bi[1] + dy * bi[4] + dz * bi[7];
  T f2 = dx * bi[2] + dy * bi[5] + dz * bi[8];
  f0 -= x_rint(f0);   // rint: half to even, like jnp.round / torch.round
  f1 -= x_rint(f1);
  f2 -= x_rint(f2);
  const T rx = f0 * box[0] + f1 * box[3] + f2 * box[6];
  const T ry = f0 * box[1] + f1 * box[4] + f2 * box[7];
  const T rz = f0 * box[2] + f1 * box[5] + f2 * box[8];
  r2 = rx * rx + ry * ry + rz * rz;
  const T r2s = r2 > T(1e-12) ? r2 : T(1);
  const T r = x_sqrt(r2s);
  const T rc = sc[0], alpha = sc[1];
  rd = T(0); tc = T(0); es = T(0); ex = T(0);
  if constexpr (RD == RD_CLASSIC) {
    if (o.rd == 1) {
      T eps, sig;
      if (o.mix == 0) {
        eps = x_sqrt(ei * ej);
        sig = T(0.5) * (si + sj);
      } else {
        const T s3i = si * si * si, s3j = sj * sj * sj;
        T denom = s3i * s3i + s3j * s3j;
        // jnp.maximum(x, 1e-300): the bound is 0 in float, as in the reference
        denom = denom > T(1e-300) ? denom : T(1e-300);
        sig = x_pow(T(0.5) * denom, T(1.0 / 6.0));
        eps = x_sqrt(ei * ej) * (T(2) * s3i * s3j / denom);
      }
      const T s2 = sig * sig / r2s;
      const T s6 = s2 * s2 * s2;
      rd = T(4) * eps * s6 * (s6 - T(1));
      if (o.lrc) {
        const T src = sig / rc;
        const T s3 = src * src * src;
        const T s9 = s3 * s3 * s3;
        tc = T(16.0 * 3.14159265358979323846 / 3.0) * eps * (sig * sig * sig)
             * (s9 / T(3) - s3);
      }
    }
  } else {
    T c6 = T(0), c8 = T(0), c10 = T(0);
    if constexpr (RD == RD_DISP) {
      c6 = disp_mix(c6i, c6j);
      c8 = disp_mix(c8i, c8j);
      c10 = disp_mix(c10i, c10j);
      if (o.lrc) tc = disp_tail(c6, c8, c10, rc);
    }
    if (r2 < rc * rc) rd = rd_form<T, RD>(r, ei, ej, si, sj, c6, c8, c10,
                                          o.rd != 0);
  }
  const T qq = qi * qj;
  if (o.es == 1) {
    es = qq * x_erfc(alpha * r) / r;
    ex = -qq * x_erf(alpha * r) / r;
  } else if (o.es == 2) {
    es = qq * (x_erfc(alpha * r) / r - x_erfc(alpha * rc) / rc);
  } else if (o.es == 3) {
    es = qq / r;
  }
}

// Tree-reduce K per-thread sums (in double) and a min over NT threads,
// then thread 0 writes the block's partials.
template <typename T, int NT, int K>
__device__ __forceinline__ void block_partials(
    const T (&acc)[K], T mn, double (*red)[NT], T* rmin,
    double* __restrict__ part, T* __restrict__ pmin, int bid) {
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < K; ++s) red[s][t] = double(acc[s]);
  rmin[t] = mn;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int s = 0; s < K; ++s) red[s][t] += red[s][t + w];
      rmin[t] = x_min(rmin[t], rmin[t + w]);
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) part[size_t(bid) * K + s] = red[s][0];
    pmin[bid] = rmin[0];
  }
}

// ---------------------------------------------------------------- B2
// Warp shuffles of the nine sums (eight in double and a minimum), then the
// warps' values added in order by threads 0..8 into dst (eight) and *dmin.
// Every thread calls it; ends with a barrier.
template <typename T>
__device__ __forceinline__ void sums_to(double (&a)[8], T mn,
                                        double (*wred)[8], T* wmin,
                                        double* dst, T* dmin) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a[s] += __shfl_down_sync(0xffffffffu, a[s], off);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mn = x_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < 8; ++s) wred[warp][s] = a[s];
    wmin[warp] = mn;
  }
  __syncthreads();
  if (t < 8) {
    double x = 0.0;
    for (int w = 0; w < NW2; ++w) x += wred[w][t];
    dst[t] = x;
  } else if (t == 8) {
    T m = T(INFINITY);
    for (int w = 0; w < NW2; ++w) m = x_min(m, wmin[w]);
    *dmin = m;
  }
  __syncthreads();
}

// Column planes in shared memory: sqrt(eps) and sig / 2 (the mixing's
// halves; a form's instance: eps and sig), RD_DISP's C6, C8, C10, and
// flags: bit 0 alive (and j < n), bit 1 frozen.  The C columns c6, c8,
// c10 come last, so that the classical instance (which reads none) keeps
// its parameters where they were.
template <typename T, int RD>
__global__ void __launch_bounds__(NT2, sizeof(T) == 4 ? MINB2 : MINB2 / 2)
    pair_terms_kernel(const T* __restrict__ pos, const T* __restrict__ q,
                      const T* __restrict__ eps, const T* __restrict__ sig,
                      const int32_t* __restrict__ mol,
                      const bool* __restrict__ alive,
                      const bool* __restrict__ frozen,
                      const T* __restrict__ sc,
                      const int32_t* __restrict__ wl, int W, int nt, int n,
                      int row_start, Opts o, double* __restrict__ part,
                      T* __restrict__ pmin, int32_t* __restrict__ ticket,
                      T* __restrict__ out, const T* __restrict__ c6,
                      const T* __restrict__ c8, const T* __restrict__ c10) {
  __shared__ T sx[TJ], sy[TJ], sz[TJ], sq[TJ], se[TJ], sh[TJ];
  __shared__ T cc6[TJ], cc8[TJ], cc10[TJ];
  __shared__ int32_t sm[TJ];
  __shared__ unsigned char sfl[TJ];
  __shared__ double wred[NW2][8];
  __shared__ T wmin[NW2];
  __shared__ int last;
  const int t = threadIdx.x;
  const int g = t % GR;           // rows g, g + GR, ... of the tile
  const int h = t / GR;           // column split
  const T rc = sc[0], alpha = sc[1];
  const T rc2 = rc * rc;
  const T wolf_shift = x_erfc(alpha * rc) / rc;
  // the LJ tail of a pair, (16 pi / 3) eps sig^3 ((sig / rc)^9 / 3 -
  // (sig / rc)^3), as C eps sig^6 (sig^6 a3 - b3)
  const T b3 = T(1) / (rc * rc * rc);
  const T a3 = b3 * b3 * b3 / T(3);
  const T c16 = T(16.0 * 3.14159265358979323846 / 3.0);
  T box[9], bi[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    box[e] = sc[2 + e];
    bi[e] = sc[11 + e];
  }
  T xi[R2], yi[R2], zi[R2], qi[R2], ei[R2], hi[R2];
  T c6i[R2], c8i[R2], c10i[R2];
  int32_t mi[R2];
  int ri[R2];
  bool iok[R2], fi[R2];
  int cur = -1;
  for (int qq = blockIdx.x; qq < W; qq += gridDim.x) {
    const int tile = wl[qq];
    const int I = tile / nt;
    const int J = tile - I * nt;
    if (I != cur) {
      cur = I;
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        const int i = I * TI + g + r * GR;
        const bool in = i < n;
        ri[r] = i;
        iok[r] = in && i >= row_start && alive[i];
        xi[r] = in ? pos[3 * i] : T(0);
        yi[r] = in ? pos[3 * i + 1] : T(0);
        zi[r] = in ? pos[3 * i + 2] : T(0);
        qi[r] = in ? q[i] : T(0);
        if constexpr (RD == RD_CLASSIC) {
          ei[r] = in ? x_sqrt(eps[i]) : T(0);
          hi[r] = in ? T(0.5) * sig[i] : T(0);
        } else {
          ei[r] = in ? eps[i] : T(0);
          hi[r] = in ? sig[i] : T(0);
        }
        if constexpr (RD == RD_DISP) {
          c6i[r] = in ? c6[i] : T(0);
          c8i[r] = in ? c8[i] : T(0);
          c10i[r] = in ? c10[i] : T(0);
        }
        mi[r] = in ? mol[i] : -1;
        fi[r] = in && frozen[i];
      }
    }
    __syncthreads();    // the previous tile's columns are consumed
    for (int c = t; c < TJ; c += NT2) {
      const int j = J * TJ + c;
      const bool in = j < n;
      sx[c] = in ? pos[3 * j] : T(0);
      sy[c] = in ? pos[3 * j + 1] : T(0);
      sz[c] = in ? pos[3 * j + 2] : T(0);
      sq[c] = in ? q[j] : T(0);
      if constexpr (RD == RD_CLASSIC) {
        se[c] = in ? x_sqrt(eps[j]) : T(0);
        sh[c] = in ? T(0.5) * sig[j] : T(0);
      } else {
        se[c] = in ? eps[j] : T(0);
        sh[c] = in ? sig[j] : T(0);
      }
      if constexpr (RD == RD_DISP) {
        cc6[c] = in ? c6[j] : T(0);
        cc8[c] = in ? c8[j] : T(0);
        cc10[c] = in ? c10[j] : T(0);
      }
      sm[c] = in ? mol[j] : -1;
      sfl[c] = (in && alive[j] ? 1 : 0) | (in && frozen[j] ? 2 : 0);
    }
    __syncthreads();
    T acc[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[s] = T(0);
    T mn = T(INFINITY);
    const int k0 = h * CS2;
    for (int k = k0; k < k0 + CS2; ++k) {
      const int j = J * TJ + k;
      const int fl = sfl[k];
      bool valid[R2];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        valid[r] = iok[r] && (fl & 1) && (j > ri[r] || j < row_start);
        any |= valid[r];
      }
      // warp-uniform: every lane skips a column none of them counts
      if (!__any_sync(0xffffffffu, any)) continue;
      const T xj = sx[k], yj = sy[k], zj = sz[k], qj = sq[k], ej = se[k],
              hj = sh[k];
      const int32_t mj = sm[k];
      const bool fj = fl & 2;
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        const T dx = xi[r] - xj, dy = yi[r] - yj, dz = zi[r] - zj;
        const T f0 = frac_image(dx * bi[0] + dy * bi[3] + dz * bi[6]);
        const T f1 = frac_image(dx * bi[1] + dy * bi[4] + dz * bi[7]);
        const T f2 = frac_image(dx * bi[2] + dy * bi[5] + dz * bi[8]);
        const T rx = f0 * box[0] + f1 * box[3] + f2 * box[6];
        const T ry = f0 * box[1] + f1 * box[4] + f2 * box[7];
        const T rz = f0 * box[2] + f1 * box[5] + f2 * box[8];
        const T r2 = rx * rx + ry * ry + rz * rz;
        const bool same = mi[r] == mj;
        const bool inter = valid[r] && !same;
        const bool ff = fi[r] && fj;
        // LJ mixing (every inter pair: the tail term needs it at any r)
        T epsm = T(0), sg2 = T(0), sg6 = T(0);
        T c6m = T(0), c8m = T(0), c10m = T(0);
        if constexpr (RD == RD_CLASSIC) {
          if (o.rd == 1) {
            T sg;
            if (o.mix == 0) {
              epsm = ei[r] * ej;
              sg = hi[r] + hj;
            } else {
              const T si = T(2) * hi[r], sj = T(2) * hj;
              const T s3i = si * si * si, s3j = sj * sj * sj;
              T denom = s3i * s3i + s3j * s3j;
              // max(x, 1e-300): the bound is 0 in float, as in the reference
              denom = denom > T(1e-300) ? denom : T(1e-300);
              sg = x_pow(T(0.5) * denom, T(1.0 / 6.0));
              epsm = ei[r] * ej * (T(2) * s3i * s3j / denom);
            }
            sg2 = sg * sg;
            sg6 = sg2 * sg2 * sg2;
            if (o.lrc) {
              const T tc = c16 * epsm * sg6 * (sg6 * a3 - b3);
              acc[3] += inter && !ff ? tc : T(0);
              acc[7] += inter && ff ? tc : T(0);
            }
          }
        } else if constexpr (RD == RD_DISP) {
          // the C mixing and the tail (every inter pair, at any r)
          c6m = disp_mix(c6i[r], cc6[k]);
          c8m = disp_mix(c8i[r], cc8[k]);
          c10m = disp_mix(c10i[r], cc10[k]);
          if (o.lrc) {
            const T tc = disp_tail(c6m, c8m, c10m, rc);
            acc[3] += inter && !ff ? tc : T(0);
            acc[7] += inter && ff ? tc : T(0);
          }
        }
        mn = inter && !ff ? x_min(mn, r2) : mn;
        const T r2s = r2 > T(1e-12) ? r2 : T(1);
        const T qq = qi[r] * qj;
        // the terms within rc: only where some lane of the warp has one
        const bool act = inter && r2 < rc2;
        if (__any_sync(0xffffffffu, act)) {
          const T ir = x_rsqrt(r2s);
          T rd = T(0), es = T(0);
          if constexpr (RD == RD_CLASSIC) {
            if (o.rd == 1) {
              const T s2 = sg2 * (ir * ir);
              const T s6 = s2 * s2 * s2;
              rd = T(4) * epsm * s6 * (s6 - T(1));
            }
          } else {
            rd = rd_form<T, RD>(x_sqrt(r2s), ei[r], ej, hi[r], hj, c6m, c8m,
                                c10m, o.rd != 0);
          }
          if (o.es == 1) {
            es = qq * x_erfc(alpha * (r2s * ir)) * ir;
          } else if (o.es == 2) {
            es = qq * (x_erfc(alpha * (r2s * ir)) * ir - wolf_shift);
          } else if (o.es == 3) {
            es = qq * ir;
          }
          acc[0] += act && !ff ? rd : T(0);
          acc[1] += act && !ff ? es : T(0);
          acc[4] += act && ff ? rd : T(0);
          acc[5] += act && ff ? es : T(0);
        }
        // the exclusion term of intra-molecular pairs (ewald only): erf
        // only where some lane of the warp holds one
        const bool intra = valid[r] && same;
        if (o.es == 1 && __any_sync(0xffffffffu, intra)) {
          const T ir = x_rsqrt(r2s);
          const T ex = -qq * x_erf(alpha * (r2s * ir)) * ir;
          acc[2] += intra && !ff ? ex : T(0);
          acc[6] += intra && ff ? ex : T(0);
        }
      }
    }
    // the tile's partial, one slot per list position
    double a[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) a[s] = double(acc[s]);
    sums_to<T>(a, mn, wred, wmin, part + size_t(qq) * 8, pmin + qq);
  }
  // the last CTA adds every slot: thread t the slots t, t + NT2, ... in
  // order, then sums_to's fixed tree
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1) == int(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double a[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = 0.0;
  T mn = T(INFINITY);
  for (int b = t; b < W; b += NT2) {
#pragma unroll
    for (int s = 0; s < 8; ++s) a[s] += __ldcg(part + size_t(b) * 8 + s);
    mn = x_min(mn, __ldcg(pmin + b));
  }
  __shared__ double tot[8];
  sums_to<T>(a, mn, wred, wmin, tot, out + 8);
  if (t < 8) out[t] = T(tot[t]);
  if (t == 0) *ticket = 0;        // ready for the next launch
}

// ---------------------------------------------------------------- reduce
// B4's last block, RT threads: thread t sums partials t, t+RT, ... in order,
// then a fixed tree - the same order every run.  out[0..K) sums (cast to
// T), out[K] min.  The partials are read from L2 (other blocks wrote them).
template <typename T, int K>
__device__ __forceinline__ void reduce_body(
    const double* __restrict__ part, const T* __restrict__ pmin, int nb,
    T* __restrict__ out, double (*red)[RT], T* rmin) {
  const int t = threadIdx.x;
  double acc[K];
#pragma unroll
  for (int s = 0; s < K; ++s) acc[s] = 0.0;
  T mn = T(INFINITY);
  for (int b = t; b < nb; b += RT) {
#pragma unroll
    for (int s = 0; s < K; ++s) acc[s] += __ldcg(part + size_t(b) * K + s);
    mn = x_min(mn, __ldcg(pmin + b));
  }
#pragma unroll
  for (int s = 0; s < K; ++s) red[s][t] = acc[s];
  rmin[t] = mn;
  __syncthreads();
  for (int w = RT / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int s = 0; s < K; ++s) red[s][t] += red[s][t + w];
      rmin[t] = x_min(rmin[t], rmin[t + w]);
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) out[s] = T(red[s][0]);
    out[K] = rmin[0];
  }
}

// ---------------------------------------------------------------- B4
// Grid (column chunks of MT, chains); the molecule's rows are gathered into
// shared memory once per block and read into registers.  Chain c = blockIdx.y
// owns mol/rows/out at its stride, partial slots [c nb, (c+1) nb) and
// ticket[c]; its pos and alive lie pos_stride (n 3: each chain its own
// system) or 0 (every chain the same system: one molecule's orientations,
// the rotor grid of ops/qrot.py) elements apart.  tickets: zero between
// launches (each chain's last block puts its own back).  The scalar
// header sc is one [20] row for every chain
// (sc_stride 0) or a row per chain (sc_stride 20: each chain its own box,
// the NPT chains).
static_assert(MT == RT, "B4's last block runs the reduction");
template <typename T, int RD>
__global__ void __launch_bounds__(MT) mol_pair_kernel(
    const T* __restrict__ pos, const T* __restrict__ q,
    const T* __restrict__ eps, const T* __restrict__ sig,
    const int32_t* __restrict__ mol_id, const bool* __restrict__ alive,
    int pos_stride, const int64_t* __restrict__ mol_atoms,
    const int64_t* __restrict__ mol_natoms, const int64_t* __restrict__ molp,
    const T* __restrict__ rows, int A, const T* __restrict__ sc,
    int sc_stride, int n, Opts o, double* __restrict__ part,
    T* __restrict__ pmin, int32_t* __restrict__ ticket,
    T* __restrict__ out, const T* __restrict__ c6,
    const T* __restrict__ c8, const T* __restrict__ c10) {
  __shared__ T rx[A_PAD], ry[A_PAD], rz[A_PAD], rq[A_PAD], re[A_PAD],
      rs[A_PAD];
  __shared__ T d6[A_PAD], d8[A_PAD], d10[A_PAD];   // RD_DISP's rows
  __shared__ double red[3][MT];
  __shared__ T rmin[MT];
  __shared__ int last;
  const int t = threadIdx.x;
  const int c = blockIdx.y;
  const int nb = gridDim.x;
  pos += size_t(c) * pos_stride;
  alive += size_t(c) * (pos_stride / 3);
  if (rows) rows += size_t(c) * A * 3;
  sc += size_t(c) * sc_stride;
  part += size_t(c) * nb * 3;
  pmin += size_t(c) * nb;
  ticket += c;
  out += size_t(c) * 4;
  const int64_t m = molp[c];
  const int na = int(mol_natoms[m]);
  if (t < A_PAD) {
    const int a = t < A ? t : 0;
    const int64_t idx = mol_atoms[m * A + a];
    rx[t] = rows ? rows[3 * a] : pos[3 * idx];
    ry[t] = rows ? rows[3 * a + 1] : pos[3 * idx + 1];
    rz[t] = rows ? rows[3 * a + 2] : pos[3 * idx + 2];
    rq[t] = q[idx]; re[t] = eps[idx]; rs[t] = sig[idx];
    if constexpr (RD == RD_DISP) {
      d6[t] = c6[idx]; d8[t] = c8[idx]; d10[t] = c10[idx];
    }
  }
  __syncthreads();
  T acc[3] = {T(0), T(0), T(0)};
  T mn = T(INFINITY);
  const int j = blockIdx.x * MT + t;
  if (j < n && alive[j] && mol_id[j] != int32_t(m)) {
    const T xj = pos[3 * j], yj = pos[3 * j + 1], zj = pos[3 * j + 2];
    const T qj = q[j], ej = eps[j], sj = sig[j];
    T c6j = T(0), c8j = T(0), c10j = T(0);
    if constexpr (RD == RD_DISP) {
      c6j = c6[j]; c8j = c8[j]; c10j = c10[j];
    }
    const T rc2 = sc[0] * sc[0];
#pragma unroll
    for (int a = 0; a < A_PAD; ++a) {
      if (a < A && a < na) {
        T r2, rd, es, ex, tc;
        T c6i = T(0), c8i = T(0), c10i = T(0);
        if constexpr (RD == RD_DISP) {
          c6i = d6[a]; c8i = d8[a]; c10i = d10[a];
        }
        pair_eval<T, RD>(rx[a], ry[a], rz[a], rq[a], re[a], rs[a], xj, yj,
                         zj, qj, ej, sj, sc, o, r2, rd, es, ex, tc, c6i,
                         c8i, c10i, c6j, c8j, c10j);
        if (r2 < rc2) {
          acc[0] += rd;
          acc[1] += es;
        }
        acc[2] += tc;
        mn = x_min(mn, r2);
      }
    }
  }
  block_partials<T, MT, 3>(acc, mn, red, rmin, part, pmin, blockIdx.x);
  if (t == 0) {
    __threadfence();            // this block's partials before its ticket
    last = atomicAdd(ticket, 1) == nb - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    reduce_body<T, 3>(part, pmin, nb, out, red, rmin);
    if (t == 0) *ticket = 0;    // ready for the next launch
  }
}

// The CTAs the card holds at once of B2.
template <typename T, int RD>
int pair_config(int* out) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, pair_terms_kernel<T, RD>, NT2, 0);
  if (e != cudaSuccess) return int(e);
  out[0] = sms * per;
  return 0;
}

template <typename T, int RD>
int launch_pair_terms(const T* pos, const T* q, const T* eps, const T* sig,
                      const int32_t* mol, const bool* alive,
                      const bool* frozen, const T* sc, const int32_t* wl,
                      int W, int nt, int n, int row_start, Opts o, int grid,
                      double* part, T* pmin, int32_t* ticket, T* out,
                      const T* c6, const T* c8, const T* c10,
                      cudaStream_t stream) {
  pair_terms_kernel<T, RD><<<grid, NT2, 0, stream>>>(
      pos, q, eps, sig, mol, alive, frozen, sc, wl, W, nt, n, row_start, o,
      part, pmin, ticket, out, c6, c8, c10);
  return int(cudaGetLastError());
}

template <typename T, int RD>
int launch_mol_pair(const T* pos, const T* q, const T* eps, const T* sig,
                    const int32_t* mol_id, const bool* alive,
                    int pos_stride, const int64_t* mol_atoms,
                    const int64_t* mol_natoms,
                    const int64_t* mol, const T* rows, int A, const T* sc,
                    int sc_stride, int n, int C, Opts o, double* part,
                    T* pmin, int32_t* ticket, T* out, const T* c6,
                    const T* c8, const T* c10, cudaStream_t stream) {
  const int nb = n > 0 ? (n + MT - 1) / MT : 1;
  mol_pair_kernel<T, RD><<<dim3(nb, C), MT, 0, stream>>>(
      pos, q, eps, sig, mol_id, alive, pos_stride, mol_atoms, mol_natoms,
      mol, rows, A, sc, sc_stride, n, o, part, pmin, ticket, out, c6, c8,
      c10);
  return int(cudaGetLastError());
}

}  // namespace

// The classical instance's entries (rd none or lj at run time): pair_terms,
// pair_config and mol_pair, _f32 and _f64.
#define PAIR_TERMS_ENTRY(SFX, T)                                            \
  extern "C" int pair_terms_##SFX(                                         \
      const void* pos, const void* q, const void* eps, const void* sig,     \
      const void* mol, const void* alive, const void* frozen,               \
      const void* sc, const void* wl, int W, int nt, int n, int row_start,  \
      int rd, int mix, int es, int lrc, int grid, void* part, void* pmin,   \
      void* ticket, void* out, void* stream) {                              \
    return launch_pair_terms<T, RD_CLASSIC>(                                \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol, (const bool*)alive, (const bool*)frozen,       \
        (const T*)sc, (const int32_t*)wl, W, nt, n, row_start,              \
        Opts{rd, mix, es, lrc}, grid, (double*)part, (T*)pmin,              \
        (int32_t*)ticket, (T*)out, nullptr, nullptr, nullptr,               \
        (cudaStream_t)stream);                                              \
  }                                                                         \
  extern "C" int pair_config_##SFX(int* out) {                             \
    return pair_config<T, RD_CLASSIC>(out);                                 \
  }

#define MOL_PAIR_ENTRY(SFX, T)                                              \
  extern "C" int mol_pair_##SFX(                                           \
      const void* pos, const void* q, const void* eps, const void* sig,     \
      const void* mol_id, const void* alive, int pos_stride,                \
      const void* mol_atoms,                                                \
      const void* mol_natoms, const void* mol, const void* rows, int A,     \
      const void* sc, int sc_stride, int n, int C, int rd, int mix, int es, \
      int lrc, void* part, void* pmin, void* ticket, void* out,             \
      void* stream) {                                                       \
    return launch_mol_pair<T, RD_CLASSIC>(                                  \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol_id, (const bool*)alive, pos_stride,             \
        (const int64_t*)mol_atoms, (const int64_t*)mol_natoms,              \
        (const int64_t*)mol, (const T*)rows, A, (const T*)sc, sc_stride, n, \
        C,                                                                  \
        Opts{rd, mix, es, lrc}, (double*)part, (T*)pmin, (int32_t*)ticket,  \
        (T*)out, nullptr, nullptr, nullptr, (cudaStream_t)stream);          \
  }

// A form's instance (RD one of RD_SG .. RD_DISP): pair_terms_rd,
// pair_config_rd and mol_pair_rd, _f32 and _f64 - the classical entries'
// arguments (rd: the damping flag) and the C6, C8, C10 columns before the
// stream (null where the form reads none).
#define PAIR_RD_ENTRIES(RD, SFX, T)                                         \
  extern "C" int pair_terms_rd_##SFX(                                      \
      const void* pos, const void* q, const void* eps, const void* sig,     \
      const void* mol, const void* alive, const void* frozen,               \
      const void* sc, const void* wl, int W, int nt, int n, int row_start,  \
      int damp, int mix, int es, int lrc, int grid, void* part,             \
      void* pmin, void* ticket, void* out, const void* c6, const void* c8,  \
      const void* c10, void* stream) {                                      \
    return launch_pair_terms<T, RD>(                                        \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol, (const bool*)alive, (const bool*)frozen,       \
        (const T*)sc, (const int32_t*)wl, W, nt, n, row_start,              \
        Opts{damp, mix, es, lrc}, grid, (double*)part, (T*)pmin,            \
        (int32_t*)ticket, (T*)out, (const T*)c6, (const T*)c8,              \
        (const T*)c10, (cudaStream_t)stream);                               \
  }                                                                         \
  extern "C" int pair_config_rd_##SFX(int* out) {                          \
    return pair_config<T, RD>(out);                                         \
  }                                                                         \
  extern "C" int mol_pair_rd_##SFX(                                        \
      const void* pos, const void* q, const void* eps, const void* sig,     \
      const void* mol_id, const void* alive, int pos_stride,                \
      const void* mol_atoms, const void* mol_natoms, const void* mol,       \
      const void* rows, int A, const void* sc, int sc_stride, int n, int C, \
      int damp, int mix, int es, int lrc, void* part, void* pmin,           \
      void* ticket, void* out, const void* c6, const void* c8,              \
      const void* c10, void* stream) {                                      \
    return launch_mol_pair<T, RD>(                                          \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol_id, (const bool*)alive, pos_stride,             \
        (const int64_t*)mol_atoms, (const int64_t*)mol_natoms,              \
        (const int64_t*)mol, (const T*)rows, A, (const T*)sc, sc_stride, n, \
        C, Opts{damp, mix, es, lrc}, (double*)part, (T*)pmin,               \
        (int32_t*)ticket, (T*)out, (const T*)c6, (const T*)c8,              \
        (const T*)c10, (cudaStream_t)stream);                               \
  }
