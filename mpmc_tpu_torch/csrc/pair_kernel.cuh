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
//     (its position in the list); a CTA takes an entry's atomic ticket
//     once, after a __threadfence, as its walk leaves the entry, and the
//     CTA whose ticket completes the entry adds its slots in a fixed order
//     and writes its nine sums - identical bits run to run, for any grid.
//   - Over a batch of C geometries (the surf drivers' vmapped energies:
//     a position array per entry, every parameter column, the alive mask
//     and the header shared), a work item is (entry, tile): item qq is
//     tile wl[qq % W] of entry qq / W, positions read at entry x n x 3,
//     the partials, minimum and ticket the entry's own.  So entry c of a
//     batched launch has the bits of a lone launch on its positions (and
//     C = 1 the bits of the one-entry design), and a batch of tiny
//     systems (a dimer: one tile, W = 1) fills the card with C items.
//
// B4 mol_pair    replaces mpmc_tpu/ops/pallas/pair_kernel.py::_mol_kernel
//   (mol_pair_tiles / mol_pair_pass_pallas): one molecule's <= 8 rows
//   against every column, over C chains (each its own positions, or one
//   system read by every chain: position stride 0, the rotor grid of
//   ops/qrot.py).  The rows are gathered by the kernel itself (mol read
//   from device memory), so the wrapper issues no copies and no host sync
//   per move.  Bound: at C = 1 the launch (~32k pairs at A = 3 and N =
//   10.8k); over chains the pairs' operations (stride 0, 256 rotors x 512
//   orientations: ~4.3e9 pairs) or, at C = 128 with positions per chain,
//   the position planes.  Design, for that bound: one summation order for
//   every chain (the B4 section below), kept by two regimes that share
//   the pair code and the trees and need no partials outside the kernel.
//   - Regime 1 (mol_pair_grid_kernel; stride 0 and C >= grid_min, enough
//     CTAs for one on every SM): a CTA holds 8 cpw chains (cpw <= 4) and
//     streams the columns through shared memory a 256-column chunk at a
//     time, double-buffered with cp.async; each chunk serves every chain
//     of the CTA (a warp a chain, 8 columns a lane), whose chunk sums stay
//     in shared memory until the CTA's last chunk.  In the classical
//     instance the rows' LJ mixing with a chunk's columns (sqrt, the
//     tail's two divisions) is computed once for all the CTA's chains of
//     one species.  Chains lie on grid x: no cap at 65,535, one launch per
//     rotor-table refresh.
//   - Regime 2 (mol_pair_cluster_kernel; every other launch): a cluster of
//     G <= 16 CTAs of 512 threads per chain, a team of 4 warps per chunk
//     (2 columns a lane, the 3 rows of an H2 unrolled); teams meet on a
//     named barrier, chunk sums go to rank 0's shared memory (distributed
//     shared memory) and one cluster barrier precedes rank 0's tree - no
//     ticket, __threadfence or device-memory slot.  Its bound at C = 1 is
//     the 16 SMs a cluster may hold (tools/measure_b4_variants.py).
//   Chain c of any launch has the bits of chain c launched alone, and of
//   the single-launch kernel this design replaced.
//   A column range [c0, c0 + n) (both regimes; c0 = 0 and n the atom count
//   is the whole system): the rows are gathered from the full arrays, the
//   column walk reads from the range's bases, so one rank of the spatial
//   MC step prices a move against its own column strip
//   (mpmc_tpu_torch/parallel/spatial.py).  The full range runs the same
//   instructions on the same addresses as before the range existed.
//
// Both: partials in double (B2 per tile, reduced by its last CTA; B4 per
// chunk, inside the kernel) in a fixed order - identical results run to
// run.  Templated on
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "device_math.cuh"
#include "rd_forms.cuh"

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
constexpr int MT = 256;    // B4: columns per chunk of its summation order
constexpr int A_PAD = 8;   // B4: most rows per molecule
constexpr int NT4 = 256;   // B4 regime 1: threads per CTA
constexpr int NW4 = NT4 / 32;
constexpr int KC = MT / 32;        // B4: a chunk's columns per lane of a warp
constexpr int NT2C = 512;          // B4 regime 2: threads per CTA
constexpr int P2 = 4;              // B4 regime 2: warps per chunk (a team)
constexpr int TM2 = NT2C / 32 / P2;  // B4 regime 2: teams per CTA
constexpr int G4_MAX = 16;         // B4 regime 2: most CTAs per chain
constexpr int CPW_MAX = 4;         // B4 regime 1: most chains per warp
constexpr int NRF = 9;             // B4: row fields x y z q eps sig c6 c8 c10
constexpr int SMEM1_MAX = 113 * 1024;  // B4 regime 1: most dynamic smem
static_assert(NT4 == MT, "B4 regime 1 stages a chunk's alive flags, one a "
              "thread");
static_assert(KC % P2 == 0 && TM2 * P2 * 32 == NT2C && TM2 < 16,
              "bad B4 team");

// The RD form, a template parameter of both kernels (RD_* of rd_forms.cuh,
// which holds the forms' formulas): the classical instance reads rd none or
// lj from Opts at run time (pair_kernel.cu); each other form is an
// instance of its own (pair_<form>_kernel.cu).

struct Opts {
  int rd;    // classical: 0 none, 1 lj; RD_DISP: 1 damps the dispersion
  int mix;   // 0 lorentz-berthelot, 1 waldman-hagler
  int es;    // 0 none, 1 ewald, 2 wolf, 3 cutoff
  int lrc;   // 1: the tail coefficient (LJ, or RD_DISP's)
};

// The minimum-image r2 of a pair (sc: rc, alpha, box, box^-1).
template <typename T>
__device__ __forceinline__ T pair_r2(T xi, T yi, T zi, T xj, T yj, T zj,
                                     const T* __restrict__ sc) {
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
  return rx * rx + ry * ry + rz * rz;
}

// The classical LJ mixing of sites i and j, which needs no position: 4
// eps, sig^2, and the tail coefficient's two factors (its value ta tb;
// o.lrc 0: both 0).
template <typename T>
__device__ __forceinline__ void lj_mix(T ei, T ej, T si, T sj, T rc,
                                       const Opts o, T& e4, T& sig2, T& ta,
                                       T& tb) {
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
  e4 = T(4) * eps;
  sig2 = sig * sig;
  ta = tb = T(0);
  if (o.lrc) {
    const T src = sig / rc;
    const T s3 = src * src * src;
    const T s9 = s3 * s3 * s3;
    ta = T(16.0 * 3.14159265358979323846 / 3.0) * eps * (sig * sig * sig);
    tb = s9 / T(3) - s3;
  }
}

// The classical pair's LJ energy and tail coefficient from its mixing
// (lj_mix) at r2s (r2, or 1 at r2 <= 1e-12).
template <typename T>
__device__ __forceinline__ void lj_terms(T e4, T sig2, T ta, T tb, T r2s,
                                         const Opts o, T& rd, T& tc) {
  const T s2 = sig2 / r2s;
  const T s6 = s2 * s2 * s2;
  rd = e4 * s6 * (s6 - T(1));
  if (o.lrc) tc = ta * tb;
}

// The real-space Coulomb terms (es, and ewald's intra-molecular ex) of
// charges qq at distance r.
template <typename T>
__device__ __forceinline__ void coulomb_terms(T qq, T r, const T* sc,
                                              const Opts o, T& es, T& ex) {
  const T rc = sc[0], alpha = sc[1];
  if (o.es == 1) {
    es = qq * x_erfc(alpha * r) / r;
    ex = -qq * x_erf(alpha * r) / r;
  } else if (o.es == 2) {
    es = qq * (x_erfc(alpha * r) / r - x_erfc(alpha * rc) / rc);
  } else if (o.es == 3) {
    es = qq / r;
  }
}

// One pair: minimum-image r2 and the unmasked term values (a form's RD
// energy only within rc; c6i..c10j its C columns, RD_DISP only).
template <typename T, int RD>
__device__ __forceinline__ void pair_eval(
    T xi, T yi, T zi, T qi, T ei, T si, T xj, T yj, T zj, T qj, T ej, T sj,
    const T* __restrict__ sc, const Opts o,
    T& r2, T& rd, T& es, T& ex, T& tc, T c6i, T c8i, T c10i, T c6j, T c8j,
    T c10j) {
  r2 = pair_r2(xi, yi, zi, xj, yj, zj, sc);
  const T r2s = r2 > T(1e-12) ? r2 : T(1);
  const T r = x_sqrt(r2s);
  const T rc = sc[0];
  rd = T(0); tc = T(0); es = T(0); ex = T(0);
  if constexpr (RD == RD_CLASSIC) {
    if (o.rd == 1) {
      T e4, sig2, ta, tb;
      lj_mix(ei, ej, si, sj, rc, o, e4, sig2, ta, tb);
      lj_terms(e4, sig2, ta, tb, r2s, o, rd, tc);
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
  coulomb_terms(qi * qj, r, sc, o, es, ex);
}

// The classical pair with its LJ mixing given (lj_mix of the two sites,
// computed once for many chains): pair_eval's values, bit for bit.
template <typename T>
__device__ __forceinline__ void pair_eval_mixed(
    T xi, T yi, T zi, T qi, T xj, T yj, T zj, T qj, T e4, T sig2, T ta,
    T tb, const T* __restrict__ sc, const Opts o, T& r2, T& rd, T& es,
    T& ex, T& tc) {
  r2 = pair_r2(xi, yi, zi, xj, yj, zj, sc);
  const T r2s = r2 > T(1e-12) ? r2 : T(1);
  const T r = x_sqrt(r2s);
  rd = T(0); tc = T(0); es = T(0); ex = T(0);
  if (o.rd == 1) lj_terms(e4, sig2, ta, tb, r2s, o, rd, tc);
  coulomb_terms(qi * qj, r, sc, o, es, ex);
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

// The CTA's walk leaves entry e after `done` of its tiles: one ticket for
// them (so one per CTA at C = 1), and the CTA that brings the entry's count
// to W adds the entry's slots: thread t the slots t, t + NT2, ... in order,
// then sums_to's fixed tree.  Every thread calls it.
template <typename T>
__device__ __forceinline__ void close_entry(
    int e, int done, int W, const double* __restrict__ part,
    const T* __restrict__ pmin, int32_t* __restrict__ ticket,
    T* __restrict__ out, double (*wred)[8], T* wmin, double* tot,
    int* last) {
  const int t = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (t == 0) *last = atomicAdd(ticket + e, done) + done == W;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  double a[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = 0.0;
  T tm = T(INFINITY);
  const double* __restrict__ pe8 = part + size_t(e) * W * 8;
  const T* __restrict__ pem = pmin + size_t(e) * W;
  for (int b = t; b < W; b += NT2) {
#pragma unroll
    for (int s = 0; s < 8; ++s) a[s] += __ldcg(pe8 + size_t(b) * 8 + s);
    tm = x_min(tm, __ldcg(pem + b));
  }
  T* __restrict__ oe = out + size_t(e) * 9;
  sums_to<T>(a, tm, wred, wmin, tot, oe + 8);
  if (t < 8) oe[t] = T(tot[t]);
  if (t == 0) ticket[e] = 0;      // ready for the next launch
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
                      int row_start, int C, Opts o,
                      double* __restrict__ part,
                      T* __restrict__ pmin, int32_t* __restrict__ ticket,
                      T* __restrict__ out, const T* __restrict__ c6,
                      const T* __restrict__ c8, const T* __restrict__ c10) {
  __shared__ T sx[TJ], sy[TJ], sz[TJ], sq[TJ], se[TJ], sh[TJ];
  __shared__ T cc6[TJ], cc8[TJ], cc10[TJ];
  __shared__ int32_t sm[TJ];
  __shared__ unsigned char sfl[TJ];
  __shared__ double wred[NW2][8];
  __shared__ T wmin[NW2];
  __shared__ double tot[8];
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
  long long cur = -1;
  int ecur = -1, done = 0;        // the entry walked and its tiles done
  const long long items = (long long)C * W;
  for (long long qq = blockIdx.x; qq < items; qq += gridDim.x) {
    const int e = int(qq / W);            // the entry (geometry)
    if (e != ecur) {
      if (done) close_entry<T>(ecur, done, W, part, pmin, ticket, out, wred,
                               wmin, tot, &last);
      ecur = e;
      done = 0;
    }
    const int tile = wl[qq - (long long)e * W];
    const int I = tile / nt;
    const int J = tile - I * nt;
    const T* __restrict__ pe = pos + size_t(e) * 3 * n;
    if ((long long)e * nt + I != cur) {
      cur = (long long)e * nt + I;
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        const int i = I * TI + g + r * GR;
        const bool in = i < n;
        ri[r] = i;
        iok[r] = in && i >= row_start && alive[i];
        xi[r] = in ? pe[3 * i] : T(0);
        yi[r] = in ? pe[3 * i + 1] : T(0);
        zi[r] = in ? pe[3 * i + 2] : T(0);
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
      sx[c] = in ? pe[3 * j] : T(0);
      sy[c] = in ? pe[3 * j + 1] : T(0);
      sz[c] = in ? pe[3 * j + 2] : T(0);
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
    ++done;
  }
  if (done) close_entry<T>(ecur, done, W, part, pmin, ticket, out, wred, wmin,
                           tot, &last);
}

// ---------------------------------------------------------------- B4
// The summation order, one for every chain whatever the regime, C or
// stride (the order of the one-launch kernel this design replaced, so that
// its outputs keep their bits): (1) each column's rows summed in T, in row
// order; (2) per chunk of MT = 256 columns, a tree in double with partner
// offsets 128, 64, ..., 1, the lower index's value first; (3) the chunk
// sums S_b combined by the same tree over u_t = S_t + S_(t+256) + ... (in
// chunk order, t < 256).  Column t of a chunk lies in lane t % 32 and slot
// kk = t / 32 = k P + p: register slot k of warp p of a team of P warps.
// So offsets 128 .. 32 (kk's bits, high first) are adds of registers
// (reg_tree over k) and then of the team's warps (reg_tree over p), and
// offsets 16 .. 1 are shuffles (lane_tree): the same pairs, the same bits.
// IEEE addition commutes, so a shuffle's partner may come first.

// The tree of NK values, k < NK, with offsets NK / 2 .. 1, evaluated
// depth first so that few values are live at once; its last level pairs
// slots k and k + NK / 2, which leaf2(k, k + NK / 2, a, b) fills together
// (two columns' work in flight at once).
template <int K0, int S, int NK, typename Leaf2>
__device__ __forceinline__ void reg_tree(const Leaf2& leaf2,
                                         double (&s)[3]) {
  double a[3], b[3];
  if constexpr (2 * S >= NK) {
    leaf2(K0, K0 + S, a, b);
  } else {
    reg_tree<K0, 2 * S, NK>(leaf2, a);
    reg_tree<K0 + S, 2 * S, NK>(leaf2, b);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = a[i] + b[i];
}

// Offsets 16 .. 1 over a warp's lanes; every lane ends with the root.
__device__ __forceinline__ void lane_tree(double (&s)[3]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
  }
}

template <typename T>
__device__ __forceinline__ T lane_min(T m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = x_min(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// Row slot a of a chain into rw [NRF][A_PAD] (a >= A repeats row 0; the
// rows past the molecule's atom count are never read):
// positions from the trial rows or the molecule's own atoms, the
// parameters (RD_DISP: and its C columns) from its atoms.
template <typename T, int RD>
__device__ __forceinline__ void gather_row(
    T* rw, int slot, int A, int64_t m, const T* __restrict__ pos,
    const T* __restrict__ rows, const int64_t* __restrict__ mol_atoms,
    const T* __restrict__ q, const T* __restrict__ eps,
    const T* __restrict__ sig, const T* __restrict__ c6,
    const T* __restrict__ c8, const T* __restrict__ c10) {
  const int a = slot < A ? slot : 0;
  const int64_t idx = mol_atoms[m * A + a];
  rw[slot] = rows ? rows[3 * a] : pos[3 * idx];
  rw[A_PAD + slot] = rows ? rows[3 * a + 1] : pos[3 * idx + 1];
  rw[2 * A_PAD + slot] = rows ? rows[3 * a + 2] : pos[3 * idx + 2];
  rw[3 * A_PAD + slot] = q[idx];
  rw[4 * A_PAD + slot] = eps[idx];
  rw[5 * A_PAD + slot] = sig[idx];
  if constexpr (RD == RD_DISP) {
    rw[6 * A_PAD + slot] = c6[idx];
    rw[7 * A_PAD + slot] = c8[idx];
    rw[8 * A_PAD + slot] = c10[idx];
  }
}

// One column's planes (RD_DISP: and its C columns); ok: the column is
// alive, below n and not the chain's molecule's (the planes of a column
// that is not are any real column's, and count nowhere).
template <typename T>
struct Col {
  T x, y, z, q, e, s, c6, c8, c10;
  int jj;     // regime 1: the column's place in its chunk
  bool ok;
};

// Two columns u and w against the chain's nr = min(A, atom count) rows:
// each column's rd and es within rc and tail coefficient summed in T in
// row order, as doubles in su / sw (+0 for a column that is not ok); mn
// takes every counted pair's r2.  The rows run in the outer loop, so a
// row's two pair evaluations are independent; NR > 0 is nr known at
// compile time (the rows unrolled: every pair of the two columns in
// flight at once), NR = 0 a loop over nr.  MIXED (the classical instance
// in regime 1): the rows' LJ mixing with the chunk's columns is read from
// mix [4][NR][MT] (lj_mix: 4 eps, sig^2, the tail's two factors).
template <typename T, int RD, int NR, bool MIXED = false>
__device__ __forceinline__ void column_pair(
    const T* rw, int nr, const Col<T>& u, const Col<T>& w,
    const T* __restrict__ sc, const Opts o, double (&su)[3],
    double (&sw)[3], T& mn, const T* mix = nullptr) {
  T au[3] = {T(0), T(0), T(0)}, aw[3] = {T(0), T(0), T(0)};
  const T rc2 = sc[0] * sc[0];
  auto row = [&](int a) {
    const T xi = rw[a], yi = rw[A_PAD + a], zi = rw[2 * A_PAD + a];
    const T qi = rw[3 * A_PAD + a], ei = rw[4 * A_PAD + a],
            si = rw[5 * A_PAD + a];
    T c6i = T(0), c8i = T(0), c10i = T(0);
    if constexpr (RD == RD_DISP) {
      c6i = rw[6 * A_PAD + a];
      c8i = rw[7 * A_PAD + a];
      c10i = rw[8 * A_PAD + a];
    }
    T r2u, rdu, esu, exu, tcu, r2w, rdw, esw, exw, tcw;
    if constexpr (MIXED) {
      static_assert(RD == RD_CLASSIC && NR > 0, "mixing of classical rows");
      const T* m = mix + a * MT;
      pair_eval_mixed(xi, yi, zi, qi, u.x, u.y, u.z, u.q, m[u.jj],
                      m[NR * MT + u.jj], m[2 * NR * MT + u.jj],
                      m[3 * NR * MT + u.jj], sc, o, r2u, rdu, esu, exu, tcu);
      pair_eval_mixed(xi, yi, zi, qi, w.x, w.y, w.z, w.q, m[w.jj],
                      m[NR * MT + w.jj], m[2 * NR * MT + w.jj],
                      m[3 * NR * MT + w.jj], sc, o, r2w, rdw, esw, exw, tcw);
    } else {
      pair_eval<T, RD>(xi, yi, zi, qi, ei, si, u.x, u.y, u.z, u.q, u.e, u.s,
                       sc, o, r2u, rdu, esu, exu, tcu, c6i, c8i, c10i, u.c6,
                       u.c8, u.c10);
      pair_eval<T, RD>(xi, yi, zi, qi, ei, si, w.x, w.y, w.z, w.q, w.e, w.s,
                       sc, o, r2w, rdw, esw, exw, tcw, c6i, c8i, c10i, w.c6,
                       w.c8, w.c10);
    }
    if (u.ok) {
      if (r2u < rc2) {
        au[0] += rdu;
        au[1] += esu;
      }
      au[2] += tcu;
      mn = x_min(mn, r2u);
    }
    if (w.ok) {
      if (r2w < rc2) {
        aw[0] += rdw;
        aw[1] += esw;
      }
      aw[2] += tcw;
      mn = x_min(mn, r2w);
    }
  };
  if constexpr (NR > 0) {
#pragma unroll
    for (int a = 0; a < NR; ++a) row(a);
  } else {
    for (int a = 0; a < nr; ++a) row(a);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    su[i] = double(au[i]);
    sw[i] = double(aw[i]);
  }
}

// The molecules' row count that B4 unrolls (the 3-site H2 of the repo's
// sorbates): a chain of nr == NR_FIXED rows takes column_pair<.., NR_FIXED>,
// any other the loop.  Both give the same bits.
constexpr int NR_FIXED = 3;
// Regime 1, classical instance: the LJ mixing of the rows with each chunk's
// columns computed once for the CTA's chains (lj_mix), where they share
// their rows' parameters and header.
constexpr bool B4_LJ_MIX = true;

// One warp: step (3) of the order over the chunk sums sl [ns][3] (and the
// chunks' minima smin [ns]); lane 0 writes out [4] (the sums cast to T,
// then the minimum).
template <typename T>
__device__ __forceinline__ void chunk_tree(const double* sl, const T* smin,
                                           int ns, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  T mn = T(INFINITY);
  auto leaf = [&](int k, double (&v)[3]) {
    v[0] = v[1] = v[2] = 0.0;
    for (int b = lane + 32 * k; b < ns; b += MT) {
#pragma unroll
      for (int i = 0; i < 3; ++i) v[i] += sl[3 * b + i];
      mn = x_min(mn, smin[b]);
    }
  };
  auto leaf2 = [&](int k0, int k1, double (&a)[3], double (&b)[3]) {
    leaf(k0, a);
    leaf(k1, b);
  };
  double s[3];
  reg_tree<0, 1, KC>(leaf2, s);
  lane_tree(s);
  mn = lane_min(mn);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = T(s[i]);
    out[3] = mn;
  }
}

// A 4- or 8-byte copy from device to shared memory that does not hold the
// thread (cp.async; completes at cp_wait).
template <typename V>
__device__ __forceinline__ void cp_async(V* dst, const V* src) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8, "cp.async of 4 or 8 B");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(int(sizeof(V)))
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A barrier of the nt threads of one team (named barrier id >= 1).
__device__ __forceinline__ void team_sync(int id, int nt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nt) : "memory");
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Regime 1's dynamic shared memory at cpw chains a warp and ns chunk slots
// a chain: two chunk buffers (the T planes x y z interleaved, q, eps, sig
// and RD_DISP's C6 C8 C10; mol_id; alive), then per chain its rows
// [NRF][A_PAD], its molecule, atom count and whether it reads the mixing,
// the mixing [4][NR_FIXED][MT] (classical instance), then per chain its
// slots [ns][3] in double and its chunks' minima [ns].
template <typename T, int RD>
struct GridSmem {
  static constexpr int NFT = RD == RD_DISP ? 9 : 6;
  static constexpr size_t TPL = size_t(NFT) * MT * sizeof(T);
  static constexpr size_t TILE = align16(TPL + size_t(MT) * 5);
  static constexpr size_t MIX =
      RD == RD_CLASSIC && B4_LJ_MIX ? 4 * NR_FIXED * MT * sizeof(T) : 0;
  size_t rows, info, mix, slots, mins, total;
  __host__ __device__ GridSmem(int cpw, int ns) {
    const size_t cg = size_t(NW4) * cpw;
    rows = 2 * TILE;
    info = rows + align16(cg * NRF * A_PAD * sizeof(T));
    mix = info + align16(cg * 3 * sizeof(int));
    slots = mix + MIX;
    mins = slots + cg * ns * 3 * sizeof(double);
    total = mins + align16(cg * ns * sizeof(T));
  }
};

// Regime 1: position stride 0 and C >= grid_min (the rotor grid: one
// system, C placements of its molecules).  CTA blockIdx.x owns chains
// [CG blockIdx.x, CG (blockIdx.x + 1)), CG = NW4 cpw; warp w the cpw from
// CG blockIdx.x + w cpw.  The columns stream through shared memory a
// chunk at a time, double-buffered (cp.async for the T and int32 planes;
// the alive flags staged in a register across the chunk's work).  Each
// chunk serves every chain of the CTA: warp w takes it for each of its
// chains, KC columns a lane (P = 1), and keeps the chunk's sums in the
// chain's slot b mod MT (added in chunk order past MT chunks).  Then warp
// w takes step (3) over each of its chains' slots.  Nothing but the
// outputs leaves the CTA.
template <typename T, int RD>
__global__ void __launch_bounds__(NT4, sizeof(T) == 4 && RD != RD_DISP ? 3
                                                                     : 2)
    mol_pair_grid_kernel(
    const T* __restrict__ pos, const T* __restrict__ q,
    const T* __restrict__ eps, const T* __restrict__ sig,
    const int32_t* __restrict__ mol_id, const bool* __restrict__ alive,
    const int64_t* __restrict__ mol_atoms,
    const int64_t* __restrict__ mol_natoms, const int64_t* __restrict__ molp,
    const T* __restrict__ rows, int A, const T* __restrict__ sc,
    int sc_stride, int col0, int n, int C, int cpw, Opts o,
    T* __restrict__ out,
    const T* __restrict__ c6, const T* __restrict__ c8,
    const T* __restrict__ c10) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = GridSmem<T, RD>;
  const int nb = (n + MT - 1) / MT;
  const int ns = nb < MT ? nb : MT;
  const L lay(cpw, ns);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int CG = NW4 * cpw;
  const int c0 = blockIdx.x * CG;
  T* rw_all = reinterpret_cast<T*>(smem + lay.rows);
  int* cm = reinterpret_cast<int*>(smem + lay.info);
  int* cna = cm + CG;
  int* cmix = cna + CG;
  T* mix = reinterpret_cast<T*>(smem + lay.mix);
  double* slots = reinterpret_cast<double*>(smem + lay.slots);
  T* smins = reinterpret_cast<T*>(smem + lay.mins);
  for (int e = t; e < CG * A_PAD; e += NT4) {
    const int cl = e / A_PAD, a = e - cl * A_PAD;
    const int c = c0 + cl;
    if (c < C && n > 0) {
      const int64_t m = molp[c];
      gather_row<T, RD>(rw_all + cl * NRF * A_PAD, a, A, m, pos,
                        rows ? rows + size_t(c) * A * 3 : nullptr,
                        mol_atoms, q, eps, sig, c6, c8, c10);
      if (a == 0) {
        cm[cl] = int(m);
        cna[cl] = int(mol_natoms[m]);
      }
    }
  }
  // the columns [col0, col0 + n): the rows above were gathered from the
  // full arrays, the column walk reads from these bases
  const T* cpos = pos + size_t(3) * col0;
  const T* cq = q + col0;
  const T* ceps = eps + col0;
  const T* csig = sig + col0;
  const T* cc6 = c6 ? c6 + col0 : c6;
  const T* cc8 = c8 ? c8 + col0 : c8;
  const T* cc10 = c10 ? c10 + col0 : c10;
  const int32_t* cmol = mol_id + col0;
  const bool* calive = alive + col0;
  // the mixing serves the chains whose NR_FIXED rows have chain 0's eps
  // and sig (the same species), under a shared header
  bool mixing = false;
  if constexpr (L::MIX > 0) {
    __syncthreads();
    const int nr0 = cna[0] < A ? cna[0] : A;
    mixing = o.rd == 1 && sc_stride == 0 && n > 0 && nr0 == NR_FIXED;
    for (int cl = t; cl < CG; cl += NT4) {
      bool same = mixing && c0 + cl < C
                  && (cna[cl] < A ? cna[cl] : A) == NR_FIXED;
      for (int a = 0; a < NR_FIXED && same; ++a) {
        const T* r0 = rw_all;
        const T* r1 = rw_all + cl * NRF * A_PAD;
        same = r1[4 * A_PAD + a] == r0[4 * A_PAD + a]
               && r1[5 * A_PAD + a] == r0[5 * A_PAD + a];
      }
      cmix[cl] = same;
    }
  }
  auto planes = [&](int buf) {
    return reinterpret_cast<T*>(smem + size_t(buf) * L::TILE);
  };
  auto mols = [&](int buf) {
    return reinterpret_cast<int32_t*>(smem + size_t(buf) * L::TILE + L::TPL);
  };
  auto alv = [&](int buf) {
    return reinterpret_cast<bool*>(smem + size_t(buf) * L::TILE + L::TPL
                                   + 4 * MT);
  };
  auto load = [&](int b, int buf) {
    const int j0 = b * MT;
    const int cnt = n - j0 < MT ? n - j0 : MT;
    T* tp = planes(buf);
    for (int e = t; e < 3 * cnt; e += NT4)
      cp_async(tp + e, cpos + size_t(3) * j0 + e);
    if (t < cnt) {
      cp_async(tp + 3 * MT + t, cq + j0 + t);
      cp_async(tp + 4 * MT + t, ceps + j0 + t);
      cp_async(tp + 5 * MT + t, csig + j0 + t);
      if constexpr (RD == RD_DISP) {
        cp_async(tp + 6 * MT + t, cc6 + j0 + t);
        cp_async(tp + 7 * MT + t, cc8 + j0 + t);
        cp_async(tp + 8 * MT + t, cc10 + j0 + t);
      }
      cp_async(mols(buf) + t, cmol + j0 + t);
    }
  };
  if (nb > 0) {
    load(0, 0);
    if (t < n) alv(0)[t] = calive[t];
  }
  cp_commit();
  for (int b = 0; b < nb; ++b) {
    const int cur = b & 1;
    bool al_next = false;
    if (b + 1 < nb) {
      load(b + 1, cur ^ 1);
      const int jn = (b + 1) * MT + t;
      if (jn < n) al_next = calive[jn];
    }
    cp_commit();
    cp_wait_prior();     // chunk b's copies (this thread's) have landed
    __syncthreads();     // ... and every thread's
    const T* tp = planes(cur);
    const int32_t* tm = mols(cur);
    const bool* ta = alv(cur);
    const int j0 = b * MT;
    if (mixing) {        // CTA-uniform
      for (int e = t; e < NR_FIXED * MT; e += NT4) {
        const int a = e / MT, jj = e - a * MT;
        T* m = mix + a * MT + jj;
        lj_mix(rw_all[4 * A_PAD + a], tp[4 * MT + jj],
               rw_all[5 * A_PAD + a], tp[5 * MT + jj], sc[0], o, m[0],
               m[NR_FIXED * MT], m[2 * NR_FIXED * MT], m[3 * NR_FIXED * MT]);
      }
      __syncthreads();
    }
    for (int i = 0; i < cpw; ++i) {
      const int cl = w * cpw + i;
      const int c = c0 + cl;
      if (c >= C) break;
      const T* rw = rw_all + cl * NRF * A_PAD;
      const int m = cm[cl];
      const int nr = cna[cl] < A ? cna[cl] : A;
      const T* scc = sc + size_t(c) * sc_stride;
      T mn = T(INFINITY);
      auto col = [&](int jj) {
        Col<T> v;
        v.x = tp[3 * jj];
        v.y = tp[3 * jj + 1];
        v.z = tp[3 * jj + 2];
        v.q = tp[3 * MT + jj];
        v.e = tp[4 * MT + jj];
        v.s = tp[5 * MT + jj];
        v.c6 = v.c8 = v.c10 = T(0);
        if constexpr (RD == RD_DISP) {
          v.c6 = tp[6 * MT + jj];
          v.c8 = tp[7 * MT + jj];
          v.c10 = tp[8 * MT + jj];
        }
        v.jj = jj;
        v.ok = j0 + jj < n && ta[jj] && tm[jj] != m;
        return v;
      };
      double s[3];
      auto chunk = [&](auto nrc, auto mixed) {
        auto leaf2 = [&](int k0, int k1, double (&a)[3], double (&b)[3]) {
          column_pair<T, RD, decltype(nrc)::value, decltype(mixed)::value>(
              rw, nr, col(lane + 32 * k0), col(lane + 32 * k1), scc, o, a,
              b, mn, mix);
        };
        reg_tree<0, 1, KC>(leaf2, s);
      };
      if constexpr (L::MIX > 0) {
        if (cmix[cl]) {
          chunk(std::integral_constant<int, NR_FIXED>{}, std::true_type{});
        } else if (nr == NR_FIXED) {
          chunk(std::integral_constant<int, NR_FIXED>{}, std::false_type{});
        } else {
          chunk(std::integral_constant<int, 0>{}, std::false_type{});
        }
      } else if (nr == NR_FIXED) {
        chunk(std::integral_constant<int, NR_FIXED>{}, std::false_type{});
      } else {
        chunk(std::integral_constant<int, 0>{}, std::false_type{});
      }
      lane_tree(s);
      mn = lane_min(mn);
      if (lane == 0) {
        const int slot = b & (MT - 1);
        double* sl = slots + (size_t(cl) * ns + slot) * 3;
        T* smn = smins + size_t(cl) * ns + slot;
        if (b < MT) {
#pragma unroll
          for (int e = 0; e < 3; ++e) sl[e] = s[e];
          *smn = mn;
        } else {
#pragma unroll
          for (int e = 0; e < 3; ++e) sl[e] += s[e];
          *smn = x_min(*smn, mn);
        }
      }
    }
    if (b + 1 < nb) alv(cur ^ 1)[t] = al_next;
    __syncthreads();     // chunk b read by every warp: its buffer is free
  }
  __syncwarp();
  for (int i = 0; i < cpw; ++i) {
    const int cl = w * cpw + i;
    const int c = c0 + cl;
    if (c >= C) break;
    chunk_tree<T>(slots + size_t(cl) * ns * 3, smins + size_t(cl) * ns, ns,
                  out + size_t(c) * 4);
  }
}

// Regime 2: every other launch (each chain its own positions, pos_stride
// n 3; or stride 0 below grid_min).  Chain c = blockIdx.x / G has a
// cluster of G CTAs (G = 1: one CTA), each of TM2 teams of P2 warps; team
// g = rank TM2 + team of the cluster takes chunks g, g + G TM2, ..., KC /
// P2 columns a lane, read from device memory.  A chunk's team meets once
// (a named barrier: offsets 64 and 32 over its warps), then its first
// warp shuffles and lane 0 writes the chunk's sums into rank 0's slots
// [nb][3] and minima [nb] (distributed shared memory).  One cluster
// barrier, and rank 0's first warp takes step (3).  No ticket, fence or
// device-memory partial.
template <typename T, int RD>
__global__ void __launch_bounds__(NT2C, 2) mol_pair_cluster_kernel(
    const T* __restrict__ pos, const T* __restrict__ q,
    const T* __restrict__ eps, const T* __restrict__ sig,
    const int32_t* __restrict__ mol_id, const bool* __restrict__ alive,
    int pos_stride, const int64_t* __restrict__ mol_atoms,
    const int64_t* __restrict__ mol_natoms, const int64_t* __restrict__ molp,
    const T* __restrict__ rows, int A, const T* __restrict__ sc,
    int sc_stride, int col0, int n, int G, Opts o, T* __restrict__ out,
    const T* __restrict__ c6, const T* __restrict__ c8,
    const T* __restrict__ c10) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T rw[NRF * A_PAD];
  __shared__ double xs[TM2][2][P2][3][32];    // a team's warps, by parity
  __shared__ T xm[TM2][2][P2][32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int c = blockIdx.x / G;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int team = w / P2, p = w % P2;
  const int nb = (n + MT - 1) / MT;
  pos += size_t(c) * pos_stride;
  alive += size_t(c) * (pos_stride / 3);
  sc += size_t(c) * sc_stride;
  const int64_t m = molp[c];
  const int na = int(mol_natoms[m]);
  const int nr = na < A ? na : A;
  if (t < A_PAD && n > 0)
    gather_row<T, RD>(rw, t, A, m, pos,
                      rows ? rows + size_t(c) * A * 3 : nullptr, mol_atoms,
                      q, eps, sig, c6, c8, c10);
  __syncthreads();
  // the columns [col0, col0 + n) of the chain: the rows above were
  // gathered from the full arrays, the column walk reads from these bases
  const T* cpos = pos + size_t(3) * col0;
  const T* cq = q + col0;
  const T* ceps = eps + col0;
  const T* csig = sig + col0;
  const T* cc6 = c6 ? c6 + col0 : c6;
  const T* cc8 = c8 ? c8 + col0 : c8;
  const T* cc10 = c10 ? c10 + col0 : c10;
  const int32_t* cmol = mol_id + col0;
  const bool* calive = alive + col0;
  double* slots = cluster.map_shared_rank(
      reinterpret_cast<double*>(smem), 0);
  T* smins = cluster.map_shared_rank(
      reinterpret_cast<T*>(smem + align16(size_t(nb) * 3 * sizeof(double))),
      0);
  const int NTM = G * TM2;
  int par = 0;
  for (int b = rank * TM2 + team; b < nb; b += NTM, par ^= 1) {
    T mn = T(INFINITY);
    // a column of the chain, read whatever its flags (the index held
    // below n): every load of the chunk in flight at once
    auto col = [&](int j) {
      const int i = j < n ? j : n - 1;
      Col<T> v;
      v.x = cpos[3 * i];
      v.y = cpos[3 * i + 1];
      v.z = cpos[3 * i + 2];
      v.q = cq[i];
      v.e = ceps[i];
      v.s = csig[i];
      v.c6 = v.c8 = v.c10 = T(0);
      if constexpr (RD == RD_DISP) {
        v.c6 = cc6[i];
        v.c8 = cc8[i];
        v.c10 = cc10[i];
      }
      v.jj = 0;
      v.ok = j < n && calive[i] && cmol[i] != int32_t(m);
      return v;
    };
    double s[3];
    auto chunk = [&](auto nrc) {
      auto leaf2 = [&](int k0, int k1, double (&a)[3], double (&b2)[3]) {
        const int j0 = b * MT + lane + 32 * p;
        column_pair<T, RD, decltype(nrc)::value>(
            rw, nr, col(j0 + 32 * P2 * k0), col(j0 + 32 * P2 * k1), sc, o,
            a, b2, mn);
      };
      reg_tree<0, 1, KC / P2>(leaf2, s);
    };
    if (nr == NR_FIXED)
      chunk(std::integral_constant<int, NR_FIXED>{});
    else
      chunk(std::integral_constant<int, 0>{});
#pragma unroll
    for (int i = 0; i < 3; ++i) xs[team][par][p][i][lane] = s[i];
    xm[team][par][p][lane] = mn;
    team_sync(1 + team, 32 * P2);
    if (p == 0) {
      auto leafp = [&](int k, double (&v)[3]) {
#pragma unroll
        for (int i = 0; i < 3; ++i) v[i] = xs[team][par][k][i][lane];
        mn = x_min(mn, xm[team][par][k][lane]);
      };
      auto leafp2 = [&](int k0, int k1, double (&a)[3], double (&b2)[3]) {
        leafp(k0, a);
        leafp(k1, b2);
      };
      reg_tree<0, 1, P2>(leafp2, s);
      lane_tree(s);
      mn = lane_min(mn);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) slots[3 * b + i] = s[i];
        smins[b] = mn;
      }
    }
  }
  cluster.sync();        // every chunk's sums are in rank 0's slots
  if (rank == 0 && w == 0)
    chunk_tree<T>(reinterpret_cast<const double*>(smem),
                  reinterpret_cast<const T*>(
                      smem + align16(size_t(nb) * 3 * sizeof(double))),
                  nb, out + size_t(c) * 4);
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
                      int W, int nt, int n, int row_start, int C, Opts o,
                      int grid, double* part, T* pmin, int32_t* ticket,
                      T* out, const T* c6, const T* c8, const T* c10,
                      cudaStream_t stream) {
  pair_terms_kernel<T, RD><<<grid, NT2, 0, stream>>>(
      pos, q, eps, sig, mol, alive, frozen, sc, wl, W, nt, n, row_start, C,
      o, part, pmin, ticket, out, c6, c8, c10);
  return int(cudaGetLastError());
}

// The card's SM count (0 on an error).
inline int b4_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// B4's launch shape for n columns and C chains (stride0: position stride
// 0): out[0] the regime (1 or 2), out[1] chains a warp (regime 1) or CTAs
// a chain (regime 2), out[2] the grid's CTAs, out[3] dynamic shared
// memory bytes, out[4] grid_min, the fewest stride-0 chains that take
// regime 1 (enough CTAs of NW4 CPW_MAX chains for one on every SM).
template <typename T, int RD>
int mol_pair_plan(int n, int C, int stride0, int* out) {
  const int sms = b4_sms();
  if (sms == 0) return int(cudaErrorInvalidDevice);
  const int nb = n > 0 ? (n + MT - 1) / MT : 0;
  const int grid_min = NW4 * CPW_MAX * sms;
  out[4] = grid_min;
  if (stride0 && C >= grid_min) {
    const int ns = nb < MT ? nb : MT;
    int cpw = CPW_MAX;
    while (cpw > 1 && GridSmem<T, RD>(cpw, ns).total > size_t(SMEM1_MAX))
      cpw >>= 1;
    const size_t smem = GridSmem<T, RD>(cpw, ns).total;
    if (smem > size_t(SMEM1_MAX)) return int(cudaErrorInvalidValue);
    out[0] = 1;
    out[1] = cpw;
    out[2] = (C + NW4 * cpw - 1) / (NW4 * cpw);
    out[3] = int(smem);
    return 0;
  }
  // enough teams for a chunk each, but no more CTAs than the card holds
  // a few times over when C alone fills it
  int G = (nb + TM2 - 1) / TM2;
  G = G < 1 ? 1 : (G > G4_MAX ? G4_MAX : G);
  const int fill = (4 * sms + C - 1) / C;
  if (G > fill) G = fill;
  const size_t smem = align16(size_t(nb) * 3 * sizeof(double))
                      + align16(size_t(nb) * sizeof(T) + 1);
  if (smem > size_t(200 * 1024) || int64_t(C) * G > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  out[0] = 2;
  out[1] = G;
  out[2] = C * G;
  out[3] = int(smem);
  return 0;
}

// Raise a kernel's dynamic shared memory limit to bytes, once per size.
template <typename Kern>
inline cudaError_t b4_smem(Kern kern, size_t bytes, size_t* have) {
  if (bytes <= *have) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e == cudaSuccess) *have = bytes;
  return e;
}

template <typename T, int RD>
int launch_mol_pair(const T* pos, const T* q, const T* eps, const T* sig,
                    const int32_t* mol_id, const bool* alive,
                    int pos_stride, const int64_t* mol_atoms,
                    const int64_t* mol_natoms,
                    const int64_t* mol, const T* rows, int A, const T* sc,
                    int sc_stride, int c0, int n, int C, Opts o, T* out,
                    const T* c6, const T* c8, const T* c10,
                    cudaStream_t stream) {
  if (A < 1 || A > A_PAD || C < 1 || n < 0 || c0 < 0)
    return int(cudaErrorInvalidValue);
  int plan[5];
  int e = mol_pair_plan<T, RD>(n, C, pos_stride == 0, plan);
  if (e) return e;
  if (plan[0] == 1) {
    static size_t have1 = 48 * 1024;
    cudaError_t r = b4_smem(mol_pair_grid_kernel<T, RD>, size_t(plan[3]),
                            &have1);
    if (r != cudaSuccess) return int(r);
    mol_pair_grid_kernel<T, RD><<<plan[2], NT4, plan[3], stream>>>(
        pos, q, eps, sig, mol_id, alive, mol_atoms, mol_natoms, mol, rows,
        A, sc, sc_stride, c0, n, C, plan[1], o, out, c6, c8, c10);
    return int(cudaGetLastError());
  }
  static size_t have2 = 48 * 1024;
  cudaError_t r = b4_smem(mol_pair_cluster_kernel<T, RD>, size_t(plan[3]),
                          &have2);
  if (r != cudaSuccess) return int(r);
  if (plan[1] > 8) {
    r = cudaFuncSetAttribute(mol_pair_cluster_kernel<T, RD>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (r != cudaSuccess) return int(r);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(plan[1]);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(plan[2]));
  cfg.blockDim = dim3(NT2C);
  cfg.dynamicSmemBytes = size_t(plan[3]);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  r = cudaLaunchKernelEx(&cfg, mol_pair_cluster_kernel<T, RD>, pos, q, eps,
                         sig, mol_id, alive, pos_stride, mol_atoms,
                         mol_natoms, mol, rows, A, sc, sc_stride, c0, n,
                         plan[1], o, out, c6, c8, c10);
  if (r != cudaSuccess) return int(r);
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
      int C, int rd, int mix, int es, int lrc, int grid, void* part,        \
      void* pmin, void* ticket, void* out, void* stream) {                  \
    return launch_pair_terms<T, RD_CLASSIC>(                                \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol, (const bool*)alive, (const bool*)frozen,       \
        (const T*)sc, (const int32_t*)wl, W, nt, n, row_start, C,           \
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
      const void* sc, int sc_stride, int c0, int n, int C, int rd, int mix, \
      int es, int lrc, void* out, void* stream) {                           \
    return launch_mol_pair<T, RD_CLASSIC>(                                  \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol_id, (const bool*)alive, pos_stride,             \
        (const int64_t*)mol_atoms, (const int64_t*)mol_natoms,              \
        (const int64_t*)mol, (const T*)rows, A, (const T*)sc, sc_stride, c0, \
        n, C, Opts{rd, mix, es, lrc}, (T*)out, nullptr, nullptr, nullptr,   \
        (cudaStream_t)stream);                                              \
  }                                                                         \
  extern "C" int mol_pair_plan_##SFX(int n, int C, int stride0, int* out) { \
    return mol_pair_plan<T, RD_CLASSIC>(n, C, stride0, out);                \
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
      int C, int damp, int mix, int es, int lrc, int grid, void* part,      \
      void* pmin, void* ticket, void* out, const void* c6, const void* c8,  \
      const void* c10, void* stream) {                                      \
    return launch_pair_terms<T, RD>(                                        \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol, (const bool*)alive, (const bool*)frozen,       \
        (const T*)sc, (const int32_t*)wl, W, nt, n, row_start, C,           \
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
      const void* rows, int A, const void* sc, int sc_stride, int c0, int n, \
      int C, int damp, int mix, int es, int lrc, void* out, const void* c6, \
      const void* c8, const void* c10, void* stream) {                      \
    return launch_mol_pair<T, RD>(                                          \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol_id, (const bool*)alive, pos_stride,             \
        (const int64_t*)mol_atoms, (const int64_t*)mol_natoms,              \
        (const int64_t*)mol, (const T*)rows, A, (const T*)sc, sc_stride, c0, \
        n, C, Opts{damp, mix, es, lrc}, (T*)out, (const T*)c6, (const T*)c8, \
        (const T*)c10, (cudaStream_t)stream);                               \
  }                                                                         \
  extern "C" int mol_pair_plan_rd_##SFX(int n, int C, int stride0,         \
                                        int* out) {                         \
    return mol_pair_plan<T, RD>(n, C, stride0, out);                        \
  }
