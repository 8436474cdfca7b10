// Pair-pass kernels of the GCMC main path, hand-written for Hopper (sm_90a).
//
// B2 pair_terms  replaces mpmc_tpu/ops/pallas/pair_kernel.py::_kernel
//   (pair_terms_tiles / pair_pass_pallas): the triangular i<j pass over all
//   atoms, optionally restricted to rows >= row_start (the per-corrtime
//   refresh).  Bound: FP32 ALU and SFU work per pair (min-image, sqrt, one
//   divide chain, erfc and erf) - about 1.2e8 pairs at N = 10.8k and no
//   data reuse problem: a 128-column strip lives in shared memory and every
//   row thread walks it from registers.  The design keeps all nine sums in
//   registers and writes one partial per block, so no [N, N] intermediate
//   ever reaches device memory.
//
// B4 mol_pair    replaces mpmc_tpu/ops/pallas/pair_kernel.py::_mol_kernel
//   (mol_pair_tiles / mol_pair_pass_pallas): one molecule's <= 8 rows
//   against every column.  Bound: launch latency - at A = 3 and N = 10.8k
//   the whole pass is ~32k pairs, 43 blocks of 256 threads.  The rows are
//   gathered by the kernel itself (mol_atoms[mol], mol read from device
//   memory), so the wrapper issues no copies and no host sync per move.
//
// Both: per-block partials [n_blocks, K] in double, then one small kernel
// reduces them in a fixed order - no atomics, identical results run to
// run.  Templated on float and double.  Semantics follow the reference
// (ops/pairs.py jnp path): exact erfc/erf, half-to-even rint in the
// minimum image, the r2 > 1e-12 guard, and per-term masks (rd/es over
// inter pairs within rc, es_excl over intra pairs, the LRC coefficient
// over inter pairs at any distance, min_r2 over non-frozen-frozen inter
// pairs at any distance).  The Coulomb constant is applied by the caller.
//
// Scalar header scal[20] in device memory: rc, alpha, box (3x3 row-major,
// rows are cell vectors), box^-1 (3x3 row-major).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_math.cuh"

namespace {

constexpr int PT = 128;    // B2: rows per block = columns per tile
constexpr int MT = 256;    // B4: columns per block
constexpr int A_PAD = 8;   // B4: most rows per molecule
constexpr int RT = 256;    // threads of the partial reduction

struct Opts {
  int rd;    // 0 none, 1 lj
  int mix;   // 0 lorentz-berthelot, 1 waldman-hagler
  int es;    // 0 none, 1 ewald, 2 wolf, 3 cutoff
  int lrc;   // 1: LJ tail coefficient
};

// One pair: minimum-image r2 and the unmasked term values.
template <typename T>
__device__ __forceinline__ void pair_eval(
    T xi, T yi, T zi, T qi, T ei, T si, T xj, T yj, T zj, T qj, T ej, T sj,
    const T* __restrict__ sc, const Opts o,
    T& r2, T& rd, T& es, T& ex, T& tc) {
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
// grid (column tiles, row tiles from row_start / PT), PT threads: thread t
// owns row ti*PT + t and walks the block's column strip from shared memory.
template <typename T>
__global__ void __launch_bounds__(PT) pair_terms_kernel(
    const T* __restrict__ pos, const T* __restrict__ q,
    const T* __restrict__ eps, const T* __restrict__ sig,
    const int32_t* __restrict__ mol, const bool* __restrict__ alive,
    const bool* __restrict__ frozen, const T* __restrict__ sc, int n,
    int row_start, int row_tile0, Opts o, double* __restrict__ part,
    T* __restrict__ pmin) {
  __shared__ T sx[PT], sy[PT], sz[PT], sq[PT], se[PT], ss[PT];
  __shared__ int32_t sm[PT];
  __shared__ bool sa[PT], sf[PT];
  __shared__ double red[8][PT];
  __shared__ T rmin[PT];
  const int t = threadIdx.x;
  const int tj = blockIdx.x;
  const int ti = blockIdx.y + row_tile0;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  T acc[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) acc[s] = T(0);
  T mn = T(INFINITY);
  // blocks wholly below the diagonal hold no pair - unless row-restricted,
  // where every column < row_start counts for every row (the skipped
  // frozen-prefix rows reappear as columns).  Uniform per block.
  if (tj >= ti || tj * PT < row_start) {
    const int j = tj * PT + t;
    const bool jok = j < n && alive[j];
    sa[t] = jok;
    if (jok) {
      sx[t] = pos[3 * j]; sy[t] = pos[3 * j + 1]; sz[t] = pos[3 * j + 2];
      sq[t] = q[j]; se[t] = eps[j]; ss[t] = sig[j];
      sm[t] = mol[j]; sf[t] = frozen[j];
    }
    __syncthreads();
    const int i = ti * PT + t;
    if (i < n && i >= row_start && alive[i]) {
      const T xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
      const T qi = q[i], ei = eps[i], si = sig[i];
      const int32_t mi = mol[i];
      const bool fi = frozen[i];
      const T rc2 = sc[0] * sc[0];
      for (int k = 0; k < PT; ++k) {
        const int jj = tj * PT + k;
        if (!sa[k] || !(jj > i || jj < row_start)) continue;
        T r2, rd, es, ex, tc;
        pair_eval<T>(xi, yi, zi, qi, ei, si, sx[k], sy[k], sz[k], sq[k],
                     se[k], ss[k], sc, o, r2, rd, es, ex, tc);
        const bool ff = fi && sf[k];
        const int b = ff ? 4 : 0;
        if (mi == sm[k]) {          // intra-molecular: exclusion only
          acc[b + 2] += ex;
        } else {
          if (r2 < rc2) {
            acc[b] += rd;
            acc[b + 1] += es;
          }
          acc[b + 3] += tc;
          if (!ff) mn = x_min(mn, r2);
        }
      }
    }
  }
  block_partials<T, PT, 8>(acc, mn, red, rmin, part, pmin, bid);
}

// ---------------------------------------------------------------- B4
// 1-D grid over column chunks of MT; the molecule's rows are gathered into
// shared memory once per block and read into registers.
template <typename T>
__global__ void __launch_bounds__(MT) mol_pair_kernel(
    const T* __restrict__ pos, const T* __restrict__ q,
    const T* __restrict__ eps, const T* __restrict__ sig,
    const int32_t* __restrict__ mol_id, const bool* __restrict__ alive,
    const int64_t* __restrict__ mol_atoms,
    const int64_t* __restrict__ mol_natoms, const int64_t* __restrict__ molp,
    const T* __restrict__ rows, int A, const T* __restrict__ sc, int n,
    Opts o, double* __restrict__ part, T* __restrict__ pmin) {
  __shared__ T rx[A_PAD], ry[A_PAD], rz[A_PAD], rq[A_PAD], re[A_PAD],
      rs[A_PAD];
  __shared__ double red[3][MT];
  __shared__ T rmin[MT];
  const int t = threadIdx.x;
  const int64_t m = *molp;
  const int na = int(mol_natoms[m]);
  if (t < A_PAD) {
    const int a = t < A ? t : 0;
    const int64_t idx = mol_atoms[m * A + a];
    rx[t] = rows ? rows[3 * a] : pos[3 * idx];
    ry[t] = rows ? rows[3 * a + 1] : pos[3 * idx + 1];
    rz[t] = rows ? rows[3 * a + 2] : pos[3 * idx + 2];
    rq[t] = q[idx]; re[t] = eps[idx]; rs[t] = sig[idx];
  }
  __syncthreads();
  T acc[3] = {T(0), T(0), T(0)};
  T mn = T(INFINITY);
  const int j = blockIdx.x * MT + t;
  if (j < n && alive[j] && mol_id[j] != int32_t(m)) {
    const T xj = pos[3 * j], yj = pos[3 * j + 1], zj = pos[3 * j + 2];
    const T qj = q[j], ej = eps[j], sj = sig[j];
    const T rc2 = sc[0] * sc[0];
#pragma unroll
    for (int a = 0; a < A_PAD; ++a) {
      if (a < A && a < na) {
        T r2, rd, es, ex, tc;
        pair_eval<T>(rx[a], ry[a], rz[a], rq[a], re[a], rs[a], xj, yj, zj,
                     qj, ej, sj, sc, o, r2, rd, es, ex, tc);
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
}

// ---------------------------------------------------------------- reduce
// One block: thread t sums partials t, t+RT, ... in order, then a fixed
// tree - the same order every run.  out[0..K) sums (cast to T), out[K] min.
template <typename T, int K>
__global__ void __launch_bounds__(RT) reduce_partials(
    const double* __restrict__ part, const T* __restrict__ pmin, int nb,
    T* __restrict__ out) {
  __shared__ double red[K][RT];
  __shared__ T rmin[RT];
  const int t = threadIdx.x;
  double acc[K];
#pragma unroll
  for (int s = 0; s < K; ++s) acc[s] = 0.0;
  T mn = T(INFINITY);
  for (int b = t; b < nb; b += RT) {
#pragma unroll
    for (int s = 0; s < K; ++s) acc[s] += part[size_t(b) * K + s];
    mn = x_min(mn, pmin[b]);
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

template <typename T>
int launch_pair_terms(const T* pos, const T* q, const T* eps, const T* sig,
                      const int32_t* mol, const bool* alive,
                      const bool* frozen, const T* sc, int n, int row_start,
                      Opts o, double* part, T* pmin, T* out,
                      cudaStream_t stream) {
  const int nt = (n + PT - 1) / PT;
  const int r0 = row_start / PT;
  const dim3 grid(nt, nt - r0);
  pair_terms_kernel<T><<<grid, PT, 0, stream>>>(
      pos, q, eps, sig, mol, alive, frozen, sc, n, row_start, r0, o, part,
      pmin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  reduce_partials<T, 8><<<1, RT, 0, stream>>>(part, pmin, nt * (nt - r0),
                                              out);
  return int(cudaGetLastError());
}

template <typename T>
int launch_mol_pair(const T* pos, const T* q, const T* eps, const T* sig,
                    const int32_t* mol_id, const bool* alive,
                    const int64_t* mol_atoms, const int64_t* mol_natoms,
                    const int64_t* mol, const T* rows, int A, const T* sc,
                    int n, Opts o, double* part, T* pmin, T* out,
                    cudaStream_t stream) {
  const int nb = n > 0 ? (n + MT - 1) / MT : 1;
  mol_pair_kernel<T><<<nb, MT, 0, stream>>>(
      pos, q, eps, sig, mol_id, alive, mol_atoms, mol_natoms, mol, rows, A,
      sc, n, o, part, pmin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  reduce_partials<T, 3><<<1, RT, 0, stream>>>(part, pmin, nb, out);
  return int(cudaGetLastError());
}

}  // namespace

#define PAIR_TERMS_ENTRY(SFX, T)                                            \
  extern "C" int pair_terms_##SFX(                                         \
      const void* pos, const void* q, const void* eps, const void* sig,     \
      const void* mol, const void* alive, const void* frozen,               \
      const void* sc, int n, int row_start, int rd, int mix, int es,        \
      int lrc, void* part, void* pmin, void* out, void* stream) {           \
    return launch_pair_terms<T>(                                            \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol, (const bool*)alive, (const bool*)frozen,       \
        (const T*)sc, n, row_start, Opts{rd, mix, es, lrc}, (double*)part,  \
        (T*)pmin, (T*)out, (cudaStream_t)stream);                           \
  }

#define MOL_PAIR_ENTRY(SFX, T)                                              \
  extern "C" int mol_pair_##SFX(                                           \
      const void* pos, const void* q, const void* eps, const void* sig,     \
      const void* mol_id, const void* alive, const void* mol_atoms,         \
      const void* mol_natoms, const void* mol, const void* rows, int A,     \
      const void* sc, int n, int rd, int mix, int es, int lrc, void* part,  \
      void* pmin, void* out, void* stream) {                                \
    return launch_mol_pair<T>(                                              \
        (const T*)pos, (const T*)q, (const T*)eps, (const T*)sig,           \
        (const int32_t*)mol_id, (const bool*)alive,                         \
        (const int64_t*)mol_atoms, (const int64_t*)mol_natoms,              \
        (const int64_t*)mol, (const T*)rows, A, (const T*)sc, n,            \
        Opts{rd, mix, es, lrc}, (double*)part, (T*)pmin, (T*)out,           \
        (cudaStream_t)stream);                                              \
  }

PAIR_TERMS_ENTRY(f32, float)
PAIR_TERMS_ENTRY(f64, double)
MOL_PAIR_ENTRY(f32, float)
MOL_PAIR_ENTRY(f64, double)
