// B5 thole_field: the Thole field kernel of the polarization path,
// hand-written for Hopper (sm_90a).
//
// Replaces mpmc_tpu/ops/pallas/thole_kernel.py::_kernel (through _field,
// via charge_field and dipole_field).  Over the pairs j != i whose sites
// are both ok and whose minimum-image distance is inside rc, with
// dr = r_i - r_j:
//   charge mode  E_i = sum_j q_j d1 dr / r^3            (j of another molecule)
//   dipole mode  E_i = sum_j [3 d2 (dr.mu_j) dr / r^5 - d1 mu_j / r^3]
// d1, d2 the Thole screening factors (none, exponential or linear); a pair
// at r^2 <= 1e-12 is evaluated at r^2 = 1, as the reference's guard does.
// The arithmetic follows the reference's jnp path (ops/thole.py: square
// root and division, not the Pallas kernel's rsqrt-derived reciprocals).
//
// Bound: FP32 (FP64) ALU and SFU work per pair inside rc - an exp, a square
// root and a division chain - on ~1.2e8 pairs at N = 10.8k, against 0.3 MB
// of inputs.  Design: one thread per target row, TI rows per block; a TJ
// column tile of positions, sources, ok flags and molecule ids is staged in
// shared memory and each row thread walks it from registers.  The column
// tiles are split over blockIdx.y so that ~4 blocks per SM are in flight at
// N = 10.8k; each split writes its row sums to a [splits, N, 3] double
// buffer and a second kernel adds the splits in order 0..S-1 - no atomics,
// the same bits on every run.  A masked pair, or one outside rc, is skipped
// before the square root; with the optional [NI, NJ] visit table a whole
// (row block, column tile) pair is skipped where it holds 0.  Every pair of
// such a tile lies outside rc, so the culled result equals the dense one
// bit for bit on the same input order.
//
// Scalar header sc[20] in device memory: rc, lambda, box (3x3 row-major,
// rows are cell vectors), box^-1 (3x3 row-major).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_math.cuh"
#include "thole_common.cuh"

namespace {

constexpr int TI = 128;   // rows per block, one thread each
constexpr int TJ = 128;   // columns per shared tile (== TI: one load a thread)
constexpr int RT = 256;   // threads of the split sum

// grid (NI row blocks, splits); block b.y walks column tiles
// [b.y * per_split, min(nj, (b.y + 1) * per_split)).
template <typename T, bool DIPOLE>
__global__ void __launch_bounds__(TI) thole_field_kernel(
    const T* __restrict__ pos, const T* __restrict__ src,
    const bool* __restrict__ ok, const int32_t* __restrict__ mol,
    const T* __restrict__ sc, const int32_t* __restrict__ visit, int n,
    int nj, int per_split, int damp_kind, int ortho,
    double* __restrict__ part) {
  __shared__ T sx[TJ], sy[TJ], sz[TJ], s0[TJ], s1[TJ], s2[TJ];
  __shared__ int32_t sm[TJ];
  __shared__ bool sok[TJ];
  const int t = threadIdx.x;
  const int ti = blockIdx.x;
  const int i = ti * TI + t;
  const bool iok = i < n && ok[i];
  T xi = T(0), yi = T(0), zi = T(0);
  int32_t mi = 0;
  if (iok) {
    xi = pos[3 * i];
    yi = pos[3 * i + 1];
    zi = pos[3 * i + 2];
    mi = mol[i];
  }
  const T rc = sc[0], lam = sc[1];
  const T rc2 = rc * rc;
  const T* box = sc + 2;
  const T* bi = sc + 11;
  double ex = 0.0, ey = 0.0, ez = 0.0;
  const int j0 = blockIdx.y * per_split;
  const int j1 = min(nj, j0 + per_split);
  for (int tj = j0; tj < j1; ++tj) {
    // uniform per block: every thread skips the tile together
    if (visit != nullptr && visit[size_t(ti) * nj + tj] == 0) continue;
    __syncthreads();            // the previous tile is consumed
    const int j = tj * TJ + t;
    const bool jok = j < n && ok[j];
    sok[t] = jok;
    if (jok) {
      sx[t] = pos[3 * j];
      sy[t] = pos[3 * j + 1];
      sz[t] = pos[3 * j + 2];
      if (DIPOLE) {
        s0[t] = src[3 * j];
        s1[t] = src[3 * j + 1];
        s2[t] = src[3 * j + 2];
      } else {
        s0[t] = src[j];
      }
      sm[t] = mol[j];
    }
    __syncthreads();
    if (!iok) continue;
    for (int k = 0; k < TJ; ++k) {
      if (!sok[k] || tj * TJ + k == i) continue;
      if (!DIPOLE && sm[k] == mi) continue;     // charge mode: inter only
      const T dx = xi - sx[k], dy = yi - sy[k], dz = zi - sz[k];
      T rx, ry, rz;
      if (ortho) {
        // diagonal cell: the general form's cross terms are exact zeros
        T f0 = dx * bi[0], f1 = dy * bi[4], f2 = dz * bi[8];
        f0 -= x_rint(f0);   // rint: half to even, like jnp.round
        f1 -= x_rint(f1);
        f2 -= x_rint(f2);
        rx = f0 * box[0];
        ry = f1 * box[4];
        rz = f2 * box[8];
      } else {
        T f0 = dx * bi[0] + dy * bi[3] + dz * bi[6];
        T f1 = dx * bi[1] + dy * bi[4] + dz * bi[7];
        T f2 = dx * bi[2] + dy * bi[5] + dz * bi[8];
        f0 -= x_rint(f0);
        f1 -= x_rint(f1);
        f2 -= x_rint(f2);
        rx = f0 * box[0] + f1 * box[3] + f2 * box[6];
        ry = f0 * box[1] + f1 * box[4] + f2 * box[7];
        rz = f0 * box[2] + f1 * box[5] + f2 * box[8];
      }
      const T r2 = rx * rx + ry * ry + rz * rz;
      if (!(r2 < rc2)) continue;
      const T r2s = r2 > T(1e-12) ? r2 : T(1);
      const T r = x_sqrt(r2s);
      T d1, d2;
      damping<T>(r, lam, damp_kind, d1, d2);
      if (DIPOLE) {
        const T mx = s0[k], my = s1[k], mz = s2[k];
        const T inv_r3 = T(1) / (r2s * r);
        const T mdotr = mx * rx + my * ry + mz * rz;
        const T c1 = T(3) * d2 * mdotr * inv_r3 / r2s;
        const T c2 = d1 * inv_r3;
        ex += double(c1 * rx - c2 * mx);
        ey += double(c1 * ry - c2 * my);
        ez += double(c1 * rz - c2 * mz);
      } else {
        const T coef = s0[k] * d1 / (r2s * r);
        ex += double(coef * rx);
        ey += double(coef * ry);
        ez += double(coef * rz);
      }
    }
  }
  if (i < n) {
    double* o = part + (size_t(blockIdx.y) * n + i) * 3;
    o[0] = ex;
    o[1] = ey;
    o[2] = ez;
  }
}

// out[e] = sum over splits k = 0..S-1 of part[k][e], in that order.
template <typename T>
__global__ void __launch_bounds__(RT) sum_splits(
    const double* __restrict__ part, int n3, int splits, T* __restrict__ out) {
  const int e = blockIdx.x * RT + threadIdx.x;
  if (e >= n3) return;
  double s = 0.0;
  for (int k = 0; k < splits; ++k) s += part[size_t(k) * n3 + e];
  out[e] = T(s);
}

template <typename T>
int launch_thole_field(const T* pos, const T* src, const bool* ok,
                       const int32_t* mol, const T* sc, const int32_t* visit,
                       int n, int ni, int nj, int per_split, int splits,
                       int dipole, int damp_kind, int ortho, double* part,
                       T* out, cudaStream_t stream) {
  const dim3 grid(ni, splits);
  if (dipole) {
    thole_field_kernel<T, true><<<grid, TI, 0, stream>>>(
        pos, src, ok, mol, sc, visit, n, nj, per_split, damp_kind, ortho,
        part);
  } else {
    thole_field_kernel<T, false><<<grid, TI, 0, stream>>>(
        pos, src, ok, mol, sc, visit, n, nj, per_split, damp_kind, ortho,
        part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int n3 = 3 * n;
  sum_splits<T><<<(n3 + RT - 1) / RT, RT, 0, stream>>>(part, n3, splits,
                                                       out);
  return int(cudaGetLastError());
}

}  // namespace

#define THOLE_FIELD_ENTRY(SFX, T)                                           \
  extern "C" int thole_field_##SFX(                                        \
      const void* pos, const void* src, const void* ok, const void* mol,    \
      const void* sc, const void* visit, int n, int ni, int nj,             \
      int per_split, int splits, int dipole, int damp_kind, int ortho,      \
      void* part, void* out, void* stream) {                                \
    return launch_thole_field<T>(                                           \
        (const T*)pos, (const T*)src, (const bool*)ok, (const int32_t*)mol, \
        (const T*)sc, (const int32_t*)visit, n, ni, nj, per_split, splits,  \
        dipole, damp_kind, ortho, (double*)part, (T*)out,                   \
        (cudaStream_t)stream);                                              \
  }

THOLE_FIELD_ENTRY(f32, float)
THOLE_FIELD_ENTRY(f64, double)
