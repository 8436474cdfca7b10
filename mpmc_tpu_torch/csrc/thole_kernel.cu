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
// The reciprocals come from one rsqrt per pair, as in the Pallas kernel
// (the plain version and the jnp path take a square root and divide:
// within phase 4c's tolerances, and a quarter faster than the divisions).
//
// Bound: FP32 (FP64) ALU and SFU work per pair inside rc - an rsqrt and an
// exp chain - on ~9e7 pairs at N = 10.8k (dense), against 0.3 MB of
// inputs.  Design, for that bound:
// - A tile is TI rows x TJ columns.  The tiles to evaluate form a work list
//   (every tile, or the visited tiles of an [NI, NJ] visit table, row-major;
//   built on the device by the wrapper).  A persistent grid of as many CTAs
//   as the card holds at once walks it, CTA b taking the list's b-th equal
//   share, so a culled call is as balanced as a dense one.
// - A thread owns R rows (register blocking): each column read from shared
//   memory serves R pairs, and the R independent rsqrt / exp chains hide
//   each other's latency.  The NT threads of a CTA
//   cover the TI rows S = NT R / TI times; split h walks the tile's h-th
//   run of TJ / S columns.
// - The pair body is branch-free: one mask (both sites ok, i != j, inside
//   rc, another molecule in charge mode) selects 0.  Only a warp-uniform
//   vote skips a column no lane of the warp has inside rc.
// - One launch: each tile's double partials (splits added in order 0..S-1)
//   go to their own slot; the CTA that completes the last tile of a row
//   key (a chain's row tile: an atomic ticket per row key, after a
//   __threadfence) adds that row key's slots in column-tile order and
//   writes the field.  The sums
//   are cut at tile boundaries whatever the table, and a skipped tile
//   stands for exact zeros (every pair of a skipped tile lies outside rc),
//   so the culled result equals the dense one bit for bit, and both are the
//   same on every run.
//
// Over a chain axis (the reference vmaps this kernel over chains): the
// sites of C chains, pos [C, n, 3], src [C, n] or [C, n, 3], ok and mol
// [C, n], out [C, n, 3], with one header for every chain or a header per
// chain (the NPT chains, each in its own box).  K of them
// are listed (chains[k], or chain k when chains is nullptr); a list item
// is (k, row tile I, column tile J) = (k NI + I) NJ + J, and a row key
// k NI + I owns a ticket.  A chain's items are computed and summed as a
// single-chain launch on that chain's tensors computes them, so each
// chain's field is that launch's bits whatever C, K or the other chains
// (the single-chain wrappers launch this kernel at C = K = 1).  Rows of
// chains not listed are not written.
//
// Scalar header sc[20] in device memory: rc, lambda, box (3x3 row-major,
// rows are cell vectors), box^-1 (3x3 row-major); chain c reads the one
// at sc + c sc_stride (sc_stride 0: one header shared by every chain, 20:
// a [C, 20] header per chain).  A CTA loads a header when its work moves
// to another chain, so a chain's pairs see the same numbers whatever the
// stride, and a shared header gives the bits of the same header repeated.
// Work list wl (int32, nullptr = dense: every item of the K listed
// chains): [W, rowoff[0..K NI], items[W...]]: W visited items, row key
// R's items at list positions rowoff[R] .. rowoff[R + 1] - 1 in column
// order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_math.cuh"

namespace {

constexpr int TI = 128;          // rows per tile (the visit table's rows)
constexpr int TJ = 128;          // columns per tile
constexpr int R = 2;             // rows per thread
constexpr int NT = 128;          // threads per CTA
constexpr int MINB = 8;          // float: CTAs per SM its registers allow
constexpr int G = TI / R;        // threads per column split
constexpr int S = NT / G;        // column splits of a tile
constexpr int CS = TJ / S;       // columns per split
static_assert(G % 32 == 0, "a warp must lie in one column split");
static_assert(TJ % S == 0 && TJ % 32 == 0, "bad column tile");

// The Thole screening factors of thole_common.cuh's damping (B6's), with
// its divisions by 6 and by lam made multiplications by reciprocals
// (inv_lam = 1 / lam): kind 0 none, 1 exponential, 2 linear.
template <typename T>
__device__ __forceinline__ void damping_rcp(T r, T lam, T inv_lam, int kind,
                                            T& d1, T& d2) {
  if (kind == 1) {
    const T x = lam * r;
    const T e = x_exp(-x);
    const T p1 = T(1) + x + T(0.5) * x * x;
    d1 = T(1) - e * p1;
    d2 = T(1) - e * (p1 + x * x * x * T(1.0 / 6.0));
  } else if (kind == 2) {
    const T u = x_min(r * inv_lam, T(1));
    const T u3 = u * u * u;
    d1 = T(4) * u3 - T(3) * u3 * u;
    d2 = u3 * u;
  } else {
    d1 = T(1);
    d2 = T(1);
  }
}

// One pair's field contribution (fx, fy, fz) at row i from column j, given
// the minimum-image dr = r_i - r_j and r2 = |dr|^2.
template <typename T, bool DIPOLE>
__device__ __forceinline__ void pair_field(T rx, T ry, T rz, T r2, T s0,
                                           T s1, T s2, T lam, T inv_lam,
                                           int damp_kind, T& fx, T& fy,
                                           T& fz) {
  const T r2s = r2 > T(1e-12) ? r2 : T(1);
  const T ir = x_rsqrt(r2s);
  const T r = r2s * ir;
  const T inv_r2 = ir * ir;
  const T inv_r3 = inv_r2 * ir;
  T d1, d2;
  damping_rcp<T>(r, lam, inv_lam, damp_kind, d1, d2);
  if (DIPOLE) {
    const T mdotr = s0 * rx + s1 * ry + s2 * rz;
    const T c1 = T(3) * d2 * mdotr * inv_r3 * inv_r2;
    const T c2 = d1 * inv_r3;
    fx = c1 * rx - c2 * s0;
    fy = c1 * ry - c2 * s1;
    fz = c1 * rz - c2 * s2;
  } else {
    const T coef = s0 * d1 * inv_r3;
    fx = coef * rx;
    fy = coef * ry;
    fz = coef * rz;
  }
}

template <typename T>
struct alignas(16) Smem {
  T x[TJ], y[TJ], z[TJ], s0[TJ], s1[TJ], s2[TJ];
  int32_t tag[TJ];          // molecule id of an ok site, -1 otherwise
  double red[S][TI * 3];    // the splits' row sums of one tile
  int last;
};

template <typename T, bool DIPOLE, bool ORTHO>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? MINB : 4)
    thole_field_kernel(const T* __restrict__ pos_all,
                       const T* __restrict__ src_all,
                       const bool* __restrict__ ok_all,
                       const int32_t* __restrict__ mol_all,
                       const T* __restrict__ sc, int sc_stride,
                       const int32_t* __restrict__ wl,
                       const int32_t* __restrict__ chains, int nk, int n,
                       int ni, int nj, int damp_kind,
                       double* __restrict__ part,
                       int32_t* __restrict__ ticket, T* __restrict__ out_all) {
  __shared__ Smem<T> sm;
  const int t = threadIdx.x;
  const int g = t % G;            // row group: rows g, g + G, ...
  const int h = t / G;            // column split
  // the header of the chain in hand (hc: its chain, -1 before the first)
  T lam = T(0), rc2 = T(0), inv_lam = T(0);
  T box[9], bi[9];
  int64_t hc = -1;
  const int nrk = nk * ni;               // row keys
  const int W = wl != nullptr ? wl[0] : nrk * nj;
  const int* rowoff = wl != nullptr ? wl + 1 : nullptr;
  const int* items = wl != nullptr ? wl + 2 + nrk : nullptr;
  const int q0 = int(int64_t(W) * blockIdx.x / gridDim.x);
  const int q1 = int(int64_t(W) * (blockIdx.x + 1) / gridDim.x);

  T xi[R], yi[R], zi[R];
  int32_t ti[R];
  int ri[R];
  int cur = -1;
  size_t cn = 0;                  // the chain's first site: chain index x n
  for (int q = q0; q < q1; ++q) {
    const int item = items != nullptr ? items[q] : q;
    const int rk = item / nj;            // row key k NI + I
    const int J = item - rk * nj;
    const int I = rk % ni;
    if (rk != cur) {
      cur = rk;
      const int k = rk / ni;
      const int64_t c = chains != nullptr ? chains[k] : k;
      cn = size_t(c) * n;
      if (hc < 0 || (sc_stride != 0 && c != hc)) {
        hc = c;
        const T* h = sc + size_t(c) * sc_stride;
        const T rc = h[0];
        lam = h[1];
        rc2 = rc * rc;
        inv_lam = T(1) / lam;
        // a diagonal cell keeps 6 of the 18 cell numbers in registers
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          box[e] = ORTHO && e % 4 != 0 ? T(0) : h[2 + e];
          bi[e] = ORTHO && e % 4 != 0 ? T(0) : h[11 + e];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = I * TI + g + r * G;
        const size_t ci = cn + i;
        const bool iok = i < n && ok_all[ci];
        ri[r] = i;
        ti[r] = iok ? mol_all[ci] : -1;
        xi[r] = iok ? pos_all[3 * ci] : T(0);
        yi[r] = iok ? pos_all[3 * ci + 1] : T(0);
        zi[r] = iok ? pos_all[3 * ci + 2] : T(0);
      }
    }
    __syncthreads();    // the previous tile's columns and sums are consumed
    for (int k = t; k < TJ; k += NT) {
      const int j = J * TJ + k;
      const bool in = j < n;
      const size_t cj = cn + (in ? j : 0);
      sm.tag[k] = in && ok_all[cj] ? mol_all[cj] : -1;
      sm.x[k] = in ? pos_all[3 * cj] : T(0);
      sm.y[k] = in ? pos_all[3 * cj + 1] : T(0);
      sm.z[k] = in ? pos_all[3 * cj + 2] : T(0);
      if (DIPOLE) {
        sm.s0[k] = in ? src_all[3 * cj] : T(0);
        sm.s1[k] = in ? src_all[3 * cj + 1] : T(0);
        sm.s2[k] = in ? src_all[3 * cj + 2] : T(0);
      } else {
        sm.s0[k] = in ? src_all[cj] : T(0);
      }
    }
    __syncthreads();
    double ax[R], ay[R], az[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ax[r] = ay[r] = az[r] = 0.0;
    const int k0 = h * CS;
    for (int k = k0; k < k0 + CS; ++k) {
      const T xj = sm.x[k], yj = sm.y[k], zj = sm.z[k];
      const int32_t tj = sm.tag[k];
      const int j = J * TJ + k;
      T rx[R], ry[R], rz[R], r2[R];
      bool m[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T dx = xi[r] - xj, dy = yi[r] - yj, dz = zi[r] - zj;
        if (ORTHO) {
          // diagonal cell: the general form's cross terms are exact zeros
          rx[r] = frac_image(dx * bi[0]) * box[0];
          ry[r] = frac_image(dy * bi[4]) * box[4];
          rz[r] = frac_image(dz * bi[8]) * box[8];
        } else {
          const T f0 = frac_image(dx * bi[0] + dy * bi[3] + dz * bi[6]);
          const T f1 = frac_image(dx * bi[1] + dy * bi[4] + dz * bi[7]);
          const T f2 = frac_image(dx * bi[2] + dy * bi[5] + dz * bi[8]);
          rx[r] = f0 * box[0] + f1 * box[3] + f2 * box[6];
          ry[r] = f0 * box[1] + f1 * box[4] + f2 * box[7];
          rz[r] = f0 * box[2] + f1 * box[5] + f2 * box[8];
        }
        r2[r] = rx[r] * rx[r] + ry[r] * ry[r] + rz[r] * rz[r];
        m[r] = ti[r] >= 0 && tj >= 0 && ri[r] != j && r2[r] < rc2
               && (DIPOLE || ti[r] != tj);
        any |= m[r];
      }
      // warp-uniform: every lane skips a column none of them needs
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T fx, fy, fz;
        pair_field<T, DIPOLE>(rx[r], ry[r], rz[r], r2[r], sm.s0[k],
                              sm.s1[k], sm.s2[k], lam, inv_lam, damp_kind,
                              fx, fy, fz);
        ax[r] += double(m[r] ? fx : T(0));
        ay[r] += double(m[r] ? fy : T(0));
        az[r] += double(m[r] ? fz : T(0));
      }
    }
    // the tile's partial: splits added in order 0..S-1, one slot per list
    // position
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = g + r * G;
      sm.red[h][3 * row] = ax[r];
      sm.red[h][3 * row + 1] = ay[r];
      sm.red[h][3 * row + 2] = az[r];
    }
    __syncthreads();
    double* slot = part + size_t(q) * (TI * 3);
    for (int e = t; e < TI * 3; e += NT) {
      double s = sm.red[0][e];
#pragma unroll
      for (int hh = 1; hh < S; ++hh) s += sm.red[hh][e];
      slot[e] = s;
    }
    __threadfence();
    __syncthreads();
    const int a0 = rowoff != nullptr ? rowoff[rk] : rk * nj;
    const int a1 = rowoff != nullptr ? rowoff[rk + 1] : (rk + 1) * nj;
    if (t == 0) sm.last = atomicAdd(ticket + rk, 1) == a1 - a0 - 1;
    __syncthreads();
    if (sm.last) {
      // the row tile's last tile: add its slots in column-tile order
      __threadfence();
      for (int e = t; e < TI * 3; e += NT) {
        if (I * TI + e / 3 >= n) break;
        double s = 0.0;
        for (int a = a0; a < a1; ++a)
          s += __ldcg(part + size_t(a) * (TI * 3) + e);
        out_all[3 * cn + size_t(I) * (TI * 3) + e] = T(s);
      }
      if (t == 0) ticket[rk] = 0;     // ready for the next launch
    }
  }
  // rows of a row key with no visited tile: exact zeros, as in the dense
  // sum of skipped tiles
  if (rowoff != nullptr) {
    for (int rk = blockIdx.x; rk < nrk; rk += gridDim.x) {
      if (rowoff[rk + 1] != rowoff[rk]) continue;
      const int k = rk / ni, I = rk % ni;
      T* o = out_all + size_t(chains != nullptr ? chains[k] : k) * n * 3;
      for (int e = t; e < TI * 3 && I * TI + e / 3 < n; e += NT)
        o[size_t(I) * (TI * 3) + e] = T(0);
    }
  }
}

// the grid is sized by the general-cell instance (the same launch bounds
// cap both instances' registers)
template <typename T, bool DIPOLE>
int blocks_per_sm(int* out) {
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, thole_field_kernel<T, DIPOLE, false>, NT, 0));
}

template <typename T>
int thole_config(int dipole, int* out) {
  // out: the CTAs the card holds at once
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const int err = dipole ? blocks_per_sm<T, true>(&per)
                         : blocks_per_sm<T, false>(&per);
  if (err != 0) return err;
  out[0] = sms * per;
  return 0;
}

template <typename T>
int launch_thole_field(const T* pos, const T* src, const bool* ok,
                       const int32_t* mol, const T* sc, int sc_stride,
                       const int32_t* wl,
                       const int32_t* chains, int nk, int n, int ni, int nj,
                       int dipole, int damp_kind, int ortho, int grid,
                       double* part, int32_t* ticket, T* out,
                       cudaStream_t stream) {
  auto kern = dipole ? (ortho ? thole_field_kernel<T, true, true>
                              : thole_field_kernel<T, true, false>)
                     : (ortho ? thole_field_kernel<T, false, true>
                              : thole_field_kernel<T, false, false>);
  kern<<<grid, NT, 0, stream>>>(pos, src, ok, mol, sc, sc_stride, wl, chains,
                                nk, n, ni, nj, damp_kind, part, ticket, out);
  return int(cudaGetLastError());
}

}  // namespace

#define THOLE_FIELD_ENTRY(SFX, T)                                           \
  extern "C" int thole_field_##SFX(                                        \
      const void* pos, const void* src, const void* ok, const void* mol,    \
      const void* sc, int sc_stride, const void* wl, const void* chains,   \
      int nk, int n, int ni, int nj, int dipole, int damp_kind, int ortho,  \
      int grid, void* part, void* ticket, void* out, void* stream) {        \
    return launch_thole_field<T>(                                           \
        (const T*)pos, (const T*)src, (const bool*)ok, (const int32_t*)mol, \
        (const T*)sc, sc_stride, (const int32_t*)wl, (const int32_t*)chains,\
        nk, n, ni, nj, dipole, damp_kind, ortho, grid, (double*)part,       \
        (int32_t*)ticket, (T*)out, (cudaStream_t)stream);                   \
  }                                                                         \
  extern "C" int thole_config_##SFX(int dipole, int* out) {                 \
    return thole_config<T>(dipole, out);                                    \
  }

THOLE_FIELD_ENTRY(f32, float)
THOLE_FIELD_ENTRY(f64, double)
