// The tensor-core, split-S row core of the bf16 / f16 decode kernel
// (decode_attention.cu) and speculative-verify window kernel
// (decode_window.cu). Their float32 paths keep decode_core.cuh's SIMT
// row loop.
//
// One kernel serves both: a (batch row b, head h) has T query rows (the
// window's T = K+1, or decode's one), and query row t attends cache rows
// 0..bound[t] = clip(pos[b] + t, 0, S-1) of the [S, D=H*Dh] plane. The
// decode kernel is this kernel at T = 1, launched with the same grid rule,
// chunk size, warp split, fragment code and merge order, so window row t
// equals the decode kernel at pos + t bit for bit: nothing that a row
// computes depends on another row of the tile (below).
//
// 1. Query tile. The rows t0..t0+15 of one (b, h) are one m16 A tile,
//    read from device memory straight into each warp's A fragments
//    (rows past T are zero and never stored; T > 16 takes further tiles,
//    each reading the cache again). S = Q K^T and O += P V run on
//    `mma.sync m16n8k16` with float32 accumulators (mma_tile.cuh); P is
//    rounded to the value dtype where the C fragment becomes the A
//    fragment (`pack2`), as the plain twins round it. A row's result
//    depends only on its own A row and the shared B fragments, so the
//    tile's padding rows and its other window rows cost no bits.
// 2. Split over S inside one launch. Cache rows are cut into chunks of CH
//    rows (a constant: neither pos nor T moves it). The chunks of one
//    (b, h, row tile) spread over a thread-block cluster of
//    C = min(8, ceil(S / CH)) CTAs; CTA rank r takes chunks r, r + C, ...
//    in order. In a CTA, each chunk is cut into slabs of WARPS x BK rows,
//    and warp w takes rows [w*BK, (w+1)*BK) of every slab: a warp's key
//    tiles are a fixed function of the key index.
// 3. K / V through shared memory. Each warp streams its own key tiles
//    through a private NSTAGE-deep cp.async ring (a wait_group and a
//    __syncwarp a tile, no CTA barrier in the loop). A tile's rows past
//    the CTA's last needed row, max_t bound[t], are zero-filled by
//    cp.async with source size 0 and never read from memory, so stale or
//    uninitialised cache rows never meet a zero weight (0 x NaN is NaN).
//    A CTA whose chunks all start past that row exits at once, before
//    any barrier. The grid comes from S alone: the host never reads pos.
// 4. Masking and the online softmax. Keys past a row's bound score -inf
//    (not the finite NEG_INF), so their weight is exactly 0. A tile with
//    no live key for a row leaves that row's state untouched (with
//    m = -inf, exp(m - m_new) would be NaN); P V of each tile goes into
//    a fresh accumulator and is added to O only for live rows, so a row
//    skipped by one kernel and never visited by the other holds the same
//    bits.
// 5. Merges. The warps' states (m, l, acc) merge through shared memory in
//    warp order, then, after cluster.sync(), the live CTAs' states
//    through distributed shared memory (cluster.map_shared_rank) in rank
//    order; an empty state (m = -inf) is skipped in every merge, never
//    weighted by 0. A second cluster.sync() keeps every live CTA's
//    shared memory alive until its peers have read it.
//
// Exponentials are `ex2.approx` (tc::exp_fast), as in the flash kernels'
// tensor-core tile.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tile.cuh"

namespace dl4j {
namespace decode_tc {

namespace cg = cooperative_groups;

constexpr int ROWS = 16;          // query rows of the m16 tile
constexpr int MAX_CLUSTER = 8;    // CTAs a cluster (the portable limit)

// The geometry, chosen by measurement on an H100 (PERF.md: chunks of 128
// to 1024 rows, 2, 4 or 8 warps, 16- or 32-key warp tiles, 3 or 4 ring
// stages): chunks of CH cache rows, WARPS warps a CTA, BK keys a warp
// tile, NSTAGE ring stages.
constexpr int CH = 512;
constexpr int WARPS = 4;
constexpr int BK = 16;
constexpr int NSTAGE = 3;
constexpr int NT = WARPS * 32;

__host__ __device__ constexpr int cluster_size(int S) {
  return (S + CH - 1) / CH < MAX_CLUSTER ? (S + CH - 1) / CH : MAX_CLUSTER;
}

template <int DH>
struct Geom {
  static constexpr int STRIDE = tc::Pad<DH>::STRIDE;
  // each warp's ring: NSTAGE stages of a K tile and a V tile (at Dh 64,
  // 54 KB a CTA: four CTAs an SM)
  static constexpr int WARP_RING = NSTAGE * 2 * BK * STRIDE;
  static constexpr int BYTES = WARPS * WARP_RING * 2;
  // after the loop the ring holds the warps' states and the CTA's
  static constexpr int STATE_BYTES =
      (WARPS + 1) * ROWS * (DH + 2) * (int)sizeof(float);
  static_assert(STATE_BYTES <= BYTES, "the merge area must fit in the ring");
};

// Rows [row0, row0 + BK) of a [*, DH] matrix of T with row stride ld into
// a padded shared tile, by the 32 lanes of a warp; rows past `last` are
// zero-filled and not read (cp.async with source size 0).
template <typename T, int DH>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int ld,
                                          int row0, int last, int lane) {
  constexpr int CPR = DH * (int)sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int EPC = 16 / (int)sizeof(T);        // elements a chunk
  constexpr int STRIDE = tc::Pad<DH>::STRIDE;
  static_assert(BK * CPR % 32 == 0, "a tile's chunks split over a warp");
#pragma unroll
  for (int i = lane; i < BK * CPR; i += 32) {
    const int r = i / CPR;
    const int c = i - r * CPR;
    const int gr = row0 + r;
    const bool ok = gr <= last;
    tc::cp_async16(dst + r * STRIDE + c * EPC,
                   src + (size_t)(ok ? gr : 0) * ld + c * EPC, ok);
  }
}

// q, o: [B, T, H, Dh] (decode: T = 1); kc, vc: the [B, S, H*Dh] plane.
// Grid (C * ceil(T/16), H, B), clusters of C along x.
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
decode_rows_tc_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, T* __restrict__ o,
                      const int* __restrict__ pos, int pos_scalar, int H,
                      int S, int T_, float scale) {
  using G = Geom<DH>;
  constexpr int STRIDE = G::STRIDE;
  constexpr int KD = DH / 16;            // k chunks of Q K^T
  constexpr int NO = DH / 8;             // output C tiles
  constexpr int NS = BK / 8;             // score C tiles of a warp tile
  constexpr int SLAB = WARPS * BK;
  constexpr int TPC = CH / SLAB;         // a warp's tiles in one chunk
  static_assert(CH % SLAB == 0, "a chunk is whole slabs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t0 = (int)(blockIdx.x / C) * ROWS;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int nt = min(ROWS, T_ - t0);
  const int D = H * DH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tg = lane & 3;

  const int p0 = (pos != nullptr ? pos[b] : pos_scalar) + t0;
  auto clip = [S](int p) { return p < 0 ? 0 : (p > S - 1 ? S - 1 : p); };
  const int last = clip(p0 + nt - 1);   // the bounds rise with t
  int bnd[2];                           // rows g and g + 8; -1: no row
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    bnd[hh] = r < nt ? clip(p0 + r) : -1;
  }
  // ranks 0..nlive-1 hold a chunk that starts at or before `last`; the
  // rest have nothing to add and leave at once (the cluster barrier
  // waits only for threads that have not exited, and no live CTA reads
  // a dead one's shared memory)
  const int nlive = min(C, last / CH + 1);
  if (rank >= nlive) return;

  const T* qb = q + (((size_t)b * T_ + t0) * H + head) * DH;
  const size_t plane = (size_t)b * S * D + (size_t)head * DH;
  const T* kb = kc + plane;
  const T* vb = vc + plane;
  T* wring = ring + warp * G::WARP_RING;
  // first key of the warp's n-th tile
  auto tile_k0 = [&](int n) {
    return (rank + C * (n / TPC)) * CH + (n % TPC) * SLAB + warp * BK;
  };
  auto load_kv = [&](int n) {
    const int k0 = tile_k0(n);
    if (k0 <= last) {
      T* st = wring + (n % NSTAGE) * 2 * BK * STRIDE;
      load_rows<T, DH>(st, kb, D, k0, last, lane);
      load_rows<T, DH>(st + BK * STRIDE, vb, D, k0, last, lane);
    }
    tc::cp_async_commit();   // empty groups keep the count uniform
  };

  float acc[NO][4];
  float m[2], l[2];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[d][c] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = -INFINITY;
    l[hh] = 0.f;
  }

  // Always true past the early exit above, and kept: without it ptxas
  // schedules the loop with 87 registers instead of 99 at Dh 64, and the
  // kernel ran 1.4-10% slower at every decode and window point on an
  // H100 (PERF.md: both builds timed in turns in one call).
  if (rank * CH <= last) {
#pragma unroll
    for (int n = 0; n < NSTAGE - 1; ++n) load_kv(n);
    // the query tile's A fragments, in ldmatrix's layout: a0 / a1 hold
    // rows g / g + 8 at columns 2tg, 2tg + 1; a2 / a3 the same rows 8
    // columns on
    uint32_t qf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1);
        qf[kk][i] = r < nt ? *reinterpret_cast<const uint32_t*>(
                                 qb + (size_t)r * D + kk * 16 + 2 * tg +
                                 8 * (i >> 1))
                           : 0u;
      }

    for (int n = 0; tile_k0(n) <= last; ++n) {
      tc::cp_async_wait<NSTAGE - 2>();   // tile n (this thread's part)
      // every lane's part of tile n is visible, and every lane is done
      // with tile n - 1, whose stage the load below refills
      __syncwarp();
      load_kv(n + NSTAGE - 1);
      const int k0 = tile_k0(n);
      const T* Kt = wring + (n % NSTAGE) * 2 * BK * STRIDE;
      const T* Vt = Kt + BK * STRIDE;

      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int jj = 0; jj < NS / 2; ++jj) {
          uint32_t b0[2], b1[2];
          tc::ldsm_b_nk<STRIDE>(b0, b1, Kt, jj * 16, kk * 16, lane);
          tc::mma<T>(s[2 * jj], qf[kk], b0);
          tc::mma<T>(s[2 * jj + 1], qf[kk], b1);
        }
      }
      // the online softmax of rows g and g + 8; every lane takes part in
      // the quad shuffles, and a row with no live key keeps its state
      bool live[2];
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        live[hh] = k0 <= bnd[hh];
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + j * 8 + 2 * tg + e;
            float sv = s[j][2 * hh + e] * scale;
            if (key > bnd[hh]) sv = -INFINITY;
            s[j][2 * hh + e] = sv;
            tmax = fmaxf(tmax, sv);
          }
        }
        const float m_new = fmaxf(m[hh], tc::quad_max(tmax));
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p =
                live[hh] ? tc::exp_fast(s[j][2 * hh + e] - m_new) : 0.f;
            psum += p;
            s[j][2 * hh + e] = p;
          }
        }
        psum = tc::quad_sum(psum);
        corr[hh] = live[hh] ? tc::exp_fast(m[hh] - m_new) : 1.f;
        if (live[hh]) {
          l[hh] = l[hh] * corr[hh] + psum;
          m[hh] = m_new;
        }
      }
      // O += P V: P rounded to T as it becomes the A operand; each
      // tile's product in a fresh accumulator, added for live rows only
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        tc::c_to_a<T>(pa[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < NO / 2; ++dd) {
        float pv[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[i][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t b0[2], b1[2];
          tc::ldsm_b_kn<STRIDE>(b0, b1, Vt, kk * 16, dd * 16, lane);
          tc::mma<T>(pv[0], pa[kk], b0);
          tc::mma<T>(pv[1], pa[kk], b1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (live[c >> 1])
              acc[2 * dd + i][c] =
                  acc[2 * dd + i][c] * corr[c >> 1] + pv[i][c];
      }
    }
    tc::cp_async_wait<0>();   // no copy outlives the loop
  }
  __syncthreads();   // every warp is done with the ring

  // the warps' states, then the CTA's, in the ring's place
  float* wm = reinterpret_cast<float*>(ring);   // [WARPS][ROWS]
  float* wl = wm + WARPS * ROWS;
  float* wacc = wl + WARPS * ROWS;              // [WARPS][ROWS][DH]
  float* cm = wacc + WARPS * ROWS * DH;         // [ROWS]
  float* cl = cm + ROWS;
  float* cacc = cl + ROWS;                      // [ROWS][DH]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    if (r < nt) {
      float* arow = wacc + (warp * ROWS + r) * DH + 2 * tg;
#pragma unroll
      for (int d = 0; d < NO; ++d) {
        arow[d * 8] = acc[d][2 * hh];
        arow[d * 8 + 1] = acc[d][2 * hh + 1];
      }
      if (tg == 0) {
        wm[warp * ROWS + r] = m[hh];
        wl[warp * ROWS + r] = l[hh];
      }
    }
  }
  __syncthreads();
  // merge the warps in warp order, one thread per (row, column)
  for (int idx = tid; idx < nt * DH; idx += NT) {
    const int t = idx / DH;
    const int c = idx - t * DH;
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, wm[w * ROWS + t]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = wm[w * ROWS + t];
      if (mw == -INFINITY) continue;   // an empty state
      const float cw = tc::exp_fast(mw - mt);
      lt = wl[w * ROWS + t] * cw + lt;
      at = wacc[(w * ROWS + t) * DH + c] * cw + at;
    }
    cacc[t * DH + c] = at;
    if (c == 0) {
      cm[t] = mt;
      cl[t] = lt;
    }
  }
  cluster.sync();   // every CTA's state is complete and visible
  // merge the CTAs in rank order through distributed shared memory
  for (int idx = rank * NT + tid; idx < nt * DH; idx += nlive * NT) {
    const int t = idx / DH;
    const int c = idx - t * DH;
    float mt = -INFINITY;
    for (int r = 0; r < nlive; ++r)
      mt = fmaxf(mt, *cluster.map_shared_rank(cm + t, r));
    float lt = 0.f, at = 0.f;
    for (int r = 0; r < nlive; ++r) {
      const float mr = *cluster.map_shared_rank(cm + t, r);
      if (mr == -INFINITY) continue;   // an empty state
      const float cw = tc::exp_fast(mr - mt);
      lt = *cluster.map_shared_rank(cl + t, r) * cw + lt;
      at = *cluster.map_shared_rank(cacc + t * DH + c, r) * cw + at;
    }
    o[(((size_t)b * T_ + t0 + t) * H + head) * DH + c] =
        Cvt<T>::from(at / lt);
  }
  cluster.sync();   // no CTA leaves while a peer reads its shared memory
}

// Launch decode_rows_tc_kernel: q, o [B, T, H, Dh], k, v the [B, S, H*Dh]
// plane. Returns the cudaError_t of the launch.
template <typename T, int DH>
int launch_rows(const void* q, const void* k, const void* v, void* o,
                const int* pos, int pos_scalar, int B, int T_, int H, int S,
                float scale, cudaStream_t stream) {
  using G = Geom<DH>;
  auto kernel = decode_rows_tc_kernel<T, DH>;
  const int C = cluster_size(S);
  const int tiles = (T_ + ROWS - 1) / ROWS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * tiles, H, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = G::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<T*>(o), pos, pos_scalar, H, S, T_,
                           scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace decode_tc
}  // namespace dl4j
