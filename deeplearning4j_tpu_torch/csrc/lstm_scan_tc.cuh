// The tensor-core variant of the fused LSTM scan (csrc/lstm_scan.cu), for
// a bfloat16 RW: RW split over a thread-block cluster's shared memory, h
// exchanged through distributed shared memory with bulk copies, the
// recurrent product on `mma.sync` (see lstm_scan.cu's header for the
// function and the bound).
//
// Geometry. A cluster of C CTAs (C in {2, 4, 8}) owns M = 16 * MT batch
// rows (MT in {1, 2, 3}); CTA `rank` owns the U units [rank * U, rank * U
// + U), U = ceil(H / C) rounded up to 2 (4 where H is a multiple of 4),
// and all four gate columns of each. Its RW slice, bf16, is loaded into
// shared memory once, before the time loop, as an [n][k] tile whose
// column n = 4u + q holds gate q of unit u: an m16n8k16 tile's columns
// are two whole units, so a C fragment holds every gate of a unit across
// a lane pair, and one shuffle of two floats puts a (row, unit)'s four
// gates in one lane (the even lane takes row g, the odd lane row g + 8).
// c stays in that lane's registers for all T steps. 8 warps; warp w owns
// the n8 tiles w, w + 8, w + 16, w + 24 (at most 32 tiles, U <= 64) for
// all M rows. `geometry` picks C and MT from B and H alone; at the
// char-RNN's B = 1024, H = 200: C = 4, U = 52, M = 48, 22 clusters, 88
// CTAs, one wave.
//
// The product in float32 on bf16 tensor cores. h (float32) splits into
// hi = bf16(h), mid = bf16(h - hi), lo = bf16(h - hi - mid): 24
// significant bits in three parts of 8, so hi + mid + lo = h, and each
// part's product with a bf16 RW entry is exact in float32. z = hi.RW +
// (mid.RW + lo.RW): hi.RW summed two depth chunks (32 products) at a time
// on the tensor cores from zero and added to a float32 sum, the small
// terms in one tensor-core accumulator. The tensor cores' float32 sums
// truncate; accumulated over all 14 chunks of H = 200 the large terms
// drifted past the 1e-5 gate in 64 steps on an H100, in sums of 32
// products they stay within it. Two parts leave 2^-17 |h| out: 4.6x the
// gate from the float64 function over the card test's inputs on an H100
// (PERF.md), so the parts are fixed at three (PARTS). ops/lstm.py's
// `lstm_scan_split_reference` is this arithmetic in PyTorch.
//
// The exchange. The depth of the product is laid out by CTA: block b of
// the h buffer ([3 parts][C blocks][M][US], US = U rounded up to 8, plus 8
// where that is a multiple of 16: rows of an odd number of 16-byte
// groups, so ldmatrix has no bank conflicts) holds CTA b's units, and the
// RW slice's depth follows it. One h buffer and two mbarriers a CTA: at
// step t each CTA reads h_{t-1} (ldmatrix), tells every peer it has
// (a remote arrival on the peer's "free" barrier), waits for its own
// "free" (every peer has read h_{t-1}), writes h_t's parts into its own
// block and sends that block to every peer with one bulk copy a part
// (cp.async.bulk shared::cta -> shared::cluster), which completes bytes
// of the peer's "full" barrier, awaited at step t + 1. No cluster-wide
// barrier a step, no fence over the outputs in flight.
//
// Loads and stores. Each step's xw for the CTA's rows and units goes to
// shared memory by 8-byte cp.async (xw 8-byte aligned: the wrapper
// refuses another) during the product ([4][M][XS], rows
// of 8 bytes times an odd number). The cell update stages a row tile's
// outputs (h, c, i, f, g, o) in shared memory (two halves: the next tile
// writes one while the other's stores read it); each (output, row) run
// then leaves by one bulk store (cp.async.bulk shared -> global, 16-byte
// aligned where H is a multiple of 4), issued by 12 lanes of each warp
// while the warps go on; else by plain coalesced stores. The gates are
// computed branch-free (exp, rcp.approx with a Newton step, within an
// ulp or two of the division; tanh from exp), so a lane's cells
// interleave.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tile.cuh"

namespace dl4j {
namespace lstm_tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int NW = 8;                    // warps a CTA
constexpr int NTH = NW * 32;
constexpr int TILES_A_WARP = 4;          // n8 tiles a warp
constexpr int MAX_TILES = NW * TILES_A_WARP;
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block
constexpr int OUTS = 6;                  // staged outputs: h, c, i, f, g, o
constexpr int PARTS = 3;                 // bf16 parts of h
// the largest H this variant takes: ops/lstm.py's `_lstm_variant` sends
// every bf16-RW call up to it here, and `geometry` finds each a cluster
// (the static_assert below)
constexpr int MAX_H = 352;

// units a CTA owns: ceil(H / C) rounded up to even (an n8 tile holds
// two), or to a multiple of 4 where H is one, so that every CTA's run of a
// bf16 xw row is 8-byte aligned (8-byte cp.async)
__host__ __device__ constexpr int units(int H, int C) {
  return ((H + C - 1) / C + (H % 4 ? 1 : 3)) / (H % 4 ? 2 : 4) *
         (H % 4 ? 2 : 4);
}

// a CTA's block of the product's depth: its units rounded up to 8
__host__ __device__ constexpr int ublock(int H, int C) {
  return (units(H, C) + 7) / 8 * 8;
}

// row stride (elements) of a CTA's block of an h buffer: an odd number of
// 16-byte groups, so the eight rows an ldmatrix phase reads hit distinct
// bank groups
__host__ __device__ constexpr int ustride(int H, int C) {
  return ublock(H, C) / 8 % 2 ? ublock(H, C) : ublock(H, C) + 8;
}

// row stride (elements) of the RW slice: depth C * ublock (a multiple of
// 16) plus 8, an odd number of 16-byte groups
__host__ __device__ constexpr int kstride(int H, int C) {
  return C * ublock(H, C) + 8;
}

// entries of the depth-chunk offset table: 8-value chunks of the depth
// C * ublock <= 8 * 72
constexpr int KOFF = 72;

// bytes ahead of the RW slice: the h buffer's two mbarriers, the depth
// chunk offsets and the per-unit parameters (4 biases, 3 peepholes)
__host__ __device__ constexpr int head_bytes(int U) {
  return 16 + 4 * KOFF + (7 * U * 4 + 15) / 16 * 16;
}

// bytes of one CTA block of one part of one h buffer, [M][ustride] bf16
__host__ __device__ constexpr int block_bytes(int H, int C, int MT) {
  return 16 * MT * ustride(H, C) * 2;
}

// row stride (elements) of the staged xw ([4][M][xstride]): 8 bytes
// times an odd number, so the 16 rows a cell update reads at once hit
// distinct banks and every row is 8-byte aligned
__host__ __device__ constexpr int xstride(int U, int x_size) {
  return (U + 8 / x_size - 1) / (8 / x_size) * (8 / x_size) % (16 / x_size)
             ? (U + 8 / x_size - 1) / (8 / x_size) * (8 / x_size)
             : (U + 8 / x_size - 1) / (8 / x_size) * (8 / x_size) +
                   8 / x_size;
}

// dynamic shared memory of a CTA: barriers and parameters, the RW slice
// [4U][kstride], the h buffer [PARTS][C][M][ustride] (bf16), this step's
// xw [M][4][xstride] (TX) and two row tiles' staged outputs [2][6][16][U]
// (f32)
__host__ __device__ constexpr long smem_bytes(int H, int C, int MT,
                                              int x_size) {
  return head_bytes(units(H, C)) + 2L * 4 * units(H, C) * kstride(H, C) +
         1L * PARTS * C * block_bytes(H, C, MT) +
         (16L * MT * 4 * xstride(units(H, C), x_size) * x_size + 15) / 16 *
             16 +
         2L * 4 * OUTS * 16 * units(H, C);
}

struct Geometry {
  int C;    // CTAs a cluster (2, 4 or 8); 0 where none fits
  int MT;   // 16-row tiles a cluster (1, 2 or 3)
};

// The geometry of B rows of H units with xw elements of x_size bytes:
// three row tiles past B = 32, two past 16, else one (its empty rows
// masked), fewer where shared memory does not fit; then the smallest
// cluster whose units fill at most MAX_TILES n8 tiles a CTA and whose
// shared memory fits. At B = 1024, H = 200: C = 4, MT = 3, 22 clusters of
// 48 rows in one wave; 32 clusters of 32 rows do not all fit an H100 at
// once and took 1.4x as long.
__host__ __device__ constexpr Geometry geometry(int B, int H, int x_size) {
  for (int mt = (B + 15) / 16 < 3 ? (B + 15) / 16 : 3; mt >= 1; --mt)
    for (int c = 2; c <= 8; c *= 2)
      if (units(H, c) / 2 <= MAX_TILES &&
          smem_bytes(H, c, mt, x_size) <= SMEM_LIMIT)
        return Geometry{c, mt};
  return Geometry{0, 0};
}

// one row tile fits at every H up to MAX_H, so every B has a geometry
constexpr bool takes_every_h() {
  for (int h = 1; h <= MAX_H; ++h)
    if (geometry(1, h, 2).C == 0 || geometry(1, h, 4).C == 0) return false;
  return true;
}
static_assert(takes_every_h(), "a cluster must fit every H up to MAX_H");

// 1 / d for d >= 1: rcp.approx and one Newton step (within an ulp or two
// of the division, with no branch to a slow path, so the cell updates of
// a lane's tiles interleave); d is capped where 1 / d is 0 in float32
__device__ __forceinline__ float rcp_ge1(float d) {
  d = fminf(d, 1e30f);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d));
  return fmaf(r, fmaf(-d, r, 1.f), r);
}

__device__ __forceinline__ float sigmoid_nr(float x) {
  return rcp_ge1(1.f + expf(-x));
}

// tanh(x) = sign(x) (1 - e) / (1 + e), e = exp(-2 |x|): within ~1e-7 of
// tanhf absolutely (the limit is 1e-5 + 1e-5 |plain|), branch-free
__device__ __forceinline__ float tanh_nr(float x) {
  const float e = expf(-2.f * fabsf(x));
  return copysignf((1.f - e) * rcp_ge1(1.f + e), x);
}

// x as S bf16 values (held in float), largest first, each the bf16
// rounding of what the earlier ones leave of x
template <int S>
__device__ __forceinline__ void split(float x, float (&p)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    p[s] = __bfloat162float(__float2bfloat16_rn(x));
    x -= p[s];
  }
}

// d = a b on the tensor cores from a zero accumulator: the sum of one
// depth chunk's 16 products, added to a running float32 sum outside
__device__ __forceinline__ void mma_fresh(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// the shared::cluster address of `p` (this CTA's shared memory) in CTA
// `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(tc::smem_u32(p)), "r"(rank));
  return a;
}

// `bytes` (a multiple of 16) from this CTA's shared memory at `src` to a
// peer's at shared::cluster address `dst`; their arrival completes that
// many bytes of the transaction count of the peer's mbarrier at `mbar`
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(tc::smem_u32(src)), "r"(bytes), "r"(mbar)
      : "memory");
}

// `bytes` (a multiple of 16) from this CTA's shared memory at `src` to
// device memory at `dst` (16-byte aligned), in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(tc::smem_u32(src)), "r"(bytes)
      : "memory");
}

// 8 bytes global -> shared, cached in L1 and L2; `ok` false zero-fills
// the destination and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// one arrival on a peer's mbarrier at shared::cluster address `mbar`,
// releasing this CTA's earlier accesses at cluster scope
__device__ __forceinline__ void mbar_arrive_remote(uint32_t mbar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* m, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   tc::smem_u32(m)),
               "r"(count)
               : "memory");
}

// this CTA's one arrival on `m` for the phase, expecting `bytes` more
__device__ __forceinline__ void mbar_expect(uint64_t* m, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          tc::smem_u32(m)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of `m` with this parity completes; acquire at
// cluster scope (the peers' bulk copies are then visible)
__device__ __forceinline__ void mbar_wait(uint64_t* m, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(tc::smem_u32(m)),
      "r"(parity)
      : "memory");
}

// Grid: C * ceil(B / M) CTAs, clusters of C along x; NW warps a CTA.
// The loops around the product run with compile-time trip counts, so
// each warp issues its loads back to back.
template <typename TX, int MT>
__global__ void __launch_bounds__(NTH, 1)
lstm_scan_tc_kernel(const TX* __restrict__ xw, const float* __restrict__ h0,
                    const float* __restrict__ c0,
                    const bf16* __restrict__ rw,
                    const float* __restrict__ bias,
                    const float* __restrict__ p_i,
                    const float* __restrict__ p_f,
                    const float* __restrict__ p_o, float* __restrict__ hs,
                    float* __restrict__ cs, float* __restrict__ gates, int T,
                    int B, int H) {
  constexpr int M = 16 * MT;
  constexpr int E8 = 8 / (int)sizeof(TX);    // xw elements an 8-byte piece
  extern __shared__ __align__(16) unsigned char tc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int U = units(H, C);                 // <= 2 * MAX_TILES = 64
  const int UB = ublock(H, C);               // a CTA's block of the depth
  const int US = ustride(H, C);
  const int KS = kstride(H, C);
  const int K = C * UB;                      // the product's depth
  const int N = 4 * U;
  const int NT = U / 2;                      // n8 tiles of this CTA
  const int H4 = 4 * H;
  const int BLK = M * US;                    // one CTA block of one part
  const int PART = C * BLK;                  // one part of the h buffer
  const int j0 = rank * U;                   // this CTA's first unit
  const int ulim = min(U, H - j0);           // its units below H
  const int row0 = (int)(blockIdx.x / C) * M;
  const int nrows = min(M, B - row0);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(tc_smem);  // h arrived
  uint64_t* s_free = s_full + 1;             // every peer read its h
  int* s_koff = reinterpret_cast<int*>(tc_smem + 16);       // [K / 8]
  float* s_par = reinterpret_cast<float*>(tc_smem + 16 + 4 * KOFF);  // [7][U]
  bf16* s_rw = reinterpret_cast<bf16*>(tc_smem + head_bytes(U));  // [N][KS]
  bf16* s_h = s_rw + (size_t)N * KS;         // [PARTS][C][M][US]
  const int XS = xstride(U, (int)sizeof(TX));
  TX* s_x = reinterpret_cast<TX*>(s_h + (size_t)PARTS * PART);  // [4][M][XS]
  float* s_out = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(s_x) +
      ((size_t)M * 4 * XS * sizeof(TX) + 15) / 16 * 16);    // [2][6][16][U]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bool x8 = H % E8 == 0 && U % E8 == 0;  // 8-byte aligned xw runs
  const int xpieces = (U + E8 - 1) / E8;     // 8-byte pieces an xw run
  const int xruns = 32 / xpieces;            // runs a warp copies at once
  const int xrun = lane / xpieces;
  const int xpiece = lane - xrun * xpieces;
  // the warp's tiles: warp, warp + NW, warp + 2 NW, warp + 3 NW, so each
  // of the SM's four sub-partitions (warps w and w + 4) gets at most two
  // tiles more than another
  auto tile_of = [&](int i) { return warp + NW * i; };
  // 12 lanes of every warp issue the 96 bulk stores of a row tile (the
  // copy engine takes them one at a time; an issuing lane waits its turn)
  const bool bulk_out = H % 4 == 0;          // 16-byte aligned output runs
  const int iss = warp * 12 + lane;          // bulk-store issuer index
  const bool issuer = lane < 12;

  // offset in a part of depth chunk c (8 values): block c / (UB / 8)
  for (int c = tid; c < K / 8; c += NTH)
    s_koff[c] = (c / (UB / 8)) * BLK + (c % (UB / 8)) * 8;
  // biases of gates i, f, g, o and the peepholes pI, pF, pO of each unit
  for (int i = tid; i < 7 * U; i += NTH) {
    const int q = i / U;
    const int j = j0 + i - q * U;
    float v = 0.f;
    if (j < H)
      v = q < 4 ? bias[q * H + j] : (q == 4 ? p_i : q == 5 ? p_f : p_o)[j];
    s_par[i] = v;
  }
  // the RW slice: s_rw[4u + q][kk] = RW[k][q H + j0 + u], where depth
  // index kk = b UB + v stands for unit k = b U + v of CTA b; zero where
  // v >= U, k >= H or j0 + u >= H. A warp takes (kk, q) runs, its lanes
  // consecutive units (coalesced reads of RW's row k), eight runs at once.
#pragma unroll 8
  for (int seg = warp; seg < KS * 4; seg += NW) {
    const int kk = seg >> 2;
    const int q = seg & 3;
    const int b = kk / UB;
    const int k = b * U + kk - b * UB;
    const bool row_ok = kk < K && kk - b * UB < U && k < H;
    const bf16* src = rw + (size_t)(row_ok ? k : 0) * H4 + q * H + j0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int u = lane + 32 * hh;
      if (u < U)
        s_rw[(4 * u + q) * KS + kk] =
            (row_ok && u < ulim) ? src[u] : __float2bfloat16_rn(0.f);
    }
  }
  // the h buffer: the parts of h0 (zero past B, past H and in the pads).
  // A warp takes (block, row) runs.
#pragma unroll 4
  for (int seg = warp; seg < C * M; seg += NW) {
    const int b = seg / M;
    const int r = seg - b * M;
    const bool row_ok = r < nrows;
    const float* src = h0 + (size_t)(row0 + (row_ok ? r : 0)) * H + b * U;
    bf16* dst = s_h + b * BLK + r * US;
#pragma unroll
    for (int hh = 0; hh < 3; ++hh) {           // US <= 72
      const int v = lane + 32 * hh;
      if (v < US) {
        const float h = (row_ok && v < U && b * U + v < H) ? src[v] : 0.f;
        float pp[PARTS];
        split<PARTS>(h, pp);
#pragma unroll
        for (int s = 0; s < PARTS; ++s)
          dst[s * PART + v] = __float2bfloat16_rn(pp[s]);
      }
    }
  }
  // a step brings every peer's block of every part
  const uint32_t step_bytes = (uint32_t)((C - 1) * PARTS * BLK * 2);
  if (tid == 0) {
    mbar_init(s_full, 1);
    mbar_init(s_free, C - 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the lane's (row, unit) of each of its tiles: row m*16 + g + 8 (tq & 1),
  // unit 2 tile + (tq >> 1); its c lives in registers for all T
  const int rl = g + 8 * (tq & 1);
  const int ul = tq >> 1;
  float c[MT][TILES_A_WARP];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < TILES_A_WARP; ++i) {
      const int r = m * 16 + rl;
      const int j = j0 + 2 * tile_of(i) + ul;
      c[m][i] = (tile_of(i) < NT && r < nrows && j < H)
                    ? c0[(size_t)(row0 + r) * H + j] : 0.f;
    }
  // every CTA's buffer and barriers are set before any peer touches them
  cluster.sync();

  // One h buffer, two barriers a CTA. Step t reads h_{t-1} from the
  // buffer; then (t < T - 1) the CTA tells every peer that it has read it
  // (an arrival on the peer's s_free), waits until every peer has read
  // its own (its s_free), writes h_t's block into its buffer and copies
  // it into every peer's, completing bytes of the peer's s_full. Phase t
  // of s_full is h_t's arrival, phase t of s_free step t's reads.
  int ob = 0;                                // s_out half of the next tile
  for (int t = 0; t < T; ++t) {
    if (t > 0) mbar_wait(s_full, (t - 1) & 1);
    const bool send = t + 1 < T;
    if (send && tid == 0) mbar_expect(s_full, step_bytes);

    // this step's xw for the CTA's rows and units into s_x, in flight
    // during the product: a light warp takes (row, gate) runs of U units,
    // its lanes 8-byte pieces (cp.async) where the runs are 8-byte
    // aligned, else plain loads
    {
      const TX* xrow = xw + ((size_t)t * B + row0) * H4 + j0;
      if (x8) {
        // a lane takes piece xpiece of run xrun of each group of xruns
#pragma unroll 4
        for (int seg0 = warp * xruns; seg0 < M * 4; seg0 += NW * xruns) {
          const int seg = seg0 + xrun;
          const int r = seg >> 2;
          const int q = seg & 3;
          const TX* src = xrow + (size_t)(r < nrows ? r : 0) * H4 + q * H;
          const int u = xpiece * E8;
          const bool ok = r < nrows && u < ulim;
          if (xrun < xruns && seg < M * 4 && u < U)
            cp_async8(s_x + (q * M + r) * XS + u, ok ? src + u : xw, ok);
        }
        tc::cp_async_commit();
      } else {
#pragma unroll 4
        for (int seg = warp; seg < M * 4; seg += NW) {
          const int r = seg >> 2;
          const int q = seg & 3;
          const TX* src = xrow + (size_t)(r < nrows ? r : 0) * H4 + q * H;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int u = lane + 32 * hh;
            if (u < U)
              s_x[(q * M + r) * XS + u] =
                  (r < nrows && u < ulim) ? src[u] : Cvt<TX>::from(0.f);
          }
        }
      }
    }

    // z (without xw and b) = hi.RW + (the smaller parts).RW, two depth
    // chunks (32) at a time: hi's two products summed on the tensor cores
    // from zero, then added to its float32 sum, so the tensor cores'
    // truncating sums never run over more than 32 products of hi
    float ahi[MT][TILES_A_WARP][4], alo[MT][TILES_A_WARP][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < TILES_A_WARP; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[m][i][e] = 0.f;
          alo[m][i][e] = 0.f;
        }
    if (tile_of(0) < NT) {
      for (int k0 = 0; k0 < K; k0 += 32) {
        const bool two = k0 + 16 < K;
        // B fragments of each tile for chunks k0 and k0 + 16: rows n0 +
        // (lane & 7), depth k0 + (lane >> 3) * 8
        uint32_t b[TILES_A_WARP][2][2];
        const bf16* brow = s_rw + (lane & 7) * KS + k0 + (lane >> 3) * 8;
#pragma unroll
        for (int i = 0; i < TILES_A_WARP; ++i)
          if (tile_of(i) < NT)
            tc::ldsm_x4(b[i][0][0], b[i][0][1], b[i][1][0], b[i][1][1],
                        brow + tile_of(i) * 8 * KS);
        // the lane's ldmatrix rows of A: depth k + (lane >> 4) * 8 of row
        // lane & 15, for k = k0 and k0 + 16
        const bf16* arow0 =
            s_h + s_koff[(k0 >> 3) + (lane >> 4)] + (lane & 15) * US;
        const bf16* arow1 =
            s_h + s_koff[((k0 + 16) >> 3) + (lane >> 4)] + (lane & 15) * US;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[2][PARTS][4];
#pragma unroll
          for (int s = 0; s < PARTS; ++s) {
            tc::ldsm_x4(a[0][s][0], a[0][s][1], a[0][s][2], a[0][s][3],
                        arow0 + s * PART + m * 16 * US);
            if (two)
              tc::ldsm_x4(a[1][s][0], a[1][s][1], a[1][s][2], a[1][s][3],
                          arow1 + s * PART + m * 16 * US);
          }
          // two tiles at a time, their four chains (hi's pair sum and the
          // small parts' sum of each) step by step: a warp issues in
          // order, so a product that waits on the one just issued would
          // stall it (same sums in the same order as one tile at a time)
          const int nt = min(TILES_A_WARP, (NT - warp + NW - 1) / NW);
#pragma unroll
          for (int i0 = 0; i0 < TILES_A_WARP; i0 += 2) {
            if (i0 >= nt) break;               // warp-uniform
            const bool pair = i0 + 1 < nt;
            float d[2][4];
            // step (part s, chunk kc) of both tiles' chains; the parts'
            // order within a chain is hi, then mid, then lo, chunk k0 first
            auto step = [&](int s, int kc) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if (j == 1 && !pair) break;
                const int i = i0 + j;
                if (s > 0)
                  tc::mma<bf16>(alo[m][i], a[kc][s], b[i][kc]);
                else if (kc == 0)
                  mma_fresh(d[j], a[0][0], b[i][0]);
                else
                  tc::mma<bf16>(d[j], a[1][0], b[i][1]);
              }
            };
            // hi's and mid's chains alternate, so each product is issued
            // four after the one it adds to
#pragma unroll
            for (int kc = 0; kc < 2; ++kc) {
              if (kc == 1 && !two) break;
              step(0, kc);
              step(1, kc);
            }
#pragma unroll
            for (int s = 2; s < PARTS; ++s) {
              step(s, 0);
              if (two) step(s, 1);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (j == 1 && !pair) break;
#pragma unroll
              for (int e = 0; e < 4; ++e) ahi[m][i0 + j][e] += d[j][e];
            }
          }
        }
      }
    }
    if (x8) tc::cp_async_wait<0>();
    __syncthreads();   // s_x is complete, the buffer read
    if (send && tid == 0) {
      // this CTA has read h_{t-1}: its peers may send h_t; then wait until
      // every peer has read its own, so this CTA may overwrite its block
      // (and its copies of h_{t-1}, read from that block, are complete)
      for (int q = 0; q < C; ++q)
        if (q != rank) mbar_arrive_remote(cluster_addr(s_free, q));
      mbar_wait(s_free, t & 1);
    }
    __syncthreads();

    // the cell update, one row tile at a time: outputs staged in half ob
    // of s_out (the other half's stores may still be in flight), h's parts
    // into this CTA's block of the buffer
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float* so_base = s_out + ob * OUTS * 16 * U;
#pragma unroll
      for (int i = 0; i < TILES_A_WARP; ++i) {
        const bool valid = tile_of(i) < NT;   // warp-uniform
        float z[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) z[e] = ahi[m][i][e] + alo[m][i][e];
        // even lanes hold (i, f) of rows g, g + 8, odd lanes (g, o)
        const bool odd = tq & 1;
        const float y0 = __shfl_xor_sync(0xffffffffu, odd ? z[0] : z[2], 1);
        const float y1 = __shfl_xor_sync(0xffffffffu, odd ? z[1] : z[3], 1);
        const float pz[4] = {odd ? y0 : z[0], odd ? y1 : z[1],
                             odd ? z[2] : y0, odd ? z[3] : y1};
        const int r = m * 16 + rl;
        const int u = valid ? 2 * tile_of(i) + ul : 0;
        const float* par = s_par + u;
        const TX* xv = s_x + r * XS + u;
        float zq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          zq[q] = (Cvt<TX>::to(xv[q * M * XS]) + pz[q]) + par[q * U];
        const float cp = c[m][i];
        const float ig = sigmoid_nr(zq[0] + cp * par[4 * U]);
        const float fg = sigmoid_nr(zq[1] + cp * par[5 * U]);
        const float gg = tanh_nr(zq[2]);
        const float cn = fg * cp + ig * gg;
        const float og = sigmoid_nr(zq[3] + cn * par[6 * U]);
        float h = og * tanh_nr(cn);
        c[m][i] = cn;
        if (valid) {
          float* so = so_base + rl * U + u;
          so[0] = h;
          so[16 * U] = cn;
          so[32 * U] = ig;
          so[48 * U] = fg;
          so[64 * U] = gg;
          so[80 * U] = og;
        }
        if (!send) continue;             // uniform: the last step sends none
        if (j0 + u >= H) h = 0.f;        // padded units stay zero
        // lanes tq 0, 1 take unit u + 1 of their row from lane tq + 2 and
        // store both units' parts, packed, in this CTA's block
        const float hn = __shfl_down_sync(0xffffffffu, h, 2);
        if (valid && tq < 2) {
          float pa[PARTS], pb[PARTS];
          split<PARTS>(h, pa);
          split<PARTS>(hn, pb);
          bf16* dst = s_h + rank * BLK + r * US + u;
#pragma unroll
          for (int s = 0; s < PARTS; ++s)
            *reinterpret_cast<uint32_t*>(dst + s * PART) =
                tc::pack2<bf16>(pa[s], pb[s]);
        }
      }
      // the issuers' bulk stores of the tile before last have read its
      // half, which the next tile reuses; this thread's writes are ordered
      // before the bulk copies and stores that read them
      if (bulk_out && issuer)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();   // the tile's outputs (at the last tile, h_t) are in
      if (m == MT - 1 && send && tid == 0) {
        // this CTA's block of h_t's parts into every peer's buffer
        for (int q = 0; q < C; ++q) {
          if (q == rank) continue;
          const uint32_t bar = cluster_addr(s_full, q);
#pragma unroll
          for (int s = 0; s < PARTS; ++s) {
            const bf16* blk = s_h + s * PART + rank * BLK;
            bulk_to_peer(cluster_addr(blk, q), blk, BLK * 2, bar);
          }
        }
      }
      // the tile's outputs to device memory, an (output, row) run each:
      // one bulk store a run, by the light warps while the others go on,
      // or (H odd) a warp's lanes on consecutive units
      if (bulk_out) {
        if (issuer) {
          const int o = iss >> 4;
          const int r = m * 16 + (iss & 15);
          if (r < nrows && ulim > 0) {
            const size_t row = (size_t)t * B + row0 + r;
            float* dst = (o == 0 ? hs + row * H
                         : o == 1 ? cs + row * H
                                  : gates + row * H4 + (o - 2) * H) + j0;
            bulk_store(dst, so_base + iss * U, ulim * 4);
          }
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      } else {
#pragma unroll 2
        for (int seg = warp; seg < OUTS * 16; seg += NW) {
          const int o = seg >> 4;
          const int r = m * 16 + (seg & 15);
          if (r >= nrows) continue;
          const size_t row = (size_t)t * B + row0 + r;
          float* dst = (o == 0 ? hs + row * H
                       : o == 1 ? cs + row * H
                                : gates + row * H4 + (o - 2) * H) + j0;
          const float* src = so_base + seg * U;
          for (int u = lane; u < ulim; u += 32) dst[u] = src[u];
        }
      }
      ob ^= 1;
    }
  }
  // every bulk store written, and every peer done with this CTA's last
  // copies (it read them before its last step), before the CTA ends
  if (bulk_out && issuer)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  cluster.sync();
}

// Launch lstm_scan_tc_kernel on clusters of C CTAs with M = 16 MT rows.
// Returns the cudaError_t of the launch.
template <typename TX, int MT>
int launch_geometry(const TX* xw, const float* h0, const float* c0,
                    const bf16* rw, const float* b, const float* pi,
                    const float* pf, const float* po, float* hs, float* cs,
                    float* gates, int T, int B, int H, int C,
                    cudaStream_t stream) {
  const long smem = smem_bytes(H, C, MT, (int)sizeof(TX));
  auto kernel = lstm_scan_tc_kernel<TX, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + 16 * MT - 1) / (16 * MT)));
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xw, h0, c0, rw, b, pi, pf, po, hs,
                           cs, gates, T, B, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch lstm_scan_tc_kernel at `geometry(B, H)`; refuses an H past
// MAX_H. Returns the cudaError_t of the launch.
template <typename TX>
int launch(const TX* xw, const float* h0, const float* c0, const bf16* rw,
           const float* b, const float* pi, const float* pf,
           const float* po, float* hs, float* cs, float* gates, int T,
           int B, int H, cudaStream_t stream) {
  const Geometry g = geometry(B, H, (int)sizeof(TX));
  if (H > MAX_H || g.C == 0) return (int)cudaErrorInvalidValue;
  switch (g.MT) {
    case 1:
      return launch_geometry<TX, 1>(xw, h0, c0, rw, b, pi, pf, po, hs, cs,
                                    gates, T, B, H, g.C, stream);
    case 2:
      return launch_geometry<TX, 2>(xw, h0, c0, rw, b, pi, pf, po, hs, cs,
                                    gates, T, B, H, g.C, stream);
    default:
      return launch_geometry<TX, 3>(xw, h0, c0, rw, b, pi, pf, po, hs, cs,
                                    gates, T, B, H, g.C, stream);
  }
}

}  // namespace lstm_tc
}  // namespace dl4j
