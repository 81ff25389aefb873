// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/flash_attention.py::_flash_dqkv_kernel
// (launched by _flash_backward). Same math: from q, k, v, dO [BH, *, Dh],
// the forward's float32 row max m and log l (kept SEPARATE, see
// flash_fwd.cu) and delta = rowsum(dO * O), it recomputes each score tile
// with the forward's masking (finite NEG_INF) and
//   P  = exp(s - (m + log l))    when causal and kv_offset <= q_offset,
//   P  = exp((s - m) - log l)    otherwise (a fully-masked row keeps its
//                                uniform P = 1/S, reference :258-259),
//   dV += P^T dO                 with P rounded to dO's dtype,
//   dS  = P * (dO V^T - delta)   zeroed at masked positions, rounded to
//                                q's dtype,
//   dK += dS^T Q,  dQ += dS K,   dK and dQ scaled by `scale` at the end,
// all accumulated in float32 and written in the input dtype.
//
// Design. The TPU kernel walked k tiles in order and carried dQ across
// them in VMEM scratch; GPU blocks run in no order, so the work is split
// into two deterministic launches that each recompute P from (q, k, m,
// log l) and never write the same element twice (no atomics: results do
// not change from run to run):
//   dkdv: one CTA per (batch-head, 64-row k tile), looping over 64-row q
//         tiles;
//   dq:   one CTA per (batch-head, 64-row q tile), looping over k tiles.
// Tiles that contribute exactly zero are skipped under the forward's rule
// only: causal with kv_offset <= q_offset (then every row sees its own
// position, no row is fully masked, and a tile past the diagonal has
// P = 0 and dS = 0). Otherwise every tile runs, so fully-masked rows put
// their uniform P into dV. Ragged tails (T or S not a multiple of 64) are
// masked in the kernel: padded query rows get P = dS = 0 and padded keys
// dS = 0, so any length is taken.
//
// bf16 / f16: the tensor-core tile of mma_tile.cuh (route `mma.sync`
// m16n8k16 with float32 accumulators; see there for why not `wgmma`).
// Four warps a CTA, 16 owned rows a warp.
//   dkdv: the warp owns 16 keys and computes S^T = K Q^T and
//         dP^T = V dO^T directly, its K and V fragments held in registers,
//         so P^T and dS^T come out in the C layout and are repacked in
//         registers (rounded to T) into the A operands of dV += P^T dO
//         and dK += dS^T Q, with no shared-memory transpose; B comes from
//         `ldmatrix` of the staged Q and dO tiles (`.trans` for the
//         accumulations). m, log l and delta are per column, read from
//         staged shared-memory columns. Q, dO and their statistics run
//         through a two-stage `cp.async` ring.
//   dq:   the forward's tile: Q and dO fragments in registers, S = Q K^T
//         and dP = dO V^T, dS = P (dP - delta) repacked, and dQ += dS K
//         from `ldmatrix.trans` of K; K and V through a two-stage ring.
//   Each tile's work is one branch-free block, with a second copy for
//   tiles that hold a masked score or a padded row (see flash_fwd.cu),
//   which also serves every tile of a call where the skip is not safe,
//   so each P takes the reference's form for its call. On the other
//   tiles P = exp(s - (m + log l)) is exp(s * scale - (m + log l)) as
//   one FMA and one `ex2.approx`. At
//   Dh 128 the owned rows' fragments are read from shared memory and
//   the other tile is taken in 16-row passes, so the dK / dV (dQ)
//   accumulators, 128 registers a thread, fit beside the rest
//   (chip_smoke.py prints each instance's registers and spills).
// float32: the earlier SIMT kernels, kept as they were so the f32 path
// stays exact to 1e-5 (tensor cores would mean TF32): tiles staged in
// shared memory as float, two threads per owned row exchanging their
// partner's 32 probabilities by warp shuffle, float32 FMAs.
//
// Bound on this card: at the flagship training shape (16 x 8 heads,
// T = S = 2048, Dh = 64, bf16, causal) the backward does five
// [T, S, Dh] products, halved by causality, ~1.7e11 FLOP (~0.17 ms at the
// bf16 tensor-core peak), against ~0.25 GB of reads and writes (~0.075 ms
// at 3.35 TB/s): bound by operations, which the tensor-core tile now runs
// on the tensor cores. The two launches recompute P (and the dq launch
// dP), seven products where five are needed, and the exponentials, masks
// and repacks run on the SIMT pipe and the special-function unit between
// the mma, in the same phase on every warp of a CTA; that and the
// rate at which mma.sync runs are what stand between the tile and the
// bound.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace dl4j {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;   // two threads per owned row
constexpr int HALF = 32;       // rows of the other tile each thread scores

template <int DH>
struct Smem {
  static constexpr int STRIDE = DH + 4;   // float4-aligned, skews banks
  // four [64, DH] float tiles, plus m / log l / delta columns (dkdv)
  static constexpr int BYTES = (4 * 64 * STRIDE + 3 * 64) * sizeof(float);
};

// dst[c] += sum over the tile's 64 rows j of w_j * rows[j][c0 + c]. Each
// thread holds w for its 32 rows (half * 32 + jj); its partner's 32 come
// by shuffle. `rows` is a [64, STRIDE] shared tile; c0 = half * DH / 2.
template <int DH>
__device__ __forceinline__ void accumulate_rows(float* dst, const float* w,
                                                const float* rows,
                                                int half) {
  constexpr int STRIDE = Smem<DH>::STRIDE;
  constexpr int DC = DH / 2;
  const float* mine = rows + (half * HALF) * STRIDE + half * DC;
  const float* oth = rows + ((1 - half) * HALF) * STRIDE + half * DC;
#pragma unroll
  for (int jj = 0; jj < HALF; ++jj) {
    const float wm = w[jj];
    const float wo = __shfl_xor_sync(0xffffffffu, w[jj], 1);
#pragma unroll
    for (int c = 0; c < DC; c += 4) {
      const float4 a =
          *reinterpret_cast<const float4*>(mine + jj * STRIDE + c);
      const float4 b =
          *reinterpret_cast<const float4*>(oth + jj * STRIDE + c);
      dst[c + 0] += wm * a.x + wo * b.x;
      dst[c + 1] += wm * a.y + wo * b.y;
      dst[c + 2] += wm * a.z + wo * b.z;
      dst[c + 3] += wm * a.w + wo * b.w;
    }
  }
}

// a[jj] = x . rows[half * 32 + jj] and b[jj] = y . rows2[half * 32 + jj]:
// the pair's 32 dot products of two own rows (x, y) with two tiles.
template <int DH>
__device__ __forceinline__ void dot_rows(float* a, float* b, const float* x,
                                         const float* y, const float* rows,
                                         const float* rows2, int half) {
  constexpr int STRIDE = Smem<DH>::STRIDE;
  const float* c1 = rows + half * HALF * STRIDE;
  const float* c2 = rows2 + half * HALF * STRIDE;
#pragma unroll
  for (int jj = 0; jj < HALF; ++jj) {
    a[jj] = 0.f;
    b[jj] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + d);
    const float4 yv = *reinterpret_cast<const float4*>(y + d);
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const float4 u = *reinterpret_cast<const float4*>(c1 + jj * STRIDE + d);
      const float4 w = *reinterpret_cast<const float4*>(c2 + jj * STRIDE + d);
      a[jj] += xv.x * u.x + xv.y * u.y + xv.z * u.z + xv.w * u.w;
      b[jj] += yv.x * w.x + yv.y * w.y + yv.z * w.z + yv.w * w.w;
    }
  }
}

// P of one score from its statistics (the reference's two forms).
__device__ __forceinline__ float prob(float sv, float m, float logl,
                                      bool skip_safe) {
  return skip_safe ? expf(sv - (m + logl)) : expf((sv - m) - logl);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ m,
                      const float* __restrict__ logl,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int tq, int sk, float scale,
                      int causal, int q_offset, int kv_offset) {
  constexpr int STRIDE = Smem<DH>::STRIDE;
  constexpr int DC = DH / 2;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * STRIDE;
  float* Qs = Vs + BK * STRIDE;
  float* Os = Qs + BQ * STRIDE;   // the dO tile
  float* Ms = Os + BQ * STRIDE;
  float* Ls = Ms + BQ;
  float* Ds = Ls + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int r = tid >> 1;       // key row inside the tile
  const int half = tid & 1;     // which 32 q rows / Dh/2 columns
  const int kg = k0 + r + kv_offset;   // global key position
  const bool skip_safe = causal && kv_offset <= q_offset;

  const size_t qrow0 = (size_t)bh * tq;
  const size_t krow0 = (size_t)bh * sk;
  load_tile<T, DH, STRIDE, BK, THREADS>(Ks, k + krow0 * DH, k0, sk);
  load_tile<T, DH, STRIDE, BK, THREADS>(Vs, v + krow0 * DH, k0, sk);

  const int nqb = (tq + BQ - 1) / BQ;
  int start = 0;
  if (skip_safe) {
    // first q tile whose last row reaches this k tile's first key
    const int need = k0 + kv_offset - q_offset - (BQ - 1);
    start = need > 0 ? (need + BQ - 1) / BQ : 0;
    if (start > nqb) start = nqb;
  }

  float dka[DC], dva[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    dka[c] = 0.f;
    dva[c] = 0.f;
  }

  for (int qt = start; qt < nqb; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // previous q tile fully consumed
    load_tile<T, DH, STRIDE, BQ, THREADS>(Qs, q + qrow0 * DH, q0, tq);
    load_tile<T, DH, STRIDE, BQ, THREADS>(Os, dout + qrow0 * DH, q0, tq);
    if (tid < BQ) {
      const bool ok = q0 + tid < tq;
      Ms[tid] = ok ? m[qrow0 + q0 + tid] : 0.f;
      Ls[tid] = ok ? logl[qrow0 + q0 + tid] : 0.f;
      Ds[tid] = ok ? delta[qrow0 + q0 + tid] : 0.f;
    }
    __syncthreads();

    // s = K[r] . Q[j] and dp = V[r] . dO[j] for the pair's 32 q rows j
    float p[HALF], ds[HALF];
    dot_rows<DH>(p, ds, Ks + r * STRIDE, Vs + r * STRIDE, Qs, Os, half);
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const int jl = half * HALF + jj;
      const int j = q0 + jl;
      const bool valid = !causal || j + q_offset >= kg;
      const float sv = valid ? p[jj] * scale : NEG_INF;
      float pv = prob(sv, Ms[jl], Ls[jl], skip_safe);
      float dsv = valid ? pv * (ds[jj] - Ds[jl]) : 0.f;
      if (j >= tq) {   // padded query row: not a row at all
        pv = 0.f;
        dsv = 0.f;
      }
      p[jj] = round_to<T>(pv);
      ds[jj] = round_to<T>(dsv);
    }
    accumulate_rows<DH>(dva, p, Os, half);    // dV[r] += sum_j P dO[j]
    accumulate_rows<DH>(dka, ds, Qs, half);   // dK[r] += sum_j dS Q[j]
  }

  const int row = k0 + r;
  if (row < sk) {
    T* dkrow = dk + (krow0 + row) * DH + half * DC;
    T* dvrow = dv + (krow0 + row) * DH + half * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkrow[c] = Cvt<T>::from(dka[c] * scale);
      dvrow[c] = Cvt<T>::from(dva[c]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ m,
                    const float* __restrict__ logl,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int sk, float scale, int causal, int q_offset,
                    int kv_offset) {
  constexpr int STRIDE = Smem<DH>::STRIDE;
  constexpr int DC = DH / 2;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + BQ * STRIDE;   // the dO tile
  float* Ks = Os + BQ * STRIDE;
  float* Vs = Ks + BK * STRIDE;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 1;       // query row inside the tile
  const int half = tid & 1;     // which 32 keys / Dh/2 columns
  const int row = q0 + r;
  const int qg = row + q_offset;   // global query position
  const bool skip_safe = causal && kv_offset <= q_offset;

  const size_t qrow0 = (size_t)bh * tq;
  const size_t krow0 = (size_t)bh * sk;
  const bool row_ok = row < tq;
  const float mr = row_ok ? m[qrow0 + row] : 0.f;
  const float lr = row_ok ? logl[qrow0 + row] : 0.f;
  const float dr = row_ok ? delta[qrow0 + row] : 0.f;
  load_tile<T, DH, STRIDE, BQ, THREADS>(Qs, q + qrow0 * DH, q0, tq);
  load_tile<T, DH, STRIDE, BQ, THREADS>(Os, dout + qrow0 * DH, q0, tq);

  const int nkb = (sk + BK - 1) / BK;
  int nb = nkb;
  if (skip_safe) {
    // last key a row of this tile can see: its own global position
    const int last_q = q0 + BQ - 1 + q_offset;
    const int lim = (last_q - kv_offset) / BK + 1;
    nb = lim < nkb ? (lim > 0 ? lim : 0) : nkb;
  }

  float dqa[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) dqa[c] = 0.f;

  for (int kt = 0; kt < nb; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // previous k tile fully consumed
    load_tile<T, DH, STRIDE, BK, THREADS>(Ks, k + krow0 * DH, k0, sk);
    load_tile<T, DH, STRIDE, BK, THREADS>(Vs, v + krow0 * DH, k0, sk);
    __syncthreads();

    // s = Q[r] . K[j] and dp = dO[r] . V[j] for the pair's 32 keys j
    float s[HALF], dp[HALF];
    dot_rows<DH>(s, dp, Qs + r * STRIDE, Os + r * STRIDE, Ks, Vs, half);
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const int kl = k0 + half * HALF + jj;
      const bool valid = !causal || qg >= kl + kv_offset;
      const float sv = valid ? s[jj] * scale : NEG_INF;
      const float pv = prob(sv, mr, lr, skip_safe);
      // padded keys (kl >= sk) carry no gradient
      const float dsv = valid && kl < sk ? pv * (dp[jj] - dr) : 0.f;
      s[jj] = round_to<T>(dsv);
    }
    accumulate_rows<DH>(dqa, s, Ks, half);   // dQ[r] += sum_j dS K[j]
  }

  if (row_ok) {
    T* dqrow = dq + (qrow0 + row) * DH + half * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) dqrow[c] = Cvt<T>::from(dqa[c] * scale);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* m, const float* logl, const float* delta, void* dq,
           void* dk, void* dv, int bh, int tq, int sk, float scale,
           int causal, int q_offset, int kv_offset, cudaStream_t stream) {
  const int bytes = Smem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  flash_bwd_dkdv_kernel<T, DH>
      <<<dim3(bh, (sk + BK - 1) / BK), THREADS, bytes, stream>>>(
          qt, kt, vt, ot, m, logl, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), tq, sk, scale, causal, q_offset, kv_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, DH>
      <<<dim3(bh, (tq + BQ - 1) / BQ), THREADS, bytes, stream>>>(
          qt, kt, vt, ot, m, logl, delta, static_cast<T*>(dq), tq, sk,
          scale, causal, q_offset, kv_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 / f16: the tensor-core tile
// ---------------------------------------------------------------------------

template <int DH>
struct TcBwd {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
  static constexpr int THREADS = 128;   // four warps, 16 owned rows each
  static constexpr int STRIDE = tc::Pad<DH>::STRIDE;
  static constexpr int TILE = 64 * STRIDE;   // elements of a [64, DH] tile
  // six tiles (dkdv: K, V and two stages of Q and dO; dq: Q, dO and two
  // stages of K and V), then two stages of the m / log l / delta columns
  static constexpr int BYTES = 6 * TILE * 2 + 2 * 3 * BQ * 4;
  // Dh <= 64: the owned rows' A fragments stay in registers and a pass
  // covers the whole other tile; Dh 128 reads the fragments from shared
  // memory and takes the other tile in halves, so the dK / dV (dQ)
  // accumulators fit the register file without spills
  static constexpr bool FRAG_REGS = DH <= 64;
  static constexpr int PASS = DH <= 64 ? 64 : 16;
};

// dK / dV: a CTA per (batch-head, 64-key tile), a warp per 16 keys,
// looping over the q tiles. S^T = K Q^T and dP^T = V dO^T come out with
// keys as rows, so P^T and dS^T are already the A operands of
// dV += P^T dO and dK += dS^T Q (B from ldmatrix.trans of the staged Q
// and dO tiles); m, log l and delta are per column, read from the staged
// shared-memory columns.
template <typename T, int DH>
__global__ void __launch_bounds__(TcBwd<DH>::THREADS)
flash_bwd_dkdv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ logl,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int tq, int sk, float scale,
                         int causal, int q_offset, int kv_offset) {
  using G = TcBwd<DH>;
  constexpr int BQ = G::BQ;
  constexpr int BK = G::BK;
  constexpr int NT = G::THREADS;
  constexpr int STRIDE = G::STRIDE;
  constexpr int TILE = G::TILE;
  constexpr int PASS = G::PASS;   // q columns a pass
  constexpr int KD = DH / 16;
  constexpr int NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE;
  T* Qs = Vs + TILE;       // two stages
  T* Os = Qs + 2 * TILE;   // two stages of the dO tile
  float* Ss = reinterpret_cast<float*>(Os + 2 * TILE);   // 2 x [m|logl|delta]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int kr0 = (tid >> 5) * 16;           // the warp's first key row
  const int kg_first = k0 + kr0 + kv_offset;   // its global position
  const bool skip_safe = causal && kv_offset <= q_offset;
  const size_t qrow0 = (size_t)bh * tq;
  const size_t krow0 = (size_t)bh * sk;
  const T* qb = q + qrow0 * DH;
  const T* ob = dout + qrow0 * DH;

  const int nqb = (tq + BQ - 1) / BQ;
  int start = 0;
  if (skip_safe) {
    // first q tile whose last row reaches this k tile's first key
    const int need = k0 + kv_offset - q_offset - (BQ - 1);
    start = need > 0 ? (need + BQ - 1) / BQ : 0;
    if (start > nqb) start = nqb;
  }

  auto load_q = [&](int qt, int stage) {
    const int q0 = qt * BQ;
    tc::load_tile<T, DH, BQ, NT>(Qs + stage * TILE, qb, q0, tq, tid);
    tc::load_tile<T, DH, BQ, NT>(Os + stage * TILE, ob, q0, tq, tid);
    float* st = Ss + stage * 3 * BQ;
    tc::load_col<BQ, NT>(st, m + qrow0, q0, tq, tid);
    tc::load_col<BQ, NT>(st + BQ, logl + qrow0, q0, tq, tid);
    tc::load_col<BQ, NT>(st + 2 * BQ, delta + qrow0, q0, tq, tid);
  };

  tc::load_tile<T, DH, BK, NT>(Ks, k + krow0 * DH, k0, sk, tid);
  tc::load_tile<T, DH, BK, NT>(Vs, v + krow0 * DH, k0, sk, tid);
  if (start < nqb) load_q(start, 0);
  tc::cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dka[d][c] = 0.f;
      dva[d][c] = 0.f;
    }
  uint32_t kf[KD][4], vf[KD][4];   // the owned keys' A fragments
  const tc::BwdArgs args{tq, sk, scale, scale * tc::LOG2E, causal,
                         q_offset, kv_offset, skip_safe};

  for (int qt = start, it = 0; qt < nqb; ++qt, ++it) {
    const int q0 = qt * BQ;
    const int stage = it & 1;
    if (qt + 1 < nqb) {   // the next q tile loads while this one computes
      load_q(qt + 1, stage ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (G::FRAG_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          tc::ldsm_a<STRIDE>(kf[kk], Ks, kr0, kk * 16, lane);
          tc::ldsm_a<STRIDE>(vf[kk], Vs, kr0, kk * 16, lane);
        }
      }
    }
    const T* Qt = Qs + stage * TILE;
    const T* Ot = Os + stage * TILE;
    const float* Mt = Ss + stage * 3 * BQ;
    const float* Lt = Mt + BQ;
    const float* Dt = Mt + 2 * BQ;
    // with skip_safe, a q tile wholly before this warp's first key adds
    // exactly zero (P = 0, dS = 0)
    if (!(skip_safe && q0 + BQ - 1 + q_offset < kg_first)) {
      if (!skip_safe || (causal && q0 + q_offset < kg_first + 15) ||
          q0 + BQ > tq || k0 + BK > sk)
        tc::dkdv_tile<T, DH, STRIDE, PASS, G::FRAG_REGS, true>(
            dka, dva, kf, vf, Ks, Vs, kr0, k0, Qt, Ot, Mt, Lt, Dt, q0,
            nullptr, args, lane);
      else
        tc::dkdv_tile<T, DH, STRIDE, PASS, G::FRAG_REGS, false>(
            dka, dva, kf, vf, Ks, Vs, kr0, k0, Qt, Ot, Mt, Lt, Dt, q0,
            nullptr, args, lane);
    }
    __syncthreads();   // this stage is free for the tile after next
  }
  tc::cp_async_wait<0>();   // no copy outlives the CTA (empty q loop)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + kr0 + g + 8 * h;
    if (row < sk) {
      T* dkrow = dk + (krow0 + row) * DH + 2 * tg;
      T* dvrow = dv + (krow0 + row) * DH + 2 * tg;
#pragma unroll
      for (int d = 0; d < NO; ++d) {
        *reinterpret_cast<uint32_t*>(dkrow + d * 8) = tc::pack2<T>(
            dka[d][2 * h] * scale, dka[d][2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvrow + d * 8) =
            tc::pack2<T>(dva[d][2 * h], dva[d][2 * h + 1]);
      }
    }
  }
}

// dQ: a CTA per (batch-head, 64-row q tile), a warp per 16 query rows,
// looping over the k tiles (two-stage cp.async ring of K and V): the
// forward's tile with dP = dO V^T beside S = Q K^T, dS repacked in
// registers, and dQ += dS K from ldmatrix.trans of K.
template <typename T, int DH>
__global__ void __launch_bounds__(TcBwd<DH>::THREADS)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ m,
                       const float* __restrict__ logl,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int tq, int sk, float scale, int causal, int q_offset,
                       int kv_offset) {
  using G = TcBwd<DH>;
  constexpr int BQ = G::BQ;
  constexpr int BK = G::BK;
  constexpr int NT = G::THREADS;
  constexpr int STRIDE = G::STRIDE;
  constexpr int TILE = G::TILE;
  constexpr int PASS = G::PASS;   // keys a pass
  constexpr int KD = DH / 16;
  constexpr int NO = DH / 8;
  constexpr int NP = PASS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Os = Qs + TILE;       // the dO tile
  T* Ks = Os + TILE;       // two stages
  T* Vs = Ks + 2 * TILE;   // two stages

  const int bh = blockIdx.x;
  // the longest (last, under causality) q tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wr0 = (tid >> 5) * 16;   // the warp's first row in the tile
  const bool skip_safe = causal && kv_offset <= q_offset;
  const size_t qrow0 = (size_t)bh * tq;
  const size_t krow0 = (size_t)bh * sk;
  const T* kb = k + krow0 * DH;
  const T* vb = v + krow0 * DH;

  float mr[2], lr[2], dr[2], ml2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr0 + g + 8 * h;
    const bool ok = row < tq;
    mr[h] = ok ? m[qrow0 + row] : 0.f;
    lr[h] = ok ? logl[qrow0 + row] : 0.f;
    dr[h] = ok ? delta[qrow0 + row] : 0.f;
    ml2[h] = (mr[h] + lr[h]) * tc::LOG2E;
  }
  const float scale_log2 = scale * tc::LOG2E;

  const int nkb = (sk + BK - 1) / BK;
  int nb = nkb;
  if (skip_safe) {
    // last key a row of this tile can see: its own global position
    const int last_q = q0 + BQ - 1 + q_offset;
    const int lim = (last_q - kv_offset) / BK + 1;
    nb = lim < nkb ? (lim > 0 ? lim : 0) : nkb;
  }

  tc::load_tile<T, DH, BQ, NT>(Qs, q + qrow0 * DH, q0, tq, tid);
  tc::load_tile<T, DH, BQ, NT>(Os, dout + qrow0 * DH, q0, tq, tid);
  tc::load_tile<T, DH, BK, NT>(Ks, kb, 0, sk, tid);
  tc::load_tile<T, DH, BK, NT>(Vs, vb, 0, sk, tid);
  tc::cp_async_commit();

  float dqa[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dqa[d][c] = 0.f;
  uint32_t qf[G::FRAG_REGS ? KD : 1][4], of[G::FRAG_REGS ? KD : 1][4];
  // global positions of the warp's first and last query rows
  const int wq_first = q0 + wr0 + q_offset;
  const int wq_last = wq_first + 15;

  for (int kt = 0; kt < nb; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nb) {   // the next tile loads while this one computes
      const int nxt = ((kt + 1) & 1) * TILE;
      tc::load_tile<T, DH, BK, NT>(Ks + nxt, kb, k0 + BK, sk, tid);
      tc::load_tile<T, DH, BK, NT>(Vs + nxt, vb, k0 + BK, sk, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (G::FRAG_REGS) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          tc::ldsm_a<STRIDE>(qf[kk], Qs, wr0, kk * 16, lane);
          tc::ldsm_a<STRIDE>(of[kk], Os, wr0, kk * 16, lane);
        }
      }
    }
    const T* Kt = Ks + (kt & 1) * TILE;
    const T* Vt = Vs + (kt & 1) * TILE;
    // with skip_safe, a tile wholly past the diagonal for every row of
    // this warp adds exactly zero
    if (!(skip_safe && wq_last < k0 + kv_offset)) {
      // one branch-free block per mask kind (see flash_fwd.cu)
      auto tile = [&](auto masked_tag) {
        constexpr bool MASKED = decltype(masked_tag)::value;
#pragma unroll
        for (int kc = 0; kc < BK; kc += PASS) {
          float s[NP][4], dp[NP][4];
#pragma unroll
          for (int j = 0; j < NP; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              s[j][c] = 0.f;
              dp[j][c] = 0.f;
            }
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            uint32_t qa[4], oa[4];
            if constexpr (G::FRAG_REGS) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                qa[i] = qf[kk][i];
                oa[i] = of[kk][i];
              }
            } else {
              tc::ldsm_a<STRIDE>(qa, Qs, wr0, kk * 16, lane);
              tc::ldsm_a<STRIDE>(oa, Os, wr0, kk * 16, lane);
            }
#pragma unroll
            for (int jj = 0; jj < NP / 2; ++jj) {
              uint32_t b0[2], b1[2];
              tc::ldsm_b_nk<STRIDE>(b0, b1, Kt, kc + jj * 16, kk * 16, lane);
              tc::mma<T>(s[2 * jj], qa, b0);
              tc::mma<T>(s[2 * jj + 1], qa, b1);
              tc::ldsm_b_nk<STRIDE>(b0, b1, Vt, kc + jj * 16, kk * 16, lane);
              tc::mma<T>(dp[2 * jj], oa, b0);
              tc::mma<T>(dp[2 * jj + 1], oa, b1);
            }
          }
#pragma unroll
          for (int j = 0; j < NP; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int h = c >> 1;
              float dsv;
              if constexpr (MASKED) {
                const int kl = k0 + kc + j * 8 + 2 * tg + (c & 1);
                const bool valid =
                    !causal || wq_first + g + 8 * h >= kl + kv_offset;
                const float sv = valid ? s[j][c] * scale : NEG_INF;
                const float pv = tc::prob(sv, mr[h], lr[h], skip_safe);
                // padded keys (kl >= sk) carry no gradient
                dsv = valid && kl < sk ? pv * (dp[j][c] - dr[h]) : 0.f;
              } else {
                // skip_safe and no masked score here: P in the folded
                // form exp(s - (m + log l)) as one FMA and one ex2
                dsv = tc::exp2_fast(fmaf(s[j][c], scale_log2, -ml2[h])) *
                      (dp[j][c] - dr[h]);
              }
              s[j][c] = dsv;
            }
          }
          // dQ += dS K; dS rounded to T here
#pragma unroll
          for (int kk = 0; kk < PASS / 16; ++kk) {
            uint32_t da[4];
            tc::c_to_a<T>(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int dd = 0; dd < NO / 2; ++dd) {
              uint32_t b0[2], b1[2];
              tc::ldsm_b_kn<STRIDE>(b0, b1, Kt, kc + kk * 16, dd * 16, lane);
              tc::mma<T>(dqa[2 * dd], da, b0);
              tc::mma<T>(dqa[2 * dd + 1], da, b1);
            }
          }
        }
      };
      if (!skip_safe || (causal && wq_first < k0 + BK - 1 + kv_offset) ||
          k0 + BK > sk)
        tile(std::true_type{});
      else
        tile(std::false_type{});
    }
    __syncthreads();   // this stage is free for the tile after next
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr0 + g + 8 * h;
    if (row < tq) {
      T* dqrow = dq + (qrow0 + row) * DH + 2 * tg;
#pragma unroll
      for (int d = 0; d < NO; ++d)
        *reinterpret_cast<uint32_t*>(dqrow + d * 8) = tc::pack2<T>(
            dqa[d][2 * h] * scale, dqa[d][2 * h + 1] * scale);
    }
  }
}

template <typename T, int DH>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* m, const float* logl, const float* delta,
              void* dq, void* dk, void* dv, int bh, int tq, int sk,
              float scale, int causal, int q_offset, int kv_offset,
              cudaStream_t stream) {
  using G = TcBwd<DH>;
  const int bytes = G::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_tc_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  flash_bwd_dkdv_tc_kernel<T, DH>
      <<<dim3(bh, (sk + G::BK - 1) / G::BK), G::THREADS, bytes, stream>>>(
          qt, kt, vt, ot, m, logl, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), tq, sk, scale, causal, q_offset, kv_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_tc_kernel<T, DH>
      <<<dim3(bh, (tq + G::BQ - 1) / G::BQ), G::THREADS, bytes, stream>>>(
          qt, kt, vt, ot, m, logl, delta, static_cast<T*>(dq), tq, sk,
          scale, causal, q_offset, kv_offset);
  return (int)cudaGetLastError();
}

// float32 keeps the SIMT kernels; bf16 / f16 take the tensor-core tile
template <typename T, int DH>
int launch_dtype(const void* q, const void* k, const void* v,
                 const void* dout, const float* m, const float* logl,
                 const float* delta, void* dq, void* dk, void* dv, int bh,
                 int tq, int sk, float scale, int causal, int q_offset,
                 int kv_offset, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch<T, DH>(q, k, v, dout, m, logl, delta, dq, dk, dv, bh, tq,
                         sk, scale, causal, q_offset, kv_offset, stream);
  else
    return launch_tc<T, DH>(q, k, v, dout, m, logl, delta, dq, dk, dv, bh,
                            tq, sk, scale, causal, q_offset, kv_offset,
                            stream);
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                const void* dout, const float* m, const float* logl,
                const float* delta, void* dq, void* dk, void* dv, int bh,
                int tq, int sk, float scale, int causal, int q_offset,
                int kv_offset, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_dtype<T, 32>(q, k, v, dout, m, logl, delta, dq, dk, dv,
                                 bh, tq, sk, scale, causal, q_offset,
                                 kv_offset, stream);
    case 64:
      return launch_dtype<T, 64>(q, k, v, dout, m, logl, delta, dq, dk, dv,
                                 bh, tq, sk, scale, causal, q_offset,
                                 kv_offset, stream);
    case 128:
      return launch_dtype<T, 128>(q, k, v, dout, m, logl, delta, dq, dk, dv,
                                  bh, tq, sk, scale, causal, q_offset,
                                  kv_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, dout, dq: contiguous [bh, tq, dh]; k, v, dk, dv: [bh, sk, dh], all of
// one dtype; m, logl, delta: float32 [bh, tq]. Launches the dK/dV kernel,
// then the dQ kernel, on `stream`. Returns the first cudaError_t.
extern "C" int dl4j_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* m,
                              const void* logl, const void* delta, void* dq,
                              void* dk, void* dv, int bh, int tq, int sk,
                              int dh, int dtype, float scale, int causal,
                              int q_offset, int kv_offset, void* stream) {
  using namespace dl4j;
  if (bh <= 0 || tq <= 0 || sk <= 0 || (tq + BQ - 1) / BQ > 65535 ||
      (sk + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(logl);
  const float* df = static_cast<const float*>(delta);
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_dh<float>(dh, q, k, v, dout, mf, lf, df, dq, dk, dv,
                                bh, tq, sk, scale, causal, q_offset,
                                kv_offset, s);
    case DTYPE_F16:
      return dispatch_dh<__half>(dh, q, k, v, dout, mf, lf, df, dq, dk, dv,
                                 bh, tq, sk, scale, causal, q_offset,
                                 kv_offset, s);
    case DTYPE_BF16:
      return dispatch_dh<__nv_bfloat16>(dh, q, k, v, dout, mf, lf, df, dq,
                                        dk, dv, bh, tq, sk, scale, causal,
                                        q_offset, kv_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
