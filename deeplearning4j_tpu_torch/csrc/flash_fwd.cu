// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/flash_attention.py::_flash_fwd_kernel
// (launched by _flash_forward_impl). Same math: causal or full attention
// on [BH, T, Dh] with static q/kv position offsets, online softmax over
// [BQ, BK] score tiles with float32 statistics and accumulation, the
// probabilities rounded to the value dtype before the PV product, and the
// row max m and log l returned as SEPARATE float32 columns (their sum
// loses fully-masked rows to float32 rounding, see the reference's
// :186-194). Masked scores are the finite NEG_INF = -1e30, so a fully
// masked row (kv_offset > q_offset) averages uniformly as in JAX; ragged
// keys (S not a multiple of the k tile) score -inf, and ragged query rows
// are never stored. Causal k tiles past the diagonal are skipped only
// when kv_offset <= q_offset (the reference's _qtile_bounds: then every
// row sees its own position and no row can be fully masked).
//
// Design, bf16 / f16 (the tensor-core tile of mma_tile.cuh, route
// `mma.sync` m16n8k16; see there for why not `wgmma`). FlashAttention-2
// shape: one CTA per (batch-head, q tile), each warp owning 16 query
// rows (128 rows on 8 warps at Dh <= 64, 64 on 4 at Dh 128: TcGeom).
// The warp loads its Q fragments once (`ldmatrix`) and keeps them in
// registers; K and V tiles of 64 keys run
// through a two-stage `cp.async` ring with one barrier a tile, so tile
// k+1 loads while tile k computes. S = Q K^T by `mma` from `ldmatrix` of
// K; the online softmax on the quad of lanes that holds a row; P rounded
// to T while it is repacked in registers into A fragments, and O += P V
// from `ldmatrix.trans` of V. The score tile never leaves registers.
// Each tile's work is one branch-free block (two copies: tiles that
// straddle the diagonal or the ragged tail mask their scores, the rest
// do not), so ptxas can interleave the exponentials with the products
// around them. On an unmasked tile the row max is taken on the raw
// scores and scaled once (the rounding of a product by scale > 0 is
// monotonic, so it equals the max of the scaled scores), and
// exp(s * scale - m) is one FMA and one `ex2.approx`. A warp whose rows
// all lie before a tile's first key skips it (it would add exactly
// zero). The epilogue writes O / l, m and log l.
//
// Design, float32: the earlier SIMT kernel, kept as it was so the f32
// path stays exact to 1e-5 (tensor cores would mean TF32): one CTA of
// 128 threads per (batch-head, 64-row q tile), tiles staged in shared
// memory as float, two threads per query row exchanging statistics and
// probabilities by warp shuffles, float32 FMAs.
//
// Bound on this card: at the engine's prefill bucket (64 slots x 8 heads,
// T=1024, Dh=64, bf16, causal) the work is ~6.9e10 FLOP against ~273 MB
// of q/k/v/o/m/log l, i.e. byte-bound at ~81 us on an H100 SXM (the FLOP
// alone take ~70 us at the bf16 tensor-core peak). The tensor-core tile
// moves the products off the FMA pipe onto the tensor cores and halves
// the shared-memory traffic of the SIMT design. What is left between it
// and the bound: between two barriers every warp of a CTA runs the same
// phase (products, then exponentials on the special-function unit, then
// products), so the pipes take turns more than they overlap, and
// mma.sync runs below the wgmma rate. A variant that started the next
// tile's Q K^T beside this tile's softmax needed 32 more registers a
// thread and lost to the lower occupancy (PERF.md); wgmma with two
// warpgroups in ping-pong is the next design.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace dl4j {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;   // two threads per q row
constexpr int HALF = BK / 2;   // scores per thread per k tile

template <int DH>
struct Smem {
  static constexpr int STRIDE = DH + 4;   // float4-aligned, skews banks
  static constexpr int BYTES = (BQ + 2 * BK) * STRIDE * sizeof(float);
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ logl_out,
                 int tq, int sk, float scale, int causal, int q_offset,
                 int kv_offset) {
  constexpr int STRIDE = Smem<DH>::STRIDE;
  constexpr int DC = DH / 2;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * STRIDE;
  float* Vs = Ks + BK * STRIDE;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 1;       // q row inside the tile
  const int half = tid & 1;     // which 32 scores / Dh/2 columns
  const int qg = q0 + r + q_offset;   // global query position

  const T* qb = q + (size_t)bh * tq * DH;
  const T* kb = k + (size_t)bh * sk * DH;
  const T* vb = v + (size_t)bh * sk * DH;

  load_tile<T, DH, STRIDE, BQ, THREADS>(Qs, qb, q0, tq);

  const int nkb = (sk + BK - 1) / BK;
  int nb = nkb;
  if (causal && kv_offset <= q_offset) {
    // last key a row of this tile can see: its own global position
    const int last_q = q0 + BQ - 1 + q_offset;
    const int lim = (last_q - kv_offset) / BK + 1;
    nb = lim < nkb ? (lim > 0 ? lim : 0) : nkb;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  for (int kt = 0; kt < nb; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // previous tile fully consumed
    load_tile<T, DH, STRIDE, BK, THREADS>(Ks, kb, k0, sk);
    load_tile<T, DH, STRIDE, BK, THREADS>(Vs, vb, k0, sk);
    __syncthreads();

    // scores for columns half*32 .. half*32+31
    float s[HALF];
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) s[jj] = 0.f;
    const float* qrow = Qs + r * STRIDE;
    const float* kcol = Ks + half * HALF * STRIDE;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int jj = 0; jj < HALF; ++jj) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kcol + jj * STRIDE + d);
        s[jj] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const int kl = k0 + half * HALF + jj;
      float sv = s[jj] * scale;
      if (causal && qg < kl + kv_offset) sv = NEG_INF;
      if (kl >= sk) sv = -INFINITY;   // ragged tail: not a key at all
      s[jj] = sv;
      tmax = fmaxf(tmax, sv);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      s[jj] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= corr;

    // acc[c] += sum_j p[j] * V[j][half*DC + c] over all 64 columns: the
    // thread's own 32 probabilities plus its partner's, by shuffle
    const float* vmine = Vs + (half * HALF) * STRIDE + half * DC;
    const float* voth = Vs + ((1 - half) * HALF) * STRIDE + half * DC;
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const float pm = s[jj];
      const float po = __shfl_xor_sync(0xffffffffu, s[jj], 1);
#pragma unroll
      for (int c = 0; c < DC; c += 4) {
        const float4 a =
            *reinterpret_cast<const float4*>(vmine + jj * STRIDE + c);
        const float4 b =
            *reinterpret_cast<const float4*>(voth + jj * STRIDE + c);
        acc[c + 0] += pm * a.x + po * b.x;
        acc[c + 1] += pm * a.y + po * b.y;
        acc[c + 2] += pm * a.z + po * b.z;
        acc[c + 3] += pm * a.w + po * b.w;
      }
    }
  }

  const int row = q0 + r;
  if (row < tq) {
    T* orow = o + ((size_t)bh * tq + row) * DH + half * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = Cvt<T>::from(acc[c] / l);
    if (half == 0) {
      m_out[(size_t)bh * tq + row] = m;
      logl_out[(size_t)bh * tq + row] = logf(l);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* logl, int bh, int tq, int sk, float scale, int causal,
           int q_offset, int kv_offset, cudaStream_t stream) {
  const int bytes = Smem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (tq + BQ - 1) / BQ);
  flash_fwd_kernel<T, DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, logl, tq, sk, scale,
      causal, q_offset, kv_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 / f16: the tensor-core tile
// ---------------------------------------------------------------------------

// Dh <= 64: 128 q rows on 8 warps, the best of the geometries swept at
// the main path's shapes (it halves the K / V traffic of 64-row tiles;
// PERF.md); Dh 128: 64 rows on 4 warps, so one thread's 168 registers
// leave room for two CTAs an SM.
template <int DH>
struct TcGeom {
  static constexpr int NW = DH <= 64 ? 8 : 4;   // warps, 16 q rows each
  static constexpr int BQ = 16 * NW;            // q rows a CTA
  static constexpr int BK = 64;                 // keys a k tile
  static constexpr int THREADS = 32 * NW;
  static constexpr int STRIDE = tc::Pad<DH>::STRIDE;
  // the Q tile and two stages of K and V, 2-byte elements
  static constexpr int BYTES = (BQ + 4 * BK) * STRIDE * 2;
};

template <typename T, int DH>
__global__ void __launch_bounds__(TcGeom<DH>::THREADS)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ logl_out,
                    int tq, int sk, float scale, int causal, int q_offset,
                    int kv_offset) {
  using G = TcGeom<DH>;
  constexpr int BQ = G::BQ;
  constexpr int BK = G::BK;
  constexpr int NT = G::THREADS;
  constexpr int STRIDE = G::STRIDE;
  constexpr int KD = DH / 16;   // k chunks of Q K^T
  constexpr int NS = BK / 8;    // score C tiles of the warp's 16 rows
  constexpr int NO = DH / 8;    // output C tiles of the warp's 16 rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * STRIDE;          // two stages
  T* Vs = Ks + 2 * BK * STRIDE;      // two stages

  const int bh = blockIdx.x;
  // the longest (last, under causality) q tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wr0 = (tid >> 5) * 16;   // the warp's first row in the tile
  const T* qb = q + (size_t)bh * tq * DH;
  const T* kb = k + (size_t)bh * sk * DH;
  const T* vb = v + (size_t)bh * sk * DH;
  const bool skip_safe = causal && kv_offset <= q_offset;

  const int nkb = (sk + BK - 1) / BK;
  int nb = nkb;
  if (skip_safe) {
    // last key a row of this tile can see: its own global position
    const int last_q = q0 + BQ - 1 + q_offset;
    const int lim = (last_q - kv_offset) / BK + 1;
    nb = lim < nkb ? (lim > 0 ? lim : 0) : nkb;
  }

  // the ring: tile i lives in stage i % 2; Q and tile 0 are in flight
  // before the loop, and each iteration loads the next tile
  tc::load_tile<T, DH, BQ, NT>(Qs, qb, q0, tq, tid);
  tc::load_tile<T, DH, BK, NT>(Ks, kb, 0, sk, tid);
  tc::load_tile<T, DH, BK, NT>(Vs, vb, 0, sk, tid);
  tc::cp_async_commit();

  uint32_t qf[KD][4];
  float acc[NO][4];
  float mrow[2], lrow[2];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[d][c] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mrow[h] = -INFINITY;
    lrow[h] = 0.f;
  }
  // global positions of the warp's first and last query rows
  const int wq_first = q0 + wr0 + q_offset;
  const int wq_last = wq_first + 15;
  const float scale_log2 = scale * tc::LOG2E;

  for (int kt = 0; kt < nb; ++kt) {
    const int k0 = kt * BK;
    tc::cp_async_wait<0>();   // tile kt has landed (this thread's part)
    // every thread's part of tile kt is visible, and every warp is done
    // with tile kt - 1, whose stage the load below refills
    __syncthreads();
    if (kt + 1 < nb) {   // the next tile loads while this one computes
      const int st = ((kt + 1) & 1) * BK * STRIDE;
      tc::load_tile<T, DH, BK, NT>(Ks + st, kb, k0 + BK, sk, tid);
      tc::load_tile<T, DH, BK, NT>(Vs + st, vb, k0 + BK, sk, tid);
      tc::cp_async_commit();
    }
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::ldsm_a<STRIDE>(qf[kk], Qs, wr0, kk * 16, lane);
    }
    const T* Kt = Ks + (kt & 1) * BK * STRIDE;
    const T* Vt = Vs + (kt & 1) * BK * STRIDE;
    // with skip_safe, a tile wholly past the diagonal for every row of
    // this warp adds exactly zero (p = 0, m and l unchanged)
    if (skip_safe && wq_last < k0 + kv_offset) continue;
    // the tile's work as one branch-free block, so ptxas can interleave
    // the exponentials with the tensor-core products around them; a
    // second copy masks (the diagonal and the ragged tail only)
    auto tile = [&](auto masked_tag) {
      constexpr bool MASKED = decltype(masked_tag)::value;
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
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // rows g and g + 8 of the warp
        float m_new, psum = 0.f;
        if constexpr (!MASKED) {
          // no masked or ragged score in this tile: the row max of the
          // raw scores times scale is the max of the scaled ones (the
          // rounding of a product by scale > 0 is monotonic), and
          // exp(s * scale - m) is one FMA and one ex2
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < NS; ++j)
            tmax = fmaxf(tmax, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
          m_new = fmaxf(mrow[h], tc::quad_max(tmax) * scale);
          const float ml = m_new * tc::LOG2E;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p =
                  tc::exp2_fast(fmaf(s[j][2 * h + e], scale_log2, -ml));
              psum += p;
              s[j][2 * h + e] = p;
            }
          }
        } else {
          const int qg = wq_first + g + 8 * h;
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float sv = s[j][2 * h + e] * scale;
              const int kl = k0 + j * 8 + 2 * tg + e;
              if (causal && qg < kl + kv_offset) sv = NEG_INF;
              if (kl >= sk) sv = -INFINITY;   // ragged tail: no key
              s[j][2 * h + e] = sv;
              tmax = fmaxf(tmax, sv);
            }
          }
          m_new = fmaxf(mrow[h], tc::quad_max(tmax));
#pragma unroll
          for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = tc::exp_fast(s[j][2 * h + e] - m_new);
              psum += p;
              s[j][2 * h + e] = p;
            }
          }
        }
        const float corr = tc::exp_fast(mrow[h] - m_new);
        lrow[h] = lrow[h] * corr + tc::quad_sum(psum);
        mrow[h] = m_new;
#pragma unroll
        for (int d = 0; d < NO; ++d) {
          acc[d][2 * h] *= corr;
          acc[d][2 * h + 1] *= corr;
        }
      }
      // O += P V: P rounded to T as it becomes the A operand
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        tc::c_to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < NO / 2; ++dd) {
          uint32_t b0[2], b1[2];
          tc::ldsm_b_kn<STRIDE>(b0, b1, Vt, kk * 16, dd * 16, lane);
          tc::mma<T>(acc[2 * dd], pa, b0);
          tc::mma<T>(acc[2 * dd + 1], pa, b1);
        }
      }
    };
    if ((causal && wq_first < k0 + BK - 1 + kv_offset) || k0 + BK > sk)
      tile(std::true_type{});
    else
      tile(std::false_type{});
  }
  tc::cp_async_wait<0>();   // no copy outlives the CTA

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr0 + g + 8 * h;
    if (row < tq) {
      const float l = lrow[h];
      T* orow = o + ((size_t)bh * tq + row) * DH + 2 * tg;
#pragma unroll
      for (int d = 0; d < NO; ++d)
        *reinterpret_cast<uint32_t*>(orow + d * 8) =
            tc::pack2<T>(acc[d][2 * h] / l, acc[d][2 * h + 1] / l);
      if (tg == 0) {
        m_out[(size_t)bh * tq + row] = mrow[h];
        logl_out[(size_t)bh * tq + row] = logf(l);
      }
    }
  }
}

template <typename T, int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* m, float* logl, int bh, int tq, int sk, float scale,
              int causal, int q_offset, int kv_offset, cudaStream_t stream) {
  using G = TcGeom<DH>;
  auto kernel = flash_fwd_tc_kernel<T, DH>;
  if ((tq + G::BQ - 1) / G::BQ > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (tq + G::BQ - 1) / G::BQ);
  kernel<<<grid, G::THREADS, G::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, logl, tq, sk, scale,
      causal, q_offset, kv_offset);
  return (int)cudaGetLastError();
}

// float32 keeps the SIMT kernel; bf16 / f16 take the tensor-core tile
template <typename T, int DH>
int launch_dtype(const void* q, const void* k, const void* v, void* o,
                 float* m, float* logl, int bh, int tq, int sk, float scale,
                 int causal, int q_offset, int kv_offset,
                 cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch<T, DH>(q, k, v, o, m, logl, bh, tq, sk, scale, causal,
                         q_offset, kv_offset, stream);
  else
    return launch_tc<T, DH>(q, k, v, o, m, logl, bh, tq, sk, scale, causal,
                            q_offset, kv_offset, stream);
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                void* o, float* m, float* logl, int bh, int tq, int sk,
                float scale, int causal, int q_offset, int kv_offset,
                cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_dtype<T, 32>(q, k, v, o, m, logl, bh, tq, sk, scale,
                                 causal, q_offset, kv_offset, stream);
    case 64:
      return launch_dtype<T, 64>(q, k, v, o, m, logl, bh, tq, sk, scale,
                                 causal, q_offset, kv_offset, stream);
    case 128:
      return launch_dtype<T, 128>(q, k, v, o, m, logl, bh, tq, sk, scale,
                                  causal, q_offset, kv_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, k, v, o: contiguous [bh, t, dh] (k, v: [bh, sk, dh]) of one dtype;
// m, logl: float32 [bh, tq]. Returns the cudaError_t of the launch.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* m, void* logl, int bh, int tq,
                              int sk, int dh, int dtype, float scale,
                              int causal, int q_offset, int kv_offset,
                              void* stream) {
  using namespace dl4j;
  if (bh <= 0 || tq <= 0 || sk <= 0 || (tq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(logl);
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_dh<float>(dh, q, k, v, o, mf, lf, bh, tq, sk, scale,
                                causal, q_offset, kv_offset, s);
    case DTYPE_F16:
      return dispatch_dh<__half>(dh, q, k, v, o, mf, lf, bh, tq, sk, scale,
                                 causal, q_offset, kv_offset, s);
    case DTYPE_BF16:
      return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, mf, lf, bh, tq, sk,
                                        scale, causal, q_offset, kv_offset,
                                        s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

