// Two-heads-per-CTA, single-pass flash-attention backward for Hopper
// (sm_90a), plain C interface.
//
// Replaces benchmarks/headpack_experiment.py::_packed2_kernel (launched by
// _packed2_call, q-chunked by packed2_backward), the head-packing
// experiment's backward. It computes the same function as flash_bwd.cu
// (see there for the math: P from the forward's separate m and log l,
// dV += P^T dO, dS = P * (dO V^T - delta) zeroed at masked positions,
// dK += dS^T Q, dQ += dS K, dK and dQ scaled at the end, float32 sums),
// but in the TPU kernel's layout: ONE launch produces dQ, dK and dV
// together, k tiles outer and q tiles inner, and one CTA owns TWO
// batch-heads (2i, 2i+1).
//
// Design.
//  - Slots. The TPU kernel ran the two slots' q loops back to back inside
//    each k tile. Here each slot has its own warpgroup (128 threads) and
//    its own shared-memory tiles, and the two warpgroups synchronise only
//    among themselves (named barriers 1 and 2), so the two heads' q loops
//    run at once on the SM and neither waits for the other.
//  - dQ. The TPU kernel carried dQ across k tiles in a [2, tq, Dh] f32
//    VMEM scratch. At the experiment's tq = 512 that is 256 KB, more than
//    a CTA's 227 KB of shared memory, so the accumulator is a float32
//    workspace in device memory owned by the CTA (64 CTAs x 256 KB =
//    16.8 MB at the flagship shape, resident in the 50 MB L2). One thread
//    owns each workspace element for the whole launch (it zeroes it
//    first, read-add-writes it once per (k tile, q tile) and scales it
//    into dq at the end), so the sums need no atomics, no fence and no
//    second launch, and do not change from run to run.
//  - The k loop is not split across CTAs: that would bring back atomics or
//    a second launch, the production design this experiment is held
//    against. So the flagship shape (bh = 128) runs 64 CTAs on the card's
//    132 SMs, one per SM (256 threads, up to 255 registers each).
//  - bf16 / f16, the tensor-core tile (mma_tile.cuh, `mma.sync`). Each
//    slot's four warps own 16 keys of the k tile each and do exactly
//    flash_bwd.cu's dK / dV warp tile: S^T = K Q^T and dP^T = V dO^T from
//    K and V fragments held in registers, P^T and dS^T repacked in
//    registers (rounded to T) into dV += P^T dO and dK += dS^T Q, Q, dO
//    and the column statistics through a two-stage `cp.async` ring. The
//    rounded dS^T tile also goes to shared memory as T; after the slot's
//    barrier each warp takes 16 q rows of it and computes its dQ tile
//    += dS K by `mma` (A from `ldmatrix.trans` of dS^T, B from
//    `ldmatrix.trans` of K) before the workspace read-add-write. Two slot
//    barriers a q tile: tile landed (and the previous dS^T consumed), and
//    dS^T complete. As in flash_bwd.cu, each tile's dK / dV work is one
//    branch-free block per mask kind, with P as one FMA and one
//    `ex2.approx` on the unmasked tiles of a call where the skip is safe.
//  - float32: the earlier SIMT kernel, kept as it was so the f32 path
//    stays exact to 1e-5: two threads per key row scoring it against 32
//    rows of the staged q tile in registers, the partner's 32 values by
//    warp shuffle, dS through a float shared tile, float32 FMAs.
// Masking and skips follow flash_bwd.cu: q tiles before the diagonal are
// skipped only when causal and kv_offset <= q_offset; otherwise every tile
// runs, so fully-masked rows keep their uniform P; padded query rows and
// padded keys (ragged T or S) carry P = dS = 0.
//
// Head dims 32 and 64 only: two slots' K, V, Q and dO tiles of Dh = 128 in
// float32 do not fit one CTA's shared memory.
//
// Bound on this card: the same function as flash_bwd.cu, so the same bound
// (operations: five [T, S, Dh] products over the causal half, ~0.17 ms at
// the bf16 tensor-core peak at the flagship shape). The single pass
// computes P and dP once (five products, not seven), but fills only 64
// SMs at the flagship shape and adds the workspace's read-add-write
// traffic (one 64 x Dh f32 tile per q tile per k tile).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace dl4j {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int SLOT_THREADS = 128;   // one warpgroup per slot
constexpr int THREADS = 2 * SLOT_THREADS;
constexpr int HALF = 32;            // rows of the other tile a thread scores

template <int DH>
struct Smem {
  static constexpr int STRIDE = DH + 4;   // float4-aligned, skews banks
  static constexpr int DS_STRIDE = BQ + 1;
  // per slot: K, V, Q, dO tiles, m / log l / delta columns, the dS tile
  static constexpr int SLOT_FLOATS =
      4 * 64 * STRIDE + 3 * 64 + BK * DS_STRIDE;
  static constexpr int BYTES = 2 * SLOT_FLOATS * sizeof(float);
  static_assert(SLOT_FLOATS % 4 == 0, "slot base must stay 16-byte aligned");
};

// the slot's 128 threads only (barrier 0 is __syncthreads)
__device__ __forceinline__ void slot_sync(int slot) {
  asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(SLOT_THREADS)
               : "memory");
}

// Rows [row0, row0 + ROWS) of a contiguous [nrows, DH] matrix of T, as
// float, into a shared tile of row stride STRIDE, by the slot's threads
// (st = thread index inside the slot); rows past nrows read as zero.
template <typename T, int DH, int STRIDE, int ROWS>
__device__ __forceinline__ void load_tile_slot(float* dst, const T* src,
                                               int row0, int nrows, int st) {
  for (int idx = st; idx < ROWS * DH; idx += SLOT_THREADS) {
    const int r = idx / DH;
    const int c = idx - r * DH;
    const int g = row0 + r;
    dst[r * STRIDE + c] =
        g < nrows ? Cvt<T>::to(src[(size_t)g * DH + c]) : 0.f;
  }
}

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
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_packed2_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ logl,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         T* __restrict__ dk, T* __restrict__ dv, float* ws,
                         int tq, int sk, float scale, int causal,
                         int q_offset, int kv_offset) {
  constexpr int STRIDE = Smem<DH>::STRIDE;
  constexpr int DSS = Smem<DH>::DS_STRIDE;
  constexpr int DC = DH / 2;
  extern __shared__ __align__(16) float smem[];
  const int slot = threadIdx.x / SLOT_THREADS;
  const int st = threadIdx.x - slot * SLOT_THREADS;
  float* Ks = smem + slot * Smem<DH>::SLOT_FLOATS;
  float* Vs = Ks + BK * STRIDE;
  float* Qs = Vs + BK * STRIDE;
  float* Os = Qs + BQ * STRIDE;   // the dO tile
  float* Ms = Os + BQ * STRIDE;
  float* Ls = Ms + BQ;
  float* Ds = Ls + BQ;
  float* Ss = Ds + BQ;            // dS tile, [key][q row]

  const int bh = blockIdx.x * 2 + slot;
  const int r = st >> 1;        // key row (dK/dV), then q row (dQ)
  const int half = st & 1;      // which 32 rows / Dh/2 columns
  const bool skip_safe = causal && kv_offset <= q_offset;
  const size_t qrow0 = (size_t)bh * tq;
  const size_t krow0 = (size_t)bh * sk;
  const int nqb = (tq + BQ - 1) / BQ;
  const int nkb = (sk + BK - 1) / BK;
  float* wsq = ws + qrow0 * DH + half * DC;   // + row * DH: my slice

  // zero my slice of dQ's accumulator: row r of every q tile
  for (int qt = 0; qt < nqb; ++qt) {
    const int row = qt * BQ + r;
    if (row < tq) {
      float4* d = reinterpret_cast<float4*>(wsq + (size_t)row * DH);
#pragma unroll
      for (int c = 0; c < DC / 4; ++c) d[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    const int kg = k0 + r + kv_offset;   // global position of my key row
    const bool key_ok = k0 + r < sk;
    slot_sync(slot);   // the previous k tile's readers of Ks are done
    load_tile_slot<T, DH, STRIDE, BK>(Ks, k + krow0 * DH, k0, sk, st);
    load_tile_slot<T, DH, STRIDE, BK>(Vs, v + krow0 * DH, k0, sk, st);

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
      slot_sync(slot);   // previous q tile consumed; K / V tiles visible
      load_tile_slot<T, DH, STRIDE, BQ>(Qs, q + qrow0 * DH, q0, tq, st);
      load_tile_slot<T, DH, STRIDE, BQ>(Os, dout + qrow0 * DH, q0, tq, st);
      if (st < BQ) {
        const bool ok = q0 + st < tq;
        Ms[st] = ok ? m[qrow0 + q0 + st] : 0.f;
        Ls[st] = ok ? logl[qrow0 + q0 + st] : 0.f;
        Ds[st] = ok ? delta[qrow0 + q0 + st] : 0.f;
      }
      slot_sync(slot);

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
        if (j >= tq || !key_ok) {   // padded query row or key
          pv = 0.f;
          dsv = 0.f;
        }
        p[jj] = round_to<T>(pv);
        ds[jj] = round_to<T>(dsv);
        Ss[r * DSS + jl] = ds[jj];
      }
      accumulate_rows<DH>(dva, p, Os, half);    // dV[r] += sum_j P dO[j]
      accumulate_rows<DH>(dka, ds, Qs, half);   // dK[r] += sum_j dS Q[j]
      slot_sync(slot);   // the dS tile is complete

      // dQ[q0 + r] += sum over the tile's keys c of dS[c][r] K[c]
      float w[HALF], dqp[DC];
#pragma unroll
      for (int jj = 0; jj < HALF; ++jj) w[jj] = Ss[(half * HALF + jj) * DSS + r];
#pragma unroll
      for (int c = 0; c < DC; ++c) dqp[c] = 0.f;
      accumulate_rows<DH>(dqp, w, Ks, half);
      const int row = q0 + r;
      if (row < tq) {
        float4* d = reinterpret_cast<float4*>(wsq + (size_t)row * DH);
#pragma unroll
        for (int c = 0; c < DC / 4; ++c) {
          float4 a = d[c];
          a.x += dqp[4 * c + 0];
          a.y += dqp[4 * c + 1];
          a.z += dqp[4 * c + 2];
          a.w += dqp[4 * c + 3];
          d[c] = a;
        }
      }
    }

    if (key_ok) {
      const int row = k0 + r;
      T* dkrow = dk + (krow0 + row) * DH + half * DC;
      T* dvrow = dv + (krow0 + row) * DH + half * DC;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dkrow[c] = Cvt<T>::from(dka[c] * scale);
        dvrow[c] = Cvt<T>::from(dva[c]);
      }
    }
  }

  // dq = scale * the accumulator; every element was last written by this
  // same thread, so no barrier is needed
  for (int qt = 0; qt < nqb; ++qt) {
    const int row = qt * BQ + r;
    if (row < tq) {
      const float* src = wsq + (size_t)row * DH;
      T* dqrow = dq + (qrow0 + row) * DH + half * DC;
#pragma unroll
      for (int c = 0; c < DC; ++c) dqrow[c] = Cvt<T>::from(src[c] * scale);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* m, const float* logl, const float* delta, void* dq,
           void* dk, void* dv, float* ws, int bh, int tq, int sk, float scale,
           int causal, int q_offset, int kv_offset, cudaStream_t stream) {
  const int bytes = Smem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_packed2_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_packed2_kernel<T, DH><<<bh / 2, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), m, logl, delta,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), ws, tq,
      sk, scale, causal, q_offset, kv_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 / f16: the tensor-core tile
// ---------------------------------------------------------------------------

template <int DH>
struct TcPacked {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
  static constexpr int STRIDE = tc::Pad<DH>::STRIDE;
  static constexpr int TILE = 64 * STRIDE;     // a [64, DH] tile of T
  static constexpr int DSTRIDE = BQ + 8;       // the dS^T tile, [key][q]
  // per slot: K, V, two stages of Q and dO, the dS^T tile, then two
  // stages of the m / log l / delta columns
  static constexpr int SLOT_BYTES =
      6 * TILE * 2 + BK * DSTRIDE * 2 + 2 * 3 * BQ * 4;
  static constexpr int BYTES = 2 * SLOT_BYTES;
  static_assert(SLOT_BYTES % 16 == 0, "slot base must stay 16-byte aligned");
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_packed2_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ m,
                            const float* __restrict__ logl,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, T* __restrict__ dk,
                            T* __restrict__ dv, float* ws, int tq, int sk,
                            float scale, int causal, int q_offset,
                            int kv_offset) {
  using G = TcPacked<DH>;
  constexpr int BQ = G::BQ;
  constexpr int NT = SLOT_THREADS;
  constexpr int STRIDE = G::STRIDE;
  constexpr int DSTRIDE = G::DSTRIDE;
  constexpr int TILE = G::TILE;
  constexpr int KD = DH / 16;
  constexpr int NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slot = threadIdx.x / SLOT_THREADS;
  const int st = threadIdx.x - slot * SLOT_THREADS;
  T* Ks = reinterpret_cast<T*>(smem_raw + slot * G::SLOT_BYTES);
  T* Vs = Ks + TILE;
  T* Qs = Vs + TILE;        // two stages
  T* Os = Qs + 2 * TILE;    // two stages of the dO tile
  T* DSs = Os + 2 * TILE;   // dS^T, [key][q row]
  // two stages of the m / log l / delta columns
  float* Ss = reinterpret_cast<float*>(DSs + BK * DSTRIDE);

  const int bh = blockIdx.x * 2 + slot;
  const int lane = st & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int r0 = (st >> 5) * 16;   // the warp's 16 keys (dK / dV), then
                                   // its 16 q rows of a tile (dQ)
  const bool skip_safe = causal && kv_offset <= q_offset;
  const tc::BwdArgs args{tq, sk, scale, scale * tc::LOG2E, causal,
                         q_offset, kv_offset, skip_safe};
  const size_t qrow0 = (size_t)bh * tq;
  const size_t krow0 = (size_t)bh * sk;
  const T* qb = q + qrow0 * DH;
  const T* ob = dout + qrow0 * DH;
  const int nqb = (tq + BQ - 1) / BQ;
  const int nkb = (sk + BK - 1) / BK;
  // this thread's elements of dQ's accumulator: rows qt * BQ + r0 + g
  // (+ 8), columns d * 8 + 2 tg (+ 1), for every q tile and k tile
  float* wsb = ws + qrow0 * DH + 2 * tg;

  auto load_q = [&](int qt, int stage) {
    const int q0 = qt * BQ;
    tc::load_tile<T, DH, BQ, NT>(Qs + stage * TILE, qb, q0, tq, st);
    tc::load_tile<T, DH, BQ, NT>(Os + stage * TILE, ob, q0, tq, st);
    float* sc = Ss + stage * 3 * BQ;
    tc::load_col<BQ, NT>(sc, m + qrow0, q0, tq, st);
    tc::load_col<BQ, NT>(sc + BQ, logl + qrow0, q0, tq, st);
    tc::load_col<BQ, NT>(sc + 2 * BQ, delta + qrow0, q0, tq, st);
  };

  for (int qt = 0; qt < nqb; ++qt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qt * BQ + r0 + g + 8 * h;
      if (row < tq) {
#pragma unroll
        for (int d = 0; d < NO; ++d)
          *reinterpret_cast<float2*>(wsb + (size_t)row * DH + d * 8) =
              make_float2(0.f, 0.f);
      }
    }
  }

  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    const int kg_first = k0 + r0 + kv_offset;   // the warp's first key
    int start = 0;
    if (skip_safe) {
      // first q tile whose last row reaches this k tile's first key
      const int need = k0 + kv_offset - q_offset - (BQ - 1);
      start = need > 0 ? (need + BQ - 1) / BQ : 0;
      if (start > nqb) start = nqb;
    }
    slot_sync(slot);   // the previous k tile's readers of K, V, dS are done
    tc::load_tile<T, DH, BK, NT>(Ks, k + krow0 * DH, k0, sk, st);
    tc::load_tile<T, DH, BK, NT>(Vs, v + krow0 * DH, k0, sk, st);
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
    uint32_t kf[KD][4], vf[KD][4];

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
      // the tile has landed; the previous q tile's dQ pass is done with
      // the dS^T tile
      slot_sync(slot);
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          tc::ldsm_a<STRIDE>(kf[kk], Ks, r0, kk * 16, lane);
          tc::ldsm_a<STRIDE>(vf[kk], Vs, r0, kk * 16, lane);
        }
      }
      const T* Qt = Qs + stage * TILE;
      const T* Ot = Os + stage * TILE;
      const float* Mt = Ss + stage * 3 * BQ;
      const float* Lt = Mt + BQ;
      const float* Dt = Mt + 2 * BQ;
      // with skip_safe, a q tile wholly before this warp's first key adds
      // exactly zero: its dS^T rows are written as zeros for the dQ pass
      if (!(skip_safe && q0 + BQ - 1 + q_offset < kg_first)) {
        // flash_bwd.cu's dK / dV warp tile; it also stores the rounded
        // dS^T for the dQ pass
        if (!skip_safe || (causal && q0 + q_offset < kg_first + 15) ||
            q0 + BQ > tq || k0 + BK > sk)
          tc::dkdv_tile<T, DH, STRIDE, BQ, true, true, DSTRIDE>(
              dka, dva, kf, vf, Ks, Vs, r0, k0, Qt, Ot, Mt, Lt, Dt, q0, DSs,
              args, lane);
        else
          tc::dkdv_tile<T, DH, STRIDE, BQ, true, false, DSTRIDE>(
              dka, dva, kf, vf, Ks, Vs, r0, k0, Qt, Ot, Mt, Lt, Dt, q0, DSs,
              args, lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          T* drow = DSs + (r0 + g) * DSTRIDE + kk * 16 + 2 * tg;
          *reinterpret_cast<uint32_t*>(drow) = 0u;
          *reinterpret_cast<uint32_t*>(drow + 8 * DSTRIDE) = 0u;
          *reinterpret_cast<uint32_t*>(drow + 8) = 0u;
          *reinterpret_cast<uint32_t*>(drow + 8 * DSTRIDE + 8) = 0u;
        }
      }
      slot_sync(slot);   // the dS^T tile is complete

      // dQ[q0 + r0 .. + 15] += dS K over the tile's keys: A = dS from
      // ldmatrix.trans of dS^T, B = K from ldmatrix.trans; then this
      // thread's own workspace elements read-add-write. Rows wholly
      // before the tile's first key (skip_safe) add exactly zero.
      if (!(skip_safe && q0 + r0 + 15 + q_offset < k0 + kv_offset)) {
        float dqp[NO][4];
#pragma unroll
        for (int d = 0; d < NO; ++d)
#pragma unroll
          for (int c = 0; c < 4; ++c) dqp[d][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[4];
          tc::ldsm_a_trans<DSTRIDE>(a, DSs, r0, kk * 16, lane);
#pragma unroll
          for (int dd = 0; dd < NO / 2; ++dd) {
            uint32_t b0[2], b1[2];
            tc::ldsm_b_kn<STRIDE>(b0, b1, Ks, kk * 16, dd * 16, lane);
            tc::mma<T>(dqp[2 * dd], a, b0);
            tc::mma<T>(dqp[2 * dd + 1], a, b1);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + r0 + g + 8 * h;
          if (row < tq) {
#pragma unroll
            for (int d = 0; d < NO; ++d) {
              float2* p =
                  reinterpret_cast<float2*>(wsb + (size_t)row * DH + d * 8);
              float2 x = *p;
              x.x += dqp[d][2 * h];
              x.y += dqp[d][2 * h + 1];
              *p = x;
            }
          }
        }
      }
    }
    tc::cp_async_wait<0>();   // no copy in flight past this k tile

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k0 + r0 + g + 8 * h;
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

  // dq = scale * the accumulator; every element was last written by this
  // same thread, so no barrier is needed
  for (int qt = 0; qt < nqb; ++qt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qt * BQ + r0 + g + 8 * h;
      if (row < tq) {
        T* dqrow = dq + (qrow0 + row) * DH + 2 * tg;
#pragma unroll
        for (int d = 0; d < NO; ++d) {
          const float2 x =
              *reinterpret_cast<const float2*>(wsb + (size_t)row * DH + d * 8);
          *reinterpret_cast<uint32_t*>(dqrow + d * 8) =
              tc::pack2<T>(x.x * scale, x.y * scale);
        }
      }
    }
  }
}

template <typename T, int DH>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* m, const float* logl, const float* delta,
              void* dq, void* dk, void* dv, float* ws, int bh, int tq,
              int sk, float scale, int causal, int q_offset, int kv_offset,
              cudaStream_t stream) {
  const int bytes = TcPacked<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_packed2_tc_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_packed2_tc_kernel<T, DH><<<bh / 2, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), m, logl, delta,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), ws, tq,
      sk, scale, causal, q_offset, kv_offset);
  return (int)cudaGetLastError();
}

// float32 keeps the SIMT kernel; bf16 / f16 take the tensor-core tile
template <typename T, int DH>
int launch_dtype(const void* q, const void* k, const void* v,
                 const void* dout, const float* m, const float* logl,
                 const float* delta, void* dq, void* dk, void* dv, float* ws,
                 int bh, int tq, int sk, float scale, int causal,
                 int q_offset, int kv_offset, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch<T, DH>(q, k, v, dout, m, logl, delta, dq, dk, dv, ws, bh,
                         tq, sk, scale, causal, q_offset, kv_offset, stream);
  else
    return launch_tc<T, DH>(q, k, v, dout, m, logl, delta, dq, dk, dv, ws,
                            bh, tq, sk, scale, causal, q_offset, kv_offset,
                            stream);
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                const void* dout, const float* m, const float* logl,
                const float* delta, void* dq, void* dk, void* dv, float* ws,
                int bh, int tq, int sk, float scale, int causal,
                int q_offset, int kv_offset, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_dtype<T, 32>(q, k, v, dout, m, logl, delta, dq, dk, dv,
                                 ws, bh, tq, sk, scale, causal, q_offset,
                                 kv_offset, stream);
    case 64:
      return launch_dtype<T, 64>(q, k, v, dout, m, logl, delta, dq, dk, dv,
                                 ws, bh, tq, sk, scale, causal, q_offset,
                                 kv_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, dout, dq: contiguous [bh, tq, dh]; k, v, dk, dv: [bh, sk, dh], all of
// one dtype; m, logl, delta: float32 [bh, tq]; ws: float32 [bh, tq, dh]
// scratch (dQ's accumulator; no initial value needed). bh must be even:
// CTA i owns batch-heads 2i and 2i+1. One launch on `stream`; returns its
// cudaError_t.
extern "C" int dl4j_flash_bwd_packed2(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* m, const void* logl,
                                      const void* delta, void* dq, void* dk,
                                      void* dv, void* ws, int bh, int tq,
                                      int sk, int dh, int dtype, float scale,
                                      int causal, int q_offset, int kv_offset,
                                      void* stream) {
  using namespace dl4j;
  if (bh <= 0 || bh % 2 || tq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(logl);
  const float* df = static_cast<const float*>(delta);
  float* wf = static_cast<float*>(ws);
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_dh<float>(dh, q, k, v, dout, mf, lf, df, dq, dk, dv,
                                wf, bh, tq, sk, scale, causal, q_offset,
                                kv_offset, s);
    case DTYPE_F16:
      return dispatch_dh<__half>(dh, q, k, v, dout, mf, lf, df, dq, dk, dv,
                                 wf, bh, tq, sk, scale, causal, q_offset,
                                 kv_offset, s);
    case DTYPE_BF16:
      return dispatch_dh<__nv_bfloat16>(dh, q, k, v, dout, mf, lf, df, dq,
                                        dk, dv, wf, bh, tq, sk, scale,
                                        causal, q_offset, kv_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
