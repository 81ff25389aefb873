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
//  - dK / dV. Per k tile of 64 keys, two threads own one key row (as in
//    flash_bwd.cu's dK/dV kernel): each scores that key against 32 rows of
//    the staged 64-row q tile in registers and accumulates half of the
//    row's Dh columns of dK and dV, taking its partner's 32 values by warp
//    shuffle. The k tile's dK and dV are finished and written when its q
//    loop ends.
//  - dQ. The TPU kernel carried dQ across k tiles in a [2, tq, Dh] f32
//    VMEM scratch. At the experiment's tq = 512 that is 256 KB, more than
//    a CTA's 227 KB of shared memory, so the accumulator is a float32
//    workspace in device memory owned by the CTA (64 CTAs x 256 KB =
//    16.8 MB at the flagship shape, resident in the 50 MB L2). Each q
//    tile's dS goes to a shared [64 keys, 64 q rows] tile; then two
//    threads own one q row, each adds dS K over the tile's keys for half
//    of the row's columns and read-add-writes its own slice of the
//    workspace. One thread owns each workspace element for the whole
//    launch (it zeroes it first and scales it into dq at the end), so the
//    sums need no atomics, no fence and no second launch, and do not
//    change from run to run.
//  - The k loop is not split across CTAs: that would bring back atomics or
//    a second launch, the production design this experiment is held
//    against. So the flagship shape (bh = 128) runs 64 CTAs on the card's
//    132 SMs, one per SM (256 threads, up to 255 registers each).
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
// the bf16 tensor-core peak at the flagship shape). Like flash_bwd.cu this
// first kernel computes with float32 FMAs, and it does a third less FMA
// work than the two-launch design (P and dP are computed once, not twice),
// but fills only 64 SMs at the flagship shape and adds the workspace's
// read-add-write traffic (one 64 x Dh f32 tile per q tile per k tile).
#include <stdint.h>

#include "common.cuh"

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

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                const void* dout, const float* m, const float* logl,
                const float* delta, void* dq, void* dk, void* dv, float* ws,
                int bh, int tq, int sk, float scale, int causal,
                int q_offset, int kv_offset, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, dout, m, logl, delta, dq, dk, dv, ws, bh,
                           tq, sk, scale, causal, q_offset, kv_offset,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, dout, m, logl, delta, dq, dk, dv, ws, bh,
                           tq, sk, scale, causal, q_offset, kv_offset,
                           stream);
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
