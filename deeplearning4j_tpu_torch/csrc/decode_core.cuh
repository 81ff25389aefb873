// The SIMT row loop of the float32 decode kernel (decode_attention.cu)
// and float32 speculative-verify window kernel (decode_window.cu), and of
// both kernels' quantized entries (any query dtype over an int8 / e4m3
// cache); their bf16 / f16 float-cache paths run decode_tc.cuh's
// tensor-core core instead. The decode sweep kernel (decode_sweep.cu)
// keeps its own loop on row_score.
//
// One CTA of 4 warps owns one (batch row b, head h) and NT query rows of
// it (NT = 1 for decode; up to 8 window rows for the verify window). It
// walks the cache rows 0..max_t bound[t] of the [S, D=H*Dh] plane once:
// each warp takes rows j = warp*RPW + slot + n*WARPS*RPW, where one row is
// read as 16-byte vectors by Dh*sizeof(T)/16 lanes (RPW rows per warp per
// step). Every loaded K/V row updates one online-softmax state (m, l, acc)
// per query row; a row past query row t's bound leaves row t's state
// untouched (the TPU window kernel's exact no-op, flash_decode.py:446-448).
// The states then merge across the lanes of a warp by shuffles and across
// warps through shared memory, per query row.
//
// Exactness: query row t's state sees the same rows, in the same lanes and
// the same order, as the decode kernel at bound[t] sees them, and every
// rounding is pinned with an explicit intrinsic (__fmaf_rn, __fmul_rn,
// __fsub_rn, __fadd_rn, __fdiv_rn) so that nvcc cannot contract the two
// instantiations differently. So a window row equals the decode kernel at
// its own position bit for bit, in every dtype: the speculative verify
// pass reproduces plain decode.
//
// Quantized cache (TK int8 or __nv_fp8_e4m3, one byte an element, with a
// float32 scale per cache row: ks[j], vs[j]). This is the function of
// the reference's scaled jnp path (ops/flash_decode.py:128-136,
// :174-184), which its TPU kernel never took: q and the cache values go
// to float32 exactly, the score is (q.k * ks[j]) * scale in that order,
// and the probability enters the PV sum as exp(s - m) * vs[j] in float32
// (no rounding to a value dtype: the reference forms p * v_scale in f32).
// A lane reads 16 one-byte elements per 16-byte vector, so LPR = Dh/16
// lanes a row, and holds 16 float32 query values and 16 accumulators per
// query row. Bound on the card: bytes, one byte a cache element, half of
// the bf16 cache's. The row loop stays SIMT rather than mma.sync because
// the reference computes the quantized path in float32: a bf16 mma would
// round p * vs.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dl4j {
namespace decode {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// dot of a lane's VEC-wide chunk, then the sum over the LPR lanes of its
// row slot (butterfly; a + b == b + a, so every lane of the slot agrees)
template <int VEC, int LPR>
__device__ __forceinline__ float row_score(const float* qf, const float* kf) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s = __fmaf_rn(qf[i], kf[i], s);
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// q + t*row_step (t < nt): query row t of this (b, h), Dh elements of TQ;
// the output row t goes to o + t*row_step. kb, vb: this (b, h)'s column of
// the plane, cache row j at + j*D, of TK: TQ itself, or a one-byte
// quantized type whose row j has the scales ks[j], vs[j] (null for a
// float cache). bound[t]: last cache row query row t attends (0..S-1);
// entries t >= nt are ignored.
template <typename TQ, typename TK, int DH, int NT>
__device__ __forceinline__ void attend_rows(
    const TQ* __restrict__ q, TQ* __restrict__ o, size_t row_step,
    const TK* __restrict__ kb, const TK* __restrict__ vb, int D,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int (&bound)[NT], int nt, float scale) {
  constexpr bool QUANT = sizeof(TK) == 1;
  static_assert(QUANT || std::is_same<TQ, TK>::value,
                "a float cache has the query's dtype");
  constexpr int VEC = 16 / sizeof(TK);  // cache elements per 16-byte load
  constexpr int QV = 16 / sizeof(TQ);   // query elements per 16-byte load
  constexpr int LPR = DH / VEC;         // lanes per cache row
  constexpr int RPW = 32 / LPR;         // rows per warp per step
  constexpr int UNROLL = NT == 1 ? 4 : 2;
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row geometry");
  static_assert(VEC % QV == 0, "query chunk geometry");

  __shared__ float sm_m[NT][WARPS];
  __shared__ float sm_l[NT][WARPS];
  __shared__ __align__(16) float sm_acc[NT][WARPS][DH];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane / LPR;          // row slot inside the warp
  const int li = lane - slot * LPR;     // 16-byte chunk of the row

  float qf[NT][VEC];
  float m[NT], l[NT], acc[NT][VEC];
  int last = 0;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt) {
#pragma unroll
      for (int c = 0; c < VEC / QV; ++c)
        load16<TQ>(q + t * row_step + li * VEC + c * QV, qf[t] + c * QV);
      last = max(last, bound[t]);
    }
    m[t] = -INFINITY;
    l[t] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[t][i] = 0.f;
  }
  kb += li * VEC;
  vb += li * VEC;

  // uniform trip count per warp: every lane joins every shuffle
#pragma unroll UNROLL
  for (int j0 = warp * RPW; j0 <= last; j0 += WARPS * RPW) {
    const int j = j0 + slot;
    float kf[VEC], vf[VEC];
    float ksj = 1.f, vsj = 1.f;
    if (j <= last) {
      load16<TK>(kb + (size_t)j * D, kf);
      load16<TK>(vb + (size_t)j * D, vf);
      if constexpr (QUANT) {
        ksj = ks[j];
        vsj = vs[j];
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t >= nt) continue;            // uniform across the CTA
      float s = row_score<VEC, LPR>(qf[t], kf);
      if (j <= bound[t]) {
        if constexpr (QUANT) {
          s = __fmul_rn(__fmul_rn(s, ksj), scale);
        } else {
          s = __fmul_rn(s, scale);
        }
        const float m_new = fmaxf(m[t], s);
        const float corr = expf(__fsub_rn(m[t], m_new));
        const float pe = expf(__fsub_rn(s, m_new));
        l[t] = __fmaf_rn(l[t], corr, pe);
        float pr;
        if constexpr (QUANT) {
          pr = __fmul_rn(pe, vsj);
        } else {
          pr = round_to<TQ>(pe);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[t][i] = __fmaf_rn(pr, vf[i], __fmul_rn(acc[t][i], corr));
        m[t] = m_new;
      }
    }
  }

  // merge the warp's row slots (lanes with the same chunk li)
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[t], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[t], off);
      const float mn = fmaxf(m[t], mo);
      const float c1 = m[t] == -INFINITY ? 0.f : expf(__fsub_rn(m[t], mn));
      const float c2 = mo == -INFINITY ? 0.f : expf(__fsub_rn(mo, mn));
      l[t] = __fmaf_rn(l[t], c1, __fmul_rn(lo, c2));
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[t][i], off);
        acc[t][i] = __fmaf_rn(acc[t][i], c1, __fmul_rn(ao, c2));
      }
      m[t] = mn;
    }
    if (slot == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[t][warp][li * VEC + i] = acc[t][i];
      if (li == 0) {
        sm_m[t][warp] = m[t];
        sm_l[t][warp] = l[t];
      }
    }
  }
  __syncthreads();

  // merge the warps: one thread per (query row, output column)
  for (int idx = threadIdx.x; idx < nt * DH; idx += THREADS) {
    const int t = idx / DH;
    const int c = idx - t * DH;
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, sm_m[t][w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float cw =
          sm_m[t][w] == -INFINITY ? 0.f : expf(__fsub_rn(sm_m[t][w], mt));
      lt = __fmaf_rn(sm_l[t][w], cw, lt);
      at = __fmaf_rn(sm_acc[t][w][c], cw, at);
    }
    o[t * row_step + c] = Cvt<TQ>::from(__fdiv_rn(at, lt));
  }
}

}  // namespace decode
}  // namespace dl4j
