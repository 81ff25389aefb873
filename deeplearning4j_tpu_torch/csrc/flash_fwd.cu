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
// masked row (kv_offset > q_offset) averages uniformly as in JAX.
//
// Design. One CTA (128 threads) per (batch-head, 64-row q tile); the CTA
// loops over 64-row k/v tiles staged in shared memory, so the TPU's
// in-order grid dimension becomes a loop inside the block. Two threads
// own one query row: each computes 32 of the tile's 64 scores in
// registers and half of the row's Dh output columns; the pair exchanges
// statistics and probabilities with warp shuffles, so the [BQ, BK] score
// tile never touches memory. Causal k tiles past the diagonal are
// skipped only when kv_offset <= q_offset (the reference's
// _qtile_bounds: then every row sees its own position and no row can be
// fully masked). The ragged tail (T or S not a multiple of 64) is masked
// in the kernel, so any length is taken.
//
// Bound on this card: at the engine's prefill bucket (64 slots x 8 heads,
// T=1024, Dh=64, bf16, causal) the work is ~6.9e10 FLOP against ~273 MB
// of q/k/v/o/m/log l, i.e. byte-bound at ~81 us on an H100 SXM (the FLOP
// alone take ~70 us at the bf16 tensor-core peak). This first kernel
// computes with float32 FMAs (no tensor cores), so it is bound by the
// FMA pipe and the shared-memory loads that feed it; float4 shared loads
// give four FMAs per load. Tensor-core (wgmma) tiles are later work.
#include <stdint.h>

#include "common.cuh"

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
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int row0, int nrows) {
  constexpr int STRIDE = Smem<DH>::STRIDE;
  for (int idx = threadIdx.x; idx < 64 * DH; idx += THREADS) {
    const int r = idx / DH;
    const int c = idx - r * DH;
    const int g = row0 + r;
    dst[r * STRIDE + c] =
        g < nrows ? Cvt<T>::to(src[(size_t)g * DH + c]) : 0.f;
  }
}

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

  load_tile<T, DH>(Qs, qb, q0, tq);

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
    load_tile<T, DH>(Ks, kb, k0, sk);
    load_tile<T, DH>(Vs, vb, k0, sk);
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

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                void* o, float* m, float* logl, int bh, int tq, int sk,
                float scale, int causal, int q_offset, int kv_offset,
                cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, m, logl, bh, tq, sk, scale, causal,
                           q_offset, kv_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, m, logl, bh, tq, sk, scale, causal,
                           q_offset, kv_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, m, logl, bh, tq, sk, scale, causal,
                            q_offset, kv_offset, stream);
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
