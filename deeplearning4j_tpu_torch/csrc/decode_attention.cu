// Decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/flash_decode.py::_decode_kernel
// (launched by decode_attention): one query row per (batch row, head)
// attends rows 0..pos[b] of a flattened-head KV cache [B, S, D=H*Dh].
// Same math: scores with float32 accumulation times 1/sqrt(Dh), float32
// online-softmax statistics, the probabilities rounded to the value dtype
// before the PV product, the output in the query dtype. Each batch row is
// masked by its OWN pos (the slotted pool's per-slot prefixes); a scalar
// pos is the shared-prefix form of generate. pos is clamped to [0, S-1].
//
// Design. The TPU kernel carried a running (m, l, acc) across an
// in-order grid over S blocks. Here one CTA (4 warps) owns one (b, h) and
// loops over S inside the block: each warp takes rows j = warp*R + i,
// stepping by 4R, where one row is read as 16-byte vectors by
// Dh*sizeof(T)/16 lanes (R rows per warp per step). Every lane keeps an
// online-softmax state for its row slot; the states merge across lanes
// by shuffles and across warps through shared memory at the end.
//  - Prefix bound: the loop stops at pos[b], so rows past a slot's
//    filled prefix are never read (the reference's DMA clamp, :194-199).
//  - Stacked caches [L, B, S, D]: the caller passes the layer plane's
//    base pointer (an offset into the stacked buffer), so the plane is
//    never copied (the reference's :301-307).
//
// Bound on this card: the kernel reads each filled cache row once
// (2 * (pos+1) * Dh * sizeof(T) bytes per (b, h)) and does ~4 FLOP per
// byte, so it is bound by device-memory bandwidth: ~268 MB at
// B=64, S=2048, D=512 in bf16, ~80 us at 3.35 TB/s on an H100 SXM. The
// design keeps several independent 16-byte loads in flight per lane
// (the unrolled S loop) to cover memory latency.
#include <stdint.h>

#include "common.cuh"

namespace dl4j {
namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, T* __restrict__ o,
              const int* __restrict__ pos, int pos_scalar, int H, int S,
              float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LPR = DH / VEC;         // lanes per cache row
  constexpr int RPW = 32 / LPR;         // rows per warp per step
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row geometry");

  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ __align__(16) float sm_acc[WARPS][DH];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * DH;
  int p = pos != nullptr ? pos[b] : pos_scalar;
  p = p < 0 ? 0 : (p > S - 1 ? S - 1 : p);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane / LPR;          // row slot inside the warp
  const int li = lane - slot * LPR;     // 16-byte chunk of the row

  float qf[VEC];
  load16<T>(q + ((size_t)b * H + h) * DH + li * VEC, qf);

  const size_t base = (size_t)b * S * D + (size_t)h * DH + li * VEC;
  const T* kb = kc + base;
  const T* vb = vc + base;

  float m = -INFINITY;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  // uniform trip count per warp: every lane joins every shuffle
#pragma unroll 4
  for (int j0 = warp * RPW; j0 <= p; j0 += WARPS * RPW) {
    const int j = j0 + slot;
    const bool valid = j <= p;
    float kf[VEC], vf[VEC];
    if (valid) {
      load16<T>(kb + (size_t)j * D, kf);
      load16<T>(vb + (size_t)j * D, vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += qf[i] * kf[i];
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (valid) {
      s *= scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float pe = expf(s - m_new);
      l = l * corr + pe;
      const float pr = round_to<T>(pe);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = acc[i] * corr + pr * vf[i];
      m = m_new;
    }
  }

  // merge the warp's row slots (lanes with the same chunk li)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float c1 = m == -INFINITY ? 0.f : expf(m - mn);
    const float c2 = mo == -INFINITY ? 0.f : expf(mo - mn);
    l = l * c1 + lo * c2;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[i], off);
      acc[i] = acc[i] * c1 + ao * c2;
    }
    m = mn;
  }
  if (slot == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[warp][li * VEC + i] = acc[i];
    if (li == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps: one thread per output column
  for (int c = threadIdx.x; c < DH; c += THREADS) {
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, sm_m[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float cw = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - mt);
      lt += sm_l[w] * cw;
      at += sm_acc[w][c] * cw;
    }
    o[((size_t)b * H + h) * DH + c] = Cvt<T>::from(at / lt);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* pos, int pos_scalar, int B, int H, int S, float scale,
           cudaStream_t stream) {
  dim3 grid(H, B);
  decode_kernel<T, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), pos, pos_scalar, H, S,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                void* o, const int* pos, int pos_scalar, int B, int H, int S,
                float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, pos, pos_scalar, B, H, S, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, pos, pos_scalar, B, H, S, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, pos, pos_scalar, B, H, S, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, o: contiguous [B, H, Dh]; k, v: the [B, S, H*Dh] plane to read (a
// stacked cache's layer plane is passed as its base pointer). pos: int32
// [B] on the device, or null to use pos_scalar for every row. Returns the
// cudaError_t of the launch.
extern "C" int dl4j_decode_attention(const void* q, const void* k,
                                     const void* v, void* o, const void* pos,
                                     int pos_scalar, int B, int H, int dh,
                                     int S, int dtype, float scale,
                                     void* stream) {
  using namespace dl4j;
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(pos);
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_dh<float>(dh, q, k, v, o, pp, pos_scalar, B, H, S,
                                scale, s);
    case DTYPE_F16:
      return dispatch_dh<__half>(dh, q, k, v, o, pp, pos_scalar, B, H, S,
                                 scale, s);
    case DTYPE_BF16:
      return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, pp, pos_scalar, B,
                                        H, S, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
