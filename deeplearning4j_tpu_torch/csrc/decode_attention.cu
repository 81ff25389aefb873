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
// by shuffles and across warps through shared memory at the end. That
// row loop is decode_core.cuh's attend_rows with one query row; the
// verify-window kernel (decode_window.cu) runs the same loop with up to 8,
// so each window row reproduces this kernel bit for bit.
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

#include "decode_core.cuh"

namespace dl4j {
namespace {

using decode::THREADS;

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, T* __restrict__ o,
              const int* __restrict__ pos, int pos_scalar, int H, int S,
              float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = H * DH;
  int p = pos != nullptr ? pos[b] : pos_scalar;
  p = p < 0 ? 0 : (p > S - 1 ? S - 1 : p);
  const int bound[1] = {p};
  const size_t row = ((size_t)b * H + h) * DH;
  const size_t base = (size_t)b * S * D + (size_t)h * DH;
  decode::attend_rows<T, DH, 1>(q + row, o + row, 0, kc + base, vc + base, D,
                                bound, 1, scale);
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
