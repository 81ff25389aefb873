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
// Bound on this card: bytes. The kernel reads each filled cache row of
// a (b, h) once, 2 * (pos[b]+1) * Dh * sizeof(T) bytes, and does ~4 FLOP
// a cache element (~1 FLOP a bf16 byte), far below the H100's ~295
// operations a byte: ~268 MB at B=64, S=2048, D=512 in bf16 at pos 2047,
// ~80 us at 3.35 TB/s on an H100 SXM. The engine's slots sit at their own
// prefixes, so the work is uneven across (b, h).
//
// Design, bf16 / f16: decode_tc.cuh's tensor-core split-S row core at
// T = 1, one launch. The cache rows of each (b, h) are cut into chunks
// of decode_tc::CH rows spread over a thread-block cluster of up to 8
// CTAs, so a long prefix is read by up to 8 SMs at once and a short one
// by few CTAs (the rest load nothing): the longest slot no longer sets
// the time alone. Each warp streams its keys through a cp.async ring in
// shared memory (bytes in flight, where the earlier design held one
// register row a lane), scores and P V run on mma.sync, and the CTAs'
// partial softmax states merge through distributed shared memory in
// rank order. The verify-window kernel (decode_window.cu) is the same
// kernel at T = K+1, so each window row reproduces this kernel bit for
// bit.
//
// Design, float32: the earlier SIMT kernel, kept as it was so the f32
// path stays exact to 1e-5 (tensor cores would mean TF32): one CTA of
// 4 warps per (b, h) loops over S inside the block (decode_core.cuh's
// attend_rows with one query row), each warp taking rows j = warp*R + i
// stepping by 4R, one row read as 16-byte vectors by Dh*4/16 lanes; the
// lanes' online-softmax states merge by shuffles and across warps
// through shared memory.
//
// Quantized entry (dl4j_decode_attention_q): an int8 or e4m3 cache with
// one float32 scale per cache row, under a float32, float16 or bfloat16
// query. It is the port's kernel for the reference's scaled jnp path
// (flash_decode.py:308-314: the TPU kernel read float caches only) and
// computes that path's function: decode_core.cuh's row loop with one byte
// a cache element, the K scale folded into the score and the V scale into
// the probability, in float32. Bound: bytes, (pos[b]+1) * Dh * 2 bytes a
// (b, h) plus 8 bytes of scales a cache row: ~135 MB at B=64, S=2048,
// D=512 at pos 2047, ~40 us at 3.35 TB/s, half the bf16 cache's time.
// Design: one CTA of 4 warps a (b, h), as the float32 path; its window
// twin (decode_window.cu) runs the same loop, so each window row equals
// this kernel at its own position bit for bit.
//
// All paths: rows past a slot's filled prefix pos[b] are never read (the
// reference's DMA clamp, :194-199), and a stacked cache [L, B, S, D] (and
// a stacked scale plane [L, B, S, 1]) is read through the layer plane's
// base pointer (an offset into the stacked buffer), never copied (the
// reference's :301-307).
#include <stdint.h>

#include <type_traits>

#include "decode_core.cuh"
#include "decode_tc.cuh"

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
  decode::attend_rows<T, T, DH, 1>(q + row, o + row, 0, kc + base,
                                   vc + base, D, nullptr, nullptr, bound, 1,
                                   scale);
}

// the quantized cache: TK one byte an element, ks / vs its [B, S] scales
template <typename TQ, typename TK, int DH>
__global__ void __launch_bounds__(THREADS)
decode_q_kernel(const TQ* __restrict__ q, const TK* __restrict__ kc,
                const TK* __restrict__ vc, const float* __restrict__ ks,
                const float* __restrict__ vs, TQ* __restrict__ o,
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
  const size_t srow = (size_t)b * S;
  decode::attend_rows<TQ, TK, DH, 1>(q + row, o + row, 0, kc + base,
                                     vc + base, D, ks + srow, vs + srow,
                                     bound, 1, scale);
}

template <typename TQ, typename TK, int DH>
int launch_q(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, void* o, const int* pos, int pos_scalar,
             int B, int H, int S, float scale, cudaStream_t stream) {
  dim3 grid(H, B);
  decode_q_kernel<TQ, TK, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), ks, vs, static_cast<TQ*>(o), pos,
      pos_scalar, H, S, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
int dispatch_q_dh(int dh, const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, void* o, const int* pos,
                  int pos_scalar, int B, int H, int S, float scale,
                  cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_q<TQ, TK, 32>(q, k, v, ks, vs, o, pos, pos_scalar, B,
                                  H, S, scale, stream);
    case 64:
      return launch_q<TQ, TK, 64>(q, k, v, ks, vs, o, pos, pos_scalar, B,
                                  H, S, scale, stream);
    case 128:
      return launch_q<TQ, TK, 128>(q, k, v, ks, vs, o, pos, pos_scalar, B,
                                   H, S, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ>
int dispatch_q_cache(int kdtype, int dh, const void* q, const void* k,
                     const void* v, const float* ks, const float* vs,
                     void* o, const int* pos, int pos_scalar, int B, int H,
                     int S, float scale, cudaStream_t stream) {
  switch (kdtype) {
    case DTYPE_I8:
      return dispatch_q_dh<TQ, int8_t>(dh, q, k, v, ks, vs, o, pos,
                                       pos_scalar, B, H, S, scale, stream);
    case DTYPE_E4M3:
      return dispatch_q_dh<TQ, __nv_fp8_e4m3>(dh, q, k, v, ks, vs, o, pos,
                                              pos_scalar, B, H, S, scale,
                                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// float32 keeps the SIMT kernel; bf16 / f16 take decode_tc.cuh's core at
// T = 1
template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* pos, int pos_scalar, int B, int H, int S, float scale,
           cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    dim3 grid(H, B);
    decode_kernel<T, DH><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), pos, pos_scalar, H,
        S, scale);
    return (int)cudaGetLastError();
  } else {
    return decode_tc::launch_rows<T, DH>(
        q, k, v, o, pos, pos_scalar, B, 1, H, S, scale, stream);
  }
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
// [B] on the device, or null to use pos_scalar for every row. ch and
// cluster: the caller's view of the split (chunk rows, CTAs a cluster);
// any other than decode_tc.cuh's is refused. Returns the cudaError_t of
// the launch.
extern "C" int dl4j_decode_attention(const void* q, const void* k,
                                     const void* v, void* o, const void* pos,
                                     int pos_scalar, int B, int H, int dh,
                                     int S, int dtype, float scale, int ch,
                                     int cluster, void* stream) {
  using namespace dl4j;
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 ||
      ch != decode_tc::CH ||
      cluster != decode_tc::cluster_size(S))
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

// The quantized cache: q, o contiguous [B, H, Dh] of qdtype (F32 / F16 /
// BF16); k, v the [B, S, H*Dh] plane of kdtype (I8 / E4M3); ks, vs the
// plane's float32 row scales [B, S] (a stacked cache's layer plane and a
// stacked [L, B, S, 1] scale plane's are passed as base pointers). pos as
// above. Returns the cudaError_t of the launch.
extern "C" int dl4j_decode_attention_q(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, void* o,
                                       const void* pos, int pos_scalar,
                                       int B, int H, int dh, int S,
                                       int qdtype, int kdtype, float scale,
                                       void* stream) {
  using namespace dl4j;
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(pos);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  switch (qdtype) {
    case DTYPE_F32:
      return dispatch_q_cache<float>(kdtype, dh, q, k, v, kss, vss, o, pp,
                                     pos_scalar, B, H, S, scale, s);
    case DTYPE_F16:
      return dispatch_q_cache<__half>(kdtype, dh, q, k, v, kss, vss, o, pp,
                                      pos_scalar, B, H, S, scale, s);
    case DTYPE_BF16:
      return dispatch_q_cache<__nv_bfloat16>(kdtype, dh, q, k, v, kss, vss,
                                             o, pp, pos_scalar, B, H, S,
                                             scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
