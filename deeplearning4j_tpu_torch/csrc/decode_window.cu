// Speculative-verify window attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces deeplearning4j_tpu/ops/flash_decode.py::_window_kernel
// (launched by decode_window_attention): the K+1 verify window of each
// batch row, q [B, T, H, Dh], where window row t of batch row b sits at
// position pos[b] + t and attends cache rows 0..clip(pos[b]+t, 0, S-1) of
// a flattened-head KV cache [B, S, D=H*Dh]. Same math as the decode
// kernel: float32 scores times 1/sqrt(Dh), float32 online-softmax
// statistics, probabilities rounded to the value dtype before the PV
// product, the output in the query dtype.
//
// Bound on this card: bytes. The TPU kernel folded the window into
// pseudo-heads p = t*H + h so that each cache block was read once for all
// T rows; so does this kernel: 2 * (min(pos+T-1, S-1)+1) * Dh * sizeof(T)
// bytes per (b, h), ~268 MB at B=64, S=2048, D=512 in bf16 at a full
// cache (~80 us at 3.35 TB/s on an H100 SXM), against ~4*T FLOP a cache
// element (T=8: ~16 FLOP a bf16 byte), still far below the card's ~295
// operations a byte. Calling the decode kernel once per window row would
// read the cache T times.
//
// Design, bf16 / f16: decode_tc.cuh's tensor-core split-S row core. The
// window rows of one (b, h) are one m16 A tile, so the work that grows
// with T (the scores, the exponentials' inputs, P V) runs on mma.sync
// instead of T SIMT dot products and shuffles a cache row; the padding
// rows of the tile are free, as the kernel waits on bytes. The cache is
// cut into chunks spread over a thread-block cluster, staged through
// cp.async rings and merged through distributed shared memory (see
// there). Window rows past 16 take further tiles (gridDim.x), each
// reading the cache again, so any T runs; the verify window of K <= 15 is
// one tile. The decode kernel (decode_attention.cu) is this kernel at
// T = 1, so window row t equals it at pos + t bit for bit.
//
// Design, float32: the earlier SIMT kernel, kept as it was so the f32
// path stays exact to 1e-5: one CTA (4 warps) owns one (b, h) and a group
// of up to 8 window rows and walks the cache rows
// 0..clip(pos[b]+t_last, 0, S-1) once; every loaded K/V row updates the
// online-softmax state of each window row whose bound it is within and
// leaves the others untouched (decode_core.cuh's attend_rows, the decode
// kernel's own row loop, lanes and roundings, so window row t equals the
// float32 decode kernel at pos + t bit for bit). Window rows past 8 take
// further CTAs (blockIdx.z).
//
// Quantized entry (dl4j_decode_window_q): an int8 or e4m3 cache with one
// float32 scale per cache row under a float32, float16 or bfloat16 query,
// the port's kernel for the reference's scaled jnp path
// (flash_decode.py:513-519). decode_core.cuh's row loop as the quantized
// decode kernel runs it, so window row t equals that kernel at pos + t bit
// for bit (quantized speculative decoding reproduces quantized plain
// decode). A lane holds 16 query values and 16 accumulators a window row,
// so a CTA carries QGROUP = 4 window rows (more would spill); a verify
// window of T rows takes ceil(T/4) CTAs a (b, h), each reading the cache.
//
// All paths: a stacked cache [L, B, S, D] (and a stacked scale plane) is
// read through the layer plane's base pointer, as for the decode kernel.
#include <stdint.h>

#include <type_traits>

#include "decode_core.cuh"
#include "decode_tc.cuh"

namespace dl4j {
namespace {

using decode::THREADS;

constexpr int GROUP = 8;   // window rows per CTA (float32)
constexpr int QGROUP = 4;  // window rows per CTA (quantized cache)

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
window_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, T* __restrict__ o,
              const int* __restrict__ pos, int pos_scalar, int H, int S,
              int T_, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.z * GROUP;
  const int nt = min(GROUP, T_ - t0);
  const int D = H * DH;
  const int p0 = (pos != nullptr ? pos[b] : pos_scalar) + t0;
  int bound[GROUP];
#pragma unroll
  for (int t = 0; t < GROUP; ++t) {
    const int p = p0 + t;
    bound[t] = p < 0 ? 0 : (p > S - 1 ? S - 1 : p);
  }
  // window rows of one (b, h) lie H*Dh apart in q and o [B, T, H, Dh]
  const size_t row_step = (size_t)H * DH;
  const size_t row = (((size_t)b * T_ + t0) * H + h) * DH;
  const size_t base = (size_t)b * S * D + (size_t)h * DH;
  decode::attend_rows<T, T, DH, GROUP>(q + row, o + row, row_step,
                                       kc + base, vc + base, D, nullptr,
                                       nullptr, bound, nt, scale);
}

// the quantized cache: TK one byte an element, ks / vs its [B, S] scales
template <typename TQ, typename TK, int DH>
__global__ void __launch_bounds__(THREADS)
window_q_kernel(const TQ* __restrict__ q, const TK* __restrict__ kc,
                const TK* __restrict__ vc, const float* __restrict__ ks,
                const float* __restrict__ vs, TQ* __restrict__ o,
                const int* __restrict__ pos, int pos_scalar, int H, int S,
                int T_, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.z * QGROUP;
  const int nt = min(QGROUP, T_ - t0);
  const int D = H * DH;
  const int p0 = (pos != nullptr ? pos[b] : pos_scalar) + t0;
  int bound[QGROUP];
#pragma unroll
  for (int t = 0; t < QGROUP; ++t) {
    const int p = p0 + t;
    bound[t] = p < 0 ? 0 : (p > S - 1 ? S - 1 : p);
  }
  const size_t row_step = (size_t)H * DH;
  const size_t row = (((size_t)b * T_ + t0) * H + h) * DH;
  const size_t base = (size_t)b * S * D + (size_t)h * DH;
  const size_t srow = (size_t)b * S;
  decode::attend_rows<TQ, TK, DH, QGROUP>(q + row, o + row, row_step,
                                          kc + base, vc + base, D,
                                          ks + srow, vs + srow, bound, nt,
                                          scale);
}

template <typename TQ, typename TK, int DH>
int launch_q(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, void* o, const int* pos, int pos_scalar,
             int B, int T_, int H, int S, float scale, cudaStream_t stream) {
  if ((T_ + QGROUP - 1) / QGROUP > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(H, B, (T_ + QGROUP - 1) / QGROUP);
  window_q_kernel<TQ, TK, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), ks, vs, static_cast<TQ*>(o), pos,
      pos_scalar, H, S, T_, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
int dispatch_q_dh(int dh, const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, void* o, const int* pos,
                  int pos_scalar, int B, int T_, int H, int S, float scale,
                  cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_q<TQ, TK, 32>(q, k, v, ks, vs, o, pos, pos_scalar, B,
                                  T_, H, S, scale, stream);
    case 64:
      return launch_q<TQ, TK, 64>(q, k, v, ks, vs, o, pos, pos_scalar, B,
                                  T_, H, S, scale, stream);
    case 128:
      return launch_q<TQ, TK, 128>(q, k, v, ks, vs, o, pos, pos_scalar, B,
                                   T_, H, S, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ>
int dispatch_q_cache(int kdtype, int dh, const void* q, const void* k,
                     const void* v, const float* ks, const float* vs,
                     void* o, const int* pos, int pos_scalar, int B, int T_,
                     int H, int S, float scale, cudaStream_t stream) {
  switch (kdtype) {
    case DTYPE_I8:
      return dispatch_q_dh<TQ, int8_t>(dh, q, k, v, ks, vs, o, pos,
                                       pos_scalar, B, T_, H, S, scale,
                                       stream);
    case DTYPE_E4M3:
      return dispatch_q_dh<TQ, __nv_fp8_e4m3>(dh, q, k, v, ks, vs, o, pos,
                                              pos_scalar, B, T_, H, S, scale,
                                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// float32 keeps the SIMT kernel; bf16 / f16 take decode_tc.cuh's core
template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* pos, int pos_scalar, int B, int T_, int H, int S,
           float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if ((T_ + GROUP - 1) / GROUP > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(H, B, (T_ + GROUP - 1) / GROUP);
    window_kernel<T, DH><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), pos, pos_scalar, H,
        S, T_, scale);
    return (int)cudaGetLastError();
  } else {
    return decode_tc::launch_rows<T, DH>(
        q, k, v, o, pos, pos_scalar, B, T_, H, S, scale, stream);
  }
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                void* o, const int* pos, int pos_scalar, int B, int T_,
                int H, int S, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, pos, pos_scalar, B, T_, H, S, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, pos, pos_scalar, B, T_, H, S, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, pos, pos_scalar, B, T_, H, S, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, o: contiguous [B, T, H, Dh]; k, v: the [B, S, H*Dh] plane to read (a
// stacked cache's layer plane is passed as its base pointer). pos: int32
// [B] on the device (window row t of batch row b at pos[b] + t), or null
// to use pos_scalar for every row. ch and cluster: the caller's view of
// the split (chunk rows, CTAs a cluster); any other than decode_tc.cuh's
// is refused. Returns the cudaError_t of the launch.
extern "C" int dl4j_decode_window(const void* q, const void* k,
                                  const void* v, void* o, const void* pos,
                                  int pos_scalar, int B, int T, int H,
                                  int dh, int S, int dtype, float scale,
                                  int ch, int cluster, void* stream) {
  using namespace dl4j;
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 || S <= 0 ||
      ch != decode_tc::CH ||
      cluster != decode_tc::cluster_size(S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(pos);
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_dh<float>(dh, q, k, v, o, pp, pos_scalar, B, T, H, S,
                                scale, s);
    case DTYPE_F16:
      return dispatch_dh<__half>(dh, q, k, v, o, pp, pos_scalar, B, T, H, S,
                                 scale, s);
    case DTYPE_BF16:
      return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, pp, pos_scalar, B, T,
                                        H, S, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The quantized cache: q, o contiguous [B, T, H, Dh] of qdtype (F32 / F16
// / BF16); k, v the [B, S, H*Dh] plane of kdtype (I8 / E4M3); ks, vs the
// plane's float32 row scales [B, S] (stacked planes passed as base
// pointers). pos as above. Returns the cudaError_t of the launch.
extern "C" int dl4j_decode_window_q(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, void* o, const void* pos,
                                    int pos_scalar, int B, int T, int H,
                                    int dh, int S, int qdtype, int kdtype,
                                    float scale, void* stream) {
  using namespace dl4j;
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(pos);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  switch (qdtype) {
    case DTYPE_F32:
      return dispatch_q_cache<float>(kdtype, dh, q, k, v, kss, vss, o, pp,
                                     pos_scalar, B, T, H, S, scale, s);
    case DTYPE_F16:
      return dispatch_q_cache<__half>(kdtype, dh, q, k, v, kss, vss, o, pp,
                                      pos_scalar, B, T, H, S, scale, s);
    case DTYPE_BF16:
      return dispatch_q_cache<__nv_bfloat16>(kdtype, dh, q, k, v, kss, vss,
                                             o, pp, pos_scalar, B, T, H, S,
                                             scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
