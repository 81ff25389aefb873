// Split-S decode attention at swept launch geometries for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas call of benchmarks/decode_kernel_sweep.py (its own
// pallas_call around flash_decode.py::_decode_kernel over (bs, bb) grid
// shapes): the decode function of decode_attention.cu (one query row per
// (batch row b, head h) attends cache rows 0..pos[b] of a flattened-head
// [B, S, D=H*Dh] plane; pos a [B] vector or one scalar, clamped to
// [0, S-1]) at launch geometries other than production's. The TPU sweep
// varied the cache rows per block (bs) and batch rows per program (bb);
// on Hopper the counterpart axes are
//   bs:    the cache rows one CTA covers. ceil(S/bs) CTAs go along S for
//          each (b, h); each writes the float32 partial (m, l, acc) of its
//          rows, and a second, small launch merges the partials.
//   WARPS: warps per CTA (4 or 8).
// A split that starts past pos[b] exits at once and the merge never reads
// it, so a short prefix costs no more than its rows.
//
// The row loop is decode_core.cuh's, with the CTA's row range and warp
// count as parameters: a warp takes rows r0 + warp*RPW + slot, stepping by
// WARPS*RPW, one row read as 16-byte vectors by Dh*sizeof(T)/16 lanes;
// the score is decode_core.cuh's row_score; every rounding is pinned with
// an explicit intrinsic. So at bs >= S with 4 warps (one split) this kernel
// does the production kernel's arithmetic in the production order, and the
// merge of one split (weight expf(0) = 1) reproduces the SIMT decode
// kernel bit for bit: decode_attention.cu's float32 path. Its bf16 / f16
// paths are now decode_tc.cuh's tensor-core split-S core, a different
// design on purpose, so there this kernel's forced production point
// agrees with them to the bf16 row tolerance, not bitwise; this kernel
// keeps its own SIMT loop as the record of the sweep.
//
// Bound on this card: the same as decode_attention.cu, the bytes of the
// filled cache rows (2 * (pos+1) * Dh * sizeof(T) per (b, h)) over the
// memory rate; the partials add 4 * (Dh + 2) bytes a split, written once
// and read once (0.8% of the cache bytes at bs = 128, Dh = 64, bf16).
#include <stdint.h>

#include "decode_core.cuh"

namespace dl4j {
namespace {

template <typename T, int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, float* __restrict__ pm,
                    float* __restrict__ pl, float* __restrict__ pacc,
                    const int* __restrict__ pos, int pos_scalar, int H,
                    int S, int bs, int nsplit, float scale) {
  constexpr int THREADS = WARPS * 32;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LPR = DH / VEC;         // lanes per cache row
  constexpr int RPW = 32 / LPR;         // rows per warp per step
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row geometry");

  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ __align__(16) float sm_acc[WARPS][DH];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int p = pos != nullptr ? pos[b] : pos_scalar;
  p = p < 0 ? 0 : (p > S - 1 ? S - 1 : p);
  const int r0 = split * bs;
  if (r0 > p) return;   // wholly past the prefix: the merge skips it
  const int last = min(r0 + bs - 1, p);
  const int D = H * DH;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane / LPR;          // row slot inside the warp
  const int li = lane - slot * LPR;     // 16-byte chunk of the row

  const size_t row = ((size_t)b * H + h) * DH;
  const size_t base = (size_t)b * S * D + (size_t)h * DH + li * VEC;
  const T* kb = kc + base;
  const T* vb = vc + base;
  float qf[VEC], acc[VEC];
  load16<T>(q + row + li * VEC, qf);
  float m = -INFINITY, l = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  // uniform trip count per warp: every lane joins every shuffle
#pragma unroll 4
  for (int j0 = r0 + warp * RPW; j0 <= last; j0 += WARPS * RPW) {
    const int j = j0 + slot;
    float kf[VEC], vf[VEC];
    if (j <= last) {
      load16<T>(kb + (size_t)j * D, kf);
      load16<T>(vb + (size_t)j * D, vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
    float s = decode::row_score<VEC, LPR>(qf, kf);
    if (j <= last) {
      s = __fmul_rn(s, scale);
      const float m_new = fmaxf(m, s);
      const float corr = expf(__fsub_rn(m, m_new));
      const float pe = expf(__fsub_rn(s, m_new));
      l = __fmaf_rn(l, corr, pe);
      const float pr = round_to<T>(pe);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] = __fmaf_rn(pr, vf[i], __fmul_rn(acc[i], corr));
      m = m_new;
    }
  }

  // merge the warp's row slots (lanes with the same chunk li)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float c1 = m == -INFINITY ? 0.f : expf(__fsub_rn(m, mn));
    const float c2 = mo == -INFINITY ? 0.f : expf(__fsub_rn(mo, mn));
    l = __fmaf_rn(l, c1, __fmul_rn(lo, c2));
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[i], off);
      acc[i] = __fmaf_rn(acc[i], c1, __fmul_rn(ao, c2));
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

  // merge the warps: one thread per output column; the split's partial
  const size_t part = ((size_t)b * H + h) * nsplit + split;
  for (int c = threadIdx.x; c < DH; c += THREADS) {
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, sm_m[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float cw =
          sm_m[w] == -INFINITY ? 0.f : expf(__fsub_rn(sm_m[w], mt));
      lt = __fmaf_rn(sm_l[w], cw, lt);
      at = __fmaf_rn(sm_acc[w][c], cw, at);
    }
    pacc[part * DH + c] = at;
    if (c == 0) {
      pm[part] = mt;
      pl[part] = lt;
    }
  }
}

// one CTA of DH threads per (b, h): merge the live splits' partials in
// split order and write the output row
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
decode_merge_kernel(const float* __restrict__ pm,
                    const float* __restrict__ pl,
                    const float* __restrict__ pacc, T* __restrict__ o,
                    const int* __restrict__ pos, int pos_scalar, int H, int S,
                    int bs, int nsplit) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  int p = pos != nullptr ? pos[b] : pos_scalar;
  p = p < 0 ? 0 : (p > S - 1 ? S - 1 : p);
  const int live = p / bs + 1;
  const size_t part = ((size_t)b * H + h) * nsplit;
  float mt = -INFINITY;
  for (int s = 0; s < live; ++s) mt = fmaxf(mt, pm[part + s]);
  float lt = 0.f, at = 0.f;
  for (int s = 0; s < live; ++s) {
    const float w = expf(__fsub_rn(pm[part + s], mt));
    lt = __fmaf_rn(pl[part + s], w, lt);
    at = __fmaf_rn(pacc[(part + s) * DH + c], w, at);
  }
  o[((size_t)b * H + h) * DH + c] = Cvt<T>::from(__fdiv_rn(at, lt));
}

template <typename T, int DH, int WARPS>
int launch(const void* q, const void* k, const void* v, void* o, float* pm,
           float* pl, float* pacc, const int* pos, int pos_scalar, int B,
           int H, int S, int bs, float scale, cudaStream_t stream) {
  const int nsplit = (S + bs - 1) / bs;
  decode_split_kernel<T, DH, WARPS>
      <<<dim3(nsplit, H, B), WARPS * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), pm, pl, pacc, pos, pos_scalar, H, S, bs,
          nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T, DH><<<dim3(H, B), DH, 0, stream>>>(
      pm, pl, pacc, static_cast<T*>(o), pos, pos_scalar, H, S, bs, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int dispatch_warps(int warps, const void* q, const void* k, const void* v,
                   void* o, float* pm, float* pl, float* pacc,
                   const int* pos, int pos_scalar, int B, int H, int S,
                   int bs, float scale, cudaStream_t stream) {
  switch (warps) {
    case 4:
      return launch<T, DH, 4>(q, k, v, o, pm, pl, pacc, pos, pos_scalar, B,
                              H, S, bs, scale, stream);
    case 8:
      return launch<T, DH, 8>(q, k, v, o, pm, pl, pacc, pos, pos_scalar, B,
                              H, S, bs, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dh(int dh, int warps, const void* q, const void* k,
                const void* v, void* o, float* pm, float* pl, float* pacc,
                const int* pos, int pos_scalar, int B, int H, int S, int bs,
                float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return dispatch_warps<T, 32>(warps, q, k, v, o, pm, pl, pacc, pos,
                                   pos_scalar, B, H, S, bs, scale, stream);
    case 64:
      return dispatch_warps<T, 64>(warps, q, k, v, o, pm, pl, pacc, pos,
                                   pos_scalar, B, H, S, bs, scale, stream);
    case 128:
      return dispatch_warps<T, 128>(warps, q, k, v, o, pm, pl, pacc, pos,
                                    pos_scalar, B, H, S, bs, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, o: contiguous [B, H, Dh]; k, v: the [B, S, H*Dh] plane to read (a
// stacked cache's layer plane is passed as its base pointer). pos: int32
// [B] on the device, or null to use pos_scalar for every row. pm, pl:
// float32 [B, H, ceil(S/bs)] and pacc float32 [B, H, ceil(S/bs), Dh]
// scratch for the partials. Launches the split kernel, then the merge, on
// `stream`; returns the first cudaError_t.
extern "C" int dl4j_decode_sweep(const void* q, const void* k, const void* v,
                                 void* o, void* pm, void* pl, void* pacc,
                                 const void* pos, int pos_scalar, int B,
                                 int H, int dh, int S, int bs, int warps,
                                 int dtype, float scale, void* stream) {
  using namespace dl4j;
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || bs <= 0 ||
      (S + bs - 1) / bs > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(pos);
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  float* a = static_cast<float*>(pacc);
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_dh<float>(dh, warps, q, k, v, o, m, l, a, pp,
                                pos_scalar, B, H, S, bs, scale, s);
    case DTYPE_F16:
      return dispatch_dh<__half>(dh, warps, q, k, v, o, m, l, a, pp,
                                 pos_scalar, B, H, S, bs, scale, s);
    case DTYPE_BF16:
      return dispatch_dh<__nv_bfloat16>(dh, warps, q, k, v, o, m, l, a, pp,
                                        pos_scalar, B, H, S, bs, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
