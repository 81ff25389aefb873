// Fused Graves (peephole) LSTM scan for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/lstm.py::_lstm_step_kernel (launched by
// _forward under the _lstm_core custom_vjp): the forward recurrence of one
// LSTM layer over all T steps, given the hoisted input projection
// xw_t = x.W ([T, B, 4H], gate order [i, f, g, o]). Same math as the TPU
// kernel: every input cast to float32, z = (xw_t + h_prev.RW) + b with a
// float32 product and float32 accumulation,
//   i = sigmoid(zi + c_prev*pI), f = sigmoid(zf + c_prev*pF), g = tanh(zg),
//   c = f*c_prev + i*g,          o = sigmoid(zo + c*pO),      h = o*tanh(c),
// and hs, cs and the gates [i, f, g, o] written in float32 for every t (the
// reserve the backward reads). The final (h, c) are hs[T-1] and cs[T-1].
// The reverse direction is the caller's flip of xw_t.
//
// The TPU kernel carried (h, c) in VMEM scratch across an in-order grid
// over T, with RW resident in VMEM and one [B, 4H] product a grid step on
// the MXU. Hopper blocks run in no order and share no state, so the time
// loop lives inside the block, and batch rows, independent in an LSTM,
// split the grid. Two variants, chosen by ops/lstm.py's `_lstm_variant`
// from the dtypes and the shape alone:
//
// "tc" (lstm_scan_tc.cuh): a bfloat16 RW at H up to 352 (lstm_tc::MAX_H;
// the cluster slice fits in shared memory there at every B). A cluster of
// C CTAs (lstm_tc::geometry, from B and H) owns 16 to 48 rows; each CTA
// holds its units' slice of RW in shared memory for the whole scan (read
// from L2 once), runs the recurrent product on the tensor cores as three
// exact bf16 parts of h times RW, keeps c in registers, and sends its
// block of h to its peers by bulk copies into distributed shared memory,
// paced by mbarriers.
//
// "simt" (below): a float32 RW, or an H past lstm_tc::MAX_H (the card
// test's 1100). One CTA owns R rows (R = 8 at B = 1024,
// so 128 CTAs) and all H units; each step has two phases, each closed by
// __syncthreads(): A. thread `col` of the 4H gate columns walks k =
// 0..H-1 reading RW[k][col] (coalesced across the warp) and h_prev[k][0..R)
// from shared memory (a broadcast), keeping R float32 sums, and puts z in
// shared memory; B. thread (r, j) updates unit j's c (in shared memory)
// and h (into the other half of a double buffer) and writes hs, cs and
// the gates. Shared memory is 28*R*H bytes; the wrapper lowers R (8, 4,
// 2, 1) until it fits and raises past H = 8301.
//
// Bound on this card. At B = 1024, T = 64, H = 200 with bf16 xw and RW the
// function moves 420.6 MB (xw in, 104.9 MB; hs, cs and the gates out in
// float32, 314.6 MB): 0.1255 ms at 3.35 TB/s. Its product is 2*B*H*4H*T =
// 2.1e10 FLOP; in the "tc" variant three bf16 products of it, 6.3e10 FLOP,
// 0.064 ms at 989 TF/s. So it is bound by bytes, and the "tc" design keeps
// everything else on chip: RW in shared memory, h in distributed shared
// memory, c in registers, each reserve value written once.
// The "simt" variant reads all of RW from L2 in every CTA at every step
// and forms the product on the CUDA cores (0.31 ms at 67 TF/s).
#include <stdint.h>

#include "common.cuh"
#include "lstm_scan_tc.cuh"

namespace dl4j {
namespace {

constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename TX, typename TW, int R>
__global__ void __launch_bounds__(MAX_THREADS)
lstm_scan_kernel(const TX* __restrict__ xw, const float* __restrict__ h0,
                 const float* __restrict__ c0, const TW* __restrict__ rw,
                 const float* __restrict__ bias, const float* __restrict__ p_i,
                 const float* __restrict__ p_f, const float* __restrict__ p_o,
                 float* __restrict__ hs, float* __restrict__ cs,
                 float* __restrict__ gates, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  float* s_h = smem;               // [2][H][R]: h_prev, k-major
  float* s_c = s_h + 2 * H * R;    // [R][H]
  float* s_z = s_c + R * H;        // [R][4H]
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);

  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    const int r = idx / H;
    const int j = idx - r * H;
    const bool ok = r < nrows;
    const size_t g = (size_t)(row0 + r) * H + j;
    s_h[j * R + r] = ok ? h0[g] : 0.f;
    s_h[H * R + j * R + r] = 0.f;
    s_c[idx] = ok ? c0[g] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hcur = s_h + (t & 1) * H * R;
    float* hnext = s_h + ((t + 1) & 1) * H * R;
    const TX* xrow = xw + ((size_t)t * B + row0) * H4;

    // phase A: z = (xw_t + h_prev . RW) + b for this CTA's rows
    for (int col = threadIdx.x; col < H4; col += blockDim.x) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const TW* wcol = rw + col;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = Cvt<TW>::to(wcol[(size_t)k * H4]);
        const float* hk = hcur + k * R;
        if constexpr (R % 4 == 0) {
#pragma unroll
          for (int q = 0; q < R / 4; ++q) {
            const float4 v = reinterpret_cast<const float4*>(hk)[q];
            acc[4 * q + 0] = fmaf(v.x, w, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
          }
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(hk[r], w, acc[r]);
        }
      }
      const float bc = bias[col];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nrows) {
          const float x = Cvt<TX>::to(xrow[(size_t)r * H4 + col]);
          s_z[r * H4 + col] = (x + acc[r]) + bc;
        }
      }
    }
    __syncthreads();

    // phase B: the cell update of each (row, unit)
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      const int r = idx / H;
      const int j = idx - r * H;
      if (r >= nrows) continue;
      const float* z = s_z + r * H4;
      const float cp = s_c[idx];
      const float ig = sigmoidf(z[j] + cp * p_i[j]);
      const float fg = sigmoidf(z[H + j] + cp * p_f[j]);
      const float gg = tanhf(z[2 * H + j]);
      const float c = fg * cp + ig * gg;
      const float og = sigmoidf(z[3 * H + j] + c * p_o[j]);
      const float h = og * tanhf(c);
      s_c[idx] = c;
      hnext[j * R + r] = h;
      const size_t o = (size_t)t * B + row0 + r;
      hs[o * H + j] = h;
      cs[o * H + j] = c;
      float* gr = gates + o * H4;
      gr[j] = ig;
      gr[H + j] = fg;
      gr[2 * H + j] = gg;
      gr[3 * H + j] = og;
    }
    __syncthreads();
  }
}

template <typename TX, typename TW, int R>
int launch(const void* xw, const float* h0, const float* c0, const void* rw,
           const float* b, const float* pi, const float* pf, const float* po,
           float* hs, float* cs, float* gates, int T, int B, int H,
           cudaStream_t stream) {
  const size_t smem = (size_t)28 * R * H;
  auto kern = lstm_scan_kernel<TX, TW, R>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int threads = ((4 * H + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const int grid = (B + R - 1) / R;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const TX*>(xw), h0, c0, static_cast<const TW*>(rw), b, pi,
      pf, po, hs, cs, gates, T, B, H);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int dispatch_rows(int rows, const void* xw, const float* h0, const float* c0,
                  const void* rw, const float* b, const float* pi,
                  const float* pf, const float* po, float* hs, float* cs,
                  float* gates, int T, int B, int H, cudaStream_t s) {
  switch (rows) {
    case 8:
      return launch<TX, TW, 8>(xw, h0, c0, rw, b, pi, pf, po, hs, cs, gates,
                               T, B, H, s);
    case 4:
      return launch<TX, TW, 4>(xw, h0, c0, rw, b, pi, pf, po, hs, cs, gates,
                               T, B, H, s);
    case 2:
      return launch<TX, TW, 2>(xw, h0, c0, rw, b, pi, pf, po, hs, cs, gates,
                               T, B, H, s);
    case 1:
      return launch<TX, TW, 1>(xw, h0, c0, rw, b, pi, pf, po, hs, cs, gates,
                               T, B, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TX>
int dispatch_w(int w_dtype, int rows, const void* xw, const float* h0,
               const float* c0, const void* rw, const float* b,
               const float* pi, const float* pf, const float* po, float* hs,
               float* cs, float* gates, int T, int B, int H, cudaStream_t s) {
  switch (w_dtype) {
    case DTYPE_F32:
      return dispatch_rows<TX, float>(rows, xw, h0, c0, rw, b, pi, pf, po,
                                      hs, cs, gates, T, B, H, s);
    case DTYPE_BF16:
      return dispatch_rows<TX, __nv_bfloat16>(rows, xw, h0, c0, rw, b, pi,
                                              pf, po, hs, cs, gates, T, B, H,
                                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// xw: contiguous [T, B, 4H] of x_dtype (float32 or bfloat16); rw: contiguous
// [H, 4H] of w_dtype (float32 or bfloat16); h0, c0: float32 [B, H]; b:
// float32 [4H]; pi, pf, po: float32 [H]. Outputs, float32: hs and cs
// [T, B, H], gates [T, B, 4H]. tc: 1 runs the "tc" variant (w_dtype must
// be bfloat16, H at most lstm_tc::MAX_H; rows is not read), 0 the "simt"
// one with rows batch rows per CTA (8, 4, 2 or 1) and 28 * rows * H bytes
// of shared memory. Returns the cudaError_t of the launch.
extern "C" int dl4j_lstm_scan(const void* xw, const void* h0, const void* c0,
                              const void* rw, const void* b, const void* pi,
                              const void* pf, const void* po, void* hs,
                              void* cs, void* gates, int T, int B, int H,
                              int x_dtype, int w_dtype, int rows, int tc,
                              void* stream) {
  using namespace dl4j;
  if (T <= 0 || B <= 0 || H <= 0 ||
      (!tc && (size_t)28 * rows * H > 232448))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  const float* c0f = static_cast<const float*>(c0);
  const float* bf = static_cast<const float*>(b);
  const float* pif = static_cast<const float*>(pi);
  const float* pff = static_cast<const float*>(pf);
  const float* pof = static_cast<const float*>(po);
  float* hso = static_cast<float*>(hs);
  float* cso = static_cast<float*>(cs);
  float* go = static_cast<float*>(gates);
  if (tc) {
    const __nv_bfloat16* rwb = static_cast<const __nv_bfloat16*>(rw);
    if (w_dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
    switch (x_dtype) {
      case DTYPE_F32:
        return lstm_tc::launch<float>(static_cast<const float*>(xw), h0f,
                                      c0f, rwb, bf, pif, pff, pof, hso, cso,
                                      go, T, B, H, s);
      case DTYPE_BF16:
        return lstm_tc::launch<__nv_bfloat16>(
            static_cast<const __nv_bfloat16*>(xw), h0f, c0f, rwb, bf, pif,
            pff, pof, hso, cso, go, T, B, H, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (x_dtype) {
    case DTYPE_F32:
      return dispatch_w<float>(w_dtype, rows, xw, h0f, c0f, rw, bf, pif, pff,
                               pof, hso, cso, go, T, B, H, s);
    case DTYPE_BF16:
      return dispatch_w<__nv_bfloat16>(w_dtype, rows, xw, h0f, c0f, rw, bf,
                                       pif, pff, pof, hso, cso, go, T, B, H,
                                       s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
