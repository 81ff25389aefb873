// The tensor-core tile shared by the bf16 / f16 flash kernels
// (flash_fwd.cu, flash_bwd.cu, flash_bwd_packed2.cu).
//
// Route: warp-level `mma.sync.aligned.m16n8k16` (bf16 or f16 operands,
// float32 accumulators) fed by `ldmatrix` from shared memory, with tiles
// staged by 16-byte `cp.async` in a two-stage ring. Not `wgmma` + TMA:
// the online softmax and the backward's P / dS math run on a score tile
// that each warp holds in registers in the mma C layout, and that tile is
// repacked in registers into the A operand of the next product (P V,
// P^T dO, dS^T Q, dS K). With `mma.sync` every warp owns 16 rows of that
// tile end to end and needs no cross-warp exchange; `wgmma` spreads a
// 64-row tile over a warpgroup and needs its async fences around each
// repack, which is later work. Every product operand here is already a
// bf16 / f16 value in the float32 SIMT kernels, and every product was
// already summed in float32, so the mma computes the same function; only
// the order of the sums differs.
//
// Shared-memory tiles are [rows][DH] of T with a row stride of DH + 8
// elements: the 16-byte pad puts the eight rows that one `ldmatrix`
// phase reads on eight distinct 16-byte bank groups (strides of 80, 144
// and 272 bytes for DH 32, 64 and 128), so `ldmatrix` has no bank
// conflicts, and every row stays 16-byte aligned for `cp.async`.
//
// Fragment layouts (PTX ISA, m16n8k16, g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//                           a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9)
//   B (16 x 8, col major):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16 x 8, float32):    c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, ..)
// so the C tiles of columns [16i, 16i+8) and [16i+8, 16i+16) are, after
// rounding each pair to T, exactly the A fragment of k chunk i.
//
// Exponentials on this path are `ex2.approx` (exp_fast, exp2_fast): one
// special-function-unit op where expf takes a dozen instructions, within
// a few float32 ulps of it, which the T roundings of P and of the outputs
// absorb (the float32 kernels keep expf).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace dl4j {
namespace tc {

// padded row stride (elements) of a [rows][DH] shared tile of T
template <int DH>
struct Pad {
  static constexpr int STRIDE = DH + 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only; `ok` false zero-fills
// the destination and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (float statistics: their rows are only 4-byte
// aligned); `ok` false zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a contiguous [nrows, DH] matrix of T into a
// padded shared tile, by NT threads (`tid` in [0, NT)); rows at or past
// nrows are zero-filled (the ragged tail).
template <typename T, int DH, int ROWS, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int nrows, int tid) {
  constexpr int CPR = DH * (int)sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int EPC = 16 / (int)sizeof(T);        // elements a chunk
  constexpr int STRIDE = Pad<DH>::STRIDE;
  static_assert((ROWS * CPR) % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / CPR;
    const int c = i - r * CPR;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async16(dst + r * STRIDE + c * EPC,
               src + (size_t)(ok ? gr : 0) * DH + c * EPC, ok);
  }
}

// Entries [row0, row0 + N) of a float32 column of length nrows into
// shared memory; entries past nrows read as zero.
template <int N, int NT>
__device__ __forceinline__ void load_col(float* dst, const float* src,
                                         int row0, int nrows, int tid) {
#pragma unroll
  for (int i = tid; i < N; i += NT) {
    const bool ok = row0 + i < nrows;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p))
      : "memory");
}

// A fragment (rows m0..m0+15, k k0..k0+15) of a row-major [m][k] tile
template <int STRIDE, typename T>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const T* tile,
                                       int m0, int k0, int lane) {
  const T* p = tile + (m0 + (lane & 15)) * STRIDE + k0 + (lane >> 4) * 8;
  ldsm_x4(a[0], a[1], a[2], a[3], p);
}

// A fragment (rows m0..m0+15, k k0..k0+15) of A stored transposed, as a
// [k][m] tile
template <int STRIDE, typename T>
__device__ __forceinline__ void ldsm_a_trans(uint32_t (&a)[4],
                                             const T* tile, int m0, int k0,
                                             int lane) {
  const T* p = tile + (k0 + (lane >> 4) * 8 + (lane & 7)) * STRIDE + m0 +
               ((lane >> 3) & 1) * 8;
  ldsm_x4_trans(a[0], a[1], a[2], a[3], p);
}

// B fragments of two n tiles (n0..n0+7, n0+8..n0+15) x k k0..k0+15 from a
// [n][k] tile (B^T row major: K[key][d] for S = Q K^T)
template <int STRIDE, typename T>
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b0)[2],
                                          uint32_t (&b1)[2], const T* tile,
                                          int n0, int k0, int lane) {
  const T* p = tile + (n0 + (lane & 7) + (lane >> 4) * 8) * STRIDE + k0 +
               ((lane >> 3) & 1) * 8;
  ldsm_x4(b0[0], b0[1], b1[0], b1[1], p);
}

// B fragments of two n tiles x k k0..k0+15 from a [k][n] tile (B row
// major: V[key][d] for O = P V), through ldmatrix.trans
template <int STRIDE, typename T>
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b0)[2],
                                          uint32_t (&b1)[2], const T* tile,
                                          int k0, int n0, int lane) {
  const T* p = tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE +
               n0 + (lane >> 4) * 8;
  ldsm_x4_trans(b0[0], b0[1], b1[0], b1[1], p);
}

// c += a b on the tensor cores, float32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const uint32_t (&a)[4],
                                                   const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to nearest-even in T, packed lo | hi << 16: each half
// equals Cvt<T>::from, i.e. round_to<T> of common.cuh
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                         float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The C tiles 2i and 2i+1 (columns [16i, 16i+16)) of a 16-row float tile,
// rounded to T: the A fragment of k chunk i of the next product.
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// exp(x) as 2^(x log2 e) on the special-function unit (ex2.approx.ftz):
// one multiply and one MUFU op where expf takes a dozen instructions,
// within a few float32 ulps of it (relative error ~2^-22 plus the
// rounding of x log2 e), which the bf16 / f16 roundings of P and of the
// output absorb; exp(-inf) = 0 and exp(0) = 1 as for expf. The float32
// kernels keep expf.
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * LOG2E));
  return y;
}

// 2^x on the special-function unit (ex2.approx.ftz)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// reductions over the four lanes of a quad (the four threads that hold
// one row of a C tile)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// P of one score from the forward's statistics, the reference's two forms
// (exp(s - (m + log l)) when the causal skip is safe, else
// exp((s - m) - log l), which keeps a fully-masked row's uniform P)
__device__ __forceinline__ float prob(float sv, float m, float logl,
                                      bool skip_safe) {
  return skip_safe ? exp_fast(sv - (m + logl)) : exp_fast((sv - m) - logl);
}

// What the backward's tiles need to know of the call.
struct BwdArgs {
  int tq, sk;
  float scale, scale_log2;   // scale and scale * log2 e
  int causal, q_offset, kv_offset;
  bool skip_safe;            // causal && kv_offset <= q_offset
};

// The backward's dK / dV warp tile (flash_bwd.cu's dkdv launch, and each
// slot of flash_bwd_packed2.cu): the warp's 16 keys, rows kr0.. of the
// staged K and V tiles of the k tile at k0, against the staged 64-row q
// tile at q0 (Q, dO and its m / log l / delta columns). S^T = K Q^T and
// dP^T = V dO^T come out with keys as rows, so P^T and dS^T are already
// in the C layout of A operands: they are repacked (rounded to T) into
// dV += P^T dO and dK += dS^T Q, B from ldmatrix.trans of the Q and dO
// tiles. FRAG_REGS: the warp's K and V A fragments are kf / vf (loaded
// once a k tile); otherwise they are read from Ks / Vs, and the q tile is
// taken in passes of PASS rows. MASKED applies the causal mask (finite
// NEG_INF, dS zeroed), zeroes P and dS of padded q rows and keys, and
// takes P in the form `prob` picks; callers pass it for every tile of a
// call where the causal skip is not safe. The unmasked copy, for the
// other tiles, takes the safe form exp(s - (m + log l)) as
// exp(s * scale - (m + log l)), one FMA and one ex2. DSTRIDE > 0 also
// stores the rounded dS^T to ds, a [key][q] tile of that row stride. The
// body is branch-free for each MASKED, so ptxas can interleave the
// exponentials with the products around them.
template <typename T, int DH, int STRIDE, int PASS, bool FRAG_REGS,
          bool MASKED, int DSTRIDE = 0>
__device__ __forceinline__ void dkdv_tile(
    float (&dka)[DH / 8][4], float (&dva)[DH / 8][4],
    const uint32_t (&kf)[DH / 16][4], const uint32_t (&vf)[DH / 16][4],
    const T* Ks, const T* Vs, int kr0, int k0, const T* Qt, const T* Ot,
    const float* Mt, const float* Lt, const float* Dt, int q0, T* ds,
    const BwdArgs& a, int lane) {
  constexpr int BQ = 64;
  constexpr int KD = DH / 16;
  constexpr int NO = DH / 8;
  constexpr int NP = PASS / 8;
  const int g = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int qc = 0; qc < BQ; qc += PASS) {
    float sT[NP][4], dpT[NP][4];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sT[j][c] = 0.f;
        dpT[j][c] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (FRAG_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = kf[kk][i];
          va[i] = vf[kk][i];
        }
      } else {
        ldsm_a<STRIDE>(ka, Ks, kr0, kk * 16, lane);
        ldsm_a<STRIDE>(va, Vs, kr0, kk * 16, lane);
      }
#pragma unroll
      for (int jj = 0; jj < NP / 2; ++jj) {
        uint32_t b0[2], b1[2];
        ldsm_b_nk<STRIDE>(b0, b1, Qt, qc + jj * 16, kk * 16, lane);
        mma<T>(sT[2 * jj], ka, b0);
        mma<T>(sT[2 * jj + 1], ka, b1);
        ldsm_b_nk<STRIDE>(b0, b1, Ot, qc + jj * 16, kk * 16, lane);
        mma<T>(dpT[2 * jj], va, b0);
        mma<T>(dpT[2 * jj + 1], va, b1);
      }
    }
    // P^T and dS^T: rows keys g, g + 8; columns q rows
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int col = qc + j * 8 + 2 * tg;
      const float2 mm = *reinterpret_cast<const float2*>(Mt + col);
      const float2 ll = *reinterpret_cast<const float2*>(Lt + col);
      const float2 de = *reinterpret_cast<const float2*>(Dt + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = c & 1;
        const float mq = e ? mm.y : mm.x;
        const float lq = e ? ll.y : ll.x;
        const float dq = e ? de.y : de.x;
        float pv, dsv;
        if constexpr (MASKED) {
          const int kl = k0 + kr0 + g + (c >> 1) * 8;
          const int jq = q0 + col + e;
          const bool valid =
              !a.causal || jq + a.q_offset >= kl + a.kv_offset;
          const float sv = valid ? sT[j][c] * a.scale : NEG_INF;
          pv = prob(sv, mq, lq, a.skip_safe);
          dsv = valid ? pv * (dpT[j][c] - dq) : 0.f;
          if (jq >= a.tq || kl >= a.sk) {   // a padded q row or key
            pv = 0.f;
            dsv = 0.f;
          }
        } else {
          pv = exp2_fast(fmaf(sT[j][c], a.scale_log2, -(mq + lq) * LOG2E));
          dsv = pv * (dpT[j][c] - dq);
        }
        sT[j][c] = pv;
        dpT[j][c] = dsv;
      }
    }
    // dV += P^T dO and dK += dS^T Q; P and dS rounded to T here
#pragma unroll
    for (int kk = 0; kk < PASS / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a<T>(pa, sT[2 * kk], sT[2 * kk + 1]);
      c_to_a<T>(da, dpT[2 * kk], dpT[2 * kk + 1]);
      if constexpr (DSTRIDE > 0) {
        T* drow = ds + (kr0 + g) * DSTRIDE + qc + kk * 16 + 2 * tg;
        *reinterpret_cast<uint32_t*>(drow) = da[0];
        *reinterpret_cast<uint32_t*>(drow + 8 * DSTRIDE) = da[1];
        *reinterpret_cast<uint32_t*>(drow + 8) = da[2];
        *reinterpret_cast<uint32_t*>(drow + 8 * DSTRIDE + 8) = da[3];
      }
#pragma unroll
      for (int dd = 0; dd < NO / 2; ++dd) {
        uint32_t b0[2], b1[2];
        ldsm_b_kn<STRIDE>(b0, b1, Ot, qc + kk * 16, dd * 16, lane);
        mma<T>(dva[2 * dd], pa, b0);
        mma<T>(dva[2 * dd + 1], pa, b1);
        ldsm_b_kn<STRIDE>(b0, b1, Qt, qc + kk * 16, dd * 16, lane);
        mma<T>(dka[2 * dd], da, b0);
        mma<T>(dka[2 * dd + 1], da, b1);
      }
    }
  }
}

}  // namespace tc
}  // namespace dl4j
