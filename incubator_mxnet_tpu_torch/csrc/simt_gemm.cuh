// Pieces shared by the port's hand kernels (fused_conv.cu and
// conv_backward.cu): the dtype codes of the ctypes interface, f32
// conversions, and the SIMT fp32 GEMM main loop both implicit-GEMM
// convolutions run: BK = 8 slices double-buffered in shared memory with the
// next slice held in registers, 8 x 8 fp32 accumulators per thread, each
// output summing its K products in order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kBK = 8;
constexpr int kPad = 4;  // shared-memory row padding: no bank conflicts

// The block computes a BM x BN tile of C = A B. `load(k)` brings the BK
// slice starting at k into the calling thread's registers, `store(buf)`
// writes them into As[buf][k][m] / Bs[buf][k][n]; the thread at (tx, ty)
// accumulates rows row_of<BM>(tx, 0..7) and columns row_of<BN>(ty, 0..7).
template <int BM, int BN, typename Load, typename Store>
__device__ __forceinline__ void gemm_mainloop(
    int k0, int nk, Load&& load, Store&& store,
    float (&As)[2][kBK][BM + kPad], float (&Bs)[2][kBK][BN + kPad],
    float (&acc)[8][8], int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (nk <= 0) return;
  load(k0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load(k0 + (t + 1) * kBK);
#pragma unroll
    for (int kq = 0; kq < kBK; ++kq) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kq][tx * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kq][tx * 4 + BM / 2]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kq][ty * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kq][ty * 4 + BN / 2]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
}

// the row (or column) of a thread's i-th accumulator within the tile
template <int BM> __device__ __forceinline__ int row_of(int t, int i) {
  return t * 4 + (i & 3) + (i >> 2) * (BM / 2);
}

}  // namespace
