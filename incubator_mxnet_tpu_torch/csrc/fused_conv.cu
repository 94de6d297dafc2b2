// Hand-written Hopper (sm_90a) kernels of the ResNet inference path, with a
// plain C interface that incubator_mxnet_tpu_torch/parallel/fused_conv.py
// loads through ctypes. That module also holds the plain PyTorch twins and
// the note on what bounds each kernel on the card.
//
//   mx_bn_epilogue   replaces incubator_mxnet_tpu/parallel/fused_conv.py
//                    _epi_kernel and _epi_res_kernel (tuned names bn_apply,
//                    bn_act, bn_add_act)
//   mx_conv_bn_relu  replaces incubator_mxnet_tpu/parallel/fused_conv.py
//                    _conv_taps_kernel and _conv_patch_kernel (tuned name
//                    conv_bn_relu)
//
// Numerics follow the TPU kernels in order: f32 accumulate, cast to the
// data dtype, re-promote to f32 for `* scale + bias`, cast, then the
// residual add in the data dtype, then ReLU. The multiply and the add are
// rounded separately (__fmul_rn, __fadd_rn), as two PyTorch ops round them,
// so an fp32 epilogue matches its plain twin bit for bit.
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "simt_gemm.cuh"

namespace {

__device__ __forceinline__ float scale_bias(float z, float s, float b) {
  return __fadd_rn(__fmul_rn(z, s), b);
}

// keeps NaN, like torch.relu and jnp.maximum(x, 0)
template <typename T> __device__ __forceinline__ T relu(T v) {
  return to_f32(v) < 0.f ? from_f32<T>(0.f) : v;
}

// ---------------------------------------------------------------------------
// BN epilogue: out = relu?(cast(z * scale[c] + bias[c]) (+ residual))
// over a contiguous NCHW tensor, VEC elements (16 bytes) per thread step.
// ---------------------------------------------------------------------------

template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC, bool RELU, bool RES>
__global__ void __launch_bounds__(256)
bn_epilogue_kernel(const T* __restrict__ z, const float* __restrict__ scale,
                   const float* __restrict__ bias, const T* __restrict__ res,
                   T* __restrict__ out, uint32_t nvec, uint32_t hw,
                   uint32_t c) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t v = blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    const uint32_t i0 = v * VEC;
    const uint32_t q = i0 / hw;
    uint32_t r = i0 - q * hw;
    uint32_t ch = q % c;
    const Pack<T, VEC> zp = reinterpret_cast<const Pack<T, VEC>*>(z)[v];
    Pack<T, VEC> rp;
    if constexpr (RES) rp = reinterpret_cast<const Pack<T, VEC>*>(res)[v];
    Pack<T, VEC> op;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      T y = from_f32<T>(
          scale_bias(to_f32(zp.v[j]), __ldg(scale + ch), __ldg(bias + ch)));
      if constexpr (RES) y = from_f32<T>(__fadd_rn(to_f32(y), to_f32(rp.v[j])));
      if constexpr (RELU) y = relu(y);
      op.v[j] = y;
      if (++r == hw) {
        r = 0;
        if (++ch == c) ch = 0;
      }
    }
    reinterpret_cast<Pack<T, VEC>*>(out)[v] = op;
  }
}

template <typename T, int VEC, bool RELU, bool RES>
cudaError_t launch_epilogue(const void* z, const void* scale, const void* bias,
                            const void* res, void* out, long long numel,
                            int hw, int c, cudaStream_t stream) {
  const uint32_t nvec = static_cast<uint32_t>(numel / VEC);
  const int threads = 256;
  long long blocks = (nvec + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 per SM
  bn_epilogue_kernel<T, VEC, RELU, RES>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          static_cast<const T*>(z), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<const T*>(res),
          static_cast<T*>(out), nvec, hw, c);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t epilogue_flags(const void* z, const void* scale, const void* bias,
                           const void* res, void* out, long long numel, int hw,
                           int c, int relu_on, cudaStream_t s) {
  if (relu_on)
    return res ? launch_epilogue<T, VEC, true, true>(z, scale, bias, res, out,
                                                     numel, hw, c, s)
               : launch_epilogue<T, VEC, true, false>(z, scale, bias, res, out,
                                                      numel, hw, c, s);
  return res ? launch_epilogue<T, VEC, false, true>(z, scale, bias, res, out,
                                                    numel, hw, c, s)
             : launch_epilogue<T, VEC, false, false>(z, scale, bias, res, out,
                                                     numel, hw, c, s);
}

template <typename T>
cudaError_t epilogue_dispatch(const void* z, const void* scale,
                              const void* bias, const void* res, void* out,
                              long long numel, int hw, int c, int relu_on,
                              int vec, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return epilogue_flags<T, kVec>(z, scale, bias, res, out, numel, hw, c,
                                   relu_on, s);
  if (vec == 1)
    return epilogue_flags<T, 1>(z, scale, bias, res, out, numel, hw, c,
                                relu_on, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// conv + BN + ReLU: k x k, stride 1, same-size output, pads (plo, k-1-plo).
// Implicit GEMM on SIMT fp32 FMAs, C[m, co] = sum_kk A[m, kk] * B[kk, co],
// with m = (image, oh, ow), kk = (ci, kh, kw) in OIHW order, co the output
// channel. A BM x BN tile per block, BK = 8 deep, double-buffered in shared
// memory with the next tile's loads held in registers; 8 x 8 outputs per
// thread. Each output sums kk = 0..K-1 in order, so a row's result does not
// depend on the batch it was computed in.
// ---------------------------------------------------------------------------

template <typename T, int KS, int BM, int BN>
__global__ void __launch_bounds__((BM / 8) * (BN / 8))
conv_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ out,
                    int C, int H, int W, int CO, int k_rt, int plo_h,
                    int plo_w, int M) {
  constexpr int TX = BM / 8;              // threads along m
  constexpr int NT = TX * (BN / 8);       // threads per block
  constexpr int A_KSTEP = NT / BM;        // A rows one pass of threads loads
  constexpr int A_PER = kBK / A_KSTEP;    // A elements per thread per tile
  constexpr int B_NSTEP = NT / kBK;       // B columns one pass loads
  constexpr int B_PER = BN / B_NSTEP;     // B elements per thread per tile
  static_assert(NT >= BM && NT % BM == 0 && A_PER * A_KSTEP == kBK, "A map");
  static_assert(B_PER * B_NSTEP == BN, "B map");

  __shared__ __align__(16) float As[2][kBK][BM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][BN + kPad];

  const int k = KS > 0 ? KS : k_rt;
  const int kk2 = k * k;
  const int HW = H * W;
  const int K = C * kk2;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the output pixel whose A row this thread loads is fixed for the K loop
  const int a_m = tid % BM;
  const int a_k = tid / BM;
  const int gm = m0 + a_m;
  const bool m_ok = gm < M;
  int img = 0, oh = 0, ow = 0;
  if (m_ok) {
    img = gm / HW;
    const int p = gm - img * HW;
    oh = p / W;
    ow = p - oh * W;
  }
  const T* xb = x + static_cast<size_t>(img) * C * HW;
  const int b_k = tid % kBK;
  const int b_n = tid / kBK;

  float a_reg[A_PER];
  float b_reg[B_PER];

  auto load_tiles = [&](int kt) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int kk = kt + a_k + A_KSTEP * j;
      float v = 0.f;
      if (m_ok && kk < K) {
        const int ci = kk / kk2;
        const int r = kk - ci * kk2;
        const int kh = r / k;
        const int kw = r - kh * k;
        const int ih = oh + kh - plo_h;
        const int iw = ow + kw - plo_w;
        if (static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
            static_cast<unsigned>(iw) < static_cast<unsigned>(W))
          v = to_f32(xb[static_cast<size_t>(ci) * HW + ih * W + iw]);
      }
      a_reg[j] = v;
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int kk = kt + b_k;
      const int co = n0 + b_n + B_NSTEP * j;
      b_reg[j] = (kk < K && co < CO)
                     ? to_f32(w[static_cast<size_t>(co) * K + kk])
                     : 0.f;
    }
  };
  auto store_tiles = [&](int buf) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) As[buf][a_k + A_KSTEP * j][a_m] = a_reg[j];
#pragma unroll
    for (int j = 0; j < B_PER; ++j) Bs[buf][b_k][b_n + B_NSTEP * j] = b_reg[j];
  };

  const int tx = tid % TX;
  const int ty = tid / TX;
  float acc[8][8];
  gemm_mainloop<BM, BN>(0, (K + kBK - 1) / kBK, load_tiles, store_tiles, As,
                        Bs, acc, tx, ty);

  // epilogue in registers: cast, scale/bias, cast, ReLU, one store
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + row_of<BM>(tx, i);
    if (m >= M) continue;
    const int im = m / HW;
    const int p = m - im * HW;
    T* ob = out + static_cast<size_t>(im) * CO * HW + p;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = n0 + row_of<BN>(ty, j);
      if (co >= CO) continue;
      const float zq = to_f32(from_f32<T>(acc[i][j]));
      const T y = from_f32<T>(scale_bias(zq, __ldg(scale + co),
                                         __ldg(bias + co)));
      ob[static_cast<size_t>(co) * HW] = relu(y);
    }
  }
}

template <typename T, int KS, int BM, int BN>
cudaError_t launch_conv(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, int n, int c, int h,
                        int wd, int co, int k, int plo_h, int plo_w,
                        cudaStream_t stream) {
  const int m = n * h * wd;
  const dim3 grid((m + BM - 1) / BM, (co + BN - 1) / BN);
  conv_bn_relu_kernel<T, KS, BM, BN><<<grid, (BM / 8) * (BN / 8), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), c, h, wd, co, k, plo_h, plo_w, m);
  return cudaGetLastError();
}

template <typename T, int BM, int BN>
cudaError_t conv_ks(const void* x, const void* w, const void* scale,
                    const void* bias, void* out, int n, int c, int h, int wd,
                    int co, int k, int plo_h, int plo_w, cudaStream_t s) {
  if (k == 1)
    return launch_conv<T, 1, BM, BN>(x, w, scale, bias, out, n, c, h, wd, co,
                                     k, plo_h, plo_w, s);
  if (k == 3)
    return launch_conv<T, 3, BM, BN>(x, w, scale, bias, out, n, c, h, wd, co,
                                     k, plo_h, plo_w, s);
  return launch_conv<T, 0, BM, BN>(x, w, scale, bias, out, n, c, h, wd, co, k,
                                   plo_h, plo_w, s);
}

// tile by shape: a 64-wide channel tile when there are at most 64 output
// channels; otherwise 128 x 128 when that already gives two blocks per SM
// (132 SMs), else 64 x 64 so small late-stage maps still fill the card.
template <typename T>
cudaError_t conv_dispatch(const void* x, const void* w, const void* scale,
                          const void* bias, void* out, int n, int c, int h,
                          int wd, int co, int k, int plo_h, int plo_w,
                          cudaStream_t s) {
  const long long m = static_cast<long long>(n) * h * wd;
  if (co <= 64)
    return conv_ks<T, 256, 64>(x, w, scale, bias, out, n, c, h, wd, co, k,
                               plo_h, plo_w, s);
  if (((m + 127) / 128) * ((co + 127) / 128) >= 2 * 132)
    return conv_ks<T, 128, 128>(x, w, scale, bias, out, n, c, h, wd, co, k,
                                plo_h, plo_w, s);
  return conv_ks<T, 64, 64>(x, w, scale, bias, out, n, c, h, wd, co, k, plo_h,
                            plo_w, s);
}

}  // namespace

extern "C" {

const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mx_bn_epilogue(const void* z, const void* scale, const void* bias,
                   const void* res, void* out, long long numel, int hw, int c,
                   int dtype, int relu_on, int vec, void* stream) {
  if (numel <= 0 || hw <= 0 || c <= 0 || vec <= 0 || numel % vec)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return epilogue_dispatch<float>(z, scale, bias, res, out, numel, hw, c,
                                    relu_on, vec, s);
  if (dtype == kBFloat16)
    return epilogue_dispatch<__nv_bfloat16>(z, scale, bias, res, out, numel,
                                            hw, c, relu_on, vec, s);
  return cudaErrorInvalidValue;
}

int mx_conv_bn_relu(const void* x, const void* w, const void* scale,
                    const void* bias, void* out, int n, int c, int h, int wd,
                    int co, int k, int plo_h, int plo_w, int dtype,
                    void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0 || co <= 0 || k <= 0 ||
      plo_h < 0 || plo_h >= k || plo_w < 0 || plo_w >= k)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return conv_dispatch<float>(x, w, scale, bias, out, n, c, h, wd, co, k,
                                plo_h, plo_w, s);
  if (dtype == kBFloat16)
    return conv_dispatch<__nv_bfloat16>(x, w, scale, bias, out, n, c, h, wd,
                                        co, k, plo_h, plo_w, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
