// Hand-written Hopper (sm_90a) kernel of the ResNet training path: the
// backward of a 3x3 stride-1 pad-1 NCHW convolution, dx and dW together,
// with a plain C interface that incubator_mxnet_tpu_torch/parallel/
// conv_backward.py loads through ctypes (that module also holds the plain
// PyTorch twin and the note on what bounds the kernel on the card).
//
//   mx_conv3x3_bwd   replaces incubator_mxnet_tpu/parallel/conv_backward.py
//                    _patch_kernel and _bwd_kernel (entry
//                    conv3x3_bwd_fused; tuned name conv3x3)
//
// One call of mx_conv3x3_bwd is one launch of the ported kernel; it issues
// three device kernels on the stream it is given:
//   dgrad_kernel   dx[n,i,h,w] = sum_{o,kh,kw} go[n,o,h+kh-1,w+kw-1]
//                                              * W[o,i,2-kh,2-kw]
//                  an implicit GEMM over M = N*H*W pixels, N = I, K = O*9,
//                  go gathered in place (padding is a predicate), the
//                  weight read flipped and transposed in place;
//   wgrad_kernel   partial[s][o][i,kh,kw] = sum over the s-th chunk of the
//                  N*H*W pixels of go[n,o,h,w] * x[n,i,h+kh-1,w+kw-1]
//                  a GEMM over M = O, N = I*9, K split into S chunks so the
//                  small dW tile grid still fills the card;
//   reduce_kernel  dW = sum_s partial[s], in order s = 0..S-1.
// No float atomics: every sum has a fixed order, so reruns are
// bit-identical. Every sum is f32 (bf16 inputs are widened on load) and is
// cast to the output's dtype once; no TF32.
//
// Both GEMMs run the SIMT main loop of simt_gemm.cuh, as fused_conv.cu's
// mx_conv_bn_relu does.
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "simt_gemm.cuh"

namespace {

// dW tiling and the split of its pixel reduction
constexpr int kWBM = 64;
constexpr int kWBN = 64;
constexpr long long kTargetBlocks = 8 * 132;  // 8 blocks per SM
constexpr long long kMinChunk = 512;          // pixels per split, at least

// ---------------------------------------------------------------------------
// dx: C[m, i] = sum_kk A[m, kk] * B[kk, i]; m = (image, h, w), kk = (o, kh,
// kw) in order, A = go gathered at (h + kh - 1, w + kw - 1), B = W[o, i,
// 2-kh, 2-kw]. A is loaded pixel-major (neighbouring threads, neighbouring
// pixels), as the forward kernel loads x.
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN>
__global__ void __launch_bounds__((BM / 8) * (BN / 8))
dgrad_kernel(const T* __restrict__ go, const T* __restrict__ w,
             T* __restrict__ dx, int CO, int CI, int H, int W, int M) {
  constexpr int TX = BM / 8;
  constexpr int NT = TX * (BN / 8);
  constexpr int A_KSTEP = NT / BM;
  constexpr int A_PER = kBK / A_KSTEP;
  constexpr int B_NSTEP = NT / kBK;
  constexpr int B_PER = BN / B_NSTEP;
  static_assert(NT >= BM && NT % BM == 0 && A_PER * A_KSTEP == kBK, "A map");
  static_assert(B_PER * B_NSTEP == BN, "B map");

  __shared__ __align__(16) float As[2][kBK][BM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][BN + kPad];

  const int HW = H * W;
  const int K = CO * 9;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

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
  const T* gob = go + static_cast<size_t>(img) * CO * HW;
  const int b_k = tid % kBK;
  const int b_n = tid / kBK;

  float a_reg[A_PER];
  float b_reg[B_PER];
  auto load = [&](int kt) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int kk = kt + a_k + A_KSTEP * j;
      float v = 0.f;
      if (m_ok && kk < K) {
        const int o = kk / 9;
        const int r = kk - o * 9;
        const int kh = r / 3;
        const int ih = oh + kh - 1;
        const int iw = ow + (r - kh * 3) - 1;
        if (static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
            static_cast<unsigned>(iw) < static_cast<unsigned>(W))
          v = to_f32(gob[static_cast<size_t>(o) * HW + ih * W + iw]);
      }
      a_reg[j] = v;
    }
    const int kk = kt + b_k;
    const int o = kk / 9;
    const int r = kk - o * 9;
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int i = n0 + b_n + B_NSTEP * j;
      b_reg[j] = (kk < K && i < CI)
                     ? to_f32(w[(static_cast<size_t>(o) * CI + i) * 9 + 8 - r])
                     : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) As[buf][a_k + A_KSTEP * j][a_m] = a_reg[j];
#pragma unroll
    for (int j = 0; j < B_PER; ++j) Bs[buf][b_k][b_n + B_NSTEP * j] = b_reg[j];
  };

  const int tx = tid % TX;
  const int ty = tid / TX;
  float acc[8][8];
  gemm_mainloop<BM, BN>(0, (K + kBK - 1) / kBK, load, store, As, Bs, acc, tx,
                        ty);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + row_of<BM>(tx, i);
    if (m >= M) continue;
    const int im = m / HW;
    const int p = m - im * HW;
    T* ob = dx + static_cast<size_t>(im) * CI * HW + p;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ci = n0 + row_of<BN>(ty, j);
      if (ci < CI) ob[static_cast<size_t>(ci) * HW] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dW partials: C[o, c] = sum_q A[o, q] * B[q, c] over the pixels q of chunk
// blockIdx.z; c = (i, kh, kw) is the OIHW column, A = go[n, o, q], B =
// x[n, i, h + kh - 1, w + kw - 1]. Both tiles are loaded pixel-major:
// eight neighbouring threads read eight neighbouring pixels (one 32-byte
// sector), and each thread decomposes its pixel once per slice.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__((kWBM / 8) * (kWBN / 8))
wgrad_kernel(const T* __restrict__ go, const T* __restrict__ x,
             float* __restrict__ part, int CO, int CI, int H, int W, int Q,
             int chunk) {
  constexpr int BM = kWBM, BN = kWBN;
  constexpr int TX = BM / 8;
  constexpr int NT = TX * (BN / 8);
  constexpr int ROWS = NT / kBK;  // rows (or columns) one pass loads
  constexpr int A_PER = BM / ROWS;
  constexpr int B_PER = BN / ROWS;
  static_assert(A_PER * ROWS == BM && B_PER * ROWS == BN, "load map");

  __shared__ __align__(16) float As[2][kBK][BM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][BN + kPad];

  const int HW = H * W;
  const int NC = CI * 9;
  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int q_begin = blockIdx.z * chunk;
  const int q_end = min(q_begin + chunk, Q);

  const int l_q = tid % kBK;
  const int l_r = tid / kBK;

  // per-thread column decomposition of its B columns, fixed for the loop
  int b_i[B_PER], b_dh[B_PER], b_dw[B_PER];
#pragma unroll
  for (int j = 0; j < B_PER; ++j) {
    const int c = c0 + l_r + ROWS * j;
    const int i = c / 9;
    const int r = c - i * 9;
    b_i[j] = c < NC ? i : -1;
    b_dh[j] = r / 3 - 1;
    b_dw[j] = r % 3 - 1;
  }

  float a_reg[A_PER];
  float b_reg[B_PER];
  auto load = [&](int kt) {
    const int q = kt + l_q;
    const bool ok = q < q_end;
    int img = 0, h = 0, wp = 0, p = 0;
    if (ok) {
      img = q / HW;
      p = q - img * HW;
      h = p / W;
      wp = p - h * W;
    }
    const T* gob = go + static_cast<size_t>(img) * CO * HW + p;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int o = o0 + l_r + ROWS * j;
      a_reg[j] = (ok && o < CO) ? to_f32(gob[static_cast<size_t>(o) * HW])
                                : 0.f;
    }
    const T* xb = x + static_cast<size_t>(img) * CI * HW;
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int ih = h + b_dh[j];
      const int iw = wp + b_dw[j];
      float v = 0.f;
      if (ok && b_i[j] >= 0 &&
          static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
          static_cast<unsigned>(iw) < static_cast<unsigned>(W))
        v = to_f32(xb[static_cast<size_t>(b_i[j]) * HW + ih * W + iw]);
      b_reg[j] = v;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) As[buf][l_q][l_r + ROWS * j] = a_reg[j];
#pragma unroll
    for (int j = 0; j < B_PER; ++j) Bs[buf][l_q][l_r + ROWS * j] = b_reg[j];
  };

  const int tx = tid % TX;
  const int ty = tid / TX;
  float acc[8][8];
  gemm_mainloop<BM, BN>(q_begin, (q_end - q_begin + kBK - 1) / kBK, load,
                        store, As, Bs, acc, tx, ty);

  float* pb = part + static_cast<size_t>(blockIdx.z) * CO * NC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = o0 + row_of<BM>(tx, i);
    if (o >= CO) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + row_of<BN>(ty, j);
      if (c < NC) pb[static_cast<size_t>(o) * NC + c] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part, T* __restrict__ dw, int n,
              int splits) {
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[static_cast<size_t>(z) * n + idx];
    dw[idx] = from_f32<T>(s);
  }
}

// the pixel chunk of one dW split: a multiple of BK, at least kMinChunk
// pixels, enough splits for about kTargetBlocks blocks
long long wgrad_chunk(long long q, long long co, long long ci) {
  const long long tiles =
      ((co + kWBM - 1) / kWBM) * ((ci * 9 + kWBN - 1) / kWBN);
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = q / kMinChunk > 1 ? q / kMinChunk : 1;
  if (splits > most) splits = most;
  long long chunk = (q + splits - 1) / splits;
  return (chunk + kBK - 1) / kBK * kBK;
}

template <typename T, int BM, int BN>
cudaError_t launch_dgrad(const void* go, const void* w, void* dx, int n,
                         int ci, int h, int wd, int co, cudaStream_t s) {
  const int m = n * h * wd;
  const dim3 grid((m + BM - 1) / BM, (ci + BN - 1) / BN);
  dgrad_kernel<T, BM, BN><<<grid, (BM / 8) * (BN / 8), 0, s>>>(
      static_cast<const T*>(go), static_cast<const T*>(w), static_cast<T*>(dx),
      co, ci, h, wd, m);
  return cudaGetLastError();
}

// dx tiles by shape, as mx_conv_bn_relu picks them: 256 x 64 when there
// are at most 64 input channels, 128 x 128 when that still gives two
// blocks per SM, else 64 x 64
template <typename T>
cudaError_t dgrad_dispatch(const void* go, const void* w, void* dx, int n,
                           int ci, int h, int wd, int co, cudaStream_t s) {
  const long long m = static_cast<long long>(n) * h * wd;
  if (ci <= 64) return launch_dgrad<T, 256, 64>(go, w, dx, n, ci, h, wd, co, s);
  if (((m + 127) / 128) * ((ci + 127) / 128) >= 2 * 132)
    return launch_dgrad<T, 128, 128>(go, w, dx, n, ci, h, wd, co, s);
  return launch_dgrad<T, 64, 64>(go, w, dx, n, ci, h, wd, co, s);
}

template <typename T>
cudaError_t conv3x3_bwd(const void* x, const void* w, const void* go,
                        void* dx, void* dw, float* ws, int n, int ci, int h,
                        int wd, int co, int splits, cudaStream_t s) {
  cudaError_t err = dgrad_dispatch<T>(go, w, dx, n, ci, h, wd, co, s);
  if (err != cudaSuccess) return err;
  const int q = n * h * wd;
  const int chunk = static_cast<int>(wgrad_chunk(q, co, ci));
  const dim3 grid((co + kWBM - 1) / kWBM, (ci * 9 + kWBN - 1) / kWBN, splits);
  wgrad_kernel<T><<<grid, (kWBM / 8) * (kWBN / 8), 0, s>>>(
      static_cast<const T*>(go), static_cast<const T*>(x), ws, co, ci, h, wd,
      q, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = co * ci * 9;
  int blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  reduce_kernel<T><<<blocks, 256, 0, s>>>(ws, static_cast<T*>(dw), total,
                                          splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// number of dW splits, i.e. the f32 workspace holds splits * co * ci * 9
int mx_conv3x3_bwd_splits(int n, int ci, int h, int wd, int co) {
  if (n <= 0 || ci <= 0 || h <= 0 || wd <= 0 || co <= 0) return 0;
  const long long q = static_cast<long long>(n) * h * wd;
  const long long chunk = wgrad_chunk(q, co, ci);
  return static_cast<int>((q + chunk - 1) / chunk);
}

int mx_conv3x3_bwd(const void* x, const void* w, const void* go, void* dx,
                   void* dw, void* ws, long long ws_elems, int n, int ci,
                   int h, int wd, int co, int dtype, void* stream) {
  const int splits = mx_conv3x3_bwd_splits(n, ci, h, wd, co);
  if (splits <= 0 ||
      static_cast<long long>(splits) * co * ci * 9 > ws_elems)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (dtype == kFloat32)
    return conv3x3_bwd<float>(x, w, go, dx, dw, wsf, n, ci, h, wd, co, splits,
                              s);
  if (dtype == kBFloat16)
    return conv3x3_bwd<__nv_bfloat16>(x, w, go, dx, dw, wsf, n, ci, h, wd, co,
                                      splits, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
