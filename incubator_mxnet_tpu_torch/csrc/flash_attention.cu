// Hand-written Hopper (sm_90a) kernels of the transformer training path:
// blocked flash attention, forward and the two backward kernels, with a
// plain C interface that incubator_mxnet_tpu_torch/parallel/
// flash_attention.py loads through ctypes (that module also holds the plain
// PyTorch twins and the note on what bounds the kernels on the card).
//
//   mx_fa_fwd      replaces incubator_mxnet_tpu/parallel/flash_attention.py
//                  _fa_kernel          (tuned name fa_fwd)
//   mx_fa_bwd_dq   replaces            _fa_bwd_dq_kernel (fa_bwd_dq)
//   mx_fa_bwd_dkv  replaces            _fa_bwd_dkv_kernel (fa_bwd_dkv)
//
// Layout: q (BH, Tq, D), k and v (BH, Tk, D), contiguous; lse, dlse and
// delta (BH, Tq) f32. D is a multiple of 8 and at most 128; Tq and Tk are
// any lengths (the ragged last tile is masked). float32 and bfloat16.
//
// FlashAttention-2 structure: one CTA of four warps owns a 64-row tile
// (q rows for the forward and dq, kv rows for dk/dv) and streams the other
// operand in 64-row tiles through shared memory; each warp owns 16 rows,
// and its per-row statistics (running max and sum, lse, delta) live in
// registers. Every gradient has one writer (dq in the dq kernel, dk and dv
// in the dk/dv kernel): no atomics, so reruns are bit-identical.
//
// Tile products: bf16 runs warp-level mma.sync.m16n8k16 (bf16 operands, f32
// accumulation), the product the TPU kernels run on the MXU; float32 runs
// SIMT FMA with the same ownership of the output fragment (no TF32: the
// port's fp32 contract is full precision). Operands come from shared memory
// in both cases; the softmax tiles P and dS are written to a per-warp strip
// of shared memory in the input dtype before their product, which is where
// the TPU kernels round them (p.astype(v.dtype), ds.astype(k.dtype)).
//
// Cast points kept from the TPU kernels: q is scaled IN THE INPUT DTYPE
// (q * dtype(sm_scale), rounded) before Q K^T; masked scores are -1e30;
// fully masked rows give a zero output and lse 1e30; delta = rowsum(dO * O)
// - dlse in f32; dq and dk are scaled by sm_scale in f32 at the end.
// Causal kv (or q) tiles strictly on the masked side of the diagonal are
// skipped.
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows of the owned and streamed tiles
constexpr int kWarps = 4;          // 16 owned rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kTile / 8;     // 8-wide fragments across a streamed tile
constexpr float kMasked = -1e30f;  // the TPU kernels' mask value
constexpr float kEmptyLse = 1e30f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Elements per 16-byte vector; rows of a shared tile are padded by one
// vector so that the fragment reads below do not collide on banks.
template <typename T>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);
};

template <typename T, int DP>
__host__ __device__ constexpr int pitch() { return DP + Tile<T>::kVec; }
template <typename T>
__host__ __device__ constexpr int strip_pitch() {
  return kTile + Tile<T>::kVec;
}

// Rows [row0, row0 + 64) of a (rows, D) matrix into a (64, DP) shared tile;
// rows past `rows` and columns past D are zero. With `scale`, every element
// is replaced by T(x * T(sm_scale)), the TPU kernels' scaled q.
template <typename T, int DP, bool kScale>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int rows, int D, float sm_scale) {
  constexpr int kVec = Tile<T>::kVec;
  constexpr int kChunks = DP / kVec;
  constexpr int P = pitch<T, DP>();
  const float s = to_f(from_f<T>(sm_scale));
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows && c < D) {
      val = *reinterpret_cast<const uint4*>(
          src + (static_cast<long long>(row0) + r) * D + c);
      if (kScale) {
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int u = 0; u < kVec; ++u) e[u] = from_f<T>(to_f(e[u]) * s);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
}

// ---------------------------------------------------------------------------
// Warp tile product C[16, 8 * NT] += A[16, K] * B[K, 8 * NT].
// A is row-major in shared memory (k contiguous, row pitch lda). B(k, n) is
// b[n * ldb + k] when kBKContig, else b[k * ldb + n]. The thread with lane
// = 4 * g + t owns c[nt][0..1] = C[g][8 nt + 2 t + {0, 1}] and c[nt][2..3] =
// C[g + 8][same columns]: the accumulator layout of mma.m16n8k16.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int K, int NT, bool kBKContig>
__device__ __forceinline__ void warp_mma(float (*c)[4], const bf16* a,
                                         int lda, const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    const bf16* ar = a + g * lda + k0 + 2 * t;
    af[0] = ld32(ar);
    af[1] = ld32(ar + 8 * lda);
    af[2] = ld32(ar + 8);
    af[3] = ld32(ar + 8 * lda + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      uint32_t b0, b1;
      if (kBKContig) {
        const bf16* br = b + n * ldb + k0 + 2 * t;
        b0 = ld32(br);
        b1 = ld32(br + 8);
      } else {
        const bf16* br = b + (k0 + 2 * t) * ldb + n;
        b0 = pack2(br[0], br[ldb]);
        b1 = pack2(br[8 * ldb], br[9 * ldb]);
      }
      mma16816(c[nt], af, b0, b1);
    }
  }
}

template <int K, int NT, bool kBKContig>
__device__ __forceinline__ void warp_mma(float (*c)[4], const float* a,
                                         int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * lda + k];
    const float a1 = a[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      float b0, b1;
      if (kBKContig) {
        b0 = b[n * ldb + k];
        b1 = b[(n + 1) * ldb + k];
      } else {
        b0 = b[k * ldb + n];
        b1 = b[k * ldb + n + 1];
      }
      c[nt][0] = fmaf(a0, b0, c[nt][0]);
      c[nt][1] = fmaf(a0, b1, c[nt][1]);
      c[nt][2] = fmaf(a1, b0, c[nt][2]);
      c[nt][3] = fmaf(a1, b1, c[nt][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (*c)[4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Masks a score tile in place. Fragment element (nt, e) sits at row
// row0 + g + 8 (e >> 1) and column col0 + 8 nt + 2 t + (e & 1) of the
// score matrix S[q, kv] (kTransposed: S^T[kv, q], rows kv and columns q).
// Columns past `cols` (the padded ragged tile) get -inf, so they weigh
// exactly nothing; causal masking keeps q >= kv and writes -1e30.
template <bool kTransposed>
__device__ __forceinline__ void mask_scores(float (*s)[4], int row0, int col0,
                                            int cols, bool causal) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const int col = col0 + nt * 8 + 2 * t + (e & 1);
      const int qi = kTransposed ? col : row;
      const int ki = kTransposed ? row : col;
      if (!kTransposed && col >= cols) {
        s[nt][e] = -INFINITY;
      } else if (causal && qi < ki) {
        s[nt][e] = kMasked;
      }
    }
  }
}

// Writes a (16, 64) fragment tile, rounded to T, into the warp's strip.
template <typename T>
__device__ __forceinline__ void store_strip(T* strip, float (*v)[4]) {
  constexpr int PS = strip_pitch<T>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int c = nt * 8 + 2 * t;
    strip[g * PS + c] = from_f<T>(v[nt][0]);
    strip[g * PS + c + 1] = from_f<T>(v[nt][1]);
    strip[(g + 8) * PS + c] = from_f<T>(v[nt][2]);
    strip[(g + 8) * PS + c + 1] = from_f<T>(v[nt][3]);
  }
}

// Stores a (16, DP) accumulator, times `scale`, into rows row0.. of a
// (rows, D) output.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, float (*acc)[4], int row0,
                                           int rows, int D, float scale) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e >> 1);
      const int c = dn * 8 + 2 * t + (e & 1);
      if (r < rows && c < D)
        dst[static_cast<long long>(r) * D + c] = from_f<T>(acc[dn][e] * scale);
    }
  }
}

// Owned tile index and batch*head of this CTA. Heavy causal tiles go
// first: the last q tiles (forward, dq) or the first kv tiles (dk/dv).
__device__ __forceinline__ void tile_of(int tiles, int bh_count,
                                        bool last_first, int* tile,
                                        int* bh) {
  const int order = blockIdx.x / bh_count;
  *bh = blockIdx.x % bh_count;
  *tile = last_first ? tiles - 1 - order : order;
}

// ---------------------------------------------------------------------------
// forward: out, lse
// ---------------------------------------------------------------------------

template <typename T, int DP>
constexpr size_t fwd_smem() {
  return (3 * kTile * pitch<T, DP>() + kTile * strip_pitch<T>()) * sizeof(T);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int BH, int Tq, int Tk, int D,
              bool causal, float sm_scale) {
  constexpr int P = pitch<T, DP>();
  constexpr int PS = strip_pitch<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kTile * P;
  T* vs = ks + kTile * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* strip = vs + kTile * P + warp * 16 * PS;

  int tile, bh;
  tile_of((Tq + kTile - 1) / kTile, BH, causal, &tile, &bh);
  const int q0 = tile * kTile;
  const int rw = q0 + warp * 16;            // first row of this warp
  q += static_cast<long long>(bh) * Tq * D;
  k += static_cast<long long>(bh) * Tk * D;
  v += static_cast<long long>(bh) * Tk * D;

  load_tile<T, DP, true>(qs, q, q0, Tq, D, sm_scale);
  const T* qw = qs + warp * 16 * P;

  float acc[DP / 8][4];
  zero<DP / 8>(acc);
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  int n_kv = (Tk + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, (q0 + kTile - 1) / kTile + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int c0 = j * kTile;
    __syncthreads();                        // the last tile's readers are done
    load_tile<T, DP, false>(ks, k, c0, Tk, D, 0.f);
    load_tile<T, DP, false>(vs, v, c0, Tk, D, 0.f);
    __syncthreads();
    float s[kNT][4];
    zero<kNT>(s);
    warp_mma<DP, kNT, true>(s, qw, P, ks, P);
    mask_scores<false>(s, rw, c0, Tk, causal);
    float mn[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mn[h] = fmaxf(m[h], quad_max(mx));
      alpha[h] = expf(m[h] - mn[h]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - mn[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
      m[h] = mn[h];
    }
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    store_strip<T>(strip, s);
    __syncwarp();
    warp_mma<kTile, DP / 8, false>(acc, strip, PS, vs, P);
    __syncwarp();
  }

  out += static_cast<long long>(bh) * Tq * D;
  lse += static_cast<long long>(bh) * Tq;
  float den[2];                 // a fully masked row divides by 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] = l[h] == 0.f ? 1.f : l[h];
    const int r = rw + g + 8 * h;
    if (t == 0 && r < Tq)
      lse[r] = l[h] == 0.f ? kEmptyLse : m[h] + logf(den[h]);
  }
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rw + g + 8 * (e >> 1);
      const int c = dn * 8 + 2 * t + (e & 1);
      if (r < Tq && c < D)
        out[static_cast<long long>(r) * D + c] =
            from_f<T>(acc[dn][e] / den[e >> 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dq and delta
// ---------------------------------------------------------------------------

template <typename T, int DP>
constexpr size_t dq_smem() {
  return (4 * kTile * pitch<T, DP>() + kTile * strip_pitch<T>()) * sizeof(T) +
         kTile * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const T* __restrict__ out,
                 const float* __restrict__ dlse, T* __restrict__ dq,
                 float* __restrict__ delta, int BH, int Tq, int Tk, int D,
                 bool causal, float sm_scale) {
  constexpr int P = pitch<T, DP>();
  constexpr int PS = strip_pitch<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kTile * P;
  T* ks = dos + kTile * P;
  T* vs = ks + kTile * P;
  T* strips = vs + kTile * P;
  float* delta_s = reinterpret_cast<float*>(strips + kTile * PS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  T* strip = strips + warp * 16 * PS;

  int tile, bh;
  tile_of((Tq + kTile - 1) / kTile, BH, causal, &tile, &bh);
  const int q0 = tile * kTile;
  const int rw = q0 + warp * 16;
  const long long qoff = static_cast<long long>(bh) * Tq * D;
  const long long koff = static_cast<long long>(bh) * Tk * D;
  const long long roff = static_cast<long long>(bh) * Tq;

  load_tile<T, DP, true>(qs, q + qoff, q0, Tq, D, sm_scale);
  load_tile<T, DP, false>(dos, dout + qoff, q0, Tq, D, 0.f);
  // delta = rowsum(dO * O) - dlse, f32, one warp per 16 rows
  for (int i = 0; i < 16; ++i) {
    const int r = rw + i;
    float part = 0.f;
    if (r < Tq) {
      const T* dr = dout + qoff + static_cast<long long>(r) * D;
      const T* orow = out + qoff + static_cast<long long>(r) * D;
      for (int c = lane; c < D; c += 32) part += to_f(dr[c]) * to_f(orow[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) {
      float d = 0.f;
      if (r < Tq) {
        d = part - dlse[roff + r];
        delta[roff + r] = d;
      }
      delta_s[warp * 16 + i] = d;
    }
  }
  __syncwarp();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + g + 8 * h;
    lse_r[h] = r < Tq ? lse[roff + r] : INFINITY;
    delta_r[h] = delta_s[warp * 16 + g + 8 * h];
  }
  const T* qw = qs + warp * 16 * P;
  const T* dow = dos + warp * 16 * P;

  float acc[DP / 8][4];
  zero<DP / 8>(acc);
  int n_kv = (Tk + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, (q0 + kTile - 1) / kTile + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int c0 = j * kTile;
    __syncthreads();
    load_tile<T, DP, false>(ks, k + koff, c0, Tk, D, 0.f);
    load_tile<T, DP, false>(vs, v + koff, c0, Tk, D, 0.f);
    __syncthreads();
    float s[kNT][4], dp[kNT][4];
    zero<kNT>(s);
    zero<kNT>(dp);
    warp_mma<DP, kNT, true>(s, qw, P, ks, P);
    mask_scores<false>(s, rw, c0, Tk, causal);
    warp_mma<DP, kNT, true>(dp, dow, P, vs, P);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - lse_r[e >> 1]);
        s[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]);
      }
    }
    store_strip<T>(strip, s);
    __syncwarp();
    warp_mma<kTile, DP / 8, false>(acc, strip, PS, ks, P);
    __syncwarp();
  }
  store_rows<T, DP>(dq + qoff, acc, rw, Tq, D, sm_scale);
}

// ---------------------------------------------------------------------------
// backward, dk and dv
// ---------------------------------------------------------------------------

template <typename T, int DP>
constexpr size_t dkv_smem() {
  return (5 * kTile * pitch<T, DP>() + kTile * strip_pitch<T>()) * sizeof(T) +
         2 * kTile * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ q, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int BH, int Tq, int Tk, int D,
                  bool causal, float sm_scale) {
  constexpr int P = pitch<T, DP>();
  constexpr int PS = strip_pitch<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kTile * P;
  T* qt = vs + kTile * P;        // q tile as given (for dK)
  T* qst = qt + kTile * P;       // q tile scaled (for S^T)
  T* dot = qst + kTile * P;
  T* strips = dot + kTile * P;
  float* lse_s = reinterpret_cast<float*>(strips + kTile * PS);
  float* delta_s = lse_s + kTile;
  const int warp = threadIdx.x >> 5;
  T* strip = strips + warp * 16 * PS;

  int tile, bh;
  tile_of((Tk + kTile - 1) / kTile, BH, false, &tile, &bh);
  const int k0 = tile * kTile;
  const int rw = k0 + warp * 16;
  const long long qoff = static_cast<long long>(bh) * Tq * D;
  const long long koff = static_cast<long long>(bh) * Tk * D;
  const long long roff = static_cast<long long>(bh) * Tq;

  load_tile<T, DP, false>(ks, k + koff, k0, Tk, D, 0.f);
  load_tile<T, DP, false>(vs, v + koff, k0, Tk, D, 0.f);
  const T* kw = ks + warp * 16 * P;
  const T* vw = vs + warp * 16 * P;

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
  zero<DP / 8>(dk_acc);
  zero<DP / 8>(dv_acc);
  const int n_q = (Tq + kTile - 1) / kTile;
  // causal: the q tile i runs iff its last row i*64 + 63 >= k0
  const int i0 = causal ? k0 / kTile : 0;
  for (int i = i0; i < n_q; ++i) {
    const int c0 = i * kTile;
    __syncthreads();
    load_tile<T, DP, false>(qt, q + qoff, c0, Tq, D, 0.f);
    load_tile<T, DP, true>(qst, q + qoff, c0, Tq, D, sm_scale);
    load_tile<T, DP, false>(dot, dout + qoff, c0, Tq, D, 0.f);
    if (threadIdx.x < kTile) {
      const int r = c0 + threadIdx.x;
      // padded q rows weigh nothing: exp(s - inf) = 0
      lse_s[threadIdx.x] = r < Tq ? lse[roff + r] : INFINITY;
      delta_s[threadIdx.x] = r < Tq ? delta[roff + r] : 0.f;
    }
    __syncthreads();
    float st[kNT][4], dpt[kNT][4];
    zero<kNT>(st);
    warp_mma<DP, kNT, true>(st, kw, P, qst, P);
    mask_scores<true>(st, rw, c0, Tq, causal);
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] = expf(st[nt][e] - lse_s[nt * 8 + 2 * t + (e & 1)]);
    }
    store_strip<T>(strip, st);
    __syncwarp();
    warp_mma<kTile, DP / 8, false>(dv_acc, strip, PS, dot, P);
    zero<kNT>(dpt);
    warp_mma<DP, kNT, true>(dpt, vw, P, dot, P);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] *= dpt[nt][e] - delta_s[nt * 8 + 2 * t + (e & 1)];
    }
    __syncwarp();                  // every lane is done reading P^T
    store_strip<T>(strip, st);
    __syncwarp();
    warp_mma<kTile, DP / 8, false>(dk_acc, strip, PS, qt, P);
  }
  store_rows<T, DP>(dk + koff, dk_acc, rw, Tk, D, sm_scale);
  store_rows<T, DP>(dv + koff, dv_acc, rw, Tk, D, 1.f);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline bool shape_ok(int bh, int tq, int tk, int d) {
  return bh > 0 && tq > 0 && tk > 0 && d > 0 && d % 8 == 0 && d <= 128;
}

template <typename T, int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int bh, int tq, int tk, int d, bool causal,
                float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<T, DP>();
  cudaError_t err = prepare(fa_fwd_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((tq + kTile - 1) / kTile) * bh;
  fa_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), bh, tq, tk, d, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* out,
                   const void* dlse, void* dq, void* delta, int bh, int tq,
                   int tk, int d, bool causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = dq_smem<T, DP>();
  cudaError_t err = prepare(fa_bwd_dq_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((tq + kTile - 1) / kTile) * bh;
  fa_bwd_dq_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const T*>(out),
      static_cast<const float*>(dlse), static_cast<T*>(dq),
      static_cast<float*>(delta), bh, tq, tk, d, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t bwd_dkv(const void* k, const void* v, const void* q,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int tq, int tk, int d,
                    bool causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<T, DP>();
  cudaError_t err = prepare(fa_bwd_dkv_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((tk + kTile - 1) / kTile) * bh;
  fa_bwd_dkv_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(q), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), bh, tq, tk, d, causal,
      scale);
  return cudaGetLastError();
}

// dtype codes of parallel/hand_kernel.py DTYPE_CODE: 0 float32, 1 bfloat16;
// the head dim is padded to 64 or 128 in shared memory.
#define MX_FA_DISPATCH(FN, ...)                                          \
  do {                                                                    \
    if (dtype == 0)                                                       \
      return d <= 64 ? FN<float, 64>(__VA_ARGS__)                         \
                     : FN<float, 128>(__VA_ARGS__);                       \
    if (dtype == 1)                                                       \
      return d <= 64 ? FN<bf16, 64>(__VA_ARGS__) : FN<bf16, 128>(__VA_ARGS__); \
    return cudaErrorInvalidValue;                                         \
  } while (0)

}  // namespace

extern "C" {

const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (BH, Tq, D) and lse (BH, Tq) f32 of softmax(q k^T * sm_scale) v.
int mx_fa_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int bh, int tq, int tk, int d, int causal,
              float sm_scale, int dtype, void* stream) {
  if (!shape_ok(bh, tq, tk, d)) return cudaErrorInvalidValue;
  MX_FA_DISPATCH(fwd, q, k, v, out, lse, bh, tq, tk, d, causal != 0,
                 sm_scale, static_cast<cudaStream_t>(stream));
}

// dq (BH, Tq, D) and delta (BH, Tq) f32 = rowsum(dO * O) - dlse.
int mx_fa_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* out,
                 const void* dlse, void* dq, void* delta, int bh, int tq,
                 int tk, int d, int causal, float sm_scale, int dtype,
                 void* stream) {
  if (!shape_ok(bh, tq, tk, d)) return cudaErrorInvalidValue;
  MX_FA_DISPATCH(bwd_dq, q, k, v, dout, lse, out, dlse, dq, delta, bh, tq,
                 tk, d, causal != 0, sm_scale,
                 static_cast<cudaStream_t>(stream));
}

// dk, dv (BH, Tk, D) from the forward's lse and the dq kernel's delta.
int mx_fa_bwd_dkv(const void* k, const void* v, const void* q,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int tq, int tk, int d,
                  int causal, float sm_scale, int dtype, void* stream) {
  if (!shape_ok(bh, tq, tk, d)) return cudaErrorInvalidValue;
  MX_FA_DISPATCH(bwd_dkv, k, v, q, dout, lse, delta, dk, dv, bh, tq, tk, d,
                 causal != 0, sm_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
