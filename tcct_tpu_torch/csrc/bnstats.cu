// Train-mode BatchNorm with an optional LeakyReLU(0.01) before it, forward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels tcct_tpu/ops/pallas/bnstats.py::_stats_kernel
// (pallas_call at bnstats.py:129) and ::_norm_kernel (bnstats.py:149), via
// bn_act_train_packed_pallas.  The TPU kernels work on a space-to-depth
// packed layout with phantom masks and fold the phases with a matmul; those
// are TPU layout artifacts.  Here the input is the port's own layout: x is
// [M, C] with channels fastest (an NCHW tensor in channels_last memory,
// M = B*H*W).
//
// Computes, per channel c, with t = act(x) in the input type:
//   mean = sum(t) / M,  var = sum(t*t) / M - mean^2   (f32 sums, biased, no clamp)
//   inv  = (1 / sqrt(var + eps)) * weight             (f32)
//   y    = (t - T(mean)) * T(inv) + T(bias)           (each step rounded to T)
// the arithmetic of the JAX package's default BatchNorm
// (tcct_tpu/models/layers.py:405-434), not the TPU kernel's folded
// t*inv + shift.  T is the input type (f32 or bf16); weight and bias come
// as f32.
//
// Bound: bytes.  The function reads x and writes y once (the statistics
// sweep reads x a second time) at a handful of operations per element.
//
// Design: three launches.
//   1. stats: a fixed grid of blocks, each over a contiguous range of rows.
//      A thread owns one channel of every (256 / C)-th row (C <= 256) and
//      keeps f32 sums of t and t*t; the block adds its threads' sums in a
//      fixed order and writes one partial [2, C].
//   2. finalize: one thread per channel adds the partials in a fixed order
//      (32 lanes, then the lanes in order) and writes mean, var and inv.
//   3. normalize: one pass over x, a word of VEC channels a thread.
// No float atomics: repeated runs give bitwise-equal results.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STAT_UNROLL = 8;  // rows a stats thread has in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round an f32 value to T and back: the result of one eager op in type T
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// LeakyReLU(0.01) in type T, as torch computes it (f32 product, rounded)
template <typename T, bool LEAKY> __device__ __forceinline__ float act(T v) {
  const float f = to_f32(v);
  if constexpr (LEAKY) return f > 0.f ? f : rnd<T>(__fmul_rn(f, 0.01f));
  return f;
}

template <typename T, bool LEAKY>
__global__ void __launch_bounds__(THREADS)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, long long M, int C,
                long long rows_per_block) {
  __shared__ float s1s[THREADS], s2s[THREADS];
  const long long m0 = (long long)blockIdx.x * rows_per_block;
  const long long m1 = min(m0 + rows_per_block, M);
  float* out = part + (size_t)blockIdx.x * 2 * C;
  for (int c0 = 0; c0 < C; c0 += THREADS) {  // channel chunks (one unless C > 256)
    const int cn = min(C - c0, THREADS);
    const int R = THREADS / cn;  // row lanes
    const int r = threadIdx.x / cn, c = c0 + threadIdx.x - r * cn;
    float s1 = 0.f, s2 = 0.f;
    if (r < R) {
      long long m = m0 + r;
      for (; m + (STAT_UNROLL - 1) * R < m1; m += STAT_UNROLL * R) {
        T v[STAT_UNROLL];
#pragma unroll
        for (int u = 0; u < STAT_UNROLL; ++u) v[u] = x[(m + (long long)u * R) * C + c];
#pragma unroll
        for (int u = 0; u < STAT_UNROLL; ++u) {
          const float t = act<T, LEAKY>(v[u]);
          s1 += t;
          s2 = fmaf(t, t, s2);
        }
      }
      for (; m < m1; m += R) {
        const float t = act<T, LEAKY>(x[m * C + c]);
        s1 += t;
        s2 = fmaf(t, t, s2);
      }
    }
    s1s[threadIdx.x] = s1;
    s2s[threadIdx.x] = s2;
    __syncthreads();
    if (threadIdx.x < cn) {
      float a = 0.f, b = 0.f;
      for (int k = 0; k < R; ++k) {
        a += s1s[k * cn + threadIdx.x];
        b += s2s[k * cn + threadIdx.x];
      }
      out[c0 + threadIdx.x] = a;
      out[C + c0 + threadIdx.x] = b;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024)
bn_finalize_kernel(const float* __restrict__ part, int nparts, int C, float n, float eps,
                   const float* __restrict__ weight, float* __restrict__ mean,
                   float* __restrict__ var, float* __restrict__ inv) {
  __shared__ float a1[32][33], a2[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  if (c < C)
    for (int p = threadIdx.y; p < nparts; p += 32) {
      s1 += part[(size_t)p * 2 * C + c];
      s2 += part[(size_t)p * 2 * C + C + c];
    }
  a1[threadIdx.y][threadIdx.x] = s1;
  a2[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      t1 += a1[r][threadIdx.x];
      t2 += a2[r][threadIdx.x];
    }
    const float m = t1 / n;
    const float v = __fsub_rn(t2 / n, __fmul_rn(m, m));
    mean[c] = m;
    var[c] = v;
    inv[c] = __fmul_rn(1.f / sqrtf(v + eps), weight[c]);
  }
}

template <typename T, int VEC> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };

template <typename T, int VEC, bool LEAKY>
__global__ void __launch_bounds__(THREADS)
bn_norm_kernel(const T* __restrict__ x, T* __restrict__ y, long long total, int C,
               const float* __restrict__ mean, const float* __restrict__ inv,
               const float* __restrict__ bias) {
  using V = typename Vec<T, VEC>::type;
  extern __shared__ float prm[];  // [3][C]: T(mean), T(inv), T(bias) as f32
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    prm[c] = rnd<T>(mean[c]);
    prm[C + c] = rnd<T>(inv[c]);
    prm[2 * C + c] = rnd<T>(bias[c]);
  }
  __syncthreads();
  const long long words = total / VEC;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < words;
       i += (long long)gridDim.x * blockDim.x) {
    V in = reinterpret_cast<const V*>(x)[i];
    const T* e = reinterpret_cast<const T*>(&in);
    V out;
    T* o = reinterpret_cast<T*>(&out);
    const int c0 = (int)((i * VEC) % C);  // VEC divides C: the word is one channel run
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = c0 + k;
      const float t = act<T, LEAKY>(e[k]);
      const float d = rnd<T>(__fsub_rn(t, prm[c]));
      const float s = rnd<T>(__fmul_rn(d, prm[C + c]));
      o[k] = from_f32<T>(__fadd_rn(s, prm[2 * C + c]));
    }
    reinterpret_cast<V*>(y)[i] = out;
  }
}

int stats_blocks(long long M) {
  // enough blocks for every SM a few times, each over >= 64 rows
  long long nb = (M + 63) / 64;
  return (int)(nb < 4 * 132 ? nb : 4 * 132);
}

template <typename T, bool LEAKY>
int run(const void* x, void* y, const float* weight, const float* bias, float* mean,
        float* var, float* inv, float* part, long long M, int C, float eps,
        cudaStream_t stream) {
  const int nb = stats_blocks(M);
  const long long rows = (M + nb - 1) / nb;
  bn_stats_kernel<T, LEAKY><<<nb, THREADS, 0, stream>>>(static_cast<const T*>(x), part, M, C,
                                                         rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_finalize_kernel<<<(C + 31) / 32, dim3(32, 32), 0, stream>>>(part, nb, C, (float)M, eps,
                                                                  weight, mean, var, inv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = M * C;
  const size_t smem = (size_t)3 * C * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(bn_norm_kernel<T, 1, LEAKY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = C % VEC == 0 && ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
  const long long words = vec ? total / VEC : total;
  long long blocks = (words + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (vec) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(bn_norm_kernel<T, VEC, LEAKY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    bn_norm_kernel<T, VEC, LEAKY><<<(int)blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), total, C, mean, inv, bias);
  } else {
    bn_norm_kernel<T, 1, LEAKY><<<(int)blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), total, C, mean, inv, bias);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Workspace of tcct_bn_act_train: the number of f32 stats partials
// [nparts, 2, C] (the caller allocates nparts * 2 * C floats).
extern "C" int tcct_bn_act_train_parts(long long M) { return stats_blocks(M); }

// x, y: [M, C] in dtype (0 = float32, 1 = bfloat16); weight, bias: [C] f32;
// mean, var, inv: [C] f32 outputs (inv = rsqrt(var + eps) * weight);
// part: the workspace.  leaky: 1 applies LeakyReLU(0.01) first.  Three
// launches.  Returns cudaGetLastError() after the last.
extern "C" int tcct_bn_act_train(const void* x, void* y, const void* weight, const void* bias,
                                 void* mean, void* var, void* inv, void* part, long long M,
                                 int C, float eps, int leaky, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  float *m = static_cast<float*>(mean), *v = static_cast<float*>(var),
        *iv = static_cast<float*>(inv), *p = static_cast<float*>(part);
  if (dtype == 0 && !leaky) return run<float, false>(x, y, w, b, m, v, iv, p, M, C, eps, s);
  if (dtype == 0 && leaky) return run<float, true>(x, y, w, b, m, v, iv, p, M, C, eps, s);
  if (dtype == 1 && !leaky) return run<__nv_bfloat16, false>(x, y, w, b, m, v, iv, p, M, C, eps, s);
  if (dtype == 1 && leaky) return run<__nv_bfloat16, true>(x, y, w, b, m, v, iv, p, M, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
