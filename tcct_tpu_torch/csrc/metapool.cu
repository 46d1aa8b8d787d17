// MetaPool token mixer, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels tcct_tpu/ops/pallas/metapool.py::_kernel and
// ::_bwd_kernel (both through pallas_call at metapool.py:64, via
// metapool_tokens_pallas and its custom VJP).
//
// Forward, for x of shape [B, N, C] (row-major, C fastest):
//   y = AvgPool2d(3, stride 1, pad 1, count_include_pad=False)(x) - x
// with the 3x3 window sliding over the (token, channel) axes -- the
// reference model's quirk, kept on purpose.  Backward, its adjoint for the
// output gradient g of the same shape:
//   dx = window_sum(g / count) - g
// where count is the same valid-element count map (torch's, 1 along an
// axis of length 1).  Arithmetic is f32 inside and the result is cast to
// the input type once (f32 or bf16).
//
// Bound: bytes.  Each element is read once and written once and costs
// about eleven f32 operations, far below the card's operations-per-byte
// balance, so the least time is 2*B*N*C*itemsize over the memory rate.
//
// Design: one block per tile of `tile_n` tokens of one batch element,
// with all C channels.  The tile plus one halo token on each side is one
// contiguous run of memory; the block reads it with 16-byte loads (8 bf16
// or 4 f32 values a thread) into shared memory, widened to f32, with zero
// columns on both sides of the channel axis and zero rows past either end
// of the token axis.  Each thread then owns one channel of ROWS
// consecutive tokens: it slides horizontal 3-sums down its channel (three
// shared reads per token), adds three of them, divides by the valid count,
// subtracts x and stores.  Consecutive threads take consecutive channels,
// so shared reads are free of bank conflicts and global stores coalesce.
// `tile_n` is chosen at launch so that small inputs still spread over the
// SMs; the halo re-reads 2 of every tile_n + 2 rows.  There is no size
// budget: every stage of every geometry runs here.  When C is not a
// multiple of the vector width the loads are scalar.  The backward is the
// same kernel (template flag BWD): it divides each staged value by its
// count instead of dividing the window sum, and subtracts g re-read from
// global memory (an L1/L2 hit: the block has just staged it).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 4;   // zero columns left of the data, keeps rows 16-byte aligned
constexpr int ROWS = 8;  // tokens a thread computes, sliding down its channel

template <typename T, int VEC> struct Vec;  // VEC values of T in one register-sized load
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const typename Vec<T, VEC>::type& v, float* out) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = to_f32(e[j]);
}

// valid elements of a 3-wide, pad-1 window at index i of an axis of length n
__device__ __forceinline__ float axis_count(int i, int n) {
  int lo = i - 1 < 0 ? 0 : i - 1;
  int hi = i + 2 > n ? n : i + 2;
  return (float)(hi - lo);
}

template <typename T, int VEC, bool BWD>
__global__ void __launch_bounds__(THREADS)
metapool_kernel(const T* __restrict__ x, T* __restrict__ y, int N, int C, int tile_n) {
  using V = typename Vec<T, VEC>::type;
  extern __shared__ __align__(16) float tile[];  // [tile_n + 2][ld], data at columns PAD..
  const int ld = C + 2 * PAD;
  const int cv = C / VEC;  // vectors per token
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * tile_n;
  const T* xb = x + (size_t)b * N * C;
  T* yb = y + (size_t)b * N * C;

  // stage tokens n0-1 .. n0+tile_n: a contiguous run of (tile_n+2)*C values
  const int nvec = (tile_n + 2) * cv;
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    const int r = i / cv;
    const int c = (i - r * cv) * VEC;
    const int n = n0 - 1 + r;
    float v[VEC];
    if (n >= 0 && n < N) {
      unpack<T, VEC>(*reinterpret_cast<const V*>(xb + (size_t)n * C + c), v);
      if constexpr (BWD) {  // g / count, the count as the plain version forms it
        const float cn = axis_count(n, N);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = v[j] / (cn * axis_count(c + j, C));
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = 0.f;
    }
    float* dst = tile + r * ld + PAD + c;
    if constexpr (VEC % 4 == 0) {  // 16-byte shared stores: rows and chunks are 16-byte aligned
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[j] = v[j];
    }
  }
  for (int r = threadIdx.x; r < tile_n + 2; r += THREADS) {
    tile[r * ld + PAD - 1] = 0.f;
    tile[r * ld + PAD + C] = 0.f;
  }
  __syncthreads();

  // one thread per (channel, group of ROWS tokens): consecutive threads take
  // consecutive channels, so shared reads are conflict-free and global
  // stores coalesced.  Horizontal 3-sums slide down the group.
  const int rows = min(tile_n, N - n0);
  const int items = ((rows + ROWS - 1) / ROWS) * C;
  for (int i = threadIdx.x; i < items; i += THREADS) {
    const int g = i / C;
    const int c = i - g * C;
    const int r0 = g * ROWS;
    const int r1 = min(r0 + ROWS, rows);
    const float* col = tile + PAD + c;  // channel c of tile row 0 (token n0-1)
    const float cc = axis_count(c, C);
    float h0 = col[r0 * ld - 1] + col[r0 * ld] + col[r0 * ld + 1];
    float h1 = col[(r0 + 1) * ld - 1] + col[(r0 + 1) * ld] + col[(r0 + 1) * ld + 1];
    for (int r = r0; r < r1; ++r) {
      const float* p = col + (r + 2) * ld;
      const float h2 = p[-1] + p[0] + p[1];
      const int n = n0 + r;
      float out;
      if constexpr (BWD) out = (h0 + h1 + h2) - to_f32(xb[(size_t)n * C + c]);
      else out = (h0 + h1 + h2) / (axis_count(n, N) * cc) - col[(r + 1) * ld];
      yb[(size_t)n * C + c] = from_f32<T>(out);
      h0 = h1;
      h1 = h2;
    }
  }
}

template <typename T, int VEC, bool BWD>
int launch(const void* x, void* y, int B, int N, int C, cudaStream_t stream) {
  // enough blocks to cover the SMs a few times over, at most 64 tokens a tile
  int tile_n = 64;
  while (tile_n > 8 && (long long)B * ((N + tile_n - 1) / tile_n) < 4 * 132) tile_n /= 2;
  const size_t smem = (size_t)(tile_n + 2) * (C + 2 * PAD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(metapool_kernel<T, VEC, BWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + tile_n - 1) / tile_n, B);
  metapool_kernel<T, VEC, BWD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), N, C, tile_n);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, bool BWD>
int dispatch(const void* x, void* y, int B, int N, int C, cudaStream_t stream) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (aligned && C % VEC == 0) return launch<T, VEC, BWD>(x, y, B, N, C, stream);
  return launch<T, 1, BWD>(x, y, B, N, C, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int tcct_metapool_fwd(const void* x, void* y, int B, int N, int C, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, 4, false>(x, y, B, N, C, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, 8, false>(x, y, B, N, C, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: g is the gradient of y, dx the gradient of x, both
// [B, N, C] in the same type.  Returns cudaGetLastError() after the launch.
extern "C" int tcct_metapool_bwd(const void* g, void* dx, int B, int N, int C, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, 4, true>(g, dx, B, N, C, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, 8, true>(g, dx, B, N, C, s);
  return (int)cudaErrorInvalidValue;
}
