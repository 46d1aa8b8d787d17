// Depthwise 3x3 convolution, forward and fused backward, stride 1 or 2,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels tcct_tpu/ops/pallas/dwconv.py::_fwd_kernel
// (pallas_call at dwconv.py:200), ::_fwd_kernel_s2 (dwconv.py:380),
// ::_bwd_kernel (dwconv.py:220) and ::_bwd_kernel_s2 (dwconv.py:420), via
// dwconv3x3 and its custom VJP.
//
// Computes, for NHWC x [B, H, W, C] and taps w [3, 3, C]:
//   y[b, i, j, c] = sum_{a, t} x[b, s*i + a - 1, s*j + t - 1, c] * w[a, t, c]
// a correlation (no flip) with SAME zero padding of one pixel, stride s in
// {1, 2}, f32 accumulation, output in the input type (f32 or bf16).  The
// bias is added by the caller.  Output is [B, Ho, Wo, C] with
// Ho = (H - 1) / s + 1, Wo = (W - 1) / s + 1.
//
// Bound: bytes.  Nine multiply-adds per output element against one input
// and one output element moved, so the least time is (input + output
// bytes) over the memory rate.
//
// Design: each thread owns VEC consecutive channels (one 8-byte word: 4
// bf16 or 2 f32) of one output column j and TH consecutive output rows of
// it (4 for stride 1, 2 for stride 2).  It first loads every input word
// those outputs read -- (TH-1)*s+3 rows by three columns (s*j-1, s*j,
// s*j+1), zeros outside the image -- into registers with independent loads, so a thread has all of them in flight
// at once and the card's memory latency is hidden by the loads rather
// than by occupancy.  Then it forms its TH outputs with nine f32
// multiply-adds per channel against the taps, which also sit in
// registers.  Consecutive threads take consecutive channel words of a
// pixel, then the next pixel, so loads and stores of the NHWC tensors are
// coalesced; the column overlap between neighbouring threads is served by
// L1 and the row halo between strips mostly by L2.  No shared memory, no
// block synchronisation.  When C is not a multiple of VEC (or a pointer is
// not 8-byte aligned) the same kernel runs with VEC = 1.
//
// Backward, for the output gradient g [B, Ho, Wo, C]: one fused pass reads
// x and g once and produces
//   dx[b, p, q, c] = sum over (i, a), (j, t) with s*i + a - 1 = p and
//                    s*j + t - 1 = q of g[b, i, j, c] * w[a, t, c]
//   dw[a, t, c]    = sum_{b, i, j} x[b, s*i + a - 1, s*j + t - 1, c] * g[b, i, j, c]
// dx in x's type, dw accumulated in f32 and cast to the taps' type.
// Bound: bytes (x and g read, dx written; 36 f32 operations per g element).
// Threads map as in the forward: a channel word of one output column j and
// a strip of TH output rows, walking down the block's share of rows.  For
// stride 1 the thread loads the x and g windows of its strip (rows i0-1 ..
// i0+TH, columns j-1 .. j+1) and forms dx at its own positions as a
// correlation of g with the flipped taps.  For stride 2 it owns the 2x2
// input pixels (2i, 2i+1) x (2j, 2j+1) of each of its g positions: even
// rows and columns take the centre tap, odd ones the two outer taps of g
// at i and i + 1 (j and j + 1); an odd last input row or column is even
// and needs only the centre tap.  Each thread sums its nine dw taps in
// registers; the block adds those of its threads in a fixed order through
// shared memory and writes one f32 partial [9, C] per block, and a second
// small kernel adds the partials in a fixed order.  No float atomics, so
// two runs give bitwise-equal dw.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// output rows a thread computes: its input strip is (TH-1)*S+3 rows
template <int S> constexpr int TH = S == 1 ? 4 : 2;

template <typename T, int VEC> struct Vec;
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename V>
__device__ __forceinline__ V zero_word() {
  V v;
  if constexpr (sizeof(V) == 8) *reinterpret_cast<uint2*>(&v) = make_uint2(0u, 0u);
  else if constexpr (sizeof(V) == 4) *reinterpret_cast<uint32_t*>(&v) = 0u;
  else *reinterpret_cast<uint16_t*>(&v) = 0;
  return v;
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const typename Vec<T, VEC>::type& v, float* out) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = to_f32(e[k]);
}

template <typename T, int VEC, int S>
__global__ void __launch_bounds__(THREADS)
dwconv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                     int H, int W, int C, int Ho, int Wo, int cgv, int n_cgroups) {
  using V = typename Vec<T, VEC>::type;
  constexpr int IR = (TH<S> - 1) * S + 3;  // input rows of a strip
  const int ncv = C / VEC;
  const int tc = threadIdx.x % cgv;
  const int tp = threadIdx.x / cgv;
  const int P = blockDim.x / cgv;  // output columns per block
  const int b = blockIdx.z / n_cgroups;
  const int cvi = (blockIdx.z - b * n_cgroups) * cgv + tc;
  const int j = blockIdx.x * P + tp;
  if (cvi >= ncv || j >= Wo) return;
  const int c = cvi * VEC;
  const int i0 = blockIdx.y * TH<S>;
  const int r0 = S * i0 - 1, x0 = S * j - 1;  // input origin of the strip

  // every input word of the strip, loads all in flight together
  const T* xb = x + (size_t)b * H * W * C + c;
  V in[IR][3];
#pragma unroll
  for (int r = 0; r < IR; ++r)
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int gy = r0 + r, gx = x0 + t;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        in[r][t] = *reinterpret_cast<const V*>(xb + ((size_t)gy * W + gx) * C);
      else
        in[r][t] = zero_word<V>();
    }
  float k[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t) unpack<T, VEC>(*reinterpret_cast<const V*>(w + t * C + c), k[t]);

  T* yb = y + (size_t)b * Ho * Wo * C + c;
#pragma unroll
  for (int o = 0; o < TH<S>; ++o) {
    const int i = i0 + o;
    if (i >= Ho) break;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        float v[VEC];
        unpack<T, VEC>(in[o * S + a][t], v);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = fmaf(v[q], k[a * 3 + t][q], acc[q]);
      }
    V out;
    T* e = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int q = 0; q < VEC; ++q) e[q] = from_f32<T>(acc[q]);
    *reinterpret_cast<V*>(yb + ((size_t)i * Wo + j) * C) = out;
  }
}

template <typename T, int VEC, int S>
int launch(const void* x, const void* w, void* y, int B, int H, int W, int C,
           cudaStream_t stream) {
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int ncv = C / VEC;
  const int cgv = ncv < THREADS ? ncv : THREADS;  // channel words a block covers
  const int n_cgroups = (ncv + cgv - 1) / cgv;
  const int P = THREADS / cgv;  // output columns a block covers
  dim3 grid((Wo + P - 1) / P, (Ho + TH<S> - 1) / TH<S>, B * n_cgroups);
  dwconv3x3_fwd_kernel<T, VEC, S><<<grid, cgv * P, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      H, W, C, Ho, Wo, cgv, n_cgroups);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int S>
int dispatch(const void* x, const void* w, void* y, int B, int H, int W, int C,
             cudaStream_t stream) {
  const bool aligned = ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % (VEC * sizeof(T)) == 0;
  if (aligned && C % VEC == 0) return launch<T, VEC, S>(x, w, y, B, H, W, C, stream);
  return launch<T, 1, S>(x, w, y, B, H, W, C, stream);
}

// ---------------------------------------------------------------------------
// backward

template <typename T, int VEC>
__device__ __forceinline__ typename Vec<T, VEC>::type load_word(const T* base, int gy, int gx,
                                                                int H, int W, int C) {
  using V = typename Vec<T, VEC>::type;
  if (gy >= 0 && gy < H && gx >= 0 && gx < W)
    return *reinterpret_cast<const V*>(base + ((size_t)gy * W + gx) * C);
  return zero_word<V>();
}

template <typename T, int VEC>
__device__ __forceinline__ void store_word(T* base, int gy, int gx, int W, int C,
                                           const float* v) {
  using V = typename Vec<T, VEC>::type;
  V out;
  T* e = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int q = 0; q < VEC; ++q) e[q] = from_f32<T>(v[q]);
  *reinterpret_cast<V*>(base + ((size_t)gy * W + gx) * C) = out;
}

// Block geometry of the backward, shared by the launch and the workspace
// query so that both agree on the number of dw partials.
struct BwdGeom {
  int Ho, Wo, cgv, n_cgroups, P, rows, gx, gy;
  long long blocks(int B) const { return (long long)gx * gy * B * n_cgroups; }
};

template <int VEC, int S>
BwdGeom bwd_geom(int B, int H, int W, int C) {
  BwdGeom g;
  g.Ho = (H - 1) / S + 1;
  g.Wo = (W - 1) / S + 1;
  const int ncv = C / VEC;
  g.cgv = ncv < THREADS ? ncv : THREADS;
  g.n_cgroups = (ncv + g.cgv - 1) / g.cgv;
  g.P = THREADS / g.cgv;
  g.gx = (g.Wo + g.P - 1) / g.P;
  // rows of output a block walks: as many as keep >= 1024 blocks in the grid
  g.rows = TH<S> * 8;
  while (g.rows > TH<S>) {
    g.gy = (g.Ho + g.rows - 1) / g.rows;
    if (g.blocks(B) >= 1024) break;
    g.rows /= 2;
  }
  g.gy = (g.Ho + g.rows - 1) / g.rows;
  return g;
}

template <typename T, int VEC, int S>
__global__ void __launch_bounds__(THREADS)
dwconv3x3_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                     int H, int W, int C, BwdGeom geo) {
  using V = typename Vec<T, VEC>::type;
  extern __shared__ float red[];  // [blockDim.x][9 * VEC]
  const int ncv = C / VEC;
  const int tc = threadIdx.x % geo.cgv;
  const int tp = threadIdx.x / geo.cgv;
  const int b = blockIdx.z / geo.n_cgroups;
  const int cg = blockIdx.z - b * geo.n_cgroups;
  const int cvi = cg * geo.cgv + tc;
  const int j = blockIdx.x * geo.P + tp;
  const int Ho = geo.Ho, Wo = geo.Wo;
  const bool active = cvi < ncv && j < Wo;
  const int c = cvi * VEC;

  float dwacc[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < VEC; ++q) dwacc[t][q] = 0.f;

  if (active) {
    float k[9][VEC];
#pragma unroll
    for (int t = 0; t < 9; ++t) unpack<T, VEC>(*reinterpret_cast<const V*>(w + t * C + c), k[t]);
    const T* xb = x + (size_t)b * H * W * C + c;
    const T* gb = g + (size_t)b * Ho * Wo * C + c;
    T* dxb = dx + (size_t)b * H * W * C + c;
    const int r_begin = blockIdx.y * geo.rows;
    const int r_end = min(r_begin + geo.rows, Ho);
    for (int i0 = r_begin; i0 < r_end; i0 += TH<S>) {
      if constexpr (S == 1) {
        V xin[TH<1> + 2][3], gin[TH<1> + 2][3];
#pragma unroll
        for (int r = 0; r < TH<1> + 2; ++r)
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            xin[r][t] = load_word<T, VEC>(xb, i0 - 1 + r, j - 1 + t, H, W, C);
            gin[r][t] = load_word<T, VEC>(gb, i0 - 1 + r, j - 1 + t, Ho, Wo, C);
          }
#pragma unroll
        for (int o = 0; o < TH<1>; ++o) {
          const int i = i0 + o;
          if (i >= Ho) break;
          float gc[VEC], acc[VEC];
          unpack<T, VEC>(gin[o + 1][1], gc);
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              float xv[VEC], gv[VEC];
              unpack<T, VEC>(xin[o + a][t], xv);
              unpack<T, VEC>(gin[o + 2 - a][2 - t], gv);
#pragma unroll
              for (int q = 0; q < VEC; ++q) {
                dwacc[a * 3 + t][q] = fmaf(xv[q], gc[q], dwacc[a * 3 + t][q]);
                acc[q] = fmaf(gv[q], k[a * 3 + t][q], acc[q]);
              }
            }
          store_word<T, VEC>(dxb, i, j, W, C, acc);
        }
      } else {
        constexpr int IR = (TH<2> - 1) * 2 + 3;
        V xin[IR][3], gin[TH<2> + 1][2];
#pragma unroll
        for (int r = 0; r < IR; ++r)
#pragma unroll
          for (int t = 0; t < 3; ++t)
            xin[r][t] = load_word<T, VEC>(xb, 2 * i0 - 1 + r, 2 * j - 1 + t, H, W, C);
#pragma unroll
        for (int r = 0; r < TH<2> + 1; ++r)
#pragma unroll
          for (int t = 0; t < 2; ++t) gin[r][t] = load_word<T, VEC>(gb, i0 + r, j + t, Ho, Wo, C);
#pragma unroll
        for (int o = 0; o < TH<2>; ++o) {
          const int i = i0 + o;
          if (i >= Ho) break;
          float g00[VEC], g01[VEC], g10[VEC], g11[VEC];  // g at (i|i+1, j|j+1)
          unpack<T, VEC>(gin[o][0], g00);
          unpack<T, VEC>(gin[o][1], g01);
          unpack<T, VEC>(gin[o + 1][0], g10);
          unpack<T, VEC>(gin[o + 1][1], g11);
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              float xv[VEC];
              unpack<T, VEC>(xin[2 * o + a][t], xv);
#pragma unroll
              for (int q = 0; q < VEC; ++q)
                dwacc[a * 3 + t][q] = fmaf(xv[q], g00[q], dwacc[a * 3 + t][q]);
            }
          float d00[VEC], d01[VEC], d10[VEC], d11[VEC];
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            d00[q] = g00[q] * k[4][q];
            d01[q] = fmaf(g01[q], k[3][q], g00[q] * k[5][q]);
            d10[q] = fmaf(g10[q], k[1][q], g00[q] * k[7][q]);
            d11[q] = fmaf(g11[q], k[0][q],
                          fmaf(g10[q], k[2][q], fmaf(g01[q], k[6][q], g00[q] * k[8][q])));
          }
          const int p = 2 * i, qc = 2 * j;
          store_word<T, VEC>(dxb, p, qc, W, C, d00);
          if (qc + 1 < W) store_word<T, VEC>(dxb, p, qc + 1, W, C, d01);
          if (p + 1 < H) {
            store_word<T, VEC>(dxb, p + 1, qc, W, C, d10);
            if (qc + 1 < W) store_word<T, VEC>(dxb, p + 1, qc + 1, W, C, d11);
          }
        }
      }
    }
  }

  // the block's dw partial: threads of one channel word added in column order
  float* mine = red + threadIdx.x * 9 * VEC;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < VEC; ++q) mine[t * VEC + q] = dwacc[t][q];
  __syncthreads();
  const int per_word = 9 * VEC;
  const int entries = geo.cgv * per_word;
  const size_t blk = ((size_t)(b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int word = e / per_word, k = e - word * per_word;
    const int tap = k / VEC, q = k - tap * VEC;
    const int ch = (cg * geo.cgv + word) * VEC + q;
    if (ch >= C) continue;
    float sum = 0.f;
    for (int p = 0; p < geo.P; ++p) sum += red[(p * geo.cgv) * per_word + e];
    part[(blk * 9 + tap) * C + ch] = sum;
  }
}

// dw[e] = sum over the partials, e in [0, 9C), in a fixed order: 32 lanes
// of partials per entry, then the 32 lane sums in order.
template <typename T>
__global__ void __launch_bounds__(1024)
dw_finalize_kernel(const float* __restrict__ part, T* __restrict__ dw, int nparts, int n) {
  __shared__ float acc[32][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (e < n)
    for (int p = threadIdx.y; p < nparts; p += 32) s += part[(size_t)p * n + e];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < n) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) t += acc[r][threadIdx.x];
    dw[e] = from_f32<T>(t);
  }
}

template <typename T, int VEC, int S>
int launch_bwd(const void* x, const void* w, const void* g, void* dx, void* dw, float* part,
               int B, int H, int W, int C, cudaStream_t stream) {
  const BwdGeom geo = bwd_geom<VEC, S>(B, H, W, C);
  dim3 grid(geo.gx, geo.gy, B * geo.n_cgroups);
  const size_t smem = (size_t)geo.cgv * geo.P * 9 * VEC * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dwconv3x3_bwd_kernel<T, VEC, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dwconv3x3_bwd_kernel<T, VEC, S><<<grid, geo.cgv * geo.P, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<T*>(dx), part, H, W, C, geo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = 9 * C;
  dw_finalize_kernel<T><<<(n + 31) / 32, dim3(32, 32), 0, stream>>>(
      part, static_cast<T*>(dw), (int)geo.blocks(B) / geo.n_cgroups, n);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
bool bwd_vectorised(const void* x, const void* w, const void* g, const void* dx, int C) {
  const uintptr_t p = (uintptr_t)x | (uintptr_t)w | (uintptr_t)g | (uintptr_t)dx;
  return p % (VEC * sizeof(T)) == 0 && C % VEC == 0;
}

template <typename T, int VEC, int S>
int dispatch_bwd(const void* x, const void* w, const void* g, void* dx, void* dw, float* part,
                 int B, int H, int W, int C, cudaStream_t stream) {
  if (bwd_vectorised<T, VEC>(x, w, g, dx, C))
    return launch_bwd<T, VEC, S>(x, w, g, dx, dw, part, B, H, W, C, stream);
  return launch_bwd<T, 1, S>(x, w, g, dx, dw, part, B, H, W, C, stream);
}

template <typename T, int VEC, int S>
long long parts_of(const void* x, const void* w, const void* g, const void* dx, int B, int H,
                   int W, int C) {
  const BwdGeom geo = bwd_vectorised<T, VEC>(x, w, g, dx, C) ? bwd_geom<VEC, S>(B, H, W, C)
                                                             : bwd_geom<1, S>(B, H, W, C);
  return geo.blocks(B) / geo.n_cgroups;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; stride: 1 or 2.  x is NHWC [B,H,W,C],
// w is [3,3,C] in the same type, y is NHWC [B,Ho,Wo,C].
// Returns cudaGetLastError() after the launch.
extern "C" int tcct_dwconv3x3_fwd(const void* x, const void* w, void* y, int B, int H, int W,
                                  int C, int stride, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && stride == 1) return dispatch<float, 2, 1>(x, w, y, B, H, W, C, s);
  if (dtype == 0 && stride == 2) return dispatch<float, 2, 2>(x, w, y, B, H, W, C, s);
  if (dtype == 1 && stride == 1) return dispatch<__nv_bfloat16, 4, 1>(x, w, y, B, H, W, C, s);
  if (dtype == 1 && stride == 2) return dispatch<__nv_bfloat16, 4, 2>(x, w, y, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's workspace: the number of f32 dw partials [nparts, 9, C]
// that tcct_dwconv3x3_bwd needs for these pointers and shapes (nparts is
// returned; the caller allocates nparts * 9 * C floats).
extern "C" long long tcct_dwconv3x3_bwd_parts(const void* x, const void* w, const void* g,
                                              const void* dx, int B, int H, int W, int C,
                                              int stride, int dtype) {
  if (dtype == 0 && stride == 1) return parts_of<float, 2, 1>(x, w, g, dx, B, H, W, C);
  if (dtype == 0 && stride == 2) return parts_of<float, 2, 2>(x, w, g, dx, B, H, W, C);
  if (dtype == 1 && stride == 1) return parts_of<__nv_bfloat16, 4, 1>(x, w, g, dx, B, H, W, C);
  if (dtype == 1 && stride == 2) return parts_of<__nv_bfloat16, 4, 2>(x, w, g, dx, B, H, W, C);
  return -1;
}

// The fused backward.  x [B,H,W,C], w [3,3,C], g [B,Ho,Wo,C], dx [B,H,W,C],
// dw [3,3,C], all in one type; part is the f32 workspace sized by
// tcct_dwconv3x3_bwd_parts.  Two launches (the fused pass, then the fixed-
// order sum of the dw partials).  Returns cudaGetLastError().
extern "C" int tcct_dwconv3x3_bwd(const void* x, const void* w, const void* g, void* dx,
                                  void* dw, void* part, int B, int H, int W, int C, int stride,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0 && stride == 1) return dispatch_bwd<float, 2, 1>(x, w, g, dx, dw, p, B, H, W, C, s);
  if (dtype == 0 && stride == 2) return dispatch_bwd<float, 2, 2>(x, w, g, dx, dw, p, B, H, W, C, s);
  if (dtype == 1 && stride == 1)
    return dispatch_bwd<__nv_bfloat16, 4, 1>(x, w, g, dx, dw, p, B, H, W, C, s);
  if (dtype == 1 && stride == 2)
    return dispatch_bwd<__nv_bfloat16, 4, 2>(x, w, g, dx, dw, p, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
