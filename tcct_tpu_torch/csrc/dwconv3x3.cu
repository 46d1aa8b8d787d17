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
// {1, 2}, f32 accumulation (a outer, t inner, one fmaf each), output in the
// input type (f32 or bf16).  Output is [B, Ho, Wo, C] with
// Ho = (H - 1) / s + 1, Wo = (W - 1) / s + 1.  Optionally, in the same
// launch, y + bias[c] and then + x[b, i, j, c] (stride 1), each add in f32
// and rounded to the output type, as a bias pass and a residual pass over
// the stored output would round.
//
// Bound: bytes.  Nine multiply-adds per output element against one input
// and one output element moved, so the least time is (input + output
// bytes) over the memory rate.  What the card adds to that: the forward
// widens bf16 elements to f32 with a shift or a mask (widen()), because the
// card's own cvt.f32.bf16, which __bfloat162float compiles to on sm_90,
// runs at a fraction of that rate: with it the direct kernel takes 57 us
// where it now takes 40 (bf16 [8,128,288,64], stride 1, H100).
//
// Forward, two kernels; the launch picks one per call (dispatch()):
//
// Direct kernel (stride 2 at every size; stride 1 under 8 MiB of input,
// where a launch is mostly latency).  A thread owns one 8-byte channel
// word (4 bf16 or 2 f32) of one output column and TH consecutive output
// rows (4 at stride 1, 2 at stride 2).  It loads every input word those
// outputs read -- (TH-1)*s+3 rows by three columns, zeros outside the
// image -- with independent loads, all in flight together, then forms its
// outputs against the taps in registers.  Consecutive threads take
// consecutive channel words of a pixel, then the next pixel, so loads and
// stores are coalesced; the overlap between neighbours is served by L1 and
// L2.  At stride 2 an input word has one reader in a row and at most two
// across rows, so nothing is gained by staging it.
//
// Ring kernel (stride 1, 8 MiB and more).  At stride 1 every input word is
// read by nine outputs.  A block owns a tile of P output columns by cgv
// channel words, one thread each with a 16-byte word (8 bf16 or 4 f32; 8
// bytes or one element where C or a pointer's alignment needs it), and
// walks down a strip of output rows.  Input rows come through a ring of
// NST slots in shared memory: cp.async copies row r + NST - 1 (P + 2
// columns, zero-filled outside the image) while row r is read, one
// __syncthreads per row, so each input word crosses L2 once per strip
// (plus the strip's two halo rows and the tile's two halo columns) and the
// copies in flight cost no registers.  A thread reads the three words of
// the staged row that its column meets, widens them once, and adds them
// into three running sums: kernel row 2 ends output row r - 1 (rounded and
// stored), row 1 continues output row r, row 0 starts output row r + 1 --
// the same order of the nine fmaf as the direct kernel, so both give the
// same bits.  The taps stay in registers for the whole strip.  The strip
// height and the block size (128 or 256 threads) are chosen per call
// (choose_geom()) so that the launch fills the card in whole rounds.
//
// Backward, for the output gradient g [B, Ho, Wo, C]: one fused pass reads
// x and g once and produces
//   dx[b, p, q, c] = sum over (i, a), (j, t) with s*i + a - 1 = p and
//                    s*j + t - 1 = q of g[b, i, j, c] * w[a, t, c]
//   dw[a, t, c]    = sum_{b, i, j} x[b, s*i + a - 1, s*j + t - 1, c] * g[b, i, j, c]
// dx in x's type, dw accumulated in f32 and cast to the taps' type.
// Bound: bytes (x and g read, dx written; 36 f32 operations per g element).
// Threads map as in the forward's direct kernel: a channel word of one
// output column j and a strip of TH output rows, walking down the block's
// share of rows.  For stride 1 the thread loads the x and g windows of its
// strip (rows i0-1 .. i0+TH, columns j-1 .. j+1) and forms dx at its own
// positions as a
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
#include <cmath>

namespace {

constexpr int THREADS = 256;
// output rows a thread of the direct forward and of the backward computes:
// its input strip is (TH-1)*S+3 rows
template <int S> constexpr int TH = S == 1 ? 4 : 2;
// the forward's ring kernel: tallest strip; stride-1 inputs of fewer bytes
// than FWD_DIRECT_BYTES take the direct kernel
constexpr int FWD_MAX_ROWS = 32;
constexpr long long FWD_DIRECT_BYTES = 8 << 20;

template <typename T, int VEC> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Vec<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Vec<__nv_bfloat16, 2> { using type = uint32_t; };
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
  if constexpr (sizeof(V) == 16) *reinterpret_cast<uint4*>(&v) = make_uint4(0u, 0u, 0u, 0u);
  else if constexpr (sizeof(V) == 8) *reinterpret_cast<uint2*>(&v) = make_uint2(0u, 0u);
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

// ---------------------------------------------------------------------------
// forward

// A word's elements as f32.  bf16 pairs widen by a shift and a mask, one
// integer operation each.
template <typename T, int VEC>
__device__ __forceinline__ void widen(const typename Vec<T, VEC>::type& v, float* out) {
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) {
      out[2 * q] = __uint_as_float(u[q] << 16);
      out[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
    }
  } else {
    unpack<T, VEC>(v, out);
  }
}

// Round the f32 sum to the output type, then (EPI) add the bias and the
// residual input word, each as an f32 add rounded to the output type -- the
// roundings of three separate passes -- and store the word.
template <typename T, int VEC, bool EPI>
__device__ __forceinline__ void finish_word(T* dst, const float (&acc)[VEC],
                                            const float (&bz)[VEC], bool has_bias,
                                            const typename Vec<T, VEC>::type& res,
                                            bool residual) {
  using V = typename Vec<T, VEC>::type;
  V out;
  T* e = reinterpret_cast<T*>(&out);
  float rv[VEC];
  if constexpr (EPI) widen<T, VEC>(res, rv);
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
    // bf16 in pairs: the two-element conversion is the fast one on this card
    __nv_bfloat162* e2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int q = 0; q < VEC; q += 2) {
      __nv_bfloat162 o = __floats2bfloat162_rn(acc[q], acc[q + 1]);
      if constexpr (EPI) {
        if (has_bias) {
          float f[2];
          widen<T, 2>(*reinterpret_cast<const uint32_t*>(&o), f);
          o = __floats2bfloat162_rn(f[0] + bz[q], f[1] + bz[q + 1]);
        }
        if (residual) {
          float f[2];
          widen<T, 2>(*reinterpret_cast<const uint32_t*>(&o), f);
          o = __floats2bfloat162_rn(f[0] + rv[q], f[1] + rv[q + 1]);
        }
      }
      e2[q / 2] = o;
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      T o = from_f32<T>(acc[q]);
      if constexpr (EPI) {
        if (has_bias) o = from_f32<T>(to_f32(o) + bz[q]);
        if (residual) o = from_f32<T>(to_f32(o) + rv[q]);
      }
      e[q] = o;
    }
  }
  *reinterpret_cast<V*>(dst) = out;
}

// The taps [3, 3, C] and (EPI) the bias [C] of one channel word, as f32.
template <typename T, int VEC, bool EPI>
__device__ __forceinline__ void load_taps(const T* w, const T* bias, int C, int c,
                                          float (&k)[3][3][VEC], float (&bz)[VEC]) {
  using V = typename Vec<T, VEC>::type;
#pragma unroll
  for (int t = 0; t < 9; ++t)
    widen<T, VEC>(*reinterpret_cast<const V*>(w + t * C + c), k[t / 3][t % 3]);
#pragma unroll
  for (int q = 0; q < VEC; ++q) bz[q] = 0.f;
  if constexpr (EPI)
    if (bias != nullptr) widen<T, VEC>(*reinterpret_cast<const V*>(bias + c), bz);
}

// The direct kernel (stride 2, and small inputs at stride 1): one thread per
// channel word, output column and TH output rows loads every input word of
// them at once, zeros outside the image, and forms its outputs.
template <typename T, int VEC, int S, bool EPI>
__global__ void __launch_bounds__(THREADS)
dwconv3x3_fwd_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
                           int Ho, int Wo, int cgv, int n_cgroups, int residual) {
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
    for (int t = 0; t < 3; ++t) in[r][t] = load_word<T, VEC>(xb, r0 + r, x0 + t, H, W, C);
  float k[3][3][VEC], bz[VEC];
  load_taps<T, VEC, EPI>(w, bias, C, c, k, bz);

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
        widen<T, VEC>(in[o * S + a][t], v);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = fmaf(v[q], k[a][t][q], acc[q]);
      }
    finish_word<T, VEC, EPI>(yb + ((size_t)i * Wo + j) * C, acc, bz, bias != nullptr,
                             in[o * S + 1][1], residual);
  }
}

// Block geometry of the ring kernel (stride 1): a tile of P output columns
// by cgv channel words (one thread each) walks down `rows` output rows.
struct FwdGeom {
  int cgv, n_cgroups, P, rows, gx, gy, slab;
  long long blocks(int B) const { return (long long)gx * gy * B * n_cgroups; }
};

template <int VEC>
FwdGeom fwd_geom(int H, int W, int C, int rows, int threads) {
  FwdGeom g;
  const int ncv = C / VEC;
  g.cgv = ncv < threads ? ncv : threads;  // channel words a block covers
  g.n_cgroups = (ncv + g.cgv - 1) / g.cgv;
  g.P = threads / g.cgv;  // output columns a block covers
  if (g.P > W) g.P = W;
  g.gx = (W + g.P - 1) / g.P;
  g.slab = (g.P + 2) * g.cgv;  // words of one staged input row
  g.rows = rows < H ? rows : H;
  g.gy = (H + g.rows - 1) / g.rows;
  return g;
}

// One word from global into shared memory, asynchronously where the card
// has a copy of that size (4, 8, 16 bytes); `ok` false writes zeros.
template <typename V>
__device__ __forceinline__ void stage_word(V* dst, const V* src, bool ok) {
  if constexpr (sizeof(V) >= 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int n = ok ? (int)sizeof(V) : 0;  // bytes read; the rest is zero-filled
    if constexpr (sizeof(V) == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                   "n"((int)sizeof(V)), "r"(n)
                   : "memory");
  } else {
    *dst = ok ? *src : zero_word<V>();
  }
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Input rows staged in shared memory: NST - 1 are in flight while one is read.
constexpr int NST = 4;

template <typename T, int VEC, bool EPI>
__global__ void __launch_bounds__(THREADS, 2)
dwconv3x3_fwd_ring_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
                          FwdGeom geo, int residual) {
  using V = typename Vec<T, VEC>::type;
  extern __shared__ uint4 ring_words[];  // NST slots of geo.slab words
  V* ring = reinterpret_cast<V*>(ring_words);
  const int ncv = C / VEC;
  const int cgv = geo.cgv;
  const int tc = threadIdx.x % cgv;
  const int tp = threadIdx.x / cgv;
  const int b = blockIdx.z / geo.n_cgroups;
  const int cg = blockIdx.z - b * geo.n_cgroups;
  const int cvi = cg * cgv + tc;
  const int j0 = blockIdx.x * geo.P;
  const int j = j0 + tp;
  const bool active = cvi < ncv && j < W;
  const int c = cvi * VEC;
  const int i0 = blockIdx.y * geo.rows;
  const int i_end = min(i0 + geo.rows, H);
  const int r0 = i0 - 1, r_last = i_end;  // first and last input row the strip reads

  // the words of a staged row this thread copies: at most three
  const T* xb = x + (size_t)b * H * W * C;
  int src[3];  // element offset in an input row; -1: zero padding; -2: none
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    const int idx = threadIdx.x + n * blockDim.x;
    src[n] = -2;
    if (idx < geo.slab) {
      const int col = idx / cgv, wd = idx - col * cgv;
      const int gx = j0 - 1 + col, cw = cg * cgv + wd;
      src[n] = (gx >= 0 && gx < W && cw < ncv) ? gx * C + cw * VEC : -1;
    }
  }
  auto stage_row = [&](int r, int slot) {
    const bool row_ok = r >= 0 && r < H;
    const T* xrow = xb + (size_t)(row_ok ? r : 0) * W * C;
    V* dst = ring + slot * geo.slab + threadIdx.x;
#pragma unroll
    for (int n = 0; n < 3; ++n)
      if (src[n] != -2) {
        const bool ok = row_ok && src[n] >= 0;
        stage_word<V>(dst + n * blockDim.x, reinterpret_cast<const V*>(ok ? xrow + src[n] : x),
                      ok);
      }
  };

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (r0 + s <= r_last) stage_row(r0 + s, s);
    stage_commit();
  }

  float k[3][3][VEC], bz[VEC];
  if (active) load_taps<T, VEC, EPI>(w, bias, C, c, k, bz);
  V centre = zero_word<V>();  // the centre word of the row before: the residual
  T* yb = y + (size_t)b * H * W * C + c;

  int slot = 0, slot_in = NST - 1;  // the slot read now, the slot staged now
  // wait for input row r; the slot read last goes to the row NST - 1 ahead
  auto next_row = [&](int r) {
    stage_wait<NST - 2>();
    __syncthreads();
    if (r + NST - 1 <= r_last) stage_row(r + NST - 1, slot_in);
    stage_commit();
    slot_in = slot_in + 1 == NST ? 0 : slot_in + 1;
  };
  // the three words of the staged row that output column j reads, as f32
  auto read_row = [&](float (&v)[3][VEC], V& mid) {
    const V* p = ring + slot * geo.slab + tp * cgv + tc;
    const V left = p[0], right = p[2 * cgv];  // whole words: one shared-memory load each
    mid = p[cgv];
    widen<T, VEC>(left, v[0]);
    widen<T, VEC>(mid, v[1]);
    widen<T, VEC>(right, v[2]);
    slot = slot + 1 == NST ? 0 : slot + 1;
  };
  // acc += the three taps of one kernel row against the row; `first` starts at 0
  auto taps_row = [&](float (&acc)[VEC], const float (&v)[3][VEC], const float (&ka)[3][VEC],
                      bool first) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        acc[q] = fmaf(v[t][q], ka[t][q], (first && t == 0) ? 0.f : acc[q]);
  };
  auto finish = [&](const float (&acc)[VEC], int i) {
    finish_word<T, VEC, EPI>(yb + ((size_t)i * W + j) * C, acc, bz, bias != nullptr, centre,
                             residual);
  };

  // input row r ends output row r - 1 (kernel row 2), continues row r
  // (kernel row 1) and starts row r + 1 (kernel row 0)
  auto step = [&](int r, float (&done)[VEC], float (&cont)[VEC], float (&start)[VEC]) {
    next_row(r);
    if (!active) return;
    float v[3][VEC];
    V mid;
    read_row(v, mid);
    if (r - 1 >= i0) {
      taps_row(done, v, k[2], false);
      finish(done, r - 1);
    }
    if (r >= i0 && r < i_end) taps_row(cont, v, k[1], false);
    if (r + 1 < i_end) taps_row(start, v, k[0], true);
    centre = mid;
  };
  float a0[VEC], a1[VEC], a2[VEC];  // the sums of three output rows, roles rotating
#pragma unroll
  for (int q = 0; q < VEC; ++q) a0[q] = a1[q] = a2[q] = 0.f;
  for (int r = r0;;) {
    step(r, a0, a1, a2);
    if (++r > r_last) break;
    step(r, a1, a2, a0);
    if (++r > r_last) break;
    step(r, a2, a0, a1);
    if (++r > r_last) break;
  }
}

// The strip height and block size of the ring kernel for one input.  A block
// takes one step per staged input row and the card holds `slots` blocks at
// once, so a launch costs its steps times its rounds; a round that is not
// full runs faster than a full one, which the mean of the rounds' exact and
// whole number stands for, and a quarter round stands for the ramp at both
// ends.  Fitted to sweeps of the strip height on an H100 (PERF.md).
template <typename T, int VEC, bool EPI>
FwdGeom choose_geom(int B, int H, int W, int C, int rows) {
  using V = typename Vec<T, VEC>::type;
  static int n_sm = 0, per_sm[2] = {0, 0};  // blocks an SM holds at 128 and 256 threads
  if (n_sm == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  FwdGeom best = fwd_geom<VEC>(H, W, C, rows > 0 ? rows : 8, THREADS / 2);
  double best_cost = -1.0;
  for (int ti = 0; ti < 2; ++ti) {
    const int threads = (THREADS / 2) << ti;
    if (per_sm[ti] == 0) {
      const FwdGeom g = fwd_geom<VEC>(H, W, C, 8, threads);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[ti],
                                                    dwconv3x3_fwd_ring_kernel<T, VEC, EPI>,
                                                    g.cgv * g.P, NST * g.slab * sizeof(V));
      if (per_sm[ti] < 1) per_sm[ti] = 1;
    }
    const double slots = (double)n_sm * per_sm[ti];
    // equal strips: gy of them, or the one height the caller names
    for (int gy = (H + FWD_MAX_ROWS - 1) / FWD_MAX_ROWS; gy <= H; ++gy) {
      const int r = rows > 0 ? rows : (H + gy - 1) / gy;
      const FwdGeom g = fwd_geom<VEC>(H, W, C, r, threads);
      const double fill = (double)g.blocks(B) / slots;
      const double cost = (g.rows + 2) * (0.5 * (fill + ceil(fill)) + 0.25);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = g;
      }
      if (rows > 0 || r <= 2) break;
    }
  }
  return best;
}

template <typename T, int VEC, bool EPI>
int launch_ring(const T* x, const T* w, const T* bias, T* y, int B, int H, int W, int C,
                int residual, int rows, cudaStream_t stream) {
  using V = typename Vec<T, VEC>::type;
  const FwdGeom geo = choose_geom<T, VEC, EPI>(B, H, W, C, rows);
  if ((long long)B * geo.n_cgroups > 65535 || geo.gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(geo.gx, geo.gy, B * geo.n_cgroups);
  const size_t smem = (size_t)NST * geo.slab * sizeof(V);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dwconv3x3_fwd_ring_kernel<T, VEC, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dwconv3x3_fwd_ring_kernel<T, VEC, EPI><<<grid, geo.cgv * geo.P, smem, stream>>>(
      x, w, bias, y, H, W, C, geo, residual);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int S, bool EPI>
int launch_direct(const T* x, const T* w, const T* bias, T* y, int B, int H, int W, int C,
                  int residual, cudaStream_t stream) {
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int ncv = C / VEC;
  const int cgv = ncv < THREADS ? ncv : THREADS;  // channel words a block covers
  const int n_cgroups = (ncv + cgv - 1) / cgv;
  const int P = THREADS / cgv;  // output columns a block covers
  dim3 grid((Wo + P - 1) / P, (Ho + TH<S> - 1) / TH<S>, B * n_cgroups);
  dwconv3x3_fwd_direct_kernel<T, VEC, S, EPI><<<grid, cgv * P, 0, stream>>>(
      x, w, bias, y, H, W, C, Ho, Wo, cgv, n_cgroups, residual);
  return (int)cudaGetLastError();
}

// Stride 2, and stride-1 inputs under FWD_DIRECT_BYTES, take the direct
// kernel with 8-byte words (else one element); larger stride-1 inputs, and
// any stride-1 call that names its strip height, the ring kernel with the
// widest word (16 or 8 bytes, else one element) that divides C and that
// every pointer is aligned to.  rows < 0 names the direct kernel.
template <typename T, int S, bool EPI>
int dispatch(const void* xv, const void* wv, const void* bv, void* yv, int B, int H, int W, int C,
             int residual, int rows, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* bias = static_cast<const T*>(bv);
  T* y = static_cast<T*>(yv);
  constexpr int WIDE = 16 / sizeof(T), MID = 8 / sizeof(T);
  const uintptr_t p = (uintptr_t)xv | (uintptr_t)wv | (uintptr_t)yv | (uintptr_t)bv;
  const bool mid = p % 8 == 0 && C % MID == 0;
  if constexpr (S == 1) {
    if (rows > 0 ||
        (rows == 0 && (long long)B * H * W * C * (long long)sizeof(T) >= FWD_DIRECT_BYTES)) {
      if (p % 16 == 0 && C % WIDE == 0)
        return launch_ring<T, WIDE, EPI>(x, w, bias, y, B, H, W, C, residual, rows, stream);
      if (mid) return launch_ring<T, MID, EPI>(x, w, bias, y, B, H, W, C, residual, rows, stream);
      return launch_ring<T, 1, EPI>(x, w, bias, y, B, H, W, C, residual, rows, stream);
    }
  }
  return mid ? launch_direct<T, MID, S, EPI>(x, w, bias, y, B, H, W, C, residual, stream)
             : launch_direct<T, 1, S, EPI>(x, w, bias, y, B, H, W, C, residual, stream);
}

template <typename T>
int dispatch_fwd(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
                 int C, int stride, int residual, int rows, cudaStream_t s) {
  const bool epi = bias != nullptr || residual;
  if (stride == 1)
    return epi ? dispatch<T, 1, true>(x, w, bias, y, B, H, W, C, residual, rows, s)
               : dispatch<T, 1, false>(x, w, bias, y, B, H, W, C, residual, rows, s);
  if (stride == 2 && !residual && rows <= 0)
    return epi ? dispatch<T, 2, true>(x, w, bias, y, B, H, W, C, residual, rows, s)
               : dispatch<T, 2, false>(x, w, bias, y, B, H, W, C, residual, rows, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// backward

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
// w is [3,3,C] in the same type, y is NHWC [B,Ho,Wo,C].  bias is [C] in
// the same type or null; residual != 0 (stride 1 only) adds x to the
// output; both are added after the sum is rounded to the output type, each
// with a rounding of its own.  rows > 0 (stride 1 only) names the ring
// kernel's strip height, rows < 0 the direct kernel; 0 lets the launch
// choose kernel and strip.
// Returns cudaGetLastError() after the launch.
extern "C" int tcct_dwconv3x3_fwd(const void* x, const void* w, const void* bias, void* y, int B,
                                  int H, int W, int C, int stride, int dtype, int residual,
                                  int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fwd<float>(x, w, bias, y, B, H, W, C, stride, residual, rows, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(x, w, bias, y, B, H, W, C, stride, residual, rows, s);
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
