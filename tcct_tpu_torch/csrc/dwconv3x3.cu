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
// Backward, for the output gradient g [B, Ho, Wo, C]: one cooperative
// launch reads x and g once and produces
//   dx[b, p, q, c] = sum over (i, a), (j, t) with s*i + a - 1 = p and
//                    s*j + t - 1 = q of g[b, i, j, c] * w[a, t, c]
//   dw[a, t, c]    = sum_{b, i, j} x[b, s*i + a - 1, s*j + t - 1, c] * g[b, i, j, c]
// and optionally db[c] = sum_{b, i, j} g[b, i, j, c] (the bias), dx + g
// (the residual, stride 1: dx rounded to x's type, g added in f32 and the
// sum rounded, bitwise the plain add), or no dx at all.  dx in x's type;
// dw and db summed in f32 in a fixed order and cast once.
// Bound: bytes (x and g read, dx written; 36 f32 operations per g element).
// Design, against what held the first version (two launches, a fresh
// workspace each call, 8-byte words widened with cvt.f32.bf16 up to three
// times, every thread loading its whole window from L2):
//  - Rows are flattened: a row of W*C elements is contiguous, and a block
//    owns a tile of N of them (N a multiple of lcm(4, C): at most 1,024 in
//    bf16, 512 in f32), four consecutive elements a thread, over a strip of
//    rows.  For C a multiple of 4 a thread's four elements are four
//    channels of one pixel and its neighbours are whole words C elements
//    away (one 8- or 16-byte shared-memory read each); for the narrow
//    channels (C = 1, 2, 3, 5, 6, 7) a thread holds four consecutive pixels
//    or parts of them, reads its neighbours element by element, and keeps
//    its dw sums per element.  Every tile gives a thread the same channels,
//    so the sums are added per channel only at the end.  Rows of at most
//    half a tile (the loss heads' C = 1 at W = 256) are packed side by
//    side, one image each, so that a block still has its threads busy.
//  - The rows stream through a ring of BWD_NST groups of BWD_RS slots in
//    shared memory (a barrier a group), filled with 16-byte cp.async where
//    x, g and the rows are 16-byte aligned (else one element a copy), so
//    each word crosses L2 once a strip plus the strip's halo rows and the
//    tile's C-element halo.  Each word read from the ring is widened once
//    (widen(): a shift and a mask) and used for every output it meets.
//    Stride 1 walks a strip upwards, one step a g row: g row r ends dx row
//    r + 1 (kernel row 2), continues row r and starts row r - 1 (kernel row
//    0), so each dx element takes its nine fmaf in the first version's
//    order (a = 0, 1, 2; t = 0, 1, 2) and dx is bitwise the first version's;
//    x row r + 1, staged in the same slot, meets the g centres of rows
//    r + 2, r + 1, r, kept in registers.  Stride 2 walks down, one step a g
//    row and two x rows, with the first version's 2x2 formulas: row i forms
//    input row 2i and the inner terms of 2i + 1, row i + 1 ends it.
//  - A thread keeps 4 elements: nine taps, nine dw sums and a bias sum (76
//    f32) plus three dx sums and three g centres; 8 elements would pass 255
//    registers.  ptxas gives the f32 kernels about 140-150 registers, so
//    their blocks are 128 threads, three an SM; the bf16 four-wide kernels
//    fit 128 registers without spilling, two 256-thread blocks an SM.  What
//    bounds the large shapes (40-60 % of their byte bound) is the rate at
//    which an SM starts instructions: a step is 72 fmaf against about as
//    many integer and shared-memory instructions.
//  - Work is a list of (images, strip, tile) items; the grid is at most as
//    many blocks as the card holds at once (256 threads an SM under 4 MiB
//    of x, where a call is latency-bound), and a block walks its items as
//    one sequence of ring steps.  The strip height is the one with the
//    fewest steps on the busiest block (bwd_geometry()).
//  - One launch: each block adds its slots' sums per channel in a fixed
//    order into one [10, C] partial; after a grid barrier
//    (cg::this_grid().sync()) L lanes finish each entry: each adds the
//    partials of its stride, then a fixed shuffle tree.  No float atomics,
//    so two runs give bitwise-equal dw and db.  The partials live in a
//    workspace the caller keeps, so the launch allocates nothing and
//    captures into a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
// output rows a thread of the direct forward computes:
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

constexpr int BWD_THREADS = 256;           // most threads of a block
constexpr int BWD_NST = 4;                 // ring groups: three in flight while one is read
constexpr int BWD_TILE = BWD_THREADS * 4;  // most elements of a tile: four a thread
// steps of a ring group, read between two barriers: stride 1 three (one
// turn of its rotating roles), stride 2 two
template <int S> constexpr int BWD_RS = S == 1 ? 3 : 2;
constexpr long long BWD_SMALL_BYTES = 4 << 20;
// blocks an SM is built to hold: two (at most 128 registers a thread) where
// ptxas fits the bf16 four-wide kernels in that without spilling, else one
template <typename T, bool VL> constexpr int BWD_MIN_BLOCKS = sizeof(T) == 2 && VL ? 2 : 1;

// One call's geometry, shared by the launch and the workspace query.
struct BwdParams {
  const void* x;
  const void* w;
  const void* g;
  void* dx;       // null: no dx
  void* dw;
  void* db;       // null: no bias gradient
  float* part;    // [nb, 10, C] block partials
  int B, H, W, C, Ho, Wo;
  int N;          // elements of a tile: NB pieces of Np
  int NB;         // images a tile packs side by side (rows shorter than half a tile), else 1
  int Np;         // elements of one image's piece: a multiple of C and of 4
  int nt;         // tiles of a g row
  int R;          // g rows of a strip
  int ns;         // strips
  int items;      // ceil(B / NB) * ns * nt
  int gseg, xseg; // elements of one piece's staged g / x row segment
  int xoff;       // where a slot's x rows start: after its NB g segments
  int slot;       // elements of a ring slot: NB g segments, then NB x segments of one
                  // (stride 1) or two (stride 2) x rows
  int residual;   // stride 1: dx + g, rounded as the plain add rounds
  int threads;    // of a block: N / 4 rounded up to a warp
};

__device__ __forceinline__ float widen1(float v) { return v; }
__device__ __forceinline__ float widen1(__nv_bfloat16 v) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(v) << 16);
}
// an f32 value rounded to T and back: the result of one op in type T
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return widen1(__float2bfloat16_rn(v));
}

// Four consecutive elements of a staged segment, as f32: one 8- or 16-byte
// shared-memory load where the offset is a multiple of four (VL), else four.
template <typename T, bool VL>
__device__ __forceinline__ void read4(const T* s, int off, float (&out)[4]) {
  if constexpr (VL) {
    const typename Vec<T, 4>::type v = *reinterpret_cast<const typename Vec<T, 4>::type*>(s + off);
    widen<T, 4>(v, out);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = widen1(s[off + q]);
  }
}

// Four elements at per-slot offsets (stride 2, narrow channels).
template <typename T>
__device__ __forceinline__ void read4_at(const T* s, const int (&off)[4], int d,
                                         float (&out)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = widen1(s[off[q] + d]);
}

// Store four consecutive elements rounded to T (elements at or past `end`
// are not stored; VL: all four or none).
template <typename T, bool VL>
__device__ __forceinline__ void store4(T* dst, int at, int end, const float (&v)[4]) {
  if constexpr (VL) {
    if (at >= end) return;
    typename Vec<T, 4>::type o;
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&o);
      e[0] = __floats2bfloat162_rn(v[0], v[1]);
      e[1] = __floats2bfloat162_rn(v[2], v[3]);
    } else {
      o = make_float4(v[0], v[1], v[2], v[3]);
    }
    *reinterpret_cast<typename Vec<T, 4>::type*>(dst + at) = o;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (at + q < end) dst[at + q] = from_f32<T>(v[q]);
  }
}

// One element a slot at per-slot positions (stride 2, narrow channels).
template <typename T>
__device__ __forceinline__ void store4_at(T* dst, const int (&at)[4], int d, int end,
                                          const float (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (at[q] + d < end) dst[at[q] + d] = from_f32<T>(v[q]);
}

// acc += g * (three taps of one kernel row), t = 0, 1, 2 in order; `first` starts at 0
__device__ __forceinline__ void taps3(float (&acc)[4], const float (&gv)[3][4],
                                      const float (&k)[9][4], int a, bool first) {
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[q] = fmaf(gv[t][q], k[a * 3 + t][q], (first && t == 0) ? 0.f : acc[q]);
}

// dw[a][t] += x[t] * g, t = 0, 1, 2
__device__ __forceinline__ void dw3(float (&dw)[9][4], const float (&xv)[3][4],
                                    const float (&gc)[4], int a) {
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) dw[a * 3 + t][q] = fmaf(xv[t][q], gc[q], dw[a * 3 + t][q]);
}

__host__ __device__ __forceinline__ int floor_to(int v, int m) {
  const int r = v % m;
  return v - (r < 0 ? r + m : r);
}

// A work item: a tile of N elements of the flattened g row, over a strip
// of g rows [r0, r1) of image b.  A block walks its items (blockIdx.x,
// + gridDim.x, ...) as one sequence of steps, so the ring runs on across
// items.  A cursor is one step of that sequence, with what the steps of
// its item share worked out once.
struct Cursor {
  int it, r, r0, r1;
  int b;   // the tile's first image
  int f0;  // the tile's first element of a row
  int gs;  // where the staged g segment starts (flat element index), aligned to a chunk
  int xs;  // and the x segment
};

template <int S, int E>
__device__ __forceinline__ bool cursor_at(Cursor& c, int it, const BwdParams& p) {
  c.it = it;
  if (it >= p.items) return false;
  const int tile = it % p.nt, rest = it / p.nt;
  const int strip = rest % p.ns;
  c.b = rest / p.ns * p.NB;
  c.r0 = strip * p.R;
  c.r1 = min(c.r0 + p.R, p.Ho);
  c.f0 = tile * p.Np;
  // stride 1: g and x at columns j - 1 .. j + 1 of the tile; stride 2: g at
  // j, j + 1, x at 2j - 1 .. 2j + 1
  c.gs = floor_to(S == 1 ? c.f0 - p.C : c.f0, E);
  c.xs = S == 1 ? c.gs : floor_to(2 * c.f0 - p.C, E);
  // stride 1 walks up, from g row r1 (its dx row r1 - 1) to r0 - 2 (x row
  // r0 - 1 only); stride 2 walks down, g rows r0 .. r1 (r1: dx only)
  c.r = S == 1 ? c.r1 : c.r0;
  return true;
}
template <int S, int E>
__device__ __forceinline__ bool cursor_next(Cursor& c, const BwdParams& p) {
  if constexpr (S == 1) {
    if (--c.r >= c.r0 - 2) return true;
  } else {
    if (++c.r <= c.r1) return true;
  }
  return cursor_at<S, E>(c, c.it + gridDim.x, p);
}

template <typename T, int S, bool VL, bool CH16>
__global__ void __launch_bounds__(BWD_THREADS, (BWD_MIN_BLOCKS<T, VL>))
    dwconv3x3_bwd_kernel(const BwdParams p) {
  using VC = typename std::conditional<CH16, uint4, T>::type;  // a staged chunk
  constexpr int E = (int)(sizeof(VC) / sizeof(T));             // elements of a chunk
  extern __shared__ uint4 bwd_smem[];
  T* ring = reinterpret_cast<T*>(bwd_smem);
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  const T* w = static_cast<const T*>(p.w);
  T* dx = static_cast<T*>(p.dx);
  const bool need_dx = dx != nullptr;
  const int C = p.C, H = p.H, Ho = p.Ho;
  const int Lx = p.W * C, Lg = p.Wo * C;  // flattened row lengths
  const int tid = threadIdx.x;
  const int s4 = 4 * tid;           // the thread's first slot of a tile
  const int pc = VL ? 0 : s4 / p.Np;  // its piece: the image b + pc of the tile (VL: one)
  const int fl = s4 - pc * p.Np;    // its first element of the piece
  const bool in_tile = s4 < p.N;

  // --- staging: the slot of one step --------------------------------------
  // A slot is NB g segments, then NB segments of each x row, copied in
  // chunks of E elements.  stage_rows copies one row's NB segments: the
  // rows of the tile's images in the same place (row: the first image's,
  // null for zeros, a row outside the image), `plane` elements apart; the
  // tile's images past the batch (from nimg on) are left as they are.
  auto stage_rows = [&](VC* dst, const T* row, size_t plane, int s0, int seg, int L, int nimg) {
    const int per = seg / E;  // chunks of a segment
    if constexpr (VL) {  // four-wide channels: one image a tile
      for (int q = tid; q < per; q += blockDim.x) {
        const int e0 = s0 + q * E;
        const bool ok = row != nullptr && (unsigned)e0 <= (unsigned)(L - E);
        stage_word<VC>(dst + q, reinterpret_cast<const VC*>(ok ? row + e0 : g), ok);
      }
    } else {
      for (int q = tid; q < nimg * per; q += blockDim.x) {
        const int i = q / per;  // the image
        const int e0 = s0 + (q - i * per) * E;
        const bool ok = row != nullptr && (unsigned)e0 <= (unsigned)(L - E);
        stage_word<VC>(dst + q, reinterpret_cast<const VC*>(ok ? row + i * plane + e0 : g), ok);
      }
    }
  };
  auto stage_step = [&](const Cursor& c, int sl) {
    T* dst = ring + (size_t)sl * p.slot;
    const int r = c.r;
    const size_t gplane = (size_t)Ho * Lg, xplane = (size_t)H * Lx;
    const T* gi = g + c.b * gplane;
    const T* xi = x + c.b * xplane;
    VC* gd = reinterpret_cast<VC*>(dst);
    VC* xd = reinterpret_cast<VC*>(dst + p.xoff);
    const int nimg = min(p.NB, p.B - c.b);
    if constexpr (S == 1) {
      if (r >= c.r0 - 1)  // g row r; rows outside the image are zeros
        stage_rows(gd, r >= 0 && r < Ho ? gi + (size_t)r * Lg : nullptr, gplane, c.gs, p.gseg, Lg,
                   nimg);
      if (r <= c.r1 - 1 && r + 1 >= 0 && r + 1 < H)  // x row r + 1
        stage_rows(xd, xi + (size_t)(r + 1) * Lx, xplane, c.xs, p.xseg, Lx, nimg);
    } else {
      stage_rows(gd, r < Ho ? gi + (size_t)r * Lg : nullptr, gplane, c.gs, p.gseg, Lg, nimg);
      if (2 * r - 1 >= 0 && 2 * r - 1 < H)
        stage_rows(xd, xi + (size_t)(2 * r - 1) * Lx, xplane, c.xs, p.xseg, Lx, nimg);
      if (r < c.r1 && 2 * r < H)
        stage_rows(xd + p.NB * p.xseg / E, xi + (size_t)(2 * r) * Lx, xplane, c.xs, p.xseg, Lx,
                   nimg);
    }
  };

  constexpr int RS = BWD_RS<S>;
  Cursor sc;  // the step staged next
  bool s_ok = cursor_at<S, E>(sc, blockIdx.x, p);
  auto stage_group = [&](int grp) {
#pragma unroll 1
    for (int sub = 0; sub < RS && s_ok; ++sub) {
      stage_step(sc, grp * RS + sub);
      s_ok = cursor_next<S, E>(sc, p);
    }
    stage_commit();
  };
  int slot_in = 0, slot = 0;
#pragma unroll 1
  for (int s = 0; s < BWD_NST - 1; ++s) stage_group(slot_in++);

  // the channel of each slot (the same in every tile: N is a multiple of
  // C), the taps of those channels (loaded while the first copies fly), and
  // the sums
  int ch[4];
  float k[9][4], dwa[9][4], dba[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ch[q] = (fl + q) % C;
    dba[q] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      k[t][q] = in_tile ? widen1(w[t * C + ch[q]]) : 0.f;
      dwa[t][q] = 0.f;
    }
  }

  // wait for the group read now; the group read last goes to the one NST - 1 ahead
  auto next = [&]() {
    stage_wait<BWD_NST - 2>();
    __syncthreads();
    stage_group(slot_in);
    slot_in = slot_in + 1 == BWD_NST ? 0 : slot_in + 1;
  };
  // the slot of the step computed next: a new group every RS steps
  const T* base = ring;
  int sub = 0;
  auto step_slot = [&]() {
    if (sub == 0) {
      next();
      base = ring + (size_t)slot * RS * p.slot;
      slot = slot + 1 == BWD_NST ? 0 : slot + 1;
    }
    const T* sl = base + (size_t)sub * p.slot;
    sub = sub + 1 == RS ? 0 : sub + 1;
    return sl;
  };

  Cursor cc;  // the step computed now
  bool c_ok = cursor_at<S, E>(cc, blockIdx.x, p);
  if constexpr (S == 1) {
    // Step r: g row r ends dx row r + 1 (kernel row 2), continues row r
    // (kernel row 1) and starts row r - 1 (kernel row 0): the fmaf of each
    // dx element in the order a = 0, 1, 2, t = 0, 1, 2.  x row r + 1 meets
    // the g centres of rows r + 2, r + 1, r (taps a = 0, 1, 2); a centre is
    // kept as zero where its row is not the strip's, so that every step
    // runs the same arithmetic.  Roles of the three dx sums and the three g
    // centres rotate.
    auto step = [&](const T* sl, float (&P)[4], float (&Q)[4], float (&Z)[4], float (&gP)[4],
                    float (&gQ)[4], float (&gZ)[4]) {
      if (!in_tile || cc.b + pc >= p.B) return;
      const int r = cc.r, r0 = cc.r0, r1 = cc.r1;
      const int f = cc.f0 + fl;  // the thread's first element of the row
      const int o = f - cc.gs;   // its offset in its piece's segments
      const bool own = r >= r0 && r < r1;
      sl += pc * p.gseg;
      if (r >= r0 - 1) {
        float gv[3][4];  // g[j + 1 - t]
        read4<T, VL>(sl, o + C, gv[0]);
        read4<T, VL>(sl, o, gv[1]);
        read4<T, VL>(sl, o - C, gv[2]);
        if (need_dx) {
          taps3(P, gv, k, 2, false);
          taps3(Q, gv, k, 1, false);
          taps3(Z, gv, k, 0, true);
          if (r + 1 >= r0 && r + 1 < r1) {
            if (p.residual) {
#pragma unroll
              for (int q = 0; q < 4; ++q) P[q] = rnd<T>(P[q]) + gP[q];
            }
            store4<T, VL>(dx + ((size_t)(cc.b + pc) * H + r + 1) * Lx, f, Lx, P);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) gQ[q] = own ? gv[1][q] : 0.f;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) gQ[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dba[q] += gQ[q];
      if (r <= r1 - 1 && r + 1 >= 0 && r + 1 < H) {
        const T* xs = sl + p.xoff + pc * (p.xseg - p.gseg);
        float xv[3][4];  // x[j + t - 1]
        read4<T, VL>(xs, o - C, xv[0]);
        read4<T, VL>(xs, o, xv[1]);
        read4<T, VL>(xs, o + C, xv[2]);
        dw3(dwa, xv, gZ, 0);
        dw3(dwa, xv, gP, 1);
        dw3(dwa, xv, gQ, 2);
      }
    };
    float A0[4], A1[4], A2[4], G0[4], G1[4], G2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) A0[q] = A1[q] = A2[q] = G0[q] = G1[q] = G2[q] = 0.f;
#pragma unroll 1
    while (c_ok) {
      step(step_slot(), A0, A1, A2, G0, G1, G2);
      if (!(c_ok = cursor_next<1, E>(cc, p))) break;
      step(step_slot(), A1, A2, A0, G1, G2, G0);
      if (!(c_ok = cursor_next<1, E>(cc, p))) break;
      step(step_slot(), A2, A0, A1, G2, G0, G1);
      c_ok = cursor_next<1, E>(cc, p);
    }
  } else {
    // Step i: g row i ends input row 2i - 1 (started by row i - 1) and forms
    // input row 2i and the start of 2i + 1 -- the 2x2 formulas, in their
    // order; x row 2i - 1 meets g rows i (a = 0) and i - 1 (a = 2), x row
    // 2i meets g row i (a = 1).  g row r1 (the strip's last step) forms dx
    // only: its centre is kept as zero.
    float p10[4], p11[4], gprev[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) p10[q] = p11[q] = gprev[q] = 0.f;
#pragma unroll 1
    while (c_ok) {
      const T* sl = step_slot();
      if (in_tile && cc.b + pc < p.B) {
        const int r = cc.r, r0 = cc.r0, r1 = cc.r1;
        const int f = cc.f0 + fl;
        const int og = pc * p.gseg + f - cc.gs;
        // per slot: x[2j + t - 1, c] is at 2f - c + (t - 1)C of the x row
        int xo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xo[q] = 2 * (f + q) - ch[q];
        float g0[4], g1[4];  // g at (i, j), (i, j + 1)
        read4<T, VL>(sl, og, g0);
        read4<T, VL>(sl, og + C, g1);
        if (need_dx) {
          T* img = dx + (size_t)(cc.b + pc) * H * Lx;
          int at[4];  // x flat index of pixel 2j of each slot; Lx: none
#pragma unroll
          for (int q = 0; q < 4; ++q) at[q] = f + q < Lg ? xo[q] : Lx;
          float d0[4], d1[4];  // a row's two input columns 2j, 2j + 1
          auto store_row = [&](int row_i) {
            T* row = img + (size_t)row_i * Lx;
            if constexpr (VL) {
              store4<T, true>(row, at[0], Lx, d0);
              store4<T, true>(row, at[0] + C, Lx, d1);
            } else {
              store4_at<T>(row, at, 0, Lx, d0);
              store4_at<T>(row, at, C, Lx, d1);
            }
          };
          if (r > r0 && 2 * r - 1 < H) {  // input row 2i - 1
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              d0[q] = fmaf(g0[q], k[1][q], p10[q]);
              d1[q] = fmaf(g1[q], k[0][q], fmaf(g0[q], k[2][q], p11[q]));
            }
            store_row(2 * r - 1);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            d0[q] = g0[q] * k[4][q];
            d1[q] = fmaf(g1[q], k[3][q], g0[q] * k[5][q]);
            p10[q] = g0[q] * k[7][q];
            p11[q] = fmaf(g1[q], k[6][q], g0[q] * k[8][q]);
          }
          if (r < r1) store_row(2 * r);  // input row 2i
        }
        float gw[4];  // g row i's centre where the row is the strip's, else zero
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          gw[q] = r < r1 ? g0[q] : 0.f;
          dba[q] += gw[q];
          xo[q] -= cc.xs - pc * p.xseg;
        }
        float xv[3][4];
        if (2 * r - 1 >= 0 && 2 * r - 1 < H) {  // x row 2i - 1
          const T* xs = sl + p.xoff;
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            if constexpr (VL) read4<T, true>(xs, xo[0] + (t - 1) * C, xv[t]);
            else read4_at<T>(xs, xo, (t - 1) * C, xv[t]);
          }
          dw3(dwa, xv, gw, 0);
          dw3(dwa, xv, gprev, 2);
        }
        if (r < r1) {  // x row 2i
          const T* xs = sl + p.xoff + p.NB * p.xseg;
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            if constexpr (VL) read4<T, true>(xs, xo[0] + (t - 1) * C, xv[t]);
            else read4_at<T>(xs, xo, (t - 1) * C, xv[t]);
          }
          dw3(dwa, xv, gw, 1);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) gprev[q] = gw[q];
      }
      c_ok = cursor_next<2, E>(cc, p);
    }
  }
  stage_wait<0>();
  __syncthreads();

  // --- the block's partial: per channel, slots c, c + C, ... in order ------
  // red [10][N]: the nine taps and the bias sum of every slot.  A channel's
  // nper slots are added in nrun runs (run `run`: slots c + C (run + nrun m),
  // at most 32, in order) into red2 [10 C][nrun], then the runs in order.
  // A thread takes one (channel, run) pair for all ten entries at once.
  float* red = reinterpret_cast<float*>(bwd_smem);
  const int N = p.N, nper = N / C, nrun = (nper + 31) / 32;
  float* red2 = red + 10 * N;
  if (in_tile) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
      *reinterpret_cast<float4*>(red + t * N + s4) =
          make_float4(dwa[t][0], dwa[t][1], dwa[t][2], dwa[t][3]);
    *reinterpret_cast<float4*>(red + 9 * N + s4) = make_float4(dba[0], dba[1], dba[2], dba[3]);
  }
  __syncthreads();
  for (int pr = tid; pr < C * nrun; pr += blockDim.x) {
    const int c = pr / nrun, run = pr - c * nrun;  // neighbouring pairs: neighbouring banks
    const float* r = red + run * C + c;
    float sum[10];
#pragma unroll
    for (int e = 0; e < 10; ++e) sum[e] = 0.f;
    for (int m = run; m < nper; m += nrun, r += nrun * C) {
#pragma unroll
      for (int e = 0; e < 10; ++e) sum[e] += r[e * N];
    }
#pragma unroll
    for (int e = 0; e < 10; ++e) red2[(e * C + c) * nrun + run] = sum[e];
  }
  __syncthreads();
  for (int ent = tid; ent < 10 * C; ent += blockDim.x) {
    float s = 0.f;
    for (int run = 0; run < nrun; ++run) s += red2[ent * nrun + run];
    p.part[(size_t)blockIdx.x * 10 * C + ent] = s;
  }

  // --- every block's partials in, then the finish ----------------------------
  cg::this_grid().sync();
  const int n_ent = p.db != nullptr ? 10 * C : 9 * C;
  // L lanes an entry (a power of two, at most 32, no more than the partials,
  // and few enough that all 10 C entries get their lanes at once, with or
  // without the bias, so that dw keeps its bits): each adds the partials of
  // its own stride, then a fixed shuffle tree over the L lanes
  const int nb = gridDim.x;
  int L = 1;
  while (L < 32 && L < nb && 2 * L * 10 * C <= nb * (int)blockDim.x) L <<= 1;
  const int lane = tid & 31, grp = lane / L, li = lane - grp * L;
  const int per_warp = 32 / L, warps = blockDim.x / 32;
  for (int ent0 = (blockIdx.x * warps + tid / 32) * per_warp; ent0 < n_ent;
       ent0 += nb * warps * per_warp) {
    const int ent = ent0 + grp;
    float s = 0.f;
    if (ent < n_ent) {
#pragma unroll 8
      for (int b = li; b < nb; b += L) s += __ldcg(p.part + (size_t)b * 10 * C + ent);
    }
    for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (li == 0 && ent < n_ent) {
      if (ent < 9 * C) static_cast<T*>(p.dw)[ent] = from_f32<T>(s);
      else static_cast<T*>(p.db)[ent - 9 * C] = from_f32<T>(s);
    }
  }
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }
int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The tile, strip and grid of one call, and its shared memory.  N is the
// largest multiple of lcm(4, C) that 256 threads of four slots cover, so
// every tile gives a thread the same channels.  The strip height R is the
// one that makes the fewest steps on the busiest block (each strip adds
// halo steps: 3 at stride 1, 1 at stride 2); the grid is at most as many
// blocks as the card holds at once (a cooperative launch).
template <typename T, int S, bool VL, bool CH16>
int bwd_geometry(BwdParams& p, int* nb, size_t* smem) {
  auto kernel = dwconv3x3_bwd_kernel<T, S, VL, CH16>;
  static int n_sm = 0, smem_max = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      n_sm = 0;
      return (int)e;
    }
  }
  static bool attr = false;  // one per instantiation
  if (!attr) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int C = p.C;
  const int l4 = 4 * C / gcd_int(4, C);
  if (l4 > BWD_TILE) return (int)cudaErrorInvalidValue;
  p.Ho = (p.H - 1) / S + 1;
  p.Wo = (p.W - 1) / S + 1;
  const int Lg = p.Wo * C;
  // a piece: at most a tile's elements (1,024; f32: 512, so that three
  // 128-thread blocks share an SM at the f32 kernels' registers), no more
  // than the row needs; narrow channels' rows of at most half of that are
  // packed side by side, an image each
  const int tile = sizeof(T) == 4 ? BWD_TILE / 2 : BWD_TILE;
  const int widest = max(l4, tile / l4 * l4), row = round_up(Lg, l4);
  p.NB = !VL && 2 * row <= widest ? min(p.B, widest / row) : 1;
  p.Np = min(widest, row);
  const int E = CH16 ? 16 / (int)sizeof(T) : 1;
  const int align = E > 8 ? E : 8;  // segments start on 16 bytes
  for (;; p.Np -= l4) {  // the widest piece whose ring fits
    if (S == 1) {
      p.gseg = round_up(p.Np + 2 * C + E - 1, align);
      p.xseg = p.gseg;
    } else {
      p.gseg = round_up(p.Np + C + E - 1, align);
      p.xseg = round_up(2 * p.Np + C + E - 1, align);
    }
    p.N = p.NB * p.Np;
    p.xoff = p.NB * p.gseg;
    p.slot = p.NB * (p.gseg + S * p.xseg);
    const size_t ring = (size_t)BWD_NST * BWD_RS<S> * p.slot * sizeof(T);
    const int nrun = (p.N / C + 31) / 32;
    const size_t red = (size_t)(10 * p.N + 10 * C * nrun) * sizeof(float);
    *smem = ring > red ? ring : red;
    if (*smem <= (size_t)smem_max) break;
    if (p.Np <= l4) return (int)cudaErrorInvalidValue;
  }
  p.threads = round_up(p.N / 4, 32);
  p.nt = (Lg + p.Np - 1) / p.Np;
  int occ = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, p.threads, *smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  // under BWD_SMALL_BYTES of x a call is latency-bound: 256 threads an SM
  // (one block, or two of 128), fewer partials to finish
  const bool small = (long long)p.B * p.H * p.W * C * (long long)sizeof(T) < BWD_SMALL_BYTES;
  const int per_sm = small ? min(occ, max(1, BWD_THREADS / p.threads)) : occ;
  const long long slots = (long long)n_sm * per_sm;
  const int halo = S == 1 ? 3 : 1;
  long long best = -1;
  for (int R = 1; R <= p.Ho; ++R) {
    const long long ns = (p.Ho + R - 1) / R;
    const long long items = (long long)((p.B + p.NB - 1) / p.NB) * ns * p.nt;
    const long long cost = (items + slots - 1) / slots * (R + halo);
    if (best < 0 || cost <= best) {
      best = cost;
      p.R = R;
    }
    if (ns == 1) break;
  }
  p.ns = (p.Ho + p.R - 1) / p.R;
  const long long items = (long long)((p.B + p.NB - 1) / p.NB) * p.ns * p.nt;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  *nb = (int)(items < slots ? items : slots);
  return 0;
}

template <typename T, int S, bool VL, bool CH16>
int launch_bwd(BwdParams p, long long* ws_floats, cudaStream_t stream) {
  int nb;
  size_t smem;
  const int e = bwd_geometry<T, S, VL, CH16>(p, &nb, &smem);
  if (e) return e;
  if (ws_floats != nullptr) {  // the workspace query
    *ws_floats = (long long)nb * 10 * p.C;
    return 0;
  }
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dwconv3x3_bwd_kernel<T, S, VL, CH16>), nb, p.threads, args,
      smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// 16-byte staging where x, g and both flattened rows allow it; four-wide
// shared-memory reads where C is a multiple of four.
template <typename T, int S>
int dispatch_bwd(BwdParams& p, long long* ws, cudaStream_t s) {
  const bool vl = p.C % 4 == 0;
  const int Wo = (p.W - 1) / S + 1;
  const bool ch16 = ((uintptr_t)p.x | (uintptr_t)p.g) % 16 == 0 &&
                    ((long long)p.W * p.C * sizeof(T)) % 16 == 0 &&
                    ((long long)Wo * p.C * sizeof(T)) % 16 == 0;
  if (vl)
    return ch16 ? launch_bwd<T, S, true, true>(p, ws, s) : launch_bwd<T, S, true, false>(p, ws, s);
  return ch16 ? launch_bwd<T, S, false, true>(p, ws, s) : launch_bwd<T, S, false, false>(p, ws, s);
}

int run_bwd(BwdParams& p, int stride, int dtype, long long* ws, cudaStream_t s) {
  if (p.residual && stride != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && stride == 1) return dispatch_bwd<float, 1>(p, ws, s);
  if (dtype == 0 && stride == 2) return dispatch_bwd<float, 2>(p, ws, s);
  if (dtype == 1 && stride == 1) return dispatch_bwd<__nv_bfloat16, 1>(p, ws, s);
  if (dtype == 1 && stride == 2) return dispatch_bwd<__nv_bfloat16, 2>(p, ws, s);
  return (int)cudaErrorInvalidValue;
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

// The backward's workspace: the floats of the f32 block partials
// [nb, 10, C] that tcct_dwconv3x3_bwd needs for these pointers and shapes
// (nb: the blocks of its launch), or a negative CUDA error code.
extern "C" long long tcct_dwconv3x3_bwd_workspace(const void* x, const void* g, int B, int H,
                                                  int W, int C, int stride, int dtype) {
  BwdParams p{};
  p.x = x;
  p.g = g;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  long long n = 0;
  const int e = run_bwd(p, stride, dtype, &n, nullptr);
  return e ? -(long long)e : n;
}

// The fused backward, one cooperative launch.  x [B,H,W,C], w [3,3,C],
// g [B,Ho,Wo,C], dx [B,H,W,C] (null: not formed), dw [3,3,C], db [C]
// (null: not formed), all in one type (dtype 0 float32, 1 bfloat16); part
// is the f32 workspace sized by tcct_dwconv3x3_bwd_workspace.  residual
// != 0 (stride 1) adds g to dx after dx is rounded, rounded again.
// Returns the launch's CUDA error code.
extern "C" int tcct_dwconv3x3_bwd(const void* x, const void* w, const void* g, void* dx, void* dw,
                                  void* db, void* part, int B, int H, int W, int C, int stride,
                                  int dtype, int residual, void* stream) {
  BwdParams p{};
  p.x = x;
  p.w = w;
  p.g = g;
  p.dx = dx;
  p.dw = dw;
  p.db = db;
  p.part = static_cast<float*>(part);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.residual = residual;
  return run_bwd(p, stride, dtype, nullptr, static_cast<cudaStream_t>(stream));
}
