// MetaPool token mixer, forward and backward, and the serving block's
// MetaPool site in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernels tcct_tpu/ops/pallas/metapool.py::_kernel and
// ::_bwd_kernel (both through pallas_call at metapool.py:64, via
// metapool_tokens_pallas and its custom VJP).
//
// Forward (K1), for x of shape [B, N, C] (row-major, C fastest):
//   a = AvgPool2d(3, stride 1, pad 1, count_include_pad=False)(x) - x
// with the 3x3 window sliding over the (token, channel) axes -- the
// reference model's quirk, kept on purpose.  Backward (K1b), its adjoint for
// the output gradient g of the same shape:
//   dx = window_sum(g / count) - g
// where count is the same valid-element count map (torch's, 1 along an
// axis of length 1).  Arithmetic is f32 inside and each result is cast to
// the input type once (f32 or bf16): the window's horizontal sums are
// (left + centre) + right, the vertical sum (above + row) + below, then the
// division by the count (forward; the backward divides each g first) and
// the subtraction.  Every quotient is an IEEE division by the count, formed
// as (row count x column count), as the plain version forms it.
//
// The site (flags, forward only): with NORMS the window runs on
//   n = LayerNorm1(x), rounded to x's type (nn.LayerNorm's output),
// and a second output n2 = LayerNorm2(y) is written, rounded; with
// RESIDUAL the output is y = x + a (an f32 add rounded once: torch's add),
// else y = a.  A
// LayerNorm's statistics are per token in f32: mean = sum(x) / C, then the
// biased variance sum((x - mean)^2) / C, rstd = rsqrtf(var + eps), the
// divisions as products with 1/C and the last one an fma; each sum
// is taken over 16-byte chunks of the token by L lanes (norm_rows: lane l
// adds the chunks l, l + L, ... in order, then a butterfly over the L
// lanes).  The output is fmaf(w, (x - mean) * rstd, b)
// with w, b widened to f32.  Tokens outside [0, N) are the window's zero
// padding in n (not LayerNorm1 of a zero row).
//
// The site on a width shard (tcct_metapool_block_shard): the same pass over
// the tokens of a block of every row's columns, the tokens beside each row's
// ends taken from two exchanged halo columns (see metapool_shard_kernel).
//
// Bound: bytes.  K1 and K1b read each element once and write it once and
// cost about a dozen f32 operations each, far below the card's operations-
// per-byte balance; the site reads x once and writes y and n2 (3 passes
// where the four separate ops make 9).
//
// Design.  A block of 128 threads owns a tile of `tile` consecutive tokens
// of one batch element with all C channels.  The tile plus one halo token
// on each side is one contiguous run of memory: it is staged raw (bf16 as
// bf16) in shared memory with 16-byte cp.async copies (8-byte or one
// element where C or a pointer's alignment needs it; the launch picks the
// word, never another kernel).  With NORMS the warps then normalise the
// staged rows into a second tile, a row's lanes keeping their weights in
// registers.  Thread (tx, ty) of the block -- tx a channel word of VEC
// elements (4 f32, or 4 bf16: half a staged word, see BF16_VEC), ty a run
// of R consecutive tokens, both decomposed once per thread -- slides down
// its run: each staged row is read once as one word, widened once (bf16
// by a shift and a mask, never cvt.f32.bf16), and its two edge channels
// c - 1 and c + VEC are two scalar reads of the same row in shared memory.
// Shared memory, not a warp shuffle, gives the edges: a run's word and its
// neighbours need not lie in one warp (C / VEC is 16-72 at the models'
// widths), the reads are 2-4 bytes against the 8-16 of the word, and the
// shared-memory rate is far above what the device-memory rate lets a tile
// use.  The thread keeps the horizontal sums of the two rows above in
// registers and re-reads its centre word from the staged tile (the
// backward's g too, never from global memory).  Each output word is one
// 8- or 16-byte store.  With NORMS the rounded y words also go to shared
// memory (over the raw x the thread has just read, one row down), and the
// warps normalise them into n2 as they did for x, a lane storing its
// chunks.  R is chosen at launch (8, 4, 2 or 1: the largest that still
// gives every SM of the card 4 blocks), so that a tile of the largest stage (64 tokens at C = 64)
// re-reads 3 % of its rows as halo, the widest (8 tokens at C = 288) a
// fifth, from L2, and the small stages spread over the card.  There is no
// integer division per element: the staging loop walks the run as one
// range of words, whose valid part (tokens in [0, N)) is one interval.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SMEM = 227 * 1024;

template <typename T, int VEC> struct Vec;  // VEC values of T in one load
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Vec<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };

// one element as f32: bf16 by a shift
__device__ __forceinline__ float widen1(float v) { return v; }
__device__ __forceinline__ float widen1(__nv_bfloat16 v) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(v) << 16);
}

// a word's elements as f32; bf16 pairs by a shift and a mask
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
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = widen1(e[k]);
  }
}

// f32 values rounded to T (to nearest even) in one word; bf16 in pairs
template <typename T, int VEC>
__device__ __forceinline__ typename Vec<T, VEC>::type pack(const float* v) {
  typename Vec<T, VEC>::type out;
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
    __nv_bfloat162* e2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) e2[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  } else if constexpr (sizeof(T) == 2) {
    T* e = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = __float2bfloat16_rn(v[k]);
  } else {
    float* e = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = v[k];
  }
  return out;
}

// valid elements of a 3-wide, pad-1 window at index i of an axis of length n
__device__ __forceinline__ float axis_count(int i, int n) {
  int lo = i - 1 < 0 ? 0 : i - 1;
  int hi = i + 2 > n ? n : i + 2;
  return (float)(hi - lo);
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
    V z;
    *reinterpret_cast<uint16_t*>(&z) = 0;
    *dst = ok ? *src : z;
  }
}

__device__ __forceinline__ void stage_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// LayerNorm of `nrows` rows of S (C elements each, shared memory) into
// dst + r * C (shared or global memory), rounded to T.  A row is cut into
// 16-byte chunks (8 bf16 or 4 f32 elements; the last may be short) and
// taken by L lanes (L the power of two >= its chunks, at most 32): lane l
// adds the chunks l, l + L, ... and a chunk's elements in order, then a
// butterfly over the L lanes gives the sum; the same again for the squared
// deviations.  The order depends on C and the type only, not on the word
// the launch picked.  Rows whose token (n_first + r) lies outside [0, N)
// are written as zeros: the window's padding.
template <typename T, int VEC>
__device__ void norm_rows(const T* S, T* dst, int nrows, int C, int n_first, int N,
                          const T* __restrict__ w, const T* __restrict__ b, float eps) {
  using V = typename Vec<T, VEC>::type;
  constexpr int WPC = 16 / (int)sizeof(T) / VEC;  // words a chunk
  const int cv = C / VEC;
  const int nch = (cv + WPC - 1) / WPC;
  int L = 1, lg = 0;
  while (L < nch && L < 32) L <<= 1, ++lg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane >> lg, sl = lane & (L - 1);
  const int per_warp = 32 >> lg, stride = (THREADS / 32) * per_warp;
  const V* wv = reinterpret_cast<const V*>(w);
  const V* bv = reinterpret_cast<const V*>(b);
  // the affine of the lane's first chunk, kept in registers
  float g0[WPC][VEC], e0[WPC][VEC];
#pragma unroll
  for (int q = 0; q < WPC; ++q)
    if (sl < nch && sl * WPC + q < cv) {
      widen<T, VEC>(wv[sl * WPC + q], g0[q]);
      widen<T, VEC>(bv[sl * WPC + q], e0[q]);
    }
  const float inv_c = 1.f / (float)C;
  for (int r0 = warp * per_warp; r0 < nrows; r0 += stride) {  // uniform in the warp
    const int r = r0 + seg;
    const bool ok = r < nrows;
    const int n = n_first + r;
    const bool valid = ok && n >= 0 && n < N;
    const V* row = reinterpret_cast<const V*>(S + (size_t)(ok ? r : 0) * C);
    // the lane's first chunk stays in registers from the sum to the store;
    // a lane's further chunks (C over 32 chunks) are read again each pass
    const bool first = ok && sl < nch;
    float hv[WPC][VEC];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < WPC; ++q)
      if (first && sl * WPC + q < cv) {
        widen<T, VEC>(row[sl * WPC + q], hv[q]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += hv[q][j];
      }
    if (ok)
      for (int k = sl + L; k < nch; k += L)
#pragma unroll
        for (int q = 0; q < WPC; ++q)
          if (k * WPC + q < cv) {
            float v[VEC];
            widen<T, VEC>(row[k * WPC + q], v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) s += v[j];
          }
    for (int off = L >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mean = s * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int q = 0; q < WPC; ++q)
      if (first && sl * WPC + q < cv)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = hv[q][j] - mean;
          sq = fmaf(d, d, sq);
        }
    if (ok)
      for (int k = sl + L; k < nch; k += L)
#pragma unroll
        for (int q = 0; q < WPC; ++q)
          if (k * WPC + q < cv) {
            float v[VEC];
            widen<T, VEC>(row[k * WPC + q], v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float d = v[j] - mean;
              sq = fmaf(d, d, sq);
            }
          }
    for (int off = L >> 1; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rs = rsqrtf(fmaf(sq, inv_c, eps));
    V* out = reinterpret_cast<V*>(dst + (size_t)r * C);
#pragma unroll
    for (int q = 0; q < WPC; ++q)
      if (first && sl * WPC + q < cv) {
        float v[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          v[j] = valid ? fmaf(g0[q][j], (hv[q][j] - mean) * rs, e0[q][j]) : 0.f;
        out[sl * WPC + q] = pack<T, VEC>(v);
      }
    if (ok)
      for (int k = sl + L; k < nch; k += L)
#pragma unroll
        for (int q = 0; q < WPC; ++q) {
          const int wi = k * WPC + q;
          if (wi < cv) {
            float v[VEC], g[VEC], e[VEC];
            widen<T, VEC>(row[wi], v);
            widen<T, VEC>(wv[wi], g);
            widen<T, VEC>(bv[wi], e);
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[j] = valid ? fmaf(g[j], (v[j] - mean) * rs, e[j]) : 0.f;
            out[wi] = pack<T, VEC>(v);
          }
        }
  }
}

// Horizontal 3-sums h of staged row s (token n) of S at the word of
// channel c: (left + centre) + right, zero outside [0, C).  The backward
// (BWD) first divides each g by its window count, as the plain version;
// cc holds the column counts of the channels c - 1 .. c + VEC.
template <typename T, int VEC, bool BWD>
__device__ __forceinline__ void row_sum(const T* S, int s, int c, int C, int n, int N,
                                        const float (&cc)[VEC + 2], float (&h)[VEC]) {
  using V = typename Vec<T, VEC>::type;
  const T* p = S + (size_t)s * C + c;
  float u[VEC + 2];
  widen<T, VEC>(*reinterpret_cast<const V*>(p), u + 1);
  u[0] = c > 0 ? widen1(p[-1]) : 0.f;
  u[VEC + 1] = c + VEC < C ? widen1(p[VEC]) : 0.f;
  if constexpr (BWD) {
    const int k0 = c > 0 ? 0 : 1, k1 = c + VEC < C ? VEC + 2 : VEC + 1;  // channels in [0, C)
    const float cn = axis_count(n, N);
#pragma unroll
    for (int k = 0; k < VEC + 2; ++k)
      if (k >= k0 && k < k1) u[k] = u[k] / (cn * cc[k]);
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) h[j] = (u[j] + u[j + 1]) + u[j + 2];
}

// Steps 2 and 3 of a tile of the site, shared by metapool_kernel and
// metapool_shard_kernel, which differ only in what they stage and in the
// token-axis count.  S holds the window's source, staged rows 0 .. rows + 1
// for the tile's output rows 0 .. rows - 1 (one row down), X the raw tokens
// in the same rows.  Writes the tile's outputs to yt + r * C and, with
// NORMS, their LayerNorm2 to n2t + r * C.  count(r) is output row r's
// token-axis count; the forward divides by count(r) times the channel
// count.  BWD (K1b) divides each staged g by its own count first, for which
// staged row s is token n_first + s of N.
template <typename T, int VEC, bool BWD, bool NORMS, typename Count>
__device__ __forceinline__ void site_tile(const T* S, const T* X, T* Y, T* __restrict__ yt,
                                          T* __restrict__ n2t, int rows, int C, int bx, int R,
                                          int residual, int n_first, int N,
                                          const T* __restrict__ w2, const T* __restrict__ b2,
                                          float eps, Count count) {
  using V = typename Vec<T, VEC>::type;
  const int cv = C / VEC;  // words a token
  // thread (tx, ty) takes channel word tx and tokens ty*R .. ty*R + R - 1 of
  // the tile (more where C / VEC > bx or the tile is taller than
  // THREADS / bx runs: never at the launch's sizes)
  const int by = THREADS / bx;
  const int tx = threadIdx.x % bx, ty = threadIdx.x / bx;  // once a thread
  if (ty < by) {
    for (int w = tx; w < cv; w += bx) {
      const int c = w * VEC;
      float cc[VEC + 2];  // column counts of the channels c - 1 .. c + VEC
#pragma unroll
      for (int k = 0; k < VEC + 2; ++k) cc[k] = axis_count(c - 1 + k, C);
      for (int r0 = ty * R; r0 < rows; r0 += by * R) {
        const int r1 = min(r0 + R, rows);
        float h0[VEC], h1[VEC];
        row_sum<T, VEC, BWD>(S, r0, c, C, n_first + r0, N, cc, h0);
        row_sum<T, VEC, BWD>(S, r0 + 1, c, C, n_first + r0 + 1, N, cc, h1);
        for (int r = r0; r < r1; ++r) {
          float h2[VEC];
          row_sum<T, VEC, BWD>(S, r + 2, c, C, n_first + r + 2, N, cc, h2);
          const size_t at = (size_t)(r + 1) * C + c;  // the centre word, staged
          float ctr[VEC], out[VEC];
          widen<T, VEC>(*reinterpret_cast<const V*>(S + at), ctr);
#pragma unroll
          for (int j = 0; j < VEC; ++j) out[j] = (h0[j] + h1[j]) + h2[j];
          if constexpr (BWD) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) out[j] = out[j] - ctr[j];
          } else {
            const float cn = count(r);
#pragma unroll
            for (int j = 0; j < VEC; ++j) out[j] = out[j] / (cn * cc[j + 1]) - ctr[j];
          }
          V word = pack<T, VEC>(out);
          if (!BWD && residual) {  // y = x + a: the rounded a, one f32 add, rounded
            float a[VEC], xr[VEC];
            widen<T, VEC>(word, a);
            widen<T, VEC>(*reinterpret_cast<const V*>(X + at), xr);
#pragma unroll
            for (int j = 0; j < VEC; ++j) a[j] = xr[j] + a[j];
            word = pack<T, VEC>(a);
          }
          *reinterpret_cast<V*>(yt + (size_t)r * C + c) = word;
          if constexpr (NORMS) *reinterpret_cast<V*>(Y + (size_t)r * C + c) = word;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            h0[j] = h1[j];
            h1[j] = h2[j];
          }
        }
      }
    }
  }

  // 3. n2 = LayerNorm2(y) of the tile's tokens, straight to global memory
  if constexpr (NORMS) {
    __syncthreads();
    norm_rows<T, VEC>(Y, n2t, rows, C, 0, rows, w2, b2, eps);
  }
}

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

// X [tile + 2][C]: the staged tokens n0-1 .. n0+tile; with NORMS a second
// tile of their LayerNorm1 (the window's source), the outputs y then
// overwriting X one row down.  Returns the bytes and puts the second tile's
// offset in *nrm.
template <typename T, bool NORMS>
__host__ __device__ inline int smem_layout(int tile, int C, int* nrm = nullptr) {
  const int xt = align16((tile + 2) * C * (int)sizeof(T));
  if (nrm) *nrm = xt;
  return NORMS ? 2 * xt : xt;
}

// blocks an SM the registers must allow (85 registers a thread); 8 make
// the site spill, and on the card 6 beat both 8 and 4 at the site and tied
// at K1 and K1b
constexpr int min_blocks() { return 6; }

// SVEC: the elements of a staged word (16 bytes where C and the pointers
// allow); VEC: the elements a thread computes on, SVEC or a part of it.
template <typename T, int SVEC, int VEC, bool BWD, bool NORMS>
__global__ void __launch_bounds__(THREADS, min_blocks())
metapool_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ y,
                T* __restrict__ n2, int N, int C, int bx, int R, int tile, int residual,
                float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  int nrm;
  smem_layout<T, NORMS>(tile, C, &nrm);
  T* X = reinterpret_cast<T*>(smem);
  T* Nrm = reinterpret_cast<T*>(smem + nrm);
  T* Y = X + C;                      // output row r, over the raw x it was made from
  const T* S = NORMS ? Nrm : X;      // the window's source

  const int n0 = blockIdx.x * tile;
  const int rows = min(tile, N - n0);  // output tokens of the tile
  const size_t base = (size_t)blockIdx.y * N * C;
  const T* xb = x + base;

  // 1. stage tokens n0-1 .. n0+tile, one run of (tile + 2) * cv words; those
  //    of tokens in [0, N) are the words [lo, hi)
  {
    using SV = typename Vec<T, SVEC>::type;
    const int sv = C / SVEC;  // staged words a token
    const int lo = n0 == 0 ? sv : 0;
    const int hi = min(tile + 2, N - n0 + 1) * sv;
    const long long first = (long long)(n0 - 1) * C;  // element offset of word 0
    SV* dst = reinterpret_cast<SV*>(X);
    for (int q = threadIdx.x; q < (tile + 2) * sv; q += THREADS) {
      const bool ok = q >= lo && q < hi;
      const T* src = ok ? xb + (first + (long long)q * SVEC) : xb;
      stage_word<SV>(dst + q, reinterpret_cast<const SV*>(src), ok);
    }
    if constexpr (sizeof(SV) >= 4) stage_wait_all();
  }
  __syncthreads();
  if constexpr (NORMS) {
    norm_rows<T, VEC>(X, Nrm, tile + 2, C, n0 - 1, N, w1, b1, eps);
    __syncthreads();
  }

  // 2-3. the window, the residual and LayerNorm2 (site_tile)
  site_tile<T, VEC, BWD, NORMS>(S, X, Y, y + base + (size_t)n0 * C,
                                NORMS ? n2 + base + (size_t)n0 * C : n2, rows, C, bx, R,
                                residual, n0 - 1, N, w2, b2, eps,
                                [=](int r) { return axis_count(n0 + r, N); });
}

// The site on a width shard (forward: the two LayerNorms and the residual,
// as the serving site always runs).  x holds the [B, H * w, C] tokens of w
// consecutive columns of an H-row token grid whose other columns lie on
// other ranks; left and right [B, H, C] hold, for each row h, the token just
// before x's row h and the one just after it in the whole grid's flat order
// (the exchanged columns: the rank before's last column, or on the first
// rank the last rank's last column of row h - 1; symmetrically on the
// right).  With `first` the shard holds the grid's first token, so row 0's
// left token does not exist; with `last` likewise row H - 1's right token.
// A missing token is the window's zero padding (after LayerNorm1, not
// LayerNorm1 of a zero row), and the token-axis count is 2 beside it, 3
// everywhere else: the counts of the whole grid.
//
// A block takes `tile` consecutive columns j0 .. of one row h of one batch
// element (a row holds ceil(w / tile) tiles) and stages them with the column
// before and the one after: x's own columns, or left[h] / right[h] at the
// row's ends.  The rest is metapool_kernel's site_tile, so the shards'
// outputs reassemble to the one-launch site's bit for bit.
template <typename T, int SVEC, int VEC>
__global__ void __launch_bounds__(THREADS, min_blocks())
metapool_shard_kernel(const T* __restrict__ x, const T* __restrict__ left,
                      const T* __restrict__ right, const T* __restrict__ w1,
                      const T* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ b2, T* __restrict__ y, T* __restrict__ n2, int H,
                      int w, int C, int tpr, int bx, int R, int tile, int first, int last,
                      float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  int nrm;
  smem_layout<T, true>(tile, C, &nrm);
  T* X = reinterpret_cast<T*>(smem);
  T* Nrm = reinterpret_cast<T*>(smem + nrm);

  const int h = blockIdx.x / tpr;
  const int j0 = (blockIdx.x - h * tpr) * tile;
  const int rows = min(tile, w - j0);  // output tokens of the tile
  const bool lmiss = first && h == 0 && j0 == 0;
  const bool rmiss = last && h == H - 1 && j0 + rows == w;
  const int vlo = lmiss ? 1 : 0, vhi = rmiss ? rows + 1 : rows + 2;  // staged rows that exist
  const size_t row0 = (size_t)blockIdx.y * H * w + (size_t)h * w;  // token (h, 0)
  const T* xr = x + row0 * C;
  const T* lrow = left + ((size_t)blockIdx.y * H + h) * C;
  const T* rrow = right + ((size_t)blockIdx.y * H + h) * C;

  // 1. stage columns j0 - 1 .. j0 + tile: staged row s is column j0 - 1 + s
  {
    using SV = typename Vec<T, SVEC>::type;
    const int sv = C / SVEC;
    SV* dst = reinterpret_cast<SV*>(X);
    for (int q = threadIdx.x; q < (tile + 2) * sv; q += THREADS) {
      const int s = q / sv, k = q - s * sv;
      const T* src;
      if (s == 0)
        src = j0 == 0 ? lrow : xr + (size_t)(j0 - 1) * C;
      else if (s == rows + 1)
        src = j0 + rows == w ? rrow : xr + (size_t)(j0 + rows) * C;
      else
        src = xr + (size_t)(j0 + s - 1) * C;
      const bool ok = s >= vlo && s < vhi;
      stage_word<SV>(dst + q, reinterpret_cast<const SV*>(ok ? src + (size_t)k * SVEC : xr), ok);
    }
    if constexpr (sizeof(SV) >= 4) stage_wait_all();
  }
  __syncthreads();
  norm_rows<T, VEC>(X, Nrm, tile + 2, C, -vlo, vhi - vlo, w1, b1, eps);
  __syncthreads();

  // 2-3. as metapool_kernel's; the token-axis count is 2 beside a missing token
  site_tile<T, VEC, false, true>(
      Nrm, X, X + C, y + (row0 + j0) * C, n2 + (row0 + j0) * C, rows, C, bx, R, 1, 0, 1, w2, b2,
      eps, [=](int r) { return 3.f - (float)(lmiss && r == 0) - (float)(rmiss && r == rows - 1); });
}

// The current device's SM count, read once a device (0 if it cannot be read).
int sm_count() {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    cached[dev] = 0;
  return cached[dev];
}

// Runs of R tokens a thread: the largest of 8, 4, 2, 1 whose tiles still
// give each of the card's `sms` SMs 4 blocks (1 where none does), and whose
// shared memory lets min_blocks() blocks share an SM.
template <typename T, bool NORMS>
int pick_rows(int B, int N, int C, int by, int sms) {
  int R = 8;
  while (R > 1 && (long long)B * ((N + by * R - 1) / (by * R)) < 4LL * sms) R /= 2;
  while (R > 1 && smem_layout<T, NORMS>(by * R, C) > MAX_SMEM / min_blocks())
    R /= 2;
  return R;
}

template <typename T, int SVEC, int VEC, bool BWD, bool NORMS>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* y, void* n2, int B, int N, int C, int residual, float eps,
           cudaStream_t stream) {
  const int cv = C / VEC;
  const int bx = cv < THREADS ? cv : THREADS;
  const int by = THREADS / bx;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int R = pick_rows<T, NORMS>(B, N, C, by, sms);
  const int tile = by * R;
  const int smem = smem_layout<T, NORMS>(tile, C);
  if (smem > MAX_SMEM || B > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = metapool_kernel<T, SVEC, VEC, BWD, NORMS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + tile - 1) / tile, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(y),
      static_cast<T*>(n2), N, C, bx, R, tile, residual, eps);
  return (int)cudaGetLastError();
}

inline bool aligned(const void* p, int bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

// bf16 elements a thread computes on when the staged word is 16 bytes:
// half a word (more threads a tile, fewer registers a thread; on the card
// it beat the whole word at K1 and at the site)
constexpr int BF16_VEC = 4;

// The staged word: 16 bytes where C and every pointer allow it, else 8,
// else one element; a thread computes on the same word (bf16: BF16_VEC of
// a 16-byte word).
template <typename T, int VEC16, bool BWD, bool NORMS>
int dispatch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
             void* y, void* n2, int B, int N, int C, int residual, float eps, cudaStream_t s) {
  auto fits = [&](int vec) {
    const int bytes = vec * (int)sizeof(T);
    return C % vec == 0 && aligned(x, bytes) && aligned(y, bytes) && aligned(n2, bytes) &&
           aligned(w1, bytes) && aligned(b1, bytes) && aligned(w2, bytes) && aligned(b2, bytes);
  };
  constexpr int VC = sizeof(T) == 2 ? BF16_VEC : VEC16;
  if (fits(VEC16))
    return launch<T, VEC16, VC, BWD, NORMS>(x, w1, b1, w2, b2, y, n2, B, N, C, residual, eps, s);
  if (fits(VEC16 / 2))
    return launch<T, VEC16 / 2, VEC16 / 2, BWD, NORMS>(x, w1, b1, w2, b2, y, n2, B, N, C,
                                                          residual, eps, s);
  return launch<T, 1, 1, BWD, NORMS>(x, w1, b1, w2, b2, y, n2, B, N, C, residual, eps, s);
}

template <typename T, int VEC16>
int dispatch_flags(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* y, void* n2, int B, int N, int C, int flags, float eps,
                   cudaStream_t s) {
  const int residual = (flags & 2) != 0;
  if (flags & 1)
    return dispatch<T, VEC16, false, true>(x, w1, b1, w2, b2, y, n2, B, N, C, residual, eps, s);
  return dispatch<T, VEC16, false, false>(x, w1, b1, w2, b2, y, n2, B, N, C, residual, eps, s);
}

// The shard's tiles: R tokens a thread (at most 8), and the fewest tiles a
// row that hold its w columns at that R, each tile as even as it can be;
// R halves while the grid would give the card's SMs under 4 blocks each, or
// the shared memory would not let min_blocks() blocks share an SM.
template <typename T>
void pick_shard_tiles(int B, int H, int w, int C, int by, int sms, int* tile, int* tpr, int* R) {
  for (int r = 8;; r /= 2) {
    *tpr = (w + by * r - 1) / (by * r);
    *R = (w + by * *tpr - 1) / (by * *tpr);
    *tile = by * *R;
    if (r == 1) return;
    if ((long long)B * H * *tpr >= 4LL * sms &&
        smem_layout<T, true>(*tile, C) <= MAX_SMEM / min_blocks())
      return;
  }
}

template <typename T, int SVEC, int VEC>
int launch_shard(const void* x, const void* left, const void* right, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* y, void* n2, int B,
                 int H, int w, int C, int first, int last, float eps, cudaStream_t stream) {
  const int cv = C / VEC;
  const int bx = cv < THREADS ? cv : THREADS;
  const int by = THREADS / bx;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  int tile, tpr, R;
  pick_shard_tiles<T>(B, H, w, C, by, sms, &tile, &tpr, &R);
  const int smem = smem_layout<T, true>(tile, C);
  if (smem > MAX_SMEM || B > 65535 || (long long)H * tpr > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto kernel = metapool_shard_kernel<T, SVEC, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(H * tpr, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), static_cast<T*>(n2), H, w, C, tpr, bx, R,
      tile, first, last, eps);
  return (int)cudaGetLastError();
}

// The shard's word, as dispatch() picks it (the halos' pointers too).
template <typename T, int VEC16>
int dispatch_shard(const void* x, const void* left, const void* right, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* y, void* n2, int B,
                   int H, int w, int C, int flags, float eps, cudaStream_t s) {
  const int first = (flags & 1) != 0, last = (flags & 2) != 0;
  auto fits = [&](int vec) {
    const int bytes = vec * (int)sizeof(T);
    return C % vec == 0 && aligned(x, bytes) && aligned(left, bytes) && aligned(right, bytes) &&
           aligned(y, bytes) && aligned(n2, bytes) && aligned(w1, bytes) && aligned(b1, bytes) &&
           aligned(w2, bytes) && aligned(b2, bytes);
  };
  constexpr int VC = sizeof(T) == 2 ? BF16_VEC : VEC16;
  if (fits(VEC16))
    return launch_shard<T, VEC16, VC>(x, left, right, w1, b1, w2, b2, y, n2, B, H, w, C, first,
                                      last, eps, s);
  if (fits(VEC16 / 2))
    return launch_shard<T, VEC16 / 2, VEC16 / 2>(x, left, right, w1, b1, w2, b2, y, n2, B, H, w,
                                                 C, first, last, eps, s);
  return launch_shard<T, 1, 1>(x, left, right, w1, b1, w2, b2, y, n2, B, H, w, C, first, last,
                               eps, s);
}

}  // namespace

// The site on a width shard (see metapool_shard_kernel): x [B, H * w, C],
// left and right [B, H, C], w1, b1, w2, b2 [C], y and n2 as x; flags: 1 =
// the shard holds the grid's first token, 2 = its last.  dtype: 0 =
// float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what it does not take.
extern "C" int tcct_metapool_block_shard(const void* x, const void* left, const void* right,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, void* y, void* n2, int B, int H, int w,
                                         int C, int dtype, int flags, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || w <= 0 || C <= 0 || !w1 || !b1 || !w2 || !b2 || !n2)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_shard<float, 4>(x, left, right, w1, b1, w2, b2, y, n2, B, H, w, C, flags,
                                    eps, s);
  if (dtype == 1)
    return dispatch_shard<__nv_bfloat16, 8>(x, left, right, w1, b1, w2, b2, y, n2, B, H, w, C,
                                            flags, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The site, forward: x [B, N, C]; flags: 1 = the two LayerNorms (w1, b1,
// w2, b2 [C]; n2 [B, N, C]), 2 = residual (y = x + a); unused pointers may
// be null.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int tcct_metapool_block(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* y, void* n2, int B,
                                   int N, int C, int dtype, int flags, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_flags<float, 4>(x, w1, b1, w2, b2, y, n2, B, N, C, flags, eps, s);
  if (dtype == 1)
    return dispatch_flags<__nv_bfloat16, 8>(x, w1, b1, w2, b2, y, n2, B, N, C, flags, eps, s);
  return (int)cudaErrorInvalidValue;
}

// K1: y = metapool(x), the site with no flags.
extern "C" int tcct_metapool_fwd(const void* x, void* y, int B, int N, int C, int dtype,
                                 void* stream) {
  return tcct_metapool_block(x, nullptr, nullptr, nullptr, nullptr, y, nullptr, B, N, C, dtype,
                             0, 0.f, stream);
}

// K1b: g is the gradient of y, dx the gradient of x, both [B, N, C] in the
// same type.  Returns cudaGetLastError() after the launch.
extern "C" int tcct_metapool_bwd(const void* g, void* dx, int B, int N, int C, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float, 4, true, false>(g, nullptr, nullptr, nullptr, nullptr, dx, nullptr, B,
                                           N, C, 0, 0.f, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, 8, true, false>(g, nullptr, nullptr, nullptr, nullptr, dx,
                                                   nullptr, B, N, C, 0, 0.f, s);
  return (int)cudaErrorInvalidValue;
}
