// Train-mode BatchNorm with an optional LeakyReLU(0.01) before it, forward
// (K3) and backward (K3b), for Hopper (sm_90a).
//
// Replaces the TPU kernels tcct_tpu/ops/pallas/bnstats.py::_stats_kernel
// (pallas_call at bnstats.py:129) and ::_norm_kernel (bnstats.py:149), via
// bn_act_train_packed_pallas, and that function's backward (::_bwd,
// bnstats.py:181, plain jnp).  The TPU kernels work on a space-to-depth
// packed layout with phantom masks and fold the phases with a matmul; those
// are TPU layout artifacts.  Here the input is the port's own layout: x is
// [M, C] with channels fastest (an NCHW tensor in channels_last memory,
// M = B*H*W).
//
// Forward, per channel c, with t = act(x) in the input type T:
//   mean = sum(t) / M,  var = sum(t*t) / M - mean^2   (f32 sums, biased, no clamp)
//   inv  = (1 / sqrt(var + eps)) * weight             (f32)
//   y    = (t - T(mean)) * T(inv) + T(bias)           (each step rounded to T)
// the arithmetic of the JAX package's default BatchNorm
// (tcct_tpu/models/layers.py:405-434), not the TPU kernel's folded
// t*inv + shift.
// Backward, with the forward's mean and var, n = M and f32 sums:
//   r = 1 / sqrt(var + eps), inv = weight * r, gsum = sum(gy),
//   ginv = sum(gy * t) - mean * gsum, gvar = -0.5 * ginv * weight * r^3,
//   gmean = -inv * gsum - 2 * mean * gvar,
//   dx = (gy * inv + gmean / n + 2 * gvar / n * t) * act'(x)   (f32, rounded once to T)
//   dweight = ginv * r, dbias = gsum                           (in weight's type)
// each product and sum rounded in f32 in the order of the plain version
// (ops/kernels/bnstats.py::bn_act_train_backward_reference).  T is f32 or
// bf16; weight and bias are f32 or bf16.
//
// Bound: bytes.  The forward reads x and writes y (4 bytes an element in
// bf16), the backward reads x and gy and writes dx (6), at a handful of
// operations an element.
//
// Design: one cooperative launch for each, a grid no larger than one block
// on each SM (so every block is resident; at least 8 KiB of input a
// block), 512 threads.
//   1. Each block owns a contiguous range of rows.  A thread owns one word
//      (16 bytes, or one element where C or a pointer does not allow it) of
//      every R-th row, UNROLL rows in flight, widens bf16 with a shift and a
//      mask, and keeps f32 sums of its word's channels.  The block keeps
//      its first rows' words in shared memory, as many as fit, so the
//      second sweep reads x (and gy) again only for the rest, the last read
//      and the likeliest still in L2 (the kept rows are read, and the
//      outputs stored, with an evict-first hint).
//   2. The block adds its threads' sums in a fixed order and writes one
//      partial per channel.  Grid barrier.
//   3. Channel c is finished by block c % grid: a warp adds the partials of
//      one sum (lane-strided, then a fixed shuffle tree), and the block forms
//      mean, var and inv (forward) or the three coefficients, dweight and
//      dbias (backward) and writes them.  Grid barrier.
//   4. Every block reads the per-channel values and runs the elementwise
//      pass over its rows, the re-read ones first; each rounding to bf16
//      is one cvt.rn.bf16x2.f32 (an integer round-to-nearest-even made the
//      large shapes compute-bound).
// No float atomics: repeated runs give bitwise-equal results.
//
// Two-phase entry points, for a batch split over the ranks of a data-parallel
// step (the TPU kernel's own structure: _stats_kernel, then _norm_kernel):
//   sums      (tcct_bn_act_sums): phases 1-3 of the forward or the backward,
//             ending in the channel's two f32 sums (sum t, sum t*t; or sum gy,
//             sum gy*t), written to a [2, C] output.  Same grid, words and
//             order as the one launch, so with the same x (and gy) the sums
//             are bitwise the ones the one launch forms.  Nothing is kept in
//             shared memory: no elementwise pass follows in this launch.
//   finish    (tcct_bn_act_normalize, tcct_bn_act_backward_dx): given the sums
//             of the whole batch (all-reduced across the ranks) and its row
//             count, every block forms the per-channel values of phase 3 for
//             all channels itself (no grid barrier: an ordinary launch) and
//             runs phase 4 over its rows, reading x (and gy) again from device
//             memory.  That re-read is what the split costs: the forward moves
//             x twice and y once (the one launch: x once, mostly, and y), the
//             backward x and gy twice and dx once.
// At one rank, sums then finish give bitwise the one launch's y, mean, var and
// dx: the same sums, then the same f32 arithmetic on them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

struct bf16 { uint16_t bits; };  // storage only: the arithmetic is f32

__device__ __forceinline__ float widen1(float v) { return v; }
__device__ __forceinline__ float widen1(bf16 v) { return __uint_as_float((uint32_t)v.bits << 16); }

// f32 -> bf16 bits, round to nearest even (one cvt.rn.bf16.f32)
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
// round an f32 value to T and back: the result of one eager op in type T
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __uint_as_float(bf16_bits(v) << 16);
}

// One word: VEC elements of T, moved as one load or store.
template <typename T, int VEC> struct Word;
template <> struct Word<float, 4> { using type = uint4; };
template <> struct Word<float, 1> { using type = float; };
template <> struct Word<bf16, 8> { using type = uint4; };
template <> struct Word<bf16, 1> { using type = bf16; };

template <typename T, int VEC>
__device__ __forceinline__ void widen(const typename Word<T, VEC>::type& w, float* out) {
  if constexpr (VEC == 1) {
    out[0] = widen1(w);
  } else if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(&w);
#pragma unroll
    for (int q = 0; q < VEC; ++q) out[q] = f[q];
  } else {  // bf16 pairs: a shift and a mask
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) {
      out[2 * q] = __uint_as_float(u[q] << 16);
      out[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ typename Word<T, VEC>::type narrow(const float* v) {
  typename Word<T, VEC>::type w;
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) w = v[0];
    else w.bits = (uint16_t)bf16_bits(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    float* f = reinterpret_cast<float*>(&w);
#pragma unroll
    for (int q = 0; q < VEC; ++q) f[q] = v[q];
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  }
  return w;
}

// Loads and stores that L2 evicts first (ld/st.global.cs): the rows a block
// keeps on chip and the outputs, so that L2 keeps the rows read again.
__device__ __forceinline__ uint4 ld_first(const uint4* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_first(const float* p) { return __ldcs(p); }
__device__ __forceinline__ bf16 ld_first(const bf16* p) { return *p; }
__device__ __forceinline__ void st_first(uint4* p, const uint4& v) { __stcs(p, v); }
__device__ __forceinline__ void st_first(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_first(bf16* p, const bf16& v) { *p = v; }

// LeakyReLU(0.01) in type T, as torch computes it (f32 product, rounded)
template <typename T, bool LEAKY> __device__ __forceinline__ float act(float f) {
  if constexpr (LEAKY) return f > 0.f ? f : rnd<T>(__fmul_rn(f, 0.01f));
  return f;
}

// a per-channel parameter of type code dt (0 f32, 1 bf16) as f32
__device__ __forceinline__ float load_param(const void* p, int dt, int c) {
  if (dt == 0) return static_cast<const float*>(p)[c];
  return __uint_as_float((uint32_t)static_cast<const uint16_t*>(p)[c] << 16);
}
__device__ __forceinline__ void store_param(void* p, int dt, int c, float v) {
  if (dt == 0) static_cast<float*>(p)[c] = v;
  else static_cast<uint16_t*>(p)[c] = (uint16_t)bf16_bits(v);
}

// What a launch runs: the one-launch kernel, or one of the two phases.
enum Mode { FULL = 0, SUMS = 1, FINISH = 2 };

struct Params {
  const void* x;       // [M, C] in T
  const void* gy;      // backward: [M, C] in T
  void* out;           // forward y, backward dx: [M, C] in T
  const void* weight;  // [C], type code wdt
  const void* bias;    // forward: [C], type code bdt
  const float* mean;   // backward: the forward's batch mean [C]
  const float* var;    // backward: the forward's biased batch var [C]
  float* stats;        // forward: [3, C] mean, var, inv (outputs); backward: [3, C] coefficients
  void* dwb;           // backward: [2, C] dweight, dbias in weight's type
  float* part;         // [2C, grid] the blocks' partial sums
  float* sums;         // SUMS: [2, C] output; FINISH: [2, C] sums of the whole batch
  float count;         // rows of the whole batch (FULL: M), the divisor n
  long long M;
  long long rows;      // rows a block
  long long keep;      // rows a block keeps in shared memory
  int C, W, R;         // channels, words a row, row lanes a block (THREADS / W)
  float eps;
  int wdt, bdt;
};

// Shared memory: the reduction scratch, [3C] per-channel values, [2*WARPS]
// finished sums; then the kept words.  The scratch is what block_partials
// uses for this C: where W = C / vec divides 32, one sum per warp of each
// channel, both sums; else one per row lane, then J runs of them.  (The
// warp path's 2 * WARPS * C floats would be 256 KiB at 2048 f32 channels,
// more than a block has, and that C takes the lane path.)
__host__ __device__ constexpr size_t red_floats(int C, int vec) {
  if (32 % (C / vec) == 0) return 2 * (size_t)WARPS * C;           // warps, both sums
  return (size_t)THREADS * vec + (C > THREADS ? C : THREADS);        // lanes, runs
}
__host__ __device__ constexpr size_t fixed_floats(int C, int vec) {
  return (red_floats(C, vec) + 3 * (size_t)C + 2 * WARPS + 3) / 4 * 4;
}

// The block's per-thread sums s1[VEC], s2[VEC] (threads r < R, word wc)
// added over the R row lanes in a fixed order; channel c's two sums go to
// part[c * grid + block] and part[(C + c) * grid + block].  Where W divides
// 32 a warp's lanes of one word column first add by a fixed shuffle tree,
// then the warps in order; else J runs of lanes, then the runs in order.
template <int VEC>
__device__ __forceinline__ void block_partials(float* red, float (&s1)[VEC], float (&s2)[VEC],
                                               int r, int wc, const Params& p) {
  const int C = p.C, R = p.R, W = p.W, tid = threadIdx.x, nb = gridDim.x;
  if (32 % W == 0) {  // every thread is a lane (R = THREADS / W)
    const int warp = tid / 32, lane = tid % 32;
    for (int o = 16; o >= W; o >>= 1)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], o);
      }
    if (lane < W)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        red[warp * C + wc * VEC + k] = s1[k];
        red[(WARPS + warp) * C + wc * VEC + k] = s2[k];
      }
    __syncthreads();
    for (int v = tid; v < 2 * C; v += THREADS) {
      const int q = v / C, c = v - q * C;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a += red[(q * WARPS + w) * C + c];
      p.part[(size_t)v * nb + blockIdx.x] = a;
    }
    __syncthreads();
    return;
  }
  float* red2 = red + THREADS * VEC;
  int J = THREADS / C;
  J = J < 1 ? 1 : (J > 32 ? 32 : J);
  const int run = (R + J - 1) / J;
  for (int q = 0; q < 2; ++q) {
    if (r < R)
#pragma unroll
      for (int k = 0; k < VEC; ++k) red[r * C + wc * VEC + k] = q ? s2[k] : s1[k];
    __syncthreads();
    for (int i = tid; i < C * J; i += THREADS) {
      const int c = i % C, j = i / C;
      float a = 0.f;
      const int q1 = min(R, (j + 1) * run);
      for (int l = j * run; l < q1; ++l) a += red[l * C + c];
      red2[j * C + c] = a;
    }
    __syncthreads();
    for (int c = tid; c < C; c += THREADS) {
      float a = 0.f;
      for (int j = 0; j < J; ++j) a += red2[j * C + c];
      p.part[(size_t)(q * C + c) * nb + blockIdx.x] = a;
    }
    __syncthreads();
  }
}

// Sum of part[v, 0..nb) by one warp: lanes over a stride of 32 in order,
// then a fixed shuffle tree.  Every lane gets the sum.
__device__ __forceinline__ float warp_partials(const float* part, int v, int nb, int lane) {
  float a = 0.f;
  for (int q = lane; q < nb; q += 32) a += __ldcg(part + (size_t)v * nb + q);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// y for one word of x: (t - T(mean)) * T(inv) + T(bias), each step rounded
// to T; prm holds T(mean), T(inv), T(bias) as f32, [3][C].
template <typename T, int VEC, bool LEAKY>
__device__ __forceinline__ typename Word<T, VEC>::type norm_word(
    const typename Word<T, VEC>::type& v, const float* prm, int C, int wc) {
  float f[VEC];
  widen<T, VEC>(v, f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = wc * VEC + k;
    const float d = rnd<T>(__fsub_rn(act<T, LEAKY>(f[k]), prm[c]));
    f[k] = __fadd_rn(rnd<T>(__fmul_rn(d, prm[C + c])), prm[2 * C + c]);
  }
  return narrow<T, VEC>(f);
}

// dx for one word of x and gy: ((gy * a + b) + c2 * t) * act'(x) in f32,
// rounded once to T; prm holds a, b, c2, [3][C].
template <typename T, int VEC, bool LEAKY>
__device__ __forceinline__ typename Word<T, VEC>::type dx_word(
    const typename Word<T, VEC>::type& vx, const typename Word<T, VEC>::type& vg,
    const float* prm, int C, int wc) {
  float fx[VEC], fg[VEC];
  widen<T, VEC>(vx, fx);
  widen<T, VEC>(vg, fg);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = wc * VEC + k;
    float d = __fadd_rn(__fadd_rn(__fmul_rn(fg[k], prm[c]), prm[C + c]),
                        __fmul_rn(prm[2 * C + c], act<T, LEAKY>(fx[k])));
    if (LEAKY) d = __fmul_rn(d, fx[k] >= 0.f ? 1.f : 0.01f);
    fg[k] = d;
  }
  return narrow<T, VEC>(fg);
}

// Per-channel values of channel c from its two sums, n = p.count.  Forward:
// v = mean, var, inv.  Backward (s1 = sum(gy), s2 = sum(gy * t)): v = the
// coefficients a, b, c2 of dx_word, and dwb = dweight, dbias.
template <bool BWD>
__device__ __forceinline__ void channel_values(const Params& p, int c, float s1, float s2,
                                               float* v, float* dwb) {
  const float n = p.count;
  const float w = load_param(p.weight, p.wdt, c);
  if constexpr (!BWD) {
    const float mu = s1 / n;
    const float var = __fsub_rn(s2 / n, __fmul_rn(mu, mu));
    v[0] = mu;
    v[1] = var;
    v[2] = __fmul_rn(1.f / __fsqrt_rn(__fadd_rn(var, p.eps)), w);
  } else {
    const float mu = p.mean[c];
    const float rs = 1.f / __fsqrt_rn(__fadd_rn(p.var[c], p.eps));
    const float inv = __fmul_rn(w, rs);
    const float ginv = __fsub_rn(s2, __fmul_rn(mu, s1));
    const float gvar =
        __fmul_rn(__fmul_rn(__fmul_rn(ginv, -0.5f), w), __fmul_rn(__fmul_rn(rs, rs), rs));
    const float gmean = __fsub_rn(__fmul_rn(-inv, s1), __fmul_rn(2.f * mu, gvar));
    v[0] = inv;
    v[1] = gmean / n;
    v[2] = __fmul_rn(gvar / n, 2.f);
    dwb[0] = __fmul_rn(ginv, rs);
    dwb[1] = s1;
  }
}

// Phase 3 of the one launch for channel c: forward, mean, var and inv into
// p.stats; backward, the coefficients a, b, c2 into p.stats and dweight,
// dbias into p.dwb.
template <bool BWD>
__device__ __forceinline__ void finish_channel(const Params& p, int c, float s1, float s2) {
  const int C = p.C;
  float v[3], dwb[2];
  channel_values<BWD>(p, c, s1, s2, v, dwb);
#pragma unroll
  for (int q = 0; q < 3; ++q) p.stats[q * C + c] = v[q];
  if constexpr (BWD) {
    store_param(p.dwb, p.wdt, c, dwb[0]);
    store_param(p.dwb, p.wdt, C + c, dwb[1]);
  }
}

// The forward (BWD false: sums of t and t*t, then y) or the backward (BWD
// true: sums of gy and gy*t, then dx).  Phases as in the header; MODE SUMS
// runs phases 1-3 and writes the two sums, FINISH phase 4 from given sums.
template <typename T, int VEC, bool LEAKY, bool BWD, int UNROLL, int MODE>
__device__ __forceinline__ void bn_act(const Params& p) {
  using V = typename Word<T, VEC>::type;
  constexpr int NT = BWD ? 2 : 1;  // tensors swept: x (and gy)
  extern __shared__ __align__(16) float smem[];
  float* red = smem;
  float* prm = red + red_floats(p.C, VEC);  // [3][C] per-channel values of phase 4
  float* fin = prm + 3 * p.C;               // [2 * WARPS] finished sums
  V* kept = reinterpret_cast<V*>(smem + fixed_floats(p.C, VEC));  // [keep][NT][W]

  const int tid = threadIdx.x, W = p.W, R = p.R, C = p.C;
  const int r = tid / W, wc = tid - r * W;
  const long long m0 = (long long)blockIdx.x * p.rows;
  const long long m1 = min(m0 + p.rows, p.M);
  const V* xw = static_cast<const V*>(p.x);
  const V* gw = static_cast<const V*>(p.gy);

  if constexpr (MODE != FINISH) {
    // 1. sweep: f32 sums, UNROLL rows of the lane in flight; words kept
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
    if (r < R)
      for (long long m = m0 + r; m < m1; m += (long long)UNROLL * R) {
        V vx[UNROLL], vg[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long mu = m + (long long)u * R;
          if (mu < m1 && mu - m0 < p.keep) {
            vx[u] = ld_first(xw + mu * W + wc);
            if constexpr (BWD) vg[u] = ld_first(gw + mu * W + wc);
          } else if (mu < m1) {
            vx[u] = xw[mu * W + wc];
            if constexpr (BWD) vg[u] = gw[mu * W + wc];
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long i = m + (long long)u * R - m0;
          if (m + (long long)u * R >= m1) continue;
          if (i < p.keep) {
            kept[(i * NT) * W + wc] = vx[u];
            if constexpr (BWD) kept[(i * NT + 1) * W + wc] = vg[u];
          }
          float fx[VEC];
          widen<T, VEC>(vx[u], fx);
          if constexpr (BWD) {
            float fg[VEC];
            widen<T, VEC>(vg[u], fg);
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              s1[k] += fg[k];
              s2[k] = fmaf(fg[k], act<T, LEAKY>(fx[k]), s2[k]);
            }
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float t = act<T, LEAKY>(fx[k]);
              s1[k] += t;
              s2[k] = fmaf(t, t, s2[k]);
            }
          }
        }
      }

    // 2. the block's partials
    block_partials<VEC>(red, s1, s2, r, wc, p);
    cg::this_grid().sync();

    // 3. this block's channels: their sums, then (FULL) their values
    const int nb = gridDim.x;
    const int mine = (int)blockIdx.x < C ? (C - 1 - (int)blockIdx.x) / nb + 1 : 0;
    const int warp = tid / 32, lane = tid % 32;
    for (int k0 = 0; k0 < mine; k0 += WARPS) {
      const int kn = min(WARPS, mine - k0);
      for (int t = warp; t < 2 * kn; t += WARPS) {
        const int c = blockIdx.x + (k0 + t / 2) * nb;
        const float a = warp_partials(p.part, (t & 1) * C + c, nb, lane);
        if (lane == 0) fin[t] = a;
      }
      __syncthreads();
      if (tid < kn) {
        const int c = blockIdx.x + (k0 + tid) * nb;
        if constexpr (MODE == SUMS) {
          p.sums[c] = fin[2 * tid];
          p.sums[C + c] = fin[2 * tid + 1];
        } else {
          finish_channel<BWD>(p, c, fin[2 * tid], fin[2 * tid + 1]);
        }
      }
      __syncthreads();
    }
    if constexpr (MODE == SUMS) return;
    cg::this_grid().sync();

    // the per-channel values of phase 4, from device memory
    for (int c = tid; c < C; c += THREADS) {
      if constexpr (BWD) {
        for (int q = 0; q < 3; ++q) prm[q * C + c] = __ldcg(p.stats + q * C + c);
      } else {
        prm[c] = rnd<T>(__ldcg(p.stats + c));
        prm[C + c] = rnd<T>(__ldcg(p.stats + 2 * C + c));
        prm[2 * C + c] = rnd<T>(load_param(p.bias, p.bdt, c));
      }
    }
  } else {
    // FINISH: every block forms every channel's values from the given sums;
    // block 0 writes the forward's mean, var and inv
    for (int c = tid; c < C; c += THREADS) {
      float v[3], dwb[2];
      channel_values<BWD>(p, c, p.sums[c], p.sums[C + c], v, dwb);
      if constexpr (BWD) {
        for (int q = 0; q < 3; ++q) prm[q * C + c] = v[q];
      } else {
        if (blockIdx.x == 0)
          for (int q = 0; q < 3; ++q) p.stats[q * C + c] = v[q];
        prm[c] = rnd<T>(v[0]);
        prm[C + c] = rnd<T>(v[2]);
        prm[2 * C + c] = rnd<T>(load_param(p.bias, p.bdt, c));
      }
    }
  }
  __syncthreads();

  // 4. the elementwise pass over the block's rows: first the rows read
  // again from device memory (the last read in phase 1, the likeliest still
  // in L2), then the kept rows from shared memory
  if (r >= R) return;
  V* out = static_cast<V*>(p.out);
  const long long mk = min(m1, m0 + p.keep);
  long long m = m0 + r;
  if (mk > m) m += (mk - m + R - 1) / R * R;  // the lane's first row past the kept ones
  for (; m < m1; m += (long long)UNROLL * R) {
    V vx[UNROLL], vg[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long mu = m + (long long)u * R;
      if (mu < m1) {
        vx[u] = xw[mu * W + wc];
        if constexpr (BWD) vg[u] = gw[mu * W + wc];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long mu = m + (long long)u * R;
      if (mu >= m1) continue;
      if constexpr (BWD)
        st_first(out + mu * W + wc, dx_word<T, VEC, LEAKY>(vx[u], vg[u], prm, C, wc));
      else
        st_first(out + mu * W + wc, norm_word<T, VEC, LEAKY>(vx[u], prm, C, wc));
    }
  }
#pragma unroll 4
  for (m = m0 + r; m < mk; m += R) {
    const long long i = m - m0;
    if constexpr (BWD)
      st_first(out + m * W + wc, dx_word<T, VEC, LEAKY>(kept[(2 * i) * W + wc],
                                                        kept[(2 * i + 1) * W + wc], prm, C, wc));
    else
      st_first(out + m * W + wc, norm_word<T, VEC, LEAKY>(kept[i * W + wc], prm, C, wc));
  }
}

template <typename T, int VEC, bool LEAKY, int UNROLL>
__global__ void __launch_bounds__(THREADS, 1) bn_act_fwd_kernel(const Params p) {
  bn_act<T, VEC, LEAKY, false, UNROLL, FULL>(p);
}

template <typename T, int VEC, bool LEAKY, int UNROLL>
__global__ void __launch_bounds__(THREADS, 1) bn_act_bwd_kernel(const Params p) {
  bn_act<T, VEC, LEAKY, true, UNROLL, FULL>(p);
}

template <typename T, int VEC, bool LEAKY, bool BWD, int UNROLL>
__global__ void __launch_bounds__(THREADS, 1) bn_act_sums_kernel(const Params p) {
  bn_act<T, VEC, LEAKY, BWD, UNROLL, SUMS>(p);
}

template <typename T, int VEC, bool LEAKY, int UNROLL>
__global__ void __launch_bounds__(THREADS, 1) bn_act_norm_kernel(const Params p) {
  bn_act<T, VEC, LEAKY, false, UNROLL, FINISH>(p);
}

template <typename T, int VEC, bool LEAKY, int UNROLL>
__global__ void __launch_bounds__(THREADS, 1) bn_act_dx_kernel(const Params p) {
  bn_act<T, VEC, LEAKY, true, UNROLL, FINISH>(p);
}

// Launch geometry of one call: the grid, rows a block, rows kept, words.
struct Geom {
  int nb, vec, W, R;
  long long rows, keep;
  size_t smem;
};

constexpr long long BLOCK_BYTES = 8 * 1024;  // the least bytes a block sweeps

int device_limits(int* sms, int* smem_max) {
  static int s_sms = 0, s_smem = 0;
  if (s_sms == 0) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&s_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&s_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) {
      s_sms = 0;
      return (int)e;
    }
  }
  *sms = s_sms;
  *smem_max = s_smem;
  return 0;
}

// tensors: 1 (forward: x) or 2 (backward: x, gy); esize: bytes an element
int geometry(long long M, int C, int esize, int tensors, bool aligned16, Geom* g) {
  int sms, smem_max;
  const int e = device_limits(&sms, &smem_max);
  if (e) return e;
  g->vec = aligned16 && (C * esize) % 16 == 0 ? 16 / esize : 1;
  g->W = C / g->vec;
  if (g->W > THREADS || M <= 0) return (int)cudaErrorInvalidValue;
  g->R = THREADS / g->W;
  const long long bytes = M * C * (long long)esize * tensors;
  long long nb = (bytes + BLOCK_BYTES - 1) / BLOCK_BYTES;
  nb = nb < 1 ? 1 : (nb > sms ? sms : nb);
  g->rows = (M + nb - 1) / nb;
  g->nb = (int)((M + g->rows - 1) / g->rows);
  const size_t fixed = fixed_floats(C, g->vec) * sizeof(float);
  if (fixed > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)C * esize * tensors;
  const long long fit = ((long long)smem_max - (long long)fixed) / row_bytes;
  g->keep = fit < g->rows ? fit : g->rows;
  g->smem = fixed + (size_t)(g->keep * row_bytes);
  return 0;
}

template <auto Kernel>
int launch(const Geom& g, Params& p, cudaStream_t stream, bool cooperative) {
  static bool attr = false;  // one per kernel
  if (!attr) {
    int sms, smem_max;
    int e = device_limits(&sms, &smem_max);
    if (e) return e;
    e = (int)cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (e) return e;
    attr = true;
  }
  p.W = g.W;
  p.R = g.R;
  p.rows = g.rows;
  p.keep = g.keep;
  void* args[] = {&p};
  const void* fn = reinterpret_cast<const void*>(Kernel);
  cudaError_t e = cooperative
                      ? cudaLaunchCooperativeKernel(fn, g.nb, THREADS, args, g.smem, stream)
                      : cudaLaunchKernel(fn, g.nb, THREADS, args, g.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The kernel of (T, BWD, LEAKY, MODE) at the geometry's word width.
template <typename T, bool BWD, bool LEAKY, int MODE>
int run_typed(const Geom& g, Params& p, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  constexpr int U16 = BWD ? 4 : 8;  // 16-byte words in flight: 8 a thread
  const bool wide = g.vec == V16;
  if constexpr (MODE == SUMS) {
    if (wide) return launch<bn_act_sums_kernel<T, V16, LEAKY, BWD, U16>>(g, p, s, true);
    return launch<bn_act_sums_kernel<T, 1, LEAKY, BWD, 8>>(g, p, s, true);
  } else if constexpr (MODE == FINISH && BWD) {
    if (wide) return launch<bn_act_dx_kernel<T, V16, LEAKY, U16>>(g, p, s, false);
    return launch<bn_act_dx_kernel<T, 1, LEAKY, 8>>(g, p, s, false);
  } else if constexpr (MODE == FINISH) {
    if (wide) return launch<bn_act_norm_kernel<T, V16, LEAKY, U16>>(g, p, s, false);
    return launch<bn_act_norm_kernel<T, 1, LEAKY, 8>>(g, p, s, false);
  } else if constexpr (BWD) {
    if (wide) return launch<bn_act_bwd_kernel<T, V16, LEAKY, U16>>(g, p, s, true);
    return launch<bn_act_bwd_kernel<T, 1, LEAKY, 8>>(g, p, s, true);
  } else {
    if (wide) return launch<bn_act_fwd_kernel<T, V16, LEAKY, U16>>(g, p, s, true);
    return launch<bn_act_fwd_kernel<T, 1, LEAKY, 8>>(g, p, s, true);
  }
}

// The word width follows the alignment of every tensor the launch reads or
// writes in rows; the sums pass has no output rows, so with an aligned
// output it takes the one launch's words, grid and order.
template <bool BWD, int MODE>
int run(Params& p, int dtype, int leaky, cudaStream_t s) {
  const int esize = dtype == 0 ? 4 : 2;
  const uintptr_t ptrs = (uintptr_t)p.x | (MODE == SUMS ? 0 : (uintptr_t)p.out) |
                         (BWD ? (uintptr_t)p.gy : 0);
  Geom g;
  const int e = geometry(p.M, p.C, esize, BWD ? 2 : 1, ptrs % 16 == 0, &g);
  if (e) return e;
  if (MODE != FULL) {  // nothing kept on chip: no elementwise pass follows the sweep
    g.keep = 0;
    g.smem = fixed_floats(p.C, g.vec) * sizeof(float);
  }
  if (dtype == 0)
    return leaky ? run_typed<float, BWD, true, MODE>(g, p, s)
                 : run_typed<float, BWD, false, MODE>(g, p, s);
  if (dtype == 1)
    return leaky ? run_typed<bf16, BWD, true, MODE>(g, p, s)
                 : run_typed<bf16, BWD, false, MODE>(g, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Workspace of one call (forward: backward = 0, x only; backward: x and gy):
// the f32 floats the caller allocates for `part`, or -1 if the kernel does
// not take this shape.
extern "C" long long tcct_bn_act_workspace(long long M, int C, int dtype, int backward) {
  Geom g;
  if (geometry(M, C, dtype == 0 ? 4 : 2, backward ? 2 : 1, true, &g)) return -1;
  return 2LL * C * g.nb;
}

// Forward.  x, y: [M, C] in dtype (0 = float32, 1 = bfloat16); weight, bias:
// [C] of type wdt, bdt (0 f32, 1 bf16); stats: [3, C] f32 outputs mean,
// var, inv = rsqrt(var + eps) * weight; part: the workspace.  leaky: 1
// applies LeakyReLU(0.01) first.  One cooperative launch; returns its error.
extern "C" int tcct_bn_act_train(const void* x, void* y, const void* weight, const void* bias,
                                 void* stats, void* part, long long M, int C, float eps,
                                 int leaky, int dtype, int wdt, int bdt, void* stream) {
  Params p{};
  p.x = x;
  p.out = y;
  p.weight = weight;
  p.bias = bias;
  p.stats = static_cast<float*>(stats);
  p.part = static_cast<float*>(part);
  p.M = M;
  p.C = C;
  p.eps = eps;
  p.wdt = wdt;
  p.bdt = bdt;
  p.count = (float)M;
  return run<false, FULL>(p, dtype, leaky, static_cast<cudaStream_t>(stream));
}

// Backward.  x, gy, dx: [M, C] in dtype; weight: [C] of type wdt; mean,
// var: [C] f32 (the forward's); coef: [3, C] f32 scratch; dwb: [2, C]
// outputs dweight, dbias in weight's type; part: the workspace.  One
// cooperative launch; returns its error.
extern "C" int tcct_bn_act_train_backward(const void* x, const void* gy, void* dx,
                                          const void* weight, const void* mean,
                                          const void* var, void* coef, void* dwb, void* part,
                                          long long M, int C, float eps, int leaky, int dtype,
                                          int wdt, void* stream) {
  Params p{};
  p.x = x;
  p.gy = gy;
  p.out = dx;
  p.weight = weight;
  p.mean = static_cast<const float*>(mean);
  p.var = static_cast<const float*>(var);
  p.stats = static_cast<float*>(coef);
  p.dwb = dwb;
  p.part = static_cast<float*>(part);
  p.M = M;
  p.C = C;
  p.eps = eps;
  p.wdt = wdt;
  p.count = (float)M;
  return run<true, FULL>(p, dtype, leaky, static_cast<cudaStream_t>(stream));
}

// Sums pass.  x (and, backward, gy): [M, C] in dtype; sums: [2, C] f32
// outputs, forward sum(t), sum(t*t), backward sum(gy), sum(gy*t), with
// t = act(x); part: the workspace of tcct_bn_act_workspace(M, C, dtype,
// backward).  One cooperative launch; returns its error.
extern "C" int tcct_bn_act_sums(const void* x, const void* gy, void* sums, void* part,
                                long long M, int C, int leaky, int dtype, int backward,
                                void* stream) {
  Params p{};
  p.x = x;
  p.gy = gy;
  p.sums = static_cast<float*>(sums);
  p.part = static_cast<float*>(part);
  p.M = M;
  p.C = C;
  p.count = (float)M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return backward ? run<true, SUMS>(p, dtype, leaky, s) : run<false, SUMS>(p, dtype, leaky, s);
}

// Normalize pass.  x, y: [M, C] in dtype; weight, bias: [C] of type wdt,
// bdt; sums: [2, C] f32, sum(t) and sum(t*t) over count rows (the whole
// batch); stats: [3, C] f32 outputs mean, var, inv.  One launch.
extern "C" int tcct_bn_act_normalize(const void* x, void* y, const void* weight,
                                     const void* bias, const void* sums, void* stats,
                                     long long M, long long count, int C, float eps, int leaky,
                                     int dtype, int wdt, int bdt, void* stream) {
  Params p{};
  p.x = x;
  p.out = y;
  p.weight = weight;
  p.bias = bias;
  p.sums = const_cast<float*>(static_cast<const float*>(sums));
  p.stats = static_cast<float*>(stats);
  p.M = M;
  p.count = (float)count;
  p.C = C;
  p.eps = eps;
  p.wdt = wdt;
  p.bdt = bdt;
  return run<false, FINISH>(p, dtype, leaky, static_cast<cudaStream_t>(stream));
}

// dx pass.  x, gy, dx: [M, C] in dtype; weight: [C] of type wdt; mean, var:
// [C] f32 (the forward's); sums: [2, C] f32, sum(gy) and sum(gy*t) over
// count rows (the whole batch).  One launch; returns its error.
extern "C" int tcct_bn_act_backward_dx(const void* x, const void* gy, void* dx,
                                       const void* weight, const void* mean, const void* var,
                                       const void* sums, long long M, long long count, int C,
                                       float eps, int leaky, int dtype, int wdt, void* stream) {
  Params p{};
  p.x = x;
  p.gy = gy;
  p.out = dx;
  p.weight = weight;
  p.mean = static_cast<const float*>(mean);
  p.var = static_cast<const float*>(var);
  p.sums = const_cast<float*>(static_cast<const float*>(sums));
  p.M = M;
  p.count = (float)count;
  p.C = C;
  p.eps = eps;
  p.wdt = wdt;
  return run<true, FINISH>(p, dtype, leaky, static_cast<cudaStream_t>(stream));
}
