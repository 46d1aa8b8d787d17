// Fused CrossCNNBlock inference forward for Hopper (sm_90a).
//
// Replaces the TPU kernel attic/crosscnn_fused.py::_block_kernel
// (pallas_call at crosscnn_fused.py:237, via fused_cross_block and
// cross_resnet_fused).
//
// For x [B, H, W, Cin] (NHWC) it computes y [B, H, W, Cout], eval mode:
//   a = affine12(lrelu(conv3x3(conv3x3(x))))
//   b = affine34(lrelu(conv3x3(conv_kx1(conv_1xk(x)))))
//   y = affine5 (lrelu(conv3x3(gelu_erf(a + b))))
// Every conv has a bias and zero-pads its own input, so each intermediate
// reads as 0 outside the image.  Sums, bias, LeakyReLU(0.01), the folded
// BatchNorm x * scale + shift, a + b and the erf GELU are f32; values are
// rounded to the input type (f32 or bf16) only where the TPU kernel rounds
// them: before each following conv and at the output.
//
// Bound: operations.  The block does 2 * (36 + 2k) * C * C operations per
// pixel at Cin = Cout = C and moves (Cin + Cout) * itemsize bytes per pixel,
// thousands of operations per byte.
//
// The input type decides the kernel.  f32 runs f32 FMAs on the CUDA cores
// (TF32 would not hold 1e-4); bf16, with Cin a multiple of 16 and Cout of 32
// as every model's blocks have, runs mma.sync on the tensor cores with f32
// accumulators (second half of this file).  Both run the stages below over
// the same buffers.
//
// Design: one block per (batch element, tile of TH x TW output pixels).  The
// chain's receptive radius is R = k/2 + 2, but each stage needs only its own:
//   X  : x at rows and columns -R .. T+R        (zero outside the image)
//   A1 : conv3x3(X)       at radius 2
//   B1 : conv_1xk(X)      at rows radius R, columns radius 2
//   B2 : conv_kx1(B1)     at radius 2
//   G  : gelu(affine12(lrelu(conv3x3(A1))) + affine34(lrelu(conv3x3(B2))))
//        at radius 1, the two 3x3 sums of an element held in registers
//   Y  : affine5(lrelu(conv3x3(G))) on the tile, stored to global memory
// All of X, A1, B1, B2 and G live in shared memory in the input type; B2
// reuses X's room and G reuses B1's.  Each stage writes 0 at positions
// outside the image, which is the zero padding of the next conv.  The tile
// is chosen at launch from Cin, Cout, k and the item size so that the
// buffers fit the SM's 227 KB, and shrunk (no further than 4 rows of 8 or 12
// columns) while the grid has fewer blocks than the card has SMs.  Any H and
// W: outputs beyond the image are not stored, and pixel groups wholly
// outside it are not computed.
//
// On the CUDA cores a conv stage gives each of 256 threads a register tile of
// 4 pixels x 4 output channels.  Consecutive lanes take consecutive channel
// groups of the same pixels, so the staged inputs are read as 16-byte
// shared-memory broadcasts (4 input channels at once) and the weights,
// tap-major [taps][Cin][Cout], as coalesced 16-byte loads through the
// read-only cache: at C = 256 one conv's weights exceed shared memory and
// every block reads them from L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int PX = 4;  // pixels of a thread's register tile
constexpr int CO = 4;  // output channels of a thread's register tile
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block can opt in to
constexpr int NUM_SMS = 132;

// rows of the f32 vector table [12][Cout]
enum { B121, B122, B341, B342, B343, B5, S12, T12, S34, T34, S5, T5 };

struct Params {
  const void* x;
  const void* w;     // the six conv weights back to back: f32 tap-major, bf16 fragment-major
  const float* vec;  // [12][Cout]: six biases, three (scale, shift) pairs
  void* y;
  int H, W, Cin, Cout, k, TH, TW;
  int ck;            // bf16: steps in each of the weights' two ring slots; 0 for resident weights
};

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ldg4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.01f * v; }
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
}

// ---- f32: the CUDA cores ---------------------------------------------------------

// One conv over a staged input [rows][IW][Cin]: output pixel (r, c) reads
// input pixel (r + oy + dy, c + ox + dx) at tap (dy, dx).
struct Conv {
  const float* in;
  const float* w;  // [KH * KW][Cin][Cout]
  int IW, Cin, KH, KW, oy, ox;
};

// acc[j][o] += sum over taps and input channels, for the PX pixels whose
// (tap 0, channel 0) input offsets are base[j] and the CO channels from co.
__device__ __forceinline__ void conv_acc(float (&acc)[PX][CO], const Conv& c,
                                         const int (&base)[PX], int Cout, int co) {
  for (int dy = 0; dy < c.KH; ++dy) {
    for (int dx = 0; dx < c.KW; ++dx) {
      const int off = (dy * c.IW + dx) * c.Cin;
      const float* wt = c.w + (size_t)((dy * c.KW + dx) * c.Cin) * Cout + co;
#pragma unroll 2
      for (int ci = 0; ci < c.Cin; ci += 4) {
        float wv[4][CO];
#pragma unroll
        for (int r = 0; r < 4; ++r) ldg4(wt + (size_t)(ci + r) * Cout, wv[r]);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          float xv[4];
          ld4(c.in + base[j] + off + ci, xv);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int o = 0; o < CO; ++o) acc[j][o] = fmaf(xv[r], wv[r][o], acc[j][o]);
          }
        }
      }
    }
  }
}

enum { STORE, GELU, OUT };

// One stage over an output region of OH x OW pixels whose pixel (0, 0) is
// the image's (gy0, gx0).
//   STORE: out = round(conv_a + bias_a), 0 outside the image      (shared memory)
//   GELU : out = round(gelu(affine_a(lrelu(conv_a + bias_a))
//                           + affine_b(lrelu(conv_b + bias_b)))), 0 outside (shared memory)
//   OUT  : out = round(affine_a(lrelu(conv_a + bias_a))), inside the image only
//          (global memory, `out` at the batch element's pixel (0, 0))
template <int MODE>
__device__ __forceinline__ void stage(const Conv& ca, const Conv& cb, const float* vec,
                                      int bias_a, int aff_a, int bias_b, int aff_b, float* out,
                                      int OH, int OW, int gy0, int gx0, int H, int W, int Cout) {
  const int npix = OH * OW;
  const int ncog = Cout / CO;
  const int items = ((npix + PX - 1) / PX) * ncog;
  for (int item = threadIdx.x; item < items; item += THREADS) {
    const int pg = item / ncog;
    const int co = (item - pg * ncog) * CO;
    int q[PX], gr[PX], gc[PX], base_a[PX], base_b[PX];
    bool inside[PX];
    bool any = false;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      q[j] = min(pg * PX + j, npix - 1);  // a group past the end repeats the last pixel
      const int r = q[j] / OW;
      const int c = q[j] - r * OW;
      gr[j] = gy0 + r;
      gc[j] = gx0 + c;
      inside[j] = gr[j] >= 0 && gr[j] < H && gc[j] >= 0 && gc[j] < W;
      any = any || inside[j];
      base_a[j] = ((r + ca.oy) * ca.IW + (c + ca.ox)) * ca.Cin;
      if (MODE == GELU) base_b[j] = ((r + cb.oy) * cb.IW + (c + cb.ox)) * cb.Cin;
    }
    float res[PX][CO];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
#pragma unroll
      for (int o = 0; o < CO; ++o) res[j][o] = 0.f;
    }
    if (any) {
      float ba[CO];
      ldg4(vec + bias_a * Cout + co, ba);
      conv_acc(res, ca, base_a, Cout, co);
      if (MODE == STORE) {
#pragma unroll
        for (int j = 0; j < PX; ++j) {
#pragma unroll
          for (int o = 0; o < CO; ++o) res[j][o] += ba[o];
        }
      } else {
        float sa[CO], ta[CO];
        ldg4(vec + aff_a * Cout + co, sa);
        ldg4(vec + (aff_a + 1) * Cout + co, ta);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
#pragma unroll
          for (int o = 0; o < CO; ++o) res[j][o] = lrelu(res[j][o] + ba[o]) * sa[o] + ta[o];
        }
      }
      if (MODE == GELU) {
        float acc_b[PX][CO];
#pragma unroll
        for (int j = 0; j < PX; ++j) {
#pragma unroll
          for (int o = 0; o < CO; ++o) acc_b[j][o] = 0.f;
        }
        conv_acc(acc_b, cb, base_b, Cout, co);
        float bb[CO], sb[CO], tb[CO];
        ldg4(vec + bias_b * Cout + co, bb);
        ldg4(vec + aff_b * Cout + co, sb);
        ldg4(vec + (aff_b + 1) * Cout + co, tb);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            const float b = lrelu(acc_b[j][o] + bb[o]) * sb[o] + tb[o];
            res[j][o] = gelu_erf(res[j][o] + b);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      if (pg * PX + j >= npix) continue;
      if (MODE == OUT) {
        if (inside[j]) st4(out + ((size_t)gr[j] * W + gc[j]) * Cout + co, res[j]);
      } else {
        if (!inside[j]) {
#pragma unroll
          for (int o = 0; o < CO; ++o) res[j][o] = 0.f;
        }
        st4(out + (size_t)q[j] * Cout + co, res[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) crosscnn_fused_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout, k = p.k, TH = p.TH, TW = p.TW;
  const int k2 = k / 2, R = k2 + 2;
  const int XH = TH + 2 * R, XW = TW + 2 * R;  // X, and B1's rows
  const int MH = TH + 4, MW = TW + 4;          // A1, B2, and B1's columns
  const int nX = XH * XW * Cin, nM = MH * MW * Cout, nB1 = XH * MW * Cout;
  float* s0 = reinterpret_cast<float*>(smem);
  float* sX = s0;                         // dead once A1 and B1 are formed
  float* sB2 = s0;
  float* sB1 = s0 + (nX > nM ? nX : nM);  // dead once B2 is formed
  float* sG = sB1;
  float* sA1 = sB1 + nB1;

  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const float* xb = static_cast<const float*>(p.x) + (size_t)blockIdx.z * H * W * Cin;
  float* yb = static_cast<float*>(p.y) + (size_t)blockIdx.z * H * W * Cout;

  // stage x with 16-byte loads, zero outside the image
  constexpr int VEC = 4;  // floats of a 16-byte vector
  const int vpp = Cin / VEC;  // vectors per pixel
  for (int i = threadIdx.x; i < XH * XW * vpp; i += THREADS) {
    const int pix = i / vpp;
    const int v = i - pix * vpp;
    const int r = pix / XW;
    const int c = pix - r * XW;
    const int gr = y0 - R + r, gc = x0 - R + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      val = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)gr * W + gc) * Cin) + v);
    reinterpret_cast<uint4*>(sX)[i] = val;
  }
  __syncthreads();

  const float* w = static_cast<const float*>(p.w);
  const float* w121 = w;
  const float* w122 = w121 + (size_t)9 * Cin * Cout;
  const float* w341 = w122 + (size_t)9 * Cout * Cout;
  const float* w342 = w341 + (size_t)k * Cin * Cout;
  const float* w343 = w342 + (size_t)k * Cout * Cout;
  const float* w5 = w343 + (size_t)9 * Cout * Cout;

  const Conv c121{sX, w121, XW, Cin, 3, 3, R - 3, R - 3};
  const Conv c341{sX, w341, XW, Cin, 1, k, 0, 0};
  const Conv c342{sB1, w342, MW, Cout, k, 1, 0, 0};
  const Conv c122{sA1, w122, MW, Cout, 3, 3, 0, 0};
  const Conv c343{sB2, w343, MW, Cout, 3, 3, 0, 0};
  const Conv c5{sG, w5, TW + 2, Cout, 3, 3, 0, 0};

  stage<STORE>(c121, c121, p.vec, B121, 0, 0, 0, sA1, MH, MW, y0 - 2, x0 - 2, H, W, Cout);
  stage<STORE>(c341, c341, p.vec, B341, 0, 0, 0, sB1, XH, MW, y0 - R, x0 - 2, H, W, Cout);
  __syncthreads();
  stage<STORE>(c342, c342, p.vec, B342, 0, 0, 0, sB2, MH, MW, y0 - 2, x0 - 2, H, W, Cout);
  __syncthreads();
  stage<GELU>(c122, c343, p.vec, B122, S12, B343, S34, sG, TH + 2, TW + 2, y0 - 1, x0 - 1, H, W,
              Cout);
  __syncthreads();
  stage<OUT>(c5, c5, p.vec, B5, S5, 0, 0, yb, TH, TW, y0, x0, H, W, Cout);
}

size_t smem_bytes(int TH, int TW, int Cin, int Cout, int k) {
  const long R = k / 2 + 2;
  const long XH = TH + 2 * R, XW = TW + 2 * R, MH = TH + 4, MW = TW + 4;
  const long nX = XH * XW * Cin, nM = MH * MW * Cout, nB1 = XH * MW * Cout;
  return (size_t)((nX > nM ? nX : nM) + nB1 + nM) * sizeof(float);
}

// The largest tile whose buffers fit, shrunk (no further than 4 x 8) while
// the grid has fewer blocks than the card has SMs.
bool choose_tile(int B, int H, int W, int Cin, int Cout, int k, int* th, int* tw) {
  static const int cand[][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 8}, {4, 4}, {2, 4}, {2, 2},
                                {1, 2}, {1, 1}};
  bool found = false;
  for (int i = 0; i < 9; ++i) {
    const int TH = cand[i][0], TW = cand[i][1];
    if (smem_bytes(TH, TW, Cin, Cout, k) > (size_t)SMEM_LIMIT) continue;
    *th = TH;
    *tw = TW;
    found = true;
    const long blocks = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
    if (blocks >= NUM_SMS || i >= 3) break;
  }
  return found;
}

// Opt a kernel in to the full shared memory, once per device, outside any
// stream capture that a later launch may be part of.
template <typename K>
int opt_in_shared_memory(K kernel, bool (&opted)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  return 0;
}

int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.TH, p.TW, p.Cin, p.Cout, p.k);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool opted[64] = {};
  if (int err = opt_in_shared_memory(crosscnn_fused_kernel, opted)) return err;
  dim3 grid((p.W + p.TW - 1) / p.TW, (p.H + p.TH - 1) / p.TH, B);
  crosscnn_fused_kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor cores ---------------------------------------------------------
//
// The same stages over the same buffers, with each conv's per-tap
// [pixels, Cin] x [Cin, Cout] products on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulators).  An M tile is 16
// consecutive pixels of one row of a stage's region, so the output tile is
// 16 j - 4 columns wide (12, 28, 44, 60): then the regions of A1, B1 and B2
// are whole M tiles and those of G and Y waste 2 and 4 columns of their
// last M tile (computed from whatever the buffer holds behind the row, never
// stored).  A warp's item is 2 M tiles x 32 output channels.  A conv is one
// loop over its steps, tap-major ((dy, dx) in order, then 16 input channels
// at a time): a step loads 2 A fragments (ldmatrix.x4) and 4 B fragments,
// and runs 8 MMAs.  The loop loads step s + 1's fragments into a second
// register set before it issues step s's MMAs, and each accumulator takes
// its MMAs in the same order as it would in any other loop over the same
// steps, so the tile, the ring and the block size leave the outputs bitwise
// unchanged.
// A staged pixel's channels are padded by 8 values (stride C + 8): the 8
// rows of an ldmatrix phase then fall into distinct banks.  The epilogue
// runs on the accumulator fragments in registers.
//
// Weights.  At Cout = 32 an item covers every output channel, so when B
// came from global memory every item read its conv's whole weights: 1.7 MB
// of L2 traffic a block at stc_tt's level 0.  The B fragments now come from
// shared memory (ld.shared.v2: the wrapper packs the weights fragment-major,
// [tap][Cin/16][Cout/8][lane][4 values], so a warp reads one fragment as 256
// contiguous bytes, free of bank conflicts), by one of two ways the launch
// picks with the tile:
//   resident: the block copies each stage's weights once, with 16-byte
//     cp.async, into one slot behind the activations (A1 + B1 while x is
//     staged, then B2, then the two of G, then Y), and G's into the free
//     tail of x's buffer while B2 runs, and Y's while G runs, where G's fit
//     there;
//   the ring, for a tile beside which no stage's weights fit (gtc_tb's wide
//     levels: a 3x3 conv at 256 -> 256 is 1.18 MB): the weights stream
//     through two slots of ck steps, every warp of the block in step, one
//     barrier a chunk, the next chunk's copy in flight while one is
//     computed; a stage walks its items in rounds of one item a warp and
//     streams its weights once a round.
// A block has 256 threads with resident weights and 512 with the ring (more
// items a round).  The launch picks the tile and the ring's chunk by an
// estimate of the launch's time: the MMAs of all five stages (halo and
// wasted columns included, items spread over the SM's four schedulers), the
// weight and x bytes a block copies and a ring's waits, times the rounds of
// blocks over the SMs.  Measured on an H100, this kernel does an MMA in
// about 4.4 SM clocks whether B comes from L2 or from shared memory: moving
// the weights into shared memory cut the L2 traffic 13x and the time far
// less.

constexpr int MT = 2;    // M tiles (16 pixels each) of a warp's item
constexpr int NT = 4;    // N tiles (8 output channels each) of a warp's item
constexpr int PADC = 8;  // values added to a staged pixel's channel stride
constexpr int TAIL = 8;  // pixels of slack behind each buffer, read by the wasted columns

typedef __nv_bfloat16 bf16;

struct ConvM {
  const bf16* in;       // staged input [rows][IW][CS]
  const char* wg;       // fragment-major weights of this conv in global memory
  uint32_t ws;          // shared-memory address of their copy (resident weights)
  int IW, CS, Cin, KH, KW, oy, ox;
};

__device__ __forceinline__ int steps_of(const ConvM& c) { return c.KH * c.KW * (c.Cin / 16); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void lds64(uint2& b, uint32_t addr) {
  asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n" : "=r"(b.x), "=r"(b.y) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// 16-byte copies of `bytes` (a multiple of 16) from global to shared memory,
// spread over the block's threads; the caller commits and waits.
template <int NTH>
__device__ __forceinline__ void copy_async(uint32_t dst, const char* src, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += NTH * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + i), "l"(src + i)
                 : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// One step's operands: MT A fragments and NT B fragments.
struct Frags {
  uint32_t a[MT][4];
  uint2 b[NT];
};

__device__ __forceinline__ void load_step(Frags& f, uint32_t in_a, const int (&base)[MT],
                                          int off, uint32_t wb) {
#pragma unroll
  for (int m = 0; m < MT; ++m) ldmatrix_x4(f.a[m], in_a + 2u * (uint32_t)(base[m] + off));
#pragma unroll
  for (int j = 0; j < NT; ++j) lds64(f.b[j], wb + 256u * j);
}

__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const Frags& f) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], f.a[m], f.b[j]);
  }
}

// acc[m][j] += steps s0 .. s1 - 1 of the conv's sum for M tile m (its row 0
// at input offset base[m] for tap 0) and the item's N tile j.  Step s0's B
// fragment of N tile 0 for this lane is at shared address wb, and each
// step's lie `sb` bytes after the last.  Two register sets: step s + 1's
// fragments load while step s's MMAs run.
__device__ __forceinline__ void mma_steps(float (&acc)[MT][NT][4], const ConvM& c,
                                          const int (&base)[MT], int lane, int s0, int s1,
                                          uint32_t wb, int sb) {
  const int kc_n = c.Cin / 16;
  // the row address this lane gives ldmatrix: row (lane % 8) + 8 * ((lane / 8) % 2)
  // of the tile, input channels from 8 * (lane / 16)
  const int lane_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * c.CS + (lane >> 4) * 8;
  const uint32_t in_a = (uint32_t)__cvta_generic_to_shared(c.in) + 2u * (uint32_t)lane_off;
  int kc = s0 % kc_n;
  const int tap = s0 / kc_n;
  int dx = tap % c.KW;
  int off = ((tap / c.KW) * c.IW + dx) * c.CS + kc * 16;  // of tap (dy, dx), channel 16 kc
  auto advance = [&]() {
    if (++kc < kc_n) {
      off += 16;
    } else {
      kc = 0;
      off += c.CS - (kc_n - 1) * 16;
      if (++dx == c.KW) {
        dx = 0;
        off += (c.IW - c.KW) * c.CS;
      }
    }
    wb += sb;
  };
  Frags f0, f1;
  load_step(f0, in_a, base, off, wb);
  for (int s = s0; s < s1; s += 2) {
    const bool two = s + 1 < s1;
    if (two) {
      advance();
      load_step(f1, in_a, base, off, wb);
    }
    mma_step(acc, f0);
    if (!two) break;
    if (s + 2 < s1) {
      advance();
      load_step(f0, in_a, base, off, wb);
    }
    mma_step(acc, f1);
  }
}

// The block's ring: two slots of ck steps each from shared address `base`.
struct Ring {
  int ck;
  uint32_t base;
};

// acc += the whole conv, its weights streamed through the ring: the next
// chunk of ck steps is in flight while one is computed.  Every thread of the
// block calls it (it holds barriers); only warps with `any` compute.
template <int NTH>
__device__ __forceinline__ void ring_pass(float (&acc)[MT][NT][4], const ConvM& c,
                                          const int (&base)[MT], int lane, int nt0, int Cout,
                                          bool any, const Ring& ring) {
  const int S = steps_of(c), ck = ring.ck;
  const int sb = 32 * Cout;  // bytes of one step's B fragments
  const int n = (S + ck - 1) / ck;
  const uint32_t slot = (uint32_t)(ck * sb);
  const uint32_t lane_b = 256u * nt0 + 8u * lane;
  auto issue = [&](int i) {  // chunk i into its slot, one copy group (empty past the end)
    if (i < n) {
      const int s0 = i * ck;
      copy_async<NTH>(ring.base + (uint32_t)(i & 1) * slot, c.wg + (size_t)s0 * sb,
                      (min(s0 + ck, S) - s0) * sb);
    }
    copy_commit();
  };
  __syncthreads();  // every warp is done with every slot
  issue(0);
  for (int i = 0; i < n; ++i) {
    copy_wait();
    __syncthreads();  // chunk i has landed; chunk i - 1's slot is free
    issue(i + 1);
    const int s0 = i * ck;
    if (any)
      mma_steps(acc, c, base, lane, s0, min(s0 + ck, S),
                ring.base + (uint32_t)(i & 1) * slot + lane_b, sb);
  }
}

__device__ __forceinline__ void st2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One stage on the tensor cores; the modes are those of stage().  `out` is
// a staged buffer [OH][OW][out_cs], or for OUT the batch element's y.  With
// ring.ck > 0 the weights stream through the ring, else they are resident
// at ca.ws and cb.ws.
template <int MODE, int NTH>
__device__ __forceinline__ void stage_mma(const ConvM& ca, const ConvM& cb, const float* vec,
                                          int bias_a, int aff_a, int bias_b, int aff_b, bf16* out,
                                          int out_cs, int OH, int OW, int gy0, int gx0, int H,
                                          int W, int Cout, const Ring& ring) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int owt = (OW + 15) / 16, mtot = OH * owt;
  const int ncg = Cout / (8 * NT);
  const int items = ((mtot + MT - 1) / MT) * ncg;
  constexpr int NW = NTH / 32;
  const int rounds = (items + NW - 1) / NW;
  for (int round = 0; round < rounds; ++round) {
    const int item = round * NW + warp;
    if (ring.ck == 0 && item >= items) break;  // the ring's rounds take every warp
    const bool has = item < items;
    const int mg = has ? item / ncg : 0;
    const int co0 = has ? (item - mg * ncg) * (8 * NT) : 0;
    int r[MT], c0[MT], base_a[MT], base_b[MT];
    bool live[MT];
    bool any = false;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      int mt = mg * MT + m;
      live[m] = mt < mtot;
      mt = min(mt, mtot - 1);
      r[m] = mt / owt;
      c0[m] = (mt - r[m] * owt) * 16;
      const int gr = gy0 + r[m], gc = gx0 + c0[m];
      any = any || (has && live[m] && gr >= 0 && gr < H && gc < W && gc + 15 >= 0);
      base_a[m] = ((r[m] + ca.oy) * ca.IW + c0[m] + ca.ox) * ca.CS;
      base_b[m] = MODE == GELU ? ((r[m] + cb.oy) * cb.IW + c0[m] + cb.ox) * cb.CS : 0;
    }
    float acc[MT][NT][4], acc_b[MODE == GELU ? MT : 1][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][j][e] = 0.f;
          if constexpr (MODE == GELU) acc_b[m][j][e] = 0.f;
        }
      }
    }
    const int nt0 = co0 / 8;
    if (ring.ck > 0) {  // uniform over the block
      ring_pass<NTH>(acc, ca, base_a, lane, nt0, Cout, any, ring);
      if constexpr (MODE == GELU) ring_pass<NTH>(acc_b, cb, base_b, lane, nt0, Cout, any, ring);
    } else if (any) {  // uniform over the warp
      const uint32_t lane_b = 256u * nt0 + 8u * lane;
      mma_steps(acc, ca, base_a, lane, 0, steps_of(ca), ca.ws + lane_b, 32 * Cout);
      if constexpr (MODE == GELU)
        mma_steps(acc_b, cb, base_b, lane, 0, steps_of(cb), cb.ws + lane_b, 32 * Cout);
    }
    if (!has) continue;
    // epilogue on the fragments: this lane holds, of M tile m and N tile j,
    // pixels g and g + 8 at channels co0 + 8 j + 2 t and the next
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int co = co0 + 8 * j + 2 * t;
      const float2 ba = __ldg(reinterpret_cast<const float2*>(vec + bias_a * Cout + co));
      float2 sa = make_float2(1.f, 1.f), ta = make_float2(0.f, 0.f);
      float2 bb = ta, sb = sa, tb = ta;
      if (MODE != STORE) {
        sa = __ldg(reinterpret_cast<const float2*>(vec + aff_a * Cout + co));
        ta = __ldg(reinterpret_cast<const float2*>(vec + (aff_a + 1) * Cout + co));
      }
      if (MODE == GELU) {
        bb = __ldg(reinterpret_cast<const float2*>(vec + bias_b * Cout + co));
        sb = __ldg(reinterpret_cast<const float2*>(vec + aff_b * Cout + co));
        tb = __ldg(reinterpret_cast<const float2*>(vec + (aff_b + 1) * Cout + co));
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (!live[m]) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = c0[m] + g + 8 * h;
          if (col >= OW) continue;  // a wasted column of the last M tile
          const int gr = gy0 + r[m], gc = gx0 + col;
          const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
          float v0 = acc[m][j][2 * h] + ba.x, v1 = acc[m][j][2 * h + 1] + ba.y;
          if (MODE != STORE) {
            v0 = lrelu(v0) * sa.x + ta.x;
            v1 = lrelu(v1) * sa.y + ta.y;
          }
          if constexpr (MODE == GELU) {
            v0 = gelu_erf(v0 + (lrelu(acc_b[m][j][2 * h] + bb.x) * sb.x + tb.x));
            v1 = gelu_erf(v1 + (lrelu(acc_b[m][j][2 * h + 1] + bb.y) * sb.y + tb.y));
          }
          if (MODE == OUT) {
            if (inside) st2(out + ((size_t)gr * W + gc) * Cout + co, v0, v1);
          } else {
            if (!inside) v0 = v1 = 0.f;
            st2(out + (size_t)(r[m] * OW + col) * out_cs + co, v0, v1);
          }
        }
      }
    }
  }
}

// Bytes of the bf16 weights of the six convs, in pack order.
struct WeightBytes {
  long w121, w122, w341, w342, w343, w5;
  __host__ __device__ WeightBytes(long Cin, long Cout, long k)
      : w121(9 * Cin * Cout * 2), w122(9 * Cout * Cout * 2), w341(k * Cin * Cout * 2),
        w342(k * Cout * Cout * 2), w343(9 * Cout * Cout * 2), w5(9 * Cout * Cout * 2) {}
  // the largest stage: A1 + B1, B2, G (two convs) or Y
  __host__ __device__ long stage_max() const {
    const long a = w121 + w341, g = w122 + w343;
    return a > w342 ? (a > g ? a : g) : (w342 > g ? w342 : g);
  }
};

template <int NTH>
__global__ void __launch_bounds__(NTH) crosscnn_fused_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout, k = p.k, TH = p.TH, TW = p.TW;
  const int k2 = k / 2, R = k2 + 2;
  const int XH = TH + 2 * R, XW = TW + 2 * R;
  const int MH = TH + 4, MW = TW + 4;
  const int CSi = Cin + PADC, CSo = Cout + PADC;
  const int nX = XH * XW * CSi, nM = MH * MW * CSo, nB1 = XH * MW * CSo;
  bf16* s0 = reinterpret_cast<bf16*>(smem);
  bf16* sX = s0;
  bf16* sB2 = s0;
  bf16* sB1 = s0 + (nX > nM ? nX : nM) + TAIL * (CSi > CSo ? CSi : CSo);
  bf16* sG = sB1;
  bf16* sA1 = sB1 + nB1 + TAIL * CSo;
  // the weight slot (resident) or the ring's two slots, behind the activations
  const uint32_t ws = (uint32_t)__cvta_generic_to_shared(sA1 + nM + TAIL * CSo);
  const int ck = p.ck;
  const Ring ring{ck, ws};

  const WeightBytes wb(Cin, Cout, k);
  const char* w121 = static_cast<const char*>(p.w);
  const char* w122 = w121 + wb.w121;
  const char* w341 = w122 + wb.w122;
  const char* w342 = w341 + wb.w341;
  const char* w343 = w342 + wb.w342;
  const char* w5 = w343 + wb.w343;
  if (ck == 0) {  // A1's and B1's weights, in flight while x is staged
    copy_async<NTH>(ws, w121, (int)wb.w121);
    copy_async<NTH>(ws + (uint32_t)wb.w121, w341, (int)wb.w341);
    copy_commit();
  }

  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const bf16* xb = static_cast<const bf16*>(p.x) + (size_t)blockIdx.z * H * W * Cin;
  bf16* yb = static_cast<bf16*>(p.y) + (size_t)blockIdx.z * H * W * Cout;

  // stage x with 16-byte cp.async, all in flight at once; zero-filled
  // outside the image
  const int vpp = Cin / 8;  // 16-byte vectors per pixel
  const uint32_t sx = (uint32_t)__cvta_generic_to_shared(sX);
  for (int i = threadIdx.x; i < XH * XW * vpp; i += NTH) {
    const int pix = i / vpp;
    const int v = i - pix * vpp;
    const int r = pix / XW;
    const int c = pix - r * XW;
    const int gr = y0 - R + r, gc = x0 - R + c;
    const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
    const bf16* src = inside ? xb + ((size_t)gr * W + gc) * Cin + v * 8 : xb;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     sx + 2u * (uint32_t)(pix * CSi + v * 8)),
                 "l"(src), "r"(inside ? 16 : 0)
                 : "memory");
  }
  copy_commit();
  copy_wait();
  __syncthreads();

  // Resident weights go into the slot once the last stage is done with it,
  // but G's go into the tail of x's buffer where they fit (free once A1
  // and B1 are formed, beyond what B2 writes and G reads there): then G's
  // load during B2 and Y's into the slot during G.
  const int nS0 = (int)(sB1 - s0);
  const bool early = ck == 0 && (long)(nS0 - nM - TAIL * CSo) * 2 >= wb.w122 + wb.w343;
  const uint32_t wg = early ? (uint32_t)__cvta_generic_to_shared(s0 + nM + TAIL * CSo) : ws;
  const uint32_t res2 = ck == 0 ? 1u : 0u;  // resident: a stage's second conv follows its first
  const ConvM c121{sX, w121, ws, XW, CSi, Cin, 3, 3, R - 3, R - 3};
  const ConvM c341{sX, w341, ws + res2 * (uint32_t)wb.w121, XW, CSi, Cin, 1, k, 0, 0};
  const ConvM c342{sB1, w342, ws, MW, CSo, Cout, k, 1, 0, 0};
  const ConvM c122{sA1, w122, wg, MW, CSo, Cout, 3, 3, 0, 0};
  const ConvM c343{sB2, w343, wg + res2 * (uint32_t)wb.w122, MW, CSo, Cout, 3, 3, 0, 0};
  const ConvM c5{sG, w5, ws, TW + 2, CSo, Cout, 3, 3, 0, 0};

  // one stage's resident weights, copied at `at` while nothing else runs
  auto resident = [&](uint32_t at, const char* a, long na, const char* b, long nb) {
    copy_async<NTH>(at, a, (int)na);
    if (nb) copy_async<NTH>(at + (uint32_t)na, b, (int)nb);
    copy_commit();
    copy_wait();
    __syncthreads();
  };

  stage_mma<STORE, NTH>(c121, c121, p.vec, B121, 0, 0, 0, sA1, CSo, MH, MW, y0 - 2, x0 - 2, H,
                            W, Cout, ring);
  stage_mma<STORE, NTH>(c341, c341, p.vec, B341, 0, 0, 0, sB1, CSo, XH, MW, y0 - R, x0 - 2, H,
                            W, Cout, ring);
  __syncthreads();
  if (ck == 0) resident(ws, w342, wb.w342, nullptr, 0);
  if (early) {  // G's weights load while B2 runs
    copy_async<NTH>(wg, w122, (int)wb.w122);
    copy_async<NTH>(wg + (uint32_t)wb.w122, w343, (int)wb.w343);
    copy_commit();
  }
  stage_mma<STORE, NTH>(c342, c342, p.vec, B342, 0, 0, 0, sB2, CSo, MH, MW, y0 - 2, x0 - 2, H,
                            W, Cout, ring);
  copy_wait();
  __syncthreads();
  if (early) {
    copy_async<NTH>(ws, w5, (int)wb.w5);
    copy_commit();
  } else if (ck == 0) {
    resident(ws, w122, wb.w122, w343, wb.w343);
  }
  stage_mma<GELU, NTH>(c122, c343, p.vec, B122, S12, B343, S34, sG, CSo, TH + 2, TW + 2,
                           y0 - 1, x0 - 1, H, W, Cout, ring);
  copy_wait();
  __syncthreads();
  if (ck == 0 && !early) resident(ws, w5, wb.w5, nullptr, 0);
  stage_mma<OUT, NTH>(c5, c5, p.vec, B5, S5, 0, 0, yb, Cout, TH, TW, y0, x0, H, W, Cout, ring);
}

// Shared-memory bytes of the activation buffers.
size_t act_bytes_mma(int TH, int TW, int Cin, int Cout, int k) {
  const long R = k / 2 + 2;
  const long XH = TH + 2 * R, XW = TW + 2 * R, MH = TH + 4, MW = TW + 4;
  const long CSi = Cin + PADC, CSo = Cout + PADC;
  const long nX = XH * XW * CSi, nM = MH * MW * CSo, nB1 = XH * MW * CSo;
  const long n = (nX > nM ? nX : nM) + TAIL * (CSi > CSo ? CSi : CSo) + nB1 + nM + 2 * TAIL * CSo;
  return (size_t)n * sizeof(bf16);
}

// Shared-memory bytes of the weights: the largest stage's (ck = 0), or the
// ring's two slots of ck steps.
size_t weight_bytes_mma(int Cin, int Cout, int k, int ck) {
  return ck > 0 ? (size_t)2 * ck * 32 * Cout : (size_t)WeightBytes(Cin, Cout, k).stage_max();
}

// The tensor cores take Cin a multiple of 16 and Cout of 32 (every model's
// blocks).
bool mma_takes(int Cin, int Cout) { return Cin % 16 == 0 && Cout % (8 * NT) == 0; }

// Threads a block: more warp items a round with the ring.
int threads_mma(int ck) { return ck > 0 ? 512 : 256; }

template <int NTH>
int call_mma(int smem, int* blocks_per_sm, const Params* p, int B, cudaStream_t stream) {
  static bool opted[64] = {};
  if (int err = opt_in_shared_memory(crosscnn_fused_mma_kernel<NTH>, opted)) return err;
  if (blocks_per_sm)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, crosscnn_fused_mma_kernel<NTH>, NTH, smem);
  dim3 grid((p->W + p->TW - 1) / p->TW, (p->H + p->TH - 1) / p->TH, B);
  crosscnn_fused_mma_kernel<NTH><<<grid, NTH, smem, stream>>>(*p);
  return (int)cudaGetLastError();
}

// The blocks an SM holds at `smem` bytes (p null), or the launch of p.
int call_mma(int ck, int smem, int* blocks_per_sm, const Params* p, int B, cudaStream_t stream) {
  return threads_mma(ck) == 512 ? call_mma<512>(smem, blocks_per_sm, p, B, stream)
                                : call_mma<256>(smem, blocks_per_sm, p, B, stream);
}

// A launch's plan: the tile and the ring's ck steps a slot (0: resident
// weights).
struct PlanM {
  int TH, TW, ck;
  size_t smem;
  double cost;
};

// Estimated SM clocks of one block (see the notes above).  Per stage: the
// MMAs of the busiest of the SM's four schedulers, at 4.4 clocks of the SM
// each (measured: this kernel's rate).  Resident weights add their copy,
// exposed, at 24 bytes a clock (an SM's share of L2) and a latency (not G's
// and Y's where they load during the stage before).  The ring takes the
// longer of the MMAs and its copy (once a round), plus a latency a pass and
// 800 clocks a chunk (every warp in step at a barrier: measured, 0.42-0.45
// us a chunk).  x's bytes at 16 a clock.
double block_cost(int TH, int TW, int Cin, int Cout, int k, int ck) {
  constexpr double CLK_MMA = 4.4, LAT = 600.0, L2_BYTES = 24.0, CHUNK = 800.0;
  const int R = k / 2 + 2, NW = threads_mma(ck) / 32;
  const int ncg = Cout / (8 * NT);
  const WeightBytes wb(Cin, Cout, k);
  struct St { int OH, OW, steps, passes; long bytes; };
  const St st[5] = {{TH + 4, TW + 4, 9 * Cin / 16, 1, wb.w121},
                    {TH + 2 * R, TW + 4, k * Cin / 16, 1, wb.w341},
                    {TH + 4, TW + 4, k * Cout / 16, 1, wb.w342},
                    {TH + 2, TW + 2, 18 * Cout / 16, 2, wb.w122 + wb.w343},
                    {TH, TW, 9 * Cout / 16, 1, wb.w5}};
  double clk = (double)(TH + 2 * R) * (TW + 2 * R) * Cin * 2 / 16.0 + LAT;
  // resident: do G's weights load during B2 (and Y's during G)?
  const long XH = TH + 2 * R, XW = TW + 2 * R, CSi = Cin + PADC, CSo = Cout + PADC;
  const long nX = XH * XW * CSi, nM = (TH + 4) * (TW + 4) * CSo;
  const bool early = (nX > nM ? nX : nM) + TAIL * (CSi > CSo ? CSi : CSo) - nM - TAIL * CSo >=
                     (wb.w122 + wb.w343) / 2;
  for (const St& s : st) {
    const int items = ((s.OH * ((s.OW + 15) / 16) + MT - 1) / MT) * ncg;
    const int rounds = (items + NW - 1) / NW;
    const int per_sched = ck > 0 ? rounds * (NW / 4) : (items + 3) / 4;
    const double mma = 4.0 * per_sched * s.steps * MT * NT * CLK_MMA;
    if (ck > 0) {
      const int chunks = s.passes * ((s.steps / s.passes + ck - 1) / ck);
      const double copy = (double)rounds * s.bytes / L2_BYTES;
      clk += (mma > copy ? mma : copy) + rounds * (s.passes * LAT + chunks * CHUNK);
    } else {
      clk += mma + (early && &s >= &st[3] ? 0.0 : s.bytes / L2_BYTES + LAT);
    }
  }
  return clk;
}

// The plan at tile TH x TW with ck ring steps a slot, costed (block_cost x
// rounds of blocks over the SMs), if its buffers fit and an SM holds a block.
bool plan_at(int B, int H, int W, int Cin, int Cout, int k, int TH, int TW, int ck, PlanM* out) {
  if ((H + TH - 1) / TH > 65535) return false;
  const size_t smem = act_bytes_mma(TH, TW, Cin, Cout, k) + weight_bytes_mma(Cin, Cout, k, ck);
  if (smem > (size_t)SMEM_LIMIT) return false;
  int bps = 0;
  if (call_mma(ck, (int)smem, &bps, nullptr, 0, nullptr) || bps < 1) return false;
  const long blocks = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const long waves = (blocks + (long)NUM_SMS * bps - 1) / ((long)NUM_SMS * bps);
  *out = PlanM{TH, TW, ck, smem, (double)waves * bps * block_cost(TH, TW, Cin, Cout, k, ck)};
  return true;
}

// The plan of least estimated time among the tiles (TH rows of 16 j - 4
// columns) whose buffers fit beside resident weights, or else beside a ring.
bool choose_plan_mma(int B, int H, int W, int Cin, int Cout, int k, PlanM* out) {
  static const int rows[] = {1, 2, 4, 8, 12, 16, 24, 32};
  static const int cols[] = {12, 28, 44, 60};
  static const int cks[] = {1, 2, 4, 8, 16, 32};
  const int max_steps = 18 * (Cin > Cout ? Cin : Cout) / 16;  // G's, or more
  bool found = false;
  auto consider = [&](int TH, int TW, int ck) {
    PlanM pl;
    if (!plan_at(B, H, W, Cin, Cout, k, TH, TW, ck, &pl)) return false;
    if (!found || pl.cost < out->cost) *out = pl;
    found = true;
    return true;
  };
  for (int TH : rows) {
    for (int TW : cols) {
      if (consider(TH, TW, 0)) continue;  // a ring only where the weights do not fit
      for (int ck : cks)
        if (ck <= max_steps) consider(TH, TW, ck);
    }
  }
  return found;
}

// choose_plan_mma, remembered by device and shape: the occupancy queries
// stay out of the launches after the first.
bool plan_mma(int B, int H, int W, int Cin, int Cout, int k, PlanM* out) {
  static std::mutex mu;
  static std::map<std::array<int, 7>, PlanM> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  const std::array<int, 7> key{dev, B, H, W, Cin, Cout, k};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  if (!choose_plan_mma(B, H, W, Cin, Cout, k, out)) return false;
  cache.emplace(key, *out);
  return true;
}

bool shape_ok(int B, int H, int W, int Cin, int Cout, int k, int dtype) {
  if (Cin % 8 || Cout % 8 || k < 3 || k % 2 == 0 || B < 1 || H < 1 || W < 1 || B > 65535)
    return false;
  return dtype == 0 || (dtype == 1 && mma_takes(Cin, Cout));
}

int launch_mma(Params p, const PlanM& pl, int B, cudaStream_t stream) {
  p.TH = pl.TH;
  p.TW = pl.TW;
  p.ck = pl.ck;
  return call_mma(pl.ck, (int)pl.smem, nullptr, &p, B, stream);
}

}  // namespace

// The plan the launch would choose: writes (TH, TW, ring steps a slot (0:
// resident weights), threads a block, the shared-memory bytes of the
// weights) to plan[0..4] and returns the block's shared-memory bytes, or -1
// if no plan fits or the type does not take these channel counts.
extern "C" long long tcct_crosscnn_fused_plan(int B, int H, int W, int Cin, int Cout, int k,
                                              int dtype, int* plan) {
  if (dtype == 1) {
    PlanM pl;
    if (!mma_takes(Cin, Cout) || !plan_mma(B, H, W, Cin, Cout, k, &pl)) return -1;
    const int out[5] = {pl.TH, pl.TW, pl.ck, threads_mma(pl.ck),
                        (int)weight_bytes_mma(Cin, Cout, k, pl.ck)};
    for (int i = 0; i < 5; ++i) plan[i] = out[i];
    return (long long)pl.smem;
  }
  if (!choose_tile(B, H, W, Cin, Cout, k, &plan[0], &plan[1])) return -1;
  plan[2] = plan[4] = 0;
  plan[3] = THREADS;
  return (long long)smem_bytes(plan[0], plan[1], Cin, Cout, k);
}

// x [B,H,W,Cin] -> y [B,H,W,Cout], both NHWC in the type `dtype` names
// (0 = float32, 1 = bfloat16) and 16-byte aligned; w the six conv weights in
// that type, in the order block12.0, block12.1, block34.0, block34.1,
// block34.2, block5.0: tap-major [taps][Cin][Cout] in f32, fragment-major
// [taps][Cin/16][Cout/8][lane][4] in bf16; vec the f32 table [12][Cout] of
// their biases in that order, then (scale, shift) of block12, block34 and
// block5.  Cin and Cout are multiples of 8 in f32, of 16 and 32 in bf16; k is
// odd and at least 3.  Returns cudaGetLastError() after the launch.
extern "C" int tcct_crosscnn_fused_fwd(const void* x, const void* w, const float* vec, void* y,
                                       int B, int H, int W, int Cin, int Cout, int k, int dtype,
                                       void* stream) {
  if (!shape_ok(B, H, W, Cin, Cout, k, dtype)) return (int)cudaErrorInvalidValue;
  Params p{x, w, vec, y, H, W, Cin, Cout, k, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    PlanM pl;
    if (!plan_mma(B, H, W, Cin, Cout, k, &pl)) return (int)cudaErrorInvalidValue;
    return launch_mma(p, pl, B, s);
  }
  if (!choose_tile(B, H, W, Cin, Cout, k, &p.TH, &p.TW) || (p.H + p.TH - 1) / p.TH > 65535)
    return (int)cudaErrorInvalidValue;
  return launch(p, B, s);
}

// For tests: tcct_crosscnn_fused_fwd in bf16 at tile TH x TW (TW one of 12,
// 28, 44, 60) with ck ring steps a slot (0: resident weights) in place of
// the launch's own plan.  cudaErrorInvalidValue where that plan does not fit.
extern "C" int tcct_crosscnn_fused_fwd_at(const void* x, const void* w, const float* vec, void* y,
                                          int B, int H, int W, int Cin, int Cout, int k, int TH,
                                          int TW, int ck, void* stream) {
  PlanM pl;
  if (!shape_ok(B, H, W, Cin, Cout, k, 1) || TH < 1 || TW < 12 || TW > 60 || TW % 16 != 12 ||
      ck < 0 || !plan_at(B, H, W, Cin, Cout, k, TH, TW, ck, &pl))
    return (int)cudaErrorInvalidValue;
  Params p{x, w, vec, y, H, W, Cin, Cout, k, 0, 0, 0};
  return launch_mma(p, pl, B, static_cast<cudaStream_t>(stream));
}
