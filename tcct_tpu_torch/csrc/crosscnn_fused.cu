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
// 12 or 28 columns wide: then the regions of A1, B1 and B2 are 16 or 32
// columns and those of G and Y waste 2 and 4 columns of their last M tile
// (computed from whatever the buffer holds behind the row, never stored).
// A warp's item is 2 M tiles x 32 output channels: per 16 input channels of
// a tap it loads 2 A fragments from shared memory (ldmatrix.x4) and 4 B
// fragments from the weights, which the wrapper packs fragment-major
// ([tap][Cin/16][Cout/8][lane][4 values]) so that a warp reads one fragment
// as 256 contiguous bytes through the read-only cache, and runs 8 MMAs.
// A staged pixel's channels are padded by 8 values (stride C + 8): the 8
// rows of an ldmatrix phase then fall into distinct banks.  The epilogue
// runs on the accumulator fragments in registers.

constexpr int MT = 2;    // M tiles (16 pixels each) of a warp's item
constexpr int NT = 4;    // N tiles (8 output channels each) of a warp's item
constexpr int PADC = 8;  // values added to a staged pixel's channel stride
constexpr int TAIL = 8;  // pixels of slack behind each buffer, read by the wasted columns

typedef __nv_bfloat16 bf16;

struct ConvM {
  const bf16* in;  // staged input [rows][IW][CS]
  const bf16* wf;  // fragment-major weights of this conv
  int IW, CS, Cin, KH, KW, oy, ox;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc[m][j] += the conv's sum for M tile m (its row 0 at input offset
// base[m] for tap 0) and N tile nt0 + j, over all taps and input channels.
__device__ __forceinline__ void conv_mma(float (&acc)[MT][NT][4], const ConvM& c,
                                         const int (&base)[MT], int nt_total, int nt0, int lane) {
  const int kc_n = c.Cin / 16;
  // the row address this lane gives ldmatrix: row (lane % 8) + 8 * ((lane / 8) % 2)
  // of the tile, input channels from 8 * (lane / 16)
  const int lane_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * c.CS + (lane >> 4) * 8;
  const uint32_t in_s = (uint32_t)__cvta_generic_to_shared(c.in);
  for (int dy = 0; dy < c.KH; ++dy) {
    for (int dx = 0; dx < c.KW; ++dx) {
      const int off = (dy * c.IW + dx) * c.CS + lane_off;
      const uint2* wt = reinterpret_cast<const uint2*>(c.wf) +
                        ((size_t)(dy * c.KW + dx) * kc_n * nt_total + nt0) * 32 + lane;
#pragma unroll 2
      for (int kc = 0; kc < kc_n; ++kc) {
        uint2 b[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) b[j] = __ldg(wt + ((size_t)kc * nt_total + j) * 32);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          ldmatrix_x4(a, in_s + 2u * (uint32_t)(base[m] + off + kc * 16));
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a, b[j]);
        }
      }
    }
  }
}

__device__ __forceinline__ void st2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One stage on the tensor cores; the modes are those of stage().  `out` is
// a staged buffer [OH][OW][out_cs], or for OUT the batch element's y.
template <int MODE, int NTH>
__device__ __forceinline__ void stage_mma(const ConvM& ca, const ConvM& cb, const float* vec,
                                          int bias_a, int aff_a, int bias_b, int aff_b, bf16* out,
                                          int out_cs, int OH, int OW, int gy0, int gx0, int H,
                                          int W, int Cout) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int owt = (OW + 15) / 16, mtot = OH * owt;
  const int ncg = Cout / (8 * NT);
  const int items = ((mtot + MT - 1) / MT) * ncg;
  for (int item = warp; item < items; item += NTH / 32) {
    const int mg = item / ncg;
    const int co0 = (item - mg * ncg) * (8 * NT);
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
      any = any || (live[m] && gr >= 0 && gr < H && gc < W && gc + 15 >= 0);
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
    if (any) {  // uniform over the warp
      conv_mma(acc, ca, base_a, Cout / 8, co0 / 8, lane);
      if constexpr (MODE == GELU) conv_mma(acc_b, cb, base_b, Cout / 8, co0 / 8, lane);
    }
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

// NTH threads: 512 where a stage has items for 16 warps, else 256
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

  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const bf16* xb = static_cast<const bf16*>(p.x) + (size_t)blockIdx.z * H * W * Cin;
  bf16* yb = static_cast<bf16*>(p.y) + (size_t)blockIdx.z * H * W * Cout;

  const int vpp = Cin / 8;  // 16-byte vectors per pixel
  for (int i = threadIdx.x; i < XH * XW * vpp; i += NTH) {
    const int pix = i / vpp;
    const int v = i - pix * vpp;
    const int r = pix / XW;
    const int c = pix - r * XW;
    const int gr = y0 - R + r, gc = x0 - R + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      val = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)gr * W + gc) * Cin) + v);
    *reinterpret_cast<uint4*>(sX + (size_t)pix * CSi + v * 8) = val;
  }
  __syncthreads();

  const bf16* w = static_cast<const bf16*>(p.w);
  const bf16* w121 = w;
  const bf16* w122 = w121 + (size_t)9 * Cin * Cout;
  const bf16* w341 = w122 + (size_t)9 * Cout * Cout;
  const bf16* w342 = w341 + (size_t)k * Cin * Cout;
  const bf16* w343 = w342 + (size_t)k * Cout * Cout;
  const bf16* w5 = w343 + (size_t)9 * Cout * Cout;

  const ConvM c121{sX, w121, XW, CSi, Cin, 3, 3, R - 3, R - 3};
  const ConvM c341{sX, w341, XW, CSi, Cin, 1, k, 0, 0};
  const ConvM c342{sB1, w342, MW, CSo, Cout, k, 1, 0, 0};
  const ConvM c122{sA1, w122, MW, CSo, Cout, 3, 3, 0, 0};
  const ConvM c343{sB2, w343, MW, CSo, Cout, 3, 3, 0, 0};
  const ConvM c5{sG, w5, TW + 2, CSo, Cout, 3, 3, 0, 0};

  stage_mma<STORE, NTH>(c121, c121, p.vec, B121, 0, 0, 0, sA1, CSo, MH, MW, y0 - 2, x0 - 2, H, W, Cout);
  stage_mma<STORE, NTH>(c341, c341, p.vec, B341, 0, 0, 0, sB1, CSo, XH, MW, y0 - R, x0 - 2, H, W, Cout);
  __syncthreads();
  stage_mma<STORE, NTH>(c342, c342, p.vec, B342, 0, 0, 0, sB2, CSo, MH, MW, y0 - 2, x0 - 2, H, W, Cout);
  __syncthreads();
  stage_mma<GELU, NTH>(c122, c343, p.vec, B122, S12, B343, S34, sG, CSo, TH + 2, TW + 2, y0 - 1,
                  x0 - 1, H, W, Cout);
  __syncthreads();
  stage_mma<OUT, NTH>(c5, c5, p.vec, B5, S5, 0, 0, yb, Cout, TH, TW, y0, x0, H, W, Cout);
}

size_t smem_bytes_mma(int TH, int TW, int Cin, int Cout, int k) {
  const long R = k / 2 + 2;
  const long XH = TH + 2 * R, XW = TW + 2 * R, MH = TH + 4, MW = TW + 4;
  const long CSi = Cin + PADC, CSo = Cout + PADC;
  const long nX = XH * XW * CSi, nM = MH * MW * CSo, nB1 = XH * MW * CSo;
  const long n = (nX > nM ? nX : nM) + TAIL * (CSi > CSo ? CSi : CSo) + nB1 + nM + 2 * TAIL * CSo;
  return (size_t)n * sizeof(bf16);
}

// The tensor cores take Cin a multiple of 16 and Cout of 32 (every model's
// blocks), and tiles 12 or 28 columns wide: a region of TW + 4 columns is
// whole M tiles.
bool mma_takes(int Cin, int Cout) { return Cin % 16 == 0 && Cout % (8 * NT) == 0; }

bool choose_tile_mma(int B, int H, int W, int Cin, int Cout, int k, int* th, int* tw) {
  static const int cand[][2] = {{16, 28}, {8, 28}, {16, 12}, {8, 12}, {4, 12}, {2, 12}, {1, 12}};
  bool found = false;
  for (int i = 0; i < 7; ++i) {
    const int TH = cand[i][0], TW = cand[i][1];
    if (smem_bytes_mma(TH, TW, Cin, Cout, k) > (size_t)SMEM_LIMIT) continue;
    *th = TH;
    *tw = TW;
    found = true;
    const long blocks = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
    if (blocks >= NUM_SMS || i >= 4) break;
  }
  return found;
}

template <int NTH>
int launch_mma_threads(const Params& p, int B, size_t smem, cudaStream_t stream) {
  static bool opted[64] = {};
  if (int err = opt_in_shared_memory(crosscnn_fused_mma_kernel<NTH>, opted)) return err;
  dim3 grid((p.W + p.TW - 1) / p.TW, (p.H + p.TH - 1) / p.TH, B);
  crosscnn_fused_mma_kernel<NTH><<<grid, NTH, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_mma(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes_mma(p.TH, p.TW, p.Cin, p.Cout, p.k);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // the items of the A1 stage, one of the two smallest besides Y's
  const int items = (((p.TH + 4) * ((p.TW + 4) / 16) + MT - 1) / MT) * (p.Cout / (8 * NT));
  return items >= 12 ? launch_mma_threads<512>(p, B, smem, stream)
                     : launch_mma_threads<256>(p, B, smem, stream);
}

}  // namespace

// The tile the launch would choose: writes tile[0] = TH and tile[1] = TW and
// returns the block's shared-memory bytes, or -1 if no tile fits or the type
// does not take these channel counts.
extern "C" long long tcct_crosscnn_fused_tile(int B, int H, int W, int Cin, int Cout, int k,
                                              int dtype, int* tile) {
  if (dtype == 1) {
    if (!mma_takes(Cin, Cout) || !choose_tile_mma(B, H, W, Cin, Cout, k, &tile[0], &tile[1]))
      return -1;
    return (long long)smem_bytes_mma(tile[0], tile[1], Cin, Cout, k);
  }
  if (!choose_tile(B, H, W, Cin, Cout, k, &tile[0], &tile[1])) return -1;
  return (long long)smem_bytes(tile[0], tile[1], Cin, Cout, k);
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
  if (Cin % 8 || Cout % 8 || k < 3 || k % 2 == 0 || B < 1 || H < 1 || W < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !mma_takes(Cin, Cout)) return (int)cudaErrorInvalidValue;
  Params p{x, w, vec, y, H, W, Cin, Cout, k, 0, 0};
  const bool ok = dtype == 1 ? choose_tile_mma(B, H, W, Cin, Cout, k, &p.TH, &p.TW)
                             : choose_tile(B, H, W, Cin, Cout, k, &p.TH, &p.TW);
  if (!ok || (p.H + p.TH - 1) / p.TH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_mma(p, B, s) : launch(p, B, s);
}
