// The implicit-GEMM 3x3 SAME convolution that both conv entry points of the
// port launch (Hopper, sm_90a): csrc/conv_fused.cu (one conv with an
// optional pre-activation) and csrc/stage_fused.cu (a decoder stage's two
// convs).  On NHWC tensors it computes
//
//   h   = relu(x * pre_mul + pre_add)   if a pre-activation is given, else x
//   out = act((conv3x3_same(h, k) + bias) * mul + add)
//
// with the SAME halo zero AFTER the pre-activation (out-of-image taps read 0,
// not relu(pre_add)).  The host folds bias into off = add + bias * mul; act
// is relu or the identity.  The input x is addressed through two options
// that let a decoder stage skip two tensors:
//   - s0 = 1 reads channels [0, C0) through a nearest 2x upsample: the tap at
//     (iy, ix) of the H x W image reads x0[iy >> 1, ix >> 1], so the
//     upsampled tensor never exists in device memory;
//   - C1 > 0 reads channels [C0, C0 + C1) from a second base pointer x1, so
//     concat[x0, x1] never exists either.
//
// Design: an implicit GEMM with M = N*H*W output pixels, N_gemm = F output
// channels and K = 9*C (tap-major, then channel), so the HWIO kernel
// (3, 3, C, F) is the row-major K x F operand as it is stored.  Each block
// owns a 128-pixel x 64-channel output tile and walks K in 32-deep chunks
// (one tap, 32 channels at a time).  The input window is gathered straight
// from the NHWC activation (no im2col in device memory), the pre-activation
// is applied on the way into shared memory, and the tiles are double
// buffered through registers so the next chunk's global loads are in flight
// while the tensor cores work on the current one.
//
// What bounds it on the H100: at the model's shapes (C up to 1344, F up to
// 320) the convs are compute-bound (hundreds of FLOP per byte), so the bf16
// path runs on the tensor cores (mma.sync m16n8k16, f32 accumulation,
// ldmatrix fragment loads from padded, bank-conflict-free shared tiles).
// The dense layers' F=32 convs fill half of a 64-wide tile.  Every tap is
// computed, also the ones an upsample makes equal; wgmma/TMA pipelines are
// the next step and are not used here.
//
// The f32 path is a plain FMA tiled kernel that exists for tight parity
// checks; it is not on the bf16 main path.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Geom {
  const void* x0;     // channels [0, C0): (N, H >> s0, W >> s0, C0)
  const void* x1;     // channels [C0, C): (N, H, W, C1), or null if C1 == 0
  const void* w;      // (3, 3, C, F) kernel in the activation's type
  const float* mul;   // (F,) epilogue scale
  const float* off;   // (F,) epilogue offset (add + bias * mul)
  const void* pm;     // (C,) pre-activation scale or null, activation type
  const void* pa;     // (C,) pre-activation offset or null, activation type
  void* out;          // (N, H, W, F), activation type
  long long M;        // N * H * W
  int H, W;           // output (and convolution) extent
  int C0, C1, C, F;   // C = C0 + C1
  int s0;             // 1: x0 is read through a nearest 2x upsample
  int relu;
};

// ----------------------------------------------------------------- bf16 path

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int A_STRIDE = BK + 8;  // 80-byte rows: ldmatrix reads conflict-free
constexpr int B_STRIDE = BN + 8;  // 144-byte rows

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const bf16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// relu(bf16(bf16(v * pm) + pa)): the same two roundings as the bf16
// elementwise x * pre_mul + pre_add of the plain version.
__device__ __forceinline__ bf16 pre_act(bf16 v, bf16 pm, bf16 pa) {
  float t = __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(v) * __bfloat162float(pm)));
  t = __bfloat162float(__float2bfloat16_rn(t + __bfloat162float(pa)));
  return __float2bfloat16_rn(fmaxf(t, 0.0f));
}

// Output pixel of one row of the tile: image index and (y, x).
struct Pix {
  long long n;  // image index, or -1 past the end of M
  int y, x;
};

__device__ __forceinline__ Pix decode(const Geom& g, long long m) {
  Pix p;
  if (m >= g.M) {
    p.n = -1;
    p.y = p.x = 0;
    return p;
  }
  const long long hw = (long long)g.H * g.W;
  p.n = m / hw;
  const int rem = (int)(m - p.n * hw);
  p.y = rem / g.W;
  p.x = rem - p.y * g.W;
  return p;
}

// Address of input channel c at tap (dy, dx) of pixel p, or null where the
// tap reads the zero halo or c is past the last channel.
template <typename T>
__device__ __forceinline__ const T* tap_ptr(const Geom& g, const Pix& p,
                                            int dy, int dx, int c) {
  if (p.n < 0 || c >= g.C) return nullptr;
  const int iy = p.y + dy - 1;
  const int ix = p.x + dx - 1;
  if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return nullptr;
  if (c < g.C0) {
    const int hs = g.H >> g.s0;
    const int ws = g.W >> g.s0;
    const long long pix = (p.n * hs + (iy >> g.s0)) * ws + (ix >> g.s0);
    return static_cast<const T*>(g.x0) + pix * g.C0 + c;
  }
  const long long pix = (p.n * g.H + iy) * g.W + ix;
  return static_cast<const T*>(g.x1) + pix * g.C1 + (c - g.C0);
}

// VEC: C0, C1 and F are multiples of 8 and the pointers 16-byte aligned, so
// every thread moves whole 16-byte vectors of 8 channels, and no vector
// straddles the two sources.  Otherwise one element at a time.
template <bool VEC>
struct Stage;

template <>
struct Stage<true> {
  uint4 a[2];  // A: rows (t>>2) and (t>>2)+64, channels (t&3)*8 .. +8
  uint4 b;     // B: k row t>>3, channels (t&7)*8 .. +8
  Pix pix[2];

  __device__ void init(const Geom& g, long long m0) {
    const int t = threadIdx.x;
    pix[0] = decode(g, m0 + (t >> 2));
    pix[1] = decode(g, m0 + (t >> 2) + 64);
  }

  __device__ void load(const Geom& g, int tap, int c0, int f0) {
    const int t = threadIdx.x;
    const int dy = tap / 3, dx = tap % 3;
    const int c = c0 + (t & 3) * 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a[r] = make_uint4(0, 0, 0, 0);
      const bf16* src = tap_ptr<bf16>(g, pix[r], dy, dx, c);
      if (src != nullptr) {
        a[r] = *reinterpret_cast<const uint4*>(src);
        if (g.pm != nullptr) {
          const uint4 pm = *reinterpret_cast<const uint4*>(
              static_cast<const bf16*>(g.pm) + c);
          const uint4 pa = *reinterpret_cast<const uint4*>(
              static_cast<const bf16*>(g.pa) + c);
          bf16* v = reinterpret_cast<bf16*>(&a[r]);
          const bf16* vm = reinterpret_cast<const bf16*>(&pm);
          const bf16* va = reinterpret_cast<const bf16*>(&pa);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = pre_act(v[j], vm[j], va[j]);
        }
      }
    }
    const int kk = t >> 3;
    const int f = f0 + (t & 7) * 8;
    b = make_uint4(0, 0, 0, 0);
    if (c0 + kk < g.C && f < g.F) {
      const long long o = ((long long)tap * g.C + c0 + kk) * g.F + f;
      b = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.w) + o);
    }
  }

  __device__ void store(bf16* As, bf16* Bs) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint4*>(As + ((t >> 2) + r * 64) * A_STRIDE +
                                (t & 3) * 8) = a[r];
    *reinterpret_cast<uint4*>(Bs + (t >> 3) * B_STRIDE + (t & 7) * 8) = b;
  }
};

template <>
struct Stage<false> {
  bf16 a[16];  // A: rows i*8 + (t>>5), channel t&31
  bf16 b[8];   // B: k rows i*4 + (t>>6), channel t&63
  long long m0;

  __device__ void init(const Geom&, long long m0_) { m0 = m0_; }

  __device__ void load(const Geom& g, int tap, int c0, int f0) {
    const int t = threadIdx.x;
    const int dy = tap / 3, dx = tap % 3;
    const int c = c0 + (t & 31);
    const bf16 zero = __float2bfloat16_rn(0.0f);
    const bf16* pm = static_cast<const bf16*>(g.pm);
    const bf16* pa = static_cast<const bf16*>(g.pa);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bf16* src =
          tap_ptr<bf16>(g, decode(g, m0 + i * 8 + (t >> 5)), dy, dx, c);
      a[i] = src == nullptr ? zero
             : pm != nullptr ? pre_act(*src, pm[c], pa[c])
                             : *src;
    }
    const int f = f0 + (t & 63);
    const bf16* w = static_cast<const bf16*>(g.w);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ck = c0 + i * 4 + (t >> 6);
      b[i] = (ck < g.C && f < g.F)
                 ? w[((long long)tap * g.C + ck) * g.F + f]
                 : zero;
    }
  }

  __device__ void store(bf16* As, bf16* Bs) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      As[(i * 8 + (t >> 5)) * A_STRIDE + (t & 31)] = a[i];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      Bs[(i * 4 + (t >> 6)) * B_STRIDE + (t & 63)] = b[i];
  }
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_bf16(Geom g) {
  __shared__ __align__(16) bf16 As[2][BM * A_STRIDE];
  __shared__ __align__(16) bf16 Bs[2][BK * B_STRIDE];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;   // 4 warps along M, 32 rows each
  const int wn = warp >> 2;  // 2 warps along F, 32 channels each
  const int nF = (g.F + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / nF) * BM;
  const int f0 = (int)(blockIdx.x % nF) * BN;
  const int cchunks = (g.C + BK - 1) / BK;
  const int KT = 9 * cchunks;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  Stage<VEC> st;
  st.init(g, m0);
  st.load(g, 0, 0, f0);
  st.store(As[0], Bs[0]);
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT)
      st.load(g, (kt + 1) / cchunks, ((kt + 1) % cchunks) * BK, f0);

#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4];
      uint32_t bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], &As[cur][(wm * 32 + i * 16 + (lane & 15)) * A_STRIDE +
                                ks + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_trans(bfr[2 * j][0], bfr[2 * j][1], bfr[2 * j + 1][0],
                      bfr[2 * j + 1][1],
                      &Bs[cur][(ks + (lane & 15)) * B_STRIDE + wn * 32 +
                               j * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }

    if (kt + 1 < KT) st.store(As[cur ^ 1], Bs[cur ^ 1]);
    __syncthreads();
  }

  // epilogue: y * mul + off, optional relu, one bf16 rounding
  const int gid = lane >> 2;
  const int tig = lane & 3;
  bf16* out = static_cast<bf16*>(g.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 32 + i * 16 + gid + half * 8;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = f0 + wn * 32 + j * 8 + tig * 2 + e;
          if (f >= g.F) continue;
          float v = acc[i][j][half * 2 + e] * g.mul[f] + g.off[f];
          if (g.relu) v = fmaxf(v, 0.0f);
          out[m * g.F + f] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ f32 path

constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;

__global__ void __launch_bounds__(256) conv3x3_f32(Geom g) {
  __shared__ float As[FK][FM];
  __shared__ float Bs[FK][FN];

  const int t = threadIdx.x;
  const int nF = (g.F + FN - 1) / FN;
  const long long m0 = (long long)(blockIdx.x / nF) * FM;
  const int f0 = (int)(blockIdx.x % nF) * FN;
  const int tm = t >> 4;  // 16 x 16 threads, 4 x 4 outputs each
  const int tn = t & 15;
  const float* w = static_cast<const float*>(g.w);
  const float* pm = static_cast<const float*>(g.pm);
  const float* pa = static_cast<const float*>(g.pa);
  const int cchunks = (g.C + FK - 1) / FK;

  float acc[4][4] = {};
  for (int kt = 0; kt < 9 * cchunks; ++kt) {
    const int tap = kt / cchunks;
    const int c0 = (kt % cchunks) * FK;
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i * 16 + (t >> 4);
      const int c = c0 + (t & 15);
      const float* src = tap_ptr<float>(g, decode(g, m0 + row), dy, dx, c);
      float v = 0.0f;
      if (src != nullptr) {
        v = *src;
        if (pm != nullptr)
          v = fmaxf(__fadd_rn(__fmul_rn(v, pm[c]), pa[c]), 0.0f);
      }
      As[t & 15][row] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = i * 4 + (t >> 6);
      const int f = f0 + (t & 63);
      Bs[kk][t & 63] = (c0 + kk < g.C && f < g.F)
                           ? w[((long long)tap * g.C + c0 + kk) * g.F + f]
                           : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][tm * 4 + r];
#pragma unroll
      for (int s = 0; s < 4; ++s) b[s] = Bs[kk][tn * 4 + s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(g.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + tm * 4 + r;
    if (m >= g.M) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int f = f0 + tn * 4 + s;
      if (f >= g.F) continue;
      float v = acc[r][s] * g.mul[f] + g.off[f];
      if (g.relu) v = fmaxf(v, 0.0f);
      out[m * g.F + f] = v;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One convolution: checks the geometry, picks the path and launches it on
// `s`.  Returns cudaGetLastError() (0 = launched).
int launch_conv3x3(const Geom& g, bool is_bf16, cudaStream_t s) {
  if (g.M <= 0 || g.C0 <= 0 || g.C1 < 0 || g.C != g.C0 + g.C1 || g.F <= 0 ||
      (g.C1 > 0) != (g.x1 != nullptr) || (g.pm == nullptr) != (g.pa == nullptr))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const long long blocks = ((g.M + BM - 1) / BM) * ((g.F + BN - 1) / BN);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const bool vec = g.C0 % 8 == 0 && g.C1 % 8 == 0 && g.F % 8 == 0 &&
                     aligned16(g.x0) && (g.x1 == nullptr || aligned16(g.x1)) &&
                     aligned16(g.w) &&
                     (g.pm == nullptr || (aligned16(g.pm) && aligned16(g.pa)));
    if (vec)
      conv3x3_bf16<true><<<(unsigned)blocks, THREADS, 0, s>>>(g);
    else
      conv3x3_bf16<false><<<(unsigned)blocks, THREADS, 0, s>>>(g);
  } else {
    const long long blocks = ((g.M + FM - 1) / FM) * ((g.F + FN - 1) / FN);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    conv3x3_f32<<<(unsigned)blocks, 256, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}

}  // namespace
