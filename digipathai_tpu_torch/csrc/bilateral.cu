// Truncated-window bilateral message of the mean-field CRF, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// digipathai_tpu/ops/pallas/bilateral.py::bilateral_message_pallas (a Pallas
// row-strip kernel for L = 2).  For q (H, W, L) and image (H, W, 3), both f32
// and pixel-major, every output pixel p gets
//
//   out[p, l] = sum_s w(p, s) q[p + s, l] / max(sum_s w(p, s), 1e-12)
//   w(p, s)   = exp(-|s|^2 / (2 sxy^2) - |I[p] - I[p + s]|^2 / (2 srgb^2))
//
// over the shifts s = (dy, dx), |dy|, |dx| <= r, s != 0.  Neighbours outside
// the image get w = 0, so borders normalise over their true neighbourhood.
// A pixel whose weights all underflow gets 0, as in the plain version.  Image
// values far from any colour (the CRF's bucket-pad sentinel) make every
// weight that involves them exactly 0.0f, never NaN.
//
// What bounds it on the H100: instruction issue.  Every (pixel, shift) pair
// needs one exponential and a dozen f32 operations, while the arrays are
// read about once (at 1024^2 and r = 10: 457 M pairs against 28 MB).  The
// design spends as few instructions per pair as it can:
//
// - Register-blocked outputs.  A block stages the (TH + 2r) x (32 + 2r) halo
//   of its 32 x TH outputs in shared memory: one float4 (r, g, b, q[l0]) per
//   cell, then the other labels of the launch as planes.  A thread owns K
//   consecutive rows of one column and walks its halo column once per dx;
//   each neighbour it loads serves every one of its outputs within r rows
//   from registers.  A warp's lanes read 32 consecutive cells: no bank
//   conflicts.
// - One ex2 per pair.  The host folds log2(e) and both 1 / (2 sigma^2) into
//   a = log2(e) / (2 sxy^2) and cs = sqrt(log2(e) / (2 srgb^2)) (> 0); the
//   halo's colours are staged times cs, so the exponent is three FMAs on
//   the colour differences, T - d0^2 - d1^2 - d2^2, started from the
//   spatial term T = -a (dy^2 + dx^2).  T comes from a per-dx table in
//   registers (radius a template parameter, the loops unrolled) or, for
//   any other radius, is computed per pair.  ex2.approx.ftz has a relative
//   error near 2^-22.  A pair costs 3 FADD, 3 FFMA, one MUFU.EX2, then one
//   FADD and L FFMA to accumulate.
// - No validity test on the hot loop.  Out-of-image cells are staged with
//   colour +inf and q = 0: |dI|^2 is +inf for every finite centre colour
//   (the 1e6 sentinel included), the exponent -inf, and ex2(-inf) = +0.
//   The self term takes T = -inf the same way.
//
// The tile (K, rows of warps, the compiled radius) comes from the host
// (ops/bilateral.py::plan_bilateral): two blocks fit an SM up to r = 20, and
// K = 4 (K = 2 on a grid too small to give every SM a block).

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;  // block tile width: one warp's lanes, one column each

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Adds the neighbour (n, nq) with spatial term t to output k.
template <int NL>
__device__ __forceinline__ void accumulate(const float4& n, const float* nq,
                                          float t, float c0, float c1,
                                          float c2, float& den, float* num) {
  const float d0 = c0 - n.x;
  const float d1 = c1 - n.y;
  const float d2 = c2 - n.z;
  const float wgt = ex2(fmaf(-d2, d2, fmaf(-d1, d1, fmaf(-d0, d0, t))));
  den += wgt;
#pragma unroll
  for (int l = 0; l < NL; ++l) num[l] = fmaf(wgt, nq[l], num[l]);
}

// NL labels per launch; each thread K output rows; WARPS rows of warps; R the
// radius unrolled at compile time, or 0 for a radius given at run time.
template <int NL, int K, int WARPS, int R>
__global__ void __launch_bounds__(TW * WARPS, 2)
    bilateral_kernel(const float* __restrict__ q, const float* __restrict__ img,
                     float* __restrict__ out, int H, int W, int L, int l0,
                     int r_arg, float a, float cs) {
  constexpr int TH = K * WARPS;
  const float inf = __int_as_float(0x7f800000);
  const int r = R > 0 ? R : r_arg;
  const int hw = TW + 2 * r;  // halo tile width
  const int cells = hw * (TH + 2 * r);
  extern __shared__ float4 smem[];
  float4* s_c = smem;                          // (r, g, b) * cs, q[l0]
  float* s_q = reinterpret_cast<float*>(smem + cells);     // NL - 1 planes

  const int bx0 = blockIdx.x * TW;
  const int by0 = blockIdx.y * TH;
  for (int i = threadIdx.y * TW + threadIdx.x; i < cells; i += TW * WARPS) {
    const int gy = by0 - r + i / hw;
    const int gx = bx0 - r + i % hw;
    float4 v = make_float4(inf, inf, inf, 0.0f);
    float qs[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) qs[l] = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t p = (size_t)gy * W + gx;
      v = make_float4(img[3 * p] * cs, img[3 * p + 1] * cs,
                      img[3 * p + 2] * cs, 0.0f);
#pragma unroll
      for (int l = 0; l < NL; ++l) qs[l] = q[p * L + l0 + l];
    }
    v.w = qs[0];
    s_c[i] = v;
#pragma unroll
    for (int l = 1; l < NL; ++l) s_q[(l - 1) * cells + i] = qs[l];
  }
  __syncthreads();

  // this thread's outputs: column bx0 + tx, rows by0 + ty K + k
  const int tx = threadIdx.x;
  const int row0 = threadIdx.y * K;  // halo row of the first neighbour row
  float c0[K], c1[K], c2[K], den[K], num[K][NL];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 v = s_c[(row0 + k + r) * hw + tx + r];
    c0[k] = v.x;
    c1[k] = v.y;
    c2[k] = v.z;
    den[k] = 0.0f;
#pragma unroll
    for (int l = 0; l < NL; ++l) num[k][l] = 0.0f;
  }

#pragma unroll 1
  for (int dx = -r; dx <= r; ++dx) {
    const float sx = -a * (float)(dx * dx);
    const int base = row0 * hw + tx + r + dx;  // neighbour row 0, this column
    if constexpr (R > 0) {
      // T[|dy|]; the self term (dy = dx = 0) gets -inf
      float T[R + 1];
      T[0] = dx == 0 ? -inf : sx;
#pragma unroll
      for (int d = 1; d <= R; ++d) T[d] = fmaf(-(float)(d * d), a, sx);
#pragma unroll
      for (int j = 0; j < K + 2 * R; ++j) {
        const int c = base + j * hw;
        const float4 n = s_c[c];
        float nq[NL];
        nq[0] = n.w;
#pragma unroll
        for (int l = 1; l < NL; ++l) nq[l] = s_q[(l - 1) * cells + c];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int dy = j - k - R;
          if (dy < -R || dy > R) continue;
          accumulate<NL>(n, nq, T[dy < 0 ? -dy : dy], c0[k], c1[k], c2[k],
                         den[k], num[k]);
        }
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < K + 2 * r; ++j) {
        const int c = base + j * hw;
        const float4 n = s_c[c];
        float nq[NL];
        nq[0] = n.w;
#pragma unroll
        for (int l = 1; l < NL; ++l) nq[l] = s_q[(l - 1) * cells + c];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int dy = j - k - r;
          if (dy < -r || dy > r) continue;
          const float t =
              (dy == 0 && dx == 0) ? -inf : fmaf(-(float)(dy * dy), a, sx);
          accumulate<NL>(n, nq, t, c0[k], c1[k], c2[k], den[k], num[k]);
        }
      }
    }
  }

  const int x = bx0 + tx;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int y = by0 + row0 + k;
    if (x < W && y < H) {
      const float d = fmaxf(den[k], 1e-12f);
      const size_t p = ((size_t)y * W + x) * L + l0;
#pragma unroll
      for (int l = 0; l < NL; ++l) out[p + l] = num[k][l] / d;
    }
  }
}

template <int NL, int K, int WARPS, int R>
int launch(const float* q, const float* img, float* out, int h, int w, int L,
           int l0, int r, float a, float cs, cudaStream_t s) {
  constexpr int TH = K * WARPS;
  const size_t cells = (size_t)(TW + 2 * r) * (TH + 2 * r);
  const size_t smem = cells * sizeof(float) * (3 + NL);
  if (smem > 232448 || (h + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  // per device, and cheap: set on every launch (two threads may launch on
  // two devices)
  cudaError_t e = cudaFuncSetAttribute(
      bilateral_kernel<NL, K, WARPS, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  dim3 block(TW, WARPS);
  bilateral_kernel<NL, K, WARPS, R><<<grid, block, smem, s>>>(
      q, img, out, h, w, L, l0, r, a, cs);
  return (int)cudaGetLastError();
}

// The compiled tiles (ops/bilateral.py::TILES and SPECIALISED mirror them):
// K in {4, 2, 1} output rows per thread, 8 rows of warps, for any radius;
// the radii 10 and 20 unrolled at K = 4 and K = 2.
template <int NL, int K>
int by_radius(const float* q, const float* img, float* out, int h, int w,
              int L, int l0, int r, float a, float cs, int spec,
              cudaStream_t s) {
  if constexpr (K >= 2) {
    if (spec == 10) return launch<NL, K, 8, 10>(q, img, out, h, w, L, l0, r, a, cs, s);
    if (spec == 20) return launch<NL, K, 8, 20>(q, img, out, h, w, L, l0, r, a, cs, s);
  }
  if (spec == 0) return launch<NL, K, 8, 0>(q, img, out, h, w, L, l0, r, a, cs, s);
  return (int)cudaErrorInvalidValue;
}

template <int NL>
int dispatch(const float* q, const float* img, float* out, int h, int w,
             int L, int l0, int r, float a, float cs, int k, int warps,
             int spec, cudaStream_t s) {
  if (warps != 8 || (spec != 0 && spec != r)) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 4: return by_radius<NL, 4>(q, img, out, h, w, L, l0, r, a, cs, spec, s);
    case 2: return by_radius<NL, 2>(q, img, out, h, w, L, l0, r, a, cs, spec, s);
    case 1: return by_radius<NL, 1>(q, img, out, h, w, L, l0, r, a, cs, spec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, img and out are device
// pointers to contiguous (h, w, L), (h, w, 3) and (h, w, L) f32 arrays; this
// launch handles labels [l0, l0 + nl), 1 <= nl <= 4.  a = log2(e) / (2
// sigma_xy^2) >= 0 and cs = sqrt(log2(e) / (2 sigma_rgb^2)) > 0.  plan is the
// host int[3] {K, rows of warps, unrolled radius or 0} of plan_bilateral.
// Launches on `stream`, allocates nothing, does not synchronise.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int dpai_bilateral_message(const void* q, const void* img, void* out,
                                      int h, int w, int L, int l0, int nl,
                                      int r, float a, float cs,
                                      const int* plan, void* stream) {
  if (h <= 0 || w <= 0 || r < 0 || L <= 0 || l0 < 0 || nl < 1 || nl > 4 ||
      l0 + nl > L || !(cs > 0.0f) || !(a >= 0.0f) || a > 3.4e38f)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* imf = static_cast<const float*>(img);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = plan[0], warps = plan[1], spec = plan[2];
  switch (nl) {
    case 1: return dispatch<1>(qf, imf, of, h, w, L, l0, r, a, cs, k, warps, spec, s);
    case 2: return dispatch<2>(qf, imf, of, h, w, L, l0, r, a, cs, k, warps, spec, s);
    case 3: return dispatch<3>(qf, imf, of, h, w, L, l0, r, a, cs, k, warps, spec, s);
    default: return dispatch<4>(qf, imf, of, h, w, L, l0, r, a, cs, k, warps, spec, s);
  }
}
