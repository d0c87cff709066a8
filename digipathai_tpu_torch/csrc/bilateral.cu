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
// Design: one thread per output pixel; a block of 32 x 8 outputs stages the
// (8 + 2r) x (32 + 2r) halo of the three image planes, the label planes of
// this launch and an in-image flag into shared memory (planar, so a warp's
// 32 neighbouring pixels read 32 consecutive words: no bank conflicts), and
// every thread walks the (2r + 1)^2 - 1 shifts with f32 accumulators in
// registers.  The weights depend only on the image, so the host launches
// once per chunk of up to four labels; NL is a template parameter so the
// label loop unrolls.
//
// What bounds it on the H100: instruction issue.  Each (pixel, shift) pair
// costs about 13 + 2L f32 operations, one of them an exponential, while the
// arrays are read about once (the halo is re-read from L2): at 1024^2 and
// r = 10 that is some 8 GFLOP against 28 MB.  Everything stays f32, with no
// fast-math, so expf is the accurate one.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;  // block tile width (one warp per row)
constexpr int TH = 8;   // block tile height
constexpr int THREADS = TW * TH;

template <int NL>
__global__ void __launch_bounds__(THREADS)
    bilateral_kernel(const float* __restrict__ q, const float* __restrict__ img,
                     float* __restrict__ out, int H, int W, int L, int l0,
                     int r, float inv2_xy, float inv2_c) {
  extern __shared__ float smem[];
  const int hw = TW + 2 * r;  // halo tile width
  const int hh = TH + 2 * r;  // halo tile height
  const int cells = hw * hh;
  float* s_img = smem;                 // 3 planes
  float* s_q = smem + 3 * cells;       // NL planes
  float* s_ok = smem + (3 + NL) * cells;  // 1 = inside the image

  const int bx0 = blockIdx.x * TW;
  const int by0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int i = tid; i < cells; i += THREADS) {
    const int gy = by0 - r + i / hw;
    const int gx = bx0 - r + i % hw;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t p = in ? (size_t)gy * W + gx : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) s_img[c * cells + i] = in ? img[p * 3 + c] : 0.0f;
#pragma unroll
    for (int l = 0; l < NL; ++l)
      s_q[l * cells + i] = in ? q[p * L + l0 + l] : 0.0f;
    s_ok[i] = in ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int x = bx0 + threadIdx.x;
  const int y = by0 + threadIdx.y;
  if (x >= W || y >= H) return;

  const int centre = (threadIdx.y + r) * hw + threadIdx.x + r;
  const float i0 = s_img[centre];
  const float i1 = s_img[cells + centre];
  const float i2 = s_img[2 * cells + centre];
  float num[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) num[l] = 0.0f;
  float den = 0.0f;

  for (int dy = -r; dy <= r; ++dy) {
    const int row = (threadIdx.y + r + dy) * hw + threadIdx.x + r;
    for (int dx = -r; dx <= r; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int j = row + dx;
      const float d0 = i0 - s_img[j];
      const float d1 = i1 - s_img[cells + j];
      const float d2 = i2 - s_img[2 * cells + j];
      const float color = d0 * d0 + d1 * d1 + d2 * d2;
      const float wgt =
          expf(-(float)(dy * dy + dx * dx) * inv2_xy - color * inv2_c) * s_ok[j];
      den += wgt;
#pragma unroll
      for (int l = 0; l < NL; ++l) num[l] = fmaf(wgt, s_q[l * cells + j], num[l]);
    }
  }

  den = fmaxf(den, 1e-12f);
  const size_t p = (size_t)y * W + x;
#pragma unroll
  for (int l = 0; l < NL; ++l) out[p * L + l0 + l] = num[l] / den;
}

template <int NL>
int launch(const float* q, const float* img, float* out, int h, int w, int L,
           int l0, int r, float inv2_xy, float inv2_c, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (size_t)(TW + 2 * r) * (TH + 2 * r) * (4 + NL);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      bilateral_kernel<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  dim3 block(TW, TH);
  bilateral_kernel<NL><<<grid, block, smem, s>>>(q, img, out, h, w, L, l0, r,
                                                 inv2_xy, inv2_c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, img and out are device
// pointers to contiguous (h, w, L), (h, w, 3) and (h, w, L) f32 arrays; this
// launch handles labels [l0, l0 + nl), 1 <= nl <= 4.  inv2_xy and inv2_c
// are 1 / (2 sigma^2) for the position and colour terms.  Launches on
// `stream`, allocates nothing, does not synchronise.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int dpai_bilateral_message(const void* q, const void* img, void* out,
                                      int h, int w, int L, int l0, int nl,
                                      int r, float inv2_xy, float inv2_c,
                                      void* stream) {
  if (h <= 0 || w <= 0 || r < 0 || L <= 0 || l0 < 0 || nl < 1 || nl > 4 ||
      l0 + nl > L || h > 65535 * TH)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* imf = static_cast<const float*>(img);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 1: return launch<1>(qf, imf, of, h, w, L, l0, r, inv2_xy, inv2_c, s);
    case 2: return launch<2>(qf, imf, of, h, w, L, l0, r, inv2_xy, inv2_c, s);
    case 3: return launch<3>(qf, imf, of, h, w, L, l0, r, inv2_xy, inv2_c, s);
    default: return launch<4>(qf, imf, of, h, w, L, l0, r, inv2_xy, inv2_c, s);
  }
}
