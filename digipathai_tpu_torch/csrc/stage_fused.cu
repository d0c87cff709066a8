// One whole U-Net decoder stage for Hopper (sm_90a):
//
//   a   = act((conv3x3_same(up2(y), ka) + bias_a) * mul_a + add_a)
//   out = act((conv3x3_same(concat[a, skip], kb) + bias_b) * mul_b + add_b)
//
// Replaces the TPU kernel digipathai_tpu/ops/pallas/stage_fused.py::
// fused_up_stage (one Pallas call per stage, N=1 only).  NHWC tensors:
// y (N, Hh, Wh, C), skip (N, 2Hh, 2Wh, Cs) or none, ka (3, 3, C, F),
// kb (3, 3, F + Cs, F); act is relu or the identity.  The host folds each
// bias into off = add + bias * mul.
//
// Design: two launches, on one stream, of the implicit-GEMM convolution of
// conv3x3_igemm.cuh (the kernel csrc/conv_fused.cu launches), each over the
// 2Hh x 2Wh output.  Neither the upsampled input nor the concat ever exists
// in device memory:
//   - convA gathers its input through the upsample (s0 = 1): the tap at
//     upsampled (iy, ix) reads y[iy >> 1, ix >> 1];
//   - convB reads its K dimension from two base pointers: channels [0, F)
//     from a, channels [F, F + Cs) from skip.
// `a` makes one round trip through a scratch tensor that the caller
// allocates, rounded once to the activation type, as the TPU kernel rounds
// it into VMEM.  Taps outside the image read 0 in both convs, which is SAME
// padding of the upsampled input and of the concat (the TPU kernel masks
// its halo to the same effect).  convA runs all 9 taps; the tap folding
// that the upsample allows (4 distinct y pixels per output pixel) is later
// work.

#include "conv3x3_igemm.cuh"

// Plain C entry point, loaded with ctypes.  All pointers are device
// pointers; `skip` is null when cs == 0; `a` is the (n, 2hh, 2wh, f)
// scratch for convA's output; `stream` is a cudaStream_t.  Launches convA
// then convB on `stream`, allocates nothing, does not synchronise.  Returns
// the first non-zero cudaGetLastError() (0 = both launched).
extern "C" int dpai_fused_up_stage(const void* y, const void* skip,
                                   const void* ka, const void* mula,
                                   const void* offa, const void* kb,
                                   const void* mulb, const void* offb,
                                   void* a, void* out, long long n, int hh,
                                   int wh, int c, int cs, int f, int relu,
                                   int is_bf16, void* stream) {
  if (n <= 0 || hh <= 0 || wh <= 0 || c <= 0 || cs < 0 || f <= 0 ||
      (cs > 0) != (skip != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geom g;
  g.pm = nullptr;
  g.pa = nullptr;
  g.H = 2 * hh;
  g.W = 2 * wh;
  g.M = n * g.H * g.W;
  g.F = f;
  g.relu = relu;

  // convA: the upsampled y, never materialised
  g.x0 = y;
  g.x1 = nullptr;
  g.C0 = c;
  g.C1 = 0;
  g.C = c;
  g.s0 = 1;
  g.w = ka;
  g.mul = static_cast<const float*>(mula);
  g.off = static_cast<const float*>(offa);
  g.out = a;
  int rc = launch_conv3x3(g, is_bf16 != 0, s);
  if (rc != 0) return rc;

  // convB: concat[a, skip] read from two base pointers
  g.x0 = a;
  g.x1 = skip;
  g.C0 = f;
  g.C1 = cs;
  g.C = f + cs;
  g.s0 = 0;
  g.w = kb;
  g.mul = static_cast<const float*>(mulb);
  g.off = static_cast<const float*>(offb);
  g.out = out;
  return launch_conv3x3(g, is_bf16 != 0, s);
}
