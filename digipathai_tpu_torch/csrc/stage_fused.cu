// One whole U-Net decoder stage for Hopper (sm_90a):
//
//   a   = act((conv3x3_same(up2(y), ka) + bias_a) * mul_a + add_a)
//   out = act((conv3x3_same(concat[a, skip], kb) + bias_b) * mul_b + add_b)
//
// Replaces the TPU kernel digipathai_tpu/ops/pallas/stage_fused.py::
// fused_up_stage (one Pallas call per stage, N=1 only).  NHWC tensors:
// y (N, Hh, Wh, C), skip (N, 2Hh, 2Wh, Cs) or none, kb (3, 3, F + Cs, F);
// act is relu or the identity.  The host folds each bias into
// off = add + bias * mul.
//
// Design: two launches, on one stream, of the implicit-GEMM convolution of
// conv3x3_igemm.cuh (the kernel csrc/conv_fused.cu launches):
//   - convA on folded taps: the host folds ka into four 2x2 kernels, one per
//     output parity class (ops/stage_fused.py::fold_upsample_kernel), and
//     the kernel computes each class over y at its own resolution and
//     writes a[2i + a, 2j + b].  4 taps per output pixel, not 9, and the
//     upsampled input never exists;
//   - convB reads its K dimension from two base pointers: channels [0, F)
//     from a, channels [F, F + Cs) from skip, so the concat never exists.
// `a` makes one round trip through a scratch tensor that the caller
// allocates, rounded once to the activation type, as the TPU kernel rounds
// it into VMEM.  Taps outside the image read 0 in both convs, which is SAME
// padding of the upsampled input and of the concat (the TPU kernel masks
// its halo to the same effect).

#include "conv3x3_igemm.cuh"

// Plain C entry point, loaded with ctypes.  All pointers but the plans are
// device pointers; `skip` is null when cs == 0; ka and kb are laid out by
// ops/conv_fused.py::prepare for their plans (ka folded, (4, 2, 2, C, F));
// `a` is the (n, 2hh, 2wh, f) scratch for convA's output; `part` is the
// split-K scratch, large enough for either conv, or null if neither plan
// splits; plan_a and plan_b are host arrays {bn, bk, tw, splits, stages, mi};
// `stream` is a cudaStream_t.  Launches convA then convB on `stream`,
// allocates nothing, does not synchronise.  Returns the first non-zero
// cudaGetLastError() (0 = both launched).
extern "C" int dpai_fused_up_stage(const void* y, const void* skip,
                                   const void* ka, const void* mula,
                                   const void* offa, const void* kb,
                                   const void* mulb, const void* offb,
                                   void* a, void* out, void* part, int n,
                                   int hh, int wh, int c, int cs, int f,
                                   int relu, int is_bf16, const int* plan_a,
                                   const int* plan_b, void* stream) {
  if (n <= 0 || hh <= 0 || wh <= 0 || c <= 0 || cs < 0 || f <= 0 ||
      (cs > 0) != (skip != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geom g;
  g.pm = nullptr;
  g.pa = nullptr;
  g.N = n;
  g.Ho = 2 * hh;
  g.Wo = 2 * wh;
  g.F = f;
  g.relu = relu;

  // convA: four parity classes of 2x2 taps over y
  g.x0 = y;
  g.x1 = nullptr;
  g.Hi = hh;
  g.Wi = wh;
  g.C0 = c;
  g.C1 = 0;
  g.C = c;
  g.taps = 2;
  g.w = ka;
  g.mul = static_cast<const float*>(mula);
  g.off = static_cast<const float*>(offa);
  g.out = a;
  g.bn = plan_a[0];
  g.bk = plan_a[1];
  g.tw = plan_a[2];
  g.splits = plan_a[3];
  g.stages = plan_a[4];
  g.mi = plan_a[5];
  g.part = g.splits > 1 ? static_cast<float*>(part) : nullptr;
  int rc = launch_conv(g, is_bf16 != 0, s);
  if (rc != 0) return rc;

  // convB: concat[a, skip] read from two base pointers
  g.x0 = a;
  g.x1 = skip;
  g.Hi = 2 * hh;
  g.Wi = 2 * wh;
  g.C0 = f;
  g.C1 = cs;
  g.C = f + cs;
  g.taps = 3;
  g.w = kb;
  g.mul = static_cast<const float*>(mulb);
  g.off = static_cast<const float*>(offb);
  g.out = out;
  g.bn = plan_b[0];
  g.bk = plan_b[1];
  g.tw = plan_b[2];
  g.splits = plan_b[3];
  g.stages = plan_b[4];
  g.mi = plan_b[5];
  g.part = g.splits > 1 ? static_cast<float*>(part) : nullptr;
  return launch_conv(g, is_bf16 != 0, s);
}
