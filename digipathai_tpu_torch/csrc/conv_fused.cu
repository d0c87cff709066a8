// Fused 3x3 SAME convolution + bias + BN-affine + relu for Hopper (sm_90a).
//
// Replaces the TPU kernel digipathai_tpu/ops/pallas/conv_fused.py::fused_conv3x3
// (Pallas strip-DMA kernel, N=1 only).  Computes, on NHWC tensors,
//
//   h   = relu(x * pre_mul + pre_add)   if a pre-affine is given, else x
//   out = act((conv3x3_same(h, k) + bias) * mul + add)
//
// with the SAME halo zero AFTER the pre-activation.  One launch of the
// implicit-GEMM convolution of conv3x3_igemm.cuh, which holds the design
// (plus its split-K reduction where the plan splits K); csrc/stage_fused.cu
// launches the same kernel for a decoder stage.

#include "conv3x3_igemm.cuh"

// Plain C entry point, loaded with ctypes.  All pointers but `plan` are
// device pointers; pre_mul and pre_add are both null or both set; `w` is
// the kernel as ops/conv_fused.py::prepare lays it out for the plan; `part`
// is the split-K scratch (null unless plan[3] > 1); plan is the host array
// {bn, bk, tw, splits, stages, mi} of ops/conv_fused.py::plan_conv (bn = 0: the
// scalar path); `stream` is a cudaStream_t.  Launches on `stream`, allocates
// nothing, does not synchronise.  Returns cudaGetLastError() (0 = launched).
extern "C" int dpai_fused_conv3x3(const void* x, const void* w,
                                  const void* mul, const void* off,
                                  const void* pre_mul, const void* pre_add,
                                  void* out, void* part, int n, int h, int wd,
                                  int c, int f, int relu, int is_bf16,
                                  const int* plan, void* stream) {
  Geom g;
  g.x0 = x;
  g.x1 = nullptr;
  g.w = w;
  g.mul = static_cast<const float*>(mul);
  g.off = static_cast<const float*>(off);
  g.pm = pre_mul;
  g.pa = pre_add;
  g.out = out;
  g.part = static_cast<float*>(part);
  g.N = n;
  g.Hi = g.Ho = h;
  g.Wi = g.Wo = wd;
  g.C0 = c;
  g.C1 = 0;
  g.C = c;
  g.F = f;
  g.taps = 3;
  g.relu = relu;
  g.bn = plan[0];
  g.bk = plan[1];
  g.tw = plan[2];
  g.splits = plan[3];
  g.stages = plan[4];
  g.mi = plan[5];
  return launch_conv(g, is_bf16 != 0, static_cast<cudaStream_t>(stream));
}
