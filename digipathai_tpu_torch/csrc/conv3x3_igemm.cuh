// The implicit-GEMM convolution that both conv entry points of the port
// launch (Hopper, sm_90a): csrc/conv_fused.cu (one 3x3 conv with an optional
// pre-activation) and csrc/stage_fused.cu (a decoder stage's two convs).  On
// NHWC tensors one launch computes
//
//   h   = relu(x * pre_mul + pre_add)   if a pre-activation is given, else x
//   out = act((conv(h, k) + bias) * mul + add)
//
// with the zero halo AFTER the pre-activation (out-of-image taps read 0, not
// relu(pre_add)).  The host folds bias into off = add + bias * mul; act is
// relu or the identity.  Channels [0, C0) come from x0 and [C0, C) from a
// second base pointer x1, so a decoder stage's concat[a, skip] never exists.
// `conv` is one of two forms (Geom::taps):
//   - 3: a 3x3 SAME conv, output (i, j) from input rows i-1..i+1;
//   - 2: one parity class of a 3x3 conv over a nearest 2x upsample of x.
//     Output pixel (2i+a, 2j+b) only ever reads x rows i-1+a .. i+a and
//     columns j-1+b .. j+b, so the host folds the 3x3 kernel into four 2x2
//     kernels (rows [k0, k1+k2] for a = 0, [k0+k1, k2] for a = 1, columns
//     likewise), and the upsampled image never exists.  blockIdx.z is the
//     parity p = 2a + b; 4 taps per output pixel, 4/9 of the naive work.
//
// What bounds it on the H100: at the model's shapes (C up to 1344, F up to
// 320) the decoder convs are compute-bound (hundreds of FLOP per byte) and
// the F=32 dense layers sit near the ridge, so the bf16 path has to reach
// the tensor cores through wgmma and keep them fed.  Fed naively, it is
// bound instead by what each block pulls from L2 per FLOP: the kernel slab
// (9 x C x BN) is read by every block, and the input by every tap.  The
// design:
//   - A block (two warpgroups) owns a spatial tile of 128 * MI output
//     positions of one image, 16 columns wide (8 for narrow images); each
//     warpgroup computes MI wgmma row blocks of 8 x 8 positions.  MI is 2
//     (4 for BN = 64), so 256 or 512 positions share each slab.
//   - K walks channel chunks of BK (16, or 32 for BN = 96).  For each chunk
//     the tile's input window ((rows + taps - 1) x (cols + taps - 1) x BK)
//     is loaded into shared memory ONCE by cp.async, the zero halo by its
//     zero fill, and in the dense layers pre-activated once per element in
//     place.  The window is stored as [row][8-channel group][column] of
//     16-byte vectors, so each 8-pixel output row is one wgmma core matrix
//     and every tap (dy, dx) is a start-address offset into the same
//     window: A comes from shared memory by descriptor (no swizzle, LBO =
//     one channel group, SBO = one window row).  Each thread's window
//     vectors are the same for every chunk, so their offsets and pixels are
//     computed once.
//   - B, the kernel, is packed on the host once per conv into the exact
//     shared-memory image of each (n tile, chunk) slab, [tap][channel
//     group][n] of 16-byte vectors (K-major core matrices), and arrives by
//     one bulk (TMA) copy that completes on the stage's mbarrier.
//   - A ring of 3 or 4 stages in dynamic shared memory: chunks k+1 and k+2
//     are in flight while wgmma runs chunk k, wgmma_wait(1) keeps one
//     chunk of tensor-core work in flight across the block's one barrier
//     per chunk.
//   - N tile BN in {32, 64, 96, 128, 160} by F (F = 320 takes two); where
//     the tiles fill fewer than two waves of 132 SMs, K is split and a
//     second kernel sums the f32 partials in a fixed order and applies the
//     epilogue (no atomics: a repeat run is bit-identical).  The host
//     chooses (tile, BK, BN, MI, split, stages) from the shape alone
//     (ops/conv_fused.py::plan_conv) and passes it in.
//   - The epilogue stages mul/off in shared memory, rounds acc * mul + off
//     once to bf16 and stores 16-byte vectors from a shared-memory tile.
//
// The scalar path (an FMA tiled kernel, f32 accumulation) takes the shapes
// the vector path cannot (bf16 with C0, C1 or F not a multiple of 8, the
// ragged rows) and the f32 dtype, which exists for tight parity checks and is
// not on the bf16 main path.  The choice is by shape and dtype only: the
// host passes bn = 0 for the scalar path and the launcher refuses a plan
// that does not match the shape.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Geom {
  const void* x0;     // channels [0, C0): (N, Hi, Wi, C0)
  const void* x1;     // channels [C0, C): (N, Hi, Wi, C1), or null if C1 == 0
  const void* w;      // kernel: packed (vector path) or (P, T, T, C, F)
  const float* mul;   // (F,) epilogue scale
  const float* off;   // (F,) epilogue offset (add + bias * mul)
  const void* pm;     // (C,) pre-activation scale or null, activation type
  const void* pa;     // (C,) pre-activation offset or null, activation type
  void* out;          // (N, Ho, Wo, F), activation type
  float* part;        // split-K partials (splits, N * Ho * Wo, F) or null
  int N, Hi, Wi;      // input extent = the grid of computed positions
  int Ho, Wo;         // output extent: (Hi, Wi) for taps 3, 2x for taps 2
  int C0, C1, C, F;   // C = C0 + C1
  int taps;           // 3: 3x3 SAME; 2: folded upsample parity conv
  int relu;
  // the vector path's plan (bn == 0: scalar path)
  int bn, bk, tw, splits, stages, mi;
};

// Where parity class p of the computed grid reads and writes: window origin
// (oy0, ox0) relative to the position, output (i * os + a, j * os + b).
struct Place {
  int oy0, ox0, a, b, os;
};

__device__ __forceinline__ Place place(const Geom& g, int p) {
  Place q;
  if (g.taps == 3) {
    q.oy0 = q.ox0 = -1;
    q.a = q.b = 0;
    q.os = 1;
  } else {
    q.a = p >> 1;
    q.b = p & 1;
    q.oy0 = q.a - 1;
    q.ox0 = q.b - 1;
    q.os = 2;
  }
  return q;
}

// relu(bf16(bf16(v * pm) + pa)): the same two roundings as the bf16
// elementwise x * pre_mul + pre_add of the plain version.
__device__ __forceinline__ bf16 pre_act(bf16 v, bf16 pm, bf16 pa) {
  float t = __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(v) * __bfloat162float(pm)));
  t = __bfloat162float(__float2bfloat16_rn(t + __bfloat162float(pa)));
  return __float2bfloat16_rn(fmaxf(t, 0.0f));
}

// ------------------------------------------------- bf16 vector path (wgmma)

constexpr int THREADS = 256;  // two warpgroups

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; bytes == 0 writes 16 zero bytes (the zero halo)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (next core matrix along K), stride byte offset (next 8 rows)
__device__ __forceinline__ uint64_t mat_desc(uint32_t addr, uint32_t lbo,
                                             uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D(64 x N, f32) += A(64 x 16, bf16, smem) * B(16 x N, bf16, smem), both
// K-major
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<160> {
  static __device__ __forceinline__ void mma(float (&d)[80], uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(a), "l"(b), "r"(1));
  }
};

__host__ __device__ constexpr int round128(int b) { return (b + 127) & ~127; }

// Bytes of one ring stage: the input window, then the kernel slab.
__host__ __device__ inline int window_bytes(int taps, int tile_m, int tw,
                                            int bk) {
  return round128((tile_m / tw + taps - 1) * (tw + taps - 1) * bk * 2);
}

__host__ __device__ inline int slab_bytes(int taps, int bk, int bn) {
  return taps * taps * bk * bn * 2;
}

constexpr int MAXV = 6;  // window vectors per thread and chunk, at most

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one bulk (TMA) copy of `bytes` contiguous bytes; completes on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wait until chunk k's window has landed: `ahead - 1` groups may stay
// pending (ahead = stages - 2 chunks are loaded ahead of the one computed)
__device__ __forceinline__ void cp_async_wait_chunk(int ahead) {
  if (ahead >= 2)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// BN: the N tile; MI: wgmma row blocks (64 positions each) per warpgroup,
// so a block's 128 * MI positions share each kernel slab it loads.
template <int BN, int MI>
__global__ void __launch_bounds__(THREADS, MI * BN <= 128 ? 2 : 1)
    conv_wgmma(Geom g) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int TM = 128 * MI;  // positions per block
  constexpr int R = BN / 2;     // accumulator registers per row block
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int T = g.taps, BK = g.bk, KG = BK / 8, TW = g.tw, TH = TM / TW;
  const int WC = TW + T - 1;
  const int WR = TH + T - 1;
  const int a_bytes = window_bytes(T, TM, TW, BK);
  const int b_bytes = slab_bytes(T, BK, BN);
  const int stage_bytes = a_bytes + b_bytes;
  const int S = g.stages;
  float* s_mul = reinterpret_cast<float*>(smem + S * stage_bytes);
  float* s_off = s_mul + BN;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_off + BN);

  // block -> (n, tile row, tile column, n tile); split; parity
  const int NT = (g.F + BN - 1) / BN;
  const int tiles_x = (g.Wi + TW - 1) / TW;
  const int tiles_y = (g.Hi + TH - 1) / TH;
  int bid = blockIdx.x;
  const int nt = bid % NT;
  bid /= NT;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int n = bid / tiles_y;
  const int p = blockIdx.z;
  const Place q = place(g, p);
  const int y0 = ty * TH, x0 = tx * TW, f0 = nt * BN;
  const int NC = (g.C + BK - 1) / BK;
  const int split = blockIdx.y;
  const int c_beg = split * NC / g.splits;
  const int nk = (split + 1) * NC / g.splits - c_beg;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&s_bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += THREADS) {
    const int f = f0 + i;
    s_mul[i] = f < g.F ? g.mul[f] : 0.0f;
    s_off[i] = f < g.F ? g.off[f] : 0.0f;
  }
  __syncthreads();

  const bf16* x0p = static_cast<const bf16*>(g.x0);
  const bf16* x1p = static_cast<const bf16*>(g.x1);
  const bf16* wsrc = static_cast<const bf16*>(g.w) +
                     (size_t)(p * NT + nt) * NC * (b_bytes / 2);

  // This thread's window vectors, the same for every chunk: the offset in
  // the window ([row][channel group][column] of 16-byte vectors), the
  // channel group, and the input pixel (-1 in the zero halo).
  const int nv = WR * WC * KG;
  int v_dst[MAXV], v_kg[MAXV], v_pix[MAXV];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int v = tid + i * THREADS;
    v_dst[i] = -1;
    v_kg[i] = 0;
    v_pix[i] = -1;
    if (v < nv) {
      const int kg = v % KG, pix = v / KG;
      const int wc = pix % WC, wr = pix / WC;
      v_dst[i] = ((wr * KG + kg) * WC + wc) * 16;
      v_kg[i] = kg;
      const int iy = y0 + q.oy0 + wr, ix = x0 + q.ox0 + wc;
      if (iy >= 0 && iy < g.Hi && ix >= 0 && ix < g.Wi)
        v_pix[i] = (n * g.Hi + iy) * g.Wi + ix;
    }
  }

  // chunk c_beg + k into ring slot k % S: the window by cp.async (zero
  // fill in the halo and past C), the kernel slab by one bulk copy
  auto load_chunk = [&](int k) {
    const int c = c_beg + k;
    const int slot = k % S;
    const uint32_t sa = smem_u32(smem + slot * stage_bytes);
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      if (v_dst[i] < 0) continue;
      const int ch = c * BK + v_kg[i] * 8;
      const bf16* src = x0p;
      int bytes = 0;
      if (v_pix[i] >= 0 && ch < g.C) {
        src = ch < g.C0 ? x0p + (long long)v_pix[i] * g.C0 + ch
                        : x1p + (long long)v_pix[i] * g.C1 + (ch - g.C0);
        bytes = 16;
      }
      cp_async16(sa + v_dst[i], src, bytes);
    }
    if (tid == 0) {
      const uint32_t bar = smem_u32(&s_bar[slot]);
      mbar_expect_tx(bar, b_bytes);
      bulk_copy(sa + a_bytes, wsrc + (size_t)c * (b_bytes / 2), b_bytes, bar);
    }
  };

  // the dense layers' pre-activation, once per in-image window element, on
  // this thread's own (landed) vectors
  auto pre_activate = [&](int k) {
    const int c = c_beg + k;
    uint8_t* base = smem + (k % S) * stage_bytes;
    const bf16* pm = static_cast<const bf16*>(g.pm);
    const bf16* pa = static_cast<const bf16*>(g.pa);
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int ch = c * BK + v_kg[i] * 8;
      if (v_dst[i] < 0 || v_pix[i] < 0 || ch >= g.C) continue;
      uint4 x = *reinterpret_cast<uint4*>(base + v_dst[i]);
      const uint4 m4 = *reinterpret_cast<const uint4*>(pm + ch);
      const uint4 a4 = *reinterpret_cast<const uint4*>(pa + ch);
      bf16* xv = reinterpret_cast<bf16*>(&x);
      const bf16* mv = reinterpret_cast<const bf16*>(&m4);
      const bf16* av = reinterpret_cast<const bf16*>(&a4);
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[j] = pre_act(xv[j], mv[j], av[j]);
      *reinterpret_cast<uint4*>(base + v_dst[i]) = x;
    }
  };

  float acc[MI][R];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;

  // this warpgroup's row blocks (8 x 8 positions each) in window
  // coordinates: side by side for 16-column tiles, stacked for 8-column
  int wr0[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) wr0[i] = TW == 16 ? 8 * i : 8 * (wg * MI + i);
  const int wc0 = TW == 16 ? 8 * wg : 0;
  const uint32_t lbo_a = WC * 16, sbo_a = KG * WC * 16;
  const uint32_t lbo_b = BN * 16, sbo_b = 128;

  // one barrier per chunk: after it, chunk k is visible to every thread and
  // every warpgroup is past chunk k - 2's wgmma, so its slot is refilled
  const int ahead = S - 2;
  for (int k = 0; k < ahead; ++k) {
    if (k < nk) load_chunk(k);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_chunk(ahead);
    if (g.pm != nullptr) pre_activate(k);
    fence_proxy_async();
    __syncthreads();
    if (k + ahead < nk) load_chunk(k + ahead);
    cp_async_commit();
    mbar_wait(smem_u32(&s_bar[k % S]), (k / S) & 1);
    const uint32_t sa = smem_u32(smem + (k % S) * stage_bytes);
    const uint32_t sb = sa + a_bytes;
    wgmma_fence();
    for (int dy = 0; dy < T; ++dy)
      for (int dx = 0; dx < T; ++dx)
        for (int s = 0; s < KG / 2; ++s) {
          const uint64_t db = mat_desc(
              sb + ((dy * T + dx) * KG + 2 * s) * BN * 16, lbo_b, sbo_b);
#pragma unroll
          for (int i = 0; i < MI; ++i)
            Wgmma<BN>::mma(
                acc[i],
                mat_desc(sa + (((wr0[i] + dy) * KG + 2 * s) * WC + wc0 + dx) *
                                  16,
                         lbo_a, sbo_a),
                db);
        }
    wgmma_commit();
    wgmma_wait<1>();  // chunk k - 1 done in this warpgroup
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MI; ++i) fence_acc(acc[i]);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free for the epilogue

  // accumulator acc[i][4j + 2h + e]: position (warp % 4) * 16 + lane / 4 +
  // 8h of row block i, channel 8j + 2 (lane % 4) + e
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  auto out_pixel = [&](int m, long long& pix) -> bool {
    const int blk = m >> 6, w = blk / MI, i = blk % MI;
    const int r = (m >> 3) & 7, cc = m & 7;
    const int row = y0 + (TW == 16 ? 8 * i : 8 * blk) + r;
    const int col = x0 + (TW == 16 ? 8 * w : 0) + cc;
    if (row >= g.Hi || col >= g.Wi) return false;
    pix = ((long long)n * g.Ho + row * q.os + q.a) * g.Wo + col * q.os + q.b;
    return true;
  };

  if (g.splits > 1) {  // f32 partials; splitk_reduce applies the epilogue
    const long long P = (long long)g.N * g.Ho * g.Wo;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wg * MI + i) * 64 + warp * 16 + (lane >> 2) + 8 * h;
        long long pix;
        if (!out_pixel(m, pix)) continue;
        float* dst = g.part + ((long long)split * P + pix) * g.F;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int f = f0 + 8 * j + 2 * (lane & 3);
          if (f < g.F)
            *reinterpret_cast<float2*>(dst + f) = make_float2(
                acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
        }
      }
    return;
  }

  constexpr int OS = BN + 8;  // bf16 per row of the output tile
  bf16* so = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wg * MI + i) * 64 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        float v0 = acc[i][4 * j + 2 * h] * s_mul[col] + s_off[col];
        float v1 =
            acc[i][4 * j + 2 * h + 1] * s_mul[col + 1] + s_off[col + 1];
        if (g.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(so + m * OS + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  __syncthreads();
  bf16* out = static_cast<bf16*>(g.out);
  constexpr int VPR = BN / 8;  // 16-byte vectors per position
  for (int v = tid; v < TM * VPR; v += THREADS) {
    const int m = v / VPR, j = v % VPR;
    const int f = f0 + 8 * j;
    long long pix;
    if (f >= g.F || !out_pixel(m, pix)) continue;
    *reinterpret_cast<uint4*>(out + pix * g.F + f) =
        *reinterpret_cast<const uint4*>(so + m * OS + 8 * j);
  }
}

// Sums the split-K partials in split order, then acc * mul + off, relu,
// one bf16 rounding; four channels per thread.
__global__ void __launch_bounds__(256) splitk_reduce(Geom g) {
  const long long total = (long long)g.N * g.Ho * g.Wo * g.F;
  bf16* out = static_cast<bf16*>(g.out);
  for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       i < total; i += 4LL * gridDim.x * blockDim.x) {
    float4 s = *reinterpret_cast<const float4*>(g.part + i);
    for (int k = 1; k < g.splits; ++k) {
      const float4 t =
          *reinterpret_cast<const float4*>(g.part + k * total + i);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    const int f = (int)(i % g.F);
    float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = v[e] * g.mul[f + e] + g.off[f + e];
      if (g.relu) v[e] = fmaxf(v[e], 0.0f);
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + i) = u;
  }
}

// --------------------------------------------------- scalar path (FMA, f32)

constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float pre_f(float v, float pm, float pa) {
  return fmaxf(__fadd_rn(__fmul_rn(v, pm), pa), 0.0f);
}
__device__ __forceinline__ float pre_f(bf16 v, bf16 pm, bf16 pa) {
  return __bfloat162float(pre_act(v, pm, pa));
}

// One 64-position x 64-channel output tile per block, K in 16-deep steps
// (one tap, 16 channels); w is (P, T, T, C, F) in the activation type.
template <typename E>
__global__ void __launch_bounds__(256) conv_fma(Geom g) {
  __shared__ float As[FK][FM];
  __shared__ float Bs[FK][FN];

  const int t = threadIdx.x;
  const int nF = (g.F + FN - 1) / FN;
  const long long Mi = (long long)g.N * g.Hi * g.Wi;
  const long long m0 = (long long)(blockIdx.x / nF) * FM;
  const int f0 = (int)(blockIdx.x % nF) * FN;
  const int p = blockIdx.z;
  const Place q = place(g, p);
  const int T = g.taps;
  const E* w = static_cast<const E*>(g.w) + (size_t)p * T * T * g.C * g.F;
  const E* pm = static_cast<const E*>(g.pm);
  const E* pa = static_cast<const E*>(g.pa);
  const int tm = t >> 4;  // 16 x 16 threads, 4 x 4 outputs each
  const int tn = t & 15;
  const int cchunks = (g.C + FK - 1) / FK;

  // this thread's 4 A rows (positions m0 + i * 16 + tm): image, row, column
  long long rn[4];
  int ry[4], rx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + i * 16 + tm;
    rn[i] = m < Mi ? m / ((long long)g.Hi * g.Wi) : -1;
    const int rem = (int)(m - (rn[i] < 0 ? 0 : rn[i]) * g.Hi * g.Wi);
    ry[i] = rem / g.Wi;
    rx[i] = rem - ry[i] * g.Wi;
  }

  float acc[4][4] = {};
  for (int kt = 0; kt < T * T * cchunks; ++kt) {
    const int tap = kt / cchunks;
    const int c0 = (kt % cchunks) * FK;
    const int dy = tap / T, dx = tap % T;
    const int c = c0 + tn;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = ry[i] + q.oy0 + dy, ix = rx[i] + q.ox0 + dx;
      float v = 0.0f;
      if (rn[i] >= 0 && c < g.C && iy >= 0 && iy < g.Hi && ix >= 0 &&
          ix < g.Wi) {
        const long long pi = (rn[i] * g.Hi + iy) * g.Wi + ix;
        const E x = c < g.C0
                        ? static_cast<const E*>(g.x0)[pi * g.C0 + c]
                        : static_cast<const E*>(g.x1)[pi * g.C1 + c - g.C0];
        v = pm != nullptr ? pre_f(x, pm[c], pa[c]) : to_f(x);
      }
      As[tn][i * 16 + tm] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = i * 4 + (t >> 6);
      const int f = f0 + (t & 63);
      Bs[kk][t & 63] =
          (c0 + kk < g.C && f < g.F)
              ? to_f(w[((long long)tap * g.C + c0 + kk) * g.F + f])
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

  E* out = static_cast<E*>(g.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + tm * 4 + r;
    if (m >= Mi) continue;
    const long long nn = m / ((long long)g.Hi * g.Wi);
    const int rem = (int)(m - nn * g.Hi * g.Wi);
    const int i = rem / g.Wi, j = rem - (rem / g.Wi) * g.Wi;
    const long long pix = (nn * g.Ho + i * q.os + q.a) * g.Wo + j * q.os + q.b;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int f = f0 + tn * 4 + s;
      if (f >= g.F) continue;
      float v = acc[r][s] * g.mul[f] + g.off[f];
      if (g.relu) v = fmaxf(v, 0.0f);
      store(out + pix * g.F + f, v);
    }
  }
}

// ------------------------------------------------------------------ launch

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int BN, int MI>
int launch_wgmma(const Geom& g, cudaStream_t s) {
  constexpr int TM = 128 * MI;
  const int th = TM / g.tw;
  const int nv = (th + g.taps - 1) * (g.tw + g.taps - 1) * (g.bk / 8);
  if (nv > MAXV * THREADS) return (int)cudaErrorInvalidConfiguration;
  const int smem = g.stages * (window_bytes(g.taps, TM, g.tw, g.bk) +
                               slab_bytes(g.taps, g.bk, BN)) +
                   2 * BN * 4 + 8 * g.stages;
  // set on every launch: the attribute is per device, and the call is cheap
  const cudaError_t e = cudaFuncSetAttribute(
      conv_wgmma<BN, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)g.N * ((g.Hi + th - 1) / th) *
                          ((g.Wi + g.tw - 1) / g.tw) * ((g.F + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, g.splits, g.taps == 2 ? 4 : 1);
  conv_wgmma<BN, MI><<<grid, THREADS, smem, s>>>(g);
  return (int)cudaGetLastError();
}

// One convolution: checks the geometry and the plan, launches it on `s`.
// Returns cudaGetLastError() (0 = launched).
int launch_conv(const Geom& g, bool is_bf16, cudaStream_t s) {
  const bool parities_ok =
      (g.taps == 3 && g.Ho == g.Hi && g.Wo == g.Wi) ||
      (g.taps == 2 && g.Ho == 2 * g.Hi && g.Wo == 2 * g.Wi);
  if (g.N <= 0 || g.Hi <= 0 || g.Wi <= 0 || !parities_ok || g.C0 <= 0 ||
      g.C1 < 0 || g.C != g.C0 + g.C1 || g.F <= 0 ||
      (g.C1 > 0) != (g.x1 != nullptr) || (g.pm == nullptr) != (g.pa == nullptr))
    return (int)cudaErrorInvalidValue;
  // the vector path takes bf16 with C0, C1 and F multiples of 8, nothing else
  const bool vec = is_bf16 && g.C0 % 8 == 0 && g.C1 % 8 == 0 && g.F % 8 == 0;
  if (vec != (g.bn != 0)) return (int)cudaErrorInvalidValue;
  if (vec) {
    if ((g.bk != 16 && g.bk != 32) || (g.tw != 8 && g.tw != 16) ||
        g.splits < 1 || (g.splits > 1) != (g.part != nullptr) ||
        g.stages < 3 || g.stages > 4 ||
        (long long)g.N * g.Hi * g.Wi > 0x7fffffffLL || !aligned16(g.x0) ||
        (g.x1 != nullptr && !aligned16(g.x1)) || !aligned16(g.w) ||
        !aligned16(g.out) ||
        (g.pm != nullptr && (!aligned16(g.pm) || !aligned16(g.pa))))
      return (int)cudaErrorInvalidValue;
    int rc;
    switch (g.bn * 8 + g.mi) {  // the (BN, MI) pairs plan_conv chooses
      case 32 * 8 + 2: rc = launch_wgmma<32, 2>(g, s); break;
      case 64 * 8 + 4: rc = launch_wgmma<64, 4>(g, s); break;
      case 96 * 8 + 2: rc = launch_wgmma<96, 2>(g, s); break;
      case 128 * 8 + 2: rc = launch_wgmma<128, 2>(g, s); break;
      case 160 * 8 + 2: rc = launch_wgmma<160, 2>(g, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (rc != 0 || g.splits == 1) return rc;
    const long long quads = (long long)g.N * g.Ho * g.Wo * g.F / 4;
    const long long blocks = (quads + 255) / 256;
    splitk_reduce<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        g);
    return (int)cudaGetLastError();
  }
  const long long mi = (long long)g.N * g.Hi * g.Wi;
  const long long blocks = ((mi + FM - 1) / FM) * ((g.F + FN - 1) / FN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, 1, g.taps == 2 ? 4 : 1);
  if (is_bf16)
    conv_fma<bf16><<<grid, 256, 0, s>>>(g);
  else
    conv_fma<float><<<grid, 256, 0, s>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace
