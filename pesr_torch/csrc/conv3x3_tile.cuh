// Shared device code of the two fused 3x3-conv kernels (resblock.cu,
// upsampler.cu): the Hopper counterpart of pesr_tpu/ops/pallas/common.py.
//
// The TPU kernels cut the padded activation into overlapping halo windows
// in HBM (common.halo_tiles) and run each 3x3 conv as nine full-tile
// matmuls (common.conv3x3_shift_acc).  Here a block loads its window from
// the UNPADDED NHWC tensor itself, with zeros where the window leaves the
// image, so no windowed copy ever reaches device memory.  The conv is an
// implicit GEMM on the tensor cores (bf16 in, f32 accumulate):
//
//   * every shared-memory window is kRowPx pixels wide and each pixel is
//     one smem row of C channels (+kPad of padding), so the pixel
//     (y, x) of a window sits at smem row y * kRowPx + x;
//   * output pixels are numbered on the same kRowPx-wide grid
//     ("virtual rows"): output q reads input q + dy * kRowPx + dx for tap
//     (dy, dx).  Sixteen consecutive outputs therefore read sixteen
//     consecutive smem rows, which is exactly a wmma A fragment with
//     leading dimension C + kPad.  Columns past the real tile width are
//     computed and thrown away (the price of a uniform stride);
//   * the weights stream from global memory (L2) in chunks of kKChunk
//     input channels x the block's output columns, double-buffered with
//     cp.async so the next chunk loads while this one multiplies.
//
// Warp layout: 8 warps, kWarpsM along the pixel rows x kWarpsN along the
// output columns; each warp owns MT x NT 16x16 accumulator fragments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace pesr {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kKChunk = 32;  // input channels per weight stage
constexpr int kRowPx = 16;   // width (pixels) of every smem window
constexpr int kPad = 16;     // bf16 of padding per smem row: keeps every
                             // row 32-byte aligned (wmma) and spreads
                             // consecutive rows over the banks

__host__ __device__ constexpr int smem_ld(int c) { return c + kPad; }

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a rows x kRowPx pixel window of image b, top-left pixel (y0, x0),
// from NHWC global memory into smem rows [0, rows * kRowPx); pixels
// outside the image (SAME zero padding) and the pad_px smem rows after
// the window are zero.
template <int C>
__device__ __forceinline__ void load_window(bf16* dst, const bf16* __restrict__ x, int b,
                                            int H, int W, int y0, int x0, int rows,
                                            int pad_px) {
  constexpr int LD = smem_ld(C);
  constexpr int VEC = C / 8;  // 16-byte vectors per pixel
  const int total = (rows * kRowPx + pad_px) * VEC;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int p = i / VEC, v = i % VEC;
    const int wy = p / kRowPx, wx = p % kRowPx;
    const int gy = y0 + wy, gx = x0 + wx;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (wy < rows && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      val = __ldg(reinterpret_cast<const uint4*>(
          x + ((static_cast<int64_t>(b) * H + gy) * W + gx) * C + v * 8));
    }
    *reinterpret_cast<uint4*>(dst + p * LD + v * 8) = val;
  }
}

// Stage s of the K loop: tap s / (CIN / kKChunk), input channels
// [kc * kKChunk, +kKChunk) of the HWIO weights w ([9][CIN][ldw] bf16),
// output columns [n0, n0 + NB), into dst ([kKChunk][NB + kPad]).
template <int CIN, int NB>
__device__ __forceinline__ void load_weight_stage(bf16* dst, const bf16* __restrict__ w,
                                                  int ldw, int n0, int s) {
  constexpr int KSTEPS = CIN / kKChunk;
  constexpr int LDB = smem_ld(NB);
  constexpr int VEC_ROW = NB / 8;
  const int tap = s / KSTEPS, kc = s % KSTEPS;
  const bf16* g = w + (static_cast<int64_t>(tap) * CIN + kc * kKChunk) * ldw + n0;
  for (int i = threadIdx.x; i < kKChunk * VEC_ROW; i += kThreads) {
    const int r = i / VEC_ROW, v = i % VEC_ROW;
    cp_async16(dst + r * LDB + v * 8, g + static_cast<int64_t>(r) * ldw + v * 8);
  }
  cp_async_commit();
}

// acc[mi][ni] = sum over the nine taps and CIN input channels of
//   src[q + dy * kRowPx + dx][cin] * w[dy][dx][cin][n0 + n]
// for this warp's rows q and columns n.  src is a smem window
// (rows of CIN + kPad bf16); bstage holds two weight stages.  Starts and
// ends with a __syncthreads, so the caller may write src before and read
// or overwrite bstage after.
template <int CIN, int MT, int NT>
__device__ __forceinline__ void conv3x3_mma(FragC (&acc)[MT][NT], const bf16* src,
                                            const bf16* __restrict__ w, int ldw, int n0,
                                            bf16* bstage) {
  constexpr int LDA = smem_ld(CIN);
  constexpr int NB = kWarpsN * NT * 16;
  constexpr int LDB = smem_ld(NB);
  constexpr int KSTEPS = CIN / kKChunk;
  constexpr int STEPS = 9 * KSTEPS;
  const int warp = threadIdx.x / 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) wmma::fill_fragment(acc[mi][ni], 0.0f);

  load_weight_stage<CIN, NB>(bstage, w, ldw, n0, 0);
  for (int s = 0; s < STEPS; ++s) {
    const bf16* cur = bstage + (s & 1) * kKChunk * LDB;
    if (s + 1 < STEPS) {
      load_weight_stage<CIN, NB>(bstage + ((s + 1) & 1) * kKChunk * LDB, w, ldw, n0, s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tap = s / KSTEPS, kc = s % KSTEPS;
    const int off = (tap / 3) * kRowPx + tap % 3;
#pragma unroll
    for (int kk = 0; kk < kKChunk; kk += 16) {
      FragA a[MT];
      FragB bfr[NT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        wmma::load_matrix_sync(a[mi], src + ((wm * MT + mi) * 16 + off) * LDA + kc * kKChunk + kk,
                               LDA);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        wmma::load_matrix_sync(bfr[ni], cur + kk * LDB + (wn * NT + ni) * 16, LDB);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) wmma::mma_sync(acc[mi][ni], a[mi], bfr[ni], acc[mi][ni]);
    }
    __syncthreads();
  }
}

// Epilogue access to one accumulator fragment: the warp stores it to its
// 16x16 f32 staging tile; lane l then owns row l / 2, columns
// (l % 2) * 8 .. +8 of it, returned as a pointer to 8 floats.  The
// caller __syncwarp()s after reading, before the next fragment.
__device__ __forceinline__ const float* stage_fragment(const FragC& acc, float* stage) {
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  return stage + (lane >> 1) * 16 + (lane & 1) * 8;
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 out;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return out;
}

__device__ __forceinline__ void unpack8(uint4 in, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(p[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

}  // namespace pesr
