// Fused x2 sub-pixel upsampler stage for Hopper (sm_90a):
//   out = pixel_shuffle(conv3x3_SAME(x, w) + b, 2)
// [B, H, W, C] -> [B, 2H, 2W, C], bf16 activations and weights, f32
// accumulation, torch channel order (conv column c * 4 + i * 2 + j lands
// at out[b, 2h + i, 2w + j, c]).
//
// Replaces the TPU kernel pesr_tpu/ops/pallas/upsampler.py
// (_upsampler_kernel / _upsampler_pallas_forward, reached through
// fused_upsampler_stage).  As there, the [H, W, 4C] conv output never
// reaches device memory: the epilogue writes each value straight to its
// shuffled position.  Left behind are the Mosaic-only workarounds: the
// f32 output cast back afterwards, the <=128-channel chunk grid and the
// silent XLA fallback; the wrapper raises on a shape this kernel does not
// take.
//
// What bounds it on the H100: the tensor cores (9 x C x 4C MACs per input
// pixel against 2 B x C in and 8 B x C out).  Design: one block computes
// a TH x TW tile of conv outputs for 256 conv columns (64 output channels
// x 4 sub-pixel phases), from a (TH+2) x 16 input window in shared memory
// (95,744 B at C = 256; TW + 2 = kRowPx).  The wrapper repacks the weight
// columns once, when the weights are loaded, so that the block's 256
// columns are [phase q][channel c0 + t]: eight consecutive columns of a
// lane are then eight consecutive channels of one output pixel, written
// as one 16-byte store.

#include "conv3x3_tile.cuh"

namespace pesr {
namespace {

constexpr int TH = 8;
constexpr int TW = 14;
static_assert(TW + 2 == kRowPx, "input window must be one virtual row wide");
constexpr int IN_ROWS = TH + 2;
constexpr int M = TH * kRowPx;  // virtual rows of conv output
constexpr int MT = M / (16 * kWarpsM);
static_assert(MT * 16 * kWarpsM == M, "row split");
constexpr int IN_PIX = IN_ROWS * kRowPx + 16;
static_assert(M - 1 + 2 * kRowPx + 2 < IN_PIX, "taps read inside the window");
constexpr int NB = 256;          // conv columns per block
constexpr int CH_PER_BLOCK = NB / 4;
constexpr int NT = NB / (16 * kWarpsN);

template <int C>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(IN_PIX) * smem_ld(C) + 2 * kKChunk * smem_ld(NB)) * 2 +
         kWarps * 256 * sizeof(float);
}

// w: [3, 3, C, 4C] bf16, columns packed as [C / 64][phase 4][64];
// bias: [4C] f32 in the same packed order.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    upsampler_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ out, int H, int W) {
  constexpr int LD = smem_ld(C);
  constexpr int CHUNKS = C / CH_PER_BLOCK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* in_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = in_s + IN_PIX * LD;
  float* st =
      reinterpret_cast<float*>(b_s + 2 * kKChunk * smem_ld(NB)) + (threadIdx.x / 32) * 256;

  const int b = blockIdx.z / CHUNKS, chunk = blockIdx.z % CHUNKS;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int row = lane >> 1, col = (lane & 1) * 8;

  load_window<C>(in_s, x, b, H, W, ty0 - 1, tx0 - 1, IN_ROWS, IN_PIX - IN_ROWS * kRowPx);

  FragC acc[MT][NT];
  conv3x3_mma<C, MT, NT>(acc, in_s, w, 4 * C, chunk * NB, b_s);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const float* v = stage_fragment(acc[mi][ni], st);
      const int r = (wm * MT + mi) * 16 + row;
      const int n = (wn * NT + ni) * 16 + col;  // packed column in the block
      const int oy = r / kRowPx, ox = r % kRowPx;
      const int gy = ty0 + oy, gx = tx0 + ox;
      if (ox < TW && gy < H && gx < W) {
        const int q = n / CH_PER_BLOCK;
        const int c = chunk * CH_PER_BLOCK + n % CH_PER_BLOCK;
        const int oy2 = 2 * gy + (q >> 1), ox2 = 2 * gx + (q & 1);
        const float* bb = bias + chunk * NB + n;
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = v[j] + bb[j];
        *reinterpret_cast<uint4*>(
            out + ((static_cast<int64_t>(b) * 2 * H + oy2) * (2 * W) + ox2) * C + c) = pack8(o);
      }
      __syncwarp();
    }
  }
}

template <int C>
int launch(const void* x, const void* w, const void* bias, void* out, int batch, int H, int W,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(upsampler_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, batch * (C / CH_PER_BLOCK));
  upsampler_kernel<C><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pesr

// x: [batch, H, W, C] bf16 NHWC; w: [3, 3, C, 4C] bf16 with packed
// columns; bias: [4C] f32 packed; out: [batch, 2H, 2W, C] bf16.  Returns
// the CUDA error code of the launch (0 = launched).  C must be 64, 128
// or 256.
extern "C" int pesr_fused_upsampler_stage(const void* x, const void* w, const void* bias,
                                          void* out, int batch, int H, int W, int C,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64:
      return pesr::launch<64>(x, w, bias, out, batch, H, W, s);
    case 128:
      return pesr::launch<128>(x, w, bias, out, batch, H, W, s);
    case 256:
      return pesr::launch<256>(x, w, bias, out, batch, H, W, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
