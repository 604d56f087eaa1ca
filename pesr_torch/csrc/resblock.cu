// Fused residual block for Hopper (sm_90a):
//   out = x + res_scale * (conv3x3(relu(conv3x3(x) + b1)) + b2)
// with SAME zero padding, bf16 activations and weights, f32 accumulation.
//
// Replaces the TPU kernel pesr_tpu/ops/pallas/resblock.py
// (_resblock_kernel / _resblock_pallas_forward, reached through
// fused_resblock).  As there, the hidden activation never reaches device
// memory: one block computes a TH x TW output tile from a (TH+4) x (TW+4)
// input window and a (TH+2) x (TW+2) hidden tile, both in shared memory.
//
// What bounds it on the H100: the tensor cores.  At C = 256 a block does
// 2 x 9 x 256 x 256 MACs per pixel for ~1 KB of activation traffic per
// pixel, far above the card's ~295 FLOP/byte balance point.  The limits
// of this first design are the 1.6x halo + virtual-column recompute of a
// tile small enough for shared memory, one block per SM, and the wmma
// (mma.sync) path, which cannot reach the wgmma rate.
//
// Tile choice.  At C = 256 one pixel is 512 B (+32 B of bank padding in
// smem).  TH x TW = 6 x 12 makes the input window 10 x 16 pixels, so its
// width is exactly the kRowPx = 16 virtual row of conv3x3_tile.cuh:
//   input window  (10 x 16 + 16 pad) px x 544 B = 95,744 B
//   hidden tile   ( 8 x 16 + 16 pad) px x 544 B = 78,336 B
//   weight stages  2 x 32 x 544 B               = 34,816 B
//   f32 staging    8 warps x 1 KB               =  8,192 B
//   total                                       = 217,088 B of the 232,448
// conv1 computes 8 x 16 = 128 virtual rows (80 real hidden pixels), conv2
// 6 x 16 = 96 (72 real outputs).  The TPU's 36 x 36 tile would need a
// 739 KB hidden tile alone.  The weights (1.18 MB per conv) do not fit
// and stream from L2 per tap and 32-channel chunk.
//
// Rounding matches the TPU kernel: bias added in f32, the hidden rounded
// to bf16 before conv2 (resblock.py:65), the residual added in f32 before
// the single bf16 rounding of the output (resblock.py:69-71).  Hidden
// pixels outside the image are ZERO (SAME padding of conv2's input), not
// relu(b1 + partial sums) (the ring mask of resblock.py:56-65).

#include "conv3x3_tile.cuh"

namespace pesr {
namespace {

constexpr int TH = 6;
constexpr int TW = 12;
static_assert(TW + 4 == kRowPx, "input window must be one virtual row wide");
constexpr int IN_ROWS = TH + 4;
constexpr int HID_ROWS = TH + 2;
constexpr int M1 = HID_ROWS * kRowPx;  // conv1 virtual rows
constexpr int M2 = TH * kRowPx;        // conv2 virtual rows
constexpr int MT1 = M1 / (16 * kWarpsM);
constexpr int MT2 = M2 / (16 * kWarpsM);
static_assert(MT1 * 16 * kWarpsM == M1 && MT2 * 16 * kWarpsM == M2, "row split");
// A tap reads up to 2 * kRowPx + 2 rows past the virtual row it computes.
constexpr int IN_PIX = IN_ROWS * kRowPx + 16;
constexpr int HID_PIX = M1 + 16;
static_assert(M1 - 1 + 2 * kRowPx + 2 < IN_PIX, "conv1 reads inside the window");
static_assert(M2 - 1 + 2 * kRowPx + 2 < HID_PIX, "conv2 reads inside the hidden tile");

template <int C>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(IN_PIX + HID_PIX) * smem_ld(C) + 2 * kKChunk * smem_ld(C)) * 2 +
         kWarps * 256 * sizeof(float);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const float* __restrict__ b1, const bf16* __restrict__ w2,
                    const float* __restrict__ b2, bf16* __restrict__ out, int H, int W,
                    float res_scale) {
  constexpr int LD = smem_ld(C);
  constexpr int NT = C / (16 * kWarpsN);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* in_s = reinterpret_cast<bf16*>(smem);
  bf16* hid_s = in_s + IN_PIX * LD;
  bf16* b_s = hid_s + HID_PIX * LD;
  float* st = reinterpret_cast<float*>(b_s + 2 * kKChunk * LD) + (threadIdx.x / 32) * 256;

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int row = lane >> 1, col = (lane & 1) * 8;

  load_window<C>(in_s, x, b, H, W, ty0 - 2, tx0 - 2, IN_ROWS, IN_PIX - IN_ROWS * kRowPx);
  for (int i = threadIdx.x; i < (HID_PIX - M1) * (C / 8); i += kThreads)
    *reinterpret_cast<uint4*>(hid_s + (M1 + i / (C / 8)) * LD + (i % (C / 8)) * 8) =
        make_uint4(0u, 0u, 0u, 0u);

  // conv1 + b1, ReLU, ring mask, bf16 -> hidden tile.
  {
    FragC acc[MT1][NT];
    conv3x3_mma<C, MT1, NT>(acc, in_s, w1, C, 0, b_s);
#pragma unroll
    for (int mi = 0; mi < MT1; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const float* v = stage_fragment(acc[mi][ni], st);
        const int q = (wm * MT1 + mi) * 16 + row;
        const int n = (wn * NT + ni) * 16 + col;
        const int hy = q / kRowPx, hx = q % kRowPx;
        const int gy = ty0 - 1 + hy, gx = tx0 - 1 + hx;
        const bool inside = hx < TW + 2 && gy >= 0 && gy < H && gx >= 0 && gx < W;
        float h[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = inside ? fmaxf(v[j] + b1[n + j], 0.0f) : 0.0f;
        *reinterpret_cast<uint4*>(hid_s + q * LD + n) = pack8(h);
        __syncwarp();
      }
    }
  }

  // conv2 + b2, scaled residual in f32, one bf16 rounding -> out.
  {
    FragC acc[MT2][NT];
    conv3x3_mma<C, MT2, NT>(acc, hid_s, w2, C, 0, b_s);
#pragma unroll
    for (int mi = 0; mi < MT2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const float* v = stage_fragment(acc[mi][ni], st);
        const int r = (wm * MT2 + mi) * 16 + row;
        const int n = (wn * NT + ni) * 16 + col;
        const int oy = r / kRowPx, ox = r % kRowPx;
        const int gy = ty0 + oy, gx = tx0 + ox;
        if (ox < TW && gy < H && gx < W) {
          float core[8], o[8];
          unpack8(*reinterpret_cast<const uint4*>(in_s + ((oy + 2) * kRowPx + ox + 2) * LD + n),
                  core);
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j] = core[j] + res_scale * (v[j] + b2[n + j]);
          *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * H + gy) * W + gx) * C + n) =
              pack8(o);
        }
        __syncwarp();
      }
    }
  }
}

template <int C>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int batch, int H, int W, float res_scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(resblock_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, batch);
  resblock_kernel<C><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), H,
      W, res_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pesr

// x, out: [batch, H, W, C] bf16 NHWC (out must not alias x); w1, w2:
// [3, 3, C, C] bf16 HWIO; b1, b2: [C] f32.  Returns the CUDA error code of
// the launch (0 = launched).  C must be 64, 128 or 256.
extern "C" int pesr_fused_resblock(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* out, int batch,
                                   int H, int W, int C, float res_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64:
      return pesr::launch<64>(x, w1, b1, w2, b2, out, batch, H, W, res_scale, s);
    case 128:
      return pesr::launch<128>(x, w1, b1, w2, b2, out, batch, H, W, res_scale, s);
    case 256:
      return pesr::launch<256>(x, w1, b1, w2, b2, out, batch, H, W, res_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
