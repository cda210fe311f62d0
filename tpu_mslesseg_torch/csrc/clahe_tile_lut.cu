// CLAHE tile LUTs for Hopper (sm_90a).
//
// Replaces tpu_mslesseg/preproc/clahe_pallas.py::_tile_lut_kernel.
//
// For each image n and tile t = ty * tiles_x + tx of an [n, h, w] uint8
// L-channel batch, extended by REFLECT_101 to tiles_y*th x tiles_x*tw:
//   hist     = 256-bin histogram of the tile's th*tw pixels
//   clipped  = sum(max(hist - limit, 0)); hist = min(hist, limit)
//   rb       = clipped / 256; residual = clipped - rb * 256
//   step     = max(256 / max(residual, 1), 1)
//   hist[b] += rb + (b % step == 0 && b / step < residual)
//   lut[b]   = clip(rint(cdf[b] * scale), 0, 255)        (f32)
// with scale the float32 the reference multiplies by (255 / tile_area
// taken in double, rounded once to float; passed in, never divided here).
//
// Design. One block of 256 threads per (tile, image). The threads stride
// over the tile's pixels, reading them straight from the image with the
// REFLECT_101 index arithmetic (the padded tile tensor is never built), and
// count them in a shared-memory histogram with atomicAdd. Thread b then
// owns bin b: the clip, a block reduction of the clipped excess (warp
// shuffles, then the 8 warp sums), the redistribution, an inclusive scan of
// the 256 bins (warp shuffles, then the warp totals) and the store.
//
// What bounds it on an H100. Almost nothing: at the main path's shapes
// (600 slices of 182x218 and similar, 64 tiles each) it reads 24 MB of
// pixels once and writes 39 MB of LUTs, some 20 us of device memory time
// at 3.35 TB/s; the shared-memory atomics of a tile (at most 28x28 = 784
// pixels) and two 256-wide block reductions are the rest. A simple first
// kernel: it keeps each tile's whole pipeline in one block and no
// intermediate in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;  // one thread per bin
constexpr int kWarps = kBins / 32;

__device__ __forceinline__ int reflect101(int i, int n) {
  return i < n ? i : 2 * (n - 1) - i;
}

__global__ void __launch_bounds__(kBins)
clahe_tile_lut_kernel(const uint8_t* __restrict__ imgs, float* __restrict__ luts,
                      int h, int w, int tiles_x, int th, int tw, int limit,
                      float scale) {
  __shared__ int hist[kBins];
  __shared__ int warp_sum[kWarps];
  __shared__ int clipped_s;

  const int b = threadIdx.x;
  const int lane = b & 31;
  const int warp = b >> 5;
  const int tile = blockIdx.x;
  const int img = blockIdx.y;
  const int ty = tile / tiles_x;
  const int tx = tile % tiles_x;
  const uint8_t* src = imgs + static_cast<size_t>(img) * h * w;

  hist[b] = 0;
  __syncthreads();
  const int area = th * tw;
  for (int p = b; p < area; p += kBins) {
    const int y = reflect101(ty * th + p / tw, h);
    const int x = reflect101(tx * tw + p % tw, w);
    atomicAdd(&hist[src[static_cast<size_t>(y) * w + x]], 1);
  }
  __syncthreads();

  // clip, and the block sum of the clipped excess
  int count = hist[b];
  int excess = count > limit ? count - limit : 0;
  count = count < limit ? count : limit;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) excess += __shfl_xor_sync(0xffffffffu, excess, o);
  if (lane == 0) warp_sum[warp] = excess;
  __syncthreads();
  if (b == 0) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += warp_sum[i];
    clipped_s = s;
  }
  __syncthreads();

  // redistribution: a uniform share, then the residual at every step-th bin
  const int clipped = clipped_s;
  const int rb = clipped / kBins;
  const int residual = clipped - rb * kBins;
  const int r1 = residual > 1 ? residual : 1;
  const int step = kBins / r1 > 1 ? kBins / r1 : 1;
  count += rb + ((b % step == 0 && b / step < residual) ? 1 : 0);

  // inclusive scan over the 256 bins
  int cdf = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, cdf, o);
    if (lane >= o) cdf += v;
  }
  __syncthreads();  // every thread has read warp_sum above
  if (lane == 31) warp_sum[warp] = cdf;
  __syncthreads();
  for (int i = 0; i < warp; ++i) cdf += warp_sum[i];

  const float v = rintf(__fmul_rn(static_cast<float>(cdf), scale));
  luts[(static_cast<size_t>(img) * gridDim.x + tile) * kBins + b] =
      fminf(fmaxf(v, 0.0f), 255.0f);
}

}  // namespace

// imgs [n, h, w] uint8 and luts [n, tiles_y * tiles_x, 256] f32, contiguous
// on the current device; th, tw the tile size and limit the clip limit as
// OpenCV sizes them; scale the float32 CDF scale. The REFLECT_101 extension
// must reach back less than the image: tiles_y*th - h < h and tiles_x*tw -
// w < w. Returns the CUDA error code of the launch (0 on success).
extern "C" int clahe_tile_luts(const uint8_t* imgs, float* luts, int n, int h,
                               int w, int tiles_x, int tiles_y, int th, int tw,
                               int limit, float scale, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || w <= 0 || tiles_x <= 0 || tiles_y <= 0 ||
      th <= 0 || tw <= 0 || tiles_y * th - h >= h || tiles_x * tw - w >= w ||
      tiles_y * th < h || tiles_x * tw < w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(tiles_x * tiles_y, n);
  clahe_tile_lut_kernel<<<grid, kBins, 0, static_cast<cudaStream_t>(stream)>>>(
      imgs, luts, h, w, tiles_x, th, tw, limit, scale);
  return static_cast<int>(cudaGetLastError());
}
