// CLAHE for Hopper (sm_90a): the tile LUTs and the blend that applies them.
//
// clahe_tile_luts replaces tpu_mslesseg/preproc/clahe_pallas.py::_tile_lut_kernel.
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
// clahe_blend replaces the apply after the LUTs: the four-LUT bilinear blend
// of tpu_mslesseg/preproc/enhance.py::_clahe_core, which the TPU module
// computes as one-hot matmuls outside its pallas_call (clahe_pallas.py:86).
// Per pixel (y, x) of value v, with f = fma(i, 1/tile, -0.5) per axis:
//   ya, xa = f - floor(f); ty1, ty2, tx1, tx2 = floor(f) and floor(f) + 1, clamped
//   top    = fma(lut[ty1][tx1][v], 1 - xa, lut[ty1][tx2][v] * xa)
//   bottom = fma(lut[ty2][tx1][v], 1 - xa, lut[ty2][tx2][v] * xa)
//   out    = out_map[clip(rint(fma(top, 1 - ya, bottom * ya)), 0, 255)]
// every product, difference and FMA rounded as written (the _rn intrinsics:
// nvcc would otherwise contract a*b+c on its own), which is how the
// reference's compiled program rounds them. out_map is the backward LAB map.
//
// What bounds them on an H100. At the main path's shapes (three launches of
// 200 images of 182x218, 182x182 and 218x182, 64 tiles each) the tile LUTs
// move 21 MB (the L images in, the f32 LUTs out), some 6 us a launch at 3.35
// TB/s; the blend 29 MB (L images and LUTs in, the image out), some 9 us a
// launch. The work per byte is small: what a launch costs before it moves a
// byte, the histogram's shared-memory atomics and the blend's per-pixel
// instructions set the time, not the bytes (tools/kernel_ab.py --ablate).
//
// Tile-LUT design. One block per (image, tile row), one warp per tile (a
// block holds at most kMaxLutWarps; more tiles in a row loop). The block
// copies its band of th image rows into shared memory as the bytes lie in
// the tensor (rows inside the image are th*w contiguous bytes: 16-byte loads
// and stores); only the last band has REFLECT_101 rows, copied row by row.
// A warp reads its tile's pixels at a running row and column, 32 a step, no
// division; only the last tile of a row has REFLECT_101 columns, mapped back
// by one compare at the read. After the one barrier each warp counts its
// tile into a private 256-bin histogram with one shared-memory atomic a
// pixel. Aggregating equal values across the warp first (__match_any_sync,
// the leader adding the group's __popc) was measured slower on an H100 on
// uniform and on background-heavy images alike: match.any costs more than
// the conflicts it saves (tools/kernel_ab.py --ablate times it). Then each
// lane owns 8 consecutive bins: clip, the excess summed with
// __reduce_add_sync, the redistribution, a prefix over its 8 bins and a
// 5-step shuffle scan of the lane totals, and two float4 stores: the warp
// writes its tile's 1 KB LUT contiguously. No block barrier after staging.
//
// Blend design. The first kernel ran one block of 128 threads per (image,
// band of rows sharing ty1 and ty2); each thread blended 16 consecutive
// bytes a step, and every pixel redid its column's arithmetic and tested
// for a row's end, so its pixel loop cost some 70 instructions a pixel. Now
// a CTA still takes kBandsPerCta bands of an image (1,800 CTAs a launch of
// 200 images), but a thread takes a column:
//   1. the setup: for each of its rows ya, 1 - ya and its band's table (a
//      broadcast read a row in the loop); the output map; and for each
//      band a table of 32-bit words, one per (tile column pair, value),
//      holding the four LUT entries a pixel needs as bytes (the LUTs hold
//      the integers 0..255, so the bytes are exact), built four values a
//      step straight from the f32 LUTs (16-byte loads, the low byte of
//      2^23 + v; the tile-LUT kernel has just written them to L2); rows of
//      the table are padded by one word, so equal values in different tile
//      columns fall in different banks;
//   2. the pixels: the thread's xa, 1 - xa and table column stay in
//      registers, and it walks the rows top to bottom, one byte in and one
//      out a row (a warp's bytes are 32 consecutive ones), a table load and
//      a map load between, no branch.
// Chosen by A/B on an H100 (tools/kernel_ab.py --ablate; PERF.md, section 6):
// a cluster of 4 CTAs an image that staged its LUT rows once and shared
// them through distributed shared memory, each CTA blending 16-byte chunks
// with a column table in shared memory, took 46-51 us a launch of 200
// images against the first kernel's 31; 2 or 3 bands a CTA, 2 or 4 columns a thread,
// two threads a column and a copy of the map for each lane were no faster.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBins = 256;
constexpr int kMaxLutWarps = 8;     // warps of a tile-LUT block
constexpr int kBlendThreads = 256;  // threads of a blend CTA at most: a thread a column
constexpr int kBandsPerCta = 1;     // bands of rows a blend CTA takes
constexpr int kTableStride = kBins + 1;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block can have
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMagic = 8388608.0f;  // 2^23: x + 2^23 holds rint(x) in its low bits

__device__ __forceinline__ int reflect101(int i, int n) {
  return i < n ? i : 2 * (n - 1) - i;
}

// Copies bytes [s, e) of the uint8 tensor at `base` (16-byte aligned) to
// `dst` + (s & 15) on, where `dst` is 16-byte aligned: so each 16-byte
// chunk of the tensor lands on one of shared memory, whole chunks with one
// vector load and store, the two partial ones byte by byte.
__device__ __forceinline__ void copy_bytes(const uint8_t* __restrict__ base, size_t s, size_t e,
                                           uint8_t* dst) {
  for (size_t k = (s >> 4) + threadIdx.x; (k << 4) < e; k += blockDim.x) {
    const size_t a = k << 4;
    uint8_t* d = dst + (a - (s & ~size_t(15)));
    if (a >= s && a + 16 <= e) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(base + a);
    } else {
      for (size_t g = a > s ? a : s; g < (a + 16 < e ? a + 16 : e); ++g) d[g - a] = base[g];
    }
  }
}

__global__ void __launch_bounds__(32 * kMaxLutWarps)
clahe_tile_lut_kernel(const uint8_t* __restrict__ imgs, float* __restrict__ luts, int h, int w,
                      int tiles_x, int th, int tw, int limit, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ty = blockIdx.x;
  const int tiles_y = gridDim.x;
  const int img = blockIdx.y;
  int* hist = reinterpret_cast<int*>(smem) + warp * kBins;  // this warp's
  uint8_t* band_area = smem + static_cast<size_t>(warps) * kBins * sizeof(int);

  reinterpret_cast<int4*>(hist)[2 * lane] = make_int4(0, 0, 0, 0);
  reinterpret_cast<int4*>(hist)[2 * lane + 1] = make_int4(0, 0, 0, 0);

  // the band [th][w]: image rows y0 .. y0 + th - 1, those past h by REFLECT_101
  const size_t img_row0 = static_cast<size_t>(img) * h;
  const int y0 = ty * th;
  const int inside = max(min(th, h - y0), 0);  // the rest lies past h
  const size_t s0 = (img_row0 + y0) * w;
  uint8_t* band = band_area + (s0 & 15);
  if (inside > 0) copy_bytes(imgs, s0, s0 + static_cast<size_t>(inside) * w, band_area);
  for (int r = inside; r < th; ++r) {
    const uint8_t* src = imgs + (img_row0 + reflect101(y0 + r, h)) * w;
    for (int c = threadIdx.x; c < w; c += blockDim.x) band[r * w + c] = src[c];
  }
  __syncthreads();

  // pixel p = s * 32 + lane of a tile at (row, column) (r, c), advanced by
  // 32 pixels a step without a division
  const int area = th * tw;
  const int steps = (area + 31) / 32;
  const int step_rows = 32 / tw;
  const int step_cols = 32 - step_rows * tw;
  const int r0 = lane / tw;
  const int c0 = lane - r0 * tw;
  for (int tx = warp; tx < tiles_x; tx += warps) {
    const int x0 = tx * tw;
    int r = r0, c = c0;
    for (int s = 0; s < steps; ++s) {
      if (s * 32 + lane < area) {
        atomicAdd(&hist[band[r * w + reflect101(x0 + c, w)]], 1);
      }
      r += step_rows;
      c += step_cols;
      if (c >= tw) {
        c -= tw;
        ++r;
      }
    }
    __syncwarp();

    // lane owns bins 8*lane .. 8*lane + 7; it zeroes them for the next tile
    int cnt[8];
    {
      int4* mine = reinterpret_cast<int4*>(hist) + 2 * lane;
      const int4 a = mine[0], b = mine[1];
      cnt[0] = a.x, cnt[1] = a.y, cnt[2] = a.z, cnt[3] = a.w;
      cnt[4] = b.x, cnt[5] = b.y, cnt[6] = b.z, cnt[7] = b.w;
      mine[0] = make_int4(0, 0, 0, 0);
      mine[1] = make_int4(0, 0, 0, 0);
    }
    __syncwarp();

    int excess = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (cnt[j] > limit) {
        excess += cnt[j] - limit;
        cnt[j] = limit;
      }
    }
    const int clipped = __reduce_add_sync(kFull, excess);
    const int rb = clipped / kBins;
    const int residual = clipped - rb * kBins;
    const int step = kBins / max(residual, 1);  // >= 1: residual < 256
    // the residual goes to bins k * step, k < residual
    const int lo = 8 * lane;
    int k = (lo + step - 1) / step;
    int next = k * step;
    int run = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int add = rb;
      if (lo + j == next && k < residual) {
        ++add;
        next += step;
        ++k;
      }
      run += cnt[j] + add;
      cnt[j] = run;  // prefix over the lane's 8 bins
    }
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int before = incl - run;
    float out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = rintf(__fmul_rn(static_cast<float>(before + cnt[j]), scale));
      out[j] = fminf(fmaxf(v, 0.0f), 255.0f);
    }
    float4* dst = reinterpret_cast<float4*>(
        luts + ((static_cast<size_t>(img) * tiles_y + ty) * tiles_x + tx) * kBins) + 2 * lane;
    dst[0] = make_float4(out[0], out[1], out[2], out[3]);
    dst[1] = make_float4(out[4], out[5], out[6], out[7]);
  }
}

__device__ __forceinline__ float tile_coord(int i, float recip) {
  return __fmaf_rn(static_cast<float>(i), recip, -0.5f);
}

// the first row of [0, size) whose floor(tile_coord) is at least i
__device__ __forceinline__ int band_start(int i, int size, int tile, float recip) {
  int y = min(max(i * tile + tile / 2, 0), size);
  while (y > 0 && floorf(tile_coord(y - 1, recip)) >= static_cast<float>(i)) --y;
  while (y < size && floorf(tile_coord(y, recip)) < static_cast<float>(i)) ++y;
  return y;
}

// byte k of q as a float, exactly: the float 2^23 + byte, less 2^23
__device__ __forceinline__ float byte_f(uint32_t q, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(q, 0x4B000000u, 0x7440 | k)), kMagic);
}

// four LUT entries (the integers 0..255 as f32) as the low bytes of 2^23 + v
__device__ __forceinline__ uint4 lut_bytes(float4 v) {
  return make_uint4(__float_as_uint(__fadd_rn(v.x, kMagic)), __float_as_uint(__fadd_rn(v.y, kMagic)),
                    __float_as_uint(__fadd_rn(v.z, kMagic)), __float_as_uint(__fadd_rn(v.w, kMagic)));
}

// the table word of one value: the low bytes of a, b, c, d in that order
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__global__ void __launch_bounds__(kBlendThreads)
clahe_blend_kernel(const uint8_t* __restrict__ imgs, const float* __restrict__ luts,
                   const uint8_t* __restrict__ out_map, uint8_t* __restrict__ out, int h, int w,
                   int tiles_x, int tiles_y, int th, int rows_max, float ry, float rx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.y;
  const int band0 = blockIdx.x * kBandsPerCta;  // bands band0 .. band1: floor(tile_coord) + 1
  const int band1 = min(band0 + kBandsPerCta, tiles_y + 1) - 1;
  const int y_beg = band0 == 0 ? 0 : band_start(band0 - 1, h, th, ry);
  const int y_end = band1 >= tiles_y ? h : band_start(band1, h, th, ry);
  if (y_end <= y_beg) return;  // bands past the image (tiles of a few pixels)
  const int band_words = (tiles_x + 1) * kTableStride;
  float4* rows = reinterpret_cast<float4*>(smem);                      // [rows_max]
  uint8_t* omap = reinterpret_cast<uint8_t*>(rows + rows_max);          // [256]
  uint32_t* tables = reinterpret_cast<uint32_t*>(omap + kBins);         // [kBandsPerCta][band_words]

  // a row's weight ya, 1 - ya and its band's table (a word offset)
  for (int r = threadIdx.x; r < y_end - y_beg; r += blockDim.x) {
    const float f = tile_coord(y_beg + r, ry);
    const float j = floorf(f);
    const float ya = __fsub_rn(f, j);
    const int band = min(static_cast<int>(j) + 1, tiles_y);
    rows[r] = make_float4(ya, __fsub_rn(1.0f, ya), __int_as_float((band - band0) * band_words), 0.0f);
  }
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) omap[k] = out_map[k];
  // table[b][e][v]: the four entries a pixel of value v in column pair e =
  // floor(fx) + 1 of band band0 + b needs, as bytes (ty1,tx1), (ty2,tx1),
  // (ty1,tx2), (ty2,tx2); four values a step, straight from the f32 LUTs
  const float4* lut4 = reinterpret_cast<const float4*>(luts + static_cast<size_t>(img) * tiles_y *
                                                                  tiles_x * kBins);
  const int groups = (band1 - band0 + 1) * (tiles_x + 1) * (kBins / 4);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int v4 = g & (kBins / 4 - 1);
    const int be = g / (kBins / 4);
    const int e = be % (tiles_x + 1);
    const int b = be / (tiles_x + 1);
    const int t1 = max(band0 + b - 1, 0), t2 = min(band0 + b, tiles_y - 1);
    const int c1 = max(e - 1, 0), c2 = min(e, tiles_x - 1);
    const uint4 a = lut_bytes(lut4[(t1 * tiles_x + c1) * (kBins / 4) + v4]);
    const uint4 bb = lut_bytes(lut4[(t2 * tiles_x + c1) * (kBins / 4) + v4]);
    const uint4 c = lut_bytes(lut4[(t1 * tiles_x + c2) * (kBins / 4) + v4]);
    const uint4 d = lut_bytes(lut4[(t2 * tiles_x + c2) * (kBins / 4) + v4]);
    uint32_t* t = tables + b * band_words + e * kTableStride + 4 * v4;
    t[0] = pack4(a.x, bb.x, c.x, d.x);
    t[1] = pack4(a.y, bb.y, c.y, d.y);
    t[2] = pack4(a.z, bb.z, c.z, d.z);
    t[3] = pack4(a.w, bb.w, c.w, d.w);
  }
  __syncthreads();

  // a thread a column: its xa, 1 - xa and table column stay in registers,
  // and it walks the rows top to bottom, one byte in and one out a row
  const uint8_t* src = imgs + static_cast<size_t>(img) * h * w;
  uint8_t* dst = out + static_cast<size_t>(img) * h * w;
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const float f = tile_coord(x, rx);
    const float j = floorf(f);
    const float xa = __fsub_rn(f, j);
    const float oma = __fsub_rn(1.0f, xa);
    const uint32_t* col = tables + min(static_cast<int>(j) + 1, tiles_x) * kTableStride;
#pragma unroll 4
    for (int y = y_beg; y < y_end; ++y) {
      const float4 row = rows[y - y_beg];
      const int o = y * w + x;
      const uint32_t q = col[__float_as_int(row.z) + src[o]];
      const float top = __fmaf_rn(byte_f(q, 0), oma, __fmul_rn(byte_f(q, 2), xa));
      const float bottom = __fmaf_rn(byte_f(q, 1), oma, __fmul_rn(byte_f(q, 3), xa));
      // res lies in [0, 255 (1 + 2^-22)]: rint (half to even, the low byte
      // of 2^23 + res) is in 0..255 without the plain version's clamp
      const float res = __fmaf_rn(top, row.y, __fmul_rn(bottom, row.x));
      dst[o] = omap[__float_as_uint(__fadd_rn(res, kMagic)) & 0xffu];
    }
  }
}

int dynamic_smem(const void* kernel, size_t bytes) {
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// imgs [n, h, w] uint8 and luts [n, tiles_y * tiles_x, 256] f32, contiguous
// on the current device, imgs 16-byte aligned; th, tw the tile size and
// limit the clip limit as OpenCV sizes them; scale the float32 CDF scale.
// The REFLECT_101 extension must reach back less than the image:
// tiles_y*th - h < h and tiles_x*tw - w < w. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int clahe_tile_luts(const uint8_t* imgs, float* luts, int n, int h, int w,
                               int tiles_x, int tiles_y, int th, int tw, int limit,
                               float scale, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || w <= 0 || tiles_x <= 0 || tiles_y <= 0 || th <= 0 ||
      tw <= 0 || tiles_y * th - h >= h || tiles_x * tw - w >= w || tiles_y * th < h ||
      tiles_x * tw < w || reinterpret_cast<uintptr_t>(imgs) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int warps = tiles_x < kMaxLutWarps ? tiles_x : kMaxLutWarps;
  const size_t smem = static_cast<size_t>(warps) * kBins * sizeof(int) +
                      static_cast<size_t>(th) * w + 16;
  const int err = dynamic_smem(reinterpret_cast<const void*>(clahe_tile_lut_kernel), smem);
  if (err != 0) return err;
  const dim3 grid(tiles_y, n);
  clahe_tile_lut_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      imgs, luts, h, w, tiles_x, th, tw, limit, scale);
  return static_cast<int>(cudaGetLastError());
}

// imgs and out [n, h, w] uint8, luts [n, tiles_y * tiles_x, 256] f32 (the
// integers 0..255, as clahe_tile_luts writes them), out_map [256] uint8,
// all contiguous on the current device, imgs, out and luts 16-byte
// aligned; th, tw the tile size, ry and rx the float32 reciprocals of th
// and tw. Returns the CUDA error code of the launch (0 on success).
extern "C" int clahe_blend(const uint8_t* imgs, const float* luts, const uint8_t* out_map,
                           uint8_t* out, int n, int h, int w, int tiles_x, int tiles_y, int th,
                           int tw, float ry, float rx, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || w <= 0 || tiles_x <= 0 || tiles_y <= 0 || th <= 0 ||
      tw <= 0 || tiles_y * th < h || tiles_x * tw < w ||
      (reinterpret_cast<uintptr_t>(imgs) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(luts)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a band holds at most th + 1 rows
  const int rows_max = std::min(h, kBandsPerCta * (th + 1));
  const int band_words = (tiles_x + 1) * kTableStride;
  const size_t smem = static_cast<size_t>(rows_max) * sizeof(float4) + kBins +
                      static_cast<size_t>(kBandsPerCta) * band_words * sizeof(uint32_t);
  const int err = dynamic_smem(reinterpret_cast<const void*>(clahe_blend_kernel), smem);
  if (err != 0) return err;
  const int threads = std::min(kBlendThreads, (w + 31) / 32 * 32);
  const dim3 grid((tiles_y + kBandsPerCta) / kBandsPerCta, n);
  clahe_blend_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      imgs, luts, out_map, out, h, w, tiles_x, tiles_y, th, rows_max, ry, rx);
  return static_cast<int>(cudaGetLastError());
}
