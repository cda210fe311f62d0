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
// Blend design. One block per (image, band of rows sharing ty1 and ty2):
// tiles_y + 1 bands an image. The block turns its two LUT rows into a table
// of 32-bit words, one per (tile column pair, value), holding the four LUT
// entries a pixel needs as bytes (the LUTs hold the integers 0..255, so the
// bytes are exact): one shared-memory load a pixel. Rows are padded by one
// word, so equal values in different tile columns fall in different banks.
// Each thread then blends 16 consecutive pixels a step with one 16-byte
// load and one 16-byte store; a band's rows are contiguous in memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kMaxLutWarps = 8;     // warps of a tile-LUT block
constexpr int kBlendThreads = 128;  // threads of a blend block
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

struct BlendRow {
  float ya, oma;  // the row's weight ya and 1 - ya
};

__device__ __forceinline__ BlendRow blend_row(int y, float ry) {
  const float f = tile_coord(y, ry);
  const float ya = __fsub_rn(f, floorf(f));
  return {ya, __fsub_rn(1.0f, ya)};
}

// the blended, mapped pixel of value v at column x
__device__ __forceinline__ uint32_t blend_pixel(uint32_t v, float xf, BlendRow row, float rx,
                                                int tiles_x, const uint32_t* table,
                                                const uint8_t* omap) {
  const float f = __fmaf_rn(xf, rx, -0.5f);
  const float j = floorf(f);
  const float xa = __fsub_rn(f, j);
  const float oma = __fsub_rn(1.0f, xa);
  // table column floor(f) + 1, read from the float's low bits
  const int e = min(__float_as_int(__fadd_rn(j, kMagic + 1.0f)) - __float_as_int(kMagic), tiles_x);
  const uint32_t q = table[e * kTableStride + v];
  const float top = __fmaf_rn(byte_f(q, 0), oma, __fmul_rn(byte_f(q, 2), xa));
  const float bottom = __fmaf_rn(byte_f(q, 1), oma, __fmul_rn(byte_f(q, 3), xa));
  float res = __fmaf_rn(top, row.oma, __fmul_rn(bottom, row.ya));
  res = fminf(fmaxf(res, 0.0f), 255.0f);
  return omap[__float_as_uint(__fadd_rn(res, kMagic)) & 0xffu];  // rint: half to even
}

__global__ void __launch_bounds__(kBlendThreads)
clahe_blend_kernel(const uint8_t* __restrict__ imgs, const float* __restrict__ luts,
                   const uint8_t* __restrict__ out_map, uint8_t* __restrict__ out, int h, int w,
                   int tiles_x, int th, float ry, float rx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles_y = gridDim.x - 1;
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);  // [tiles_x + 1][kTableStride]
  uint8_t* lut_rows = smem + (tiles_x + 1) * kTableStride * sizeof(uint32_t);  // [2][tiles_x][256]
  uint8_t* omap = lut_rows + 2 * tiles_x * kBins;
  const int i = static_cast<int>(blockIdx.x) - 1;  // floor(tile_coord) of the band's rows
  const int img = blockIdx.y;
  const int ty1 = max(i, 0);
  const int ty2 = min(i + 1, tiles_y - 1);

  // the band's two LUT rows as bytes, and the output map
  const int per_row = tiles_x * kBins / 4;
  for (int k = threadIdx.x; k < 2 * per_row; k += blockDim.x) {
    const int second = k >= per_row;
    const size_t t0 = (static_cast<size_t>(img) * tiles_y + (second ? ty2 : ty1)) * tiles_x;
    const float4 v = reinterpret_cast<const float4*>(luts + t0 * kBins)[k - second * per_row];
    reinterpret_cast<uchar4*>(lut_rows)[k] =
        make_uchar4(static_cast<unsigned char>(__float2uint_rn(v.x)),
                    static_cast<unsigned char>(__float2uint_rn(v.y)),
                    static_cast<unsigned char>(__float2uint_rn(v.z)),
                    static_cast<unsigned char>(__float2uint_rn(v.w)));
  }
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) omap[k] = out_map[k];
  __syncthreads();

  // table[e][v]: the four entries of a pixel of value v in column pair e =
  // floor(fx) + 1, as bytes (ty1,tx1), (ty2,tx1), (ty1,tx2), (ty2,tx2)
  for (int k = threadIdx.x; k < (tiles_x + 1) * kBins; k += blockDim.x) {
    const int e = k / kBins;
    const int v = k - e * kBins;
    const int c1 = max(e - 1, 0);
    const int c2 = min(e, tiles_x - 1);
    const uint8_t* a = lut_rows;
    const uint8_t* b = lut_rows + tiles_x * kBins;
    table[e * kTableStride + v] = a[c1 * kBins + v] | b[c1 * kBins + v] << 8 |
                                  a[c2 * kBins + v] << 16 | b[c2 * kBins + v] << 24;
  }
  __syncthreads();

  const int y_beg = i < 0 ? 0 : band_start(i, h, th, ry);
  const int y_end = i + 1 >= tiles_y ? h : band_start(i + 1, h, th, ry);
  const size_t img0 = static_cast<size_t>(img) * h * w;
  const size_t s = img0 + static_cast<size_t>(y_beg) * w;
  const size_t e = img0 + static_cast<size_t>(y_end) * w;
  for (size_t k = (s >> 4) + threadIdx.x; (k << 4) < e; k += blockDim.x) {
    const size_t a = k << 4;
    const size_t first = a > s ? a : s;
    const size_t last = a + 16 < e ? a + 16 : e;
    const int o = static_cast<int>(first - img0);
    int y = o / w;
    int x = o - y * w;
    float xf = static_cast<float>(x);
    BlendRow row = blend_row(y, ry);
    if (first == a && last == a + 16) {  // the whole chunk is this band's
      const uint4 in = *reinterpret_cast<const uint4*>(imgs + a);
      const uint32_t iw[4] = {in.x, in.y, in.z, in.w};
      uint32_t ow[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t v = (iw[j >> 2] >> (8 * (j & 3))) & 0xffu;
        ow[j >> 2] |= blend_pixel(v, xf, row, rx, tiles_x, table, omap) << (8 * (j & 3));
        xf += 1.0f;
        if (++x == w) {
          x = 0;
          xf = 0.0f;
          row = blend_row(++y, ry);
        }
      }
      *reinterpret_cast<uint4*>(out + a) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    } else {  // shared with the next band or image, or the tensor's end
      for (size_t g = first; g < last; ++g) {
        out[g] = static_cast<uint8_t>(blend_pixel(imgs[g], xf, row, rx, tiles_x, table, omap));
        xf += 1.0f;
        if (++x == w) {
          x = 0;
          xf = 0.0f;
          row = blend_row(++y, ry);
        }
      }
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
  const size_t smem = static_cast<size_t>(tiles_x + 1) * kTableStride * sizeof(uint32_t) +
                      2 * static_cast<size_t>(tiles_x) * kBins + kBins;
  const int err = dynamic_smem(reinterpret_cast<const void*>(clahe_blend_kernel), smem);
  if (err != 0) return err;
  const dim3 grid(tiles_y + 1, n);
  clahe_blend_kernel<<<grid, kBlendThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      imgs, luts, out_map, out, h, w, tiles_x, th, ry, rx);
  return static_cast<int>(cudaGetLastError());
}
