// Proto-mask union for Hopper (sm_90a).
//
// Replaces tpu_mslesseg/infer/mask_union_pallas.py::_union_kernel.
//
// For each image n and proto pixel (row, col):
//   out[n, row, col] = max over kept detections k whose box (letterbox px,
//                      divided by the proto stride) holds the pixel
//                      (x1 <= col < x2, y1 <= row < y2) of coef[n, k] . proto[n, row, col]
//   and -1e4 where no kept box holds the pixel. Only slots below n_active
//   (highest kept slot + 1, computed on the device by the wrapper and read
//   here, so the host never syncs) are looked at. The [N, K, mh, mw]
//   per-detection tensor never exists.
//
// bf16 proto and bf16 coefficients, the serving path (mask_union_mma_kernel).
// One block of 256 threads covers an 8-row strip of one image and walks
// its 8 x 32 pixel tiles; warp w owns row w of each tile, 32 pixels. Once
// per strip the block reads each detection slot below n_active: a kept
// box's columns, the strip rows it holds as a bit mask (x1 <= col < x2 is
// ceil(x1) <= col < ceil(x2) for an integer col, so a box is a run of
// bits), and its coefficients, into shared memory. Per tile the warps
// cp.async their rows of proto (64 B a pixel, each read from device memory
// once), and all 256 threads turn each slot's columns into a bit mask of
// the tile's columns and compact the slots that hold a pixel of the tile,
// in slot order, padded to a multiple of 8 with a zero row that holds no
// pixel. Each warp then loads its pixels as mma A fragments with ldmatrix
// (two m16 tiles, two k16 steps, held in registers), and per n8 tile of
// staged detections that meets its row computes [32 pixels x 32] . [32 x
// 8 detections] with mma.sync m16n8k16 bf16 into f32 accumulators; the B
// fragments come from one ldmatrix whose lanes give the staged slots' rows.
// Each accumulator element is a known (pixel, detection) pair: one bit
// test of the detection's column mask selects it into a running max in
// registers, and the four lanes of a quad (which hold different detections
// of the same pixels) combine their maxima with shuffles at the end. The
// union is written once, 128 B a warp. Rows of proto and coefficients in
// shared memory have their 16-byte chunks swizzled by (row / 2) % 4, so
// the eight rows ldmatrix reads for a matrix of consecutive rows sit in
// distinct banks.
//
// f32 coefficients (the f32 model, or callers that pass them) take the FMA
// path (mask_union_fma_kernel): one pixel a thread, 256 consecutive pixels
// a block, detections filtered by the block's rows, a box test and a
// 32-term f32 dot product per (pixel, detection).
//
// What bounds it on an H100. Device memory: each proto pixel is read once
// (N*160*160*64 B in bf16, 983 MB at N=600, about 0.29 ms at 3.35 TB/s) and
// the f32 union written once (61 MB). Arithmetic: 64 flops per (pixel,
// kept detection whose box holds it); 85 kept detections per image over
// all 600 images is 84 GFLOP, about 0.09 ms on the bf16 tensor cores (989
// TFLOP/s) but 1.25 ms on the f32 FMA pipe (67 TFLOP/s). So the mma kernel
// is bound by bytes, where the FMA kernel is bound by FMAs. Measured
// (tools/kernel_ab.py, H100 SXM at 700 W), its time per image hardly
// follows the number of kept detections: what is left above the bytes is
// each tile's chain of dependent steps (proto copy, slot scan, products).
// Reading the slots once per strip rather than once per tile, and scanning
// them with all eight warps rather than one, is what brought it near its
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNM = 32;        // mask coefficients per detection
constexpr int kThreads = 256;  // pixels per block, one per thread
constexpr float kNeg = -1e4f;  // the reference's _NEG

__device__ __forceinline__ void load_pixel(const float* p, float (&v)[kNM]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kNM / 4; ++i) {
    const float4 t = q[i];
    v[4 * i + 0] = t.x;
    v[4 * i + 1] = t.y;
    v[4 * i + 2] = t.z;
    v[4 * i + 3] = t.w;
  }
}

__device__ __forceinline__ void load_pixel(const __nv_bfloat16* p,
                                           float (&v)[kNM]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kNM / 8; ++i) {
    const uint4 t = q[i];
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned short lo = static_cast<unsigned short>(w[j] & 0xffffu);
      const unsigned short hi = static_cast<unsigned short>(w[j] >> 16);
      v[8 * i + 2 * j + 0] = __bfloat162float(__ushort_as_bfloat16(lo));
      v[8 * i + 2 * j + 1] = __bfloat162float(__ushort_as_bfloat16(hi));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mask_union_fma_kernel(const T* __restrict__ proto, const float* __restrict__ coef,
                  const float* __restrict__ boxes,
                  const uint8_t* __restrict__ keep,
                  const int* __restrict__ n_active, float* __restrict__ out,
                  int npix, int mw, int k, float stride) {
  extern __shared__ float4 smem[];
  float4* box_s = smem;                                     // [k]
  float* coef_s = reinterpret_cast<float*>(box_s + k);      // [k][kNM]
  int* slot_s = reinterpret_cast<int*>(coef_s + k * kNM);   // [k]
  __shared__ int n_live;

  const int img = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int p_last = min(p0 + kThreads, npix) - 1;
  const float row_lo = static_cast<float>(p0 / mw);
  const float row_hi = static_cast<float>(p_last / mw);
  const int nact = min(n_active[img], k);
  const size_t det0 = static_cast<size_t>(img) * k;

  if (threadIdx.x < 32) {  // warp 0: compact the live detections
    const int lane = threadIdx.x;
    int base = 0;
    for (int s0 = 0; s0 < nact; s0 += 32) {
      const int s = s0 + lane;
      bool live = false;
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < nact && keep[det0 + s]) {
        const float* bp = boxes + (det0 + s) * 4;
        b = make_float4(bp[0] / stride, bp[1] / stride, bp[2] / stride,
                        bp[3] / stride);
        // can the box hold a pixel of the tile's rows? (y1 <= row < y2)
        live = b.w > row_lo && b.y <= row_hi;
      }
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int pos = base + __popc(m & ((1u << lane) - 1u));
        box_s[pos] = b;
        slot_s[pos] = s;
      }
      base += __popc(m);
    }
    if (lane == 0) n_live = base;
  }
  __syncthreads();
  const int nk = n_live;
  for (int i = threadIdx.x; i < nk * kNM; i += kThreads) {
    coef_s[i] = coef[(det0 + slot_s[i / kNM]) * kNM + i % kNM];
  }
  __syncthreads();

  const int p = p0 + threadIdx.x;
  if (p >= npix) return;
  const float row = static_cast<float>(p / mw);
  const float col = static_cast<float>(p % mw);
  float v[kNM];
  load_pixel(proto + (static_cast<size_t>(img) * npix + p) * kNM, v);
  float acc = kNeg;
  for (int j = 0; j < nk; ++j) {
    const float4 b = box_s[j];
    if (col >= b.x && col < b.z && row >= b.y && row < b.w) {
      const float* c = coef_s + j * kNM;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kNM; ++i) d = fmaf(c[i], v[i], d);
      acc = fmaxf(acc, d);
    }
  }
  out[static_cast<size_t>(img) * npix + p] = acc;
}

// ---------------------------------------------------------------------------
// bf16 x bf16: the dot products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTileH = 8;   // pixel tile rows, one warp each
constexpr int kTileW = 32;  // pixel tile columns

// element offset of 16-byte chunk `ch` of 64-byte row `r` in a swizzled
// [rows][32] bf16 array
__device__ __forceinline__ int swz(int r, int ch) { return r * kNM + ((ch ^ ((r >> 1) & 3)) << 3); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared memory: the proto tile; per detection slot its 32 coefficients,
// its box's columns and the rows of the block's strip it holds (one more
// slot, of zeros, for padding); per staged detection of the tile its slot
// and column mask
size_t mma_smem_bytes(int k) {
  const size_t kpad = (static_cast<size_t>(k) + 7) / 8 * 8;
  return kTileH * kTileW * kNM * sizeof(__nv_bfloat16) +
         (k + 1) * (kNM * sizeof(__nv_bfloat16) + sizeof(float2) + sizeof(uint32_t)) +
         kpad * (sizeof(int) + sizeof(uint32_t));
}

// bit j (j < n) set where a <= origin + j < b: for an integer x, a <= x iff
// ceil(a) <= x and x < b iff x < ceil(b), so the set is a run of bits
__device__ __forceinline__ uint32_t span_mask(float a, float b, int origin, int n) {
  const float ca = ceilf(a), cb = ceilf(b);
  if (!(ca < cb)) return 0u;  // empty, or not a number
  const int lo = static_cast<int>(fminf(fmaxf(ca - origin, 0.f), static_cast<float>(n)));
  const int hi = static_cast<int>(fminf(fmaxf(cb - origin, 0.f), static_cast<float>(n)));
  if (hi <= lo) return 0u;
  return (hi >= 32 ? 0xffffffffu : (1u << hi) - 1u) & ~((1u << lo) - 1u);
}

__global__ void __launch_bounds__(kThreads)
mask_union_mma_kernel(const __nv_bfloat16* __restrict__ proto,
                      const __nv_bfloat16* __restrict__ coef,
                      const float* __restrict__ boxes, const uint8_t* __restrict__ keep,
                      const int* __restrict__ n_active, float* __restrict__ out, int mh,
                      int mw, int k, float stride) {
  extern __shared__ uint4 smem_u4[];
  const int kpad = (k + 7) & ~7;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_u4);   // [256][32]
  __nv_bfloat16* coef_s = tile + kTileH * kTileW * kNM;               // [k + 1][32]
  float2* cols_s = reinterpret_cast<float2*>(coef_s + (k + 1) * kNM);  // [k + 1]: x1, x2
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(cols_s + k + 1);      // [k + 1]
  int* slot_s = reinterpret_cast<int*>(rows_s + k + 1);                // [kpad]
  uint32_t* cmask_s = reinterpret_cast<uint32_t*>(slot_s + kpad);      // [kpad]
  __shared__ int warp_live[kTileH];  // live detections a warp found in this pass

  const int img = blockIdx.y;
  const int r0 = blockIdx.x * kTileH;  // the block's strip: rows r0 .. r0 + 7
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = r0 + warp;
  const size_t npix = static_cast<size_t>(mh) * mw;
  const int nact = min(n_active[img], k);
  const size_t det0 = static_cast<size_t>(img) * k;

  // once per strip: each slot's box (empty unless kept), the strip rows it
  // holds, and the kept detections' coefficients; a zero row for padding
  for (int s = threadIdx.x; s < nact; s += kThreads) {
    const float4 b = reinterpret_cast<const float4*>(boxes)[det0 + s];
    const bool kept = keep[det0 + s] != 0;
    cols_s[s] = kept ? make_float2(b.x / stride, b.z / stride) : make_float2(0.f, 0.f);
    rows_s[s] = kept ? span_mask(b.y / stride, b.w / stride, r0, kTileH) : 0u;
  }
  for (int i = threadIdx.x; i < nact * 4; i += kThreads) {
    const int s = i >> 2, ch = i & 3;
    if (keep[det0 + s]) {
      *reinterpret_cast<uint4*>(coef_s + swz(s, ch)) =
          reinterpret_cast<const uint4*>(coef + (det0 + s) * kNM)[ch];
    }
  }
  if (threadIdx.x < 4) {
    *reinterpret_cast<uint4*>(coef_s + swz(k, threadIdx.x)) = make_uint4(0u, 0u, 0u, 0u);
  } else if (threadIdx.x == 4) {
    rows_s[k] = 0u;
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* prow = proto + (img * npix + static_cast<size_t>(row) * mw) * kNM;
  for (int c0 = 0; c0 < mw; c0 += kTileW) {
    // this warp's row of the tile: 32 pixels x 4 chunks of 16 B, zeros off
    // the map
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = it * 32 + lane;
      const int i = idx >> 2, ch = idx & 3;
      __nv_bfloat16* dst = tile + swz(warp * kTileW + i, ch);
      if (row < mh && c0 + i < mw) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                     "l"(prow + static_cast<size_t>(c0 + i) * kNM + ch * 8));
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    asm volatile("cp.async.commit_group;\n");

    // compact the kept detections that hold a pixel of the tile, in slot
    // order across the warps
    int nk = 0;
    for (int s0 = 0; s0 < nact; s0 += kThreads) {
      const int s = s0 + threadIdx.x;
      uint32_t cm = 0u;
      if (s < nact && rows_s[s] != 0u) cm = span_mask(cols_s[s].x, cols_s[s].y, c0, kTileW);
      const unsigned m = __ballot_sync(0xffffffffu, cm != 0u);
      if (lane == 0) warp_live[warp] = __popc(m);
      __syncthreads();
      int pos = nk + __popc(m & ((1u << lane) - 1u));
      for (int w = 0; w < kTileH; ++w) {
        pos += w < warp ? warp_live[w] : 0;
        nk += warp_live[w];
      }
      if (cm != 0u) {
        slot_s[pos] = s;
        cmask_s[pos] = cm;
      }
      __syncthreads();  // warp_live is read before the next pass writes it
    }
    const int nk8 = (nk + 7) & ~7;
    if (threadIdx.x < nk8 - nk) {  // padding: the zero row, holding no pixel
      slot_s[nk + threadIdx.x] = k;
      cmask_s[nk + threadIdx.x] = 0u;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    if (row < mh) {
      // A fragments: pixel mt*16 + (lane % 16), chunk 2*ks + lane / 16
      uint32_t a[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          ldmatrix_x4(a[mt][ks], tile + swz(warp * kTileW + mt * 16 + (lane & 15),
                                            2 * ks + (lane >> 4)));
      // accumulator element e of pixel tile mt: pixel mt*16 + g + 8*(e/2),
      // detection 2t + e%2 of the n8 tile; with the column mask shifted
      // right by g, the pixel's bit is mt*16 + 8*(e/2)
      float best[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) best[mt][hh] = kNeg;
      for (int d0 = 0; d0 < nk8; d0 += 8) {
        uint32_t m[2];  // detections 2t, 2t + 1: their masks of this row's pixels
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int d = d0 + 2 * t + u;
          m[u] = ((rows_s[slot_s[d]] >> warp) & 1u) ? cmask_s[d] >> g : 0u;
        }
        if (!__any_sync(0xffffffffu, (m[0] | m[1]) != 0u)) continue;  // none in this row
        uint32_t b[4];  // (ks 0: b0, b1), (ks 1: b0, b1): chunks 0..3 of 8 detections
        ldmatrix_x4(b, coef_s + swz(slot_s[d0 + (lane & 7)], lane >> 3));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(c, a[mt][0], b[0], b[1]);
          mma_bf16(c, a[mt][1], b[2], b[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (m[e & 1] & (1u << (mt * 16 + 8 * (e >> 1)))) {
              best[mt][e >> 1] = fmaxf(best[mt][e >> 1], c[e]);
            }
          }
        }
      }
      // the quad's lanes hold other detections of the same pixels
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          best[mt][hh] = fmaxf(best[mt][hh], __shfl_xor_sync(0xffffffffu, best[mt][hh], 1));
          best[mt][hh] = fmaxf(best[mt][hh], __shfl_xor_sync(0xffffffffu, best[mt][hh], 2));
        }
      // lane l writes pixel l = mt*16 + hh*8 + g', held by lane 4*g'
      float v = kNeg;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float s = __shfl_sync(0xffffffffu, best[mt][hh], 4 * (lane & 7));
          if ((lane >> 4) == mt && ((lane >> 3) & 1) == hh) v = s;
        }
      if (c0 + lane < mw) out[img * npix + static_cast<size_t>(row) * mw + c0 + lane] = v;
    }
    __syncthreads();  // the tile, slots and masks are rewritten for the next tile
  }
}

template <typename T>
cudaError_t launch_fma(const void* proto, const float* coef, const float* boxes,
                       const uint8_t* keep, const int* n_active, float* out, int n,
                       int npix, int mw, int k, float stride, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(k) * (sizeof(float4) + kNM * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mask_union_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((npix + kThreads - 1) / kThreads, n);
  mask_union_fma_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(proto), coef, boxes, keep, n_active, out, npix, mw,
      k, stride);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* proto, const void* coef, const float* boxes,
                       const uint8_t* keep, const int* n_active, float* out, int n,
                       int mh, int mw, int k, float stride, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mask_union_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((mh + kTileH - 1) / kTileH, n);
  mask_union_mma_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(proto), static_cast<const __nv_bfloat16*>(coef),
      boxes, keep, n_active, out, mh, mw, k, stride);
  return cudaGetLastError();
}

}  // namespace

// proto [n, mh, mw, nm] (bf16 when proto_bf16, else f32); coef [n, k, nm]
// (bf16 when coef_bf16, else f32; bf16 only with bf16 proto, which takes
// the tensor-core kernel); boxes [n, k, 4] f32 letterbox px; keep [n, k]
// uint8; n_active [n] int32; out [n, mh, mw] f32. All contiguous and
// 16-byte aligned on the current device. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int mask_union_logits(const void* proto, int proto_bf16, const void* coef,
                                 int coef_bf16, const float* boxes, const uint8_t* keep,
                                 const int* n_active, float* out, int n, int mh, int mw,
                                 int k, int nm, float stride, void* stream) {
  if (nm != kNM || n <= 0 || n > 65535 || mh <= 0 || mw <= 0 || k <= 0 ||
      (coef_bf16 && !proto_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(coef);
  cudaError_t e;
  if (coef_bf16) {
    e = launch_mma(proto, coef, boxes, keep, n_active, out, n, mh, mw, k, stride, s);
  } else if (proto_bf16) {
    e = launch_fma<__nv_bfloat16>(proto, cf, boxes, keep, n_active, out, n, mh * mw, mw, k,
                                  stride, s);
  } else {
    e = launch_fma<float>(proto, cf, boxes, keep, n_active, out, n, mh * mw, mw, k, stride, s);
  }
  return static_cast<int>(e);
}
