// Proto-mask union for Hopper (sm_90a).
//
// Replaces tpu_mslesseg/infer/mask_union_pallas.py::_union_kernel.
//
// For each image n and proto pixel (row, col):
//   out[n, row, col] = max over kept detections k whose box (letterbox px,
//                      divided by the proto stride) holds the pixel
//                      (x1 <= col < x2, y1 <= row < y2) of coef[n, k] . proto[n, row, col]
//   and -1e4 where no kept box holds the pixel.
//
// Design. One block covers (image, tile of kThreads consecutive pixels);
// each thread owns one pixel and keeps its 32 proto values (contiguous in
// NHWC, 64 B in bf16) in registers. Warp 0 compacts the image's kept
// detections below n_active (highest kept slot + 1, computed on the device
// by the wrapper and read here, so the host never syncs) that can touch the
// tile's rows, staging their boxes and slots in shared memory; the block
// then stages their coefficients. Per pixel and staged detection: the box
// test first, then a 32-term f32 FMA dot product, then a running max. The
// [N, K, mh, mw] per-detection tensor never exists.
//
// What bounds it on an H100. Device memory: each proto pixel is read once
// (N*160*160*64 B in bf16, 983 MB at N=600, about 0.3 ms at 3.35 TB/s) and
// the f32 union written once. Arithmetic: 64 flops per (pixel, kept
// detection whose box holds it) on the f32 FMA pipe (67 TFLOP/s), so when
// many kept boxes cover the whole map the kernel is bound by FMAs, not
// bytes: 85 kept detections per image over all 600 images is 84 GFLOP,
// about 1.25 ms. The box test skips the products outside a box, and the row
// filter at staging drops detections that miss the tile. A simple first
// kernel: no tensor cores, TMA or wgmma yet.

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
mask_union_kernel(const T* __restrict__ proto, const float* __restrict__ coef,
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

template <typename T>
cudaError_t launch(const void* proto, const float* coef, const float* boxes,
                   const uint8_t* keep, const int* n_active, float* out, int n,
                   int npix, int mw, int k, float stride, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(k) * (sizeof(float4) + kNM * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mask_union_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((npix + kThreads - 1) / kThreads, n);
  mask_union_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(proto), coef, boxes, keep, n_active, out, npix, mw,
      k, stride);
  return cudaGetLastError();
}

}  // namespace

// proto [n, npix, nm] (bf16 when proto_bf16, else f32); coef [n, k, nm] f32;
// boxes [n, k, 4] f32 letterbox px; keep [n, k] uint8; n_active [n] int32;
// out [n, npix] f32. All contiguous on the current device. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int mask_union_logits(const void* proto, int proto_bf16,
                                 const float* coef, const float* boxes,
                                 const uint8_t* keep, const int* n_active,
                                 float* out, int n, int npix, int mw, int k,
                                 int nm, float stride, void* stream) {
  if (nm != kNM || n <= 0 || npix <= 0 || mw <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      proto_bf16
          ? launch<__nv_bfloat16>(proto, coef, boxes, keep, n_active, out, n,
                                  npix, mw, k, stride, s)
          : launch<float>(proto, coef, boxes, keep, n_active, out, n, npix, mw,
                          k, stride, s);
  return static_cast<int>(e);
}
