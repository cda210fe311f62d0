// NMS's suppression for Hopper (sm_90a): the greedy keep mask of every image
// of a batch, one block an image, nothing in device memory between the
// candidates and the mask, no host read.
//
// It replaces no Pallas kernel. The JAX package (tpu_mslesseg/infer/nms.py
// nms_single) runs the suppression as a fixpoint in a lax.while_loop,
//   keep_i = valid_i and not any_j (j < i and IoU(i, j) > iou_thres and keep_j),
// from keep = valid, one [K, K] @ [K] matvec a step, with the loop's test on
// the device inside one XLA program. The port's plain version
// (infer/nms.py suppress_ref) runs the same steps from the host: about five
// kernels a step over a [B, K, K] float32 matrix and one bool read back to
// the host, so the card drains and idles once a step.
//
// The fixpoint converges to the exact greedy result (after step t the first
// t + 1 candidates are final), so this kernel computes the greedy result
// directly: the same keep, bit for bit.
//
// Numerics: each IoU as the plain box_iou_matrix rounds it on the card, every
// elementwise operation its own float32 rounding:
//   area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
//   wh   = (min(rb) - max(lt)).clamp(min=0), inter = w * h
//   iou  = inter / ((area_i + area_j) - inter).clamp(min=1e-7)
// then iou > iou_thres in float32 (the threshold rounded to float, as
// PyTorch casts a Python scalar to the tensor's type). The _rn intrinsics
// keep nvcc from contracting (area_i + area_j) - w * h into an FMA, which
// would flip pairs at the threshold. max, min and the clamps keep a NaN, as
// PyTorch's do.
//
// Design, one block of 512 threads an image:
//   1. the K boxes, their areas and `valid` into shared memory;
//   2. the bits: row i of S holds bit j of word j / 32 where j < i and
//      IoU(i, j) > iou_thres; a warp builds one word a step (a lane a
//      column, __ballot_sync), the warps taking rows in turn; rows of
//      candidates that are not valid are skipped, as nothing reads them;
//   3. the greedy scan, one warp, 32 candidates at a time: a lane's
//      candidate is suppressed by the kept ones of the earlier words (its
//      row's words ANDed with the kept words), then the word itself is
//      resolved in order: the lowest candidate left is kept and the lanes it
//      suppresses (one ballot over their rows' bit) are dropped;
//   4. keep written out as bytes.
// The scan costs at most K / 32 words and one ballot a kept candidate,
// whatever the depth of the suppression chains; the fixpoint would cost one
// block-wide barrier a step, and a chain of depth d takes d steps.
// Shared memory: 16 + 4 + 4 * (K / 32 + 1) + 1 bytes a candidate, about
// 19.5 KB at K = 300 and 157 KB at the limit, K = 1024 (beyond 48 KB with
// the opt-in attribute).
//
// What bounds it on an H100: operations. Its bytes are the boxes, `valid`
// and `keep` (1.1 MB for 200 images of 300 candidates, 0.3 us at 3.35
// TB/s); its work is an IoU for each pair of valid candidates, some 15
// float32 operations and a division, K (K - 1) / 2 pairs an image.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum: a NaN in either operand is the result
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }

// clamp(min=lo): a NaN stays
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(clamp_min(__fsub_rn(b.z, b.x), 0.0f), clamp_min(__fsub_rn(b.w, b.y), 0.0f));
}

// IoU(a, b) > thr, rounded as box_iou_matrix rounds it
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b,
                                         float thr) {
  const float w = clamp_min(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float h = clamp_min(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = clamp_min(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  return __fdiv_rn(inter, uni) > thr;
}

__host__ __device__ constexpr int words_of(int k) { return (k + 31) / 32; }
// a row's stride in words: odd, so that 32 lanes reading word w of 32
// consecutive rows hit 32 banks
__host__ __device__ constexpr int row_stride(int k) { return words_of(k) | 1; }

size_t shared_bytes(int k) {
  return static_cast<size_t>(k) * (sizeof(float4) + sizeof(float)) +
         sizeof(unsigned) * (words_of(k) + static_cast<size_t>(k) * row_stride(k)) + k;
}

__global__ void __launch_bounds__(kThreads)
    nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
               uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = words_of(k), stride = row_stride(k);
  float4* box = reinterpret_cast<float4*>(smem);                // [k]
  float* area = reinterpret_cast<float*>(box + k);              // [k]
  unsigned* kept = reinterpret_cast<unsigned*>(area + k);       // [words]
  unsigned* bits = kept + words;                                // [k][stride]
  uint8_t* ok = reinterpret_cast<uint8_t*>(bits + static_cast<size_t>(k) * stride);  // [k]

  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float4 b = boxes[base + i];
    box[i] = b;
    area[i] = box_area(b);
    ok[i] = valid[base + i] != 0;
  }
  __syncthreads();

  // 2. the bits of every valid row: words 0 .. i / 32, the last holding
  // the columns j < i of i's own word (all zero where i % 32 == 0)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < k; i += kWarps) {
    if (!ok[i]) continue;  // the whole warp skips the row
    const float4 bi = box[i];
    const float ai = area[i];
    unsigned* row = bits + static_cast<size_t>(i) * stride;
    for (int w = 0; w <= (i >> 5); ++w) {
      const int j = (w << 5) + lane;
      const bool hit = j < i && overlaps(bi, ai, box[j], area[j], thr);
      const unsigned word = __ballot_sync(kFull, hit);
      if (lane == 0) row[w] = word;
    }
  }
  __syncthreads();

  // 3. the greedy scan, 32 candidates a step
  if (warp == 0) {
    for (int blk = 0; blk < words; ++blk) {
      const int i = (blk << 5) + lane;
      const bool cand = i < k && ok[i];
      unsigned suppressed = 0, diag = 0;
      if (cand) {
        const unsigned* row = bits + static_cast<size_t>(i) * stride;
        for (int w = 0; w < blk; ++w) suppressed |= row[w] & kept[w];
        diag = row[blk];
      }
      unsigned left = __ballot_sync(kFull, cand && suppressed == 0), word = 0;
      while (left) {  // warp-uniform
        const int b = __ffs(left) - 1;
        word |= 1u << b;
        left &= ~(1u << b);
        left &= ~__ballot_sync(kFull, (diag >> b) & 1u);
      }
      if (lane == 0) kept[blk] = word;
      __syncwarp();
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += kThreads) {
    keep[base + i] = static_cast<uint8_t>((kept[i >> 5] >> (i & 31)) & 1u);
  }
}

}  // namespace

// boxes: [b, k, 4] float32 xyxy, contiguous, 16-byte aligned, on the current
// device (each image's candidates in descending score order); valid: [b, k]
// bool (bytes 0/1); keep: [b, k] bool, written. k at most 1024; thr the IoU
// threshold, compared in float32. Launches on `stream` and does not
// synchronise. Returns the CUDA error code of the launch (0 on success).
extern "C" int nms_suppress(const void* boxes, const void* valid, void* keep, int b, int k,
                            float thr, void* stream) {
  if (boxes == nullptr || valid == nullptr || keep == nullptr || b < 0 || k < 0 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || k == 0) return 0;
  if (reinterpret_cast<uintptr_t>(boxes) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const size_t bytes = shared_bytes(k);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_kernel<<<b, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}
