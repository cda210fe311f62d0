// NMS's suppression for Hopper (sm_90a): the greedy keep mask of every image
// of a batch, one thread-block cluster an image, nothing in device memory
// between the candidates and the mask, no host read.
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
// PyTorch's do (PTX's max.NaN / min.NaN, one instruction each).
//
// The comparison without the division. With u = the clamped union and t the
// float threshold, RN(inter / u) > t holds exactly when inter / u > m, m =
// t + h the midpoint between t and the next float up (h half an ulp of t),
// or when inter / u == m and the tie rounds up. For 2^-60 <= t <= 1 the
// kernel computes d = fma(-t, u, inter), which is RN(inter - t u) with one
// rounding, and hu = h * u, exact (h a power of two, u >= 1e-7, so hu is a
// normal float). RN is monotone and hu is a float, so d > hu implies inter -
// t u > h u (the pair is above), d < hu implies inter - t u < h u (not
// above), and only d == hu leaves the answer open: such a word is decided
// again with __fdiv_rn. A NaN fails both comparisons, as the division's NaN
// does; an infinite inter gives d = inf > hu, as inf / u > t; an infinite u
// gives d = -inf < hu, as inter / inf = 0 is not above t. Outside that range
// of t (never a caller's IoU threshold) every pair divides.
// tests/test_torch_port_nms.py holds a float32 statement of the rule against
// the division on pairs at and an ulp beside 0.3, 0.45 and 0.7 and on 10^6
// seeded pairs.
//
// Design. The first kernel ran one block of 512 threads an image: at stage
// 3's 50 images 82 of 132 SMs idled, 16 warps built some 70 dependent
// words each with a ballot and an IEEE division a pair, and one warp
// scanned while 15 waited. Here a cluster of kCluster CTAs of kThreads
// threads takes an image:
//   1. every CTA stages the K boxes, their areas and `valid` in its shared
//      memory and finds n, one past the last valid candidate; rows and
//      columns from n on are never built or scanned;
//   2. the bits: row i holds bit j of word j / 32 where j < i and IoU(i, j)
//      > iou_thres. The lower triangle of 32 x 32 tiles (row block r, word
//      w <= r) is spread over the cluster's warps, a tile at a time: lane l
//      keeps row 32 r + l's box in registers and walks the tile's 32
//      columns, whose boxes all lanes read at once (a shared-memory
//      broadcast), building its word in a register: no ballot, no division
//      but at a tie. At K = 300 the 55 tiles go to the cluster's 32 warps,
//      two at most each. Each word is stored straight into the leader CTA's
//      shared memory (distributed shared memory, laid out [w][i] so that a
//      warp's 32 stores are 128 contiguous bytes);
//   3. after the cluster barrier the leader's first warp scans, 32
//      candidates a step: a lane's candidate is suppressed by the kept ones
//      of the earlier words (its row's words ANDed with the kept words),
//      then the word is resolved in rounds: every candidate left with no
//      earlier candidate left that overlaps it is kept, and the candidates
//      the kept ones overlap are dropped. A round keeps at least the lowest
//      candidate left, so the result is the greedy one; on served-like
//      clusters (tools/nms_cases.py) a word takes about one round, against
//      some 16 kept candidates, one ballot each, in a one-at-a-time scan.
//      The keep bytes go out as each word is resolved.
// The clusters of the other images keep the SMs busy while a leader scans.
// Chosen by A/B on an H100 (tools/kernel_ab.py --ablate; PERF.md, section 6):
// two launches, the bits through device memory and then a warp an image
// scanning them, took 24.5 us at 200 images and 16.7 at 50 against this
// kernel's 20.1 and 9.3; clusters of 4 CTAs and CTAs of 64 or 256 threads
// were no faster at both sizes.
// Shared memory a CTA: 21 + 4 * (K / 32) bytes a candidate (K rounded up to
// a multiple of 32), about 19 KB at K = 300 and 149 KB at the limit, K =
// 1024 (past 48 KB with the opt-in attribute).
//
// What bounds it on an H100: operations. Its bytes are the boxes, `valid`
// and `keep` (1.1 MB for 200 images of 300 candidates, 0.3 us at 3.35
// TB/s); its work is an IoU against the threshold for each pair of valid
// candidates, some 14 float32 operations, n (n - 1) / 2 pairs an image.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs an image
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum: a NaN in either operand is the result
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f), max_nan(__fsub_rn(b.w, b.y), 0.0f));
}

// the intersection and the clamped union of a pair, rounded as
// box_iou_matrix rounds them
__device__ __forceinline__ void inter_union(float4 a, float area_a, float4 b, float area_b,
                                            float& inter, float& uni) {
  const float w = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float h = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  inter = __fmul_rn(w, h);
  uni = max_nan(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
}

__host__ __device__ constexpr int words_of(int k) { return (k + 31) / 32; }

size_t shared_bytes(int k) {
  const size_t kp = 32 * static_cast<size_t>(words_of(k));
  return kp * (sizeof(float4) + sizeof(float) + 1) +
         sizeof(unsigned) * words_of(k) * (kp + 1);
}

// Row i's word of the columns j0 .. j0 + 31 (bit jj: j0 + jj < i and IoU > thr),
// `n` = i - j0 of them below i. With half_ulp > 0 the comparison without the
// division (the note above), the word decided again by the division where a
// pair ties; with half_ulp == 0 every pair divides.
template <bool kScreen>
__device__ __forceinline__ unsigned row_word(float4 bi, float ai, const float4* col,
                                             const float* col_area, int n, float thr,
                                             float half_ulp) {
  unsigned word = 0;
  bool tie = false;
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    float inter, uni;
    inter_union(bi, ai, col[jj], col_area[jj], inter, uni);
    bool hit;
    if (kScreen) {
      const float d = __fmaf_rn(-thr, uni, inter);
      const float hu = __fmul_rn(half_ulp, uni);
      hit = d > hu;
      tie = tie || d == hu;
    } else {
      hit = __fdiv_rn(inter, uni) > thr;
    }
    word |= static_cast<unsigned>(hit) << jj;
  }
  if (kScreen && tie) {
    word = 0;
    for (int jj = 0; jj < n && jj < 32; ++jj) {
      float inter, uni;
      inter_union(bi, ai, col[jj], col_area[jj], inter, uni);
      word |= static_cast<unsigned>(__fdiv_rn(inter, uni) > thr) << jj;
    }
  }
  return n >= 32 ? word : word & ((1u << n) - 1u);
}

// the tile (row block r, word w <= r) of task t, tasks in row order
__device__ __forceinline__ void tile_of(int t, int& r, int& w) {
  r = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  while (r * (r + 1) / 2 > t) --r;
  w = t - r * (r + 1) / 2;
}

// 1. an image's candidates into shared memory (kp = k rounded up to 32,
// zero boxes past k); returns n, one past the last valid candidate. Every
// thread of the block calls it.
__device__ __forceinline__ int stage(const float4* __restrict__ boxes,
                                     const uint8_t* __restrict__ valid, size_t base, int k,
                                     int kp, float4* box, float* area, uint8_t* ok,
                                     int* last_valid) {
  if (threadIdx.x == 0) *last_valid = 0;
  __syncthreads();
  int last = 0;
  for (int i = threadIdx.x; i < kp; i += blockDim.x) {
    const float4 b = i < k ? boxes[base + i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const bool v = i < k && valid[base + i] != 0;
    box[i] = b;
    area[i] = box_area(b);
    ok[i] = v;
    if (v) last = i + 1;
  }
  last = __reduce_max_sync(kFull, last);
  if ((threadIdx.x & 31) == 0) atomicMax(last_valid, last);
  __syncthreads();
  return *last_valid;
}

// 2. the 32 x 32 tiles (row block r, word w <= r) of the rows below n, tile
// t to the warp `first` + a multiple of `stride`, each word into
// bits[w * kp + i]
__device__ __forceinline__ void build_tiles(int n, int kp, const float4* box, const float* area,
                                            const uint8_t* ok, unsigned* bits, int first,
                                            int stride, float thr, float half_ulp) {
  const int lane = threadIdx.x & 31;
  const int blocks = words_of(n);
  const int tiles = blocks * (blocks + 1) / 2;
  for (int t = first; t < tiles; t += stride) {
    int r, w;
    tile_of(t, r, w);
    const int i = 32 * r + lane;
    unsigned word = 0;
    if (i < n && ok[i]) {
      const int cols = i - 32 * w;
      word = half_ulp > 0.0f
                 ? row_word<true>(box[i], area[i], box + 32 * w, area + 32 * w, cols, thr, half_ulp)
                 : row_word<false>(box[i], area[i], box + 32 * w, area + 32 * w, cols, thr, 0.0f);
    }
    bits[static_cast<size_t>(w) * kp + i] = word;
  }
}

// 3. the greedy scan by one warp, 32 candidates a step; writes keep for
// the row blocks below n (kept: a word a block, scratch)
__device__ __forceinline__ void scan(int n, int k, int kp, const unsigned* bits,
                                     const uint8_t* ok, unsigned* kept, uint8_t* keep) {
  const int lane = threadIdx.x & 31;
  for (int blk = 0; blk < words_of(n); ++blk) {
    const int i = 32 * blk + lane;
    const bool cand = i < n && ok[i];
    unsigned suppressed = 0;
    for (int w = 0; w < blk; ++w) suppressed |= bits[static_cast<size_t>(w) * kp + i] & kept[w];
    // columns j < i of this word (masked: any bits at all let the rounds end)
    const unsigned diag = bits[static_cast<size_t>(blk) * kp + i] & ((1u << lane) - 1u);
    unsigned left = __ballot_sync(kFull, cand && suppressed == 0), word = 0;
    while (left) {  // warp-uniform
      const unsigned now = __ballot_sync(kFull, ((left >> lane) & 1u) && (diag & left) == 0);
      word |= now;
      left &= ~(now | __ballot_sync(kFull, (diag & now) != 0));
    }
    if (lane == 0) kept[blk] = word;
    __syncwarp();
    if (i < k) keep[i] = static_cast<uint8_t>((word >> lane) & 1u);
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 4)
    nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
               uint8_t* __restrict__ keep, int k, float thr, float half_ulp) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_valid;
  cg::cluster_group cluster = cg::this_cluster();
  // a CTA may store into the leader's shared memory only once the leader
  // runs: arrive now, wait before the first store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  const int words = words_of(k), kp = 32 * words;
  float4* box = reinterpret_cast<float4*>(smem);               // [kp]
  float* area = reinterpret_cast<float*>(box + kp);            // [kp]
  unsigned* bits = reinterpret_cast<unsigned*>(area + kp);     // [words][kp]
  unsigned* kept = bits + static_cast<size_t>(words) * kp;     // [words]
  uint8_t* ok = reinterpret_cast<uint8_t*>(kept + words);      // [kp]
  const int warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t base = static_cast<size_t>(blockIdx.x / kCluster) * k;

  const int n = stage(boxes, valid, base, k, kp, box, area, ok, &last_valid);
  unsigned* leader_bits = cluster.map_shared_rank(bits, 0);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  build_tiles(n, kp, box, area, ok, leader_bits, rank * kWarps + warp, kCluster * kWarps, thr,
              half_ulp);
  cluster.sync();  // the leader's bits are complete and visible
  if (rank != 0) return;
  if (warp == 0) {
    scan(n, k, kp, bits, ok, kept, keep + base);
  } else {  // keep = 0 from the last row block on
    for (int i = 32 * words_of(n) + threadIdx.x - 32; i < k; i += kThreads - 32) keep[base + i] = 0;
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
  if (boxes == nullptr || valid == nullptr || keep == nullptr || b < 0 || k < 0 || k > kMaxK ||
      b > (0x7fffffff / kCluster)) {
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
  // half an ulp of thr where the comparison needs no division (the note)
  const float half_ulp =
      thr >= 0x1p-60f && thr <= 1.0f ? (nextafterf(thr, INFINITY) - thr) * 0.5f : 0.0f;
  nms_kernel<<<b * kCluster, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thr, half_ulp);
  return static_cast<int>(cudaGetLastError());
}
