// Fused RPN proposals over the whole anchor table: decode, clip, min-size
// mask and greedy NMS in one launch, one image per block.
//
// Replaces the TPU kernels `_batched_kernel` (whole batch) and
// `_fused_kernel` (one image; here the same launch with B = 1) of the JAX
// package (ops/pallas_proposals.py).  No sort: each of the n_post greedy
// steps takes the best still-alive score (the lowest index among equals),
// emits it (valid where score > -1e9 / 2), and kills every row whose IoU
// with it is > thr, and itself.
//
// Layout of a block (1024 threads, one image):
//  * the decoded, clipped boxes of all N rows sit in dynamic shared memory,
//    16 bytes a row: 14,336 rows use 229,376 of the 232,448 bytes a block
//    can opt into.  From 14,337 to 32,768 rows the same kernel keeps them
//    in a global scratch buffer, [B, N] float4, which stays in L2.  That
//    covers every table the predict route sends here at the default
//    n_pre_nms of 3000 (N < 18,000, such as FPN inputs of 240-268 px); the
//    wrapper raises above 32,768;
//  * the alive scores sit in registers, row j in thread j % 1024, slot
//    j / 1024 (14 a thread, or 32 with the scratch buffer);
//  * the area is not stored: there is no room for a fifth float a row, so
//    each step recomputes it from the coordinates, the same way each time.
// A step is one pass over the thread's rows that suppresses against the
// previous winner and keeps the thread's best survivor, then a block-wide
// argmax: a warp butterfly, one shared-memory round (double-buffered, so one
// barrier a step), and a second butterfly that every warp runs.  The IoU
// division runs only for rows that overlap the winner.  Once the
// winner is invalid every later step is invalid too, so the block zero-fills
// the remaining slots and stops.
//
// What bounds it on the H100: neither bytes (about 0.8 MB in per image) nor
// operations (n_post x N IoUs, ~0.9 GFLOP at B=16, N=12,996, n_post=300),
// but the n_post dependent steps, each a pass plus a barrier, on one SM per
// image: 16 of the 132 SMs work at B=16.  A cluster with distributed shared
// memory would spread one image over several SMs and lift the row cap.
//
// Exactness: decode and IoU use __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn in
// the plain version's order (cx = dx*aw + acx, w = exp(dw)*aw, clip to
// [0, W] / [0, H]; iou = inter / (area + barea - inter + 1e-8)), so nothing
// is contracted into an FMA and every decision equals the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSmemRowsPerThread = 14;      // boxes in shared memory
constexpr int kScratchRowsPerThread = 32;   // boxes in the global scratch
constexpr int kSmemMaxRows = kThreads * kSmemRowsPerThread;       // 14,336
constexpr int kMaxRows = kThreads * kScratchRowsPerThread;        // 32,768
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;
constexpr float kValidMin = -5e8f;   // NEG / 2

__device__ __forceinline__ float area_rn(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// iou(a, b) > thr, with iou = inter / (area_b + area_a - inter + 1e-8).
// Most rows do not overlap the winner: there inter = +0 and the IoU is
// exactly +0 (the denominator is at least 1e-8), so the division is skipped
// and the answer is 0 > thr.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b,
                                          float thr) {
  const float ix1 = fmaxf(b.x, a.x), iy1 = fmaxf(b.y, a.y);
  const float ix2 = fminf(b.z, a.z), iy2 = fminf(b.w, a.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.0f));
  if (inter == 0.0f) return 0.0f > thr;
  const float denom =
      __fadd_rn(__fsub_rn(__fadd_rn(area_rn(b), area_a), inter), 1e-8f);
  return __fdiv_rn(inter, denom) > thr;
}

__device__ __forceinline__ float clip(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

// (v, i) replaces (bv, bi) if it is larger, or equal at a lower index
__device__ __forceinline__ void take_better(float v, int i, float* bv,
                                            int* bi) {
  if (v > *bv || (v == *bv && i < *bi)) {
    *bv = v;
    *bi = i;
  }
}

__device__ __forceinline__ void warp_argmax(float* bv, int* bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(kFull, *bv, off);
    const int i = __shfl_xor_sync(kFull, *bi, off);
    take_better(v, i, bv, bi);
  }
}

template <int kRowsPerThread, bool kSmemBoxes>
__global__ void __launch_bounds__(kThreads, 1)
proposals_kernel(const float4* __restrict__ locs,
                 const float* __restrict__ scores,
                 const float4* __restrict__ anchors, int n, int n_post,
                 float thr, float min_size, float img_h, float img_w,
                 float4* __restrict__ out_boxes, float* __restrict__ out_scores,
                 bool* __restrict__ out_valid, float4* scratch) {
  extern __shared__ float4 smem_box[];   // [n] when kSmemBoxes
  __shared__ float red_val[2][kWarps];
  __shared__ int red_idx[2][kWarps];
  const int img = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float4* l_img = locs + (size_t)img * n;
  const float* s_img = scores + (size_t)img * n;
  float4* ob = out_boxes + (size_t)img * n_post;
  float* os = out_scores + (size_t)img * n_post;
  bool* ov = out_valid + (size_t)img * n_post;
  float4* box = kSmemBoxes ? smem_box : scratch + (size_t)img * n;

  // decode + clip + min-size mask, and this thread's best row
  float s[kRowsPerThread];
  float bv = -INFINITY;
  int bi = n;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int j = tid + r * kThreads;
    s[r] = -INFINITY;
    if (j < n) {
      const float4 a = anchors[j];
      const float4 d = l_img[j];
      const float aw = __fsub_rn(a.z, a.x), ah = __fsub_rn(a.w, a.y);
      const float acx = __fadd_rn(a.x, __fmul_rn(0.5f, aw));
      const float acy = __fadd_rn(a.y, __fmul_rn(0.5f, ah));
      const float cx = __fadd_rn(__fmul_rn(d.x, aw), acx);
      const float cy = __fadd_rn(__fmul_rn(d.y, ah), acy);
      const float hw = __fmul_rn(0.5f, __fmul_rn(expf(d.z), aw));
      const float hh = __fmul_rn(0.5f, __fmul_rn(expf(d.w), ah));
      const float4 b = make_float4(
          clip(__fsub_rn(cx, hw), img_w), clip(__fsub_rn(cy, hh), img_h),
          clip(__fadd_rn(cx, hw), img_w), clip(__fadd_rn(cy, hh), img_h));
      const bool ok = __fsub_rn(b.z, b.x) >= min_size &&
                      __fsub_rn(b.w, b.y) >= min_size;
      box[j] = b;
      s[r] = ok ? s_img[j] : kNeg;
      take_better(s[r], j, &bv, &bi);
    }
  }
  __syncthreads();

  for (int k = 0; k < n_post; ++k) {
    // block-wide argmax of the alive scores, ties to the lower index
    const int buf = k & 1;
    warp_argmax(&bv, &bi);
    if (lane == 0) {
      red_val[buf][warp] = bv;
      red_idx[buf][warp] = bi;
    }
    __syncthreads();
    bv = red_val[buf][lane];
    bi = red_idx[buf][lane];
    warp_argmax(&bv, &bi);
    const float win_score = bv;
    const int win = bi;

    if (!(win_score > kValidMin)) {   // every later step is invalid too
      for (int q = k + tid; q < n_post; q += kThreads) {
        ob[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        os[q] = 0.f;
        ov[q] = false;
      }
      return;
    }
    const float4 sel = box[win];
    if (tid == 0) {
      ob[k] = sel;
      os[k] = win_score;
      ov[k] = true;
    }
    const float sel_area = area_rn(sel);
    bv = -INFINITY;
    bi = n;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int j = tid + r * kThreads;
      if (j < n) {
        const float4 b = box[j];
        if (j == win || iou_above(sel, sel_area, b, thr)) s[r] = kNeg;
        take_better(s[r], j, &bv, &bi);
      }
    }
  }
}

template <int kRowsPerThread, bool kSmemBoxes>
cudaError_t launch(const void* locs, const void* scores, const void* anchors,
                   int batch, int n, int n_post, float thr, float min_size,
                   float img_h, float img_w, void* out_boxes,
                   void* out_scores, void* out_valid, void* scratch,
                   cudaStream_t s) {
  auto kernel = proposals_kernel<kRowsPerThread, kSmemBoxes>;
  const int smem = kSmemBoxes ? n * (int)sizeof(float4) : 0;
  if (kSmemBoxes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch, kThreads, smem, s>>>(
      static_cast<const float4*>(locs), static_cast<const float*>(scores),
      static_cast<const float4*>(anchors), n, n_post, thr, min_size, img_h,
      img_w, static_cast<float4*>(out_boxes), static_cast<float*>(out_scores),
      static_cast<bool*>(out_valid), static_cast<float4*>(scratch));
  return cudaGetLastError();
}

}  // namespace

// scratch: [batch, n] float4 of device memory when n > 14,336, else unused
extern "C" int proposals_launch(const void* locs, const void* scores,
                                const void* anchors, int batch, int n,
                                int n_post, float thr, float min_size,
                                float img_h, float img_w, void* out_boxes,
                                void* out_scores, void* out_valid,
                                void* scratch, void* stream) {
  if (n < 1 || n > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kSmemMaxRows)
    return (int)launch<kSmemRowsPerThread, true>(
        locs, scores, anchors, batch, n, n_post, thr, min_size, img_h, img_w,
        out_boxes, out_scores, out_valid, nullptr, s);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch<kScratchRowsPerThread, false>(
      locs, scores, anchors, batch, n, n_post, thr, min_size, img_h, img_w,
      out_boxes, out_scores, out_valid, scratch, s);
}
