// Greedy NMS over score-sorted boxes, for the RPN proposal path.
//
// Replaces the TPU kernel `_batched_nms_kernel` of the JAX package
// (ops/pallas_proposals.py, its loop `_greedy_nms_rows`): `n_post` greedy
// select-and-suppress steps over boxes that are already decoded, clipped,
// min-size-masked (score -1e9) and cut to the top K by a stable sort.
//
// Because the rows arrive sorted by score, descending, ties by lower index,
// "select the best alive box" is "the first alive row", so greedy NMS in
// row order gives exactly the TPU kernel's selections.  Two phases:
//
//  1. nms_mask_kernel: one 64-bit word per (row i, column block j >= i's
//     block), bit set where iou(i, j) > thr for j > i.  Grid (column block,
//     row block, image), 64 threads, the column block's boxes in shared
//     memory.  O(K^2/2) IoUs, all parallel.
//  2. nms_scan_kernel: one warp per image walks the rows in order with a
//     "removed" bitmask in shared memory.  Each row that is alive and valid
//     is emitted and ORs its mask row into "removed"; the walk stops at
//     n_post kept.  The diagonal word of every row (the suppression it does
//     inside its own block) is preloaded into shared memory, so the serial
//     decisions read only shared memory; the loads of off-diagonal words of
//     kept rows are independent and overlap.
//
// What bounds it on the H100: not bytes (about 1 MB in and out per batch of
// 16 at K=3000) nor operations (at most n_post*K IoUs per image), but the
// serial scan: K steps of a warp-wide ballot/branch plus one dependent
// global load per kept row.  The mask is K*ceil(K/64)*8 bytes per image:
// 1.1 MB at predict (K=3000), 18 MB at train (K=12000, a later slice).
//
// Exactness: the IoU is computed with __fmul_rn/__fadd_rn/__fsub_rn/
// __fdiv_rn in the order inter / (area + barea - inter + 1e-8), with
// area = (x2-x1)*(y2-y1), so no multiply-add is contracted into an FMA and
// every decision equals the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kValidMin = -5e8f;   // NEG / 2: masked rows score -1e9

__device__ __forceinline__ float area_rn(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float iou_rn(float4 a, float area_a, float4 b,
                                        float area_b) {
  const float ix1 = fmaxf(b.x, a.x), iy1 = fmaxf(b.y, a.y);
  const float ix2 = fminf(b.z, a.z), iy2 = fminf(b.w, a.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.0f));
  const float denom =
      __fadd_rn(__fsub_rn(__fadd_rn(area_b, area_a), inter), 1e-8f);
  return __fdiv_rn(inter, denom);
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int k,
                                int n_words, float thr,
                                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, img = blockIdx.z;
  if (cb < rb) return;   // rows never read the words left of their own block
  __shared__ float4 col_box[kBlock];
  __shared__ float col_area[kBlock];
  const float4* bb = boxes + (size_t)img * k;
  const int j = cb * kBlock + threadIdx.x;
  if (j < k) {
    const float4 v = bb[j];
    col_box[threadIdx.x] = v;
    col_area[threadIdx.x] = area_rn(v);
  }
  __syncthreads();
  const int i = rb * kBlock + threadIdx.x;
  if (i >= k) return;
  const float4 a = bb[i];
  const float area_a = area_rn(a);
  const int n_col = min(kBlock, k - cb * kBlock);
  unsigned long long bits = 0;
  for (int c = (cb == rb) ? threadIdx.x + 1 : 0; c < n_col; ++c) {
    if (iou_rn(a, area_a, col_box[c], col_area[c]) > thr) bits |= 1ull << c;
  }
  mask[((size_t)img * k + i) * n_words + cb] = bits;
}

__global__ void nms_scan_kernel(const float4* __restrict__ boxes,
                                const float* __restrict__ scores,
                                const unsigned long long* __restrict__ mask,
                                int k, int n_words, int n_post,
                                float4* __restrict__ out_boxes,
                                float* __restrict__ out_scores,
                                bool* __restrict__ out_valid) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;           // [n_words]
  unsigned long long* diag = smem + n_words;    // [k]
  const int img = blockIdx.x, lane = threadIdx.x;
  const unsigned long long* m = mask + (size_t)img * k * n_words;
  const float4* bb = boxes + (size_t)img * k;
  const float* sc = scores + (size_t)img * k;
  float4* ob = out_boxes + (size_t)img * n_post;
  float* os = out_scores + (size_t)img * n_post;
  bool* ov = out_valid + (size_t)img * n_post;

  for (int w = lane; w < n_words; w += 32) removed[w] = 0ull;
  for (int i = lane; i < k; i += 32) diag[i] = m[(size_t)i * n_words + i / kBlock];
  __syncwarp();

  int n_kept = 0;
  for (int w = 0; w < n_words && n_kept < n_post; ++w) {
    const int i_lo = w * kBlock + lane, i_hi = i_lo + 32;
    const unsigned lo = __ballot_sync(kFull, i_lo < k && sc[i_lo] > kValidMin);
    const unsigned hi = __ballot_sync(kFull, i_hi < k && sc[i_hi] > kValidMin);
    unsigned long long cand =
        ((unsigned long long)hi << 32 | lo) & ~removed[w];
    while (cand != 0ull && n_kept < n_post) {   // uniform across the warp
      const int bit = __ffsll((long long)cand) - 1;
      const int i = w * kBlock + bit;
      if (lane == 0) {
        ob[n_kept] = bb[i];
        os[n_kept] = sc[i];
        ov[n_kept] = true;
      }
      ++n_kept;
      cand &= ~diag[i] & ~(1ull << bit);
      const unsigned long long* row = m + (size_t)i * n_words;
      for (int w2 = w + 1 + lane; w2 < n_words; w2 += 32) removed[w2] |= row[w2];
    }
    __syncwarp();
  }
  for (int s = n_kept + lane; s < n_post; s += 32) {
    ob[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    os[s] = 0.f;
    ov[s] = false;
  }
}

}  // namespace

extern "C" int nms_launch(const void* boxes, const void* scores, void* mask,
                          int batch, int k, int n_post, float thr,
                          void* out_boxes, void* out_scores, void* out_valid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_words = (k + kBlock - 1) / kBlock;
  nms_mask_kernel<<<dim3(n_words, n_words, batch), kBlock, 0, s>>>(
      static_cast<const float4*>(boxes), k, n_words, thr,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(n_words + k) * sizeof(unsigned long long);
  err = cudaFuncSetAttribute(nms_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<batch, 32, smem, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const unsigned long long*>(mask), k, n_words, n_post,
      static_cast<float4*>(out_boxes), static_cast<float*>(out_scores),
      static_cast<bool*>(out_valid));
  return (int)cudaGetLastError();
}
