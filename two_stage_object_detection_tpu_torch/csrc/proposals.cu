// Fused RPN proposals over the whole anchor table, launch A: decode, clip,
// min-size mask and the greedy order of every row.  Launch B is kernel 1's
// walk (csrc/nms.cu) over the sorted rows, with K = N.
//
// Replaces the TPU kernels `_batched_kernel` (whole batch) and
// `_fused_kernel` (one image; here the same launches with B = 1) of the JAX
// package (ops/pallas_proposals.py).  Those take, n_post times, the best
// still-alive score (the lowest index among equals), emit it (valid where
// score > -1e9 / 2), and kill every row whose IoU with it is > thr, and
// itself.  "The best alive score, lowest index on ties" is the same as
// "the first alive row in (score descending, index ascending) order", so
// once the rows are in that order the steps are kernel 1's walk, which
// spreads an image over a thread-block cluster and decides 64 rows a tile.
//
// Launch A orders the rows by a unique 64-bit key: the orderable bits of
// the masked score, inverted (descending), then the row index (ascending).
// -0.0 is turned into +0.0 first: the plain version's argmax holds them
// equal and takes the lower index.  The keys are unique, so any correct
// sort gives the plain order.  Two kernels:
//  * decode_sort_kernel, grid (chunks, B): a block decodes a chunk of up
//    to `chunk` rows (a power of two, 2048..16,384, so that an image has at
//    most 8 chunks where it can), builds their keys and sorts them in
//    shared memory (bitonic, 8 bytes a key), and writes them out;
//  * merge_scatter_kernel, grid (rows / 256, B): each row finds its place in
//    the image's order, its rank in its own chunk plus, for each other
//    chunk, the number of that chunk's keys below its own (a binary search
//    in a sorted chunk that L2 holds), decodes its row again (the same
//    code, so the same bits) and writes box and masked score there.
// Scratch: keys [B, N] u64, boxes [B, N, 4] f32 and scores [B, N] f32, which
// the wrapper allocates (28 bytes a row: 32 MB at B=16, N=72,000, within
// the 50 MB L2).
//
// What bounds it on the H100: neither bytes (about 0.8 MB in per image) nor
// operations (~20 MB of keys moved through shared memory per image by the
// sort), but latency: 66 barrier-separated stages of the 2048-key bitonic
// sort, and the chain of dependent loads of the binary searches (7 x 11 at
// N=12,996).  The walk that follows (launch B) is kernel 1's, bounded by
// its chain of tiles.
//
// Exactness: decode uses __fmul_rn/__fadd_rn/__fsub_rn in the plain
// version's order (cx = dx*aw + acx, w = exp(dw)*aw, clip to [0, W] /
// [0, H]), so nothing is contracted into an FMA and every box and mask
// equals the plain version's; kernel 1's IoU decisions equal its plain
// version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSortThreads = 1024;
constexpr int kScatterThreads = 256;
constexpr int kMinChunk = 2048;
constexpr int kMaxChunk = 16384;   // 128 KB of keys in shared memory
constexpr int kChunksWanted = 8;
constexpr float kNeg = -1e9f;
constexpr unsigned long long kPad = ~0ull;   // above every real key

__device__ __forceinline__ float clip(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

// row j's decoded, clipped box and its score, NEG where a side is under
// min_size
__device__ __forceinline__ float4 decode_row(const float4* __restrict__ locs,
                                             const float* __restrict__ scores,
                                             const float4* __restrict__ anchors,
                                             int j, float min_size,
                                             float img_h, float img_w,
                                             float* masked) {
  const float4 a = anchors[j];
  const float4 d = locs[j];
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
  *masked = ok ? scores[j] : kNeg;
  return b;
}

// Ascending keys give the greedy order: score descending, row ascending.
__device__ __forceinline__ unsigned long long order_key(float s, int row) {
  unsigned u = __float_as_uint(s);
  if ((u << 1) == 0u) u = 0u;                      // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending with s
  return (unsigned long long)(~u) << 32 | (unsigned)row;
}

__global__ void __launch_bounds__(kSortThreads)
decode_sort_kernel(const float4* __restrict__ locs,
                   const float* __restrict__ scores,
                   const float4* __restrict__ anchors, int n, int chunk,
                   float min_size, float img_h, float img_w,
                   unsigned long long* __restrict__ keys) {
  extern __shared__ unsigned long long key_s[];   // [chunk]
  const int img = blockIdx.y, tid = threadIdx.x;
  const int c0 = blockIdx.x * chunk;
  const int len = min(chunk, n - c0);
  const float4* l_img = locs + (size_t)img * n;
  const float* s_img = scores + (size_t)img * n;
  for (int i = tid; i < chunk; i += kSortThreads) {
    unsigned long long key = kPad;
    if (i < len) {
      float masked;
      decode_row(l_img, s_img, anchors, c0 + i, min_size, img_h, img_w,
                 &masked);
      key = order_key(masked, c0 + i);
    }
    key_s[i] = key;
  }
  __syncthreads();
  // bitonic sort, ascending: each stage compares chunk / 2 disjoint pairs
  for (int k = 2; k <= chunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < chunk / 2; p += kSortThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const unsigned long long a = key_s[i], b = key_s[i | j];
        if ((a > b) == ((i & k) == 0)) {
          key_s[i] = b;
          key_s[i | j] = a;
        }
      }
      __syncthreads();
    }
  }
  unsigned long long* k_img = keys + (size_t)img * n + c0;
  for (int i = tid; i < len; i += kSortThreads) k_img[i] = key_s[i];
}

__global__ void __launch_bounds__(kScatterThreads)
merge_scatter_kernel(const unsigned long long* __restrict__ keys,
                     const float4* __restrict__ locs,
                     const float* __restrict__ scores,
                     const float4* __restrict__ anchors, int n, int chunk,
                     float min_size, float img_h, float img_w,
                     float4* __restrict__ sorted_boxes,
                     float* __restrict__ sorted_scores) {
  const int img = blockIdx.y;
  const int q = blockIdx.x * kScatterThreads + threadIdx.x;
  if (q >= n) return;
  const unsigned long long* k_img = keys + (size_t)img * n;
  const int own = q / chunk;
  const unsigned long long key = k_img[q];
  int pos = q - own * chunk;   // rank in its own chunk
  const int n_chunks = (n + chunk - 1) / chunk;
  for (int c = 0; c < n_chunks; ++c) {
    if (c == own) continue;
    const unsigned long long* kc = k_img + (size_t)c * chunk;
    int lo = 0, hi = min(chunk, n - c * chunk);
    while (lo < hi) {   // keys of chunk c below `key`
      const int mid = (lo + hi) >> 1;
      if (kc[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    pos += lo;
  }
  const int row = (int)(key & 0xffffffffull);
  float masked;
  const float4 b = decode_row(locs + (size_t)img * n, scores + (size_t)img * n,
                              anchors, row, min_size, img_h, img_w, &masked);
  sorted_boxes[(size_t)img * n + pos] = b;
  sorted_scores[(size_t)img * n + pos] = masked;
}

// Rows an image's chunk holds: at least 2048 (at most n rounded up to a
// power of two), doubled up to 16,384 until the image has at most 8 chunks.
int sort_chunk(int n) {
  int chunk = kMinChunk;
  while (chunk < kMaxChunk && (n + chunk - 1) / chunk > kChunksWanted) {
    chunk <<= 1;
  }
  if (n < chunk) {
    int p = 2;
    while (p < n) p <<= 1;
    chunk = p;
  }
  return chunk;
}

}  // namespace

// Launch A.  keys: [batch, n] u64 scratch; sorted_boxes [batch, n, 4] f32
// and sorted_scores [batch, n] f32: the rows in greedy order, which launch
// B (nms_launch of csrc/nms.cu, K = n) walks.  Returns a cudaError_t code.
extern "C" int proposals_sort_launch(const void* locs, const void* scores,
                                     const void* anchors, int batch, int n,
                                     float min_size, float img_h, float img_w,
                                     void* keys, void* sorted_boxes,
                                     void* sorted_scores, void* stream) {
  if (batch < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunk = sort_chunk(n);
  const int smem = chunk * (int)sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      decode_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 sort_grid((n + chunk - 1) / chunk, batch);
  decode_sort_kernel<<<sort_grid, kSortThreads, smem, s>>>(
      static_cast<const float4*>(locs), static_cast<const float*>(scores),
      static_cast<const float4*>(anchors), n, chunk, min_size, img_h, img_w,
      static_cast<unsigned long long*>(keys));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 scatter_grid((n + kScatterThreads - 1) / kScatterThreads, batch);
  merge_scatter_kernel<<<scatter_grid, kScatterThreads, 0, s>>>(
      static_cast<const unsigned long long*>(keys),
      static_cast<const float4*>(locs), static_cast<const float*>(scores),
      static_cast<const float4*>(anchors), n, chunk, min_size, img_h, img_w,
      static_cast<float4*>(sorted_boxes), static_cast<float*>(sorted_scores));
  return (int)cudaGetLastError();
}
