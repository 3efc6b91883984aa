// RoIPool max forward with the per-bin argmax, for the single-scale RoI head.
//
// Replaces the TPU kernel `_roi_pool_kernel` of the JAX package
// (ops/pallas_roi.py): for each roi, torchvision RoIPool integer bins
// (rois scaled and rounded half to even; start = p*size/P + lo,
// end = ceil((p+1)*size/P) + lo, size = max(hi - lo, 1); both clamped to
// the map), the max of each bin per channel and the flat index y*W + x of
// its first maximum in row-major order.  An empty bin gives 0 and -1.
//
// The TPU kernel finds the first row-major maximum with two separable
// masked-max stages and min-index selects over [H, W, C] VMEM tiles.  Here
// each bin is scanned directly: one block per (roi, image), threads over
// channels (neighbouring threads read neighbouring channels of one NHWC
// pixel, so every load is coalesced), pixels in row-major order, and the
// index moves only on a strictly greater value -- the same first maximum.
// bf16 maps are read as they are; the upcast to f32 is exact.  Each thread
// takes 4 neighbouring channels (C must be a multiple of 4): one 8-byte
// (bf16) or 16-byte (f32) load a pixel, one 16-byte store of values and one
// of indices a bin.  With a null `argmax` (a forward that no backward
// will follow) the indices are not stored: half the bytes.
//
// What bounds it on the H100: bytes.  The outputs are f32 + int32 per
// (roi, bin, channel): 963 MB at B=16, R=300, P=7, C=512, against a 23.6 MB
// bf16 map that stays in the 50 MB L2.  The writes are coalesced; nothing
// else is stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// 4 neighbouring channels as f32: a bf16 is the high half of its f32
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ void bin_range(int lo, int hi, int p, int pooled,
                                          int limit, int* start, int* end) {
  const long long size = max(hi - lo, 1);
  const long long s = (long long)p * size / pooled + lo;
  const long long e = ((long long)(p + 1) * size + pooled - 1) / pooled + lo;
  *start = (int)min(max(s, 0ll), (long long)limit);
  *end = (int)min(max(e, 0ll), (long long)limit);
}

template <typename T, bool kWithArgmax>
__global__ void __launch_bounds__(kThreads)
roi_pool_kernel(const T* __restrict__ feats, const float4* __restrict__ rois,
                int h, int w, int c, int r, int pooled, float scale,
                float* __restrict__ out, int* __restrict__ argmax) {
  const int roi = blockIdx.x, img = blockIdx.y;
  const float4 box = rois[(size_t)img * r + roi];
  const int x1 = __float2int_rn(__fmul_rn(box.x, scale));
  const int y1 = __float2int_rn(__fmul_rn(box.y, scale));
  const int x2 = __float2int_rn(__fmul_rn(box.z, scale));
  const int y2 = __float2int_rn(__fmul_rn(box.w, scale));
  const T* f = feats + (size_t)img * h * w * c;
  const size_t base = ((size_t)img * r + roi) * pooled * pooled * c;

  for (int ph = 0; ph < pooled; ++ph) {
    int hs, he;
    bin_range(y1, y2, ph, pooled, h, &hs, &he);
    for (int pw = 0; pw < pooled; ++pw) {
      int ws, we;
      bin_range(x1, x2, pw, pooled, w, &ws, &we);
      const size_t o = base + (size_t)(ph * pooled + pw) * c;
      for (int ch = threadIdx.x * 4; ch < c; ch += kThreads * 4) {
        float best[4] = {0.f, 0.f, 0.f, 0.f};   // an empty bin: 0 and -1
        int idx[4] = {-1, -1, -1, -1};
        for (int y = hs; y < he; ++y) {
          for (int x = ws; x < we; ++x) {
            float v[4];
            load4(f + ((size_t)y * w + x) * c + ch, v);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (idx[q] < 0 || v[q] > best[q]) {
                best[q] = v[q];
                idx[q] = y * w + x;
              }
            }
          }
        }
        *reinterpret_cast<float4*>(out + o + ch) =
            make_float4(best[0], best[1], best[2], best[3]);
        if (kWithArgmax) {
          *reinterpret_cast<int4*>(argmax + o + ch) =
              make_int4(idx[0], idx[1], idx[2], idx[3]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int roi_pool_launch(const void* feats, const void* rois, void* out,
                               void* argmax, int batch, int h, int w, int c,
                               int r, int pooled, float scale, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(r, batch);
  const float4* b = static_cast<const float4*>(rois);
  float* o = static_cast<float*>(out);
  int* a = static_cast<int*>(argmax);
  // the wrapper hands 16-byte-aligned tensors with C % 4 == 0, so every
  // pixel and every output row starts 16-byte (f32) or 8-byte (bf16) aligned
  const float* f32 = static_cast<const float*>(feats);
  const __nv_bfloat16* bf16 = static_cast<const __nv_bfloat16*>(feats);
  // four instantiations: the map's type, and with or without the index store
  if (dtype == 0 && a != nullptr) {
    roi_pool_kernel<float, true><<<grid, kThreads, 0, s>>>(
        f32, b, h, w, c, r, pooled, scale, o, a);
  } else if (dtype == 0) {
    roi_pool_kernel<float, false><<<grid, kThreads, 0, s>>>(
        f32, b, h, w, c, r, pooled, scale, o, a);
  } else if (a != nullptr) {
    roi_pool_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, s>>>(
        bf16, b, h, w, c, r, pooled, scale, o, a);
  } else {
    roi_pool_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(
        bf16, b, h, w, c, r, pooled, scale, o, a);
  }
  return (int)cudaGetLastError();
}
