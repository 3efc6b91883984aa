// RoIPool max backward, for the single-scale RoI head's train step.
//
// Two entry points:
//
// * roi_pool_bwd_recompute_launch (kernel 6) replaces the TPU kernel
//   `_bwd_kernel` of the JAX package (ops/pallas_roi_bwd.py):
//   (feat, rois, g) -> dfeat, the pooled cotangent g of every bin and
//   channel credited to the bin's first maximum in row-major order.  The
//   maximum is found again from the map, so nothing of size [B, R, P, P, C]
//   has to live between the forward and the backward pass.
// * roi_pool_bwd_scatter_launch is the backward of kernel 5
//   (csrc/roi_pool.cu), which did save its argmax: (argmax, g) -> dfeat.
//   In the JAX package this is a scatter-add beside `_roi_pool_kernel`
//   (ops/pallas_roi.py, `_bwd`).  It is kernel 6's last step on its own.
//
// The TPU kernel keeps one [H, W, 128] block of dfeat in VMEM, walks the
// rois in order and rebuilds both separable max stages with dense equality
// masks, because the TPU gathers and scatters badly.  Here the work is
// turned round: one block per (roi, image), threads over channels (4
// neighbouring channels a thread, so every load of the NHWC map is
// coalesced), each bin scanned in row-major order with a strictly-greater
// update -- the scan of csrc/roi_pool.cu, the same bins, the same
// half-to-even rounding, the same first maximum -- and g added at the
// winner.  An empty bin adds nothing.
//
// Adjacent bins share a row or a column (floor and ceiling edges) and rois
// overlap freely, so additions collide: they are atomicAdd on an f32 buffer
// in global memory that the wrapper zeroes.  The order of the additions is
// therefore not fixed, and the result equals the plain version up to f32
// summation order, not bit for bit.  A cotangent of exactly 0 is skipped
// (adding it changes nothing): padded samples carry such rows.
//
// What bounds it on the H100: bytes.  g is f32 per (roi, bin, channel):
// 205 MB at B=16, R=128, P=7, C=512, read once and coalesced; the map
// (11.8 MB in bf16) and dfeat (23.7 MB of f32) stay in the 50 MB L2, where
// the atomics are resolved.

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

// the bin edges of csrc/roi_pool.cu
__device__ __forceinline__ void bin_range(int lo, int hi, int p, int pooled,
                                          int limit, int* start, int* end) {
  const long long size = max(hi - lo, 1);
  const long long s = (long long)p * size / pooled + lo;
  const long long e = ((long long)(p + 1) * size + pooled - 1) / pooled + lo;
  *start = (int)min(max(s, 0ll), (long long)limit);
  *end = (int)min(max(e, 0ll), (long long)limit);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_pool_bwd_recompute_kernel(const T* __restrict__ feats,
                              const float4* __restrict__ rois,
                              const float* __restrict__ g, int h, int w, int c,
                              int r, int pooled, float scale,
                              float* __restrict__ dfeat) {
  const int roi = blockIdx.x, img = blockIdx.y;
  const float4 box = rois[(size_t)img * r + roi];
  const int x1 = __float2int_rn(__fmul_rn(box.x, scale));
  const int y1 = __float2int_rn(__fmul_rn(box.y, scale));
  const int x2 = __float2int_rn(__fmul_rn(box.z, scale));
  const int y2 = __float2int_rn(__fmul_rn(box.w, scale));
  const T* f = feats + (size_t)img * h * w * c;
  float* d = dfeat + (size_t)img * h * w * c;
  const size_t base = ((size_t)img * r + roi) * pooled * pooled * c;

  for (int ph = 0; ph < pooled; ++ph) {
    int hs, he;
    bin_range(y1, y2, ph, pooled, h, &hs, &he);
    for (int pw = 0; pw < pooled; ++pw) {
      int ws, we;
      bin_range(x1, x2, pw, pooled, w, &ws, &we);
      if (hs >= he || ws >= we) continue;          // an empty bin: no credit
      const size_t o = base + (size_t)(ph * pooled + pw) * c;
      for (int ch = threadIdx.x * 4; ch < c; ch += kThreads * 4) {
        const float4 gq = *reinterpret_cast<const float4*>(g + o + ch);
        const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
        if (gv[0] == 0.f && gv[1] == 0.f && gv[2] == 0.f && gv[3] == 0.f)
          continue;
        float best[4] = {0.f, 0.f, 0.f, 0.f};
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
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (gv[q] != 0.f) atomicAdd(d + (size_t)idx[q] * c + ch + q, gv[q]);
        }
      }
    }
  }
}

// one thread per 4 neighbouring channels of one (image, roi, bin)
__global__ void __launch_bounds__(256)
roi_pool_bwd_scatter_kernel(const int4* __restrict__ argmax,
                            const float4* __restrict__ g, long long n4,
                            long long per_image4, int c, int hw,
                            float* __restrict__ dfeat) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  const int4 iq = argmax[e];
  const float4 gq = g[e];
  const long long img = e / per_image4;
  const int ch = (int)((e * 4) % c);
  float* d = dfeat + (size_t)img * hw * c + ch;
  const int idx[4] = {iq.x, iq.y, iq.z, iq.w};
  const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (idx[q] >= 0 && gv[q] != 0.f) atomicAdd(d + (size_t)idx[q] * c + q, gv[q]);
  }
}

}  // namespace

// dfeat: [batch, h, w, c] f32, zeroed by the caller.  The wrapper hands
// 16-byte-aligned tensors with C % 4 == 0.
extern "C" int roi_pool_bwd_recompute_launch(const void* feats,
                                             const void* rois, const void* g,
                                             void* dfeat, int batch, int h,
                                             int w, int c, int r, int pooled,
                                             float scale, int dtype,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(r, batch);
  const float4* b = static_cast<const float4*>(rois);
  const float* gp = static_cast<const float*>(g);
  float* d = static_cast<float*>(dfeat);
  if (dtype == 0) {
    roi_pool_bwd_recompute_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(feats), b, gp, h, w, c, r, pooled, scale, d);
  } else {
    roi_pool_bwd_recompute_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), b, gp, h, w, c, r, pooled,
        scale, d);
  }
  return (int)cudaGetLastError();
}

// argmax, g: [batch, n_per_image, c] (n_per_image = R * P * P), c % 4 == 0;
// dfeat: [batch, hw, c] f32, zeroed by the caller.
extern "C" int roi_pool_bwd_scatter_launch(const void* argmax, const void* g,
                                           void* dfeat, int batch,
                                           int n_per_image, int c, int hw,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_image4 = (long long)n_per_image * c / 4;
  const long long n4 = per_image4 * batch;
  const int threads = 256;
  const long long blocks = (n4 + threads - 1) / threads;
  if (blocks > 0) {
    roi_pool_bwd_scatter_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const int4*>(argmax), static_cast<const float4*>(g), n4,
        per_image4, c, hw, static_cast<float*>(dfeat));
  }
  return (int)cudaGetLastError();
}
