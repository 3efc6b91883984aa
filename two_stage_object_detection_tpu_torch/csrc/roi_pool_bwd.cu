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
// * roi_pool_bwd_scatter_launch (kernel 5b) is the backward of kernel 5
//   (csrc/roi_pool.cu), which did save its argmax: (argmax, g) -> dfeat.
//   In the JAX package this is a scatter-add beside `_roi_pool_kernel`
//   (ops/pallas_roi.py, `_bwd`).  It is kernel 6's last step on its own.
//
// The TPU kernel keeps one [H, W, 128] block of dfeat in VMEM and walks the
// rois in order.  Here the same idea, in shared memory (the slice route):
// grid (channel slice, image), one block walks every roi of its image.
//  - At the start a block zeroes an f32 dfeat slice [H, W, slice] in
//    dynamic shared memory.  Kernel 6's block also copies the map's
//    [H, W, slice] into shared memory (one bulk copy a pixel, completing on
//    an mbarrier, where a pixel's slice is a multiple of 16 bytes; plain
//    vector loads otherwise), and computes its rois' bin edges meanwhile.
//  - Kernel 6: threads work over (roi, bin) x 16-byte vector of channels
//    (8 bf16 or 4 f32; 8 bytes where C * 2 is not a multiple of 16).  Each bin
//    is scanned from shared memory in row-major order from its first pixel
//    with a strictly-greater update (the first maximum), bf16 maps two
//    channels a compare (set.gt.u32.bf16x2, exact: the upcast keeps the
//    order) -- the scan of csrc/roi_pool.cu, the same bins, the same
//    half-to-even rounding.  The cotangent (f32, read once, coalesced; the
//    next item's is loaded before this one's scan) is added at the winner
//    with a shared-memory atomicAdd (a compare-and-swap loop on the H100,
//    ATOMS.CAST.SPIN).  Empty bins and zero cotangents add nothing.
//  - Kernel 5b: a block reads its channel slice of argmax and g once,
//    coalesced, four rows a thread in flight, and adds into shared memory.
//  - At the end each block writes its slice to device memory once, in the
//    output dtype (the map's for kernel 6, f32 for 5b); kernel 6 stages it
//    in the map slice's buffer and stores it with one bulk copy a pixel
//    where the pixel's slice is whole 16-byte units.  There is no global
//    atomic, no f32 map to zero first and no pass to convert it after.
// The slice width and the grid come from ops/roi_pool_max.py:
// roi_pool_bwd_plan: one block a slice and image, no roi chunks, the width
// that spreads the vectors over the SMs most evenly.  At B=16, 38x38x512:
// kernel 6 from a bf16 map 16 channels a slice (6 bytes a pixel and channel:
// 151,764 bytes with the gradient's padding and the bin edges, 512
// blocks), 5b 32 channels (4 bytes, 184,832 bytes, 256 blocks).
//
// A map whose narrowest slice (one vector) does not fit takes the direct
// route, the design before the slice: kernel 6 one block per (roi, image),
// threads over 4 channels each, every bin read straight from global memory
// (L2); 5b one thread per 4 channels of one (image, roi, bin); both
// atomicAdd into an f32 dfeat in global memory that the wrapper zeroes.
//
// Either way the additions collide (adjacent bins share a row or a column,
// rois overlap) and their order is not fixed: the result equals the plain
// version up to f32 summation order, not bit for bit.
//
// What bounds them on the H100: bytes.  g is f32 per (roi, bin, channel):
// 205.5 MB at B=16, R=128, P=7, C=512, read once.  Kernel 6 also reads the
// bf16 map (23.7 MB) and writes a bf16 dfeat (23.7 MB): 252.9 MB; 5b reads
// the int32 argmax (205.5 MB) and writes an f32 dfeat (47.3 MB): 458.4 MB.
// The design before the slice zeroed a 47.3 MB f32 dfeat, resolved some
// 45-51 M f32 atomicAdds in L2 and (kernel 6) scanned every bin's pixels
// from L2 (892.6 MB at R=128) and converted dfeat in a second pass.  On the
// slice route kernel 6 is held by its shared-memory work, not the bytes:
// the scan and the compare-and-swap loops of its adds take about a third
// each, the serial copy-in and write-out of each block's four waves most
// of the rest (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDirectThreads = 128;
constexpr int kSliceThreads = 1024;

// the bin edges of csrc/roi_pool.cu
__device__ __forceinline__ void bin_range(int lo, int hi, int p, int pooled,
                                          int limit, int* start, int* end) {
  const long long size = max(hi - lo, 1);
  const long long s = (long long)p * size / pooled + lo;
  const long long e = ((long long)(p + 1) * size + pooled - 1) / pooled + lo;
  *start = (int)min(max(s, 0ll), (long long)limit);
  *end = (int)min(max(e, 0ll), (long long)limit);
}

__device__ __forceinline__ int4 roi_corners(float4 box, float scale) {
  return make_int4(__float2int_rn(__fmul_rn(box.x, scale)),
                   __float2int_rn(__fmul_rn(box.y, scale)),
                   __float2int_rn(__fmul_rn(box.z, scale)),
                   __float2int_rn(__fmul_rn(box.w, scale)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One 32-bit word of a pixel's channels, as csrc/roi_pool.cu scans it: a
// bf16 word holds 2 channels, compared as a pair (set.gt.u32.bf16x2 gives
// 0xffff in each half that is greater) and selected with bit masks, its two
// indices packed as 16-bit halves (the slice route takes maps of fewer than
// 65,536 pixels); an f32 word is one channel.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int kCh = 1;
  static __device__ __forceinline__ unsigned greater(unsigned a, unsigned b) {
    return __uint_as_float(a) > __uint_as_float(b) ? 0xffffffffu : 0u;
  }
  static __device__ __forceinline__ unsigned index(int p) { return p; }
  static __device__ __forceinline__ void unpack(unsigned i, int* idx) {
    idx[0] = (int)i;
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int kCh = 2;
  static __device__ __forceinline__ unsigned greater(unsigned a, unsigned b) {
    unsigned m;
    asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(m) : "r"(a), "r"(b));
    return m;
  }
  static __device__ __forceinline__ unsigned index(int p) {
    return (unsigned)p | (unsigned)p << 16;
  }
  static __device__ __forceinline__ void unpack(unsigned i, int* idx) {
    idx[0] = (int)(i & 0xffffu);
    idx[1] = (int)(i >> 16);
  }
};

// A vector of a pixel's channels of T, kBytes wide: 16 bytes (4 f32 or 8
// bf16 channels), or 8 (4 bf16, where C * 2 is not a multiple of 16).
template <typename T, int kBytes>
struct Vec {
  static constexpr int kCh = kBytes / (int)sizeof(T);
  static constexpr int kWords = kBytes / 4;
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              unsigned* w) {
    if constexpr (kWords == 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x; w[1] = q.y;
    }
  }
  static __device__ __forceinline__ void copy(unsigned char* dst,
                                              const T* src) {
    if constexpr (kWords == 4) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    }
  }
};

// kCh f32 sums written as T: f32 as they are, bf16 rounded to nearest even
// (as PyTorch's .to(torch.bfloat16) rounds), kCh * sizeof(T) bytes at once.
template <int kCh>
__device__ __forceinline__ void store_sums(float* dst, const float* v) {
#pragma unroll
  for (int q = 0; q < kCh; q += 4) {
    *reinterpret_cast<float4*>(dst + q) =
        make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
}
template <int kCh>
__device__ __forceinline__ void store_sums(__nv_bfloat16* dst, const float* v) {
  unsigned w[kCh / 2];
#pragma unroll
  for (int q = 0; q < kCh / 2; ++q) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    w[q] = *reinterpret_cast<const unsigned*>(&pair);
  }
  if constexpr (kCh == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// Dynamic shared memory of kernel 6's slice kernel, for `nv` vectors of
// `ch` channels a pixel (ops/roi_pool_max.py:roi_pool_bwd_plan computes the
// same bytes): the map slice (rounded up to 16 bytes); the f32 gradient
// slice, nv * ch + 1 floats a pixel (an odd stride, so that the adds of one
// instruction, at the random winners of the warp's bins, spread over the 32
// banks: without it kernel 6 took twice as long on the H100), rounded up to
// 16 bytes; then each roi's bin edges ([rois_per_pass][2][pooled] of start
// | end << 16, rows then columns) and each bin's (ph << 16 | pw); all
// unsigned.  Kernel 5b holds the gradient slice alone, hw * nv * 16 bytes.
__host__ __device__ inline int grad_stride(int nv, int ch) {
  return nv * ch + 1;
}
__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t grad_slice_bytes(int hw, int nv, int ch) {
  return round16((size_t)hw * grad_stride(nv, ch) * 4);
}
__host__ __device__ inline size_t recompute_smem(int hw, int nv, int vec_bytes,
                                                 int ch, int rois_per_pass,
                                                 int pooled) {
  return round16((size_t)hw * nv * vec_bytes) + grad_slice_bytes(hw, nv, ch) +
         ((size_t)rois_per_pass * 2 * pooled + (size_t)pooled * pooled) * 4;
}

__device__ __forceinline__ void zero_slice(float* d_s, int n) {
  for (int i = threadIdx.x; i < n; i += kSliceThreads) d_s[i] = 0.f;
}

// The block's gradient slice (`gs` floats a pixel, `my_nv` vectors of kCh
// channels) to out ([hw][c] of T, from the slice's first channel), once.
template <int kCh, typename T>
__device__ __forceinline__ void write_slice(const float* d_s, int gs, T* out,
                                            int hw, int c, int my_nv) {
  for (int q = threadIdx.x; q < hw * my_nv; q += kSliceThreads) {
    const int p = q / my_nv, v = q - p * my_nv;
    float sums[kCh];
#pragma unroll
    for (int k = 0; k < kCh; ++k) sums[k] = d_s[p * gs + v * kCh + k];
    store_sums<kCh>(out + (size_t)p * c + v * kCh, sums);
  }
}

// grid (slices, B), kSliceThreads threads.  A slice is `nv` vectors of
// kCh channels; the last one may have fewer (`my_nv`).  Thread t takes
// vector t % my_nv of every (roi, bin) t / my_nv, t / my_nv + lanes, ...:
// neighbouring threads read neighbouring vectors of a pixel and of g.
template <typename T, int kVecBytes>
__global__ void __launch_bounds__(kSliceThreads, 1)
recompute_slice_kernel(const T* __restrict__ feats,
                       const float4* __restrict__ rois,
                       const float* __restrict__ g, T* __restrict__ dfeat,
                       int h, int w, int c, int r, int pooled, float scale,
                       int nv, int rois_per_pass) {
  using V = Vec<T, kVecBytes>;
  using W = Word<T>;
  constexpr int kCh = V::kCh;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  const int img = blockIdx.y, tid = threadIdx.x;
  const int hw = h * w, bins = pooled * pooled;
  const int v0 = blockIdx.x * nv;                  // first vector of the slice
  const int my_nv = min(nv, c / kCh - v0);
  const int gs = grad_stride(my_nv, kCh);          // floats a pixel
  const unsigned pixel_bytes = (unsigned)(my_nv * kVecBytes);
  unsigned char* map_s = smem;
  float* d_s = reinterpret_cast<float*>(smem + round16((size_t)hw * nv * kVecBytes));
  unsigned* edges = reinterpret_cast<unsigned*>(
      reinterpret_cast<unsigned char*>(d_s) + grad_slice_bytes(hw, nv, kCh));
  unsigned* bin_at = edges + (size_t)rois_per_pass * 2 * pooled;
  const T* f = feats + (size_t)img * hw * c + (size_t)v0 * kCh;
  // uniform in the block: every pixel's slice is whole 16-byte units and
  // starts on 16 bytes (the map itself does)
  const bool bulk = pixel_bytes % 16 == 0 && (c * sizeof(T)) % 16 == 0 &&
                    (v0 * kVecBytes) % 16 == 0;

  if (bulk) {
    const uint32_t b = smem_addr(&bar);
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
          "r"(pixel_bytes * (unsigned)hw) : "memory");
    }
    __syncthreads();
    for (int p = tid; p < hw; p += kSliceThreads) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(smem_addr(map_s + (size_t)p * pixel_bytes)),
          "l"(f + (size_t)p * c), "r"(pixel_bytes), "r"(b)
          : "memory");
    }
  } else {
    for (int q = tid; q < hw * my_nv; q += kSliceThreads) {
      const int p = q / my_nv, v = q - p * my_nv;
      V::copy(map_s + (size_t)q * kVecBytes, f + (size_t)p * c + v * kCh);
    }
  }
  // while the slice arrives: zero the gradient slice, the (ph, pw) of each
  // bin and the first pass's bin edges
  zero_slice(d_s, hw * gs);
  for (int t = tid; t < bins; t += kSliceThreads) {
    bin_at[t] = (unsigned)(t / pooled) << 16 | (unsigned)(t % pooled);
  }
  auto bin_edges = [&](int r0, int n_rois) {
    for (int t = tid; t < n_rois * 2 * pooled; t += kSliceThreads) {
      const int roi = t / (2 * pooled), rem = t - roi * 2 * pooled;
      const int p = rem % pooled;
      const int4 q = roi_corners(rois[(size_t)img * r + r0 + roi], scale);
      int s, e;
      if (rem < pooled) {
        bin_range(q.y, q.w, p, pooled, h, &s, &e);
      } else {
        bin_range(q.x, q.z, p, pooled, w, &s, &e);
      }
      edges[t] = (unsigned)s | (unsigned)e << 16;
    }
  };
  int r0 = 0, n_rois = min(rois_per_pass, r);
  bin_edges(r0, n_rois);
  if (bulk) mbar_wait(smem_addr(&bar), 0);
  __syncthreads();

  const int v = tid % my_nv, lanes = kSliceThreads / my_nv;
  const int first = tid / my_nv;       // >= lanes: a thread left over
  const int roi_step = lanes / bins, bin_step = lanes % bins;
  const unsigned char* base = map_s + (size_t)v * kVecBytes;
  const float* g_img = g + (size_t)img * r * bins * c + (size_t)(v0 + v) * kCh;
  float* d_v = d_s + v * kCh;
  while (true) {
    if (first < lanes) {
      // this item's cotangent, kCh f32 (zeros past the last roi)
      auto g_of = [&](int roi, int bin, float4* out) {
        const float4* src = reinterpret_cast<const float4*>(
            g_img + ((size_t)(r0 + roi) * bins + bin) * c);
#pragma unroll
        for (int q = 0; q < kCh / 4; ++q) {
          out[q] = roi < n_rois ? __ldcs(src + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      };
      int roi = first / bins, bin = first % bins;
      float4 gq[kCh / 4];
      g_of(roi, bin, gq);
      while (roi < n_rois) {
        int next_roi = roi + roi_step, next_bin = bin + bin_step;
        if (next_bin >= bins) {
          next_bin -= bins;
          ++next_roi;
        }
        float4 g_next[kCh / 4];
        g_of(next_roi, next_bin, g_next);   // in flight during the scan
        const unsigned pb = bin_at[bin];
        const unsigned ey = edges[roi * 2 * pooled + (pb >> 16)];
        const unsigned ex = edges[roi * 2 * pooled + pooled + (pb & 0xffffu)];
        const int hs = ey & 0xffffu, he = ey >> 16;
        const int ws = ex & 0xffffu, we = ex >> 16;
        if (hs < he && ws < we) {   // an empty bin: no credit
          unsigned bw[V::kWords], bi[V::kWords];
          V::load(base + (size_t)(hs * w + ws) * pixel_bytes, bw);
#pragma unroll
          for (int k = 0; k < V::kWords; ++k) bi[k] = W::index(hs * w + ws);
          for (int y = hs; y < he; ++y) {
            const unsigned char* row = base + (size_t)(y * w) * pixel_bytes;
            for (int x = ws; x < we; ++x) {
              unsigned vw[V::kWords];
              V::load(row + (size_t)x * pixel_bytes, vw);
              const unsigned cur = W::index(y * w + x);
#pragma unroll
              for (int k = 0; k < V::kWords; ++k) {
                const unsigned m = W::greater(vw[k], bw[k]);
                bw[k] = (vw[k] & m) | (bw[k] & ~m);
                bi[k] = (cur & m) | (bi[k] & ~m);
              }
            }
          }
          int idx[kCh];
#pragma unroll
          for (int k = 0; k < V::kWords; ++k) W::unpack(bi[k], idx + k * W::kCh);
          const float* gv = reinterpret_cast<const float*>(gq);
#pragma unroll
          for (int k = 0; k < kCh; ++k) {
            if (gv[k] != 0.f) atomicAdd(d_v + idx[k] * gs + k, gv[k]);
          }
        }
        roi = next_roi;
        bin = next_bin;
#pragma unroll
        for (int q = 0; q < kCh / 4; ++q) gq[q] = g_next[q];
      }
    }
    __syncthreads();   // every add of the pass is in; the edges are free
    r0 += rois_per_pass;
    if (r0 >= r) break;
    n_rois = min(rois_per_pass, r - r0);
    bin_edges(r0, n_rois);
    __syncthreads();
  }
  T* out = dfeat + (size_t)img * hw * c + (size_t)v0 * kCh;
  if (!bulk) {
    write_slice<kCh>(d_s, gs, out, hw, c, my_nv);
    return;
  }
  // the sums as T, pixel-major, in the map slice's buffer (free now), then
  // one bulk store a pixel: the block waits only until they are read
  T* stage = reinterpret_cast<T*>(map_s);
  for (int q = tid; q < hw * my_nv; q += kSliceThreads) {
    const int p = q / my_nv, v = q - p * my_nv;
    float sums[kCh];
#pragma unroll
    for (int k = 0; k < kCh; ++k) sums[k] = d_s[p * gs + v * kCh + k];
    store_sums<kCh>(stage + (size_t)q * kCh, sums);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  for (int p = tid; p < hw; p += kSliceThreads) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            out + (size_t)p * c),
        "r"(smem_addr(stage + (size_t)p * my_nv * kCh)), "r"(pixel_bytes)
        : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// (x, g) of one argmax vector added into the slice: an index outside the
// map (-1: an empty bin) or a zero cotangent adds nothing
__device__ __forceinline__ void scatter4(float* d_v, int4 iq, float4 gq,
                                         int hw, int gs) {
  const int idx[4] = {iq.x, iq.y, iq.z, iq.w};
  const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if ((unsigned)idx[k] < (unsigned)hw && gv[k] != 0.f) {
      atomicAdd(d_v + idx[k] * gs + k, gv[k]);
    }
  }
}

// grid (slices, B), kSliceThreads threads; a slice is `nv` vectors of 4
// channels; rows are the image's R * P * P (roi, bin) rows of argmax and g.
// Thread t takes vector t % my_nv of rows t / my_nv, t / my_nv + lanes, ...
// The gradient slice keeps the slice's own stride here: its zeroing and its
// write-out go in 16-byte vectors, which saved more on the H100 than the
// odd stride's fewer bank conflicts among the adds.
__global__ void __launch_bounds__(kSliceThreads, 1)
scatter_slice_kernel(const int* __restrict__ argmax,
                     const float* __restrict__ g, float* __restrict__ dfeat,
                     int hw, int c, int n_rows, int nv) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* d_s = reinterpret_cast<float*>(smem);
  const int img = blockIdx.y, tid = threadIdx.x;
  float4* d4 = reinterpret_cast<float4*>(smem);
  const int v0 = blockIdx.x * nv;
  const int my_nv = min(nv, c / 4 - v0);
  const int gs = my_nv * 4;
  for (int i = tid; i < hw * my_nv; i += kSliceThreads) {
    d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const int v = tid % my_nv, lanes = kSliceThreads / my_nv;
  const int first = tid / my_nv;
  if (first < lanes) {
    const size_t off = (size_t)img * n_rows * c + (size_t)(v0 + v) * 4;
    const int4* a = reinterpret_cast<const int4*>(argmax + off);
    const float4* gg = reinterpret_cast<const float4*>(g + off);
    const size_t rs = (size_t)c / 4;                  // a row, in vectors
    float* d_v = d_s + v * 4;
    int row = first;
    for (; row + 3 * lanes < n_rows; row += 4 * lanes) {
      int4 iq[4];
      float4 gq[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        iq[u] = __ldcs(a + (size_t)(row + u * lanes) * rs);
        gq[u] = __ldcs(gg + (size_t)(row + u * lanes) * rs);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) scatter4(d_v, iq[u], gq[u], hw, gs);
    }
    for (; row < n_rows; row += lanes) {
      scatter4(d_v, __ldcs(a + (size_t)row * rs), __ldcs(gg + (size_t)row * rs),
               hw, gs);
    }
  }
  __syncthreads();
  float* out = dfeat + (size_t)img * hw * c + (size_t)v0 * 4;
  for (int q = tid; q < hw * my_nv; q += kSliceThreads) {
    const int p = q / my_nv;
    *reinterpret_cast<float4*>(out + (size_t)p * c + (q - p * my_nv) * 4) = d4[q];
  }
}

// ---------------------------------------------------------- direct route
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

template <typename T>
__global__ void __launch_bounds__(kDirectThreads)
recompute_direct_kernel(const T* __restrict__ feats,
                        const float4* __restrict__ rois,
                        const float* __restrict__ g, int h, int w, int c,
                        int r, int pooled, float scale,
                        float* __restrict__ dfeat) {
  const int roi = blockIdx.x, img = blockIdx.y;
  const int4 q = roi_corners(rois[(size_t)img * r + roi], scale);
  const T* f = feats + (size_t)img * h * w * c;
  float* d = dfeat + (size_t)img * h * w * c;
  const size_t base = ((size_t)img * r + roi) * pooled * pooled * c;

  for (int ph = 0; ph < pooled; ++ph) {
    int hs, he;
    bin_range(q.y, q.w, ph, pooled, h, &hs, &he);
    for (int pw = 0; pw < pooled; ++pw) {
      int ws, we;
      bin_range(q.x, q.z, pw, pooled, w, &ws, &we);
      if (hs >= he || ws >= we) continue;          // an empty bin: no credit
      const size_t o = base + (size_t)(ph * pooled + pw) * c;
      for (int ch = threadIdx.x * 4; ch < c; ch += kDirectThreads * 4) {
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
            for (int k = 0; k < 4; ++k) {
              if (idx[k] < 0 || v[k] > best[k]) {
                best[k] = v[k];
                idx[k] = y * w + x;
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (gv[k] != 0.f) atomicAdd(d + (size_t)idx[k] * c + ch + k, gv[k]);
        }
      }
    }
  }
}

// one thread per 4 neighbouring channels of one (image, roi, bin)
__global__ void __launch_bounds__(256)
scatter_direct_kernel(const int4* __restrict__ argmax,
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
  for (int k = 0; k < 4; ++k) {
    if (idx[k] >= 0 && gv[k] != 0.f) atomicAdd(d + (size_t)idx[k] * c + k, gv[k]);
  }
}

template <typename T, int kVecBytes>
cudaError_t launch_recompute_slice(const void* feats, const float4* rois,
                                   const float* g, void* dfeat, int batch,
                                   int h, int w, int c, int r, int pooled,
                                   float scale, int nv, int n_slices,
                                   int rois_per_pass, cudaStream_t s) {
  auto kernel = recompute_slice_kernel<T, kVecBytes>;
  const int smem = (int)recompute_smem(h * w, nv, kVecBytes,
                                       Vec<T, kVecBytes>::kCh, rois_per_pass,
                                       pooled);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_slices, batch), kSliceThreads, smem, s>>>(
      static_cast<const T*>(feats), rois, g, static_cast<T*>(dfeat), h, w, c,
      r, pooled, scale, nv, rois_per_pass);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_recompute_direct(const void* feats, const float4* rois,
                                    const float* g, void* dfeat, int batch,
                                    int h, int w, int c, int r, int pooled,
                                    float scale, cudaStream_t s) {
  if (r > 0) {
    recompute_direct_kernel<T><<<dim3(r, batch), kDirectThreads, 0, s>>>(
        static_cast<const T*>(feats), rois, g, h, w, c, r, pooled, scale,
        static_cast<float*>(dfeat));
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16.  The wrapper hands 16-byte-aligned contiguous
// tensors with C % 4 == 0 and the plan of ops/roi_pool_max.py:
// roi_pool_bwd_plan.  vec_bytes 16 or 8 (bf16 with C % 8 != 0): the slice
// route, `nv` vectors a slice, `n_slices` slices, `rois_per_pass` rois'
// bin edges at a time; dfeat [batch, h, w, c] in the map's dtype, every
// element written.  vec_bytes 0: the direct route; dfeat [batch, h, w, c]
// f32, zeroed by the caller.  Returns a cudaError_t code.
extern "C" int roi_pool_bwd_recompute_launch(const void* feats,
                                             const void* rois, const void* g,
                                             void* dfeat, int batch, int h,
                                             int w, int c, int r, int pooled,
                                             float scale, int dtype,
                                             int vec_bytes, int nv,
                                             int n_slices, int rois_per_pass,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || r < 0 || c % 4 != 0 || pooled < 1 ||
      (vec_bytes != 0 && (nv < 1 || nv > kSliceThreads || n_slices < 1 ||
                          rois_per_pass < 1 || h * w >= 65536))) {
    return (int)cudaErrorInvalidValue;
  }
  const float4* b = static_cast<const float4*>(rois);
  const float* gp = static_cast<const float*>(g);
  if (vec_bytes == 0) {
    if (dtype == 0)
      return (int)launch_recompute_direct<float>(feats, b, gp, dfeat, batch, h,
                                                 w, c, r, pooled, scale, s);
    if (dtype == 1)
      return (int)launch_recompute_direct<__nv_bfloat16>(
          feats, b, gp, dfeat, batch, h, w, c, r, pooled, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  // every channel in exactly one slice
  const int elem = dtype == 0 ? 4 : 2;
  const int cv = c * elem / vec_bytes;
  if ((c * elem) % vec_bytes != 0 || (long long)(n_slices - 1) * nv >= cv ||
      (long long)n_slices * nv < cv) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0 && vec_bytes == 16)
    return (int)launch_recompute_slice<float, 16>(
        feats, b, gp, dfeat, batch, h, w, c, r, pooled, scale, nv, n_slices,
        rois_per_pass, s);
  if (dtype == 1 && vec_bytes == 16)
    return (int)launch_recompute_slice<__nv_bfloat16, 16>(
        feats, b, gp, dfeat, batch, h, w, c, r, pooled, scale, nv, n_slices,
        rois_per_pass, s);
  if (dtype == 1 && vec_bytes == 8)
    return (int)launch_recompute_slice<__nv_bfloat16, 8>(
        feats, b, gp, dfeat, batch, h, w, c, r, pooled, scale, nv, n_slices,
        rois_per_pass, s);
  return (int)cudaErrorInvalidValue;
}

// argmax, g: [batch, n_per_image, c] (n_per_image = R * P * P), c % 4 == 0;
// dfeat: [batch, hw, c] f32.  nv > 0: the slice route (`nv` 4-channel
// vectors a slice, `n_slices` slices), every element written; nv == 0: the
// direct route, dfeat zeroed by the caller.  Returns a cudaError_t code.
extern "C" int roi_pool_bwd_scatter_launch(const void* argmax, const void* g,
                                           void* dfeat, int batch,
                                           int n_per_image, int c, int hw,
                                           int nv, int n_slices,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n_per_image < 0 || c % 4 != 0 || nv < 0 ||
      (nv > 0 && (nv > kSliceThreads || (long long)(n_slices - 1) * nv >= c / 4 ||
                  (long long)n_slices * nv < c / 4))) {
    return (int)cudaErrorInvalidValue;
  }
  if (nv > 0) {
    const int smem = hw * nv * 16;
    cudaError_t err = cudaFuncSetAttribute(
        scatter_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    scatter_slice_kernel<<<dim3(n_slices, batch), kSliceThreads, smem, s>>>(
        static_cast<const int*>(argmax), static_cast<const float*>(g),
        static_cast<float*>(dfeat), hw, c, n_per_image, nv);
    return (int)cudaGetLastError();
  }
  const long long per_image4 = (long long)n_per_image * c / 4;
  const long long n4 = per_image4 * batch;
  const int threads = 256;
  const long long blocks = (n4 + threads - 1) / threads;
  if (blocks > 0) {
    scatter_direct_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const int4*>(argmax), static_cast<const float4*>(g), n4,
        per_image4, c, hw, static_cast<float*>(dfeat));
  }
  return (int)cudaGetLastError();
}
