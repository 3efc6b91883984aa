// RoIPool max forward with the per-bin argmax, for the single-scale RoI head.
//
// Replaces the TPU kernel `_roi_pool_kernel` of the JAX package
// (ops/pallas_roi.py): for each roi, torchvision RoIPool integer bins
// (rois scaled and rounded half to even; start = p*size/P + lo,
// end = ceil((p+1)*size/P) + lo, size = max(hi - lo, 1); both clamped to
// the map), the max of each bin per channel and the flat index y*W + x of
// its first maximum in row-major order.  An empty bin gives 0 and -1.
//
// The TPU kernel holds an [H, W, c_tile] slice of the map in VMEM and
// serves every roi from it.  Here the same idea, in shared memory
// (roi_pool_slice_kernel): grid (channel slice, image, roi chunk).  A block
// copies its image's [H, W, nv vectors] slice into dynamic shared memory
// once (one bulk copy a pixel, completing on an mbarrier, where a vector
// is 16 bytes; plain 8-byte loads where it is 8), and meanwhile computes
// its rois' bin edges into shared memory; then it pools every roi of its
// chunk from there.  Threads work over (roi, bin) x vector: neighbouring
// threads take neighbouring 16-byte vectors of one pixel, so the shared
// memory reads are conflict-free and each bin's values (and indices) go
// out as coalesced 16-byte stores.  Each bin is scanned row-major from its
// first pixel, the index moving only on a strictly greater value: the
// first maximum.  bf16 maps are compared two channels an instruction, in
// bf16 (exact: the upcast to f32 keeps the order), and pooled in f32 at
// the end.  With a null `argmax` (a forward that no backward will follow)
// the indices are not stored.  At 38x38, a slice is 64 bf16 or 32 f32
// channels (184,832 bytes); the wrapper (ops/roi_pool_max.py:
// roi_pool_plan) picks the slices and the roi chunks so that the grid
// covers the SMs.
//
// A map whose narrowest slice (one vector a pixel) does not fit in shared
// memory takes roi_pool_direct_kernel, the design before the slice: one
// block per (roi, image), threads over 4 channels each, every bin read
// straight from global memory (L2).
//
// What bounds it on the H100: bytes.  The outputs are f32 + int32 per
// (roi, bin, channel): 963 MB at B=16, R=300, P=7, C=512, against a 23.6 MB
// bf16 map read once.  The direct scan re-reads each roi's region from L2
// (the bin pixels x C x 2 bytes, 2.1 GB at R=300 on chip_smoke.py's rois);
// the slice kernel reads it from shared memory instead, where the compare
// and select instructions of the scan, not the bytes, come next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDirectThreads = 128;
constexpr int kSliceThreads = 1024;

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

// kN values and, with kWithArgmax, their indices, as 16-byte stores
template <int kN, bool kWithArgmax>
__device__ __forceinline__ void store_bin(float* out, int* argmax, size_t o,
                                          const float* best, const int* idx) {
#pragma unroll
  for (int q = 0; q < kN; q += 4) {
    *reinterpret_cast<float4*>(out + o + q) =
        make_float4(best[q], best[q + 1], best[q + 2], best[q + 3]);
    if constexpr (kWithArgmax) {
      *reinterpret_cast<int4*>(argmax + o + q) =
          make_int4(idx[q], idx[q + 1], idx[q + 2], idx[q + 3]);
    }
  }
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

// One 32-bit word of a vector: a bf16 word holds 2 channels, compared as a
// pair (set.gt.u32.bf16x2 gives 0xffff in each half that is greater; an
// unordered pair is not greater, as in f32) and selected with bit masks,
// its two indices packed as 16-bit halves (the slice route takes maps of
// fewer than 65,536 pixels); an f32 word is one channel.  The compare of
// two bf16 equals the compare of their exact f32 upcasts, and a select
// keeps the bits, so the result equals the f32 scan's.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int kCh = 1;
  static __device__ __forceinline__ unsigned greater(unsigned a, unsigned b) {
    return __uint_as_float(a) > __uint_as_float(b) ? 0xffffffffu : 0u;
  }
  static __device__ __forceinline__ unsigned index(int p) { return p; }
  static __device__ __forceinline__ void unpack(unsigned v, unsigned i,
                                                float* val, int* idx) {
    val[0] = __uint_as_float(v);
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
  static __device__ __forceinline__ void unpack(unsigned v, unsigned i,
                                                float* val, int* idx) {
    val[0] = __uint_as_float(v << 16);
    val[1] = __uint_as_float(v & 0xffff0000u);
    idx[0] = (int)(i & 0xffffu);
    idx[1] = (int)(i >> 16);
  }
};

template <int kWords>
__device__ __forceinline__ void load_words(const unsigned char* p,
                                           unsigned* w) {
  if constexpr (kWords == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x; w[1] = q.y;
  }
}

// The 8 values (and indices) at out + o of this thread and its partner
// (lane ^ 1, the next or previous vector of the same bin, `odd` for the
// second of the two): the first store writes the even thread's 32 bytes,
// the second the odd thread's, each as two 16-byte halves from the two
// lanes.  Each lane sends the half that the other writes.
template <bool kWithArgmax>
__device__ __forceinline__ void store_pair(float* out, int* argmax, size_t o,
                                           bool odd, const float* best,
                                           const int* idx) {
  const unsigned pair = 3u << ((threadIdx.x & 31) & ~1u);
  // even lane: its own first half, then the odd lane's first half (8
  // floats on); odd lane: the even lane's second half, then its own.
  // Element-wise selects only, so that every array stays in registers.
  float first[4], second[4];
  int first_idx[4], second_idx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float got = __shfl_xor_sync(pair, odd ? best[k] : best[4 + k], 1);
    first[k] = odd ? got : best[k];
    second[k] = odd ? best[4 + k] : got;
    if constexpr (kWithArgmax) {
      const int got_idx = __shfl_xor_sync(pair, odd ? idx[k] : idx[4 + k], 1);
      first_idx[k] = odd ? got_idx : idx[k];
      second_idx[k] = odd ? idx[4 + k] : got_idx;
    }
  }
  const size_t o1 = odd ? o - 4 : o;       // the even thread's sector
  const size_t o2 = odd ? o + 4 : o + 8;   // the odd thread's sector
  store_bin<4, kWithArgmax>(out, argmax, o1, first, first_idx);
  store_bin<4, kWithArgmax>(out, argmax, o2, second, second_idx);
}

// Dynamic shared memory of the slice kernel: the slice (h * w pixels of
// `nv` vectors, rounded up to 16 bytes), then each roi's bin edges
// ([rois_per_chunk][2][pooled] of start | end << 16, rows then columns),
// then each bin's (ph << 16 | pw); all unsigned.
__host__ __device__ inline size_t slice_bytes(int h, int w, int nv,
                                              int vec_bytes) {
  return ((size_t)h * w * nv * vec_bytes + 15) / 16 * 16;
}
__host__ __device__ inline size_t slice_smem(int h, int w, int nv,
                                             int vec_bytes, int rois_per_chunk,
                                             int pooled) {
  return slice_bytes(h, w, nv, vec_bytes) +
         ((size_t)rois_per_chunk * 2 * pooled + (size_t)pooled * pooled) * 4;
}

// grid (slices, B, roi chunks), kSliceThreads threads.  The last slice may
// have fewer vectors than `nv`: its pixels are `my_nv` vectors apart.
// Thread t takes vector t % my_nv of every (roi, bin) t / my_nv, t / my_nv
// + lanes, ...: neighbouring threads read neighbouring vectors of a pixel.
// A 16-byte bf16 vector's 8 channels come out as one 32-byte sector of f32
// (and one of indices), which a thread stores as two 16-byte halves.  With
// the index store, so that each store instruction writes whole sectors,
// threads 2i and 2i + 1 of a bin (my_nv even) swap halves: the first store
// writes thread 2i's sector, the second thread 2i + 1's (store_pair).
// Without the index store the swap cost more than it saved on the H100,
// and each thread stores its own halves.
template <typename T, int kVecBytes, bool kWithArgmax>
__global__ void __launch_bounds__(kSliceThreads, 1)
roi_pool_slice_kernel(const T* __restrict__ feats,
                      const float4* __restrict__ rois, int h, int w, int c,
                      int r, int pooled, float scale, int nv,
                      int rois_per_chunk, float* __restrict__ out,
                      int* __restrict__ argmax) {
  using W = Word<T>;
  constexpr int kWords = kVecBytes / 4;
  constexpr int kCh = kWords * W::kCh;       // channels a vector
  extern __shared__ __align__(16) unsigned char slice[];
  __shared__ __align__(8) unsigned long long bar;
  const int img = blockIdx.y, tid = threadIdx.x;
  const int cv = c / kCh;                    // vectors a pixel of the map
  const int v0 = blockIdx.x * nv;
  const int my_nv = min(nv, cv - v0);
  const int hw = h * w;
  const unsigned pixel_bytes = (unsigned)(my_nv * kVecBytes);
  const T* f = feats + (size_t)img * hw * c + (size_t)v0 * kCh;
  const int r0 = blockIdx.z * rois_per_chunk;
  const int n_rois = min(r, r0 + rois_per_chunk) - r0;
  const int bins = pooled * pooled;
  unsigned* edges =
      reinterpret_cast<unsigned*>(slice + slice_bytes(h, w, nv, kVecBytes));
  unsigned* bin_at = edges + (size_t)rois_per_chunk * 2 * pooled;

  if constexpr (kVecBytes == 16) {
    // one bulk copy a pixel (16-byte aligned: C * sizeof(T) is a multiple
    // of 16), all completing on one mbarrier
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
          "[%0], [%1], %2, [%3];" ::"r"(smem_addr(slice + (size_t)p * pixel_bytes)),
          "l"(f + (size_t)p * c), "r"(pixel_bytes), "r"(b)
          : "memory");
    }
  } else {
    for (int q = tid; q < hw * my_nv; q += kSliceThreads) {
      const int p = q / my_nv, v = q - p * my_nv;
      reinterpret_cast<uint2*>(slice)[q] =
          *reinterpret_cast<const uint2*>(f + (size_t)p * c + v * kCh);
    }
  }
  // while the slice arrives: the bin edges of the chunk's rois, and the
  // (ph, pw) of each bin
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
  for (int t = tid; t < bins; t += kSliceThreads) {
    bin_at[t] = (unsigned)(t / pooled) << 16 | (unsigned)(t % pooled);
  }
  if constexpr (kVecBytes == 16) mbar_wait(smem_addr(&bar), 0);
  __syncthreads();

  const int v = tid % my_nv, lanes = kSliceThreads / my_nv;
  int roi = tid / my_nv;
  if (roi >= lanes) return;                  // the threads left over
  int bin = roi % bins;
  roi /= bins;
  const int roi_step = lanes / bins, bin_step = lanes % bins;
  const unsigned char* base = slice + (size_t)v * kVecBytes;
  const bool paired = my_nv % 2 == 0;   // uniform in the block
  for (; roi < n_rois; roi += roi_step) {
    const unsigned pb = bin_at[bin];
    const unsigned ey = edges[roi * 2 * pooled + (pb >> 16)];
    const unsigned ex = edges[roi * 2 * pooled + pooled + (pb & 0xffffu)];
    const int hs = ey & 0xffffu, he = ey >> 16, ws = ex & 0xffffu, we = ex >> 16;
    float best[kCh];
    int idx[kCh];
    if (hs < he && ws < we) {
      // start from the bin's first pixel, then move on strictly greater
      unsigned bw[kWords], bi[kWords];
      load_words<kWords>(base + (size_t)(hs * w + ws) * pixel_bytes, bw);
#pragma unroll
      for (int k = 0; k < kWords; ++k) bi[k] = W::index(hs * w + ws);
      for (int y = hs; y < he; ++y) {
        const unsigned char* row = base + (size_t)(y * w) * pixel_bytes;
        for (int x = ws; x < we; ++x) {
          unsigned vw[kWords];
          load_words<kWords>(row + (size_t)x * pixel_bytes, vw);
          const unsigned cur = W::index(y * w + x);
#pragma unroll
          for (int k = 0; k < kWords; ++k) {
            const unsigned m = W::greater(vw[k], bw[k]);
            bw[k] = (vw[k] & m) | (bw[k] & ~m);
            bi[k] = (cur & m) | (bi[k] & ~m);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        W::unpack(bw[k], bi[k], best + k * W::kCh, idx + k * W::kCh);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCh; ++k) {   // an empty bin: 0 and -1
        best[k] = 0.f;
        idx[k] = -1;
      }
    }
    const size_t o = (((size_t)img * r + r0 + roi) * bins + bin) * c +
                     (size_t)(v0 + v) * kCh;
    if constexpr (kCh == 8 && kWithArgmax) {
      if (paired) {
        store_pair<kWithArgmax>(out, argmax, o, (v & 1) != 0, best, idx);
      } else {
        store_bin<kCh, kWithArgmax>(out, argmax, o, best, idx);
      }
    } else {
      store_bin<kCh, kWithArgmax>(out, argmax, o, best, idx);
    }
    bin += bin_step;
    if (bin >= bins) {
      bin -= bins;
      ++roi;
    }
  }
}

// 4 neighbouring channels as f32 straight from global memory: a bf16 is the
// high half of its f32
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xffff0000u);
}

template <typename T, bool kWithArgmax>
__global__ void __launch_bounds__(kDirectThreads)
roi_pool_direct_kernel(const T* __restrict__ feats,
                       const float4* __restrict__ rois, int h, int w, int c,
                       int r, int pooled, float scale, float* __restrict__ out,
                       int* __restrict__ argmax) {
  const int roi = blockIdx.x, img = blockIdx.y;
  const int4 q = roi_corners(rois[(size_t)img * r + roi], scale);
  const T* f = feats + (size_t)img * h * w * c;
  const size_t base = ((size_t)img * r + roi) * pooled * pooled * c;

  for (int ph = 0; ph < pooled; ++ph) {
    int hs, he;
    bin_range(q.y, q.w, ph, pooled, h, &hs, &he);
    for (int pw = 0; pw < pooled; ++pw) {
      int ws, we;
      bin_range(q.x, q.z, pw, pooled, w, &ws, &we);
      const size_t o = base + (size_t)(ph * pooled + pw) * c;
      for (int ch = threadIdx.x * 4; ch < c; ch += kDirectThreads * 4) {
        float best[4] = {0.f, 0.f, 0.f, 0.f};   // an empty bin: 0 and -1
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
        store_bin<4, kWithArgmax>(out, argmax, o + ch, best, idx);
      }
    }
  }
}

template <typename T, int kVecBytes, bool kWithArgmax>
cudaError_t launch_slice(const void* feats, const float4* rois, float* out,
                         int* argmax, int batch, int h, int w, int c, int r,
                         int pooled, float scale, int nv, int n_slices,
                         int n_chunks, cudaStream_t s) {
  auto kernel = roi_pool_slice_kernel<T, kVecBytes, kWithArgmax>;
  const int per_chunk = (r + n_chunks - 1) / n_chunks;
  const int smem = (int)slice_smem(h, w, nv, kVecBytes, per_chunk, pooled);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_slices, batch, n_chunks), kSliceThreads, smem, s>>>(
      static_cast<const T*>(feats), rois, h, w, c, r, pooled, scale, nv,
      per_chunk, out, argmax);
  return cudaGetLastError();
}

template <typename T, bool kWithArgmax>
cudaError_t launch_direct(const void* feats, const float4* rois, float* out,
                          int* argmax, int batch, int h, int w, int c, int r,
                          int pooled, float scale, cudaStream_t s) {
  roi_pool_direct_kernel<T, kWithArgmax><<<dim3(r, batch), kDirectThreads, 0,
                                           s>>>(
      static_cast<const T*>(feats), rois, h, w, c, r, pooled, scale, out,
      argmax);
  return cudaGetLastError();
}

template <typename T, int kVecBytes>
cudaError_t launch_slice_any(const void* feats, const float4* rois, float* out,
                             int* argmax, int batch, int h, int w, int c,
                             int r, int pooled, float scale, int nv,
                             int n_slices, int n_chunks, cudaStream_t s) {
  if (argmax != nullptr)
    return launch_slice<T, kVecBytes, true>(feats, rois, out, argmax, batch,
                                            h, w, c, r, pooled, scale, nv,
                                            n_slices, n_chunks, s);
  return launch_slice<T, kVecBytes, false>(feats, rois, out, argmax, batch, h,
                                           w, c, r, pooled, scale, nv,
                                           n_slices, n_chunks, s);
}

}  // namespace

// dtype: 0 f32, 1 bf16.  vec_bytes: 16 or 8 (bf16 with C % 8 != 0) for the
// slice route, with `nv` vectors a slice, `n_slices` slices and `n_chunks`
// roi chunks (ops/roi_pool_max.py:roi_pool_plan); 0 for the direct route.
// A null `argmax` skips the index store.  Returns a cudaError_t code.
extern "C" int roi_pool_launch(const void* feats, const void* rois, void* out,
                               void* argmax, int batch, int h, int w, int c,
                               int r, int pooled, float scale, int dtype,
                               int vec_bytes, int nv, int n_slices,
                               int n_chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b = static_cast<const float4*>(rois);
  float* o = static_cast<float*>(out);
  int* a = static_cast<int*>(argmax);
  if (batch < 1 || r < 1 || c % 4 != 0) return (int)cudaErrorInvalidValue;
  if (vec_bytes == 0) {
    // the wrapper hands 16-byte-aligned tensors with C % 4 == 0, so every
    // pixel and every output row starts 16-byte (f32) or 8-byte (bf16)
    // aligned
    if (dtype == 0)
      return (int)(a ? launch_direct<float, true>(feats, b, o, a, batch, h, w,
                                                  c, r, pooled, scale, s)
                     : launch_direct<float, false>(feats, b, o, a, batch, h,
                                                   w, c, r, pooled, scale, s));
    return (int)(a ? launch_direct<__nv_bfloat16, true>(
                         feats, b, o, a, batch, h, w, c, r, pooled, scale, s)
                   : launch_direct<__nv_bfloat16, false>(
                         feats, b, o, a, batch, h, w, c, r, pooled, scale, s));
  }
  if (nv < 1 || nv > kSliceThreads || n_slices < 1 || n_chunks < 1 ||
      h * w >= 65536 || pooled < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0 && vec_bytes == 16)
    return (int)launch_slice_any<float, 16>(feats, b, o, a, batch, h, w, c, r,
                                            pooled, scale, nv, n_slices,
                                            n_chunks, s);
  if (dtype == 1 && vec_bytes == 16 && c % 8 == 0)
    return (int)launch_slice_any<__nv_bfloat16, 16>(
        feats, b, o, a, batch, h, w, c, r, pooled, scale, nv, n_slices,
        n_chunks, s);
  if (dtype == 1 && vec_bytes == 8)
    return (int)launch_slice_any<__nv_bfloat16, 8>(
        feats, b, o, a, batch, h, w, c, r, pooled, scale, nv, n_slices,
        n_chunks, s);
  return (int)cudaErrorInvalidValue;
}
