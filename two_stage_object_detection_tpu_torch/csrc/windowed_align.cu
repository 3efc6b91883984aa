// Windowed multi-level RoIAlign for the FPN box head.
//
// Replaces the TPU kernel `_kernel` of the JAX package
// (ops/pallas_windowed_align.py, wrapper `windowed_roi_align_batched`):
// per roi, RoIAlign on the roi's assigned pyramid level, P x P bins of
// S x S bilinear samples, read through a win x win window whose origin and
// window-local sample rules are those of the JAX prologue
// (ops/roi_pool.py:_windowed_prologue with x_quant=1):
//   oy = clip(floor(cy0), 0, max(H_l, win) - win)
//   ox = clip(floor(cx0), 0, max(max_l W_l, win) - win)
//   local coordinates clip to [0, win-1], i1 = min(i0 + 1, win - 1).
// A tap beyond the level's own map reads 0, as the atlas' zero padding
// does.  So the kernel reproduces the windowed semantics, including rois the
// window does not cover; it is not a dense RoIAlign.
//
// Design: one block per roi.  The block first computes its roi's 2*P*S y
// taps and 2*P*S x taps (row/column and weight) into shared memory.  Its
// threads then share the roi's P*P bins x C/V channel vectors, one (bin,
// vector) at a time, neighbouring threads on neighbouring vectors of one
// NHWC pixel: each tap is one V-wide vector load (16 bytes: 8 bf16 or 4
// f32 channels, where C allows), the 4*S*S taps of a bin accumulate in f32
// registers, and the bin is rounded once to the feature dtype and written
// as one vector.  The kernel is compiled for P=7, S=2 (the box head) and
// P=14, S=2 (Mask R-CNN's mask head: 28 taps an axis, 196 bins of each
// kept detection), where the tap loops unroll, and once for any other
// (P, S) with the same code and runtime loop bounds.  V is the widest of 16, 8, 4 and 2
// bytes (one element at least) that divides a pixel's C channels
// (ops/windowed_align.py:align_vector_width), so a channel count that is
// not a multiple of 8 (bf16) or 4 (f32) takes narrower vectors and leaves
// no tail.  Each block reads its level's own [H_l, W_l, C] map directly:
// there is no atlas, no combined w_comb operator and no 8-aligned x origin
// (those were TPU DMA workarounds).
//
// What bounds it on the H100: bytes.  At predict (B=16, R=300, C=256,
// bf16) it must write 4800*49*256*2 B = 120 MB and read the pyramid pixels
// the rois touch (176 MB on chip_smoke.py's rois) from HBM; and each block
// must bring its roi's pixels into its SM (521 MB in all, each pixel once
// per roi that reads it), so L2's rate bounds it before HBM's.  The 16 taps
// of a bin hit L1 mostly, since neighbouring samples share pixels.  The
// mask head's call (B=16, R=100, P=14) writes 4 times the bins a roi: 161 MB
// for 1,600 rois, against the box head's 120 MB for 4,800.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxTaps = 64;     // P*S per axis
constexpr int kThreads = 256;

struct Levels {
  const void* feat[kMaxLevels];  // [B, H_l, W_l, C]
  int h[kMaxLevels];
  int w[kMaxLevels];
  float sy[kMaxLevels];
  float sx[kMaxLevels];
};

// V adjacent channels in one load / store of V * sizeof(T) bytes
template <typename T, int V>
struct Vec;

template <int V>
struct Vec<float, V> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[V]) {
    if constexpr (V == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    } else if constexpr (V == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p));
      f[0] = v.x; f[1] = v.y;
    } else {
      f[0] = __ldg(p);
    }
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[V]) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    } else {
      *p = f[0];
    }
  }
};

// bf16 -> f32 is exact: the 16 bits are the top half of the f32
__device__ __forceinline__ void bf16x2_to_f(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t f_to_bf16x2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16(b)) << 16;
}

template <int V>
struct Vec<__nv_bfloat16, V> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[V]) {
    if constexpr (V == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      bf16x2_to_f(v.x, f); bf16x2_to_f(v.y, f + 2);
      bf16x2_to_f(v.z, f + 4); bf16x2_to_f(v.w, f + 6);
    } else if constexpr (V == 4) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      bf16x2_to_f(v.x, f); bf16x2_to_f(v.y, f + 2);
    } else if constexpr (V == 2) {
      bf16x2_to_f(__ldg(reinterpret_cast<const unsigned int*>(p)), f);
    } else {
      f[0] = __uint_as_float(
          (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[V]) {
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) =
          make_uint4(f_to_bf16x2(f[0], f[1]), f_to_bf16x2(f[2], f[3]),
                     f_to_bf16x2(f[4], f[5]), f_to_bf16x2(f[6], f[7]));
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(f_to_bf16x2(f[0], f[1]), f_to_bf16x2(f[2], f[3]));
    } else if constexpr (V == 2) {
      *reinterpret_cast<unsigned int*>(p) = f_to_bf16x2(f[0], f[1]);
    } else {
      *p = __float2bfloat16(f[0]);
    }
  }
};

// Sample k of a roi along one axis: the clipped level coordinate
// lo + g_k * bin with g_k = k/S + (k%S + 0.5)/S, as the plain version
// computes it (no FMA contraction).
__device__ __forceinline__ float sample_coord(int k, int s, float lo,
                                              float bin, float hi) {
  const float g = __fadd_rn((float)(k / s),
                            __fdiv_rn(__fadd_rn((float)(k % s), 0.5f), (float)s));
  const float c = __fadd_rn(lo, __fmul_rn(g, bin));
  return fminf(fmaxf(c, 0.0f), hi);
}

// kP, kS: compile-time P and S, or 0 for the runtime p_rt, s_rt
template <typename T, int V, int kP, int kS>
__global__ void __launch_bounds__(kThreads)
windowed_align_kernel(Levels lv, const float* __restrict__ rois,
                      const int* __restrict__ levels, T* __restrict__ out,
                      int r, int c_feat, int p_rt, int s_rt, int win,
                      int w_pad, float offset) {
  const int p = kP ? kP : p_rt;
  const int s = kS ? kS : s_rt;
  __shared__ int tap_y[2 * kMaxTaps], tap_x[2 * kMaxTaps];
  __shared__ float wt_y[2 * kMaxTaps], wt_x[2 * kMaxTaps];
  const int roi = blockIdx.x;
  const int img = roi / r;
  const int l = levels[roi];
  const int h = lv.h[l], w = lv.w[l];
  const float* box = rois + (size_t)roi * 4;
  const float x1 = __fsub_rn(__fmul_rn(box[0], lv.sx[l]), offset);
  const float y1 = __fsub_rn(__fmul_rn(box[1], lv.sy[l]), offset);
  const float x2 = __fsub_rn(__fmul_rn(box[2], lv.sx[l]), offset);
  const float y2 = __fsub_rn(__fmul_rn(box[3], lv.sy[l]), offset);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f), (float)p);
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f), (float)p);
  const float hi_y = (float)(h - 1), hi_x = (float)(w - 1);
  const int ps = p * s;

  // window origins from the first sample
  const int oy = min(max((int)floorf(sample_coord(0, s, y1, bin_h, hi_y)), 0),
                     max(h, win) - win);
  const int ox = min(max((int)floorf(sample_coord(0, s, x1, bin_w, hi_x)), 0),
                     w_pad - win);

  for (int t = threadIdx.x; t < 2 * ps; t += blockDim.x) {
    const bool is_x = t >= ps;
    const int k = is_x ? t - ps : t;
    const int o = is_x ? ox : oy;
    const int lim = is_x ? w : h;
    const float c = is_x ? sample_coord(k, s, x1, bin_w, hi_x)
                         : sample_coord(k, s, y1, bin_h, hi_y);
    const float cl = fminf(fmaxf(__fsub_rn(c, (float)o), 0.0f), (float)(win - 1));
    const int i0 = (int)floorf(cl);
    const int i1 = min(i0 + 1, win - 1);
    const float f = __fsub_rn(cl, (float)i0);
    int* tap = is_x ? tap_x : tap_y;
    float* wt = is_x ? wt_x : wt_y;
    tap[2 * k] = o + i0 < lim ? o + i0 : -1;       // -1: beyond the map, reads 0
    tap[2 * k + 1] = o + i1 < lim ? o + i1 : -1;
    wt[2 * k] = __fsub_rn(1.0f, f);
    wt[2 * k + 1] = f;
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(lv.feat[l]) + (size_t)img * h * w * c_feat;
  T* dst = out + (size_t)roi * p * p * c_feat;
  const float inv = 1.0f / (float)(s * s);
  const int n_vec = c_feat / V;
  for (int it = threadIdx.x; it < p * p * n_vec; it += blockDim.x) {
    const int bin = it / n_vec;
    const int ch = (it - bin * n_vec) * V;
    const int ty0 = 2 * (bin / p) * s, tx0 = 2 * (bin % p) * s;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int a = 0; a < 2 * s; ++a) {
      const int y = tap_y[ty0 + a];
      const float wy = wt_y[ty0 + a];
      const T* row = feat + (size_t)max(y, 0) * w * c_feat + ch;
#pragma unroll
      for (int b = 0; b < 2 * s; ++b) {
        const int x = tap_x[tx0 + b];
        if (y < 0 || x < 0) continue;
        const float wgt = wy * wt_x[tx0 + b];
        float v[V];
        Vec<T, V>::load(row + (size_t)x * c_feat, v);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += wgt * v[e];
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] *= inv;
    Vec<T, V>::store(dst + (size_t)bin * c_feat + ch, acc);
  }
}

template <typename T, int V>
cudaError_t launch(int n_roi, int threads, cudaStream_t st, const Levels& lv,
                   const float* rois, const int* levels, void* out, int r,
                   int c_feat, int p, int s, int win, int w_pad, float offset) {
  T* o = static_cast<T*>(out);
  if (p == 7 && s == 2) {
    windowed_align_kernel<T, V, 7, 2><<<n_roi, threads, 0, st>>>(
        lv, rois, levels, o, r, c_feat, p, s, win, w_pad, offset);
  } else if (p == 14 && s == 2) {
    windowed_align_kernel<T, V, 14, 2><<<n_roi, threads, 0, st>>>(
        lv, rois, levels, o, r, c_feat, p, s, win, w_pad, offset);
  } else {
    windowed_align_kernel<T, V, 0, 0><<<n_roi, threads, 0, st>>>(
        lv, rois, levels, o, r, c_feat, p, s, win, w_pad, offset);
  }
  return cudaGetLastError();
}

}  // namespace

// feats: n_levels device pointers; hw: n_levels (H, W) pairs; scales:
// n_levels (sy, sx) pairs (host arrays).  dtype 0 = f32, 1 = bf16.  vec:
// channels a thread loads at once (ops/windowed_align.py:
// align_vector_width): it must divide c_feat, and vec * the element size
// must be 16, 8, 4 or 2 bytes (or one element); every pointer must be
// aligned to vec elements.
extern "C" int windowed_align_launch(const void* const* feats, const int* hw,
                                     const float* scales, int n_levels,
                                     const void* rois, const void* levels,
                                     void* out, int batch, int r, int c_feat,
                                     int p, int s, int win, int aligned,
                                     int dtype, int vec, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || p < 1 || s < 1 ||
      p * s > kMaxTaps || vec < 1 || c_feat % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv = {};
  int w_pad = win;
  for (int i = 0; i < n_levels; ++i) {
    lv.feat[i] = feats[i];
    lv.h[i] = hw[2 * i];
    lv.w[i] = hw[2 * i + 1];
    lv.sy[i] = scales[2 * i];
    lv.sx[i] = scales[2 * i + 1];
    w_pad = std::max(w_pad, lv.w[i]);
  }
  const int n_roi = batch * r;
  if (n_roi == 0) return 0;
  const int items = p * p * (c_feat / vec);
  const int threads = std::min(kThreads, ((items + 31) / 32) * 32);
  const float offset = aligned ? 0.5f : 0.0f;
  const float* rp = static_cast<const float*>(rois);
  const int* lp = static_cast<const int*>(levels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 4: err = launch<float, 4>(n_roi, threads, st, lv, rp, lp, out, r, c_feat, p, s, win, w_pad, offset); break;
      case 2: err = launch<float, 2>(n_roi, threads, st, lv, rp, lp, out, r, c_feat, p, s, win, w_pad, offset); break;
      case 1: err = launch<float, 1>(n_roi, threads, st, lv, rp, lp, out, r, c_feat, p, s, win, w_pad, offset); break;
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 8: err = launch<__nv_bfloat16, 8>(n_roi, threads, st, lv, rp, lp, out, r, c_feat, p, s, win, w_pad, offset); break;
      case 4: err = launch<__nv_bfloat16, 4>(n_roi, threads, st, lv, rp, lp, out, r, c_feat, p, s, win, w_pad, offset); break;
      case 2: err = launch<__nv_bfloat16, 2>(n_roi, threads, st, lv, rp, lp, out, r, c_feat, p, s, win, w_pad, offset); break;
      case 1: err = launch<__nv_bfloat16, 1>(n_roi, threads, st, lv, rp, lp, out, r, c_feat, p, s, win, w_pad, offset); break;
    }
  }
  return (int)err;
}
