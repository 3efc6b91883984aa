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
// Design: one block per roi, threads over channels, so neighbouring threads
// read neighbouring channels of one NHWC pixel (coalesced).  The block
// first computes its roi's 2*P*S y taps and 2*P*S x taps (row/column and
// weight) into shared memory; each thread then accumulates
// (1/S^2) * sum over samples of the 4 weighted taps in f32 and writes one
// output per bin in the feature dtype.  Each block reads its level's own
// [H_l, W_l, C] map directly: there is no atlas, no combined w_comb
// operator and no 8-aligned x origin (those were TPU DMA workarounds).
//
// What bounds it on the H100: bytes.  At predict (B=16, R=300, C=256,
// bf16) it must write 4800*49*256*2 B = 60 MB and read the pyramid pixels
// the rois touch (at most the 245 MB of P2..P5); 784 taps per channel per
// roi are served mostly by L1/L2, since neighbouring samples share pixels.
// Simple and exact first: no shared-memory staging, no vector loads.

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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

template <typename T>
__global__ void windowed_align_kernel(Levels lv, const float* __restrict__ rois,
                                      const int* __restrict__ levels,
                                      T* __restrict__ out, int r, int c_feat,
                                      int p, int s, int win, int w_pad,
                                      float offset) {
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
  for (int ch = threadIdx.x; ch < c_feat; ch += blockDim.x) {
    for (int py = 0; py < p; ++py) {
      for (int px = 0; px < p; ++px) {
        float acc = 0.0f;
        for (int ty = 2 * py * s; ty < 2 * (py + 1) * s; ++ty) {
          const int y = tap_y[ty];
          if (y < 0) continue;
          const float wy = wt_y[ty];
          const T* row = feat + (size_t)y * w * c_feat + ch;
          for (int tx = 2 * px * s; tx < 2 * (px + 1) * s; ++tx) {
            const int x = tap_x[tx];
            if (x < 0) continue;
            acc += wy * wt_x[tx] * load_f(row + (size_t)x * c_feat);
          }
        }
        store_f(dst + (size_t)(py * p + px) * c_feat + ch, acc * inv);
      }
    }
  }
}

}  // namespace

// feats: n_levels device pointers; hw: n_levels (H, W) pairs; scales:
// n_levels (sy, sx) pairs (host arrays).  dtype 0 = f32, 1 = bf16.
extern "C" int windowed_align_launch(const void* const* feats, const int* hw,
                                     const float* scales, int n_levels,
                                     const void* rois, const void* levels,
                                     void* out, int batch, int r, int c_feat,
                                     int p, int s, int win, int aligned,
                                     int dtype, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || p * s > kMaxTaps) {
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
  const int threads = std::min(kThreads, ((c_feat + 31) / 32) * 32);
  const float offset = aligned ? 0.5f : 0.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    windowed_align_kernel<float><<<n_roi, threads, 0, st>>>(
        lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
        static_cast<float*>(out), r, c_feat, p, s, win, w_pad, offset);
  } else {
    windowed_align_kernel<__nv_bfloat16><<<n_roi, threads, 0, st>>>(
        lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
        static_cast<__nv_bfloat16*>(out), r, c_feat, p, s, win, w_pad, offset);
  }
  return (int)cudaGetLastError();
}
