// Depth-wise 3x3 conv of HarDNet's folded predict route, stored into every
// buffer that reads its output.
//
// Replaces no TPU kernel.  The JAX package leaves the dense blocks'
// concatenations to XLA, which fuses them into the convs that consume
// them.  The port's eager predict ran cuDNN's depth-wise conv into a tensor
// of its own and then torch.cat copied that tensor into each concatenation
// it enters: a layer's input of several links, the block's output
// (models/hardnet.py:HarDBlock).  This kernel is the conv and the
// concatenations in one pass: each output pixel's C channels are stored
// to up to kMaxDests destinations, each a channels-last buffer given as
// (pointer, channel offset, the buffer's channels as pixel pitch).  What
// it computes, in float32 and rounded once to T:
//   y[n, oy, ox, c] = sum over taps (ky, kx) in row-major order of
//                     x[n, oy*s + ky - 1, ox*s + kx - 1, c] * w[c, ky, kx]
//                     (+ bias[c]),
// zero outside the map (padding 1), each product rounded and added in
// that order (no fused multiply-add), so that it equals its plain version
// bit for bit (ops/depthwise_store.py:depthwise_conv_reference).
//
// What bounds it on the H100: bytes.  It reads x once and writes y once a
// destination: a HarDNet-39 bucket (B=16, 600x600, 36 launches) reads 2.75
// GB and writes 6.17 GB, 8.92 GB in all (2.66 ms at 3.35 TB/s), where
// cuDNN's conv and the 20 torch.cat copies moved 2.75 + 2.65 + 2 x 9.35 GB.
// A write that fills part of a 32-byte sector costs more than its bytes
// (the rest of the sector is read back): where a destination's slices do
// not start and end on sectors, and HarDNet's mostly do not, the stores
// take longer than their bytes say.
//
// Design.  A block takes th x 16 output pixels of one image (th x 8 at
// stride 2) and a chunk of channels: all of C where a pixel's C fit in 256
// bytes, else the fewest chunks of at most 128 bytes.  It stages the input
// pixels the tile reads, halo included, in shared memory with 16-byte
// cp.async whatever C's alignment: each pixel's segment of the chunk in a
// slot of the aligned 16-byte words that hold it, at its address's offset
// in the first word (zeros outside the map), so that HarDNet's widths in
// 4-byte pairs (26, 82, 102, 262, 410) load as fast as the aligned ones;
// and the chunk's weights (and bias) as float32.  A thread then computes
// a run of 4 adjacent output pixels of one row (2 at stride 2) for VC
// channels, reading each input vector of the run's window once a row and
// each tap's weights once for the run, and stores each pixel's VC
// channels to every destination.  VC is the store width that
// ops/depthwise_store.py picks (the widest that divides C and every
// destination's offset and pitch), at most 8 bytes: 4-byte pairs at
// HarDNet's widths above and at offsets such as 42.  Neighbouring threads
// take neighbouring vectors of a pixel, so each destination's slice of a
// pixel is written by neighbouring threads; where a destination is a
// slice of a wider buffer, a pixel takes a power of 2 of threads, so that
// no warp splits a slice (a split leaves sectors written in part).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDests = 8;
constexpr int kSmemBytes = 48 * 1024;

struct Dests {
  void* ptr[kMaxDests];
  long long off[kMaxDests];    // channel offset in the buffer
  long long pitch[kMaxDests];  // the buffer's channels: one pixel's stride
  int n;
};

// V adjacent elements: loaded as float, packed once, stored packed, in one
// access of V * sizeof(T) bytes
template <typename T, int V>
struct Vec;

template <int V>
struct Vec<float, V> {
  using Packed = typename std::conditional<
      V == 4, float4, typename std::conditional<V == 2, float2, float>::type
      >::type;
  static __device__ __forceinline__ void load(const float* p, float (&f)[V]) {
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    } else if constexpr (V == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      f[0] = v.x; f[1] = v.y;
    } else {
      f[0] = *p;
    }
  }
  static __device__ __forceinline__ Packed pack(const float (&f)[V]) {
    if constexpr (V == 4) {
      return make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (V == 2) {
      return make_float2(f[0], f[1]);
    } else {
      return f[0];
    }
  }
};

// bf16 -> f32 is exact: the 16 bits are the top half of the f32
__device__ __forceinline__ void bf16x2_to_f(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ uint32_t f_to_bf16x2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16(b)) << 16;
}

template <int V>
struct Vec<__nv_bfloat16, V> {
  using Packed = typename std::conditional<
      V == 8, uint4, typename std::conditional<
          V == 4, uint2, typename std::conditional<
              V == 2, unsigned int, unsigned short>::type>::type>::type;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[V]) {
    if constexpr (V == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      bf16x2_to_f(v.x, f); bf16x2_to_f(v.y, f + 2);
      bf16x2_to_f(v.z, f + 4); bf16x2_to_f(v.w, f + 6);
    } else if constexpr (V == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      bf16x2_to_f(v.x, f); bf16x2_to_f(v.y, f + 2);
    } else if constexpr (V == 2) {
      bf16x2_to_f(*reinterpret_cast<const unsigned int*>(p), f);
    } else {
      f[0] = __uint_as_float(
          (uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
    }
  }
  static __device__ __forceinline__ Packed pack(const float (&f)[V]) {
    if constexpr (V == 8) {
      return make_uint4(f_to_bf16x2(f[0], f[1]), f_to_bf16x2(f[2], f[3]),
                        f_to_bf16x2(f[4], f[5]), f_to_bf16x2(f[6], f[7]));
    } else if constexpr (V == 4) {
      return make_uint2(f_to_bf16x2(f[0], f[1]), f_to_bf16x2(f[2], f[3]));
    } else if constexpr (V == 2) {
      return f_to_bf16x2(f[0], f[1]);
    } else {
      return __bfloat16_as_ushort(__float2bfloat16(f[0]));
    }
  }
};

// 16 bytes from device to shared memory, of which the first `bytes` are
// copied and the rest zero-filled (0: all zeros; src is then not read)
__device__ __forceinline__ void stage16(void* dst, const void* src,
                                        int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// output columns a tile and a thread's run of them, by stride
template <int S> constexpr int kTileW = S == 1 ? 16 : 8;
template <int S> constexpr int kRun = S == 1 ? 4 : 2;

// A block: th x kTileW output pixels of image n, channels [k0, k0 + cn).
// Each input pixel's segment of the chunk, [k0, k0 + cn), is staged in a
// slot of nw 16-byte words: the aligned words that hold it, loaded whole
// (16-byte cp.async whatever C's alignment), so that the segment starts
// `shift` bytes into its slot, shift = its byte address mod 16; pixels
// outside the map are zeros.  A thread then computes kRun adjacent output
// pixels of one row for VC channels, reading each input vector of its
// window once a row ((kRun - 1) * S + 3 of them) and the weights of a tap
// once for all kRun pixels, and stores each pixel's VC channels to every
// destination.
template <typename T, int VC, int S>
__global__ void __launch_bounds__(kThreads)
depthwise_store_kernel(const T* __restrict__ x, const T* __restrict__ wgt,
                       const float* __restrict__ bias, Dests d, int h,
                       int w, int c, int ho, int wo, int th, int ct,
                       int chunks, int nw) {
  constexpr int TW = kTileW<S>, PX = kRun<S>, NIN = (PX - 1) * S + 3;
  constexpr int RUNS = TW / PX, SZ = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int ih = (th - 1) * S + 3, iw = (TW - 1) * S + 3, slot = nw * 16;
  float* s_w = reinterpret_cast<float*>(smem + (size_t)ih * iw * slot);
  float* s_b = s_w + 9 * ct;  // [9][ct] weights, tap-major, then [ct] bias

  const int chunk = blockIdx.x % chunks;
  const int tx = blockIdx.x / chunks, ty = blockIdx.y, n = blockIdx.z;
  const int k0 = chunk * ct, cn = min(ct, c - k0);
  const int y0 = ty * th * S - 1, x0 = tx * TW * S - 1;
  const char* xb = reinterpret_cast<const char*>(x);

  // the input tile, halo included: a thread keeps one word u of every
  // pixel it loads, lanes pixels a pass
  {
    const int lanes = kThreads / nw;
    const int lane = threadIdx.x / nw, u = threadIdx.x - lane * nw;
    if (lane < lanes) {
      int r = lane / iw, col = lane % iw;
      for (int q = lane; q < ih * iw; q += lanes) {
        const int iy = y0 + r, ix = x0 + col;
        unsigned char* dst = smem + (size_t)q * slot + 16 * u;
        if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
          const size_t b0 = ((((size_t)n * h + iy) * w + ix) * c + k0) * SZ;
          const size_t a = (b0 & ~(size_t)15) + 16 * u;
          const long long left = (long long)(b0 + (size_t)cn * SZ) -
                                 (long long)a;
          stage16(dst, left > 0 ? xb + a : xb,
                  left > 16 ? 16 : (left > 0 ? (int)left : 0));
        } else {
          stage16(dst, xb, 0);
        }
        for (col += lanes; col >= iw; col -= iw) ++r;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = threadIdx.x; i < cn * 9; i += kThreads) {
    const int k = i / 9, tap = i - k * 9;
    float f[1];
    Vec<T, 1>::load(wgt + (size_t)(k0 + k) * 9 + tap, f);
    s_w[tap * ct + k] = f[0];
  }
  if (bias != nullptr) {
    for (int k = threadIdx.x; k < cn; k += kThreads) s_b[k] = bias[k0 + k];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // a pixel's shift is its byte address mod 16: the low bits of
  // (pixel * c + k0) * SZ, in 32-bit arithmetic
  const unsigned step = (unsigned)c * SZ;
  // threads a pixel: one a vector; where a destination is a slice of a
  // wider buffer, as many as the next power of 2 (at most 32), so that no
  // warp splits a pixel's slice and leaves a sector partly written that
  // one warp would have filled
  const int cvc = cn / VC;
  int grp = cvc;
  for (int j = 0; j < d.n; ++j) {
    if (d.pitch[j] != c) {
      grp = 1;
      while (grp < cvc && grp < 32) grp *= 2;
      grp = grp < cvc ? (cvc + 31) / 32 * 32 : grp;
      break;
    }
  }
  for (int i = threadIdx.x; i < th * RUNS * grp; i += kThreads) {
    const int r = i / grp, v = i - r * grp;
    if (v >= cvc) continue;
    const int ry = r / RUNS, rx = r - ry * RUNS;
    const int oy = ty * th + ry, ox = tx * TW + rx * PX;
    if (oy >= ho || ox >= wo) continue;
    const float* w0 = s_w + v * VC;
    float acc[PX][VC];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int tr = ry * S + ky, tc = rx * PX * S;
      const unsigned g = (unsigned)((n * h + y0 + tr) * w + x0 + tc);
      unsigned sh = g * step + (unsigned)(k0 * SZ);
      const unsigned char* row = smem + ((size_t)tr * iw + tc) * slot +
                                 v * VC * SZ;
      float in[NIN][VC];
#pragma unroll
      for (int q = 0; q < NIN; ++q, sh += step) {
        Vec<T, VC>::load(
            reinterpret_cast<const T*>(row + q * slot + (sh & 15u)), in[q]);
      }
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float wv[VC];
        Vec<float, VC>::load(w0 + (ky * 3 + kx) * ct, wv);
#pragma unroll
        for (int px = 0; px < PX; ++px) {
#pragma unroll
          for (int k = 0; k < VC; ++k) {
            const float prod = __fmul_rn(in[px * S + kx][k], wv[k]);
            acc[px][k] = ky == 0 && kx == 0 ? prod
                                            : __fadd_rn(acc[px][k], prod);
          }
        }
      }
    }
    typename Vec<T, VC>::Packed out[PX];
    float bv[VC];
    if (bias != nullptr) Vec<float, VC>::load(s_b + v * VC, bv);
#pragma unroll
    for (int px = 0; px < PX; ++px) {
      if (bias != nullptr) {
#pragma unroll
        for (int k = 0; k < VC; ++k) acc[px][k] = __fadd_rn(acc[px][k], bv[k]);
      }
      out[px] = Vec<T, VC>::pack(acc[px]);
    }
    const int np = min(PX, wo - ox);
    const size_t pix = ((size_t)n * ho + oy) * wo + ox;
    for (int j = 0; j < d.n; ++j) {
      const long long pitch = d.pitch[j];
      T* dst = static_cast<T*>(d.ptr[j]) + pix * pitch + d.off[j] + k0 +
               v * VC;
#pragma unroll
      for (int px = 0; px < PX; ++px) {
        if (px < np) {
          *reinterpret_cast<typename Vec<T, VC>::Packed*>(dst + px * pitch) =
              out[px];
        }
      }
    }
  }
}

// the chunk's channels: all of C where a pixel's C fit in 256 bytes, else
// the fewest chunks of at most 128 bytes, as even as VC allows
int chunk_channels(int c, int vc, int size) {
  if (c * size <= 256) return c;
  const int chunks = (c * size + 127) / 128;
  const int per = (c + chunks - 1) / chunks;
  return (per + vc - 1) / vc * vc;
}

// 16-byte words a pixel's segment of ct channels can span: its bytes, and
// as many before it as its address can sit past a 16-byte boundary (the
// largest power of 2 up to 16 dividing both c and ct bytes bounds that)
int slot_words(int c, int ct, int size) {
  int g = 16;
  while ((c * size) % g != 0 || (ct * size) % g != 0) g /= 2;
  return (ct * size + 16 - g + 15) / 16;
}

size_t smem_bytes(int th, int tw, int s, int ct, int nw) {
  return (size_t)((th - 1) * s + 3) * ((tw - 1) * s + 3) * nw * 16 +
         (size_t)10 * ct * sizeof(float);
}

template <typename T, int VC, int S>
cudaError_t launch(const void* x, const void* wgt, const void* bias,
                   const Dests& d, int n, int h, int w, int c,
                   cudaStream_t st) {
  constexpr int TW = kTileW<S>;
  const int ho = (h - 1) / S + 1, wo = (w - 1) / S + 1;
  const int ct = chunk_channels(c, VC, sizeof(T));
  const int chunks = (c + ct - 1) / ct;
  const int nw = slot_words(c, ct, sizeof(T));
  // 8 rows of outputs, fewer where the input tile would not fit in 48 KB
  int th = 8;
  while (smem_bytes(th, TW, S, ct, nw) > kSmemBytes && th > 1) --th;
  const size_t smem = smem_bytes(th, TW, S, ct, nw);
  const long long tiles_x = (wo + TW - 1) / TW, tiles_y = (ho + th - 1) / th;
  if (smem > kSmemBytes || nw > kThreads || tiles_x * chunks > 0x7fffffffLL ||
      tiles_y > 65535 || n > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)(tiles_x * chunks), (unsigned)tiles_y,
                  (unsigned)n);
  depthwise_store_kernel<T, VC, S><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wgt),
      static_cast<const float*>(bias), d, h, w, c, ho, wo, th, ct, chunks,
      nw);
  return cudaGetLastError();
}

template <typename T, int VC>
cudaError_t by_stride(int s, const void* x, const void* wgt, const void* bias,
                      const Dests& d, int n, int h, int w, int c,
                      cudaStream_t st) {
  return s == 2 ? launch<T, VC, 2>(x, wgt, bias, d, n, h, w, c, st)
                : launch<T, VC, 1>(x, wgt, bias, d, n, h, w, c, st);
}

}  // namespace

// x [n, h, w, c] (T, channels-last), weight [c, 3, 3] (T), bias [c] f32 or
// null; dests a host array of 3 * n_dest long longs: the destinations'
// pointers, then their channel offsets, then their pitches (each a
// channels-last [n, ho, wo, pitch] buffer of T, ho = (h - 1) / stride + 1);
// dtype 0 f32, 1 bf16; vec the channels a store may move, dividing c and
// every offset and pitch (ops/depthwise_store.py picks it).  Returns cudaGetLastError() after the
// launch.
extern "C" int depthwise_store_launch(const void* x, const void* weight,
                                      const void* bias, const void* dests,
                                      int n_dest, int n, int h, int w, int c,
                                      int stride, int dtype, int vec,
                                      void* stream) {
  if (c < 1 || h < 1 || w < 1 || n < 0 || vec < 1 || c % vec != 0 ||
      (stride != 1 && stride != 2) || n_dest < 1 || n_dest > kMaxDests ||
      dests == nullptr || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Dests d;
  d.n = n_dest;
  const long long* a = static_cast<const long long*>(dests);
  for (int j = 0; j < n_dest; ++j) {
    d.ptr[j] = reinterpret_cast<void*>(a[j]);
    d.off[j] = a[n_dest + j];
    d.pitch[j] = a[2 * n_dest + j];
    if (d.ptr[j] == nullptr || d.off[j] < 0 || d.off[j] % vec != 0 ||
        d.pitch[j] % vec != 0 || d.off[j] + c > d.pitch[j]) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the channels a thread computes and stores at once: vec, at most 8
  // bytes (the input is loaded in 16-byte words whatever c's alignment)
  const int s = stride;
  if (dtype == 0) {
    return (int)(vec >= 2 ? by_stride<float, 2>(s, x, weight, bias, d, n, h, w, c, st)
                          : by_stride<float, 1>(s, x, weight, bias, d, n, h, w, c, st));
  }
  switch (vec >= 4 ? 4 : vec) {
    case 4: return (int)by_stride<__nv_bfloat16, 4>(s, x, weight, bias, d, n, h, w, c, st);
    case 2: return (int)by_stride<__nv_bfloat16, 2>(s, x, weight, bias, d, n, h, w, c, st);
    default: return (int)by_stride<__nv_bfloat16, 1>(s, x, weight, bias, d, n, h, w, c, st);
  }
}
