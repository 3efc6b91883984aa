// Conv epilogue of the backbones' folded predict route.
//
// Replaces no TPU kernel.  The JAX package leaves batch norm, the residual
// add and the activation to XLA, which fuses them into the convolution's
// output pass.  The port's eager predict ran each as a pass of its own over
// the conv's output (F.batch_norm, torch.clamp or F.prelu, the add).  With
// eval-mode batch norm folded into the conv's weights and a float32 bias
// (models/layers.py:fold_norm), this kernel is the one pass that is left,
// in place on the unbiased conv's output:
//   y <- act(y + bias[c] (+ residual)),  in f32, rounded once to T.
// act is none, ReLU6 (clamp to [0, 6]) or PReLU with one slope read from
// device memory (no host sync), rounded to T first, as F.prelu takes the
// weight in the input's dtype.  The sums run in the plain version's order
// ((y + bias) + residual), so the two agree bit for bit
// (ops/conv_epilogue.py:conv_epilogue_reference).
//
// Layout: y and residual are channels-last maps, rows of C channels, one a
// pixel; a vector's channel is its index modulo C / V.
//
// What bounds it on the H100: bytes.  It reads y (and the residual) and
// writes y once, sizeof(T) * N*H*W*C each: a 256-channel bf16 map of 16
// images at 200x272 is 446 MB a pass, 0.27 ms at 3.35 TB/s (0.40 ms with a
// residual).  Design: V channels a load, the widest of 16, 8, 4 and 2 bytes
// that divides a pixel's C channels (16 bytes for C % 8 == 0 in bf16; the
// 4-byte pairs of HarDNet's widths 26, 82, 102, 262, 410), and as many
// vectors a thread an iteration as make 16 bytes, so that every width keeps
// as many bytes in flight; the bias in shared memory once a block; a
// grid-stride loop over at most 8 blocks of 256 threads an SM, each thread
// stepping its vector's channel by the stride modulo C / V rather than
// dividing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
enum Act { kNone = 0, kRelu6 = 1, kPrelu = 2 };

// V adjacent elements in one load / store of V * sizeof(T) bytes (y is
// read and written, so its loads do not take the read-only path)
template <typename T, int V>
struct Vec;

template <int V>
struct Vec<float, V> {
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
  static __device__ __forceinline__ void store(float* p, const float (&f)[V]) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    } else {
      *p = f[0];
    }
  }
  static __device__ __forceinline__ float round(float a) { return a; }
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
  static __device__ __forceinline__ float round(float a) {
    return __bfloat162float(__float2bfloat16(a));
  }
};

template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
epilogue_kernel(T* __restrict__ y, const T* __restrict__ res,
                const float* __restrict__ bias,
                const float* __restrict__ slope, long long n_vec, int cv) {
  // U vectors a thread an iteration: 16 bytes in flight whatever V is
  constexpr int U = (int)(16 / (V * sizeof(T))) > 0
                        ? (int)(16 / (V * sizeof(T))) : 1;
  extern __shared__ float s_bias[];
  for (int i = threadIdx.x; i < cv * V; i += blockDim.x) s_bias[i] = bias[i];
  float a = 0.0f;
  if constexpr (ACT == kPrelu) a = Vec<T, V>::round(__ldg(slope));
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const int step = (int)(stride % cv);
  long long v0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int col = (int)(v0 % cv);
  for (; v0 < n_vec; v0 += U * stride) {
    float f[U][V];
    int cols[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long v = v0 + u * stride;
      cols[u] = col;
      col += step;
      if (col >= cv) col -= cv;
      if (v < n_vec) {
        Vec<T, V>::load(y + v * V, f[u]);
        if constexpr (RES) {
          float r[V];
          Vec<T, V>::load(res + v * V, r);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            f[u][k] = (f[u][k] + s_bias[cols[u] * V + k]) + r[k];
          }
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) f[u][k] += s_bias[cols[u] * V + k];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long v = v0 + u * stride;
      if (v >= n_vec) break;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float x = f[u][k];
        if constexpr (ACT == kRelu6) {
          // NaN stays NaN, as in torch.clamp
          f[u][k] = x != x ? x : fminf(fmaxf(x, 0.0f), 6.0f);
        } else if constexpr (ACT == kPrelu) {
          f[u][k] = x >= 0.0f ? x : x * a;
        }
      }
      Vec<T, V>::store(y + v * V, f[u]);
    }
  }
}

int g_sms = 0;

template <typename T, int V, int ACT, bool RES>
cudaError_t launch(void* y, const void* res, const void* bias,
                   const void* slope, long long n, int c, cudaStream_t st) {
  constexpr int U = (int)(16 / (V * sizeof(T))) > 0
                        ? (int)(16 / (V * sizeof(T))) : 1;
  const long long n_vec = n / V;
  const long long want = (n_vec + (long long)kThreads * U - 1) /
                         ((long long)kThreads * U);
  const int blocks = (int)std::max(1LL, std::min(want,
                                   (long long)g_sms * kBlocksPerSm));
  epilogue_kernel<T, V, ACT, RES>
      <<<blocks, kThreads, c * sizeof(float), st>>>(
          static_cast<T*>(y), static_cast<const T*>(res),
          static_cast<const float*>(bias), static_cast<const float*>(slope),
          n_vec, c / V);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dispatch(int act, bool has_res, void* y, const void* res,
                     const void* bias, const void* slope, long long n, int c,
                     cudaStream_t st) {
  switch (act * 2 + (has_res ? 1 : 0)) {
    case 0: return launch<T, V, kNone, false>(y, res, bias, slope, n, c, st);
    case 1: return launch<T, V, kNone, true>(y, res, bias, slope, n, c, st);
    case 2: return launch<T, V, kRelu6, false>(y, res, bias, slope, n, c, st);
    case 3: return launch<T, V, kRelu6, true>(y, res, bias, slope, n, c, st);
    case 4: return launch<T, V, kPrelu, false>(y, res, bias, slope, n, c, st);
    case 5: return launch<T, V, kPrelu, true>(y, res, bias, slope, n, c, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// y [n / c, c] (T, in place), residual the same or null, bias [c] f32,
// slope [1] f32 (read with act == 2 only); dtype 0 f32, 1 bf16; vec the
// channels a load (ops/conv_epilogue.py picks it from c).  Returns
// cudaGetLastError() after the launch.
extern "C" int conv_epilogue_launch(void* y, const void* residual,
                                    const void* bias, const void* slope,
                                    long long n, int c, int act, int dtype,
                                    int vec, void* stream) {
  if (c < 1 || vec < 1 || c % vec != 0 || n % c != 0 || act < 0 ||
      act > 2 || (act == kPrelu && slope == nullptr) ||
      c * sizeof(float) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_sms < 1) g_sms = 132;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool r = residual != nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 4: err = dispatch<float, 4>(act, r, y, residual, bias, slope, n, c, st); break;
      case 2: err = dispatch<float, 2>(act, r, y, residual, bias, slope, n, c, st); break;
      case 1: err = dispatch<float, 1>(act, r, y, residual, bias, slope, n, c, st); break;
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 8: err = dispatch<__nv_bfloat16, 8>(act, r, y, residual, bias, slope, n, c, st); break;
      case 4: err = dispatch<__nv_bfloat16, 4>(act, r, y, residual, bias, slope, n, c, st); break;
      case 2: err = dispatch<__nv_bfloat16, 2>(act, r, y, residual, bias, slope, n, c, st); break;
      case 1: err = dispatch<__nv_bfloat16, 1>(act, r, y, residual, bias, slope, n, c, st); break;
    }
  }
  return (int)err;
}
