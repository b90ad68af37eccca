// su3_mult.cu — the SU3_Bench link multiply C = A (x) B, chained k times,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/su3_matmul.py:
// su3_mult_planar (body _su3_kernel over _mult_tile, _expand_tile and
// _compress_tile), registered there as "pallas".
//
// What bounds it on this card: HBM bytes.  One multiply reads A and writes C,
// 2 x 72 words per site (2 x 48 with two-row storage), for 864 flops: 1.5
// flop/byte at f32, far below the H100 SXM's FP32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte.  A k-chain keeps each link in registers between
// multiplies, so it moves the same bytes for k times the flops; at f32 it
// stays bytes-bound up to k ~ 13.
//
// How the design deals with that:
//  * One thread per (site, link).  A link's chain C_j = A_j B_j^k touches only
//    that link's 18 words (12 two-row), so a thread holds its inputs, its
//    outputs and B_j in registers.  One thread per site would need more than
//    150 registers, and 512 such threads would exceed the SM's 64K registers.
//  * blockIdx.y is the link and a warp's threads take consecutive sites, so
//    every row load and store of a warp is one contiguous segment, in SoA
//    (offset (p*rows + r)*S + s) and in AoSoA (offset
//    ((s/T*2 + p)*rows + r)*T + s%T) alike.  AoSoA is read and written in
//    place: no transposing copy before or after the kernel, only A and C
//    stream through HBM.
//  * B_j (18 words) is staged in shared memory once per block.
//  * Rounding: every product, sum and difference is an explicit __fmul_rn /
//    __fadd_rn / __fsub_rn in the order of the reference's _mult_tile, so
//    nvcc contracts nothing into an FMA.  The kernel rounds exactly as its
//    plain PyTorch version (repro_torch/kernels/su3_matmul.py), and a k-chain
//    equals k single launches bit for bit at f32.
//  * bf16 storage: words widen with __bfloat162float on load.  Pure bf16
//    rounds to bf16 (__float2bfloat16_rn) after every product, sum and
//    difference, as the reference's bf16 _mult_tile does (each jnp op on
//    bf16 operands rounds its result), so the two agree bit for bit; bf16
//    storage with f32 accumulation keeps the chain in f32 and narrows once
//    on store.
//  * Two-row storage: rows 0/1 of C depend only on rows 0/1 of A, so a chain
//    over the two stored rows never reads row 2, and the thread computes the
//    stored rows only.  (The TPU kernel rebuilds row 2 on load and drops it
//    again on store; its stored output is the same function.)
//  * In place (c == a) is safe: each thread reads all of its words before it
//    writes any, and no other thread touches them.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block, one (site, link) each
constexpr int kLinks = 4;
constexpr int kFullRows = 36;  // planar rows of B (and of full storage)

// storage / arithmetic modes, as passed from Python
constexpr int kModeF32 = 0;        // f32 words, f32 chain
constexpr int kModeBF16 = 1;       // bf16 words, rounded to bf16 per operation
constexpr int kModeBF16AccF32 = 2; // bf16 words, f32 chain, rounded on store

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// R: round the result to bf16 (pure bf16), else keep the f32 result.
template <bool R>
__device__ __forceinline__ float rnd(float x) {
  return R ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}
template <bool R>
__device__ __forceinline__ float mul(float a, float b) { return rnd<R>(__fmul_rn(a, b)); }
template <bool R>
__device__ __forceinline__ float add(float a, float b) { return rnd<R>(__fadd_rn(a, b)); }
template <bool R>
__device__ __forceinline__ float sub(float a, float b) { return rnd<R>(__fsub_rn(a, b)); }

// T: storage word; NR: stored rows per link (3 full, 2 two-row);
// ROUND_EACH: round to bf16 after every operation (pure bf16);
// AOSOA: (tiles, 2, rows, lane) physical layout, else SoA (2, rows, S).
template <typename T, int NR, bool ROUND_EACH, bool AOSOA>
__global__ void __launch_bounds__(kThreads)
su3_mult_kernel(const void* a_words, void* c_words, const void* b_words,
                int64_t n_sites, int lane, int k_iters) {
  const T* a = static_cast<const T*>(a_words);
  T* c = static_cast<T*>(c_words);
  const T* b = static_cast<const T*>(b_words);

  __shared__ float b_s[2][9];
  const int j = blockIdx.y;  // link
  if (threadIdx.x < 18) {
    const int p = threadIdx.x / 9, e = threadIdx.x % 9;
    b_s[p][e] = widen(b[p * kFullRows + j * 9 + e]);
  }
  __syncthreads();

  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_sites) return;

  constexpr int rows = kLinks * NR * 3;  // planar rows of the stored form
  int64_t base, row_stride;
  if (AOSOA) {
    const int64_t tile = s / lane;
    base = tile * 2 * rows * lane + (s - tile * lane);
    row_stride = lane;
  } else {
    base = s;
    row_stride = n_sites;
  }
  const int64_t plane_stride = static_cast<int64_t>(rows) * row_stride;
  const int64_t first = base + static_cast<int64_t>(j * NR * 3) * row_stride;

  float xr[NR][3], xi[NR][3];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const int64_t o = first + static_cast<int64_t>(k * 3 + l) * row_stride;
      xr[k][l] = widen(a[o]);
      xi[k][l] = widen(a[o + plane_stride]);
    }
  }
  float br[9], bi[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    br[e] = b_s[0][e];
    bi[e] = b_s[1][e];
  }

#pragma unroll 1
  for (int it = 0; it < k_iters; ++it) {
    float yr[NR][3], yi[NR][3];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        // c[k][m] = sum_l x[k][l] * b[l][m], in _mult_tile's order:
        //   cr = (cr + xr*br) - xi*bi ;  ci = (ci + xr*bi) + xi*br
        constexpr bool R = ROUND_EACH;
        float cr = sub<R>(mul<R>(xr[k][0], br[m]), mul<R>(xi[k][0], bi[m]));
        float ci = add<R>(mul<R>(xr[k][0], bi[m]), mul<R>(xi[k][0], br[m]));
#pragma unroll
        for (int l = 1; l < 3; ++l) {
          cr = sub<R>(add<R>(cr, mul<R>(xr[k][l], br[l * 3 + m])),
                      mul<R>(xi[k][l], bi[l * 3 + m]));
          ci = add<R>(add<R>(ci, mul<R>(xr[k][l], bi[l * 3 + m])),
                      mul<R>(xi[k][l], br[l * 3 + m]));
        }
        yr[k][m] = cr;
        yi[k][m] = ci;
      }
    }
#pragma unroll
    for (int k = 0; k < NR; ++k) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        xr[k][m] = yr[k][m];
        xi[k][m] = yi[k][m];
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NR; ++k) {
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const int64_t o = first + static_cast<int64_t>(k * 3 + l) * row_stride;
      c[o] = narrow<T>(xr[k][l]);
      c[o + plane_stride] = narrow<T>(xi[k][l]);
    }
  }
}

using KernelFn = void (*)(const void*, void*, const void*, int64_t, int, int);

template <typename T, int NR, bool ROUND_EACH>
KernelFn pick_layout(int aosoa) {
  if (aosoa) return su3_mult_kernel<T, NR, ROUND_EACH, true>;
  return su3_mult_kernel<T, NR, ROUND_EACH, false>;
}

KernelFn pick(int mode, int compressed, int aosoa) {
  switch (mode) {
    case kModeF32:
      return compressed ? pick_layout<float, 2, false>(aosoa)
                        : pick_layout<float, 3, false>(aosoa);
    case kModeBF16:
      return compressed ? pick_layout<__nv_bfloat16, 2, true>(aosoa)
                        : pick_layout<__nv_bfloat16, 3, true>(aosoa);
    case kModeBF16AccF32:
      return compressed ? pick_layout<__nv_bfloat16, 2, false>(aosoa)
                        : pick_layout<__nv_bfloat16, 3, false>(aosoa);
    default:
      return nullptr;
  }
}

}  // namespace

// Launches the chain on `stream`.  a/c: SoA (2, rows, n_sites) when lane == 0,
// else AoSoA (n_sites / lane, 2, rows, lane); rows = 24 if compressed else 36;
// c may equal a.  b: (2, 36).  Returns the launch's cudaError_t (0 = queued).
extern "C" int su3_mult_planar(const void* a, void* c, const void* b,
                               long long n_sites, int lane, int k_iters,
                               int mode, int compressed, void* stream) {
  KernelFn fn = pick(mode, compressed, lane > 0);
  if (fn == nullptr || n_sites <= 0 || k_iters < 1 || lane < 0 ||
      (lane > 0 && n_sites % lane != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((n_sites + kThreads - 1) / kThreads), kLinks);
  const dim3 block(kThreads);
  int64_t n = n_sites;
  void* args[] = {const_cast<void**>(&a), &c, const_cast<void**>(&b), &n, &lane, &k_iters};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid, block, args, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's per-block budget: out = {numRegs, static shared bytes, local
// (spill) bytes, maxThreadsPerBlock, threads per block, resident blocks/SM}.
extern "C" int su3_mult_planar_attributes(int mode, int compressed, int aosoa, int* out) {
  KernelFn fn = pick(mode, compressed, aosoa);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(fn));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reinterpret_cast<const void*>(fn), kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  out[4] = kThreads;
  out[5] = blocks;
  return 0;
}

extern "C" const char* su3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
