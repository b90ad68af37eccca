// flash_attention.cu — GQA prefill attention with an online softmax for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// flash_attention_tpu (body _flash_kernel), which the reference documents as
// the prefill attention on the accelerator.  It computes what the chunked
// src/repro/models/attention.py flash_attention computes:
//   q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), G = Hq / Hkv query heads per
//   kv head; scores (q * D^-1/2) . k in f32, masked to -1e30 where a key lies
//   past Skv or, if causal, past the query's absolute position (its index +
//   q_offset); an online softmax with f32 statistics; out = acc / max(l,
//   1e-37), rounded once to q's type.
//
// What bounds it on this card: operations.  At the prefill shape (B=4,
// Sq=Skv=1024, Hq=32, Hkv=8, D=128, causal) a layer needs 4*B*Hq*D flops per
// visible (query, key) pair, 34.4 GFLOP: 0.035 ms at the bf16 tensor-core
// rate (989 TFLOP/s, H100 SXM) and 0.51 ms at the FP32 CUDA-core rate
// (67 TFLOP/s), against 84 MB of q, k, v and o (0.025 ms at 3.35 TB/s).
// This kernel runs on the CUDA cores in f32 (FMAs), so 0.51 ms is its own
// floor; tensor cores (wgmma over bf16 tiles) are a later step.
//
// Design:
//  * One block per (batch * kv head, tile of 64 folded rows).  Folded row f
//    of a kv head is query f / G, head hk * G + f % G: the GQA group is
//    indexed in place through the strides of the (B, S, H, D) tensors, so
//    the reference's transposed fold is never materialised.
//  * 256 threads as 16 x 16; thread (ty, tx) owns rows 4ty..4ty+3 of the
//    score tile (keys 4tx..4tx+3) and of the output (D/16 columns), so the
//    row statistics and the rescaling of the accumulators stay in its
//    registers; a row's max and sum are reduced over its 16 threads with
//    warp shuffles.
//  * Shared memory, all f32: q * scale transposed (D x 64), one K tile
//    transposed (D x 64), one V tile (64 x D) and the probabilities
//    (64 x 64): 112 KB at D=128, two blocks per SM.  Each operand is widened
//    to f32 once on load (bf16 storage), as the reference upcasts.
//  * Tiles of 64 keys; causal blocks stop at the last tile that holds a
//    visible key.  A skipped tile would add exp(-1e30 - m) = 0 to every row,
//    so skipping changes no bit.  Key 0 lies in the first tile and is seen
//    by every row, so the masked value -1e30 never leaks into a sum.
//  * Keys past Skv and rows past Sq * G are masked here (the ragged edge):
//    any Sq, Skv, q_offset >= 0 and non-causal Sq != Skv are served.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // folded query rows per block
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

constexpr int kF32 = 0;  // dtype codes, as passed from Python
constexpr int kBF16 = 1;

struct Params {
  int sq, skv, g, hkv, q_offset;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (batch, seq, head)
};

template <int D>
constexpr int smem_floats() {
  return D * kRows + D * kKeys + kKeys * D + kRows * kKeys;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Output column c (0 <= c < D/16) of thread tx: groups of 4 at 64-column
// strides, so the 16 threads of a row read 256 contiguous bytes of V.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D >= 64) {
    return (c / 4) * 64 + tx * 4 + (c % 4);
  } else {
    return tx * (D / 16) + c;
  }
}

template <int D>
__device__ __forceinline__ void load_v_row(const float* row, int tx, float (&vv)[D / 16]) {
  if constexpr (D >= 64) {
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(row + g * 64 + tx * 4);
      vv[g * 4 + 0] = x.x;
      vv[g * 4 + 1] = x.y;
      vv[g * 4 + 2] = x.z;
      vv[g * 4 + 3] = x.w;
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(row + tx * 2);
    vv[0] = x.x;
    vv[1] = x.y;
  }
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, const Params p) {
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kRows]  q * scale
  float* kt = qt + D * kRows;                   // [D][kKeys]
  float* vs = kt + D * kKeys;                   // [kKeys][D]
  float* ps = vs + kKeys * D;                   // [kRows][kKeys]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / p.hkv, hk = blockIdx.y % p.hkv;
  const long long rows = static_cast<long long>(p.sq) * p.g;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const T* kb = k + b * p.ks[0] + hk * p.ks[2];
  const T* vb = v + b * p.vs[0] + hk * p.vs[2];

  // q * scale in f32 (the reference's q.astype(f32) * scale), transposed
  for (int idx = tid; idx < kRows * (D / 4); idx += kThreads) {
    const int r = idx % kRows, c = (idx / kRows) * 4;
    const long long f = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < rows) {
      const long long i = f / p.g;
      const int h = hk * p.g + static_cast<int>(f % p.g);
      x = load4(q + b * p.qs[0] + i * p.qs[1] + h * p.qs[2] + c);
    }
    qt[(c + 0) * kRows + r] = x.x * p.scale;
    qt[(c + 1) * kRows + r] = x.y * p.scale;
    qt[(c + 2) * kRows + r] = x.z * p.scale;
    qt[(c + 3) * kRows + r] = x.w * p.scale;
  }

  // absolute position of each of this thread's rows (rows past the end are
  // computed on zero q and never stored)
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = row0 + ty * 4 + i;
    qpos[i] = static_cast<int>((f < rows ? f : rows - 1) / p.g) + p.q_offset;
  }
  int n_tiles = (p.skv + kKeys - 1) / kKeys;
  if (kCausal) {
    const long long last_row = (row0 + kRows < rows ? row0 + kRows : rows) - 1;
    const int last_pos = static_cast<int>(last_row / p.g) + p.q_offset;
    n_tiles = min(n_tiles, last_pos / kKeys + 1);
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kKeys * (D / 4); idx += kThreads) {
      const int j = idx % kKeys, c = (idx / kKeys) * 4, key = key0 + j;
      const float4 x = key < p.skv ? load4(kb + key * p.ks[1] + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      kt[(c + 0) * kKeys + j] = x.x;
      kt[(c + 1) * kKeys + j] = x.y;
      kt[(c + 2) * kKeys + j] = x.z;
      kt[(c + 3) * kKeys + j] = x.w;
    }
    for (int idx = tid; idx < kKeys * (D / 4); idx += kThreads) {
      const int j = idx / (D / 4), c = (idx % (D / 4)) * 4, key = key0 + j;
      const float4 x = key < p.skv ? load4(vb + key * p.vs[1] + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vs + j * D + c) = x;
    }
    __syncthreads();

    // scores of rows 4ty.. against keys 4tx..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kRows + ty * 4);
      const float4 bk = *reinterpret_cast<const float4*>(kt + d * kKeys + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + tx * 4 + j;
        const bool visible = key < p.skv && (!kCausal || key <= qpos[i]);
        s[i][j] = visible ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kKeys + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kKeys + j);
        pr[i][0] = x.x;
        pr[i][1] = x.y;
        pr[i][2] = x.z;
        pr[i][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kCols];
        load_v_row<D>(vs + (j + jj) * D, tx, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pr[i][jj], vv[c], acc[i][c]);
      }
    }
  }

  // out = acc / max(l, 1e-37), rounded once to the storage type
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = row0 + ty * 4 + i;
    if (f >= rows) continue;
    const long long qi = f / p.g;
    const int h = hk * p.g + static_cast<int>(f % p.g);
    T* orow = o + b * p.os[0] + qi * p.os[1] + h * p.os[2];
    const float den = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) store1(orow + out_col<D>(tx, c), acc[i][c] / den);
  }
}

template <typename T, int D>
const void* pick_causal(bool causal) {
  return causal ? reinterpret_cast<const void*>(&flash_attention_kernel<T, D, true>)
                : reinterpret_cast<const void*>(&flash_attention_kernel<T, D, false>);
}

template <typename T>
const void* pick_d(int d, bool causal) {
  switch (d) {
    case 32: return pick_causal<T, 32>(causal);
    case 64: return pick_causal<T, 64>(causal);
    case 128: return pick_causal<T, 128>(causal);
    default: return nullptr;
  }
}

const void* pick(int dtype, int d, bool causal) {
  switch (dtype) {
    case kF32: return pick_d<float>(d, causal);
    case kBF16: return pick_d<__nv_bfloat16>(d, causal);
    default: return nullptr;
  }
}

int smem_bytes(int d) {
  switch (d) {
    case 32: return 4 * smem_floats<32>();
    case 64: return 4 * smem_floats<64>();
    case 128: return 4 * smem_floats<128>();
    default: return -1;
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel; ask for the
// largest carveout so that two 112 KB blocks fit on one SM.
cudaError_t prepare(const void* fn, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Attention on `stream`.  q (batch, sq, hq, d), k and v (batch, skv, hkv,
// d), o like q; strides[12] holds the element strides of (batch, seq,
// head) for q, k, v and o in that order (the last dim is contiguous).
// dtype: 0 f32, 1 bf16.  Returns the launch's cudaError_t (0 = queued).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int batch, int sq, int skv, int hq, int hkv, int d,
                                   const long long* strides, int causal, int q_offset,
                                   float scale, int dtype, void* stream) {
  const void* fn = pick(dtype, d, causal != 0);
  if (fn == nullptr || batch <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      q_offset < 0 || static_cast<long long>(batch) * hkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.sq = sq;
  p.skv = skv;
  p.g = hq / hkv;
  p.hkv = hkv;
  p.q_offset = q_offset;
  p.scale = scale;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  const int bytes = smem_bytes(d);
  cudaError_t err = prepare(fn, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_tiles = (static_cast<long long>(sq) * p.g + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(batch * hkv));
  void* args[] = {const_cast<void**>(&q), const_cast<void**>(&k), const_cast<void**>(&v), &o, &p};
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation's per-block budget: out = {numRegs, dynamic shared
// bytes, local (spill) bytes, maxThreadsPerBlock, threads per block,
// resident blocks/SM}.
extern "C" int flash_attention_attributes(int dtype, int d, int causal, int* out) {
  const void* fn = pick(dtype, d, causal != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes(d);
  cudaError_t err = prepare(fn, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = bytes;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  out[4] = kThreads;
  out[5] = blocks;
  return 0;
}

// Every csrc library exports this name; the wrappers raise with it.
extern "C" const char* su3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
