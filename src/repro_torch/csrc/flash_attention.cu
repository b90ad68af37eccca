// flash_attention.cu — GQA prefill attention with an online softmax for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// flash_attention_tpu (body _flash_kernel), which the reference documents as
// the prefill attention on the accelerator.  It computes what the chunked
// src/repro/models/attention.py flash_attention computes:
//   q and k (B, Sq|Skv, Hq|Hkv, D), v (B, Skv, Hkv, Dv), G = Hq / Hkv query
//   heads per kv head; scores (q * D^-1/2) . k in f32, masked to -1e30 where a key lies
//   past Skv or, if causal, past the query's absolute position (its index +
//   q_offset); an online softmax with f32 statistics; out = acc / max(l,
//   1e-37), rounded once to q's type, (B, Sq, Hq, Dv).  Dv = D at D in
//   {32, 64, 128}; MLA's prefill (src/repro/models/mla.py apply) calls it at
//   D = 192 (nope 128 + rope 64), Dv = 128, with G = 1, on a concatenated q
//   and k; here MLA's prefill and training pass the parts instead
//   (flash_attention_mla_fwd, tc::flash_mla_fwd).
//
// What bounds it on this card: operations.  At the prefill shape (B=4,
// Sq=Skv=1024, Hq=32, Hkv=8, D=128, causal) a layer needs 4*B*Hq*D flops per
// visible (query, key) pair, 34.4 GFLOP: 0.035 ms at the bf16 tensor-core
// rate (989 TFLOP/s, H100 SXM) and 0.51 ms at the FP32 CUDA-core rate
// (67 TFLOP/s), against 84 MB of q, k, v and o (0.025 ms at 3.35 TB/s).
// MLA's prefill (B=4, S=1024, H=128, G=1, D=192, Dv=128) is bound by bytes:
// 604.5 MB of q, k_nope, v and o (every head has its own) and k's one rope
// channel, 0.180 ms at 3.35 TB/s (671 MB, 0.200 ms, where k's rope part is
// copied to every head), against 2*(D+Dv) flops a visible pair, 0.174 ms
// at 989 TFLOP/s.
//
// Two bodies, chosen by the storage type:
//
// bf16 (the prefill path): tensor cores.  Its bound is the bf16
// tensor-core rate (989 TFLOP/s, against 67 for FP32).
//  * Work: at D = Dv = 64 and 128 (every model's attention but MLA's) one
//    persistent block per SM walks a list of (batch * kv head, tile of G *
//    (128 / G) folded rows: whole query groups) work items, heaviest first,
//    in chunks of heads whose K and V stay in L2 (tc::flash_group_fwd, G <=
//    128).  Folded row f of a kv head is query f / G, head hk * G + f % G,
//    read in place through the (B, S, H) strides: the GQA group is never
//    copied.  At D=192, Dv=128 (MLA) a persistent block walks (head, row
//    tile) items (tc::flash_mla_fwd).  At D=32 (the tests' small configs)
//    flash_attention_tc runs one block per (batch * kv head, tile of 128
//    folded rows), heaviest first.
//  * Three warpgroups: a producer that keeps tiles of 128 keys coming by TMA
//    into shared-memory rings (full and empty mbarriers), and two consumers
//    of 64 rows each (wgmma's M), which take the producer's registers
//    (setmaxnreg).  flash_group_fwd loads Q by TMA into two stages at D=64
//    and one at D=128, K and V into rings of three stages each (132,224 B
//    and 230,512 B), so that the next item's Q and first tiles load under
//    this item's last tiles and its O store; flash_mla_fwd Q beside two K
//    and two V stages (214,096 B); flash_attention_tc Q by the consumers'
//    cp.async beside three K/V stages (58,416 B at D=32).
//  * Per key tile, each consumer issues one batch: O += P V of the previous
//    tile, then S = Q K^T (wgmma, bf16 operands from shared memory, f32
//    accumulators), then runs the online softmax of S while the other
//    consumer's batch runs: named barriers hand the tensor cores from one
//    warpgroup to the other.  P comes from registers (the S accumulator's
//    layout is the A fragment's) and V from shared memory as stored
//    (MN-major).  The mask runs only on tiles that hold an invisible key.
//  * Precision.  The products of bf16 q and k are exact and summed in f32;
//    D^-1/2 scales the f32 score inside the exponent, p = 2^(s c - m c)
//    with c = D^-1/2 log2(e), so q * D^-1/2 is never rounded to bf16.  p is
//    split into p_hi = bf16(p) and p_lo = bf16(p - p_hi) and both are
//    multiplied into V: p_hi + p_lo holds p to ~2^-16, where one bf16 p
//    would put ~10% of the outputs more than a bf16 ulp from the plain
//    version.  So the kernel still differs from its plain version by about
//    one output rounding, at 1.5x the counted flops (PV twice); its own
//    floor is the flops it executes at 989 TFLOP/s.
//  * Keys past Skv arrive as zeros (TMA's out-of-bounds fill) and are
//    masked; rows past Sq * G are computed on zero q and never stored.
//
// f32: CUDA cores, flash_attention_kernel, in f32 FMAs (0.51 ms is its own
// floor at the prefill shape).
//  * One block per (batch * kv head, tile of 64 folded rows), 256 threads as
//    16 x 16; thread (ty, tx) owns rows 4ty..4ty+3 of the score tile (keys
//    4tx..4tx+3) and of the output (D/16 columns), so the row statistics and
//    the rescaling of the accumulators stay in its registers; a row's max
//    and sum are reduced over its 16 threads with warp shuffles.
//  * Shared memory, all f32: q * scale transposed (D x 64), one K tile
//    transposed (D x 64), one V tile (64 x D) and the probabilities
//    (64 x 64): 112 KB at D=128, two blocks per SM; with a V tile of
//    64 x Dv, 144 KB at D=192, Dv=128, one block per SM.
//
// Both: causal blocks stop at the last tile that holds a visible key.  A
// skipped tile would add exp(-1e30 - m) = 0 to every row, so skipping
// changes no bit.  Key 0 lies in the first tile and is seen by every row, so
// the masked value -1e30 never leaks into a sum.  Any Sq, Skv, q_offset >= 0
// and non-causal Sq != Skv are served.  Given an lse buffer, both bodies
// also store each row's log-sum-exp for the backward, after `out`.
//
// The backward (flash_attention_bwd) is the gradient the reference takes by
// autodiff, in three kernels: a delta pass, then dK/dV and dQ, without
// atomics in any sum (bf16 at D = Dv = 64 and 128: the delta pass, then one
// persistent kernel over both, tcb::flash_bwd_d64 or tcb::flash_bwd_d128,
// whose blocks claim their work items from a counter).  bf16 runs on the tensor cores (namespace
// tcb), f32 on the CUDA cores (namespace bwd).  Both take the forward's (D,
// Dv) pairs: MLA's training runs them at (192, 128), where Q, K, dQ and dK
// have width D and V, dO, O and dV width Dv.

#include <algorithm>
#include <cstdint>
#include <functional>
#include <vector>

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
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
  float* lse;  // (batch, hq, sq) f32 log-sum-exp of the scaled scores, or null
};

// lse of folded row (query qi, head h): m + log(l) in units of the scaled
// score, where m is the row max and l = sum exp(score - m).
__device__ __forceinline__ void store_lse(const Params& p, int b, long long qi, int h, float m,
                                          float l) {
  p.lse[(static_cast<long long>(b) * p.hkv * p.g + h) * p.sq + qi] = m + logf(l);
}

template <int D, int Dv>
constexpr int smem_floats() {
  return D * kRows + D * kKeys + kKeys * Dv + kRows * kKeys;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

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

template <typename T, int D, int Dv, bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, const Params p) {
  constexpr int kCols = Dv / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kRows]  q * scale
  float* kt = qt + D * kRows;                   // [D][kKeys]
  float* vs = kt + D * kKeys;                   // [kKeys][Dv]
  float* ps = vs + kKeys * Dv;                  // [kRows][kKeys]

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
    for (int idx = tid; idx < kKeys * (Dv / 4); idx += kThreads) {
      const int j = idx / (Dv / 4), c = (idx % (Dv / 4)) * 4, key = key0 + j;
      const float4 x = key < p.skv ? load4(vb + key * p.vs[1] + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vs + j * Dv + c) = x;
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
        load_v_row<Dv>(vs + (j + jj) * Dv, tx, vv);
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
    for (int c = 0; c < kCols; ++c) store1(orow + out_col<Dv>(tx, c), acc[i][c] / den);
    if (p.lse != nullptr && tx == 0) store_lse(p, b, qi, h, m[i], l[i]);
  }
}

// -- bf16: tensor cores ---------------------------------------------------------

namespace tc {

constexpr int kRows = 128;     // folded query rows per block: 64 per consumer warpgroup
constexpr int kKeys = 128;     // keys per K/V tile
constexpr int kThreads = 384;  // one producer and two consumer warpgroups
constexpr int kAlign = 1024;   // a 128-byte swizzle repeats every 8 rows of 128 bytes

// 128 rows of a head dim D in bf16, as TMA boxes of one swizzled row each
template <int D>
struct Tile {
  static constexpr int kSwizzle = D >= 64 ? 128 : 64;  // bytes of one swizzled shared row
  static constexpr int kBoxCols = kSwizzle / 2;        // bf16 of one row of a TMA box
  static constexpr int kBoxes = D / kBoxCols;          // boxes across the head dim
  static constexpr int kBoxBytes = kKeys * kSwizzle;   // one box of 128 rows (Q, K or V)
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // Q, or one K or V tile
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;  // wgmma's swizzle code
};

// flash_attention_tc's block at D = Dv (D=32 since D=64 and 128 run the
// persistent flash_group_fwd): Q, K and V tiles of D (Tile<D>), K/V tiles in
// flight, and its shared memory: aligned Q, the K and V stages, then the
// full and empty barriers.  MLA's (192, 128) has a block of its own (MlaFwd,
// flash_mla_fwd below): three stages of its 48 KB K and 32 KB V tiles beside
// a 48 KB Q would take 289 KB, past the 227 KB a block may have.
template <int D, int Dv>
struct Fwd {
  using K = Tile<D>;
  using V = Tile<Dv>;
  static_assert(D == Dv, "(192, 128) is MlaFwd");
  static constexpr int kStages = 3;
  static constexpr int kSmem =
      kAlign + K::kTileBytes + kStages * (K::kTileBytes + V::kTileBytes) + 16 * kStages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the (D, Hkv, Skv, B) view into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int head, int key0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head), "r"(key0), "r"(batch)
      : "memory");
}

// 16 bytes from global to shared memory without a register; zeros past
// `bytes` (0 or 16).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle code.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The accumulator is written asynchronously: no read of it may move above
// the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B: A (64 x 16) and B (128 x 16) from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B: A (64 x 16) and B (64 x 16) from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B: A (64 x 16) and B (32 x 16) from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B: A (64 x 16) from registers, B (16 x 32) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B: A (64 x 16) from registers, B (16 x 64) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B: A (64 x 16) from registers, B (16 x 128) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B: A (64 x 16) from registers, B (16 x 192) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 3 and 4 order the two consumer warpgroups' products on the
// tensor cores: each issues its batch in its turn, then passes the turn, so
// one warpgroup's softmax runs under the other's products.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
}

// wgmma descriptors of a bf16 operand stored as rows of D in boxes of
// `box` bytes under Tile<D>'s swizzle: K-major when the reduction runs
// along D (a k-slice is 16 columns), MN-major when it runs down the rows (a
// k-slice is 16 rows; boxes across D `box` apart).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk, uint32_t box) {
  using T = Tile<D>;
  return smem_desc(tile + (16 * kk / T::kBoxCols) * box + (16 * kk % T::kBoxCols) * 2, 16,
                   8 * T::kSwizzle, T::kLayout);
}
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, uint32_t box) {
  using T = Tile<D>;
  return smem_desc(tile + 16 * kk * T::kSwizzle, box, 8 * T::kSwizzle, T::kLayout);
}

// Folded rows row0 .. row0 + n - 1 of a (B, S, H, D) bf16 tensor (row f:
// sequence f / g, head hk * g + f % g; g = 1 reads keys of kv head hk) by
// 16-byte cp.async from thread `tid` of `nthreads` into the swizzle TMA
// would give (16-byte chunk j of row r at j ^ (r % 8) for 128 bytes,
// j ^ (r / 2 % 4) for 64), boxes `box` bytes apart; zeros past `rows`.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, uint32_t box,
                                          const __nv_bfloat16* base, const long long (&st)[3],
                                          int b, int hk, int g, int row0, int n, int rows,
                                          int tid, int nthreads) {
  using T = Tile<D>;
  constexpr int kChunks = D / 8, kRowChunks = T::kSwizzle / 16;
  for (int idx = tid; idx < n * kChunks; idx += nthreads) {
    const int r = idx / kChunks, ch = idx % kChunks, f = row0 + r;
    const __nv_bfloat16* src = base;
    if (f < rows) {
      const int i = f / g, h = hk * g + f % g;
      src = base + b * st[0] + i * st[1] + h * st[2] + ch * 8;
    }
    const int j = ch % kRowChunks;
    const int swz = T::kSwizzle == 128 ? (r & 7) : ((r >> 1) & 3);
    cp_async16(dst + (ch / kRowChunks) * box + r * T::kSwizzle + (j ^ swz) * 16, src,
               f < rows ? 16 : 0);
  }
}

// The thread's cp.async copies have landed and are visible to wgmma.
__device__ __forceinline__ void cp_async_publish() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One consumer warpgroup's view of a block: its Q rows, the K/V ring, and
// this thread's two accumulator rows (r and r + 8 of the warpgroup's 64).
// Value i of an accumulator lies in row r + 8 * (i / 2 % 2), column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2.  Q and K have head dim D, V and
// the output Dv.
template <int D, int Dv>
struct Tc {
  using T = Tile<D>;
  using TV = Tile<Dv>;
  uint32_t q_wg, k_s, v_s;
  int lim[2];   // keys visible to each row: those below lim
  int min_lim;  // the least lim of the warpgroup's rows
  int lane;
  float c;      // D^-1/2 log2(e): p = 2^(s c - m c)

  // K-major operands (Q, K) and V as stored (MN-major), in boxes of 128 rows
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
    return desc_k<D>(tile, kk, T::kBoxBytes);
  }
  static __device__ __forceinline__ uint64_t vdesc(uint32_t tile, int kk) {
    return desc_mn<Dv>(tile, kk, TV::kBoxBytes);
  }

  // S = Q K^T of stage s
  __device__ __forceinline__ void issue_qk(float (&sc)[kKeys / 2], int s) const {
    const uint32_t k_t = k_s + s * T::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(sc, kmajor(q_wg, kk), kmajor(k_t, kk), kk > 0);
  }

  // O += P_hi V + P_lo V of stage s
  __device__ __forceinline__ void issue_pv(float (&acc)[Dv / 2], const uint32_t (&hi)[kKeys / 16][4],
                                           const uint32_t (&lo)[kKeys / 16][4], int s) const {
    const uint32_t v_t = v_s + s * TV::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) wgmma_rs(acc, hi[kk], vdesc(v_t, kk));
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) wgmma_rs(acc, lo[kk], vdesc(v_t, kk));
  }

  // The online-softmax step of the tile at key0 on raw scores: mask (only
  // where the tile holds an invisible key), update the row max m and this
  // thread's share of the row sum l, set alpha (the rescale of the
  // accumulator), and write p = hi + lo (both bf16) as A fragments:
  // register j of k-slice kk holds values 8kk + 2j and 8kk + 2j + 1.
  template <bool kMask>
  __device__ __forceinline__ void softmax(float (&sc)[kKeys / 2], float (&m)[2], float (&l)[2],
                                          float (&alpha)[2], uint32_t (&hi)[kKeys / 16][4],
                                          uint32_t (&lo)[kKeys / 16][4], int key0) const {
    // the row max and sum over 4 partial values each, to shorten the chains
    float mx[2][4], sum[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[h][u] = kNegInf, sum[h][u] = 0.f;
    int rel[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rel[h] = lim[h] - key0 - 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int h = i / 2 % 2;
      if (kMask && 8 * (i / 4) + i % 2 >= rel[h]) sc[i] = kNegInf;
      mx[h][i / 4 % 4] = fmaxf(mx[h][i / 4 % 4], sc[i]);
    }
    float mc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[h], x);
      alpha[h] = exp2_approx((m[h] - m_new) * c);
      mc[h] = m_new * c;
      m[h] = m_new;
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j, h = j % 2;
        const float p0 = exp2_approx(fmaf(sc[i], c, -mc[h]));
        const float p1 = exp2_approx(fmaf(sc[i + 1], c, -mc[h]));
        sum[h][kk % 4] += p0 + p1;
        const uint32_t ph = bf16x2_bits(__floats2bfloat162_rn(p0, p1));
        hi[kk][j] = ph;  // its halves widen to f32 by a shift and a mask
        lo[kk][j] = bf16x2_bits(__floats2bfloat162_rn(p0 - __uint_as_float(ph << 16),
                                                      p1 - __uint_as_float(ph & 0xffff0000u)));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * alpha[h] + ((sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]));
    }
  }
};

template <int D, int Dv, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
                   const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                   const Params p) {
  using T = Tile<D>;
  using TV = Tile<Dv>;
  constexpr int kStages = Fwd<D, Dv>::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + T::kTileBytes;              // kStages K tiles
  const uint32_t v_s = k_s + kStages * T::kTileBytes;    // kStages V tiles
  const uint32_t full = v_s + kStages * TV::kTileBytes;  // kStages barriers, then
  const uint32_t empty = full + 8 * kStages;             // kStages more

  const int b = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const int rows = p.sq * p.g;  // < 2^23: the launch holds row tiles to 65535
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  int n_tiles = (p.skv + kKeys - 1) / kKeys;
  if (kCausal) {
    const int last_row = min(row0 + kRows, rows) - 1;
    n_tiles = min(n_tiles, (last_row / p.g + p.q_offset) / kKeys + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrival, plus the bytes
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: K and V tiles by TMA ------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);  // stage released
        mbar_expect_tx(full + 8 * s, T::kTileBytes + TV::kTileBytes);
#pragma unroll
        for (int i = 0; i < T::kBoxes; ++i) {
          tma_load(k_s + s * T::kTileBytes + i * T::kBoxBytes, &tmk, full + 8 * s,
                   i * T::kBoxCols, hk, t * kKeys, b);
        }
#pragma unroll
        for (int i = 0; i < TV::kBoxes; ++i) {
          tma_load(v_s + s * TV::kTileBytes + i * TV::kBoxBytes, &tmv, full + 8 * s,
                   i * TV::kBoxCols, hk, t * kKeys, b);
        }
      }
    }
  } else {
    // -- consumer c: folded rows row0 + 64c .. row0 + 64c + 63 -------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int wg_row0 = row0 + 64 * c;

    // Q, once, by cp.async into the swizzle TMA would give; zeros past the
    // last row
    load_rows<D>(q_s + 64 * c * T::kSwizzle, T::kBoxBytes, q, p.qs, b, hk, p.g, wg_row0, 64, rows,
                 tid, 128);
    cp_async_publish();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

    // this thread's rows of the accumulators: r and r + 8 of the warpgroup's 64;
    // a row sees keys below min(Skv, its position + 1) (causal) or Skv.
    // Rows past the end take the last row's position.
    const int r = 16 * warp + lane / 4;
    auto lim_of = [&](int f) {
      const int pos = min(f, rows - 1) / p.g + p.q_offset;
      return kCausal ? min(p.skv, pos + 1) : p.skv;
    };
    const Tc<D, Dv> tcx{q_s + 64 * c * T::kSwizzle, k_s, v_s,
                    {lim_of(wg_row0 + r), lim_of(wg_row0 + r + 8)}, lim_of(wg_row0), lane,
                    p.scale * 1.4426950408889634f};

    float acc[Dv / 2], sc[kKeys / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < Dv / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];  // p of the previous tile
    auto softmax = [&](int key0) {
      if (key0 + kKeys > tcx.min_lim) {
        tcx.template softmax<true>(sc, m, l, alpha, hi, lo, key0);
      } else {
        tcx.template softmax<false>(sc, m, l, alpha, hi, lo, key0);
      }
    };

    // Tile 0: S_0 and its softmax.  Tile t: P_{t-1} V_{t-1} and S_t in one
    // batch; then the softmax of S_t, and the accumulator rescaled.
    if (c == 1) turn_pass(1);  // warpgroup 0 takes the first turn
    mbar_wait(full, 0);
    turn_wait(c);
    wgmma_fence();
    tcx.issue_qk(sc, 0);
    wgmma_commit();
    turn_pass(c);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % kStages, prev = (t - 1) % kStages;
      mbar_wait(full + 8 * s, (t / kStages) & 1);
      turn_wait(c);
      wgmma_fence();
      tcx.issue_pv(acc, hi, lo, prev);
      tcx.issue_qk(sc, s);
      wgmma_commit();
      turn_pass(c);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);  // this warp is done with the stage
      softmax(t * kKeys);
#pragma unroll
      for (int i = 0; i < Dv / 2; ++i) acc[i] *= alpha[i / 2 % 2];
    }
    turn_wait(c);
    wgmma_fence();
    tcx.issue_pv(acc, hi, lo, (n_tiles - 1) % kStages);
    wgmma_commit();
    if (c == 0) turn_pass(c);  // the last turn of warpgroup 1 has no taker
    wgmma_wait<0>();
    fence_regs(acc);

    // out = acc / max(l, 1e-37), rounded once to bf16; rows past Sq * G unstored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int f = wg_row0 + r + 8 * h;
      if (f >= rows) continue;
      const int qi = f / p.g, head = hk * p.g + f % p.g;
      __nv_bfloat16* orow = o + b * p.os[0] + qi * p.os[1] + head * p.os[2] + 2 * (lane % 4);
      const float inv = 1.f / fmaxf(l[h], 1e-37f);
#pragma unroll
      for (int j = 0; j < Dv / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
      // m is a max of raw q . k: scaled here, as the exponent scales it
      if (p.lse != nullptr && lane % 4 == 0) store_lse(p, b, qi, head, m[h] * p.scale, l[h]);
    }
  }
}

// -- MLA's (192, 128): a persistent block over work items ------------------------
//
// MLA decompresses one K and V per head (G = 1) and builds the 192-wide q
// and k from two parts: nope (128) and rope (64), where k's rope part is one
// channel shared by every head.  flash_mla_fwd reads them where MLA makes
// them: box 0-1 of a Q or K tile (64 columns each, Tile<192>) come from the
// nope tensor's TMA map and box 2 from the rope tensor's, at head 0 of a
// rope tensor with one head.  The contiguous 192-wide form is the same
// kernel on views.
//
// One block per SM walks a fixed list of work items (batch * head, tile of
// 128 query rows): chunks of `chunk` heads, in a chunk every head's heaviest
// row tile first, then the next.  Block j takes items j, j + grid, ...; the
// host picks the chunk that balances the blocks' causal work (work_chunk), and
// the heads of a chunk run together, so their K and V come from L2: one
// block per (head, row tile) in head-fastest order read each head's K and V
// once per row tile from device memory (about 1.5 GB at the prefill shape,
// 2.4x the bytes the function moves).  The producer's TMA ring runs on
// across items: K and V have their own stages and barriers, so K of tile
// t + 1 loads once S = Q K^T of tile t is done, while P V of tile t still
// reads V_t.  Q has its own full/empty pair: the producer loads the next
// item's Q once both consumers have issued their last Q K^T, so that load
// and the next item's first K tiles run under this item's last softmax, its
// P V and its O store.  Per item the consumers run tc::flash_attention_tc's
// loop (ping-pong on the tensor cores, P in two bf16 parts, the mask only
// where a tile holds an invisible key): the same arithmetic, the same bits.
struct MlaFwd {
  using K = Tile<192>;
  using V = Tile<128>;
  static constexpr int kStages = 2;  // K tiles in flight, and V tiles
  // aligned Q, the K and V rings, then the full and empty barriers of each K
  // and V stage and of Q: 214,096 B
  static constexpr int kSmem =
      kAlign + K::kTileBytes + kStages * (K::kTileBytes + V::kTileBytes) + 8 * (4 * kStages + 2);
};

struct MlaParams {
  int heads, rope_heads, sq, skv, q_offset;
  int n_rt, n_bh, chunk, n_items;  // row tiles a head, batch * heads, the work list
  float scale;
  long long os[3];  // o's element strides of (batch, seq, head)
  float* lse;       // (batch, heads, sq) f32, or null
};

// Work item `item`: batch * head `bh` and its row tile's first row and key
// tiles (the causal ones up to the last that its last row sees).
struct MlaItem {
  int b, h, row0, n_tiles;
};

template <bool kCausal>
__device__ __forceinline__ MlaItem mla_item(const MlaParams& p, int item) {
  const int per = p.chunk * p.n_rt;  // items of a whole chunk
  const int c = item / per, j = item % per;
  const int heads = min(p.chunk, p.n_bh - c * p.chunk);  // the last chunk may hold fewer
  const int bh = c * p.chunk + j % heads;
  MlaItem it;
  it.b = bh / p.heads;
  it.h = bh % p.heads;
  it.row0 = (p.n_rt - 1 - j / heads) * kRows;  // heaviest first
  it.n_tiles = (p.skv + kKeys - 1) / kKeys;
  if (kCausal) {
    const int last_row = min(it.row0 + kRows, p.sq) - 1;
    it.n_tiles = min(it.n_tiles, (last_row + p.q_offset) / kKeys + 1);
  }
  return it;
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_mla_fwd(const __grid_constant__ CUtensorMap tmqn, const __grid_constant__ CUtensorMap tmqr,
              const __grid_constant__ CUtensorMap tmkn, const __grid_constant__ CUtensorMap tmkr,
              const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
              const MlaParams p) {
  using T = MlaFwd::K;
  using TV = MlaFwd::V;
  constexpr int kStages = MlaFwd::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + T::kTileBytes;              // kStages K tiles
  const uint32_t v_s = k_s + kStages * T::kTileBytes;    // kStages V tiles
  const uint32_t k_full = v_s + kStages * TV::kTileBytes;
  const uint32_t k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;
  const uint32_t q_full = v_empty + 8 * kStages, q_empty = q_full + 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);   // the producer's arrival, plus the bytes
      mbar_init(k_empty + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 8);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: per item Q, then K_0, (K_u, V_{u-1}) for u >= 1, V_{n-1} ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int done = 0;  // K and V tiles loaded before this item (as many of each)
      for (int ic = 0; blockIdx.x + ic * gridDim.x < p.n_items; ++ic) {
        const MlaItem it = mla_item<kCausal>(p, blockIdx.x + ic * gridDim.x);
        // two boxes of the nope map, then one of the rope map
        auto load3 = [&](uint32_t dst, const CUtensorMap* nope, const CUtensorMap* rope,
                         uint32_t bar, int row, int head_rope) {
          tma_load(dst, nope, bar, 0, it.h, row, it.b);
          tma_load(dst + T::kBoxBytes, nope, bar, T::kBoxCols, it.h, row, it.b);
          tma_load(dst + 2 * T::kBoxBytes, rope, bar, 0, head_rope, row, it.b);
        };
        auto load_k = [&](int t) {
          const int s = (done + t) % kStages;
          mbar_wait(k_empty + 8 * s, (((done + t) / kStages) & 1) ^ 1);  // stage released
          mbar_expect_tx(k_full + 8 * s, T::kTileBytes);
          load3(k_s + s * T::kTileBytes, &tmkn, &tmkr, k_full + 8 * s, t * kKeys,
                p.rope_heads == 1 ? 0 : it.h);
        };
        auto load_v = [&](int t) {
          const int s = (done + t) % kStages;
          mbar_wait(v_empty + 8 * s, (((done + t) / kStages) & 1) ^ 1);
          mbar_expect_tx(v_full + 8 * s, TV::kTileBytes);
#pragma unroll
          for (int i = 0; i < TV::kBoxes; ++i) {
            tma_load(v_s + s * TV::kTileBytes + i * TV::kBoxBytes, &tmv, v_full + 8 * s,
                     i * TV::kBoxCols, it.h, t * kKeys, it.b);
          }
        };
        mbar_wait(q_empty, (ic & 1) ^ 1);  // the previous item's last Q K^T is done
        mbar_expect_tx(q_full, T::kTileBytes);
        load3(q_s, &tmqn, &tmqr, q_full, it.row0, it.h);
        load_k(0);
        for (int t = 1; t < it.n_tiles; ++t) {
          load_k(t);
          load_v(t - 1);
        }
        load_v(it.n_tiles - 1);
        done += it.n_tiles;
      }
    }
  } else {
    // -- consumer c: rows row0 + 64c .. row0 + 64c + 63 of each item ---------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r = 16 * warp + lane / 4;  // this thread's rows r and r + 8 of the 64
    // K and V tiles taken before this item (an item takes as many of each:
    // tile t of the item is K and V number done + t, stage (done + t) % 2)
    int done = 0;
    for (int ic = 0; blockIdx.x + ic * gridDim.x < p.n_items; ++ic) {
      int n_tiles, wg_row0;
      {
        const MlaItem it = mla_item<kCausal>(p, blockIdx.x + ic * gridDim.x);
        n_tiles = it.n_tiles;
        wg_row0 = it.row0 + 64 * c;
      }
      // a row sees keys below min(Skv, its position + 1) (causal) or Skv; rows
      // past the end take the last row's position
      auto lim_of = [&](int f) {
        const int pos = min(f, p.sq - 1) + p.q_offset;
        return kCausal ? min(p.skv, pos + 1) : p.skv;
      };
      const Tc<192, 128> tcx{q_s + 64 * c * T::kSwizzle, k_s, v_s,
                             {lim_of(wg_row0 + r), lim_of(wg_row0 + r + 8)}, lim_of(wg_row0),
                             lane, p.scale * 1.4426950408889634f};
      float acc[64], sc[kKeys / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];  // p of the previous tile
      auto softmax = [&](int key0) {
        if (key0 + kKeys > tcx.min_lim) {
          tcx.template softmax<true>(sc, m, l, alpha, hi, lo, key0);
        } else {
          tcx.template softmax<false>(sc, m, l, alpha, hi, lo, key0);
        }
      };
      auto stage = [&](int i) { return (done + i) % kStages; };
      auto parity = [&](int i) { return static_cast<uint32_t>((done + i) / kStages) & 1; };

      mbar_wait(q_full, ic & 1);
      if (c == 1) turn_pass(1);  // warpgroup 0 takes the first turn
      // Tile 0: S_0 and its softmax.  Tile t: P_{t-1} V_{t-1} and S_t in one
      // batch; then the softmax of S_t, and the accumulator rescaled.
      mbar_wait(k_full + 8 * stage(0), parity(0));
      turn_wait(c);
      wgmma_fence();
      tcx.issue_qk(sc, stage(0));
      wgmma_commit();
      turn_pass(c);
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * stage(0));     // this warp is done with K_0
        if (n_tiles == 1) mbar_arrive(q_empty);  // and with Q
      }
      softmax(0);
      for (int t = 1; t < n_tiles; ++t) {
        mbar_wait(v_full + 8 * stage(t - 1), parity(t - 1));
        mbar_wait(k_full + 8 * stage(t), parity(t));
        turn_wait(c);
        wgmma_fence();
        tcx.issue_pv(acc, hi, lo, stage(t - 1));
        tcx.issue_qk(sc, stage(t));
        wgmma_commit();
        turn_pass(c);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(sc);
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * stage(t));
          mbar_arrive(v_empty + 8 * stage(t - 1));
          if (t == n_tiles - 1) mbar_arrive(q_empty);
        }
        softmax(t * kKeys);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] *= alpha[i / 2 % 2];
      }
      mbar_wait(v_full + 8 * stage(n_tiles - 1), parity(n_tiles - 1));
      turn_wait(c);
      wgmma_fence();
      tcx.issue_pv(acc, hi, lo, stage(n_tiles - 1));
      wgmma_commit();
      if (c == 0) turn_pass(c);  // the last turn of warpgroup 1 has no taker
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(v_empty + 8 * stage(n_tiles - 1));
      done += n_tiles;

      // out = acc / max(l, 1e-37), rounded once to bf16; rows past Sq unstored.
      // The item's batch and head, decoded again here, are not held in
      // registers across its loop.
      const MlaItem it = mla_item<kCausal>(p, blockIdx.x + ic * gridDim.x);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int qi = it.row0 + 64 * c + r + 8 * h;
        if (qi >= p.sq) continue;
        __nv_bfloat16* orow =
            o + it.b * p.os[0] + qi * p.os[1] + it.h * p.os[2] + 2 * (lane % 4);
        const float inv = 1.f / fmaxf(l[h], 1e-37f);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
        }
        // m is a max of raw q . k: scaled here, as the exponent scales it
        if (p.lse != nullptr && lane % 4 == 0) {
          p.lse[(static_cast<long long>(it.b) * p.heads + it.h) * p.sq + qi] =
              m[h] * p.scale + logf(l[h]);
        }
      }
    }
  }
}

}  // namespace tc

// -- backward: CUDA cores ----------------------------------------------------------
//
// The gradient of the forward above, which the reference takes by autodiff
// of its chunked flash_attention (it has no Pallas backward).  With P the
// softmax probabilities recomputed from q . k and the forward's lse:
//   delta = rowsum(dO o O)         (f32, one warp per row: flash_bwd_delta)
//   dV = P^T dO,  dS = P o (dO V^T - delta),  dK = scale dS^T Q
//                                   (flash_bwd_dkdv: one block per (batch *
//                                    kv head, tile of 64 keys))
//   dQ = scale dS K                 (flash_bwd_dq: one block per (batch * kv
//                                    head, tile of 64 folded rows))
// No atomics: a dkdv block loops over every folded row tile (all G query
// heads of its group, read in place through the strides) that sees its keys
// and writes its dK and dV rows once; a dq block loops over the key tiles
// its rows see and writes its dQ rows once.  So two calls give the same bits.
//
// What bounds it on this card: operations.  Its bound takes the tensor
// cores' 989 TFLOP/s: five products of 2 D flops per visible (query, key)
// pair and query head, seven executed (dq recomputes S and dP); at Dv != D
// the products over V, dO and dV take 2 Dv.  This body
// serves f32 on the CUDA cores (67 TFLOP/s); bf16 goes to the tensor cores
// (namespace tcb below).  The design keeps every operand of a tile in shared
// memory as f32 rows of D + 1 (Q, K) or Dv + 1 (dO, V) words, so that each
// inner product reads one
// word per lane from distinct banks: thread (ty, tx) of 16 x 16 owns score
// rows tx + 16a and keys ty + 16b (a, b < 4), and output rows ty + 16b,
// columns tx + 16c.

namespace bwd {

constexpr int kRows = 64;      // folded query rows per tile
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kDeltaRows = kThreads / 32;  // delta pass: one warp per row

struct Params {
  int batch, sq, skv, g, hkv, q_offset;
  float scale;
  // element strides of (batch, seq, head): q k v o dout dq dk dv
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  // bf16 body at (192, 128): q's and k's rope parts, read apart from their
  // nope parts (qs, ks); k's has rope_heads heads, 1 (krs[2] = 0: one rope
  // channel serves every head) or hkv
  long long qrs[3], krs[3];
  int rope_heads;
  const float* lse;  // (batch, hq, sq), the forward's
  // f32 body: (batch, hq, sq), written by flash_bwd_delta.  bf16 body: two
  // planes of (batch * hkv, rows_pad) f32, lse * log2(e) then delta, each
  // row tile of tile_rows folded rows in kTileSlots slots (zeros past its
  // rows and past sq * g; flash_bwd_delta<..., true>)
  float* delta;
  int rows_pad;   // bf16 body: slots per (batch, kv head) of the planes
  int tile_rows;  // bf16 body: folded rows of a row tile, g * (kTileSlots / g)
};

constexpr int kTileSlots = 64;  // bf16 body: slots of a row tile (tcb::kRows)

// The slot of folded row f in the bf16 body's planes.
__device__ __forceinline__ int slot_of(const Params& p, int f) {
  return f / p.tile_rows * kTileSlots + f % p.tile_rows;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// K and Q * scale in rows of D + 1, V and dO in rows of Dv + 1
template <int D, int Dv>
constexpr int smem_floats_dkdv() {  // K, V, Q * scale, dO, P, dS, lse, delta
  return (kKeys + kRows) * (D + Dv + 2) + 2 * kRows * (kKeys + 1) + 2 * kRows;
}
template <int D, int Dv>
constexpr int smem_floats_dq() {  // Q * scale, dO, K, V, dS, lse, delta
  return (kRows + kKeys) * (D + Dv + 2) + kRows * (kKeys + 1) + 2 * kRows;
}

// delta of each (batch, query, head) row: sum over the Dv columns of dO * O,
// in f32, one warp per row.  kFolded (the bf16 body): one warp per slot of the two
// planes of p.delta, writing its folded row's lse * log2(e) and delta (zeros
// for slots that hold no row).
template <typename T, int Dv, bool kFolded>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, const Params p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, hq = p.g * p.hkv;
  const long long row = static_cast<long long>(blockIdx.x) * kDeltaRows + warp;
  const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
  int b, h;
  long long i;
  if constexpr (kFolded) {
    if (row >= plane) return;  // the whole warp leaves together
    const int slot = static_cast<int>(row % p.rows_pad), bh = static_cast<int>(row / p.rows_pad);
    const int f = slot / kTileSlots * p.tile_rows + slot % kTileSlots;
    if (slot % kTileSlots >= p.tile_rows || f >= p.sq * p.g) {
      if (lane == 0) p.delta[row] = 0.f, p.delta[plane + row] = 0.f;
      return;
    }
    b = bh / p.hkv;
    i = f / p.g;
    h = bh % p.hkv * p.g + f % p.g;
  } else {
    const long long per_batch = static_cast<long long>(p.sq) * hq;  // head fastest
    if (row >= per_batch * p.batch) return;  // the whole warp leaves together
    b = static_cast<int>(row / per_batch);
    i = row % per_batch / hq;
    h = static_cast<int>(row % hq);
  }
  const T* orow = o + b * p.os[0] + i * p.os[1] + h * p.os[2];
  const T* drow = dout + b * p.dos[0] + i * p.dos[1] + h * p.dos[2];
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < Dv; c += 32) acc = fmaf(to_f(drow[c]), to_f(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  const long long at = (static_cast<long long>(b) * hq + h) * p.sq + i;
  if constexpr (kFolded) {
    p.delta[row] = p.lse[at] * 1.4426950408889634f;
    p.delta[plane + row] = acc;
  } else {
    p.delta[at] = acc;
  }
}

// The bf16 body's delta pass at MLA's (192, 128), G = 1 (a folded row is a
// query, a row tile of 64 its 64 slots): the planes of flash_bwd_delta<bf16,
// 128, true>, with each row's 128 columns of dO and O read as 16 threads of
// 16 bytes (two rows a warp) where flash_bwd_delta reads them 2 bytes a lane
// (a row a warp); each thread sums its 8 products, then the 16 threads.
constexpr int kMlaDeltaRows = kThreads / 16;  // rows a block

__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_mla(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    const Params p) {
  const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
  const long long row = static_cast<long long>(blockIdx.x) * kMlaDeltaRows + threadIdx.x / 16;
  const int part = threadIdx.x % 16;  // columns 8 part .. 8 part + 7
  if (row >= plane) return;  // the row's 16 threads leave together
  const int i = static_cast<int>(row % p.rows_pad), bh = static_cast<int>(row / p.rows_pad);
  const int b = bh / p.hkv, h = bh % p.hkv;
  float acc = 0.f;
  if (i < p.sq) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + b * p.os[0] + i * p.os[1] + h * p.os[2] +
                                                    8 * part);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + b * p.dos[0] + i * p.dos[1] +
                                                    h * p.dos[2] + 8 * part);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 widens to f32 by a shift or a mask
      acc = fmaf(__uint_as_float(ys[j] << 16), __uint_as_float(xs[j] << 16), acc);
      acc = fmaf(__uint_as_float(ys[j] & 0xffff0000u), __uint_as_float(xs[j] & 0xffff0000u), acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off, 16);
  if (part != 0) return;
  const bool real = i < p.sq;  // slots past the queries hold zeros
  p.delta[row] = real ? p.lse[(static_cast<long long>(b) * p.hkv + h) * p.sq + i] * 1.4426950408889634f
                      : 0.f;
  p.delta[plane + row] = real ? acc : 0.f;
}

// The bf16 body's delta pass at Dv = 64 and 128 (before the persistent
// tcb::flash_bwd_d64 and flash_bwd_d128): the planes of flash_bwd_delta<bf16,
// Dv, true> and its sums in its order, four threads a row reading 16 bytes
// at a time where it reads 2 bytes a lane, a row a warp (a large share of
// the backward at the causal training shapes on an H100, once dK/dV and dQ
// ran in one launch).  flash_bwd_delta's lane c (of 32) sums columns c, c +
// 32, ... (Dv / 32 of them) by a chain of fma from 0; then the xor tree
// leaves lane 0 with the sum of v_c + v_{c+16} (level 16), of those values c
// and c + 8 (level 8), and so on.  Here thread j of a row holds columns 32i
// + 8j .. 32i + 8j + 7 (i < Dv / 32): its v_c for c = 8j + e in register e,
// chained over i in the same order.  Level 16 adds thread j + 2's registers
// to thread j's (j < 2), level 8 thread 1's to thread 0's, levels 4, 2 and 1
// run in thread 0's registers: the same additions of the same values.  Block
// 0 also zeroes the persistent kernel's work counter, which runs next on the
// stream.
constexpr int kVecDeltaRows = kThreads / 4;  // rows a block

template <int Dv>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_vec(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    const Params p, int* __restrict__ counter) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *counter = 0;
  const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
  const long long row = static_cast<long long>(blockIdx.x) * kVecDeltaRows + threadIdx.x / 4;
  const int j = threadIdx.x % 4;  // 16-byte chunks j, j + 4, ... of the row
  const int slot = static_cast<int>(row % p.rows_pad), bh = static_cast<int>(row / p.rows_pad);
  const int f = slot / kTileSlots * p.tile_rows + slot % kTileSlots;
  const bool real = row < plane && slot % kTileSlots < p.tile_rows && f < p.sq * p.g;
  const int b = bh / p.hkv, i = f / p.g, h = bh % p.hkv * p.g + f % p.g;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (real) {
    const __nv_bfloat16* orow = o + b * p.os[0] + i * p.os[1] + h * p.os[2] + 8 * j;
    const __nv_bfloat16* drow = dout + b * p.dos[0] + i * p.dos[1] + h * p.dos[2] + 8 * j;
#pragma unroll
    for (int part = 0; part < Dv / 32; ++part) {
      const uint4 ox = *reinterpret_cast<const uint4*>(orow + 32 * part);
      const uint4 dx = *reinterpret_cast<const uint4*>(drow + 32 * part);
      const uint32_t os[4] = {ox.x, ox.y, ox.z, ox.w}, ds[4] = {dx.x, dx.y, dx.z, dx.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // a bf16 widens to f32 by a shift (even e) or a mask
        auto wide = [&](uint32_t x) {
          return __uint_as_float(e % 2 == 0 ? x << 16 : x & 0xffff0000u);
        };
        v[e] = fmaf(wide(ds[e / 2]), wide(os[e / 2]), v[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] += __shfl_down_sync(0xffffffffu, v[e], 2, 4);  // level 16
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] += __shfl_down_sync(0xffffffffu, v[e], 1, 4);  // level 8
  if (j != 0 || row >= plane) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] += v[e + 4];  // level 4
  v[0] += v[2];  // level 2
  v[1] += v[3];
  v[0] += v[1];  // level 1
  p.delta[row] = real ? p.lse[(static_cast<long long>(b) * p.hkv * p.g + h) * p.sq + i] *
                            1.4426950408889634f
                      : 0.f;
  p.delta[plane + row] = real ? v[0] : 0.f;
}

// Folded rows row0 .. row0 + kRows - 1 of a (B, S, H, D) tensor (row f:
// sequence f / G, head hk * G + f % G) as f32 rows of D + 1, times mul;
// zeros past `rows`.  D is the tensor's head dim: D for q, Dv for dout.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* base, const long long (&st)[3],
                                          int b, int hk, int g, long long row0, long long rows,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const long long f = row0 + r;
    float x = 0.f;
    if (f < rows) {
      const long long i = f / g;
      const int h = hk * g + static_cast<int>(f % g);
      x = to_f(base[b * st[0] + i * st[1] + h * st[2] + c]) * mul;
    }
    dst[r * (D + 1) + c] = x;
  }
}

// lse and delta of the same folded rows (zeros past `rows`).
__device__ __forceinline__ void load_stats(float* lse_s, float* del_s, const Params& p, int b,
                                           int hk, long long row0, long long rows) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const long long f = row0 + r;
    float l = 0.f, dl = 0.f;
    if (f < rows) {
      const long long i = f / p.g;
      const int h = hk * p.g + static_cast<int>(f % p.g);
      const long long at = (static_cast<long long>(b) * p.hkv * p.g + h) * p.sq + i;
      l = p.lse[at];
      dl = p.delta[at];
    }
    lse_s[r] = l;
    del_s[r] = dl;
  }
}

// Keys key0 .. key0 + kKeys - 1 of one (batch, kv head) as f32 rows of
// D + 1; zeros past skv.
template <typename T, int D>
__device__ __forceinline__ void load_keys(float* dst, const T* base, long long key_stride,
                                          int key0, int skv) {
  for (int idx = threadIdx.x; idx < kKeys * D; idx += kThreads) {
    const int j = idx / D, c = idx % D, key = key0 + j;
    dst[j * (D + 1) + c] = key < skv ? to_f(base[key * key_stride + c]) : 0.f;
  }
}

// This thread's 4 x 4 of S = (Q * scale) K^T (over D) and dP = dO V^T (over
// Dv) (rows tx + 16a, keys ty + 16b), then P = exp(S - lse) where the key is
// visible to the row (else 0) in s, and dS = P (dP - delta) in dp.
template <int D, int Dv, bool kCausal>
__device__ __forceinline__ void probabilities(const float* qs, const float* dos, const float* ks,
                                              const float* vs, const float* lse_s,
                                              const float* del_s, const Params& p, long long row0,
                                              long long rows, int key0, int tx, int ty,
                                              float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f, dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = qs[(tx + 16 * a) * (D + 1) + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) kb[b] = ks[(ty + 16 * b) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
  }
#pragma unroll 4
  for (int d = 0; d < Dv; ++d) {
    float oa[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) oa[a] = dos[(tx + 16 * a) * (Dv + 1) + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) vb[b] = vs[(ty + 16 * b) * (Dv + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long f = row0 + tx + 16 * a;
    const int pos = static_cast<int>((f < rows ? f : rows - 1) / p.g) + p.q_offset;
    const float lse = lse_s[tx + 16 * a], delta = del_s[tx + 16 * a];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int key = key0 + ty + 16 * b;
      const bool visible = f < rows && key < p.skv && (!kCausal || key <= pos);
      const float pr = visible ? expf(s[a][b] - lse) : 0.f;
      s[a][b] = pr;
      dp[a][b] = pr * (dp[a][b] - delta);
    }
  }
}

template <typename T, int D, int Dv, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
               const Params p) {
  constexpr int kP = D + 1, kPv = Dv + 1, kS = kKeys + 1, kC = D / 16, kCv = Dv / 16;
  extern __shared__ float4 smem4[];
  float* ks_ = reinterpret_cast<float*>(smem4);  // [kKeys][kP]
  float* vs_ = ks_ + kKeys * kP;                  // [kKeys][kPv]
  float* qs_ = vs_ + kKeys * kPv;                 // [kRows][kP] q * scale
  float* dos_ = qs_ + kRows * kP;                 // [kRows][kPv]
  float* ps_ = dos_ + kRows * kPv;                // [kRows][kS] P
  float* dss_ = ps_ + kRows * kS;                 // [kRows][kS] dS
  float* lse_s = dss_ + kRows * kS;
  float* del_s = lse_s + kRows;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const int key0 = blockIdx.y * kKeys;  // the heaviest (causal) tiles come first
  const long long rows = static_cast<long long>(p.sq) * p.g;
  load_keys<T, D>(ks_, k + bi * p.ks[0] + hk * p.ks[2], p.ks[1], key0, p.skv);
  load_keys<T, Dv>(vs_, v + bi * p.vs[0] + hk * p.vs[2], p.vs[1], key0, p.skv);

  // causal: the first folded row whose position reaches key0
  const long long first = kCausal ? static_cast<long long>(max(key0 - p.q_offset, 0)) * p.g : 0;
  const long long n_tiles = (rows + kRows - 1) / kRows;
  float dkv[4][kC], dvv[4][kCv];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int c = 0; c < kC; ++c) dkv[b][c] = 0.f;
#pragma unroll
    for (int c = 0; c < kCv; ++c) dvv[b][c] = 0.f;
  }

  for (long long t = first / kRows; t < n_tiles; ++t) {
    const long long row0 = t * kRows;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(qs_, q, p.qs, bi, hk, p.g, row0, rows, p.scale);
    load_rows<T, Dv>(dos_, dout, p.dos, bi, hk, p.g, row0, rows, 1.f);
    load_stats(lse_s, del_s, p, bi, hk, row0, rows);
    __syncthreads();
    float s[4][4], dp[4][4];
    probabilities<D, Dv, kCausal>(qs_, dos_, ks_, vs_, lse_s, del_s, p, row0, rows, key0, tx, ty,
                                  s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        ps_[(tx + 16 * a) * kS + ty + 16 * b] = s[a][b];
        dss_[(tx + 16 * a) * kS + ty + 16 * b] = dp[a][b];
      }
    __syncthreads();
    // dV += P^T dO, dK += dS^T (Q * scale) over the tile's rows, in order
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      float pb[4], sb[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        pb[b] = ps_[r * kS + ty + 16 * b];
        sb[b] = dss_[r * kS + ty + 16 * b];
      }
#pragma unroll
      for (int c = 0; c < kCv; ++c) {
        const float o = dos_[r * kPv + tx + 16 * c];
#pragma unroll
        for (int b = 0; b < 4; ++b) dvv[b][c] = fmaf(pb[b], o, dvv[b][c]);
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float qv = qs_[r * kP + tx + 16 * c];
#pragma unroll
        for (int b = 0; b < 4; ++b) dkv[b][c] = fmaf(sb[b], qv, dkv[b][c]);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int key = key0 + ty + 16 * b;
    if (key >= p.skv) continue;
    T* krow = dk + bi * p.dks[0] + key * p.dks[1] + hk * p.dks[2];
    T* vrow = dv + bi * p.dvs[0] + key * p.dvs[1] + hk * p.dvs[2];
#pragma unroll
    for (int c = 0; c < kC; ++c) put(krow + tx + 16 * c, dkv[b][c]);
#pragma unroll
    for (int c = 0; c < kCv; ++c) put(vrow + tx + 16 * c, dvv[b][c]);
  }
}

template <typename T, int D, int Dv, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, T* __restrict__ dq, const Params p) {
  constexpr int kP = D + 1, kPv = Dv + 1, kS = kKeys + 1, kC = D / 16;
  extern __shared__ float4 smem4[];
  float* qs_ = reinterpret_cast<float*>(smem4);  // [kRows][kP] q * scale
  float* dos_ = qs_ + kRows * kP;                 // [kRows][kPv]
  float* ks_ = dos_ + kRows * kPv;                // [kKeys][kP]
  float* vs_ = ks_ + kKeys * kP;                  // [kKeys][kPv]
  float* dss_ = vs_ + kKeys * kPv;                // [kRows][kS] dS
  float* lse_s = dss_ + kRows * kS;
  float* del_s = lse_s + kRows;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const long long rows = static_cast<long long>(p.sq) * p.g;
  const long long row0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  load_rows<T, D>(qs_, q, p.qs, bi, hk, p.g, row0, rows, p.scale);
  load_rows<T, Dv>(dos_, dout, p.dos, bi, hk, p.g, row0, rows, 1.f);
  load_stats(lse_s, del_s, p, bi, hk, row0, rows);
  int n_tiles = (p.skv + kKeys - 1) / kKeys;
  if (kCausal) {
    const long long last_row = (row0 + kRows < rows ? row0 + kRows : rows) - 1;
    n_tiles = min(n_tiles, static_cast<int>(last_row / p.g + p.q_offset) / kKeys + 1);
  }
  const T* kb = k + bi * p.ks[0] + hk * p.ks[2];
  const T* vb = v + bi * p.vs[0] + hk * p.vs[2];

  float dqv[4][kC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) dqv[a][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();  // the previous tile's readers are done
    load_keys<T, D>(ks_, kb, p.ks[1], key0, p.skv);
    load_keys<T, Dv>(vs_, vb, p.vs[1], key0, p.skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    probabilities<D, Dv, kCausal>(qs_, dos_, ks_, vs_, lse_s, del_s, p, row0, rows, key0, tx, ty,
                                  s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dss_[(tx + 16 * a) * kS + ty + 16 * b] = dp[a][b];
    __syncthreads();
    // dQ += dS K over the tile's keys, in order (rows ty + 16a here)
#pragma unroll 2
    for (int j = 0; j < kKeys; ++j) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dss_[(ty + 16 * a) * kS + j];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float kv = ks_[j * kP + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) dqv[a][c] = fmaf(sa[a], kv, dqv[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long f = row0 + ty + 16 * a;
    if (f >= rows) continue;
    const long long i = f / p.g;
    const int h = hk * p.g + static_cast<int>(f % p.g);
    T* qrow = dq + bi * p.dqs[0] + i * p.dqs[1] + h * p.dqs[2];
#pragma unroll
    for (int c = 0; c < kC; ++c) put(qrow + tx + 16 * c, dqv[a][c] * p.scale);
  }
}

}  // namespace bwd

// -- backward, bf16: tensor cores -------------------------------------------------
//
// The same gradient as namespace bwd, on the tensor cores: wgmma with bf16
// operands and f32 accumulators, warp-specialised like the forward.  Its
// bound is the bf16 tensor-core rate (989 TFLOP/s); it executes ten
// products per visible pair where the bound counts five (dQ recomputes S
// and dP; dV, dK and dQ run twice, on the two bf16 parts of P and dS), plus
// the causal tiles' masked entries: 2.17x the counted flops at the
// training shape.
//
//  * A row tile is G * (64 / G) folded rows (f = query * G + head within
//    the kv group): whole query groups, all 64 when G divides 64.
//    flash_bwd_delta<bf16, D, true> writes lse * log2(e) and delta of every
//    folded row into two planes, a row tile in 64 slots (zeros past its
//    rows), so a tile finds its statistics in 256 contiguous bytes.
//  * flash_bwd_dkdv_tc: one block per (batch, kv head, pair of key tiles of
//    64).  Consumer warpgroup 0 owns key tile j, consumer 1 key tile
//    n - 1 - j (none if that is j or less): both read one stream of row
//    tiles, which starts where tile j's keys are first seen, so a Q/dO tile
//    loaded serves up to 128 keys, and under the causal mask every block
//    multiplies the same number of row tiles (68 at the training shape;
//    consumer 1 waits out the first ones).  K and V of a consumer's 64 keys
//    stay in shared memory (cp.async at the start).  The producer
//    warpgroup streams row tiles of Q and dO with their statistics through
//    kStages stages, one producer warp per stage, by TMA from a
//    (D, G, Hkv, S, B) view (64 / G queries of G heads are the tile's folded
//    rows in order; a shorter tile's last rows stay zero, written once) and
//    bulk copies: the GQA group is read in place through the strides, never
//    copied.  Loads bounded this kernel while threads issued them by
//    cp.async (PERF.md); TMA issues them from one lane per stage.  Per row
//    tile a consumer computes S^T = K Q^T
//    and dP^T = V dO^T (wgmma_ss, m64n64, K-major, D the reduction);
//    P^T = 2^(S^T c - lse log2 e) and dS^T = P^T (dP^T - delta) in f32
//    registers, masked only on tiles that hold an invisible pair; then
//    dV += P^T dO and dK += dS^T Q (wgmma_rs: P^T and dS^T from registers
//    as bf16 parts, as the forward's P; dO and Q MN-major, N = D).  The
//    loop over row tiles replaces the sum across blocks: no atomics.
//    Registers: the producer keeps 24, the consumers take 240 (dK and dV
//    128 accumulators at D=128, S^T and dP^T 64, the bf16 parts of P^T and
//    dS^T 64; flash_bwd_d128's dK/dV items keep this layout).
//  * flash_bwd_dkdv_mla at MLA's (192, 128), G = 1: dK (96 accumulators)
//    and dV (64) of 64 keys do not fit one consumer beside a row tile's
//    products; one block per key tile, whose consumers split the products
//    (tcb::MlaDkdv).  q and k are read as nope and rope parts.
//  * flash_bwd_dq_tc: one block per (batch * kv head, 128 folded rows),
//    heaviest first; Q and dO by cp.async once, K and V tiles of 128 keys
//    (64 at (192, 128), tcb::Dq) by TMA into a ring of two; per tile
//    S = Q K^T and dP = dO V^T (wgmma_ss, m64n128 or m64n64), dS in
//    registers, dQ += dS K (wgmma_rs on both parts of dS, K MN-major).
//    flash_bwd_dq_mla is the same at (192, 128) on q and k as nope and rope
//    parts, the row tiles of a head neighbouring blocks, so its K and V come
//    from L2.
//  * flash_bwd_dkdv_tc and flash_bwd_dq_tc serve D = Dv = 32 (the tests'
//    small configs).  At 64 and 128 both kinds of block are work items of
//    one persistent kernel, flash_bwd_d64 and flash_bwd_d128 (after the
//    persistent forward below), whose loops per item are these kernels',
//    after a delta pass of their own (flash_bwd_delta_vec).
//  * Precision: the products of bf16 operands are exact and summed in f32;
//    D^-1/2 scales the f32 score inside the exponent (c = D^-1/2 log2 e) and
//    dK, dQ in f32 at the end; P and dS are each split into hi = bf16(x)
//    and lo = bf16(x - hi), both multiplied in (hi + lo holds x to ~2^-16),
//    and each output is rounded once to bf16.  One bf16 rounding of P and
//    dS stays within kernel_tolerance(bf16) but put a form at 0.91 of the
//    limit on the card; the split keeps every form under half of it.  The
//    CPU test test_torch_flash_backward.py emulates this arithmetic against
//    the plain version.
//  * Deterministic: every sum runs in a fixed order in one block.

namespace tcb {

using tc::Tile;

constexpr int kKeys = 64;              // dK/dV: keys per consumer warpgroup (wgmma's M)
constexpr int kRows = bwd::kTileSlots; // dK/dV: rows of a streamed Q/dO tile (tile_rows used)
constexpr int kDqRows = tc::kRows;     // dQ: folded rows per block, 64 per consumer
constexpr int kThreads = 384;          // one producer and two consumer warpgroups
constexpr int kPad = 128;              // the statistics planes pad folded rows to this
static_assert(kPad % kRows == 0, "row tiles must not overrun the planes");

// Folded rows of a row tile: whole query groups of g heads (g <= kRows).
__host__ __device__ constexpr int tile_rows(int g) { return kRows / g * g; }

// Slots per (batch, kv head) of the statistics planes: kRows a row tile.
__host__ __device__ constexpr long long plane_slots(long long rows, int g) {
  return ((rows + tile_rows(g) - 1) / tile_rows(g) * kRows + kPad - 1) / kPad * kPad;
}

// The dK/dV block at (D, Dv): Q and K tiles of D, V and dO tiles of Dv, and
// its shared memory: aligned K and V of both consumers, kStages Q and dO
// tiles, their lse and delta, then the full and empty barriers.  kStages
// row tiles are in flight, one producer warp each.  It serves Dv = D; since
// PR 24 MLA's (192, 128) runs MlaDkdv / flash_bwd_dkdv_mla, and the Dv != D
// branches below (PR 23's three stages and two slices, which spilled) are
// built no more: the D = Dv kernels keep PR 23's code as it was.
template <int D, int Dv>
struct Dkdv {
  using TK = Tile<D>;
  using TV = Tile<Dv>;
  static_assert(TK::kSwizzle == TV::kSwizzle, "Q/K and V/dO share one swizzle");
  static constexpr int kStages = D == Dv ? 4 : 3;
  static_assert(kStages <= 4, "one producer warp per stage");
  // Row slices a consumer takes a Q/dO tile in (one at D = Dv)
  static constexpr int kSlices = D == Dv ? 1 : 2;
  static constexpr int kSliceRows = kRows / kSlices;
  static constexpr int kSliceK = kSliceRows / 16;  // k-slices of 16 rows in a slice
  static constexpr int kBox = kRows * TK::kSwizzle;  // one box of 64 rows
  static constexpr int kTileK = TK::kBoxes * kBox;   // 64 rows of D bf16 (K, Q)
  static constexpr int kTileV = TV::kBoxes * kBox;   // 64 rows of Dv bf16 (V, dO)
  static constexpr int kStats = 2 * kRows * 4;       // lse * log2 e and delta, f32
  static constexpr int kSmem = tc::kAlign + 2 * (kTileK + kTileV) +
                               kStages * (kTileK + kTileV + kStats) + 16 * kStages;
};

// dK/dV at MLA's (192, 128), G = 1 (flash_bwd_dkdv_mla): one block per
// (batch * head, key tile of 64), whose two consumers split the work by
// product instead of by keys.  Consumer 0 holds dV (64 accumulators a
// thread) and computes S^T = K Q^T, P^T and dV += P^T dO; consumer 1 holds
// dK (96) and computes dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK +=
// dS^T Q, taking P^T in f32 from consumer 0 through shared memory (each
// thread the values of its own accumulator positions: the two products'
// layouts are one).  A block that held dK and dV of 64 keys in each
// consumer (PR 23's pairs of key tiles) kept 160 accumulators a thread
// beside a row tile's S^T and dP^T and spilled in every arrangement tried;
// here the larger consumer keeps 96 + dP^T (32) + dS^T's parts (32).  A
// Q/dO row tile now serves 64 keys, not 128, and its loads come from L2:
// the key tiles of a head are neighbouring blocks, heaviest (key tile 0)
// first.  Shared memory: K and V of the 64 keys, four stages of a Q (192)
// and a dO (128) row tile of 64 with their statistics, P^T (f32), barriers.
struct MlaDkdv {
  using TK = Tile<192>;
  using TV = Tile<128>;
  static constexpr int kStages = 4;  // row tiles in flight, one producer warp each
  static constexpr int kBox = kRows * TK::kSwizzle;  // one box of 64 rows
  static constexpr int kTileK = TK::kBoxes * kBox;   // 64 rows of 192 (K, Q)
  static constexpr int kTileV = TV::kBoxes * kBox;   // 64 rows of 128 (V, dO)
  static constexpr int kStats = 2 * kRows * 4;       // lse * log2 e and delta, f32
  static constexpr int kPBytes = kKeys * kRows * 4;  // P^T of a row tile, f32
  static constexpr int kSmem = tc::kAlign + kTileK + kTileV +
                               kStages * (kTileK + kTileV + kStats) + kPBytes + 16 * kStages;
};

// The dQ block at (D, Dv): aligned Q (D) and dO (Dv) of 128 rows, kStages K
// (D) and V (Dv) tiles of kKeys keys, the full and empty barriers.  Where
// Dv = D the tiles are the forward's (128 keys, its TMA box).  At (192, 128)
// two stages of 128 keys would take 241 KB, past the 227 KB of a block, and
// the consumers' registers would hold dQ (96), S and dP (64 each) and dS's
// two bf16 parts (64): tiles of 64 keys halve S, dP and dS (161 KB).
template <int D, int Dv>
struct Dq {
  using TK = Tile<D>;
  using TV = Tile<Dv>;
  static_assert(TK::kSwizzle == TV::kSwizzle, "Q/K and V/dO share one swizzle");
  static constexpr int kKeys = D == Dv ? tc::kKeys : 64;
  static constexpr int kStages = 2;
  static constexpr int kKeyBox = kKeys * TK::kSwizzle;  // one box of kKeys rows
  static constexpr int kTileK = TK::kBoxes * kKeyBox;
  static constexpr int kTileV = TV::kBoxes * kKeyBox;
  static constexpr int kSmem = tc::kAlign + TK::kTileBytes + TV::kTileBytes +
                               kStages * (kTileK + kTileV) + 16 * kStages;
};

// One box of the (D, G, Hkv, S, B) view of q or dout into shared memory,
// counted on `bar`: 64 / G queries of G heads are tile_rows folded rows in
// order.
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int d0, int hk, int i0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(0), "r"(hk), "r"(i0),
      "r"(batch)
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// p = 2^(s c - lse2): the probability of raw score s, c = D^-1/2 log2(e),
// lse2 = lse log2(e).
__device__ __forceinline__ float prob(float s, float c, float lse2) {
  return tc::exp2_approx(fmaf(s, c, -lse2));
}

// (x, y) as two bf16x2 parts: hi = bf16(x, y), lo = bf16 of what hi misses;
// hi + lo holds each value to ~2^-16 of itself.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = tc::bf16x2_bits(__floats2bfloat162_rn(x, y));  // its halves widen by a shift and a mask
  lo = tc::bf16x2_bits(__floats2bfloat162_rn(x - __uint_as_float(hi << 16),
                                             y - __uint_as_float(hi & 0xffff0000u)));
}

// The first folded row that sees key `key` (rows if none): causal, the
// first whose position reaches it.
__device__ __forceinline__ int first_row(const bwd::Params& p, bool causal, int key) {
  return causal ? min(max(key - p.q_offset, 0), p.sq) * p.g : 0;
}

// The first row tile that sees key `key` (n_rt if none does).
__device__ __forceinline__ int first_tile(const bwd::Params& p, bool causal, int key, int n_rt) {
  const int f = first_row(p, causal, key);
  return f < p.sq * p.g ? f / p.tile_rows : n_rt;
}

// P^T and dS^T = P^T (dP^T - delta) of kK * 16 rows of a row tile (a
// slice), each split into two bf16 parts (hi, lo), as A fragments (register
// j of k-slice kk holds accumulator values 8kk + 2j and 8kk + 2j + 1, as in
// the forward).  Accumulator value i lies in key row r + 8 * (i / 2 % 2)
// and column (folded row of the slice) 8 * (i / 4) + 2 * (lane % 4) + i % 2.
// With kMask, a probability is kept where its column lies in [lo[h],
// hi_col) (relative to the thread's first column), else 0.
template <int kK>
struct Frags {
  uint32_t hi[kK][4], lo[kK][4];
};

template <bool kMask, int kK>
__device__ __forceinline__ void tile_grads(const float (&st)[8 * kK], const float (&dpt)[8 * kK],
                                           Frags<kK>& pf, Frags<kK>& dsf, const float* lse2,
                                           const float* dl, float c, int lane,
                                           const int (&lo)[2], int hi_col) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // columns 16kk + 8 half + 2 (lane % 4) + {0, 1}
      const int col = 16 * kk + 8 * half + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
      const float2 de = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * half + h, i = 8 * kk + 2 * j, e = 16 * kk + 8 * half;
        float p0 = prob(st[i], c, l2.x), p1 = prob(st[i + 1], c, l2.y);
        if (kMask) {
          p0 = e >= lo[h] && e < hi_col ? p0 : 0.f;
          p1 = e + 1 >= lo[h] && e + 1 < hi_col ? p1 : 0.f;
        }
        split_bf16(p0, p1, pf.hi[kk][j], pf.lo[kk][j]);
        split_bf16(p0 * (dpt[i] - de.x), p1 * (dpt[i + 1] - de.y), dsf.hi[kk][j], dsf.lo[kk][j]);
      }
    }
  }
}

template <int D, int Dv, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmdo, const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, const bwd::Params p) {
  using S = Dkdv<D, Dv>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t base = (raw + tc::kAlign - 1) & ~static_cast<uint32_t>(tc::kAlign - 1);
  const uint32_t k_s = base;                            // two K tiles (one per consumer)
  const uint32_t v_s = k_s + 2 * S::kTileK;             // two V tiles
  const uint32_t q_s = v_s + 2 * S::kTileV;             // kStages Q tiles
  const uint32_t do_s = q_s + kStages * S::kTileK;      // kStages dO tiles
  const uint32_t st_s = do_s + kStages * S::kTileV;     // kStages (lse2, delta) of 64 rows
  const uint32_t full = st_s + kStages * S::kStats;     // kStages barriers, then
  const uint32_t empty = full + 8 * kStages;            // kStages more
  const float* stats = reinterpret_cast<const float*>(smem_raw + (st_s - raw));

  const int b = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv, pair = blockIdx.y;
  const int rows = p.sq * p.g;  // < 2^23: the launch holds row tiles to 65535
  const int n_rt = (rows + p.tile_rows - 1) / p.tile_rows;
  const int n_kt = (p.skv + kKeys - 1) / kKeys;
  // the stream starts at the first row tile that sees consumer 0's keys,
  // the lower of the pair
  const int t0 = first_tile(p, kCausal, pair * kKeys, n_rt);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(full + 8 * s, 1);   // the producer's arrival, plus the bytes
      tc::mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.tile_rows < kRows) {
    // rows tile_rows .. kRows - 1 of every Q and dO stage: TMA never writes
    // them, so zeros once make them add nothing to dV and dK.  The stages'
    // boxes of 64 rows lie back to back from q_s: Q's, then dO's.
    constexpr int kChunks = S::TK::kSwizzle / 16;  // of 16 bytes in a row
    constexpr int kBoxesAll = kStages * (S::TK::kBoxes + S::TV::kBoxes);
    const int tail = (kRows - p.tile_rows) * kChunks;
    uint4* tiles = reinterpret_cast<uint4*>(smem_raw + (q_s - raw));
    for (int idx = threadIdx.x; idx < kBoxesAll * tail; idx += kThreads) {
      tiles[idx / tail * (S::kBox / 16) + p.tile_rows * kChunks + idx % tail] =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: warp w fills stage w with row tiles t0 + w, t0 + w + kStages, ...
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int w = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0 && w < kStages) {
      const float* stat = p.delta + static_cast<long long>(blockIdx.x) * p.rows_pad;
      const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
      for (int t = t0 + w, u = 0; t < n_rt; t += kStages, ++u) {
        tc::mbar_wait(empty + 8 * w, (u & 1) ^ 1);  // stage released
        tc::mbar_expect_tx(full + 8 * w, p.tile_rows * (D + Dv) * 2 + S::kStats);
        const int i0 = t * (p.tile_rows / p.g);
#pragma unroll
        for (int i = 0; i < S::TK::kBoxes; ++i) {
          tma_load_rows(q_s + w * S::kTileK + i * S::kBox, &tmq, full + 8 * w,
                        i * S::TK::kBoxCols, hk, i0, b);
        }
#pragma unroll
        for (int i = 0; i < S::TV::kBoxes; ++i) {
          tma_load_rows(do_s + w * S::kTileV + i * S::kBox, &tmdo, full + 8 * w,
                        i * S::TV::kBoxCols, hk, i0, b);
        }
        bulk_load(st_s + w * S::kStats, stat + t * kRows, kRows * 4, full + 8 * w);
        bulk_load(st_s + w * S::kStats + kRows * 4, stat + plane + t * kRows, kRows * 4,
                  full + 8 * w);
      }
    }
  } else {
    // -- consumer c: keys of tile j (c = 0) or n - 1 - j (c = 1) --------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int jt = c == 0 ? pair : n_kt - 1 - pair;
    const bool active = c == 0 || jt > pair;
    const int key0 = jt * kKeys;
    const uint32_t k_wg = k_s + c * S::kTileK, v_wg = v_s + c * S::kTileV;
    if (active) {
      tc::load_rows<D>(k_wg, S::kBox, k, p.ks, b, hk, 1, key0, kKeys, p.skv, tid, 128);
      tc::load_rows<Dv>(v_wg, S::kBox, v, p.vs, b, hk, 1, key0, kKeys, p.skv, tid, 128);
      tc::cp_async_publish();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    }
    const int my_t0 = active ? first_tile(p, kCausal, key0, n_rt) : n_rt;
    // this thread's keys (accumulator rows r and r + 8) and the first folded
    // row each sees; rows at or past `full_from` see every key of the tile.
    // A tile of fewer than kRows rows is masked past them.
    const int r = 16 * warp + lane / 4;
    int first[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + r + 8 * h;
      first[h] = key < p.skv ? first_row(p, kCausal, key) : rows;
    }
    const int full_from = first_row(p, kCausal, key0 + kKeys - 1);
    const bool ragged = key0 + kKeys > p.skv || p.tile_rows < kRows;
    const float cexp = p.scale * 1.4426950408889634f;

    // dK (64 keys x D) and dV (64 x Dv): 160 accumulators a thread at (192,
    // 128), where dK's product runs at wgmma's N = 192
    constexpr int kSliceRows = S::kSliceRows, kSliceK = S::kSliceK;
    float dkv[D / 2], dvv[Dv / 2], st[kSliceRows / 2], dpt[kSliceRows / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dkv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < Dv / 2; ++i) dvv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kSliceRows / 2; ++i) st[i] = 0.f, dpt[i] = 0.f;
    Frags<kSliceK> pf, dsf;

    for (int t = t0, u = 0; t < n_rt; ++t, ++u) {
      const int s = u % kStages;
      tc::mbar_wait(full + 8 * s, (u / kStages) & 1);
      if (t >= my_t0) {
        const uint32_t q_t = q_s + s * S::kTileK, do_t = do_s + s * S::kTileV;
        const int row0 = t * p.tile_rows;
        const float* lse2 = stats + s * (S::kStats / 4);
        const bool masked = ragged || row0 + kRows > rows || row0 < full_from;
#pragma unroll
        for (int sl = 0; sl < S::kSlices; ++sl) {
          // S^T = K Q^T (over D) and dP^T = V dO^T (over Dv) for the
          // slice's rows: their boxes' rows sl * kSliceRows on (a multiple
          // of the swizzle's 8 rows)
          const uint32_t q_sl = q_t + sl * kSliceRows * S::TK::kSwizzle;
          const uint32_t do_sl = do_t + sl * kSliceRows * S::TV::kSwizzle;
          tc::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            tc::wgmma_ss(st, tc::desc_k<D>(k_wg, kk, S::kBox), tc::desc_k<D>(q_sl, kk, S::kBox),
                         kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < Dv / 16; ++kk) {
            tc::wgmma_ss(dpt, tc::desc_k<Dv>(v_wg, kk, S::kBox),
                         tc::desc_k<Dv>(do_sl, kk, S::kBox), kk > 0);
          }
          tc::wgmma_commit();
          tc::wgmma_wait<0>();
          tc::fence_regs(st);
          tc::fence_regs(dpt);
          const int col0 = row0 + sl * kSliceRows + 2 * (lane % 4);
          const float* lse2_sl = lse2 + sl * kSliceRows;
          if (masked) {
            const int lo[2] = {first[0] - col0, first[1] - col0};
            tile_grads<true>(st, dpt, pf, dsf, lse2_sl, lse2_sl + kRows, cexp, lane, lo,
                             min(rows, row0 + p.tile_rows) - col0);
          } else {
            const int none[2] = {0, 0};
            tile_grads<false>(st, dpt, pf, dsf, lse2_sl, lse2_sl + kRows, cexp, lane, none, 0);
          }
          // dV += P^T dO and dK += dS^T Q over the slice's rows, each part
          // in turn
          tc::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kSliceK; ++kk) {
            const int rk = sl * kSliceK + kk;  // the k-slice of 16 rows in the tile
            tc::wgmma_rs(dvv, pf.hi[kk], tc::desc_mn<Dv>(do_t, rk, S::kBox));
            tc::wgmma_rs(dkv, dsf.hi[kk], tc::desc_mn<D>(q_t, rk, S::kBox));
          }
#pragma unroll
          for (int kk = 0; kk < kSliceK; ++kk) {
            const int rk = sl * kSliceK + kk;
            tc::wgmma_rs(dvv, pf.lo[kk], tc::desc_mn<Dv>(do_t, rk, S::kBox));
            tc::wgmma_rs(dkv, dsf.lo[kk], tc::desc_mn<D>(q_t, rk, S::kBox));
          }
          tc::wgmma_commit();
          tc::wgmma_wait<0>();
          tc::fence_regs(dvv);
          tc::fence_regs(dkv);
        }
      }
      if (lane == 0) tc::mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }

    // dK = D^-1/2 dS^T Q and dV, rounded once to bf16; keys past Skv unstored
    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key0 + r + 8 * h;
        if (key >= p.skv) continue;
        __nv_bfloat16* krow = dk + b * p.dks[0] + key * p.dks[1] + hk * p.dks[2] + 2 * (lane % 4);
        __nv_bfloat16* vrow = dv + b * p.dvs[0] + key * p.dvs[1] + hk * p.dvs[2] + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) = __floats2bfloat162_rn(
              dkv[4 * j + 2 * h] * p.scale, dkv[4 * j + 2 * h + 1] * p.scale);
        }
#pragma unroll
        for (int j = 0; j < Dv / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
              __floats2bfloat162_rn(dvv[4 * j + 2 * h], dvv[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// P^T = 2^(S^T c - lse2) of a row tile in place of S^T (kK k-slices of 16
// rows), 0 where a key is invisible (kMask: kept where its column lies in
// [lo[h], hi_col)), and its two bf16 parts as A fragments (tile_grads'
// layout).
template <bool kMask, int kK>
__device__ __forceinline__ void tile_probs(float (&st)[8 * kK], Frags<kK>& pf, const float* lse2,
                                           float c, int lane, const int (&lo)[2], int hi_col) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // columns 16kk + 8 half + 2 (lane % 4) + {0, 1}
      const int col = 16 * kk + 8 * half + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * half + h, i = 8 * kk + 2 * j, e = 16 * kk + 8 * half;
        float p0 = prob(st[i], c, l2.x), p1 = prob(st[i + 1], c, l2.y);
        if (kMask) {
          p0 = e >= lo[h] && e < hi_col ? p0 : 0.f;
          p1 = e + 1 >= lo[h] && e + 1 < hi_col ? p1 : 0.f;
        }
        st[i] = p0;
        st[i + 1] = p1;
        split_bf16(p0, p1, pf.hi[kk][j], pf.lo[kk][j]);
      }
    }
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_mla(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmqr,
                   const __grid_constant__ CUtensorMap tmdo, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ k_rope, const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   const bwd::Params p) {
  using S = MlaDkdv;
  using TK = S::TK;
  using TV = S::TV;
  constexpr int kStages = S::kStages, kK = kRows / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t base = (raw + tc::kAlign - 1) & ~static_cast<uint32_t>(tc::kAlign - 1);
  const uint32_t k_s = base;                         // K of the block's 64 keys
  const uint32_t v_s = k_s + S::kTileK;              // and their V
  const uint32_t q_s = v_s + S::kTileV;              // kStages Q tiles
  const uint32_t do_s = q_s + kStages * S::kTileK;   // kStages dO tiles
  const uint32_t p_s = do_s + kStages * S::kTileV;   // P^T, consumer 0 -> consumer 1
  const uint32_t st_s = p_s + S::kPBytes;            // kStages (lse2, delta) of 64 rows
  const uint32_t full = st_s + kStages * S::kStats;  // kStages barriers, then
  const uint32_t empty = full + 8 * kStages;         // kStages more
  const float* stats = reinterpret_cast<const float*>(smem_raw + (st_s - raw));
  float* pt = reinterpret_cast<float*>(smem_raw + (p_s - raw));

  const int bh = blockIdx.y, b = bh / p.hkv, hk = bh % p.hkv;
  const int key0 = blockIdx.x * kKeys;  // key tile 0, the heaviest, first
  const int rows = p.sq;                // G = 1: a folded row is a query
  const int n_rt = (rows + kRows - 1) / kRows;
  const int t0 = first_tile(p, kCausal, key0, n_rt);  // the first row tile that sees a key

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(full + 8 * s, 1);   // the producer's arrival, plus the bytes
      tc::mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: warp w fills stage w with row tiles t0 + w, t0 + w + kStages, ...
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int w = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0 && w < kStages) {
      const float* stat = p.delta + static_cast<long long>(bh) * p.rows_pad;
      const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
      for (int t = t0 + w, u = 0; t < n_rt; t += kStages, ++u) {
        tc::mbar_wait(empty + 8 * w, (u & 1) ^ 1);  // stage released
        tc::mbar_expect_tx(full + 8 * w, kRows * (192 + 128) * 2 + S::kStats);
        const int i0 = t * kRows;
#pragma unroll
        for (int i = 0; i < TK::kBoxes; ++i) {  // boxes 0-1 from q's nope part, 2 from its rope
          tma_load_rows(q_s + w * S::kTileK + i * S::kBox, i < 2 ? &tmq : &tmqr, full + 8 * w,
                        i < 2 ? i * TK::kBoxCols : 0, hk, i0, b);
        }
#pragma unroll
        for (int i = 0; i < TV::kBoxes; ++i) {
          tma_load_rows(do_s + w * S::kTileV + i * S::kBox, &tmdo, full + 8 * w,
                        i * TV::kBoxCols, hk, i0, b);
        }
        bulk_load(st_s + w * S::kStats, stat + t * kRows, kRows * 4, full + 8 * w);
        bulk_load(st_s + w * S::kStats + kRows * 4, stat + plane + t * kRows, kRows * 4,
                  full + 8 * w);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4;  // this thread's keys: r and r + 8 of the 64
  if (c == 0) {  // K: its nope part into boxes 0-1, its rope part into box 2
    tc::load_rows<128>(k_s, S::kBox, k, p.ks, b, hk, 1, key0, kKeys, p.skv, tid, 128);
    tc::load_rows<64>(k_s + 2 * S::kBox, S::kBox, k_rope, p.krs, b, hk, 1, key0, kKeys, p.skv,
                      tid, 128);
  } else {
    tc::load_rows<128>(v_s, S::kBox, v, p.vs, b, hk, 1, key0, kKeys, p.skv, tid, 128);
  }
  tc::cp_async_publish();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

  if (c == 0) {
    // -- consumer 0: S^T = K Q^T, P^T (to consumer 1), dV += P^T dO -----------------
    // the first row that sees each of this thread's keys; rows at or past
    // `full_from` see every key of the tile
    int first[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + r + 8 * h;
      first[h] = key < p.skv ? first_row(p, kCausal, key) : rows;
    }
    const int full_from = first_row(p, kCausal, key0 + kKeys - 1);
    const bool ragged = key0 + kKeys > p.skv;
    const float cexp = p.scale * 1.4426950408889634f;
    float dvv[64], st[kRows / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) dvv[i] = 0.f;
    Frags<kK> pf;
    for (int t = t0, u = 0; t < n_rt; ++t, ++u) {
      const int s = u % kStages, row0 = t * kRows;
      const uint32_t q_t = q_s + s * S::kTileK, do_t = do_s + s * S::kTileV;
      tc::mbar_wait(full + 8 * s, (u / kStages) & 1);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 192 / 16; ++kk) {
        tc::wgmma_ss(st, tc::desc_k<192>(k_s, kk, S::kBox), tc::desc_k<192>(q_t, kk, S::kBox),
                     kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(st);
      const float* lse2 = stats + s * (S::kStats / 4);
      const int col0 = row0 + 2 * (lane % 4);
      if (ragged || row0 + kRows > rows || row0 < full_from) {
        const int lo[2] = {first[0] - col0, first[1] - col0};
        tile_probs<true>(st, pf, lse2, cexp, lane, lo, min(rows, row0 + kRows) - col0);
      } else {
        const int none[2] = {0, 0};
        tile_probs<false>(st, pf, lse2, cexp, lane, none, 0);
      }
      // hand P^T to consumer 1 once it has read the previous tile's (named
      // barrier 6), then signal it (5)
      if (u > 0) asm volatile("bar.sync 6, 256;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) pt[i * 128 + tid] = st[i];
      __threadfence_block();
      asm volatile("bar.arrive 5, 256;\n" ::: "memory");
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) tc::wgmma_rs(dvv, pf.hi[kk], tc::desc_mn<128>(do_t, kk, S::kBox));
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) tc::wgmma_rs(dvv, pf.lo[kk], tc::desc_mn<128>(do_t, kk, S::kBox));
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dvv);
      if (lane == 0) tc::mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }
    // dV, rounded once to bf16; keys past Skv unstored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + r + 8 * h;
      if (key >= p.skv) continue;
      __nv_bfloat16* vrow = dv + b * p.dvs[0] + key * p.dvs[1] + hk * p.dvs[2] + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
            __floats2bfloat162_rn(dvv[4 * j + 2 * h], dvv[4 * j + 2 * h + 1]);
      }
    }
  } else {
    // -- consumer 1: dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q ----------
    float dkv[96], dpt[kRows / 2];
#pragma unroll
    for (int i = 0; i < 96; ++i) dkv[i] = 0.f;
    Frags<kK> dsf;
    for (int t = t0, u = 0; t < n_rt; ++t, ++u) {
      const int s = u % kStages;
      const uint32_t q_t = q_s + s * S::kTileK, do_t = do_s + s * S::kTileV;
      tc::mbar_wait(full + 8 * s, (u / kStages) & 1);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 128 / 16; ++kk) {
        tc::wgmma_ss(dpt, tc::desc_k<128>(v_s, kk, S::kBox), tc::desc_k<128>(do_t, kk, S::kBox),
                     kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dpt);
      const float* dl = stats + s * (S::kStats / 4) + kRows;
      asm volatile("bar.sync 5, 256;\n" ::: "memory");  // P^T of this tile is there
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // columns 16kk + 8 half + 2 (lane % 4) + {0, 1}
          const float2 de = *reinterpret_cast<const float2*>(dl + 16 * kk + 8 * half + 2 * (lane % 4));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * half + h, i = 8 * kk + 2 * j;
            split_bf16(pt[i * 128 + tid] * (dpt[i] - de.x),
                       pt[(i + 1) * 128 + tid] * (dpt[i + 1] - de.y), dsf.hi[kk][j],
                       dsf.lo[kk][j]);
          }
        }
      }
      // consumer 0 may write the next tile's P^T (none follows the last)
      if (t + 1 < n_rt) asm volatile("bar.arrive 6, 256;\n" ::: "memory");
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) tc::wgmma_rs(dkv, dsf.hi[kk], tc::desc_mn<192>(q_t, kk, S::kBox));
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) tc::wgmma_rs(dkv, dsf.lo[kk], tc::desc_mn<192>(q_t, kk, S::kBox));
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dkv);
      if (lane == 0) tc::mbar_arrive(empty + 8 * s);
    }
    // dK = D^-1/2 dS^T Q, rounded once to bf16; keys past Skv unstored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + r + 8 * h;
      if (key >= p.skv) continue;
      __nv_bfloat16* krow = dk + b * p.dks[0] + key * p.dks[1] + hk * p.dks[2] + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) = __floats2bfloat162_rn(
            dkv[4 * j + 2 * h] * p.scale, dkv[4 * j + 2 * h + 1] * p.scale);
      }
    }
  }
}

template <int D, int Dv, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
                const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ dout,
                __nv_bfloat16* __restrict__ dq, const bwd::Params p) {
  using S = Dq<D, Dv>;
  using TK = typename S::TK;
  using TV = typename S::TV;
  constexpr int kDqKeys = S::kKeys, kDqStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t base = (raw + tc::kAlign - 1) & ~static_cast<uint32_t>(tc::kAlign - 1);
  const uint32_t q_s = base;                          // 128 rows of Q
  const uint32_t do_s = q_s + TK::kTileBytes;         // and of dO
  const uint32_t k_s = do_s + TV::kTileBytes;         // kDqStages K tiles
  const uint32_t v_s = k_s + kDqStages * S::kTileK;   // kDqStages V tiles
  const uint32_t full = v_s + kDqStages * S::kTileV;  // kDqStages barriers, then
  const uint32_t empty = full + 8 * kDqStages;        // kDqStages more

  const int b = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const int rows = p.sq * p.g;  // < 2^23: the launch holds row tiles to 65535
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // heaviest first
  int n_tiles = (p.skv + kDqKeys - 1) / kDqKeys;
  if (kCausal) {
    const int last_row = min(row0 + kDqRows, rows) - 1;
    n_tiles = min(n_tiles, (last_row / p.g + p.q_offset) / kDqKeys + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      tc::mbar_init(full + 8 * s, 1);   // the producer's arrival, plus the bytes
      tc::mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: K and V tiles by TMA, as the forward's ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kDqStages;
        tc::mbar_wait(empty + 8 * s, ((t / kDqStages) & 1) ^ 1);  // stage released
        tc::mbar_expect_tx(full + 8 * s, S::kTileK + S::kTileV);
#pragma unroll
        for (int i = 0; i < TK::kBoxes; ++i) {
          tc::tma_load(k_s + s * S::kTileK + i * S::kKeyBox, &tmk, full + 8 * s,
                       i * TK::kBoxCols, hk, t * kDqKeys, b);
        }
#pragma unroll
        for (int i = 0; i < TV::kBoxes; ++i) {
          tc::tma_load(v_s + s * S::kTileV + i * S::kKeyBox, &tmv, full + 8 * s,
                       i * TV::kBoxCols, hk, t * kDqKeys, b);
        }
      }
    }
  } else {
    // -- consumer c: folded rows row0 + 64c .. row0 + 64c + 63 -------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int wg_row0 = row0 + 64 * c;
    const uint32_t q_wg = q_s + 64 * c * TK::kSwizzle, do_wg = do_s + 64 * c * TV::kSwizzle;
    tc::load_rows<D>(q_wg, TK::kBoxBytes, q, p.qs, b, hk, p.g, wg_row0, 64, rows, tid, 128);
    tc::load_rows<Dv>(do_wg, TV::kBoxBytes, dout, p.dos, b, hk, p.g, wg_row0, 64, rows, tid, 128);
    tc::cp_async_publish();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

    // this thread's rows r and r + 8: their statistics (zeros past the end)
    // and the keys they see (below lim); rows past the end take the last
    // row's position and are never stored
    const int r = 16 * warp + lane / 4;
    const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
    const float* stat = p.delta + static_cast<long long>(blockIdx.x) * p.rows_pad;
    float lse2[2] = {0.f, 0.f}, del[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = wg_row0 + r + 8 * h;
      if (f < rows) {
        lse2[h] = stat[bwd::slot_of(p, f)];
        del[h] = stat[plane + bwd::slot_of(p, f)];
      }
    }
    auto lim_of = [&](int f) {
      const int pos = min(f, rows - 1) / p.g + p.q_offset;
      return kCausal ? min(p.skv, pos + 1) : p.skv;
    };
    const int lim[2] = {lim_of(wg_row0 + r), lim_of(wg_row0 + r + 8)};
    const int min_lim = lim_of(wg_row0);
    const float cexp = p.scale * 1.4426950408889634f;

    float dqv[D / 2], sc[kDqKeys / 2], dp[kDqKeys / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) sc[i] = 0.f, dp[i] = 0.f;
    uint32_t ds_hi[kDqKeys / 16][4], ds_lo[kDqKeys / 16][4];

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kDqStages, key0 = t * kDqKeys;
      const uint32_t k_t = k_s + s * S::kTileK, v_t = v_s + s * S::kTileV;
      tc::mbar_wait(full + 8 * s, (t / kDqStages) & 1);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        tc::wgmma_ss(sc, tc::desc_k<D>(q_wg, kk, TK::kBoxBytes),
                     tc::desc_k<D>(k_t, kk, S::kKeyBox), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < Dv / 16; ++kk) {
        tc::wgmma_ss(dp, tc::desc_k<Dv>(do_wg, kk, TV::kBoxBytes),
                     tc::desc_k<Dv>(v_t, kk, S::kKeyBox), kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(sc);
      tc::fence_regs(dp);
      // dS = P (dP - delta), P = 2^(S c - lse log2 e) where the key is
      // visible (masked only on tiles that hold an invisible key)
      const bool mask = key0 + kDqKeys > min_lim;
      int rel[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) rel[h] = lim[h] - key0 - 2 * (lane % 4);
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j, h = j % 2, e = 8 * (i / 4);
          float p0 = prob(sc[i], cexp, lse2[h]);
          float p1 = prob(sc[i + 1], cexp, lse2[h]);
          if (mask) {
            p0 = e < rel[h] ? p0 : 0.f;
            p1 = e + 1 < rel[h] ? p1 : 0.f;
          }
          split_bf16(p0 * (dp[i] - del[h]), p1 * (dp[i + 1] - del[h]), ds_hi[kk][j],
                     ds_lo[kk][j]);
        }
      }
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
        tc::wgmma_rs(dqv, ds_hi[kk], tc::desc_mn<D>(k_t, kk, S::kKeyBox));
      }
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
        tc::wgmma_rs(dqv, ds_lo[kk], tc::desc_mn<D>(k_t, kk, S::kKeyBox));
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dqv);
      if (lane == 0) tc::mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }

    // dQ = D^-1/2 dS K, rounded once to bf16; rows past Sq * G unstored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = wg_row0 + r + 8 * h;
      if (f >= rows) continue;
      const int qi = f / p.g, head = hk * p.g + f % p.g;
      __nv_bfloat16* qrow = dq + b * p.dqs[0] + qi * p.dqs[1] + head * p.dqs[2] + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) = __floats2bfloat162_rn(
            dqv[4 * j + 2 * h] * p.scale, dqv[4 * j + 2 * h + 1] * p.scale);
      }
    }
  }
}

// dQ at MLA's (192, 128), G = 1: flash_bwd_dq_tc's design on q and k as
// nope and rope parts (a K tile's box 2 from k_rope's TMA map, at head 0 for
// one rope channel; Q's box 2 from q_rope by cp.async), with the row tiles
// of a (batch, head) as neighbouring blocks, heaviest first, so that its K
// and V, which each of them reads, come from L2.
template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_mla(const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmkr,
                 const __grid_constant__ CUtensorMap tmv, const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ q_rope, const __nv_bfloat16* __restrict__ dout,
                 __nv_bfloat16* __restrict__ dq, const bwd::Params p) {
  constexpr int D = 192, Dv = 128;
  using S = Dq<D, Dv>;
  using TK = typename S::TK;
  using TV = typename S::TV;
  constexpr int kDqKeys = S::kKeys, kDqStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t base = (raw + tc::kAlign - 1) & ~static_cast<uint32_t>(tc::kAlign - 1);
  const uint32_t q_s = base;                          // 128 rows of Q
  const uint32_t do_s = q_s + TK::kTileBytes;         // and of dO
  const uint32_t k_s = do_s + TV::kTileBytes;         // kDqStages K tiles
  const uint32_t v_s = k_s + kDqStages * S::kTileK;   // kDqStages V tiles
  const uint32_t full = v_s + kDqStages * S::kTileV;  // kDqStages barriers, then
  const uint32_t empty = full + 8 * kDqStages;        // kDqStages more

  const int bh = blockIdx.y;
  const int b = bh / p.hkv, hk = bh % p.hkv;
  const int rows = p.sq * p.g;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;  // heaviest first
  int n_tiles = (p.skv + kDqKeys - 1) / kDqKeys;
  if (kCausal) {
    const int last_row = min(row0 + kDqRows, rows) - 1;
    n_tiles = min(n_tiles, (last_row / p.g + p.q_offset) / kDqKeys + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      tc::mbar_init(full + 8 * s, 1);   // the producer's arrival, plus the bytes
      tc::mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: K and V tiles by TMA, as the forward's ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kDqStages;
        tc::mbar_wait(empty + 8 * s, ((t / kDqStages) & 1) ^ 1);  // stage released
        tc::mbar_expect_tx(full + 8 * s, S::kTileK + S::kTileV);
#pragma unroll
        for (int i = 0; i < TK::kBoxes; ++i) {  // box 2 from the rope part
          const bool rope = i == TK::kBoxes - 1;
          tc::tma_load(k_s + s * S::kTileK + i * S::kKeyBox, rope ? &tmkr : &tmk, full + 8 * s,
                       rope ? 0 : i * TK::kBoxCols, rope && p.rope_heads == 1 ? 0 : hk, t * kDqKeys,
                       b);
        }
#pragma unroll
        for (int i = 0; i < TV::kBoxes; ++i) {
          tc::tma_load(v_s + s * S::kTileV + i * S::kKeyBox, &tmv, full + 8 * s,
                       i * TV::kBoxCols, hk, t * kDqKeys, b);
        }
      }
    }
  } else {
    // -- consumer c: folded rows row0 + 64c .. row0 + 64c + 63 -------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int wg_row0 = row0 + 64 * c;
    const uint32_t q_wg = q_s + 64 * c * TK::kSwizzle, do_wg = do_s + 64 * c * TV::kSwizzle;
    // q's nope part into boxes 0-1, its rope part into box 2
    tc::load_rows<D - 64>(q_wg, TK::kBoxBytes, q, p.qs, b, hk, p.g, wg_row0, 64, rows, tid, 128);
    tc::load_rows<64>(q_wg + (TK::kBoxes - 1) * TK::kBoxBytes, TK::kBoxBytes, q_rope, p.qrs, b,
                      hk, p.g, wg_row0, 64, rows, tid, 128);
    tc::load_rows<Dv>(do_wg, TV::kBoxBytes, dout, p.dos, b, hk, p.g, wg_row0, 64, rows, tid, 128);
    tc::cp_async_publish();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

    // this thread's rows r and r + 8: their statistics (zeros past the end)
    // and the keys they see (below lim); rows past the end take the last
    // row's position and are never stored
    const int r = 16 * warp + lane / 4;
    const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
    const float* stat = p.delta + static_cast<long long>(bh) * p.rows_pad;
    float lse2[2] = {0.f, 0.f}, del[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = wg_row0 + r + 8 * h;
      if (f < rows) {
        lse2[h] = stat[bwd::slot_of(p, f)];
        del[h] = stat[plane + bwd::slot_of(p, f)];
      }
    }
    auto lim_of = [&](int f) {
      const int pos = min(f, rows - 1) / p.g + p.q_offset;
      return kCausal ? min(p.skv, pos + 1) : p.skv;
    };
    const int lim[2] = {lim_of(wg_row0 + r), lim_of(wg_row0 + r + 8)};
    const int min_lim = lim_of(wg_row0);
    const float cexp = p.scale * 1.4426950408889634f;

    float dqv[D / 2], sc[kDqKeys / 2], dp[kDqKeys / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) sc[i] = 0.f, dp[i] = 0.f;
    uint32_t ds_hi[kDqKeys / 16][4], ds_lo[kDqKeys / 16][4];

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kDqStages, key0 = t * kDqKeys;
      const uint32_t k_t = k_s + s * S::kTileK, v_t = v_s + s * S::kTileV;
      tc::mbar_wait(full + 8 * s, (t / kDqStages) & 1);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        tc::wgmma_ss(sc, tc::desc_k<D>(q_wg, kk, TK::kBoxBytes),
                     tc::desc_k<D>(k_t, kk, S::kKeyBox), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < Dv / 16; ++kk) {
        tc::wgmma_ss(dp, tc::desc_k<Dv>(do_wg, kk, TV::kBoxBytes),
                     tc::desc_k<Dv>(v_t, kk, S::kKeyBox), kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(sc);
      tc::fence_regs(dp);
      // dS = P (dP - delta), P = 2^(S c - lse log2 e) where the key is
      // visible (masked only on tiles that hold an invisible key)
      const bool mask = key0 + kDqKeys > min_lim;
      int rel[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) rel[h] = lim[h] - key0 - 2 * (lane % 4);
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j, h = j % 2, e = 8 * (i / 4);
          float p0 = prob(sc[i], cexp, lse2[h]);
          float p1 = prob(sc[i + 1], cexp, lse2[h]);
          if (mask) {
            p0 = e < rel[h] ? p0 : 0.f;
            p1 = e + 1 < rel[h] ? p1 : 0.f;
          }
          split_bf16(p0 * (dp[i] - del[h]), p1 * (dp[i + 1] - del[h]), ds_hi[kk][j],
                     ds_lo[kk][j]);
        }
      }
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
        tc::wgmma_rs(dqv, ds_hi[kk], tc::desc_mn<D>(k_t, kk, S::kKeyBox));
      }
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
        tc::wgmma_rs(dqv, ds_lo[kk], tc::desc_mn<D>(k_t, kk, S::kKeyBox));
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dqv);
      if (lane == 0) tc::mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }

    // dQ = D^-1/2 dS K, rounded once to bf16; rows past Sq * G unstored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = wg_row0 + r + 8 * h;
      if (f >= rows) continue;
      const int qi = f / p.g, head = hk * p.g + f % p.g;
      __nv_bfloat16* qrow = dq + b * p.dqs[0] + qi * p.dqs[1] + head * p.dqs[2] + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) = __floats2bfloat162_rn(
            dqv[4 * j + 2 * h] * p.scale, dqv[4 * j + 2 * h + 1] * p.scale);
      }
    }
  }
}

}  // namespace tcb

// -- bf16 at D = Dv = 64 and 128: a persistent block over work items ----------------
//
// A causal block of flash_attention_tc at S = 1,024 walks 4.5 key tiles on
// average (1 to 8), and its start (barriers, Q by cp.async, the first Q K^T
// alone) and end (the last P V alone, the O store), which nothing overlaps,
// weigh as much as its loop: zamba2-1.2b's shared block (D=64) ran 1.5x
// behind SDPA on an H100 SXM, qwen3-4b's prefill (D=128) 1.5x too, at ~3.6
// us a key tile step against ~1.7 us at the tensor-core rate.
// flash_group_fwd<D>:
//  * One block per SM walks a fixed list of work items (batch * kv head,
//    tile of tile_rows = G * (128 / G) folded rows: whole query groups, so
//    that a tile's Q is one TMA box of 128 / G queries of G heads across
//    each 64 columns), in chunks of heads, in a chunk every head's heaviest
//    row tile first, as flash_mla_fwd walks its list (the host picks the
//    chunk: work_chunk).  Rows tile_rows .. 127 of the Q stages (G not a
//    power of two) are zeroed once, computed and never stored.
//  * The producer keeps K and V in rings of three stages each that run on
//    across items, and Q in stages of its own, each stage with its own
//    full/empty pair: the next item's Q and first K and V tiles load under
//    this item's last softmax, its last P V and its O store.  D=64: two Q
//    stages (132,224 B), the next item's Q a whole item ahead.  D=128: one
//    Q stage (230,512 B; two would take 263,296 B), so the next item's Q
//    loads once both consumers have run this item's last Q K^T, while its
//    first K tiles may load earlier; two Q stages beside two K and two V
//    stages (197,728 B) ran 3-4 % slower at qwen3-4b's prefill shape on an
//    H100 SXM.
//  * Per key tile the consumers run flash_attention_tc's loop (Tc): P V of
//    the previous tile and S = Q K^T in one batch, the two warpgroups taking
//    turns on the tensor cores, then the softmax.  Two alternatives ran
//    slower on an H100 at D=64: the exponentials of S_t under the
//    warpgroup's own P_{t-1} V_{t-1} with the bf16 split after it (the MUFU
//    and F2FP phases then no longer interleave), and two P register sets
//    alternating by key tile (ptxas serialized every wgmma for want of
//    registers).
//  * The arithmetic is flash_attention_tc's row for row: key tiles of 128 in
//    order, exp2_approx, P in two bf16 parts, the rescale after each P V, the
//    lse in raw units scaled at the store.  A row's bits do not depend on
//    the rows beside it or on tiles past its last visible key (they add
//    exp2(-huge) = 0 and rescale by 1), so out and lse are the same bits.
namespace tc {

template <int D>
struct GroupFwd {
  using T = Tile<D>;
  static constexpr int kStages = 3;                 // K tiles in flight, and V tiles
  static constexpr int kQStages = D == 64 ? 2 : 1;  // Q tiles: an item's (and the next one's)
  // aligned Q stages, the K and V rings, then the full and empty barriers of
  // each K, V and Q stage: 132,224 B at D=64, 230,512 B at D=128
  static constexpr int kSmem =
      kAlign + (kQStages + 2 * kStages) * T::kTileBytes + 8 * (4 * kStages + 2 * kQStages);
};

struct GroupParams {
  int sq, skv, g, hkv, q_offset;
  int tile_rows;                   // folded rows of an item: g * (kRows / g)
  int n_rt, n_bh, chunk, n_items;  // row tiles a kv head, batch * kv heads, the work list
  float scale;
  long long os[3];  // o's element strides of (batch, seq, head)
  float* lse;       // (batch, hq, sq) f32, or null
};

// Work item `item`: batch and kv head, its row tile's first folded row and
// key tiles (the causal ones up to the last that its last row sees).
struct GroupItem {
  int b, hk, row0, n_tiles;
};

template <bool kCausal>
__device__ __forceinline__ GroupItem group_item(const GroupParams& p, int item) {
  const int per = p.chunk * p.n_rt;  // items of a whole chunk
  const int c = item / per, j = item % per;
  const int heads = min(p.chunk, p.n_bh - c * p.chunk);  // the last chunk may hold fewer
  const int bh = c * p.chunk + j % heads;
  GroupItem it;
  it.b = bh / p.hkv;
  it.hk = bh % p.hkv;
  it.row0 = (p.n_rt - 1 - j / heads) * p.tile_rows;  // heaviest first
  it.n_tiles = (p.skv + kKeys - 1) / kKeys;
  if (kCausal) {
    const int last_row = min(it.row0 + p.tile_rows, p.sq * p.g) - 1;
    it.n_tiles = min(it.n_tiles, (last_row / p.g + p.q_offset) / kKeys + 1);
  }
  return it;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_group_fwd(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
                const GroupParams p) {
  using T = typename GroupFwd<D>::T;
  constexpr int kStages = GroupFwd<D>::kStages, kQStages = GroupFwd<D>::kQStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t q_s = base;                            // kQStages Q tiles
  const uint32_t k_s = q_s + kQStages * T::kTileBytes;  // kStages K tiles
  const uint32_t v_s = k_s + kStages * T::kTileBytes;   // kStages V tiles
  const uint32_t k_full = v_s + kStages * T::kTileBytes;
  const uint32_t k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;
  const uint32_t q_full = v_empty + 8 * kStages, q_empty = q_full + 8 * kQStages;
  const int rows = p.sq * p.g;  // < 2^23 (the host's row-tile limit)

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);   // the producer's arrival, plus the bytes
      mbar_init(k_empty + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 8);
    }
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.tile_rows < kRows) {
    // rows tile_rows .. kRows - 1 of every box of both Q stages: TMA never
    // writes them, so zeros once keep them finite (their outputs are never
    // stored).  The boxes of 128 rows lie back to back from q_s.
    constexpr int kChunks = T::kSwizzle / 16;  // of 16 bytes in a row
    const int tail = (kRows - p.tile_rows) * kChunks;
    uint4* tiles = reinterpret_cast<uint4*>(smem_raw + (q_s - raw));
    for (int idx = threadIdx.x; idx < kQStages * T::kBoxes * tail; idx += kThreads) {
      tiles[idx / tail * (T::kBoxBytes / 16) + p.tile_rows * kChunks + idx % tail] =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: per item Q, then K_0, (K_u, V_{u-1}) for u >= 1, V_{n-1} --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (const CUtensorMap* map : {&tmq, &tmk, &tmv}) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
                     : "memory");
      }
      int done = 0;  // K and V tiles loaded before this item (as many of each)
      for (int ic = 0; blockIdx.x + ic * gridDim.x < p.n_items; ++ic) {
        const GroupItem it = group_item<kCausal>(p, blockIdx.x + ic * gridDim.x);
        auto load = [&](uint32_t ring, uint32_t full, uint32_t empty, const CUtensorMap* map,
                        int t) {
          const int s = (done + t) % kStages;
          mbar_wait(empty + 8 * s, (((done + t) / kStages) & 1) ^ 1);  // stage released
          mbar_expect_tx(full + 8 * s, T::kTileBytes);
#pragma unroll
          for (int i = 0; i < T::kBoxes; ++i) {
            tma_load(ring + s * T::kTileBytes + i * T::kBoxBytes, map, full + 8 * s,
                     i * T::kBoxCols, it.hk, t * kKeys, it.b);
          }
        };
        const int qs = ic % kQStages;
        mbar_wait(q_empty + 8 * qs, ((ic / kQStages) & 1) ^ 1);  // its last Q K^T is done
        mbar_expect_tx(q_full + 8 * qs, T::kBoxes * p.tile_rows * T::kSwizzle);
#pragma unroll
        for (int i = 0; i < T::kBoxes; ++i) {
          tcb::tma_load_rows(q_s + qs * T::kTileBytes + i * T::kBoxBytes, &tmq, q_full + 8 * qs,
                             i * T::kBoxCols, it.hk, it.row0 / p.g, it.b);
        }
        load(k_s, k_full, k_empty, &tmk, 0);
        for (int t = 1; t < it.n_tiles; ++t) {
          load(k_s, k_full, k_empty, &tmk, t);
          load(v_s, v_full, v_empty, &tmv, t - 1);
        }
        load(v_s, v_full, v_empty, &tmv, it.n_tiles - 1);
        done += it.n_tiles;
      }
    }
  } else {
    // -- consumer c: folded rows row0 + 64c .. row0 + 64c + 63 of each item -----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r = 16 * warp + lane / 4;  // this thread's rows r and r + 8 of the 64
    // K and V tiles taken before this item (tile t of the item is K and V
    // number done + t, stage (done + t) % kStages)
    int done = 0;
    for (int ic = 0; blockIdx.x + ic * gridDim.x < p.n_items; ++ic) {
      const int qs = ic % kQStages;
      int n_tiles, wg_row0;
      {
        const GroupItem it = group_item<kCausal>(p, blockIdx.x + ic * gridDim.x);
        n_tiles = it.n_tiles;
        wg_row0 = it.row0 + 64 * c;
      }
      // a row sees keys below min(Skv, its position + 1) (causal) or Skv;
      // rows past the end take the last row's position
      auto lim_of = [&](int f) {
        const int pos = min(f, rows - 1) / p.g + p.q_offset;
        return kCausal ? min(p.skv, pos + 1) : p.skv;
      };
      const Tc<D, D> tcx{q_s + qs * T::kTileBytes + 64 * c * T::kSwizzle, k_s, v_s,
                         {lim_of(wg_row0 + r), lim_of(wg_row0 + r + 8)}, lim_of(wg_row0),
                         lane, p.scale * 1.4426950408889634f};
      float acc[D / 2], sc[kKeys / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
      uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];  // p of the previous tile
      auto softmax = [&](int key0) {
        if (key0 + kKeys > tcx.min_lim) {
          tcx.template softmax<true>(sc, m, l, alpha, hi, lo, key0);
        } else {
          tcx.template softmax<false>(sc, m, l, alpha, hi, lo, key0);
        }
      };
      auto stage = [&](int i) { return (done + i) % kStages; };
      auto parity = [&](int i) { return static_cast<uint32_t>((done + i) / kStages) & 1; };

      mbar_wait(q_full + 8 * qs, (ic / kQStages) & 1);
      if (c == 1) turn_pass(1);  // warpgroup 0 takes the first turn
      // Tile 0: S_0 and its softmax.  Tile t: P_{t-1} V_{t-1} and S_t in one
      // batch; then the softmax of S_t, and the accumulator rescaled.
      mbar_wait(k_full + 8 * stage(0), parity(0));
      turn_wait(c);
      wgmma_fence();
      tcx.issue_qk(sc, stage(0));
      wgmma_commit();
      turn_pass(c);
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * stage(0));              // this warp is done with K_0
        if (n_tiles == 1) mbar_arrive(q_empty + 8 * qs);  // and with Q
      }
      softmax(0);
      for (int t = 1; t < n_tiles; ++t) {
        mbar_wait(v_full + 8 * stage(t - 1), parity(t - 1));
        mbar_wait(k_full + 8 * stage(t), parity(t));
        turn_wait(c);
        wgmma_fence();
        tcx.issue_pv(acc, hi, lo, stage(t - 1));
        tcx.issue_qk(sc, stage(t));
        wgmma_commit();
        turn_pass(c);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(sc);
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * stage(t));
          mbar_arrive(v_empty + 8 * stage(t - 1));
          if (t == n_tiles - 1) mbar_arrive(q_empty + 8 * qs);
        }
        softmax(t * kKeys);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[i / 2 % 2];
      }
      mbar_wait(v_full + 8 * stage(n_tiles - 1), parity(n_tiles - 1));
      turn_wait(c);
      wgmma_fence();
      tcx.issue_pv(acc, hi, lo, stage(n_tiles - 1));
      wgmma_commit();
      if (c == 0) turn_pass(c);  // the last turn of warpgroup 1 has no taker
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(v_empty + 8 * stage(n_tiles - 1));
      done += n_tiles;

      // out = acc / max(l, 1e-37), rounded once to bf16; rows past the item's
      // tile and past Sq * G unstored.  The item, decoded again here, is not
      // held in registers across its loop.
      const GroupItem it = group_item<kCausal>(p, blockIdx.x + ic * gridDim.x);
      const int row_end = min(it.row0 + p.tile_rows, rows);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int f = it.row0 + 64 * c + r + 8 * h;
        if (f >= row_end) continue;
        const int qi = f / p.g, head = it.hk * p.g + f % p.g;
        __nv_bfloat16* orow =
            o + it.b * p.os[0] + qi * p.os[1] + head * p.os[2] + 2 * (lane % 4);
        const float inv = 1.f / fmaxf(l[h], 1e-37f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
        }
        // m is a max of raw q . k: scaled here, as the exponent scales it
        if (p.lse != nullptr && lane % 4 == 0) {
          p.lse[(static_cast<long long>(it.b) * p.hkv * p.g + head) * p.sq + qi] =
              m[h] * p.scale + logf(l[h]);
        }
      }
    }
  }
}

}  // namespace tc

// -- bf16 backward at D = Dv = 64: one persistent launch over both kinds of item ---------
//
// Replaces no TPU kernel: the reference differentiates its attention
// (src/repro/models/attention.py:52) by autodiff.  flash_bwd_dkdv_tc and
// flash_bwd_dq_tc were laid out for D=128.  At D=64 they reached 0.06-0.15
// of the bound on an H100 SXM: the two launches ran in series though neither
// reads the other's output; their grids left a nearly empty second wave
// (whisper-tiny's encoder: 144 blocks on 132 SMs, twice) or most SMs idle
// (its decoder: 48 blocks, twice); each short block paid its start (K/V or
// Q/dO by cp.async, waited for) and its end (the stores) with nothing under
// them; and the delta pass read a row 2 bytes a lane (bwd::flash_bwd_delta_vec
// reads it 16 bytes a thread, in the same order of sums).  The bound is the
// tensor cores' rate at these shapes but whisper's decoder (bytes); a chain
// of row tiles of one key tile (or of key tiles of one dQ tile) runs in
// order, one tile's products, exponentials and products again, so a causal
// shape's longest chain, not the rate, sets its time.  flash_bwd_d64:
//  * One launch after the delta pass, one block per SM (at most one per
//    item).  The work list holds both kinds of item: dK/dV items (batch *
//    kv head, pair of key tiles of 64, one a consumer) and dQ items (batch
//    * kv head, tile of g * (128 / g) folded rows: whole query groups, so
//    that its Q and dO are one TMA box each).  A head lists the kind whose
//    heaviest item weighs more first, each kind heaviest first; the heads
//    run in chunks (work_chunk), so that the items of a head run together
//    and read its Q, dO, K and V from L2.  A block's producer claims the
//    next item from a counter (zeroed by the delta pass) when an operand
//    slot frees, so the blocks that finish first take the items left: the
//    list is dealt by load, not in turn.  Every sum still runs in one block
//    in a fixed order: the bits do not depend on which block takes an item.
//  * Pairs: key tiles 2j and 2j + 1 (not flash_bwd_dkdv_tc's j and
//    n - 1 - j), whose chains are about as long, so both consumers work
//    through the item; the list dealt by load evens out the pairs' unequal
//    weights where causal.  Both pairings, picked per shape on the host,
//    ran whisper-tiny's decoder (one wave of 96 items, causal) 15 % faster
//    with j and n - 1 - j, but the branch between them slowed granite-moe's
//    training shape by 3-4 % on an H100, a larger loss by its launches.
//  * Loads by TMA, running on across items: two operand slots of 32 KB (a
//    dK/dV item's K and V of both key tiles, or a dQ item's Q and dO of its
//    rows), a ring of four Q/dO row tiles of 64 with their statistics (dK/dV)
//    and a ring of two K/V tiles of 128 keys (dQ), each slot and stage with
//    its own full and empty barriers.  The next item's operands and first
//    tiles load under this item's last tiles and its stores.
//  * Per item the consumers run flash_bwd_dkdv_tc's or flash_bwd_dq_tc's
//    loop: row tiles in ascending order into dK and dV, key tiles of 128 in
//    ascending order into dQ, the same products, masks, prob, split_bf16
//    and tile_grads, the scale at the store: dq, dk and dv are their bits.
//    A dQ item's rows past its tile (g not dividing 128) are computed from
//    whatever the slot holds and never stored; a row's bits do not depend
//    on its tile (tiles past its last visible key add zeros).  Issuing the
//    next tile's S^T and dP^T behind this tile's dV and dK (one wait a tile
//    instead of two) made ptxas serialize the wgmmas (C7520) and spill,
//    and ran slower on an H100; so did S and dP in two batches with
//    P's exponentials under dP and dS under dV, at three of the five
//    training shapes: neither is kept.
namespace tcb {

struct D64Bwd {
  using T = Tile<64>;                                    // one swizzled box of 128 bytes across D
  static constexpr int kBox = kRows * T::kSwizzle;       // 64 rows: 8 KB
  static constexpr int kOp = 4 * kBox;                   // an item's operands: 32 KB
  static constexpr int kKeyTile = tc::kKeys * T::kSwizzle;  // dQ: a K or V tile of 128 keys
  static constexpr int kKvStages = 4;                    // dK/dV: Q/dO row tiles in flight
  static constexpr int kQStages = 2;                     // dQ: K/V tiles in flight
  static constexpr int kStats = 2 * kRows * 4;           // a row tile's lse * log2 e and delta
  static constexpr int kBars = 2 * (2 + kKvStages + kQStages);  // a full and an empty each
  // aligned operand slots, the row ring with its statistics, the K/V ring,
  // the barriers, the item of each operand slot: 199,824 B
  static constexpr int kSmem = tc::kAlign + 2 * kOp + kKvStages * (2 * kBox + kStats) +
                               kQStages * 2 * kKeyTile + 8 * kBars + 16;
};

constexpr int kCounterWords = 4;  // the work counter after the statistics planes (16 bytes)

struct BwdWork {
  int n_kt, n_rt;       // key tiles of 64, row tiles of tile_rows (dK/dV)
  int q_rows, n_qt;     // dQ: folded rows of an item, g * (128 / g), and its row tiles
  int n_pairs, n_per;   // dK/dV items of a head, all items of a head
  int n_bh, chunk, n_items;
  int q_first;          // a head lists its dQ items first
  int* next;            // the work counter: 0 at launch
};

// Work item `item`: dK/dV (pair idx: key tiles 2 idx and 2 idx + 1) or dQ
// (row tile idx), batch and kv head.
struct BwdItem {
  int dkdv, b, hk, idx;
};

__host__ __device__ __forceinline__ BwdItem bwd_item(const bwd::Params& p, const BwdWork& w,
                                                     int item) {
  const int per = w.chunk * w.n_per;  // items of a whole chunk
  const int c = item / per, j = item % per;
  const int left = w.n_bh - c * w.chunk;  // the last chunk may hold fewer heads
  const int heads = w.chunk < left ? w.chunk : left;
  const int bh = c * w.chunk + j % heads, rank = j / heads;
  const int n_first = w.q_first ? w.n_qt : w.n_pairs;
  BwdItem it;
  it.dkdv = (rank < n_first) != (w.q_first != 0);
  it.idx = rank < n_first ? rank : rank - n_first;
  if (!it.dkdv) it.idx = w.n_qt - 1 - it.idx;  // dQ: the last row tile, the heaviest, first
  it.b = bh / p.hkv;
  it.hk = bh % p.hkv;
  return it;
}

// The first row tile a dK/dV item streams (that of its lower key tile's
// first row), and a dQ item's key tiles of 128 (the causal ones up to the
// last its last row sees).
template <bool kCausal>
__device__ __forceinline__ int pair_first_tile(const bwd::Params& p, const BwdWork& w,
                                               int pair) {
  return first_tile(p, kCausal, 2 * pair * kKeys, w.n_rt);
}
template <bool kCausal>
__device__ __forceinline__ int dq_key_tiles(const bwd::Params& p, const BwdWork& w,
                                            int row_tile) {
  int n = (p.skv + tc::kKeys - 1) / tc::kKeys;
  if (kCausal) {
    const int last_row = min((row_tile + 1) * w.q_rows, p.sq * p.g) - 1;
    n = min(n, (last_row / p.g + p.q_offset) / tc::kKeys + 1);
  }
  return n;
}

// A dK/dV item in consumer c: flash_bwd_dkdv_tc's loop at D = Dv = 64 on
// the row ring from row tile number `u0` of the block; releases the operand
// slot, then stores.
template <bool kCausal>
__device__ __forceinline__ void d64_dkdv(const bwd::Params& p, const BwdWork& w,
                                         const BwdItem& it, uint32_t op, uint32_t op_empty,
                                         uint32_t rq_s, uint32_t rdo_s, uint32_t r_full,
                                         uint32_t r_empty, const float* stats, int u0, int c,
                                         int warp, int lane, __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv) {
  using S = D64Bwd;
  const int rows = p.sq * p.g;
  const int jt = 2 * it.idx + c;  // key tile 2j or 2j + 1: c = 0, 1
  const bool active = jt < w.n_kt;
  const int key0 = jt * kKeys;
  const uint32_t k_wg = op + 2 * c * S::kBox, v_wg = k_wg + S::kBox;
  const int t0 = pair_first_tile<kCausal>(p, w, it.idx);
  const int my_t0 = active ? first_tile(p, kCausal, key0, w.n_rt) : w.n_rt;
  // this thread's keys (accumulator rows r and r + 8) and the first folded
  // row each sees; rows at or past `full_from` see every key of the tile.
  // A tile of fewer than kRows rows is masked past them.
  const int r = 16 * warp + lane / 4;
  int first[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + r + 8 * h;
    first[h] = key < p.skv ? first_row(p, kCausal, key) : rows;
  }
  const int full_from = first_row(p, kCausal, key0 + kKeys - 1);
  const bool ragged = key0 + kKeys > p.skv || p.tile_rows < kRows;
  const float cexp = p.scale * 1.4426950408889634f;

  float dkv[32], dvv[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkv[i] = 0.f, dvv[i] = 0.f, st[i] = 0.f, dpt[i] = 0.f;
  Frags<kRows / 16> pf, dsf;
  for (int t = t0, u = u0; t < w.n_rt; ++t, ++u) {
    const int s = u % S::kKvStages;
    tc::mbar_wait(r_full + 8 * s, (u / S::kKvStages) & 1);
    if (t >= my_t0) {
      const uint32_t q_t = rq_s + s * S::kBox, do_t = rdo_s + s * S::kBox;
      const int row0 = t * p.tile_rows;
      const float* lse2 = stats + s * (S::kStats / 4);
      const bool masked = ragged || row0 + kRows > rows || row0 < full_from;
      // S^T = K Q^T and dP^T = V dO^T over the tile's rows
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) {
        tc::wgmma_ss(st, tc::desc_k<64>(k_wg, kk, S::kBox), tc::desc_k<64>(q_t, kk, S::kBox),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) {
        tc::wgmma_ss(dpt, tc::desc_k<64>(v_wg, kk, S::kBox), tc::desc_k<64>(do_t, kk, S::kBox),
                     kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(st);
      tc::fence_regs(dpt);
      const int col0 = row0 + 2 * (lane % 4);
      if (masked) {
        const int lo[2] = {first[0] - col0, first[1] - col0};
        tile_grads<true>(st, dpt, pf, dsf, lse2, lse2 + kRows, cexp, lane, lo,
                         min(rows, row0 + p.tile_rows) - col0);
      } else {
        const int none[2] = {0, 0};
        tile_grads<false>(st, dpt, pf, dsf, lse2, lse2 + kRows, cexp, lane, none, 0);
      }
      // dV += P^T dO and dK += dS^T Q over the tile's rows, each part in turn
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        tc::wgmma_rs(dvv, pf.hi[kk], tc::desc_mn<64>(do_t, kk, S::kBox));
        tc::wgmma_rs(dkv, dsf.hi[kk], tc::desc_mn<64>(q_t, kk, S::kBox));
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        tc::wgmma_rs(dvv, pf.lo[kk], tc::desc_mn<64>(do_t, kk, S::kBox));
        tc::wgmma_rs(dkv, dsf.lo[kk], tc::desc_mn<64>(q_t, kk, S::kBox));
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dvv);
      tc::fence_regs(dkv);
    }
    if (lane == 0) tc::mbar_arrive(r_empty + 8 * s);  // this warp is done with the stage
  }
  if (lane == 0) tc::mbar_arrive(op_empty);  // and with K and V

  // dK = D^-1/2 dS^T Q and dV, rounded once to bf16; keys past Skv unstored
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + r + 8 * h;
      if (key >= p.skv) continue;
      __nv_bfloat16* krow =
          dk + it.b * p.dks[0] + key * p.dks[1] + it.hk * p.dks[2] + 2 * (lane % 4);
      __nv_bfloat16* vrow =
          dv + it.b * p.dvs[0] + key * p.dvs[1] + it.hk * p.dvs[2] + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) = __floats2bfloat162_rn(
            dkv[4 * j + 2 * h] * p.scale, dkv[4 * j + 2 * h + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
            __floats2bfloat162_rn(dvv[4 * j + 2 * h], dvv[4 * j + 2 * h + 1]);
      }
    }
  }
}

// A dQ item in consumer c (its rows 64c .. 64c + 63): flash_bwd_dq_tc's loop
// at D = Dv = 64 on the K/V ring from key tile number `u0` of the block;
// releases the operand slot, then stores the item's rows.
template <bool kCausal>
__device__ __forceinline__ void d64_dq(const bwd::Params& p, const BwdWork& w,
                                       const BwdItem& it, uint32_t op, uint32_t op_empty,
                                       uint32_t kk_s, uint32_t kv_s, uint32_t k_full,
                                       uint32_t k_empty, int u0, int c, int warp, int lane,
                                       __nv_bfloat16* __restrict__ dq) {
  using S = D64Bwd;
  using TK = Tile<64>;
  const int rows = p.sq * p.g;
  const int row0 = it.idx * w.q_rows, wg_row0 = row0 + 64 * c;
  const uint32_t q_wg = op + 64 * c * TK::kSwizzle;  // Q of the item's rows, then dO
  const uint32_t do_wg = q_wg + 2 * S::kBox;
  const int n_tiles = dq_key_tiles<kCausal>(p, w, it.idx);

  // this thread's rows r and r + 8: their statistics (zeros past the end)
  // and the keys they see (below lim); rows past the end take the last
  // row's position and are never stored
  const int r = 16 * warp + lane / 4;
  const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
  const float* stat = p.delta + static_cast<long long>(it.b * p.hkv + it.hk) * p.rows_pad;
  float lse2[2] = {0.f, 0.f}, del[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = wg_row0 + r + 8 * h;
    if (f < rows) {
      lse2[h] = stat[bwd::slot_of(p, f)];
      del[h] = stat[plane + bwd::slot_of(p, f)];
    }
  }
  auto lim_of = [&](int f) {
    const int pos = min(f, rows - 1) / p.g + p.q_offset;
    return kCausal ? min(p.skv, pos + 1) : p.skv;
  };
  const int lim[2] = {lim_of(wg_row0 + r), lim_of(wg_row0 + r + 8)};
  const int min_lim = lim_of(wg_row0);
  const float cexp = p.scale * 1.4426950408889634f;

  float dqv[32], sc[tc::kKeys / 2], dp[tc::kKeys / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < tc::kKeys / 2; ++i) sc[i] = 0.f, dp[i] = 0.f;
  uint32_t ds_hi[tc::kKeys / 16][4], ds_lo[tc::kKeys / 16][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int u = u0 + t, s = u % S::kQStages, key0 = t * tc::kKeys;
    const uint32_t k_t = kk_s + s * S::kKeyTile, v_t = kv_s + s * S::kKeyTile;
    tc::mbar_wait(k_full + 8 * s, (u / S::kQStages) & 1);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      tc::wgmma_ss(sc, tc::desc_k<64>(q_wg, kk, TK::kBoxBytes),
                   tc::desc_k<64>(k_t, kk, S::kKeyTile), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      tc::wgmma_ss(dp, tc::desc_k<64>(do_wg, kk, TK::kBoxBytes),
                   tc::desc_k<64>(v_t, kk, S::kKeyTile), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);
    tc::fence_regs(dp);
    // dS = P (dP - delta), P = 2^(S c - lse log2 e) where the key is
    // visible (masked only on tiles that hold an invisible key)
    const bool mask = key0 + tc::kKeys > min_lim;
    int rel[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rel[h] = lim[h] - key0 - 2 * (lane % 4);
#pragma unroll
    for (int kk = 0; kk < tc::kKeys / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j, h = j % 2, e = 8 * (i / 4);
        float p0 = prob(sc[i], cexp, lse2[h]);
        float p1 = prob(sc[i + 1], cexp, lse2[h]);
        if (mask) {
          p0 = e < rel[h] ? p0 : 0.f;
          p1 = e + 1 < rel[h] ? p1 : 0.f;
        }
        split_bf16(p0 * (dp[i] - del[h]), p1 * (dp[i + 1] - del[h]), ds_hi[kk][j], ds_lo[kk][j]);
      }
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < tc::kKeys / 16; ++kk) {
      tc::wgmma_rs(dqv, ds_hi[kk], tc::desc_mn<64>(k_t, kk, S::kKeyTile));
    }
#pragma unroll
    for (int kk = 0; kk < tc::kKeys / 16; ++kk) {
      tc::wgmma_rs(dqv, ds_lo[kk], tc::desc_mn<64>(k_t, kk, S::kKeyTile));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dqv);
    if (lane == 0) tc::mbar_arrive(k_empty + 8 * s);  // this warp is done with the stage
  }
  if (lane == 0) tc::mbar_arrive(op_empty);  // and with Q and dO

  // dQ = D^-1/2 dS K, rounded once to bf16; rows past the item's tile and
  // past Sq * G unstored
  const int row_end = min(row0 + w.q_rows, rows);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = wg_row0 + r + 8 * h;
    if (f >= row_end) continue;
    const int qi = f / p.g, head = it.hk * p.g + f % p.g;
    __nv_bfloat16* qrow = dq + it.b * p.dqs[0] + qi * p.dqs[1] + head * p.dqs[2] + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) = __floats2bfloat162_rn(
          dqv[4 * j + 2 * h] * p.scale, dqv[4 * j + 2 * h + 1] * p.scale);
    }
  }
}

// tmq / tmdo: q and dout as row tiles of 64 folded rows (dK/dV's stream),
// tmqw / tmdow of 128 (a dQ item's operands); tmk / tmv: k and v as tiles of
// 64 keys (a dK/dV item's operands), tmkw / tmvw of 128 (dQ's stream).
template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_d64(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmdo,
              const __grid_constant__ CUtensorMap tmqw, const __grid_constant__ CUtensorMap tmdow,
              const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
              const __grid_constant__ CUtensorMap tmkw, const __grid_constant__ CUtensorMap tmvw,
              __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, const bwd::Params p, const BwdWork w) {
  using S = D64Bwd;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t base = (raw + tc::kAlign - 1) & ~static_cast<uint32_t>(tc::kAlign - 1);
  const uint32_t op_s = base;                            // two operand slots
  const uint32_t rq_s = op_s + 2 * S::kOp;               // dK/dV: kKvStages Q row tiles,
  const uint32_t rdo_s = rq_s + S::kKvStages * S::kBox;  // their dO row tiles,
  const uint32_t st_s = rdo_s + S::kKvStages * S::kBox;  // and their statistics
  const uint32_t kk_s = st_s + S::kKvStages * S::kStats;      // dQ: kQStages K tiles
  const uint32_t kv_s = kk_s + S::kQStages * S::kKeyTile;     // and V tiles
  const uint32_t op_full = kv_s + S::kQStages * S::kKeyTile;  // the barriers
  const uint32_t op_empty = op_full + 16;
  const uint32_t r_full = op_empty + 16, r_empty = r_full + 8 * S::kKvStages;
  const uint32_t k_full = r_empty + 8 * S::kKvStages, k_empty = k_full + 8 * S::kQStages;
  const uint32_t slots_s = k_empty + 8 * S::kQStages;  // the item in each operand slot
  volatile int* slots = reinterpret_cast<volatile int*>(smem_raw + (slots_s - raw));
  const float* stats = reinterpret_cast<const float*>(smem_raw + (st_s - raw));

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      tc::mbar_init(op_full + 8 * s, 1);   // the producer's arrival, plus the bytes
      tc::mbar_init(op_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < S::kKvStages; ++s) {
      tc::mbar_init(r_full + 8 * s, 1);
      tc::mbar_init(r_empty + 8 * s, 8);
    }
    for (int s = 0; s < S::kQStages; ++s) {
      tc::mbar_init(k_full + 8 * s, 1);
      tc::mbar_init(k_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.tile_rows < kRows) {
    // rows tile_rows .. kRows - 1 of every Q and dO row stage: TMA never
    // writes them, so zeros once make them add nothing to dV and dK.  The
    // stages' boxes of 64 rows lie back to back from rq_s: Q's, then dO's.
    constexpr int kChunks = S::T::kSwizzle / 16;  // of 16 bytes in a row
    const int tail = (kRows - p.tile_rows) * kChunks;
    uint4* tiles = reinterpret_cast<uint4*>(smem_raw + (rq_s - raw));
    for (int idx = threadIdx.x; idx < 2 * S::kKvStages * tail; idx += kThreads) {
      tiles[idx / tail * (S::kBox / 16) + p.tile_rows * kChunks + idx % tail] =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: per item its operands, then its row tiles or key tiles -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (const CUtensorMap* map : {&tmq, &tmdo, &tmqw, &tmdow, &tmk, &tmv, &tmkw, &tmvw}) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
                     : "memory");
      }
      const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
      int rt = 0, kt = 0;  // row tiles and key tiles loaded before this item
      for (int ic = 0;; ++ic) {
        const int slot = ic & 1;
        const uint32_t full = op_full + 8 * slot;
        tc::mbar_wait(op_empty + 8 * slot, ((ic >> 1) & 1) ^ 1);  // its last item is done
        const int item = atomicAdd(w.next, 1);
        if (item >= w.n_items) {  // none left: the consumers stop at -1
          slots[slot] = -1;
          tc::mbar_arrive(full);
          break;
        }
        slots[slot] = item;  // published by the arrival below
        const BwdItem it = bwd_item(p, w, item);
        const uint32_t op = op_s + slot * S::kOp;
        if (it.dkdv) {
          // the consumers' key tiles; consumer 1 has none past the end
          const int j0 = 2 * it.idx, j1 = j0 + 1;
          const bool two = j1 < w.n_kt;
          tc::mbar_expect_tx(full, (two ? 4 : 2) * S::kBox);
          tc::tma_load(op, &tmk, full, 0, it.hk, j0 * kKeys, it.b);
          tc::tma_load(op + S::kBox, &tmv, full, 0, it.hk, j0 * kKeys, it.b);
          if (two) {
            tc::tma_load(op + 2 * S::kBox, &tmk, full, 0, it.hk, j1 * kKeys, it.b);
            tc::tma_load(op + 3 * S::kBox, &tmv, full, 0, it.hk, j1 * kKeys, it.b);
          }
          const float* stat = p.delta + static_cast<long long>(it.b * p.hkv + it.hk) * p.rows_pad;
          for (int t = pair_first_tile<kCausal>(p, w, it.idx); t < w.n_rt; ++t, ++rt) {
            const int s = rt % S::kKvStages;
            const uint32_t bar = r_full + 8 * s;
            tc::mbar_wait(r_empty + 8 * s, ((rt / S::kKvStages) & 1) ^ 1);  // stage released
            tc::mbar_expect_tx(bar, p.tile_rows * 2 * S::T::kSwizzle + S::kStats);
            const int i0 = t * (p.tile_rows / p.g);
            tma_load_rows(rq_s + s * S::kBox, &tmq, bar, 0, it.hk, i0, it.b);
            tma_load_rows(rdo_s + s * S::kBox, &tmdo, bar, 0, it.hk, i0, it.b);
            bulk_load(st_s + s * S::kStats, stat + t * kRows, kRows * 4, bar);
            bulk_load(st_s + s * S::kStats + kRows * 4, stat + plane + t * kRows, kRows * 4, bar);
          }
        } else {
          const int i0 = it.idx * (w.q_rows / p.g);
          tc::mbar_expect_tx(full, 2 * w.q_rows * S::T::kSwizzle);
          tma_load_rows(op, &tmqw, full, 0, it.hk, i0, it.b);
          tma_load_rows(op + 2 * S::kBox, &tmdow, full, 0, it.hk, i0, it.b);
          const int n = dq_key_tiles<kCausal>(p, w, it.idx);
          for (int t = 0; t < n; ++t, ++kt) {
            const int s = kt % S::kQStages;
            const uint32_t bar = k_full + 8 * s;
            tc::mbar_wait(k_empty + 8 * s, ((kt / S::kQStages) & 1) ^ 1);  // stage released
            tc::mbar_expect_tx(bar, 2 * S::kKeyTile);
            tc::tma_load(kk_s + s * S::kKeyTile, &tmkw, bar, 0, it.hk, t * tc::kKeys, it.b);
            tc::tma_load(kv_s + s * S::kKeyTile, &tmvw, bar, 0, it.hk, t * tc::kKeys, it.b);
          }
        }
      }
    }
  } else {
    // -- consumer c: keys of tile 2j + c of a dK/dV item, rows 64c ..
    // 64c + 63 of a dQ item ---------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    int rt = 0, kt = 0;  // row tiles and key tiles taken before this item
    for (int ic = 0;; ++ic) {
      const int slot = ic & 1;
      tc::mbar_wait(op_full + 8 * slot, (ic >> 1) & 1);
      const int item = slots[slot];
      if (item < 0) break;
      const BwdItem it = bwd_item(p, w, item);
      const uint32_t op = op_s + slot * S::kOp;
      if (it.dkdv) {
        d64_dkdv<kCausal>(p, w, it, op, op_empty + 8 * slot, rq_s, rdo_s, r_full, r_empty, stats,
                          rt, c, warp, lane, dk, dv);
        rt += w.n_rt - pair_first_tile<kCausal>(p, w, it.idx);
      } else {
        d64_dq<kCausal>(p, w, it, op, op_empty + 8 * slot, kk_s, kv_s, k_full, k_empty, kt, c,
                        warp, lane, dq);
        kt += dq_key_tiles<kCausal>(p, w, it.idx);
      }
    }
  }
}

}  // namespace tcb

// -- bf16 backward at D = Dv = 128: one persistent launch over both kinds of item --------
//
// Replaces no TPU kernel (the reference's autodiff of
// src/repro/models/attention.py:52).  At D=128 flash_bwd_dkdv_tc and
// flash_bwd_dq_tc reached 0.20 of the bound at qwen3-4b's training shape on
// an H100 SXM: 128 dK/dV blocks held 128 of 132 SMs for the whole pass, the
// dQ launch ran after it with a tail of its own, and the delta pass read a
// row 2 bytes a lane.  flash_bwd_d128 is flash_bwd_d64's design (the delta
// pass bwd::flash_bwd_delta_vec<128> zeroes the counter; one block per SM
// claims dK/dV items, pairs of key tiles 2j and 2j + 1, and dQ items, tiles
// of g * (128 / g) folded rows, from one list; the plan is the same,
// persistent_bwd_plan) with what D=128 forces:
//  * Registers.  A dK/dV item keeps dK and dV (128 accumulators a consumer)
//    beside a row tile's S^T, dP^T and their bf16 parts; a dQ item keeps dQ
//    (64) beside S, dP (64 each) and dS's parts.  Each kind runs in a
//    function of its own and keeps nothing of the other live: the item
//    loop's state is the ring counter and the slot.  No spill, as the two
//    kernels it replaces.
//  * Shared memory.  Two operand slots of 64 KB: a dK/dV item's K and V of
//    keys 128j .. 128j + 127 (consumer c reads rows 64c .. 64c + 63 of each
//    box of 128, the swizzle's phase unchanged), or a dQ item's Q and dO of
//    its 128 rows.  One ring of three 32 KB stages serves both kinds: a
//    stage holds a Q and a dO row tile of 64 (with its statistics beside) or
//    one K or one V tile of 128 keys; a dQ key tile takes two stages, V's
//    first, so that V_t's stage, freed once dP is done, takes K_{t+1} while
//    dS and dQ += dS K still read K_t (K first would hold V_{t+1} behind the
//    end of tile t).  232,032 B of the 232,448 a block may have.  A dQ
//    item's K/V ring of 64 KB a stage beside the dK/dV ring would not fit.
//  * Rows tile_rows .. 63 of a row stage are zeroed once; a dQ tile written
//    there later leaves finite K or V values (or TMA's zeros), which P^T = 0
//    multiplies to exact zeros, as flash_bwd_dkdv_tc's zeros did.
//  * Per item the consumers run flash_bwd_dkdv_tc's or flash_bwd_dq_tc's
//    loop at D=128: row tiles in ascending order into dK and dV, key tiles
//    of 128 in ascending order into dQ, the same products (S^T and dP^T at
//    wgmma's N = 64, dK and dV at N = 128, S and dP at N = 128 keys, dQ at N
//    = 128), masks, prob, split_bf16 and tile_grads, the scale at the
//    store: dq, dk and dv are their bits.
namespace tcb {

struct D128Bwd {
  using T = Tile<128>;                                      // two swizzled boxes across D
  static constexpr int kRowBox = kRows * T::kSwizzle;       // a box of 64 rows: 8 KB
  static constexpr int kWideBox = tc::kRows * T::kSwizzle;  // a box of 128 rows or keys: 16 KB
  static constexpr int kOp = 4 * kWideBox;                  // an item's operands: 64 KB
  static constexpr int kStage = 2 * T::kBoxes * kRowBox;    // Q and dO of 64 rows: 32 KB
  static_assert(kStage == T::kTileBytes, "a stage holds a K or a V tile of 128 keys too");
  static constexpr int kStages = 3;                         // ring stages, both kinds of item
  static constexpr int kStats = 2 * kRows * 4;              // a row tile's lse * log2 e and delta
  static constexpr int kBars = 2 * (2 + kStages);           // a full and an empty each
  // aligned operand slots, the ring, its statistics, the barriers, the item
  // of each operand slot: 232,032 B
  static constexpr int kSmem =
      tc::kAlign + 2 * kOp + kStages * (kStage + kStats) + 8 * kBars + 16;
};

// A dK/dV item in consumer c: flash_bwd_dkdv_tc's loop at D = Dv = 128 on
// the ring from ring tile number `u0` of the block; releases the operand
// slot, then stores.
template <bool kCausal>
__device__ __forceinline__ void d128_dkdv(const bwd::Params& p, const BwdWork& w,
                                          const BwdItem& it, uint32_t op, uint32_t op_empty,
                                          uint32_t ring, uint32_t r_full, uint32_t r_empty,
                                          const float* stats, int u0, int c, int warp, int lane,
                                          __nv_bfloat16* __restrict__ dk,
                                          __nv_bfloat16* __restrict__ dv) {
  using S = D128Bwd;
  const int rows = p.sq * p.g;
  const int jt = 2 * it.idx + c;  // key tile 2j or 2j + 1: c = 0, 1
  const bool active = jt < w.n_kt;
  const int key0 = jt * kKeys;
  // this consumer's keys: rows 64c .. 64c + 63 of the slot's boxes of 128 keys
  const uint32_t k_wg = op + 64 * c * S::T::kSwizzle, v_wg = k_wg + 2 * S::kWideBox;
  const int t0 = pair_first_tile<kCausal>(p, w, it.idx);
  const int my_t0 = active ? first_tile(p, kCausal, key0, w.n_rt) : w.n_rt;
  // this thread's keys (accumulator rows r and r + 8) and the first folded
  // row each sees; rows at or past `full_from` see every key of the tile.
  // A tile of fewer than kRows rows is masked past them.
  const int r = 16 * warp + lane / 4;
  int first[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + r + 8 * h;
    first[h] = key < p.skv ? first_row(p, kCausal, key) : rows;
  }
  const int full_from = first_row(p, kCausal, key0 + kKeys - 1);
  const bool ragged = key0 + kKeys > p.skv || p.tile_rows < kRows;
  const float cexp = p.scale * 1.4426950408889634f;

  float dkv[64], dvv[64], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) dkv[i] = 0.f, dvv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = 0.f, dpt[i] = 0.f;
  Frags<kRows / 16> pf, dsf;
  for (int t = t0, u = u0; t < w.n_rt; ++t, ++u) {
    const int s = u % S::kStages;
    tc::mbar_wait(r_full + 8 * s, (u / S::kStages) & 1);
    if (t >= my_t0) {
      const uint32_t q_t = ring + s * S::kStage, do_t = q_t + 2 * S::kRowBox;
      const int row0 = t * p.tile_rows;
      const float* lse2 = stats + s * (S::kStats / 4);
      const bool masked = ragged || row0 + kRows > rows || row0 < full_from;
      // S^T = K Q^T and dP^T = V dO^T over the tile's rows
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 128 / 16; ++kk) {
        tc::wgmma_ss(st, tc::desc_k<128>(k_wg, kk, S::kWideBox),
                     tc::desc_k<128>(q_t, kk, S::kRowBox), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 128 / 16; ++kk) {
        tc::wgmma_ss(dpt, tc::desc_k<128>(v_wg, kk, S::kWideBox),
                     tc::desc_k<128>(do_t, kk, S::kRowBox), kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(st);
      tc::fence_regs(dpt);
      const int col0 = row0 + 2 * (lane % 4);
      if (masked) {
        const int lo[2] = {first[0] - col0, first[1] - col0};
        tile_grads<true>(st, dpt, pf, dsf, lse2, lse2 + kRows, cexp, lane, lo,
                         min(rows, row0 + p.tile_rows) - col0);
      } else {
        const int none[2] = {0, 0};
        tile_grads<false>(st, dpt, pf, dsf, lse2, lse2 + kRows, cexp, lane, none, 0);
      }
      // dV += P^T dO and dK += dS^T Q over the tile's rows, each part in turn
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        tc::wgmma_rs(dvv, pf.hi[kk], tc::desc_mn<128>(do_t, kk, S::kRowBox));
        tc::wgmma_rs(dkv, dsf.hi[kk], tc::desc_mn<128>(q_t, kk, S::kRowBox));
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        tc::wgmma_rs(dvv, pf.lo[kk], tc::desc_mn<128>(do_t, kk, S::kRowBox));
        tc::wgmma_rs(dkv, dsf.lo[kk], tc::desc_mn<128>(q_t, kk, S::kRowBox));
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(dvv);
      tc::fence_regs(dkv);
    }
    if (lane == 0) tc::mbar_arrive(r_empty + 8 * s);  // this warp is done with the stage
  }
  if (lane == 0) tc::mbar_arrive(op_empty);  // and with K and V

  // dK = D^-1/2 dS^T Q and dV, rounded once to bf16; keys past Skv unstored
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + r + 8 * h;
      if (key >= p.skv) continue;
      __nv_bfloat16* krow =
          dk + it.b * p.dks[0] + key * p.dks[1] + it.hk * p.dks[2] + 2 * (lane % 4);
      __nv_bfloat16* vrow =
          dv + it.b * p.dvs[0] + key * p.dvs[1] + it.hk * p.dvs[2] + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) = __floats2bfloat162_rn(
            dkv[4 * j + 2 * h] * p.scale, dkv[4 * j + 2 * h + 1] * p.scale);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
            __floats2bfloat162_rn(dvv[4 * j + 2 * h], dvv[4 * j + 2 * h + 1]);
      }
    }
  }
}

// A dQ item in consumer c (its rows 64c .. 64c + 63): flash_bwd_dq_tc's loop
// at D = Dv = 128 on the ring from ring tile number `u0` of the block (key
// tile t: V in ring tile u0 + 2t, K in u0 + 2t + 1); releases the operand
// slot, then stores the item's rows.
template <bool kCausal>
__device__ __forceinline__ void d128_dq(const bwd::Params& p, const BwdWork& w,
                                        const BwdItem& it, uint32_t op, uint32_t op_empty,
                                        uint32_t ring, uint32_t r_full, uint32_t r_empty, int u0,
                                        int c, int warp, int lane,
                                        __nv_bfloat16* __restrict__ dq) {
  using S = D128Bwd;
  const int rows = p.sq * p.g;
  const int row0 = it.idx * w.q_rows, wg_row0 = row0 + 64 * c;
  const uint32_t q_wg = op + 64 * c * S::T::kSwizzle;  // Q of the item's rows, then dO
  const uint32_t do_wg = q_wg + 2 * S::kWideBox;
  const int n_tiles = dq_key_tiles<kCausal>(p, w, it.idx);

  // this thread's rows r and r + 8: their statistics (zeros past the end)
  // and the keys they see (below lim); rows past the end take the last
  // row's position and are never stored
  const int r = 16 * warp + lane / 4;
  const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
  const float* stat = p.delta + static_cast<long long>(it.b * p.hkv + it.hk) * p.rows_pad;
  float lse2[2] = {0.f, 0.f}, del[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = wg_row0 + r + 8 * h;
    if (f < rows) {
      lse2[h] = stat[bwd::slot_of(p, f)];
      del[h] = stat[plane + bwd::slot_of(p, f)];
    }
  }
  auto lim_of = [&](int f) {
    const int pos = min(f, rows - 1) / p.g + p.q_offset;
    return kCausal ? min(p.skv, pos + 1) : p.skv;
  };
  const int lim[2] = {lim_of(wg_row0 + r), lim_of(wg_row0 + r + 8)};
  const int min_lim = lim_of(wg_row0);
  const float cexp = p.scale * 1.4426950408889634f;

  float dqv[64], sc[tc::kKeys / 2], dp[tc::kKeys / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) dqv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < tc::kKeys / 2; ++i) sc[i] = 0.f, dp[i] = 0.f;
  uint32_t ds_hi[tc::kKeys / 16][4], ds_lo[tc::kKeys / 16][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int u = u0 + 2 * t, sv = u % S::kStages, sk = (u + 1) % S::kStages;
    const int key0 = t * tc::kKeys;
    const uint32_t v_t = ring + sv * S::kStage, k_t = ring + sk * S::kStage;
    tc::mbar_wait(r_full + 8 * sv, (u / S::kStages) & 1);
    tc::mbar_wait(r_full + 8 * sk, ((u + 1) / S::kStages) & 1);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 128 / 16; ++kk) {
      tc::wgmma_ss(sc, tc::desc_k<128>(q_wg, kk, S::kWideBox),
                   tc::desc_k<128>(k_t, kk, S::kWideBox), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 128 / 16; ++kk) {
      tc::wgmma_ss(dp, tc::desc_k<128>(do_wg, kk, S::kWideBox),
                   tc::desc_k<128>(v_t, kk, S::kWideBox), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);
    tc::fence_regs(dp);
    if (lane == 0) tc::mbar_arrive(r_empty + 8 * sv);  // this warp is done with V_t
    // dS = P (dP - delta), P = 2^(S c - lse log2 e) where the key is
    // visible (masked only on tiles that hold an invisible key)
    const bool mask = key0 + tc::kKeys > min_lim;
    int rel[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rel[h] = lim[h] - key0 - 2 * (lane % 4);
#pragma unroll
    for (int kk = 0; kk < tc::kKeys / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j, h = j % 2, e = 8 * (i / 4);
        float p0 = prob(sc[i], cexp, lse2[h]);
        float p1 = prob(sc[i + 1], cexp, lse2[h]);
        if (mask) {
          p0 = e < rel[h] ? p0 : 0.f;
          p1 = e + 1 < rel[h] ? p1 : 0.f;
        }
        split_bf16(p0 * (dp[i] - del[h]), p1 * (dp[i + 1] - del[h]), ds_hi[kk][j], ds_lo[kk][j]);
      }
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < tc::kKeys / 16; ++kk) {
      tc::wgmma_rs(dqv, ds_hi[kk], tc::desc_mn<128>(k_t, kk, S::kWideBox));
    }
#pragma unroll
    for (int kk = 0; kk < tc::kKeys / 16; ++kk) {
      tc::wgmma_rs(dqv, ds_lo[kk], tc::desc_mn<128>(k_t, kk, S::kWideBox));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dqv);
    if (lane == 0) tc::mbar_arrive(r_empty + 8 * sk);  // and with K_t
  }
  if (lane == 0) tc::mbar_arrive(op_empty);  // and with Q and dO

  // dQ = D^-1/2 dS K, rounded once to bf16; rows past the item's tile and
  // past Sq * G unstored
  const int row_end = min(row0 + w.q_rows, rows);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = wg_row0 + r + 8 * h;
    if (f >= row_end) continue;
    const int qi = f / p.g, head = it.hk * p.g + f % p.g;
    __nv_bfloat16* qrow = dq + it.b * p.dqs[0] + qi * p.dqs[1] + head * p.dqs[2] + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) = __floats2bfloat162_rn(
          dqv[4 * j + 2 * h] * p.scale, dqv[4 * j + 2 * h + 1] * p.scale);
    }
  }
}

// tmq / tmdo: q and dout as row tiles of 64 folded rows (dK/dV's stream),
// tmqw / tmdow of 128 (a dQ item's operands); tmkw / tmvw: k and v as tiles
// of 128 keys (a dK/dV item's operands, both its key tiles, and dQ's
// stream).
template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_d128(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmdo,
               const __grid_constant__ CUtensorMap tmqw, const __grid_constant__ CUtensorMap tmdow,
               const __grid_constant__ CUtensorMap tmkw, const __grid_constant__ CUtensorMap tmvw,
               __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, const bwd::Params p, const BwdWork w) {
  using S = D128Bwd;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t base = (raw + tc::kAlign - 1) & ~static_cast<uint32_t>(tc::kAlign - 1);
  const uint32_t op_s = base;                              // two operand slots
  const uint32_t ring = op_s + 2 * S::kOp;                 // kStages ring stages
  const uint32_t st_s = ring + S::kStages * S::kStage;     // a row tile's statistics a stage
  const uint32_t op_full = st_s + S::kStages * S::kStats;  // the barriers
  const uint32_t op_empty = op_full + 16;
  const uint32_t r_full = op_empty + 16, r_empty = r_full + 8 * S::kStages;
  const uint32_t slots_s = r_empty + 8 * S::kStages;  // the item in each operand slot
  volatile int* slots = reinterpret_cast<volatile int*>(smem_raw + (slots_s - raw));
  const float* stats = reinterpret_cast<const float*>(smem_raw + (st_s - raw));

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      tc::mbar_init(op_full + 8 * s, 1);   // the producer's arrival, plus the bytes
      tc::mbar_init(op_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < S::kStages; ++s) {
      tc::mbar_init(r_full + 8 * s, 1);
      tc::mbar_init(r_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.tile_rows < kRows) {
    // rows tile_rows .. kRows - 1 of every box of 64 rows of the ring (a
    // stage's Q boxes, then its dO boxes): TMA never writes them for a row
    // tile, so zeros once make them add nothing to dV and dK
    constexpr int kChunks = S::T::kSwizzle / 16;  // of 16 bytes in a row
    const int tail = (kRows - p.tile_rows) * kChunks;
    uint4* tiles = reinterpret_cast<uint4*>(smem_raw + (ring - raw));
    for (int idx = threadIdx.x; idx < S::kStages * 4 * tail; idx += kThreads) {
      tiles[idx / tail * (S::kRowBox / 16) + p.tile_rows * kChunks + idx % tail] =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: per item its operands, then its row tiles or key tiles -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (const CUtensorMap* map : {&tmq, &tmdo, &tmqw, &tmdow, &tmkw, &tmvw}) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
                     : "memory");
      }
      const long long plane = static_cast<long long>(p.batch) * p.hkv * p.rows_pad;
      int ru = 0;  // ring tiles loaded before this item
      // ring tile number ru: wait for its stage, then count `bytes` on its bar
      auto next_stage = [&](uint32_t bytes) {
        const int s = ru % S::kStages;
        tc::mbar_wait(r_empty + 8 * s, ((ru / S::kStages) & 1) ^ 1);  // stage released
        tc::mbar_expect_tx(r_full + 8 * s, bytes);
        ++ru;
        return s;
      };
      for (int ic = 0;; ++ic) {
        const int slot = ic & 1;
        const uint32_t full = op_full + 8 * slot;
        tc::mbar_wait(op_empty + 8 * slot, ((ic >> 1) & 1) ^ 1);  // its last item is done
        const int item = atomicAdd(w.next, 1);
        if (item >= w.n_items) {  // none left: the consumers stop at -1
          slots[slot] = -1;
          tc::mbar_arrive(full);
          break;
        }
        slots[slot] = item;  // published by the arrival below
        const BwdItem it = bwd_item(p, w, item);
        const uint32_t op = op_s + slot * S::kOp;
        if (it.dkdv) {
          // K and V of keys 128j .. 128j + 127: both consumers' key tiles
          // (zeros past Skv)
          const int key0 = 2 * it.idx * kKeys;
          tc::mbar_expect_tx(full, S::kOp);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            tc::tma_load(op + i * S::kWideBox, &tmkw, full, 64 * i, it.hk, key0, it.b);
            tc::tma_load(op + (2 + i) * S::kWideBox, &tmvw, full, 64 * i, it.hk, key0, it.b);
          }
          const float* stat = p.delta + static_cast<long long>(it.b * p.hkv + it.hk) * p.rows_pad;
          for (int t = pair_first_tile<kCausal>(p, w, it.idx); t < w.n_rt; ++t) {
            const int s = next_stage(4 * p.tile_rows * S::T::kSwizzle + S::kStats);
            const uint32_t bar = r_full + 8 * s, stage = ring + s * S::kStage;
            const int i0 = t * (p.tile_rows / p.g);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              tma_load_rows(stage + i * S::kRowBox, &tmq, bar, 64 * i, it.hk, i0, it.b);
              tma_load_rows(stage + (2 + i) * S::kRowBox, &tmdo, bar, 64 * i, it.hk, i0, it.b);
            }
            bulk_load(st_s + s * S::kStats, stat + t * kRows, kRows * 4, bar);
            bulk_load(st_s + s * S::kStats + kRows * 4, stat + plane + t * kRows, kRows * 4, bar);
          }
        } else {
          const int i0 = it.idx * (w.q_rows / p.g);
          tc::mbar_expect_tx(full, 4 * w.q_rows * S::T::kSwizzle);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            tma_load_rows(op + i * S::kWideBox, &tmqw, full, 64 * i, it.hk, i0, it.b);
            tma_load_rows(op + (2 + i) * S::kWideBox, &tmdow, full, 64 * i, it.hk, i0, it.b);
          }
          const int n = dq_key_tiles<kCausal>(p, w, it.idx);
          for (int t = 0; t < n; ++t) {
            for (const CUtensorMap* map : {&tmvw, &tmkw}) {  // V_t, then K_t
              const int s = next_stage(S::kStage);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                tc::tma_load(ring + s * S::kStage + i * S::kWideBox, map, r_full + 8 * s, 64 * i,
                             it.hk, t * tc::kKeys, it.b);
              }
            }
          }
        }
      }
    }
  } else {
    // -- consumer c: keys of tile 2j + c of a dK/dV item, rows 64c ..
    // 64c + 63 of a dQ item ---------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    int ru = 0;  // ring tiles taken before this item
    for (int ic = 0;; ++ic) {
      const int slot = ic & 1;
      tc::mbar_wait(op_full + 8 * slot, (ic >> 1) & 1);
      const int item = slots[slot];
      if (item < 0) break;
      const BwdItem it = bwd_item(p, w, item);
      const uint32_t op = op_s + slot * S::kOp;
      if (it.dkdv) {
        d128_dkdv<kCausal>(p, w, it, op, op_empty + 8 * slot, ring, r_full, r_empty, stats, ru, c,
                           warp, lane, dk, dv);
        ru += w.n_rt - pair_first_tile<kCausal>(p, w, it.idx);
      } else {
        d128_dq<kCausal>(p, w, it, op, op_empty + 8 * slot, ring, r_full, r_empty, ru, c, warp,
                         lane, dq);
        ru += 2 * dq_key_tiles<kCausal>(p, w, it.idx);
      }
    }
  }
}

}  // namespace tcb

// -- host ---------------------------------------------------------------------------

template <typename T, int D, int Dv>
const void* pick_causal(bool causal) {
  return causal ? reinterpret_cast<const void*>(&flash_attention_kernel<T, D, Dv, true>)
                : reinterpret_cast<const void*>(&flash_attention_kernel<T, D, Dv, false>);
}

template <int D, int Dv>
const void* pick_tc(bool causal) {
  return causal ? reinterpret_cast<const void*>(&tc::flash_attention_tc<D, Dv, true>)
                : reinterpret_cast<const void*>(&tc::flash_attention_tc<D, Dv, false>);
}

// One instantiation with its block: function, threads, dynamic shared
// bytes, its tiling (folded rows per block, keys per tile, K/V tiles in
// flight) and, for the tensor-core body, the swizzle (bytes) of its K/V boxes.
struct Body {
  const void* fn = nullptr;
  int threads = 0, smem = 0, rows = 0, keys = 0, stages = 0, swizzle = 0;
};

template <int D, int Dv>
Body body_d(int dtype, bool causal) {
  if (dtype == kBF16) {
    if constexpr (D != Dv) {  // MLA's (192, 128): the persistent flash_mla_fwd
      return {causal ? reinterpret_cast<const void*>(&tc::flash_mla_fwd<true>)
                     : reinterpret_cast<const void*>(&tc::flash_mla_fwd<false>),
              tc::kThreads, tc::MlaFwd::kSmem, tc::kRows, tc::kKeys, tc::MlaFwd::kStages,
              tc::MlaFwd::K::kSwizzle};
    } else if constexpr (D == 64 || D == 128) {  // the persistent flash_group_fwd
      using G = tc::GroupFwd<D>;
      return {causal ? reinterpret_cast<const void*>(&tc::flash_group_fwd<D, true>)
                     : reinterpret_cast<const void*>(&tc::flash_group_fwd<D, false>),
              tc::kThreads, G::kSmem, tc::kRows, tc::kKeys, G::kStages, G::T::kSwizzle};
    } else {
      return {pick_tc<D, Dv>(causal), tc::kThreads, tc::Fwd<D, Dv>::kSmem, tc::kRows, tc::kKeys,
              tc::Fwd<D, Dv>::kStages, tc::Tile<D>::kSwizzle};
    }
  }
  if (dtype == kF32) {
    return {pick_causal<float, D, Dv>(causal), kThreads, 4 * smem_floats<D, Dv>(), kRows, kKeys,
            1, 0};
  }
  return {};
}

// The (D, Dv) pairs the forward is built for: Dv = D at 32, 64 and 128, and
// MLA's (192, 128).
Body pick(int dtype, int d, int dv, bool causal) {
  if (d == 32 && dv == 32) return body_d<32, 32>(dtype, causal);
  if (d == 64 && dv == 64) return body_d<64, 64>(dtype, causal);
  if (d == 128 && dv == 128) return body_d<128, 128>(dtype, causal);
  if (d == 192 && dv == 128) return body_d<192, 128>(dtype, causal);
  return {};
}

// Dynamic shared memory above 48 KB must be allowed per kernel; ask for the
// largest carveout so that two f32 blocks fit on one SM.  Once per kernel
// function and device (a function always asks for the same bytes): the
// launches after the first skip both calls.
cudaError_t prepare(const void* fn, int bytes) {
  struct Prepared {
    const void* fn;
    int dev;
  };
  static thread_local Prepared done[128];
  static thread_local int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_done; ++i) {
    if (done[i].fn == fn && done[i].dev == dev) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && n_done < 128) done[n_done++] = {fn, dev};
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found{};
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// The (D, Hkv, Skv, B) view of k or v, cut into boxes of (swizzle / 2, 1,
// keys, 1) under that swizzle.  strides: elements of (batch, seq, head).
cudaError_t kv_map(CUtensorMap* map, const void* base, int d, int hkv, int skv, int batch,
                   const long long* strides, int swizzle, int keys) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(hkv),
                              static_cast<cuuint64_t>(skv), static_cast<cuuint64_t>(batch)};
  cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                         static_cast<cuuint64_t>(strides[1]) * 2,
                         static_cast<cuuint64_t>(strides[0]) * 2};
  for (int i = 0; i < 3; ++i) {  // an extent of 1 is never stepped: any valid stride
    if (dims[i + 1] == 1) bytes[i] = i == 0 ? dims[0] * 2 : bytes[i - 1] * dims[i];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(swizzle / 2), 1,
                             static_cast<cuuint32_t>(keys), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, bytes, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The (D, G, Hkv, S, B) view of q or dout (element strides of (batch, seq,
// head)), cut into boxes of (swizzle / 2, G, 1, rows / G, 1): G * (rows / G)
// folded rows of one kv head (query f / G, head f % G of its group) under
// that swizzle.  G <= rows: the backward's tiles of tcb::kRows (64) rows,
// flash_group_fwd's of tc::kRows (128).
cudaError_t row_map(CUtensorMap* map, const void* base, int d, int g, int hkv, int sq, int batch,
                    const long long* strides, int swizzle, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(g),
                              static_cast<cuuint64_t>(hkv), static_cast<cuuint64_t>(sq),
                              static_cast<cuuint64_t>(batch)};
  cuuint64_t bytes[4] = {static_cast<cuuint64_t>(strides[2]) * 2,
                         static_cast<cuuint64_t>(strides[2]) * g * 2,
                         static_cast<cuuint64_t>(strides[1]) * 2,
                         static_cast<cuuint64_t>(strides[0]) * 2};
  for (int i = 0; i < 4; ++i) {  // an extent of 1 is never stepped: any valid stride
    if (dims[i + 1] == 1) bytes[i] = i == 0 ? dims[0] * 2 : bytes[i - 1] * dims[i];
  }
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(swizzle / 2), static_cast<cuuint32_t>(g), 1,
                             static_cast<cuuint32_t>(rows / g), 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, bytes, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Key tiles of 128 that the rows f0 .. f1 - 1 of a row tile see: up to the
// last that its last row sees where causal, else all (a forward item's, or
// a dQ item's).
int seen_key_tiles(int f0, int f1, int g, int sq, int skv, int q_offset, bool causal) {
  const int key_tiles = (skv + tc::kKeys - 1) / tc::kKeys;
  if (!causal) return key_tiles;
  const int last = (f1 < sq * g ? f1 : sq * g) - 1;
  const int seen_tiles = (last / g + q_offset) / tc::kKeys + 1;
  return key_tiles < seen_tiles ? key_tiles : seen_tiles;
}

// A persistent kernel's chunk of heads (flash_mla_fwd, flash_group_fwd,
// tcb::flash_bwd_d64 and flash_bwd_d128): its work list holds n_bh heads (batch * kv heads) of
// the same n_per items, cost[i] the weight of a head's i-th item (a head
// lists them heaviest first), in chunks of `chunk` heads whose items run
// rank by rank, heads fastest.  The chunk is the one of kChunks (at most the
// heads) whose list, dealt to `grid` blocks, gives the least largest block:
// in turn (block j takes items j, j + grid, ...: the forwards) or by load
// (each item to the block that frees first: the backward's blocks claim
// items from a counter); the smaller chunk on a tie, whose heads' operands
// stay in L2.  The last few answers are kept: a model calls it at one shape
// again and again.
int work_chunk(int n_bh, const int* cost, int n_per, int grid, bool by_load) {
  constexpr int kChunks[] = {1, 2, 4, 6, 8, 12, 16, 24, 32};
  constexpr int kMaxGrid = 1024;
  constexpr int kSeen = 32;  // a training step's shapes, forward and backward
  unsigned long long hash = 1469598103934665603ULL;  // FNV-1a over the costs
  for (int i = 0; i < n_per; ++i) hash = (hash ^ static_cast<unsigned>(cost[i])) * 1099511628211ULL;
  struct Key {
    int n_bh, n_per, grid, by_load, chunk;
    unsigned long long hash;
  };
  static thread_local Key seen[kSeen];
  static thread_local int next = 0;
  for (const Key& k : seen) {
    if (k.chunk > 0 && k.n_bh == n_bh && k.n_per == n_per && k.grid == grid &&
        k.by_load == (by_load ? 1 : 0) && k.hash == hash) {
      return k.chunk;
    }
  }
  const long long items = static_cast<long long>(n_bh) * n_per;
  int best = 16;  // past kMaxGrid blocks or 2^20 items (2^16 by load) no search
  long long best_span = -1;
  if (grid <= kMaxGrid && items <= (by_load ? (1 << 16) : (1 << 20))) {
    long long load[kMaxGrid];
    for (const int chunk : kChunks) {
      if (chunk > n_bh && chunk > 1) break;
      for (int i = 0; i < grid; ++i) load[i] = 0;
      int blk = 0;  // the block that takes the next item (in turn)
      for (int c0 = 0; c0 < n_bh; c0 += chunk) {
        const int heads = n_bh - c0 < chunk ? n_bh - c0 : chunk;
        for (int rank = 0; rank < n_per; ++rank) {
          for (int j = 0; j < heads; ++j) {
            if (by_load) {  // load[] a min-heap: the block that frees first takes it
              std::pop_heap(load, load + grid, std::greater<long long>());
              load[grid - 1] += cost[rank];
              std::push_heap(load, load + grid, std::greater<long long>());
            } else {
              load[blk] += cost[rank];
              blk = blk + 1 == grid ? 0 : blk + 1;
            }
          }
        }
      }
      long long largest = 0;
      for (int i = 0; i < grid; ++i) largest = load[i] > largest ? load[i] : largest;
      if (best_span < 0 || largest < best_span) best = chunk, best_span = largest;
    }
  }
  seen[next] = {n_bh, n_per, grid, by_load ? 1 : 0, best, hash};
  next = (next + 1) % kSeen;
  return best;
}

// A persistent forward's chunk: its items are row tiles of tile_rows folded
// rows, the heaviest (the last) first, each weighing its key tiles plus half
// a tile (its Q load and O store).
int fwd_chunk(int n_bh, int n_rt, int tile_rows, int g, int sq, int skv, int q_offset,
              bool causal, int grid) {
  constexpr int kMaxCosts = 4096;  // past them the search is skipped (work_chunk's default)
  if (n_rt > kMaxCosts) return 16;
  int cost[kMaxCosts];
  for (int rank = 0; rank < n_rt; ++rank) {
    const int row0 = (n_rt - 1 - rank) * tile_rows;
    cost[rank] = 2 * seen_key_tiles(row0, row0 + tile_rows, g, sq, skv, q_offset, causal) + 1;
  }
  return work_chunk(n_bh, cost, n_rt, grid, false);
}

// MLA's bf16 attention at (192, 128), G = 1: q = [q_nope | q_rope], k =
// [k_nope | k_rope] with k_rope of rope_heads heads (1: shared by every
// head, or heads).  strides[18]: element strides of (batch, seq, head) of
// q_nope, q_rope, k_nope, k_rope, v and o.
cudaError_t launch_mla_fwd(const void* qn, const void* qr, const void* kn, const void* kr,
                           const void* v, void* o, void* lse, int batch, int sq, int skv, int heads,
                           int rope_heads, const long long* strides, bool causal, int q_offset,
                           float scale, cudaStream_t stream) {
  const Body body = body_d<192, 128>(kBF16, causal);
  if (batch <= 0 || sq <= 0 || skv <= 0 || heads <= 0 || q_offset < 0 ||
      (rope_heads != 1 && rope_heads != heads) ||
      static_cast<long long>(batch) * heads * ((sq + tc::kRows - 1) / tc::kRows) > (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  tc::MlaParams p;
  p.heads = heads;
  p.rope_heads = rope_heads;
  p.sq = sq;
  p.skv = skv;
  p.q_offset = q_offset;
  p.scale = scale;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[15 + i];
  p.lse = static_cast<float*>(lse);
  p.n_rt = (sq + tc::kRows - 1) / tc::kRows;
  p.n_bh = batch * heads;
  p.n_items = p.n_bh * p.n_rt;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = n_sm < p.n_items ? n_sm : p.n_items;
  p.chunk = fwd_chunk(p.n_bh, p.n_rt, tc::kRows, 1, sq, skv, q_offset, causal, grid);
  CUtensorMap tmqn, tmqr, tmkn, tmkr, tmv;
  const int sw = tc::MlaFwd::K::kSwizzle;
  err = kv_map(&tmqn, qn, 128, heads, sq, batch, strides, sw, tc::kRows);
  if (err == cudaSuccess) err = kv_map(&tmqr, qr, 64, heads, sq, batch, strides + 3, sw, tc::kRows);
  if (err == cudaSuccess) err = kv_map(&tmkn, kn, 128, heads, skv, batch, strides + 6, sw, tc::kKeys);
  if (err == cudaSuccess) {
    err = kv_map(&tmkr, kr, 64, rope_heads, skv, batch, strides + 9, sw, tc::kKeys);
  }
  if (err == cudaSuccess) err = kv_map(&tmv, v, 128, heads, skv, batch, strides + 12, sw, tc::kKeys);
  if (err == cudaSuccess) err = prepare(body.fn, body.smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&tmqn, &tmqr, &tmkn, &tmkr, &tmv, &o, &p};
  err = cudaLaunchKernel(body.fn, dim3(static_cast<unsigned>(grid)), dim3(body.threads), args,
                         body.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// bf16 at D = Dv = 64 or 128, any G <= 128: flash_group_fwd over a work list
// of (batch * kv head, tile of G * (128 / G) folded rows) items, q read by a
// TMA map of whole query groups.
template <int D>
cudaError_t launch_group_fwd(const void* q, const void* k, const void* v, void* o,
                             const Params& p, int batch, const long long* strides, bool causal,
                             cudaStream_t stream) {
  const Body body = body_d<D, D>(kBF16, causal);
  if (p.g > tc::kRows || static_cast<long long>(p.sq) * p.g > 65535LL * tc::kRows) {
    return cudaErrorInvalidValue;  // whole query groups in a tile; rows as the other bodies'
  }
  tc::GroupParams gp;
  gp.sq = p.sq;
  gp.skv = p.skv;
  gp.g = p.g;
  gp.hkv = p.hkv;
  gp.q_offset = p.q_offset;
  gp.tile_rows = p.g * (tc::kRows / p.g);
  gp.scale = p.scale;
  for (int i = 0; i < 3; ++i) gp.os[i] = p.os[i];
  gp.lse = p.lse;
  gp.n_rt = (p.sq * p.g + gp.tile_rows - 1) / gp.tile_rows;
  gp.n_bh = batch * p.hkv;
  if (static_cast<long long>(gp.n_bh) * gp.n_rt > (1LL << 30)) return cudaErrorInvalidValue;
  gp.n_items = gp.n_bh * gp.n_rt;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = n_sm < gp.n_items ? n_sm : gp.n_items;
  gp.chunk = fwd_chunk(gp.n_bh, gp.n_rt, gp.tile_rows, p.g, p.sq, p.skv, p.q_offset, causal,
                       grid);
  CUtensorMap tmq, tmk, tmv;
  err = row_map(&tmq, q, D, p.g, p.hkv, p.sq, batch, strides, body.swizzle, tc::kRows);
  if (err == cudaSuccess) {
    err = kv_map(&tmk, k, D, p.hkv, p.skv, batch, strides + 3, body.swizzle, body.keys);
  }
  if (err == cudaSuccess) {
    err = kv_map(&tmv, v, D, p.hkv, p.skv, batch, strides + 6, body.swizzle, body.keys);
  }
  if (err == cudaSuccess) err = prepare(body.fn, body.smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&tmq, &tmk, &tmv, &o, &gp};
  err = cudaLaunchKernel(body.fn, dim3(static_cast<unsigned>(grid)), dim3(body.threads), args,
                         body.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One kernel of the backward: function, dynamic shared bytes and its tiling
// (folded rows per tile, keys per tile, tiles in flight).
struct BwdKernel {
  const void* fn = nullptr;
  int smem = 0, rows = 0, keys = 0, stages = 0;
};

// The backward of one (dtype, d, dv, causal): the delta pass, the dK/dV and
// dQ kernels, their threads per block, whether it is the tensor-core body
// (folded statistics planes, paired key tiles, TMA maps), and the head dim
// of the persistent kernel (dkdv and dq name it both) that runs both after
// its own delta pass (bf16 at D = Dv = 64 and 128: bwd::flash_bwd_delta_vec,
// tcb::flash_bwd_d64 and tcb::flash_bwd_d128), else 0.
struct BwdBody {
  const void* delta = nullptr;
  BwdKernel dkdv, dq;
  int threads = 0;
  bool tc = false;
  int persistent = 0;
};

template <int D, int Dv>
BwdBody bwd_body_f32(bool causal) {
  BwdBody body;
  body.delta = reinterpret_cast<const void*>(&bwd::flash_bwd_delta<float, Dv, false>);
  body.dkdv = {causal ? reinterpret_cast<const void*>(&bwd::flash_bwd_dkdv<float, D, Dv, true>)
                      : reinterpret_cast<const void*>(&bwd::flash_bwd_dkdv<float, D, Dv, false>),
               4 * bwd::smem_floats_dkdv<D, Dv>(), bwd::kRows, bwd::kKeys, 1};
  body.dq = {causal ? reinterpret_cast<const void*>(&bwd::flash_bwd_dq<float, D, Dv, true>)
                    : reinterpret_cast<const void*>(&bwd::flash_bwd_dq<float, D, Dv, false>),
             4 * bwd::smem_floats_dq<D, Dv>(), bwd::kRows, bwd::kKeys, 1};
  body.threads = bwd::kThreads;
  return body;
}

template <int D, int Dv>
BwdBody bwd_body_tc(bool causal) {
  using Kv = tcb::Dkdv<D, Dv>;
  using Q = tcb::Dq<D, Dv>;
  BwdBody body;
  if constexpr (D != Dv) {  // MLA's (192, 128): its own kernels on the split operands
    body.delta = reinterpret_cast<const void*>(&bwd::flash_bwd_delta_mla);
    body.dkdv = {causal ? reinterpret_cast<const void*>(&tcb::flash_bwd_dkdv_mla<true>)
                        : reinterpret_cast<const void*>(&tcb::flash_bwd_dkdv_mla<false>),
                 tcb::MlaDkdv::kSmem, tcb::kRows, tcb::kKeys, tcb::MlaDkdv::kStages};
    body.dq = {causal ? reinterpret_cast<const void*>(&tcb::flash_bwd_dq_mla<true>)
                      : reinterpret_cast<const void*>(&tcb::flash_bwd_dq_mla<false>),
               Q::kSmem, tcb::kDqRows, Q::kKeys, Q::kStages};
  } else if constexpr (D == 64) {  // one persistent launch over both kinds of item
    using S = tcb::D64Bwd;
    const void* fn = causal ? reinterpret_cast<const void*>(&tcb::flash_bwd_d64<true>)
                            : reinterpret_cast<const void*>(&tcb::flash_bwd_d64<false>);
    body.delta = reinterpret_cast<const void*>(&bwd::flash_bwd_delta_vec<64>);
    body.dkdv = {fn, S::kSmem, tcb::kRows, tcb::kKeys, S::kKvStages};
    body.dq = {fn, S::kSmem, tcb::kDqRows, tc::kKeys, S::kQStages};
    body.persistent = 64;
  } else if constexpr (D == 128) {  // the same, on one ring for both kinds of item
    using S = tcb::D128Bwd;
    const void* fn = causal ? reinterpret_cast<const void*>(&tcb::flash_bwd_d128<true>)
                            : reinterpret_cast<const void*>(&tcb::flash_bwd_d128<false>);
    body.delta = reinterpret_cast<const void*>(&bwd::flash_bwd_delta_vec<128>);
    body.dkdv = {fn, S::kSmem, tcb::kRows, tcb::kKeys, S::kStages};
    body.dq = {fn, S::kSmem, tcb::kDqRows, tc::kKeys, S::kStages};
    body.persistent = 128;
  } else {
    body.delta = reinterpret_cast<const void*>(&bwd::flash_bwd_delta<__nv_bfloat16, Dv, true>);
    body.dkdv = {causal ? reinterpret_cast<const void*>(&tcb::flash_bwd_dkdv_tc<D, Dv, true>)
                        : reinterpret_cast<const void*>(&tcb::flash_bwd_dkdv_tc<D, Dv, false>),
                 Kv::kSmem, tcb::kRows, tcb::kKeys, Kv::kStages};
    body.dq = {causal ? reinterpret_cast<const void*>(&tcb::flash_bwd_dq_tc<D, Dv, true>)
                      : reinterpret_cast<const void*>(&tcb::flash_bwd_dq_tc<D, Dv, false>),
               Q::kSmem, tcb::kDqRows, Q::kKeys, Q::kStages};
  }
  body.threads = tcb::kThreads;
  body.tc = true;
  return body;
}

template <int D, int Dv>
BwdBody bwd_body_d(int dtype, bool causal) {
  if (dtype == kBF16) return bwd_body_tc<D, Dv>(causal);
  if (dtype == kF32) return bwd_body_f32<D, Dv>(causal);
  return {};
}

// The (D, Dv) pairs the backward is built for: the forward's (pick's).
BwdBody pick_bwd(int dtype, int d, int dv, bool causal) {
  if (d == 32 && dv == 32) return bwd_body_d<32, 32>(dtype, causal);
  if (d == 64 && dv == 64) return bwd_body_d<64, 64>(dtype, causal);
  if (d == 128 && dv == 128) return bwd_body_d<128, 128>(dtype, causal);
  if (d == 192 && dv == 128) return bwd_body_d<192, 128>(dtype, causal);
  return {};
}

}  // namespace

// Attention on `stream`.  q (batch, sq, hq, d), k (batch, skv, hkv, d), v
// (batch, skv, hkv, dv), o (batch, sq, hq, dv); (d, dv) one of pick's pairs;
// strides[12] holds the element strides of (batch, seq, head) for q, k, v
// and o in that order (the last dim is contiguous).
// lse: null, or (batch, hq, sq) f32 that receives each row's log-sum-exp
// (the backward's input; o is the same bits either way).
// dtype: 0 f32, 1 bf16 (strides in multiples of 8, 16-byte aligned bases).
// Returns the launch's cudaError_t (0 = queued).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int batch, int sq, int skv, int hq, int hkv, int d,
                                   int dv, const long long* strides, int causal, int q_offset,
                                   float scale, int dtype, void* stream) {
  const Body body = pick(dtype, d, dv, causal != 0);
  if (body.fn == nullptr || batch <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
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
  p.lse = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && d != dv) {
    // MLA's (192, 128), G = 1: flash_mla_fwd on q and k as nope and rope views
    if (p.g != 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    long long split[18];
    for (int i = 0; i < 3; ++i) {
      split[i] = split[3 + i] = strides[i];
      split[6 + i] = split[9 + i] = strides[3 + i];
      split[12 + i] = strides[6 + i];
      split[15 + i] = strides[9 + i];
    }
    return static_cast<int>(launch_mla_fwd(qb, qb + 128, kb, kb + 128, v, o, lse, batch, sq, skv,
                                           hq, hkv, split, causal != 0, q_offset, scale, st));
  }
  if (dtype == kBF16 && d == 64) {
    return static_cast<int>(launch_group_fwd<64>(q, k, v, o, p, batch, strides, causal != 0, st));
  }
  if (dtype == kBF16 && d == 128) {
    return static_cast<int>(launch_group_fwd<128>(q, k, v, o, p, batch, strides, causal != 0,
                                                   st));
  }
  cudaError_t err = prepare(body.fn, body.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_tiles = (static_cast<long long>(sq) * p.g + body.rows - 1) / body.rows;
  if (dtype == kBF16) {
    if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tmk, tmv;
    err = kv_map(&tmk, k, d, hkv, skv, batch, strides + 3, body.swizzle, body.keys);
    if (err == cudaSuccess) {
      err = kv_map(&tmv, v, dv, hkv, skv, batch, strides + 6, body.swizzle, body.keys);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(batch * hkv), static_cast<unsigned>(row_tiles));
    void* args[] = {&tmk, &tmv, const_cast<void**>(&q), &o, &p};
    err = cudaLaunchKernel(body.fn, grid, dim3(body.threads), args, body.smem, st);
  } else {
    const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(batch * hkv));
    void* args[] = {const_cast<void**>(&q), const_cast<void**>(&k), const_cast<void**>(&v), &o,
                    &p};
    err = cudaLaunchKernel(body.fn, grid, dim3(body.threads), args, body.smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// MLA's attention, bf16 at (D, Dv) = (192, 128), G = 1, on `stream`, from
// its parts: q = [q_nope (batch, sq, heads, 128) | q_rope (.., 64)], k =
// [k_nope (batch, skv, heads, 128) | k_rope (batch, skv, rope_heads, 64)]
// (rope_heads 1: one rope channel for every head, or heads), v (batch, skv,
// heads, 128) -> o (batch, sq, heads, 128), and lse as flash_attention_fwd's.
// strides[18]: element strides of (batch, seq, head) of q_nope, q_rope,
// k_nope, k_rope, v and o (16-byte rows and bases, as TMA reads them).
// Returns the launch's cudaError_t (0 = queued).
extern "C" int flash_attention_mla_fwd(const void* q_nope, const void* q_rope, const void* k_nope,
                                       const void* k_rope, const void* v, void* o, void* lse,
                                       int batch, int sq, int skv, int heads, int rope_heads,
                                       const long long* strides, int causal, int q_offset,
                                       float scale, void* stream) {
  return static_cast<int>(launch_mla_fwd(q_nope, q_rope, k_nope, k_rope, v, o, lse, batch, sq, skv,
                                         heads, rope_heads, strides, causal != 0, q_offset, scale,
                                         static_cast<cudaStream_t>(stream)));
}

// One instantiation's per-block budget: out = {numRegs, dynamic shared
// bytes, local (spill) bytes, maxThreadsPerBlock, threads per block,
// resident blocks/SM, folded rows per block, keys per tile, K/V tiles in
// flight}.
extern "C" int flash_attention_attributes(int dtype, int d, int dv, int causal, int* out) {
  const Body body = pick(dtype, d, dv, causal != 0);
  if (body.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(body.fn, body.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, body.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, body.fn, body.threads, body.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = body.smem;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  out[4] = body.threads;
  out[5] = blocks;
  out[6] = body.rows;
  out[7] = body.keys;
  out[8] = body.stages;
  return 0;
}

// f32 words of the backward's `delta` scratch for one call: (batch, hq, sq)
// for the f32 body, two folded planes of (batch * hkv, padded rows) for the
// bf16 body and, after them, the persistent kernels' work counter
// (kCounterWords).
extern "C" long long flash_attention_bwd_scratch(int dtype, int batch, int sq, int hq, int hkv) {
  if (batch <= 0 || sq <= 0 || hkv <= 0 || hq % hkv != 0) return 0;
  if (dtype == kBF16) {  // the planes, then the persistent kernels' work counter
    return 2LL * batch * hkv * tcb::plane_slots(static_cast<long long>(sq) * (hq / hkv), hq / hkv) +
           tcb::kCounterWords;
  }
  return static_cast<long long>(batch) * hq * sq;
}

namespace {

// The backward's operands: q and k as a nope part (d - 64 wide at (192,
// 128), else all of d) and a rope part (q_rope, k_rope: (192, 128) only),
// k_rope of rope_heads heads; strides[30]: element strides of (batch, seq,
// head) of q, k, v, o, dout, dq, dk, dv, q_rope and k_rope in that order.
struct BwdArgs {
  const void *q, *k, *v, *o, *dout, *lse, *q_rope, *k_rope;
  void *delta, *dq, *dk, *dv;
  int batch, sq, skv, hq, hkv, d, dv_dim, rope_heads;
  const long long* strides;
  bool causal;
  int q_offset;
  float scale;
};

// The persistent backward's work list (flash_bwd_d64's and flash_bwd_d128's:
// the same items) at one shape on n_sm SMs: all of *w but the counter, and
// the grid (one block per SM, at most one per item).
cudaError_t persistent_bwd_plan(const bwd::Params& p, bool causal, int n_sm, tcb::BwdWork* out,
                                int* grid_out) {
  tcb::BwdWork w;
  const int rows = p.sq * p.g;
  w.n_kt = (p.skv + tcb::kKeys - 1) / tcb::kKeys;
  w.n_rt = (rows + p.tile_rows - 1) / p.tile_rows;
  w.q_rows = p.g * (tc::kRows / p.g);
  w.n_qt = (rows + w.q_rows - 1) / w.q_rows;
  w.n_pairs = (w.n_kt + 1) / 2;
  w.n_per = w.n_pairs + w.n_qt;
  w.n_bh = p.batch * p.hkv;
  if (static_cast<long long>(w.n_bh) * w.n_per > (1LL << 30)) return cudaErrorInvalidValue;
  w.n_items = w.n_bh * w.n_per;
  const int grid = n_sm < w.n_items ? n_sm : w.n_items;
  // A head's items and their weights: each kind heaviest first (the pairs
  // from j = 0, the dQ row tiles from the last), the kind whose heaviest
  // weighs more first.  The weights are estimates (they order and chunk the
  // list; the bits do not depend on them), in tenths of a row tile of 64 on
  // one consumer: 13 a tile where both consumers run at once (the tensor
  // cores then serve two chains), a dQ key tile of 128 one and a half such
  // tiles (20), an item's start and end 5.
  constexpr int kMaxCosts = 4096;  // past them no search: work_chunk's chunk
  std::vector<int> cost(static_cast<size_t>(w.n_per));
  auto chain = [&](int tile) {  // row tiles of 64 that key tile `tile` walks
    if (tile >= w.n_kt) return 0;
    const int key = tile * tcb::kKeys;
    const int f = causal ? std::min(std::max(key - p.q_offset, 0), p.sq) * p.g : 0;
    return f < rows ? w.n_rt - f / p.tile_rows : 0;  // tcb::first_tile's
  };
  int* kv_cost = cost.data();
  int* q_cost = cost.data() + w.n_pairs;
  for (int j = 0; j < w.n_pairs; ++j) {
    const int c0 = chain(2 * j), c1 = chain(2 * j + 1);
    const int lo = std::min(c0, c1), hi = std::max(c0, c1);
    kv_cost[j] = 10 * (hi - lo) + 13 * lo + 5;
  }
  for (int i = 0; i < w.n_qt; ++i) {
    const int row0 = (w.n_qt - 1 - i) * w.q_rows;
    q_cost[i] = 20 * seen_key_tiles(row0, row0 + w.q_rows, p.g, p.sq, p.skv, p.q_offset,
                                    causal) + 5;
  }
  w.q_first = q_cost[0] > kv_cost[0] ? 1 : 0;
  if (w.q_first) std::rotate(cost.begin(), cost.begin() + w.n_pairs, cost.end());
  w.chunk = w.n_per <= kMaxCosts ? work_chunk(w.n_bh, cost.data(), w.n_per, grid, true) : 16;
  w.next = nullptr;
  *out = w;
  *grid_out = grid;
  return cudaSuccess;
}

// bf16 at D = Dv = 64 or 128: the delta pass (bwd::flash_bwd_delta_vec,
// which also zeroes the work counter), then tcb::flash_bwd_d64 or
// tcb::flash_bwd_d128 over the heads' dK/dV and dQ items (persistent_bwd_plan).
// The counter is the scratch's last kCounterWords words.
template <int D>
cudaError_t launch_persistent_bwd(const BwdArgs& a, const bwd::Params& p, const BwdBody& body,
                                  cudaStream_t st) {
  int dev = 0, n_sm = 0, grid = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  tcb::BwdWork w;
  if (err == cudaSuccess) err = persistent_bwd_plan(p, a.causal, n_sm, &w, &grid);
  if (err != cudaSuccess) return err;
  w.next = reinterpret_cast<int*>(p.delta + 2LL * a.batch * a.hkv * p.rows_pad);
  const int sw = tc::Tile<D>::kSwizzle;
  // q and dout as row tiles of 64 and 128 folded rows, k and v as tiles of
  // 64 keys (D=64: a dK/dV item's operands) and of 128
  CUtensorMap tmq, tmdo, tmqw, tmdow, tmk, tmv, tmkw, tmvw;
  err = row_map(&tmq, a.q, D, p.g, a.hkv, a.sq, a.batch, a.strides, sw, tcb::kRows);
  if (err == cudaSuccess) {
    err = row_map(&tmdo, a.dout, D, p.g, a.hkv, a.sq, a.batch, a.strides + 12, sw, tcb::kRows);
  }
  if (err == cudaSuccess) {
    err = row_map(&tmqw, a.q, D, p.g, a.hkv, a.sq, a.batch, a.strides, sw, tc::kRows);
  }
  if (err == cudaSuccess) {
    err = row_map(&tmdow, a.dout, D, p.g, a.hkv, a.sq, a.batch, a.strides + 12, sw, tc::kRows);
  }
  if (err == cudaSuccess && D == 64) {
    err = kv_map(&tmk, a.k, D, a.hkv, a.skv, a.batch, a.strides + 3, sw, tcb::kKeys);
  }
  if (err == cudaSuccess && D == 64) {
    err = kv_map(&tmv, a.v, D, a.hkv, a.skv, a.batch, a.strides + 6, sw, tcb::kKeys);
  }
  if (err == cudaSuccess) {
    err = kv_map(&tmkw, a.k, D, a.hkv, a.skv, a.batch, a.strides + 3, sw, tc::kKeys);
  }
  if (err == cudaSuccess) {
    err = kv_map(&tmvw, a.v, D, a.hkv, a.skv, a.batch, a.strides + 6, sw, tc::kKeys);
  }
  if (err != cudaSuccess) return err;
  const long long n_rows = static_cast<long long>(a.batch) * a.hkv * p.rows_pad;
  void* delta_args[] = {const_cast<void**>(&a.o), const_cast<void**>(&a.dout),
                        const_cast<bwd::Params*>(&p), &w.next};
  err = cudaLaunchKernel(
      body.delta,
      dim3(static_cast<unsigned>((n_rows + bwd::kVecDeltaRows - 1) / bwd::kVecDeltaRows)),
      dim3(bwd::kThreads), delta_args, 0, st);
  if (err != cudaSuccess) return err;
  void* args64[] = {&tmq, &tmdo, &tmqw, &tmdow, &tmk, &tmv, &tmkw, &tmvw,
                    const_cast<void**>(&a.dq), const_cast<void**>(&a.dk),
                    const_cast<void**>(&a.dv), const_cast<bwd::Params*>(&p), &w};
  void* args128[] = {&tmq, &tmdo, &tmqw, &tmdow, &tmkw, &tmvw,
                     const_cast<void**>(&a.dq), const_cast<void**>(&a.dk),
                     const_cast<void**>(&a.dv), const_cast<bwd::Params*>(&p), &w};
  err = cudaLaunchKernel(body.dkdv.fn, dim3(static_cast<unsigned>(grid)), dim3(body.threads),
                         D == 64 ? args64 : args128, body.dkdv.smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_bwd(const BwdArgs& a, int dtype, cudaStream_t st) {
  const BwdBody body = pick_bwd(dtype, a.d, a.dv_dim, a.causal);
  const long long rows = static_cast<long long>(a.sq) * (a.hkv > 0 ? a.hq / a.hkv : 0);
  const bool mla = body.tc && a.d != a.dv_dim;  // (192, 128): split operands, G = 1
  if (body.delta == nullptr || a.batch <= 0 || a.sq <= 0 || a.skv <= 0 || a.hkv <= 0 ||
      a.hq % a.hkv != 0 || a.q_offset < 0 || (rows + body.dq.rows - 1) / body.dq.rows > 65535 ||
      (a.skv + body.dkdv.keys - 1) / body.dkdv.keys > 65535 ||
      (body.tc && a.hq / a.hkv > tcb::kRows) ||
      (mla && (a.hq != a.hkv || (a.rope_heads != 1 && a.rope_heads != a.hkv)))) {
    return cudaErrorInvalidValue;
  }
  bwd::Params p;
  p.batch = a.batch;
  p.sq = a.sq;
  p.skv = a.skv;
  p.g = a.hq / a.hkv;
  p.hkv = a.hkv;
  p.q_offset = a.q_offset;
  p.scale = a.scale;
  long long* dst[10] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs, p.qrs, p.krs};
  for (int t = 0; t < 10; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = a.strides[3 * t + i];
  p.rope_heads = a.rope_heads;
  if (a.rope_heads == 1) p.krs[2] = 0;  // every head reads the one rope channel
  p.lse = static_cast<const float*>(a.lse);
  p.delta = static_cast<float*>(a.delta);
  p.rows_pad = body.tc ? static_cast<int>(tcb::plane_slots(rows, p.g)) : 0;
  p.tile_rows = body.tc ? tcb::tile_rows(p.g) : 0;
  const int swizzle = a.d >= 64 ? 128 : 64;  // tc::Tile<D>::kSwizzle (Tile<Dv>'s too)
  cudaError_t err = prepare(body.dkdv.fn, body.dkdv.smem);
  if (err == cudaSuccess) err = prepare(body.dq.fn, body.dq.smem);
  if (err != cudaSuccess) return err;
  if (body.persistent == 64) return launch_persistent_bwd<64>(a, p, body, st);
  if (body.persistent == 128) return launch_persistent_bwd<128>(a, p, body, st);
  const long long n_rows = body.tc ? static_cast<long long>(a.batch) * a.hkv * p.rows_pad
                                   : static_cast<long long>(a.batch) * a.sq * a.hq;
  void* delta_args[] = {const_cast<void**>(&a.o), const_cast<void**>(&a.dout), &p};
  const int delta_rows = mla ? bwd::kMlaDeltaRows : bwd::kDeltaRows;  // rows a block
  err = cudaLaunchKernel(
      body.delta, dim3(static_cast<unsigned>((n_rows + delta_rows - 1) / delta_rows)),
      dim3(bwd::kThreads), delta_args, 0, st);
  if (err != cudaSuccess) return err;
  // dK/dV: one block per (batch * kv head, key tile), or pair of key tiles
  // in the tensor-core body; at (192, 128) one per key tile, those of a
  // head side by side
  const int key_tiles = (a.skv + body.dkdv.keys - 1) / body.dkdv.keys;
  const unsigned bh = static_cast<unsigned>(a.batch * a.hkv);
  const unsigned kv_tiles = static_cast<unsigned>(body.tc && !mla ? (key_tiles + 1) / 2
                                                                  : key_tiles);
  const dim3 kv_grid = mla ? dim3(kv_tiles, bh) : dim3(bh, kv_tiles);
  const int nope = mla ? a.d - 64 : a.d;  // q's and k's columns in their first part
  if (mla) {
    CUtensorMap tmq, tmqr, tmdo;
    err = row_map(&tmq, a.q, nope, p.g, a.hkv, a.sq, a.batch, a.strides, swizzle, tcb::kRows);
    if (err == cudaSuccess) {
      err = row_map(&tmqr, a.q_rope, 64, p.g, a.hkv, a.sq, a.batch, a.strides + 24, swizzle,
                    tcb::kRows);
    }
    if (err == cudaSuccess) {
      err = row_map(&tmdo, a.dout, a.dv_dim, p.g, a.hkv, a.sq, a.batch, a.strides + 12, swizzle,
                    tcb::kRows);
    }
    if (err != cudaSuccess) return err;
    void* dkdv_args[] = {&tmq, &tmqr, &tmdo, const_cast<void**>(&a.k),
                         const_cast<void**>(&a.k_rope), const_cast<void**>(&a.v),
                         const_cast<void**>(&a.dk), const_cast<void**>(&a.dv), &p};
    err = cudaLaunchKernel(body.dkdv.fn, kv_grid, dim3(body.threads), dkdv_args, body.dkdv.smem,
                           st);
  } else if (body.tc) {
    CUtensorMap tmq, tmdo;
    err = row_map(&tmq, a.q, a.d, p.g, a.hkv, a.sq, a.batch, a.strides, swizzle, tcb::kRows);
    if (err == cudaSuccess) {
      err = row_map(&tmdo, a.dout, a.dv_dim, p.g, a.hkv, a.sq, a.batch, a.strides + 12, swizzle,
                    tcb::kRows);
    }
    if (err != cudaSuccess) return err;
    void* dkdv_args[] = {&tmq, &tmdo, const_cast<void**>(&a.q), const_cast<void**>(&a.k),
                         const_cast<void**>(&a.v), const_cast<void**>(&a.dout),
                         const_cast<void**>(&a.dk), const_cast<void**>(&a.dv), &p};
    err = cudaLaunchKernel(body.dkdv.fn, kv_grid, dim3(body.threads), dkdv_args, body.dkdv.smem,
                           st);
  } else {
    void* dkdv_args[] = {const_cast<void**>(&a.q), const_cast<void**>(&a.k),
                         const_cast<void**>(&a.v), const_cast<void**>(&a.dout),
                         const_cast<void**>(&a.dk), const_cast<void**>(&a.dv), &p};
    err = cudaLaunchKernel(body.dkdv.fn, kv_grid, dim3(body.threads), dkdv_args, body.dkdv.smem,
                           st);
  }
  if (err != cudaSuccess) return err;
  const unsigned row_tiles = static_cast<unsigned>((rows + body.dq.rows - 1) / body.dq.rows);
  const dim3 q_grid = mla ? dim3(row_tiles, bh) : dim3(bh, row_tiles);
  if (body.tc) {
    CUtensorMap tmk, tmkr, tmv;
    err = kv_map(&tmk, a.k, nope, a.hkv, a.skv, a.batch, a.strides + 3, swizzle, body.dq.keys);
    if (err == cudaSuccess && mla) {
      err = kv_map(&tmkr, a.k_rope, 64, a.rope_heads, a.skv, a.batch, a.strides + 27, swizzle,
                   body.dq.keys);
    }
    if (err == cudaSuccess) {
      err = kv_map(&tmv, a.v, a.dv_dim, a.hkv, a.skv, a.batch, a.strides + 6, swizzle,
                   body.dq.keys);
    }
    if (err != cudaSuccess) return err;
    void* mla_args[] = {&tmk, &tmkr, &tmv, const_cast<void**>(&a.q),
                        const_cast<void**>(&a.q_rope), const_cast<void**>(&a.dout),
                        const_cast<void**>(&a.dq), &p};
    void* dq_args[] = {&tmk, &tmv, const_cast<void**>(&a.q), const_cast<void**>(&a.dout),
                       const_cast<void**>(&a.dq), &p};
    err = cudaLaunchKernel(body.dq.fn, q_grid, dim3(body.threads), mla ? mla_args : dq_args,
                           body.dq.smem, st);
  } else {
    void* dq_args[] = {const_cast<void**>(&a.q), const_cast<void**>(&a.k),
                       const_cast<void**>(&a.v), const_cast<void**>(&a.dout),
                       const_cast<void**>(&a.dq), &p};
    err = cudaLaunchKernel(body.dq.fn, q_grid, dim3(body.threads), dq_args, body.dq.smem, st);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The gradient of flash_attention_fwd on `stream`: q, k (head dim d), v, o
// (the forward's output), dout (dv) and lse (the forward's, (batch, hq, sq)
// f32) in; dq, dk, dv out, in the operands' dtype; (d, dv) one of
// pick_bwd's pairs; delta: f32 scratch of
// flash_attention_bwd_scratch words.  strides[24] holds the element
// strides of (batch, seq, head) for q, k, v, o, dout, dq, dk and dv in that
// order (the last dim contiguous; bf16: q, k, v and dout in multiples of 8
// from 16-byte aligned bases, as cp.async and TMA read them).  Three
// launches: delta, then dK/dV and dQ (bf16 at D = Dv = 64 and 128 two:
// delta, then flash_bwd_d64 or flash_bwd_d128 over both).  Returns the first failing launch's
// cudaError_t (0 = all queued).  bf16 at (192, 128) takes G = 1 and reads q
// and k as nope and rope views (flash_attention_mla_bwd).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int batch, int sq, int skv, int hq,
                                   int hkv, int d, int dv_dim, const long long* strides,
                                   int causal, int q_offset, float scale, int dtype,
                                   void* stream) {
  long long all[30];
  for (int i = 0; i < 24; ++i) all[i] = strides[i];
  for (int i = 0; i < 3; ++i) all[24 + i] = strides[i], all[27 + i] = strides[3 + i];
  const bool mla = dtype == kBF16 && d != dv_dim;
  const int off = mla ? d - 64 : 0;  // the rope part's first column
  BwdArgs a{q, k, v, o, dout, lse,
            static_cast<const __nv_bfloat16*>(q) + off, static_cast<const __nv_bfloat16*>(k) + off,
            delta, dq, dk, dv, batch, sq, skv, hq, hkv, d, dv_dim, hkv, all, causal != 0,
            q_offset, scale};
  return static_cast<int>(launch_bwd(a, dtype, static_cast<cudaStream_t>(stream)));
}

// The gradient of flash_attention_mla_fwd, bf16 at (192, 128), G = 1, on
// `stream`: q_nope, q_rope, k_nope, k_rope (rope_heads heads), v, o, dout and
// lse in; dq (batch, sq, heads, 192) and dk (batch, skv, heads, 192: the rope
// gradient of every head, which the caller sums where rope_heads is 1) and
// dv out; delta as flash_attention_bwd's.  strides[30]: element strides of
// (batch, seq, head) of q_nope, k_nope, v, o, dout, dq, dk, dv, q_rope and
// k_rope in that order.
extern "C" int flash_attention_mla_bwd(const void* q_nope, const void* q_rope,
                                       const void* k_nope, const void* k_rope, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int batch,
                                       int sq, int skv, int heads, int rope_heads,
                                       const long long* strides, int causal, int q_offset,
                                       float scale, void* stream) {
  BwdArgs a{q_nope, k_nope, v, o, dout, lse, q_rope, k_rope, delta, dq, dk, dv, batch, sq, skv,
            heads, heads, 192, 128, rope_heads, strides, causal != 0, q_offset, scale};
  return static_cast<int>(launch_bwd(a, kBF16, static_cast<cudaStream_t>(stream)));
}

// The backward's budget: out = {numRegs, dynamic shared bytes, local
// (spill) bytes, threads per block, resident blocks/SM, folded rows per
// tile, keys per tile, tiles in flight} of the dK/dV kernel (which = 0) or
// the dQ kernel (which = 1) at (d, dv); bf16 at (64, 64) and (128, 128)
// both are the persistent kernel, with each role's tiling.
extern "C" int flash_attention_bwd_attributes(int dtype, int d, int dv, int causal, int which,
                                              int* out) {
  const BwdBody body = pick_bwd(dtype, d, dv, causal != 0);
  const BwdKernel& kern = which == 0 ? body.dkdv : body.dq;
  if (kern.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(kern.fn, kern.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern.fn, body.threads, kern.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = kern.smem;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = body.threads;
  out[4] = blocks;
  out[5] = kern.rows;
  out[6] = kern.keys;
  out[7] = kern.stages;
  return 0;
}

// The persistent backward's work list (flash_bwd_d64 and flash_bwd_d128) at
// one shape on n_sm SMs, as the host plans it
// and its blocks decode it: plan[3] = {q_first, chunk, items}; items (if
// not null, room for max_items) holds 4 ints an item in the order the
// blocks claim them: dK/dV (1) or dQ (0), batch, kv head, and the pair j
// (key tiles 2j and 2j + 1) or the row tile.  cudaErrorInvalidValue for a
// shape the kernel does not take or past max_items.
extern "C" int flash_attention_bwd_plan(int batch, int sq, int skv, int hq, int hkv, int causal,
                                        int q_offset, int n_sm, int* plan, int* items,
                                        int max_items) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      hq / hkv > tcb::kRows || q_offset < 0 || n_sm <= 0) {
    return cudaErrorInvalidValue;
  }
  bwd::Params p{};
  p.batch = batch;
  p.sq = sq;
  p.skv = skv;
  p.g = hq / hkv;
  p.hkv = hkv;
  p.q_offset = q_offset;
  p.tile_rows = tcb::tile_rows(p.g);
  tcb::BwdWork w;
  int grid = 0;
  const cudaError_t err = persistent_bwd_plan(p, causal != 0, n_sm, &w, &grid);
  if (err != cudaSuccess) return err;
  plan[0] = w.q_first;
  plan[1] = w.chunk;
  plan[2] = w.n_items;
  if (items == nullptr) return cudaSuccess;
  if (w.n_items > max_items) return cudaErrorInvalidValue;
  for (int i = 0; i < w.n_items; ++i) {
    const tcb::BwdItem it = tcb::bwd_item(p, w, i);
    items[4 * i] = it.dkdv;
    items[4 * i + 1] = it.b;
    items[4 * i + 2] = it.hk;
    items[4 * i + 3] = it.idx;
  }
  return cudaSuccess;
}

// Every csrc library exports this name; the wrappers raise with it.
extern "C" const char* su3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
