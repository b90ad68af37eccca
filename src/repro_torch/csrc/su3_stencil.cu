// su3_stencil.cu — the nearest-neighbour SU(3) stencil and the fused CG
// iteration body for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/su3_stencil.py:
//  * su3_stencil_planar (body _su3_stencil_kernel over _stencil_tile),
//    registered there as "pallas_stencil":
//      out(x) = sum_mu U_mu(x) v(x + mu) + U_mu(x)^dagger v(x - mu);
//  * su3_cg_fused_planar (body _su3_cg_fused_kernel), registered there as
//    "pallas_cg": p' = r + beta p at the centre and at the 8 neighbours,
//    then the same stencil on p'_nbr; writes (p', S(p')).
// The neighbour gather stays outside both kernels, as in the reference: the
// plan fills a direction-major (8, 2, 3, S) block per vector field.
//
// What bounds them on this card: HBM bytes.  The stencil streams 126 words
// per site (U 72, 8 neighbour vectors 48, out 6; 102 with two-row links)
// for 576 flops: 1.1 flop/byte at f32, far below the H100 SXM's FP32 ridge
// of 67 TFLOP/s over 3.35 TB/s = 20 flop/byte.  The CG body streams 192
// words per site (a second neighbour block, r, p and a second output) for
// about the same flops.
//
// How the design deals with that:
//  * One thread per site; a warp takes 32 consecutive sites, so every load
//    and store of a warp is one contiguous segment: v_nbr[d][p][l][s] sits
//    at ((d*2 + p)*3 + l)*S + s, and U at the SoA or AoSoA offsets of
//    su3_mult.cu (AoSoA is read in place, no transposing copy).  Each word
//    is read once and each output written once; nothing is staged in
//    shared memory because no word is reused across threads.
//  * The thread walks mu = 0..3: it loads that link's 18 words (12 with
//    two-row storage, plus row 2 rebuilt in registers) and the 12 words of
//    its two neighbours, and folds them into 6 f32 accumulators.
//  * Rounding: every product, sum and difference is an explicit __fmul_rn /
//    __fadd_rn / __fsub_rn in the reference's order (mu outer, then l,
//    forward before backward; each colour's sum starts from its first term,
//    not from 0.0f, so no -0.0 flips to +0.0).  nvcc contracts nothing into
//    an FMA, so the kernels equal their plain PyTorch versions
//    (repro_torch/kernels/su3_stencil.py) bit for bit, a site subset gives
//    the bits of the full pass, and the fused CG body's p' = r + beta p (a
//    product, then a sum) equals the plan's composed axpy at f32.
//  * Pure bf16 rounds to bf16 after every operation, as the reference's bf16
//    jnp ops do, and agrees with it bit for bit; bf16 storage with f32
//    accumulation widens on load, runs in f32 and narrows once on store.
//  * Two-row links: the adjoint reads link columns, so row 2 is rebuilt,
//    conj(row0 x row1), in f32 with the reference's operand grouping, and
//    narrowed to bf16 under pure bf16.
//  * beta is read from coefs[0] in device memory: data, so an iteration
//    needs no host round trip and no new build.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block, one site each
constexpr int kLinks = 4;

// storage / arithmetic modes, as passed from Python (shared with su3_mult.cu)
constexpr int kModeF32 = 0;        // f32 words, f32 arithmetic
constexpr int kModeBF16 = 1;       // bf16 words, rounded to bf16 per operation
constexpr int kModeBF16AccF32 = 2; // bf16 words, f32 arithmetic, rounded on store

constexpr int kStencil = 0;  // kernel ids of su3_stencil_attributes
constexpr int kCG = 1;

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

// Where one site's link words sit: word (p, row) at first + row*row_stride
// + p*plane_stride.  SoA (2, rows, S) or AoSoA (S/lane, 2, rows, lane).
struct LinkAddr {
  int64_t first, row_stride, plane_stride;
};

template <int NR, bool AOSOA>
__device__ __forceinline__ LinkAddr link_addr(int64_t s, int64_t n_sites, int lane) {
  constexpr int rows = kLinks * NR * 3;
  LinkAddr a;
  if (AOSOA) {
    const int64_t tile = s / lane;
    a.first = tile * 2 * rows * lane + (s - tile * lane);
    a.row_stride = lane;
  } else {
    a.first = s;
    a.row_stride = n_sites;
  }
  a.plane_stride = static_cast<int64_t>(rows) * a.row_stride;
  return a;
}

// Link mu of one site as a full 3x3 complex matrix in f32.  Two-row storage
// (NR == 2) rebuilds row 2 = conj(r0[l1]*r1[l2] - r0[l2]*r1[l1]) with the
// grouping ((ar*br) - (ai*bi)) - ((cr*dr) - (ci*di)) and
// ((ar*bi) + (ai*br)) - ((cr*di) + (ci*dr)), each op rounded on its own in
// f32, then narrowed to bf16 under pure bf16.
template <typename T, int NR, bool R>
__device__ __forceinline__ void load_link(const T* u, const LinkAddr& a, int mu,
                                          float (&lr)[3][3], float (&li)[3][3]) {
#pragma unroll
  for (int k = 0; k < NR; ++k) {
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const int64_t o = a.first + static_cast<int64_t>((mu * NR + k) * 3 + l) * a.row_stride;
      lr[k][l] = widen(u[o]);
      li[k][l] = widen(u[o + a.plane_stride]);
    }
  }
  if (NR == 2) {
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const int l1 = (l + 1) % 3, l2 = (l + 2) % 3;
      const float ar = lr[0][l1], ai = li[0][l1], br = lr[1][l2], bi = li[1][l2];
      const float cr = lr[0][l2], ci = li[0][l2], dr = lr[1][l1], di = li[1][l1];
      const float xr = __fsub_rn(__fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi)),
                                 __fsub_rn(__fmul_rn(cr, dr), __fmul_rn(ci, di)));
      const float xi = __fsub_rn(__fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br)),
                                 __fadd_rn(__fmul_rn(cr, di), __fmul_rn(ci, dr)));
      lr[2][l] = rnd<R>(xr);
      li[2][l] = rnd<R>(-xi);  // conjugate
    }
  }
}

// The stencil of one site.  nbr(d, p, l) gives the f32 value of neighbour
// direction d (+x +y +z +t -x -y -z -t), part p (re, im), colour l.
// Per colour k, in the reference's _stencil_tile order: for mu, for l,
//   forward   tr = ur*vr - ui*vi,  ti = ur*vi + ui*vr   with U[mu, k, l]
//   backward  sr = ur*vr + ui*vi,  si = ur*vi - ui*vr   with U[mu, l, k]
// the sum starting from the first forward term.
template <typename T, int NR, bool R, class Nbr>
__device__ __forceinline__ void stencil_site(const T* u, const LinkAddr& a, const Nbr& nbr,
                                             float (&out_r)[3], float (&out_i)[3]) {
#pragma unroll
  for (int mu = 0; mu < kLinks; ++mu) {
    float lr[3][3], li[3][3];
    load_link<T, NR, R>(u, a, mu, lr, li);
    float vfr[3], vfi[3], vbr[3], vbi[3];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      vfr[l] = nbr(mu, 0, l);
      vfi[l] = nbr(mu, 1, l);
      vbr[l] = nbr(kLinks + mu, 0, l);
      vbi[l] = nbr(kLinks + mu, 1, l);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const float tr = sub<R>(mul<R>(lr[k][l], vfr[l]), mul<R>(li[k][l], vfi[l]));
        const float ti = add<R>(mul<R>(lr[k][l], vfi[l]), mul<R>(li[k][l], vfr[l]));
        if (mu == 0 && l == 0) {
          out_r[k] = tr;
          out_i[k] = ti;
        } else {
          out_r[k] = add<R>(out_r[k], tr);
          out_i[k] = add<R>(out_i[k], ti);
        }
        const float sr = add<R>(mul<R>(lr[l][k], vbr[l]), mul<R>(li[l][k], vbi[l]));
        const float si = sub<R>(mul<R>(lr[l][k], vbi[l]), mul<R>(li[l][k], vbr[l]));
        out_r[k] = add<R>(out_r[k], sr);
        out_i[k] = add<R>(out_i[k], si);
      }
    }
  }
}

// Neighbours read from one gathered (8, 2, 3, S) block.
template <typename T>
struct GatheredNbr {
  const T* v;
  int64_t s, n;
  __device__ __forceinline__ float operator()(int d, int p, int l) const {
    return widen(v[static_cast<int64_t>((d * 2 + p) * 3 + l) * n + s]);
  }
};

// Neighbours of p' = r + beta p, formed from the gathered r and p blocks:
// gathering is indexing, so this equals gathering p'.
template <typename T, bool R>
struct AxpyNbr {
  const T* r;
  const T* p;
  int64_t s, n;
  float beta;
  __device__ __forceinline__ float operator()(int d, int q, int l) const {
    const int64_t o = static_cast<int64_t>((d * 2 + q) * 3 + l) * n + s;
    return add<R>(widen(r[o]), mul<R>(beta, widen(p[o])));
  }
};

template <typename T>
__device__ __forceinline__ void store_vec(T* out, int64_t s, int64_t n, const float (&vr)[3],
                                          const float (&vi)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k * n + s] = narrow<T>(vr[k]);
    out[(3 + k) * n + s] = narrow<T>(vi[k]);
  }
}

// T: storage word; NR: stored rows per link (3 full, 2 two-row);
// R: round to bf16 after every operation (pure bf16); AOSOA: link layout.
template <typename T, int NR, bool R, bool AOSOA>
__global__ void __launch_bounds__(kThreads)
su3_stencil_kernel(const void* u_words, const void* v_words, void* out_words, int64_t n_sites,
                   int lane) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_sites) return;
  const T* u = static_cast<const T*>(u_words);
  const GatheredNbr<T> nbr{static_cast<const T*>(v_words), s, n_sites};
  float o_r[3], o_i[3];
  stencil_site<T, NR, R>(u, link_addr<NR, AOSOA>(s, n_sites, lane), nbr, o_r, o_i);
  store_vec(static_cast<T*>(out_words), s, n_sites, o_r, o_i);
}

template <typename T, int NR, bool R, bool AOSOA>
__global__ void __launch_bounds__(kThreads)
su3_cg_fused_kernel(const void* u_words, const void* rn_words, const void* pn_words,
                    const void* r_words, const void* p_words, const float* coefs,
                    void* pnew_words, void* s_words, int64_t n_sites, int lane) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_sites) return;
  const float beta = rnd<R>(coefs[0]);  // pure bf16 casts beta to bf16 first
  const T* r = static_cast<const T*>(r_words);
  const T* p = static_cast<const T*>(p_words);
  T* p_new = static_cast<T*>(pnew_words);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int64_t o = q * n_sites + s;
    p_new[o] = narrow<T>(add<R>(widen(r[o]), mul<R>(beta, widen(p[o]))));
  }
  const AxpyNbr<T, R> nbr{static_cast<const T*>(rn_words), static_cast<const T*>(pn_words), s,
                          n_sites, beta};
  float o_r[3], o_i[3];
  stencil_site<T, NR, R>(static_cast<const T*>(u_words), link_addr<NR, AOSOA>(s, n_sites, lane),
                         nbr, o_r, o_i);
  store_vec(static_cast<T*>(s_words), s, n_sites, o_r, o_i);
}

template <typename T, int NR, bool R, bool AOSOA>
const void* kernel_for(int which) {
  if (which == kStencil) return reinterpret_cast<const void*>(su3_stencil_kernel<T, NR, R, AOSOA>);
  return reinterpret_cast<const void*>(su3_cg_fused_kernel<T, NR, R, AOSOA>);
}

template <typename T, int NR, bool R>
const void* pick_layout(int which, int aosoa) {
  return aosoa ? kernel_for<T, NR, R, true>(which) : kernel_for<T, NR, R, false>(which);
}

const void* pick(int which, int mode, int compressed, int aosoa) {
  if (which != kStencil && which != kCG) return nullptr;
  switch (mode) {
    case kModeF32:
      return compressed ? pick_layout<float, 2, false>(which, aosoa)
                        : pick_layout<float, 3, false>(which, aosoa);
    case kModeBF16:
      return compressed ? pick_layout<__nv_bfloat16, 2, true>(which, aosoa)
                        : pick_layout<__nv_bfloat16, 3, true>(which, aosoa);
    case kModeBF16AccF32:
      return compressed ? pick_layout<__nv_bfloat16, 2, false>(which, aosoa)
                        : pick_layout<__nv_bfloat16, 3, false>(which, aosoa);
    default:
      return nullptr;
  }
}

int launch(const void* fn, int64_t n_sites, void** args, void* stream) {
  const dim3 grid(static_cast<unsigned>((n_sites + kThreads - 1) / kThreads));
  const dim3 block(kThreads);
  cudaError_t err = cudaLaunchKernel(fn, grid, block, args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sites(long long n_sites, int lane) {
  return n_sites <= 0 || lane < 0 || (lane > 0 && n_sites % lane != 0);
}

}  // namespace

// The stencil on `stream`.  u: SoA (2, rows, n_sites) when lane == 0, else
// AoSoA (n_sites / lane, 2, rows, lane); rows = 24 if compressed else 36.
// v_nbr: (8, 2, 3, n_sites); out: (2, 3, n_sites).  Returns the launch's
// cudaError_t (0 = queued).
extern "C" int su3_stencil_planar(const void* u, const void* v_nbr, void* out, long long n_sites,
                                  int lane, int mode, int compressed, void* stream) {
  const void* fn = pick(kStencil, mode, compressed, lane > 0);
  if (fn == nullptr || bad_sites(n_sites, lane)) return static_cast<int>(cudaErrorInvalidValue);
  int64_t n = n_sites;
  void* args[] = {const_cast<void**>(&u), const_cast<void**>(&v_nbr), &out, &n, &lane};
  return launch(fn, n, args, stream);
}

// The fused CG body on `stream`.  u as above; r_nbr, p_nbr: (8, 2, 3,
// n_sites); r, p: (2, 3, n_sites); coefs: device float[2] = {beta, sigma};
// p_new, s_out: (2, 3, n_sites).  Returns the launch's cudaError_t.
extern "C" int su3_cg_fused_planar(const void* u, const void* r_nbr, const void* p_nbr,
                                   const void* r, const void* p, const void* coefs, void* p_new,
                                   void* s_out, long long n_sites, int lane, int mode,
                                   int compressed, void* stream) {
  const void* fn = pick(kCG, mode, compressed, lane > 0);
  if (fn == nullptr || bad_sites(n_sites, lane)) return static_cast<int>(cudaErrorInvalidValue);
  int64_t n = n_sites;
  void* args[] = {const_cast<void**>(&u), const_cast<void**>(&r_nbr),
                  const_cast<void**>(&p_nbr), const_cast<void**>(&r),
                  const_cast<void**>(&p), const_cast<void**>(&coefs),
                  &p_new, &s_out, &n, &lane};
  return launch(fn, n, args, stream);
}

// One kernel's per-block budget: out = {numRegs, static shared bytes, local
// (spill) bytes, maxThreadsPerBlock, threads per block, resident blocks/SM}.
// which: 0 the stencil, 1 the CG body.
extern "C" int su3_stencil_attributes(int which, int mode, int compressed, int aosoa, int* out) {
  const void* fn = pick(which, mode, compressed, aosoa);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
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
