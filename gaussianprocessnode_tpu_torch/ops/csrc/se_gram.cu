// Squared-exponential Gram matrix on Hopper (sm_90a), float32.
//
//   K[m, n] = σ² · exp(−½ · max(‖z_m/ℓ‖² + ‖x_n/ℓ‖² − 2 (z_m/ℓ)·(x_n/ℓ), 0))
//
// Replaces gaussianprocessnode_tpu/ops/pallas_gram.py::_gram_kernel together
// with its wrapper se_gram_pallas (the 1/ℓ scaling, the row and column
// norms, the 1e3 padding and the slice back to (M, N)).
//
// What bounds it. At the serving shape (M = 600, D = 8, N = 30000) the
// kernel reads 0.96 MB and writes 72 MB: 21.8 µs at the H100's 3.35 TB/s;
// fill_ of the same output takes 23.3 µs on an H100 80GB HBM3 at 700 W.
// The arithmetic is not small beside that: per output 8 FMAs of the cross
// term and an epilogue of add, fma, clamp, scale, exp and the σ² product.
// Measured on that card with the stores removed, the first version's
// arithmetic (64 × 128 tiles, one block each) took nearly all of its time
// and this kernel's about three quarters: the time is the arithmetic, the
// work that precedes each output, and how far the store overlaps them
// (numbers in PERF.md).
//
// The design, and what each part does about that:
//
// 1. Persistent blocks over contiguous tile ranges. The launcher reads the
//    SM count and the resident blocks per SM once per device (2 per SM) and
//    launches at most that many blocks, so there is no wave ramp and no tail
//    of short-lived blocks. Block b takes tiles b·T/G .. (b+1)·T/G in column
//    strip order: consecutive tiles share their X columns. Tiles are 40 rows
//    × 256 columns: 600 = 15 × 40, so the kin40k shapes waste no tile row
//    (64-row tiles left the tenth row of tiles 62 % empty), and 256 columns
//    are a warp's 32 lanes × two float4s. Each thread holds 5 rows × 8
//    columns of accumulators. At 600 × 30000 that is 1,770 tiles, 6–7 per
//    block.
// 2. Resident inputs, prefetched. A block scales its X strip (256 × 8) and
//    the Z rows its range needs in that strip (at most 1,024 × 8) by ℓ once,
//    in shared memory, and its warps then walk the strip's tiles with no
//    barrier and no load from device memory. While one strip is used, the
//    next strip's X and Z rows arrive in the second buffer by cp.async.
//    Kernels that staged and scaled every tile's inputs (the first version,
//    and an early form of this one) spent a third of their instructions on
//    it. The scaling is the correctly rounded division the plain version
//    does, by Markstein's FMA correction from RN(1/ℓ) (fast_div below), with
//    the IEEE division for inputs outside 2^±40; the norms are FMAs in the
//    order of the dimensions. What is left before a block's first store is
//    its prologue: the copy and scaling of its first strip, and one tile.
// 3. Stores straight from registers, 16 bytes per lane (st.global.v4), so a
//    warp's row segment is one 512-byte store per column group and warps
//    store while others compute. Output tiles staged in shared memory and
//    sent with cp.async.bulk (lane 0 of each warp issuing and waiting on its
//    own bulk groups) were tried: level with these stores at 600 × 30000
//    and 20 % slower at 600 × 10000 (PERF.md), so they went. When
//    N % 4 ≠ 0 (or K is not 16-byte aligned) rows do not start on 16 bytes
//    and the launcher picks, by shape, 4-byte stores.
// 4. A cheaper exp. exp(−½·d²) = 2^(d²·(−½·log2 e)) on the MUFU unit
//    (ex2.approx.ftz). Rounding: the product d²·(−½·log2 e) carries a
//    relative error ≤ ε (the rounded constant and the product), which moves
//    K by at most σ²·ε·t·e^(−t) ≤ σ²·ε/e (t = d²/2); ex2.approx adds ≤ 2 ulp
//    of K; results below 2^−126 flush to 0, an absolute change below
//    σ²·1.2e−38. Together about 2.4 σ²·ε against the plain version's expf,
//    inside the 4 σ²·ε the chip check allows for exp and the σ² product (the
//    d² term of that bound is unchanged: the inputs are still divided by ℓ,
//    and the expanded form and the clamp at 0 are those of the plain
//    version, so the two differ in d² only by the order of the D-term sums).
// 5. No tensor cores: with D = 8 a wgmma tile would be almost all padding,
//    and TF32 would lose the full-precision cross term the JAX package pins.
//
// D > 8 takes 8 dimensions per pass: each tile restages both inputs per
// pass, with barriers, and carries accumulators and norms across passes.
// More Z rows than a window holds are staged per tile.
//
// -Xptxas -v on the H100 (nvcc 12.9, sm_90a): 128 registers, an 8-byte
// stack frame (8 bytes of spill), 88,576 bytes of dynamic shared memory per
// block, 2 blocks per SM.
//
// Interface: plain C, loaded with ctypes. ℓ and σ² are device pointers, so
// the serving path never synchronises with the host. The function returns
// cudaGetLastError() after the launch; the wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 40;                        // rows of Z per tile
constexpr int kRowsPerWarp = kBM / kWarps;     // rows each warp owns: warp + 8 i
constexpr int kColGroups = 2;                  // float4 column groups per lane
constexpr int kCols = 4 * kColGroups;          // columns each lane owns
constexpr int kBN = 128 * kColGroups;          // columns of X per tile (a strip)
constexpr int kDC = 8;                         // input dimensions resident per pass
constexpr int kWinRows = 1024;                 // rows of Z/ℓ a window holds
constexpr int kMaxD = 256;                     // keep equal to SE_GRAM_MAX_D in se_gram.py
constexpr int kMaxDevices = 64;
constexpr float kNegHalfLog2e = -0.72134752044448170368f;  // −½·log2(e)

// shared memory, in floats: two buffers, each an X/ℓ strip ([kDC][kBN]),
// its column norms ([kBN]) and a Z/ℓ window ([kWinRows][kDC], plus a
// tile's height of slack: the rows of a ragged last tile past M read from
// it and are never stored); then ℓ and RN(1/ℓ)
constexpr int kXs = kDC * kBN;
constexpr int kXn = kBN;
constexpr int kWin = (kWinRows + kBM) * kDC;
constexpr int kBuf = kXs + kXn + kWin;
constexpr int kOffLs = 2 * kBuf;
constexpr size_t kSmemBytes = (kOffLs + 2 * kMaxD) * sizeof(float);

static_assert(kBM % kWarps == 0, "each warp owns the same number of rows");
static_assert(kBN == kThreads, "one thread scales each staged column");
static_assert(kXs % 4 == 0 && kBuf % 4 == 0, "float4 reads stay 16-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global → shared; an invalid element writes a zero and reads nothing
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copy the raw inputs of (strip col0, dimensions k0 .. k0 + kDC) into a
// buffer: the X strip transposed, and Z rows z_lo .. z_hi. Columns past N
// and dimensions past D read as 0, which adds nothing to norms or cross
// terms.
__device__ __forceinline__ void stage(float* buf, const float* Z, const float* X,
                                      int N, int D, int col0, int k0, int z_lo,
                                      int z_hi, int tid) {
  for (int e = tid; e < kBN * kDC; e += kThreads) {
    const int c = e / kDC, k = e % kDC, n = col0 + c, d = k0 + k;
    const bool ok = n < N && d < D;
    cp_async_4(buf + k * kBN + c, ok ? X + (size_t)n * D + d : X, ok);
  }
  float* win = buf + kXs + kXn;
  for (int e = tid; e < (z_hi - z_lo) * kDC; e += kThreads) {
    const int m = z_lo + e / kDC, d = k0 + e % kDC;
    cp_async_4(win + e, Z + (size_t)m * D + d, d < D);
  }
  cp_async_commit();
}

// a / ℓ, correctly rounded, from rl = RN(1/ℓ): q = RN(a·rl) is within an
// ulp of a/ℓ, a − ℓ·q is exact in one FMA, and q + (a − ℓ·q)·rl rounds to
// RN(a/ℓ) (Markstein's correction) while no intermediate leaves the normal
// range. fast_div_ok says when that holds; other inputs (zeros among them)
// take the IEEE division. Three dependent operations and no branch, where
// the IEEE division is a reciprocal, four FMAs and a range-check branch per
// element: the divisions stop serialising a block's prologue.
__device__ __forceinline__ float fast_div(float a, float l, float rl) {
  const float q = a * rl;
  return fmaf(fmaf(-q, l, a), rl, q);
}

__device__ __forceinline__ bool fast_div_ok(float a, float rl) {
  const float aa = fabsf(a);
  return aa >= 0x1p-40f && aa <= 0x1p40f && rl != 0.f;
}

// Scale Z rows z_lo .. z_lo + z_rows of a window by ℓ in place.
__device__ __forceinline__ void scale_rows(float* win, const float* Z, const float* lsv,
                                           const float* lsr, int D, int k0, int z_lo,
                                           int z_rows, int tid) {
  bool ok = true;
  for (int e = tid; e < z_rows * kDC; e += kThreads) {
    const int d = k0 + e % kDC;
    if (d < D) {
      ok = ok && fast_div_ok(win[e], lsr[d]);
      win[e] = fast_div(win[e], lsv[d], lsr[d]);
    }
  }
  if (!ok)  // the IEEE division, from the raw values
    for (int e = tid; e < z_rows * kDC; e += kThreads) {
      const int d = k0 + e % kDC;
      if (d < D) win[e] = Z[(size_t)(z_lo + e / kDC) * D + d] / lsv[d];
    }
}

// Scale a staged buffer by ℓ in place: its X strip, one thread per column,
// which also carries the column norms over the chunks (from xn_prev, the
// other buffer's, after the first), the FMAs in the order of the
// dimensions; and its Z window. The fallback rereads the raw values from
// device memory, so no copy of them stays live in registers.
__device__ __forceinline__ void scale(float* buf, const float* xn_prev, const float* Z,
                                      const float* X, const float* lsv, const float* lsr,
                                      int N, int D, int col0, int k0, int z_lo, int z_rows,
                                      int tid) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kDC; ++k) {
    if (k0 + k < D) {
      float* v = buf + k * kBN + tid;
      ok = ok && fast_div_ok(*v, lsr[k0 + k]);
      *v = fast_div(*v, lsv[k0 + k], lsr[k0 + k]);
    }
  }
  if (!ok)  // the IEEE division, from the raw values
#pragma unroll
    for (int k = 0; k < kDC; ++k) {
      const int n = col0 + tid, d = k0 + k;
      if (d < D) buf[k * kBN + tid] = n < N ? X[(size_t)n * D + d] / lsv[d] : 0.f;
    }
  float sq = xn_prev ? xn_prev[tid] : 0.f;
#pragma unroll
  for (int k = 0; k < kDC; ++k)
    if (k0 + k < D) sq = fmaf(buf[k * kBN + tid], buf[k * kBN + tid], sq);
  buf[kXs + tid] = sq;
  scale_rows(buf + kXs + kXn, Z, lsv, lsr, D, k0, z_lo, z_rows, tid);
}

__global__ void __launch_bounds__(kThreads, 2)
se_gram_kernel(const float* __restrict__ Z, const float* __restrict__ X,
               const float* __restrict__ ls, int ls_len,
               const float* __restrict__ var, float* __restrict__ K,
               int M, int N, int D, int vec4) {
  extern __shared__ __align__(128) float smem[];
  float* lsv = smem + kOffLs;
  float* lsr = lsv + kMaxD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_tiles = (M + kBM - 1) / kBM;
  const long long tiles = (long long)row_tiles * ((N + kBN - 1) / kBN);
  const int chunks = (D + kDC - 1) / kDC;
  // a contiguous range of tiles, column strip by column strip, so that
  // consecutive tiles share their X columns
  const int t_begin = (int)(tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)(tiles * (blockIdx.x + 1) / gridDim.x);
  const int first_ct = t_begin / row_tiles, last_ct = (t_end - 1) / row_tiles;
  const int first_rt = t_begin % row_tiles, last_rt = (t_end - 1) % row_tiles;
  // the rows of Z the range needs in strip ct, and whether they fit a window
  const auto seg_lo = [&](int ct) { return ct == first_ct ? first_rt * kBM : 0; };
  const auto seg_hi = [&](int ct) {
    return ct == last_ct ? min(M, (last_rt + 1) * kBM) : M;
  };
  const auto seg_fits = [&](int ct) { return seg_hi(ct) - seg_lo(ct) <= kWinRows; };

  for (int d = tid; d < D; d += kThreads) {
    const float l = ls[ls_len == 1 ? 0 : d];
    lsv[d] = l;
    // 0 where ℓ itself is outside the range the fast division needs
    lsr[d] = fabsf(l) >= 0x1p-40f && fabsf(l) <= 0x1p40f ? __frcp_rn(l) : 0.f;
  }
  const float s2 = var[0];

  // the active buffer holds (strip a_ct, chunk a_chunk) and Z/ℓ rows
  // w_lo .. w_hi; with D ≤ kDC the other buffer is filled with the next
  // strip's inputs while this one is used
  int b = 1, a_ct = -1, a_chunk = -1, w_lo = 0, w_hi = 0, w_chunk = -1;
  bool prefetched = false;
  int rt = first_rt, ct = first_ct;

  for (int t = t_begin; t < t_end; ++t) {
    const int row0 = rt * kBM, col0 = ct * kBN;
    float acc[kRowsPerWarp][kCols], zz[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      zz[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    }
    for (int c = 0; c < chunks; ++c) {
      const int k0 = c * kDC;
      // every thread takes the same branches: the barriers are uniform
      if (ct != a_ct || c != a_chunk) {
        // a new strip (D ≤ kDC) or chunk: switch buffers, staging the new
        // one now unless it was prefetched
        const bool fits = seg_fits(ct);
        const int lo = fits ? seg_lo(ct) : 0, hi = fits ? seg_hi(ct) : 0;
        __syncthreads();  // nobody reads the buffer about to be refilled
        if (!(prefetched && ct == a_ct + 1))
          stage(smem + (b ^ 1) * kBuf, Z, X, N, D, col0, k0, lo, hi, tid);
        b ^= 1;
        cp_async_wait_all();
        __syncthreads();
        scale(smem + b * kBuf, c == 0 ? nullptr : smem + (b ^ 1) * kBuf + kXs, Z, X, lsv,
              lsr, N, D, col0, k0, lo, hi - lo, tid);
        __syncthreads();
        a_ct = ct;
        a_chunk = c;
        w_lo = lo;
        w_hi = hi;
        w_chunk = c;
        prefetched = chunks == 1 && ct < last_ct;
        if (prefetched) {
          const bool nf = seg_fits(ct + 1);
          stage(smem + (b ^ 1) * kBuf, Z, X, N, D, col0 + kBN, 0,
                nf ? seg_lo(ct + 1) : 0, nf ? seg_hi(ct + 1) : 0, tid);
        }
      }
      if (c != w_chunk || row0 < w_lo || min(row0 + kBM, M) > w_hi) {
        // more rows than a window holds: this tile's rows, staged now
        __syncthreads();
        w_lo = row0;
        w_hi = min(row0 + kBM, M);
        w_chunk = c;
        float* win = smem + b * kBuf + kXs + kXn;
        for (int e = tid; e < (w_hi - w_lo) * kDC; e += kThreads) {
          const int m = w_lo + e / kDC, d = k0 + e % kDC;
          cp_async_4(win + e, Z + (size_t)m * D + d, d < D);
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        scale_rows(win, Z, lsv, lsr, D, k0, w_lo, w_hi - w_lo, tid);
        __syncthreads();
      }

      // the cross term, and the row norms in the order of the dimensions
      const float* xc = smem + b * kBuf;
      const float* zc = xc + kXs + kXn + (row0 - w_lo) * kDC;
#pragma unroll
      for (int k = 0; k < kDC; ++k) {
        float z[kRowsPerWarp], x[kCols];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          z[i] = zc[(warp + i * kWarps) * kDC + k];
          zz[i] = fmaf(z[i], z[i], zz[i]);
        }
#pragma unroll
        for (int g = 0; g < kColGroups; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(xc + k * kBN + g * 128 + 4 * lane);
          x[4 * g] = v.x; x[4 * g + 1] = v.y; x[4 * g + 2] = v.z; x[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(z[i], x[j], acc[i][j]);
      }
    }
    if (++rt == row_tiles) {
      rt = 0;
      ++ct;
    }

    // epilogue: K = σ²·2^(max(d², 0)·(−½·log2 e)), stored from registers
    const float* xn = smem + b * kBuf + kXs;
    float xx[kCols];
#pragma unroll
    for (int g = 0; g < kColGroups; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(xn + g * 128 + 4 * lane);
      xx[4 * g] = v.x; xx[4 * g + 1] = v.y; xx[4 * g + 2] = v.z; xx[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int m = row0 + warp + i * kWarps;
      if (m >= M) continue;
      float v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float d2 = fmaf(-2.f, acc[i][j], zz[i] + xx[j]);
        v[j] = s2 * ex2_approx(fmaxf(d2, 0.f) * kNegHalfLog2e);
      }
      float* orow = K + (size_t)m * N;
      if (vec4) {
#pragma unroll
        for (int g = 0; g < kColGroups; ++g) {
          const int n = col0 + g * 128 + 4 * lane;  // N % 4 = 0: n < N ⇒ n + 3 < N
          if (n < N)
            *reinterpret_cast<float4*>(orow + n) =
                make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int n = col0 + j / 4 * 128 + 4 * lane + j % 4;
          if (n < N) orow[n] = v[j];
        }
      }
    }
  }
}

// resident blocks of se_gram_kernel on each device (0: not read yet)
int g_resident[kMaxDevices];

int resident_blocks(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_resident[dev] == 0) {
    err = cudaFuncSetAttribute(se_gram_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, se_gram_kernel,
                                                        kThreads, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (sms < 1 || per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    g_resident[dev] = sms * per_sm;
  }
  *out = g_resident[dev];
  return 0;
}

}  // namespace

extern "C" {

// K (M, N) = SE Gram of Z (M, D) and X (N, D), all row-major float32 on the
// device. ls points at ls_len (1 or D) lengthscales, var at σ². Returns the
// cudaError_t of the launch (0 on success).
int se_gram_f32(const float* Z, const float* X, const float* ls, int ls_len,
                const float* var, float* K, int M, int N, int D,
                void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || D > kMaxD ||
      (ls_len != 1 && ls_len != D))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // tile indices are ints
  int resident = 0;
  const int rc = resident_blocks(&resident);
  if (rc != 0) return rc;
  const int grid = (int)(tiles < resident ? tiles : resident);
  // 16-byte stores need 16-byte-aligned row starts: N % 4 = 0 and K aligned
  const int vec4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(K) % 16 == 0;
  se_gram_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      Z, X, ls, ls_len, var, K, M, N, D, vec4);
  return (int)cudaGetLastError();
}

const char* se_gram_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int se_gram_max_d(void) { return kMaxD; }

}  // extern "C"
