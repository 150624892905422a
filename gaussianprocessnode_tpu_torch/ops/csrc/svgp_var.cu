// The whitened SVGP's predictive mean and variance from its Gram, on Hopper
// (sm_90a), float32, column by column of the Gram K = K(Xu, X) (M, B):
//
//   Y = Lu⁻¹K,   mean = Yᵀm̃,   var = max(k(x, x) − ‖y‖² + ‖Ãᵀy‖², 1e-12)
//
// with Lu the lower Cholesky factor of Kuu and Ã the lower-triangular q(u)
// factor, both (M, M).
//
// It replaces no Pallas kernel: the JAX package (infer/svgp.py) leaves the
// triangular solve and the product with Ãᵀ to XLA, and the port ran them as
// cuBLAS trsm (with a copy of the Gram into the layout trsm takes), a dense
// sgemm for Ãᵀ·Y, and elementwise squares written out before their sums.
//
// What bounds it. The solve and the product are M²B multiply-adds each,
// 2M²B FLOPs in all where the zero triangles of Lu and Ã are skipped; at
// M = 512, B = 262,144 that is 1.37e11 FLOPs, 2.05 ms at the H100's 67
// TFLOP/s of float32 FMA (TF32 stays off: the configurations state it).
// Device memory is small beside that: the Gram is read once (537 MB, 0.16
// ms at 3.35 TB/s), and only the mean and the variance are written. But
// every tile of columns streams all of Lu's and Ã's lower triangles from
// L2 (1.1 MB a tile of 64 columns, 4.7 GB a call at the cell's shape), and
// shared memory feeds the FMAs. The design is about keeping the FMA pipes
// fed from those two:
//
// 1. Persistent blocks over column tiles. A block owns BN columns of the
//    Gram at a time (BN = 64 up to M = 512, 32 up to M = 1,024) and keeps
//    their Y (M × BN, at most 128 KB) in shared memory, so Y, Z = ÃᵀY and
//    their squares never reach device memory. Blocks walk tiles strided
//    by the grid; one block per SM at the cell's shape.
// 2. A blocked forward substitution, left-looking over panels of 64 rows:
//    Y[p] = K[p] − L[p, :p]·Y[:p] as a GEMM of register-tiled FFMAs,
//    then the 64 × 64 diagonal block solved in place by warps, each warp 8
//    columns with four lanes to a column: 4-row blocks substituted in a
//    lane and passed on by shuffles, with no block barrier.
//    Lu's zero triangle is never read outside the diagonal blocks.
// 3. The product Z = ÃᵀY by row panels of 64, each the same GEMM over
//    Y[q:]; each Z panel is squared and summed in registers as it is made.
//    m̃ᵀY and ‖y‖² are taken in the diagonal solve, from registers. The
//    three sums are carried in float64 and reduced in a fixed order, so
//    answers do not depend on the launch (a replayed graph gives the eager
//    call's bits).
// 4. The GEMMs' shape: a thread's block of the panel is 8 × 8, so four
//    128-bit shared loads feed 64 FMAs (with 4 × 4 blocks, two fed 16, and
//    the kernel ran 0.48 ms slower at the cell's shape on an H100); to keep
//    256 threads on a 64 × 64 panel, four groups of 64 threads split each
//    chunk's 64 k, their partial sums meeting at the panel's end through
//    two panel-sized buffers.
// 5. Lu's and Ã's 64 × 64 chunks stream from L2 through three shared-
//    memory buffers, two chunks in flight ahead of the one in use, in one
//    sequence over a tile's steps and on into the next tile's, one barrier
//    a step. One thread fetches a chunk with one TMA load completing on an
//    mbarrier (zeros past M from the tensor map; the upper triangle of Ã's
//    diagonal chunk zeroed in shared memory). TMA takes a chunk whose rows
//    lie along memory, so Lu comes column-major (as torch.linalg.cholesky
//    leaves it on the card) and Ã row-major, each column or row a multiple
//    of 16 bytes from the last; the wrapper lays them so where they do not
//    already lie so (an M² copy, for a ragged M or the other layout).
//    Measured at the cell's shape on an H100: TMA 5.18 ms, 16-byte
//    cp.async copies 6.04 ms (their 1,024 copies a chunk cost ~1.4 ms).
//    The next tile's Gram
//    panel q is loaded into registers in the step after this tile last
//    reads Y[q] (the product's chunk (q, q)), and stored in its place at
//    that step's end. Y's columns are swizzled by row so that the diagonal
//    solve meets no bank conflict.
//
// Any B (ragged tiles read zeros past B and store nothing there) and any
// M up to kMaxM (rows past M read zeros, with a unit pivot). Only the
// lower triangles of Lu and Ã are used.
//
// Interface: plain C, loaded with ctypes. The function returns
// cudaGetLastError() after the launch; the wrapper raises if it is not 0.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;            // rows of a panel of Lu, Y and Z; the inner length of a chunk
constexpr int kWS = kP;           // row stride of a staged chunk (a TMA box lands dense)
constexpr int kChunk = kP * kWS;  // floats of one staged chunk
constexpr int kMaxM = 1024;       // keep equal to SVGP_VAR_MAX_M in svgp_var.py
constexpr int kMaxPanels = kMaxM / kP;
constexpr int kMaxDevices = 64;

// BN columns a tile. The GEMMs split each chunk's 64 k four ways over four
// groups of BN threads; a thread holds an 8 × 8 block of the 64 × BN panel
// (rows 4tr + r and 32 + 4tr + r, columns 4tc + c and BN/2 + 4tc + c,
// r, c < 4), and the groups' partial sums meet at the panel's end.
template <int BN>
struct Tile {
  static constexpr int kThreads = 4 * BN;
  static constexpr int kMaxRows = 32768 / BN;  // the Y a block holds: 128 KB
};

template <int BN>
size_t smem_bytes(int panels) {
  const size_t rows = (size_t)panels * kP;
  // float64 sums [4][BN], Y [rows][BN], three chunks, two partial panels
  // [2][kP][BN], m̃ [rows], 1/diag [kP], three mbarriers
  return 4 * BN * sizeof(double) +
         sizeof(float) * (rows * BN + 3 * kChunk + 2 * kP * BN + rows + kP) + 4 * 8;
}

// Y's columns are swizzled by row: column c of row r lies at c ^ ysw(r), so
// that the diagonal solve's lanes (4 rows apart, one column) hit 32 banks
__device__ __forceinline__ int ysw(int row) { return ((row >> 2) & 3) << 3; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 or 16 bytes global → shared; an invalid copy writes zeros and reads nothing
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A chunk by the tensor memory accelerator: one 64 × 64 box of a tensor
// map, completing on an mbarrier that expects its bytes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void tma_chunk(float* dst, const CUtensorMap* map, int x, int y,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(kP * kP * 4) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%1], %2;\n"
      "selp.u32 %0, 1, 0, done;\n"
      "}\n" : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// a chunk that never lands ends the kernel with an error, not a hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int n = 0; !mbar_try(bar, parity); ++n)
    if (n > (1 << 22)) __trap();
}

// The steps of a tile, in order: the solve's panels p = 0 .. NP − 1, each
// over the chunks kc = 0 .. p of its inner dimension (kc = p: the diagonal
// block), then the product's panels p = 0 .. NP − 1 over kc = p .. NP − 1.
// Moves (phase, p, kc) to the next step; true when that starts a new tile.
__device__ __forceinline__ bool advance(int& phase, int& p, int& kc, int panels) {
  if (phase == 0) {
    if (kc < p) {
      ++kc;
    } else if (p + 1 < panels) {
      ++p;
      kc = 0;
    } else {
      phase = 1;
      p = 0;
      kc = 0;
    }
    return false;
  }
  if (kc + 1 < panels) {
    ++kc;
  } else if (p + 1 < panels) {
    ++p;
    kc = p;
  } else {
    phase = 0;
    p = 0;
    kc = 0;
    return true;
  }
  return false;
}

// Stage the chunk of step (phase, p, kc) by TMA as W[k][i], k the inner
// index (a row of Y), i the output row within the panel:
//   solve:   W[k][i] = L[64p + i][64kc + k] (Lu column-major: i along memory);
//   product: W[k][i] = Ã[64kc + k][64p + i] (Ã row-major: i along memory);
// entries past M are zeros. The upper triangles come too: the diagonal
// solve never reads Lu's, and Ã's is zeroed in shared memory before use.
// Called by one thread.
__device__ __forceinline__ void stage_w(float* buf, int phase, int p, int kc,
                                       const CUtensorMap* tl, const CUtensorMap* ta,
                                       uint64_t* bar) {
  tma_chunk(buf, phase == 0 ? tl : ta, p * kP, kc * kP, bar);
}

// The Gram's rows row0 .. row0 + rows of columns col0 .. col0 + BN into Y
// by cp.async (the first tile of a block); zeros past M and B. vec: 16-byte
// copies (B % 4 = 0 and K 16-byte aligned).
template <int BN>
__device__ __forceinline__ void stage_k(float* Ys, const float* __restrict__ K, int M,
                                        int B, int col0, int row0, int rows, int vec,
                                        int tid) {
  constexpr int T = Tile<BN>::kThreads;
  if (vec) {
    for (int f = tid; f < rows * (BN / 4); f += T) {
      const int r = row0 + f / (BN / 4), c = 4 * (f % (BN / 4));
      const bool ok = r < M && col0 + c < B;
      cp_async_16(Ys + (size_t)r * BN + (c ^ ysw(r)), ok ? K + (size_t)r * B + col0 + c : K, ok);
    }
  } else {
    for (int e = tid; e < rows * BN; e += T) {
      const int r = row0 + e / BN, c = e % BN;
      const bool ok = r < M && col0 + c < B;
      cp_async_4(Ys + (size_t)r * BN + (c ^ ysw(r)), ok ? K + (size_t)r * B + col0 + c : K, ok);
    }
  }
}

// One 64-row panel of the Gram (64 × BN = 16 values a thread) held in
// registers between its load and its store.
template <int BN>
struct KPanel {
  float v[16];

  __device__ __forceinline__ void load(const float* __restrict__ K, int M, int B, int col0,
                                       int p, int vec, int tid) {
    constexpr int T = Tile<BN>::kThreads;
    if (vec) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = tid + i * T;
        const int r = p * kP + f / (BN / 4), c = col0 + 4 * (f % (BN / 4));
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < M && c < B) x = __ldcs(reinterpret_cast<const float4*>(K + (size_t)r * B + c));
        v[4 * i] = x.x;
        v[4 * i + 1] = x.y;
        v[4 * i + 2] = x.z;
        v[4 * i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int e = tid + i * T;
        const int r = p * kP + e / BN, c = col0 + e % BN;
        v[i] = r < M && c < B ? __ldcs(K + (size_t)r * B + c) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float* Ys, int p, int vec, int tid) const {
    constexpr int T = Tile<BN>::kThreads;
    float* Yp = Ys + (size_t)p * kP * BN;
    if (vec) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = tid + i * T, r = f / (BN / 4), c = 4 * (f % (BN / 4));
        *reinterpret_cast<float4*>(Yp + r * BN + (c ^ ysw(r))) =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int e = tid + i * T, r = e / BN;
        Yp[r * BN + ((e % BN) ^ ysw(r))] = v[i];
      }
    }
  }
};

// acc[r][c] += Σ_k W[k][row r] · Yk[k][column c] over this group's 16 k,
// k0 .. k0 + 16 (rows 4tr + (r & 3) + 32 (r >> 2), columns 4tc + (c & 3)
// + BN/2 (c >> 2); Y's columns swizzled)
template <int BN>
__device__ __forceinline__ void gemm_chunk(float (&acc)[8][8], const float* W,
                                           const float* Yk, int k0, int tr, int tc) {
  const float* w = W + k0 * kWS + 4 * tr;
  const float* y = Yk + k0 * BN;
  int col[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < 4; ++s) col[h][s] = (h * (BN / 2) + 4 * tc) ^ (s << 3);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(w + k * kWS);
    const float4 a1 = *reinterpret_cast<const float4*>(w + k * kWS + 32);
    const float4 b0 = *reinterpret_cast<const float4*>(y + k * BN + col[0][(k >> 2) & 3]);
    const float4 b1 = *reinterpret_cast<const float4*>(y + k * BN + col[1][(k >> 2) & 3]);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

// The four groups' partial sums of a panel, met in group 0 in a fixed
// order, (g0 + g2) + (g1 + g3), so answers do not depend on the launch:
// groups 2, 3 write theirs to part[0], part[1]; groups 0, 1 add them; group 1
// writes its sum back over part[1]; group 0 adds it. Every other group's
// acc is zero after.
template <int BN>
__device__ __forceinline__ void meet(float (&acc)[8][8], float* part, int g, int tr, int tc) {
  const auto at = [&](int buf, int r, int h) {
    const int row = 4 * tr + (r & 3) + 32 * (r >> 2);
    return reinterpret_cast<float4*>(part + buf * kP * BN + row * BN + h * (BN / 2) + 4 * tc);
  };
  const auto put = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *at(buf, r, h) = make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                                     acc[r][4 * h + 3]);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  };
  const auto add = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *at(buf, r, h);
        acc[r][4 * h] += v.x;
        acc[r][4 * h + 1] += v.y;
        acc[r][4 * h + 2] += v.z;
        acc[r][4 * h + 3] += v.w;
      }
  };
  if (g >= 2) put(g - 2);
  __syncthreads();
  if (g < 2) add(g);
  if (g == 1) put(1);  // over what this group has just read
  __syncthreads();
  if (g == 0) add(1);
}

// Solve the 64 × 64 diagonal block in place on Y's panel Yp: the lane holds
// column dc, rows 16q + 4dg + r (q, r = 0 .. 3). W is the staged diagonal
// chunk (W[k][i] = L[i][k]), rinv the pivots' reciprocals. Adds the
// column's ‖y‖² and m̃ᵀy over the panel (mp: m̃ of its rows) to yy and ym.
template <int BN>
__device__ __forceinline__ void diag_solve(float* Yp, const float* W, const float* rinv,
                                           const float* mp, int lane, int dc, int dg,
                                           double& yy, double& ym) {
  float y[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) y[q][r] = Yp[(16 * q + 4 * dg + r) * BN + (dc ^ (dg << 3))];
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int qb = b >> 2, gb = b & 3, i0 = 4 * b;
    // rows i0 .. i0 + 3 (held by the lanes with dg = gb): substitution
    const float4 c0 = *reinterpret_cast<const float4*>(W + (i0 + 0) * kWS + i0);
    const float4 c1 = *reinterpret_cast<const float4*>(W + (i0 + 1) * kWS + i0);
    const float4 c2 = *reinterpret_cast<const float4*>(W + (i0 + 2) * kWS + i0);
    const float4 d = *reinterpret_cast<const float4*>(rinv + i0);
    const float v0 = y[qb][0] * d.x;
    const float v1 = fmaf(-c0.y, v0, y[qb][1]) * d.y;
    const float v2 = fmaf(-c1.z, v1, fmaf(-c0.z, v0, y[qb][2])) * d.z;
    const float v3 = fmaf(-c2.w, v2, fmaf(-c1.w, v1, fmaf(-c0.w, v0, y[qb][3]))) * d.w;
    const int src = (lane & 7) | (gb << 3);
    const float t0 = __shfl_sync(0xffffffffu, v0, src);
    const float t1 = __shfl_sync(0xffffffffu, v1, src);
    const float t2 = __shfl_sync(0xffffffffu, v2, src);
    const float t3 = __shfl_sync(0xffffffffu, v3, src);
    if (dg == gb) {
      y[qb][0] = t0;
      y[qb][1] = t1;
      y[qb][2] = t2;
      y[qb][3] = t3;
    }
    // the rows below: y −= L[rows][i0 .. i0 + 3] · t
#pragma unroll
    for (int q = qb; q < 4; ++q) {
      const int row = 16 * q + 4 * dg;
      const float4 e0 = *reinterpret_cast<const float4*>(W + (i0 + 0) * kWS + row);
      const float4 e1 = *reinterpret_cast<const float4*>(W + (i0 + 1) * kWS + row);
      const float4 e2 = *reinterpret_cast<const float4*>(W + (i0 + 2) * kWS + row);
      const float4 e3 = *reinterpret_cast<const float4*>(W + (i0 + 3) * kWS + row);
      if (q > qb || dg > gb) {
        y[q][0] = fmaf(-e3.x, t3, fmaf(-e2.x, t2, fmaf(-e1.x, t1, fmaf(-e0.x, t0, y[q][0]))));
        y[q][1] = fmaf(-e3.y, t3, fmaf(-e2.y, t2, fmaf(-e1.y, t1, fmaf(-e0.y, t0, y[q][1]))));
        y[q][2] = fmaf(-e3.z, t3, fmaf(-e2.z, t2, fmaf(-e1.z, t1, fmaf(-e0.z, t0, y[q][2]))));
        y[q][3] = fmaf(-e3.w, t3, fmaf(-e2.w, t2, fmaf(-e1.w, t1, fmaf(-e0.w, t0, y[q][3]))));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * q + 4 * dg + r;
      const float v = y[q][r];
      Yp[row * BN + (dc ^ (dg << 3))] = v;
      yy = fma((double)v, (double)v, yy);
      ym = fma((double)mp[row], (double)v, ym);
    }
}

template <int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads, 1)
svgp_var_kernel(const float* __restrict__ K, const float* __restrict__ m,
                const float* __restrict__ kxx, float* __restrict__ mean,
                float* __restrict__ var, int M, int B, int vec,
                const __grid_constant__ CUtensorMap tl,
                const __grid_constant__ CUtensorMap ta) {
  constexpr int T = Tile<BN>::kThreads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // float64 sums by column: ‖y‖², m̃ᵀy, ‖z‖² of group 0's BN/32 warps
  double* red = reinterpret_cast<double*>(smem_raw);
  const int panels = (M + kP - 1) / kP, rows = panels * kP;
  float* Ys = reinterpret_cast<float*>(red + 4 * BN);  // Y [rows][BN]
  float* Wb = Ys + (size_t)rows * BN;                   // three chunks
  float* part = Wb + 3 * kChunk;                        // two partial panels
  float* mw = part + 2 * kP * BN;                       // m̃, zeros past M
  float* rinv = mw + rows;                              // 1 / the panel's pivots
  // one mbarrier a chunk buffer
  uint64_t* bars = reinterpret_cast<uint64_t*>((reinterpret_cast<uintptr_t>(rinv + kP) + 7) & ~uintptr_t(7));
  uint32_t parity = 0;  // bit b: the phase to wait for on buffer b

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the GEMMs: group g takes k = 16g .. 16g + 16 of each chunk; an 8 × 8 block
  const int g = tid / BN, tr = (tid % BN) / (BN / 8), tc = tid % (BN / 8);
  // the diagonal solve: column dc, rows 16q + 4dg + r
  const int dc = warp * 8 + (lane & 7), dg = lane >> 3;
  const int tiles = (B + BN - 1) / BN;
  int tile = blockIdx.x;  // the launcher keeps the grid within the tiles

  for (int i = tid; i < rows; i += T) mw[i] = i < M ? m[i] : 0.f;
  if (tid == 0)
    for (int b = 0; b < 3; ++b) mbar_init(bars + b);
  __syncthreads();
  stage_k<BN>(Ys, K, M, B, tile * BN, 0, rows, vec, tid);
  cp_async_commit();
  int phase = 0, p = 0, kc = 0, buf = 0;
  // the chunk stream runs two steps ahead of the compute: at the top of a
  // step, (ph1, p1, kc1) of tile t1 is the next step, staged if ok1
  if (tid == 0) stage_w(Wb, 0, 0, 0, &tl, &ta, bars);
  int ph1 = 0, p1 = 0, kc1 = 0, t1 = tile;
  if (advance(ph1, p1, kc1, panels)) t1 += gridDim.x;
  bool ok1 = t1 < tiles;
  if (ok1 && tid == 0) stage_w(Wb + kChunk, ph1, p1, kc1, &tl, &ta, bars + 1);
  // the first tile's Gram is the one cp.async group; the barrier at the
  // top of the first step shows it to every thread
  cp_async_wait<0>();

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  double yy = 0.0, ym = 0.0, zz[8];  // zz: group 0's ‖z‖² by its 8 columns
#pragma unroll
  for (int c = 0; c < 8; ++c) zz[c] = 0.0;
  KPanel<BN> next_k;
  int kq = -1, kcol = 0;  // the next tile's Gram panel kq (columns kcol ..) to fetch this step

  for (;;) {
    const bool last = phase == 1 && p == panels - 1 && kc == panels - 1;
    mbar_wait(bars + buf, (parity >> buf) & 1);
    parity ^= 1u << buf;
    __syncthreads();
    {  // the step after next, into the buffer the previous step used
      int ph2 = ph1, p2 = p1, kc2 = kc1, t2 = t1;
      if (advance(ph2, p2, kc2, panels)) t2 += gridDim.x;
      const bool ok2 = ok1 && t2 < tiles;
      if (ok2 && tid == 0) {
        const int b2 = buf == 0 ? 2 : buf - 1;
        stage_w(Wb + b2 * kChunk, ph2, p2, kc2, &tl, &ta, bars + b2);
      }
      ph1 = ph2; p1 = p2; kc1 = kc2; t1 = t2; ok1 = ok2;
    }
    if (kq >= 0) {
      next_k.load(K, M, B, kcol, kq, vec, tid);
      if (phase == 0 && kc == p && p == kq) {  // one panel (M ≤ 64): needed now
        next_k.store(Ys, kq, vec, tid);
        kq = -1;
        __syncthreads();
      }
    }
    float* W = Wb + buf * kChunk;
    if (phase == 1 && kc == p) {  // the box holds Ã's upper triangle: zeros for k < i
      for (int e = tid; e < kP * kP; e += T)
        if (e / kP < e % kP) W[e] = 0.f;
      __syncthreads();
    }
    if (phase == 1 || kc < p) {
      gemm_chunk<BN>(acc, W, Ys + (size_t)kc * kP * BN, 16 * g, tr, tc);
      if (phase == 1 && kc == panels - 1) {  // a Z panel done: ‖z‖² in group 0
        meet<BN>(acc, part, g, tr, tc);
        if (g == 0) {
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              zz[c] = fma((double)acc[r][c], (double)acc[r][c], zz[c]);
              acc[r][c] = 0.f;
            }
        }
      }
    } else {
      float* Yp = Ys + (size_t)p * kP * BN;
      if (p > 0) meet<BN>(acc, part, g, tr, tc);
      if (g == 0) {
        const int sw = (tr & 3) << 3;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 4 * tr + (r & 3) + 32 * (r >> 2);
            float4* y = reinterpret_cast<float4*>(Yp + row * BN + ((h * (BN / 2) + 4 * tc) ^ sw));
            float4 v = *y;
            v.x -= acc[r][4 * h];
            v.y -= acc[r][4 * h + 1];
            v.z -= acc[r][4 * h + 2];
            v.w -= acc[r][4 * h + 3];
            *y = v;
          }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      }
      if (tid < kP) rinv[tid] = p * kP + tid < M ? 1.f / W[tid * kWS + tid] : 1.f;
      __syncthreads();
      diag_solve<BN>(Yp, W, rinv, mw + p * kP, lane, dc, dg, yy, ym);
    }
    if (kq >= 0) {  // this step reads no Y[kq]
      next_k.store(Ys, kq, vec, tid);
      kq = -1;
    }
    if (phase == 1 && kc == p && tile + (int)gridDim.x < tiles) {
      kq = p;
      kcol = (tile + (int)gridDim.x) * BN;
    }
    if (last) {
      // ‖z‖² over group 0's lanes of a warp that share tc (lane bits from
      // BN/8 up), then over its warps (BN/32) in red
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int o = BN / 8; o < 32; o <<= 1) zz[c] += __shfl_xor_sync(0xffffffffu, zz[c], o);
      yy += __shfl_xor_sync(0xffffffffu, yy, 8);
      yy += __shfl_xor_sync(0xffffffffu, yy, 16);
      ym += __shfl_xor_sync(0xffffffffu, ym, 8);
      ym += __shfl_xor_sync(0xffffffffu, ym, 16);
      if (g == 0 && lane < BN / 8)
#pragma unroll
        for (int c = 0; c < 8; ++c) red[(2 + warp) * BN + (c >> 2) * (BN / 2) + 4 * tc + (c & 3)] = zz[c];
      if (dg == 0) {
        red[dc] = yy;
        red[BN + dc] = ym;
      }
      __syncthreads();
      if (tid < BN) {
        const int col = tile * BN + tid;
        if (col < B) {
          double z2 = red[2 * BN + tid];
#pragma unroll
          for (int w = 1; w < BN / 32; ++w) z2 += red[(2 + w) * BN + tid];
          const double v = ((double)kxx[col] - red[tid]) + z2;
          const float vf = (float)v;
          var[col] = vf < 1e-12f ? 1e-12f : vf;
          mean[col] = (float)red[BN + tid];
        }
      }
      yy = ym = 0.0;
#pragma unroll
      for (int c = 0; c < 8; ++c) zz[c] = 0.0;
      tile += gridDim.x;
      if (tile >= tiles) break;
    }
    advance(phase, p, kc, panels);
    buf = buf == 2 ? 0 : buf + 1;
  }
}

// blocks of svgp_var_kernel<BN> resident on each device, by panel count
// (0: not read yet); whether its shared-memory limit is raised there
int g_resident[kMaxDevices][2][kMaxPanels + 1];
bool g_attr[kMaxDevices][2];

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, looked up once through the runtime
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static bool looked = false;
  if (!looked) {
    looked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// An (M, M) float32 matrix seen with its contiguous index first, ld floats
// from one column (or row) to the next, in 64 × 64 boxes
bool box_map(CUtensorMap* map, const float* X, int M, int ld) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)M, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {kP, kP}, step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(X), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const float* K, const float* L, const float* A, const float* m, const float* kxx,
           float* mean, float* var, int M, int B, int ld_l, int ld_a, cudaStream_t stream) {
  constexpr int slot = BN == 64 ? 0 : 1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int panels = (M + kP - 1) / kP;
  const size_t smem = smem_bytes<BN>(panels);
  if (!g_attr[dev][slot]) {
    err = cudaFuncSetAttribute(svgp_var_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<BN>(Tile<BN>::kMaxRows / kP));
    if (err != cudaSuccess) return (int)err;
    g_attr[dev][slot] = true;
  }
  if (g_resident[dev][slot][panels] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, svgp_var_kernel<BN>,
                                                        Tile<BN>::kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (sms < 1 || per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    g_resident[dev][slot][panels] = sms * per_sm;
  }
  const int tiles = (B + BN - 1) / BN;
  const int grid = tiles < g_resident[dev][slot][panels] ? tiles : g_resident[dev][slot][panels];
  const int vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(K) % 16 == 0;
  CUtensorMap tl{}, ta{};
  if (!box_map(&tl, L, M, ld_l) || !box_map(&ta, A, M, ld_a)) return (int)cudaErrorNotSupported;
  svgp_var_kernel<BN><<<grid, Tile<BN>::kThreads, smem, stream>>>(K, m, kxx, mean, var, M, B,
                                                                  vec, tl, ta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mean and var (B each) of the whitened SVGP from K (M, B) = K(Xu, X)
// row-major, Lu (M, M) column-major with ld_l floats from one column to the
// next, Ã (M, M) row-major with ld_a floats from one row to the next (lower
// triangles used; ld_l, ld_a ≥ M and multiples of 4, Lu and Ã 16-byte
// aligned), m̃ (M) and k(x, x) (B), all float32 on the device. Returns the
// cudaError_t of the launch (0 on success).
int svgp_var_f32(const float* K, const float* L, const float* A, const float* m,
                 const float* kxx, float* mean, float* var, int M, int B, int ld_l,
                 int ld_a, void* stream) {
  if (M <= 0 || M > kMaxM || B <= 0 || ld_l < M || ld_a < M || ld_l % 4 || ld_a % 4 ||
      reinterpret_cast<uintptr_t>(L) % 16 || reinterpret_cast<uintptr_t>(A) % 16)
    return (int)cudaErrorInvalidValue;
  if (M <= Tile<64>::kMaxRows)
    return launch<64>(K, L, A, m, kxx, mean, var, M, B, ld_l, ld_a, (cudaStream_t)stream);
  return launch<32>(K, L, A, m, kxx, mean, var, M, B, ld_l, ld_a, (cudaStream_t)stream);
}

const char* svgp_var_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int svgp_var_max_m(void) { return kMaxM; }

}  // extern "C"
