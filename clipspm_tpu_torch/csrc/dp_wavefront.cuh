// Device code shared by kernels K1 (otam_dp.cu) and K2 (softdtw_dp.cu):
// the division-free soft-min, the lane-segment wavefront of each DP, and the
// shared-memory gram stage that builds a cosine distance table from frame
// features.
//
// The wavefront. One segment of W lanes (W = 16 or 32, a divisor of the
// warp) owns one table; lane j owns column j + 1 of the DP state. At
// anti-diagonal step k, lane j computes the cell of row k - j: `up` is its
// own value from step k - 1, `left` is lane j - 1's value from step k - 1
// (one __shfl_up_sync), and `upleft` is lane j - 1's value from step k - 2,
// which lane j kept from the previous shuffle. Every lane of the warp takes
// part in every shuffle; lanes with no valid cell are masked by predicates,
// never by an early return, so all segments of a warp must run the same
// number of steps. The dependent chain of a table is one soft-min and one
// shuffle per anti-diagonal instead of one soft-min per cell.
//
// The soft-min is the clamped, max-shifted form of the JAX package's
// Pallas kernels (clamp at 80 on the scaled difference), with the division
// by the temperature replaced by a multiplication by its reciprocal,
// computed once per launch on the host. expf and logf stay IEEE-accurate
// (the sources are built without --use_fast_math).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dpw {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kClamp = 80.0f;
constexpr float kBig = 1e30f;  // soft-DTW's finite stand-in for +inf

// Threads of a fused (gram + DP) block; the gram's cp.async pipeline:
// kStages stages of kStageFloats floats (16 KB), kStages - 1 of them in
// flight while one is summed.
constexpr int kFusedThreads = 256;
constexpr int kStages = 4;
constexpr int kStageFloats = 4096;
constexpr int kMaxFrames = 32;  // vectors on either side of a fused pair
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------- soft-min

__device__ __forceinline__ float softmin2(float a, float b, float t,
                                          float inv_t) {
  const float m = fminf(a, b);
  const float ea = expf(-fminf((a - m) * inv_t, kClamp));
  const float eb = expf(-fminf((b - m) * inv_t, kClamp));
  return m - t * logf(ea + eb);
}

__device__ __forceinline__ float softmin3(float a, float b, float c, float t,
                                          float inv_t) {
  const float m = fminf(fminf(a, b), c);
  const float ea = expf(-fminf((a - m) * inv_t, kClamp));
  const float eb = expf(-fminf((b - m) * inv_t, kClamp));
  const float ec = expf(-fminf((c - m) * inv_t, kClamp));
  return m - t * logf(ea + eb + ec);
}

// ---------------------------------------------------------- lane segments

// Lane j - 1's value within a W-lane segment (lane 0 gets its own back).
template <int W>
__device__ __forceinline__ float seg_shift_up(float v) {
  return __shfl_up_sync(kFullMask, v, 1, W);
}

// Inclusive prefix sum over the lanes of a W-lane segment (Hillis-Steele:
// log2(W) shuffles; its summation order is a tree, not a running sum).
template <int W>
__device__ __forceinline__ float seg_inclusive_sum(float x, int lane) {
#pragma unroll
  for (int d = 1; d < W; d <<= 1) {
    const float y = __shfl_up_sync(kFullMask, x, d, W);
    if (lane >= d) x += y;
  }
  return x;
}

// Table readers: element (row, col) at t[row * rs + col * cs]. A transposed
// read swaps the strides. `PaddedRows` adds a zero row above and below (the
// soft-DTW query-axis pad), so row r of the padded table is row r - 1 of t.
struct Strided {
  const float* t;
  int rs, cs;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return t[r * rs + c * cs];
  }
};

struct PaddedRows {
  const float* t;
  int rs, cs, rows;  // rows of t; the padded table has rows + 2
  __device__ __forceinline__ float operator()(int r, int c) const {
    return (r == 0 || r == rows + 1) ? 0.0f : t[(r - 1) * rs + c * cs];
  }
};

// ------------------------------------------------------------------ OTAM

// OTAM cumulative distance of one [L, Ms] table per W-lane segment
// (Ms <= W). The zero pad columns 0 and Ms + 1 of the reference stay
// implicit: lane j < Ms owns column j + 1, and the lane that owns column Ms
// also carries the right pad column. `get(l, j)` returns D[l, j] and is
// called only for l < L, j < Ms. `steps` must be the same on every lane of
// the warp and at least L + Ms - 2 of each segment's table. Returns
// C[L-1, Ms+1] on lane Ms - 1 (other lanes: unspecified).
//   row 0: a cumulative sum (the segment prefix sum);
//   column 1: D + softmin3(0, up, 0);
//   columns 2..Ms: D + softmin2(upleft, left) (no `up` term);
//   column Ms+1: softmin3(upleft, up, left) (its D is the zero pad).
template <int W, class Get>
__device__ __forceinline__ float otam_wavefront(const Get& get, int L,
                                                int Ms, int lane, int steps,
                                                float lbda, float inv) {
  const bool owns = lane < Ms;
  float v = seg_inclusive_sum<W>(owns ? get(0, lane) : 0.0f, lane);
  float pad = v;  // C[0, Ms+1] == C[0, Ms] on lane Ms - 1
  float upleft = 0.0f;
  auto load = [&](int l) {
    return (owns && l >= 1 && l < L) ? get(l, lane) : 0.0f;
  };
  float d = load(1 - lane);  // prefetched one step ahead of its use
  for (int k = 1; k <= steps; ++k) {
    const int l = k - lane;
    const float d_next = load(l + 1);
    float left = seg_shift_up<W>(v);  // C[l, j] from lane j - 1
    if (lane == 0) left = 0.0f;       // column 0 is always 0
    if (owns && l >= 1 && l < L) {
      const float c = d + (lane == 0 ? softmin3(0.0f, v, 0.0f, lbda, inv)
                                     : softmin2(upleft, left, lbda, inv));
      if (lane == Ms - 1) pad = softmin3(v, pad, c, lbda, inv);
      v = c;
    }
    upleft = left;
    d = d_next;
  }
  return pad;
}

// -------------------------------------------------------------- soft-DTW

// Soft-DTW R[N, M] of one [N, M] table per W-lane segment (M <= W), borders
// implicit: R[0,0] = 0, R[i,0] = R[0,j] = kBig. Lane j < M owns column
// j + 1. With bandwidth > 0 a cell with |i - j| > bandwidth is written as
// kBig exactly, never computed. `get(i, j)` returns D[i, j] (0-based) and is
// called only for cells in the band. `steps` as for otam_wavefront, at least
// N + M - 1. Returns R[N, M] on lane M - 1.
template <int W, class Get>
__device__ __forceinline__ float softdtw_wavefront(const Get& get, int N,
                                                   int M, int lane, int steps,
                                                   float gamma, float inv,
                                                   float bandwidth) {
  const bool owns = lane < M;
  const bool banded = bandwidth > 0.0f;
  auto in_band = [&](int i) {
    return !banded || fabsf(static_cast<float>(i - (lane + 1))) <= bandwidth;
  };
  auto load = [&](int i) {
    return (owns && i >= 1 && i <= N && in_band(i)) ? get(i - 1, lane)
                                                    : 0.0f;
  };
  float v = kBig;  // R[0, j+1]
  float upleft = kBig;
  float d = load(1 - lane);
  for (int k = 1; k <= steps; ++k) {
    const int i = k - lane;
    const float d_next = load(i + 1);
    float left = seg_shift_up<W>(v);  // R[i, j] from lane j - 1
    float ul = upleft;                // R[i-1, j]
    if (lane == 0) {
      left = kBig;                    // R[i, 0]
      ul = (i == 1) ? 0.0f : kBig;    // R[i-1, 0]
    }
    if (owns && i >= 1 && i <= N)
      v = in_band(i) ? d + softmin3(ul, v, left, gamma, inv) : kBig;
    upleft = left;
    d = d_next;
  }
  return v;
}

// ------------------------------------------------------------ gram stage

// Cosine forms of the two DPs' distance tables, from a dot product and the
// two squared norms.
struct OtamCos {  // ops/otam.py:frame_distance_cos: eps on the norm product
  float eps;
  __device__ __forceinline__ float operator()(float dot, float a2,
                                              float b2) const {
    return 1.0f - dot / (sqrtf(a2) * sqrtf(b2) + eps);
  }
};

struct ClampedCos {  // ops/softdtw.py:pairwise_cos_dist: each norm >= 1e-8
  __device__ __forceinline__ float operator()(float dot, float a2,
                                              float b2) const {
    return 1.0f - dot / (fmaxf(sqrtf(a2), 1e-8f) * fmaxf(sqrtf(b2), 1e-8f));
  }
};

// Floats of D per vector in one stage: a multiple of 32 (whole float4
// columns, 16-byte aligned stages), at most what a stage holds for nv
// vectors, no more than D needs.
__host__ __device__ constexpr int gram_chunk(int nv, int D) {
  int dc = (kStageFloats / nv) / 32 * 32;
  const int need = (D + 31) / 32 * 32;
  return dc < need ? dc : need;
}

// Shared-memory floats of a fused block: the stages, the dot-product
// accumulators, and the [na, nb + 1] table (row pitch nb + 1, so a
// transposed read hits distinct banks).
__host__ __device__ constexpr int fused_smem_floats(int na, int nb, int D) {
  return kStages * (na + nb) * gram_chunk(na + nb, D) + na * nb + na + nb +
         na * (nb + 1);
}

// The most any fused block takes (72 KB): above the 48 KB a kernel may use
// without opting in.
constexpr int kFusedSmemBytes =
    4 * fused_smem_floats(kMaxFrames, kMaxFrames, 1 << 20);

// Lets `kernel` take kFusedSmemBytes of dynamic shared memory on the
// current device; `done` holds one flag per device already set.
inline cudaError_t allow_fused_smem(const void* kernel, bool* done) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess || dev >= kMaxDevices || done[dev]) return rc;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kFusedSmemBytes);
  if (rc == cudaSuccess) done[dev] = true;
  return rc;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issues the copy of D range [d0, d0 + dc) of every vector into `buf`
// ([nv][dc]); columns past D are zero-filled. 16-byte copies when `vec16`
// (D % 4 == 0 and both bases 16-byte aligned), else 4-byte copies.
__device__ __forceinline__ void gram_issue(float* buf, const float* a, int na,
                                           const float* b, int nv, int D,
                                           int d0, int dc, bool vec16) {
  if (vec16) {
    const int per = dc / 4;
    for (int idx = threadIdx.x; idx < nv * per; idx += kFusedThreads) {
      const int v = idx / per, c = idx - v * per, d = d0 + 4 * c;
      const float* row = v < na ? a + static_cast<size_t>(v) * D
                                : b + static_cast<size_t>(v - na) * D;
      const bool in = d < D;  // D % 4 == 0: all four floats or none
      cp_async16(buf + v * dc + 4 * c, in ? row + d : row, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < nv * dc; idx += kFusedThreads) {
      const int v = idx / dc, c = idx - v * dc, d = d0 + c;
      const float* row = v < na ? a + static_cast<size_t>(v) * D
                                : b + static_cast<size_t>(v - na) * D;
      const bool in = d < D;
      cp_async4(buf + v * dc + c, in ? row + d : row, in ? 4 : 0);
    }
  }
}

// <u, w> added to s, in the order x, y, z, w.
__device__ __forceinline__ float fma4(const float4& u, const float4& w,
                                      float s) {
  return fmaf(u.w, w.w, fmaf(u.z, w.z, fmaf(u.y, w.y, fmaf(u.x, w.x, s))));
}

constexpr int kTile = 4;  // a thread's products: kTile A rows x kTile B rows
constexpr int kTileVals = kTile * kTile + 2 * kTile;  // + both sides' norms

// The gram stage. All kFusedThreads threads of the block call it. Vectors
// A_i are rows of `a` (na of them, D floats apart), B_j rows of `b`. Stages
// D in chunks through shared memory with cp.async, kStages - 1 chunks in
// flight, and takes every dot product <A_i, B_j> and squared norm in fp32
// FMA (no TF32, no tensor cores). The products are cut into tiles of
// kTile x kTile; a group of consecutive threads shares one tile and splits
// each chunk's float4 columns between them, so a thread reads 2 * kTile
// float4 per column for kTile^2 dot products (shared-memory bandwidth, not
// FMA, is what a gram this small runs out of). The partial sums stay in
// registers across chunks and are reduced once, over the group, in a fixed
// order: shuffles within a warp, then shared memory across warps.
// Then writes tab[i * (nb + 1) + j] = form(<A_i, B_j>, |A_i|^2, |B_j|^2)
// and returns `tab`, after a __syncthreads: the table is ready for every
// thread.
template <class Form>
__device__ float* gram_cos_table(const float* a, int na, const float* b,
                                 int nb, int D, bool vec16, float* smem,
                                 const Form& form) {
  const int nv = na + nb, dc = gram_chunk(nv, D), cols = dc / 4;
  const int n_dot = na * nb;
  float* acc = smem + kStages * nv * dc;  // dots, then A norms, B norms
  float* tab = acc + n_dot + na + nb;

  const int tb = (nb + kTile - 1) / kTile;
  const int tiles = (na + kTile - 1) / kTile * tb;  // <= 64
  int slots = 1;
  while (slots < tiles) slots <<= 1;
  const int group = kFusedThreads / slots;  // a power of two, >= 4
  const int tile = threadIdx.x / group, r = threadIdx.x % group;
  const bool busy = tile < tiles;  // threads past the last tile idle
  const int ti = tile / tb, tj = tile - ti * tb;
  int ra[kTile], rb[kTile];  // clamped: computed past the edge, not stored
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    ra[k] = min(ti * kTile + k, na - 1);
    rb[k] = na + min(tj * kTile + k, nb - 1);
  }
  float v[kTileVals];  // dots [i * kTile + j], then A norms, then B norms
#pragma unroll
  for (int k = 0; k < kTileVals; ++k) v[k] = 0.0f;

  const int chunks = (D + dc - 1) / dc;
  // one commit group per chunk (empty past the last), so that after the
  // commit of iteration ch, waiting for all but kStages - 1 groups leaves
  // chunks 0..ch complete
  for (int ch = 0; ch < kStages - 1; ++ch) {
    if (ch < chunks)
      gram_issue(smem + ch * nv * dc, a, na, b, nv, D, ch * dc, dc, vec16);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    const int next = ch + kStages - 1;  // into the stage freed last round
    if (next < chunks)
      gram_issue(smem + (next % kStages) * nv * dc, a, na, b, nv, D,
                 next * dc, dc, vec16);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float4* buf =
        reinterpret_cast<const float4*>(smem + (ch % kStages) * nv * dc);
    if (busy) {
      for (int c = r; c < cols; c += group) {
        float4 u[kTile], w[kTile];
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          u[k] = buf[ra[k] * cols + c];
          w[k] = buf[rb[k] * cols + c];
        }
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            v[i * kTile + j] = fma4(u[i], w[j], v[i * kTile + j]);
        if (tj == 0) {
#pragma unroll
          for (int i = 0; i < kTile; ++i)
            v[kTile * kTile + i] = fma4(u[i], u[i], v[kTile * kTile + i]);
        }
        if (ti == 0) {
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            v[kTile * kTile + kTile + j] =
                fma4(w[j], w[j], v[kTile * kTile + kTile + j]);
        }
      }
    }
    __syncthreads();  // the next round's issue overwrites this stage
  }
  cp_async_wait<0>();

  // the group's sum of v, stored for tile t
  auto store = [&](int t, const float* sum) {
    const int si = t / tb, sj = t - si * tb;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int gi = si * kTile + i;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int gj = sj * kTile + j;
        if (gi < na && gj < nb) acc[gi * nb + gj] = sum[i * kTile + j];
      }
      if (sj == 0 && gi < na) acc[n_dot + gi] = sum[kTile * kTile + i];
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int gj = sj * kTile + j;
      if (si == 0 && gj < nb) acc[n_dot + na + gj] = sum[kTile * kTile +
                                                         kTile + j];
    }
  };
  const int width = group < 32 ? group : 32;
  for (int off = width / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kTileVals; ++k)
      v[k] += __shfl_xor_sync(kFullMask, v[k], off);
  }
  if (group <= 32) {
    if (busy && r == 0) store(tile, v);
  } else {
    // a group spans group / 32 warps: each warp's sum goes through the
    // (now idle) stage memory, then one thread per tile adds them in order
    float* red = smem;
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int k = 0; k < kTileVals; ++k) red[warp * kTileVals + k] = v[k];
    }
    __syncthreads();
    if (threadIdx.x < tiles) {
      const int t = threadIdx.x, warps = group / 32;
      float sum[kTileVals];
#pragma unroll
      for (int k = 0; k < kTileVals; ++k) sum[k] = 0.0f;
      for (int w = 0; w < warps; ++w) {
#pragma unroll
        for (int k = 0; k < kTileVals; ++k)
          sum[k] += red[(t * warps + w) * kTileVals + k];
      }
      store(t, sum);
    }
  }
  __syncthreads();

  const int pitch = nb + 1;
  for (int p = threadIdx.x; p < n_dot; p += kFusedThreads) {
    const int i = p / nb, j = p - i * nb;
    tab[i * pitch + j] = form(acc[p], acc[n_dot + i], acc[n_dot + na + j]);
  }
  __syncthreads();
  return tab;
}

}  // namespace dpw
