// K1: the OTAM band dynamic program on Hopper (sm_90a).
//
// Replaces clipspm_tpu/ops/otam_pallas.py:_otam_kernel. It computes the same
// function -- the OTAM cumulative distance C[L-1, M-1] of each (query,
// support) frame-distance table -- but not the TPU kernel's layout: there is
// no diagonal-major gather, no 128-lane tile and no roll. The recurrence is
// serial within one table, so one thread owns one table and walks it row by
// row, keeping one rolling row of M = Ms + 2 floats in registers. The two
// zero pad columns are implicit: the kernel reads the unpadded [B, L, Ms]
// tables and never materialises the pad.
//
// What bounds it: at the main-path sizes (B = 25 or 5 tables of 8 x 8 per
// launch) one launch reads about 6.4 KB and does a few thousand exp/log
// operations, so neither bytes nor FLOPs bound it: latency does. One launch
// is as long as one thread's serial walk of its table -- 63 dependent cells
// at L = Ms = 8, each with IEEE divisions, expf and logf -- plus the launch
// itself, whatever B is (about 0.04 ms on an H100 from B = 5 to B = 1600;
// chip_smoke.py, tools/k1_variants.py). The levers, left to later changes:
// batch every episode's tables into one launch, shorten the chain (the
// divisions take about half of it), and fuse the cosine table.
//
// Soft-min is the clamped, max-shifted form of otam_pallas.py:_softmin_pair /
// _softmin3 with expf/logf; build without --use_fast_math so the division and
// the transcendental functions stay IEEE-accurate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libotam_dp.so otam_dp.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Largest padded width M = Ms + 2 the kernel takes (the wrapper raises above).
constexpr int kMaxM = 34;
constexpr int kThreads = 128;
constexpr float kClamp = 80.0f;

__device__ __forceinline__ float softmin2(float a, float b, float lbda) {
  const float m = fminf(a, b);
  const float ea = expf(-fminf((a - m) / lbda, kClamp));
  const float eb = expf(-fminf((b - m) / lbda, kClamp));
  return m - lbda * logf(ea + eb);
}

__device__ __forceinline__ float softmin3(float a, float b, float c,
                                          float lbda) {
  const float m = fminf(fminf(a, b), c);
  const float ea = expf(-fminf((a - m) / lbda, kClamp));
  const float eb = expf(-fminf((b - m) / lbda, kClamp));
  const float ec = expf(-fminf((c - m) / lbda, kClamp));
  return m - lbda * logf(ea + eb + ec);
}

__global__ void __launch_bounds__(kThreads)
otam_dp_kernel(const float* __restrict__ dists, float* __restrict__ out,
               int B, int L, int Ms, float lbda) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* table = dists + static_cast<size_t>(b) * L * Ms;
  const int M = Ms + 2;

  // row[m] holds C[l, m] of the row being built (C[l-1, m] before column m
  // is overwritten). Every index below is a compile-time constant after
  // unrolling, so the row stays in registers.
  float row[kMaxM];
  row[0] = 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int m = 1; m < kMaxM; ++m) {
    // row 0: cumsum over the padded row (the pad columns add 0)
    if (m <= Ms) acc += table[m - 1];
    row[m] = acc;
  }
  float result = acc;  // C[0, M-1], the answer when L == 1

  for (int l = 1; l < L; ++l) {
    const float* drow = table + static_cast<size_t>(l) * Ms;
    float upleft = 0.0f;  // C[l-1, 0]: the left pad column is always 0
#pragma unroll
    for (int m = 1; m < kMaxM; ++m) {
      if (m < M) {
        const float up = row[m];        // C[l-1, m]
        const float left = row[m - 1];  // C[l, m-1], already this row's
        const float d = (m <= Ms) ? drow[m - 1] : 0.0f;
        float c;
        if (m == M - 1) {
          c = d + softmin3(upleft, up, left, lbda);
          result = c;
        } else if (m == 1) {
          c = d + softmin3(0.0f, up, 0.0f, lbda);
        } else {
          c = d + softmin2(upleft, left, lbda);
        }
        upleft = up;
        row[m] = c;
      }
    }
  }
  out[b] = result;
}

}  // namespace

extern "C" {

int otam_dp_max_m() { return kMaxM; }

// Launches K1 on `stream` over B contiguous fp32 tables [B, L, Ms]; writes
// [B] fp32. Returns cudaGetLastError() (0 on success).
int otam_dp_launch(const float* dists, float* out, int B, int L, int Ms,
                   float lbda, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  otam_dp_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dists, out, B, L, Ms, lbda);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
