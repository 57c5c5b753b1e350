// Streaming top-1 L2 search: for every query row, the nearest corpus row
// and its distance, without writing the (nq, m) distance panel anywhere.
//
// Replaces annembed_tpu/ops/top1.py::_top1_kernel, the Pallas TPU kernel
// launched by _top1_l2_impl and driven by top1_l2.  It computes what that
// kernel computes, not how:
//   * d^2 = (|q|^2 + |c|^2) - 2 q.c in f32, every product a CUDA-core f32
//     FMA (no TF32, no bf16), so near neighbours are ordered as the JAX
//     kernel orders them;
//   * a running (min d^2, argmin) per query, in registers;
//   * ties go to the LOWEST corpus index: each thread scans its columns in
//     increasing order with a strict <, and the reduction across the
//     threads that share a query breaks equal d^2 by the smaller index;
//   * out: idx int32 and sqrt(max(d^2, 0)).
// One thread block owns BQ queries and loops over the WHOLE corpus in
// tiles of BC rows staged through shared memory; that loop takes the place
// of the TPU's sequential corpus grid axis.  The feature axis is staged in
// chunks of DK, so any d works (d = 28 on the Higgs path, 784 for MNIST).
// Ragged query, corpus and feature edges are bounds-checked, not padded.
//
// What bounds it on an H100: f32 FMA throughput on the CUDA cores (at
// d = 28 the product is ~1e12 FMAs for 1M queries x 40k corpus rows, and
// without TF32 there is no tensor-core path).  This first version is a
// plain 4x4 register tile per thread; register tiling over wider tiles, a
// TF32-free mma path, or a split over the corpus come later.
//
// Launch contract: runs on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BC = 64;        // corpus rows per shared-memory tile
constexpr int DK = 16;        // features staged per step
constexpr int TX = 16;        // threads along the corpus tile
constexpr int TY = 16;        // threads along the query tile
constexpr int RQ = BQ / TY;   // queries per thread
constexpr int RC = BC / TX;   // corpus columns per thread
constexpr int NT = TX * TY;   // threads per block
static_assert(BC + BQ <= NT, "norm accumulation needs one thread per row");
static_assert(TX <= 32 && (32 % TX) == 0, "a query's threads share a warp");

__global__ void __launch_bounds__(NT)
top1_l2_kernel(const float* __restrict__ q, const float* __restrict__ c,
               int nq, int m, int d, int* __restrict__ out_idx,
               float* __restrict__ out_dist) {
  __shared__ float qs[DK][BQ + 1];
  __shared__ float cs[DK][BC + 1];
  __shared__ float qsq_s[BQ];
  __shared__ float csq_s[BC];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long q0 = static_cast<long long>(blockIdx.x) * BQ;

  float best[RQ];
  int best_i[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    best[i] = CUDART_INF_F;
    best_i[i] = 0;
  }

  for (int c0 = 0; c0 < m; c0 += BC) {
    float acc[RQ][RC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;
    // squared norm of one staged row: threads [0, BC) own corpus rows,
    // threads [BC, BC + BQ) own query rows
    float sq = 0.f;

    for (int k0 = 0; k0 < d; k0 += DK) {
      for (int e = tid; e < BQ * DK; e += NT) {
        const int r = e / DK, kk = e % DK;
        const long long row = q0 + r;
        const int col = k0 + kk;
        qs[kk][r] = (row < nq && col < d) ? q[row * d + col] : 0.f;
      }
      for (int e = tid; e < BC * DK; e += NT) {
        const int r = e / DK, kk = e % DK;
        const long long row = static_cast<long long>(c0) + r;
        const int col = k0 + kk;
        cs[kk][r] = (row < m && col < d) ? c[row * d + col] : 0.f;
      }
      __syncthreads();

      if (tid < BC) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk)
          sq = fmaf(cs[kk][tid], cs[kk][tid], sq);
      } else if (tid < BC + BQ) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk)
          sq = fmaf(qs[kk][tid - BC], qs[kk][tid - BC], sq);
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        float a[RQ], b[RC];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = qs[kk][ty * RQ + i];
#pragma unroll
        for (int j = 0; j < RC; ++j) b[j] = cs[kk][tx + TX * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    if (tid < BC) {
      csq_s[tid] = sq;
    } else if (tid < BC + BQ) {
      qsq_s[tid - BC] = sq;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float qn = qsq_s[ty * RQ + i];
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const int col = c0 + tx + TX * j;
        if (col < m) {
          const float d2 = (qn + csq_s[tx + TX * j]) - 2.f * acc[i][j];
          if (d2 < best[i]) {
            best[i] = d2;
            best_i[i] = col;
          }
        }
      }
    }
    __syncthreads();  // qsq_s / csq_s are rewritten by the next tile
  }

  // the TX threads holding one query are consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float bd = best[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const long long row = q0 + ty * RQ + i;
    if (tx == 0 && row < nq) {
      out_idx[row] = bi;
      out_dist[row] = sqrtf(fmaxf(bd, 0.f));
    }
  }
}

}  // namespace

extern "C" int top1_l2_launch(const void* queries, const void* corpus,
                              int nq, int m, int d, void* out_idx,
                              void* out_dist, void* stream) {
  const dim3 grid((nq + BQ - 1) / BQ);
  top1_l2_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(corpus),
      nq, m, d, static_cast<int*>(out_idx), static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}
