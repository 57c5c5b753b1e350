// Streaming top-1 L2 search on Hopper's tensor cores: for every query
// row, the nearest corpus row and its distance, without writing the
// (nq, m) distance panel anywhere.
//
// Replaces annembed_tpu/ops/top1.py::_top1_kernel, the Pallas TPU kernel
// launched by _top1_l2_impl and driven by top1_l2.  It computes what that
// kernel computes, not how:
//   * d^2 = (|q|^2 + |c|^2) - 2 q.c in f32;
//   * a running (min d^2, argmin) per query over the whole corpus;
//   * ties go to the LOWEST corpus index;
//   * out: idx int32 and sqrt(max(d^2, 0)).
//
// What bounds it on an H100 SXM: the product.  At the hierarchical
// path's shape (1M queries x 40k corpus rows x d = 28) it is 2.24e12
// flop against ~125 MB of inputs and outputs, so bytes bound it at
// 0.04 ms and operations at 33.4 ms on the f32 CUDA cores (67 TFLOP/s).
// The tensor cores reach 495 TFLOP/s in TF32, but TF32 keeps 11 bits of
// mantissa, too few for the cancellation in the expansion.  So every
// product is split ("3xTF32"): x = hi + lo with hi = tf32_rna(x) and
// lo = tf32_rna(x - hi), and q.c ~ lo.hi + hi.lo + hi.hi, the small
// terms accumulated first; the dropped lo.lo term is ~2^-22 of |q||c|.
// That is three TF32 products, 6 nq m d flop: 13.6 ms at the slice
// shape, 2.33 ms at 70k x 3.5k x 784, 1.64 s at 11M x 440k x 28.
//
// Design:
//   * A prologue kernel splits the corpus once (it is re-read by every
//     query tile) into TF32 hi / lo, padded to 128-row tiles and 32-wide
//     feature chunks and laid out exactly as wgmma's shared-memory
//     operand wants it (core matrices of 8 rows x 4 values, no swizzle),
//     so one bulk copy moves a whole (tile, chunk) into shared memory;
//     it also writes |c|^2, +inf on padded rows so they never win.
//   * One block owns 192 queries at d <= 32 (three consumer warpgroups
//     of 64 rows; on an H100 SXM at 700 W 8% faster than two at the
//     slice shape and 12% at 11M x 440k, PERF.md section 6) and
//     128 above (two: the streamed variant needs 159 registers a
//     thread), plus one producer warp that keeps a 4-stage ring of
//     corpus tiles in flight (cp.async.bulk behind mbarriers).  The block
//     loops over the WHOLE corpus, which takes the place of the TPU's
//     sequential corpus grid axis.
//   * Queries are split on load, into registers: wgmma's A operand comes
//     from registers.  At d <= 32 the hi / lo fragments stay in registers
//     for the whole loop; at larger d each 32-wide chunk is loaded from
//     global memory one chunk ahead of its use.
//   * Products: wgmma m64n128k8 TF32, three per 8 features.
//   * Epilogue in registers: each thread scans its columns in increasing
//     corpus order with a strict <, so the running best keeps the lowest
//     index; the four threads that share a row break equal d^2 by the
//     smaller index.  The consumer warpgroups run it in turns with each
//     other's products.
//
// Launch contract: runs on the caller's stream, allocates nothing (the
// caller passes top1_l2_scratch_floats(m, d) floats of scratch), returns
// the first non-zero cudaGetLastError() of its two launches.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "sm90_ptx.cuh"

namespace {

constexpr int BN = 128;                  // corpus rows per tile
constexpr int KC = 32;                   // features per chunk
constexpr int KSTEPS = KC / 8;           // wgmma k8 steps per chunk
constexpr int STAGES = 4;                // corpus ring depth
// one (tile, chunk) of the split corpus: hi then lo, each
// [KSTEPS][BN / 8 row groups][2 halves of k8][8 rows][4 values]
constexpr int PART_FLOATS = KSTEPS * BN * 8;      // 4096
constexpr int CHUNK_FLOATS = 2 * PART_FLOATS;     // 8192
constexpr uint32_t KSTEP_BYTES = BN * 8 * 4;      // 4096
constexpr uint32_t LBO = 128;            // next 4 features (core matrix)
constexpr uint32_t SBO = 256;            // next 8 rows
constexpr uint32_t STAGE_BYTES = CHUNK_FLOATS * 4 + BN * 4;
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
static_assert(STAGE_BYTES % 128 == 0, "stages stay 128-byte aligned");

__device__ __forceinline__ float tf32_lo(float x, uint32_t hi) {
  return __uint_as_float(sm90::tf32_rna(x - __uint_as_float(hi)));
}

// Split the corpus into the (tile, chunk) blocks the main kernel copies,
// and write |c|^2 per padded row.
__global__ void split_corpus_kernel(const float* __restrict__ c, int m, int d,
                                    int nkc, long long ntiles,
                                    float* __restrict__ split,
                                    float* __restrict__ c_sq) {
  const long long total = ntiles * nkc * PART_FLOATS;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long block = e / PART_FLOATS;   // tile * nkc + chunk
    const int w = static_cast<int>(e % PART_FLOATS);
    const long long tile = block / nkc;
    const int kc = static_cast<int>(block % nkc);
    const int s = w / (BN * 8), g = (w / 64) % (BN / 8), h = (w / 32) % 2,
              r = (w / 4) % 8, j = w % 4;
    const long long row = tile * BN + g * 8 + r;
    const int col = kc * KC + s * 8 + h * 4 + j;
    const float x = (row < m && col < d) ? c[row * d + col] : 0.f;
    const uint32_t hi = sm90::tf32_rna(x);
    float* out = split + block * CHUNK_FLOATS + w;
    out[0] = __uint_as_float(hi);
    out[PART_FLOATS] = tf32_lo(x, hi);
    if (e < ntiles * BN) {
      float sq = CUDART_INF_F;
      if (e < m) {
        sq = 0.f;
        for (int k = 0; k < d; ++k) sq = fmaf(c[e * d + k], c[e * d + k], sq);
      }
      c_sq[e] = sq;
    }
  }
}

// Query values of one 32-wide chunk in wgmma's A fragment order:
// v[s][0..3] = (r0, k), (r1, k), (r0, k + 4), (r1, k + 4) with
// k = chunk * 32 + 8 s + lane % 4.
__device__ __forceinline__ void load_chunk(const float* __restrict__ q,
                                           long long r0, long long nq, int d,
                                           int kc, int quad,
                                           float (&v)[KSTEPS][4]) {
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = r0 + (i & 1) * 8;
      const int col = kc * KC + s * 8 + quad + (i >> 1) * 4;
      v[s][i] = (row < nq && col < d) ? __ldg(q + row * d + col) : 0.f;
    }
  }
}

__device__ __forceinline__ void split_chunk(const float (&v)[KSTEPS][4],
                                            uint32_t (&hi)[KSTEPS][4],
                                            uint32_t (&lo)[KSTEPS][4]) {
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[s][i] = sm90::tf32_rna(v[s][i]);
      lo[s][i] = __float_as_uint(tf32_lo(v[s][i], hi[s][i]));
    }
}

// NCONS consumer warpgroups of 64 query rows and one producer warp
template <int NCONS>
constexpr int threads() { return 128 * NCONS + 32; }

template <bool kResident, int NCONS>
__global__ void __launch_bounds__(threads<NCONS>(), 1)
top1_l2_kernel(const float* __restrict__ q, long long nq, int m, int d,
               int nkc, int ntiles, const float* __restrict__ split,
               const float* __restrict__ c_sq, int* __restrict__ out_idx,
               float* __restrict__ out_dist) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long total = static_cast<long long>(ntiles) * nkc;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128 * NCONS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NCONS) {
    // producer: one thread streams every (tile, chunk) through the ring
    if (lane == 0) {
      for (long long it = 0; it < total; ++it) {
        const int st = static_cast<int>(it % STAGES);
        sm90::mbar_wait(&empty[st], static_cast<uint32_t>((it / STAGES) & 1) ^ 1);
        unsigned char* buf = smem + st * STAGE_BYTES;
        sm90::mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
        sm90::bulk_g2s(buf, split + it * CHUNK_FLOATS, CHUNK_FLOATS * 4,
                       &full[st]);
        sm90::bulk_g2s(buf + CHUNK_FLOATS * 4, c_sq + (it / nkc) * BN,
                       BN * 4, &full[st]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the
  // block; this thread holds rows r0 and r0 + 8 of them
  const int wg = warp / 4;
  const int quad = lane % 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * 64 * NCONS + wg * 64 +
                       (warp % 4) * 16 + lane / 4;
  float qn0 = 0.f, qn1 = 0.f;
  for (int k = quad; k < d; k += 4) {
    if (r0 < nq) qn0 = fmaf(q[r0 * d + k], q[r0 * d + k], qn0);
    if (r0 + 8 < nq) qn1 = fmaf(q[(r0 + 8) * d + k], q[(r0 + 8) * d + k], qn1);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    qn0 += __shfl_xor_sync(0xffffffffu, qn0, off);
    qn1 += __shfl_xor_sync(0xffffffffu, qn1, off);
  }

  float raw[KSTEPS][4];
  uint32_t a_hi[KSTEPS][4], a_lo[KSTEPS][4];
  load_chunk(q, r0, nq, d, 0, quad, raw);
  if (kResident) split_chunk(raw, a_hi, a_lo);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float best0 = CUDART_INF_F, best1 = CUDART_INF_F;
  int besti0 = 0, besti1 = 0;
  long long it = 0;
  for (int tile = 0; tile < ntiles; ++tile) {
    for (int kc = 0; kc < nkc; ++kc, ++it) {
      if (!kResident) {
        split_chunk(raw, a_hi, a_lo);
        load_chunk(q, r0, nq, d, kc + 1 < nkc ? kc + 1 : 0, quad, raw);
      }
      const int st = static_cast<int>(it % STAGES);
      sm90::mbar_wait(&full[st], static_cast<uint32_t>((it / STAGES) & 1));
      const unsigned char* buf = smem + st * STAGE_BYTES;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        sm90::wgmma_m64n128k8_tf32(
            acc, a_lo[s], sm90::smem_desc(buf + s * KSTEP_BYTES, LBO, SBO),
            kc > 0 || s > 0);
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        sm90::wgmma_m64n128k8_tf32(
            acc, a_hi[s],
            sm90::smem_desc(buf + PART_FLOATS * 4 + s * KSTEP_BYTES, LBO, SBO),
            1);
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        sm90::wgmma_m64n128k8_tf32(
            acc, a_hi[s], sm90::smem_desc(buf + s * KSTEP_BYTES, LBO, SBO), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
      if (kc == nkc - 1) {
        const float* cn = reinterpret_cast<const float*>(buf + CHUNK_FLOATS * 4);
        const int c0 = tile * BN + 2 * quad;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 cv = *reinterpret_cast<const float2*>(cn + 8 * j + 2 * quad);
          const int col = c0 + 8 * j;
          float v = fmaf(-2.f, acc[4 * j + 0], qn0 + cv.x);
          if (v < best0) { best0 = v; besti0 = col; }
          v = fmaf(-2.f, acc[4 * j + 1], qn0 + cv.y);
          if (v < best0) { best0 = v; besti0 = col + 1; }
          v = fmaf(-2.f, acc[4 * j + 2], qn1 + cv.x);
          if (v < best1) { best1 = v; besti1 = col; }
          v = fmaf(-2.f, acc[4 * j + 3], qn1 + cv.y);
          if (v < best1) { best1 = v; besti1 = col + 1; }
        }
      }
      sm90::mbar_arrive(&empty[st]);
    }
  }

  // the four lanes of a quad hold the same two rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    float od = __shfl_xor_sync(0xffffffffu, best0, off);
    int oi = __shfl_xor_sync(0xffffffffu, besti0, off);
    if (od < best0 || (od == best0 && oi < besti0)) { best0 = od; besti0 = oi; }
    od = __shfl_xor_sync(0xffffffffu, best1, off);
    oi = __shfl_xor_sync(0xffffffffu, besti1, off);
    if (od < best1 || (od == best1 && oi < besti1)) { best1 = od; besti1 = oi; }
  }
  if (quad == 0) {
    if (r0 < nq) {
      out_idx[r0] = besti0;
      out_dist[r0] = sqrtf(fmaxf(best0, 0.f));
    }
    if (r0 + 8 < nq) {
      out_idx[r0 + 8] = besti1;
      out_dist[r0 + 8] = sqrtf(fmaxf(best1, 0.f));
    }
  }
}

int chunks(int d) { return (d + KC - 1) / KC; }
int tiles(int m) { return (m + BN - 1) / BN; }

}  // namespace

// Floats of scratch top1_l2_launch needs for an (m, d) corpus: its split
// (hi / lo per tile and chunk) and |c|^2 per padded row.
extern "C" long long top1_l2_scratch_floats(int m, int d) {
  return static_cast<long long>(tiles(m)) * chunks(d) * CHUNK_FLOATS +
         static_cast<long long>(tiles(m)) * BN;
}

extern "C" int top1_l2_launch(const void* queries, const void* corpus,
                              long long nq, int m, int d, void* out_idx,
                              void* out_dist, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkc = chunks(d), ntiles = tiles(m);
  float* split = static_cast<float*>(scratch);
  float* c_sq = split + static_cast<long long>(ntiles) * nkc * CHUNK_FLOATS;
  const long long work = static_cast<long long>(ntiles) * nkc * PART_FLOATS;
  const int split_blocks = static_cast<int>((work + 255) / 256 < 65536
                                                ? (work + 255) / 256 : 65536);
  split_corpus_kernel<<<split_blocks, 256, 0, s>>>(
      static_cast<const float*>(corpus), m, d, nkc, ntiles, split, c_sq);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // d <= 32: query fragments resident in registers, three consumers;
  // larger d: streamed, two (159 registers a thread leave room for no
  // third)
  constexpr int NR = 3, NS = 2;
  auto kernel = d <= KC ? top1_l2_kernel<true, NR> : top1_l2_kernel<false, NS>;
  const int ncons = d <= KC ? NR : NS;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES)));
  if (err != 0) return err;
  const long long grid = (nq + 64 * ncons - 1) / (64 * ncons);
  kernel<<<static_cast<unsigned>(grid), 128 * ncons + 32, SMEM_BYTES, s>>>(
      static_cast<const float*>(queries), nq, m, d, nkc, ntiles, split, c_sq,
      static_cast<int*>(out_idx), static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}
