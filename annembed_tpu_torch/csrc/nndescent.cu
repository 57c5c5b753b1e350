// One NN-descent round's local join, DistL2: every row in one launch (or
// one launch a mesh rank).
//
// Replaces the per-slab torch chain of knn/nndescent.py (_nndescent_slab),
// the port of annembed_tpu/knn/nndescent.py::_nndescent_slab (:87-165),
// which the JAX package runs as XLA code, with no Pallas kernel.  It
// computes what that chain computes, for each row i it serves:
//   * the candidates are inner[inner[i][a]][b] (a, b < s: s^2 ids), then
//     uni[i][0..u), ordered by ascending id; candidate e sits at position
//     k + e of the merge, after the current list's k slots;
//   * a candidate is not scored and counts as +inf if it is a pad (>= n),
//     i itself, equal to the candidate before it in that order, or in the
//     row's current list; a current entry equal to an earlier one of the
//     list is +inf too;
//   * the score is sqrt(max(sum_j (q_j - c_j)^2, 0)), summed in f32 over
//     operands read in the scoring type (bf16 or f32);
//   * the k smallest (value, position) of the k + C entries, ascending:
//     their ids, and their values clamped at 0 (+inf stays), rows with
//     fewer than k finite entries included.
// Rows served: all of them; with size > 1 the rows of the slabs rank,
// rank + size, ... of ``slab`` rows, the others left as they are (the
// wrapper zeroes them).  *pairs gains the number of candidates scored.
//
// What bounds it on an H100 SXM: bytes.  At the 11M Higgs round (k 12,
// s 12, u 24: C = 168 candidates a row, d 28 in bf16) ~8.5e8 candidates
// survive the dedup, 56 B of row each, some 47 GB (~14 ms at 3.35 TB/s);
// the id tables and the lists in and out are a few GB.  The torch chain
// materialises every candidate's f32 row and rereads it for the
// difference, the square and the sum, slab after slab, with a host sync
// in each slab's top-k.
//
// Design (SIMT; one warp a row, a grid of resident blocks walking the
// rows, nothing kept between rows):
//   * the row's C ids are loaded at once, lane-strided (every load
//     independent), padded with INT_MAX to P = 32 R (256 or 512) and
//     sorted by a bitonic network in registers: steps within a lane's R
//     values in registers, the others by xor shuffles;
//   * pads, self and repeats (the neighbour before, across lanes by one
//     shuffle) and the current list (k broadcasts) are marked in
//     registers;
//   * the surviving candidates are compacted into shared memory (a warp
//     prefix sum) and scored by groups of G lanes a row, G the power of two
//     that covers the row's d / 4 vectors of 4 elements (8 at d 28), U rows
//     a group in flight at once, the partial sums reduced by xor shuffles;
//   * the merge: k rounds of a warp-wide minimum of (value, position) keys
//     by two redux.sync, each lane's keys in registers;
//   * the scored count is kept per lane, one atomic a warp at the end.
#include <cuda_runtime.h>

#include <cstdint>

// warps a block; the host build (tools/nndescent_host_check.py) runs one
#ifndef NND_WARPS
#define NND_WARPS 8
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = NND_WARPS;
// the largest list, candidate count and row width served; the per-warp
// shared slice at the largest (2 P + d floats, 8 warps) stays under 48 KB
constexpr int MAX_K = 32;
constexpr int MAX_C = 512;
constexpr int MAX_D = 256;
// candidate rows a lane group has in flight
constexpr int U = 4;
constexpr int PAD_ID = 0x7fffffff;
constexpr unsigned NONE = 0xffffffffu;

struct RoundArgs {
  const void* x;           // (n + 1, d) scoring rows, bf16 or f32; row n 0
  const int* inner;        // (n + 1, s): the sampled neighbourhood
  const int* uni;          // (n + 1, u): the whole neighbourhood
  const int* cur_idx;      // (n, k)
  const float* cur_dist;   // (n, k)
  int* out_idx;            // (n, k)
  float* out_dist;         // (n, k)
  unsigned long long* pairs;  // scored candidates, added to (may be null)
  long long rows;          // served rows: j < rows
  long long slab;
  int n, d, k, s, u, c, rank, size, group;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// a float's bits as an unsigned of the same order, -0 taken as +0
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned b = __float_as_uint(v + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// element ``i`` of the scoring rows as f32
template <bool BF16>
__device__ __forceinline__ float load_elem(const void* x, long long i) {
  if constexpr (BF16) {
    const unsigned h = static_cast<const unsigned short*>(x)[i];
    return __uint_as_float(h << 16);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

// columns [4 v, 4 v + 4) of row ``id`` as f32, 0 past d; VEC: d % 4 == 0,
// so the 4 elements are one aligned 8-byte (bf16) or 16-byte (f32) load
template <bool BF16, bool VEC>
__device__ __forceinline__ float4 load_vec(const void* x, int id, int d,
                                           int v) {
  const long long at = static_cast<long long>(id) * d + 4 * v;
  float4 out;
  if constexpr (VEC && BF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        static_cast<const unsigned short*>(x) + at);
    out.x = __uint_as_float(w.x << 16);
    out.y = __uint_as_float(w.x & 0xffff0000u);
    out.z = __uint_as_float(w.y << 16);
    out.w = __uint_as_float(w.y & 0xffff0000u);
  } else if constexpr (VEC) {
    out = *reinterpret_cast<const float4*>(static_cast<const float*>(x) + at);
  } else {
    const int col = 4 * v;
    out.x = col < d ? load_elem<BF16>(x, at) : 0.0f;
    out.y = col + 1 < d ? load_elem<BF16>(x, at + 1) : 0.0f;
    out.z = col + 2 < d ? load_elem<BF16>(x, at + 2) : 0.0f;
    out.w = col + 3 < d ? load_elem<BF16>(x, at + 3) : 0.0f;
  }
  return out;
}

// Ascending bitonic sort of a warp's 32 R values: element lane R + r in
// register r of each lane at the end, whatever the order at the start.
template <int R, int LOG_P>
__device__ __forceinline__ void warp_sort(int (&v)[R], int lane) {
#pragma unroll
  for (int ls = 1; ls <= LOG_P; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride >= R) {
        // the partner is register r of lane ^ (stride / R)
        const int lanes = stride / R;
        const bool lower = (lane & lanes) == 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool up = ((lane * R + r) & size) == 0;
          const int other = __shfl_xor_sync(FULL, v[r], lanes);
          v[r] = (lower == up) ? min(v[r], other) : max(v[r], other);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & stride) == 0) {
            const bool up = ((lane * R + r) & size) == 0;
            const int a = v[r], b = v[r + stride];
            v[r] = up ? min(a, b) : max(a, b);
            v[r + stride] = up ? max(a, b) : min(a, b);
          }
        }
      }
    }
  }
}

// BF16: the scoring rows' type; VEC: d % 4 == 0; R: candidate slots a
// lane (P = 32 R >= C)
template <bool BF16, bool VEC, int R, int LOG_P>
__global__ void __launch_bounds__(WARPS * 32)
    nndescent_round_kernel(const RoundArgs a) {
  extern __shared__ float4 dyn_smem[];
  constexpr int P = 32 * R;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int nvec = (a.d + 3) >> 2;
  // the warp's slice: compacted candidate ids, their values, the query
  // (zero past d)
  float* slice = reinterpret_cast<float*>(dyn_smem) + warp * (2 * P + 4 * nvec);
  int* clist = reinterpret_cast<int*>(slice);
  float* sval = slice + P;
  float* q = slice + 2 * P;
  const int G = a.group, per = 32 / G, grp = lane / G, lig = lane & (G - 1);
  const int ss = a.s * a.s;
  unsigned exists = 0;  // bit r: slot lane R + r is a candidate (< C)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane * R + r < a.c) exists |= 1u << r;
  }
  unsigned long long scored = 0;
  const long long stride_rows = static_cast<long long>(gridDim.x) * WARPS;
  for (long long j = static_cast<long long>(blockIdx.x) * WARPS + warp;
       j < a.rows; j += stride_rows) {
    const long long row =
        a.size == 1 ? j
                    : (a.rank + (j / a.slab) * a.size) * a.slab + j % a.slab;
    if (row >= a.n) continue;  // the whole warp

    // the current list, the query, the candidate ids
    int cid = PAD_ID;
    float cdv = inf_f();
    if (lane < a.k) {
      cid = a.cur_idx[row * a.k + lane];
      cdv = a.cur_dist[row * a.k + lane];
    }
    for (int col = lane; col < 4 * nvec; col += 32) {
      q[col] = col < a.d ? load_elem<BF16>(a.x, row * a.d + col) : 0.0f;
    }
    const int outer = lane < a.s ? a.inner[row * a.s + lane] : 0;
    int ids[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = lane + 32 * r;
      const int hop = e < ss ? e / a.s : 0;
      const int o = __shfl_sync(FULL, outer, hop);
      int id = PAD_ID;
      if (e < ss) {
        id = a.inner[static_cast<long long>(o) * a.s + (e - hop * a.s)];
      } else if (e < a.c) {
        id = a.uni[row * a.u + (e - ss)];
      }
      ids[r] = id;
    }
    warp_sort<R, LOG_P>(ids, lane);

    // not scored: pads, self, repeats, the current list
    const int prev = __shfl_up_sync(FULL, ids[R - 1], 1);
    unsigned bad = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int before = r > 0 ? ids[r - 1] : (lane > 0 ? prev : -1);
      if (ids[r] >= a.n || ids[r] == row || ids[r] == before) bad |= 1u << r;
    }
    bool repeat = false;
    for (int t = 0; t < a.k; ++t) {
      const int o = __shfl_sync(FULL, cid, t);
      repeat = repeat || (t < lane && o == cid);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (ids[r] == o) bad |= 1u << r;
      }
    }
    if (repeat) cdv = inf_f();

    // compact the scored candidates: a prefix sum over the lanes
    const unsigned good = exists & ~bad;
    const int cnt = __popc(good);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    const int first = incl - cnt;
    {
      int w = first;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((good >> r) & 1u) clist[w++] = ids[r];
      }
    }
    scored += static_cast<unsigned long long>(cnt);
    __syncwarp();

    // score them: G lanes a row, U rows a group at once
    for (int b0 = 0; b0 < total; b0 += per * U) {
      float acc[U];
#pragma unroll
      for (int t = 0; t < U; ++t) acc[t] = 0.0f;
      for (int v = lig; v < nvec; v += G) {
        const float4 qv = reinterpret_cast<const float4*>(q)[v];
        float4 cv[U];
#pragma unroll
        for (int t = 0; t < U; ++t) {
          const int jj = b0 + t * per + grp;
          cv[t] = jj < total ? load_vec<BF16, VEC>(a.x, clist[jj], a.d, v)
                             : qv;
        }
#pragma unroll
        for (int t = 0; t < U; ++t) {
          const float dx = cv[t].x - qv.x, dy = cv[t].y - qv.y;
          const float dz = cv[t].z - qv.z, dw = cv[t].w - qv.w;
          acc[t] += dx * dx;
          acc[t] += dy * dy;
          acc[t] += dz * dz;
          acc[t] += dw * dw;
        }
      }
#pragma unroll
      for (int t = 0; t < U; ++t) {
        for (int off = G >> 1; off > 0; off >>= 1) {
          acc[t] += __shfl_xor_sync(FULL, acc[t], off);
        }
        const int jj = b0 + t * per + grp;
        if (lig == 0 && jj < total) sval[jj] = sqrtf(fmaxf(acc[t], 0.0f));
      }
    }
    __syncwarp();
    float val[R];
    {
      int w = first;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        val[r] = inf_f();
        if ((good >> r) & 1u) val[r] = sval[w++];
      }
    }

    // the merge: k rounds of the warp's least (value, position)
    unsigned taken = 0;  // bit r: slot r selected; bit R: the list entry
    if (lane >= a.k) taken |= 1u << R;
    int out_id = 0;
    float out_v = 0.0f;
    for (int t = 0; t < a.k; ++t) {
      unsigned kv = NONE, kp = NONE;
      int kid = 0, kslot = -1;
      if (!((taken >> R) & 1u)) {
        kv = ordered(cdv);
        kp = static_cast<unsigned>(lane);
        kid = cid;
        kslot = R;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (((exists & ~taken) >> r) & 1u) {
          const unsigned o = ordered(val[r]);
          if (o < kv) {
            kv = o;
            kp = static_cast<unsigned>(a.k + lane * R + r);
            kid = ids[r];
            kslot = r;
          }
        }
      }
      const unsigned vmin = __reduce_min_sync(FULL, kv);
      const unsigned pmin = __reduce_min_sync(FULL, kv == vmin ? kp : NONE);
      const bool own = kslot >= 0 && kv == vmin && kp == pmin;
      const unsigned who = __ballot_sync(FULL, own);
      const int wid = __shfl_sync(FULL, kid, __ffs(who) - 1);
      if (own) taken |= 1u << kslot;
      if (lane == t) {
        out_id = wid;
        out_v = unordered(vmin);
      }
    }
    if (lane < a.k) {
      a.out_idx[row * a.k + lane] = out_id;
      a.out_dist[row * a.k + lane] = fmaxf(out_v, 0.0f);
    }
    __syncwarp();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    scored += __shfl_xor_sync(FULL, scored, off);
  }
  if (lane == 0 && a.pairs != nullptr && scored > 0) {
    atomicAdd(a.pairs, scored);
  }
}

template <bool BF16, bool VEC, int R, int LOG_P>
int launch_instance(const RoundArgs& a, cudaStream_t st) {
  const int threads = WARPS * 32;
  const int nvec = (a.d + 3) / 4;
  const int smem =
      WARPS * (2 * 32 * R + 4 * nvec) * static_cast<int>(sizeof(float));
  int err = static_cast<int>(cudaFuncSetAttribute(
      nndescent_round_kernel<BF16, VEC, R, LOG_P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, nndescent_round_kernel<BF16, VEC, R, LOG_P>, threads, smem));
  if (err != 0) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long wanted = (a.rows + WARPS - 1) / WARPS;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned blocks =
      static_cast<unsigned>(wanted < resident ? wanted : resident);
  nndescent_round_kernel<BF16, VEC, R, LOG_P><<<blocks, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, bool VEC>
int launch_vec(const RoundArgs& a, cudaStream_t st) {
  if (a.c <= 256) return launch_instance<BF16, VEC, 8, 8>(a, st);
  return launch_instance<BF16, VEC, 16, 9>(a, st);
}

}  // namespace

// One round over the rows of (n, k) lists ``cur_idx`` / ``cur_dist``
// into ``out_idx`` / ``out_dist``: all rows (size 1), or the rows of the
// slabs rank, rank + size, ... of ``slab`` rows, the others left as they
// are.  ``x`` (n + 1, d) in bf16 (``bf16``) or f32; ``inner`` (n + 1, s)
// and ``uni`` (n + 1, u) int32; ``pairs`` an unsigned 64-bit count added
// to, or null.  k <= MAX_K, s^2 + u <= MAX_C and d <= MAX_D (the limits
// of ops/nndescent.py's route rule).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int nndescent_round_launch(
    const void* x, const void* inner, const void* uni, const void* cur_idx,
    const void* cur_dist, void* out_idx, void* out_dist, void* pairs, int n,
    int d, int k, int s, int u, int bf16, long long slab, int rank, int size,
    void* stream) {
  const int c = s * s + u;
  if (n < 0 || d < 1 || d > MAX_D || k < 1 || k > MAX_K || s < 1 || s > 32 ||
      u < 1 || c > MAX_C || slab < 1 || size < 1 || rank < 0 ||
      rank >= size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long rows = n;
  if (size > 1) {
    const long long slabs = (n + slab - 1) / slab;
    rows = slabs > rank ? (slabs - rank + size - 1) / size * slab : 0;
  }
  if (rows == 0) return 0;
  RoundArgs a;
  a.x = x;
  a.inner = static_cast<const int*>(inner);
  a.uni = static_cast<const int*>(uni);
  a.cur_idx = static_cast<const int*>(cur_idx);
  a.cur_dist = static_cast<const float*>(cur_dist);
  a.out_idx = static_cast<int*>(out_idx);
  a.out_dist = static_cast<float*>(out_dist);
  a.pairs = static_cast<unsigned long long*>(pairs);
  a.rows = rows;
  a.slab = slab;
  a.n = n;
  a.d = d;
  a.k = k;
  a.s = s;
  a.u = u;
  a.c = c;
  a.rank = rank;
  a.size = size;
  int nvec = (d + 3) / 4, group = 1;
  while (group < nvec && group < 32) group <<= 1;
  a.group = group;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0;
  if (bf16) {
    return vec ? launch_vec<true, true>(a, st) : launch_vec<true, false>(a, st);
  }
  return vec ? launch_vec<false, true>(a, st) : launch_vec<false, false>(a, st);
}
