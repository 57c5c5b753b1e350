// The IVF local join of the cell-sorted layout, DistL2: for every query
// position of every virtual row, the k nearest candidates of the windows
// of the cells its row probes, in one launch (or one launch a mesh rank).
//
// Replaces the torch join of knn/ivf.py (_ivf_join_sorted, _join_rows),
// the port of annembed_tpu/knn/ivf.py::_ivf_join_sorted (:159-230), which
// the JAX package runs as an XLA lax.map of jnp code, with no Pallas
// kernel.  It computes what that join computes, for the rows of the plan
// the caller builds (_ivf_rowplan_impl):
//   * virtual row r covers the sorted positions [qstarts[r], qstarts[r] +
//     qcap) of its cell qparents[r], cut at the cell's end;
//   * its candidates are the windows [starts[c], starts[c] + min(counts[c],
//     cap)) of the cells c = nbrs[qparents[r], 0..nprobe), laid end to end
//     in probe order: a candidate's slot is its probe, then its position
//     in the window.  A cell may be the sentinel empty cell (count 0);
//   * the value ranked is sqrt(max((|q|^2 + |c|^2) - 2 q.c, 0)), the
//     norms from the f32 rows (sqn), the cross product in f32 or, with
//     bf16, of the operands rounded to bf16 (nearest even), whose products
//     are exact in f32; the query itself is left out;
//   * the k smallest values, ties to the lower slot; then the exact f32
//     distance sqrt(sum (q - c)^2) of each selected pair, and a stable sort
//     by it;
//   * a query with fewer than k candidates ends its row with dist = inf and
//     the pad id n, which the caller's fix-up (_fixup_underfilled) repairs.
// Results go to row qpos of (n, k) outputs, ids in sorted-position space.
//
// What bounds it on an H100 SXM: operations.  At the 11M Higgs join (d 28,
// k 12, nprobe 24, cap 3,317, qcap 1,024) some 2-3e11 query-candidate pairs
// take 2 d flop each, 12-17 TFLOP (12-17 ms at the tensor cores' 989
// TFLOP/s in bf16, ~0.2 s on the CUDA cores' 67 TFLOP/s in f32); the
// windows, read once a virtual row, are ~30 GB (9 ms at 3.35 TB/s).  The
// torch join writes and rereads a distance panel for every pair instead.
//
// Design (plain SIMT, FMA on the CUDA cores; csrc/ivf_join_tc.cu is the
// same join with the cross products on the tensor cores, and
// ops/ivf_join.py::join_route picks one of the two by shape):
//   * one block of T threads per (virtual row, slice of T queries), one
//     query a thread; blocks of a row are adjacent, so the row's windows
//     come from L2 after the first;
//   * the block streams each window through shared memory in tiles
//     (d <= 32: 128 candidates x DC floats, DC the smallest of 4, 8, 16, 32
//     that holds d, the query in registers; d > 32: 32 candidates in chunks
//     of 32 columns, the query chunk in registers and 32 running dot
//     products), every operand rounded once as it enters the tile;
//   * a running top-k per thread in dynamic shared memory, one column a
//     thread, for every k.  Lists in registers (16 or 32 slots) measured
//     slower on the H100 at d 28 (989 against 892 ms at the 11M join, 41.1
//     against 38.7 ms at 1M: 94-126 registers a thread cut the blocks an
//     SM holds) and gained 0.3 ms only on the 1M x 2 grid join, so they
//     went (tools/torch_join_variants.py); the column tiles of 4, 8 and
//     16 stay, 1.9-2.4x faster than the 32-column one at d 2 and 3;
//   * a candidate is inserted only when its value is below the list's k-th
//     and comes after every entry already there (slots are visited in
//     order), so equal values keep the lower slot, as the twin's top-k
//     does; the square root is taken only for candidates whose d^2 is not
//     already above a bound that implies a larger value;
//   * the rerank (ivf_join_common.cuh::rerank_write) reads the selected
//     rows and the f32 query from memory, and sorts the list in place by
//     insertion (stable);
//   * no atomics: every output row is written by its own thread, so two
//     launches give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "ivf_join_common.cuh"

namespace {

using namespace ivfj;

// queries a block at most, candidates a tile (d <= 32), candidates a tile
// and columns a chunk (d > 32)
constexpr int THREADS = 128;
constexpr int TILE = 128;
constexpr int MTILE = 32;
constexpr int CHUNK = 32;
// shared memory a block may hold on an H100 (227 KB), and what a block
// keeps for its tiles beside its lists
constexpr int SMEM_LIMIT = 232448;
constexpr int SMEM_TILES = 24 * 1024;

// A thread's running top-k, ascending, in dynamic shared memory: slot i
// of thread t at [i T + t] (k values, then k ids)
struct TopK {
  float* v;
  int* id;
  int k, stride;

  __device__ __forceinline__ void init(int kk, int pad, float* smem) {
    k = kk;
    stride = blockDim.x;
    v = smem + threadIdx.x;
    id = reinterpret_cast<int*>(smem + static_cast<long long>(k) * stride) +
         threadIdx.x;
    for (int i = 0; i < k; ++i) {
      v[i * stride] = inf_f();
      id[i * stride] = pad;
    }
  }
  __device__ __forceinline__ float worst() const {
    return v[(k - 1) * stride];
  }
  __device__ __forceinline__ void insert(float x, int s) {
    int i = k - 1;
    while (i > 0 && v[(i - 1) * stride] > x) {
      v[i * stride] = v[(i - 1) * stride];
      id[i * stride] = id[(i - 1) * stride];
      --i;
    }
    v[i * stride] = x;
    id[i * stride] = s;
  }
  __device__ __forceinline__ void finish(const JoinArgs& a, int qpos) {
    rerank_write<1>(a, qpos, v, id, stride);
  }
};

// One candidate of slot order: ranked by sqrt(max(e, 0)) with e the
// expansion, inserted when below the k-th value.  ``bound`` is a d^2
// above which the value cannot be below the k-th value w: e > w^2 (1 +
// 2^-20) + 1e-36 puts sqrt(e) above w whatever the rounding of w^2, and
// a correctly rounded sqrt keeps the order.
__device__ __forceinline__ void consider(TopK& list, float& bound, float qsq,
                                         float csq, float dot, int pos,
                                         int qpos) {
  const float e = (qsq + csq) - 2.0f * dot;
  if (e > bound || pos == qpos) return;
  const float val = sqrtf(fmaxf(e, 0.0f));
  if (!(val < list.worst())) return;
  list.insert(val, pos);
  const float w = list.worst();
  bound = w * w * 1.000001f + 1.0e-36f;
}

// rows [row, row + m) of columns [col, col + DC) into a (rows x DC) tile,
// zero beyond m rows and d columns, rounded for a bf16 product; their
// |c|^2 beside it
template <int DC, int ROWS>
__device__ __forceinline__ void load_tile(const JoinArgs& a, float* tile,
                                          float* tile_sq, int row, int m,
                                          int col) {
  const int cols = a.d - col;
  for (int e = threadIdx.x; e < ROWS * DC; e += blockDim.x) {
    const int i = e / DC, j = e % DC;
    float x = 0.0f;
    if (i < m && j < cols) {
      x = a.xs[static_cast<long long>(row + i) * a.d + col + j];
      if (a.bf16) x = bf16_round(x);
    }
    tile[e] = x;
  }
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
    tile_sq[i] = i < m ? a.sqn[row + i] : 0.0f;
  }
}

// columns [col, col + DC) of the query, rounded for a bf16 product
template <int DC>
__device__ __forceinline__ void load_query(const JoinArgs& a, float* q,
                                           int qpos, int col) {
  const float* row = a.xs + static_cast<long long>(qpos) * a.d + col;
  const int cols = a.d - col;
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    float x = j < cols ? row[j] : 0.0f;
    q[j] = a.bf16 ? bf16_round(x) : x;
  }
}

// q . c over DC columns, two running sums
template <int DC>
__device__ __forceinline__ float dot_tile(const float* q, const float* c) {
  const float4* c4 = reinterpret_cast<const float4*>(c);
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int j = 0; j < DC / 4; ++j) {
    const float4 x = c4[j];
    s0 += q[4 * j] * x.x;
    s1 += q[4 * j + 1] * x.y;
    s0 += q[4 * j + 2] * x.z;
    s1 += q[4 * j + 3] * x.w;
  }
  return s0 + s1;
}

// MULTI: d > 32, in chunks of DC = 32 columns.
template <int DC, bool MULTI>
__global__ void __launch_bounds__(THREADS)
    ivf_join_kernel(const JoinArgs a) {
  constexpr int TC = MULTI ? MTILE : TILE;
  __shared__ __align__(16) float tile[TC * DC];
  __shared__ float tile_sq[TC];
  __shared__ float dots[MULTI ? TC * THREADS : 1];
  extern __shared__ float4 dyn_smem[];

  const int t = threadIdx.x, T = blockDim.x;
  const long long vrow =
      a.row0 + static_cast<long long>(blockIdx.x / a.slices) * a.row_step;
  const int first = static_cast<int>(blockIdx.x % a.slices) * T;
  const int parent = a.qparents[vrow];
  const int qstart = a.qstarts[vrow];
  const int qn = min(a.starts[parent] + a.counts[parent] - qstart, a.qcap);
  if (first >= qn) return;  // the whole block
  const bool valid = first + t < qn;
  const int qpos = valid ? qstart + first + t : a.n;

  float q[DC];
  if (!MULTI && valid) load_query<DC>(a, q, qpos, 0);
  const float qsq = a.sqn[qpos];
  TopK list;
  list.init(a.k, a.n, reinterpret_cast<float*>(dyn_smem));
  float bound = inf_f();
  const int nch = MULTI ? (a.d + DC - 1) / DC : 1;
  const int* probes = a.nbrs + static_cast<long long>(parent) * a.nprobe;

  for (int p = 0; p < a.nprobe; ++p) {
    const int cell = probes[p];
    const int cs = a.starts[cell];
    const int cc = min(a.counts[cell], a.cap);
    for (int c0 = 0; c0 < cc; c0 += TC) {
      const int m = min(TC, cc - c0);
      if constexpr (!MULTI) {
        __syncthreads();
        load_tile<DC, TC>(a, tile, tile_sq, cs + c0, m, 0);
        __syncthreads();
        if (valid) {
          for (int i = 0; i < m; ++i) {
            consider(list, bound, qsq, tile_sq[i],
                     dot_tile<DC>(q, tile + i * DC), cs + c0 + i, qpos);
          }
        }
      } else {
        float acc[TC];
#pragma unroll
        for (int i = 0; i < TC; ++i) acc[i] = 0.0f;
        for (int ch = 0; ch < nch; ++ch) {
          __syncthreads();
          load_tile<DC, TC>(a, tile, tile_sq, cs + c0, m, ch * DC);
          __syncthreads();
          if (valid) {
            load_query<DC>(a, q, qpos, ch * DC);
#pragma unroll
            for (int i = 0; i < TC; ++i) {
              acc[i] += dot_tile<DC>(q, tile + i * DC);
            }
          }
        }
        if (valid) {
#pragma unroll
          for (int i = 0; i < TC; ++i) dots[i * THREADS + t] = acc[i];
          for (int i = 0; i < m; ++i) {
            consider(list, bound, qsq, tile_sq[i], dots[i * THREADS + t],
                     cs + c0 + i, qpos);
          }
        }
      }
    }
  }
  if (valid) list.finish(a, qpos);
}

// threads a block: the most (a multiple of 32, at most THREADS) whose
// lists of k values and ids fit beside the tiles
int block_threads(int k) {
  const long long per_thread = 8LL * k;
  long long t = (SMEM_LIMIT - SMEM_TILES) / per_thread;
  t = t / 32 * 32;
  return static_cast<int>(t > THREADS ? THREADS : t);
}

template <int DC, bool MULTI>
int launch_instance(JoinArgs a, long long rows, cudaStream_t st) {
  const int threads = block_threads(a.k);
  if (threads < 32) return static_cast<int>(cudaErrorInvalidValue);
  // the lists, opted in at every size: beside the tiles' static arrays
  // they pass the default 48 KB of a block before they reach it alone
  // (k 32 at d 17-32 did)
  const int smem = 8 * a.k * threads;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      ivf_join_kernel<DC, MULTI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  a.slices = (a.qcap + threads - 1) / threads;
  const long long blocks = rows * a.slices;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  ivf_join_kernel<DC, MULTI><<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the largest k the join serves (32 threads a block)
extern "C" int ivf_join_max_k() {
  return static_cast<int>((SMEM_LIMIT - SMEM_TILES) / (8LL * 32));
}

// The join of the virtual rows row0, row0 + row_step, ... (``rows`` of
// them) into (n, k) outputs; the rows of other launches are left as they
// are.  Returns the CUDA error of the launch (0 on success).
extern "C" int ivf_join_launch(const void* xs, const void* sqn,
                               const void* qstarts, const void* qparents,
                               const void* starts, const void* counts,
                               const void* nbrs, void* out_idx,
                               void* out_dist, long long rows, long long row0,
                               long long row_step, int n, int d, int k,
                               int nprobe, int qcap, int cap, int bf16,
                               void* stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > ivf_join_max_k() || d < 1 || qcap < 1 || nprobe < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  JoinArgs a;
  a.xs = static_cast<const float*>(xs);
  a.sqn = static_cast<const float*>(sqn);
  a.qstarts = static_cast<const int*>(qstarts);
  a.qparents = static_cast<const int*>(qparents);
  a.starts = static_cast<const int*>(starts);
  a.counts = static_cast<const int*>(counts);
  a.nbrs = static_cast<const int*>(nbrs);
  a.out_idx = static_cast<int*>(out_idx);
  a.out_dist = static_cast<float*>(out_dist);
  a.row0 = row0;
  a.row_step = row_step;
  a.n = n;
  a.d = d;
  a.k = k;
  a.nprobe = nprobe;
  a.qcap = qcap;
  a.cap = cap;
  a.slices = 1;
  a.bf16 = bf16;
  a.rank_v = nullptr;
  a.rank_i = nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 4) return launch_instance<4, false>(a, rows, st);
  if (d <= 8) return launch_instance<8, false>(a, rows, st);
  if (d <= 16) return launch_instance<16, false>(a, rows, st);
  if (d <= 32) return launch_instance<32, false>(a, rows, st);
  return launch_instance<CHUNK, true>(a, rows, st);
}
