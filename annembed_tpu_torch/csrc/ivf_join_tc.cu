// The IVF local join of the cell-sorted layout, DistL2, with the cross
// products on Hopper's tensor cores (wgmma): for every query position of
// every virtual row, the k nearest candidates of the windows of the cells
// its row probes, in one launch (or one launch a mesh rank).
//
// Computes what csrc/ivf_join.cu (the SIMT route) and its twin, the torch
// join of knn/ivf.py (_ivf_join_sorted), compute: the port of
// annembed_tpu/knn/ivf.py::_ivf_join_sorted (:159-230), an XLA lax.map
// of jnp code; the JAX package has no Pallas kernel for the join.  Per
// virtual row r: its queries [qstarts[r], + qcap) of cell qparents[r],
// its candidates the windows [starts[c], + min(counts[c], cap)) of the
// probed cells c = nbrs[qparents[r], 0..nprobe) laid end to end in probe
// order (a candidate's slot); the value ranked sqrt(max((|q|^2 + |c|^2) -
// 2 q.c, 0)), norms from the f32 rows, the query itself left out; the k
// smallest, ties to the lower slot; then the exact f32 distance and a
// stable sort; an underfilled row ends in inf with the pad id n.
//
// What bounds it on an H100 SXM: at the 11M Higgs join (d 28, k 12,
// nprobe 24, bf16; 2.5e11 pairs) the products, 1.4e13 flop, take 14.2 ms
// at the tensor cores' 989 TFLOP/s in bf16 (3xTF32 for f32 at 495: three
// times the flop at half the rate); the windows, read once a virtual row,
// 13.4 ms at 3.35 TB/s; and one compare a pair on the CUDA cores'
// 3.35e13 issue slots/s, 7.5 ms.  The SIMT route spends ~46 issue slots
// a pair (shared loads and 32 FMAs), 0.8 s.  What bounds this kernel is
// the selection: per query ~124 insertions into the partial lists (the
// candidates come in no order of distance), and the latency of each
// tile's chain (the products, their wait, the filter, the quad's cap)
// with 12 warps an SM (PERF.md, tools/torch_join_variants.py).
//
// Design:
//   * Operands (ivf_join_common.cuh): a prologue kernel writes the corpus
//     once as -2 x with its norm's pieces in the padding columns (bf16:
//     three bf16 pieces; f32: TF32 hi / lo planes of the same), and the
//     query row carries ones there, so the accumulator holds |c|^2 - 2
//     q.c and the pair's value is |q|^2 + acc: one add, and the hot loop
//     one compare a pair.  The copy is kept as 16-byte planes (8 bf16 or
//     4 TF32 columns of every row), so any run of rows of a plane is one
//     contiguous bulk copy into wgmma's no-swizzle K-major layout (a
//     tile's plane: 64 rows x 16 bytes; LBO one plane, SBO 8 rows).
//   * One block per (virtual row, slice of 64 ncons queries): ncons
//     consumer warpgroups of 64 queries (3 with 12-slot lists, 2 with 24:
//     what the registers hold), the query operand in shared
//     memory; one producer warp keeps a ring of 8 candidate tiles of 64
//     slots in flight, a tile running across window boundaries (one bulk
//     copy per window piece and plane, the planes over the warp's lanes,
//     completing on an mbarrier).  The blocks of a row are adjacent, so
//     its windows come from L2 after the first.
//   * Products: wgmma m64n64k16 bf16 (d + 3 <= 16 or 32: one or two
//     k-steps) or m64n64k8 TF32, three products a k-step (lo.hi, hi.lo,
//     hi.hi, the small terms first), both operands from shared memory.
//   * Selection in the fragment: a thread holds 2 query rows x 16 tile
//     columns and, in registers, a partial top-k of the columns it holds
//     for each (RegList: a runtime k in compile-time slots, inserted by
//     selects, no memory); per row it takes the minimum of its 16 values
//     and compares it once with a threshold that implies "cannot enter"
//     (RowSel::thr); only then are its passing columns tested exactly, in
//     slot order, in one loop the warp runs for all its passing threads
//     together.  After each tile the quad's four lists cap the row's k-th
//     value (two shuffles), so a thread's threshold follows the row's k
//     smallest and not only its own.  At the end the lists go to shared
//     memory, each row's four are merged by (value, slot), which is the
//     row's k smallest with ties to the lower slot, then the exact rerank
//     and the stable sort (rerank_write, shared with the SIMT route).
//   * No atomics: every output row is written by one thread, so two
//     launches give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "ivf_join_common.cuh"
#include "sm90_ptx.cuh"

namespace {

using namespace ivfj;

// one plane of a tile (64 candidate rows) or of a warpgroup's queries (64
// rows): 64 x 16 bytes; the next 8 rows within it
constexpr int PLANE_BYTES = TC_BN * 16;
constexpr uint32_t SBO = 128;

template <bool BF16, int KS>
struct Tile {
  static constexpr int NCH = 2 * KS;        // planes of one set
  static constexpr int PLANES = (BF16 ? 1 : 2) * NCH;
  static constexpr int STAGE_BYTES = PLANES * PLANE_BYTES;
};

// The operand copy: plane p of row r (16 bytes) at planes[p (n + 1) + r].
template <bool BF16, int KS>
__global__ void tc_operands_kernel(const JoinArgs a,
                                   uint4* __restrict__ planes) {
  using T = Tile<BF16, KS>;
  const long long rows = a.n + 1LL;
  const long long total = T::PLANES * rows;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(e / rows);
    const long long r = e % rows;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (BF16) {
        w[i] = b_bf16(a, r, 8 * p + 2 * i) |
               (static_cast<uint32_t>(b_bf16(a, r, 8 * p + 2 * i + 1)) << 16);
      } else {
        w[i] = __float_as_uint(b_tf32(a, r, 4 * (p % T::NCH) + i,
                                      p / T::NCH));
      }
    }
    planes[e] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ uint64_t desc(const unsigned char* p) {
  return sm90::smem_desc(p, PLANE_BYTES, SBO);
}

// KL: list slots (12 or 24); MAXC: consumer warpgroups at most (the
// registers of KL: with the producer warp, 13 warps leave 128 registers
// a thread, 9 168; warps take registers in groups of four)
template <bool BF16, int KS, int KL, int MAXC>
__global__ void __launch_bounds__(MAXC * 128 + 32, 1)
    ivf_join_tc_kernel(const JoinArgs a, const uint4* __restrict__ planes,
                       int ncons) {
  using T = Tile<BF16, KS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int k = a.k;
  const int nt = 128 * ncons;
  const long long ring = tc_ring_bytes(a.d, a.bf16, ncons, k);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring);
  uint64_t* empty = full + TC_STAGES;
  int* wstart = reinterpret_cast<int*>(empty + TC_STAGES);
  int* wlen = wstart + a.nprobe;
  int* woff = wlen + a.nprobe;
  unsigned char* a_tiles =
      smem + ring + 16 * TC_STAGES + tc_table_bytes(a.nprobe);

  const int tid = threadIdx.x;
  const long long vrow =
      a.row0 + static_cast<long long>(blockIdx.x / a.slices) * a.row_step;
  const int first = static_cast<int>(blockIdx.x % a.slices) * 64 * ncons;
  const int parent = a.qparents[vrow];
  const int qstart = a.qstarts[vrow];
  const int qn = min(a.starts[parent] + a.counts[parent] - qstart, a.qcap);
  if (first >= qn) return;  // the whole block
  const int nact = min(ncons, (qn - first + 63) / 64);

  const int* probes = a.nbrs + static_cast<long long>(parent) * a.nprobe;
  for (int p = tid; p < a.nprobe; p += blockDim.x) {
    const int cell = probes[p];
    wstart[p] = a.starts[cell];
    wlen[p] = min(a.counts[cell], a.cap);
  }
  // the query operands: warpgroup w's row r (query first + 64 w + r) in
  // plane p at a_tiles + (w PLANES + p) PLANE_BYTES + 16 r
  for (int c = tid; c < nact * T::PLANES * 64; c += blockDim.x) {
    const int r = c % 64, p = (c / 64) % T::PLANES, w = c / (64 * T::PLANES);
    const int qi = first + 64 * w + r;
    const bool valid = qi < qn;
    const long long q = valid ? qstart + qi : a.n;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (BF16) {
        v[i] = a_bf16(a, q, valid, 8 * p + 2 * i) |
               (static_cast<uint32_t>(a_bf16(a, q, valid, 8 * p + 2 * i + 1))
                << 16);
      } else {
        v[i] = __float_as_uint(
            a_tf32(a, q, valid, 4 * (p % T::NCH) + i, p / T::NCH));
      }
    }
    *reinterpret_cast<uint4*>(a_tiles + (w * T::PLANES + p) * PLANE_BYTES +
                              16 * r) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  sm90::fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * nact);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    int o = 0;
    for (int p = 0; p < a.nprobe; ++p) {
      woff[p] = o;
      o += wlen[p];
    }
    woff[a.nprobe] = o;
  }
  __syncthreads();
  const Windows win{wstart, wlen, woff, a.nprobe};
  const int total = woff[a.nprobe];
  const int ntiles = (total + TC_BN - 1) / TC_BN;
  const int warp = tid / 32, lane = tid % 32;

  if (warp == 4 * ncons) {
    // producer: tile t holds slots [64 t, 64 t + 64), one bulk copy per
    // window piece and plane, the planes over the warp's lanes
    int p = 0, within = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % TC_STAGES;
      sm90::mbar_wait(&empty[st],
                      static_cast<uint32_t>((t / TC_STAGES) & 1) ^ 1);
      const int rows = min(TC_BN, total - t * TC_BN);
      unsigned char* buf = smem + static_cast<long long>(st) * T::STAGE_BYTES;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[st], rows * 16 * T::PLANES);
      }
      __syncwarp();
      for (int filled = 0; filled < rows;) {
        while (within == wlen[p]) {
          ++p;
          within = 0;
        }
        const int m = min(rows - filled, wlen[p] - within);
        const long long src = static_cast<long long>(wstart[p]) + within;
        for (int pl = lane; pl < T::PLANES; pl += 32) {
          sm90::bulk_g2s(buf + pl * PLANE_BYTES + filled * 16,
                         planes + pl * (a.n + 1LL) + src,
                         static_cast<uint32_t>(m) * 16, &full[st]);
        }
        filled += m;
        within += m;
      }
    }
    return;
  }
  if (warp >= 4 * nact) return;  // a warpgroup past the slice's queries

  // consumers: warpgroup wg holds queries [first + 64 wg, + 64) of the
  // row; this thread rows rr and rr + 8 of them, columns 8 j + 2 quad + e
  const int wg = warp / 4, quad = lane % 4;
  const int rr = (warp % 4) * 16 + lane / 4;
  const unsigned char* a_tile = a_tiles + wg * T::PLANES * PLANE_BYTES;
  RowSel<KL> rs[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = first + wg * 64 + rr + 8 * h;
    const bool valid = qi < qn;
    qpos[h] = valid ? qstart + qi : a.n;
    rs[h].init(k, valid, a.sqn[qpos[h]],
               valid ? win.slot_of(qpos[h]) : SLOT_NONE);
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % TC_STAGES;
    sm90::mbar_wait(&full[st], static_cast<uint32_t>((t / TC_STAGES) & 1));
    const unsigned char* buf =
        smem + static_cast<long long>(st) * T::STAGE_BYTES;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    if constexpr (BF16) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        sm90::wgmma_m64n64k16_bf16_ss(
            acc, desc(a_tile + 2 * s * PLANE_BYTES),
            desc(buf + 2 * s * PLANE_BYTES), s > 0);
      }
    } else {
      // lo.hi, hi.lo, hi.hi: plane set 0 holds hi, set 1 lo (A and B)
      constexpr int LO = T::NCH * PLANE_BYTES;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        sm90::wgmma_m64n64k8_tf32_ss(
            acc, desc(a_tile + LO + 2 * s * PLANE_BYTES),
            desc(buf + 2 * s * PLANE_BYTES), s > 0);
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        sm90::wgmma_m64n64k8_tf32_ss(
            acc, desc(a_tile + 2 * s * PLANE_BYTES),
            desc(buf + LO + 2 * s * PLANE_BYTES), 1);
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        sm90::wgmma_m64n64k8_tf32_ss(
            acc, desc(a_tile + 2 * s * PLANE_BYTES),
            desc(buf + 2 * s * PLANE_BYTES), 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
    filter_tile<TC_BN / 8>(acc, rs, t * TC_BN, 2 * quad, total - t * TC_BN,
                           k);
    // the quad's cap on each row's k-th value, for the next tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float q = rs[h].quarter;
      q = fmaxf(q, __shfl_xor_sync(0xffffffffu, q, 1));
      q = fmaxf(q, __shfl_xor_sync(0xffffffffu, q, 2));
      rs[h].tighten(q);
    }
  }

  // every active consumer is through the ring: it holds the lists (entry
  // i of row h of thread t at [(2 i + h) nt + t]) and the merged rows
  asm volatile("bar.sync 1, %0;\n" :: "r"(128 * nact) : "memory");
  float* lists_v = reinterpret_cast<float*>(smem);
  int* lists_s = reinterpret_cast<int*>(lists_v + 2LL * k * nt);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h].list.store(lists_v + h * nt + tid, lists_s + h * nt + tid, 2 * nt,
                     k);
  }
  __syncwarp();
  const int h = quad;
  if (h < 2 && (h == 0 ? rs[0].valid : rs[1].valid)) {
    float* mv = reinterpret_cast<float*>(lists_s + 2LL * k * nt);
    int* mid = reinterpret_cast<int*>(mv + 64LL * ncons * k);
    const long long rb = (wg * 64 + rr + 8 * h) * static_cast<long long>(k);
    const int q0 = tid & ~3;
    float* const lv[4] = {lists_v + h * nt + q0, lists_v + h * nt + q0 + 1,
                          lists_v + h * nt + q0 + 2,
                          lists_v + h * nt + q0 + 3};
    int* const ls[4] = {lists_s + h * nt + q0, lists_s + h * nt + q0 + 1,
                        lists_s + h * nt + q0 + 2, lists_s + h * nt + q0 + 3};
    const int q = h == 0 ? qpos[0] : qpos[1];
    merge_quad(lv, ls, 2 * nt, k, win, a.n, mv + rb, mid + rb);
    if (a.rank_v != nullptr) {
      for (int i = 0; i < k; ++i) {
        a.rank_v[static_cast<long long>(q) * k + i] = mv[rb + i];
        a.rank_i[static_cast<long long>(q) * k + i] = mid[rb + i];
      }
    }
    rerank_write<4>(a, q, mv + rb, mid + rb, 1);
  }
}

template <bool BF16, int KS, int KL>
int launch_tc(JoinArgs a, long long rows, void* operands, cudaStream_t st) {
  using T = Tile<BF16, KS>;
  constexpr int MAXC = KL == 12 ? 3 : 2;
  uint4* planes = static_cast<uint4*>(operands);
  const long long total = T::PLANES * (a.n + 1LL);
  const long long prep = (total + 255) / 256;
  tc_operands_kernel<BF16, KS>
      <<<static_cast<unsigned>(prep < 65536 ? prep : 65536), 256, 0, st>>>(
          a, planes);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int ncons = tc_consumers(a.d, a.bf16, a.k, a.nprobe);
  if (ncons == 0 || ncons > MAXC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = tc_smem_bytes(a.d, a.bf16, ncons, a.k, a.nprobe);
  err = static_cast<int>(cudaFuncSetAttribute(
      ivf_join_tc_kernel<BF16, KS, KL, MAXC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err != 0) return err;
  a.slices = (a.qcap + 64 * ncons - 1) / (64 * ncons);
  const long long blocks = rows * a.slices;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ivf_join_tc_kernel<BF16, KS, KL, MAXC>
      <<<static_cast<unsigned>(blocks), 128 * ncons + 32,
         static_cast<size_t>(smem), st>>>(a, planes, ncons);
  return static_cast<int>(cudaGetLastError());
}

template <int KL>
int dispatch(JoinArgs a, long long rows, void* operands, cudaStream_t st) {
  const int ks = tc_ksteps(a.d, a.bf16);
  if (a.bf16) {
    return ks == 1 ? launch_tc<true, 1, KL>(a, rows, operands, st)
                   : launch_tc<true, 2, KL>(a, rows, operands, st);
  }
  if (ks == 1) return launch_tc<false, 1, KL>(a, rows, operands, st);
  if (ks == 2) return launch_tc<false, 2, KL>(a, rows, operands, st);
  return launch_tc<false, 4, KL>(a, rows, operands, st);
}

}  // namespace

// Bytes of the operand copy the launch takes as scratch for an (n + 1, d)
// corpus.
extern "C" long long ivf_join_tc_operand_bytes(int n, int d, int bf16) {
  return tc_operand_bytes(n, d, bf16);
}

// The largest k the route serves at (d, dtype, nprobe); 0 for a d it does
// not serve.
extern "C" int ivf_join_tc_max_k(int d, int bf16, int nprobe) {
  return tc_max_k(d, bf16, nprobe);
}

// The join of the virtual rows row0, row0 + row_step, ... (``rows`` of
// them) into (n, k) outputs, the rows of other launches left as they are;
// ``operands`` is ivf_join_tc_operand_bytes of scratch; ``rank_v`` /
// ``rank_i``, when not null, (n, k) outputs of the ranked values and ids
// before the rerank (JoinArgs).  Returns the first CUDA error of its two
// launches (0 on success).
extern "C" int ivf_join_tc_launch(const void* xs, const void* sqn,
                                  const void* qstarts, const void* qparents,
                                  const void* starts, const void* counts,
                                  const void* nbrs, void* out_idx,
                                  void* out_dist, long long rows,
                                  long long row0, long long row_step, int n,
                                  int d, int k, int nprobe, int qcap, int cap,
                                  int bf16, void* operands, void* rank_v,
                                  void* rank_i, void* stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > tc_max_k(d, bf16, nprobe) || qcap < 1 ||
      nprobe < 1) {
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
  a.rank_v = static_cast<float*>(rank_v);
  a.rank_i = static_cast<int*>(rank_i);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tc_list_slots(k) == 12 ? dispatch<12>(a, rows, operands, st)
                                 : dispatch<24>(a, rows, operands, st);
}
