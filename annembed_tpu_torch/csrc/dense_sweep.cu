// Sub-sweeps of the dense CE optimizer: the closed-form attraction of
// every row's kg edges of one column group, then every row's n_neg
// repulsion kicks.  Two ways to launch the same per-row code:
//   * the per-sweep pair (dense_attraction_launch, dense_kick_launch):
//     one sweep of the rows [lo, lo + rows), two launches;
//   * the persistent launch (dense_sweeps_launch): a run of whole-array
//     sweeps in one cooperative launch of co-resident blocks, a grid
//     barrier between the attraction and the kicks and between sweeps,
//     each sweep's gamma, pool offset and column group read from small
//     device arrays.
//
// Replaces the sweep of annembed_tpu/optim/dense.py, which the JAX
// package runs as an XLA fusion of jnp code, with no Pallas kernel (its
// Mosaic build lacks a dynamic vector gather): _attraction_sweep_sfT
// (:272) and _repulsion_block_T (:406) with _neighbor_rejection and
// _repulsion_kick_T.  It computes what the port's optim/dense.py
// computes, in the same order of operations, for the rows [lo, lo + rows)
// of an (n, d) embedding:
//   * attraction (attraction_row): for each edge j = idx[l] of the row's
//     group record, d2 = |y_j - y_i|^2, the clipped fractions alpha_f
//     (from the row's scale and w) and alpha_r (the neighbour's scale and
//     w_rev), the pair's remaining gap f = max(exp(m_eff log clamp(1 - 2
//     alpha_f) + m_rev log clamp(1 - 2 alpha_r)), f_min) and y1_i = y_i +
//     sum_l (y_j - y_i) (w_rev > 0 ? 0.5 : 1) (1 - f);
//   * kicks (kick_row): kick t pairs position p with (p + offset +
//     t max(1, n / n_neg)) mod n of the post-attraction snapshot,
//     rejected when that partner is p itself or one of p's k neighbours;
//     coefficient min(gamma coeff / max(d2s^2, 1/16), 2), times the
//     partner's hubness weight; chained on the row's running position,
//     or (parallel kicks) all read from the snapshot and summed.
//
// What bounds it on an H100 SXM: bytes.  A sweep at the 11M Higgs large
// step (d 2, kg 3, k 6, n_neg 5, hubness weights) reads every input once
// in ~120 bytes a row (1.3 GB, 0.39 ms at 3.35 TB/s); each row's reads of
// kg random neighbour rows fetch a 32-byte sector for 8 bytes; the
// operations (a few hundred f32 ops and 2 kg + 1 logs and exps a row) are
// ~40x below the byte time.  Latency, not arithmetic, is what the design
// has to hide, and at small n the launches themselves.
//
// Design:
//   * one thread per row (grid-stride in the persistent launch), f32,
//     precise expf / logf / powf, no atomics: every output row is written
//     by its own thread only, so two launches on the same input are
//     bit-equal, and both launch modes give the same bits;
//   * built with -fmad=false (ops/_build.py): every product and sum
//     rounds as the twin's separate torch ops round it.  The kicks' map
//     is expansive (a capped coefficient near the 1/16 pole scales a
//     difference in y by more than 3 a kick), so an FMA's one-ulp
//     difference grows to ~1e-4 of max|y| over five kicks;
//   * one code path for the rows of d 2 and 3, held in registers: a
//     row's edges and kicks run in chunks whose loads are all issued
//     before their arithmetic.  A compile-time instance takes all of
//     them in one chunk, so the row's record and its kg neighbour rows
//     (d 2, kg 3), or also its n_neg partner rows and their weights (the
//     persistent launch at n_neg 5 and 10), are in flight at once and
//     the chained kicks run from registers; the runtime-bound instance
//     takes one edge or kick a chunk.  Which shapes get which is
//     measured (the dispatch, below).  Any other d keeps the row in its
//     output row;
//   * a group's constant edge tables are one record a row (ops/
//     dense_sweep.py::pack_groups): kg ids, then kg each of w, m, w_rev,
//     m_rev and the neighbours' scales, padded to 16 bytes and read with
//     128-bit loads (five at kg 3) instead of 18 scalar streams;
//   * coordinates row-major (n, d): at d = 2 a row is one 8-byte load,
//     at d = 3 three scalars.  What a launch writes (y, a) is read
//     through L2 (ld.global.cg),
//     coherent across the persistent launch's grid barriers; the constant
//     tables through the read-only path;
//   * the kicks must see every row's attraction: the attraction writes
//     the rows to a buffer `a`, the kicks read partners inside the block
//     from `a` and outside it from `y` (rows no launch writes), and write
//     `out`, which may be the block's own rows of `y`.  The persistent
//     launch puts a grid barrier where the pair puts its second launch;
//   * partner windows are read with a modular index, so no
//     wraparound-extended copy of the snapshot is built.
//
// Launch contract: runs on the caller's stream, allocates nothing,
// returns the CUDA error of its launch (a refused cooperative launch is
// returned, never replaced by another launch).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
// the persistent launch's block: its grid barrier waits on every block
constexpr int SWEEP_THREADS = 256;
// 1 / PROBA_MIN (params.py): the attraction's pole floor
constexpr float REP_ATT_FLOOR = 1.0e4f;
// the kicks' pole floor
constexpr float REP_FLOOR = 1.0f / 16.0f;
// the fields of an edge record, kg words each: ids, w, m, w_rev, m_rev,
// the neighbours' scales
constexpr int FIELDS = 6;

struct Shape {
  float b, b_minus_1, two_b;  // the kernel exponent and its derived forms
  float gamma;
};

// The attraction of rows [lo, lo + rows): y, ysrc (n, d); edges (rows,
// words) records; scale (n,); mask (kg, rows) or null; out (rows, d).
struct AttArgs {
  const float* y;
  const float* ysrc;
  const int32_t* edges;
  const float* scale;
  const float* mask;
  float* out;
  long long rows, lo;
  int kg, d, words;
  Shape s;
  float f_min, inv_mask_p;
};

// The kicks of rows [lo, lo + rows): y (n, d) outside the block, a
// (rows, d) the block after its attraction, idx_full (k, rows), scale and
// neg_weight (n,), neg_weight may be null; out (rows, d).
struct KickArgs {
  const float* y;
  const float* a;
  const int32_t* idx_full;
  const float* scale;
  const float* neg_weight;
  float* out;
  long long rows, lo, n, offset, stride;
  int k, d, n_neg;
  Shape s;
  int exclusion, parallel, flat;
};

// The persistent launch's per-sweep inputs: group g's records start at
// edges + g * group_stride.
struct Plan {
  const int32_t* edges;
  long long group_stride;
  const float* gammas;
  const long long* offsets;
  const int32_t* groups;
  long long steps;
};

// The persistent launch's one argument
struct Sweeps {
  AttArgs att;
  KickArgs kick;
  Plan plan;
};

// 2 b cauchy d2s^(b-1) / scale^2 (optim/ce.py::_common_coeff)
__device__ __forceinline__ float common_coeff(float d2s, float scale,
                                              const Shape& s) {
  const float s2 = scale * scale;
  if (s.b == 1.0f) {
    const float cauchy = 1.0f / (1.0f + d2s);
    return 2.0f * cauchy / s2;
  }
  const float d2c = fmaxf(d2s, 1e-30f);
  const float cauchy = 1.0f / (1.0f + powf(d2c, s.b));
  return s.two_b * cauchy * powf(d2c, s.b_minus_1) / s2;
}

// optim/dense.py::_clipped_alpha
__device__ __forceinline__ float clipped_alpha(float d2s, float scale,
                                               float w, const Shape& s) {
  const float coeff = common_coeff(d2s, scale, s);
  const float rep_att = 1.0f / fmaxf(d2s * d2s, REP_ATT_FLOOR);
  const float cij =
      fmaxf(s.gamma * coeff * (-w + (1.0f - w) * rep_att), -0.49f);
  return d2s > 0.0f ? -cij : 0.0f;
}

__device__ __forceinline__ float log_gap(float alpha) {
  return logf(fminf(fmaxf(1.0f - 2.0f * alpha, 1e-3f), 1.05f));
}

// One edge's move of the row: (1 - f) with the mutual-pair split
__device__ __forceinline__ float edge_net(float d2, float si, float si2,
                                          float w, float m, float w_rev,
                                          float m_rev, float sj,
                                          const float* mask, float mask_e,
                                          const AttArgs& p) {
  const float af = clipped_alpha(d2 / si2, si, w, p.s);
  const float ar = clipped_alpha(d2 / (sj * sj), sj, w_rev, p.s);
  const float m_eff = mask ? m * mask_e * p.inv_mask_p : m;
  const float f =
      fmaxf(expf(m_eff * log_gap(af) + m_rev * log_gap(ar)), p.f_min);
  return (w_rev > 0.0f ? 0.5f : 1.0f) * (1.0f - f);
}

// Row i of a row-major (n, D) array the launch may write, through L2
template <int D>
__device__ __forceinline__ void load_row(const float* base, long long i,
                                         float (&v)[D]) {
  if constexpr (D == 2) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(base) + i);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = __ldcg(base + i * D + c);
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* base, long long i,
                                          const float (&v)[D]) {
  if constexpr (D == 2) {
    reinterpret_cast<float2*>(base)[i] = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) base[i * D + c] = v[c];
  }
}

// The attraction of row lo + r.  D > 0: the row in registers, its kg
// edges in chunks of KG (KG > 0: one chunk, the record read with 128-bit
// loads) or of one (KG == 0, runtime kg), each chunk's neighbour rows all
// loaded before its arithmetic.  D == 0 (runtime d): the row accumulated
// in its own output row.
template <int D, int KG>
__device__ __forceinline__ void attraction_row(const AttArgs& p,
                                               long long r) {
  const long long i = p.lo + r;
  const int32_t* rec = p.edges + r * p.words;
  const float si = __ldg(p.scale + i);
  const float si2 = si * si;
  if constexpr (D > 0) {
    constexpr int L = KG > 0 ? KG : 1;
    constexpr int WORDS = (FIELDS * L + 3) / 4 * 4;
    const int kg = KG > 0 ? KG : p.kg;
    float own[D];
    load_row<D>(p.y, i, own);
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.0f;
    for (int l0 = 0; l0 < kg; l0 += L) {
      // the chunk's fields, field-major: e[f L + j] is field f of edge
      // l0 + j
      int32_t e[WORDS];
      if constexpr (KG > 0) {
#pragma unroll
        for (int v = 0; v < WORDS / 4; ++v) {
          const int4 t = __ldg(reinterpret_cast<const int4*>(rec) + v);
          e[4 * v] = t.x;
          e[4 * v + 1] = t.y;
          e[4 * v + 2] = t.z;
          e[4 * v + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int f = 0; f < FIELDS; ++f) e[f] = __ldg(rec + f * kg + l0);
      }
      float nb[L][D];
      float msk[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        load_row<D>(p.ysrc, e[j], nb[j]);
        msk[j] = p.mask ? __ldg(p.mask + (l0 + j) * p.rows + r) : 1.0f;
      }
#pragma unroll
      for (int j = 0; j < L; ++j) {
        float diff[D];
        float d2 = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          diff[c] = nb[j][c] - own[c];
          d2 += diff[c] * diff[c];
        }
        const float net = edge_net(
            d2, si, si2, __int_as_float(e[L + j]),
            __int_as_float(e[2 * L + j]), __int_as_float(e[3 * L + j]),
            __int_as_float(e[4 * L + j]), __int_as_float(e[5 * L + j]),
            p.mask, msk[j], p);
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] += diff[c] * net;
      }
    }
    float res[D];
#pragma unroll
    for (int c = 0; c < D; ++c) res[c] = own[c] + acc[c];
    store_row<D>(p.out, r, res);
  } else {
    const int kg = p.kg;
    const int dd = p.d;
    const float* yi = p.y + i * dd;
    float* o = p.out + r * dd;
    for (int c = 0; c < dd; ++c) o[c] = 0.0f;
    for (int l = 0; l < kg; ++l) {
      const float* yj = p.ysrc + static_cast<long long>(__ldg(rec + l)) * dd;
      float d2 = 0.0f;
      for (int c = 0; c < dd; ++c) {
        const float dc = __ldcg(yj + c) - __ldcg(yi + c);
        d2 += dc * dc;
      }
      const float net = edge_net(
          d2, si, si2, __int_as_float(__ldg(rec + kg + l)),
          __int_as_float(__ldg(rec + 2 * kg + l)),
          __int_as_float(__ldg(rec + 3 * kg + l)),
          __int_as_float(__ldg(rec + 4 * kg + l)),
          __int_as_float(__ldg(rec + 5 * kg + l)), p.mask,
          p.mask ? __ldg(p.mask + l * p.rows + r) : 1.0f, p);
      for (int c = 0; c < dd; ++c) {
        o[c] += (__ldcg(yj + c) - __ldcg(yi + c)) * net;
      }
    }
    for (int c = 0; c < dd; ++c) o[c] = __ldcg(yi + c) + o[c];
  }
}

// One kick's coefficient against a partner at squared distance d2
__device__ __forceinline__ float kick_coeff(float d2, float si, float si2,
                                            bool ok, const float* nw,
                                            float nw_q, const Shape& s) {
  const float d2s = d2 / si2;
  const float rep = 1.0f / fmaxf(d2s * d2s, REP_FLOOR);
  float coeff = fminf(s.gamma * common_coeff(d2s, si, s) * rep, 2.0f);
  if (nw) coeff *= nw_q;
  return (d2s > 0.0f && ok) ? coeff : 0.0f;
}

// The kicks of row lo + r.  D > 0: the row in registers, its n_neg kicks
// in chunks of NNEG (NNEG > 0: one chunk) or of one (NNEG == 0, runtime
// n_neg); a chunk's partner indices, then its partner rows, weights and
// the row's neighbour ids, all loaded before its first kick.  D == 0
// (runtime d): the row in its own output row.
template <int D, int NNEG>
__device__ __forceinline__ void kick_row(const KickArgs& p, long long r) {
  static_assert(NNEG <= 32, "one rejection bit a kick");
  const long long pos = p.lo + r;
  const float si = __ldg(p.scale + pos);
  const float si2 = si * si;
  if constexpr (D > 0) {
    constexpr int T = NNEG > 0 ? NNEG : 1;
    const int n_neg = NNEG > 0 ? NNEG : p.n_neg;
    float y0[D];
    load_row<D>(p.a, r, y0);
    float yi[D];
#pragma unroll
    for (int c = 0; c < D; ++c) yi[c] = p.parallel ? 0.0f : y0[c];
    long long shift = p.offset;
    for (int t0 = 0; t0 < n_neg; t0 += T) {
      // partner positions in 32 bits (ids are int32, so n <= 2^31) and
      // the rejections as one bit a kick: fewer registers at n_neg 20
      unsigned q[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (t0 + t > 0) {
          shift += p.stride;
          if (shift >= p.n) shift -= p.n;
        }
        q[t] = static_cast<unsigned>(pos + shift >= p.n ? pos + shift - p.n
                                                        : pos + shift);
      }
      float yq[T][D];
      float nw[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const bool inside = q[t] >= p.lo && q[t] < p.lo + p.rows;
        load_row<D>(inside ? p.a : p.y, inside ? q[t] - p.lo : q[t], yq[t]);
        nw[t] = p.neg_weight ? __ldg(p.neg_weight + q[t]) : 1.0f;
      }
      unsigned rejected = 0;
#pragma unroll
      for (int t = 0; t < T; ++t) rejected |= (q[t] == pos) << t;
      if (p.exclusion) {
        for (int l = 0; l < p.k; ++l) {
          const unsigned id = __ldg(p.idx_full + l * p.rows + r);
#pragma unroll
          for (int t = 0; t < T; ++t) rejected |= (id == q[t]) << t;
        }
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float d2 = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float dc = (p.parallel ? y0[c] : yi[c]) - yq[t][c];
          d2 += dc * dc;
        }
        const float coeff = kick_coeff(d2, si, si2, !((rejected >> t) & 1u),
                                       p.neg_weight, nw[t], p.s);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          if (p.parallel) {
            yi[c] += (y0[c] - yq[t][c]) * coeff;
          } else {
            yi[c] = yi[c] + (yi[c] - yq[t][c]) * coeff;
          }
        }
      }
    }
    // parallel: y0 + sum; flat (the whole array's sweep, formed as the
    // JAX package's flat path forms it): y0 + (yi - y0)
    float res[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float v = p.parallel ? y0[c] + yi[c] : yi[c];
      res[c] = p.flat ? y0[c] + (v - y0[c]) : v;
    }
    store_row<D>(p.out, r, res);
  } else {
    const int dd = p.d;
    const float* y0 = p.a + r * dd;  // the row after its attraction
    // the running position (sequential) or the kicks' sum (parallel),
    // kept in the row's output row (out never overlaps a)
    float* yi = p.out + r * dd;
    for (int c = 0; c < dd; ++c) yi[c] = p.parallel ? 0.0f : __ldcg(y0 + c);
    long long shift = p.offset;
    for (int t = 0; t < p.n_neg; ++t) {
      if (t > 0) {
        shift += p.stride;
        if (shift >= p.n) shift -= p.n;
      }
      const long long q = pos + shift >= p.n ? pos + shift - p.n
                                             : pos + shift;
      bool ok = q != pos;
      if (p.exclusion) {
        for (int l = 0; l < p.k; ++l) {
          ok = ok && static_cast<long long>(
                         __ldg(p.idx_full + l * p.rows + r)) != q;
        }
      }
      const float* yq = (q >= p.lo && q < p.lo + p.rows)
                            ? p.a + (q - p.lo) * dd
                            : p.y + q * dd;
      float d2 = 0.0f;
      for (int c = 0; c < dd; ++c) {
        const float dc =
            (p.parallel ? __ldcg(y0 + c) : yi[c]) - __ldcg(yq + c);
        d2 += dc * dc;
      }
      const float coeff = kick_coeff(
          d2, si, si2, ok, p.neg_weight,
          p.neg_weight ? __ldg(p.neg_weight + q) : 1.0f, p.s);
      for (int c = 0; c < dd; ++c) {
        if (p.parallel) {
          yi[c] += (__ldcg(y0 + c) - __ldcg(yq + c)) * coeff;
        } else {
          yi[c] = yi[c] + (yi[c] - __ldcg(yq + c)) * coeff;
        }
      }
    }
    for (int c = 0; c < dd; ++c) {
      const float a0 = __ldcg(y0 + c);
      const float v = p.parallel ? a0 + yi[c] : yi[c];
      yi[c] = p.flat ? a0 + (v - a0) : v;
    }
  }
}

template <int D, int KG>
__global__ void __launch_bounds__(THREADS) attraction_kernel(AttArgs p) {
  const long long r =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (r < p.rows) attraction_row<D, KG>(p, r);
}

template <int D, int NNEG>
__global__ void __launch_bounds__(THREADS) kick_kernel(KickArgs p) {
  const long long r =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (r < p.rows) kick_row<D, NNEG>(p, r);
}

// A run of whole-array sweeps (lo 0, rows n): rows dealt grid-stride,
// the attraction of every row into `a`, a grid barrier, the kicks of
// every row from `a` into y, a grid barrier before the next sweep.
template <int D, int KG, int NNEG>
__global__ void __launch_bounds__(SWEEP_THREADS) sweeps_kernel(Sweeps run) {
  cg::grid_group grid = cg::this_grid();
  const long long first =
      static_cast<long long>(blockIdx.x) * SWEEP_THREADS + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * SWEEP_THREADS;
  for (long long s = 0; s < run.plan.steps; ++s) {
    const float gamma = __ldg(run.plan.gammas + s);
    run.att.s.gamma = gamma;
    run.kick.s.gamma = gamma;
    run.att.edges =
        run.plan.edges + __ldg(run.plan.groups + s) * run.plan.group_stride;
    run.kick.offset = __ldg(run.plan.offsets + s);
    for (long long r = first; r < run.att.rows; r += step) {
      attraction_row<D, KG>(run.att, r);
    }
    grid.sync();
    for (long long r = first; r < run.kick.rows; r += step) {
      kick_row<D, NNEG>(run.kick, r);
    }
    if (s + 1 < run.plan.steps) grid.sync();
  }
}

inline unsigned blocks_for(long long rows) {
  return static_cast<unsigned>((rows + THREADS - 1) / THREADS);
}

inline Shape make_shape(float gamma, float b, float b_minus_1, float two_b) {
  Shape s;
  s.b = b;
  s.b_minus_1 = b_minus_1;
  s.two_b = two_b;
  s.gamma = gamma;
  return s;
}

template <int D, int KG>
int attraction_launch(const AttArgs& p, cudaStream_t st) {
  attraction_kernel<D, KG><<<blocks_for(p.rows), THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NNEG>
int kick_launch(const KickArgs& p, cudaStream_t st) {
  kick_kernel<D, NNEG><<<blocks_for(p.rows), THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The cooperative launch: as many co-resident blocks as the card holds,
// no more than the rows need; a grid the card refuses is an error
template <int D, int KG, int NNEG>
int sweeps_launch(Sweeps run, cudaStream_t st) {
  auto kernel = sweeps_kernel<D, KG, NNEG>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        SWEEP_THREADS, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long want = (run.att.rows + SWEEP_THREADS - 1) / SWEEP_THREADS;
  const long long most = static_cast<long long>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(want < most ? want : most);
  void* args[] = {&run};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(SWEEP_THREADS), args, 0,
                                    st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The instance of a shape: the runtime-bound instance of its d, but for
// the compile-time instances that beat it on the card by more than the
// spread between runs (tools/torch_sweep_variants.py, whose runtime
// variant drops their lines): the attraction at d 2, kg 3 (the paths' k
// 6 in two groups), and the persistent launch there at n_neg 5 and 10
// (n_sub 60 and 30).  The pair's kicks at n_neg 5 and the persistent
// launch at n_neg 20 ran slower compile-time (more registers).
int launch_attraction(const AttArgs& p, cudaStream_t st) {
  if (p.d == 2 && p.kg == 3) return attraction_launch<2, 3>(p, st);
  if (p.d == 2) return attraction_launch<2, 0>(p, st);
  if (p.d == 3) return attraction_launch<3, 0>(p, st);
  return attraction_launch<0, 0>(p, st);
}

int launch_kick(const KickArgs& p, cudaStream_t st) {
  if (p.d == 2) return kick_launch<2, 0>(p, st);
  if (p.d == 3) return kick_launch<3, 0>(p, st);
  return kick_launch<0, 0>(p, st);
}

int launch_sweeps(const Sweeps& run, cudaStream_t st) {
  const bool kg3 = run.att.d == 2 && run.att.kg == 3;
  const int n_neg = run.kick.n_neg;
  if (kg3 && n_neg == 5) return sweeps_launch<2, 3, 5>(run, st);
  if (kg3 && n_neg == 10) return sweeps_launch<2, 3, 10>(run, st);
  if (run.att.d == 2) return sweeps_launch<2, 0, 0>(run, st);
  if (run.att.d == 3) return sweeps_launch<3, 0, 0>(run, st);
  return sweeps_launch<0, 0, 0>(run, st);
}

AttArgs make_att(const void* y, const void* ysrc, const void* edges,
                 const void* scale, const void* mask, void* out,
                 long long rows, long long lo, int kg, int d, int words,
                 const Shape& s, float f_min, float inv_mask_p) {
  AttArgs p;
  p.y = static_cast<const float*>(y);
  p.ysrc = static_cast<const float*>(ysrc);
  p.edges = static_cast<const int32_t*>(edges);
  p.scale = static_cast<const float*>(scale);
  p.mask = static_cast<const float*>(mask);
  p.out = static_cast<float*>(out);
  p.rows = rows;
  p.lo = lo;
  p.kg = kg;
  p.d = d;
  p.words = words;
  p.s = s;
  p.f_min = f_min;
  p.inv_mask_p = inv_mask_p;
  return p;
}

KickArgs make_kick(const void* y, const void* a, const void* idx_full,
                   const void* scale, const void* neg_weight, void* out,
                   long long rows, long long lo, long long n, int k, int d,
                   long long offset, long long stride, int n_neg,
                   const Shape& s, int exclusion, int parallel, int flat) {
  KickArgs p;
  p.y = static_cast<const float*>(y);
  p.a = static_cast<const float*>(a);
  p.idx_full = static_cast<const int32_t*>(idx_full);
  p.scale = static_cast<const float*>(scale);
  p.neg_weight = static_cast<const float*>(neg_weight);
  p.out = static_cast<float*>(out);
  p.rows = rows;
  p.lo = lo;
  p.n = n;
  p.offset = offset;
  p.stride = stride;
  p.k = k;
  p.d = d;
  p.n_neg = n_neg;
  p.s = s;
  p.exclusion = exclusion;
  p.parallel = parallel;
  p.flat = flat;
  return p;
}

}  // namespace

// Attraction of the rows [lo, lo + rows): y, ysrc (n, d); edges (rows,
// words) int32 records of kg edges (16-byte aligned); scale (n,); mask
// (kg, rows) or null; out (rows, d), overlapping neither y nor ysrc.
extern "C" int dense_attraction_launch(
    const void* y, const void* ysrc, const void* edges, const void* scale,
    const void* mask, void* out, long long rows, long long lo, int kg, int d,
    int words, float gamma, float b, float b_minus_1, float two_b,
    float f_min, float inv_mask_p, void* stream) {
  return launch_attraction(
      make_att(y, ysrc, edges, scale, mask, out, rows, lo, kg, d, words,
               make_shape(gamma, b, b_minus_1, two_b), f_min, inv_mask_p),
      static_cast<cudaStream_t>(stream));
}

// Kicks of the rows [lo, lo + rows): y (n, d) the snapshot outside the
// block, a (rows, d) the block after its attraction, idx_full (k, rows),
// scale (n,), neg_weight (n,) or null; out (rows, d) may be y's rows
// [lo, lo + rows), never a.  offset in [0, n), stride max(1, n / n_neg).
extern "C" int dense_kick_launch(
    const void* y, const void* a, const void* idx_full, const void* scale,
    const void* neg_weight, void* out, long long rows, long long lo,
    long long n, int k, int d, long long offset, long long stride, int n_neg,
    float gamma, float b, float b_minus_1, float two_b, int exclusion,
    int parallel, int flat, void* stream) {
  return launch_kick(
      make_kick(y, a, idx_full, scale, neg_weight, out, rows, lo, n, k, d,
                offset, stride, n_neg, make_shape(gamma, b, b_minus_1, two_b),
                exclusion, parallel, flat),
      static_cast<cudaStream_t>(stream));
}

// `steps` whole-array sweeps in one cooperative launch: y (n, d) updated
// in place; ysrc (n, d) the neighbours' source (y itself, or a stale
// snapshot no sweep writes); a (n, d) scratch; edges (groups, n, words)
// records, group_stride = n * words; scale, neg_weight (n,), neg_weight
// may be null; idx_full (k, n); gammas (steps,) f32, offsets (steps,)
// int64 in [0, n), groups (steps,) int32, all on the card.
extern "C" int dense_sweeps_launch(
    void* y, const void* ysrc, void* a, const void* edges,
    long long group_stride, const void* scale, const void* neg_weight,
    const void* idx_full, const void* gammas, const void* offsets,
    const void* groups, long long steps, long long n, int kg, int k, int d,
    int words, long long stride, int n_neg, float b, float b_minus_1,
    float two_b, float f_min, int exclusion, int parallel, void* stream) {
  const Shape s = make_shape(0.0f, b, b_minus_1, two_b);
  Sweeps run;
  run.att = make_att(y, ysrc, edges, scale, nullptr, a, n, 0, kg, d, words,
                     s, f_min, 1.0f);
  run.kick = make_kick(y, a, idx_full, scale, neg_weight, y, n, 0, n, k, d,
                       0, stride, n_neg, s, exclusion, parallel, 1);
  run.plan.edges = static_cast<const int32_t*>(edges);
  run.plan.group_stride = group_stride;
  run.plan.gammas = static_cast<const float*>(gammas);
  run.plan.offsets = static_cast<const long long*>(offsets);
  run.plan.groups = static_cast<const int32_t*>(groups);
  run.plan.steps = steps;
  return launch_sweeps(run, static_cast<cudaStream_t>(stream));
}
