// One sub-sweep of the dense CE optimizer, fused into two launches: the
// closed-form attraction of every row's kg edges of one column group,
// then every row's n_neg repulsion kicks.
//
// Replaces the sweep of annembed_tpu/optim/dense.py, which the JAX
// package runs as an XLA fusion of jnp code, with no Pallas kernel (its
// Mosaic build lacks a dynamic vector gather): _attraction_sweep_sfT
// (:272) and _repulsion_block_T (:406) with _neighbor_rejection and
// _repulsion_kick_T.  It computes what the port's optim/dense.py
// computes, in the same order of operations, for the rows [lo, lo + rows)
// of an (n, d) embedding:
//   * attraction (attraction_kernel): for each edge j = idx[l, r] of the
//     group, d2 = |y_j - y_i|^2, the clipped fractions alpha_f (from the
//     row's scale and w) and alpha_r (the neighbour's scale and w_rev),
//     the pair's remaining gap f = max(exp(m_eff log clamp(1 - 2 alpha_f)
//     + m_rev log clamp(1 - 2 alpha_r)), f_min) and y1_i = y_i +
//     sum_l (y_j - y_i) (w_rev > 0 ? 0.5 : 1) (1 - f);
//   * kicks (kick_kernel): kick t pairs position p with (p + offset +
//     t max(1, n / n_neg)) mod n of the post-attraction snapshot,
//     rejected when that partner is p itself or one of p's k neighbours;
//     coefficient min(gamma coeff / max(d2s^2, 1/16), 2), times the
//     partner's hubness weight; chained on the row's running position,
//     or (parallel kicks) all read from the snapshot and summed.
//
// What bounds it on an H100 SXM: bytes.  A sweep at the 11M Higgs large
// step (d 2, kg 3, k 6, n_neg 5, hubness weights) reads every input once
// in ~120 bytes a row (1.3 GB, 0.39 ms at 3.35 TB/s), and each row's
// reads of kg random neighbour rows and n_neg partner rows touch ~220
// bytes a row; the operations (a few hundred f32 ops and 2 kg + 1 logs
// and exps a row) are ~40x below the byte time.  The random neighbour
// reads are 8 of every 32-byte sector fetched, so latency, not the
// arithmetic, is what the design has to hide.
//
// Design (plain first; speed is later work):
//   * one thread per row, f32, precise expf / logf / powf, no atomics:
//     every output row is written by its own thread only, so two
//     launches on the same input are bit-equal;
//   * built with -fmad=false (ops/_build.py): every product and sum
//     rounds as the twin's separate torch ops round it.  The kicks'
//     map is expansive (a capped coefficient near the 1/16 pole scales
//     a difference in y by more than 3 a kick), so an FMA's one-ulp
//     difference in the attraction grows to ~1e-4 of max|y| over five
//     kicks at the Higgs large step's shape;
//   * coordinates row-major (n, d): a neighbour or partner read is one
//     row; edge tables (kg, rows) and (k, rows), so a warp's reads of
//     edge l coalesce; compile-time d = 2 and d = 3 keep the rows in
//     registers, any other d runs the same code on the output row;
//   * the kicks must see every row's attraction, so the sweep is two
//     launches: the attraction writes the block's rows to a buffer `a`,
//     the kicks read partners inside the block from `a` and outside it
//     from `y` (rows no launch writes), and write `out`, which may be
//     the block's own rows of `y`;
//   * partner windows are read with a modular index, so no
//     wraparound-extended copy of the snapshot is built.
//
// Launch contract: runs on the caller's stream, allocates nothing,
// returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
// 1 / PROBA_MIN (params.py): the attraction's pole floor
constexpr float REP_ATT_FLOOR = 1.0e4f;
// the kicks' pole floor
constexpr float REP_FLOOR = 1.0f / 16.0f;

struct Shape {
  float b, b_minus_1, two_b;  // the kernel exponent and its derived forms
  float gamma;
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

// D > 0: the row lives in registers; D == 0: runtime d, the row lives in
// the thread's own output row.
template <int D>
struct RowBuf {
  float v[D];
  __device__ __forceinline__ float& operator[](int c) { return v[c]; }
};
template <>
struct RowBuf<0> {
  float* v;
  __device__ __forceinline__ float& operator[](int c) { return v[c]; }
};

template <int D>
__global__ void __launch_bounds__(THREADS)
attraction_kernel(const float* __restrict__ y, const float* __restrict__ ysrc,
                  const int32_t* __restrict__ idx, const float* __restrict__ w,
                  const float* __restrict__ m,
                  const float* __restrict__ w_rev,
                  const float* __restrict__ m_rev,
                  const float* __restrict__ scale_j,
                  const float* __restrict__ scale,
                  const float* __restrict__ mask, float* __restrict__ out,
                  long long rows, long long lo, int kg, int d, Shape s,
                  float f_min, float inv_mask_p) {
  const long long r = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (r >= rows) return;
  const int dd = D > 0 ? D : d;
  const float* yi = y + (lo + r) * dd;
  float* o = out + r * dd;
  RowBuf<D> own, acc;
  if constexpr (D == 0) {
    own.v = nullptr;  // read from yi instead
    acc.v = o;
  }
#pragma unroll
  for (int c = 0; c < dd; ++c) {
    if constexpr (D > 0) own[c] = yi[c];
    acc[c] = 0.0f;
  }
  const float si = scale[lo + r];
  const float si2 = si * si;
  for (int l = 0; l < kg; ++l) {
    const long long e = l * rows + r;
    const float* yj = ysrc + static_cast<long long>(idx[e]) * dd;
    float diff[D > 0 ? D : 1];
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < dd; ++c) {
      const float dc = yj[c] - (D > 0 ? own[c] : yi[c]);
      if constexpr (D > 0) diff[c] = dc;
      d2 += dc * dc;
    }
    const float sj = scale_j[e];
    const float wr = w_rev[e];
    const float af = clipped_alpha(d2 / si2, si, w[e], s);
    const float ar = clipped_alpha(d2 / (sj * sj), sj, wr, s);
    const float m_eff = mask ? m[e] * mask[e] * inv_mask_p : m[e];
    const float f =
        fmaxf(expf(m_eff * log_gap(af) + m_rev[e] * log_gap(ar)), f_min);
    const float net = (wr > 0.0f ? 0.5f : 1.0f) * (1.0f - f);
#pragma unroll
    for (int c = 0; c < dd; ++c) {
      const float dc = D > 0 ? diff[c] : yj[c] - yi[c];
      acc[c] += dc * net;
    }
  }
#pragma unroll
  for (int c = 0; c < dd; ++c) o[c] = (D > 0 ? own[c] : yi[c]) + acc[c];
}

template <int D>
__global__ void __launch_bounds__(THREADS)
kick_kernel(const float* y, const float* __restrict__ a,
            const int32_t* __restrict__ idx_full,
            const float* __restrict__ scale,
            const float* __restrict__ neg_weight, float* out, long long rows,
            long long lo, long long n, int k, int d, long long offset,
            long long stride, int n_neg, Shape s, int exclusion,
            int parallel, int flat) {
  const long long r = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (r >= rows) return;
  const int dd = D > 0 ? D : d;
  const long long p = lo + r;
  const float* y0 = a + r * dd;       // the row after its attraction
  float* o = out + r * dd;
  // yi: the running position (sequential) or the kicks' sum (parallel)
  RowBuf<D> yi;
  if constexpr (D == 0) {
    yi.v = o;
  }
#pragma unroll
  for (int c = 0; c < dd; ++c) yi[c] = parallel ? 0.0f : y0[c];
  const float si = scale[p];
  const float si2 = si * si;
  long long shift = offset;
  for (int t = 0; t < n_neg; ++t) {
    if (t > 0) {
      shift += stride;
      if (shift >= n) shift -= n;
    }
    long long q = p + shift;
    if (q >= n) q -= n;
    bool ok = q != p;
    if (exclusion) {
      for (int l = 0; l < k; ++l) {
        ok = ok && static_cast<long long>(idx_full[l * rows + r]) != q;
      }
    }
    const float* yq = (q >= lo && q < lo + rows) ? a + (q - lo) * dd
                                                 : y + q * dd;
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < dd; ++c) {
      const float dc = (parallel ? y0[c] : yi[c]) - yq[c];
      d2 += dc * dc;
    }
    const float d2s = d2 / si2;
    const float rep = 1.0f / fmaxf(d2s * d2s, REP_FLOOR);
    float coeff = fminf(s.gamma * common_coeff(d2s, si, s) * rep, 2.0f);
    if (neg_weight) coeff *= neg_weight[q];
    if (!(d2s > 0.0f && ok)) coeff = 0.0f;
#pragma unroll
    for (int c = 0; c < dd; ++c) {
      if (parallel) {
        yi[c] += (y0[c] - yq[c]) * coeff;
      } else {
        yi[c] = yi[c] + (yi[c] - yq[c]) * coeff;
      }
    }
  }
  // parallel: y0 + sum; flat (the whole array's sweep, formed as the
  // JAX package's flat path forms it): y0 + (yi - y0)
#pragma unroll
  for (int c = 0; c < dd; ++c) {
    float v = parallel ? y0[c] + yi[c] : yi[c];
    o[c] = flat ? y0[c] + (v - y0[c]) : v;
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

}  // namespace

// Attraction of the rows [lo, lo + rows): y, ysrc (n, d); idx, w, m,
// w_rev, m_rev, scale_j, mask (kg, rows), mask may be null; scale (n,);
// out (rows, d), overlapping neither y nor ysrc.
extern "C" int dense_attraction_launch(
    const void* y, const void* ysrc, const void* idx, const void* w,
    const void* m, const void* w_rev, const void* m_rev, const void* scale_j,
    const void* scale, const void* mask, void* out, long long rows,
    long long lo, int kg, int d, float gamma, float b, float b_minus_1,
    float two_b, float f_min, float inv_mask_p, void* stream) {
  const Shape s = make_shape(gamma, b, b_minus_1, two_b);
  const auto st = static_cast<cudaStream_t>(stream);
#define ANNEMBED_ATTRACTION(D)                                               \
  attraction_kernel<D><<<blocks_for(rows), THREADS, 0, st>>>(               \
      static_cast<const float*>(y), static_cast<const float*>(ysrc),         \
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),        \
      static_cast<const float*>(m), static_cast<const float*>(w_rev),        \
      static_cast<const float*>(m_rev), static_cast<const float*>(scale_j),  \
      static_cast<const float*>(scale), static_cast<const float*>(mask),     \
      static_cast<float*>(out), rows, lo, kg, d, s, f_min, inv_mask_p)
  if (d == 2) {
    ANNEMBED_ATTRACTION(2);
  } else if (d == 3) {
    ANNEMBED_ATTRACTION(3);
  } else {
    ANNEMBED_ATTRACTION(0);
  }
#undef ANNEMBED_ATTRACTION
  return static_cast<int>(cudaGetLastError());
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
  const Shape s = make_shape(gamma, b, b_minus_1, two_b);
  const auto st = static_cast<cudaStream_t>(stream);
#define ANNEMBED_KICK(D)                                                     \
  kick_kernel<D><<<blocks_for(rows), THREADS, 0, st>>>(                     \
      static_cast<const float*>(y), static_cast<const float*>(a),            \
      static_cast<const int32_t*>(idx_full),                                 \
      static_cast<const float*>(scale),                                      \
      static_cast<const float*>(neg_weight), static_cast<float*>(out), rows, \
      lo, n, k, d, offset, stride, n_neg, s, exclusion, parallel, flat)
  if (d == 2) {
    ANNEMBED_KICK(2);
  } else if (d == 3) {
    ANNEMBED_KICK(3);
  } else {
    ANNEMBED_KICK(0);
  }
#undef ANNEMBED_KICK
  return static_cast<int>(cudaGetLastError());
}
