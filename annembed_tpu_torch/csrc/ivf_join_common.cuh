// Pieces of the IVF local join (DistL2, cell-sorted layout) shared by
// its two kernels, csrc/ivf_join.cu (SIMT, one query a thread) and
// csrc/ivf_join_tc.cu (the cross products on the tensor cores), and by
// their host builds (tools/ivf_join_host_check.py): the launch's
// arguments, the rounding of the operands, the exact f32 rerank with its
// stable sort, and the tensor-core route's operands, row windows,
// selection on accumulator fragments and merge of a quad's lists.
//
// Everything here is plain C++ on scalars and pointers, with no
// threadIdx: the kernels pass each thread's place in explicitly, so the
// host build runs the same code on fragments it computes from a plain
// product.
#pragma once

#include <cstdint>

// helpers the host-side launchers call too
#if defined(__CUDACC__)
#define IVFJ_HD __host__ __device__ __forceinline__
#else
#define IVFJ_HD inline
#endif

namespace ivfj {

struct JoinArgs {
  const float* xs;       // (n + 1, d): the corpus in cell order, a zero row
  const float* sqn;      // (n + 1,): |x|^2 of each row
  const int* qstarts;    // (V,): first sorted position of each virtual row
  const int* qparents;   // (V,): its cell
  const int* starts;     // (cells,): first sorted position of each cell
  const int* counts;     // (cells,): members of each cell
  const int* nbrs;       // (nlist, nprobe): probed cells, own cell first
  int* out_idx;          // (n, k)
  float* out_dist;       // (n, k)
  long long row0, row_step;  // this launch's virtual rows: row0 + b row_step
  int n, d, k, nprobe, qcap, cap, slices, bf16;
  // optional (the tensor-core route; null: not written): (n, k) ranked
  // values and ids of the selected entries in selection order, before
  // the rerank, for measuring the expansion's error
  float* rank_v;
  int* rank_i;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// round to the nearest bf16, ties to even (torch's .to(torch.bfloat16))
__device__ __forceinline__ float bf16_round(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return x;
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// round to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero, as cvt.rna.tf32.f32 does: the low 13 bits of the result are 0
__device__ __forceinline__ float tf32_round(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return x;
  return __uint_as_float((u + 0x1000u) & 0xffffe000u);
}

// The selected entries of query ``qpos`` (``v`` ranked values, ``id``
// sorted positions, entry i at [i stride], ascending by value, ties in
// slot order; inf with id n past the last candidate): each finite value
// replaced by the exact f32 distance sqrt(sum (q - c)^2), a stable
// insertion sort by it, and the row written to the outputs.  W
// candidates at a time, so their rows' loads overlap (the tensor-core
// route, one block an SM, takes 4; the SIMT route, whose blocks overlap
// each other, 1: more registers cost it blocks); each sum in column
// order whatever W.
template <int W>
__device__ __forceinline__ void rerank_write(const JoinArgs& a, int qpos,
                                             float* v, int* id, int stride) {
  const int k = a.k;
  const float* q = a.xs + static_cast<long long>(qpos) * a.d;
  for (int i0 = 0; i0 < k; i0 += W) {
    const float* c[W];
    bool live[W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int i = i0 + u;
      live[u] = i < k && v[i * stride] != inf_f();
      c[u] = a.xs + (live[u] ? static_cast<long long>(id[i * stride]) * a.d
                             : 0LL);
    }
    if (!live[0]) break;
    float s[W];
#pragma unroll
    for (int u = 0; u < W; ++u) s[u] = 0.0f;
    for (int j = 0; j < a.d; ++j) {
      const float qj = q[j];
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const float t = qj - c[u][j];
        s[u] += t * t;
      }
    }
#pragma unroll
    for (int u = 0; u < W; ++u) {
      if (live[u]) v[(i0 + u) * stride] = sqrtf(fmaxf(s[u], 0.0f));
    }
  }
  for (int i = 1; i < k; ++i) {
    const float x = v[i * stride];
    const int s = id[i * stride];
    int j = i;
    while (j > 0 && v[(j - 1) * stride] > x) {
      v[j * stride] = v[(j - 1) * stride];
      id[j * stride] = id[(j - 1) * stride];
      --j;
    }
    v[j * stride] = x;
    id[j * stride] = s;
  }
  const long long row = static_cast<long long>(qpos) * k;
  for (int i = 0; i < k; ++i) {
    a.out_idx[row + i] = id[i * stride];
    a.out_dist[row + i] = v[i * stride];
  }
}

// --- the tensor-core route ----------------------------------------------
//
// Operands.  Every row r of the corpus becomes a padded operand row B_r
// of DP columns, kept as DP / (8 or 4) planes of 16 bytes a row (plane p
// holds columns [8p, 8p + 8) in bf16, or [4p, 4p + 4) in TF32, of every
// row, so the rows [s, s + m) of one plane are one contiguous copy):
//   bf16: B_r = (-2 x_r in bf16, h, m, l, 0...) with h + m + l = |x_r|^2
//         exactly (three bf16 pieces of the f32 norm);
//   TF32: B_r = (-2 x_r, |x_r|^2, 0...), each value split into hi =
//         tf32(v) and lo = tf32(v - hi), a plane set for each.
// The query's row is A_q = (x_q in bf16, 1, 1, 1, 0...) or (x_q, 1,
// 0...), split alike.  So A_q . B_c = |c|^2 - 2 q.c, in bf16 exact
// products (x2 is exact) or in three TF32 products lo.hi + hi.lo +
// hi.hi, and the value the join ranks is e = |q|^2 + A_q . B_c.
constexpr int TC_BN = 64;        // candidates a tile (wgmma N)
constexpr int TC_STAGES = 8;     // tiles in flight
constexpr int TC_MAX_D = 29;     // d + 3 <= 32 (bf16), d + 1 <= 32 (TF32)
constexpr int TC_MAX_K = 24;     // the largest register list
constexpr int SLOT_NONE = 0x7fffffff;

// k-steps of the padded width: 16 columns each in bf16, 8 in TF32
IVFJ_HD int tc_ksteps(int d, int bf16) {
  if (bf16) return d + 3 <= 16 ? 1 : 2;
  return d + 1 <= 8 ? 1 : (d + 1 <= 16 ? 2 : 4);
}
// 16-byte planes of the operand copy (both TF32 sets)
IVFJ_HD int tc_planes(int d, int bf16) {
  return 2 * tc_ksteps(d, bf16) * (bf16 ? 1 : 2);
}

// column j of row r's operand B_r, bf16 (its bits) or one TF32 set
// (``lo`` 0: hi, 1: lo)
__device__ __forceinline__ uint16_t b_bf16(const JoinArgs& a, long long r,
                                           int j) {
  float v = 0.0f;
  if (j < a.d) {
    v = bf16_round(-2.0f * a.xs[r * a.d + j]);
  } else if (j < a.d + 3) {
    const float s = a.sqn[r];
    const float h = bf16_round(s);
    const float m = bf16_round(s - h);
    v = j == a.d ? h : (j == a.d + 1 ? m : bf16_round((s - h) - m));
  }
  return static_cast<uint16_t>(__float_as_uint(v) >> 16);
}
__device__ __forceinline__ float b_tf32(const JoinArgs& a, long long r, int j,
                                        int lo) {
  float v = 0.0f;
  if (j < a.d) v = -2.0f * a.xs[r * a.d + j];
  else if (j == a.d) v = a.sqn[r];
  const float hi = tf32_round(v);
  return lo ? tf32_round(v - hi) : hi;
}
// column j of query row q's operand A_q (zero for a row past the queries)
__device__ __forceinline__ uint16_t a_bf16(const JoinArgs& a, long long q,
                                           bool valid, int j) {
  float v = 0.0f;
  if (valid) {
    if (j < a.d) v = bf16_round(a.xs[q * a.d + j]);
    else if (j < a.d + 3) v = 1.0f;
  }
  return static_cast<uint16_t>(__float_as_uint(v) >> 16);
}
__device__ __forceinline__ float a_tf32(const JoinArgs& a, long long q,
                                        bool valid, int j, int lo) {
  float v = 0.0f;
  if (valid) {
    if (j < a.d) v = a.xs[q * a.d + j];
    else if (j == a.d) v = 1.0f;
  }
  const float hi = tf32_round(v);
  return lo ? tf32_round(v - hi) : hi;
}

// The candidate windows of a virtual row, laid end to end in probe order
// (a candidate's slot): window p is [start[p], start[p] + len[p]) of the
// sorted corpus at slots [off[p], off[p] + len[p]); off[nprobe] is the
// row's candidate count.
struct Windows {
  const int* start;
  const int* len;
  const int* off;
  int nprobe;

  // the slot of sorted position ``pos`` (the first window holding it), or
  // SLOT_NONE
  __device__ __forceinline__ int slot_of(int pos) const {
    for (int p = 0; p < nprobe; ++p) {
      if (start[p] <= pos && pos < start[p] + len[p]) {
        return off[p] + pos - start[p];
      }
    }
    return SLOT_NONE;
  }
  // the sorted position of slot s < off[nprobe]: the last window whose
  // offset is <= s (an empty window shares its offset with the next),
  // by bisection
  __device__ __forceinline__ int pos_of(int s) const {
    int lo = 0, hi = nprobe - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (off[mid] <= s) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    return start[lo] + s - off[lo];
  }
};

// One thread's list for one query row, in registers: a partial top-k
// over the columns the thread holds, KL slots (KL >= k compile-time, so
// every index is static), ascending; the first KL - k hold -inf and
// never move, so the k-th value is always v[KL - 1].  Ties stay in slot
// order: the thread meets its columns in slot order and inserts only
// strictly below its limit, after every equal value.
template <int KL>
struct RegList {
  float v[KL];
  int s[KL];

  __device__ __forceinline__ void init(int k) {
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      v[i] = i < KL - k ? -inf_f() : inf_f();
      s[i] = SLOT_NONE;
    }
  }
  // (x, slot) in, v[KL - 1] out: every slot at once, no memory
  __device__ __forceinline__ void insert(float x, int slot) {
#pragma unroll
    for (int i = KL - 1; i > 0; --i) {
      const bool up = v[i - 1] > x;
      const bool here = !up && v[i] > x;
      v[i] = up ? v[i - 1] : (here ? x : v[i]);
      s[i] = up ? s[i - 1] : (here ? slot : s[i]);
    }
    if (v[0] > x) {
      v[0] = x;
      s[0] = slot;
    }
  }
  // the list's ceil(k / 4)-th smallest real value
  __device__ __forceinline__ float quarter(int k) const {
    const int at = KL - k + (k + 3) / 4 - 1;
    float q = v[0];
#pragma unroll
    for (int i = 1; i < KL; ++i) q = i == at ? v[i] : q;
    return q;
  }
  // the k real entries to list[i stride], i < k
  __device__ __forceinline__ void store(float* lv, int* ls, int stride,
                                        int k) const {
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      if (i >= KL - k) {
        lv[(i - (KL - k)) * stride] = v[i];
        ls[(i - (KL - k)) * stride] = s[i];
      }
    }
  }
};

// One thread's running selection for one query row, all in registers:
// its list and the bounds that keep the hot loop off it.  A pair enters
// only strictly below both the list's k-th value and ``cap``, the quad's
// bound on the row's k-th value (``tighten``): the largest of the four
// threads' quarter() values, so k candidates of earlier tiles (lower
// slots) are at or below it, and a value at or above it cannot be among
// the row's k smallest.  ``bound`` is the d^2 above which a value cannot
// pass the limit w: e > w^2 (1 + 2^-20) + 1e-36 puts sqrt(e) above w
// whatever the rounding of w^2, and a correctly rounded sqrt keeps the
// order.  ``thr`` is the same bound on the accumulator: acc > (bound -
// |q|^2) + 2^-21 (bound + |q|^2) puts the f32 sum |q|^2 + acc above
// bound whatever the rounding of thr, so a pair above it is passed over
// on one compare.
template <int KL>
struct RowSel {
  RegList<KL> list;
  float qsq, cap, bound, thr, quarter;
  int self;
  bool valid;

  __device__ __forceinline__ void init(int k, bool is_valid, float q_sq,
                                       int self_slot) {
    list.init(k);
    qsq = q_sq;
    cap = inf_f();
    bound = inf_f();
    quarter = inf_f();
    self = self_slot;
    valid = is_valid;
    thr = valid ? inf_f() : -inf_f();
  }
  __device__ __forceinline__ void rebound() {
    const float w = fminf(list.v[KL - 1], cap);
    bound = w * w * 1.000001f + 1.0e-36f;
    thr = valid ? (bound - qsq) + 4.76837158e-7f * (bound + qsq) : -inf_f();
  }
  // the exact test of one pair that passed the filter, and its insertion
  __device__ __forceinline__ void consider(float acc, int slot) {
    const float e = qsq + acc;
    if (slot == self || e > bound) return;
    const float val = sqrtf(fmaxf(e, 0.0f));
    if (!(val < fminf(list.v[KL - 1], cap))) return;
    list.insert(val, slot);
    rebound();
  }
  // ``quad``: the largest of the quad's quarter() values
  __device__ __forceinline__ void tighten(float quad) {
    if (quad < cap) {
      cap = quad;
      rebound();
    }
  }
};

// One tile's accumulator fragment of one thread (wgmma m64nN, f32):
// acc[4 j + 2 h + e] is query row h (the thread's rows r and r + 8) and
// tile column 8 j + col0 + e, col0 = 2 (lane % 4).  Columns from ``lim``
// on are past the row's candidates (the last tile) and are not read.
// Per row: the minimum over its N / 4 values (a tree, four chains), one
// compare against thr; only when that passes, a mask of the columns that
// pass and one loop over them in slot order, so a warp runs the exact
// test and the insertion for all its passing threads together rather
// than column by column.  Then the thread's quarter() for the quad's cap.
template <int NJ, int KL>
__device__ __forceinline__ void filter_tile(const float (&acc)[4 * NJ],
                                            RowSel<KL> (&rs)[2], int slot0,
                                            int col0, int lim, int k) {
  static_assert(NJ % 4 == 0 && NJ <= 16, "columns a thread: 8 to 32");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m4[4] = {inf_f(), inf_f(), inf_f(), inf_f()};
    if (lim >= 8 * NJ) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        m4[j % 4] = fminf(m4[j % 4], fminf(acc[4 * j + 2 * h],
                                           acc[4 * j + 2 * h + 1]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * j + col0 + e < lim) {
            m4[j % 4] = fminf(m4[j % 4], acc[4 * j + 2 * h + e]);
          }
        }
      }
    }
    const float m = fminf(fminf(m4[0], m4[1]), fminf(m4[2], m4[3]));
    if (m <= rs[h].thr) {
      float vals[2 * NJ];
      uint32_t mask = 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[4 * j + 2 * h + e];
          vals[2 * j + e] = x;
          if (8 * j + col0 + e < lim && x <= rs[h].thr) {
            mask |= 1u << (2 * j + e);
          }
        }
      }
      while (mask != 0) {
        const int b = __ffs(static_cast<int>(mask)) - 1;
        mask &= mask - 1;
        const float x = vals[b];
        if (x <= rs[h].thr) {
          rs[h].consider(x, slot0 + 8 * (b >> 1) + col0 + (b & 1));
        }
      }
      rs[h].quarter = rs[h].list.quarter(k);
    }
  }
}

// The k smallest (value, slot) of a quad's four partial lists of one row
// (list t's entry i at v[t][i stride]), lexicographically: each list
// holds its thread's k smallest, so their union holds the row's.  Into
// out_v / out_id (stride 1) as values and sorted positions (n past the
// candidates), ready for rerank_write.
__device__ __forceinline__ void merge_quad(float* const (&v)[4],
                                           int* const (&s)[4], int stride,
                                           int k, const Windows& w, int n,
                                           float* out_v, int* out_id) {
  int h0 = 0, h1 = 0, h2 = 0, h3 = 0;
  for (int i = 0; i < k; ++i) {
    float bv = v[0][h0 * stride];
    int bs = s[0][h0 * stride], t = 0;
    float x = v[1][h1 * stride];
    int y = s[1][h1 * stride];
    if (x < bv || (x == bv && y < bs)) { bv = x; bs = y; t = 1; }
    x = v[2][h2 * stride];
    y = s[2][h2 * stride];
    if (x < bv || (x == bv && y < bs)) { bv = x; bs = y; t = 2; }
    x = v[3][h3 * stride];
    y = s[3][h3 * stride];
    if (x < bv || (x == bv && y < bs)) { bv = x; bs = y; t = 3; }
    h0 += t == 0;
    h1 += t == 1;
    h2 += t == 2;
    h3 += t == 3;
    out_v[i] = bv;
    out_id[i] = bs == SLOT_NONE ? n : w.pos_of(bs);
  }
}

// Shared memory of a tensor-core block of ``ncons`` consumer warpgroups:
// the tile ring (at the end the consumers' lists and merged rows in its
// place), the barriers, the window table, and each warpgroup's query
// operand (64 rows of every plane).
IVFJ_HD long long tc_ring_bytes(int d, int bf16, int ncons, int k) {
  const long long ring =
      static_cast<long long>(TC_STAGES) * tc_planes(d, bf16) * TC_BN * 16;
  // two lists of k (value, slot) a thread, then 64 merged rows of k a
  // warpgroup
  const long long lists = 2560LL * k * ncons;
  return ring > lists ? ring : lists;
}
IVFJ_HD long long tc_table_bytes(int nprobe) {
  return (4LL * (3 * nprobe + 1) + 15) / 16 * 16;
}
IVFJ_HD long long tc_smem_bytes(int d, int bf16, int ncons, int k,
                                int nprobe) {
  return tc_ring_bytes(d, bf16, ncons, k) + 16LL * TC_STAGES +
         tc_table_bytes(nprobe) + 1024LL * tc_planes(d, bf16) * ncons;
}

// shared memory a block may hold on an H100
constexpr long long TC_SMEM_LIMIT = 232448;

// bytes of the operand copy of an (n + 1, d) corpus
IVFJ_HD long long tc_operand_bytes(int n, int d, int bf16) {
  return 16LL * tc_planes(d, bf16) * (n + 1LL);
}

// the register list a k takes (0: none)
IVFJ_HD int tc_list_slots(int k) {
  if (k < 1 || k > TC_MAX_K) return 0;
  return k <= 12 ? 12 : 24;
}

// consumer warpgroups a block: three with 12-slot lists, two with 24
// (registers), fewer if shared memory does not hold them (0: none)
IVFJ_HD int tc_consumers(int d, int bf16, int k, int nprobe) {
  const int slots = tc_list_slots(k);
  if (slots == 0 || d < 1 || d > TC_MAX_D) return 0;
  for (int c = slots == 12 ? 3 : 2; c >= 1; --c) {
    if (tc_smem_bytes(d, bf16, c, k, nprobe) <= TC_SMEM_LIMIT) return c;
  }
  return 0;
}

// the largest k the route serves at (d, dtype, nprobe); 0 for a d it does
// not serve
IVFJ_HD int tc_max_k(int d, int bf16, int nprobe) {
  int k = 0;
  while (k < TC_MAX_K && tc_consumers(d, bf16, k + 1, nprobe) > 0) ++k;
  return k;
}

}  // namespace ivfj
