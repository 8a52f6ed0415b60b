// Tenant-axis rank counts of the serving fleet on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tuplewise_tpu/ops/pallas_counts.py:
//   _tenant_kernel via _tenant_call, reached through
//   tenant_signed_count_local_fn, and its mesh twin tenant_signed_count_fn
//   (the same body on every device's shard, then one psum).
//
// What it computes. Two packs of sorted float32 rows, one per class:
// neg [T, cap_n] and pos [T, cap_p], row t holding tenant slot t's sorted
// base run padded with +inf; and two query blocks qn, qp [T, qb], row t
// holding slot t's queries. The result is one int32 block [4, T, qb] with
// rows (less_n, leq_n, less_p, leq_p):
//     out[0][t][j] = #{v in neg[t] : v <  qn[t][j]}
//     out[1][t][j] = #{v in neg[t] : v <= qn[t][j]}
//     out[2][t][j] = #{v in pos[t] : v <  qp[t][j]}
//     out[3][t][j] = #{v in pos[t] : v <= qp[t][j]}
// For a finite query the +inf padding counts 0 in both rows, so an empty
// row counts 0 everywhere. This is the TPU kernel's function without its
// transposes: the TPU took the queries as [qb, T] and returned
// [4, qb, T] only to keep the pack rows on its lanes.
//
// The worker axis. The mesh form of the fleet keeps each tenant's run as S
// contiguous slices: the packs are [S, T, cap] (worker w's slice of tenant
// t in row [w, t]) and the query blocks, the same for every worker, stay
// [T, qb]. One launch counts every worker's rows (grid.z = 2 S: worker and
// side) and worker w writes its own block out[w] of [S, 4, T, qb]; the
// caller adds the blocks in worker order (comm.all_reduce_sum), the psum of
// the TPU kernel's mesh twin. A flat launch is the worker axis of one.
//
// Design. The TPU kernel counted by broadcast comparison: every (tenant,
// query) against all cap values of its row. Here each cell binary-searches
// its own sorted row. Nearly every cell of a fleet's block is padding (a
// 256-event apply fills a [1024, 256] block for about 100 tenants), so the
// bytes are few and the time is set by the chain of dependent loads and by
// the load instructions an SM keeps in flight. The search:
//   * Lower bound by fixed halvings: the window [base, base + n) that holds
//     the bound shrinks by h = n / 2, n -= h, whether the probe at base + h
//     moves base or not, so the sizes of every halving are known before any
//     load, the same for every cell of a row.
//   * The top in shared memory. The first kTopLevels halvings of a row
//     probe kTop = 2^kTopLevels - 1 positions whatever the query; a block,
//     which holds cells of one row, loads them in one round of independent
//     loads (31 sectors a row at kTopLevels = 5, near the paths that the
//     queries of a row take anyway) and every cell takes those halvings
//     from shared memory.
//   * Two halvings a round below the top. A round loads the probe of its
//     first halving and both candidates of its second (3 independent
//     loads), then takes both halvings in registers.
//   * One descent for both bounds. The last round loads row[base] and
//     row[base + 1]: the lower bound #{v < q} is base + (row[base] < q),
//     and the upper bound #{v <= q} is the same unless the value at the
//     lower bound equals q; only then does a plain halving of the rest of
//     the row find the end of the ties.
//   * Two cells a thread (kCells), two independent chains, so a launch
//     fills the card in one wave of blocks.
// At cap 2^17 a cell waits on 8 dependent rounds (the top, 6 rounds of two
// halvings, the last), where a lower and then an upper binary search took
// 2 x 18 dependent loads. Per-thread rounds of 3 or more halvings (7 or 15
// loads a round) and a top of 8 halvings (255 sectors a row) were slower:
// they add load instructions and bytes faster than they cut the chain
// (bench_torch_variants.py times such variants).
// Each output element has one writer: no atomics, one launch a call. The
// two sides may have different row lengths.
//
// Exactness. The counts are those of a binary search with the predicates
// v < q and v <= q: integers, equal to the plain version (comparison
// counting) and to the batched torch.searchsorted route bit for bit at
// every query that is not NaN. A NaN query satisfies neither predicate and
// counts 0 (torch.searchsorted sorts NaN last); -0.0 and +0.0 compare
// equal. A count is at most the row's length, which the wrapper checks to
// be below 2^31. The repository's certified envelope for this count
// (tuplewise_tpu/analysis/exactness_bounds.toml) is max_runs * cap =
// 6291456.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCells = 2;        // cells a thread: independent chains
constexpr int kTopLevels = 5;    // halvings a block reads from shared memory
constexpr int kTop = (1 << kTopLevels) - 1;
constexpr int kLevels = 2;       // halvings a round below the top
constexpr int kProbes = (1 << kLevels) - 1;

// The first halvings' probes are the same for every cell of a row: node c
// of level l (breadth first, the choices so far in c's bits, the first in
// the highest) probes base + the sizes chosen + h_l. off = that position.
template <int L>
__device__ __forceinline__ int tree_offset(const int (&h)[L], int l, int c) {
  int off = 0;
#pragma unroll
  for (int b = 0; b < L; ++b) {
    if (b < l && ((c >> (l - 1 - b)) & 1)) off += h[b];
    if (b == l) off += h[b];
  }
  return off;
}

// #{v <= q} in row[lo, cap) plus lo, by the plain halving (the rare path:
// a query equal to the value at its lower bound)
__device__ __forceinline__ int upper_bound(const float* __restrict__ row,
                                           int lo, int cap, float q) {
  int n = cap - lo;
  while (n > 0) {
    const int half = n >> 1;
    if (__ldg(row + lo + half) <= q) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// grid (column blocks of qb, T rows, 2 sides x workers), kThreads threads
// of kCells cells: cell (t, j) of side 0 of worker w counts qn[t][j]
// against neg[w][t], of side 1 qp[t][j] against pos[w][t], into out[w].
// kWorkers false: one worker, whose offsets fold away (the flat form's
// code, as fast as before the worker axis).
template <bool kWorkers>
__global__ void __launch_bounds__(kThreads)
tenant_count_kernel(const float* __restrict__ neg, int cap_n,
                    const float* __restrict__ pos, int cap_p,
                    const float* __restrict__ qn,
                    const float* __restrict__ qp, int qb,
                    int* __restrict__ out) {
  __shared__ float top[kTop];
  const int side = kWorkers ? (blockIdx.z & 1) : blockIdx.z;
  const long long worker = kWorkers ? (blockIdx.z >> 1) : 0;
  const long long cells = (long long)gridDim.y * qb;
  const int cap = side == 0 ? cap_n : cap_p;
  const float* row = (side == 0 ? neg : pos) +
                     (worker * gridDim.y + blockIdx.y) * cap;
  const float* qrow = (side == 0 ? qn : qp) + (long long)blockIdx.y * qb;
  int* less_out = out + (4 * worker + 2 * side) * cells +
                  (long long)blockIdx.y * qb;
  int* leq_out = less_out + cells;

  // the window [base, base + n) of the lower bound shrinks by halvings of
  // sizes h = n / 2, n -= h, whatever the data: the top's sizes
  int n = cap;
  int h[kTopLevels];
#pragma unroll
  for (int l = 0; l < kTopLevels; ++l) {
    h[l] = n >> 1;
    n -= h[l];
  }
  // the block loads the top's kTop probes at once: one round of loads
  for (int p = threadIdx.x; cap > 0 && p < kTop; p += kThreads) {
    const int l = 31 - __clz(p + 1);
    top[p] = __ldg(row + tree_offset(h, l, p + 1 - (1 << l)));
  }
  __syncthreads();

  float q[kCells];
  int base[kCells], c[kCells];
#pragma unroll
  for (int u = 0; u < kCells; ++u) {
    const int j = (blockIdx.x * kCells + u) * kThreads + threadIdx.x;
    q[u] = j < qb ? qrow[j] : 0.f;
    base[u] = 0;
    c[u] = 0;
  }
  if (cap > 0) {
#pragma unroll
    for (int l = 0; l < kTopLevels; ++l) {
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        const bool up = top[(1 << l) - 1 + c[u]] < q[u];
        base[u] = up ? base[u] + h[l] : base[u];
        c[u] = 2 * c[u] + (up ? 1 : 0);
      }
    }
  }
  // below the top: rounds of kLevels halvings, each round's probes (every
  // candidate of its halvings) loaded together
  while (n > 1) {  // one dependent round a pass
    int hr[kLevels];
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      hr[l] = n >> 1;
      n -= hr[l];
    }
#pragma unroll
    for (int u = 0; u < kCells; ++u) {
      float v[kProbes];
#pragma unroll
      for (int p = 0; p < kProbes; ++p) {
        const int l = 31 - __clz(p + 1);
        v[p] = __ldg(row + base[u] + tree_offset(hr, l, p + 1 - (1 << l)));
      }
      int cc = 0;
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        float x = v[(1 << l) - 1];
#pragma unroll
        for (int k = 1; k < (1 << l); ++k)
          if (cc == k) x = v[(1 << l) - 1 + k];
        const bool up = x < q[u];
        base[u] = up ? base[u] + hr[l] : base[u];
        cc = 2 * cc + (up ? 1 : 0);
      }
    }
  }
  // the last round: row[base] and row[base + 1]; the lower bound is base +
  // (row[base] < q), and #{v <= q} is the same unless the value at the
  // bound equals q
#pragma unroll
  for (int u = 0; u < kCells; ++u) {
    const int j = (blockIdx.x * kCells + u) * kThreads + threadIdx.x;
    if (j >= qb) continue;
    int less = 0, leq = 0;
    if (cap > 0) {
      const float v = __ldg(row + base[u]);
      const float w = base[u] + 1 < cap ? __ldg(row + base[u] + 1)
                                        : __int_as_float(0x7F800000);
      less = base[u] + (v < q[u] ? 1 : 0);
      const float at = v < q[u] ? w : v;
      leq = less < cap && at == q[u] ? upper_bound(row, less + 1, cap, q[u])
                                     : less;
    }
    less_out[j] = less;
    leq_out[j] = leq;
  }
}

}  // namespace

extern "C" {

// the halvings read from shared memory and a round below them
// (ops/count_kernels.py checks them against its own)
int tw_tenant_top_levels() { return kTopLevels; }
int tw_tenant_levels() { return kLevels; }

// Launches the tenant-count kernel on `stream` over `workers` slices of
// each pack and returns cudaGetLastError(). neg [workers, t_rows, cap_n],
// pos [workers, t_rows, cap_p], qn and qp [t_rows, qb] float32 and out
// [workers, 4, t_rows, qb] int32, all contiguous on the device; t_rows * qb
// > 0. The wrapper checks every argument; a bad size returns
// cudaErrorInvalidValue.
int tw_tenant_count_mesh(const void* neg, long long cap_n, const void* pos,
                         long long cap_p, const void* qn, const void* qp,
                         int t_rows, int qb, int workers, void* out,
                         void* stream) {
  if (t_rows <= 0 || t_rows > 65535 || qb <= 0 || cap_n < 0 || cap_p < 0 ||
      cap_n >= (1LL << 31) || cap_p >= (1LL << 31) || workers < 1 ||
      workers > 32767)
    return (int)cudaErrorInvalidValue;
  const int per_block = kThreads * kCells;
  const dim3 grid((unsigned)((qb + per_block - 1) / per_block),
                  (unsigned)t_rows, (unsigned)(2 * workers));
  auto kernel = workers == 1 ? tenant_count_kernel<false>
                             : tenant_count_kernel<true>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(neg), (int)cap_n,
      static_cast<const float*>(pos), (int)cap_p,
      static_cast<const float*>(qn), static_cast<const float*>(qp), qb,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// The flat form: one worker; neg [t_rows, cap_n], pos [t_rows, cap_p] and
// out [4, t_rows, qb]. The Python wrappers launch tw_tenant_count_mesh only;
// this entry keeps the C interface of earlier versions, which
// bench_torch_variants.py calls.
int tw_tenant_count(const void* neg, long long cap_n, const void* pos,
                    long long cap_p, const void* qn, const void* qp,
                    int t_rows, int qb, void* out, void* stream) {
  return tw_tenant_count_mesh(neg, cap_n, pos, cap_p, qn, qp, t_rows, qb, 1,
                              out, stream);
}

}  // extern "C"
