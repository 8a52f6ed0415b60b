// Fused signed rank counts of the serving index on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tuplewise_tpu/ops/pallas_counts.py:
//   _flat_kernel via _flat_call, reached through flat_signed_count_fn.
//
// What it computes. Up to kMaxRuns sorted float32 runs, run r with a sign
// s_r in {+1, -1} and a query-set assignment a_r in {0, 1}, and two query
// vectors qa [la] and qb [lb]. The result is one int32 block [4, qcols],
// qcols = max(la, lb), with rows (less_a, leq_a, less_b, leq_b):
//     out[2 a_r    ][i] += s_r * #{v in run_r : v <  q_{a_r}[i]}
//     out[2 a_r + 1][i] += s_r * #{v in run_r : v <= q_{a_r}[i]}
// and 0 in the columns past a query set's length. A run may carry +inf
// padding past its values (the bucket-padded placement of the index): for
// a finite query the padding counts 0 in both rows.
//
// Bound. A call counts a few hundred queries against runs of 2^17-2^19
// values (1-2 MB each, resident in the 50 MB L2): the bytes are a few
// hundred sectors and the operations a few thousand compares, so the time
// is set by the chain of dependent loads of one search and by how many
// searches the card runs side by side. A straight binary search per thread
// (the port's first form) waited on 2 x 19 loads one after another, about
// 190 ns each from L2, in 4 of 132 SMs.
//
// Design. The TPU kernel counted by broadcast comparison. Here each (query,
// run) cell is a search with a short chain:
//   * A k-ary search. A window [lo, lo + n) that holds the bound (the count
//     lies in [lo, lo + n]) is cut by splitters at lo + floor(i (n + 1) / P)
//     - 1, i = 1 .. P - 1, into P parts of near equal size. One round loads
//     every splitter at once (independent loads), and the splitters below
//     the bound, a prefix, pick the part that holds it: the window shrinks
//     by P a round. A splitter below lo (a part of a short window that is
//     empty) is virtual and counts as below the bound.
//   * Lanes side by side. A cell is a group of kLanes lanes for the lower
//     bound (v < q) and another for the upper bound (v <= q), each lane
//     loading one splitter (P = kLanes + 1); __ballot_sync counts the
//     splitters below the bound. A tie costs no second chain.
//   * The top in shared memory. A block holds cells of kCells / R queries
//     for each of the R runs of its query set; it first loads the top of
//     every run, kTop = 2^kTopLevels - 1 splitters at fixed positions, in
//     one round of independent loads (the cells' queries load beside it),
//     and every cell takes its first cut from shared memory, searching
//     those sorted splitters by the same rounds (two of 17 parts).
//   * The runs side by side. The R searches of a query are cells of one
//     block, so they run together; the block then adds each query's signed
//     counts over its runs in shared memory and writes them: one writer an
//     output, no atomics, one launch a call.
// At cap 2^19 a cell waits on 4 dependent rounds (the top, then 3 rounds
// of 17 parts), the lower and upper bounds together; a block of 8 warps
// searches 8 queries of one run, so 512 queries a set fill 128 blocks.
//
// Exactness. Counts are integers, so the kernel equals its plain version
// (comparison counting) and the torch.searchsorted chain bit for bit at
// every query that is not NaN. A NaN query is below no value and counts 0,
// as in the Pallas kernel (torch.searchsorted sorts NaN last); -0.0 and
// +0.0 compare equal. Every partial sum is bounded by the sum of the run
// lengths, which the wrapper checks to be below 2^31, so int32 is exact.
// The repository's certified envelope
// (tuplewise_tpu/analysis/exactness_bounds.toml) is max_runs * cap = 3 *
// 2^21 = 6291456 per count.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRuns = 8;
constexpr int kTopLevels = 8;  // the top: 2^kTopLevels - 1 splitters a run
constexpr int kLanes = 16;     // lanes a bound, one splitter each

constexpr int kTop = (1 << kTopLevels) - 1;
constexpr int kParts = kLanes + 1;             // parts a round cuts
constexpr int kCellLanes = 2 * kLanes;         // lanes a (query, run) cell
constexpr int kCells = kThreads / kCellLanes;  // (query, run) cells a block
static_assert(kCellLanes <= 32 && 32 % kCellLanes == 0,
              "a cell's two lane groups fit in one warp");
static_assert(kCells >= kMaxRuns, "a block holds every run of a query");

// the runs of set 0 first, then those of set 1
struct Runs {
  const float* ptr[kMaxRuns];
  int len[kMaxRuns];
  int sign[kMaxRuns];
  int first[2];
  int count[2];
};

// splitter i (1 <= i < parts) of the window [lo, lo + n): in 32-bit
// arithmetic while parts (n + 1) fits (every window below the top of a run
// of 2^23 values or fewer, and every one below the first cut), in 64-bit
// above
__device__ __forceinline__ int splitter(int lo, int n, int i, int parts) {
  const unsigned m = (unsigned)n + 1u;
  return lo - 1 +
         (m <= 0xFFFFFFFFu / (unsigned)parts
              ? (int)((unsigned)i * m / (unsigned)parts)
              : (int)((long long)i * (long long)m / parts));
}

// v lies before the bound: v < q (lower) or v <= q (upper)
__device__ __forceinline__ bool before(float v, float q, bool upper) {
  return upper ? v <= q : v < q;
}

// a probe of a run in device memory (read-only) or of a top in shared memory
template <bool kShared>
__device__ __forceinline__ float probe(const float* p, int s) {
  return kShared ? p[s] : __ldg(p + s);
}

// a lane group's rounds, one splitter a lane (g = 0 .. kLanes - 1), until
// every window of the warp is empty: the bound
template <bool kShared>
__device__ __forceinline__ int group_rounds(const float* __restrict__ run,
                                            float q, bool upper, int g,
                                            unsigned group_mask, int lo,
                                            int n) {
  while (__any_sync(0xffffffffu, n > 0)) {  // one dependent round a pass
    const int s = splitter(lo, n, g + 1, kParts);
    bool below = false;
    if (n > 0) below = s < lo || before(probe<kShared>(run, s), q, upper);
    const int c = __popc(__ballot_sync(0xffffffffu, below) & group_mask);
    if (n > 0) {
      const int nlo = c == 0 ? lo : splitter(lo, n, c, kParts) + 1;
      const int nhi = c == kLanes ? lo + n : splitter(lo, n, c + 1, kParts);
      lo = nlo;
      n = nhi - nlo;
    }
  }
  return lo;
}

// The first cut, from the run's top in shared memory: the window [lo, lo +
// n) of the bound in a run of len values. The cell searches the top's
// sorted splitters by the same rounds (in shared memory: no round of device
// loads), from past the virtual ones (all of them for an empty run).
__device__ __forceinline__ void top_cut(const float* top, int len, float q,
                                        bool upper, int g,
                                        unsigned group_mask, int& lo,
                                        int& n) {
  constexpr int parts = kTop + 1;
  const int virt = (int)(((long long)parts + len) / ((long long)len + 1)) - 1;
  const int c = group_rounds<true>(top, q, upper, g, group_mask, virt,
                                   kTop - virt);
  lo = c == 0 ? 0 : splitter(0, len, c, parts) + 1;
  const int hi = c == kTop ? len : splitter(0, len, c + 1, parts);
  n = hi - lo;
}

// grid (column blocks of qpb queries, 2 query sets), kThreads threads.
// Block (x, set) counts queries x qpb .. x qpb + qpb - 1 of its set against
// each of the set's R runs, qpb R <= kCells.
__global__ void __launch_bounds__(kThreads)
signed_count_kernel(Runs runs, const float* __restrict__ qa, int la,
                    const float* __restrict__ qb, int lb,
                    int* __restrict__ out, int qcols, int qpb) {
  __shared__ float top[kMaxRuns][kTop];
  __shared__ int counts[2][kCells];
  const int set = blockIdx.y;
  const int R = runs.count[set], r0 = runs.first[set];
  const int len = set == 0 ? la : lb;
  const float* qs = set == 0 ? qa : qb;
  const int q0 = blockIdx.x * qpb;

  // this thread's cell: query q0 + t against run r, slot t R + r; its
  // query is loaded beside the tops
  const int slot = threadIdx.x / kCellLanes;
  const int t = R > 0 ? slot / R : 0;
  const int r = R > 0 ? slot - t * R : 0;
  const bool live = R > 0 && t < qpb && q0 + t < len;
  const int n_run = live ? runs.len[r0 + r] : 0;
  const float* run = live ? runs.ptr[r0 + r] : nullptr;
  const float q = live ? qs[q0 + t] : 0.f;

  // every run's top: one round of independent loads
  for (int p = threadIdx.x; p < R * kTop; p += kThreads) {
    const int rr = p / kTop, i = p - rr * kTop + 1;
    const int s = splitter(0, runs.len[r0 + rr], i, kTop + 1);
    if (s >= 0) top[rr][i - 1] = __ldg(runs.ptr[r0 + rr] + s);
  }
  __syncthreads();

  // this lane's bound (upper: v <= q) and splitter in its cell
  const int lane = threadIdx.x % kCellLanes;
  const bool upper = lane >= kLanes;
  const int g = lane % kLanes;
  const unsigned group_mask = ((1u << kLanes) - 1u)
                              << ((threadIdx.x & 31) / kLanes * kLanes);
  int lo, n;
  top_cut(top[r], n_run, q, upper, g, group_mask, lo, n);
  const int bound = group_rounds<false>(run, q, upper, g, group_mask, lo, n);
  if (live && g == 0) counts[upper ? 1 : 0][slot] = bound;
  __syncthreads();

  // each query's signed counts over its runs
  for (int u = threadIdx.x; u < qpb; u += kThreads) {
    const int j = q0 + u;
    if (j >= qcols) break;
    int less = 0, leq = 0;
    if (j < len) {
      for (int k = 0; k < R; ++k) {
        less += runs.sign[r0 + k] * counts[0][u * R + k];
        leq += runs.sign[r0 + k] * counts[1][u * R + k];
      }
    }
    out[(2 * set) * qcols + j] = less;
    out[(2 * set + 1) * qcols + j] = leq;
  }
}

}  // namespace

extern "C" {

// the search's constants (ops/count_kernels.py checks them against its own)
int tw_signed_count_max_runs() { return kMaxRuns; }
int tw_signed_count_top_levels() { return kTopLevels; }
int tw_signed_count_lanes() { return kLanes; }

// Launches the signed-count kernel on `stream` and returns
// cudaGetLastError(). ptrs/lens/signs/sets: k host arrays describing the
// runs (device pointers to contiguous float32, their lengths, +1/-1, 0/1);
// qa [la], qb [lb] float32 and out [4, qcols] int32 on the device, qcols =
// max(la, lb) > 0. The wrapper checks every argument; k, a length or a set
// out of range returns cudaErrorInvalidValue.
int tw_signed_count(const unsigned long long* ptrs, const long long* lens,
                    const int* signs, const int* sets, int k, const void* qa,
                    int la, const void* qb, int lb, void* out, int qcols,
                    void* stream) {
  if (k < 0 || k > kMaxRuns || qcols <= 0) return (int)cudaErrorInvalidValue;
  Runs runs;
  int at = 0;
  for (int s = 0; s < 2; ++s) {
    runs.first[s] = at;
    for (int r = 0; r < k; ++r) {
      if (sets[r] != s) continue;
      if (lens[r] < 0 || lens[r] >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
      runs.ptr[at] = reinterpret_cast<const float*>(ptrs[r]);
      runs.len[at] = (int)lens[r];
      runs.sign[at] = signs[r];
      ++at;
    }
    runs.count[s] = at - runs.first[s];
  }
  if (at != k) return (int)cudaErrorInvalidValue;
  for (; at < kMaxRuns; ++at) {
    runs.ptr[at] = nullptr;
    runs.len[at] = 0;
    runs.sign[at] = 0;
  }
  const int most = runs.count[0] > runs.count[1] ? runs.count[0]
                                                 : runs.count[1];
  const int qpb = kCells / (most > 0 ? most : 1);
  const dim3 grid((unsigned)((qcols + qpb - 1) / qpb), 2);
  signed_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      runs, static_cast<const float*>(qa), la, static_cast<const float*>(qb),
      lb, static_cast<int*>(out), qcols, qpb);
  return (int)cudaGetLastError();
}

}  // extern "C"
