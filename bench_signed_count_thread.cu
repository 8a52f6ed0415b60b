// Kernel 6's other design, for bench_torch_variants.py --flat only: the
// signed counts of tuplewise_tpu_torch/csrc/signed_count.cu (same contract,
// same C entry point tw_signed_count) with kernel 7's search shape
// (csrc/tenant_count.cu) in place of the committed warp-cooperative one.
//
// One thread a (query, run) cell. Its first cut comes from the run's top,
// 2^kTopLevels - 1 splitters the block loads into shared memory in one
// round; below it each round loads kProbes splitters into the thread's
// registers at once (2^L - 1 for L halvings a round) and keeps the part
// that holds the bound. The lower bound (v < q) is searched first, and the
// upper bound (v <= q) searched again, past it, only where the value at the
// lower bound equals q: a tie costs a second chain. The block then adds
// each query's signed counts over its runs in shared memory: one writer an
// output, no atomics. The splitters and the NaN, -0.0 and +inf rules are
// those of the committed source. The bench replaces kThreads, kTopLevels
// and kProbes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxRuns = 8;
constexpr int kTopLevels = 8;  // the top: 2^kTopLevels - 1 splitters a run
constexpr int kProbes = 3;     // splitters a thread loads a round

constexpr int kTop = (1 << kTopLevels) - 1;
constexpr int kParts = kProbes + 1;  // parts a round cuts
constexpr int kCells = kThreads;     // (query, run) cells a block
static_assert(kCells >= kMaxRuns, "a block holds every run of a query");

// the runs of set 0 first, then those of set 1
struct Runs {
  const float* ptr[kMaxRuns];
  int len[kMaxRuns];
  int sign[kMaxRuns];
  int first[2];
  int count[2];
};

// splitter i (1 <= i < parts) of the window [lo, lo + n)
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

template <bool kShared>
__device__ __forceinline__ float probe(const float* p, int s) {
  return kShared ? p[s] : __ldg(p + s);
}

// rounds of kProbes splitters until the window is empty: the bound, and
// the value at it where it is below the window's end
template <bool kShared>
__device__ __forceinline__ int thread_rounds(const float* __restrict__ run,
                                             float q, bool upper, int lo,
                                             int n, float& at_hi) {
  while (n > 0) {  // one dependent round a pass
    float v[kProbes];
    int c = 0;
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      const int s = splitter(lo, n, p + 1, kParts);
      v[p] = s >= lo ? probe<kShared>(run, s) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < kProbes; ++p)
      c += splitter(lo, n, p + 1, kParts) < lo || before(v[p], q, upper);
#pragma unroll
    for (int p = 0; p < kProbes; ++p)
      if (p == c) at_hi = v[p];
    const int nlo = c == 0 ? lo : splitter(lo, n, c, kParts) + 1;
    const int nhi = c == kProbes ? lo + n : splitter(lo, n, c + 1, kParts);
    lo = nlo;
    n = nhi - nlo;
  }
  return lo;
}

// the first cut, from the run's top in shared memory, searched by the same
// rounds: the window [lo, lo + n) of the bound in a run of len values, and
// the value at its end where that is below len
__device__ __forceinline__ void top_cut(const float* top, int len, float q,
                                        int& lo, int& n, float& at_hi) {
  constexpr int parts = kTop + 1;
  const int virt = (int)(((long long)parts + len) / ((long long)len + 1)) - 1;
  const int c = thread_rounds<true>(top, q, false, virt, kTop - virt, at_hi);
  lo = c == 0 ? 0 : splitter(0, len, c, parts) + 1;
  const int hi = c == kTop ? len : splitter(0, len, c + 1, parts);
  if (c < kTop) at_hi = top[c];
  n = hi - lo;
}

// grid (column blocks of qpb queries, 2 query sets), kThreads threads
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

  const int slot = threadIdx.x;
  const int t = R > 0 ? slot / R : 0;
  const int r = R > 0 ? slot - t * R : 0;
  const bool live = R > 0 && t < qpb && q0 + t < len;
  const int n_run = live ? runs.len[r0 + r] : 0;
  const float* run = live ? runs.ptr[r0 + r] : nullptr;
  const float q = live ? qs[q0 + t] : 0.f;

  for (int p = threadIdx.x; p < R * kTop; p += kThreads) {
    const int rr = p / kTop, i = p - rr * kTop + 1;
    const int s = splitter(0, runs.len[r0 + rr], i, kTop + 1);
    if (s >= 0) top[rr][i - 1] = __ldg(runs.ptr[r0 + rr] + s);
  }
  __syncthreads();

  int lo, n;
  float at_hi = 0.f;
  top_cut(top[r], n_run, q, lo, n, at_hi);
  const int less = thread_rounds<false>(run, q, false, lo, n, at_hi);
  // the upper bound: the same unless the value at the lower bound is q
  int leq = less;
  if (less < n_run && at_hi == q)
    leq = thread_rounds<false>(run, q, true, less + 1, n_run - less - 1,
                               at_hi);
  if (live) {
    counts[0][slot] = less;
    counts[1][slot] = leq;
  }
  __syncthreads();

  for (int u = threadIdx.x; u < qpb; u += kThreads) {
    const int j = q0 + u;
    if (j >= qcols) break;
    int sless = 0, sleq = 0;
    if (j < len) {
      for (int k = 0; k < R; ++k) {
        sless += runs.sign[r0 + k] * counts[0][u * R + k];
        sleq += runs.sign[r0 + k] * counts[1][u * R + k];
      }
    }
    out[(2 * set) * qcols + j] = sless;
    out[(2 * set + 1) * qcols + j] = sleq;
  }
}

}  // namespace

extern "C" {

// as tw_signed_count of csrc/signed_count.cu
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
