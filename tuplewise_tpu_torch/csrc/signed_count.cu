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
// Design. The TPU kernel counted by broadcast comparison, because a binary
// search is the wrong shape for its vector unit; here a binary search per
// query is the natural shape. One thread per (query, query set): for each
// run of its set, a lower_bound and an upper_bound over the run. All runs
// of a call go to one launch, their pointers, lengths, signs and sets in a
// small struct passed by value. No atomics (each output element has one
// writer), no shared memory, and no padding of the queries: CUDA has no
// compile ladder, so the exact lengths are launched.
//
// Bound. A query reads about 2 log2(len) run elements, each load depending
// on the one before: the kernel is bound by the latency of those dependent
// loads (runs of a few MB sit in the 50 MB L2), not by bytes or operations,
// and at the index's sizes a launch costs less than its own launch latency.
//
// Exactness. Counts are integers, so the kernel equals its plain version
// (comparison counting) and the torch.searchsorted chain bit for bit. Every
// partial sum is bounded by the sum of the run lengths, which the wrapper
// checks to be below 2^31, so int32 is exact. The repository's certified
// envelope (tuplewise_tpu/analysis/exactness_bounds.toml) is max_runs * cap
// = 3 * 2^21 = 6291456 per count.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRuns = 8;

struct Runs {
  const float* ptr[kMaxRuns];
  long long len[kMaxRuns];
  int sign[kMaxRuns];
  int set[kMaxRuns];
  int k;
};

// #{v in run[0, n) : v < q} (lower) or #{v <= q} (upper), run sorted.
template <bool kUpper>
__device__ __forceinline__ long long bound(const float* __restrict__ run,
                                           long long n, float q) {
  long long lo = 0;
  while (n > 0) {
    const long long half = n >> 1;
    const float v = __ldg(run + lo + half);
    if (kUpper ? (v <= q) : (v < q)) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
signed_count_kernel(Runs runs, const float* __restrict__ qa, int la,
                    const float* __restrict__ qb, int lb,
                    int* __restrict__ out, int qcols) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int set = blockIdx.y;
  if (i >= qcols) return;
  const int len = set == 0 ? la : lb;
  int less = 0, leq = 0;
  if (i < len) {
    const float q = (set == 0 ? qa : qb)[i];
    for (int r = 0; r < runs.k; ++r) {
      if (runs.set[r] != set) continue;
      const int lo = (int)bound<false>(runs.ptr[r], runs.len[r], q);
      const int hi = (int)bound<true>(runs.ptr[r], runs.len[r], q);
      less += runs.sign[r] * lo;
      leq += runs.sign[r] * hi;
    }
  }
  out[(2 * set) * qcols + i] = less;
  out[(2 * set + 1) * qcols + i] = leq;
}

}  // namespace

extern "C" {

int tw_signed_count_max_runs() { return kMaxRuns; }

// Launches the signed-count kernel on `stream` and returns
// cudaGetLastError(). ptrs/lens/signs/sets: k host arrays describing the
// runs (device pointers to contiguous float32, their lengths, +1/-1, 0/1);
// qa [la], qb [lb] float32 and out [4, qcols] int32 on the device, qcols =
// max(la, lb) > 0. The wrapper checks every argument; k out of range
// returns cudaErrorInvalidValue.
int tw_signed_count(const unsigned long long* ptrs, const long long* lens,
                    const int* signs, const int* sets, int k, const void* qa,
                    int la, const void* qb, int lb, void* out, int qcols,
                    void* stream) {
  if (k < 0 || k > kMaxRuns || qcols <= 0) return (int)cudaErrorInvalidValue;
  Runs runs;
  runs.k = k;
  for (int r = 0; r < kMaxRuns; ++r) {
    const bool used = r < k;
    runs.ptr[r] = used ? reinterpret_cast<const float*>(ptrs[r]) : nullptr;
    runs.len[r] = used ? lens[r] : 0;
    runs.sign[r] = used ? signs[r] : 0;
    runs.set[r] = used ? sets[r] : -1;
  }
  const dim3 grid((unsigned)((qcols + kThreads - 1) / kThreads), 2);
  signed_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      runs, static_cast<const float*>(qa), la, static_cast<const float*>(qb),
      lb, static_cast<int*>(out), qcols);
  return (int)cudaGetLastError();
}

}  // extern "C"
