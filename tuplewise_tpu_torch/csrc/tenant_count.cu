// Tenant-axis rank counts of the serving fleet on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tuplewise_tpu/ops/pallas_counts.py:
//   _tenant_kernel via _tenant_call, reached through
//   tenant_signed_count_local_fn.
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
// Design. The TPU kernel counted by broadcast comparison: every (tenant,
// query) against all cap values of its row. Here one thread per (tenant
// row, query column, side) runs a lower and an upper bound over its own
// sorted row, about 2 log2(cap) dependent loads. Each output element has
// one writer: no atomics, no shared memory, one launch a call. The two
// sides may have different row lengths.
//
// Exactness. Counts are integers, so the kernel equals its plain version
// (comparison counting) and the batched torch.searchsorted route bit for
// bit. A count is at most the row's length, which the wrapper checks to
// be below 2^31. The repository's certified envelope for this count
// (tuplewise_tpu/analysis/exactness_bounds.toml) is max_runs * cap =
// 6291456.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// #{v in row[0, n) : v < q} (lower) or #{v <= q} (upper), row sorted.
template <bool kUpper>
__device__ __forceinline__ long long bound(const float* __restrict__ row,
                                           long long n, float q) {
  long long lo = 0;
  while (n > 0) {
    const long long half = n >> 1;
    const float v = __ldg(row + lo + half);
    if (kUpper ? (v <= q) : (v < q)) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// grid.x covers the T * qb (tenant row, query column) cells, grid.y the
// side: 0 counts qn against neg, 1 counts qp against pos.
__global__ void __launch_bounds__(kThreads)
tenant_count_kernel(const float* __restrict__ neg, long long cap_n,
                    const float* __restrict__ pos, long long cap_p,
                    const float* __restrict__ qn,
                    const float* __restrict__ qp, long long cells, int qb,
                    int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= cells) return;
  const int side = blockIdx.y;
  const long long t = i / qb;
  const long long cap = side == 0 ? cap_n : cap_p;
  const float* row = (side == 0 ? neg : pos) + t * cap;
  const float q = (side == 0 ? qn : qp)[i];
  out[(2 * side) * cells + i] = (int)bound<false>(row, cap, q);
  out[(2 * side + 1) * cells + i] = (int)bound<true>(row, cap, q);
}

}  // namespace

extern "C" {

// Launches the tenant-count kernel on `stream` and returns
// cudaGetLastError(). neg [t_rows, cap_n], pos [t_rows, cap_p], qn and qp
// [t_rows, qb] float32 and out [4, t_rows, qb] int32, all contiguous on
// the device; t_rows * qb > 0. The wrapper checks every argument; a bad
// size returns cudaErrorInvalidValue.
int tw_tenant_count(const void* neg, long long cap_n, const void* pos,
                    long long cap_p, const void* qn, const void* qp,
                    int t_rows, int qb, void* out, void* stream) {
  const long long cells = (long long)t_rows * qb;
  if (t_rows <= 0 || qb <= 0 || cap_n < 0 || cap_p < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, 2);
  tenant_count_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(neg), cap_n, static_cast<const float*>(pos),
      cap_p, static_cast<const float*>(qn), static_cast<const float*>(qp),
      cells, qb, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
