// Complete-U pair sums for score-difference kernels on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of tuplewise_tpu/ops/pallas_pairs.py:
//   * pallas_pair_sum        (body _pair_sum_kernel)         -> MASKED = false
//   * pallas_masked_pair_sum (body _masked_pair_sum_kernel)  -> MASKED = true
// and, with them, the any-size dispatcher pallas_pair_sum_any: bounds
// checks at the ragged edge take the place of its interior/edge split.
//
// What it computes, for each of W independent problems w (a batch axis:
// 1 for a complete statistic, N workers for a local round, reps x workers
// for the Monte-Carlo harness):
//     S_w = sum_{i < n1, j < n2} g(a[w,i] - b[w,j]) * ma[w,i] * mb[w,j]
// (the masks are absent when MASKED is false). g is the auc, hinge or
// logistic body; the unmasked auc sum is not built here: it runs the
// sort-and-count kernels of csrc/rank_count.cu.
//
// Design. The grid is (row tiles, column tiles, W). A block of 256 threads
// owns a row tile of kTileA = 2048 scores of `a`, 8 per thread in
// registers, loaded coalesced. It stages a column tile of kTileB = 2048
// scores of `b` (and its mask) in shared memory, then every thread sweeps
// the whole column tile: all threads read the same shared word at once
// (a broadcast, no bank conflicts) and evaluate 8 pairs per word, with 8
// independent float32 accumulators. Each block reduces its sum with warp
// shuffles and writes ONE float32 partial; the wrapper sums the partials
// in float64. No block depends on another, so blocks run in any order
// (the TPU kernel instead carried a Kahan cell across a sequential grid
// axis, which Hopper does not have).
//
// AUC exactness. AUC terms are multiples of 0.5, which float32 holds
// exactly below 2^23. A block covers kTileA * kTileB = 2^22 pairs, so
// every per-thread, per-warp and per-block float32 sum of the AUC body is
// exact, and the float64 sum of the partials is exact too: the kernel's
// AUC equals the integer rank AUC (ops/rank_auc.py) bit for bit.
//
// Bound. After the tile loads, a pair costs a subtraction, the body and
// an add (a multiply more when MASKED), all in registers, with no memory
// traffic: the kernel is bound by the FP32/ALU issue rate (and for the
// logistic body by the expf/log1pf sequence), not by bytes. It is built
// without fast-math, so expf and log1pf keep their full precision.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kTileA = kThreads * kRowsPerThread;
constexpr int kTileB = 2048;
static_assert((long long)kTileA * kTileB < (1LL << 23),
              "a block partial must cover fewer than 2^23 pairs");

struct AucBody {  // 1{d > 0} + 0.5 * 1{d == 0}
  __device__ __forceinline__ static float g(float d) {
    return d > 0.f ? 1.f : (d == 0.f ? 0.5f : 0.f);
  }
};

struct HingeBody {  // max(0, 1 - d)
  __device__ __forceinline__ static float g(float d) {
    return fmaxf(0.f, 1.f - d);
  }
};

struct LogisticBody {  // log(1 + e^{-d}), stable form
  __device__ __forceinline__ static float g(float d) {
    return fmaxf(-d, 0.f) + log1pf(expf(-fabsf(d)));
  }
};

template <class Body, bool MASKED>
__global__ void __launch_bounds__(kThreads)
pair_sum_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ ma, const float* __restrict__ mb,
                float* __restrict__ partials, int64_t n1, int64_t n2) {
  __shared__ float sb[kTileB];
  __shared__ float smb[MASKED ? kTileB : 1];
  __shared__ float swarp[kThreads / 32];

  const int64_t w = blockIdx.z;
  const int64_t row0 = (int64_t)blockIdx.x * kTileA;
  const int64_t col0 = (int64_t)blockIdx.y * kTileB;
  const int64_t rem = n2 - col0;
  const int ncols = rem < kTileB ? (int)rem : kTileB;
  const float* aw = a + w * n1;
  const float* bw = b + w * n2 + col0;

  for (int j = threadIdx.x; j < ncols; j += kThreads) {
    sb[j] = bw[j];
    if (MASKED) smb[j] = mb[w * n2 + col0 + j];
  }

  float av[kRowsPerThread];
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = row0 + k * kThreads + threadIdx.x;
    av[k] = r < n1 ? aw[r] : 0.f;  // rows past n1 are dropped below
    acc[k] = 0.f;
  }
  __syncthreads();

#pragma unroll 4
  for (int j = 0; j < ncols; ++j) {
    const float bj = sb[j];
    if (MASKED) {
      const float mj = smb[j];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k)
        acc[k] += Body::g(av[k] - bj) * mj;
    } else {
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) acc[k] += Body::g(av[k] - bj);
    }
  }

  float t = 0.f;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = row0 + k * kThreads + threadIdx.x;
    if (r < n1) t += MASKED ? acc[k] * ma[w * n1 + r] : acc[k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    t += __shfl_down_sync(0xffffffffu, t, off);
  if ((threadIdx.x & 31) == 0) swarp[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x < 32) {
    t = threadIdx.x < kThreads / 32 ? swarp[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_down_sync(0xffffffffu, t, off);
    if (threadIdx.x == 0)
      partials[(w * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = t;
  }
}

template <class Body>
void launch(bool masked, dim3 grid, cudaStream_t stream, const float* a,
            const float* b, const float* ma, const float* mb, float* out,
            int64_t n1, int64_t n2) {
  if (masked)
    pair_sum_kernel<Body, true>
        <<<grid, kThreads, 0, stream>>>(a, b, ma, mb, out, n1, n2);
  else
    pair_sum_kernel<Body, false>
        <<<grid, kThreads, 0, stream>>>(a, b, ma, mb, out, n1, n2);
}

}  // namespace

extern "C" {

int tw_pair_tile_a() { return kTileA; }
int tw_pair_tile_b() { return kTileB; }

// Launches one pair-sum kernel on `stream` and returns cudaGetLastError().
// a [W, n1], b [W, n2] (and ma, mb when masked) are contiguous float32 on
// the device; out holds W * ceil(n2/kTileB) * ceil(n1/kTileA) partials.
// body: 0 auc (masked only), 1 hinge, 2 logistic (ops/kernels.py). The
// wrapper checks every argument; an unknown body, or the unmasked auc body,
// returns cudaErrorInvalidValue.
int tw_pair_sum(const void* a, const void* b, const void* ma, const void* mb,
                void* out, long long n1, long long n2, int w, int body,
                int masked, void* stream) {
  const dim3 grid((unsigned)((n1 + kTileA - 1) / kTileA),
                  (unsigned)((n2 + kTileB - 1) / kTileB), (unsigned)w);
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto pma = static_cast<const float*>(ma);
  auto pmb = static_cast<const float*>(mb);
  auto fo = static_cast<float*>(out);
  switch (body) {
    case 0:  // the unmasked auc sum is tw_rank_auc (csrc/rank_count.cu)
      if (!masked) return (int)cudaErrorInvalidValue;
      pair_sum_kernel<AucBody, true>
          <<<grid, kThreads, 0, s>>>(fa, fb, pma, pmb, fo, n1, n2);
      break;
    case 1: launch<HingeBody>(masked, grid, s, fa, fb, pma, pmb, fo, n1, n2); break;
    case 2: launch<LogisticBody>(masked, grid, s, fa, fb, pma, pmb, fo, n1, n2); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
