// Per-anchor distance-difference sums of the degree-3 (triplet) statistics
// on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tuplewise_tpu/ops/pallas_triplets.py:
//   _batched_masked_pair_sum (body _batched_pair_sum_kernel), driven by
//   pallas_triplet_stats, for the hinge combine. The indicator combine runs
//   the sort-and-count kernel of csrc/rank_count.cu.
//
// What it computes. The built-in triplet kernels depend on the three points
// only through t = d(a,p) - d(a,n) (squared euclidean distances), so the
// caller forms, per anchor, the row A[w,.] of its distances to the P
// positives and the row B[w,.] of its distances to the K negatives (anchor-
// major, [W, P] and [W, K]), and this kernel reduces, for each of W
// problems w:
//     S_w = sum_{j < P, k < K} g(A[w,j] - B[w,k])
//                              * mp[q,j] * 1{ip[q,j] != ia[w]} * mk[q,k]
// Problems come in groups of C that share their positives and negatives
// (q = w / C): one group for a complete statistic (C = W anchors), one per
// worker for a local round (C = the worker's anchors). g is the hinge
// max(0, margin + t).
//
// Design. The grid is (W, row tiles of P, column tiles of K). A block of 256
// threads holds kTileP = 2048 positive distances of its anchor, 8 per thread
// in registers, and stages kTileK = 2048 negative distances with their mask
// in shared memory (interleaved, one 8-byte broadcast read a column). Every
// thread sweeps the column tile with 8 independent float32 accumulators.
// The positive weight mp * 1{ip != ia} is formed in the kernel from the ids,
// once per row after the sweep: no [P, C] mask matrix (the TPU kernel read
// one, with anchors in lanes). Each block writes ONE float32 partial; the
// wrapper sums the partials of a problem in float64, in a fixed order. No
// block depends on another, no atomics (the TPU kernel carried a Kahan cell
// across its sequential grid).
//
// Bound. After the tile loads a triplet costs a subtraction, the body (an
// add and a max) and a multiply-add by the negative mask, all in registers:
// the kernel is bound by FP32 issue, not by bytes (it reads each distance
// once per row or column tile).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kTileP = kThreads * kRowsPerThread;
constexpr int kTileK = 2048;
struct HingeBody {  // max(0, margin + t)
  __device__ __forceinline__ static float g(float t, float margin) {
    return fmaxf(0.f, margin + t);
  }
};

template <class Body>
__global__ void __launch_bounds__(kThreads)
triplet_sum_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ mp,
                   const int64_t* __restrict__ ip,
                   const int64_t* __restrict__ ia,
                   const float* __restrict__ mk, float* __restrict__ partials,
                   int64_t P, int64_t K, int64_t C, float margin) {
  __shared__ float2 sbm[kTileK];  // (negative distance, its mask)
  __shared__ float swarp[kThreads / 32];

  const int64_t w = blockIdx.x;
  const int64_t q = w / C;
  const int64_t row0 = (int64_t)blockIdx.y * kTileP;
  const int64_t col0 = (int64_t)blockIdx.z * kTileK;
  const int64_t rem = K - col0;
  const int ncols = rem < kTileK ? (int)rem : kTileK;
  const float* bw = B + w * K + col0;
  const float* mkq = mk + q * K + col0;
  for (int k = threadIdx.x; k < ncols; k += kThreads)
    sbm[k] = make_float2(bw[k], mkq[k]);

  const float* aw = A + w * P;
  float av[kRowsPerThread];
  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t j = row0 + r * kThreads + threadIdx.x;
    av[r] = j < P ? aw[j] : 0.f;  // rows past P get weight 0 below
    acc[r] = 0.f;
  }
  __syncthreads();

#pragma unroll 4
  for (int k = 0; k < ncols; ++k) {
    const float2 bm = sbm[k];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      acc[r] += Body::g(av[r] - bm.x, margin) * bm.y;
  }

  const int64_t id = ia[w];
  const float* mpq = mp + q * P;
  const int64_t* ipq = ip + q * P;
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t j = row0 + r * kThreads + threadIdx.x;
    if (j < P && ipq[j] != id) t += acc[r] * mpq[j];
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
      partials[(w * gridDim.y + blockIdx.y) * gridDim.z + blockIdx.z] = t;
  }
}

}  // namespace

extern "C" {

int tw_triplet_tile_p() { return kTileP; }
int tw_triplet_tile_k() { return kTileK; }

// Launches the triplet-sum kernel on `stream` and returns
// cudaGetLastError(). A [W, P], B [W, K] float32; mp [W/C, P] float32,
// ip [W/C, P] int64, ia [W] int64, mk [W/C, K] float32; all contiguous on
// the device. out holds W * ceil(P/kTileP) * ceil(K/kTileK) partials.
// body: 1 hinge (ops/kernels.py; the indicator, 0, is tw_rank_indicator in
// csrc/rank_count.cu). The wrapper checks every argument; any other body
// returns cudaErrorInvalidValue.
int tw_triplet_sum(const void* A, const void* B, const void* mp,
                   const void* ip, const void* ia, const void* mk, void* out,
                   long long P, long long K, long long W, long long C,
                   int body, float margin, void* stream) {
  const dim3 grid((unsigned)W, (unsigned)((P + kTileP - 1) / kTileP),
                  (unsigned)((K + kTileK - 1) / kTileK));
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(A);
  auto fb = static_cast<const float*>(B);
  auto fmp = static_cast<const float*>(mp);
  auto iip = static_cast<const int64_t*>(ip);
  auto iia = static_cast<const int64_t*>(ia);
  auto fmk = static_cast<const float*>(mk);
  auto fo = static_cast<float*>(out);
  if (body != 1) return (int)cudaErrorInvalidValue;
  triplet_sum_kernel<HingeBody><<<grid, kThreads, 0, s>>>(
      fa, fb, fmp, iip, iia, fmk, fo, P, K, C, margin);
  return (int)cudaGetLastError();
}

}  // extern "C"
