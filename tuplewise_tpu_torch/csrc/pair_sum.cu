// Complete-U pair sums of the logistic body on Hopper (sm_90a).
//
// Replaces, for the logistic body, the two Pallas TPU kernels of
// tuplewise_tpu/ops/pallas_pairs.py:
//   * pallas_pair_sum        (body _pair_sum_kernel)         -> MASKED = false
//   * pallas_masked_pair_sum (body _masked_pair_sum_kernel)  -> MASKED = true
// and, with them, the any-size dispatcher pallas_pair_sum_any: bounds
// checks at the ragged edge take the place of its interior/edge split.
//
// What it computes, for each of W independent problems w (a batch axis:
// 1 for a complete statistic, N workers for a local round, reps x workers
// for the Monte-Carlo harness):
//     S_w = sum_{i < n1, j < n2} g(a[w,i] - b[w,j]) * ma[w,i] * mb[w,j]
// (the masks are absent when MASKED is false), g the logistic body. The
// auc and hinge bodies, masked or not, are not built here: they run the
// sort-and-search kernels of csrc/rank_count.cu.
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
// Logistic body: g(d) = max(-d, 0) + log1p(e^{-|d|}). The full-precision
// expf and log1pf sequences cost about 40 instructions a pair, so the
// logistic kernel (logistic_sum_kernel) is built for the instruction
// issue rate instead:
//   * Factored exponential. With a centre c per block,
//         e^{-|a_i - b_j|} = min(e^{c - a_i} e^{b_j - c}, e^{a_i - c} e^{c - b_j}),
//     the smaller of two products of per-score exponentials (the other is
//     >= 1). A block forms e^{+-(a_i - c)} once for its 8 rows a thread, in
//     registers, and e^{+-(b_j - c)} once for its column tile, staged with
//     b_j (and its mask) in shared memory as one float4 a column: two
//     multiplies and a min a pair where expf was. The products must stay
//     normal floats: a block takes this branch only when its scores (the
//     row tile's and the column tile's, padding left out) are all finite
//     and span at most kLogisticSpan = 80, so |a - c|, |b - c| <= 40.5 and
//     both products lie in [e^-81, e^81]. c is 0 when every score lies in
//     [-40, 40] (then a - c is exact), else the midpoint rounded to an
//     integer. Any other block (a wider span, or an inf or NaN anywhere in
//     its tiles) takes the per-pair branch: x = expf(-|d|). The branch is a
//     per-block decision on the block's own data; both branches give the
//     body within float32 rounding, and the masked and unmasked kernels
//     share them. A caller may pass a counter of the blocks of each branch.
//   * log1p on [0, 1] in a few FMAs: log1p(x) = 2 atanh(s) with s = x / (2
//     + x) in [0, 1/3], taken as s * P(s^2), P of degree 4 (coefficients
//     kLog1p*, a fit of 2 atanh(sqrt z) / sqrt z on [0, 1/9] in relative
//     error, 4e-9 before rounding); the division is rcp.approx (one MUFU
//     reciprocal, within an ulp) and a multiply. In float32 the whole
//     log1p is within 4 units in 2^-24 of log1p(x) on [0, 1] with an exact
//     division, also for small x.
//   A pair is then a subtraction, two multiplies and a min, the log1p (an
//   add, the reciprocal, 3 multiplies, 4 FMAs), a max and an FMA, and the
//   accumulating add: 15.3 SASS instructions a pair in the factored loop,
//   where the expf/log1pf loop holds 41 (chip_smoke.py counts them). NaN and
//   infinities (the per-pair branch) give what max(-d, 0) + log1p(exp(-|d|))
//   gives in IEEE float32: NaN for a NaN difference, 0 for d = +inf, +inf
//   for d = -inf.
//
// Bound. After the tile loads, a pair costs a subtraction, the body and
// an add (a multiply more when MASKED), all in registers, with no memory
// traffic: the kernel is bound by the FP32/ALU issue rate, by its
// instruction count a pair, not by bytes. It is
// built without fast-math: expf keeps its full precision, and the
// subtractions keep gradual underflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kTileA = kThreads * kRowsPerThread;
constexpr int kTileB = 2048;

// the logistic kernel's constants (see the note; ops/pair_kernels.py
// checks them against the built library)
constexpr float kLogisticSpan = 80.f;
constexpr float kLog1p0 = 2.0f;
constexpr float kLog1p1 = 0.6666631698608398f;
constexpr float kLog1p2 = 0.4002491533756256f;
constexpr float kLog1p3 = 0.27960577607154846f;
constexpr float kLog1p4 = 0.2817831039428711f;

// log1p(x) for x in [0, 1] (NaN for NaN): s P(s^2), s = x / (2 + x), the
// division a one-ulp reciprocal (2 + x is a normal float, so flushing
// subnormals in the reciprocal changes nothing) and a multiply
__device__ __forceinline__ float log1p_unit(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(2.f + x));
  const float s = x * r;
  const float z = s * s;
  float p = fmaf(kLog1p4, z, kLog1p3);
  p = fmaf(p, z, kLog1p2);
  p = fmaf(p, z, kLog1p1);
  p = fmaf(p, z, kLog1p0);
  return s * p;
}

// The logistic body's kernel: the grid, tiles and reduction of the note,
// with the factored exponential or the per-pair expf chosen per block (see
// the note). branches, when not null, counts the blocks of each branch:
// [0] factored, [1] per-pair.
template <bool MASKED>
__global__ void __launch_bounds__(kThreads)
logistic_sum_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ ma, const float* __restrict__ mb,
                    float* __restrict__ partials, int64_t n1, int64_t n2,
                    unsigned long long* __restrict__ branches) {
  __shared__ float4 sbm[kTileB];  // (b, e^{b - c}, e^{c - b}, mask)
  __shared__ float smin[kThreads / 32], smax[kThreads / 32];
  __shared__ float swarp[kThreads / 32];

  const int64_t w = blockIdx.z;
  const int64_t row0 = (int64_t)blockIdx.x * kTileA;
  const int64_t col0 = (int64_t)blockIdx.y * kTileB;
  const int64_t rem = n2 - col0;
  const int ncols = rem < kTileB ? (int)rem : kTileB;
  const float* aw = a + w * n1;
  const float* bw = b + w * n2 + col0;
  const float kInf = __int_as_float(0x7F800000);

  // the block's scores: their range, and whether all are finite
  float lo = kInf, hi = -kInf;
  bool finite = true;
  for (int j = threadIdx.x; j < ncols; j += kThreads) {
    const float bj = bw[j];
    sbm[j] = make_float4(bj, 0.f, 0.f, MASKED ? mb[w * n2 + col0 + j] : 1.f);
    finite = finite && fabsf(bj) < kInf;
    lo = fminf(lo, bj);
    hi = fmaxf(hi, bj);
  }
  float av[kRowsPerThread];
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = row0 + k * kThreads + threadIdx.x;
    av[k] = r < n1 ? aw[r] : 0.f;  // rows past n1 are dropped below
    acc[k] = 0.f;
    if (r < n1) {
      finite = finite && fabsf(av[k]) < kInf;
      lo = fminf(lo, av[k]);
      hi = fmaxf(hi, av[k]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    smin[threadIdx.x >> 5] = lo;
    smax[threadIdx.x >> 5] = hi;
  }
  const bool all_finite = !__syncthreads_or(!finite);
#pragma unroll
  for (int v = 0; v < kThreads / 32; ++v) {
    lo = fminf(lo, smin[v]);
    hi = fmaxf(hi, smax[v]);
  }
  const bool factored = all_finite && hi - lo <= kLogisticSpan;
  if (branches != nullptr && threadIdx.x == 0)
    atomicAdd(&branches[factored ? 0 : 1], 1ull);

  if (factored) {
    const float c = fmaxf(fabsf(lo), fabsf(hi)) <= 0.5f * kLogisticSpan
                        ? 0.f : rintf(0.5f * (lo + hi));
    // this thread's own columns: no other thread reads them before the
    // barrier below
    for (int j = threadIdx.x; j < ncols; j += kThreads) {
      const float bc = sbm[j].x - c;
      sbm[j].y = expf(bc);
      sbm[j].z = expf(-bc);
    }
    float up[kRowsPerThread], dn[kRowsPerThread];  // e^{a - c}, e^{c - a}
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      up[k] = expf(av[k] - c);
      dn[k] = expf(c - av[k]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < ncols; ++j) {
      const float4 t = sbm[j];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const float d = av[k] - t.x;
        const float x = fminf(dn[k] * t.y, up[k] * t.z);
        const float g = fmaxf(-d, 0.f) + log1p_unit(x);
        acc[k] += MASKED ? g * t.w : g;
      }
    }
  } else {
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < ncols; ++j) {
      const float4 t = sbm[j];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const float d = av[k] - t.x;
        const float g = fmaxf(-d, 0.f) + log1p_unit(expf(-fabsf(d)));
        acc[k] += MASKED ? g * t.w : g;
      }
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

}  // namespace

extern "C" {

int tw_pair_tile_a() { return kTileA; }
int tw_pair_tile_b() { return kTileB; }
float tw_pair_logistic_span() { return kLogisticSpan; }
// the log1p coefficients kLog1p0..kLog1p4 (any other i: 0)
float tw_pair_log1p_coef(int i) {
  const float c[5] = {kLog1p0, kLog1p1, kLog1p2, kLog1p3, kLog1p4};
  return i >= 0 && i < 5 ? c[i] : 0.f;
}

// Launches the logistic pair-sum kernel on `stream` and returns
// cudaGetLastError(). a [W, n1], b [W, n2] (and ma, mb when masked) are
// contiguous float32 on the device; out holds W * ceil(n2/kTileB) *
// ceil(n1/kTileA) partials. body: 2 logistic (ops/kernels.py); the auc
// (0) and hinge (1) bodies, masked or not, run csrc/rank_count.cu, and
// they or an unknown body return cudaErrorInvalidValue.
// branches: null, or 2 uint64 on the device to which the kernel adds its
// blocks of each branch (factored, per-pair). The wrapper checks every
// argument.
int tw_pair_sum(const void* a, const void* b, const void* ma, const void* mb,
                void* out, long long n1, long long n2, int w, int body,
                int masked, void* branches, void* stream) {
  if (body != 2) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n1 + kTileA - 1) / kTileA),
                  (unsigned)((n2 + kTileB - 1) / kTileB), (unsigned)w);
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto pma = static_cast<const float*>(ma);
  auto pmb = static_cast<const float*>(mb);
  auto fo = static_cast<float*>(out);
  auto nb = static_cast<unsigned long long*>(branches);
  if (masked)
    logistic_sum_kernel<true>
        <<<grid, kThreads, 0, s>>>(fa, fb, pma, pmb, fo, n1, n2, nb);
  else
    logistic_sum_kernel<false>
        <<<grid, kThreads, 0, s>>>(fa, fb, pma, pmb, fo, n1, n2, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
