// Pairwise-loss gradient sums for score-difference kernels on Hopper (sm_90a).
//
// Replaces the two gradient Pallas TPU kernels of
// tuplewise_tpu/ops/pallas_pairs.py:
//   * pallas_pair_loss_grad (body _fused_loss_grad_kernel) -> WITH_LOSS = true
//   * pallas_pair_grad_sums (body _pair_grad_kernel)       -> WITH_LOSS = false
//
// What it computes, for each of W independent problems w (a batch axis:
// the N workers of a training step, or seeds x workers of the simulated
// learner), with d_ij = a[w,i] - b[w,j]:
//     row[w,i] = sum_j g'(d_ij)      col[w,j] = sum_i g'(d_ij)
//     loss[w]  = sum_ij g(d_ij)      (WITH_LOSS only)
// g is the hinge or logistic body. Row and col come out as float32, the
// loss as float64. Both variants evaluate g' and reduce row and col in
// the same code and the same order, so their row and col are bit-identical:
// a recorded training step and a loss-free one take the same gradient.
//
// Bound. After the tile loads, a pair costs a subtraction, the g' body and
// two adds (row and col), plus the g body and an add WITH_LOSS, all in
// registers: the kernel is bound by the FP32/ALU instruction rate (for the
// logistic body by the expf / division / log1pf sequences), not by bytes.
// It is built without fast-math, so those keep their full precision.
//
// Design. The TPU kernels keep the whole col vector resident in VMEM across
// a SEQUENTIAL grid; Hopper blocks run in no order, so here every reduction
// that crosses blocks goes through float32 (float64 for the loss) partials
// in scratch and a second kernel sums them in a fixed order. There are no
// atomics, so two runs of the same step give the same bits.
//   * Grid (row tiles gx, column segments gs, W). A block of 256 threads
//     owns a row tile of kTileA = 2048 scores of `a`, 8 per thread in
//     registers, and sweeps the column tiles of its segment (a loop inside
//     the block takes the place of the TPU's sequential column axis). The
//     wrapper picks gs so that the grid holds enough blocks to fill the
//     card; gs = 1 when W alone does.
//   * Per column tile of kTileB = 1024 scores staged in shared memory, all
//     threads read the same word at once (a broadcast). A thread takes the
//     tile in chunks of 32 columns: 8 rows x 32 columns = 256 pairs, with
//     the row sums in 8 registers and the column sums of the chunk in 32.
//     A warp then reduce-scatters the 32 column sums over its 32 lanes
//     (31 shuffles: 16 + 8 + 4 + 2 + 1), so lane l holds the warp's sum of
//     column l; the 8 warps' sums meet in shared memory and the block
//     writes ONE float32 partial per column: colpart[w, bx, j].
//   * Row sums: each thread folds its per-tile row sums (at most kTileB
//     terms each) into a second register, then writes one float32 partial
//     per row and segment: rowpart[w, seg, i].
//   * Loss: per-row float32 sums of at most kTileB terms, folded per tile
//     into a float64 per thread, reduced over the block in float64 and
//     written as one float64 partial per block. That is finer than
//     pair_sum.cu, whose float32 partials cover 2^22 pairs.
//   * reduce_kernel sums rowpart over segments, colpart over row tiles and
//     the loss partials, each in a fixed order.
// Scratch: W * (gs * n1 + gx * n2) float32 + W * gs * gx float64. At the
// trainer's headline (W = 1, n1 = n2 = 5e5) that is about 0.5 GB, nearly
// all of it the column partials (gx = 245 row tiles).
//
// Ragged edges. Rows past n1 hold +inf and columns past n2 hold -inf, so
// their d is +inf, where both bodies give g = 0 and g' = 0 (exactly, -0.0
// for the logistic g'); padded rows and columns are never written out.
// This holds for finite inputs, which scores of finite parameters are.
//
// Hinge exactness. Every hinge g' is 0 or -1, so every partial and every
// sum is an integer below 2^24 (for n1, n2 < 2^24), which float32 holds
// exactly: row and col equal the plain version's at any size and in any
// summation order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kTileA = kThreads * kRowsPerThread;
constexpr int kTileB = 1024;
constexpr int kChunk = 32;
static_assert(kTileB % kChunk == 0, "a column tile is whole chunks");

struct HingeBody {
  // g = max(0, 1 - d); g' = -1{d < 1}, 0 at the kink
  __device__ __forceinline__ static float g(float d) {
    return fmaxf(0.f, 1.f - d);
  }
  __device__ __forceinline__ static float gp(float d) {
    return d < 1.f ? -1.f : 0.f;
  }
};

struct LogisticBody {
  // g = log(1 + e^{-d}) (stable form); g' = -1 / (1 + e^{d}), which is
  // -0 where expf(d) overflows to inf
  __device__ __forceinline__ static float g(float d) {
    return fmaxf(-d, 0.f) + log1pf(expf(-fabsf(d)));
  }
  __device__ __forceinline__ static float gp(float d) {
    return -1.f / (1.f + expf(d));
  }
};

// One level of the warp's reduce-scatter: lanes that differ in bit s swap
// halves of v[0, 2s) and add, so v[0, s) holds sums over both lanes. The
// level is a template so that every loop has a constant trip count and
// unrolls, which keeps v in registers (a runtime-stepped level loop left it
// in local memory).
template <int s>
__device__ __forceinline__ void reduce_level(float (&v)[kChunk], int lane) {
  const bool upper = (lane & s) != 0;
#pragma unroll
  for (int i = 0; i < s; ++i) {
    const float send = upper ? v[i] : v[i + s];
    const float keep = upper ? v[i + s] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
  }
}

// Lane l of the warp returns the warp-wide sum of v[l]: a reduce-scatter
// of 32 values over 32 lanes in a fixed order.
__device__ __forceinline__ float reduce_scatter32(float (&v)[kChunk],
                                                  int lane) {
  static_assert(kChunk == 32, "one column per lane");
  reduce_level<16>(v, lane);
  reduce_level<8>(v, lane);
  reduce_level<4>(v, lane);
  reduce_level<2>(v, lane);
  reduce_level<1>(v, lane);
  return v[0];
}

template <class Body, bool WITH_LOSS>
__global__ void __launch_bounds__(kThreads, 2)
pair_grad_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ rowpart, float* __restrict__ colpart,
                 double* __restrict__ losspart, int64_t n1, int64_t n2,
                 int tiles_per_seg) {
  __shared__ float sb[kTileB];
  __shared__ float wcol[kWarps][kTileB];
  __shared__ double swarp[kWarps];

  const int64_t w = blockIdx.z;
  const int bx = blockIdx.x, seg = blockIdx.y;
  const int gx = gridDim.x, gs = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = (int64_t)bx * kTileA;
  const float* aw = a + w * n1;
  const float* bw = b + w * n2;

  float av[kRowsPerThread], rtot[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = row0 + k * kThreads + threadIdx.x;
    av[k] = r < n1 ? aw[r] : INFINITY;
    rtot[k] = 0.f;
  }
  double ltot = 0.0;

  const int64_t gy = (n2 + kTileB - 1) / kTileB;
  const int64_t t_begin = (int64_t)seg * tiles_per_seg;
  const int64_t t_end = t_begin + tiles_per_seg < gy ? t_begin + tiles_per_seg
                                                     : gy;
  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int64_t col0 = tile * kTileB;
    const int ncols = n2 - col0 < kTileB ? (int)(n2 - col0) : kTileB;
    const int nchunks = (ncols + kChunk - 1) / kChunk;
    __syncthreads();  // the previous tile's readers of sb and wcol are done
    for (int j = threadIdx.x; j < nchunks * kChunk; j += kThreads)
      sb[j] = j < ncols ? bw[col0 + j] : -INFINITY;
    __syncthreads();

    float racc[kRowsPerThread], lacc[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) racc[k] = lacc[k] = 0.f;

    for (int ch = 0; ch < nchunks; ++ch) {
      float v[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float bj = sb[ch * kChunk + c];
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          const float d = av[k] - bj;
          const float t = Body::gp(d);
          racc[k] += t;
          s += t;
          if (WITH_LOSS) lacc[k] += Body::g(d);
        }
        v[c] = s;
      }
      wcol[warp][ch * kChunk + lane] = reduce_scatter32(v, lane);
    }
    __syncthreads();

    float* cp = colpart + (w * gx + bx) * n2 + col0;
    for (int j = threadIdx.x; j < ncols; j += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += wcol[q][j];
      cp[j] = s;
    }
    float lt = 0.f;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      rtot[k] += racc[k];
      lt += lacc[k];
    }
    if (WITH_LOSS) ltot += (double)lt;
  }

  float* rp = rowpart + (w * gs + seg) * n1;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = row0 + k * kThreads + threadIdx.x;
    if (r < n1) rp[r] = rtot[k];
  }
  if (WITH_LOSS) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ltot += __shfl_down_sync(0xffffffffu, ltot, off);
    if (lane == 0) swarp[warp] = ltot;
    __syncthreads();
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int q = 0; q < kWarps; ++q) s += swarp[q];
      losspart[(w * gs + seg) * gx + bx] = s;
    }
  }
}

// row[w,i] = sum over segments of rowpart, col[w,j] = sum over row tiles of
// colpart, loss[w] = sum of the block partials; each in a fixed order.
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ rowpart,
              const float* __restrict__ colpart,
              const double* __restrict__ losspart, float* __restrict__ row,
              float* __restrict__ col, double* __restrict__ loss, int64_t n1,
              int64_t n2, int gx, int gs) {
  __shared__ double swarp[kWarps];
  const int64_t w = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n1) {
    const float* p = rowpart + w * gs * n1 + i;
    float s = 0.f;
    for (int q = 0; q < gs; ++q) s += p[q * n1];
    row[w * n1 + i] = s;
  }
  if (i < n2) {
    const float* p = colpart + w * gx * n2 + i;
    float s = 0.f;
    for (int q = 0; q < gx; ++q) s += p[q * n2];
    col[w * n2 + i] = s;
  }
  if (loss != nullptr && blockIdx.x == 0) {
    const int np = gs * gx;
    const double* p = losspart + w * np;
    double s = 0.0;
    for (int q = threadIdx.x; q < np; q += kThreads) s += p[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) swarp[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      double t = 0.0;
      for (int q = 0; q < kWarps; ++q) t += swarp[q];
      loss[w] = t;
    }
  }
}

template <class Body>
void launch(bool with_loss, dim3 grid, cudaStream_t stream, const float* a,
            const float* b, float* rowpart, float* colpart, double* losspart,
            int64_t n1, int64_t n2, int tiles_per_seg) {
  if (with_loss)
    pair_grad_kernel<Body, true><<<grid, kThreads, 0, stream>>>(
        a, b, rowpart, colpart, losspart, n1, n2, tiles_per_seg);
  else
    pair_grad_kernel<Body, false><<<grid, kThreads, 0, stream>>>(
        a, b, rowpart, colpart, losspart, n1, n2, tiles_per_seg);
}

}  // namespace

extern "C" {

int tw_grad_tile_a() { return kTileA; }
int tw_grad_tile_b() { return kTileB; }

// Launches the pair kernel and then the reduction on `stream`; returns the
// first non-zero cudaGetLastError() (0 when both launched).
// a [W, n1], b [W, n2]: contiguous float32 on the device. Scratch, from the
// wrapper: rowpart [W, gs, n1] and colpart [W, gx, n2] float32, losspart
// [W, gs, gx] float64 (with_loss only), where gx = ceil(n1 / kTileA) and
// the n2 side's ceil(n2 / kTileB) column tiles are cut into gs segments of
// tiles_per_seg tiles. Outputs: row [W, n1], col [W, n2] float32, loss [W]
// float64 (with_loss only; pass null otherwise). body: 1 hinge, 2 logistic
// (ops/kernels.py); any other body returns cudaErrorInvalidValue. The
// wrapper checks every argument.
int tw_pair_grad(const void* a, const void* b, void* rowpart, void* colpart,
                 void* losspart, void* row, void* col, void* loss,
                 long long n1, long long n2, int w, int gs,
                 int tiles_per_seg, int body, int with_loss, void* stream) {
  const int gx = (int)((n1 + kTileA - 1) / kTileA);
  const dim3 grid((unsigned)gx, (unsigned)gs, (unsigned)w);
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto rp = static_cast<float*>(rowpart);
  auto cp = static_cast<float*>(colpart);
  auto lp = static_cast<double*>(losspart);
  switch (body) {
    case 1: launch<HingeBody>(with_loss, grid, s, fa, fb, rp, cp, lp, n1, n2, tiles_per_seg); break;
    case 2: launch<LogisticBody>(with_loss, grid, s, fa, fb, rp, cp, lp, n1, n2, tiles_per_seg); break;
    default: return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long nmax = n1 > n2 ? n1 : n2;
  const dim3 rgrid((unsigned)((nmax + kThreads - 1) / kThreads), (unsigned)w);
  reduce_kernel<<<rgrid, kThreads, 0, s>>>(
      rp, cp, with_loss ? lp : nullptr, static_cast<float*>(row),
      static_cast<float*>(col), with_loss ? static_cast<double*>(loss) : nullptr,
      n1, n2, gx, gs);
  return (int)cudaGetLastError();
}

}  // extern "C"
