// Pairwise-loss gradient sums of the logistic body on Hopper (sm_90a).
//
// Replaces, for the logistic body, the two gradient Pallas TPU kernels of
// tuplewise_tpu/ops/pallas_pairs.py:
//   * pallas_pair_loss_grad (body _fused_loss_grad_kernel) -> WITH_LOSS = true
//   * pallas_pair_grad_sums (body _pair_grad_kernel)       -> WITH_LOSS = false
// The hinge body's g' is -1 or 0, so its sums are counts: it runs the
// sort-and-search route tw_rank_hinge_grad of csrc/rank_count.cu.
//
// What it computes, for each of W independent problems w (a batch axis:
// the N workers of a training step, or seeds x workers of the simulated
// learner), with d_ij = a[w,i] - b[w,j]:
//     row[w,i] = sum_j g'(d_ij)      col[w,j] = sum_i g'(d_ij)
//     loss[w]  = sum_ij g(d_ij)      (WITH_LOSS only)
// g(d) = log(1 + e^{-d}), g'(d) = -1 / (1 + e^d). Row and col come out as
// float32, the loss as float64. Both variants evaluate g' and reduce row
// and col in the same code and the same order, so their row and col are
// bit-identical: a recorded training step and a loss-free one take the
// same gradient.
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
//     written as one float64 partial per block.
//   * reduce_kernel sums rowpart over segments, colpart over row tiles and
//     the loss partials, each in a fixed order.
// Scratch: W * (gs * n1 + gx * n2) float32 + W * gs * gx float64. At the
// trainer's headline (W = 1, n1 = n2 = 5e5) that is about 0.5 GB, nearly
// all of it the column partials (gx = 245 row tiles).
//
// The body, for the instruction issue rate (csrc/pair_sum.cu's
// logistic_sum_kernel is the model). With u = e^{-|d|} and one reciprocal
// r = 1 / (1 + u):
//     g'(d) = -(d >= 0 ? u : 1) * r,     g(d) = max(-d, 0) + log1p(u),
// log1p(u) = s P(s^2), s = u / (2 + u) (pair_sum.cu's log1p_unit, one more
// reciprocal). u is the factored exponential: with a centre c,
//     e^{-|a - b|} = min(e^{c - a} e^{b - c}, e^{a - c} e^{c - b}),
// two multiplies and a min from per-score exponentials formed once a row
// and a column, where expf was. The products must stay normal floats, so a
// block takes this form for a column tile only when the tile's scores and
// its row tile's (padding left out) are all finite and span at most
// kLogisticSpan = 80; c is 0 when every score lies in [-40, 40], else the
// midpoint rounded to an integer. Any other tile takes u = expf(-|d|) a
// pair. The choice is made on the block's own data, the same way in both
// variants, so it never parts their row and col. The products that form g'
// and the adds that sum it are __fmul_rn / __fadd_rn, so the compiler
// cannot contract them into FMAs differently in the two variants.
// NaN and infinities take the per-pair form and give what the plain body
// gives: NaN for a NaN difference (g and g'), g' = -0 and g = 0 for d =
// +inf, g' = -1 and g = +inf for d = -inf. Where e^d overflows (d > 88.7)
// the plain g' is -1 / inf = -0 and this form gives -e^{-d}, a value
// below 2^-126.
//
// Ragged edges. Rows past n1 and columns past n2 are left out by index: a
// chunk that holds one (the last row tile, the last chunk of the last
// column tile) takes the per-pair form with both masks, a select a pair
// that no other chunk pays. No score sentinel enters a sum, so an
// infinite real score meets no padding.
//
// Bound. After the tile loads a pair costs, in the factored form, a
// subtraction, two multiplies and a min, the reciprocal (an add and a MUFU
// op), a select and a multiply for g', and the row and col adds; the loss
// adds the log1p (an add, a reciprocal, 3 multiplies, 4 FMAs), a max, an
// add and its accumulating add. It is bound by the instruction issue rate
// (chip_smoke.py counts the SASS instructions a pair of each loop), not by
// bytes. It is built without fast-math.

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

// the factored branch's widest score range, and log1p's coefficients: a
// copy of csrc/pair_sum.cu's (each source builds alone, and ops/_build.py
// keys a library by its one source); ops/pair_grad_kernels.py checks both
// libraries against ops/pair_kernels.py's values when it loads them
constexpr float kLogisticSpan = 80.f;
constexpr float kLog1p0 = 2.0f;
constexpr float kLog1p1 = 0.6666631698608398f;
constexpr float kLog1p2 = 0.4002491533756256f;
constexpr float kLog1p3 = 0.27960577607154846f;
constexpr float kLog1p4 = 0.2817831039428711f;

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// log1p(x) for x in [0, 1] (NaN for NaN): s P(s^2), s = x / (2 + x)
__device__ __forceinline__ float log1p_unit(float x) {
  const float s = x * rcp_approx(2.f + x);
  const float z = s * s;
  float p = fmaf(kLog1p4, z, kLog1p3);
  p = fmaf(p, z, kLog1p2);
  p = fmaf(p, z, kLog1p1);
  p = fmaf(p, z, kLog1p0);
  return s * p;
}

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

// the forms of a chunk's pairs
enum Form { kFactored = 0, kPerPair = 1, kMasked = 2 };

// The 256 pairs of one chunk (8 rows of this thread x 32 columns from col):
// g' into the row sums racc and the column sums v, g into lacc. kMasked is
// the per-pair form with the rows past n1 (rok) and the columns past
// ncols left out.
template <bool WITH_LOSS, int FORM>
__device__ __forceinline__ void chunk_pairs(
    const float* sb, const float2* sexp, int col, int ncols,
    const float (&av)[kRowsPerThread], const float (&up)[kRowsPerThread],
    const float (&dn)[kRowsPerThread], const bool (&rok)[kRowsPerThread],
    float (&racc)[kRowsPerThread], float (&lacc)[kRowsPerThread],
    float (&v)[kChunk]) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const float bj = sb[col + c];
    float ey = 0.f, ez = 0.f;
    if (FORM == kFactored) {
      const float2 t = sexp[col + c];
      ey = t.x;
      ez = t.y;
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const float d = av[k] - bj;
      const float u = FORM == kFactored
                          ? fminf(__fmul_rn(dn[k], ey), __fmul_rn(up[k], ez))
                          : expf(-fabsf(d));
      const float r = rcp_approx(1.f + u);
      float t = __fmul_rn(d >= 0.f ? -u : -1.f, r);
      if (FORM == kMasked && !(rok[k] && col + c < ncols)) t = 0.f;
      racc[k] = __fadd_rn(racc[k], t);
      s = __fadd_rn(s, t);
      if (WITH_LOSS) {
        float g = fmaxf(-d, 0.f) + log1p_unit(u);
        if (FORM == kMasked && !(rok[k] && col + c < ncols)) g = 0.f;
        lacc[k] += g;
      }
    }
    v[c] = s;
  }
}

// min and max of a value over the block (every thread gets them), and
// whether every thread's flag is set
__device__ __forceinline__ bool block_range(float& lo, float& hi, bool ok,
                                            float* smin, float* smax) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    smin[threadIdx.x >> 5] = lo;
    smax[threadIdx.x >> 5] = hi;
  }
  const bool all = !__syncthreads_or(!ok);
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    lo = fminf(lo, smin[q]);
    hi = fmaxf(hi, smax[q]);
  }
  return all;
}

template <bool WITH_LOSS>
__global__ void __launch_bounds__(kThreads, 2)
logistic_grad_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ rowpart, float* __restrict__ colpart,
                     double* __restrict__ losspart, int64_t n1, int64_t n2,
                     int tiles_per_seg) {
  __shared__ float sb[kTileB];
  __shared__ float2 sexp[kTileB];  // (e^{b - c}, e^{c - b})
  __shared__ float wcol[kWarps][kTileB];
  __shared__ float smin[kWarps], smax[kWarps];
  __shared__ double swarp[kWarps];

  const int64_t w = blockIdx.z;
  const int bx = blockIdx.x, seg = blockIdx.y;
  const int gx = gridDim.x, gs = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = (int64_t)bx * kTileA;
  const float* aw = a + w * n1;
  const float* bw = b + w * n2;
  const float kInf = __int_as_float(0x7F800000);

  float av[kRowsPerThread], rtot[kRowsPerThread];
  float up[kRowsPerThread], dn[kRowsPerThread];
  bool rok[kRowsPerThread];
  float rlo = kInf, rhi = -kInf;
  bool rfin = true;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = row0 + k * kThreads + threadIdx.x;
    rok[k] = r < n1;
    av[k] = rok[k] ? aw[r] : 0.f;  // left out by index below
    rtot[k] = 0.f;
    up[k] = dn[k] = 0.f;
    if (rok[k]) {
      rfin = rfin && fabsf(av[k]) < kInf;
      rlo = fminf(rlo, av[k]);
      rhi = fmaxf(rhi, av[k]);
    }
  }
  rfin = block_range(rlo, rhi, rfin, smin, smax);
  const bool row_ragged = row0 + kTileA > n1;
  double ltot = 0.0;

  const int64_t gy = (n2 + kTileB - 1) / kTileB;
  const int64_t t_begin = (int64_t)seg * tiles_per_seg;
  const int64_t t_end = t_begin + tiles_per_seg < gy ? t_begin + tiles_per_seg
                                                     : gy;
  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int64_t col0 = tile * kTileB;
    const int ncols = n2 - col0 < kTileB ? (int)(n2 - col0) : kTileB;
    const int nchunks = (ncols + kChunk - 1) / kChunk;
    __syncthreads();  // the previous tile's readers of sb, sexp, wcol are done
    float lo = rlo, hi = rhi;
    bool fin = true;
    for (int j = threadIdx.x; j < nchunks * kChunk; j += kThreads) {
      const float bj = j < ncols ? bw[col0 + j] : 0.f;  // left out by index
      sb[j] = bj;
      if (j < ncols) {
        fin = fin && fabsf(bj) < kInf;
        lo = fminf(lo, bj);
        hi = fmaxf(hi, bj);
      }
    }
    fin = block_range(lo, hi, fin, smin, smax) && rfin;
    const bool factored = fin && hi - lo <= kLogisticSpan;
    if (factored) {
      const float c = fmaxf(fabsf(lo), fabsf(hi)) <= 0.5f * kLogisticSpan
                          ? 0.f : rintf(0.5f * (lo + hi));
      for (int j = threadIdx.x; j < nchunks * kChunk; j += kThreads) {
        const float bc = sb[j] - c;
        sexp[j] = make_float2(expf(bc), expf(-bc));
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        up[k] = expf(av[k] - c);
        dn[k] = expf(c - av[k]);
      }
    }
    __syncthreads();

    float racc[kRowsPerThread], lacc[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) racc[k] = lacc[k] = 0.f;

    for (int ch = 0; ch < nchunks; ++ch) {
      const int col = ch * kChunk;
      float v[kChunk];
      if (row_ragged || col + kChunk > ncols)
        chunk_pairs<WITH_LOSS, kMasked>(sb, sexp, col, ncols, av, up, dn,
                                        rok, racc, lacc, v);
      else if (factored)
        chunk_pairs<WITH_LOSS, kFactored>(sb, sexp, col, ncols, av, up, dn,
                                          rok, racc, lacc, v);
      else
        chunk_pairs<WITH_LOSS, kPerPair>(sb, sexp, col, ncols, av, up, dn,
                                         rok, racc, lacc, v);
      wcol[warp][col + lane] = reduce_scatter32(v, lane);
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
      rtot[k] = __fadd_rn(rtot[k], racc[k]);
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

}  // namespace

extern "C" {

int tw_grad_tile_a() { return kTileA; }
int tw_grad_tile_b() { return kTileB; }
float tw_grad_logistic_span() { return kLogisticSpan; }
// the log1p coefficients kLog1p0..kLog1p4 (any other i: 0)
float tw_grad_log1p_coef(int i) {
  const float c[5] = {kLog1p0, kLog1p1, kLog1p2, kLog1p3, kLog1p4};
  return i >= 0 && i < 5 ? c[i] : 0.f;
}

// Launches the pair kernel and then the reduction on `stream`; returns the
// first non-zero cudaGetLastError() (0 when both launched).
// a [W, n1], b [W, n2]: contiguous float32 on the device. Scratch, from the
// wrapper: rowpart [W, gs, n1] and colpart [W, gx, n2] float32, losspart
// [W, gs, gx] float64 (with_loss only), where gx = ceil(n1 / kTileA) and
// the n2 side's ceil(n2 / kTileB) column tiles are cut into gs segments of
// tiles_per_seg tiles. Outputs: row [W, n1], col [W, n2] float32, loss [W]
// float64 (with_loss only; pass null otherwise). body: 2 logistic
// (ops/kernels.py); any other body returns cudaErrorInvalidValue (the
// hinge is tw_rank_hinge_grad of csrc/rank_count.cu). The wrapper checks
// every argument.
int tw_pair_grad(const void* a, const void* b, void* rowpart, void* colpart,
                 void* losspart, void* row, void* col, void* loss,
                 long long n1, long long n2, int w, int gs,
                 int tiles_per_seg, int body, int with_loss, void* stream) {
  if (body != 2) return (int)cudaErrorInvalidValue;
  const int gx = (int)((n1 + kTileA - 1) / kTileA);
  const dim3 grid((unsigned)gx, (unsigned)gs, (unsigned)w);
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto rp = static_cast<float*>(rowpart);
  auto cp = static_cast<float*>(colpart);
  auto lp = static_cast<double*>(losspart);
  if (with_loss)
    logistic_grad_kernel<true><<<grid, kThreads, 0, s>>>(
        fa, fb, rp, cp, lp, n1, n2, tiles_per_seg);
  else
    logistic_grad_kernel<false><<<grid, kThreads, 0, s>>>(
        fa, fb, rp, cp, lp, n1, n2, tiles_per_seg);
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
