// Sort-and-count kernels on Hopper (sm_90a): the auc and hinge bodies of the
// pair sum, unmasked and masked, the indicator and hinge bodies of the
// per-anchor triplet sums, and the hinge body of the gradient pair sums.
//
// Replaces, for these bodies, the Pallas TPU kernels of
//   * tuplewise_tpu/ops/pallas_pairs.py:134 pallas_pair_sum (auc and hinge
//     bodies, also reached through pallas_pair_sum_any) -> tw_rank_auc,
//                                                         tw_rank_hinge_sum
//   * tuplewise_tpu/ops/pallas_pairs.py:300 pallas_masked_pair_sum (auc and
//     hinge bodies)                                     -> tw_rank_masked_sum
//   * tuplewise_tpu/ops/pallas_triplets.py:185 _batched_masked_pair_sum
//     (indicator and hinge combines, driven by pallas_triplet_stats)
//                                                      -> tw_rank_indicator,
//                                                         tw_rank_hinge
//   * tuplewise_tpu/ops/pallas_pairs.py:440 pallas_pair_loss_grad and :520
//     pallas_pair_grad_sums (hinge body)                -> tw_rank_hinge_grad
// The logistic body, masked or not, keeps csrc/pair_sum.cu and
// csrc/pair_grad.cu.
//
// What they compute, for each of W independent problems w:
//   tw_rank_auc:       2 * #{(i,j): fl(a_i - b_j) > 0} + #{(i,j): fl(a_i - b_j) == 0}
//                      as int64 partials; the wrapper halves the sum in
//                      float64, which is the auc body's pair sum exactly.
//   tw_rank_indicator: S_w = sum_{j,k} 1{fl(A[w,j] - B[w,k]) < -margin}
//                            * mp[q,j] * 1{ip[q,j] != ia[w]} * mk[q,k]
//                      (q = w / C) as float64 partials, one per block.
//   tw_rank_hinge:     S_w = sum_{j,k} max(0, margin + A[w,j] - B[w,k])
//                            * mp[q,j] * 1{ip[q,j] != ia[w]} * mk[q,k]
//                      as float64 partials, one per block.
//   tw_rank_hinge_grad: row[w,i] = -#{j : fl(a_i - b_j) < 1},
//                      col[w,j] = -#{i : fl(a_i - b_j) < 1} (float32 of
//                      int32 counts), loss[w] = sum_ij max(0, 1 - fl(a_i -
//                      b_j)) in float64: the hinge's g' and g summed.
//   tw_rank_hinge_sum: loss[w] = sum_ij max(0, 1 - fl(a_i - b_j)) in float64,
//                      the hinge body's pair sum (the gradient route's loss
//                      alone).
//   tw_rank_masked_sum: out[w] = sum_ij g(fl(a_i - b_j)) * ma_i * mb_j in
//                      float64, g the auc or the hinge body, for any finite
//                      weights ma, mb of either sign (the caller forms the
//                      count sum(ma) * sum(mb)).
//
// Design. The TPU kernels compared every pair (or triplet) because the TPU
// has no fast search. Here the second operand is cut into tiles of T values
// (T in {2048, 4096, 8192, 16384}; the wrapper picks it). A block sorts one
// tile with a block-wide radix sort (CUB's BlockRadixSort, a building block
// inside the kernel) on order-preserving uint32 keys held in registers, and
// then every value of the first operand counts the tile by a binary search
// in shared memory: log2(T) + 1 probes a value and tile instead of T
// compares.
//   * auc: sort_tiles_kernel sorts each tile of b once into a scratch tensor;
//     auc_count_kernel loads one sorted tile into shared memory and counts a
//     chunk of kCountChunk values of a against it (a lower search, and an
//     upper one only where the value ties the tile). One int64 partial a
//     block, summed by the wrapper; no atomics on the result.
//   * indicator: a tile of B[w] is searched by the positives of problem w
//     alone, so indicator_kernel sorts the tile together with its weights
//     mk, forms their float64 suffix sums, and searches every A[w,j] in the
//     same block. One float64 partial a block; the positive weight
//     mp * 1{ip != ia} is formed in the kernel from the ids.
//   * hinge: the body is piecewise linear in B. For one positive x = A[w,j]
//     the terms that are not 0 are those with fl(margin + fl(x - B_k)) > 0,
//     a prefix pre(x) of the sorted tile, and their sum is
//         (margin + x) * sum_{pre(x)} mk_k  -  sum_{pre(x)} mk_k * B_k.
//     hinge_kernel sorts (key, mk) pairs as the indicator does, forms the
//     two float64 prefix sums (W[c], S[c]) side by side in shared memory
//     (one 16-byte load a positive), and each positive searches its prefix
//     with the body's predicate and takes (margin + x) * W - S in float64:
//     O((P + K) log K) work an anchor and tile instead of O(P K). The tile
//     is at most kHingeMaxTile = 8192: 4 T bytes of values and 16 (T + 1)
//     of prefix sums, 160 KB at T = 8192, fit a block's 227 KB; T = 16384
//     (320 KB) does not. One tile per row with the prefix sums in global
//     memory was the other choice: it would save the searches of 3 tiles of
//     a 32768-wide row but sort 32768 values a block, out of a block's
//     registers, and read its prefix sums from L2.
//   * hinge gradient (kernels 3-4): g' is -1 or 0, so row and col are
//     counts, and the predicate fl(a - b) < 1 holds on a suffix of the sorted
//     b (row pass) and on a prefix of the sorted a (col pass). The weights
//     are all 1, so one float64 suffix sum of b gives the loss of a row:
//     c (1 - a_i) + sum of the suffix, c its length (hinge_kernel's identity
//     with margin 1). That is 12 bytes a value, so tiles of up to 16384
//     (196 KB) fit a block. grad_sort_kernel sorts every tile of a and of b
//     once into scratch (Eytzinger values, the suffix sums, and per tile the
//     count of values that are not NaN, of +inf and of -inf values, and a NaN
//     flag); grad_count_kernel loads one sorted tile and searches a chunk of
//     the other side against it with the body's float32 predicate (rule 1),
//     adds each count to an int32 per score with an integer atomic (order-
//     free, so the bits repeat) and, in the row pass, sums the loss of its
//     chunk into one float64 partial; grad_finish_kernel writes -count as
//     float32 and sums the partials of a problem in a fixed order. Padding
//     never enters a count or a sum: it is left out by the count of a tile's
//     values (a search past them is clamped) and by index. Non-finite scores
//     follow rule 4 with margin 1 and unit weights (hinge_grad_loss); g' is
//     0 for a NaN difference, as -1{d < 1} is. Rows and cols equal the plain
//     version at any size (one rounding of an exact integer each), and the
//     loss-free call runs the same counts, so its row and col are those of
//     the loss call bit for bit.
//   * hinge pair sum (kernel 1, unmasked): the gradient route's loss with no
//     counts and no col pass. grad_sort_kernel sorts b's tiles with their
//     suffix sums (a null counts pointer: nothing to zero), the row pass of
//     grad_count_kernel runs with COUNTS false (no atomics: each block only
//     writes its float64 partial of the loss; a block searches a tile with
//     kSumSweeps / kGradSweeps = 8 times the values of a, since the tile
//     and its suffix sums fill a block's shared memory and their load is
//     the block's other cost), and grad_finish_kernel sums a
//     problem's partials in a fixed order, so a run repeats bit for bit. A
//     selected pair adds (1 - a_i) + b_j in float64 where the pair sweep added
//     fl(1 - fl(a_i - b_j)) in float32: the two differ by at most half an ulp
//     of fl(a_i - b_j) and half an ulp of the float32 term a pair (rule 5).
//   * masked pair sum (kernel 2, auc and hinge): the TPU kernel swept every
//     pair with a multiply by each mask; here the weights ride the sort.
//     masked_sort_kernel sorts each tile of b once into scratch as (key,
//     weight) pairs (NaN values and padding weigh 0 and sit as +inf slots
//     after the others) with the float64 suffix sums of the sorted weights
//     (auc: 12 bytes a value, tiles of up to 16384, 196 KB in a block) or of
//     (mb, mb b) over the finite values (hinge: 20 bytes a value, tiles of
//     up to kHingeMaxTile = 8192, 160 KB), and the tile's int4 info (values
//     that are not NaN, +inf values, flags, -inf values).
//     masked_search_kernel loads one sorted tile and its sums into shared
//     memory and searches a chunk of sum_chunk(T) values of a against it, as
//     the unmasked hinge's row pass does (a grid of (chunks, tiles, W): at
//     W = 8 the chunks of a, not the problems and tiles alone, fill the 132
//     SMs with one block each; bench_torch_variants.py --masked times other
//     chunks):
//       auc: P_gt and P_ge, the weights of the b with fl(a_i - b) > 0 and
//         >= 0 (rule 1: a lower search, and an upper one only where a_i ties
//         the next value), from the suffix sums; the row adds ma_i (P_gt +
//         (P_ge - P_gt) / 2) in float64. For weights in {0, 1} every suffix
//         sum, row and partial is an integer or a half below 2^53, so the
//         sum is the plain version's exactly; NaN a_i, NaN b and equal
//         infinities satisfy no predicate and add 0, so a zero weight never
//         makes NaN (the auc body is 0 there, times a finite weight). For
//         other weights the plain version rounds each float32 product
//         g mb ma once (g mb is exact for g in {0, 1/2, 1}), so the two differ
//         by at most 2^-24 of the sum, and float64 rounding.
//       hinge: the terms that are not 0 are the b with fl(a_i - b) < 1, a
//         suffix of the sorted tile past the prefix where !(fl(a_i - b) <
//         1); the row adds ma_i ((1 - a_i) W + S) with W and S the suffix
//         sums of mb and mb b there, in float64. Non-finite scores follow
//         rule 4 read for the pair hinge max(0, 1 - a_i + b_j) ma_i mb_j
//         (masked_hinge_row): a NaN anywhere in a[w] or b[w] makes S_w NaN;
//         an infinite term takes the sign of its two weights' product, and
//         is NaN where one of them is 0; the tile's counts of +inf and -inf
//         values and its flags (kTileNan; for the +inf values, and for the
//         finite and +inf values, whether one has a weight < 0, = 0, > 0)
//         decide these cases by count. The plain version rounds fl(a - b),
//         fl(1 - d) and the two float32 products by the weights; this form
//         adds the exact products, so the two differ by at most half an ulp
//         of each of those a pair, times the weights that follow it (rule 5;
//         tests/test_torch_masked_routes.py derives the gap).
//     Both write one float64 partial a block; grad_finish_kernel sums a
//     problem's partials in a fixed order, so a call repeats bit for bit.
//     Any finite weights of either sign are right, not only {0, 1}: the
//     suffix sums are of the weights themselves, and every non-finite case
//     is decided by the sign flags above (rule 4).
// A sorted tile sits in shared memory in Eytzinger (breadth-first) order:
// sorted positions 0..T-2 form a complete search tree of log2(T) levels,
// position T-1 sits in slot T-1. A search step is one load, one subtraction,
// one compare and an index update, and the probes of one level lie side by
// side, so a warp's probes spread over the banks. Each thread keeps kIlp
// searches in flight.
//
// Exactness rules (a plain rank count does not compute the bodies above: the
// body scores equal infinities, whose difference is NaN, as 0, not as a tie).
//   1. Every search uses the body's own predicate on the float32 difference,
//      never a raw comparison of a and b: wins = #b with fl(a - b) > 0 and
//      wins + ties = #b with fl(a - b) >= 0 (auc); #B with
//      fl(A - B) < -margin (indicator); fl(margin + fl(A - B)) > 0 (hinge).
//      fl(x - s) is non-increasing in s once NaN s is left out, so each
//      predicate holds on a prefix (auc, hinge) or a suffix (indicator) of a
//      sorted tile and a binary search counts it exactly, for any finite
//      margin. Equal infinities fall out by themselves.
//   2. Keys: -0.0 is made +0.0 first (the body calls them tied; as raw bits
//      -0.0 would sort below +0.0), and every NaN, of either sign, becomes
//      the top key kNanKey, so NaN values (and the padding of a short tile)
//      sort to the end of a tile and are left out of every count: for the
//      auc they stay NaN, on which neither predicate holds; for the indicator
//      and the hinge their weights are zeroed before the prefix sums and
//      their slots hold +inf, which ends the search of every A.
//   3. A NaN value of the first operand satisfies no predicate and adds 0
//      to the auc and the indicator.
//   4. The hinge propagates NaN and infinity as max(0, margin + t) * mk * wp
//      summed in IEEE arithmetic does (jnp.maximum and torch.clamp_min both
//      return NaN for NaN), with finite weights mk and wp of either sign. An
//      infinite t gives a term of +inf * mk_k * wp: an infinity with the
//      sign of mk_k * wp, NaN where either is 0; a sum that meets both
//      signs is NaN. So a row's infinite part is NaN if its own weight, or
//      a weight of the values that give it an infinite t, is 0, or if those
//      weights have both signs; else an infinity of sign(wp) times their
//      sign. A tile records, for each class of values that can give an
//      infinite t, whether it holds one of weight < 0, = 0 and > 0:
//        * a NaN in A[w, :] or in B[w, :] makes S_w NaN, whatever the
//          weights (a NaN term times a zero weight is NaN): a NaN in the
//          tile makes the block's partial NaN, a NaN positive its term;
//        * x = -inf: t = -inf - B is -inf (a term of 0) unless B = -inf,
//          where t is NaN; so NaN if the tile holds a -inf, else 0;
//        * x = +inf: t = +inf for every finite or -inf B, and NaN for B =
//          +inf; so NaN if the tile holds a +inf, else the infinite part
//          of the finite and -inf B's weights (kTileNegW, kTileZeroW,
//          kTilePosW);
//        * finite x: B = +inf gives t = -inf, a term of 0, and stays out of
//          every prefix; B = -inf gives t = +inf and lies in every prefix, so
//          mk_k * B_k = -inf * sign(mk_k) (or NaN for mk_k = 0) in S makes
//          the term an infinity of sign(mk_k) (or NaN), and -inf values of
//          both signs of weight make S NaN, as in the plain sum;
//        * the row's part is multiplied by wp in IEEE arithmetic: an
//          infinity times wp = 0 is NaN, and a negative wp flips its sign,
//          so every positive of the row enters the sum, whatever its
//          weight.
//      Kernel 2's masked pair hinge max(0, 1 - a + b) ma mb reads the same
//      rule with the roles of the classes mirrored (masked_hinge_row).
//      A finite difference that overflows float32 (|A - B| > 3.4e38) is out
//      of this contract: the plain sum gives +inf there, this form a finite
//      float64.
//   5. Hinge numerics: the plain version sums float32 terms fl(margin +
//      fl(A - B)) * mk in float64; this form sums exact float64 products and
//      differences of the float32 inputs, so the two differ by the float32
//      rounding of each term (a few units in 2^-24 of a term), and a term
//      whose float32 predicate and exact sign disagree is at most an ulp.
// Built without fast-math (ops/_build.py): fl(x - s) == 0 iff x == s for
// finite floats only with gradual underflow.
//
// Bound. Bytes: each operand (and weight) is read once and each partial
// written once (the count and search kernels re-read a sorted tile from L2
// once per chunk of a). The
// work is log2(T) + 1 shared-memory probes a value and tile plus a radix
// sort of each tile, far below the all-pairs operation count of the TPU
// kernels; what sets the time is the instruction issue of the probes and
// the shared-memory traffic of the sort.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int kMaxTile = 16384;       // values sorted by one block
constexpr int kMinTile = 2048;
constexpr int kHingeMaxTile = 8192;   // the hinge's tile (see the note)
constexpr int kCountThreads = 512;
constexpr int kCountChunk = 8192;     // values of a counted by one block
constexpr int kIlp = 4;               // searches a thread keeps in flight
constexpr unsigned kNanKey = 0xFFFFFFFFu;

__host__ __device__ constexpr int log2_of(int t) {
  return t > 1 ? 1 + log2_of(t >> 1) : 0;
}

// order-preserving key: -0.0 -> +0.0, every NaN -> kNanKey (rule 2)
__device__ __forceinline__ unsigned float_key(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return kNanKey;
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Eytzinger slot of sorted position p in a tile of 2^LOG_T values
template <int LOG_T>
__device__ __forceinline__ int eyt_slot(int p) {
  constexpr int T = 1 << LOG_T;
  if (p == T - 1) return T - 1;
  const int j = p + 1;                 // in-order rank in the tree, from 1
  const int t = __ffs(j) - 1;          // height of its node
  return (j >> (t + 1)) + (1 << (LOG_T - 1 - t)) - 1;
}

struct Wins {          // auc: fl(a - b) > 0
  __device__ __forceinline__ bool holds(float x, float s) const {
    return x - s > 0.f;
  }
};

struct WinsOrTies {    // auc: fl(a - b) >= 0
  __device__ __forceinline__ bool holds(float x, float s) const {
    return x - s >= 0.f;
  }
};

struct NotBelow {      // indicator: !(fl(A - B) < -margin), a prefix
  float neg_margin;
  __device__ __forceinline__ bool holds(float x, float s) const {
    return !(x - s < neg_margin);
  }
};

struct HingePositive {  // hinge: fl(margin + fl(A - B)) > 0, a prefix
  float margin;
  __device__ __forceinline__ bool holds(float x, float s) const {
    return margin + (x - s) > 0.f;
  }
};

// c[u] = the length of the prefix of the sorted tile e (Eytzinger order) on
// which pred(x[u], .) holds: kIlp interleaved searches of log2(T) + 1 probes
template <int LOG_T, int N, class Pred>
__device__ __forceinline__ void prefix_counts(const float* e,
                                              const float (&x)[N],
                                              int (&c)[N], Pred pred) {
  constexpr int T = 1 << LOG_T;
  int i[N];
#pragma unroll
  for (int u = 0; u < N; ++u) i[u] = 0;
#pragma unroll
  for (int level = 0; level < LOG_T; ++level) {
#pragma unroll
    for (int u = 0; u < N; ++u)
      i[u] = 2 * i[u] + (pred.holds(x[u], e[i[u]]) ? 2 : 1);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    c[u] = i[u] + 1 - T;               // in [0, T - 1]
    if (c[u] == T - 1 && pred.holds(x[u], e[T - 1])) c[u] = T;
  }
}

template <class V>
__device__ __forceinline__ V block_sum(V v, V* swarp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) swarp[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? swarp[threadIdx.x] : V(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // valid in thread 0
}

__device__ __forceinline__ double plus(double x, double y) { return x + y; }
__device__ __forceinline__ double2 plus(double2 x, double2 y) {
  return make_double2(x.x + y.x, x.y + y.y);
}
__device__ __forceinline__ double shfl_down(double v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ double2 shfl_down(double2 v, int off) {
  return make_double2(shfl_down(v.x, off), shfl_down(v.y, off));
}

// the sum of tot over the block's later threads (those of higher index), in
// a fixed order: a suffix scan over the block's threads. swarp holds one
// value a warp; the call syncs the block once.
template <class S>
__device__ __forceinline__ S later_threads_sum(S tot, S* swarp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  S incl = tot;  // this lane's and the later lanes' totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const S o = shfl_down(incl, off);
    if (lane + off < 32) incl = plus(incl, o);
  }
  if (lane == 0) swarp[warp] = incl;
  __syncthreads();
  S run = shfl_down(incl, 1);
  if (lane == 31) run = S();
  for (int q = warp + 1; q < (int)(blockDim.x >> 5); ++q)
    run = plus(run, swarp[q]);
  return run;
}

// ------------------------------------------------------------------------ //
// auc                                                                      //
// ------------------------------------------------------------------------ //

// grid (tiles, W), THREADS threads, the sort's temporary storage as dynamic
// shared memory. Writes the tile of b sorted ascending (canonical values,
// NaN and padding last) in Eytzinger order to sorted[w, tile, 0:T].
template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
sort_tiles_kernel(const float* __restrict__ b, float* __restrict__ sorted,
                  int64_t n2) {
  constexpr int T = THREADS * ITEMS;
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t w = blockIdx.y;
  const int64_t col0 = (int64_t)blockIdx.x * T;
  const int64_t rem = n2 - col0;
  const int len = rem < T ? (int)rem : T;
  const float* bw = b + w * n2 + col0;
  unsigned keys[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = r * THREADS + threadIdx.x;
    keys[r] = i < len ? float_key(bw[i]) : kNanKey;
  }
  // striped result: this thread holds sorted positions r THREADS + t
  Sort(*reinterpret_cast<typename Sort::TempStorage*>(smem))
      .SortBlockedToStriped(keys);
  float* out = sorted + (w * gridDim.x + blockIdx.x) * T;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    out[eyt_slot<log2_of(T)>(r * THREADS + threadIdx.x)] = key_float(keys[r]);
}

// the length of the prefix of e on which pred(x, .) holds (one search)
template <int LOG_T, class Pred>
__device__ __forceinline__ int prefix_count(const float* e, float x,
                                            Pred pred) {
  const float xs[1] = {x};
  int c[1];
  prefix_counts<LOG_T>(e, xs, c, pred);
  return c[0];
}

// gt[u], ge[u] = the lengths of the prefixes of the sorted tile e on which
// fl(x[u] - b) > 0 and >= 0 hold (rule 1): one search each, and the second
// only where x[u] ties the next value (ties are rare: probe it first)
template <int LOG_T, int N>
__device__ __forceinline__ void auc_counts(const float* e, const float (&x)[N],
                                           int (&gt)[N], int (&ge)[N]) {
  constexpr int T = 1 << LOG_T;
  prefix_counts<LOG_T>(e, x, gt, Wins());
#pragma unroll
  for (int u = 0; u < N; ++u) {
    ge[u] = gt[u];
    if (ge[u] < T && WinsOrTies().holds(x[u], e[eyt_slot<LOG_T>(ge[u])]))
      ge[u] = prefix_count<LOG_T>(e, x[u], WinsOrTies());
  }
}

// grid (chunks of a, tiles, W), kCountThreads threads, 4 T bytes of dynamic
// shared memory. partials[w, tile, chunk] = sum over the chunk's a of
// (wins + (wins + ties)) against the sorted tile.
template <int LOG_T>
__global__ void __launch_bounds__(kCountThreads)
auc_count_kernel(const float* __restrict__ a, const float* __restrict__ sorted,
                 long long* __restrict__ partials, int64_t n1) {
  constexpr int T = 1 << LOG_T;
  extern __shared__ __align__(16) unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  __shared__ long long swarp[kCountThreads / 32];
  const int64_t w = blockIdx.z;
  const int64_t tile = w * gridDim.y + blockIdx.y;
  const float4* src = reinterpret_cast<const float4*>(sorted + tile * T);
  for (int i = threadIdx.x; i < T / 4; i += kCountThreads)
    reinterpret_cast<float4*>(e)[i] = src[i];
  __syncthreads();

  const float* aw = a + w * n1;
  const int64_t row0 = (int64_t)blockIdx.x * kCountChunk;
  const int64_t end = n1 - row0 < kCountChunk ? n1 : row0 + kCountChunk;
  long long acc = 0;
  for (int64_t r0 = row0 + threadIdx.x; r0 < end;
       r0 += (int64_t)kIlp * kCountThreads) {
    // a slot past the end searches NaN, which counts 0 (rule 3)
    float x[kIlp];
    int wins[kIlp], upto[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int64_t r = r0 + (int64_t)u * kCountThreads;
      x[u] = r < end ? aw[r] : __int_as_float(0x7FFFFFFF);
    }
    auc_counts<LOG_T>(e, x, wins, upto);
#pragma unroll
    for (int u = 0; u < kIlp; ++u) acc += wins[u] + upto[u];
  }
  acc = block_sum(acc, swarp);
  if (threadIdx.x == 0) partials[tile * gridDim.x + blockIdx.x] = acc;
}

// ------------------------------------------------------------------------ //
// indicator                                                                //
// ------------------------------------------------------------------------ //

// grid (W, tiles), THREADS threads, dynamic shared memory: the sort's
// temporary storage, then (aliasing it) the sorted values [T] in Eytzinger
// order and the float64 suffix sums of their weights [T + 1] in sorted
// order. partials[w, tile] = the tile's part of S_w.
template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
indicator_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ mp, const int64_t* __restrict__ ip,
                 const int64_t* __restrict__ ia, const float* __restrict__ mk,
                 double* __restrict__ partials, int64_t P, int64_t K,
                 int64_t C, float margin) {
  constexpr int T = THREADS * ITEMS;
  constexpr int LOG_T = log2_of(T);
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  double* suffix = reinterpret_cast<double*>(smem + 4 * (size_t)T);
  __shared__ double swarp[THREADS / 32];

  const int64_t w = blockIdx.x;
  const int64_t q = w / C;
  const int64_t col0 = (int64_t)blockIdx.y * T;
  const int64_t rem = K - col0;
  const int len = rem < T ? (int)rem : T;
  const float* bw = B + w * K + col0;
  const float* mkq = mk + q * K + col0;
  unsigned keys[ITEMS];
  float wts[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = r * THREADS + threadIdx.x;
    const bool in = i < len;
    keys[r] = in ? float_key(bw[i]) : kNanKey;
    wts[r] = in ? mkq[i] : 0.f;
  }
  // blocked result: this thread holds sorted positions [t ITEMS, t ITEMS + ITEMS)
  Sort(*reinterpret_cast<typename Sort::TempStorage*>(smem)).Sort(keys, wts);

  // suffix[p] = sum of the weights at sorted positions >= p, NaN keys'
  // weights zeroed (rule 2)
  double tot = 0.0;
#pragma unroll
  for (int r = ITEMS - 1; r >= 0; --r) {
    if (keys[r] == kNanKey) wts[r] = 0.f;
    tot += (double)wts[r];
  }
  // its sync: the sort is done with its storage, which e and suffix alias
  double run = later_threads_sum(tot, swarp);
  const int base = threadIdx.x * ITEMS;
#pragma unroll
  for (int r = ITEMS - 1; r >= 0; --r) {
    run += (double)wts[r];
    suffix[base + r] = run;
    e[eyt_slot<LOG_T>(base + r)] =
        keys[r] == kNanKey ? __int_as_float(0x7F800000) : key_float(keys[r]);
  }
  if (threadIdx.x == 0) suffix[T] = 0.0;
  __syncthreads();

  // #B with fl(A - B) < -margin is a suffix of the sorted tile: count its
  // complement, a prefix, and take the suffix sum after it
  const NotBelow pred{-margin};
  const float* aw = A + w * P;
  const float* mpq = mp + q * P;
  const int64_t* ipq = ip + q * P;
  const int64_t id = ia[w];
  double acc = 0.0;
  for (int64_t j0 = threadIdx.x; j0 < P; j0 += (int64_t)kIlp * THREADS) {
    float x[kIlp], wj[kIlp];
    int c[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int64_t j = j0 + (int64_t)u * THREADS;
      const bool in = j < P;
      x[u] = in ? aw[j] : 0.f;
      wj[u] = in && ipq[j] != id ? mpq[j] : 0.f;
    }
    prefix_counts<LOG_T>(e, x, c, pred);
#pragma unroll
    for (int u = 0; u < kIlp; ++u)
      if (wj[u] != 0.f) acc += (double)wj[u] * suffix[c[u]];
  }
  acc = block_sum(acc, swarp);
  if (threadIdx.x == 0) partials[w * gridDim.y + blockIdx.y] = acc;
}

// ------------------------------------------------------------------------ //
// hinge                                                                    //
// ------------------------------------------------------------------------ //

// flags of a tile of B (rule 4), over its values, not its padding
constexpr unsigned kTileNan = 1u;       // a NaN
constexpr unsigned kTilePosInf = 2u;    // a +inf
constexpr unsigned kTileNegInf = 4u;    // a -inf
constexpr unsigned kTileZeroW = 8u;     // a finite or -inf value of weight 0
constexpr unsigned kTileNegW = 64u;     // ... of weight < 0
constexpr unsigned kTilePosW = 128u;    // ... of weight > 0

// the flag of a weight's sign among (zero, neg, pos); a NaN weight counts as
// 0, whose term is NaN too
__device__ __forceinline__ unsigned weight_flag(float w, unsigned zero,
                                                unsigned neg, unsigned pos) {
  return w > 0.f ? pos : (w < 0.f ? neg : zero);
}

// rule 4: the infinite part of a row with weight wa whose infinite terms are
// +inf times the weights of one class of values, flagged in z by (zero, neg,
// pos): NaN if wa or one of those weights is 0, or if they have both signs;
// else an infinity of sign(wa) times their sign
__device__ __forceinline__ double signed_inf(float wa, unsigned z,
                                             unsigned zero, unsigned neg,
                                             unsigned pos) {
  if (!(wa > 0.f || wa < 0.f) || (z & zero) || ((z & neg) && (z & pos)))
    return __longlong_as_double(0x7FF8000000000000LL);
  const double inf = __longlong_as_double(0x7FF0000000000000LL);
  return ((z & neg) != 0) != (wa < 0.f) ? -inf : inf;
}

// a sorted slot's term of the sum mk * B: NaN and +inf slots hold +inf with
// weight 0 and add nothing (they lie in no prefix); a -inf slot adds
// mk * -inf, which is -inf, or NaN for mk = 0 (rule 4)
__device__ __forceinline__ double hinge_term(float wt, float v) {
  return wt == 0.f && v != -__int_as_float(0x7F800000)
             ? 0.0 : (double)wt * (double)v;
}

// grid (W, tiles), THREADS threads, dynamic shared memory: the sort's
// temporary storage, then (aliasing it) the sorted values [T] in Eytzinger
// order and the float64 prefix sums (sum mk, sum mk * B) [T + 1] over the
// sorted order. partials[w, tile] = the tile's part of S_w.
template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
hinge_kernel(const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ mp, const int64_t* __restrict__ ip,
             const int64_t* __restrict__ ia, const float* __restrict__ mk,
             double* __restrict__ partials, int64_t P, int64_t K, int64_t C,
             float margin) {
  constexpr int T = THREADS * ITEMS;
  constexpr int LOG_T = log2_of(T);
  const float kInf = __int_as_float(0x7F800000);
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  double2* pre = reinterpret_cast<double2*>(smem + 4 * (size_t)T);
  __shared__ double2 swarp[THREADS / 32];
  __shared__ double sred[THREADS / 32];
  __shared__ unsigned sflags;  // the tile's kTile* flags

  const int64_t w = blockIdx.x;
  const int64_t q = w / C;
  const int64_t col0 = (int64_t)blockIdx.y * T;
  const int64_t rem = K - col0;
  const int len = rem < T ? (int)rem : T;
  const float* bw = B + w * K + col0;
  const float* mkq = mk + q * K + col0;
  if (threadIdx.x == 0) sflags = 0u;
  unsigned keys[ITEMS];
  float wts[ITEMS];
  unsigned flags = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = r * THREADS + threadIdx.x;
    const bool in = i < len;
    const float v = in ? bw[i] : 0.f;
    keys[r] = in ? float_key(v) : kNanKey;
    wts[r] = in ? mkq[i] : 0.f;
    if (in) {
      if (v != v) flags |= kTileNan;
      else if (v == kInf) flags |= kTilePosInf;
      else {
        if (v == -kInf) flags |= kTileNegInf;
        flags |= weight_flag(wts[r], kTileZeroW, kTileNegW, kTilePosW);
      }
    }
  }
  __syncthreads();  // sflags is zeroed
  // a warp ORs its flags, then one lane adds them to the tile's (read after
  // the barrier below)
  flags = __reduce_or_sync(0xffffffffu, flags);
  if ((threadIdx.x & 31) == 0 && flags) atomicOr(&sflags, flags);
  // blocked result: this thread holds sorted positions [t ITEMS, t ITEMS + ITEMS)
  Sort(*reinterpret_cast<typename Sort::TempStorage*>(smem)).Sort(keys, wts);

  // NaN keys (NaN values and the padding) become +inf slots; +inf slots
  // carry no weight
  float vals[ITEMS];
  double tw = 0.0, ts = 0.0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    vals[r] = keys[r] == kNanKey ? kInf : key_float(keys[r]);
    if (vals[r] == kInf) wts[r] = 0.f;
    tw += (double)wts[r];
    ts += hinge_term(wts[r], vals[r]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double iw = tw, is = ts;  // inclusive over this warp's lanes up to this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double ow = __shfl_up_sync(0xffffffffu, iw, off);
    const double os = __shfl_up_sync(0xffffffffu, is, off);
    if (lane >= off) {
      iw += ow;
      is += os;
    }
  }
  if (lane == 31) swarp[warp] = make_double2(iw, is);
  __syncthreads();  // the sort is done with its storage: e, pre alias it
  const unsigned tile_flags = sflags;
  double rw = __shfl_up_sync(0xffffffffu, iw, 1);
  double rs = __shfl_up_sync(0xffffffffu, is, 1);
  if (lane == 0) rw = rs = 0.0;
  for (int v = 0; v < warp; ++v) {
    rw += swarp[v].x;
    rs += swarp[v].y;
  }
  const int base = threadIdx.x * ITEMS;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    pre[base + r] = make_double2(rw, rs);
    rw += (double)wts[r];
    rs += hinge_term(wts[r], vals[r]);
    e[eyt_slot<LOG_T>(base + r)] = vals[r];
  }
  if (threadIdx.x == THREADS - 1) pre[T] = make_double2(rw, rs);
  __syncthreads();

  const HingePositive pred{margin};
  const double dm = (double)margin;
  const float* aw = A + w * P;
  const float* mpq = mp + q * P;
  const int64_t* ipq = ip + q * P;
  const int64_t id = ia[w];
  const double dnan = __longlong_as_double(0x7FF8000000000000LL);
  double acc = 0.0;
  for (int64_t j0 = threadIdx.x; j0 < P; j0 += (int64_t)kIlp * THREADS) {
    float x[kIlp], wj[kIlp];
    int c[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int64_t j = j0 + (int64_t)u * THREADS;
      const bool in = j < P;
      x[u] = in ? aw[j] : 0.f;
      wj[u] = in && ipq[j] != id ? mpq[j] : 0.f;
    }
    prefix_counts<LOG_T>(e, x, c, pred);
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      if (j0 + (int64_t)u * THREADS >= P) continue;
      double inner;
      if (fabsf(x[u]) < kInf) {
        const double2 s = pre[c[u]];
        inner = (dm + (double)x[u]) * s.x - s.y;
      } else if (x[u] == kInf) {
        // wj's own sign and zero enter below, by the product
        inner = (tile_flags & kTilePosInf)
                    ? dnan
                    : signed_inf(1.f, tile_flags, kTileZeroW, kTileNegW,
                                 kTilePosW);
      } else if (x[u] == -kInf) {
        inner = (tile_flags & kTileNegInf) ? dnan : 0.0;
      } else {
        inner = dnan;
      }
      acc += (double)wj[u] * inner;
    }
  }
  acc = block_sum(acc, sred);
  if (threadIdx.x == 0)
    partials[w * gridDim.y + blockIdx.y] = (tile_flags & kTileNan) ? dnan : acc;
}

// ------------------------------------------------------------------------ //
// hinge gradient pair sums (kernels 3-4)                                   //
// ------------------------------------------------------------------------ //

// the threads of a gradient count block, by tile size, and the values of
// the searching side one block counts (kIlp in flight, kGradSweeps rounds;
// the pair sums' blocks, unmasked hinge and masked auc and hinge,
// kSumSweeps: with no col pass beside them, a tile loaded into a block's
// shared memory is searched by more values of a)
constexpr int kGradSweeps = 4;
constexpr int kSumSweeps = 32;
__host__ __device__ constexpr int grad_threads(int T) {
  return T <= 2048 ? 128 : 512;
}
__host__ __device__ constexpr int grad_chunk(int T) {
  return grad_threads(T) * kIlp * kGradSweeps;
}
__host__ __device__ constexpr int sum_chunk(int T) {
  return grad_threads(T) * kIlp * kSumSweeps;
}

// row pass, !(fl(a - b) < 1) with a tile of b: a prefix (rule 1), whose
// complement among the tile's values is the row's count
struct GradRowPrefix {
  __device__ __forceinline__ bool holds(float x, float s) const {
    return !(x - s < 1.f);
  }
};

// col pass, fl(a - b) < 1 with a tile of a (x = b): a prefix
struct GradColPrefix {
  __device__ __forceinline__ bool holds(float x, float s) const {
    return s - x < 1.f;
  }
};

// grid (tiles, W), THREADS threads, the sort's temporary storage as dynamic
// shared memory. Sorts a tile of v[w] and writes: its values in Eytzinger
// order (NaN values and padding as +inf slots after the others) to
// sorted[w, tile, 0:T]; info[w, tile] = (values that are not NaN, +inf
// values, kTileNan if a NaN, -inf values); with SUFFIX, suffix[w, tile, p]
// = the float64 sum of the finite values at sorted positions >= p (p <= T).
// It zeroes the counts of the tile's own values, counts[w, col0 + i], to
// which the other side's count launch (later on the stream) adds (counts
// null: no counts to zero).
template <int THREADS, int ITEMS, bool SUFFIX>
__global__ void __launch_bounds__(THREADS)
grad_sort_kernel(const float* __restrict__ v, float* __restrict__ sorted,
                 double* __restrict__ suffix, int4* __restrict__ info,
                 int* __restrict__ counts, int64_t n) {
  constexpr int T = THREADS * ITEMS;
  constexpr int LOG_T = log2_of(T);
  const float kInf = __int_as_float(0x7F800000);
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double swarp[THREADS / 32];
  __shared__ int scount[3];  // NaN, +inf, -inf values of the tile

  const int64_t tile = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int64_t col0 = (int64_t)blockIdx.x * T;
  const int64_t rem = n - col0;
  const int len = rem < T ? (int)rem : T;
  const float* src = v + (int64_t)blockIdx.y * n + col0;
  int* cnt = counts ? counts + (int64_t)blockIdx.y * n + col0 : nullptr;
  if (threadIdx.x < 3) scount[threadIdx.x] = 0;
  unsigned keys[ITEMS];
  int nnan = 0, npos = 0, nneg = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = r * THREADS + threadIdx.x;
    const bool in = i < len;
    const float x = in ? src[i] : 0.f;
    keys[r] = in ? float_key(x) : kNanKey;
    if (in && cnt) cnt[i] = 0;
    nnan += in && x != x;
    npos += in && x == kInf;
    nneg += in && x == -kInf;
  }
  __syncthreads();  // scount is zeroed
  // integer counts: the order of the adds does not matter
  if (nnan) atomicAdd(&scount[0], nnan);
  if (npos) atomicAdd(&scount[1], npos);
  if (nneg) atomicAdd(&scount[2], nneg);
  // blocked result: this thread holds sorted positions [t ITEMS, t ITEMS + ITEMS)
  Sort(*reinterpret_cast<typename Sort::TempStorage*>(smem)).Sort(keys);

  const int base = threadIdx.x * ITEMS;
  float* out = sorted + tile * T;
  float vals[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    vals[r] = keys[r] == kNanKey ? kInf : key_float(keys[r]);
    out[eyt_slot<LOG_T>(base + r)] = vals[r];
  }
  if (SUFFIX) {
    // NaN keys (NaN values, padding) are +inf slots and add 0, as do the
    // +inf and -inf values (the count kernel takes them by their counts)
    double tot = 0.0;
#pragma unroll
    for (int r = ITEMS - 1; r >= 0; --r)
      if (fabsf(vals[r]) < kInf) tot += (double)vals[r];
    double run = later_threads_sum(tot, swarp);
    double* sp = suffix + tile * (T + 1);
#pragma unroll
    for (int r = ITEMS - 1; r >= 0; --r) {
      if (fabsf(vals[r]) < kInf) run += (double)vals[r];
      sp[base + r] = run;
    }
    if (threadIdx.x == 0) sp[T] = 0.0;
  }
  __syncthreads();  // scount is complete
  if (threadIdx.x == 0)
    info[tile] = make_int4(len - scount[0], scount[1],
                           scount[0] ? (int)kTileNan : 0, scount[2]);
}

// the loss of one value x of a against a sorted tile of b: the sum over the
// tile of max(0, 1 - fl(x - b)) as the plain float32 terms summed in IEEE
// arithmetic give it (the hinge's rule 4 with margin 1 and unit weights):
//   * finite x: the terms that are not 0 are the suffix of the sorted tile
//     past p (the row pass's prefix), c (1 - x) + sum of that suffix, c its
//     length; a +inf in the tile gives d = -inf, a term of +inf; a -inf
//     gives d = +inf, a term of 0, and lies in the prefix;
//   * x = +inf: d = +inf (a term of 0) but NaN against a +inf;
//   * x = -inf: d = -inf (+inf) but NaN against a -inf;
//   * x NaN: NaN. A NaN in the tile makes the block's partial NaN.
__device__ __forceinline__ double hinge_grad_loss(float x, int p,
                                                  const int4& ti,
                                                  const double* suf) {
  const float kInf = __int_as_float(0x7F800000);
  const double dnan = __longlong_as_double(0x7FF8000000000000LL);
  const double dinf = __longlong_as_double(0x7FF0000000000000LL);
  if (fabsf(x) < kInf) {
    if (ti.y > 0) return dinf;
    return (double)(ti.x - p) * (1.0 - (double)x) + suf[p];
  }
  if (x == kInf) return ti.y > 0 ? dnan : 0.0;
  if (x == -kInf) return ti.w > 0 ? dnan : (ti.x > 0 ? dinf : 0.0);
  return dnan;
}

// grid (chunks of the searching side x, tiles of the other side, W),
// grad_threads(T) threads, dynamic shared memory: the sorted tile [T] and,
// for the row pass with the loss, its suffix sums [T + 1]. With COUNTS, adds
// each value's count over the tile to counts[w, i] (integer atomics, order-
// free): ROW, #{b : fl(x - b) < 1}; else #{a : fl(a - x) < 1}. The row pass
// with the loss writes one float64 partial a block: losspart[w, tile, chunk].
template <int LOG_T, bool ROW, bool WITH_LOSS, bool COUNTS>
__global__ void __launch_bounds__(grad_threads(1 << LOG_T))
grad_count_kernel(const float* __restrict__ x, const float* __restrict__ sorted,
                  const double* __restrict__ suffix,
                  const int4* __restrict__ info, int* __restrict__ counts,
                  double* __restrict__ losspart, int64_t n) {
  constexpr int T = 1 << LOG_T;
  constexpr int THREADS = grad_threads(T);
  constexpr int CHUNK = COUNTS ? grad_chunk(T) : sum_chunk(T);
  constexpr bool LOSS = ROW && WITH_LOSS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  double* suf = reinterpret_cast<double*>(smem + 4 * (size_t)T);
  __shared__ double swarp[THREADS / 32];

  const int64_t w = blockIdx.z;
  const int64_t tile = w * gridDim.y + blockIdx.y;
  const float4* src = reinterpret_cast<const float4*>(sorted + tile * T);
  for (int i = threadIdx.x; i < T / 4; i += THREADS)
    reinterpret_cast<float4*>(e)[i] = src[i];
  if (LOSS) {
    const double* sp = suffix + tile * (T + 1);
    for (int i = threadIdx.x; i <= T; i += THREADS) suf[i] = sp[i];
  }
  const int4 ti = info[tile];
  __syncthreads();

  const int nv = ti.x;
  const float* xw = x + w * n;
  int* cw = COUNTS ? counts + w * n : nullptr;
  const int64_t row0 = (int64_t)blockIdx.x * CHUNK;
  const int64_t end = n - row0 < CHUNK ? n : row0 + CHUNK;
  double acc = 0.0;
  for (int64_t r0 = row0 + threadIdx.x; r0 < end;
       r0 += (int64_t)kIlp * THREADS) {
    float xv[kIlp];
    int c[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int64_t r = r0 + (int64_t)u * THREADS;
      xv[u] = r < end ? xw[r] : 0.f;
    }
    if (ROW)
      prefix_counts<LOG_T>(e, xv, c, GradRowPrefix());
    else
      prefix_counts<LOG_T>(e, xv, c, GradColPrefix());
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int64_t r = r0 + (int64_t)u * THREADS;
      if (r >= end) continue;
      // the prefix never reaches past the tile's values into its +inf
      // slots except for x = +inf or NaN (row pass), whose count is 0
      const int p = c[u] < nv ? c[u] : nv;
      const int cnt = ROW ? nv - p : p;
      if (COUNTS && cnt) atomicAdd(cw + r, cnt);
      if (LOSS) acc += hinge_grad_loss(xv[u], p, ti, suf);
    }
  }
  if (LOSS) {
    acc = block_sum(acc, swarp);
    if (threadIdx.x == 0)
      losspart[tile * gridDim.x + blockIdx.x] =
          (ti.z & kTileNan) ? __longlong_as_double(0x7FF8000000000000LL)
                            : acc;
  }
}

// grid (ceil(max(n1, n2) / 256), W), 256 threads: row = -rowcnt, col =
// -colcnt as float32 (one rounding of an exact integer, as the plain
// version rounds its float64 sum of -1s), loss[w] = the sum of the nparts
// partials of problem w in a fixed order (loss null: no loss). The pair sum
// launches it with n1 = n2 = 0 on a grid (1, W): the loss alone.
__global__ void __launch_bounds__(256)
grad_finish_kernel(const int* __restrict__ rowcnt,
                   const int* __restrict__ colcnt,
                   const double* __restrict__ losspart,
                   float* __restrict__ row, float* __restrict__ col,
                   double* __restrict__ loss, int64_t n1, int64_t n2,
                   int nparts) {
  __shared__ double swarp[256 / 32];
  const int64_t w = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i < n1) row[w * n1 + i] = (float)(-rowcnt[w * n1 + i]);
  if (i < n2) col[w * n2 + i] = (float)(-colcnt[w * n2 + i]);
  if (loss != nullptr && blockIdx.x == 0) {
    const double* p = losspart + w * nparts;
    double s = 0.0;
    for (int q = threadIdx.x; q < nparts; q += 256) s += p[q];
    s = block_sum(s, swarp);
    if (threadIdx.x == 0) loss[w] = s;
  }
}

// ------------------------------------------------------------------------ //
// masked pair sums (kernel 2: auc and hinge bodies)                        //
// ------------------------------------------------------------------------ //

// more flags of a weighted tile of b (the pair hinge's rule 4): the signs of
// the weights of the finite and +inf values (which meet a = -inf with an
// infinite term) and of the +inf values (which meet a finite a so)
constexpr unsigned kTileUpZeroW = 16u;      // a finite or +inf value of weight 0
constexpr unsigned kTileUpNegW = 256u;      // ... of weight < 0
constexpr unsigned kTileUpPosW = 512u;      // ... of weight > 0
constexpr unsigned kTilePosInfZeroW = 32u;  // a +inf value of weight 0
constexpr unsigned kTilePosInfNegW = 1024u; // ... of weight < 0
constexpr unsigned kTilePosInfPosW = 2048u; // ... of weight > 0

// a tile's float64 suffix sums: auc the weights, hinge (weights, weights x
// values) side by side, one 16-byte load a search
template <bool HINGE>
using MaskedSum = typename std::conditional<HINGE, double2, double>::type;

// grid (tiles, W), THREADS threads, the sort's temporary storage as dynamic
// shared memory. Sorts a tile of b[w] with its weights mb[w] (CUB's block
// radix sort on (key, weight) pairs) and writes: its values in Eytzinger
// order, NaN values and padding as +inf slots after the others, to
// sorted[w, tile, 0:T]; suffix[w, tile, p] (p <= T) = the float64 sum over
// sorted positions >= p of the weights (auc: of every value that is not
// NaN) or of (weight, weight x value) of the finite values (hinge); NaN
// values and padding weigh 0. info[w, tile] = (values that are not NaN,
// +inf values, flags: kTileNan and the weight signs kTileUp*W and
// kTilePosInf*W, -inf values).
template <int THREADS, int ITEMS, bool HINGE>
__global__ void __launch_bounds__(THREADS)
masked_sort_kernel(const float* __restrict__ b, const float* __restrict__ mb,
                   float* __restrict__ sorted,
                   MaskedSum<HINGE>* __restrict__ suffix,
                   int4* __restrict__ info, int64_t n) {
  using S = MaskedSum<HINGE>;
  constexpr int T = THREADS * ITEMS;
  constexpr int LOG_T = log2_of(T);
  const float kInf = __int_as_float(0x7F800000);
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ S swarp[THREADS / 32];
  __shared__ int scount[4];  // NaN, +inf, -inf values; flags

  const int64_t tile = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int64_t col0 = (int64_t)blockIdx.x * T;
  const int64_t rem = n - col0;
  const int len = rem < T ? (int)rem : T;
  const float* src = b + (int64_t)blockIdx.y * n + col0;
  const float* wsrc = mb + (int64_t)blockIdx.y * n + col0;
  if (threadIdx.x < 4) scount[threadIdx.x] = 0;
  unsigned keys[ITEMS];
  float wts[ITEMS];
  int nnan = 0, npos = 0, nneg = 0;
  unsigned flags = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = r * THREADS + threadIdx.x;
    const bool in = i < len;
    const float x = in ? src[i] : 0.f;
    keys[r] = in ? float_key(x) : kNanKey;
    wts[r] = in ? wsrc[i] : 0.f;
    nnan += in && x != x;
    npos += in && x == kInf;
    nneg += in && x == -kInf;
    if (in && x == x && x != -kInf) {
      flags |= weight_flag(wts[r], kTileUpZeroW, kTileUpNegW, kTileUpPosW);
      if (x == kInf)
        flags |= weight_flag(wts[r], kTilePosInfZeroW, kTilePosInfNegW,
                             kTilePosInfPosW);
    }
  }
  __syncthreads();  // scount is zeroed
  // integer counts and flags: the order of the atomics does not matter;
  // nearly every thread holds a weight-sign flag, so a warp ORs its flags
  // first and one lane adds them to the tile's
  if (nnan) atomicAdd(&scount[0], nnan);
  if (npos) atomicAdd(&scount[1], npos);
  if (nneg) atomicAdd(&scount[2], nneg);
  flags = __reduce_or_sync(0xffffffffu, flags);
  if ((threadIdx.x & 31) == 0 && flags)
    atomicOr(reinterpret_cast<unsigned*>(&scount[3]), flags);
  // blocked result: this thread holds sorted positions [t ITEMS, t ITEMS + ITEMS)
  Sort(*reinterpret_cast<typename Sort::TempStorage*>(smem)).Sort(keys, wts);

  const int base = threadIdx.x * ITEMS;
  float* out = sorted + tile * T;
  // a sorted slot's part of the sums (recomputed, not kept: registers)
  auto part = [&](int r) -> S {
    const double wt = keys[r] == kNanKey ? 0.0 : (double)wts[r];
    if constexpr (HINGE) {
      // infinite values weigh 0 here: the search takes them by their counts
      const float v = key_float(keys[r]);
      return fabsf(v) < kInf ? make_double2(wt, wt * (double)v)
                             : make_double2(0.0, 0.0);
    } else {
      return wt;
    }
  };
  S tot = S();
#pragma unroll
  for (int r = ITEMS - 1; r >= 0; --r) {
    out[eyt_slot<LOG_T>(base + r)] =
        keys[r] == kNanKey ? kInf : key_float(keys[r]);
    tot = plus(tot, part(r));
  }
  S run = later_threads_sum(tot, swarp);
  S* sp = suffix + tile * (T + 1);
#pragma unroll
  for (int r = ITEMS - 1; r >= 0; --r) {
    run = plus(run, part(r));
    sp[base + r] = run;
  }
  if (threadIdx.x == 0) sp[T] = S();
  __syncthreads();  // scount is complete
  if (threadIdx.x == 0)
    info[tile] = make_int4(len - scount[0], scount[1],
                           (int)((scount[0] ? kTileNan : 0u) |
                                 (unsigned)scount[3]),
                           scount[2]);
}

// the hinge's row of one value x of a with weight wa against a sorted,
// weighted tile of b: sum_j max(0, 1 - fl(x - b_j)) * mb_j * wa as the
// plain float32 terms summed in IEEE arithmetic give it (rule 4 read for
// the pair hinge max(0, 1 - a + b) ma mb, with finite weights of either
// sign; signed_inf gives an infinite part):
//   * finite x: the terms that are not 0 are those of the suffix of the
//     sorted tile past p (the prefix where !(fl(x - b) < 1)), wa ((1 - x) W
//     + S) with W, S the suffix sums of mb and mb b; a +inf b gives d = -inf,
//     a term of +inf times its weight and wa, so the infinite part of the
//     +inf values' weights; a -inf b gives d = +inf, a term of 0, and lies
//     in the prefix;
//   * x = +inf: d = +inf (a term of 0) but NaN against a +inf;
//   * x = -inf: d = -inf, a term of +inf times the weights, so the infinite
//     part of the finite and +inf values' weights, but NaN against a -inf;
//   * x NaN: NaN. A NaN in the tile makes the block's partial NaN.
__device__ __forceinline__ double masked_hinge_row(float x, float wa, int p,
                                                   const int4& ti,
                                                   const double2* suf) {
  const float kInf = __int_as_float(0x7F800000);
  const double dnan = __longlong_as_double(0x7FF8000000000000LL);
  const unsigned z = (unsigned)ti.z;
  if (fabsf(x) < kInf) {
    if (ti.y > 0)
      return signed_inf(wa, z, kTilePosInfZeroW, kTilePosInfNegW,
                        kTilePosInfPosW);
    const double2 s = suf[p];
    return (double)wa * ((1.0 - (double)x) * s.x + s.y);
  }
  if (x == kInf) return ti.y > 0 ? dnan : 0.0;
  if (x == -kInf)
    return ti.w > 0 ? dnan
                    : signed_inf(wa, z, kTileUpZeroW, kTileUpNegW,
                                 kTileUpPosW);
  return dnan;
}

// grid (chunks of a, tiles of b, W), grad_threads(T) threads, dynamic
// shared memory: the sorted tile [T] and its suffix sums [T + 1].
// partials[w, tile, chunk] = the float64 sum over the chunk's a_i of the
// tile's part of row i, weighted by ma_i:
//   auc: ma_i (P_gt + (P_ge - P_gt) / 2), P_gt and P_ge the weights of the b
//        with fl(a_i - b) > 0 and >= 0 (two searches with the body's
//        predicates, the second only where a_i ties the next value);
//   hinge: masked_hinge_row, after one search with !(fl(a_i - b) < 1).
template <int LOG_T, bool HINGE>
__global__ void __launch_bounds__(grad_threads(1 << LOG_T))
masked_search_kernel(const float* __restrict__ a, const float* __restrict__ ma,
                     const float* __restrict__ sorted,
                     const MaskedSum<HINGE>* __restrict__ suffix,
                     const int4* __restrict__ info,
                     double* __restrict__ partials, int64_t n1) {
  using S = MaskedSum<HINGE>;
  constexpr int T = 1 << LOG_T;
  constexpr int THREADS = grad_threads(T);
  constexpr int CHUNK = sum_chunk(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  S* suf = reinterpret_cast<S*>(smem + 4 * (size_t)T);
  __shared__ double swarp[THREADS / 32];

  const int64_t w = blockIdx.z;
  const int64_t tile = w * gridDim.y + blockIdx.y;
  const float4* src = reinterpret_cast<const float4*>(sorted + tile * T);
  for (int i = threadIdx.x; i < T / 4; i += THREADS)
    reinterpret_cast<float4*>(e)[i] = src[i];
  const S* sp = suffix + tile * (T + 1);
  for (int i = threadIdx.x; i <= T; i += THREADS) suf[i] = sp[i];
  const int4 ti = info[tile];
  __syncthreads();

  const float* aw = a + w * n1;
  const float* mw = ma + w * n1;
  const int64_t row0 = (int64_t)blockIdx.x * CHUNK;
  const int64_t end = n1 - row0 < CHUNK ? n1 : row0 + CHUNK;
  double acc = 0.0;
  for (int64_t r0 = row0 + threadIdx.x; r0 < end;
       r0 += (int64_t)kIlp * THREADS) {
    // a slot past the end searches NaN with weight 0, which adds 0 to the
    // auc and is skipped by the hinge
    float x[kIlp], wa[kIlp];
    int c[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int64_t r = r0 + (int64_t)u * THREADS;
      x[u] = r < end ? aw[r] : __int_as_float(0x7FFFFFFF);
      wa[u] = r < end ? mw[r] : 0.f;
    }
    if constexpr (HINGE) {
      prefix_counts<LOG_T>(e, x, c, GradRowPrefix());
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        if (r0 + (int64_t)u * THREADS < end)
          acc += masked_hinge_row(x[u], wa[u], c[u], ti, suf);
    } else {
      int upto[kIlp];
      auc_counts<LOG_T>(e, x, c, upto);
      // P_gt + (P_ge - P_gt) / 2 = suf[0] - (suf[gt] + suf[ge]) / 2: an
      // integer or a half, exactly, for weights in {0, 1}
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        acc += (double)wa[u] * (suf[0] - 0.5 * (suf[c[u]] + suf[upto[u]]));
    }
  }
  acc = block_sum(acc, swarp);
  if (threadIdx.x == 0)
    partials[tile * gridDim.x + blockIdx.x] =
        HINGE && (ti.z & kTileNan) ? __longlong_as_double(0x7FF8000000000000LL)
                                   : acc;
}

template <int THREADS, int ITEMS>
int launch_auc(const float* a, const float* b, float* sorted,
               long long* partials, long long n1, long long n2, int w,
               cudaStream_t s) {
  constexpr int T = THREADS * ITEMS;
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS>;
  const int sort_smem = (int)sizeof(typename Sort::TempStorage);
  const int count_smem = 4 * T;
  cudaError_t err = cudaFuncSetAttribute(
      sort_tiles_kernel<THREADS, ITEMS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sort_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(auc_count_kernel<log2_of(T)>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               count_smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((n2 + T - 1) / T);
  const unsigned chunks = (unsigned)((n1 + kCountChunk - 1) / kCountChunk);
  sort_tiles_kernel<THREADS, ITEMS>
      <<<dim3(tiles, (unsigned)w), THREADS, sort_smem, s>>>(b, sorted, n2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auc_count_kernel<log2_of(T)>
      <<<dim3(chunks, tiles, (unsigned)w), kCountThreads, count_smem, s>>>(
          a, sorted, partials, n1);
  return (int)cudaGetLastError();
}

template <int THREADS, int ITEMS>
int launch_indicator(const float* A, const float* B, const float* mp,
                     const int64_t* ip, const int64_t* ia, const float* mk,
                     double* partials, long long P, long long K, long long W,
                     long long C, float margin, cudaStream_t s) {
  constexpr int T = THREADS * ITEMS;
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, float>;
  const size_t need = 12 * (size_t)T + 8;
  const int smem = (int)(sizeof(typename Sort::TempStorage) > need
                             ? sizeof(typename Sort::TempStorage) : need);
  cudaError_t err = cudaFuncSetAttribute(
      indicator_kernel<THREADS, ITEMS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((K + T - 1) / T);
  indicator_kernel<THREADS, ITEMS><<<dim3((unsigned)W, tiles), THREADS, smem, s>>>(
      A, B, mp, ip, ia, mk, partials, P, K, C, margin);
  return (int)cudaGetLastError();
}

template <int THREADS, int ITEMS>
int launch_hinge(const float* A, const float* B, const float* mp,
                 const int64_t* ip, const int64_t* ia, const float* mk,
                 double* partials, long long P, long long K, long long W,
                 long long C, float margin, cudaStream_t s) {
  constexpr int T = THREADS * ITEMS;
  static_assert(T <= kHingeMaxTile, "the hinge tile must fit shared memory");
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, float>;
  const size_t need = 4 * (size_t)T + 16 * ((size_t)T + 1);
  const int smem = (int)(sizeof(typename Sort::TempStorage) > need
                             ? sizeof(typename Sort::TempStorage) : need);
  cudaError_t err = cudaFuncSetAttribute(
      hinge_kernel<THREADS, ITEMS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((K + T - 1) / T);
  hinge_kernel<THREADS, ITEMS><<<dim3((unsigned)W, tiles), THREADS, smem, s>>>(
      A, B, mp, ip, ia, mk, partials, P, K, C, margin);
  return (int)cudaGetLastError();
}

// sorts the tiles of v [W, n] (tiles of T = THREADS * ITEMS values)
template <int THREADS, int ITEMS>
int launch_grad_sort(bool with_suffix, const float* v, float* sorted,
                     double* suffix, int4* info, int* counts, long long n,
                     int w, cudaStream_t s) {
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS>;
  const int smem = (int)sizeof(typename Sort::TempStorage);
  auto kern = with_suffix ? &grad_sort_kernel<THREADS, ITEMS, true>
                          : &grad_sort_kernel<THREADS, ITEMS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((n + THREADS * ITEMS - 1) / (THREADS * ITEMS));
  kern<<<dim3(tiles, (unsigned)w), THREADS, smem, s>>>(v, sorted, suffix,
                                                        info, counts, n);
  return (int)cudaGetLastError();
}

// counts the n values of x [W, n] against the sorted tiles of the other
// side (tiles of T values); counts null: the row pass's loss alone
template <int LOG_T>
int launch_grad_count(bool row, bool with_loss, const float* x,
                      const float* sorted, const double* suffix,
                      const int4* info, int* counts, double* losspart,
                      long long n, long long n_other, int w, cudaStream_t s) {
  constexpr int T = 1 << LOG_T;
  const bool loss = row && with_loss;
  const int smem = 4 * T + (loss ? 8 * (T + 1) : 0);
  if (!counts && !loss) return (int)cudaErrorInvalidValue;
  auto kern = !counts ? &grad_count_kernel<LOG_T, true, true, false>
              : loss  ? &grad_count_kernel<LOG_T, true, true, true>
              : row   ? &grad_count_kernel<LOG_T, true, false, true>
                      : &grad_count_kernel<LOG_T, false, false, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int chunk = counts ? grad_chunk(T) : sum_chunk(T);
  const unsigned chunks = (unsigned)((n + chunk - 1) / chunk);
  const unsigned tiles = (unsigned)((n_other + T - 1) / T);
  kern<<<dim3(chunks, tiles, (unsigned)w), grad_threads(T), smem, s>>>(
      x, sorted, suffix, info, counts, losspart, n);
  return (int)cudaGetLastError();
}

int grad_sort(int T, bool with_suffix, const float* v, float* sorted,
              double* suffix, int4* info, int* counts, long long n, int w,
              cudaStream_t s) {
  switch (T) {
    case 256: return launch_grad_sort<128, 2>(with_suffix, v, sorted, suffix, info, counts, n, w, s);
    case 2048: return launch_grad_sort<256, 8>(with_suffix, v, sorted, suffix, info, counts, n, w, s);
    case 8192: return launch_grad_sort<1024, 8>(with_suffix, v, sorted, suffix, info, counts, n, w, s);
    case 16384: return launch_grad_sort<1024, 16>(with_suffix, v, sorted, suffix, info, counts, n, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int grad_count(int T, bool row, bool with_loss, const float* x,
               const float* sorted, const double* suffix, const int4* info,
               int* counts, double* losspart, long long n, long long n_other,
               int w, cudaStream_t s) {
  switch (T) {
    case 256: return launch_grad_count<8>(row, with_loss, x, sorted, suffix, info, counts, losspart, n, n_other, w, s);
    case 2048: return launch_grad_count<11>(row, with_loss, x, sorted, suffix, info, counts, losspart, n, n_other, w, s);
    case 8192: return launch_grad_count<13>(row, with_loss, x, sorted, suffix, info, counts, losspart, n, n_other, w, s);
    case 16384: return launch_grad_count<14>(row, with_loss, x, sorted, suffix, info, counts, losspart, n, n_other, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// masked pair sum: sorts the tiles of b (T = THREADS * ITEMS values each)
// with their weights, searches each a against every tile and sums each
// problem's partials in a fixed order into out [W]: three launches
template <int THREADS, int ITEMS, bool HINGE>
int launch_masked(const float* a, const float* b, const float* ma,
                  const float* mb, float* sorted, MaskedSum<HINGE>* suffix,
                  int4* info, double* partials, double* out, long long n1,
                  long long n2, int w, cudaStream_t s) {
  constexpr int T = THREADS * ITEMS;
  constexpr int LOG_T = log2_of(T);
  static_assert(!HINGE || T <= kHingeMaxTile,
                "the hinge tile and its sums must fit shared memory");
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, float>;
  const int sort_smem = (int)sizeof(typename Sort::TempStorage);
  const int search_smem = 4 * T + (int)sizeof(MaskedSum<HINGE>) * (T + 1);
  cudaError_t err = cudaFuncSetAttribute(
      masked_sort_kernel<THREADS, ITEMS, HINGE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sort_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(masked_search_kernel<LOG_T, HINGE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               search_smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((n2 + T - 1) / T);
  const unsigned chunks = (unsigned)((n1 + sum_chunk(T) - 1) / sum_chunk(T));
  masked_sort_kernel<THREADS, ITEMS, HINGE>
      <<<dim3(tiles, (unsigned)w), THREADS, sort_smem, s>>>(b, mb, sorted,
                                                             suffix, info, n2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  masked_search_kernel<LOG_T, HINGE>
      <<<dim3(chunks, tiles, (unsigned)w), grad_threads(T), search_smem, s>>>(
          a, ma, sorted, suffix, info, partials, n1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_finish_kernel<<<dim3(1, (unsigned)w), 256, 0, s>>>(
      nullptr, nullptr, partials, nullptr, nullptr, out, 0, 0,
      (int)(tiles * chunks));
  return (int)cudaGetLastError();
}

template <bool HINGE>
int masked_sum(int T, const float* a, const float* b, const float* ma,
               const float* mb, float* sorted, MaskedSum<HINGE>* suffix,
               int4* info, double* partials, double* out, long long n1,
               long long n2, int w, cudaStream_t s) {
  switch (T) {
    case 256: return launch_masked<128, 2, HINGE>(a, b, ma, mb, sorted, suffix, info, partials, out, n1, n2, w, s);
    case 2048: return launch_masked<256, 8, HINGE>(a, b, ma, mb, sorted, suffix, info, partials, out, n1, n2, w, s);
    case 8192: return launch_masked<1024, 8, HINGE>(a, b, ma, mb, sorted, suffix, info, partials, out, n1, n2, w, s);
    case 16384:
      // the hinge's tile and its (W, S) sums would need 4 + 16 bytes a
      // value, 320 KB: beyond a block's shared memory
      if constexpr (HINGE) return (int)cudaErrorInvalidValue;
      else return launch_masked<1024, 16, HINGE>(a, b, ma, mb, sorted, suffix, info, partials, out, n1, n2, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int tw_rank_max_tile() { return kMaxTile; }
int tw_rank_min_tile() { return kMinTile; }
int tw_rank_hinge_max_tile() { return kHingeMaxTile; }
int tw_rank_count_chunk() { return kCountChunk; }

// auc: launches sort_tiles_kernel, then auc_count_kernel, on `stream`, and
// returns the first nonzero cuda error. a [W, n1] and b [W, n2] are
// contiguous float32 on the device; sorted holds W * tiles * T float32 and
// partials W * tiles * ceil(n1 / kCountChunk) int64, with tiles =
// ceil(n2 / T). T is 2048, 4096, 8192 or 16384 (any other returns
// cudaErrorInvalidValue); the wrapper checks every argument and the grid
// limits.
int tw_rank_auc(const void* a, const void* b, void* sorted, void* partials,
                long long n1, long long n2, int w, int T, void* stream) {
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto fs = static_cast<float*>(sorted);
  auto out = static_cast<long long*>(partials);
  auto s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 2048: return launch_auc<256, 8>(fa, fb, fs, out, n1, n2, w, s);
    case 4096: return launch_auc<512, 8>(fa, fb, fs, out, n1, n2, w, s);
    case 8192: return launch_auc<1024, 8>(fa, fb, fs, out, n1, n2, w, s);
    case 16384: return launch_auc<1024, 16>(fa, fb, fs, out, n1, n2, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// indicator: launches indicator_kernel on `stream` and returns
// cudaGetLastError(). A [W, P], B [W, K] float32; mp [W/C, P] float32,
// ip [W/C, P] int64, ia [W] int64, mk [W/C, K] float32; all contiguous on
// the device. partials holds W * ceil(K / T) float64. T as for tw_rank_auc.
int tw_rank_indicator(const void* A, const void* B, const void* mp,
                      const void* ip, const void* ia, const void* mk,
                      void* partials, long long P, long long K, long long W,
                      long long C, float margin, int T, void* stream) {
  auto fA = static_cast<const float*>(A);
  auto fB = static_cast<const float*>(B);
  auto fmp = static_cast<const float*>(mp);
  auto iip = static_cast<const int64_t*>(ip);
  auto iia = static_cast<const int64_t*>(ia);
  auto fmk = static_cast<const float*>(mk);
  auto out = static_cast<double*>(partials);
  auto s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 2048:
      return launch_indicator<256, 8>(fA, fB, fmp, iip, iia, fmk, out, P, K,
                                      W, C, margin, s);
    case 4096:
      return launch_indicator<512, 8>(fA, fB, fmp, iip, iia, fmk, out, P, K,
                                      W, C, margin, s);
    case 8192:
      return launch_indicator<1024, 8>(fA, fB, fmp, iip, iia, fmk, out, P, K,
                                       W, C, margin, s);
    case 16384:
      return launch_indicator<1024, 16>(fA, fB, fmp, iip, iia, fmk, out, P, K,
                                        W, C, margin, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// hinge: launches hinge_kernel on `stream` and returns cudaGetLastError().
// Arguments as for tw_rank_indicator; T is 2048, 4096 or 8192
// (kHingeMaxTile).
int tw_rank_hinge(const void* A, const void* B, const void* mp,
                  const void* ip, const void* ia, const void* mk,
                  void* partials, long long P, long long K, long long W,
                  long long C, float margin, int T, void* stream) {
  auto fA = static_cast<const float*>(A);
  auto fB = static_cast<const float*>(B);
  auto fmp = static_cast<const float*>(mp);
  auto iip = static_cast<const int64_t*>(ip);
  auto iia = static_cast<const int64_t*>(ia);
  auto fmk = static_cast<const float*>(mk);
  auto out = static_cast<double*>(partials);
  auto s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 2048:
      return launch_hinge<256, 8>(fA, fB, fmp, iip, iia, fmk, out, P, K, W,
                                  C, margin, s);
    case 4096:
      return launch_hinge<512, 8>(fA, fB, fmp, iip, iia, fmk, out, P, K, W,
                                  C, margin, s);
    case 8192:
      return launch_hinge<1024, 8>(fA, fB, fmp, iip, iia, fmk, out, P, K, W,
                                   C, margin, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the values of the searching side one gradient count block takes, for a
// tile of T values of the other side (0 for a T the route does not build)
int tw_rank_grad_chunk(int T) {
  return T == 256 || T == 2048 || T == 8192 || T == 16384 ? grad_chunk(T) : 0;
}

// hinge gradient sums: sorts the tiles of a (Ta values each) and of b (Tb,
// with float64 suffix sums when with_loss), zeroing the counts as it goes,
// counts each a against b's tiles (and sums the loss) and each b against
// a's tiles, then writes row, col (and loss) on `stream`: five launches;
// returns the first nonzero cuda error. a [W, n1], b [W, n2] contiguous float32 on the device.
// Scratch, from the wrapper: sorted_a [W, ta, Ta] and sorted_b [W, tb, Tb]
// float32, suffix_b [W, tb, Tb + 1] float64 (with_loss only), info_a
// [W, ta] and info_b [W, tb] int4, rowcnt [W, n1] and colcnt [W, n2] int32,
// losspart [W, tb, ceil(n1 / tw_rank_grad_chunk(Tb))] float64 (with_loss
// only), where ta = ceil(n1 / Ta) and tb = ceil(n2 / Tb). Outputs: row
// [W, n1], col [W, n2] float32, loss [W] float64 (with_loss only; null
// otherwise). Ta and Tb are 256, 2048, 8192 or 16384.
int tw_rank_hinge_grad(const void* a, const void* b, void* sorted_a,
                       void* sorted_b, void* suffix_b, void* info_a,
                       void* info_b, void* rowcnt, void* colcnt,
                       void* losspart, void* row, void* col, void* loss,
                       long long n1, long long n2, int w, int Ta, int Tb,
                       int with_loss, void* stream) {
  if (!tw_rank_grad_chunk(Ta) || !tw_rank_grad_chunk(Tb))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto sa = static_cast<float*>(sorted_a);
  auto sb = static_cast<float*>(sorted_b);
  auto suf = static_cast<double*>(suffix_b);
  auto ia = static_cast<int4*>(info_a);
  auto ib = static_cast<int4*>(info_b);
  auto rc = static_cast<int*>(rowcnt);
  auto cc = static_cast<int*>(colcnt);
  auto lp = static_cast<double*>(losspart);
  const bool wl = with_loss != 0;
  int err = grad_sort(Ta, false, fa, sa, nullptr, ia, rc, n1, w, s);
  if (!err) err = grad_sort(Tb, wl, fb, sb, suf, ib, cc, n2, w, s);
  if (!err) err = grad_count(Tb, true, wl, fa, sb, suf, ib, rc, lp, n1, n2, w, s);
  if (!err) err = grad_count(Ta, false, false, fb, sa, nullptr, ia, cc, nullptr, n2, n1, w, s);
  if (err) return err;
  const long long nmax = n1 > n2 ? n1 : n2;
  const int nparts = (int)(((n2 + Tb - 1) / Tb) *
                           ((n1 + grad_chunk(Tb) - 1) / grad_chunk(Tb)));
  grad_finish_kernel<<<dim3((unsigned)((nmax + 255) / 256), (unsigned)w), 256,
                       0, s>>>(rc, cc, wl ? lp : nullptr,
                               static_cast<float*>(row),
                               static_cast<float*>(col),
                               wl ? static_cast<double*>(loss) : nullptr, n1,
                               n2, nparts);
  return (int)cudaGetLastError();
}

// the values of a one pair-sum block takes, for a tile of T values of b (0
// for a T the route does not build)
int tw_rank_sum_chunk(int T) {
  return tw_rank_grad_chunk(T) ? sum_chunk(T) : 0;
}

// hinge pair sum (kernel 1, unmasked): sorts the tiles of b (Tb values each)
// with float64 suffix sums, sums each a's loss against every tile into one
// float64 partial a block, then sums each problem's partials in a fixed
// order into loss [W] float64, on `stream`: three launches; returns the
// first nonzero cuda error. a [W, n1], b [W, n2] contiguous float32 on the
// device. Scratch, from the wrapper: sorted_b [W, tb, Tb] float32, suffix_b
// [W, tb, Tb + 1] float64, info_b [W, tb] int4, losspart [W, tb,
// ceil(n1 / tw_rank_sum_chunk(Tb))] float64, tb = ceil(n2 / Tb). Tb as
// for tw_rank_hinge_grad.
int tw_rank_hinge_sum(const void* a, const void* b, void* sorted_b,
                      void* suffix_b, void* info_b, void* losspart,
                      void* loss, long long n1, long long n2, int w, int Tb,
                      void* stream) {
  if (!tw_rank_grad_chunk(Tb)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto sb = static_cast<float*>(sorted_b);
  auto suf = static_cast<double*>(suffix_b);
  auto ib = static_cast<int4*>(info_b);
  auto lp = static_cast<double*>(losspart);
  int err = grad_sort(Tb, true, static_cast<const float*>(b), sb, suf, ib,
                      nullptr, n2, w, s);
  if (!err) err = grad_count(Tb, true, true, static_cast<const float*>(a), sb,
                             suf, ib, nullptr, lp, n1, n2, w, s);
  if (err) return err;
  const int nparts = (int)(((n2 + Tb - 1) / Tb) *
                           ((n1 + sum_chunk(Tb) - 1) / sum_chunk(Tb)));
  grad_finish_kernel<<<dim3(1, (unsigned)w), 256, 0, s>>>(
      nullptr, nullptr, lp, nullptr, nullptr, static_cast<double*>(loss), 0,
      0, nparts);
  return (int)cudaGetLastError();
}

// masked pair sum (kernel 2, auc and hinge bodies): sorts the tiles of b (T
// values each) with their weights mb, sums each a_i's weighted row against
// every tile into one float64 partial a block, then sums each problem's
// partials in a fixed order into out [W] float64, on `stream`: three
// launches; returns the first nonzero cuda error. a, ma [W, n1] and b, mb
// [W, n2] contiguous float32 on the device, the weights finite, of either
// sign. Scratch, from the wrapper: sorted_b [W, tb, T] float32,
// suffix_b [W, tb, T + 1] float64 (auc) or double2 (hinge), info_b [W, tb]
// int4, partials [W, tb, ceil(n1 / tw_rank_sum_chunk(T))] float64, tb =
// ceil(n2 / T). T is 256, 2048, 8192 or (auc only) 16384.
int tw_rank_masked_sum(const void* a, const void* b, const void* ma,
                       const void* mb, void* sorted_b, void* suffix_b,
                       void* info_b, void* partials, void* out, long long n1,
                       long long n2, int w, int T, int hinge, void* stream) {
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto fma = static_cast<const float*>(ma);
  auto fmb = static_cast<const float*>(mb);
  auto sb = static_cast<float*>(sorted_b);
  auto ib = static_cast<int4*>(info_b);
  auto lp = static_cast<double*>(partials);
  auto o = static_cast<double*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (hinge)
    return masked_sum<true>(T, fa, fb, fma, fmb, sb,
                            static_cast<double2*>(suffix_b), ib, lp, o, n1,
                            n2, w, s);
  return masked_sum<false>(T, fa, fb, fma, fmb, sb,
                           static_cast<double*>(suffix_b), ib, lp, o, n1, n2,
                           w, s);
}

}  // extern "C"
