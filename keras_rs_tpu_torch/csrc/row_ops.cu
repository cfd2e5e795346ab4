// Row kernels of the embedding update, for the packed and the split state.
//
// 1. apply_scatter_row_blocks_kernel: fused optimizer-apply + row-block
//    scatter for the packed state. Replaces
//    keras_rs_tpu/ops/row_ops.py::_make_rmw_kernel (the Pallas kernel behind
//    apply_scatter_row_blocks), which the sharded lookup's backward pass runs
//    once per stack per training step (lookup.py:392-423).
// 2. scatter_rows_kernel: a plain k-stream row scatter. Replaces three Pallas
//    kernels of the same file, which are one function on this card:
//      _scatter_kernel    (scatter_rows, B3):        table[idx[i]] = rows[i]
//      _make_multi_kernel (_scatter_rows_multi, B4): the same for k arrays
//                                                    sharing one idx
//      _block_kernel      (scatter_row_blocks, B2):  packed[idx[i]] = blk[i],
//                                                    a [k, dim] row group
//    See the section comment above scatter_rows_kernel.
// 3. apply_split_rows_kernel: the split layout's update of a bf16 table
//    (gather, row-wise Adagrad, stochastic rounding with Philox bits) into a
//    [n, dim] buffer that scatter_rows_kernel then writes back. It replaces
//    no Pallas kernel: the JAX package leaves this chain to XLA
//    (lookup.py:448-523). See the section comment above it.
//
// ---------------------------------------------------------------------------
// 1. Fused apply + block scatter.
//
// What it computes, for every live position i < n_valid:
//   blk = packed[idx[i]]                  // [K, dim]: table row + K-1 slots
//   packed[idx[i]] = Op(blk, grads[i])    // in place
// n_valid is read from device memory, so the caller never syncs with the
// host. Positions past n_valid (the sink padding of the dedup list) are
// skipped. The caller must keep every live index inside [0, num_rows), as
// the lookup's dedup list always does; an index outside it is skipped, so a
// broken caller loses that update instead of writing out of bounds.
//
// The TPU path gathers the blocks in a separate XLA op before the kernel
// (lookup.py:371-378); here each warp reads its own block. That is safe
// because the live prefix of idx holds no duplicates, so no two warps touch
// the same row.
//
// Bound: HBM bytes. Per live row the kernel reads K*dim*4 bytes of state,
// dim*4 of gradient and 4 of index, and writes K*dim*4: about 2.5 KB at
// K = 2 (Adagrad), dim = 128, against a handful of flops per element.
// Design: one warp per row; at dim 128 each lane moves exactly one float4 of
// every state row and of the gradient, so every warp access is one fully
// coalesced 512-byte line and each block is read and written once. No
// shared memory, no tensor cores: there is nothing to reuse.
//
// Numerics: built with -fmad=false and IEEE sqrt/div (no fast-math), so
// each operation rounds once in the same order as the plain PyTorch
// version (optimizers.py apply).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// w -= lr * g
struct Sgd {
  static constexpr int kRows = 1;
  float lr;
  __device__ __forceinline__ void operator()(float& w, float* /*slots*/,
                                             float g, float /*step*/) const {
    w = w - lr * g;
  }
};

// acc += g^2; w -= lr * g / (sqrt(acc) + eps)
struct Adagrad {
  static constexpr int kRows = 2;
  float lr;
  float eps;
  __device__ __forceinline__ void operator()(float& w, float* slots, float g,
                                             float /*step*/) const {
    const float acc = slots[0] + g * g;
    const float update = g / (sqrtf(acc) + eps);
    slots[0] = acc;
    w = w - lr * update;
  }
};

template <class Op>
__global__ void apply_scatter_row_blocks_kernel(
    float* __restrict__ packed, const int32_t* __restrict__ idx,
    const float* __restrict__ grads, const float* __restrict__ scalars,
    const int32_t* __restrict__ n_valid, int64_t num_rows, int64_t n,
    int dim, Op op, int lr_index) {
  constexpr int K = Op::kRows;
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  int64_t live = *n_valid;
  live = live < 0 ? 0 : (live > n ? n : live);
  if (i >= live) return;
  const int64_t r = idx[i];
  if (r < 0 || r >= num_rows) return;
  float* blk = packed + r * K * dim;
  const float* g = grads + i * dim;
  const float step = scalars[0];
  // A learning-rate schedule evaluated on the device: read it here.
  if (lr_index >= 0) op.lr = scalars[lr_index];
  for (int c = lane * 4; c < dim; c += 128) {
    const float4 gv = *reinterpret_cast<const float4*>(g + c);
    float4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = *reinterpret_cast<const float4*>(blk + k * dim + c);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float w = reinterpret_cast<float*>(&v[0])[j];
      float slots[K > 1 ? K - 1 : 1];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        slots[k - 1] = reinterpret_cast<float*>(&v[k])[j];
      }
      op(w, slots, reinterpret_cast<const float*>(&gv)[j], step);
      reinterpret_cast<float*>(&v[0])[j] = w;
#pragma unroll
      for (int k = 1; k < K; ++k) {
        reinterpret_cast<float*>(&v[k])[j] = slots[k - 1];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      *reinterpret_cast<float4*>(blk + k * dim + c) = v[k];
    }
  }
}

constexpr int kThreads = 256;  // 8 warps, one row each
constexpr int kUnsupported = -1;

template <class Op>
int launch(float* packed, const int32_t* idx, const float* grads,
           const float* scalars, const int32_t* n_valid, int64_t num_rows,
           int64_t n, int dim, Op op, int lr_index, cudaStream_t stream) {
  const int64_t rows_per_block = kThreads / 32;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return kUnsupported;
  apply_scatter_row_blocks_kernel<Op>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          packed, idx, grads, scalars, n_valid, num_rows, n, dim, op,
          lr_index);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// optimizer: 0 = Adagrad (k must be 2), 1 = SGD (k must be 1).
// lr_index: -1 takes `lr`; else the rate is scalars[lr_index], written on
// the device (a learning-rate schedule), and `lr` is ignored.
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// (optimizer, k) pair or grid size; 0 means launched.
extern "C" int krt_apply_scatter_row_blocks(
    void* packed, const void* idx, const void* grads, const void* scalars,
    const void* n_valid, long long num_rows, long long n, int k, int dim,
    int optimizer, float lr, int lr_index, float eps, void* stream) {
  if (n <= 0) return 0;
  float* p = static_cast<float*>(packed);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* g = static_cast<const float*>(grads);
  const float* sc = static_cast<const float*>(scalars);
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (optimizer == 0 && k == Adagrad::kRows) {
    return launch(p, ix, g, sc, nv, num_rows, n, dim, Adagrad{lr, eps},
                  lr_index, s);
  }
  if (optimizer == 1 && k == Sgd::kRows) {
    return launch(p, ix, g, sc, nv, num_rows, n, dim, Sgd{lr}, lr_index,
                  s);
  }
  return kUnsupported;
}

// ---------------------------------------------------------------------------
// 2. Row scatter (B2, B3, B4 as one kernel).
//
// What it computes, for every stream s < k and every live position
// i < n_valid (n_valid null: all N):
//   dst[s][idx[i]] = src[s][i]            // one row of row_bytes[s] bytes
// A row is everything after the leading dimension, so a packed [R, k, dim]
// state is one stream whose rows are [k, dim] groups (B2), a [R, dim] table
// is one stream (B3), and a table with its optimizer slots is k streams of
// possibly different widths and types sharing one idx (B4). Positions past
// n_valid and indices outside [0, num_rows) are skipped; n_valid is read on
// the device, so the caller never syncs with the host. The live prefix of
// idx is unique (the dedup list), or repeats an index only with identical
// bytes, so no two lane groups race on a row.
//
// The TPU kernels keep 64 row DMAs in flight per core, issued in unrolled
// groups from a scalar loop over 2048-row tiles, with the index list padded
// to a tile; none of that carries over. Here a group of lanes copies one
// position's rows, striding over each row in 16-byte vectors where the row
// bytes and both base pointers are multiples of 16, 4-byte words otherwise,
// 2-byte halves for rows of an odd number of 2-byte elements. The group is
// the smallest power of two of at least 4 lanes that covers the widest
// stream in vectors, at most a warp, chosen at launch: a 256-byte bf16 row
// of dim 128 is 16 vectors, so a warp copies two positions (a warp per
// position would idle half its lanes and keep half the bytes in flight);
// [3, 128] f32 groups (B2) and 512-byte f32 rows (B4) keep whole warps.
// Thousands of resident warps keep enough loads in flight to cover HBM
// latency, which is the card's way to do what the TPU's DMA window did.
//
// Bound: HBM bytes. Per live position the kernel reads each stream's source
// row and the index and writes each destination row: 2 * 256 + 4 bytes for
// the bf16 dim-128 table row. Rows land at random addresses, so each write
// is its own 256-byte (or larger) burst; no data is reused.
//
// Row offsets are 64-bit: 204,102,451 rows of 256 bytes is 52 GB, far past
// 2^31.

namespace {

constexpr int kMaxStreams = 4;

struct ScatterStreams {
  char* dst[kMaxStreams];
  const char* src[kMaxStreams];
  int64_t row_bytes[kMaxStreams];
  int vec_bytes[kMaxStreams];  // 16, 4 or 2
  int k;
  int lane_bits;  // one position per 2^lane_bits lanes (2 .. 5)
};

template <class V>
__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         int64_t row_bytes, int lane,
                                         int lanes) {
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  const int64_t n = row_bytes / static_cast<int64_t>(sizeof(V));
  for (int64_t j = lane; j < n; j += lanes) d[j] = s[j];
}

__global__ void scatter_rows_kernel(ScatterStreams st,
                                    const int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ n_valid,
                                    int64_t num_rows, int64_t n) {
  const int lanes = 1 << st.lane_bits;
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >>
      st.lane_bits;
  const int lane = threadIdx.x & (lanes - 1);
  int64_t live = n;
  if (n_valid != nullptr) {
    live = *n_valid;
    live = live < 0 ? 0 : (live > n ? n : live);
  }
  if (i >= live) return;
  const int64_t r = idx[i];
  if (r < 0 || r >= num_rows) return;
#pragma unroll
  for (int s = 0; s < kMaxStreams; ++s) {
    if (s >= st.k) break;
    const int64_t rb = st.row_bytes[s];
    char* dst = st.dst[s] + r * rb;
    const char* src = st.src[s] + i * rb;
    if (st.vec_bytes[s] == 16) {
      copy_row<uint4>(dst, src, rb, lane, lanes);
    } else if (st.vec_bytes[s] == 4) {
      copy_row<uint32_t>(dst, src, rb, lane, lanes);
    } else {
      copy_row<uint16_t>(dst, src, rb, lane, lanes);
    }
  }
}

}  // namespace

// k streams (1..4) of row_bytes[s] bytes per row, dst[s] with num_rows rows
// and src[s] with n rows; idx int32 [n]; n_valid a device int32 or null.
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// stream count, row width or alignment (row bytes and pointers must be
// even) or grid size; 0 means launched.
extern "C" int krt_scatter_rows(int k, void* const* dst,
                                const void* const* src,
                                const long long* row_bytes, const void* idx,
                                const void* n_valid, long long num_rows,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kMaxStreams) return kUnsupported;
  ScatterStreams st{};
  st.k = k;
  long long widest = 1;  // vectors in the widest stream's row
  for (int s = 0; s < k; ++s) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(dst[s]) |
                           reinterpret_cast<uintptr_t>(src[s]);
    const long long rb = row_bytes[s];
    if (rb <= 0 || rb % 2 != 0 || addr % 2 != 0) return kUnsupported;
    st.dst[s] = static_cast<char*>(dst[s]);
    st.src[s] = static_cast<const char*>(src[s]);
    st.row_bytes[s] = rb;
    st.vec_bytes[s] = (rb % 16 == 0 && addr % 16 == 0)  ? 16
                      : (rb % 4 == 0 && addr % 4 == 0) ? 4
                                                        : 2;
    widest = rb / st.vec_bytes[s] > widest ? rb / st.vec_bytes[s] : widest;
  }
  st.lane_bits = 2;
  while (st.lane_bits < 5 && (1LL << st.lane_bits) < widest) ++st.lane_bits;
  const int64_t rows_per_block = kThreads >> st.lane_bits;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return kUnsupported;
  scatter_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(n_valid), num_rows, n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 3. Split-layout update of bf16 tables.
//
// What it computes, for every live position i < n_valid, with r = idx[i]:
//   apply (row-wise Adagrad, kApply):
//     g = src[i]                           // [dim] f32 row gradient
//     a = acc[r] + sum(g^2)                // in place
//     out[i] = round(w[r] - lr * g / (sqrt(a) + eps))
//   round only (any other optimizer, whose new rows PyTorch computed):
//     out[i] = round(src[i])
// round() is the stochastic rounding of ops/quant.py,
// `(bits(x) + (bits & 0xFFFF)) >> 16`, whose bits come from Philox4x32-10
// (Salmon et al., SC'11) keyed with the 64-bit `seed + step` and counted
// by (r, column / 4): one call gives the bits of the four columns a lane
// holds. `step` is scalars[0], the stack's step counter in device memory,
// so the caller reads nothing on the host; the bits depend neither on a
// row's place in idx nor on the launch geometry. The learning rate is
// `lr`, or scalars[lr_index] (a schedule computed on the device), as in
// kernel 1. Positions past n_valid, and with kApply rows outside
// [0, num_rows), are skipped: their out rows are left as they were. Round
// only, idx is the counter alone (the table is not passed).
//
// The JAX package gathers the rows and slots, applies the optimizer and
// rounds as separate XLA ops; in PyTorch the same chain was ten or so
// passes over [n, dim] f32 temporaries. Here each warp reads its row's
// gradient, bf16 row and accumulator once and writes the rounded row and
// the accumulator once. The live prefix of idx is unique, so no two warps
// touch one accumulator.
//
// Bound: HBM bytes. Per live row: the f32 gradient (4 * dim), the bf16 row
// read and the bf16 out row written (2 * 2 * dim), the accumulator read
// and written (8) and the index (4): 1,036 bytes at dim 128. Design: one
// warp per row; at dim 128 each lane holds four columns: one 16-byte
// gradient load, one 8-byte row load and one 8-byte store, all coalesced
// across the warp. Each lane holds its columns in registers (a template
// count of 4-column groups, up to dim 1,024), so every load of a row (the
// gradient, the table row, the accumulator) is issued at once after the
// index: one round trip to memory a row, where a loop that read the table
// row only after the sum of squares took three in a chain. The row's sum of squares is a butterfly
// of warp shuffles, so every lane ends with the same sum, taken in the
// order of the plain version (four columns per lane, then a halving tree
// over the 32 lanes). Philox costs 20 integer multiplies per four columns,
// well under the memory time. Rows whose width or alignment does not allow
// the vector loads take 4-byte and 2-byte loads in the same order (kVec
// off).
//
// Numerics: -fmad=false and IEEE sqrt and division, as in kernel 1: every
// operation rounds once in the plain version's order, so the two agree
// bit for bit.

namespace {

// Widest row the kernel takes: 8 groups of 4 columns a lane.
constexpr int kMaxSplitDim = 1024;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10: ten rounds, the key bumped before every round but the
// first (Random123's philox4x32_R(10, ...)).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint16_t round_bf16(float x, uint32_t bits) {
  return static_cast<uint16_t>((__float_as_uint(x) + (bits & 0xFFFFu)) >> 16);
}

__device__ __forceinline__ float bf16_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// Four consecutive columns [c, c + 4) of a row; with kVec the caller
// guarantees c + 4 <= dim and the alignment of one vector load.
template <bool kVec>
__device__ __forceinline__ void load4(const float* p, int c, int dim,
                                      float v[4]) {
  if (kVec) {
    const float4 x = *reinterpret_cast<const float4*>(p + c);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < dim ? p[c + j] : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void load4(const uint16_t* p, int c, int dim,
                                      float v[4]) {
  if (kVec) {
    const uint2 x = *reinterpret_cast<const uint2*>(p + c);
    v[0] = bf16_to_float(x.x & 0xFFFFu), v[1] = bf16_to_float(x.x >> 16);
    v[2] = bf16_to_float(x.y & 0xFFFFu), v[3] = bf16_to_float(x.y >> 16);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = c + j < dim ? bf16_to_float(p[c + j]) : 0.0f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(uint16_t* p, int c, int dim,
                                       const uint16_t h[4]) {
  if (kVec) {
    *reinterpret_cast<uint2*>(p + c) =
        make_uint2(h[0] | static_cast<uint32_t>(h[1]) << 16,
                   h[2] | static_cast<uint32_t>(h[3]) << 16);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j < dim) p[c + j] = h[j];
    }
  }
}

// The kernel's arguments, one struct so that each of its instances takes
// the same launch.
struct SplitArgs {
  const uint16_t* table;  // [num_rows, dim] bf16 (apply)
  float* acc;             // [num_rows] f32, updated in place (apply)
  const float* src;       // [n, dim] f32: gradients (apply) or new rows
  uint16_t* out;          // [n, dim] bf16
  const int32_t* idx;
  const float* scalars;   // [0]: the step; [lr_index]: a scheduled rate
  const int32_t* n_valid;
  int64_t num_rows;
  int64_t n;
  int dim;
  float lr;
  int lr_index;
  float eps;
  uint64_t seed;
};

// kChunks: the 4-column groups a lane holds (columns lane * 4 + 128 * k),
// at least ceil(dim / 128); every load of a row is issued before the first
// is used, so a row costs one index read and then one round trip to memory.
template <bool kApply, bool kVec, int kChunks>
__global__ void __launch_bounds__(kThreads)
    apply_split_rows_kernel(const SplitArgs p) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  int64_t live = *p.n_valid;
  live = live < 0 ? 0 : (live > p.n ? p.n : live);
  if (i >= live) return;  // uniform over the warp, as is the next check
  const int64_t r = p.idx[i];
  if (kApply && (r < 0 || r >= p.num_rows)) return;
  const int dim = p.dim;
  const float* s = p.src + i * dim;
  const uint16_t* w = p.table + r * dim;
  float x[kChunks][4] = {};
  float v[kChunks][4] = {};
  // Lane 0 reads and writes the accumulator; a shuffle hands it on.
  const float a0 = kApply && lane == 0 ? p.acc[r] : 0.0f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = lane * 4 + 128 * k;
    if (c < dim) {
      load4<kVec>(s, c, dim, x[k]);
      if (kApply) load4<kVec>(w, c, dim, v[k]);
    }
  }
  const uint64_t key = p.seed + static_cast<uint64_t>(
                                    static_cast<int64_t>(p.scalars[0]));
  const uint32_t k0 = static_cast<uint32_t>(key);
  const uint32_t k1 = static_cast<uint32_t>(key >> 32);
  float denom = 0.0f, rate = 0.0f;
  if (kApply) {
    float ssq = 0.0f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (lane * 4 + 128 * k < dim) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ssq = ssq + x[k][j] * x[k][j];
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      ssq = ssq + __shfl_xor_sync(0xffffffffu, ssq, offset);
    }
    const float a = __shfl_sync(0xffffffffu, a0, 0) + ssq;
    denom = sqrtf(a) + p.eps;
    rate = p.lr_index >= 0 ? p.scalars[p.lr_index] : p.lr;
    if (lane == 0) p.acc[r] = a;
  }
  uint16_t* o = p.out + i * dim;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = lane * 4 + 128 * k;
    if (c >= dim) break;
    if (kApply) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[k][j] = v[k][j] - rate * (x[k][j] / denom);
      }
    }
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(c >> 2),
                   0u, 0u),
        k0, k1);
    const uint16_t h[4] = {
        round_bf16(x[k][0], bits.x), round_bf16(x[k][1], bits.y),
        round_bf16(x[k][2], bits.z), round_bf16(x[k][3], bits.w)};
    store4<kVec>(o, c, dim, h);
  }
}

template <bool kApply, bool kVec>
int launch_split(const SplitArgs& p, unsigned int grid, cudaStream_t stream) {
  const int chunks = (p.dim + 127) / 128;
  if (chunks == 1) {
    apply_split_rows_kernel<kApply, kVec, 1><<<grid, kThreads, 0, stream>>>(p);
  } else if (chunks == 2) {
    apply_split_rows_kernel<kApply, kVec, 2><<<grid, kThreads, 0, stream>>>(p);
  } else if (chunks <= 4) {
    apply_split_rows_kernel<kApply, kVec, 4><<<grid, kThreads, 0, stream>>>(p);
  } else if (chunks <= 8) {
    apply_split_rows_kernel<kApply, kVec, 8><<<grid, kThreads, 0, stream>>>(p);
  } else {
    return kUnsupported;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// apply 1: row-wise Adagrad from the gradients `src` [n, dim] f32, the bf16
// `table` [num_rows, dim] and the f32 accumulator `acc` [num_rows] (updated
// in place); apply 0: `src` holds the new f32 rows, `table`, `acc` and
// num_rows are unused (may be null / 0). Either way writes the rounded bf16
// rows to `out` [n, dim] for the live positions; dim is at most 1,024. `seed` is the Philox key less the step,
// which the kernel adds from scalars[0]. lr_index as for
// krt_apply_scatter_row_blocks. Returns cudaGetLastError() after the
// launch, or -1 for an unsupported argument or grid; 0 means launched.
extern "C" int krt_split_rows(const void* table, void* acc, const void* src,
                              void* out, const void* idx,
                              const void* scalars, const void* n_valid,
                              long long num_rows, long long n, int dim,
                              int apply, float lr, int lr_index, float eps,
                              unsigned long long seed, void* stream) {
  if (n <= 0) return 0;
  if (dim <= 0 || dim > kMaxSplitDim ||
      (apply && (table == nullptr || acc == nullptr))) {
    return kUnsupported;
  }
  const int64_t rows_per_block = kThreads / 32;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return kUnsupported;
  const uintptr_t align8 = reinterpret_cast<uintptr_t>(table) |
                           reinterpret_cast<uintptr_t>(out);
  const bool vec = dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   align8 % 8 == 0;
  const SplitArgs p{static_cast<const uint16_t*>(table),
                    static_cast<float*>(acc),
                    static_cast<const float*>(src),
                    static_cast<uint16_t*>(out),
                    static_cast<const int32_t*>(idx),
                    static_cast<const float*>(scalars),
                    static_cast<const int32_t*>(n_valid),
                    num_rows, n, dim, lr, lr_index, eps, seed};
  const unsigned int grid = static_cast<unsigned int>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (apply) {
    return vec ? launch_split<true, true>(p, grid, st)
               : launch_split<true, false>(p, grid, st);
  }
  return vec ? launch_split<false, true>(p, grid, st)
             : launch_split<false, false>(p, grid, st);
}
