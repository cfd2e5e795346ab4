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
