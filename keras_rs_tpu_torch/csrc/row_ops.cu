// Fused optimizer-apply + row-block scatter for the packed embedding state.
//
// Replaces keras_rs_tpu/ops/row_ops.py::_make_rmw_kernel (the Pallas kernel
// behind apply_scatter_row_blocks), which the sharded lookup's backward pass
// runs once per stack per training step (lookup.py:392-423).
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
    int dim, Op op) {
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
           int64_t n, int dim, Op op, cudaStream_t stream) {
  const int64_t rows_per_block = kThreads / 32;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return kUnsupported;
  apply_scatter_row_blocks_kernel<Op>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          packed, idx, grads, scalars, n_valid, num_rows, n, dim, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// optimizer: 0 = Adagrad (k must be 2), 1 = SGD (k must be 1).
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// (optimizer, k) pair or grid size; 0 means launched.
extern "C" int krt_apply_scatter_row_blocks(
    void* packed, const void* idx, const void* grads, const void* scalars,
    const void* n_valid, long long num_rows, long long n, int k, int dim,
    int optimizer, float lr, float eps, void* stream) {
  if (n <= 0) return 0;
  float* p = static_cast<float*>(packed);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* g = static_cast<const float*>(grads);
  const float* sc = static_cast<const float*>(scalars);
  const int32_t* nv = static_cast<const int32_t*>(n_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (optimizer == 0 && k == Adagrad::kRows) {
    return launch(p, ix, g, sc, nv, num_rows, n, dim, Adagrad{lr, eps}, s);
  }
  if (optimizer == 1 && k == Sgd::kRows) {
    return launch(p, ix, g, sc, nv, num_rows, n, dim, Sgd{lr}, s);
  }
  return kUnsupported;
}
