// Fused causal attention for Hopper: forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of
// keras_rs_tpu/ops/flash_attention.py:
//   _fwd_kernel     (:48)  -> flash_fwd_kernel      (B5)
//   _bwd_dq_kernel  (:85)  -> flash_bwd_dq_kernel   (B6)
//   _bwd_dkv_kernel (:116) -> flash_bwd_dkv_kernel  (B7)
//
// Tensors keep the public [B, T, H, hd] layout (no transpose, no padding
// on the host): element (b, t, h, d) lies at ((b*T + t)*H + h)*hd + d.
// bias is [B, T] f32 (0 for a real key, -1e9 for a padded one); lse and
// delta are [B, H, T] f32. q, k, v, o, do are f32 or bf16; the math is
// f32 throughout. dK and dV are written in f32 (the wrapper casts them).
//
// Design. The TPU kernel keeps all of K and V for one (batch, head) in
// VMEM and computes a [128, T] score tile at once. At T = 1024, hd = 64
// in f32 that is 512 KB, more than a Hopper block's 227 KB of shared
// memory, and the TPU's sequential grid has no counterpart here. So:
//   * forward: one block per (b*h, 64-query tile) walks the 64-key tiles
//     (only those at or below the diagonal when causal) with an online
//     softmax: running max m, running sum l and an f32 accumulator per
//     query row, rescaled by exp(m_old - m_new) at each tile;
//   * dQ: one block per (b*h, 64-query tile) walks the key tiles and
//     recomputes P = exp(S - lse) from the saved logsumexp;
//   * dK/dV: one block per (b*h, 64-key tile) walks the query tiles at or
//     above the diagonal and accumulates dK and dV in registers.
// The backward keeps the JAX package's two-pass split, so no block
// writes what another block writes: no atomics, results independent of
// scheduling.
//
// Block: 256 threads = 16 groups of 16 lanes (half-warps). Group r owns
// tile rows 4r..4r+3; lane c of the group owns score columns c + 16j
// (j < 4) and output columns c + 16v (v < HD / 16). A 64 x 64 score tile
// S = A . B^T reads A transposed in shared memory ([HD][68] floats: one
// float4 gives the group's 4 rows) and B row-major with an odd row
// stride HD + 1 (the 16 lanes hit 16 banks). P (or dS) goes back to
// shared memory transposed, and the product P . D reads D from the same
// odd-stride row-major tile: K serves both S = Q K^T and dQ += dS K. Rows
// are reduced with shuffles inside the group, and a group reads only the
// P rows it wrote, so __syncwarp suffices between the two products.
//
// Bound on this card: at the SASRec slice (B 128, H 1, T 1024, hd 50)
// the causal forward does up to 13.4 GFLOP against ~105 MB of q, k, v
// and O, so the FP32 CUDA-core rate bounds it (no tensor cores: the
// results must stay within 1e-5 of f32 math). This first version is
// plain SIMT code: no wgmma, no TMA, single-buffered tiles.
//
// Masking follows the TPU kernel: S = (Q K^T) * scale + bias, then -1e9
// where the key lies after the query (causal). Keys at t >= T do not
// exist and get -inf. Rows whose visible keys are all padded are only
// finite here (the TPU kernel averages V over all T keys, this one over
// the key tiles it visits); every row with one visible real key agrees.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // query rows and key rows per tile
constexpr int THREADS = 256;  // 16 groups of 16 lanes
constexpr int LDT = 68;       // row stride of a transposed tile (floats)
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One (batch, head) slice of a [B, T, H, hd] tensor.
struct Head {
  long long base;  // offset of (b, 0, h, 0)
  long long rs;    // row stride H * hd
  int b;
};

__device__ __forceinline__ Head head_of(int bh, int T, int H, int hd) {
  Head g;
  g.b = bh / H;
  const int h = bh - g.b * H;
  g.rs = (long long)H * hd;
  g.base = (long long)g.b * T * g.rs + (long long)h * hd;
  return g;
}

// Rows [t0, t0 + 64) transposed into dst[d * LDT + r]; zeros past T and
// past hd.
template <int HD, typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                const Head& g, int t0,
                                                int T_len, int hd) {
  for (int e = threadIdx.x; e < TILE * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int t = t0 + r;
    float x = 0.f;
    if (t < T_len && d < hd) x = to_f32(src[g.base + t * g.rs + d]);
    dst[d * LDT + r] = x;
  }
}

// Rows [t0, t0 + 64) row-major into dst[r * (HD + 1) + d]; zeros past T
// and past hd.
template <int HD, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          const Head& g, int t0, int T_len,
                                          int hd) {
  for (int e = threadIdx.x; e < TILE * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int t = t0 + r;
    float x = 0.f;
    if (t < T_len && d < hd) x = to_f32(src[g.base + t * g.rs + d]);
    dst[r * (HD + 1) + d] = x;
  }
}

// s[i][j] = sum_d A[4r + i][d] * B[c + 16j][d] over d < hd4 (At
// transposed, Bs row-major with stride HD + 1; zero padding past hd).
template <int HD>
__device__ __forceinline__ void tile_scores(float (&s)[4][4],
                                            const float* __restrict__ At,
                                            const float* __restrict__ Bs,
                                            int r, int c, int hd4) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  const float* a_ptr = At + 4 * r;
  const float* b_ptr = Bs + c * (HD + 1);
#pragma unroll 4
  for (int d = 0; d < hd4; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(a_ptr + d * LDT);
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = b_ptr[16 * j * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[0][j] = fmaf(a.x, b[j], s[0][j]);
      s[1][j] = fmaf(a.y, b[j], s[1][j]);
      s[2][j] = fmaf(a.z, b[j], s[2][j]);
      s[3][j] = fmaf(a.w, b[j], s[3][j]);
    }
  }
}

// Pt[(c + 16j) * LDT + 4r + i] = p[i][j]: the group's 4 rows of a 64-wide
// tile, transposed, one float4 per column.
__device__ __forceinline__ void store_transposed(float* Pt,
                                                 const float (&p)[4][4],
                                                 int r, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(Pt + (c + 16 * j) * LDT + 4 * r) =
        make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
}

// acc[i][v] += sum_{kk < n} P[4r + i][kk] * D[kk][c + 16v] (Pt transposed,
// Ds row-major with stride HD + 1).
template <int HD>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][HD / 16],
                                                const float* __restrict__ Pt,
                                                const float* __restrict__ Ds,
                                                int r, int c, int n) {
  constexpr int NV = HD / 16;
  const float* p_ptr = Pt + 4 * r;
  const float* d_ptr = Ds + c;
#pragma unroll 4
  for (int kk = 0; kk < n; ++kk) {
    const float4 p = *reinterpret_cast<const float4*>(p_ptr + kk * LDT);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float x = d_ptr[kk * (HD + 1) + 16 * v];
      acc[0][v] = fmaf(p.x, x, acc[0][v]);
      acc[1][v] = fmaf(p.y, x, acc[1][v]);
      acc[2][v] = fmaf(p.z, x, acc[2][v]);
      acc[3][v] = fmaf(p.w, x, acc[3][v]);
    }
  }
}

// Reductions over the 16 lanes of a group (xor offsets < 16 stay inside).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
struct Smem {
  static constexpr int kTransposed = HD * LDT;       // [HD][LDT]
  static constexpr int kRows = TILE * (HD + 1);      // [64][HD + 1]
  static constexpr int kP = TILE * LDT;              // [64][LDT]
  static constexpr size_t fwd_bytes =
      sizeof(float) * (kTransposed + kP + 2 * kRows + TILE);
  static constexpr size_t bwd_bytes =
      sizeof(float) * (2 * kTransposed + kP + 2 * kRows + 2 * TILE);
};

// --------------------------------------------------------------------------
// B5: forward
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ lse, int T_len, int H, int hd,
                     float scale, int causal) {
  constexpr int NV = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Pt = Qt + Smem<HD>::kTransposed;
  float* Ks = Pt + Smem<HD>::kP;
  float* Vs = Ks + Smem<HD>::kRows;
  float* bias_s = Vs + Smem<HD>::kRows;

  const int n_tiles = (T_len + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_tiles;
  // Heaviest (last) query tiles first: they walk the most key tiles.
  const int q0 = (n_tiles - 1 - blockIdx.x % n_tiles) * TILE;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const int hd4 = (hd + 3) & ~3;
  const Head g = head_of(bh, T_len, H, hd);

  load_transposed<HD>(Qt, q, g, q0, T_len, hd);

  float m[4], l[4], acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) acc[i][vv] = 0.f;
  }

  const int q_end = min(q0 + TILE, T_len);
  const int k_tiles = causal ? (q_end + TILE - 1) / TILE : n_tiles;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_rows<HD>(Ks, k, g, k0, T_len, hd);
    load_rows<HD>(Vs, v, g, k0, T_len, hd);
    if (tid < TILE) {
      const int t = k0 + tid;
      bias_s[tid] = t < T_len ? bias[(long long)g.b * T_len + t] : 0.f;
    }
    __syncthreads();

    float s[4][4];
    tile_scores<HD>(s, Qt, Ks, r, c, hd4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * r + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c + 16 * j;
        float x = s[i][j] * scale + bias_s[c + 16 * j];
        if (causal && kj > qi) x = kNegInf;
        if (kj >= T_len) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int vv = 0; vv < NV; ++vv) acc[i][vv] *= alpha;
    }
    store_transposed(Pt, s, r, c);
    __syncwarp();
    tile_accumulate<HD>(acc, Pt, Vs, r, c, min(TILE, T_len - k0));
    __syncwarp();
  }

  float* lse_row = lse + (long long)bh * T_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * r + i;
    if (qi >= T_len) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) {
      const int d = c + 16 * vv;
      if (d < hd) out[g.base + qi * g.rs + d] = from_f32<T>(acc[i][vv] * inv);
    }
    if (c == 0) lse_row[qi] = m[i] + logf(l[i]);
  }
}

// --------------------------------------------------------------------------
// B6: dQ
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int T_len, int H, int hd, float scale, int causal) {
  constexpr int NV = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* dOt = Qt + Smem<HD>::kTransposed;
  float* Pt = dOt + Smem<HD>::kTransposed;
  float* Ks = Pt + Smem<HD>::kP;
  float* Vs = Ks + Smem<HD>::kRows;
  float* bias_s = Vs + Smem<HD>::kRows;

  const int n_tiles = (T_len + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (n_tiles - 1 - blockIdx.x % n_tiles) * TILE;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const int hd4 = (hd + 3) & ~3;
  const Head g = head_of(bh, T_len, H, hd);

  load_transposed<HD>(Qt, q, g, q0, T_len, hd);
  load_transposed<HD>(dOt, dout, g, q0, T_len, hd);

  float lse_r[4], delta_r[4], acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * r + i;
    const long long at = (long long)bh * T_len + qi;
    lse_r[i] = qi < T_len ? lse[at] : 0.f;
    delta_r[i] = qi < T_len ? delta[at] : 0.f;
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) acc[i][vv] = 0.f;
  }

  const int q_end = min(q0 + TILE, T_len);
  const int k_tiles = causal ? (q_end + TILE - 1) / TILE : n_tiles;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_rows<HD>(Ks, k, g, k0, T_len, hd);
    load_rows<HD>(Vs, v, g, k0, T_len, hd);
    if (tid < TILE) {
      const int t = k0 + tid;
      bias_s[tid] = t < T_len ? bias[(long long)g.b * T_len + t] : 0.f;
    }
    __syncthreads();

    float p[4][4], dp[4][4];
    tile_scores<HD>(p, Qt, Ks, r, c, hd4);
    tile_scores<HD>(dp, dOt, Vs, r, c, hd4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * r + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c + 16 * j;
        float x = p[i][j] * scale + bias_s[c + 16 * j];
        if (causal && kj > qi) x = kNegInf;
        const float pij = kj < T_len ? expf(x - lse_r[i]) : 0.f;
        p[i][j] = pij * (dp[i][j] - delta_r[i]) * scale;  // dS
      }
    }
    store_transposed(Pt, p, r, c);
    __syncwarp();
    tile_accumulate<HD>(acc, Pt, Ks, r, c, min(TILE, T_len - k0));
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * r + i;
    if (qi >= T_len) continue;
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) {
      const int d = c + 16 * vv;
      if (d < hd) dq[g.base + qi * g.rs + d] = from_f32<T>(acc[i][vv]);
    }
  }
}

// --------------------------------------------------------------------------
// B7: dK, dV
// --------------------------------------------------------------------------
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int T_len, int H, int hd, float scale, int causal) {
  constexpr int NV = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;
  float* Vt = Kt + Smem<HD>::kTransposed;
  float* Pt = Vt + Smem<HD>::kTransposed;
  float* Qs = Pt + Smem<HD>::kP;
  float* dOs = Qs + Smem<HD>::kRows;
  float* lse_s = dOs + Smem<HD>::kRows;
  float* delta_s = lse_s + TILE;

  const int n_tiles = (T_len + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_tiles;
  // Heaviest (first) key tiles first: they walk the most query tiles.
  const int k0 = (blockIdx.x % n_tiles) * TILE;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const int hd4 = (hd + 3) & ~3;
  const Head g = head_of(bh, T_len, H, hd);

  load_transposed<HD>(Kt, k, g, k0, T_len, hd);
  load_transposed<HD>(Vt, v, g, k0, T_len, hd);

  // Score rows are keys here; each carries its key's bias.
  float kb[4], acc_k[4][NV], acc_v[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * r + i;
    kb[i] = kj < T_len ? bias[(long long)g.b * T_len + kj] : 0.f;
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) acc_k[i][vv] = acc_v[i][vv] = 0.f;
  }

  const float* lse_row = lse + (long long)bh * T_len;
  const float* delta_row = delta + (long long)bh * T_len;
  for (int qt = causal ? k0 / TILE : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_rows<HD>(Qs, q, g, q0, T_len, hd);
    load_rows<HD>(dOs, dout, g, q0, T_len, hd);
    if (tid < TILE) {
      const int t = q0 + tid;
      lse_s[tid] = t < T_len ? lse_row[t] : 0.f;
      delta_s[tid] = t < T_len ? delta_row[t] : 0.f;
    }
    __syncthreads();
    const int n = min(TILE, T_len - q0);

    // p[i][j]: key k0 + 4r + i against query q0 + c + 16j.
    float p[4][4];
    tile_scores<HD>(p, Kt, Qs, r, c, hd4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + 4 * r + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = q0 + c + 16 * j;
        float x = p[i][j] * scale + kb[i];
        if (causal && kj > qj) x = kNegInf;
        p[i][j] = qj < T_len ? expf(x - lse_s[c + 16 * j]) : 0.f;
      }
    }
    store_transposed(Pt, p, r, c);
    __syncwarp();
    tile_accumulate<HD>(acc_v, Pt, dOs, r, c, n);  // dV += P^T dO
    __syncwarp();

    float dp[4][4];
    tile_scores<HD>(dp, Vt, dOs, r, c, hd4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dp[i][j] = p[i][j] * (dp[i][j] - delta_s[c + 16 * j]) * scale;
    store_transposed(Pt, dp, r, c);
    __syncwarp();
    tile_accumulate<HD>(acc_k, Pt, Qs, r, c, n);  // dK += dS^T Q
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * r + i;
    if (kj >= T_len) continue;
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) {
      const int d = c + 16 * vv;
      if (d < hd) {
        dk[g.base + kj * g.rs + d] = acc_k[i][vv];
        dv[g.base + kj * g.rs + d] = acc_v[i][vv];
      }
    }
  }
}

// --------------------------------------------------------------------------
// Launchers
// --------------------------------------------------------------------------

// Shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD, typename T>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* bias, void* out, float* lse, int B, int T_len,
               int H, int hd, float scale, int causal, cudaStream_t stream) {
  const size_t smem = Smem<HD>::fwd_bytes;
  cudaError_t err = allow_smem(flash_fwd_kernel<HD, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)B * H * ((T_len + TILE - 1) / TILE);
  if (blocks > 0x7fffffffLL) return -1;
  flash_fwd_kernel<HD, T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, T_len, H,
      hd, scale, causal);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch_dq(const void* q, const void* k, const void* v,
              const float* bias, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int T_len, int H, int hd,
              float scale, int causal, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bwd_bytes;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<HD, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)B * H * ((T_len + TILE - 1) / TILE);
  if (blocks > 0x7fffffffLL) return -1;
  flash_bwd_dq_kernel<HD, T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dq), T_len, H, hd, scale, causal);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch_dkv(const void* q, const void* k, const void* v,
               const float* bias, const void* dout, const float* lse,
               const float* delta, float* dk, float* dv, int B, int T_len,
               int H, int hd, float scale, int causal, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bwd_bytes;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<HD, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)B * H * ((T_len + TILE - 1) / TILE);
  if (blocks > 0x7fffffffLL) return -1;
  flash_bwd_dkv_kernel<HD, T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse,
      delta, dk, dv, T_len, H, hd, scale, causal);
  return (int)cudaGetLastError();
}

// Returns LAUNCH<HD, T>(args...) for the padded head dim HD (32, 64 or
// 128) and the element type T (dtype 0: f32, 1: bf16); -1 for anything
// else.
#define KRT_DISPATCH(LAUNCH, hd, dtype, ...)                            \
  do {                                                                  \
    if (T_len <= 0 || B <= 0 || H <= 0 || hd <= 0) return -1;           \
    if ((dtype) == 0) {                                                 \
      if ((hd) <= 32) return LAUNCH<32, float>(__VA_ARGS__);            \
      if ((hd) <= 64) return LAUNCH<64, float>(__VA_ARGS__);            \
      if ((hd) <= 128) return LAUNCH<128, float>(__VA_ARGS__);          \
    } else if ((dtype) == 1) {                                          \
      if ((hd) <= 32) return LAUNCH<32, __nv_bfloat16>(__VA_ARGS__);    \
      if ((hd) <= 64) return LAUNCH<64, __nv_bfloat16>(__VA_ARGS__);    \
      if ((hd) <= 128) return LAUNCH<128, __nv_bfloat16>(__VA_ARGS__);  \
    }                                                                   \
    return -1;                                                          \
  } while (0)

}  // namespace

extern "C" {

// Each returns 0, -1 for an unsupported shape or dtype, or the
// cudaError_t of the launch. None synchronises.

int krt_flash_fwd(const void* q, const void* k, const void* v,
                  const float* bias, void* out, float* lse, int B, int T_len,
                  int H, int hd, float scale, int causal, int dtype,
                  void* stream) {
  KRT_DISPATCH(launch_fwd, hd, dtype, q, k, v, bias, out, lse, B, T_len, H,
               hd, scale, causal, static_cast<cudaStream_t>(stream));
}

int krt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const float* bias, const void* dout, const float* lse,
                     const float* delta, void* dq, int B, int T_len, int H,
                     int hd, float scale, int causal, int dtype,
                     void* stream) {
  KRT_DISPATCH(launch_dq, hd, dtype, q, k, v, bias, dout, lse, delta, dq, B,
               T_len, H, hd, scale, causal,
               static_cast<cudaStream_t>(stream));
}

int krt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const float* bias, const void* dout, const float* lse,
                      const float* delta, float* dk, float* dv, int B,
                      int T_len, int H, int hd, float scale, int causal,
                      int dtype, void* stream) {
  KRT_DISPATCH(launch_dkv, hd, dtype, q, k, v, bias, dout, lse, delta, dk,
               dv, B, T_len, H, hd, scale, causal,
               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
