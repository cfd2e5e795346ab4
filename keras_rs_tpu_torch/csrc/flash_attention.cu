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
// delta are [B, H, T] f32. q, k, v, o, do are f32 or bf16. dK and dV are
// written in f32 (the wrapper casts them).
//
// Work split. The TPU kernel keeps all of K and V for one (batch, head)
// in VMEM and computes a [128, T] score tile at once; a Hopper block has
// 227 KB of shared memory and no sequential grid. So:
//   * forward: one block per (b*h, 128-query tile) walks the 64-key tiles
//     (only those at or below the diagonal when causal) with an online
//     softmax: running max m, running sum l and an f32 accumulator per
//     query row, rescaled by exp(m_old - m_new) at each tile;
//   * dQ: one block per (b*h, 128-query tile) walks the 32-key tiles at
//     or below the diagonal, recomputes P = exp(S - lse) from the saved
//     logsumexp and accumulates dQ in registers;
//   * dK/dV: one block per (b*h, 64-key tile) walks the 32-query tiles at
//     or above the diagonal and accumulates dK and dV in registers.
// The backward keeps the JAX package's two-pass split, so no block
// writes what another block writes: no atomics, results independent of
// scheduling. Blocks are ordered heaviest first (the last query tiles,
// the first key tiles), so the causal imbalance does not idle the tail.
//
// All three run on the tensor cores (the TPU kernels are MXU-bound; the
// tensor core is this card's matrix unit).
//
//   Matrix unit: warp-level mma.sync (m16n8k8 TF32 for f32 inputs,
//   m16n8k16 for bf16), not wgmma. Three reasons. (1) f32 inputs need an
//   error-compensated product (below) whose big and small parts are made
//   from each fragment in registers; wgmma reads B from shared memory
//   only, so both parts of every tile would have to be written there
//   first (twice the footprint and an extra pass per tile). (2) wgmma's
//   descriptors name 16-byte-swizzled layouts, while a row of the SASRec
//   slice is 200 bytes (hd 50, f32) and can only be copied 8 bytes at a
//   time. (3) With mma.sync the score accumulators are the next
//   product's A fragments, so P and dS never leave registers. The price
//   (NVIDIA H100 80GB HBM3, 700 W; kernels/mma_rate.py): one scheduler
//   starts an mma.sync every ~3.4 ns, TF32 m16n8k8 and bf16 m16n8k16
//   alike, 65% of the published tensor peak, so three products per tile
//   put the f32 kernels' floor at 0.15 ms (B5), 0.23 ms (B6) and 0.30 ms
//   (B7) at the SASRec slice.
//
//   Numbers. bf16 inputs go to the tensor cores as they are; P and dS are
//   rounded to bf16 for the product that takes them as its A operand
//   (P . V, dS . K, P^T . dO, dS^T . Q); accumulators, softmax
//   statistics, lse and delta are f32. f32 inputs must stay within 1e-5
//   of f32 math, which one TF32 product (10 mantissa bits) does not give.
//   Each operand x is split into big = tf32(x), rounded to nearest, and
//   small = x - big truncated to TF32, and each product is summed in f32
//   as small*big + big*small + big*big ("3xTF32", the scheme CUTLASS
//   documents as matching SGEMM accuracy). The split is made in registers
//   after each fragment load, with integer and float ALU operations
//   (add 0x1000, mask, subtract, mask): cvt.rna.tf32.f32 gives the same
//   big but runs at a quarter of the ALU rate and cost 18% of B5's time.
//   Splitting once per tile in shared memory instead would double its
//   footprint (fewer blocks per SM) and add a read-split-write pass.
//   The three MMAs of one accumulator depend on each other, so each pass
//   is run over a group of 4 column tiles.
//
//   Block: warp w owns rows 16w .. 16w+15 of the block's tile: 8 warps
//   and 128 query rows in B5 and B6, 4 warps and 64 key rows in B7. Lane
//   = 4g + t holds accumulator rows g and g + 8 and columns 8j + 2t,
//   8j + 2t + 1 of each 8-wide column tile j. B7 computes S transposed
//   (K Q^T: rows are keys), so P^T and dS^T are its accumulators. In B5
//   and B6 a warp skips a key tile that lies wholly after its rows (it
//   would add zeros).
//
//   Fragments. A tile is row-major in shared memory with row stride
//   ld = HDP + 4 floats or HDP + 8 bf16, where HDP is hd rounded up to
//   the MMA's depth (8 for TF32: hd 50 -> 56; 16 for bf16) and a
//   template parameter: one instance per HDP up to 128, so that no loop
//   over head-dim tiles carries a run-time guard (guards cost 20-27%).
//   The padding columns hd .. HDP-1 are zeroed once in shared memory,
//   never in device memory. ld is 4 * odd words, so the 32 lanes of every
//   fragment load hit 32 banks, for "A . B^T" products (B[n][k] at
//   (n0 + g) * ld + k0 + t) and for "P . B" products alike. For TF32 the
//   accumulator layout is not the A layout; P . B therefore maps k-slot
//   t to key 2t and k-slot t + 4 to key 2t + 1 on both operands (B[2t][g]
//   at 2t * ld + g), which sums the same terms. bf16 B fragments come
//   from ldmatrix (.trans for P . B); rows of 16 * odd bytes keep it free
//   of conflicts.
//
//   Copies. K/V tiles with their bias rows (B5, B6) or Q/dO tiles with
//   their lse/delta rows (B7) go through a ring of two stages filled by
//   cp.async (B6 and B7 copy their resident tiles the same way):
//   the next tile's copies are in flight during this tile's products. The
//   copy width is chosen at launch from the row bytes and the pointers:
//   16 bytes (cp.async.cg) where rows allow, else 8 or 4 (cp.async.ca);
//   rows of odd bf16 length (2-byte aligned) fall back to plain loads.
//   Rows past T are zero-filled by the copy itself (src-size 0).
//
//   Occupancy at the SASRec slice (hd 50 f32, HDP 56, ld 60; ptxas,
//   sm_90a, no spills). B5: 127 registers x 256 threads; shared memory
//   (128 Q + 4 x 64 ring rows) x 240 B + bias = 92,672 B: two blocks, 16
//   warps per SM (__launch_bounds__(256, 2) for HDP <= 64). B7: 130
//   registers x 128 threads; (2 x 64 K, V + 4 x 32 ring rows) x 240 B +
//   lse/delta = 61,952 B: three blocks, 12 warps per SM. The 32-query
//   ring tile keeps P^T and dS^T at 16 registers each beside the 2 x
//   HDP / 2 of dK and dV (64-query tiles took 166 registers and 93 KB:
//   two blocks per SM, 5% slower). B6: 116 registers x 256 threads;
//   (128 Q + 128 dO + 4 x 32 ring rows) x 240 B + bias = 92,416 B: two
//   blocks, 16 warps per SM; S, dP and dQ are 16 + 16 + 28 accumulator
//   registers (64-key ring tiles: 127 registers, 11% slower at the slice
//   and 9% faster in bf16 at T 4096, where HDP 64 spills; 4 warps and 64
//   queries: 1% slower in f32, 9% in bf16). The widest instance (HDP
//   128, f32) fits one block per SM: B5 203,264 B, B6 203,008 B, B7
//   135,680 B.
//
// Masking follows the TPU kernel: S = (Q K^T) * scale + bias, then -1e9
// where the key lies after the query (causal). Keys at t >= T do not
// exist and get -inf; every row's first tile holds key 0, so -inf is
// never a row's maximum. Rows whose visible keys are all padded are only
// finite here (the TPU kernel averages V over all T keys, this one over
// the key tiles it visits); every row with one visible real key agrees.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;  // key rows of a B5 ring tile
constexpr float kNegInf = -1e9f;

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

// ==========================================================================
// Tensor-core building blocks (B5, B7)
// ==========================================================================

constexpr int FWD_WARPS = 8;  // 16 query rows each
constexpr int FWD_ROWS = 16 * FWD_WARPS;
constexpr int DKV_WARPS = 4;  // 16 key rows each
constexpr int DKV_ROWS = 16 * DKV_WARPS;
constexpr int DKV_RING_ROWS = 32;  // query rows of a dK/dV ring tile
constexpr int DQ_WARPS = 8;  // 16 query rows each
constexpr int DQ_ROWS = 16 * DQ_WARPS;
constexpr int DQ_RING_ROWS = 32;  // key rows of a dQ ring tile

// Depth of one MMA in elements, and the padding of a shared-memory row.
template <typename T>
struct Tc;
template <>
struct Tc<float> {
  static constexpr int kDepth = 8, kPad = 4;
};
template <>
struct Tc<__nv_bfloat16> {
  static constexpr int kDepth = 16, kPad = 8;
};

// Row stride (elements) of a shared-memory tile for head dim hd.
template <typename T>
__host__ __device__ constexpr int padded_hd(int hd) {
  return (hd + Tc<T>::kDepth - 1) / Tc<T>::kDepth * Tc<T>::kDepth;
}
template <typename T>
__host__ __device__ constexpr int row_stride(int hd) {
  return padded_hd<T>(hd) + Tc<T>::kPad;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One W-byte asynchronous copy; zero-fills the destination when !ok.
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  const int n = ok ? W : 0;
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else if constexpr (W == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How the rows of one launch are copied: `width` bytes per copy, `cpr`
// copies per row, and the multiplier that divides by cpr (e / cpr ==
// umulhi(e, magic) for e < 2^13, cpr <= 128).
struct RowCopy {
  int width;
  int cpr;
  unsigned magic;
};

__device__ __forceinline__ RowCopy row_copy(int row_bytes, int width) {
  RowCopy rc;
  rc.width = width;
  rc.cpr = row_bytes / width;
  rc.magic = rc.cpr > 1 ? 0xFFFFFFFFu / (unsigned)rc.cpr + 1u : 0u;
  return rc;
}

template <int W, typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* src,
                                                const Head& g, int t0,
                                                int T_len, int rows, int ld,
                                                const RowCopy& rc) {
  const uint32_t to = smem_addr(dst);
  const char* from = reinterpret_cast<const char*>(src + g.base);
  const long long row_bytes = g.rs * (long long)sizeof(T);
  const int ld_bytes = ld * (int)sizeof(T);
  const int total = rows * rc.cpr;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = rc.cpr > 1 ? (int)__umulhi((unsigned)e, rc.magic) : e;
    const int c = e - r * rc.cpr;
    const int t = t0 + r;
    const bool ok = t < T_len;
    cp_async<W>(to + r * ld_bytes + c * W,
                from + (ok ? t : 0) * row_bytes + c * W, ok);
  }
}

// Rows [t0, t0 + rows) of one head into dst[r * ld + d], d < hd; zeros
// past T. Asynchronous (cp.async) unless the rows are 2-byte aligned.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          const Head& g, int t0, int T_len,
                                          int rows, int hd, int ld,
                                          const RowCopy& rc) {
  if (rc.width == 16) {
    copy_rows_async<16>(dst, src, g, t0, T_len, rows, ld, rc);
  } else if (rc.width == 8) {
    copy_rows_async<8>(dst, src, g, t0, T_len, rows, ld, rc);
  } else if (rc.width == 4) {
    copy_rows_async<4>(dst, src, g, t0, T_len, rows, ld, rc);
  } else {
    for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
      const int r = e / hd, d = e - r * hd;
      const int t = t0 + r;
      dst[r * ld + d] =
          t < T_len ? src[g.base + t * g.rs + d] : from_f32<T>(0.f);
    }
  }
}

// n <= blockDim.x floats src[t0 .. t0 + n) into dst; zeros past T.
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           int t0, int T_len, int n) {
  if ((int)threadIdx.x < n) {
    const int t = t0 + threadIdx.x;
    const bool ok = t < T_len;
    cp_async<4>(smem_addr(dst + threadIdx.x), src + (ok ? t : 0), ok);
  }
}

// Zeros columns hd .. hdp-1 of `rows` shared-memory rows.
template <typename T>
__device__ __forceinline__ void zero_padding(T* tiles, int rows, int hd,
                                             int hdp, int ld) {
  const int w = hdp - hd;
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
    const int r = e / w;
    tiles[r * ld + hd + (e - r * w)] = from_f32<T>(0.f);
  }
}

// --- MMA ------------------------------------------------------------------

// x = big + small + (at most 2^-21 |x|), both valid TF32 encodings (low
// 13 bits clear): big is x rounded to nearest, ties away from zero (what
// cvt.rna.tf32.f32 gives), small is the exact remainder truncated. Integer
// and float ALU operations: cvt runs at a quarter of their rate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Column tiles whose MMAs are started together. The three MMAs of one
// accumulator depend on each other (~30 cycles each); taking each pass
// over a group of tiles puts MMA_GROUP - 1 independent MMAs between them.
constexpr int MMA_GROUP = 4;

// acc[j0 + i] += A . B_i for i < n, for f32 A (split into a_big, a_small)
// and the f32 B fragments (b0[i], b1[i]): small*big + big*small + big*big.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[N][4], int j0, int n,
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const float (&b0)[MMA_GROUP],
                                           const float (&b1)[MMA_GROUP]) {
  uint32_t b0_big[MMA_GROUP], b0_small[MMA_GROUP];
  uint32_t b1_big[MMA_GROUP], b1_small[MMA_GROUP];
#pragma unroll
  for (int i = 0; i < MMA_GROUP; ++i) {
    split_tf32(b0[i], b0_big[i], b0_small[i]);
    split_tf32(b1[i], b1_big[i], b1_small[i]);
  }
#pragma unroll
  for (int i = 0; i < MMA_GROUP; ++i)
    if (i < n) mma_tf32(acc[j0 + i], a_small, b0_big[i], b1_big[i]);
#pragma unroll
  for (int i = 0; i < MMA_GROUP; ++i)
    if (i < n) mma_tf32(acc[j0 + i], a_big, b0_small[i], b1_small[i]);
#pragma unroll
  for (int i = 0; i < MMA_GROUP; ++i)
    if (i < n) mma_tf32(acc[j0 + i], a_big, b0_big[i], b1_big[i]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 and receives elements (i / 4, 2 (i % 4) + {0, 1}) of each
// (transposed: (2 (i % 4) + {0, 1}, i / 4)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// acc[j] = A . Bm[8j .. 8j+7]^T over d < HDP, j < NT. A: the warp's 16
// rows of a shared tile; Bm: a shared tile of 8 NT rows; both row-major
// with stride row_stride(HDP) and zeros past hd.
template <int NT, int HDP>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4],
                                            const float* A, const float* Bm,
                                            int lane) {
  constexpr int ld = row_stride<float>(HDP);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  const float* a_ptr = A + g * ld + t;
  const float* b_ptr = Bm + g * ld + t;
#pragma unroll 1
  for (int k0 = 0; k0 < HDP; k0 += 8) {
    uint32_t a_big[4], a_small[4];
    split_tf32(a_ptr[k0], a_big[0], a_small[0]);
    split_tf32(a_ptr[k0 + 8 * ld], a_big[1], a_small[1]);
    split_tf32(a_ptr[k0 + 4], a_big[2], a_small[2]);
    split_tf32(a_ptr[k0 + 8 * ld + 4], a_big[3], a_small[3]);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += MMA_GROUP) {
      const int n = NT - j0;  // column tiles left (a constant when unrolled)
      float b0[MMA_GROUP], b1[MMA_GROUP];
#pragma unroll
      for (int i = 0; i < MMA_GROUP; ++i) {
        b0[i] = i < n ? b_ptr[(j0 + i) * 8 * ld + k0] : 0.f;
        b1[i] = i < n ? b_ptr[(j0 + i) * 8 * ld + k0 + 4] : 0.f;
      }
      mma_3xtf32(acc, j0, n, a_big, a_small, b0, b1);
    }
  }
}

template <int NT, int HDP>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4],
                                            const __nv_bfloat16* A,
                                            const __nv_bfloat16* Bm,
                                            int lane) {
  static_assert(NT % 2 == 0, "ldmatrix.x4 covers two column tiles");
  constexpr int ld = row_stride<__nv_bfloat16>(HDP);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  const __nv_bfloat16* a_ptr = A + g * ld + 2 * t;
  // Matrix i / 8 of the four: rows 8 (i / 16) + i % 8, columns
  // 8 ((i / 8) % 2): (b0, b1) of column tile j, then of j + 1.
  const uint32_t b_addr = smem_addr(
      Bm + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int k0 = 0; k0 < HDP; k0 += 16) {
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(a_ptr + k0);
    a[1] = *reinterpret_cast<const uint32_t*>(a_ptr + 8 * ld + k0);
    a[2] = *reinterpret_cast<const uint32_t*>(a_ptr + k0 + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(a_ptr + 8 * ld + k0 + 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_addr + (j * 8 * ld + k0) * 2);
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc[jd] += P . Bm[:, 8jd .. 8jd+7] for jd < HDP / 8. P: the warp's
// [16, 8 NT] accumulators of product_abt (p[j] is column tile j); Bm: a
// shared tile of 8 NT rows.
template <int NT, int HDP>
__device__ __forceinline__ void product_pb(float (&acc)[HDP / 8][4],
                                           const float (&p)[NT][4],
                                           const float* Bm, int lane) {
  constexpr int ld = row_stride<float>(HDP), ND = HDP / 8;
  const int g = lane >> 2, t = lane & 3;
  // k-slot t is row 2t of the 8-row step, k-slot t + 4 is row 2t + 1.
  const float* b_ptr = Bm + 2 * t * ld + g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t a_big[4], a_small[4];
    split_tf32(p[j][0], a_big[0], a_small[0]);
    split_tf32(p[j][2], a_big[1], a_small[1]);
    split_tf32(p[j][1], a_big[2], a_small[2]);
    split_tf32(p[j][3], a_big[3], a_small[3]);
#pragma unroll
    for (int jd0 = 0; jd0 < ND; jd0 += MMA_GROUP) {
      const int n = ND - jd0;  // column tiles left (a constant when unrolled)
      float b0[MMA_GROUP], b1[MMA_GROUP];
#pragma unroll
      for (int i = 0; i < MMA_GROUP; ++i) {
        b0[i] = i < n ? b_ptr[8 * j * ld + 8 * (jd0 + i)] : 0.f;
        b1[i] = i < n ? b_ptr[(8 * j + 1) * ld + 8 * (jd0 + i)] : 0.f;
      }
      mma_3xtf32(acc, jd0, n, a_big, a_small, b0, b1);
    }
  }
}

template <int NT, int HDP>
__device__ __forceinline__ void product_pb(float (&acc)[HDP / 8][4],
                                           const float (&p)[NT][4],
                                           const __nv_bfloat16* Bm,
                                           int lane) {
  static_assert(NT % 2 == 0 && HDP % 16 == 0, "16-row steps, 16-column pairs");
  constexpr int ld = row_stride<__nv_bfloat16>(HDP), ND = HDP / 8;
  // Matrix i / 8 of the four: rows 8 ((i / 8) % 2) + i % 8, columns
  // 8 (i / 16): transposed, (b0, b1) of column tile jd, then of jd + 1.
  const uint32_t b_addr = smem_addr(
      Bm + (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8);
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * jj][0], p[2 * jj][1]);
    a[1] = pack_bf16(p[2 * jj][2], p[2 * jj][3]);
    a[2] = pack_bf16(p[2 * jj + 1][0], p[2 * jj + 1][1]);
    a[3] = pack_bf16(p[2 * jj + 1][2], p[2 * jj + 1][3]);
#pragma unroll
    for (int jd = 0; jd < ND; jd += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_addr + (16 * jj * ld + 8 * jd) * 2);
      mma_bf16(acc[jd], a, b[0], b[1]);
      mma_bf16(acc[jd + 1], a, b[2], b[3]);
    }
  }
}

// exp for the probabilities: full accuracy for f32 inputs, the fast
// intrinsic for bf16 (P is rounded to bf16 next).
template <typename T>
__device__ __forceinline__ float exp_of(float x);
template <>
__device__ __forceinline__ float exp_of<float>(float x) {
  return expf(x);
}
template <>
__device__ __forceinline__ float exp_of<__nv_bfloat16>(float x) {
  return __expf(x);
}

// Reductions over the 4 lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HDP, typename T>
constexpr size_t fwd_smem_bytes() {
  constexpr size_t row = (size_t)row_stride<T>(HDP) * sizeof(T);
  return (FWD_ROWS + 4 * TILE) * row + 2 * TILE * sizeof(float);
}
template <int HDP, typename T>
constexpr size_t dkv_smem_bytes() {
  constexpr size_t row = (size_t)row_stride<T>(HDP) * sizeof(T);
  return (2 * DKV_ROWS + 4 * DKV_RING_ROWS) * row +
         4 * DKV_RING_ROWS * sizeof(float);
}
template <int HDP, typename T>
constexpr size_t dq_smem_bytes() {
  constexpr size_t row = (size_t)row_stride<T>(HDP) * sizeof(T);
  return (2 * DQ_ROWS + 4 * DQ_RING_ROWS) * row +
         2 * DQ_RING_ROWS * sizeof(float);
}

// --------------------------------------------------------------------------
// B5: forward
// --------------------------------------------------------------------------
template <int HDP, typename T>
__global__ void __launch_bounds__(32 * FWD_WARPS, HDP <= 64 ? 2 : 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ lse, int T_len, int H, int hd,
                     float scale, int causal, int width) {
  constexpr int NT = TILE / 8, ND = HDP / 8;
  constexpr int ld = row_stride<T>(HDP), tile = TILE * ld;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // Q, then stage s: K at ring + 2 s tile, V one tile later; bias [2][64].
  T* Qs = reinterpret_cast<T*>(tc_smem);
  T* ring = Qs + FWD_ROWS * ld;
  float* bias_s = reinterpret_cast<float*>(ring + 4 * tile);

  const int n_tiles = (T_len + FWD_ROWS - 1) / FWD_ROWS;
  const int bh = blockIdx.x / n_tiles;
  // Heaviest (last) query tiles first: they walk the most key tiles.
  const int q0 = (n_tiles - 1 - blockIdx.x % n_tiles) * FWD_ROWS;
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const Head gh = head_of(bh, T_len, H, hd);
  const RowCopy rc = row_copy(hd * (int)sizeof(T), width);
  const float* bias_row = bias + (long long)gh.b * T_len;

  const int q_end = min(q0 + FWD_ROWS, T_len);
  const int k_tiles = (causal ? q_end + TILE - 1 : T_len + TILE - 1) / TILE;

  auto fetch = [&](int kt) {
    T* Ks = ring + (kt & 1) * 2 * tile;
    load_tile(Ks, k, gh, kt * TILE, T_len, TILE, hd, ld, rc);
    load_tile(Ks + tile, v, gh, kt * TILE, T_len, TILE, hd, ld, rc);
    load_stats(bias_s + (kt & 1) * TILE, bias_row, kt * TILE, T_len, TILE);
    cp_commit();
  };

  zero_padding(Qs, FWD_ROWS + 4 * TILE, hd, HDP, ld);
  load_tile(Qs, q, gh, q0, T_len, FWD_ROWS, hd, ld, rc);
  fetch(0);

  // Per thread: rows g and g + 8 of the warp's 16. l holds this lane's
  // share of the row sum (summed over the quad at the end).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int jd = 0; jd < ND; ++jd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[jd][c] = 0.f;
  const int qr0 = q0 + w0 + g, qr1 = qr0 + 8;

  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      fetch(kt + 1);  // into the stage the previous iteration released
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile kt (and Q) landed for every thread
    const T* Ks = ring + (kt & 1) * 2 * tile;
    const float* bs = bias_s + (kt & 1) * TILE;
    const int k0 = kt * TILE;

    // A key tile wholly after the warp's rows adds exp(-1e9 - m) = 0.
    if (!(causal && k0 > q0 + w0 + 15)) {
      float s[NT][4];
      product_abt<NT, HDP>(s, Qs + w0 * ld, Ks, lane);

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int kj = k0 + 8 * j + 2 * t;
        const float2 bj =
            *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kj + (c & 1);
          float x = s[j][c] * scale + ((c & 1) ? bj.y : bj.x);
          if (causal && key > (c < 2 ? qr0 : qr1)) x = kNegInf;
          if (key >= T_len) x = -INFINITY;
          s[j][c] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      const float m0 = fmaxf(m[0], quad_max(mx0));
      const float m1 = fmaxf(m[1], quad_max(mx1));
      const float alpha0 = exp_of<T>(m[0] - m0);
      const float alpha1 = exp_of<T>(m[1] - m1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp_of<T>(s[j][0] - m0);
        s[j][1] = exp_of<T>(s[j][1] - m0);
        s[j][2] = exp_of<T>(s[j][2] - m1);
        s[j][3] = exp_of<T>(s[j][3] - m1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l[0] = l[0] * alpha0 + sum0;
      l[1] = l[1] * alpha1 + sum1;
      m[0] = m0;
      m[1] = m1;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        o[jd][0] *= alpha0;
        o[jd][1] *= alpha0;
        o[jd][2] *= alpha1;
        o[jd][3] *= alpha1;
      }
      product_pb<NT, HDP>(o, s, Ks + tile, lane);
    }
    __syncthreads();  // the stage may be refilled
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  float* lse_row = lse + (long long)bh * T_len;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? qr1 : qr0;
    if (qi >= T_len) continue;
    const float inv = 1.f / l[half];
    T* o_row = out + gh.base + qi * gh.rs;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * jd + 2 * t + c;
        if (d < hd) o_row[d] = from_f32<T>(o[jd][2 * half + c] * inv);
      }
    if (t == 0) lse_row[qi] = m[half] + logf(l[half]);
  }
}

// --------------------------------------------------------------------------
// B7: dK, dV
// --------------------------------------------------------------------------
template <int HDP, typename T>
__global__ void __launch_bounds__(32 * DKV_WARPS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int T_len, int H, int hd, float scale, int causal,
                         int width) {
  constexpr int BQ = DKV_RING_ROWS, NT = BQ / 8, ND = HDP / 8;
  constexpr int ld = row_stride<T>(HDP);
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // K, V, then stage s: Q at ring + 2 s BQ ld, dO BQ ld later; lse and
  // delta [2][2][BQ].
  T* Ks = reinterpret_cast<T*>(tc_smem);
  T* Vs = Ks + DKV_ROWS * ld;
  T* ring = Vs + DKV_ROWS * ld;
  float* stats = reinterpret_cast<float*>(ring + 4 * BQ * ld);

  const int n_tiles = (T_len + DKV_ROWS - 1) / DKV_ROWS;
  const int bh = blockIdx.x / n_tiles;
  // Heaviest (first) key tiles first: they walk the most query tiles.
  const int k0 = (blockIdx.x % n_tiles) * DKV_ROWS;
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const Head gh = head_of(bh, T_len, H, hd);
  const RowCopy rc = row_copy(hd * (int)sizeof(T), width);
  const float* lse_row = lse + (long long)bh * T_len;
  const float* delta_row = delta + (long long)bh * T_len;

  const int qt_first = causal ? k0 / BQ : 0;
  const int qt_end = (T_len + BQ - 1) / BQ;

  auto fetch = [&](int qt) {
    const int s = (qt - qt_first) & 1;
    T* Qs = ring + s * 2 * BQ * ld;
    load_tile(Qs, q, gh, qt * BQ, T_len, BQ, hd, ld, rc);
    load_tile(Qs + BQ * ld, dout, gh, qt * BQ, T_len, BQ, hd, ld, rc);
    load_stats(stats + s * 2 * BQ, lse_row, qt * BQ, T_len, BQ);
    load_stats(stats + s * 2 * BQ + BQ, delta_row, qt * BQ, T_len, BQ);
    cp_commit();
  };

  zero_padding(Ks, 2 * DKV_ROWS + 4 * BQ, hd, HDP, ld);
  load_tile(Ks, k, gh, k0, T_len, DKV_ROWS, hd, ld, rc);
  load_tile(Vs, v, gh, k0, T_len, DKV_ROWS, hd, ld, rc);
  fetch(qt_first);

  // Score rows are keys here (rows g and g + 8 of the warp's 16); each
  // carries its key's bias.
  const int kr0 = k0 + w0 + g, kr1 = kr0 + 8;
  const float kb0 = kr0 < T_len ? bias[(long long)gh.b * T_len + kr0] : 0.f;
  const float kb1 = kr1 < T_len ? bias[(long long)gh.b * T_len + kr1] : 0.f;
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int jd = 0; jd < ND; ++jd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[jd][c] = acc_v[jd][c] = 0.f;

  for (int qt = qt_first; qt < qt_end; ++qt) {
    if (qt + 1 < qt_end) {
      fetch(qt + 1);  // into the stage the previous iteration released
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile qt (and K, V) landed for every thread
    const int s = (qt - qt_first) & 1;
    const T* Qs = ring + s * 2 * BQ * ld;
    const T* dOs = Qs + BQ * ld;
    const float* lse_s = stats + s * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    const int q0 = qt * BQ;

    // p[j][c]: key kr0 (c < 2) or kr1 against query q0 + 8j + 2t + c % 2.
    float p[NT][4];
    product_abt<NT, HDP>(p, Ks + w0 * ld, Qs, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int qj = q0 + 8 * j + 2 * t;
      const float2 lj =
          *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int query = qj + (c & 1);
        float x = p[j][c] * scale + (c < 2 ? kb0 : kb1);
        if (causal && (c < 2 ? kr0 : kr1) > query) x = kNegInf;
        p[j][c] =
            query < T_len ? exp_of<T>(x - ((c & 1) ? lj.y : lj.x)) : 0.f;
      }
    }
    product_pb<NT, HDP>(acc_v, p, dOs, lane);  // dV += P^T dO

    float dp[NT][4];
    product_abt<NT, HDP>(dp, Vs + w0 * ld, dOs, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 dj =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dp[j][c] = p[j][c] * (dp[j][c] - ((c & 1) ? dj.y : dj.x)) * scale;
    }
    product_pb<NT, HDP>(acc_k, dp, Qs, lane);  // dK += dS^T Q
    __syncthreads();  // the stage may be refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = half ? kr1 : kr0;
    if (kj >= T_len) continue;
    float* dk_row = dk + gh.base + kj * gh.rs;
    float* dv_row = dv + gh.base + kj * gh.rs;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * jd + 2 * t + c;
        if (d < hd) {
          dk_row[d] = acc_k[jd][2 * half + c];
          dv_row[d] = acc_v[jd][2 * half + c];
        }
      }
  }
}

// --------------------------------------------------------------------------
// B6: dQ
// --------------------------------------------------------------------------
// B7's structure with queries as the rows: the block's Q and dO tiles stay
// in shared memory, K, V and the key bias walk through the ring, and per
// key tile S = Q K^T, P = exp(S - lse), dP = dO V^T, dS = P (dP - delta)
// scale and dQ += dS K, with P, dP and dS in registers throughout.
template <int HDP, typename T>
__global__ void __launch_bounds__(32 * DQ_WARPS, HDP <= 64 ? 2 : 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int T_len, int H, int hd, float scale, int causal,
                        int width) {
  constexpr int BK = DQ_RING_ROWS, NT = BK / 8, ND = HDP / 8;
  constexpr int ld = row_stride<T>(HDP), tile = BK * ld;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // Q, dO, then stage s: K at ring + 2 s tile, V one tile later; bias
  // [2][BK].
  T* Qs = reinterpret_cast<T*>(tc_smem);
  T* dOs = Qs + DQ_ROWS * ld;
  T* ring = dOs + DQ_ROWS * ld;
  float* bias_s = reinterpret_cast<float*>(ring + 4 * tile);

  const int n_tiles = (T_len + DQ_ROWS - 1) / DQ_ROWS;
  const int bh = blockIdx.x / n_tiles;
  // Heaviest (last) query tiles first: they walk the most key tiles.
  const int q0 = (n_tiles - 1 - blockIdx.x % n_tiles) * DQ_ROWS;
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const Head gh = head_of(bh, T_len, H, hd);
  const RowCopy rc = row_copy(hd * (int)sizeof(T), width);
  const float* bias_row = bias + (long long)gh.b * T_len;

  const int q_end = min(q0 + DQ_ROWS, T_len);
  const int k_tiles = ((causal ? q_end : T_len) + BK - 1) / BK;

  auto fetch = [&](int kt) {
    T* Ks = ring + (kt & 1) * 2 * tile;
    load_tile(Ks, k, gh, kt * BK, T_len, BK, hd, ld, rc);
    load_tile(Ks + tile, v, gh, kt * BK, T_len, BK, hd, ld, rc);
    load_stats(bias_s + (kt & 1) * BK, bias_row, kt * BK, T_len, BK);
    cp_commit();
  };

  zero_padding(Qs, 2 * DQ_ROWS + 4 * BK, hd, HDP, ld);
  load_tile(Qs, q, gh, q0, T_len, DQ_ROWS, hd, ld, rc);
  load_tile(dOs, dout, gh, q0, T_len, DQ_ROWS, hd, ld, rc);
  fetch(0);

  // Per thread: rows g and g + 8 of the warp's 16, with their lse and
  // delta (0 past T: those rows are never written).
  const int qr0 = q0 + w0 + g, qr1 = qr0 + 8;
  const long long stat0 = (long long)bh * T_len;
  const float lse0 = qr0 < T_len ? lse[stat0 + qr0] : 0.f;
  const float lse1 = qr1 < T_len ? lse[stat0 + qr1] : 0.f;
  const float dl0 = qr0 < T_len ? delta[stat0 + qr0] : 0.f;
  const float dl1 = qr1 < T_len ? delta[stat0 + qr1] : 0.f;
  float acc[ND][4];
#pragma unroll
  for (int jd = 0; jd < ND; ++jd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[jd][c] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      fetch(kt + 1);  // into the stage the previous iteration released
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile kt (and Q, dO) landed for every thread
    const T* Ks = ring + (kt & 1) * 2 * tile;
    const float* bs = bias_s + (kt & 1) * BK;
    const int k0 = kt * BK;

    // A key tile wholly after the warp's rows has P = 0: it adds nothing.
    if (!(causal && k0 > q0 + w0 + 15)) {
      // p[j][c]: query qr0 (c < 2) or qr1 against key k0 + 8j + 2t + c % 2.
      float p[NT][4];
      product_abt<NT, HDP>(p, Qs + w0 * ld, Ks, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int kj = k0 + 8 * j + 2 * t;
        const float2 bj =
            *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kj + (c & 1);
          float x = p[j][c] * scale + ((c & 1) ? bj.y : bj.x);
          if (causal && key > (c < 2 ? qr0 : qr1)) x = kNegInf;
          p[j][c] = key < T_len ? exp_of<T>(x - (c < 2 ? lse0 : lse1)) : 0.f;
        }
      }
      float ds[NT][4];
      product_abt<NT, HDP>(ds, dOs + w0 * ld, Ks + tile, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ds[j][c] = p[j][c] * (ds[j][c] - (c < 2 ? dl0 : dl1)) * scale;
      product_pb<NT, HDP>(acc, ds, Ks, lane);  // dQ += dS K
    }
    __syncthreads();  // the stage may be refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? qr1 : qr0;
    if (qi >= T_len) continue;
    T* dq_row = dq + gh.base + qi * gh.rs;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * jd + 2 * t + c;
        if (d < hd) dq_row[d] = from_f32<T>(acc[jd][2 * half + c]);
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

// Bytes per cp.async: the widest of 16, 8, 4 that divides a row's bytes
// and every pointer (rows of one tensor then share the alignment, since
// row and head strides are multiples of the row bytes); 2 for bf16 rows
// of odd length, which are copied with plain loads.
template <typename... Ptrs>
int copy_width(size_t row_bytes, Ptrs... ptrs) {
  const uintptr_t all = (reinterpret_cast<uintptr_t>(ptrs) | ...) | row_bytes;
  for (int w = 16; w >= 4; w >>= 1)
    if (all % w == 0) return w;
  return 2;
}

template <int HDP, typename T>
int launch_fwd(const void* q, const void* k, const void* v,
               const float* bias, void* out, float* lse, int B, int T_len,
               int H, int hd, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HDP, T>();
  cudaError_t err = allow_smem(flash_fwd_kernel<HDP, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)B * H * ((T_len + FWD_ROWS - 1) / FWD_ROWS);
  if (blocks > 0x7fffffffLL) return -1;
  flash_fwd_kernel<HDP, T>
      <<<(unsigned)blocks, 32 * FWD_WARPS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), bias, static_cast<T*>(out), lse, T_len,
          H, hd, scale, causal, copy_width(hd * sizeof(T), q, k, v));
  return (int)cudaGetLastError();
}

template <int HDP, typename T>
int launch_dq(const void* q, const void* k, const void* v,
              const float* bias, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int T_len, int H, int hd,
              float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HDP, T>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<HDP, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)B * H * ((T_len + DQ_ROWS - 1) / DQ_ROWS);
  if (blocks > 0x7fffffffLL) return -1;
  flash_bwd_dq_kernel<HDP, T>
      <<<(unsigned)blocks, 32 * DQ_WARPS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse,
          delta, static_cast<T*>(dq), T_len, H, hd, scale, causal,
          copy_width(hd * sizeof(T), q, k, v, dout));
  return (int)cudaGetLastError();
}

template <int HDP, typename T>
int launch_dkv(const void* q, const void* k, const void* v,
               const float* bias, const void* dout, const float* lse,
               const float* delta, float* dk, float* dv, int B, int T_len,
               int H, int hd, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HDP, T>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<HDP, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)B * H * ((T_len + DKV_ROWS - 1) / DKV_ROWS);
  if (blocks > 0x7fffffffLL) return -1;
  flash_bwd_dkv_kernel<HDP, T>
      <<<(unsigned)blocks, 32 * DKV_WARPS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse,
          delta, dk, dv, T_len, H, hd, scale, causal,
          copy_width(hd * sizeof(T), q, k, v, dout));
  return (int)cudaGetLastError();
}

// Returns LAUNCH<HDP, T>(args...) for hd padded to the MMA depth
// (HDP a multiple of 8 for f32, of 16 for bf16, at most 128).
#define KRT_CASE(LAUNCH, T, HDP, ...) \
  case HDP:                           \
    return LAUNCH<HDP, T>(__VA_ARGS__);
#define KRT_CASES_16(LAUNCH, T, ...)      \
  KRT_CASE(LAUNCH, T, 16, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 32, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 48, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 64, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 80, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 96, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 112, __VA_ARGS__)   \
  KRT_CASE(LAUNCH, T, 128, __VA_ARGS__)
#define KRT_CASES_8(LAUNCH, T, ...)       \
  KRT_CASE(LAUNCH, T, 8, __VA_ARGS__)     \
  KRT_CASE(LAUNCH, T, 24, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 40, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 56, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 72, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 88, __VA_ARGS__)    \
  KRT_CASE(LAUNCH, T, 104, __VA_ARGS__)   \
  KRT_CASE(LAUNCH, T, 120, __VA_ARGS__)
#define KRT_DISPATCH_MMA(LAUNCH, hd, dtype, ...)                      \
  do {                                                                \
    if (T_len <= 0 || B <= 0 || H <= 0 || hd <= 0 || hd > 128)        \
      return -1;                                                      \
    if ((dtype) == 0) {                                               \
      switch (padded_hd<float>(hd)) {                                 \
        KRT_CASES_8(LAUNCH, float, __VA_ARGS__)                       \
        KRT_CASES_16(LAUNCH, float, __VA_ARGS__)                      \
      }                                                               \
    } else if ((dtype) == 1) {                                        \
      switch (padded_hd<__nv_bfloat16>(hd)) {                         \
        KRT_CASES_16(LAUNCH, __nv_bfloat16, __VA_ARGS__)              \
      }                                                               \
    }                                                                 \
    return -1;                                                        \
  } while (0)

}  // namespace

extern "C" {

// Each returns 0, -1 for an unsupported shape or dtype, or the
// cudaError_t of the launch. None synchronises.

int krt_flash_fwd(const void* q, const void* k, const void* v,
                  const float* bias, void* out, float* lse, int B, int T_len,
                  int H, int hd, float scale, int causal, int dtype,
                  void* stream) {
  KRT_DISPATCH_MMA(launch_fwd, hd, dtype, q, k, v, bias, out, lse, B, T_len,
                   H, hd, scale, causal, static_cast<cudaStream_t>(stream));
}

int krt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const float* bias, const void* dout, const float* lse,
                     const float* delta, void* dq, int B, int T_len, int H,
                     int hd, float scale, int causal, int dtype,
                     void* stream) {
  KRT_DISPATCH_MMA(launch_dq, hd, dtype, q, k, v, bias, dout, lse, delta,
                   dq, B, T_len, H, hd, scale, causal,
                   static_cast<cudaStream_t>(stream));
}

int krt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const float* bias, const void* dout, const float* lse,
                      const float* delta, float* dk, float* dv, int B,
                      int T_len, int H, int hd, float scale, int causal,
                      int dtype, void* stream) {
  KRT_DISPATCH_MMA(launch_dkv, hd, dtype, q, k, v, bias, dout, lse, delta,
                   dk, dv, B, T_len, H, hd, scale, causal,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
