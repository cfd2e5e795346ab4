"""Measures how fast one SM sub-partition starts warp-level `mma.sync`.

    python3 keras_rs_tpu_torch/kernels/mma_rate.py

Writes a small CUDA program into the build directory, compiles it with
nvcc for sm_90a and runs it: 132 blocks of 1, 2 or 4 warps per scheduler,
each warp running 8 independent accumulator chains of TF32 m16n8k8 or
bf16 m16n8k16 MMAs back to back. Prints nanoseconds per MMA per
scheduler; the flash kernels' MMA counts times this rate is the least
time their design (csrc/flash_attention.cu) can take. The last line is
the card's name, power limit and SM clock.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
template <int KIND>
__global__ void rate(float* out, int iters) {
  float c[8][4];
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  uint32_t b0 = threadIdx.x + 1, b1 = threadIdx.x + 2;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0;
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i) s += c[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  float* out;
  cudaMalloc(&out, 132 * 512 * sizeof(float));
  const int iters = 20000;
  for (int kind = 0; kind < 2; ++kind)
    for (int warps = 1; warps <= 4; warps *= 2) {  // per scheduler
      cudaEvent_t s, e;
      cudaEventCreate(&s);
      cudaEventCreate(&e);
      for (int rep = 0; rep < 2; ++rep) {  // the first run warms up
        cudaEventRecord(s);
        if (kind == 0) rate<0><<<132, 128 * warps>>>(out, iters);
        else rate<1><<<132, 128 * warps>>>(out, iters);
        cudaEventRecord(e);
        cudaEventSynchronize(e);
      }
      float ms;
      cudaEventElapsedTime(&ms, s, e);
      printf("%s, %d warp(s) per scheduler: %.3f ns per MMA per scheduler\n",
             kind == 0 ? "tf32 m16n8k8" : "bf16 m16n8k16", warps,
             ms * 1e6 / ((double)iters * 8 * warps));
    }
  return cudaDeviceSynchronize() != cudaSuccess;
}
"""


def main() -> int:
    from keras_rs_tpu_torch.kernels import loader

    loader.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = loader.BUILD_DIR / "mma_rate.cu"
    exe = loader.BUILD_DIR / "mma_rate"
    src.write_text(SOURCE)
    subprocess.run([loader._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe),
                    str(src)], check=True)
    subprocess.run([str(exe)], check=True)
    subprocess.run(["nvidia-smi",
                    "--query-gpu=name,power.limit,clocks.sm",
                    "--format=csv,noheader"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
