"""Where kernel 6's [782, 782] time goes, by builds of its source with
parts cut out, and how the tensor cores take its two kinds of product.

Builds ``csrc/df2scan.cu`` apart from the fit's library
(``build/mf_torch_kernels_probe/``), as shipped and cut three ways:

  * "tile only": the move to the chain's owners, the chain and the row
    minima cut; each lane folds its Gram sums into one value;
  * "no copies": "tile only" with the chunks' copies cut too (the ``mma``
    read whatever shared memory holds);
  * "no int8 mma": "no copies" with the level products cut too;

and times each (CUDA events, mean of ``--reps``) on one chunk of the
flagship workload (552 sequences, 782 atoms, seed 0: the two rotated
blocks of its first ``chunk`` voxels), in turns: shipped, cuts, cuts,
shipped. The cut builds compute wrong answers: they time parts of the
kernel and are never the fit's. Then a micro-benchmark of ``mma.sync``
alone, 2 blocks of 256 threads an SM, per warp and step: 16 float64
m16n8k8; 16 int8 m16n8k32; 16 float64 + 8 int8 (kernel 6's mix); 16
float64 + 64 float32-to-float64 conversions feeding them (kernel 6's
ratio). It prints the card's name and power limit.

    python -m microstructure_fingerprinting_torch.examples.df2_probe \\
        [chunk] [--reps 3]
"""

import argparse
import os
import subprocess
import tempfile

import numpy as np
import torch

from .. import testing as mft
from ..ops import dfscan, kernels
from ..ops import interp as mfi
from . import trials

#: the folded Gram sums that stand for the chain in the "tile only" cut
_FOLD = """    if (live) {
      double d = 0.0;
      int s = 0;
      for (int n = 0; n < NT; ++n)
        for (int i = 0; i < 4; ++i) s += t11[n][i] + t12[n][i] + t22[n][i];
      for (int m = 0; m < 2; ++m)
        for (int n = 0; n < NT; ++n)
          for (int e = 0; e < 2; ++e) d += c1[m][n][e] + c2[m][n][e];
      s += (int)d;
      if (s < best_key[0]) {
        best_key[0] = s;
        best_j[0] = col0;
      }
    }
"""


_TILE_ONLY = trials.span("df2scan.cu", "    MF_PHASE(0);\n",
                         "    MF_PHASE(2);\n", _FOLD)
_NO_COPIES = trials.swap("df2scan.cu",
                         "    if (k < steps) {\n      Chunk& f",
                         "    if (false) {\n      Chunk& f")
_NO_INT8 = [trials.swap("df2scan.cu",
                        "          mf::mma_s8(t%s[n], qa%s, qb%s[n]);\n" % x,
                        "")
            for x in (("11", "1", "1"), ("12", "1", "2"), ("12", "2", "1"),
                      ("22", "2", "2"))]
#: the cut builds of df2scan.cu (``trials`` cuts)
CUTS = {"shipped": [], "tile only": [_TILE_ONLY],
        "no copies": [_TILE_ONLY, _NO_COPIES],
        "no int8 mma": [_TILE_ONLY, _NO_COPIES] + _NO_INT8}

MICRO = r"""
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double a2, double a3, double b0,
                                     double b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}
__device__ __forceinline__ void imma(int (&d)[4], const int (&a)[4],
                                     const int (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ double cvt(float x) {
  double d;
  asm volatile("cvt.f64.f32 %0, %1;" : "=d"(d) : "f"(x));
  return d;
}
// per step: F float64 mma, I int8 mma, C conversions feeding the float64
template <int F, int I, int C>
__global__ void __launch_bounds__(256, 2) bench(const float* in, double* out,
                                                int iters) {
  const int lane = threadIdx.x % 32;
  float x[16];
  for (int u = 0; u < 16; ++u) x[u] = in[(lane + u) % 64];
  double acc[8][4] = {};
  int ti[4][4] = {};
  const int qa[4] = {lane, lane + 1, lane + 2, lane + 3}, qb[2] = {lane, 7};
  double a[8], b[8];
  for (int u = 0; u < 8; ++u) { a[u] = x[u]; b[u] = x[8 + u]; }
  for (int it = 0; it < iters; ++it) {
    #pragma unroll
    for (int k = 0; k < I; ++k) imma(ti[k % 4], qa, qb);
    #pragma unroll
    for (int k = 0; k < F / 4; ++k) {
      if (C) {
        #pragma unroll
        for (int u = 0; u < 8; ++u) { a[u] = cvt(x[u]); b[u] = cvt(x[8 + u]); }
      }
      #pragma unroll
      for (int n = 0; n < 2; ++n) {
        dmma(acc[2 * (k % 2) + n], a[0], a[1], a[2], a[3], b[2 * n],
             b[2 * n + 1]);
        dmma(acc[4 + 2 * (k % 2) + n], a[4], a[5], a[6], a[7], b[4 + 2 * n],
             b[5 + 2 * n]);
      }
    }
    #pragma unroll
    for (int u = 0; u < 16; ++u)
      x[u] = __uint_as_float(__float_as_uint(x[u]) ^ (it & 1));
  }
  double s = ti[0][0] + ti[1][1] + ti[2][2] + ti[3][3];
  for (int k = 0; k < 8; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  if (s == 12345.0) out[threadIdx.x] = s;
}
template <int F, int I, int C>
void run(const char* name, const float* in, double* out, int blocks) {
  const int iters = 20000;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  bench<F, I, C><<<blocks, 256>>>(in, out, 10);
  cudaEventRecord(a);
  bench<F, I, C><<<blocks, 256>>>(in, out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  const double steps = (double)iters * blocks * 8;
  printf("micro %-34s %8.3f ms  float64 %6.2f TFLOP/s  int8 %7.1f TOP/s%s\n",
         name, ms, steps * F * 2048.0 / (ms * 1e9),
         steps * I * 8192.0 / (ms * 1e9),
         cudaGetLastError() == cudaSuccess ? "" : "  (launch failed)");
}
int main() {
  float* in;
  double* out;
  cudaMalloc(&in, 64 * sizeof(float));
  cudaMalloc(&out, 256 * sizeof(double));
  float h[64];
  for (int i = 0; i < 64; ++i) h[i] = 0.01f * (i + 1);
  cudaMemcpy(in, h, sizeof(h), cudaMemcpyHostToDevice);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  run<16, 0, 0>("16 float64 mma", in, out, 2 * sms);
  run<0, 16, 0>("16 int8 mma", in, out, 2 * sms);
  run<16, 8, 0>("16 float64 + 8 int8 mma", in, out, 2 * sms);
  run<16, 0, 1>("16 float64 mma + 64 conversions", in, out, 2 * sms);
  return 0;
}
"""


def sources():
    """The text of each cut build: {build: {"df2scan.cu": text}}; raises
    where the shipped file no longer holds the text a cut replaces."""
    return trials.sources("df2_probe", ("df2scan.cu",), CUTS)


def _builds(where):
    """Each cut of df2scan.cu compiled into its own library and the
    micro-benchmark's executable (all nvcc at once). Returns (libraries
    by cut, executable)."""
    micro = os.path.join(where, "micro")
    with open(micro + ".cu", "w") as f:
        f.write(MICRO)
    job = subprocess.Popen(
        [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-o", micro, micro + ".cu"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    libs, _outs = trials.compile_all("df2_probe", where, sources())
    out = job.communicate()[0]
    if job.returncode:
        raise RuntimeError("df2_probe: nvcc failed:\n%s" % out)
    return libs, micro


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chunk", nargs="?", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("df2_probe needs a CUDA device")
    dev = torch.device("cuda")
    print("card: %s" % trials.card())
    where = kernels.BUILD_DIR + "_probe"
    os.makedirs(where, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=where) as tmp:
        libs, micro = _builds(tmp)
        wl = mft.make_fit_workload(num_atom=782, n_vox=args.chunk,
                                   device="cuda")
        rotate, perm = mfi.make_grouped_rotation_paired(wl["msinterp"],
                                                        wl["plan"])
        _x, ys_t, _c = wl["msinterp"].device_tables(dev, torch.float32)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=dev)
        D = rotate(ys_t, f32(wl["peaks"]))
        ops, _yn = dfscan.df2_scan_operands(D[:, 0].contiguous(),
                                            D[:, 1].contiguous(),
                                            f32(wl["y"][:, perm]))
        del D
        B, S, N1p = ops[0].shape
        N2pb = ops[4].shape[2]
        row_val = torch.empty(B, N1p, device=dev)
        row_i2 = torch.empty(B, N1p, dtype=torch.int32, device=dev)
        calls = {}
        for name, path in libs.items():
            fn = trials.bind(path, ("df2scan",)).mf_df2scan
            calls[name] = (lambda fn=fn: fn(
                *[o.data_ptr() for o in ops], row_val.data_ptr(),
                row_i2.data_ptr(), B, S, N1p, N2pb, 782, 782,
                torch.cuda.current_stream().cuda_stream))
        out = {}
        order = list(CUTS) + list(CUTS)[1:][::-1] + ["shipped"]
        for name in order:
            if calls[name]():
                raise RuntimeError("df2_probe: %s failed to launch" % name)
            out.setdefault(name, []).append(
                trials.ms(calls[name], args.reps))
        for name, ms in out.items():
            print("kernel 6 %-12s %d voxels, 782 x 782: %s ms" % (
                name, B, " / ".join("%.3f" % m for m in ms)))
        print(subprocess.run([micro], capture_output=True, text=True,
                             check=True).stdout, end="")
    return out


if __name__ == "__main__":
    main()
