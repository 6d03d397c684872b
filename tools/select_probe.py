#!/usr/bin/env python3
"""Probes behind select_v4's design, on one NVIDIA GPU.

    python3 tools/select_probe.py [--atomics] [--phases]

--atomics builds and runs two small CUDA programs (nvcc, into the
git-ignored vosk_tpu_torch/_build/probe/): 256 threads of one CTA of a
2-CTA cluster take the minimum of their values into a word of the other
CTA's shared memory by 64-bit atomicMin (generic and shared::cluster
addressing), by a 64-bit compare-and-swap loop and by 32-bit atomicMin,
and into their own CTA's word by 64-bit atomicMin; each result is printed
beside the true minimum.  Then cudaOccupancyMaxActiveClusters per cluster
size for 1024-thread CTAs at 100 KB and at 200 KB of shared memory (pass
2's CTAs take 64 registers a thread, so one an SM, as at 200 KB).

--phases copies vosk_tpu_torch into vosk_tpu_torch/_build/phase_profile/
with %globaltimer stamps added to select_v4's pass 2 (rank 0, thread 0 of
each channel's cluster, at each phase boundary, into an enlarged stats
buffer) and prints, per frame of chip_smoke.py (under load at B = 32 and
B = 1, light at B = 32 and B = 1, split), the kernel's time and the mean
microseconds of each phase over the channels, the slowest channel's total,
the radix rounds and the cluster size.  The stamps cost a store each; the
copy's results are not checked.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "vosk_tpu_torch" / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

ATOMICS = r"""
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;
__global__ void __cluster_dims__(2, 1, 1) k(int mode, unsigned long long* out) {
  __shared__ unsigned long long v64;
  __shared__ unsigned v32;
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) { v64 = ~0ull; v32 = ~0u; }
  cl.sync();
  unsigned long long val = (0x80000000ull + 1000 - threadIdx.x) << 32 | threadIdx.x;
  if (cl.block_rank() == 0 || mode == 3) {
    unsigned long long* p = mode == 3 ? &v64 : cl.map_shared_rank(&v64, 1);
    if (mode == 0 || mode == 3) {
      atomicMin(p, val);
    } else if (mode == 1) {
      unsigned long long old = *(volatile unsigned long long*)p;
      while (val < old) {
        const unsigned long long seen = atomicCAS(p, old, val);
        if (seen == old) break;
        old = seen;
      }
    } else if (mode == 2) {
      atomicMin(cl.map_shared_rank(&v32, 1), (unsigned)(val >> 32));
    } else {
      unsigned a = (unsigned)__cvta_generic_to_shared(&v64), ra;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(a), "r"(1));
      asm volatile("atom.shared::cluster.min.u64 %0, [%1], %2;" : "=l"(val) : "r"(ra), "l"(val)
                   : "memory");
    }
  }
  cl.sync();
  if (threadIdx.x == 0 && cl.block_rank() == (mode == 3 ? 0 : 1))
    out[mode] = mode == 2 ? (unsigned long long)v32 << 32 : v64;
}
__global__ void __launch_bounds__(1024, 1) occ(int* p) {
  extern __shared__ int s[];
  if (p) p[threadIdx.x] = s[threadIdx.x];
}
int main() {
  unsigned long long* d;
  cudaMalloc(&d, 64);
  for (int m = 0; m < 5; ++m) k<<<2, 256>>>(m, d);
  unsigned long long h[5];
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  const unsigned long long want = (0x80000000ull + 1000 - 255) << 32 | 255;
  const char* names[5] = {"64-bit atomicMin into the other CTA (generic address)",
                          "64-bit compare-and-swap loop into the other CTA",
                          "32-bit atomicMin into the other CTA (high word)",
                          "64-bit atomicMin into the CTA's own word",
                          "64-bit atom.shared::cluster.min into the other CTA"};
  for (int m = 0; m < 5; ++m)
    printf("%s: %llx, the minimum is %llx: %s\n", names[m], h[m],
           m == 2 ? want >> 32 << 32 : want,
           h[m] == (m == 2 ? want >> 32 << 32 : want) ? "right" : "WRONG");
  for (int smem : {102400, 200 * 1024}) {
    cudaFuncSetAttribute(occ, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    for (int C = 2; C <= 8; ++C) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(C * 64);
      cfg.blockDim = dim3(1024);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute a;
      a.id = cudaLaunchAttributeClusterDimension;
      a.val.clusterDim.x = C;
      a.val.clusterDim.y = a.val.clusterDim.z = 1;
      cfg.attrs = &a;
      cfg.numAttrs = 1;
      int n = -1;
      cudaOccupancyMaxActiveClusters(&n, occ, &cfg);
      printf("1024-thread CTAs, %d bytes of shared memory, clusters of %d: %d at once\n", smem,
             C, n);
    }
  }
  return 0;
}
"""

# (anchor in csrc/frame_step.cu, stamp slot): the stamp goes before the anchor
STAMPS = [
    ("  const int32_t best = chan_best[b];\n", 0),
    ("  if (r == 0 && tid == 0) {\n    chan_best[b] = kBig;", 1),
    ("  // 3. L into its buckets; D's in-beam candidates into the table.", 2),
    ("  const int n_win = cluster_reduce(cluster, &ctl.n_new, &s_int[3], C);\n", 3),
    ("  // 4. the K first winners by (key, state) into their buckets;", 5),
    ("  walk_slots([&](bool occ, uint32_t u, uint32_t st) {\n    const bool take", 6),
    ("  // 5b. this CTA's bucket of W in order: the frontier and its records\n", 7),
    ("  // the rows past the kept winners and past L, over the whole cluster\n", 9),
    ("  // 6. wk over the cluster; this CTA's lattice rows above wk + lattice_beam\n", 10),
]
PHASES = [("first barrier", 0, 1), ("cuts", 1, 2), ("inserts", 2, 3),
          ("L ranked (heavy)", 3, 5), ("winners' cut", 5, 6), ("W to buckets", 6, 7),
          ("W ranked, frontier", 7, 9), ("tails, last barrier", 9, 10), ("lattice drop", 10, 11)]


def stamp(slot: int, value: str = "gtime()") -> str:
    return ("  if (r == 0 && tid == 0 && stats) reinterpret_cast<unsigned long long*>("
            f"stats + 4 * (gridDim.x / C))[b * 16 + {slot}] = {value};\n")


def instrumented_copy() -> Path:
    """vosk_tpu_torch with pass-2 stamps, under _build/phase_profile."""
    dst = BUILD / "phase_profile"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "vosk_tpu_torch", dst / "vosk_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = dst / "vosk_tpu_torch" / "csrc" / "frame_step.cu"
    s = cu.read_text().replace("struct SelectCtl {", """__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
struct SelectCtl {""", 1)
    for anchor, slot in STAMPS:
        if anchor not in s:
            raise SystemExit(f"frame_step.cu changed: no anchor {anchor!r}")
        s = s.replace(anchor, stamp(slot) + anchor, 1)
    end = "      rec_lat_cost[bR + lat_off + i] = INFINITY;\n    }\n  }\n}\n"
    if end not in s:
        raise SystemExit("frame_step.cu changed: no end of pass 2")
    s = s.replace(end, end[:-2] + stamp(11) + stamp(12, "round") + stamp(13, "C") + "}\n", 1)
    cu.write_text(s)
    py = dst / "vosk_tpu_torch" / "ops" / "frame_step.py"
    py.write_text(py.read_text().replace(
        '        _check_2d("stats", stats, torch.int32, B, 3)\n', ""))
    return dst / "vosk_tpu_torch"


def phases(torch, cs):
    from vosk_tpu_torch.ops import frame_step as fs

    pkg = instrumented_copy()
    spec = importlib.util.spec_from_file_location(
        "probe_vtt", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["probe_vtt"] = mod
    spec.loader.exec_module(mod)
    pfs = importlib.import_module("probe_vtt.ops.frame_step")

    def run(name, dec, fr, ll, valid):
        pool = fs.expand_v4(dec.em_pack, fr["state"], fr["cost"], ll[:, -1],
                            dec.params.acoustic_scale, dec.S, dec.M, dec.mbits)
        B = fr["state"].shape[0]
        args = (*pool, fr, valid, dec.params.beam, dec.params.lattice_beam, dec.S, dec.mbits,
                dec.K2, dec.R)
        out, sc = dec.record_buffers((B,)), pfs.SelectScratch()
        st = torch.zeros(36 * B, dtype=torch.int32, device="cuda")
        for _ in range(3):
            pfs.select_v4(*args, out, scratch=sc, stats=st)
        torch.cuda.synchronize()
        t = st[4 * B:].view(torch.int64).view(B, 16).cpu().double()
        d = {k: round(float((t[:, j] - t[:, i]).mean()) / 1e3, 2) for k, i, j in PHASES}
        d["total"] = round(float((t[:, 11] - t[:, 0]).mean()) / 1e3, 2)
        d["slowest channel"] = round(float((t[:, 11] - t[:, 0]).max()) / 1e3, 2)
        d["rounds"] = float(t[:, 12].mean())
        d["C"] = float(t[:, 13].mean())
        ms = cs.event_ms(torch, lambda: pfs.select_v4(*args, out, scratch=sc))
        cs.log(f"{name}: kernel {ms:.6f} ms; pass 2, us a channel: {json.dumps(d)}")

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        bm = cs.phase_model(torch, dev, tmp)
        dec, P = bm._pipeline.dec, bm._model.am_config.num_pdfs
        ones = torch.ones(cs.B, dtype=torch.bool, device=dev)
        fr, ll = cs.loaded_frame(torch, bm)
        run("under load B=32", dec, fr, ll, ones)
        run("under load B=1", dec, {k: v[:1].contiguous() for k, v in fr.items()}, ll[:1],
            ones[:1])
        g = torch.Generator().manual_seed(cs.SEED + 5)
        ll = (torch.randn((cs.B, 7, P), generator=g) * 2.0).to(dev)
        fr, _, _, _ = dec.decode_chunk(dec.init_frontier(cs.B), ll[:, :6])
        run("light B=32", dec, fr, ll, ones)
        run("light B=1", dec, {k: v[:1].contiguous() for k, v in fr.items()}, ll[:1], ones[:1])
        del bm, dec
        _, _, (d_main, _) = cs.phase_split(torch, tmp)
        run("split B=1", d_main, *cs.real_frame(torch, d_main, P, cs.SEED + 9))


def main() -> int:
    import torch

    args = set(sys.argv[1:]) or {"--atomics", "--phases"}
    if not args <= {"--atomics", "--phases"}:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("select_probe.py needs a CUDA device; none is visible")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip())
    if "--atomics" in args:
        d = BUILD / "probe"
        d.mkdir(parents=True, exist_ok=True)
        (d / "atomics.cu").write_text(ATOMICS)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(d / "atomics"), str(d / "atomics.cu")],
                       check=True)
        cs.log(subprocess.run([str(d / "atomics")], capture_output=True, text=True,
                              check=True).stdout.rstrip())
    if "--phases" in args:
        phases(torch, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
