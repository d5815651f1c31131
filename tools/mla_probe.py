"""Where the bf16 MLA kernel's time goes, on one H100 (needs a CUDA card
and nvcc):

  python tools/mla_probe.py

Builds the tensor-core kernel of csrc/paged_attention_mla.cu with source
cuts selected at run time: each CTA leaves after staging its q terms (1),
skips all but the key gathers and its partial S (2), skips the PV product
(3), or runs whole (0); cuts 2 and 3 still store the output. Each cut is
timed at chip_smoke.py's MLA shapes, with one key split, as chip_smoke
times kernels (CUDA-graph replay over inputs cycled past L2). Prints one
JSON line per shape, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import device_time_ms, mla_case  # noqa: E402
from repro_torch.kernels import _launch as L  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

CASES = {  # label -> mla_case kwargs (chip_smoke.py's MLA rows)
    "decode B=4 H=128 r=512 nb=18": dict(b=4, c=1, past=[40, 51, 60, 71]),
    "prefill B=4 C=32 H=128 r=512 nb=18": dict(b=4, c=32, past=[0, 16, 24, 40]),
    "decode B=4 H=128 r=512 nb=1024": dict(b=4, c=1, past=[3900, 4000, 4050, 4095], nb=1024),
}
CUTS = {1: "q staged", 2: "+ key gathers and partial S", 3: "+ exchange and softmax",
        0: "whole"}
# (start of an anchor line in the kernel, its indentation aside; code
# inserted before it). bar.sync 1: the wgmma warpgroup's own barrier.
CUT_POINTS = (
    ("  for (int t = t_begin; t < t_end; ++t) {\n",
     "  if (g_mla_cut == 1) {\n    hopper::cp_async_wait<0>();\n"
     "    out[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 128 + threadIdx.x] =\n"
     "        reinterpret_cast<const float*>(q_s)[threadIdx.x];\n    return;\n  }\n"),
    ("    // S = the two partials (a + b == b + a: both CTAs hold the same S)\n",
     "    if (g_mla_cut == 2) {\n      o[0][0] += sc[tid % 32];\n"
     "      asm volatile(\"bar.sync 1, 128;\" ::: \"memory\");\n      continue;\n    }\n"),
    ("    // O += P . ckv over this CTA's latent chunks (the key tile, MN-major)\n",
     "    if (g_mla_cut == 3) {\n      o[0][0] += __uint_as_float(pa[0][0][0] ^ pa[1][3][3]);\n"
     "      goto pv_done;\n    }\n"),
    ("    __syncthreads();  // this key stage", "  pv_done:\n"),
)
SET_CUT = """
extern "C" int mla_probe_set_cut(int cut) {
  return (int)cudaMemcpyToSymbol(g_mla_cut, &cut, sizeof(int));
}
"""
SCALE = (128 + 64) ** -0.5


def cut_library() -> ctypes.CDLL:
    """csrc/paged_attention_mla.cu with the run-time cuts, built as
    libmla_probe.so."""
    src = (build.SRC_DIR / "paged_attention_mla.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n__device__ int g_mla_cut;\n", 1)
    lines = src.split("\n")
    for anchor, code in CUT_POINTS:  # before the line that starts with `anchor`
        at = [i for i, line in enumerate(lines) if line.strip().startswith(anchor.strip())]
        if len(at) != 1:
            raise RuntimeError(f"anchor not found once: {anchor.strip()}")
        lines[at[0]] = code + lines[at[0]]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / "mla_probe.cu"
    path.write_text("\n".join(lines) + SET_CUT)
    out = build.BUILD_DIR / "libmla_probe.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR), "-o", str(out),
           str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.mla_probe_set_cut.argtypes = [ctypes.c_int]
    lib.paged_prefill_mla.restype = ctypes.c_int
    lib.paged_prefill_mla.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    lib = cut_library()

    def run(q_lat, q_rope, pc, pr, tables, past, lengths):  # bf16 pools, one key split
        b, c, h, r = q_lat.shape
        out = torch.empty_like(q_lat)
        ptrs = [L.ptr(t) for t in (q_lat, q_rope, pc, pr, tables, past, lengths, out)]
        err = lib.paged_prefill_mla(*ptrs, None, None, b, c, h, r, q_rope.shape[-1],
                                    pc.shape[1], tables.shape[1], 1, SCALE, 1, L.stream(q_lat))
        build.check(err, "mla_probe")
        return out

    gen = torch.Generator().manual_seed(0)
    for label, kw in CASES.items():
        first = mla_case(torch.bfloat16, dev=dev, gen=gen, **kw)
        n_sets = max(1, min(32, -(-2 * 50 * 2 ** 20 // first["held"])))
        sets = [first["args"]] + [mla_case(torch.bfloat16, dev=dev, gen=gen, **kw)["args"]
                                  for _ in range(n_sets - 1)]
        line = dict(case=label, bound_ms=first["bound"][0])
        for cut, name in CUTS.items():
            build.check(lib.mla_probe_set_cut(cut), "mla_probe_set_cut")
            torch.cuda.synchronize()
            line[name] = device_time_ms(run, sets)
        got = run(*first["args"])  # whole kernel (cut 0): still right
        line["whole_max_abs_err"] = float((got - first["plain"](*first["args"])).abs().max())
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
