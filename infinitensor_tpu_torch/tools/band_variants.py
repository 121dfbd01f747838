"""Where the ring form of the band kernels spends its time: patched copies
of kernels/csrc/band_ring.cu, each built under build/band_variants/<name>/
and timed in its own process (two libraries with the same kernel names in
one process fail their launches above 48 KB of shared memory), at
chip_smoke.py phase 3's band shapes: phase 13's (bz 8, S 2048, D 128, w
64) in f32 and bf16, and Longformer-base's attention (bz 12, S 4096, D 64,
w 256) in bf16.

    python -m infinitensor_tpu_torch.tools.band_variants [variant ...]

Variants, each the source with what it names changed:
  route         the source as it is;
  three_stages  a ring of 3 window (and P) tiles, not 2;
  pairs         gbmm's P tiles copied 4 bytes (a bf16 pair) at a time at
                every w, not 16 bytes where w is a multiple of 4;
  fragments     g2bmm's bf16 scores stored from the mma fragments (16
                bytes to a row, a word a lane), not through the warp's
                stage a row at a time;
  no_mma        no products (g2bmm's n8 groups, gbmm's k16 steps);
  no_window     no copies of B's window tiles;
  no_p          no copies of gbmm's P tiles;
  no_store      no stores of the outputs.
Outputs of the last four are wrong by design; the others are held to the
plain versions (max abs error over max|plain| printed). A time is the
median of 50 CUDA-event timings after a 1 GB memset (cold L2). Prints the
card (nvidia-smi name and power limit) and one JSON line per variant
{case: ms}; writes chiprun_out/band_variants.json.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "infinitensor_tpu_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "band_variants"
SRC = "band_ring.cu"
EXACT = ("route", "three_stages", "pairs", "fragments")

# g2bmm's bf16 tile with its stores from the fragments: each lane's pair
# (c, c + 1) of rows g and g + 8, 0 where c is no row of B
_FRAGMENTS = r'''template <int KP>
__device__ __forceinline__ void g2_tile_bf16(const Walk& x,
                                             const uint32_t (&qa)[KP / 16][4],
                                             const bf16* tb, bf16* st, bf16* band,
                                             int c0) {
  const int lane = x.lane, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int fc = c0 + 8 * f;
    if (fc > x.i0 + 15 + 2 * x.w || fc + 7 < x.i0) continue;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (fc <= x.hi && fc + 7 >= x.lo) {
#pragma unroll
      for (int k2 = 0; k2 < KP / 32; ++k2) {
        if (32 * k2 >= x.kp) break;
        uint32_t bq[4];
        ldsm_x4(bq, smem_addr(tb + (8 * f + (lane & 7)) * x.ld + 32 * k2 +
                              8 * (lane >> 3)));
        mma16816<kXBf16>(s, qa[2 * k2], bq[0], bq[1]);
        mma16816<kXBf16>(s, qa[2 * k2 + 1], bq[2], bq[3]);
      }
    }
    const int c = fc + 2 * t4;
    const uint32_t keep = (in_rows(x, c) ? 0xffffu : 0u) | (in_rows(x, c + 1) ? 0xffff0000u : 0u);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = x.i0 + g + 8 * h;
      const bool v0 = in_band(x, i, c), v1 = in_band(x, i, c + 1);
      const uint32_t word = pack_out<kXBf16>(s[2 * h], s[2 * h + 1]) & keep;
      bf16* d = band + (size_t)i * x.J + (c + 1 - i);
      if (v0 && v1)
        *reinterpret_cast<uint32_t*>(d - 1) = word;
      else if (v0)
        *reinterpret_cast<uint16_t*>(d - 1) = (uint16_t)(word & 0xffffu);
      else if (v1)
        *reinterpret_cast<uint16_t*>(d) = (uint16_t)(word >> 16);
    }
  }
}

'''


def variants() -> dict:
    """{name: source text}: the route's source and its patched copies."""
    src = (CSRC / SRC).read_text()
    a = src.index("template <int KP>\n__device__ __forceinline__ void g2_tile_bf16")
    b = src.index("// gbmm, bf16: in the copy")
    patches = {
        "three_stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
        "pairs": [("OP == kG && (w & 3) == 0 ? 8 : 2;", "2;")],
        "fragments": [(src[a:b], _FRAGMENTS)],
        "no_mma": [("    if (fc <= x.hi && fc + 7 >= x.lo) {", "    if (x.w < 0) {"),
                   ("    if (kc > x.hi || kc + 15 < x.lo) continue;",
                    "    if (x.w >= 0) continue;")],
        "no_window": [("    if (has_rows(c0, c_lo, c_hi))\n      load_tile(",
                       "    if (w < 0)\n      load_tile(")],
        "no_p": [("    if (OP == kG)\n      load_p_tile(", "    if (OP == kG && w < 0)\n      load_p_tile(")],
        "no_store": [
            ("      *reinterpret_cast<uint32_t*>(band + (size_t)(x.i0 + ii)",
             "      if (x.w < 0) *reinterpret_cast<uint32_t*>(band + (size_t)(x.i0 + ii)"),
            ("    if (!(v0 || v1)) continue;", "    if (!(v0 || v1) || x.w >= 0) continue;"),
            ("        band[(size_t)i * x.J + (c - i)] = full",
             "        if (x.w < 0) band[(size_t)i * x.J + (c - i)] = full"),
            ("          if (i < nrows && col < k)", "          if (i < nrows && col < k && w < 0)"),
            ("          if (i < nrows && 8 * n < k)", "          if (i < nrows && 8 * n < k && w < 0)")],
    }
    out = {"route": src}
    for name, subs in patches.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old.strip()[:60]!r} is not in {SRC}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(names) -> list:
    """Compile the named variants, one nvcc each, all at once; returns the
    names that built."""
    from infinitensor_tpu_torch.kernels import _build

    procs = {}
    for name, text in variants().items():
        if names and name not in names:
            continue
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / SRC).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-o",
               str(d / "lib.so"), str(d / SRC)]
        procs[name] = subprocess.Popen(cmd, stdout=open(d / "log", "w"),
                                       stderr=subprocess.STDOUT)
    built = []
    for name, proc in procs.items():
        if proc.wait():
            print(f"# {name}: build failed\n"
                  + (OUT / name / "log").read_text()[-2000:], flush=True)
        else:
            built.append(name)
    return built


def time_variant(name: str) -> dict:
    """{case: ms} of the variant's library behind the band wrappers."""
    import torch

    import chip_smoke as cs
    from infinitensor_tpu_torch.kernels import _build, band

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    P, I = _build.P, _build.I
    for fn in ("g2bmm_ring", "gbmm_ring"):
        getattr(lib, fn).argtypes = [P, P, P, I, I, I, I, I, P]
        getattr(lib, fn).restype = I
    lib.itt_error_string.argtypes = [I]
    lib.itt_error_string.restype = ctypes.c_char_p
    band._lib_ring = lambda: lib
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    res = {}
    for label, shape, dtype in (("phase 13 f32", cs.LF, torch.float32),
                                ("phase 13 bf16", cs.LF, torch.bfloat16),
                                ("longformer-base bf16", cs.LF_BASE,
                                 torch.bfloat16)):
        q, k, v, wts = cs.band_inputs(torch, shape, dtype, gen, dev)
        w = shape["w"]
        for op, fn, plain, first, b in (
                ("g2bmm", band.g2bmm_band, band.g2bmm_plain, q, k),
                ("gbmm", band.gbmm_band, band.gbmm_plain, wts, v)):
            case = f"{op} {label}"
            if name in EXACT:
                want = plain(first, b, w).float()
                res[case + " err"] = ((fn(first, b, w).float() - want).abs().max()
                                      / want.abs().max()).item()
            res[case] = cs.cuda_ms(
                torch, lambda f=fn, a=first, b=b, w=w: f(a, b, w), 50, flush)
    return res


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--time":
        print(json.dumps(time_variant(sys.argv[2])), flush=True)
        return
    import chip_smoke as cs

    print(f"# {cs.smi_line()}", flush=True)
    report = {}
    for name in build(sys.argv[1:]):
        out = subprocess.run(
            [sys.executable, "-m", "infinitensor_tpu_torch.tools.band_variants",
             "--time", name], cwd=ROOT, capture_output=True, text=True)
        if out.returncode:
            print(f"# {name}: failed\n{out.stderr[-2000:]}", flush=True)
            continue
        report[name] = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{name} {json.dumps(report[name])}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "band_variants.json").write_text(
        json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
