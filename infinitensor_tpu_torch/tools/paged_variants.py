"""Where the paged decode's ring form spends its time: patched copies of
kernels/csrc/paged_flash_decode_ring.cu, each built under
build/paged_variants/<name>/ and timed in its own process (two libraries
with the same kernel names in one process fail their launches above 48 KB
of shared memory), at chip_smoke.py phase 3's paged shapes: 8 slots,
pages of 64 rows, pos 693-1501, a shuffled table; MHA 32/32 and GQA 32/8;
INT8 and bf16 pages; chunks of 3 pages (GQA's route) and the whole table
(MHA's route).

    python -m infinitensor_tpu_torch.tools.paged_variants

Variants: "route" (the source as it is), "no_consumer" (the copies and
their waits, no scores, softmax or PV), "no_copies" (the consumer over
whatever the ring holds, no copy issued), "empty" (no stage: the launch,
q, the page ids, the block's and the chunks' merge), "no_merge" (every
block returns once its partial is written). Outputs of the patched
variants are wrong by design; only "route" is held to the block form's
output (max abs error printed). A time is the median of 50 CUDA-event
timings after a 1 GB memset (cold L2). Prints the card (nvidia-smi name
and power limit) and one JSON line per variant {case: ms}; writes
chiprun_out/paged_variants.json.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "infinitensor_tpu_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "paged_variants"
SRC = "paged_flash_decode_ring.cu"


def variants() -> dict:
    """{name: source text}: the route's source and its patched copies."""
    src = (CSRC / SRC).read_text()
    patches = {
        "no_consumer": [("    if (rows <= 0) continue;", "    continue;")],
        "no_copies": [(a, a.replace("cp_async", "if (0) cp_async")) for a in (
            "        cp_async16(slot + j * RB", "        cp_async16(slot + (kWR + j)",
            "          cp_async4(slot + 2 * kWR")],
        "empty": [("  const int n_st = (end - begin + kBR - 1) / kBR;",
                   "  const int n_st = 0 * ((end - begin + kBR - 1) / kBR);")],
        "no_merge": [("  if (chunks == 1) return;", "  return;")],
    }
    out = {"route": src}
    for name, subs in patches.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old.strip()!r} is not in {SRC}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build() -> list:
    """Compile every variant, one nvcc each, all at once; returns the names
    that built."""
    from infinitensor_tpu_torch.kernels import _build

    procs = {}
    for name, text in variants().items():
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
    """{case: ms} of the variant's library behind the paged wrappers."""
    import torch

    import chip_smoke as cs
    from infinitensor_tpu_torch.kernels import _build
    from infinitensor_tpu_torch.kernels import paged_attention as pa

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    P_, I, F = _build.P, _build.I, _build.F
    for fn, argtypes in (
            ("paged_flash_decode_q8_ring", [P_, I] + [P_] * 9 + [I] * 7 + [F, P_]),
            ("paged_flash_decode_ring", [P_, I] + [P_] * 7 + [I] * 7 + [F, P_])):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I
    lib.itt_error_string.argtypes = [I]
    lib.itt_error_string.restype = ctypes.c_char_p
    pa._ring_lib = lambda: lib
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    B, D, P = cs.SLOTS, 128, cs.PAGE
    MP = cs.MAX_SEQ // P
    N = B * MP + 1
    pos = torch.tensor(cs.PAGED_POS[:B], dtype=torch.int32, device=dev)
    table = (torch.randperm(N - 1, generator=gen, device=dev)[:B * MP]
             + 1).reshape(B, MP).to(torch.int32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {}
    for H, Hkv in ((32, 32), (32, 8)):
        q = torch.randn(B, H, 1, D, generator=gen, device=dev).to(
            torch.bfloat16)
        kq, vq = (torch.randint(-127, 128, (N, Hkv, P, D), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        sc = [torch.rand(N, Hkv, P, generator=gen, device=dev) * 0.015
              + 0.005 for _ in range(2)]
        kb, vb = (torch.randn(N, Hkv, P, D, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        route = pa.ring_chunks(B, Hkv, MP, sms)[0]
        for kind, fn, args in (
                ("int8", pa.paged_flash_decode_q8,
                 (q, kq, vq, *sc, table, pos)),
                ("bf16", pa.paged_flash_decode, (q, kb, vb, table, pos))):
            for C in sorted({route, 3, MP}):
                case = f"{H}/{Hkv} {kind} C{C}"
                if name == "route":
                    err = (fn(*args, _chunk_pages=C).float()
                           - fn(*args, _form="block").float()).abs().max()
                    res[case + " err"] = err.item()
                res[case] = cs.cuda_ms(
                    torch, lambda f=fn, a=args, C=C: f(*a, _chunk_pages=C),
                    50, flush)
    return res


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--time":
        print(json.dumps(time_variant(sys.argv[2])), flush=True)
        return
    import chip_smoke as cs

    print(f"# {cs.smi_line()}", flush=True)
    report = {}
    for name in build():
        out = subprocess.run(
            [sys.executable, "-m", "infinitensor_tpu_torch.tools.paged_variants",
             "--time", name], cwd=ROOT, capture_output=True, text=True)
        if out.returncode:
            print(f"# {name}: failed\n{out.stderr[-2000:]}", flush=True)
            continue
        report[name] = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{name} {json.dumps(report[name])}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "paged_variants.json").write_text(
        json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
