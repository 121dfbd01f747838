"""Where the one-row ring forms of the int4 matmuls spend their time:
patched copies of kernels/csrc/ring.cuh (the grid, the copies, the waits
and the merge both rings share) and of the two ring sources
(quant_matmul_w4a8_ring.cu: qmm_w4a8_ring and qmm_norm_w4a8_ring, the
integer consumer; quant_matmul_ring.cu: qmm_group_norm_ring, the f32
consumer), each variant built under build/ring_variants/<name>/ and timed
in its own process (two libraries with the same kernel names in one
process fail their launches above 48 KB of shared memory), at the
Llama-2-7B shapes of the batch-1 decode: wqkv 4096 -> 12288 and w_gateup
4096 -> 22528 for the two norm rings, wo 4096 -> 4096, w_down 11008 ->
4096 and the lm_head 4096 -> 32000 for qmm_w4a8_ring; int4 codes with
bf16 scales at group 128, a bf16 row.

    python -m infinitensor_tpu_torch.tools.ring_variants

Every case has 16-byte aligned rows, so its stages are TMA copies onto
the slots' mbarriers. Variants: "route" (the sources as they are),
"no_consumer" (the copies and their waits, no arithmetic), "no_copies"
(the consumer over whatever the ring holds: each stage's mbarrier
completed with no bytes and no copy issued), "empty" (neither: the launch,
the prologue, the ring's waits and barriers, the tile flushes and the
merge). Outputs of the patched variants are wrong by design; only "route"
is held to the CUDA-core form's output (max abs error printed, and that
form's time). A time is the median of 50 CUDA-event timings after a 1 GB
memset (cold L2). A variant's process that outlasts TIME_LIMIT seconds is
killed and reported. Prints the card (nvidia-smi name and power limit)
and one JSON line per variant {case: ms}; writes
chiprun_out/ring_variants.json.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "infinitensor_tpu_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ring_variants"
SOURCES = ("quant_matmul_w4a8_ring.cu", "quant_matmul_ring.cu")
TIME_LIMIT = 300                 # seconds a variant's timing process may take
# (kernel, weight, din, dout)
CASES = [("qmm_w4a8_ring", "lm_head", 4096, 32000),
         ("qmm_w4a8_ring", "wo", 4096, 4096),
         ("qmm_w4a8_ring", "w_down", 11008, 4096),
         ("qmm_norm_w4a8_ring", "wqkv", 4096, 12288),
         ("qmm_norm_w4a8_ring", "w_gateup", 4096, 22528),
         ("qmm_group_norm_ring", "wqkv", 4096, 12288),
         ("qmm_group_norm_ring", "w_gateup", 4096, 22528)]

_CONSUME = "    consume(slots + (i % kStages) * kStageBytes, at, acc);"
_COPIES = """      mbar_expect_tx(bar, kWBytes + 2 * kCols * SSZ);
      tma_2d(st, &maps.w, col0, p0, bar);
      tma_2d(st + kWBytes, &maps.s, col0, c, bar);
      tma_2d(st + kWBytes + kCols * SSZ, &maps.s, col0, sh.ngs + c, bar);
"""
_NO_COPIES = "      mbar_expect_tx(bar, 0);\n"    # the slot's phase completes


def variants() -> dict:
    """{name: patched ring.cuh text}: the route's header and its patched
    copies (the ring sources themselves are not patched)."""
    src = (CSRC / "ring.cuh").read_text()
    patches = {
        "no_consumer": [(_CONSUME, "")],
        "no_copies": [(_COPIES, _NO_COPIES)],
        "empty": [(_CONSUME, ""), (_COPIES, _NO_COPIES)],
    }
    out = {"route": src}
    for name, subs in patches.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old.strip()!r} is not in ring.cuh")
            text = text.replace(old, new)
        out[name] = text
    return out


def build() -> list:
    """Compile both ring sources of every variant, one nvcc each, all at
    once; returns the names whose two libraries built."""
    from infinitensor_tpu_torch.kernels import _build

    procs = {}
    for name, header in variants().items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "ring.cuh").write_text(header)
        for src in SOURCES:
            (d / src).write_text((CSRC / src).read_text())
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-o",
                   str(d / f"lib{Path(src).stem}.so"), str(d / src)]
            procs[name, src] = subprocess.Popen(
                cmd, stdout=open(d / f"{src}.log", "w"),
                stderr=subprocess.STDOUT)
    failed = set()
    for (name, src), proc in procs.items():
        if proc.wait():
            failed.add(name)
            print(f"# {name} {src}: build failed\n"
                  + (OUT / name / f"{src}.log").read_text()[-2000:],
                  flush=True)
    return [n for n in variants() if n not in failed]


def _load(name: str, stem: str, **signatures) -> ctypes.CDLL:
    from infinitensor_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(OUT / name / f"lib{stem}.so"))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _build.I
    lib.itt_error_string.argtypes = [_build.I]
    lib.itt_error_string.restype = ctypes.c_char_p
    return lib


def time_variant(name: str) -> dict:
    """{case: ms} of the variant's libraries behind the ring wrappers."""
    import torch

    import chip_smoke as cs
    from infinitensor_tpu_torch.kernels import _build
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    from infinitensor_tpu_torch.quant.weight_only import QuantizedLinear

    P, I, F = _build.P, _build.I, _build.F
    w4a8 = _load(name, "quant_matmul_w4a8_ring",
                 qmm_w4a8_ring=[P, I, P, P, I, P, P, P, I, I, I, I, P],
                 qmm_norm_w4a8_ring=[P, P, P, P, I, P, P, P, I, I, I, I, F,
                                     P])
    group = _load(name, "quant_matmul_ring",
                  qmm_group_norm_ring=[P, P, P, P, I, P, P, P, I, I, I, I,
                                       F, P])
    qm._lib_w4a8_ring = lambda: w4a8
    qm._lib_ring = lambda: group
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    res = {}
    for kname, label, din, dout in CASES:
        q = QuantizedLinear(
            torch.randint(-128, 128, (din // 2, dout), generator=gen,
                          device=dev, dtype=torch.int8),
            (torch.rand(din // 128, dout, generator=gen, device=dev) * 0.02
             + 0.001).to(torch.bfloat16), 4, 128)
        x = torch.randn(1, din, generator=gen, device=dev).to(torch.bfloat16)
        nw = (torch.rand(din, generator=gen, device=dev) + 0.5).to(
            torch.bfloat16)
        if kname == "qmm_group_norm_ring":
            def fn(form=None, x=x, nw=nw, q=q):
                return qm._launch_group(x, nw, q, 1e-5, "qmm_group_norm",
                                        form=form or "ring")
        else:
            norm = nw if kname == "qmm_norm_w4a8_ring" else None

            def fn(form=None, x=x, nw=norm, q=q):
                return qm._launch_w4a8(x, q, nw, 1e-5, form=form or "ring")
        case = f"{kname} {label}"
        if name == "route":
            core = fn("cuda_core")
            res[case + " err"] = (fn().float() - core.float()).abs().max() \
                .item()
            res[case + " max|cuda_core|"] = core.float().abs().max().item()
            res[case + " cuda_core"] = cs.cuda_ms(torch, lambda f=fn: f(
                "cuda_core"), 50, flush)
        res[case] = cs.cuda_ms(torch, fn, 50, flush)
    return res


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--time":
        print(json.dumps(time_variant(sys.argv[2])), flush=True)
        return
    import chip_smoke as cs
    from infinitensor_tpu_torch.kernels import _build

    print(f"# {cs.smi_line()}", flush=True)
    _build.build_all()           # the route's CUDA-core forms, beside
    report = {"card": cs.smi_line()}
    for name in build():
        try:
            out = subprocess.run(
                [sys.executable, "-m",
                 "infinitensor_tpu_torch.tools.ring_variants", "--time", name],
                cwd=ROOT, capture_output=True, text=True, timeout=TIME_LIMIT)
        except subprocess.TimeoutExpired:
            print(f"# {name}: killed after {TIME_LIMIT} s", flush=True)
            continue
        if out.returncode:
            print(f"# {name}: failed\n{out.stderr[-2000:]}", flush=True)
            continue
        report[name] = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{name} {json.dumps(report[name])}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "ring_variants.json").write_text(
        json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
