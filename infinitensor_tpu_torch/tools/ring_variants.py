"""Where the one-row ring forms of the int4 matmuls spend their time:
patched copies of kernels/csrc/ring.cuh (the grid, the copies, the waits,
the merge and the launch all rings share) and of the two ring sources
(quant_matmul_w4a8_ring.cu: qmm_w4a8_ring and qmm_norm_w4a8_ring, the
integer consumer; quant_matmul_ring.cu: qmm_group_norm_ring,
qmm_slab_norm_ring and qmm_group2d_ring, the f32 consumer), each variant
built under build/ring_variants/<name>/ and timed in its own process (two
libraries with the same kernel names in one process fail their launches
above 48 KB of shared memory), at the Llama-2-7B shapes of the batch-1
decode: wqkv 4096 -> 12288 and w_gateup 4096 -> 22528 for the three norm
rings (paired scales for qmm_slab_norm_ring), wo 4096 -> 4096 and w_down
11008 -> 4096 for qmm_w4a8_ring and qmm_group2d_ring (the split-K table's
kb 256 and 128 for the latter's two-launch form), the lm_head 4096 ->
32000 for qmm_w4a8_ring; int4 codes with bf16 scales at group 128, a bf16
row.

    python -m infinitensor_tpu_torch.tools.ring_variants [variant ...]

Every case has 16-byte aligned rows, so its stages are TMA copies onto
the slots' mbarriers. Variants, each the sources with what it names kept:
  route        the sources as they are (a programmatic dependent launch);
  no_pdl       route launched without the programmatic attribute (the
               launch before the cut of the fixed cost);
then, each without the programmatic attribute (the fixed cost's split
before the cut), and again with it (the same name + "_pdl", after):
  launch       the same grid, block and shared memory, returning at once;
  prologue     launch + the mbarrier setup, the first kStages - 1 stage
               issues, the norm or row prologue and the wait for those
               stages;
  merge        prologue + every tile flush of the block's share and the
               last-block merge (no stage loop: no copies past the first
               stages, no waits, no consumer);
  empty        merge + the stage loop's waits and barriers over stages
               completed with no bytes (no copy, no consumer);
  no_consumer  route without the consumer (copies and waits);
  no_copies    route without the copies (each stage's mbarrier completed
               with no bytes, the consumer over whatever the ring holds).
Outputs of the patched variants are wrong by design; only the routes are
held to the old form's output (max abs error printed, and that form's
time: the CUDA-core form; qmm_slab_norm's CUDA-core body; qmm_group2d's
two-launch split). A time is read cold, the median of 50 CUDA-event
timings after a 1 GB memset, and back to back, ms a launch of 32 launches
over 32 copies of the weight captured in one CUDA graph (chip_smoke.py
graph_launch_ms; the lm_head's one copy 32 times). A variant's process
that outlasts TIME_LIMIT seconds is killed and reported. Prints the card
(nvidia-smi name and power limit) and one JSON line per variant {case:
ms}; writes chiprun_out/ring_variants.json.
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
COPIES = 32                      # weight copies of a back-to-back graph
# (kernel, weight, din, dout, kb of the split-K table)
CASES = [("qmm_w4a8_ring", "lm_head", 4096, 32000, 0),
         ("qmm_w4a8_ring", "wo", 4096, 4096, 0),
         ("qmm_w4a8_ring", "w_down", 11008, 4096, 0),
         ("qmm_norm_w4a8_ring", "wqkv", 4096, 12288, 0),
         ("qmm_norm_w4a8_ring", "w_gateup", 4096, 22528, 0),
         ("qmm_group_norm_ring", "wqkv", 4096, 12288, 0),
         ("qmm_group_norm_ring", "w_gateup", 4096, 22528, 0),
         ("qmm_slab_norm_ring", "wqkv", 4096, 12288, 0),
         ("qmm_slab_norm_ring", "w_gateup", 4096, 22528, 0),
         ("qmm_group2d_ring", "wo", 4096, 4096, 256),
         ("qmm_group2d_ring", "w_down", 11008, 4096, 128)]

_CONSUME = "    consume(slots + (i % kStages) * kStageBytes, at, acc);"
_COPIES = """      mbar_expect_tx(bar, kWBytes + (PAIRED ? 1 : 2) * kCols * SSZ);
      tma_2d(st, &maps.w, col0, p0, bar);
      tma_2d(st + kWBytes, &maps.s, col0, c, bar);
      if (!PAIRED) tma_2d(st + kWBytes + kCols * SSZ, &maps.s, col0, sh.ngs + c, bar);
"""
_NO_COPIES = "      mbar_expect_tx(bar, 0);\n"    # the slot's phase completes
_NO_PDL = ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")
_TOP = """  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  __shared__ __align__(8) uint64_t full[kStages];     // the slots' mbarriers (A16)
"""
_FIRST_LANDED = """  for (int i = 0; i < kStages - 1 && i < sh.n; ++i)   // the first stages land
    if constexpr (A16) mbar_wait(full + i, 0);
  cp_async_wait<0>();
  __syncthreads();
"""
_PROLOGUE = "  prologue();\n"
_LOOP_HEAD = """  for (int i = 0; i < sh.n; ++i) {
    if constexpr (A16)
      mbar_wait(full + i % kStages, i / kStages & 1);
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();          // stage i landed; slot (i - 1) % kStages is free
    issue<A16, SSZ, PAIRED>(slots, i + kStages - 1, sh, ip, qw, sc, dout_p, maps, full);
    cp_async_commit();
"""
_SPLIT = {
    "launch": [(_TOP, "  return;\n" + _TOP)],
    "prologue": [(_PROLOGUE, _PROLOGUE + _FIRST_LANDED + "  return;\n")],
    "merge": [(_LOOP_HEAD, _FIRST_LANDED + "  for (int i = 0; i < sh.n; ++i) {\n"),
              (_CONSUME, "")],
    "empty": [(_CONSUME, ""), (_COPIES, _NO_COPIES)],
    "no_consumer": [(_CONSUME, "")],
    "no_copies": [(_COPIES, _NO_COPIES)],
}
VARIANTS = {"route": [], "no_pdl": [_NO_PDL],
            **{k: [_NO_PDL, *v] for k, v in _SPLIT.items()},
            **{k + "_pdl": v for k, v in _SPLIT.items()
               if k in ("launch", "prologue", "merge")}}


def variants(names=None) -> dict:
    """{name: patched ring.cuh text} of VARIANTS (or those named): the
    route's header and its patched copies (the ring sources themselves are
    not patched)."""
    src = (CSRC / "ring.cuh").read_text()
    out = {}
    for name in names or VARIANTS:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: {old.strip()!r} is not in ring.cuh")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(names=None) -> list:
    """Compile both ring sources of every variant (or those named), one
    nvcc each, all at once; returns the names whose two libraries built."""
    from infinitensor_tpu_torch.kernels import _build

    procs = {}
    for name, header in variants(names).items():
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
    return [n for n in variants(names) if n not in failed]


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
    """{case: ms} of the variant's libraries behind the ring wrappers: cold
    and back to back ("<case> b2b"); for the route also the old form's."""
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
                                       F, P],
                  qmm_slab_norm_ring=[P, P, P, P, I, P, P, P, I, I, I, I,
                                      F, P],
                  qmm_group2d_ring=[P, I, P, P, I, P, P, P, I, I, I, I, P])
    qm._lib_w4a8_ring = lambda: w4a8
    qm._lib_ring = lambda: group
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    res = {}
    for kname, label, din, dout, kb in CASES:
        paired = kname == "qmm_slab_norm_ring"

        def weight():
            return QuantizedLinear(
                torch.randint(-128, 128, (din // 2, dout), generator=gen,
                              device=dev, dtype=torch.int8),
                (torch.rand(din // (256 if paired else 128), dout,
                            generator=gen, device=dev) * 0.02
                 + 0.001).to(torch.bfloat16), 4, 128)

        weights = [weight()] * COPIES if label == "lm_head" \
            else [weight() for _ in range(COPIES)]
        x = torch.randn(1, din, generator=gen, device=dev).to(torch.bfloat16)
        nw = (torch.rand(din, generator=gen, device=dev) + 0.5).to(
            torch.bfloat16)
        if kname == "qmm_group_norm_ring":
            def fn(q, form="ring", x=x, nw=nw):
                return qm._launch_group(x, nw, q, 1e-5, "qmm_group_norm",
                                        form=form)
        elif paired:
            def fn(q, form="ring", x=x, nw=nw):
                return qm._launch_slab(x, nw, q, 1e-5, "qmm_slab_norm",
                                       form=form)
        elif kname == "qmm_group2d_ring":
            def fn(q, form="ring", x=x, kb=kb):
                return qm._launch_group2d(x, q, kb, form=form)
        else:
            norm = nw if kname == "qmm_norm_w4a8_ring" else None

            def fn(q, form="ring", x=x, nw=norm):
                return qm._launch_w4a8(x, q, nw, 1e-5, form=form)
        case, q = f"{kname} {label}", weights[0]
        if name in ("route", "no_pdl"):
            old = fn(q, "cuda_core")
            res[case + " err"] = (fn(q).float() - old.float()).abs().max() \
                .item()
            res[case + " max|old|"] = old.float().abs().max().item()
        if name == "route":
            res[case + " old"] = cs.cuda_ms(
                torch, lambda f=fn, q=q: f(q, "cuda_core"), 50, flush)
            res[case + " old b2b"] = cs.graph_launch_ms(
                torch, lambda q, f=fn: f(q, "cuda_core"), weights)
        res[case] = cs.cuda_ms(torch, lambda f=fn, q=q: f(q), 50, flush)
        res[case + " b2b"] = cs.graph_launch_ms(torch, fn, weights)
        del weights, q
    return res


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--time":
        print(json.dumps(time_variant(sys.argv[2])), flush=True)
        return
    import chip_smoke as cs
    from infinitensor_tpu_torch.kernels import _build

    names = sys.argv[1:] or None
    print(f"# {cs.smi_line()}", flush=True)
    _build.build_all()           # the route's old forms, beside
    report = {"card": cs.smi_line()}
    for name in build(names):
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
