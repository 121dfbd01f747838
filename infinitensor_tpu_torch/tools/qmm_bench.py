"""Times of the quantized-matmul kernels at the decode shapes, through the
public wrappers, on one card.

    python -m infinitensor_tpu_torch.tools.qmm_bench [--all]

Cases: Llama-2-7B INT4 at group 128 (quant_matmul_norm on wqkv and
w_gateup, quant_matmul on wo, w_down and the lm_head; 1 and 8 rows), the
same with paired scales (1 row), and GPT-2 345M INT8 (quant_matmul_ln on
w_qkv at 64 and 1 rows, quant_matmul on the 51200-column lm_head at 64
rows), each with the variant knobs unset. --all adds the chunk kernel at
group 64, qmm_norm_w4a8 (INFINITPU_QMM_VARIANT=w4a8, an empty table) and
qmm_group2d at wo and w_down for every split kb the table may name.

Weights are random from seed 0, made on the card. A time is the median of
REPS CUDA-event timings, a 1 GB memset before each: it overwrites the L2
cache and outlasts the host's enqueueing of the call, so the events time
the card, not the wrapper's Python. Each case
must launch the kernel named beside it once. Prints one JSON line: the
card, and ms per case.

The cases go through quant_matmul, quant_matmul_norm and quant_matmul_ln
only, so the script can time an older checkout of the package on the
same card: run it with that checkout first on PYTHONPATH, e.g.
PYTHONPATH=old python infinitensor_tpu_torch/tools/qmm_bench.py.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

from infinitensor_tpu_torch.kernels import _build
from infinitensor_tpu_torch.kernels import quant_matmul as qm
from infinitensor_tpu_torch.quant.weight_only import QuantizedLinear

REPS = 50
DIM, MLP, VOCAB, GATEUP_P = 4096, 11008, 32000, 22528


def _qlin(gen, din, dout, bits=4, group=128, paired=False, logical=0):
    dev = gen.device
    rows = din // 2 if bits == 4 else din
    qw = torch.randint(-127, 127, (rows, dout), generator=gen, device=dev,
                       dtype=torch.int8)
    ng = din // (2 * group) if paired else din // group
    sc = torch.rand(ng, dout, generator=gen, device=dev) * 0.019 + 0.001
    return QuantizedLinear(qw, sc.to(torch.bfloat16) if bits == 4 else sc,
                           bits, group, logical)


def _ms(fn, flush) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _knobs(variant=None, table=None) -> None:
    """Set INFINITPU_QMM_VARIANT and, with `table`, INFINITPU_QMM_TUNE to
    a file holding it under the build directory; None unsets."""
    os.environ.pop("INFINITPU_QMM_VARIANT", None)
    os.environ.pop("INFINITPU_QMM_TUNE", None)
    if variant:
        os.environ["INFINITPU_QMM_VARIANT"] = variant
    if table is not None:
        out = _build.BUILD_ROOT / "qmm_bench"
        out.mkdir(parents=True, exist_ok=True)
        text = json.dumps(table, sort_keys=True)
        path = out / f"tune_{hashlib.sha1(text.encode()).hexdigest()[:12]}.json"
        path.write_text(text)
        os.environ["INFINITPU_QMM_TUNE"] = str(path)


def cases(gen, all_variants: bool) -> list:
    """(label, kernel, knobs, fn) for every case."""
    def x(rows, din):
        return torch.randn(rows, din, generator=gen, device=gen.device
                           ).to(torch.bfloat16)

    nw = torch.ones(DIM, dtype=torch.bfloat16, device=gen.device)
    w = {"wqkv": _qlin(gen, DIM, 3 * DIM), "wo": _qlin(gen, DIM, DIM),
         "w_gateup": _qlin(gen, DIM, GATEUP_P, logical=2 * MLP),
         "w_down": _qlin(gen, MLP, DIM), "lm_head": _qlin(gen, DIM, VOCAB)}
    out = []
    for rows in (1, 8):
        for name in ("wqkv", "w_gateup"):
            out.append((f"{name} {rows}", "qmm_group_norm", {},
                        lambda q=w[name], a=x(rows, DIM):
                        qm.quant_matmul_norm(a, nw, q)))
        for name in ("wo", "w_down"):
            q = w[name]
            out.append((f"{name} {rows}", "qmm_group", {},
                        lambda q=q, a=x(rows, q.in_features):
                        qm.quant_matmul(a, q)))
    out.append(("lm_head 1", "qmm_w4a8", {},
                lambda q=w["lm_head"], a=x(1, DIM): qm.quant_matmul(a, q)))
    pw = {"wqkv": _qlin(gen, DIM, 3 * DIM, paired=True),
          "wo": _qlin(gen, DIM, DIM, paired=True),
          "w_down": _qlin(gen, MLP, DIM, paired=True)}
    out.append(("paired wqkv 1", "qmm_slab_norm", {},
                lambda a=x(1, DIM): qm.quant_matmul_norm(a, nw, pw["wqkv"])))
    for name in ("wo", "w_down"):
        q = pw[name]
        out.append((f"paired {name} 1", "qmm_slab", {},
                    lambda q=q, a=x(1, q.in_features): qm.quant_matmul(a, q)))
    g = torch.ones(1024, dtype=torch.float32, device=gen.device)
    bias = torch.zeros(3072, dtype=torch.float32, device=gen.device)
    gqkv = _qlin(gen, 1024, 3072, bits=8)
    for rows in (64, 1):
        out.append((f"gpt2 w_qkv {rows}", "qmm_group_ln", {},
                    lambda a=x(rows, 1024): qm.quant_matmul_ln(
                        a, g, g * 0, gqkv, bias)))
    out.append(("gpt2 lm_head 64", "qmm_group", {},
                lambda q=_qlin(gen, 1024, 51200, bits=8), a=x(64, 1024):
                qm.quant_matmul(a, q)))
    if not all_variants:
        return out
    for name in ("wqkv", "w_gateup", "wo", "w_down", "lm_head"):
        q = w[name]
        q64 = _qlin(gen, q.in_features, q.out_physical, group=64,
                    logical=q.out_features if name == "w_gateup" else 0)
        out.append((f"g64 {name} 1", "qmm_chunk", {},
                    lambda q=q64, a=x(1, q.in_features):
                    qm.quant_matmul(a, q)))
    for name in ("wqkv", "w_gateup"):
        out.append((f"w4a8 {name} 1", "qmm_norm_w4a8",
                    {"variant": "w4a8", "table": {}},
                    lambda q=w[name], a=x(1, DIM):
                    qm.quant_matmul_norm(a, nw, q)))
    for name in ("wo", "w_down"):
        q = w[name]
        kr = q.qweight.shape[0]
        key = f"{q.in_features}:{q.out_features}:4"
        for kb in range(128, kr, 128):
            if kr % kb == 0:
                out.append((f"group2d {name} kb {kb} 1", "qmm_group2d",
                            {"table": {key: {"variant": "group2d",
                                             "bn": 1024, "kb": kb}}},
                            lambda q=q, a=x(1, q.in_features):
                            qm.quant_matmul(a, q)))
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("qmm_bench needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ms = {}
    for label, kernel, knobs, fn in cases(gen, "--all" in argv):
        _knobs(**knobs)
        before = qm.launches[kernel]
        fn()
        if qm.launches[kernel] != before + 1:
            raise SystemExit(f"{label}: {kernel} was not launched")
        ms[label] = _ms(fn, flush)
    _knobs()
    res = {"card": card, "torch": torch.__version__,
           "package": os.path.dirname(os.path.dirname(qm.__file__)),
           "ms": ms}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
