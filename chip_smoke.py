"""Drive the PyTorch/CUDA port (infinitensor_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing with a nonzero exit, each printing its seconds:
  1. the card: CUDA present; its name and power limit (nvidia-smi);
  2. build every kernel from kernels/csrc/ (one nvcc per source, in
     parallel), timed;
  3. each kernel against its plain PyTorch version on the card at the
     Llama-2-7B shapes of its path: decode (bs=1, ctx=1024), the prompt's
     attention (S=1024) and its matmuls at 256 rows, and the serving
     engine's paged decode (8 slots, pages of 64 rows, ragged positions
     around 1024, a shuffled block table, NaN in every row no slot owns or
     past its position); max error, median
     time, the least time the card could take (bytes over the published
     3.35 TB/s or operations over the published tensor-core peak,
     whichever is larger, and bytes over the device-to-device copy rate
     measured here), the plain version's time and one PyTorch library
     call's time;
  4. the 7B INT4 + INT8-KV decode path with random weights built on the
     card as bench.py builds them: one step with the kernels against the
     same step on the plain versions (CPU), then llama_decode_multi for
     128 greedy steps under a CUDA graph (tokens equal to an eager loop),
     tok/s (min of 3 fresh runs) against the copy-rate roofline, and each
     kernel's launch count on that path;
  5. the prompt -> generate path (greedy_generate) with the same weights
     and a seeded 1024-token prompt, for 128 tokens with the default bf16
     cache and again with an INT8 cache: prefill ms, prompt tok/s, the
     decode tok/s of the generate loop (min of 3 runs) against its
     roofline, the launches of every kernel and of the dequant route;
     a 256-token prompt, whose matmuls take the kernels; prefill of S-1
     tokens plus one bf16 decode step against the S-token prefill; a
     2-layer model of 7B width, kernels on the card against the plain
     versions on the CPU;
  6. the serving path at full width: PagedServingEngine over the same 7B
     INT4 weights, 8 slots, pages of 64 rows, buckets (128, 512, 1024),
     decode chunks of 8 under one captured CUDA graph, and a pool of 96
     usable pages (6144 tokens, against 8 x 1664 for a dense cache) so
     that admission waits for reclaim; 24 seeded requests of 64-900 prompt
     tokens and 32-128 new tokens; once with the bf16 pool and once with
     the INT8 pool. Every request ends with its token count and every page
     returns to the free list; the tokens equal the dense ServingEngine's
     on the same stream and one request's equal greedy_generate's, each
     up to a first near-tie whose logit gap is printed; a snapshot taken
     mid-stream and restored into a fresh engine ends in the same tokens;
     the paged kernel is launched 32 times per decode step and
     flash_attention 32 times per prefill pass. Prints generated tok/s
     over the drain, decode ms per step at 8 live slots and the engine's
     stats slices.
The last lines are the kernels JSON, nvidia-smi's name and power limit,
and {"ok": true, "device": {...}}. A report goes to chiprun_out/.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12        # H100 SXM published device-memory rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}    # dense tensor-core peaks
SEED = 0
CTX = 1024                   # decode position (bench.py BENCH_CTX)
MAX_SEQ = 1664               # bench.py cache capacity at ctx 1024
STEPS = 128                  # tokens per CUDA-graph region (BENCH_MULTI)
PROMPT = 1024                # phase 5 prompt length (ctx of the decode)
SHORT = 256                  # the longest prompt whose matmuls take kernels
GEN = 128                    # greedy_generate tokens in phase 5
TOL = 1e-2                   # kernel vs plain: max err <= TOL * max|plain|
SLOTS = 8                    # phase 6: decode batch of the serving engines
PAGE = 64                    # rows per KV page
POOL_PAGES = 97              # page 0 is the trash page: 96 usable
BUCKETS = (128, 512, 1024)   # prefill buckets
CHUNK = 8                    # decode steps per fetch
REQUESTS = 24
TIE = 5e-2                   # near-tie: logit gap <= TIE * max|logit|
SRC = "infinitensor_tpu_torch/kernels/csrc/"
TPU = "infinitensor_tpu/kernels/"


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps, flush=None):
    """Median milliseconds of fn() over `reps` CUDA-event timings, with
    the L2 cache overwritten before each (cold weights, as in decode)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def copy_rate(torch):
    """Device-to-device copy_ of 1 GB: bytes read + written per second."""
    n = 1 << 30
    a = torch.empty(n, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    ms = cuda_ms(torch, lambda: b.copy_(a), 10)
    del a, b
    return 2 * n / (ms * 1e-3)


class Counters:
    """The launch counters of the kernel modules: zeroed just before a
    path runs, read just after."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self):
        for m in self.modules:
            m.launches.clear()

    def read(self):
        out = {}
        for m in self.modules:
            out.update(m.launches)
        return out


def phase(n, t0):
    print(f"# phase {n} done in {time.perf_counter() - t0:.1f}s", flush=True)
    return time.perf_counter()


def main():
    import torch

    t_phase = time.perf_counter()
    # 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from infinitensor_tpu_torch.kernels import _build
    from infinitensor_tpu_torch.kernels import attention as att
    from infinitensor_tpu_torch.kernels import flash_attention as fa
    from infinitensor_tpu_torch.kernels import paged_attention as pa
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    from infinitensor_tpu_torch.models import llama
    from infinitensor_tpu_torch.quant.weight_only import (
        QuantizedLinear, dequant_matmul, dequantize_weight)

    smi = smi_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    print(f"# card: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    report = {"card": smi, "torch": torch.__version__}
    counters = Counters(qm, att, fa, pa)
    t_phase = phase(1, t_phase)

    # 2. build
    t0 = time.perf_counter()
    took = _build.build_all()
    build_s = time.perf_counter() - t0
    per_src = {k: round(v, 1) for k, v in took.items()}
    print(f"# kernels built in {build_s:.1f}s (per source: {per_src})",
          flush=True)
    for log in sorted(_build.build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"# {log.stem}: {line.strip()}")
    report["build_s"] = build_s
    t_phase = phase(2, t_phase)

    # 3. kernels against their plain versions at the 7B shapes
    bw_copy = copy_rate(torch)
    print(f"# device-to-device copy: {bw_copy / 1e9:.1f} GB/s", flush=True)
    report["copy_gbps"] = bw_copy / 1e9
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = llama.LlamaConfig(max_seq=MAX_SEQ)
    params = build_params(torch, cfg, gen, dev, QuantizedLinear)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    eps = cfg.norm_eps
    layer0 = params["layers"][0]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # path: the run whose launch counts a case reports (phase 4 "decode",
    # phase 5 "prompt 1024" with the bf16 cache, phase 5 "prompt 256")
    cases = []
    for label, q in (("wqkv", layer0["wqkv"]),
                     ("w_gateup", layer0["w_gateup"])):
        x = randn(1, cfg.dim)
        nw = (torch.rand(cfg.dim, generator=gen, device=dev) + 0.5).to(
            torch.bfloat16)
        xn = qm.rmsnorm_bf16(x, nw, eps)
        w = dequantize_weight(q)
        cases.append(dict(
            name="qmm_group_norm", shape=label, path="decode",
            replaces=TPU + "quant_matmul.py:85",
            source=SRC + "quant_matmul.cu",
            kernel=lambda x=x, nw=nw, q=q: qm.quant_matmul_norm(x, nw, q, eps),
            plain=lambda x=x, nw=nw, q=q: qm.qmm_group_plain(
                qm.rmsnorm_bf16(x, nw, eps), q)[:, :q.out_features],
            library=lambda xn=xn, w=w: torch.matmul(xn, w),
            bytes=nbytes(x, nw, q.qweight, q.scales) + 2 * q.out_physical,
            ops=2 * cfg.dim * q.out_physical, kind="bf16"))
    decode_mm = (("wo", layer0["wo"], cfg.dim),
                 ("w_down", layer0["w_down"], cfg.intermediate))
    prompt_mm = (("wqkv", layer0["wqkv"], cfg.dim), decode_mm[0],
                 ("w_gateup", layer0["w_gateup"], cfg.dim), decode_mm[1])
    # SLOTS rows: the paged engine's decode step, which does not fuse the
    # norm, so all four matmuls of a layer are qmm_group
    for rows, path, shapes in ((1, "decode", decode_mm),
                               (SLOTS, "serving paged bf16", prompt_mm),
                               (SHORT, f"prompt {SHORT}", prompt_mm)):
        for label, q, din in shapes:
            x = randn(rows, din)
            w = dequantize_weight(q)
            cases.append(dict(
                name="qmm_group",
                shape=label if rows == 1 else f"{label} {rows} rows",
                path=path, replaces=TPU + "quant_matmul.py:100",
                source=SRC + "quant_matmul.cu",
                kernel=lambda x=x, q=q: qm.quant_matmul(x, q),
                plain=lambda x=x, q=q: qm.qmm_group_plain(x, q)[
                    :, :q.out_features],
                library=lambda x=x, w=w: torch.matmul(x, w),
                bytes=nbytes(x, q.qweight, q.scales)
                + 2 * rows * q.out_physical,
                ops=2 * rows * din * q.out_physical, kind="bf16"))
    q = params["lm_head"]
    w = dequantize_weight(q)
    if qm.variant_for(cfg.dim, q) != "w4a8":
        fail("the variant table does not route the lm_head to w4a8")
    for rows, path in ((1, "decode"), (SLOTS, "serving paged bf16"),
                       (SHORT, f"prompt {SHORT}")):
        x = randn(rows, cfg.dim)
        cases.append(dict(
            name="qmm_w4a8",
            shape="lm_head" if rows == 1 else f"lm_head {rows} rows",
            path=path, replaces=TPU + "quant_matmul.py:283",
            source=SRC + "quant_matmul.cu",
            kernel=lambda x=x, q=q: qm.quant_matmul(x, q),
            plain=lambda x=x, q=q: qm.qmm_w4a8_plain(x, q)[
                :, :q.out_features],
            library=lambda x=x, w=w: torch.matmul(x, w),
            bytes=nbytes(x, q.qweight, q.scales) + 2 * rows * q.out_physical,
            ops=2 * rows * cfg.dim * q.out_physical, kind="int8"))
    for label, H, Hkv in (("mha 32/32", 32, 32), ("gqa 32/8", 32, 8)):
        D, S = cfg.head_dim, MAX_SEQ
        qh = randn(1, H, 1, D)
        kc = torch.randint(-127, 128, (1, Hkv, S, D), generator=gen,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-127, 128, (1, Hkv, S, D), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand(1, Hkv, S, generator=gen, device=dev) * 0.015 + 0.005
        vs = torch.rand(1, Hkv, S, generator=gen, device=dev) * 0.015 + 0.005
        pos = torch.full((1,), CTX, dtype=torch.int32, device=dev)
        live = CTX + 1
        rep = H // Hkv
        kf = (kc[:, :, :live].float() * ks[:, :, :live, None]).to(
            torch.bfloat16).repeat_interleave(rep, 1)
        vf = (vc[:, :, :live].float() * vs[:, :, :live, None]).to(
            torch.bfloat16).repeat_interleave(rep, 1)
        args = (qh, kc, vc, ks, vs, pos)
        cases.append(dict(
            name="flash_decode_q8", shape=f"{label} pos {CTX}",
            path="decode", replaces=TPU + "attention.py:345",
            source=SRC + "flash_decode.cu",
            kernel=lambda a=args: att.flash_decode_q8(*a),
            plain=lambda a=args: att.flash_decode_q8_plain(*a),
            library=lambda qh=qh, kf=kf, vf=vf:
                torch.nn.functional.scaled_dot_product_attention(qh, kf, vf),
            bytes=2 * Hkv * live * (D + 4) + 2 * nbytes(qh),
            ops=4 * H * live * D, kind="bf16"))
        kb, vb = randn(1, Hkv, S, D), randn(1, Hkv, S, D)
        args = (qh, kb, vb, pos)
        kr = kb[:, :, :live].repeat_interleave(rep, 1)
        vr = vb[:, :, :live].repeat_interleave(rep, 1)
        cases.append(dict(
            name="flash_decode", shape=f"{label} pos {CTX}",
            path=f"prompt {PROMPT}", replaces=TPU + "attention.py:294",
            source=SRC + "flash_decode.cu",
            kernel=lambda a=args: att.flash_decode(*a),
            plain=lambda a=args: att.flash_decode_plain(*a),
            library=lambda qh=qh, kr=kr, vr=vr:
                torch.nn.functional.scaled_dot_product_attention(qh, kr, vr),
            bytes=2 * Hkv * live * D * 2 + 2 * nbytes(qh),
            ops=4 * H * live * D, kind="bf16"))
    H, D = cfg.n_heads, cfg.head_dim
    qa, ka, va = (randn(1, H, PROMPT, D) for _ in range(3))
    cases.append(dict(
        name="flash_attention", shape=f"causal 1x{H}x{PROMPT}x{D}",
        path=f"prompt {PROMPT}", replaces=TPU + "flash_attention.py:37",
        source=SRC + "flash_attention.cu",
        kernel=lambda: fa.flash_attention(qa, ka, va, causal=True),
        plain=lambda: fa.mha_plain(qa, ka, va, causal=True),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qa, ka, va, is_causal=True),
        bytes=4 * nbytes(qa),
        # the (i, j <= i) pairs this causal input needs, 4 D flops each
        ops=4 * H * (PROMPT * (PROMPT + 1) // 2) * D, kind="bf16"))

    cases += paged_cases(torch, pa, cfg, gen, dev, randn)

    for c in cases:
        got, want = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{c['name']} {c['shape']}: shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        c["max_abs_err"], c["max_abs_ref"] = err, ref
        if not (math.isfinite(err) and err <= TOL * ref):
            fail(f"{c['name']} {c['shape']}: max err {err} > {TOL} * {ref}")
        c["ms"] = cuda_ms(torch, c["kernel"], 50, flush)
        c["plain_ms"] = cuda_ms(torch, c["plain"], 5, flush)
        c["library_ms"] = cuda_ms(torch, c["library"], 50, flush)
        c["bound_ms"] = 1e3 * max(c["bytes"] / HBM_BYTES_S,
                                  c["ops"] / PEAK_OPS[c["kind"]])
        c["bound_by"] = ("bytes" if c["bytes"] / HBM_BYTES_S
                         >= c["ops"] / PEAK_OPS[c["kind"]] else "operations")
        c["copy_bound_ms"] = 1e3 * c["bytes"] / bw_copy
        print(f"# {c['name']:16s} {c['shape']:22s} err {err:.3g} "
              f"(max|ref| {ref:.3g})  kernel {c['ms']:.4f} ms  bound "
              f"{c['bound_ms']:.4f} ms {c['bound_by']} (copy-rate "
              f"{c['copy_bound_ms']:.4f})  plain {c['plain_ms']:.4f} ms  "
              f"library {c['library_ms']:.4f} ms  {c['bytes'] / 1e6:.2f} MB",
              flush=True)
    del flush, qa, ka, va
    t_phase = phase(3, t_phase)

    # 4. the 7B decode path
    per_token = decode_path(torch, llama, counters, params, cfg, dev, report)
    paths = {"decode": report["launches_main_path"]}
    for kname in ("qmm_group_norm", "qmm_group", "qmm_w4a8",
                  "flash_decode_q8"):
        if paths["decode"].get(kname, 0) <= 0:
            fail(f"{kname} was never launched on the main path")
    t_phase = phase(4, t_phase)

    # 5. the 7B prompt -> generate path
    paths.update(generate_path(torch, llama, counters, params, cfg, dev,
                               report, per_token, dequantize_weight,
                               dequant_matmul))
    for path, knames in ((f"prompt {PROMPT}", ("flash_attention",
                                               "flash_decode")),
                         (f"prompt {PROMPT} int8", ("flash_attention",
                                                    "flash_decode_q8")),
                         (f"prompt {SHORT}", ("qmm_group", "qmm_w4a8",
                                              "flash_attention",
                                              "flash_decode"))):
        for kname in knames:
            if paths[path].get(kname, 0) <= 0:
                fail(f"{kname} was never launched on the path {path}")
    t_phase = phase(5, t_phase)

    # 6. the 7B serving path, paged against dense
    paths.update(serving_path(torch, llama, counters, params, cfg, dev,
                              report, per_token))
    for path, kname in (("serving paged bf16", "paged_flash_decode"),
                        ("serving paged int8", "paged_flash_decode_q8")):
        for k in (kname, "flash_attention", "qmm_group", "qmm_w4a8"):
            if paths[path].get(k, 0) <= 0:
                fail(f"{k} was never launched on the path {path}")
    t_phase = phase(6, t_phase)

    per_prompt = report["generate"][f"prompt {SHORT}"]["launches_per_prompt"]
    kernels = []
    for c in cases:
        prefill = c["name"] == "flash_attention" or c["path"] == \
            f"prompt {SHORT}"
        step = report["serving"][c["path"]]["launches_per_step"] \
            if c["path"].startswith("serving") else per_token
        kernels.append({
            "name": c["name"], "shape": c["shape"], "route": "cuda",
            "source": c["source"], "replaces": c["replaces"],
            "path": c["path"], "launches": paths[c["path"]].get(c["name"], 0),
            "launches_per_token": None if prefill
            else step.get(c["name"], 0),
            "launches_per_prompt": per_prompt.get(c["name"], 0) if prefill
            else None,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "copy_bound_ms": c["copy_bound_ms"],
            "bytes": c["bytes"], "ops": c["ops"],
            "library_ms": c["library_ms"]})
    report["kernels"] = kernels
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke_report.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def paged_cases(torch, pa, cfg, gen, dev, randn):
    """Phase 3 rows of the two paged kernels at the serving shape: SLOTS
    slots, ragged positions around CTX, a shuffled block table over a pool
    with spare pages, NaN wherever no live row lies (pages for bf16, scale
    pages for int8)."""
    B, D, P = SLOTS, cfg.head_dim, PAGE
    MP = MAX_SEQ // P
    N = B * MP + 1
    pos = torch.tensor([CTX - 331, CTX - 64, CTX - 1, CTX, CTX + 1,
                        CTX + 63, CTX + 200, CTX + 477][:B],
                       dtype=torch.int32, device=dev)
    table = (torch.randperm(N - 1, generator=gen, device=dev)[:B * MP] + 1
             ).reshape(B, MP).to(torch.int32)
    live_rows = int((pos + 1).sum())
    live = torch.zeros(N, P, dtype=torch.bool, device=dev)
    rows = torch.arange(MP * P, device=dev)
    for b in range(B):
        s = rows[:int(pos[b]) + 1]
        live[table[b].long()[s // P], s % P] = True
    mask = (rows[None] <= pos[:, None])[:, None, None]     # [B, 1, 1, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for label, H, Hkv in (("mha 32/32", 32, 32), ("gqa 32/8", 32, 8)):
        rep = H // Hkv
        dead = ~live[:, None, :].expand(N, Hkv, P)
        qh = randn(B, H, 1, D)
        shape = f"{label} {B} slots P{P} pos~{CTX}"
        kp, vp = (torch.randint(-127, 128, (N, Hkv, P, D), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(N, Hkv, P, generator=gen, device=dev) * 0.015
                  + 0.005 for _ in range(2))
        kf, vf = ((pa.gather_pages(x, table).float()
                   * pa.gather_scale_pages(sc, table)[..., None]).to(
                       torch.bfloat16).repeat_interleave(rep, 1)
                  for x, sc in ((kp, ks), (vp, vs)))
        ks[dead] = float("nan")
        vs[dead] = float("nan")
        args = (qh, kp, vp, ks, vs, table, pos)
        small = 2 * qh.numel() * 2 + table.numel() * 4 + pos.numel() * 4
        out.append(dict(
            name="paged_flash_decode_q8", shape=shape,
            path="serving paged int8",
            replaces=TPU + "paged_attention.py:187",
            source=SRC + "paged_flash_decode.cu",
            kernel=lambda a=args: pa.paged_flash_decode_q8(*a),
            plain=lambda a=args: pa.paged_decode_q8_plain(*a),
            library=lambda qh=qh, kf=kf, vf=vf: sdpa(qh, kf, vf,
                                                     attn_mask=mask),
            bytes=2 * Hkv * live_rows * (D + 4) + small,
            ops=4 * H * live_rows * D, kind="bf16"))
        kb, vb = randn(N, Hkv, P, D), randn(N, Hkv, P, D)
        kr, vr = (pa.gather_pages(x, table).repeat_interleave(rep, 1)
                  for x in (kb, vb))
        kb[dead] = float("nan")
        vb[dead] = float("nan")
        args = (qh, kb, vb, table, pos)
        out.append(dict(
            name="paged_flash_decode", shape=shape,
            path="serving paged bf16",
            replaces=TPU + "paged_attention.py:146",
            source=SRC + "paged_flash_decode.cu",
            kernel=lambda a=args: pa.paged_flash_decode(*a),
            plain=lambda a=args: pa.paged_decode_plain(*a),
            library=lambda qh=qh, kr=kr, vr=vr: sdpa(qh, kr, vr,
                                                     attn_mask=mask),
            bytes=2 * Hkv * live_rows * D * 2 + small,
            ops=4 * H * live_rows * D, kind="bf16"))
    return out


def build_params(torch, cfg, gen, dev, QuantizedLinear):
    """Random INT4 weights on the card, as bench.py:24-97 builds them:
    codes uniform in [-127, 126], bf16 scales uniform in [0.001, 0.02],
    group 128, w_gateup padded to a multiple of 2048 columns (22528),
    a 0.02-scaled bf16 embedding, unit norms."""
    def qlin(din, dout, pad_to=0, group=128):
        logical = 0
        if pad_to and dout % pad_to:
            logical, dout = dout, dout + pad_to - dout % pad_to
        qw = torch.randint(-127, 127, (din // 2, dout), generator=gen,
                           device=dev, dtype=torch.int8)
        sc = (torch.rand(din // group, dout, generator=gen, device=dev)
              * 0.019 + 0.001).to(torch.bfloat16)
        return QuantizedLinear(qw, sc, 4, group, logical)

    kvd = cfg.n_kv_heads * cfg.head_dim
    ones = torch.ones(cfg.dim, dtype=torch.bfloat16, device=dev)
    layers = [{
        "attn_norm": ones, "wqkv": qlin(cfg.dim, cfg.dim + 2 * kvd),
        "wo": qlin(cfg.dim, cfg.dim), "mlp_norm": ones,
        "w_gateup": qlin(cfg.dim, 2 * cfg.intermediate, pad_to=2048),
        "w_down": qlin(cfg.intermediate, cfg.dim),
    } for _ in range(cfg.n_layers)]
    embed = (torch.randn(cfg.vocab_size, cfg.dim, generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
    return {"embed": embed, "final_norm": ones,
            "lm_head": qlin(cfg.dim, cfg.vocab_size), "layers": layers}


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.to("cpu")


def fresh(cache):
    for bufs in cache.values():
        for t in bufs:
            t.zero_()


def compare_logits(torch, what, got, want, report):
    """Fail unless got [vocab] agrees with want: relative error <= 5e-2 and
    the same top-1, or a near-tie: want's logits of the two candidates lie
    within the measured error of each other."""
    lk, lp = got.float().cpu().reshape(-1), want.float().cpu().reshape(-1)
    if not torch.isfinite(lk).all():
        fail(f"{what}: non-finite logits")
    err = (lk - lp).abs().max().item()
    rel = err / lp.abs().max().item()
    top_k, top_p = int(lk.argmax()), int(lp.argmax())
    tie = float(lp[top_p] - lp[top_k]) <= 2 * err
    print(f"# {what}: rel logit err {rel:.3g}, top-1 {top_k} vs {top_p}",
          flush=True)
    report[what] = {"rel_logit_err": rel, "top1": [top_k, top_p]}
    if rel > 5e-2 or (top_k != top_p and not tie):
        fail(f"{what}: rel {rel}, top-1 {top_k} vs {top_p}")
    return rel, top_k, top_p


def decode_path(torch, llama, counters, params, cfg, dev, report):
    """Phase 4; returns each kernel's launches in one eager decode step."""
    token = torch.zeros(1, dtype=torch.int32, device=dev)
    pos = torch.full((1,), CTX, dtype=torch.int32, device=dev)
    cache = llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev)

    # one step, kernels on the card against plain versions on the CPU
    counters.reset()
    logits, _ = llama.llama_decode_step(params, cfg, token, pos, cache)
    torch.cuda.synchronize()
    per_token = counters.read()
    t0 = time.perf_counter()
    ref, _ = llama.llama_decode_step(
        to_cpu(params), cfg, token.cpu(), pos.cpu(),
        llama.init_kv_cache(cfg, 1, kv_quant=True, device="cpu"))
    plain_s = time.perf_counter() - t0
    print(f"# 7B step on the plain versions (CPU): {plain_s:.1f}s")
    rel, top_k, top_p = compare_logits(
        torch, "7B step, kernels vs plain", logits[0], ref[0], report)
    report["step_rel_logit_err"], report["step_top1"] = rel, [top_k, top_p]

    # the main path: llama_decode_multi under a CUDA graph
    fresh(cache)
    counters.reset()
    t0 = time.perf_counter()
    toks, last, next_pos, cache = llama.llama_decode_multi(
        params, cfg, token, pos, cache, STEPS)
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    report["launches_main_path"] = counters.read()
    if toks.shape != (1, STEPS) or int(next_pos) != CTX + STEPS:
        fail(f"decode_multi returned {tuple(toks.shape)}, pos {next_pos}")

    # eager loop from the same state
    fresh(cache)
    tok, p, eager = token.clone(), pos.clone(), []
    for _ in range(STEPS):
        lg, cache = llama.llama_decode_step(params, cfg, tok, p, cache)
        tok = torch.argmax(lg, -1).to(torch.int32)
        eager.append(tok)
        p = p + 1
    eager = torch.stack(eager, 1)
    same = (toks == eager)[0].int().cumprod(0).sum().item()
    print(f"# graph vs eager greedy tokens: first {same} of {STEPS} equal; "
          f"first tokens {toks[0, :8].tolist()}", flush=True)
    report["graph_eager_equal_prefix"] = same
    if same < 32:
        fail(f"graph and eager tokens differ at step {same}")

    # timing: one captured graph, 3 runs of 128 tokens from fresh state
    fresh(cache)
    g = llama.DecodeGraph(params, cfg, token, pos, cache, STEPS)
    samples = []
    for _ in range(3):
        fresh(cache)
        g.reset(token, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = g.run()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
        if not torch.equal(out, toks):
            fail("a timed graph run gave other tokens")
    dt = min(samples)
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * CTX * (cfg.head_dim + 4)
    bytes_tok = weight_bytes(cfg) + kv_bytes
    tok_s = STEPS / dt
    res = {
        "tok_s": tok_s, "ms_per_token": 1e3 * dt / STEPS,
        "tok_s_samples": [STEPS / s for s in samples],
        "decode_multi_call_s": multi_s, "bytes_per_token": bytes_tok,
        "roofline_tok_s_copy": report["copy_gbps"] * 1e9 / bytes_tok,
        "roofline_tok_s_published": HBM_BYTES_S / bytes_tok,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_main_path": report["launches_main_path"],
        "launches_per_token": per_token}
    report.update(res)
    print("# decode " + json.dumps(res), flush=True)
    return per_token


def weight_bytes(cfg):
    """INT4 weights + bf16 group-128 scales read by one decode step."""
    kvd = cfg.n_kv_heads * cfg.head_dim
    per_layer = (cfg.dim * cfg.dim * 2 + cfg.dim * kvd * 2
                 + cfg.dim * cfg.intermediate * 3)
    total = per_layer * cfg.n_layers + cfg.dim * cfg.vocab_size
    return total * 4 / 8 + total / 128 * 2


def time_prefill(torch, llama, params, cfg, prompt, cache, reps=3):
    """Min seconds of llama_prefill over `reps` runs (each rewrites the
    cache rows [0, S) with the same values); returns (s, logits)."""
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = llama.llama_prefill(params, cfg, prompt, cache)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return min(samples), logits


def generate_path(torch, llama, counters, params, cfg, dev, report,
                  per_token, dequantize_weight, dequant_matmul):
    """Phase 5. Returns each path's launch counts; adds one bf16 decode
    step's launches to per_token."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    paths, res = {}, {}
    for label, kv_quant in ((f"prompt {PROMPT}", False),
                            (f"prompt {PROMPT} int8", True)):
        # the main path: greedy_generate, the default bf16 cache first
        cache = (llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev)
                 if kv_quant else None)
        counters.reset()
        t0 = time.perf_counter()
        toks, cache = llama.greedy_generate(params, cfg, prompt, GEN,
                                            cache=cache)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        paths[label] = counters.read()
        if toks.shape != (1, GEN) or toks.dtype != torch.int32:
            fail(f"{label}: greedy_generate gave {tuple(toks.shape)} "
                 f"{toks.dtype}")
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{label}: token ids out of range")
        prefill_s, logits = time_prefill(torch, llama, params, cfg, prompt,
                                         cache)
        first = torch.argmax(logits[:, -1], -1).to(torch.int32)
        if not torch.equal(first, toks[:, 0]):
            fail(f"{label}: prefill argmax {first.tolist()} is not the "
                 f"first generated token {toks[:, 0].tolist()}")
        # the generate loop's decode: one captured step, 3 runs of GEN - 1
        # tokens from pos PROMPT (rows >= PROMPT are written before read)
        pos = torch.full((1,), PROMPT, dtype=torch.int32, device=dev)
        g = llama.DecodeGraph(params, cfg, first, pos, cache, GEN - 1)
        samples = []
        for _ in range(3):
            g.reset(first, pos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = g.run()
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
            if not torch.equal(out, toks[:, 1:]):
                fail(f"{label}: a timed decode run gave other tokens")
        del g
        row = 2 * cfg.n_layers * cfg.n_kv_heads * PROMPT
        kv_bytes = row * (cfg.head_dim + 4) if kv_quant \
            else row * cfg.head_dim * 2
        bytes_tok = weight_bytes(cfg) + kv_bytes
        tok_s = (GEN - 1) / min(samples)
        res[label] = {
            "greedy_generate_call_s": call_s, "prefill_ms": 1e3 * prefill_s,
            "prompt_tok_s": PROMPT / prefill_s, "decode_tok_s": tok_s,
            "decode_tok_s_samples": [(GEN - 1) / t for t in samples],
            "kv_bytes_per_token": kv_bytes, "bytes_per_token": bytes_tok,
            "roofline_tok_s_copy": report["copy_gbps"] * 1e9 / bytes_tok,
            "roofline_tok_s_published": HBM_BYTES_S / bytes_tok,
            "launches": paths[label], "first_tokens": toks[0, :8].tolist()}
        print(f"# {label}: " + json.dumps(res[label]), flush=True)
        del cache

    # a 256-token prompt: its matmuls take the kernels
    label = f"prompt {SHORT}"
    short = prompt[:, :SHORT].contiguous()
    counters.reset()
    toks, cache = llama.greedy_generate(params, cfg, short, 8)
    torch.cuda.synchronize()
    paths[label] = counters.read()
    counters.reset()
    prefill_s, _ = time_prefill(torch, llama, params, cfg, short, cache, 1)
    per_prompt = counters.read()
    prefill_s, _ = time_prefill(torch, llama, params, cfg, short, cache)
    res[label] = {"prefill_ms": 1e3 * prefill_s,
                  "prompt_tok_s": SHORT / prefill_s,
                  "launches": paths[label], "launches_per_prompt": per_prompt,
                  "first_tokens": toks[0].tolist()}
    print(f"# {label}: " + json.dumps(res[label]), flush=True)
    del cache

    # prefill of S-1 tokens + one bf16 decode step = the S-token prefill
    cache = llama.init_kv_cache(cfg, 1, device=dev)
    full, _ = llama.llama_prefill(params, cfg, prompt, cache)
    fresh(cache)
    llama.llama_prefill(params, cfg, prompt[:, :-1].contiguous(), cache)
    counters.reset()
    step, _ = llama.llama_decode_step(
        params, cfg, prompt[:, -1],
        torch.full((1,), PROMPT - 1, dtype=torch.int32, device=dev), cache)
    torch.cuda.synchronize()
    per_token["flash_decode"] = counters.read().get("flash_decode", 0)
    compare_logits(torch, f"7B prefill {PROMPT - 1} + bf16 step vs "
                   f"prefill {PROMPT}", step[0], full[0, -1], report)
    del cache, full

    # 2 layers at 7B width: kernels on the card against the plain versions
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = dict(params, layers=params["layers"][:2])
    got, _ = llama.llama_prefill(params2, cfg2, short,
                                 llama.init_kv_cache(cfg2, 1, device=dev))
    t0 = time.perf_counter()
    want, _ = llama.llama_prefill(
        to_cpu(params2), cfg2, short.cpu(),
        llama.init_kv_cache(cfg2, 1, device="cpu"))
    print(f"# 2-layer prefill on the plain versions (CPU): "
          f"{time.perf_counter() - t0:.1f}s")
    compare_logits(torch, f"2-layer prefill {SHORT}, kernels vs plain",
                   got[0, -1], want[0, -1], report)
    report["generate"] = res

    # the dequant route of a long prompt, per shape: dequantize_weight
    # alone, and with its cuBLAS product at PROMPT rows
    route = {}
    layer0 = params["layers"][0]
    for label, q, din in (("wqkv", layer0["wqkv"], cfg.dim),
                          ("wo", layer0["wo"], cfg.dim),
                          ("w_gateup", layer0["w_gateup"], cfg.dim),
                          ("w_down", layer0["w_down"], cfg.intermediate),
                          ("lm_head", params["lm_head"], cfg.dim)):
        x = torch.randn(PROMPT, din, generator=gen, device=dev).to(
            torch.bfloat16)
        route[label] = {
            "dequantize_ms": cuda_ms(torch, lambda q=q:
                                     dequantize_weight(q), 10),
            "dequant_matmul_ms": cuda_ms(torch, lambda x=x, q=q:
                                         dequant_matmul(x, q), 10)}
    report["dequant_route_ms"] = route
    print(f"# dequant route at {PROMPT} rows: " + json.dumps(route),
          flush=True)
    return paths


def serving_requests(np, cfg):
    """REQUESTS seeded (prompt, max_new_tokens): 64-900 prompt tokens,
    32-128 new tokens. With eos unset the engine's schedule follows from
    the lengths alone; this seed's stream makes admission wait for pages
    and never leaves an idle slot's stale block-table row aimed at a live
    request's page (stale_row_hazards; ROADMAP.md Queue 3 has the
    finding), which would make paged and dense tokens differ."""
    rng = np.random.default_rng(SEED + 4)
    return [(rng.integers(0, cfg.vocab_size, int(n)).tolist(), int(m))
            for n, m in zip(rng.integers(64, 901, REQUESTS),
                            rng.integers(32, 129, REQUESTS))]


def device_profile(torch, fn):
    """Run fn() under torch.profiler and read the card's side of it: the
    span from the first kernel's start to the last one's end, the share of
    it in which some kernel ran, and kernel milliseconds by kind. None
    where the profiler recorded no device event (then: not measured)."""
    from torch.profiler import ProfilerActivity, profile
    kinds = (("qmm_group_kernel", "qmm_group"),
             ("qmm_w4a8_kernel", "qmm_w4a8"),
             ("flash_decode_kernel", "decode attention"),
             ("flash_attention_kernel", "flash_attention"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_kind = [], {}
    for e in prof.events():
        if "CUDA" not in str(e.device_type):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        kind = next((k for sub, k in kinds if sub in e.name), "torch ops")
        by_kind[kind] = by_kind.get(kind, 0.0) \
            + (e.time_range.end - e.time_range.start) / 1e3
    if not spans:
        return None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]
    return {"span_ms": span / 1e3, "busy_share": busy / span,
            "idle_share": 1 - busy / span, "kernel_ms": by_kind,
            "device_events": len(spans)}


def stale_row_hazards(eng):
    """(uid, page index) of every live request one of whose pages is the
    first entry of an idle slot's block-table row: the idle slot's decode
    step (pos 0) writes row 0 of that page. Reads the device table."""
    table = eng.cache["block_table"].cpu().numpy()
    out = set()
    for s in range(eng.B):
        if eng.slots[s] is not None:
            continue
        for t, req in enumerate(eng.slots):
            owned = eng.allocator.owned[t]
            if req is not None and int(table[s, 0]) in owned:
                out.add((req.uid, owned.index(int(table[s, 0]))))
    return out


def serving_path(torch, llama, counters, params, cfg, dev, report,
                 per_token):
    """Phase 6. Returns the launch counts of the paged engine's drain per
    pool type; adds one paged decode step's launches to per_token."""
    import numpy as np
    from infinitensor_tpu_torch.serving import (PagedServingEngine,
                                                ServingEngine)

    reqs = serving_requests(np, cfg)
    n_layers = cfg.n_layers
    ref_cache = llama.init_kv_cache(cfg, 1, device=dev)

    def tie_gap(prefix, a, b):
        """The gap between the logits of tokens a and b after `prefix`
        (one prefill), relative to max|logit|."""
        toks = torch.tensor([prefix], dtype=torch.int32, device=dev)
        logits, _ = llama.llama_prefill(params, cfg, toks, ref_cache)
        last = logits[0, -1].float()
        return (abs(float(last[a] - last[b])) / float(last.abs().max()))

    def same_up_to_ties(what, got, want, prompts):
        """Fail unless each got[i] equals want[i], or first differs at a
        near-tie (the rest of that request then follows another history).
        Returns [(request, index, gap)] of the near-ties."""
        ties = []
        for i, (g, w) in enumerate(zip(got, want)):
            if g == w:
                continue
            j = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y),
                     None)
            if j is None:
                fail(f"{what}: request {i} has {len(g)} vs {len(w)} tokens")
            gap = tie_gap(prompts[i] + g[:j], g[j], w[j])
            ties.append((i, j, gap))
            if gap > TIE:
                fail(f"{what}: request {i} differs at token {j} "
                     f"({g[j]} vs {w[j]}), logit gap {gap:.3g} of max|logit|")
        return ties

    def drain(eng, snap_after=None):
        """Submit the stream and step to the end; returns (tokens per
        request, seconds without the snapshot's, steps, the snapshot)."""
        handles = [eng.submit(p, max_new_tokens=m, uid=i)
                   for i, (p, m) in enumerate(reqs)]
        snap, snap_s, n = None, 0.0, 0
        waited, hazards = [0], set()
        paged = hasattr(eng, "allocator")
        admit = eng._admit

        def counted_admit():
            """Count the admissions that left a request waiting for pages
            beside a free slot."""
            admit()
            waited[0] += bool(eng.pending) and None in eng.slots

        if paged:
            eng._admit = counted_admit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.pending or any(r is not None for r in eng.slots):
            eng.step()
            n += 1
            if paged:
                hazards |= stale_row_hazards(eng)
            if n == snap_after:
                t1 = time.perf_counter()
                snap = eng.snapshot()
                snap_s = time.perf_counter() - t1
            if n > 10_000:
                fail("the serving engine did not drain")
        torch.cuda.synchronize()
        took = time.perf_counter() - t0 - snap_s
        waited = waited[0]
        if paged and (not waited or hazards):
            fail(f"the stream made admission wait in {waited} steps and "
                 f"aimed stale table rows at live pages {sorted(hazards)}")
        for h, (_, m) in zip(handles, reqs):
            if not h.done or len(h.generated) != m:
                fail(f"request {h.uid}: done={h.done}, "
                     f"{len(h.generated)} of {m} tokens")
            if not all(0 <= t < cfg.vocab_size for t in h.generated):
                fail(f"request {h.uid}: token ids out of range")
        return ([list(h.generated) for h in handles], took, n, snap,
                snap_s, waited)

    prompts = [p for p, _ in reqs]
    n_new = sum(m for _, m in reqs)
    paths, res = {}, {}
    for label, kv_quant in (("serving paged bf16", False),
                            ("serving paged int8", True)):
        kname = "paged_flash_decode_q8" if kv_quant else "paged_flash_decode"
        kw = dict(max_slots=SLOTS, prefill_buckets=BUCKETS,
                  decode_chunk=CHUNK, kv_quant=kv_quant)
        paged_kw = dict(kw, n_pages=POOL_PAGES, page_size=PAGE)
        # the main path: the paged engine drains the stream
        eng = PagedServingEngine(params, cfg, **paged_kw)
        counters.reset()
        got, took, n_steps, snap, snap_s, waited = drain(eng, snap_after=6)
        paths[label] = counters.read()
        stats = dict(eng.stats)
        if eng.free_pages != POOL_PAGES - 1 or any(eng.allocator.owned):
            fail(f"{label}: {eng.free_pages} of {POOL_PAGES - 1} pages free "
                 "after the drain")
        if eng._program.graph is None:
            fail(f"{label}: the decode step was not captured")
        # warm-up + capture of the one decode graph; one pass per prefill
        if paths[label].get(kname, 0) != 2 * n_layers:
            fail(f"{label}: {paths[label].get(kname, 0)} launches of "
                 f"{kname}, expected {2 * n_layers}")
        passes = int(stats["prefill_launches"])
        if paths[label].get("flash_attention", 0) != n_layers * passes:
            fail(f"{label}: flash_attention launched "
                 f"{paths[label].get('flash_attention', 0)} times in "
                 f"{passes} prefill passes")
        pool_tokens = (POOL_PAGES - 1) * PAGE
        if pool_tokens >= SLOTS * cfg.max_seq:
            fail("the pool is not smaller than the dense reservation")

        # decode ms per step with all slots live: the engine's own graph,
        # 12 pages per slot, positions 640-703
        table = (torch.arange(SLOTS * 12, device=dev, dtype=torch.int32)
                 .reshape(SLOTS, 12) + 1)
        eng.cache["block_table"].zero_()
        eng.cache["block_table"][:, :12] = table
        tok0 = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
        pos0 = torch.full((SLOTS,), 640, dtype=torch.int32, device=dev)
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                eng._program.run(tok0, pos0, CHUNK)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) / (8 * CHUNK))
        # the card's side of two chunks (2 * CHUNK replays of the graph)
        prof = device_profile(torch, lambda: [
            eng._program.run(tok0, pos0, CHUNK) for _ in range(2)])
        # one eager step on the same cache: launches per decode step
        counters.reset()
        llama.llama_decode_step(params, cfg, tok0, pos0, eng.cache)
        torch.cuda.synchronize()
        step_launches = counters.read()
        per_token[kname] = step_launches.get(kname, 0)
        if per_token[kname] != n_layers:
            fail(f"{label}: {per_token[kname]} launches of {kname} in one "
                 f"decode step, expected {n_layers}")
        del eng

        # a fresh engine resumes the mid-stream snapshot to the same tokens
        eng = PagedServingEngine(params, cfg, **paged_kw)
        eng.restore(snap)
        handles = {r.uid: r for r in list(eng.pending)
                   + [r for r in eng.slots if r is not None]}
        eng.run_to_completion()
        resumed = sum(1 for uid, h in handles.items()
                      if list(h.generated) == got[uid])
        if resumed != len(handles) or eng.free_pages != POOL_PAGES - 1:
            fail(f"{label}: {resumed} of {len(handles)} resumed requests "
                 "ended in the tokens of the uninterrupted run")
        del eng, snap

        # the dense engine on the same stream
        dense = ServingEngine(params, cfg, **kw)
        want, dense_s, dense_steps, _, _, _ = drain(dense)
        dense_stats = dict(dense.stats)
        del dense
        ties = same_up_to_ties(f"{label} vs dense engine", got, want,
                               prompts)
        # one request against greedy_generate at batch 1
        i = min(range(REQUESTS), key=lambda i: len(prompts[i]))
        cache = llama.init_kv_cache(cfg, 1, kv_quant=kv_quant, device=dev)
        solo, _ = llama.greedy_generate(
            params, cfg, torch.tensor([prompts[i]], dtype=torch.int32,
                                      device=dev), reqs[i][1], cache=cache)
        del cache
        solo_ties = same_up_to_ties(
            f"{label} vs greedy_generate", [got[i]], [solo[0].tolist()],
            [prompts[i]])
        decode_s = stats["decode_dispatch_s"] + stats["decode_fetch_s"]
        res[label] = {
            "requests": REQUESTS, "generated_tokens": n_new,
            "prompt_tokens": sum(len(p) for p in prompts),
            "drain_s": took, "generated_tok_s": n_new / took,
            "engine_steps": n_steps, "steps_admission_waited": waited,
            "decode_steps": eng_steps(stats),
            "mean_live_slots": stats["slot_steps_active"]
            / max(stats["slot_steps_total"] / SLOTS, 1),
            "decode_ms_per_step_drain": 1e3 * decode_s
            / max(eng_steps(stats), 1),
            "decode_ms_per_step_8_live": 1e3 * min(samples),
            "decode_tok_s_8_live": SLOTS / min(samples),
            "decode_device_profile_8_live": prof,
            "stats": stats, "snapshot_s": snap_s,
            "pool_tokens": pool_tokens,
            "dense_reservation_tokens": SLOTS * cfg.max_seq,
            "launches": paths[label], "launches_per_step": step_launches,
            "dense_engine": {"drain_s": dense_s,
                             "generated_tok_s": n_new / dense_s,
                             "engine_steps": dense_steps,
                             "stats": dense_stats},
            "equal_to_dense": REQUESTS - len(ties),
            "near_ties_vs_dense": ties,
            "greedy_generate_request": i,
            "near_ties_vs_greedy_generate": solo_ties,
            "resumed_requests_equal": resumed,
            "first_tokens": got[0][:8]}
        print(f"# {label}: " + json.dumps(res[label]), flush=True)
    report["serving"] = res
    return paths


def eng_steps(stats):
    """Decode steps the engine ran (every slot steps in each)."""
    return int(stats["slot_steps_total"]) // SLOTS


if __name__ == "__main__":
    main()
