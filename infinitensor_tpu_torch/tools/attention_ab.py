"""The attention kernels of two checkouts timed in one call, on one card:
the fast bf16 decode, merge, paged and prefill kernels at the shapes of
chip_smoke.py phase 3 (Llama-2-7B: decode at pos 1024, batch 1, MHA 32/32
and GQA 32/8; the paged step of 8 slots; the 1024-token prompt; GPT-2's
head dim 64 at 64 slots; entry()'s prompt), and the any-type prefill
(flash_attention_any) at causal 1 x 32 x 256 x 128 and 1 x 32 x 1024 x
128 in f32 and 1 x 32 x 256 x 256 in bf16.

    python -m infinitensor_tpu_torch.tools.attention_ab OLD_ROOT [NEW_ROOT]

Each root (a checkout's top directory; NEW_ROOT defaults to this one) is
built first, both at once, then timed in its own process (two libraries
with the same kernel names in one process fail their launches above 48 KB
of shared memory), in turns: old, new, new, old. Each process calls only
the wrappers' interface, which both checkouts share. A time is the
median of 50 CUDA-event timings after a 1 GB memset (cold L2). Prints the
card (nvidia-smi name and power limit) and one JSON line {row: {"old":
[ms, ms], "new": [ms, ms]}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

BUILD = "from infinitensor_tpu_torch.kernels import _build; _build.build_all()"


def time_rows() -> dict:
    """{row: ms} of the attention kernels of the checkout on the import
    path (seeded inputs, rows past pos never read)."""
    import torch

    from infinitensor_tpu_torch.kernels import attention as att
    from infinitensor_tpu_torch.kernels import flash_attention as fa
    from infinitensor_tpu_torch.kernels import paged_attention as pa
    from infinitensor_tpu_torch.tools.qmm_bench import _ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def sc(*shape):
        return torch.rand(*shape, generator=gen, device=dev) * 0.015 + 0.005

    rows = {}
    S, D = 1664, 128
    pos = torch.full((1,), 1024, dtype=torch.int32, device=dev)
    for label, Hkv in (("mha 32/32", 32), ("gqa 32/8", 8)):
        q = rnd(1, 32, 1, D)
        q8 = (q, i8(1, Hkv, S, D), i8(1, Hkv, S, D), sc(1, Hkv, S),
              sc(1, Hkv, S), pos)
        kv = (q, rnd(1, Hkv, S, D), rnd(1, Hkv, S, D), pos)
        rows[f"flash_decode_q8 {label} pos 1024"] = \
            lambda a=q8: att.flash_decode_q8(*a)
        rows[f"flash_decode {label} pos 1024"] = \
            lambda a=kv: att.flash_decode(*a)
        if Hkv == 32:
            part = att.flash_decode_q8_split_plain(
                *q8, att.launch_splits(1, 32, S)).contiguous()
            rows["flash_decode_merge mha 32/32"] = \
                lambda p=part: att.flash_decode_merge(p)
    B, H, S64 = 64, 16, 384                      # GPT-2 345M at 64 slots
    pos64 = torch.randint(16, 314, (B,), generator=gen, device=dev).to(
        torch.int32)
    q = rnd(B, H, 1, 64)
    q8 = (q, i8(B, H, S64, 64), i8(B, H, S64, 64), sc(B, H, S64),
          sc(B, H, S64), pos64)
    kv = (q, rnd(B, H, S64, 64), rnd(B, H, S64, 64), pos64)
    rows["flash_decode_q8 D 64 B 64"] = lambda: att.flash_decode_q8(*q8)
    rows["flash_decode D 64 B 64"] = lambda: att.flash_decode(*kv)
    P, MP, SLOTS = 64, 26, 8                     # the paged step
    N = SLOTS * MP + 1
    ppos = torch.tensor([693, 960, 1023, 1024, 1025, 1087, 1224, 1501],
                        dtype=torch.int32, device=dev)
    table = (torch.randperm(N - 1, generator=gen, device=dev)[:SLOTS * MP]
             + 1).reshape(SLOTS, MP).to(torch.int32)
    for label, Hkv in (("mha 32/32", 32), ("gqa 32/8", 8)):
        q = rnd(SLOTS, 32, 1, D)
        a8 = (q, i8(N, Hkv, P, D), i8(N, Hkv, P, D), sc(N, Hkv, P),
              sc(N, Hkv, P), table, ppos)
        a16 = (q, rnd(N, Hkv, P, D), rnd(N, Hkv, P, D), table, ppos)
        rows[f"paged_flash_decode_q8 {label} 8 slots"] = \
            lambda a=a8: pa.paged_flash_decode_q8(*a)
        rows[f"paged_flash_decode {label} 8 slots"] = \
            lambda a=a16: pa.paged_flash_decode(*a)
    qkv = tuple(rnd(1, 32, 1024, D) for _ in range(3))
    rows["flash_attention causal 1x32x1024x128"] = \
        lambda: fa.flash_attention(*qkv, causal=True)
    qkv64 = tuple(rnd(2, 8, 64, 64) for _ in range(3))
    rows["flash_attention causal 2x8x64x64"] = \
        lambda: fa.flash_attention(*qkv64, causal=True)
    for dt, S, D in ((torch.float32, 256, 128), (torch.float32, 1024, 128),
                     (bf16, 256, 256)):            # the any-type prefill
        qkv_any = tuple(torch.randn(1, 32, S, D, generator=gen, device=dev)
                        .to(dt) for _ in range(3))
        name = "f32" if dt == torch.float32 else "bf16"
        rows[f"flash_attention_any {name} causal 1x32x{S}x{D}"] = \
            lambda a=qkv_any: fa.flash_attention(*a, causal=True)
    return {name: _ms(fn, flush) for name, fn in rows.items()}


def _run(root: Path, code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{root}: {out.stderr[-4000:]}")
    return out.stdout


def main(argv, tool: str = __file__, doc: str = __doc__) -> None:
    """Build both roots, then print the rows of `tool`'s time_rows() from
    each, in turns (tools/step_ab.py runs through this main)."""
    if len(argv) not in (1, 2):
        sys.exit(doc)
    here = Path(__file__).resolve().parents[2]
    roots = {"old": Path(argv[0]).resolve(),
             "new": Path(argv[1]).resolve() if len(argv) == 2 else here}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=r,
                               env=dict(os.environ, PYTHONPATH=str(r)))
              for r in roots.values()]
    if any([b.wait() for b in builds]):
        sys.exit(f"{Path(tool).stem}: a build failed")
    code = ("import json, runpy; print(json.dumps(runpy.run_path("
            f"{str(Path(tool).resolve())!r})['time_rows']()))")
    got = {}
    for which in ("old", "new", "new", "old"):
        out = _run(roots[which], code).splitlines()[-1]
        for row, ms in json.loads(out).items():
            got.setdefault(row, {"old": [], "new": []})[which].append(ms)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# card: {smi}")
    print(json.dumps(got))


if __name__ == "__main__":
    main(sys.argv[1:])
