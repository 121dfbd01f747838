"""Generic ONNX inference CLI on the PyTorch/CUDA port (counterpart of
examples/onnx_inference.py): load an .onnx file, import it with the port's
OnnxStub, run it with random (or provided .npz) inputs, print outputs and
per-run latency, optionally re-export.

Runs on the CUDA card (one captured CUDA graph per input signature);
--cpu runs it on the CPU's eager executor. The per-op tuning and the graph
rewrites of the JAX example wait for their modules (ROADMAP.md Queue 1
items 12 and 13).

Usage:
    python examples/torch_onnx_inference.py model.onnx [--inputs data.npz]
        [--runs 5] [--cpu] [--export out.onnx]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model")
    ap.add_argument("--inputs", help=".npz with one array per graph input")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--export", help="re-export the imported graph to .onnx")
    args = ap.parse_args(argv)

    from infinitensor_tpu_torch.onnx.importer import OnnxStub
    from infinitensor_tpu_torch.runtime.runtime import (
        cpu_runtime, default_runtime)

    runtime = cpu_runtime() if args.cpu else default_runtime()
    t0 = time.perf_counter()
    stub = OnnxStub(args.model, runtime)
    print(f"imported in {time.perf_counter() - t0:.2f}s; "
          f"{len(stub.handler.graph.operators)} ops; on {runtime.device}")

    rng = np.random.default_rng(0)
    feeds = {}
    provided = dict(np.load(args.inputs)) if args.inputs else {}
    for name, t in stub.inputs.items():
        if name in provided:
            feeds[name] = provided[name]
        elif np.issubdtype(t.dtype.np(), np.integer):
            feeds[name] = rng.integers(0, 2, size=t.shape,
                                       dtype=t.dtype.np())
        else:
            feeds[name] = rng.standard_normal(t.shape).astype(t.dtype.np())
        print(f"input {name}: {t.shape} {t.dtype.name}"
              f"{' (from file)' if name in provided else ' (random)'}")

    t0 = time.perf_counter()
    out = stub.run(feeds, return_numpy=True)
    print(f"first run (incl. capture): "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    t0 = time.perf_counter()
    for _ in range(args.runs):
        out = stub.run(feeds, return_numpy=True)
    print(f"avg latency: {1e3 * (time.perf_counter() - t0) / args.runs:.2f} "
          f"ms over {args.runs} runs (host clock, outputs fetched)")

    for name, arr in out.items():
        flat = np.asarray(arr, np.float64).reshape(-1)
        print(f"output {name}: {arr.shape} {arr.dtype} "
              f"mean={flat.mean():.4f} first={flat[:4]}")

    if args.export:
        from infinitensor_tpu_torch.onnx.proto import save_model
        save_model(stub.to_onnx("reexport"), args.export)
        print(f"re-exported to {args.export}")
    return out


if __name__ == "__main__":
    main()
