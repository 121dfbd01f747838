"""Vision inference through the ONNX path on the PyTorch/CUDA port
(counterpart of examples/resnet_onnx_inference.py): build ResNet-18v2,
export it to ONNX bytes with the built-in codec, re-import it, run it and
check it against the directly built graph.

Runs on the CUDA card; --cpu runs it on the CPU, --image a smaller image.
Prints the graph's memory plan (the native planner's peak, arena and
weight bytes; runtime/profiling.py memory_report).

Usage:
    python examples/torch_resnet_onnx_inference.py [--image 224] [--cpu]
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
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    from infinitensor_tpu_torch.models.vision import (
        build_resnet18, init_resnet18_params)
    from infinitensor_tpu_torch.onnx.exporter import export_onnx
    from infinitensor_tpu_torch.onnx.importer import OnnxStub
    from infinitensor_tpu_torch.runtime.profiling import memory_report
    from infinitensor_tpu_torch.runtime.runtime import (
        cpu_runtime, default_runtime)

    runtime = cpu_runtime() if args.cpu else default_runtime()
    rng = np.random.default_rng(0)
    params = init_resnet18_params(rng)
    h = build_resnet18(params, batch=1, image=args.image)
    h.runtime = runtime
    print("graph:", h.graph.stats()["ops"], "ops;",
          {k: v for k, v in sorted(h.graph.stats()["op_types"].items())})
    print("memory plan:", {k: v for k, v in memory_report(h.graph).items()
                           if k != "offsets"})

    data = export_onnx(h.graph, "resnet18v2").serialize()
    print(f"exported ONNX: {len(data) / 1e6:.1f} MB")

    stub = OnnxStub(data, runtime)
    x = rng.standard_normal((1, 3, args.image, args.image),
                            dtype=np.float32)
    ref = h.run({"input": x}, return_numpy=True)
    t0 = time.perf_counter()
    out = stub.run({"input": x}, return_numpy=True)
    print(f"inference {1e3 * (time.perf_counter() - t0):.1f} ms on "
          f"{runtime.device} (first run incl. capture)")
    key = list(ref)[0]
    diff = float(np.abs(out[key] - ref[key]).max())
    print("max abs diff vs direct graph:", diff)
    print("top-5 classes:", np.argsort(out[key][0])[-5:][::-1])
    return diff


if __name__ == "__main__":
    main()
