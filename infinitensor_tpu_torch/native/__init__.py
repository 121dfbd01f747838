"""ctypes bindings of the native C++ components under native/ (the graph
scheduler, the ONNX wire scanner and the memory planner)."""
from infinitensor_tpu_torch.native.planner import (
    MemoryPlanner, plan_graph_memory, native_available,
)

__all__ = ["MemoryPlanner", "plan_graph_memory", "native_available"]
