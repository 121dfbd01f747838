from infinitensor_tpu_torch.onnx.importer import OnnxStub, import_onnx
from infinitensor_tpu_torch.onnx.exporter import export_onnx
from infinitensor_tpu_torch.onnx import proto

__all__ = ["OnnxStub", "import_onnx", "export_onnx", "proto"]
