from infinitensor_tpu_torch.core.dtype import DataType
from infinitensor_tpu_torch.core.tensor import TensorObj, TensorRole
from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.handler import GraphHandler

__all__ = ["DataType", "TensorObj", "TensorRole", "Operator", "Graph", "GraphHandler"]
