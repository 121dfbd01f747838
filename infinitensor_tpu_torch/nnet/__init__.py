"""EinNet/NNET analog: tensor-comprehension expression IR + derivation
(counterpart of infinitensor_tpu/nnet/).

The reference's src/nnet is a C++ expression IR (RangeOp/Subscript/Tensor/
BinaryOp) with rule-based derivation producing library-call matches and
MemBound residue ops. Here the expression IR evaluates directly with
torch (evaluator.py): broadcast index grids and gathers, run eagerly and
captured with the rest of a graph in one CUDA graph on the card.

Every module but evaluator.py is a copy of the JAX package's, bound to
this package's IR; evaluator.py is the torch port of the JAX evaluator.
"""

from infinitensor_tpu_torch.nnet.expr import (  # noqa: F401
    Access, BinOp, Comprehension, Const, Func, TensorRef, Var, fresh_var,
)
from infinitensor_tpu_torch.nnet.derivator import (  # noqa: F401
    Candidate, Derivator, derive_op_program,
)
from infinitensor_tpu_torch.nnet.rules import Program, Stage, match_routine  # noqa: F401
from infinitensor_tpu_torch.nnet.nmutator import NMutator  # noqa: F401
