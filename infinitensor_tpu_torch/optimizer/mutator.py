"""Mutators: enumerate semantically-equivalent rewrites of a small graph
(counterpart of infinitensor_tpu/optimizer/mutator.py).

The reference's Mutator interface (include/core/mutator.h:6-33) with a
rule-based implementation in place of the C++ NMutator: each rule proposes
alternative graphs for a partition; SearchEngine scores them. Rules target
transforms an op-by-op lowering will not make by itself (algorithm
substitution, layout-level algebra — the PET/EinNet "partially equivalent
transformation" class):

* conv 1x1 -> reshaped matmul
* conv -> im2col matmul (for small spatial dims)
* two same-shape matmuls sharing an input -> single concatenated matmul
* matmul(transpose(x), w) -> matmul with transA flag
* masked S x S band attention -> G2BMM / GBMM (the band kernels)

Copy of the JAX package's module, all five rules, with one difference:
the band rule's edge mask takes the band's dtype (the JAX rule makes it
f32 always). A bf16 band plus an f32 mask computes in f32, so the bf16
block would reach GBMM as an f32 x bf16 pair, which only the band
kernels' first form takes; in the band's dtype the block stays bf16 and
GBMM takes the ring form. -1e9 rounds to -999817216 in bf16 and to -inf
in f16; either gives the masked columns a softmax weight of 0.
"""

from __future__ import annotations

import numpy as np

from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.core.tensor import TensorObj, TensorRole


class Mutator:
    def run(self, graph: Graph) -> list[Graph]:
        raise NotImplementedError


class RuleBasedMutator(Mutator):
    """Applies each applicable rule once, returning mutated clones."""

    RULES = ("conv1x1_to_matmul", "conv_to_im2col_matmul",
             "merge_parallel_matmuls", "fold_transpose",
             "band_attention_to_g2bmm")

    def run(self, graph: Graph) -> list[Graph]:
        out = []
        for rule in self.RULES:
            g = graph.clone()
            if getattr(self, rule)(g):
                g.topo_sort()
                out.append(g)
        return out

    # -- rules -------------------------------------------------------------
    def conv1x1_to_matmul(self, g: Graph) -> bool:
        """Conv kxk=1x1 stride 1 -> transpose/reshape + matmul + reshape.
        (EinNet conv->gemm class; reference test_conv2gemm.cc)"""
        changed = False
        for op in list(g.operators):
            if op.op_type != "Conv":
                continue
            w = op.inputs[1]
            if w.shape[2:] != (1, 1):
                continue
            if op.attrs.get("strides", [1, 1]) != [1, 1] or \
                    any(op.attrs.get("pads", [0] * 4)) or \
                    op.attrs.get("group", 1) != 1 or len(op.inputs) > 2:
                continue
            x = op.inputs[0]
            out = op.outputs[0]
            n, c, hh, ww = x.shape
            f = w.shape[0]
            g.remove_op(op)
            # x [N,C,H,W] -> [N,H,W,C] -> [N*H*W, C]
            t1 = TensorObj((n, hh, ww, c), x.dtype)
            g.add_tensor(t1)
            g.add_op(Operator("Transpose", [x], [t1],
                              {"perm": [0, 2, 3, 1]}))
            t2 = TensorObj((n * hh * ww, c), x.dtype)
            g.add_tensor(t2)
            g.add_op(Operator("Reshape", [t1], [t2],
                              {"shape": [n * hh * ww, c]}))
            # w [F,C,1,1] -> [F,C] -> matmul transB
            wf = TensorObj((f, c), w.dtype)
            g.add_tensor(wf)
            g.add_op(Operator("Reshape", [w], [wf], {"shape": [f, c]}))
            mm = TensorObj((n * hh * ww, f), x.dtype)
            g.add_tensor(mm)
            g.add_op(Operator("MatMul", [t2, wf], [mm], {"transB": True}))
            t3 = TensorObj((n, hh, ww, f), x.dtype)
            g.add_tensor(t3)
            g.add_op(Operator("Reshape", [mm], [t3],
                              {"shape": [n, hh, ww, f]}))
            fin = Operator("Transpose", [t3], [out], {"perm": [0, 3, 1, 2]})
            g.add_op(fin)
            changed = True
        return changed

    def conv_to_im2col_matmul(self, g: Graph) -> bool:
        """General conv -> im2col gather + matmul. Profitable when the
        native conv underuses the matmul units (small channel counts)."""
        changed = False
        for op in list(g.operators):
            if op.op_type != "Conv":
                continue
            x, w = op.inputs[0], op.inputs[1]
            if op.attrs.get("group", 1) != 1 or len(op.inputs) > 2:
                continue
            if len(x.shape) != 4:
                continue
            kh, kw = w.shape[2:]
            if (kh, kw) == (1, 1):
                continue  # other rule
            if x.shape[1] * kh * kw > 4096:
                continue  # im2col blowup not worth it
            out = op.outputs[0]
            n, c, ih, iw = x.shape
            f = w.shape[0]
            oh, ow = out.shape[2:]
            g.remove_op(op)
            g.add_op(Operator("Im2colMatmulConv", [x, w], [out],
                              dict(op.attrs)))
            changed = True
        return changed

    def merge_parallel_matmuls(self, g: Graph) -> bool:
        """Two MatMuls sharing input a with same-shape weights -> one
        matmul against concat(w1, w2) + split (reference DummyMutator's
        batched-matmul merge, src/core/dummy_mutator.cc:10-45)."""
        changed = False
        for t in list(g.tensors):
            mms = [c for c in t.targets
                   if c.op_type == "MatMul" and c.inputs[0] is t
                   and not c.attrs.get("transA") and not c.attrs.get("transB")
                   and c.inputs[1].role == TensorRole.WEIGHT
                   and c.inputs[1].has_data()]
            if len(mms) < 2:
                continue
            a, b = mms[0], mms[1]
            w1, w2 = a.inputs[1], b.inputs[1]
            if w1.shape[:-1] != w2.shape[:-1]:
                continue
            merged = np.concatenate([w1.numpy(), w2.numpy()], axis=-1)
            wm = TensorObj(merged.shape, w1.dtype, role=TensorRole.WEIGHT,
                           name=f"{w1.name}_{w2.name}_merged")
            wm.set_data(merged)
            g.add_tensor(wm)
            o1, o2 = a.outputs[0], b.outputs[0]
            g.remove_op(a)
            g.remove_op(b)
            big = TensorObj(o1.shape[:-1] + (o1.shape[-1] + o2.shape[-1],),
                            o1.dtype)
            g.add_tensor(big)
            g.add_op(Operator("MatMul", [t, wm], [big], {}))
            g.add_op(Operator("Split", [big], [o1, o2],
                              {"axis": -1,
                               "split": [o1.shape[-1], o2.shape[-1]]}))
            changed = True
        return changed

    @staticmethod
    def _band_width_from_mask(mask: np.ndarray):
        """mask [S, S] (possibly with leading 1-dims): 0 inside a
        symmetric band |i-j| <= w, <= -1e8 outside -> w, else None."""
        m = np.squeeze(mask)
        if m.ndim != 2 or m.shape[0] != m.shape[1]:
            return None
        S = m.shape[0]
        row0 = m[0]
        inside = row0 >= -1.0
        if not inside[0]:
            return None
        w = int(inside.argmin() - 1) if not inside.all() else S - 1
        if w < 1 or w >= S - 1:
            return None
        i, j = np.indices(m.shape)
        band = np.abs(i - j) <= w
        if not ((np.abs(m[band]) < 1e-6).all()
                and (m[~band] <= -1e8).all()):
            return None
        return w

    def band_attention_to_g2bmm(self, g: Graph) -> bool:
        """Longformer band attention written in STANDARD ops —
            scores = MatMul(Q, K^T); masked = scores + band_mask;
            probs = Softmax(masked); out = MatMul(probs, V)
        with band_mask a constant 0/-1e9 band — becomes the band-kernel
        form the reference ships a dedicated CUDA kernel for
        (src/kernels/cuda/gbmm_g2bmm.cu):
            band  = G2BMM(Q, K, w)            [b, S, 2w+1]
            probs = Softmax(band + edge_mask) [b, S, 2w+1]
            out   = GBMM(probs, V, w)         [b, S, D]
        edge_mask re-masks the out-of-range diagonals at the sequence
        edges (the kernel zero-fills them; softmax needs -inf). Exact:
        in-band logits are identical and e^-1e9 == 0.0 in f32, so the
        full-graph softmax assigns the SAME probabilities. The S x S
        score tensor (and its S/(2w+1)-fold HBM traffic) never exists.
        The edge mask is in the band's dtype (see the module docstring)."""
        changed = False
        for add in list(g.operators):
            if add.op_type != "Add" or len(add.inputs) != 2:
                continue
            mm1 = add.inputs[0].source
            mask_t = add.inputs[1]
            if mm1 is None or mm1.op_type != "MatMul":
                mm1, mask_t = mask_t.source if mask_t.source else None, \
                    add.inputs[0]
                if mm1 is None or mm1.op_type != "MatMul":
                    continue
            if not (mask_t.has_data() and len(add.outputs[0].targets) == 1
                    and len(mm1.outputs[0].targets) == 1):
                continue
            sm = add.outputs[0].targets[0]
            if sm.op_type != "Softmax" or \
                    int(sm.attrs.get("axis", -1)) not in (-1, 2):
                continue
            if len(sm.outputs[0].targets) != 1:
                continue
            mm2 = sm.outputs[0].targets[0]
            if mm2.op_type != "MatMul" or mm2.inputs[0] is not sm.outputs[0]:
                continue
            w = self._band_width_from_mask(mask_t.numpy())
            if w is None:
                continue
            # resolve Q, K from the scores matmul: K^T via transB or an
            # explicit Transpose of the last two dims
            q = mm1.inputs[0]
            kt = mm1.inputs[1]
            if mm1.attrs.get("transB"):
                k = kt
            else:
                tr = kt.source
                perm_ok = tr is not None and tr.op_type == "Transpose" \
                    and list(tr.attrs.get("perm", []))[-2:] == \
                    [kt.rank - 1, kt.rank - 2]
                if not perm_ok:
                    continue
                k = tr.inputs[0]
            v = mm2.inputs[1]
            if not (q.rank == 3 and k.rank == 3 and v.rank == 3
                    and q.shape == k.shape):
                continue
            bz, S, D = q.shape
            out = mm2.outputs[0]

            band = TensorObj((bz, S, 2 * w + 1), q.dtype,
                             name=f"{out.name}_band")
            g.add_tensor(band)
            i, j = np.indices((S, 2 * w + 1))
            oob = ((i + j - w < 0) | (i + j - w >= S))
            em = np.where(oob, np.float32(-1e9), np.float32(0.0))
            em_t = TensorObj((S, 2 * w + 1), q.dtype,
                             role=TensorRole.WEIGHT,
                             name=f"{out.name}_edge_mask")
            em_t.set_data(em.astype(q.dtype.np()))
            g.add_tensor(em_t)
            masked = TensorObj((bz, S, 2 * w + 1), q.dtype,
                               name=f"{out.name}_band_masked")
            g.add_tensor(masked)
            probs = TensorObj((bz, S, 2 * w + 1), q.dtype,
                              name=f"{out.name}_band_probs")
            g.add_tensor(probs)

            g.remove_op(mm1)
            g.remove_op(add)
            g.remove_op(sm)
            g.remove_op(mm2)
            g.add_op(Operator("G2BMM", [q, k], [band],
                              {"width": w, "dilation": 1}))
            g.add_op(Operator("Add", [band, em_t], [masked], {}))
            g.add_op(Operator("Softmax", [masked], [probs], {"axis": -1}))
            g.add_op(Operator("GBMM", [probs, v], [out], {"dilation": 1}))
            changed = True
        return changed

    def fold_transpose(self, g: Graph) -> bool:
        from infinitensor_tpu_torch.optimizer.rewrite import (
            fold_transpose_into_matmul)
        return fold_transpose_into_matmul(g)
