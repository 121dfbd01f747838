"""Horizontal multi-branch merge (the reference's ``searchMerge``).

The reference SearchEngine DFS-enumerates groupings of sibling compute ops
at the topological frontier and fuses groups its mutator accepts (two
matmuls -> one batched matmul, reference src/core/search_engine.cc:206-316
searchMerge/searchMergeDfs + src/core/dummy_mutator.cc:26-45
mergeMultiBranch). Recast here: merge opportunities are found by
graph analysis (independent sibling ops of compatible shape), each group
can be applied independently, and the SearchEngine scores merged variants
against the original with its perf-cache cost model. The payoffs are
fewer kernel launches and larger matmul tiles — the multi-branch wins
(Inception-style parallel branches) no op-by-op lowering makes on its
own.

Merge kinds:
* shared_a_matmul — N matmuls reading the same activation against
  different weights: concat weights along the output dim -> one matmul ->
  split (the Megatron fused-QKV transform at graph scope).
* stacked_matmul  — N independent same-shape 2D matmuls: stack operands on
  a new leading batch dim -> one batched matmul -> split (reference
  DummyMutator::mergeMultiBranch semantics).
* sibling_conv    — N convs on the same input with identical attrs and
  kernel geometry: concat filters on the out-channel dim -> one conv ->
  split channels (Inception branch fusion).

Copy of infinitensor_tpu/optimizer/merge.py (no jax code).
"""

from __future__ import annotations

from typing import Optional

from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.core.tensor import TensorObj, TensorRole


def _ancestor_sets(graph: Graph) -> dict:
    """guid -> set of ancestor op guids (graph must be topo-sorted)."""
    anc: dict[int, set] = {}
    for op in graph.operators:
        s: set = set()
        for p in op.predecessors():
            s.add(p.guid)
            s |= anc.get(p.guid, set())
        anc[op.guid] = s
    return anc


def _independent(ops, anc) -> bool:
    guids = [o.guid for o in ops]
    return not any(
        a != b and a in anc.get(b, set())
        for a in guids for b in guids)


def _attr_key(attrs: dict) -> str:
    return repr(sorted((k, v) for k, v in attrs.items()))


def find_merge_groups(graph: Graph) -> list:
    """Enumerate horizontal merge opportunities: (kind, [op names])."""
    graph.require_sorted()
    anc = _ancestor_sets(graph)
    groups = []
    taken: set = set()

    # 1. matmuls sharing the same first input (2-input; transB siblings
    #    merge too — weights are [n, k], concatenated on the OUT axis 0;
    #    the reference's searchMerge accepts whatever its mutator merges,
    #    search_engine.cc:206-316)
    by_a: dict[tuple, list] = {}
    for op in graph.operators:
        if (op.op_type == "MatMul" and len(op.inputs) == 2
                and not op.attrs.get("transA")
                and len(op.inputs[1].shape) == 2):
            key = (op.inputs[0].guid, bool(op.attrs.get("transB")))
            by_a.setdefault(key, []).append(op)
    for ops in by_a.values():
        ops = [o for o in ops if o.guid not in taken]
        if len(ops) >= 2 and _independent(ops, anc):
            groups.append(("shared_a_matmul", [o.name for o in ops]))
            taken.update(o.guid for o in ops)

    # 2. independent same-shape matmuls (distinct operands): 2D pairs
    #    stack onto a new batch dim; already-batched 3D pairs concatenate
    #    along their existing batch dim
    by_shape: dict[tuple, list] = {}
    for op in graph.operators:
        if (op.op_type == "MatMul" and len(op.inputs) == 2
                and op.guid not in taken
                and len(op.inputs[0].shape) in (2, 3)
                and len(op.inputs[0].shape) == len(op.inputs[1].shape)
                and not op.attrs.get("transA")):
            key = (op.inputs[0].shape, op.inputs[1].shape,
                   bool(op.attrs.get("transB")))
            by_shape.setdefault(key, []).append(op)
    for ops in by_shape.values():
        if len(ops) >= 2 and _independent(ops, anc):
            groups.append(("stacked_matmul", [o.name for o in ops]))
            taken.update(o.guid for o in ops)

    # 3. sibling convs: same input, same attrs, same C/kh/kw
    by_conv: dict[tuple, list] = {}
    for op in graph.operators:
        if op.op_type == "Conv" and len(op.inputs) == 2 \
                and op.attrs.get("group", 1) == 1:
            key = (op.inputs[0].guid, _attr_key(op.attrs),
                   tuple(op.inputs[1].shape[1:]))
            by_conv.setdefault(key, []).append(op)
    for ops in by_conv.values():
        if len(ops) >= 2 and _independent(ops, anc):
            groups.append(("sibling_conv", [o.name for o in ops]))
    return groups


def apply_merges(graph: Graph, groups) -> Optional[Graph]:
    """Clone `graph` and apply each (kind, op-names) group. Returns the
    merged clone, or None if nothing applied."""
    g = graph.clone()
    changed = False
    for kind, names in groups:
        by_name = {op.name: op for op in g.operators}
        ops = [by_name[n] for n in names if n in by_name]
        if len(ops) < 2:
            continue
        if kind == "shared_a_matmul":
            changed |= _merge_shared_a(g, ops)
        elif kind == "stacked_matmul":
            changed |= _merge_stacked(g, ops)
        elif kind == "sibling_conv":
            changed |= _merge_conv(g, ops)
    if not changed:
        return None
    g.topo_sort()
    return g


def _add(g: Graph, op_type, ins, outs, attrs) -> Operator:
    return g.add_op(Operator(op_type, ins, outs, attrs))


def _bias_add_of(g: Graph, out: TensorObj):
    """If `out` feeds exactly one Add whose other operand is a 1-D vector
    of out's trailing dim (the Gemm bias decomposition the importer
    emits), return that Add op. A graph-OUTPUT pre-bias tensor is never
    fusable: fusion deletes it, which would drop a graph boundary."""
    if out.role is TensorRole.OUTPUT:
        return None
    consumers = [op for op in g.operators
                 if any(t is out for t in op.inputs)]
    if len(consumers) != 1 or consumers[0].op_type != "Add":
        return None
    add = consumers[0]
    other = add.inputs[1] if add.inputs[0] is out else add.inputs[0]
    if tuple(other.shape) == (out.shape[-1],):
        return add
    return None


def _merge_shared_a(g: Graph, ops) -> bool:
    a = ops[0].inputs[0]
    trans_b = bool(ops[0].attrs.get("transB"))
    ws = [o.inputs[1] for o in ops]
    outs = [o.outputs[0] for o in ops]
    kdim = 1 if trans_b else 0          # contraction axis of the weight
    k = ws[0].shape[kdim]
    if any(w.shape[kdim] != k for w in ws):
        return False
    # Gemm-style bias fusion: when EVERY sibling's output feeds a 1-D bias
    # Add, fold the Adds into one over the concatenated bias
    bias_adds = [_bias_add_of(g, o) for o in outs]
    fuse_bias = all(b is not None for b in bias_adds) and \
        len({b.guid for b in bias_adds}) == len(bias_adds)
    for o in ops:
        g.remove_op(o)
    nsum = sum(w.shape[1 - kdim] for w in ws)
    wcat = TensorObj((nsum, k) if trans_b else (k, nsum), ws[0].dtype)
    g.add_tensor(wcat)
    _add(g, "Concat", ws, [wcat], {"axis": 0 if trans_b else 1})
    big = TensorObj(outs[0].shape[:-1] + (nsum,), outs[0].dtype)
    g.add_tensor(big)
    _add(g, "MatMul", [a, wcat], [big],
         {"transB": True} if trans_b else {})
    if fuse_bias:
        biases = []
        final_outs = []
        for add, o in zip(bias_adds, outs):
            biases.append(add.inputs[1] if add.inputs[0] is o
                          else add.inputs[0])
            final_outs.append(add.outputs[0])
            g.remove_op(add)
        bcat = TensorObj((nsum,), biases[0].dtype)
        g.add_tensor(bcat)
        _add(g, "Concat", biases, [bcat], {"axis": 0})
        biased = TensorObj(big.shape, big.dtype)
        g.add_tensor(biased)
        _add(g, "Add", [big, bcat], [biased], {})
        _add(g, "Split", [biased], final_outs,
             {"axis": -1, "split": [o.shape[-1] for o in final_outs]})
        for o in outs:                  # dead pre-bias intermediates
            g.remove_tensor(o)
        return True
    _add(g, "Split", [big], outs,
         {"axis": -1, "split": [o.shape[-1] for o in outs]})
    return True


def _merge_stacked(g: Graph, ops) -> bool:
    """Stack N same-shape matmuls into one batched matmul. 2D operands
    gain a new leading batch dim; 3D (already batched) operands
    concatenate along their existing batch dim. transB siblings keep the
    attr on the merged op."""
    n = len(ops)
    rank = len(ops[0].inputs[0].shape)
    trans_b = bool(ops[0].attrs.get("transB"))
    attrs = {"transB": True} if trans_b else {}
    outs = [o.outputs[0] for o in ops]
    if rank == 2:
        m, k = ops[0].inputs[0].shape
        wshape = ops[0].inputs[1].shape
        nn = wshape[0] if trans_b else wshape[1]
        a3s, w3s = [], []
        for o in ops:
            a3 = TensorObj((1, m, k), o.inputs[0].dtype)
            w3 = TensorObj((1,) + tuple(wshape), o.inputs[1].dtype)
            g.add_tensor(a3)
            g.add_tensor(w3)
            _add(g, "Reshape", [o.inputs[0]], [a3], {"shape": [1, m, k]})
            _add(g, "Reshape", [o.inputs[1]], [w3],
                 {"shape": [1] + list(wshape)})
            a3s.append(a3)
            w3s.append(w3)
        for o in ops:
            g.remove_op(o)
        acat = TensorObj((n, m, k), a3s[0].dtype)
        wcat = TensorObj((n,) + tuple(wshape), w3s[0].dtype)
        big = TensorObj((n, m, nn), outs[0].dtype)
        for t in (acat, wcat, big):
            g.add_tensor(t)
        _add(g, "Concat", a3s, [acat], {"axis": 0})
        _add(g, "Concat", w3s, [wcat], {"axis": 0})
        _add(g, "MatMul", [acat, wcat], [big], attrs)
        slices = []
        for o in outs:
            s3 = TensorObj((1, m, nn), o.dtype)
            g.add_tensor(s3)
            slices.append(s3)
        _add(g, "Split", [big], slices, {"axis": 0, "split": [1] * n})
        for s3, o in zip(slices, outs):
            _add(g, "Reshape", [s3], [o], {"shape": [m, nn]})
        return True
    # rank 3: concat along the existing batch dim
    b, m, k = ops[0].inputs[0].shape
    wshape = ops[0].inputs[1].shape
    nn = wshape[1] if trans_b else wshape[2]
    a_ins = [o.inputs[0] for o in ops]
    w_ins = [o.inputs[1] for o in ops]
    for o in ops:
        g.remove_op(o)
    acat = TensorObj((n * b, m, k), a_ins[0].dtype)
    wcat = TensorObj((n * b,) + tuple(wshape[1:]), w_ins[0].dtype)
    big = TensorObj((n * b, m, nn), outs[0].dtype)
    for t in (acat, wcat, big):
        g.add_tensor(t)
    _add(g, "Concat", a_ins, [acat], {"axis": 0})
    _add(g, "Concat", w_ins, [wcat], {"axis": 0})
    _add(g, "MatMul", [acat, wcat], [big], attrs)
    _add(g, "Split", [big], outs, {"axis": 0, "split": [b] * n})
    return True


def _merge_conv(g: Graph, ops) -> bool:
    x = ops[0].inputs[0]
    ws = [o.inputs[1] for o in ops]
    outs = [o.outputs[0] for o in ops]
    attrs = dict(ops[0].attrs)
    for o in ops:
        g.remove_op(o)
    fsum = sum(w.shape[0] for w in ws)
    wcat = TensorObj((fsum,) + tuple(ws[0].shape[1:]), ws[0].dtype)
    g.add_tensor(wcat)
    _add(g, "Concat", ws, [wcat], {"axis": 0})
    big = TensorObj((outs[0].shape[0], fsum) + tuple(outs[0].shape[2:]),
                    outs[0].dtype)
    g.add_tensor(big)
    _add(g, "Conv", [x, wcat], [big], attrs)
    _add(g, "Split", [big], outs,
         {"axis": 1, "split": [o.shape[1] for o in outs]})
    return True


def _set_partitions(items: list):
    """All partitions of `items` into blocks (standard recursive
    enumeration, reference searchMergeDfs's plan space)."""
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in _set_partitions(rest):
        for i in range(len(part)):
            yield part[:i] + [[first] + part[i]] + part[i + 1:]
        yield [[first]] + part


def _subset_selections(kind: str, names: list, cap: int) -> list:
    """Bounded DFS over sibling groupings: every way to partition the
    sibling set into merge blocks (size >= 2; singletons stay unmerged),
    except the single all-together block (enumerated separately). The
    reference enumerates the same space with a recursive plan mask
    (src/core/search_engine.cc:206-316 searchMergeDfs)."""
    if len(names) < 3:
        return []
    out = []
    for part in _set_partitions(list(names)):
        blocks = [b for b in part if len(b) >= 2]
        if not blocks or (len(blocks) == 1 and len(blocks[0]) == len(names)):
            continue
        out.append([(kind, b) for b in blocks])
        if len(out) >= cap:
            break
    return out


def search_merge(graph: Graph, max_variants: int = 12) -> list:
    """Enumerate merged variants (reference searchMergeDfs, bounded):
    variant 0 applies ALL groups; then each group alone; then sub-group
    partitions of every sibling set of >= 3 (other sets fully merged) —
    the cost model picks the winner."""
    groups = find_merge_groups(graph)
    if not groups:
        return []
    variants = []
    selections = [groups]                       # all-on first
    if len(groups) > 1:
        selections += [[grp] for grp in groups]  # each alone
    for kind, names in groups:
        others = [g for g in groups if g[1] is not names]
        for sel in _subset_selections(kind, names,
                                      cap=max_variants - len(selections)):
            selections.append(others + sel)
    for sel in selections[:max_variants]:
        got = apply_merges(graph, sel)
        if got is not None:
            variants.append(got)
    return variants
