"""The port's nnet/* expression half (expr.py, visitors.py, rules.py,
iterator_table.py, derivation.py, derivator.py, evaluator.py) on the CPU,
against the JAX package's on the same expressions and the same numpy feeds.

* The comprehensions of matmul, the three conv families of
  tools/derivation_bench.py (at their full widths: building an expression
  evaluates nothing) and G2BMM serialize and hash alike in both packages.
* Every rule (1-5, 8, 9, 90, 91 and the matchers) gives the JAX rule's
  output, equal in serialize().
* derive_op_program gives the JAX package's candidates in its order, for
  one small conv and one matmul (oracle on: the JAX side is one
  module-scoped derivation, since its first one costs seconds).
* The evaluator agrees with the JAX evaluator on matmul, the padded,
  strided and dilated conv, every Func, /, //, %, an unpadded
  out-of-range access and a negative index: f32 within 1e-5 of max|JAX|
  (both sum in f32, in another order), integers exact, bf16 feeds give
  bf16 within one bf16 ulp at max|JAX| (2^-8 of it). The chunked path
  equals the unchunked one under a tiny budget.

Both packages number fresh vars and stages from module-global counters;
each comparison resets all four before building. The JAX evaluator runs
under jax.jit, as the JAX package's MemBound lowering traces it (one XLA
compile a distinct program instead of one a primitive: the same values,
in a few seconds less).
"""

import itertools
import json

import jax
import numpy as np
import pytest
import torch

from infinitensor_tpu.nnet import derivation as jderiv
from infinitensor_tpu.nnet import derivator as jdtor
from infinitensor_tpu.nnet import evaluator as jeval
from infinitensor_tpu.nnet import expr as jexpr
from infinitensor_tpu.nnet import iterator_table as jtable
from infinitensor_tpu.nnet import rules as jrules
from infinitensor_tpu.nnet import visitors as jvis

from infinitensor_tpu_torch.nnet import derivation as tderiv
from infinitensor_tpu_torch.nnet import derivator as tdtor
from infinitensor_tpu_torch.nnet import evaluator as teval
from infinitensor_tpu_torch.nnet import expr as texpr
from infinitensor_tpu_torch.nnet import iterator_table as ttable
from infinitensor_tpu_torch.nnet import rules as trules
from infinitensor_tpu_torch.nnet import visitors as tvis

TOL = 1e-5
BF16 = 2.0 ** -8

#: each package's modules under one set of names
JAX = dict(deriv=jderiv, expr=jexpr, rules=jrules, vis=jvis, table=jtable)
PORT = dict(deriv=tderiv, expr=texpr, rules=trules, vis=tvis, table=ttable)

#: tools/derivation_bench.py's conv families at full width:
#: (n, c, h, w, f, r, s, pad, stride, dilation)
FAMILIES = {"stem": (8, 3, 224, 224, 64, 7, 7, 3, 2, 1),
            "dilated": (8, 256, 28, 28, 256, 3, 3, 2, 1, 2),
            "conv1x1": (32, 192, 28, 28, 64, 1, 1, 0, 1, 1)}


def reset_counters():
    for m in (jexpr, texpr):
        m._counter = itertools.count()
    for m in (jrules, trules):
        m._stage_counter = itertools.count()


def both(make):
    """make(modules) built by each package from the same counters."""
    reset_counters()
    j = make(JAX)
    reset_counters()
    t = make(PORT)
    return j, t


def conv(m, key):
    n, c, h, w, f, r, s, pad, stride, dil = FAMILIES[key]
    return m["deriv"].conv_expr(n, c, h, w, f, r, s, pad=pad, stride=stride,
                                dilation=dil)


def g2bmm(m):
    E = m["expr"]
    b, i, w, k = (E.fresh_var(n) for n in "biwk")
    A = E.TensorRef("A", (2, 16, 8))
    B = E.TensorRef("B", (2, 16, 8), paddings=(0, 4, 0))
    return E.Comprehension([(b, 2), (i, 16), (w, 9)], [(k, 8)],
                           A[b, i, k] * B[b, i + w - 4, k])


EXPRS = {"matmul": lambda m: m["deriv"].matmul_expr(64, 128, 32),
         "matmul_tt": lambda m: m["deriv"].matmul_expr(
             4, 8, 6, trans_a=True, trans_b=True),
         "g2bmm": g2bmm,
         **{k: (lambda m, k=k: conv(m, k)) for k in FAMILIES}}


def ser(m, comp):
    return m["vis"].serialize(comp)


def ser_prog(m, prog):
    """A program as plain data: each stage's name, serialized comp and
    routine kind."""
    if prog is None:
        return None
    return [(s.name, ser(m, s.comp), (s.routine or {}).get("kind"))
            for s in prog.stages]


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expressions_serialize_and_hash_alike(name):
    j, t = both(EXPRS[name])
    assert ser(JAX, j) == ser(PORT, t)
    assert jvis.comp_hash(j) == tvis.comp_hash(t)
    assert jvis.expr_hash(j.body) == tvis.expr_hash(t.body)
    assert repr(j) == repr(t)
    assert jvis.check_oob(j) == tvis.check_oob(t)


# -- the rules ---------------------------------------------------------------

def _prog(m, comp):
    R = m["rules"]
    return R.Program([R.Stage("out", comp)])


def _names(comp):
    (i, _), (j, _) = comp.loop_vars
    return {"i": i.name, "j": j.name, "k": comp.sum_vars[0][0].name}


def _r1_sum(m):
    mm = m["deriv"].matmul_expr(4, 8, 6)
    return m["rules"].rule1_sum_var_split(mm, mm.sum_vars[0][0], 4)


def _r1_loop(m):
    mm = m["deriv"].matmul_expr(4, 8, 6)
    return m["rules"].rule1_loop_var_split(mm, mm.loop_vars[0][0], 2)


def _r2(m):
    mm = m["deriv"].matmul_expr(4, 8, 6)
    return m["rules"].rule2_var_merge(mm, mm.loop_vars[0][0],
                                      mm.loop_vars[1][0])


def _r5(m):
    mm = m["deriv"].matmul_expr(5, 8, 6)
    comp, pad = m["rules"].rule5_range_relax(mm, mm.loop_vars[0][0], 8)
    return comp, pad


def _r3(m):
    c = m["deriv"].conv_expr(1, 2, 5, 5, 3, 3, 3, pad=1)
    return m["rules"].rule3_stage_split(_prog(m, c), "out", c.body.lhs)


def _r4(m):
    split = _r3(m)
    return m["rules"].rule4_stage_merge(split, split.stages[0].name)


def _r8(r, s, pad, stride):
    def make(m):
        c = m["deriv"].conv_expr(2, 3, 8, 8, 4, r, s, pad=pad, stride=stride)
        return m["rules"].rule8_guided_dlt(_prog(m, c), "out")
    return make


def _r90(m):
    E, R = m["expr"], m["rules"]
    i = E.fresh_var("i")
    X = E.TensorRef("X", (8,))
    p = R.Stage("t", E.Comprehension([(i, 8)], [], X[i] * 2.0))
    j = E.fresh_var("j")
    T = E.TensorRef("t", (8,))
    f = R.Stage("out", E.Comprehension([(j, 8)], [], E.Func("relu", T[j])))
    return R.rule90_merge_elementwise(R.Program([p, f]), "out")


def _r91(m):
    """A matmul stage consumed by a summing product: rule 91 inlines it,
    distributing the product over its sum."""
    E, R = m["expr"], m["rules"]
    P = R.Stage("P", m["deriv"].matmul_expr(4, 8, 6))
    i, j = E.fresh_var("i"), E.fresh_var("j")
    T, C = E.TensorRef("P", (4, 6)), E.TensorRef("C", (6,))
    out = R.Stage("out", E.Comprehension([(i, 4)], [(j, 6)], T[i, j] * C[j]))
    return R.rule91_merge_stage_with_sum(R.Program([P, out]), "P")


def _prog_rule(rule, var, arg, make=lambda d: d.matmul_expr(6, 12, 5)):
    def run(m):
        comp = make(m["deriv"])
        return getattr(m["rules"], rule)(_prog(m, comp), "out",
                                         _names(comp)[var], arg)
    return run


def _r2_prog(m):
    c = m["deriv"].conv_expr(1, 2, 6, 6, 3, 3, 3)
    (cv, _), (rv, _), _ = c.sum_vars
    return m["rules"].rule2_program(_prog(m, c), "out", cv.name, rv.name)


COMP_RULES = {"rule1_sum_var_split": _r1_sum,
              "rule1_loop_var_split": _r1_loop,
              "rule2_var_merge": _r2}

PROG_RULES = {"rule3_stage_split": _r3, "rule4_stage_merge": _r4,
              "rule8_1x1": _r8(1, 1, 0, 1), "rule8_3x3_p1": _r8(3, 3, 1, 1),
              "rule8_3x3_p1_s2": _r8(3, 3, 1, 2),
              "rule90_merge_elementwise": _r90,
              "rule91_merge_stage_with_sum": _r91,
              "rule1_program": _prog_rule("rule1_program", "k", 4),
              "rule1_loop_program": _prog_rule("rule1_loop_program", "i", 2),
              "rule5_program": _prog_rule("rule5_program", "i", 8),
              "rule9_program": _prog_rule("rule9_program", "k", 8),
              "rule2_program": _r2_prog}


@pytest.mark.parametrize("name", sorted(COMP_RULES))
def test_comprehension_rules_match_jax(name):
    j, t = both(COMP_RULES[name])
    assert j is not None and ser(JAX, j) == ser(PORT, t)


def test_rule5_range_relax_matches_jax():
    (jc, jp), (tc, tp) = both(_r5)
    assert jp == tp == 3 and ser(JAX, jc) == ser(PORT, tc)


@pytest.mark.parametrize("name", sorted(PROG_RULES))
def test_program_rules_match_jax(name):
    j, t = both(PROG_RULES[name])
    assert j is not None and ser_prog(JAX, j) == ser_prog(PORT, t)
    assert j.hash() == t.hash()


def _plain(d):
    """A matcher's dict as plain data (tensor refs by name and shape)."""
    if d is None:
        return None
    out = {}
    for k, v in d.items():
        if hasattr(v, "shape") and hasattr(v, "name"):
            v = (v.name, tuple(v.shape), tuple(v.paddings))
        elif isinstance(v, list):
            v = [tuple((x.name, e) if hasattr(x, "name") else x
                       for x in item) if isinstance(item, tuple) else item
                 for item in v]
        out[k] = v
    return out


MATCHES = {
    "match_routine_matmul": lambda m: m["rules"].match_routine(
        m["deriv"].matmul_expr(3, 4, 5, True, False)),
    "match_matmul": lambda m: m["deriv"].match_matmul(
        m["deriv"].matmul_expr(3, 4, 5, False, True)),
    "match_conv": lambda m: m["rules"].match_conv(
        m["deriv"].conv_expr(2, 3, 8, 8, 4, 3, 3, pad=1, stride=2)),
    "match_g2bmm": lambda m: m["rules"].match_g2bmm(g2bmm(m)),
    "match_matmul_table": lambda m: m["table"].match_matmul_table(
        _permuted_matmul(m)),
}


def _permuted_matmul(m):
    E = m["expr"]
    A = E.TensorRef("A", (4, 6))
    B = E.TensorRef("B", (6, 5))
    i, j, k = E.fresh_var("i"), E.fresh_var("j"), E.fresh_var("k")
    return E.Comprehension([(j, 5), (i, 4)], [(k, 6)], B[k, j] * A[i, k])


@pytest.mark.parametrize("name", sorted(MATCHES))
def test_matchers_match_jax(name):
    j, t = both(MATCHES[name])
    assert j is not None and _plain(j) == _plain(t)


# -- the derivator -----------------------------------------------------------

DERIVED = {"conv": lambda m: m["deriv"].conv_expr(
               1, 3, 10, 10, 4, 3, 3, pad=1, stride=2, dilation=2),
           "matmul": lambda m: m["deriv"].matmul_expr(6, 12, 5)}


def _cands(m, cands):
    return [(c.score(), c.n_routines, ser_prog(m, c.program)) for c in cands]


def jax_eval(comp, feeds):
    return jax.jit(lambda f: jeval.evaluate(comp, f))(feeds)


_JITTED = {}


def jax_eval_program(prog, feeds, _orig=jeval.evaluate_program):
    """jeval.evaluate_program jitted, one compile per distinct program (the
    oracle evaluates its input program once per candidate)."""
    key = json.dumps([(s.name, jvis.serialize(s.comp)) for s in prog.stages])
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda f: _orig(prog, f))
    return _JITTED[key](feeds)


@pytest.fixture(scope="module")
def jax_derived():
    """The JAX package's derivations, oracle on, its evaluator jitted."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeval, "evaluate_program", jax_eval_program)
        for name, make in DERIVED.items():
            reset_counters()
            out[name] = _cands(JAX, jdtor.derive_op_program(make(JAX),
                                                            max_depth=2))
    return out


@pytest.mark.parametrize("name", sorted(DERIVED))
def test_derive_op_program_matches_jax(name, jax_derived):
    reset_counters()
    got = _cands(PORT, tdtor.derive_op_program(DERIVED[name](PORT),
                                               max_depth=2, device="cpu"))
    assert got and got == jax_derived[name]


def test_derivator_unverified_search_matches_jax():
    """verify=False: the symbolic search alone, on the full-width dilated
    family, needs no device and gives the JAX package's candidates."""
    def run(m, dtor):
        return _cands(m, dtor.derive_op_program(conv(m, "dilated"),
                                                max_depth=2, verify=False))
    reset_counters()
    j = run(JAX, jdtor)
    reset_counters()
    t = run(PORT, tdtor)
    assert len(t) > 8 and t == j


def test_oracle_takes_the_card_by_default():
    """device=None is the card, or an error where there is none: the
    oracle never falls back to the CPU."""
    d = tdtor.Derivator(max_depth=1)
    prog = _prog(PORT, tderiv.matmul_expr(2, 3, 4))
    if torch.cuda.is_available():
        assert d._equivalent(prog, prog)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            d._equivalent(prog, prog)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teval.evaluate(prog.stages[0].comp, {})


# -- the evaluator -----------------------------------------------------------

def _feeds(comp, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {t.name: rng.standard_normal(t.shape).astype(dtype)
            for t in comp.inputs()}


def _close(got, want, tol=TOL):
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    want = np.asarray(want, np.float32) if str(want.dtype) == "bfloat16" \
        else np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
        return
    top = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol * top, (err, top)


def _conv_small(pad, stride, dil):
    return lambda m: m["deriv"].conv_expr(2, 3, 9, 9, 4, 3, 3, pad=pad,
                                          stride=stride, dilation=dil)


def _funcs(fn):
    def make(m):
        E = m["expr"]
        i, j = E.fresh_var("i"), E.fresh_var("j")
        X = E.TensorRef("X", (5, 7))
        return E.Comprehension([(i, 5), (j, 7)], [],
                               E.Func(fn, X[i, j] * 0.5 + 0.25))
    return make


def _index_math(m):
    """Float / int arithmetic on index grids: /, //, % with negative
    operands, read through a padded access."""
    E = m["expr"]
    i, j = E.fresh_var("i"), E.fresh_var("j")
    X = E.TensorRef("X", (6, 8), paddings=(2, 2))
    return E.Comprehension(
        [(i, 6), (j, 8)], [],
        X[(i - 3) // 2 + 1, (j - 5) % 4 + j // -3] + (i - 2) / 4.0)


def _int_only(m):
    E = m["expr"]
    i, j = E.fresh_var("i"), E.fresh_var("j")
    return E.Comprehension([(i, 6), (j, 5)], [],
                           (i - 3) // 2 * 7 + (j - 4) % 3)


def _out_of_range(m):
    """Unpadded dims read past both ends and at negative indices: JAX
    wraps a negative index once and clamps."""
    E = m["expr"]
    i, j = E.fresh_var("i"), E.fresh_var("j")
    X = E.TensorRef("X", (5, 4))
    return E.Comprehension([(i, 9), (j, 7)], [],
                           X[i * 2 - 8, j - 3] + X[-1, j + 9] * X[i, -6])


def _summed_oob(m):
    """A sum over an access out of range at both ends, unpadded."""
    E = m["expr"]
    i, k = E.fresh_var("i"), E.fresh_var("k")
    X = E.TensorRef("X", (4, 6))
    return E.Comprehension([(i, 5)], [(k, 9)], X[i - 1, k - 2] * (k - 4))


EVALS = {"matmul": lambda m: m["deriv"].matmul_expr(7, 12, 5),
         "matmul_tt": lambda m: m["deriv"].matmul_expr(7, 12, 5, True, True),
         "conv_padded": _conv_small(1, 1, 1),
         "conv_strided": _conv_small(1, 2, 1),
         "conv_dilated": _conv_small(2, 1, 2),
         "conv_all": _conv_small(3, 2, 2),
         "g2bmm": g2bmm,
         "index_math": _index_math,
         "int_only": _int_only,
         "out_of_range": _out_of_range,
         "summed_oob": _summed_oob,
         **{f"func_{fn}": _funcs(fn)
            for fn in ("relu", "tanh", "exp", "sigmoid")}}


@pytest.mark.parametrize("name", sorted(EVALS))
def test_evaluator_matches_jax(name):
    j, t = both(EVALS[name])
    feeds = _feeds(j)
    want = np.asarray(jax_eval(j, feeds))
    got = teval.evaluate(t, feeds, device="cpu")
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    _close(got, want)


@pytest.mark.parametrize("name", ["matmul", "conv_all", "func_sigmoid"])
def test_evaluator_bf16_feeds_match_jax(name):
    import jax.numpy as jnp
    j, t = both(EVALS[name])
    feeds = _feeds(j)
    want = jax_eval(j, {k: jnp.asarray(v, jnp.bfloat16)
                        for k, v in feeds.items()})
    got = teval.evaluate(t, {k: torch.from_numpy(v).bfloat16()
                             for k, v in feeds.items()}, device="cpu")
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    _close(got, np.asarray(want, np.float32), tol=BF16)


@pytest.mark.parametrize("name", ["matmul", "conv_all", "summed_oob",
                                  "g2bmm"])
@pytest.mark.parametrize("budget", [1, 7, 64])
def test_chunked_equals_unchunked(name, budget, monkeypatch):
    _, t = both(EVALS[name])
    feeds = _feeds(t)
    whole = teval.evaluate(t, feeds, device="cpu")
    monkeypatch.setattr(teval, "ELEMENT_BUDGET", budget)
    parts = teval.evaluate(t, feeds, device="cpu")
    _close(parts, whole.numpy())


def test_chunks_cover_the_grid_once():
    """Each chunk holds at most the budget (or one index of every loop
    var), and the chunks tile the loop grid."""
    loop, inner = [3, 5, 4], 6
    for budget in (1, 6, 24, 50, 119, 360, 10 ** 6):
        seen = np.zeros(loop, np.int64)
        for ranges in teval._chunks(loop, inner, budget):
            size = int(np.prod([hi - lo for lo, hi in ranges]))
            assert size * inner <= max(budget, inner)
            seen[tuple(slice(lo, hi) for lo, hi in ranges)] += 1
        assert (seen == 1).all()


def test_evaluate_program_matches_jax():
    """A rule-8 program (gather, matmul, restores) evaluated stage by
    stage, each stage a feed of the next."""
    j, t = both(_r8(3, 3, 1, 2))
    feeds = {"X": np.random.default_rng(1).standard_normal(
                 (2, 3, 8, 8)).astype(np.float32),
             "W": np.random.default_rng(2).standard_normal(
                 (4, 3, 3, 3)).astype(np.float32)}
    want = np.asarray(jax_eval_program(j, feeds))
    _close(teval.evaluate_program(t, feeds, device="cpu"), want)
