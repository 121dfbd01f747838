"""The ring form of the band kernels (kernels/csrc/band_ring.cu) where
there is no card: its route (band_form), the arguments its wrapper hands
the library (through a stand-in), and a torch emulation of its tile walk
held against the plain versions and against the JAX package's Pallas
kernels run in interpret mode.

The emulation repeats the kernel's integer arithmetic: 64-row blocks, the
window columns [c_lo, c_hi) that are rows of B, the walk (g2bmm over every
band column of a block's rows, gbmm over [c_lo, c_hi)) and its start (one
column early in bf16 where that makes a row's pair (c, c + 1) an aligned
word of the band tensor), 64-row window tiles zero-filled outside
[c_lo, c_hi), each warp's 16 rows and the window columns [lo, hi] they
reach (tiles, n8 column groups and k16 steps outside it skipped), the
shear j = c - i, and gbmm's P tiles copied from W a word at a time
(src-size 0, 2 or 4, one element zeroed after landing). Its sums are f32
matmuls, rounded once
to the operands' type, so it agrees with the plain versions within 1e-5
of max|plain| in f32 and one bf16 ulp (4e-3 of max|plain|) in bf16; the
interpreted Pallas kernels round the same f32 sums.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.kernels import band as jband
from infinitensor_tpu.utils.config import config as jconfig

from infinitensor_tpu_torch.kernels import band

ROWS = 64          # rows a block, window rows a tile
F32_TOL, BF16_TOL = 1e-5, 4e-3


def _vec(dtype):
    """Elements a 16-byte copy."""
    return 16 // torch.empty(0, dtype=dtype).element_size()


def _gran(w, f32, g2):
    """Columns of a band-tensor copy or store: one f32, a bf16 pair, or
    (gbmm's bf16 copies of W, w a multiple of 4) an 8-column chunk of 16
    bytes."""
    return 1 if f32 else 2 if g2 or w % 4 else 8


def _walk(m, r0, w, mis, f32, g2):
    """A block's rows, the window rows [c_lo, c_hi) of B it reaches, and
    its walk: the first tile's column and the tile count (g2bmm over
    every band column of its rows, gbmm over [c_lo, c_hi)); the start
    puts (mis + c0) on a multiple of the granule."""
    nrows = min(ROWS, m - r0)
    c_lo, c_hi = max(0, w - r0), min(w - r0 + m, nrows + 2 * w)
    first, end = (0, nrows + 2 * w) if g2 else (c_lo, c_hi)
    cs = first - (first + mis) % _gran(w, f32, g2)
    return nrows, c_lo, c_hi, cs, -(-(end - cs) // ROWS)


def _window_tile(bb, r0, w, c0, c_lo, c_hi, kp):
    """Window rows c0 .. c0 + 63 as staged: row c is bb[r0 - w + c] when
    c_lo <= c < c_hi, zeros otherwise and past column k; f32."""
    k = bb.shape[1]
    tile = torch.zeros(ROWS, kp)
    c = torch.arange(c0, c0 + ROWS)
    keep = (c >= c_lo) & (c < c_hi)
    tile[keep, :k] = bb[(r0 - w + c)[keep]].float()
    return tile


def _in_band(i, c, nrows, w):
    return (i < nrows) & (c - i >= 0) & (c - i <= 2 * w)


def _in_rows(c, c_lo, c_hi):
    return (c >= c_lo) & (c < c_hi)


def _warp_range(i0, c_lo, c_hi, w):
    return max(i0, c_lo), min(i0 + 15 + 2 * w, c_hi - 1)


def ring_g2bmm(a, b, w, mis=0):
    """g2bmm as the ring form computes it; `mis` is the misalignment (in
    elements) of the output tensor's start. The output starts as NaN: the
    walk must write every band element."""
    bz, m, k = a.shape
    f32, J, kp = a.dtype == torch.float32, 2 * w + 1, -(-k // 32) * 32
    out = torch.full((bz, m, J), float("nan"), dtype=a.dtype)
    ii = torch.arange(16)[:, None]
    for bi in range(bz):
        for r0 in range(0, m, ROWS):
            row0 = bi * m + r0
            nrows, c_lo, c_hi, cs, nt = _walk(
                m, r0, w, (mis + row0 * J) % _vec(a.dtype), f32, True)
            at = torch.zeros(ROWS, kp)
            at[:nrows, :k] = a[bi, r0:r0 + nrows].float()
            for t in range(nt):
                c0 = cs + t * ROWS
                tb = _window_tile(b[bi], r0, w, c0, c_lo, c_hi, kp)
                for i0 in range(0, ROWS, 16):
                    lo, hi = _warp_range(i0, c_lo, c_hi, w)
                    if i0 >= nrows or c0 > i0 + 15 + 2 * w or \
                            c0 + ROWS - 1 < i0:    # no band column
                        continue
                    s = torch.zeros(16, ROWS)
                    for f in range(8):       # n8 column groups
                        fc = c0 + 8 * f
                        if fc <= hi and fc + 7 >= lo:
                            s[:, 8 * f:8 * f + 8] = \
                                at[i0:i0 + 16] @ tb[8 * f:8 * f + 8].T
                    stage = s.to(a.dtype)
                    i = i0 + ii
                    c = c0 + torch.arange(ROWS)[None, :]
                    g = _gran(w, f32, True)   # each store is aligned
                    start = (mis + (row0 + i) * J + c - i)[:, ::g]
                    assert bool((start % g == 0).all())
                    keep = _in_band(i, c, nrows, w)
                    val = torch.where(_in_rows(c, c_lo, c_hi), stage,
                                      torch.zeros((), dtype=a.dtype))
                    out[bi, r0 + i.expand(-1, ROWS)[keep], (c - i)[keep]] = \
                        val.expand(16, -1)[keep]
    return out


def _p_tile(flat, row0, nrows, c0, c_lo, c_hi, w, mis, f32):
    """gbmm's P tile at c0 as the ring copies it from W (flat: the whole
    tensor, row0: the block's first row): a copy an element (f32), a pair
    or an 8-element chunk (bf16); src-size 0 for no term and the terms
    only for a copy that starts on one; the whole copy when it starts
    before the row's first term, what it holds outside the terms zeroed
    after it lands. Asserts each copy is aligned to its size and reads
    only inside the aligned segments that hold the tensor's elements (an
    allocation starts and ends on such a boundary)."""
    J, per = 2 * w + 1, _gran(w, f32, False)
    p = torch.zeros(ROWS, ROWS)
    for r in range(ROWS):
        lo, hi = max(r, c_lo), min(r + 2 * w, c_hi - 1)
        for q in range(0, ROWS, per):
            c = c0 + q
            v = [r < nrows and lo <= c + e <= hi for e in range(per)]
            if not any(v):
                continue
            idx = (row0 + r) * J + c - r          # the copy's first element
            assert (mis + idx) % per == 0         # an aligned copy
            # from a term: its terms (src-size); else the whole copy
            n = sum(v) if v[0] else per
            assert mis + idx >= mis - mis % per and \
                mis + idx + n <= -(-(mis + flat.numel()) // per) * per
            for e in range(n):
                p[r, q + e] = flat[idx + e].float() \
                    if 0 <= idx + e < flat.numel() else float("nan")
        f = lo - c0                               # the fix after landing
        f0 = f - f % per
        if r < nrows and lo <= hi and 0 <= f < ROWS and f != f0:
            p[r, f0:f] = 0.0
            p[r, hi - c0 + 1:f0 + per] = 0.0
    return p


def ring_gbmm(wts, b, w, mis=0):
    """gbmm as the ring form computes it; `mis` is the misalignment (in
    elements) of the W tensor's start."""
    bz, m, k = b.shape
    f32, J, kp = b.dtype == torch.float32, 2 * w + 1, -(-k // 32) * 32
    out = torch.empty(bz, m, k, dtype=b.dtype)
    flat = wts.reshape(-1)
    for bi in range(bz):
        for r0 in range(0, m, ROWS):
            nrows, c_lo, c_hi, cs, nt = _walk(
                m, r0, w, (mis + (bi * m + r0) * J) % _vec(b.dtype), f32,
                False)
            acc = torch.zeros(ROWS, kp)
            for t in range(nt):
                c0 = cs + t * ROWS
                tb = _window_tile(b[bi], r0, w, c0, c_lo, c_hi, kp)
                p = _p_tile(flat, bi * m + r0, nrows, c0, c_lo, c_hi, w,
                            mis, f32)
                for i0 in range(0, ROWS, 16):
                    lo, hi = _warp_range(i0, c_lo, c_hi, w)
                    if i0 >= nrows or c0 > hi or c0 + ROWS - 1 < lo:
                        continue
                    for kk in range(ROWS // 16):   # k16 steps
                        kc = c0 + 16 * kk
                        if kc <= hi and kc + 15 >= lo:
                            acc[i0:i0 + 16] += \
                                p[i0:i0 + 16, 16 * kk:16 * kk + 16] \
                                @ tb[16 * kk:16 * kk + 16]
            out[bi, r0:r0 + nrows] = acc[:nrows, :k].to(b.dtype)
    return out


def _inputs(rng, bz, m, k, w, dtype):
    a, b = (torch.from_numpy(rng.standard_normal((bz, m, k))).to(dtype)
            for _ in range(2))
    wts = torch.softmax(torch.from_numpy(
        rng.standard_normal((bz, m, 2 * w + 1))), -1).to(dtype)
    return a, b, wts


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bz,m,k,w", [
    (2, 1, 8, 0), (3, 17, 24, 1), (1, 63, 64, 7), (2, 64, 96, 64),
    (1, 65, 128, 64), (2, 130, 32, 130), (1, 300, 256, 7),
    (1, 40, 16, 256)])
@pytest.mark.parametrize("mis", [0, 1, 3])
def test_ring_walk_matches_plain(dtype, bz, m, k, w, mis):
    """The emulated tile walk against g2bmm_plain / gbmm_plain: ragged
    m, m < w, w 0 and wider than a block, k below a 32-column step, band
    spans off a 16-byte boundary by 0, 1 or 3 elements."""
    rng = np.random.default_rng(m * 31 + k + w)
    a, b, wts = _inputs(rng, bz, m, k, w, dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    _close(ring_g2bmm(a, b, w, mis), band.g2bmm_plain(a, b, w), tol)
    _close(ring_gbmm(wts, b, w, mis), band.gbmm_plain(wts, b, w), tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("m,k,w", [(72, 24, 0), (200, 64, 3), (72, 16, 70)])
def test_ring_walk_matches_interpreted_kernels(dtype, m, k, w):
    """The emulated tile walk against the JAX Pallas kernels in interpret
    mode (their row block a multiple of 8 dividing m and >= w): 72 and
    200 rows are ragged against the ring's 64-row blocks; w 0, and w 70
    wider than a block."""
    rng = np.random.default_rng(m + w)
    a = jnp.asarray(rng.standard_normal((2, m, k)), dtype)
    b = jnp.asarray(rng.standard_normal((2, m, k)), dtype)
    wts = jnp.asarray(rng.standard_normal((2, m, 2 * w + 1)), dtype)
    with jconfig.override(pallas_interpret=True):
        want_s = jband.g2bmm_band(a, b, w, 1, interpret=True)
        want_o = jband.gbmm_band(wts, b, w, 1, interpret=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    t = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(tdt)  # noqa
    tol = F32_TOL if tdt == torch.float32 else BF16_TOL
    _close(ring_g2bmm(t(a), t(b), w, mis=1), t(want_s), tol)
    _close(ring_gbmm(t(wts), t(b), w, mis=1), t(want_o), tol)


@pytest.mark.parametrize("a_dt,b_dt,k,form", [
    (torch.bfloat16, torch.bfloat16, 64, "ring"),
    (torch.float32, torch.float32, 128, "ring"),
    (torch.bfloat16, torch.bfloat16, 8, "ring"),
    (torch.float32, torch.float32, 256, "ring"),
    (torch.float32, torch.bfloat16, 64, "simt"),
    (torch.bfloat16, torch.float32, 64, "simt"),
    (torch.bfloat16, torch.bfloat16, 20, "simt"),
    (torch.bfloat16, torch.bfloat16, 264, "simt"),
    (torch.float16, torch.float16, 64, "simt")])
def test_band_form_route(a_dt, b_dt, k, form):
    """The ring form takes both operands bf16 or both f32 at k a multiple
    of 8 from 8 to 256; a mixed pair and any other k keep the old form."""
    assert band.band_form(a_dt, b_dt, k) == form


class _FakeLib:
    """Stands in for a band library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("op", ["g2bmm", "gbmm"])
@pytest.mark.parametrize("dtypes,k,form", [
    ((torch.bfloat16, torch.bfloat16), 64, None),
    ((torch.float32, torch.float32), 24, None),
    ((torch.float32, torch.bfloat16), 64, None),
    ((torch.bfloat16, torch.bfloat16), 20, None),
    ((torch.bfloat16, torch.bfloat16), 64, "simt")])
def test_band_launch_takes_its_form(op, dtypes, k, form, monkeypatch):
    """The wrapper's launch (read through stand-in libraries: the
    arguments, not the kernels) calls the ring library for what band_form
    routes there, the old one for a mixed pair, k 20 or a forced "simt";
    "g2bmm" / "gbmm" count every launch, "<op>_ring" the ring's again."""
    ring, simt = _FakeLib(), _FakeLib()
    monkeypatch.setattr(band, "_lib_ring", lambda: ring)
    monkeypatch.setattr(band, "_lib", lambda: simt)
    monkeypatch.setattr(band._build, "stream", lambda: None)
    bz, m, w = 2, 10, 3
    first = torch.zeros(bz, m, k if op == "g2bmm" else 2 * w + 1,
                        dtype=dtypes[0])
    b = torch.zeros(bz, m, k, dtype=dtypes[1])
    out = torch.zeros(1)
    before = dict(band.launches)
    band._launch(op, first, b, w, out, form)
    routed = (form or band.band_form(*dtypes, k)) == "ring"
    lib = ring if routed else simt
    (name, args), = lib.calls
    assert not (simt if routed else ring).calls
    ptr = band._build.ptr
    if routed:
        assert name == op + "_ring"
        assert [args[i].value for i in range(3)] == \
            [ptr(t).value for t in (first, b, out)]
        assert args[3:8] == (dtypes[1] == torch.float32, bz, m, k, w)
    else:
        assert name == op
        assert args[1] == (dtypes[0] == torch.float32)
        assert args[3] == (dtypes[1] == torch.float32)
        assert args[5:9] == (bz, m, k, w)
    assert band.launches[op] == before.get(op, 0) + 1
    assert band.launches[op + "_ring"] == \
        before.get(op + "_ring", 0) + routed


def test_band_ring_refuses_what_it_does_not_take(monkeypatch):
    """Forcing the ring form on a mixed pair or an odd k raises (no launch,
    no fallback); an operand off a 16-byte boundary reaches the ring as an
    aligned copy."""
    ring = _FakeLib()
    monkeypatch.setattr(band, "_lib_ring", lambda: ring)
    monkeypatch.setattr(band._build, "stream", lambda: None)
    for first, b in ((torch.zeros(1, 8, 64), torch.zeros(
            1, 8, 64, dtype=torch.bfloat16)),
                     (torch.zeros(1, 8, 20), torch.zeros(1, 8, 20))):
        with pytest.raises(ValueError, match="no form 'ring'"):
            band._launch("g2bmm", first, b, 2, torch.zeros(1), "ring")
    assert not ring.calls
    buf = torch.zeros(1 + 8 * 64, dtype=torch.bfloat16)
    a = buf[1:].view(1, 8, 64)
    assert a.data_ptr() % 16
    band._launch("g2bmm", a, a, 2, torch.zeros(1), None)
    (_, args), = ring.calls
    assert args[0].value % 16 == 0 and args[1].value % 16 == 0


@pytest.mark.parametrize("op,dts,bz,m,k,w,usable", [
    # the ring form: any m and w, bz up to a launch's grid
    ("g2bmm", (torch.bfloat16,) * 2, 8, 2048, 128, 64, True),
    ("gbmm", (torch.float32,) * 2, 12, 4096, 256, 4096, True),
    ("g2bmm", (torch.float32,) * 2, 65535, 4, 8, 1, True),
    ("g2bmm", (torch.float32,) * 2, 65536, 4, 8, 1, False),
    ("gbmm", (torch.bfloat16,) * 2, 65536, 4, 8, 1, False),
    # the first form: its window staged whole in one block
    ("g2bmm", (torch.float32,) * 2, 2, 64, 512, 128, False),
    ("gbmm", (torch.float32,) * 2, 2, 64, 512, 128, False),
    ("g2bmm", (torch.float32,) * 2, 2, 64, 512, 32, True),
    ("g2bmm", (torch.bfloat16, torch.float32), 3, 100, 64, 20, True),
    ("gbmm", (torch.float32, torch.bfloat16), 1, 300, 20, 130, True),
    ("g2bmm", (torch.bfloat16,) * 2, 1, 1, 1000, 0, True),
    ("g2bmm", (torch.bfloat16,) * 2, 65536, 4, 20, 1, False),
    # types no form takes
    ("g2bmm", (torch.float16,) * 2, 1, 8, 64, 2, False),
])
def test_band_gate(op, dts, bz, m, k, w, usable):
    """band_kernels_usable, the lowerings' gate, is true exactly where the
    form band_form picks launches: bz at most 65535 (a launch's grid y),
    and for the first form a window that fits a block's shared memory (an
    f32 G2BMM at k 512, w 128 needs 529,432 bytes for one row against
    232,448; at w 32 it fits). Dilation 2 is always refused."""
    assert band.band_kernels_usable(op, *dts, bz, m, k, w, 1) == usable
    assert not band.band_kernels_usable(op, *dts, bz, m, k, w, 2)


@pytest.mark.parametrize("op", ["g2bmm", "gbmm"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [20, 36, 300, 512, 1000])
def test_band_gate_mirrors_pick_rows(op, dt, k):
    """The first form's half of the gate against csrc/band.cu's pick_rows
    and padded<T> written out here once more: one row and its 2w + 1
    window rows, each tile's rows padded as the kernel pads them, within
    232,448 bytes; the widest w that fits passes and the next one does
    not."""
    el = torch.empty(0, dtype=dt).element_size()

    def ld(k):
        if el == 4:
            return k | 1
        s = k + (k & 1)
        return s if s % 4 == 2 else s + 2

    def fits(w):
        row, win = ((ld(k) * el, ld(k) * el) if op == "g2bmm"
                    else ((2 * w + 1) * el, k * el))
        return row + 16 + (1 + 2 * w) * win <= 232448

    widest = max(w for w in range(0, 4096) if fits(w))
    assert band.band_form(dt, dt, k) == "simt"
    assert band.band_kernels_usable(op, dt, dt, 2, 64, k, widest, 1)
    assert not band.band_kernels_usable(op, dt, dt, 2, 64, k, widest + 1, 1)
