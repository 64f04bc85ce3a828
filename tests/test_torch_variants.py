"""The window-sum kernel's variant forms in the port (radix 32, int16
partials, int32 tables, windows per block, the unrolled body, 32 lanes a
block), the select-only form K2s, the micro-probes' chains and the two
kernel knobs, on the CPU, where every wrapper runs its plain PyTorch
version.  Inputs are made with numpy and Python's `random` from fixed seeds
and given to the JAX package and the port alike.

Tolerances: exact.  Digit planes and 17-entry tables equal the JAX
package's byte for byte; radix-32 window sums equal the JAX package's XLA
kernel as group elements (the fold order differs, so not limb for limb)
and, Horner-combined, the exact host MSM; every variant form that keeps
64 lanes a block equals the 20-limb default (`arith="l20"`, the design the
variants share) limb for limb, and the 32-lane form and the default K2
(csrc/window_sums_u32.cuh, another order of additions and canonical
limbs) equal it as group elements.  The -l20 plain forms equal their
earlier outputs byte for byte (a hash of them).  One slow case holds the JAX
Pallas kernel in interpret mode against the port's forms."""

import hashlib
import random
import re

import numpy as np
import pytest
import torch

from ed25519_consensus_tpu.ops import limbs as jlimbs
from ed25519_consensus_tpu.ops import msm as jmsm
from ed25519_consensus_tpu_torch.error import ConfigError
from ed25519_consensus_tpu_torch.ops import _cuda, edwards, limbs, msm, probes
from ed25519_consensus_tpu_torch.ops import torch_edwards as TE
from ed25519_consensus_tpu_torch.ops.field import P

B, N = 2, 200  # ragged: 200 lanes end inside the fourth 64-lane chunk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops.  With several test
    workers on one host, torch's intra-op thread pools oversubscribe the
    cores; one thread per worker keeps the workers out of each other's
    way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _terms(n, seed):
    """n (scalar, point) terms: the eight torsion points and random
    multiples of the basepoint, scalars 0, 1, 2^128 - 1 and random."""
    rng = random.Random(seed)
    pts = edwards.eight_torsion() + [
        edwards.BASEPOINT.scalar_mul(rng.randrange(1, 2**252))
        for _ in range(min(n, 24) - 8)]
    pts = [pts[i % len(pts)] for i in range(n)]
    sc = [rng.randrange(1 << 128) for _ in range(n)]
    sc[:3] = [0, 1, (1 << 128) - 1]
    return sc, pts


def _adversarial_digits(window_bits, b, n, seed):
    """(b, nwin, n) int8: runs of the most negative digit, the most positive
    and zero, then uniform digits of the radix."""
    half = 1 << (window_bits - 1)
    d = np.random.default_rng(seed).integers(
        -half, half, size=(b, msm.nwindows(window_bits), n)).astype(np.int8)
    q = n // 8
    d[:, :, :q] = -half
    d[:, :, q:2 * q] = half - 1
    d[:, :, 2 * q:3 * q] = 0
    return d


@pytest.fixture(scope="module")
def points():
    """(B, 4, NLIMBS, N) int16 extended points: torsion and random."""
    _, pts = _terms(B * N, 21)
    ext = limbs.pack_point_batch(pts).astype(np.int16)
    return torch.from_numpy(np.ascontiguousarray(
        ext.reshape(4, limbs.NLIMBS, B, N).transpose(2, 0, 1, 3)))


def _assert_points_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for idx in np.ndindex(got.shape[:-3] + got.shape[-1:]):
        g = got[idx[:-1] + (Ellipsis, idx[-1])]
        w = want[idx[:-1] + (Ellipsis, idx[-1])]
        assert limbs.unpack_point(g) == limbs.unpack_point(w), idx


# -- radix 32 against the JAX package --------------------------------------

@pytest.mark.parametrize("window_bits", [4, 5])
def test_digit_planes_match_reference(window_bits):
    sc, pts = _terms(64, 1)
    sc[3] = 1 << 127
    nwin = msm.nwindows(window_bits)
    got = limbs.pack_scalar_windows(sc, nwin, window_bits)
    want = jlimbs.pack_scalar_windows(sc, nwin, window_bits)
    assert got.dtype == want.dtype == np.int8
    assert got.tobytes() == want.tobytes()
    half = 1 << (window_bits - 1)
    assert got.min() >= -half and got.max() <= half - 1
    d, e = msm.pack_msm_operands(sc, pts, n_lanes=128,
                                 window_bits=window_bits)
    jd, je = jmsm.pack_msm_operands(sc, pts, n_lanes=128,
                                    window_bits=window_bits)
    assert d.tobytes() == jd.tobytes() and e.tobytes() == je.tobytes()
    assert limbs.windows_for_bits(window_bits) == \
        jlimbs.windows_for_bits(window_bits) == nwin


def test_17_entry_tables_match_reference_bytes():
    _, pts = _terms(128, 2)
    ext = limbs.pack_point_batch(pts).astype(np.int16)[None]
    got = msm.build_tables_plain(torch.from_numpy(ext), window_bits=5)
    want = np.asarray(jmsm.build_multiples_tables(ext, window_bits=5))
    assert got.shape == (1, 17, 4, limbs.NLIMBS, 128)
    assert got.numpy().tobytes() == want.tobytes()
    assert torch.equal(msm.multiples_tables(torch.from_numpy(ext), 5), got)


@pytest.mark.parametrize("tables_in", [False, True])
def test_radix32_window_sums_match_reference_and_host(tables_in):
    """K2 (K2t) at radix 32 + K3: every window equal to the JAX XLA
    kernel's as a point, and the Horner combine at 5 doublings a window
    equal to the exact host MSM, torsion points and edge scalars
    included."""
    sc, pts = _terms(128, 3)
    digits, ext = msm.pack_msm_operands(sc, pts, n_lanes=128,
                                        window_bits=5)
    assert digits.shape == (limbs.NWINDOWS_R32, 128)
    if tables_in:
        tables = msm.build_tables_plain(torch.from_numpy(ext[None]), 5)
        got = msm.window_sums_many_tables_full(digits[None], tables,
                                               window_bits=5, device="cpu")
        want = jmsm._compiled_kernel(128, 27, window_bits=5, tables_in=True)(
            digits, tables[0].numpy())
    else:
        got = msm.window_sums_many(digits[None], ext[None], window_bits=5,
                                   device="cpu")
        want = jmsm._compiled_kernel(128, 27, window_bits=5)(digits, ext)
    assert got.shape == (1, 4, limbs.NLIMBS, 27)
    _assert_points_equal(got.numpy()[0], np.asarray(want))
    assert msm.combine_window_sums(got.numpy(), window_bits=5) == \
        edwards.multiscalar_mul(sc, pts)


# -- every form against the default, on the same operands ------------------

FORMS = {
    "int16-fold": {"fold_dtype": "int16"},
    "int32-table": {"tbl_dtype": "int32"},
    "w11": {"win_chunk": 11},
    "w3": {"win_chunk": 3},
    "w1": {"win_chunk": 1},
    "hybrid": {"body": "hybrid"},
    "hybrid-w3": {"body": "hybrid", "win_chunk": 3},
}


@pytest.fixture(scope="module")
def default_partials(points):
    """(digits, the 20-limb default's partials, the default K2's folded window
    sums)."""
    d = torch.from_numpy(_adversarial_digits(4, B, N, 5))
    return (d, msm.window_partials(d, points, arith="l20"),
            msm.fold_partials(msm.window_partials(d, points)))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_form_equals_default_limb_for_limb(form, points, default_partials):
    """Every variant form equals the default of its design, the 20-limb K2
    (arith="l20"), limb for limb; the default K2 of
    csrc/window_sums_u32.cuh sums in another order, so against it the
    folded window sums are equal as group elements."""
    d, want, default = default_partials
    got = msm.window_partials(d, points, **FORMS[form])
    assert got.dtype == (torch.int16 if form == "int16-fold"
                         else torch.int32)
    assert torch.equal(got.int(), want)
    assert torch.equal(msm.fold_partials(got),
                       msm.fold_partials(want))
    _assert_points_equal(msm.fold_partials(got).numpy(), default.numpy())


def test_32_lane_form_equals_default_as_points(points, default_partials):
    d, want, _ = default_partials
    got = msm.window_partials(d, points, tbl_dtype="int32", chunk=32)
    assert got.shape[1] == 2 * want.shape[1] - 1  # 7 chunks of 32 for 200
    _assert_points_equal(msm.fold_partials(got).numpy(),
                         msm.fold_partials(want).numpy())


@pytest.mark.parametrize("window_bits", [4, 5])
def test_tables_forms_equal_cold_forms_as_points(window_bits, points):
    """K2t on K4's tables (TH = 1 and TH = B, the head boundary inside a
    chunk; windows per block 11 at radix 16) against K2 on the points, as
    group elements, and the radix-32 K2 with an int32 table (32 lanes) as
    well."""
    d = torch.from_numpy(_adversarial_digits(window_bits, B, N, 6))
    shared = points.clone()
    shared[1:, ..., :130] = points[:1, ..., :130]  # one head for every batch
    tbl = msm.multiples_tables(shared, window_bits)
    W = 11 if window_bits == 4 else 27
    for head in (tbl[:1, ..., :130], tbl[..., :130]):
        got = msm.fold_partials(msm.window_partials_tables(
            d, head.contiguous(), tbl[..., 130:].contiguous(),
            window_bits=window_bits, win_chunk=W))
        want = msm.fold_partials(msm.window_partials(
            d, shared, window_bits=window_bits))
        _assert_points_equal(got.numpy(), want.numpy())
    if window_bits == 5:
        want = msm.fold_partials(msm.window_partials(d, points,
                                                     window_bits=5))
        got = msm.fold_partials(msm.window_partials(
            d, points, window_bits=5, tbl_dtype="int32"))
        _assert_points_equal(got.numpy(), want.numpy())


def test_limbs_stay_inside_the_int16_bound(points):
    """|limb| ≤ 8191 for every complete addition's output, the bound the
    int16 table, the int16 partials and the int16 exchange rely on
    (pallas_msm.py:189-193): on limbs drawn anywhere inside the bound, and
    on the partials of both radixes over adversarial digits and the
    torsion points — where the int16-fold form also equals the int32 one
    (a wrapped limb would differ)."""
    g = np.random.default_rng(8)
    p, q = (torch.from_numpy(g.integers(-8191, 8192, size=(
        4, limbs.NLIMBS, 4096)).astype(np.int32)) for _ in range(2))
    p[..., :64] = 8191
    q[..., 64:128] = -8191
    assert int(TE.point_add(p, q).abs().max()) <= 8191
    for wb in (4, 5):
        d = torch.from_numpy(_adversarial_digits(wb, B, N, 9))
        part = msm.window_partials(d, points, window_bits=wb,
                                   arith="l20")
        assert int(part.abs().max()) <= 8191
        assert int(msm.multiples_tables(points, wb).abs().max()) <= 8191
        if wb == 4:
            assert torch.equal(msm.window_partials(
                d, points, fold_dtype="int16").int(), part)


def test_select_only_is_the_xor_of_the_selected_entries(points):
    """K2s: for window w and chunk half h, the limb-wise XOR over the
    half's 32 lanes of sign(d)·T[|d|] (the identity past lane N), computed
    here from the tables with numpy."""
    d = _adversarial_digits(4, B, N, 10)
    tbl = msm.multiples_tables(points)
    head, r = tbl[:1, ..., :130].contiguous(), tbl[..., 130:].contiguous()
    got = msm.select_only(torch.from_numpy(d), head, r).numpy()
    t = tbl.numpy().astype(np.int32)
    t[:, :, :, :, :130] = t[:1, :, :, :, :130]  # TH = 1: batch 0's head
    nchunk = -(-N // 64)
    ident = np.zeros(80, dtype=np.int32)
    ident[20] = ident[40] = 1
    want = np.zeros((B, nchunk, 33, 2, 80), dtype=np.int32)
    for b in range(B):
        for w in range(33):
            for n in range(nchunk * 64):
                if n < N:
                    dv = int(d[b, w, n])
                    e = t[b, abs(dv), :, :, n].reshape(80).copy()
                    if dv < 0:
                        e[:20] *= -1
                        e[60:] *= -1
                else:
                    e = ident
                want[b, n // 64, w, (n % 64) // 32] ^= e
    assert got.shape == want.shape and (got == want).all()


# -- the micro-probes ------------------------------------------------------

@pytest.mark.parametrize("n_steps", [64, 512])
@pytest.mark.parametrize("op", probes.CHAIN_OPS)
def test_probe_chains_match_jnp(op, n_steps):
    """The plain chains equal JAX's, evaluated with jnp outside any
    kernel (int32 wraparound and the arithmetic shift included)."""
    import jax.numpy as jnp

    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) % 97
    a = jnp.asarray(x)
    b = a + 1
    for _ in range(n_steps):
        if op == "add":
            a, b = b, a + b
        elif op == "mul":
            a, b = b, a * b
        elif op == "shift":
            a, b = b, (a + 4096) >> 13
        else:
            a, b = b, a * 3 + b
    got = probes.chain(torch.from_numpy(x), op, n_steps)
    assert (got.numpy() == np.asarray(b)).all()


def test_fmul_chain_matches_reference_limb_for_limb():
    """The plain fmul chain (torch_field.mul, the kernels' fe_mul) equals
    the JAX package's pallas_msm._fmul_a chain mod p and limb for limb:
    both take the same 41 columns, two unfolded wide carries, the 608 and
    608² folds and five carries."""
    import jax.numpy as jnp

    from ed25519_consensus_tpu.ops.pallas_msm import _fmul_a

    x = np.arange(20 * 8 * 128, dtype=np.int32).reshape(20, 8, 128) % 1000
    a = jnp.asarray(x)
    b = a + 1
    for _ in range(8):
        a, b = b, _fmul_a(a, b)
    want = np.asarray(b)
    got = probes.fmul_chain(torch.from_numpy(x), 8).numpy()
    assert (got == want).all()
    for i in (0, 517, 1023):
        assert limbs.limbs_to_int(got[:, i // 128, i % 128]) % P == \
            limbs.limbs_to_int(want[:, i // 128, i % 128]) % P


# -- the knobs and the forms that are not built ----------------------------

def test_body_knob_falls_back_to_rolled(monkeypatch):
    for raw, want in (("hybrid", "hybrid"), ("HYBRID", "hybrid"),
                      ("rolled", "rolled"), ("unrolled", "rolled"),
                      ("junk", "rolled"), ("", "rolled")):
        monkeypatch.setenv("ED25519_TPU_PALLAS_BODY", raw)
        assert msm.body_style() == want
    monkeypatch.delenv("ED25519_TPU_PALLAS_BODY")
    assert msm.body_style() == "rolled"


def test_win_chunk_knob(monkeypatch):
    """Unset: every window in one block (the port's default, not the
    TPU's 11 / 9).  A divisor is taken; a non-divisor is warned about and
    ignored; a non-integer raises ConfigError at the read."""
    assert msm.auto_win_chunk(33) == 33 and msm.auto_win_chunk(27) == 27
    monkeypatch.setenv("ED25519_TPU_WIN_CHUNK", "11")
    assert msm.auto_win_chunk(33) == 11
    with pytest.warns(UserWarning, match="ED25519_TPU_WIN_CHUNK"):
        assert msm.auto_win_chunk(27) == 27
    for raw in ("5", "0", "-3"):
        monkeypatch.setenv("ED25519_TPU_WIN_CHUNK", raw)
        with pytest.warns(UserWarning, match="divisor"):
            assert msm.auto_win_chunk(33) == 33
    monkeypatch.setenv("ED25519_TPU_WIN_CHUNK", "eleven")
    with pytest.raises(ConfigError, match="ED25519_TPU_WIN_CHUNK"):
        msm.auto_win_chunk(33)
    with pytest.raises(ConfigError):
        msm.dispatch_window_sums_many(
            np.zeros((1, 33, 64), np.int8),
            limbs.identity_point_batch(64)[None], device="cpu")


def test_dispatches_read_both_knobs_on_every_call(monkeypatch):
    """The cold and head-resident dispatches pass ED25519_TPU_WIN_CHUNK
    and ED25519_TPU_PALLAS_BODY to K2 on every call, the tables dispatch
    only the window chunk (its body is always rolled); unset, the
    default form runs.  The window sums do not change as group elements
    (a knob reaches the 20-limb kernels, which sum in another order)."""
    seen = []
    real = msm.window_partials
    real_t = msm.window_partials_tables

    def spy(*a, **kw):
        seen.append(("K2", kw.get("win_chunk"), kw.get("body")))
        return real(*a, **kw)

    def spy_t(*a, **kw):
        seen.append(("K2t", kw.get("win_chunk"), kw.get("body")))
        return real_t(*a, **kw)

    monkeypatch.setattr(msm, "window_partials", spy)
    monkeypatch.setattr(msm, "window_partials_tables", spy_t)
    d = _adversarial_digits(4, 1, 64, 11)
    _, pts = _terms(64, 12)
    ext = limbs.pack_point_batch(pts).astype(np.int16)[None]
    base = msm.dispatch_window_sums_many(d, ext, device="cpu")
    head = ext[0, ..., :40]
    tables = msm.build_tables_plain(torch.from_numpy(head[None]))[0]
    rwire = np.stack([limbs.identity_wire_batch(24)])
    base_t = msm.dispatch_window_sums_many_tables(d, tables, rwire,
                                                  device="cpu")
    monkeypatch.setenv("ED25519_TPU_WIN_CHUNK", "11")
    monkeypatch.setenv("ED25519_TPU_PALLAS_BODY", "hybrid")
    got = msm.dispatch_window_sums_many(d, ext, device="cpu")
    got_c = msm.dispatch_window_sums_many_cached(d, head, rwire,
                                                 device="cpu")
    got_t = msm.dispatch_window_sums_many_tables(d, tables, rwire,
                                                 device="cpu")
    assert seen == [("K2", 33, "rolled"), ("K2t", 33, None),
                    ("K2", 11, "hybrid"), ("K2", 11, "hybrid"),
                    ("K2t", 11, None)]
    _assert_points_equal(got.numpy(), base.numpy())
    _assert_points_equal(got_t.numpy(), base_t.numpy())
    _assert_points_equal(got_c.numpy(), got_t.numpy())


@pytest.mark.parametrize("kw", [
    {"window_bits": 5, "fold_dtype": "int16"},
    {"chunk": 48},
    {"win_chunk": 5},
    {"window_bits": 5, "win_chunk": 11},
    {"tbl_dtype": "int8"},
    {"window_bits": 6},
    {"body": "unrolled"},
    {"fold_dtype": "int16", "body": "hybrid"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_forms_that_are_not_built_raise(kw, points):
    """A form with no instantiation, or no fit, raises ValueError on the
    CPU as on the card: nothing falls back to another form."""
    wb = kw.get("window_bits", 4)
    d = torch.zeros((B, msm.nwindows(wb) if wb in (4, 5) else 33, N),
                    dtype=torch.int8)
    with pytest.raises(ValueError):
        msm.window_partials(d, points, **kw)


def test_shared_memory_of_the_forms():
    """The 20-limb default keeps its launch, 94,624 B a block; the default K2
    and K2t of window_sums_u32.cuh take 67,648 B (the u32 table and the
    digits: three blocks an SM).  Radix 32 with an int32 table does not
    fit at 64 lanes (~328 KB) and takes 32; the K2t forms at radix 32 fit
    (~174 KB).  Tables forms at int16 partials are not built."""
    assert msm.k2_shared_bytes(4, "int16", "int32", 64, 33) == 94_624
    assert msm.U32_SHARED_BYTES == 67_648 and 3 * (67_648 + 1_024) <= \
        233_472
    # the Python block shape is the header's (window_sums_u32.cuh)
    text = (_cuda.CSRC / "window_sums_u32.cuh").read_text(encoding="utf-8")
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}
    assert const["S"] == msm.U32_SPLIT
    assert const["S"] * const["WSTRIDE"] == msm.U32_THREADS
    assert const["NENT"] * const["CHUNK"] * 128 + const["CHUNK"] * \
        const["NWIN"] == msm.U32_SHARED_BYTES
    assert msm.kernel_form("window_sums", arith="l20") == (
        "window_sums-l20", "", 64, 33)
    assert msm.k2_shared_bytes(5, "int32", "int32", 64, 27) > \
        msm.MAX_SHARED_BYTES
    assert msm.kernel_form("window_sums", 5, "int32") == (
        "window_sums-r32-i32tbl-c32", "", 32, 27)
    assert msm.k2_shared_bytes(5, "int16", "int32", 64, 27) == 174_272
    assert msm.kernel_form("window_sums_tables", 5) == (
        "window_sums_tables-r32", "", 64, 27)
    with pytest.raises(ValueError, match="windows a block"):
        msm.kernel_form("window_sums_tables", 5, win_chunk=9)
    assert msm.kernel_form("window_sums", 4, win_chunk=33) == (
        "window_sums", "", 64, 33)
    with pytest.raises(ValueError, match="no kernel is built"):
        msm.kernel_form("window_sums_tables", 4, fold_dtype="int16")
    with pytest.raises(ValueError):
        msm.window_partials(torch.zeros((1, 17, 64), dtype=torch.uint8),
                            torch.zeros((1, 4, limbs.NLIMBS, 64),
                                        dtype=torch.int16), window_bits=5)


# -- the default K2 and K2t against the 20-limb design ------------------------

# sha256 of the 20-limb plain versions' partials (window_partials_plain and
# window_partials_tables_plain at commit b90f4b6, when they were the
# default) on `_l20_operands()`.
L20_SHA256 = {
    "k2": "30f7d5e189eb27b297fced7d13d8157e7f650ecfb617c6192ef0a8b69b7f5575",
    "k2t": "511555da57a714a7f7f1fa563fd3817f3bc9a7039fe26a0fa60a53b5d3ecf160",
}


def _l20_operands():
    rng = random.Random(0x4C20)
    pts = edwards.eight_torsion() + [
        edwards.BASEPOINT.scalar_mul(rng.randrange(1, 2**252))
        for _ in range(24)]
    pts = [pts[i % len(pts)] for i in range(B * N)]
    ext = limbs.pack_point_batch(pts).astype(np.int16)
    ext = np.ascontiguousarray(
        ext.reshape(4, limbs.NLIMBS, B, N).transpose(2, 0, 1, 3))
    d = np.random.default_rng(0x4C20).integers(
        -8, 8, size=(B, 33, N)).astype(np.int8)
    d[:, :, :25] = -8
    d[:, :, 25:50] = 7
    d[:, :, 50:75] = 0
    return torch.from_numpy(d), torch.from_numpy(ext)


def test_l20_plain_forms_equal_their_earlier_outputs():
    """The 20-limb default K2 and K2t (arith="l20") still give their earlier
    partials byte for byte, and the default K2 and K2t give the same
    window sums as group elements."""
    d, e = _l20_operands()
    tb = msm.build_tables_plain(e, arith="l20")
    head, r = tb[:1, ..., :130].contiguous(), tb[..., 130:].contiguous()
    k2 = msm.window_partials(d, e, arith="l20")
    k2t = msm.window_partials_tables(d, head, r, arith="l20")
    for name, t in (("k2", k2), ("k2t", k2t)):
        assert hashlib.sha256(t.numpy().tobytes()).hexdigest() == \
            L20_SHA256[name], name
    _assert_points_equal(msm.fold_partials(msm.window_partials(d, e)),
                         msm.fold_partials(k2))
    _assert_points_equal(msm.fold_partials(
        msm.window_partials_tables(d, head, r)), msm.fold_partials(k2t))


# -- the Pallas kernel itself, in interpret mode ---------------------------

PALLAS_FORMS = [
    ("rolled-w11", 4, {"win_chunk": 11}),
    ("rolled-w33", 4, {"win_chunk": 33}),
    ("int16-fold-w11", 4, {"win_chunk": 11, "fold_dtype": "int16"}),
    ("int32-table", 4, {"tbl_dtype": "int32", "win_chunk": 33}),
    ("hybrid-w3", 4, {"body": "hybrid", "win_chunk": 3}),
    ("radix32-w9", 5, {"win_chunk": 9}),
    ("tables-w11", 4, {"tables": True, "win_chunk": 11}),
]


@pytest.mark.slow
@pytest.mark.parametrize("name,window_bits,kw", PALLAS_FORMS,
                         ids=[f[0] for f in PALLAS_FORMS])
def test_pallas_interpret_matches_port_forms(name, window_bits, kw):
    """The JAX package's Pallas kernel, run in interpret mode at a
    (8, 128) tile (one 1,024-lane block), against the port's form of the
    same axes on the same operands: window sums equal as group elements,
    and the Horner combine equal to the exact host MSM.  Each form is its
    own interpret compile (minutes on the CPU), hence the slow mark, as
    tests/test_pallas_msm.py marks its variant case."""
    from ed25519_consensus_tpu.ops import pallas_msm

    kw = dict(kw)
    sc, pts = _terms(1024, 13)
    digits, ext = msm.pack_msm_operands(sc, pts, n_lanes=1024,
                                        window_bits=window_bits)
    if kw.pop("tables", False):
        tables = msm.build_tables_plain(torch.from_numpy(ext[None]),
                                        window_bits)
        want = pallas_msm.pallas_window_sums_many_tables_full(
            digits[None], tables.numpy(), interpret=True, tile=(8, 128),
            window_bits=window_bits, **kw)
        got = msm.window_sums_many_tables_full(
            digits[None], tables, window_bits=window_bits, device="cpu",
            **kw)
    else:
        want = pallas_msm.pallas_window_sums_many(
            digits[None], ext[None], interpret=True, tile=(8, 128),
            window_bits=window_bits, **kw)
        got = msm.window_sums_many(digits[None], ext[None],
                                   window_bits=window_bits, device="cpu",
                                   **kw)
    _assert_points_equal(got.numpy(), np.asarray(want))
    assert msm.combine_window_sums(got.numpy(),
                                   window_bits=window_bits) == \
        edwards.multiscalar_mul(sc, pts)
