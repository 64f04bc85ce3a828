"""The port's CUDA kernels on the card, each against its plain PyTorch
version, at small and ragged shapes, and verify_many through resident
tables on the card.  CUDA kernels have no CPU mode, so
every test here needs an NVIDIA GPU (sm_90a) and `nvcc`; without one they
skip.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: the suite's conftest imports JAX, which the port does
not need and a GPU host may not have).  Tolerance: exact equality; K2,
K2t, K3 and K4 take the plain versions' additions in the same order (the
default K2 and K2t, csrc/window_sums_u32.cuh, those of the `split=4`
plain order with canonical limbs; the 20-limb forms their own); forms of
the two designs agree as points.  K1 and K3 on the 8 x 32-bit
arithmetic equal their plain versions (canonical limbs) and, as points,
their 20-limb forms; so do K4, K5 and K6 (and each -l20 form its own
plain version).  The self-test of the fe8 field arithmetic
(probe_fe8) equals the exact-integer model word for word."""

import random

import numpy as np
import pytest
import torch

from ed25519_consensus_tpu_torch import InvalidSignature, SigningKey, batch
from ed25519_consensus_tpu_torch.ops import _cuda, edwards, limbs, msm
from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run this file on the card)")
    return torch.device("cuda")


def _wire(n, seed):
    """(33, n) compressed wire: torsion points, then random points."""
    rng = random.Random(seed)
    encs = [p.compress() for p in edwards.eight_torsion()]
    while len(encs) < n:
        e = rng.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is not None:
            encs.append(e)
    w = np.zeros((33, n), dtype=np.uint8)
    for i, e in enumerate(encs[:n]):
        w[:32, i] = np.frombuffer(e, dtype=np.uint8)
        w[32, i] = edwards.decompress_with_hint(e)[1]
    return w


def test_expand_compressed_matches_plain(dev):
    w = np.stack([_wire(300, 1), _wire(300, 2)])
    wire = torch.from_numpy(w).to(dev)
    before = _cuda.KERNELS["expand_compressed"].launches
    got = TD.expand_compressed_points(wire)
    want = TD.expand_compressed_points_plain(wire)
    torch.cuda.synchronize()
    assert _cuda.KERNELS["expand_compressed"].launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("packed", [True, False])
def test_window_sums_and_fold_match_plain(dev, packed):
    B, N = 2, 200
    d = np.random.default_rng(3).integers(
        -8, 8, size=(B, limbs.NWINDOWS, N)).astype(np.int8)
    d[:, :, :20] = -8
    d[:, :, 20:40] = 7
    if packed:
        d = np.stack([limbs.pack_digit_planes(x) for x in d])
    digits = torch.from_numpy(d).to(dev)
    points = TD.expand_compressed_points(
        torch.from_numpy(np.stack([_wire(N, 4), _wire(N, 5)])).to(dev))
    parts = msm.window_partials(digits, points)
    want_parts = msm.window_partials_plain(digits, points)
    assert torch.equal(parts, want_parts)
    assert torch.equal(msm.fold_partials(parts),
                       msm.fold_partials_plain(want_parts))


def test_verify_gpu_accepts_and_rejects(dev):
    rng = random.Random(6)
    keys = [SigningKey.new(rng) for _ in range(5)]
    entries = []
    for i in range(150):
        m = b"card-%d" % i
        entries.append((keys[i % 5].verification_key_bytes(),
                        keys[i % 5].sign(m), m))
    _cuda.reset_launch_counts()
    good = batch.Verifier()
    good.queue_bulk(entries)
    good.verify_gpu(rng=random.Random(7))
    counts = _cuda.launch_counts()
    assert [counts[k] for k in ("expand_compressed", "window_sums",
                                "fold_partials")] == [1, 1, 1]
    assert counts["window_sums_tables"] == counts["build_tables"] == 0
    entries[9] = (entries[9][0], entries[9][1], b"altered")
    bad = batch.Verifier()
    bad.queue_bulk(entries)
    with pytest.raises(InvalidSignature):
        bad.verify_gpu(rng=random.Random(8))


def test_mixed_devices_raise(dev):
    digits = torch.zeros((1, limbs.PACKED_WINDOWS, 64), dtype=torch.uint8)
    points = torch.zeros((1, 4, limbs.NLIMBS, 64), dtype=torch.int16,
                         device=dev)
    with pytest.raises(ValueError):
        msm.window_partials(digits, points)


@pytest.mark.parametrize("head_batched", [False, True])
def test_build_tables_and_window_sums_tables_match_plain(dev, head_batched):
    B, N, n_head = 2, 200, 70
    points = TD.expand_compressed_points(
        torch.from_numpy(np.stack([_wire(N, 8), _wire(N, 9)])).to(dev))
    tables = msm.multiples_tables(points)
    assert torch.equal(tables, msm.build_tables_plain(points))
    d = np.random.default_rng(10).integers(
        -8, 8, size=(B, limbs.NWINDOWS, N)).astype(np.int8)
    digits = torch.from_numpy(
        np.stack([limbs.pack_digit_planes(x) for x in d])).to(dev)
    head = tables[..., :n_head] if head_batched else tables[:1, ..., :n_head]
    head, r = head.contiguous(), tables[..., n_head:].contiguous()
    got = msm.window_partials_tables(digits, head, r)
    assert torch.equal(got, msm.window_partials_tables_plain(digits, head,
                                                             r))
    full = msm.window_partials_tables(digits, tables)
    assert torch.equal(msm.window_partials_tables_plain(digits, tables),
                       full)


def test_verify_many_from_resident_tables(dev):
    from ed25519_consensus_tpu_torch import devcache

    rng = random.Random(11)
    keys = [SigningKey.new(rng) for _ in range(6)]
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
    try:
        for rep in range(3):
            vs = []
            for b in range(2):
                v = batch.Verifier()
                v.queue_bulk([(sk.verification_key_bytes(),
                               sk.sign(b"%d-%d-%d" % (rep, b, i)),
                               b"%d-%d-%d" % (rep, b, i)
                               if (rep, b, i) != (2, 1, 0) else b"x")
                              for i, sk in enumerate(keys)])
                vs.append(v)
            got = batch.verify_many(vs, rng=rng, chunk=2, hybrid=False,
                                    merge="never")
            assert got == [True, rep != 2]
        assert batch.last_run_stats["devcache"]["table_dispatch_hits"] == 1
    finally:
        devcache.set_default_cache(None)
        batch._DeviceLane.reset_all()


@pytest.mark.parametrize("n_shards", [1, 3, 32])
def test_fold_shards_matches_plain(dev, n_shards):
    """K5 on per-shard window sums of real points and digits (B = 2), as a
    sequence of shard tensors and as one stacked tensor; the lab's
    fold_shards-l20 against its own plain version."""
    B, N = 2, 128
    parts = []
    for k in range(n_shards):
        d = np.random.default_rng(20 + k).integers(
            -8, 8, size=(B, limbs.NWINDOWS, N)).astype(np.int8)
        w = np.stack([_wire(N, 30 + k), _wire(N, 40 + k)])
        parts.append(msm.dispatch_window_sums_many(d, w, dev))
    gathered = torch.stack(parts)
    want = msm.fold_shards_plain(gathered)
    for shards in (parts, gathered):
        before = _cuda.KERNELS["fold_shards"].launches
        got = msm.fold_shards(shards)
        torch.cuda.synchronize()
        assert _cuda.KERNELS["fold_shards"].launches == before + 1
        assert torch.equal(got, want)
    before = _cuda.KERNELS["fold_shards-l20"].launches
    got = msm.fold_shards(gathered, arith="l20")
    torch.cuda.synchronize()
    assert _cuda.KERNELS["fold_shards-l20"].launches == before + 1
    assert torch.equal(got, msm.fold_shards_plain(gathered, arith="l20"))


@pytest.mark.parametrize("n", [300, 200])
def test_expand_affine_matches_plain(dev, n):
    """K6 and the lab's expand_affine-l20 on decompressed points and on
    limbs at the bound |limb| = 8191: N = 300 moves one int16 a thread
    (rows not 16-byte aligned) with a ragged last tile, N = 200 16 bytes a
    thread with a ragged last tile."""
    pts = TD.expand_compressed_points(
        torch.from_numpy(np.stack([_wire(n, 50)])).to(dev))[:, :2]
    ext = torch.from_numpy(np.random.default_rng(51).choice(
        np.array([-8191, 8191, -1, 0, 1], dtype=np.int16),
        size=(1, 2, limbs.NLIMBS, n))).to(dev)
    for aff in (pts.contiguous(), ext):
        for arith, name in (("u32", "expand_affine"),
                            ("l20", "expand_affine-l20")):
            before = _cuda.KERNELS[name].launches
            got = msm.expand_affine_points(aff, arith=arith)
            want = msm.expand_affine_points_plain(aff, arith=arith)
            torch.cuda.synchronize()
            assert _cuda.KERNELS[name].launches == before + 1
            assert torch.equal(got, want)


def test_virtual_mesh_on_the_card(dev):
    """A 2-shard mesh with both shards on the card: the window sums equal
    the single lane's as points, and verify_many(mesh=2) decides on it."""
    from ed25519_consensus_tpu_torch.parallel import sharded_msm

    rng = random.Random(52)
    keys = [SigningKey.new(rng) for _ in range(4)]
    entries = [(keys[i % 4].verification_key_bytes(),
                keys[i % 4].sign(b"mesh-%d" % i), b"mesh-%d" % i)
               for i in range(90)]
    v = batch.Verifier()
    v.queue_bulk(entries)
    staged = v._stage(random.Random(53))
    N = sharded_msm.shard_pad(staged.n_device_terms, 2)
    d, w = staged.device_operands(lambda n: N)
    mesh_ws = sharded_msm.sharded_window_sums_many(
        d[None], w[None], 2, devices=[dev, dev]).cpu().numpy()
    one_ws = msm.dispatch_window_sums_many(d[None], w[None],
                                           dev).cpu().numpy()
    assert msm.combine_window_sums(mesh_ws) == \
        msm.combine_window_sums(one_ws)
    vs = []
    for b in range(3):
        vb = batch.Verifier()
        vb.queue_bulk(entries[30 * b:30 * (b + 1)])
        vs.append(vb)
    try:
        assert batch.verify_many(vs, rng=rng, chunk=2, hybrid=False,
                                 merge="never", mesh=2, device=dev,
                                 sentinel_rate=1.0) == [True] * 3
        st = batch.last_run_stats
        assert st["mesh"] == 2 and st["sentinel"]["divergence"] == 0
        assert st["sentinel"]["audits"] >= 1
    finally:
        batch._DeviceLane.reset_all()


# -- the kernel lab's forms (slice 3) ---------------------------------------

def _digits(window_bits, B, N, seed):
    half = 1 << (window_bits - 1)
    d = np.random.default_rng(seed).integers(
        -half, half, size=(B, msm.nwindows(window_bits), N)).astype(np.int8)
    d[:, :, :20] = -half
    d[:, :, 20:40] = half - 1
    return d


K2_FORMS = [
    (4, {}), (4, {"arith": "l20"}),
    (4, {"win_chunk": 11}), (4, {"win_chunk": 3}), (4, {"win_chunk": 1}),
    (4, {"fold_dtype": "int16", "win_chunk": 11}),
    (4, {"tbl_dtype": "int32"}), (4, {"tbl_dtype": "int32", "chunk": 32}),
    (4, {"body": "hybrid"}), (4, {"body": "hybrid", "win_chunk": 3}),
    (5, {}), (5, {"win_chunk": 9}), (5, {"tbl_dtype": "int32"}),
]


@pytest.mark.parametrize("window_bits,kw", K2_FORMS,
                         ids=[f"r{1 << wb}-" + "-".join(
                             f"{k}={v}" for k, v in kw.items())
                             for wb, kw in K2_FORMS])
def test_window_sum_forms_match_plain(dev, window_bits, kw):
    """Every K2 instantiation and several windows per block, at a ragged
    shape, against its plain version (exact), and K3 of the form's
    partials; the launch is counted under the form's own name."""
    B, N = 2, 200
    d = torch.from_numpy(_digits(window_bits, B, N, 60)).to(dev)
    pts = TD.expand_compressed_points(
        torch.from_numpy(np.stack([_wire(N, 61), _wire(N, 62)])).to(dev))
    base, suffix, chunk, _ = msm.kernel_form(
        "window_sums", window_bits, kw.get("tbl_dtype", "int16"),
        kw.get("fold_dtype", "int32"), kw.get("body", "rolled"),
        kw.get("chunk", 64), kw.get("win_chunk"), kw.get("arith", "u32"))
    k = _cuda.kernel(base, suffix)
    before = k.launches
    got = msm.window_partials(d, pts, window_bits=window_bits, **kw)
    want = msm.window_partials_plain(
        d, pts, window_bits=window_bits, chunk=chunk,
        **{n: v for n, v in kw.items() if n != "chunk"})
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(msm.fold_partials(got), msm.fold_partials_plain(want))


@pytest.mark.parametrize("window_bits", [4, 5])
def test_tables_forms_and_select_only_match_plain(dev, window_bits):
    """K4 at 9 and 17 entries, K2t at both radixes (the default and the
    20-limb form at W = 11 at radix 16, the head boundary inside a chunk) and
    K2s against their plain versions."""
    B, N, n_head = 2, 200, 70
    pts = TD.expand_compressed_points(
        torch.from_numpy(np.stack([_wire(N, 63), _wire(N, 64)])).to(dev))
    tables = msm.multiples_tables(pts, window_bits)
    assert torch.equal(tables, msm.build_tables_plain(pts, window_bits))
    d = torch.from_numpy(_digits(window_bits, B, N, 65)).to(dev)
    head = tables[..., :n_head].contiguous()
    r = tables[..., n_head:].contiguous()
    for W in ((None, 11) if window_bits == 4 else (None,)):
        got = msm.window_partials_tables(d, head, r, window_bits=window_bits,
                                         win_chunk=W)
        assert torch.equal(got, msm.window_partials_tables_plain(
            d, head, r, window_bits=window_bits, win_chunk=W))
    if window_bits == 4:
        assert torch.equal(msm.select_only(d, tables[:1]),
                           msm.select_only_plain(d, tables[:1]))


def test_probes_match_plain(dev):
    from ed25519_consensus_tpu_torch.ops import probes

    x = torch.from_numpy(np.arange(8 * 128, dtype=np.int32)
                         .reshape(8, 128) % 97).to(dev)
    for op in probes.CHAIN_OPS:
        assert torch.equal(probes.chain(x, op, 64),
                           probes.chain_plain(x, op, 64))
    xf = torch.from_numpy(np.arange(20 * 8 * 128, dtype=np.int32)
                          .reshape(20, 8, 128) % 1000).to(dev)
    assert torch.equal(probes.fmul_chain(xf, 3),
                       probes.fmul_chain_plain(xf, 3))
    xs = torch.from_numpy(probes.fe8_operands(n_random=16))
    assert torch.equal(probes.fe8_selftest(xs.to(dev)).cpu(),
                       probes.fe8_selftest_plain(xs))
    from ed25519_consensus_tpu_torch.tools import microbench

    xg = torch.from_numpy(microbench.ge8_tile(2, 40))
    assert torch.equal(probes.ge8_chain(xg.to(dev), 5).cpu(),
                       probes.ge8_chain_plain(xg, 5))


def _canonical_points(pts):
    """(B, 4, 20, N) limbs → their canonical limbs (equal as points when Z
    is 1 in both)."""
    from ed25519_consensus_tpu_torch.ops import torch_field as TF

    return TF.canonical_limbs20(pts.int().movedim(2, 0)).movedim(0, 2)


def test_expand_compressed_new_and_l20_on_every_encoding(dev):
    """The fe8 K1 and the 20-limb K1 (expand_compressed-l20) against their
    plain versions on the ZIP215 matrix encodings under every hint value,
    the non-canonical encodings, random points and a ragged lane count;
    the two kernels equal as points (canonical limbs, Z = 1)."""
    from ed25519_consensus_tpu_torch.utils import fixtures

    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()
    lanes = [(e, h) for e in encs for h in range(4)]
    w = _wire(301, 71)
    for j, (e, h) in enumerate(lanes):
        w[:32, j] = np.frombuffer(e, dtype=np.uint8)
        w[32, j] = h
    wire = torch.from_numpy(np.stack([w, _wire(301, 72)])).to(dev)
    new = TD.expand_compressed_points(wire)
    old = TD.expand_compressed_points(wire, arith="l20")
    assert torch.equal(new, TD.expand_compressed_points_plain(wire))
    assert torch.equal(old, TD.expand_compressed_points_plain(wire,
                                                               arith="l20"))
    assert torch.equal(_canonical_points(old), new.int())


@pytest.mark.parametrize("nchunk", [0, 1, 2, 31, 33, 129, 159, 192])
def test_fold_partials_new_and_l20(dev, nchunk):
    """K3 on the fe8 arithmetic (128 threads, warp trees) and the 20-limb
    K3 (fold_partials-l20) against their plain versions at chunk counts
    around the warp and round boundaries, on K2's partials (canonical) and
    on 20-limb partials; the int16 and 27-window forms too; new and old
    equal as points.  A partials tensor whose storage is not 16-byte
    aligned is copied before the 16-byte loads."""
    rng = np.random.default_rng(nchunk)
    pts = TD.expand_compressed_points(
        torch.from_numpy(_wire(64, 73)[None]).to(dev), arith="l20")
    pts = pts.int()[0].permute(2, 0, 1)  # (64, 4, 20) 20-limb points
    idx = torch.from_numpy(rng.integers(0, 64, size=(2, nchunk, 33))).to(dev)
    parts = pts[idx].contiguous()  # (2, nchunk, 33, 4, 20)
    for p in (parts, parts.to(torch.int16), parts[:, :, :27].contiguous()):
        assert torch.equal(msm.fold_partials(p), msm.fold_partials_plain(p))
    new = msm.fold_partials(parts)
    old = msm.fold_partials(parts, arith="l20")
    assert torch.equal(old, msm.fold_partials_plain(parts, arith="l20"))
    n, o = new.cpu().numpy(), old.cpu().numpy()
    assert all(limbs.unpack_point(n[b, ..., w]) ==
               limbs.unpack_point(o[b, ..., w])
               for b in range(2) for w in range(33))
    flat = torch.empty(parts.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(parts.shape)
    shifted.copy_(parts)
    assert torch.equal(msm.fold_partials(shifted), new)


@pytest.mark.parametrize("N", [1, 31, 33, 63, 65, 333])
def test_build_tables_new_and_l20_at_the_limits(dev, N):
    """The fe8 K4 (build_tables) and the 20-limb K4 (build_tables-l20)
    against their plain versions at one lane and odd lane counts around a
    block of 64 lanes, on K1's output and on points whose limbs sit at
    |limb| = 8191; the new tables are canonical and equal the old ones as
    points, entry by entry; each launch counted under its own name."""
    from ed25519_consensus_tpu_torch.ops import probes

    pts = [TD.expand_compressed_points(torch.from_numpy(
        np.stack([_wire(N, 80), _wire(N, 81)])).to(dev)),
        torch.from_numpy(np.stack([probes.extreme_points(N, s)
                                   for s in (3, 4)])).to(dev)]
    for p in pts:
        before = _cuda.launch_counts()
        new = msm.multiples_tables(p)
        old = msm.multiples_tables(p, arith="l20")
        torch.cuda.synchronize()
        after = _cuda.launch_counts()
        assert after["build_tables"] == before["build_tables"] + 1
        assert after["build_tables-l20"] == before["build_tables-l20"] + 1
        assert torch.equal(new, msm.build_tables_plain(p))
        assert torch.equal(old, msm.build_tables_plain(p, arith="l20"))
        n, o = new.cpu().numpy(), old.cpu().numpy()
        assert all(limbs.unpack_point(n[b, k, ..., j]) ==
                   limbs.unpack_point(o[b, k, ..., j])
                   for b in range(2) for k in range(msm.NTABLE)
                   for j in range(N))


def test_tables_dispatch_launches_the_fe8_k4(dev):
    """The resident-tables dispatch builds the R lanes' tables with the fe8
    K4, never the 20-limb one."""
    B, N, n_head = 2, 200, 70
    pts = TD.expand_compressed_points(
        torch.from_numpy(np.stack([_wire(N, 82), _wire(N, 83)])).to(dev))
    head = msm.multiples_tables(pts[:1, ..., :n_head].contiguous())[0]
    rwire = torch.from_numpy(np.stack([_wire(N - n_head, 84),
                                       _wire(N - n_head, 85)])).to(dev)
    d = torch.from_numpy(_digits(4, B, N, 86)).to(dev)
    _cuda.reset_launch_counts()
    msm.dispatch_window_sums_many_tables(d, head, rwire, dev)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    assert counts["build_tables"] == 1 and counts["build_tables-l20"] == 0


@pytest.mark.parametrize("env,name", [
    ({"ED25519_TPU_WIN_CHUNK": "11"}, "window_sums-l20-w11"),
    ({"ED25519_TPU_PALLAS_BODY": "hybrid"}, "window_sums-hybrid"),
    ({"ED25519_TPU_PALLAS_BODY": "unrolled"}, "window_sums"),
])
def test_knobs_drive_the_main_path(dev, monkeypatch, env, name):
    """The stacked dispatch runs the instantiation the knobs name, with the
    default's window sums as points (the 20-limb forms sum in another
    order)."""
    B, N = 2, 128
    d = _digits(4, B, N, 66)
    w = np.stack([_wire(N, 67), _wire(N, 68)])
    want = msm.dispatch_window_sums_many(d, w, dev)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    before = _cuda.launch_counts()
    got = msm.dispatch_window_sums_many(d, w, dev)
    torch.cuda.synchronize()
    after = _cuda.launch_counts()
    assert after[name] == before.get(name, 0) + 1
    assert name == "window_sums" or \
        after["window_sums"] == before["window_sums"]
    g, w_ = got.cpu().numpy(), want.cpu().numpy()
    assert all(limbs.unpack_point(g[b, ..., i]) ==
               limbs.unpack_point(w_[b, ..., i])
               for b in range(B) for i in range(limbs.NWINDOWS))


def test_single_form_entries_refuse_other_windows(dev):
    """An instantiation that holds only its every-window kernel refuses
    fewer windows a block at its C entry as well (cudaErrorInvalidValue,
    launching nothing), and the int16-fold form, which holds only its
    any-W kernel, runs every window in one block equal to its plain
    version."""
    B, N = 1, 128
    d = torch.from_numpy(_digits(4, B, N, 69)).to(dev)
    pts = TD.expand_compressed_points(
        torch.from_numpy(_wire(N, 70)[None]).to(dev))
    out = torch.empty((B, 2, 33, 4, limbs.NLIMBS), dtype=torch.int32,
                      device=dev)
    for name in ("window_sums-i32tbl", "window_sums"):
        k = _cuda.KERNELS[name]
        before = k.launches
        with pytest.raises(_cuda.CudaError) as err:
            k.launch(pts.device, d.data_ptr(), 0, pts.data_ptr(),
                     out.data_ptr(), B, N, 11)
        assert err.value.cuda_error == 1 and k.launches == before
    got = msm.window_partials(d, pts, fold_dtype="int16")
    assert torch.equal(got, msm.window_partials_plain(d, pts,
                                                      fold_dtype="int16"))


def test_unbuilt_forms_raise_on_the_card(dev):
    d = torch.zeros((1, 27, 64), dtype=torch.int8, device=dev)
    pts = torch.zeros((1, 4, limbs.NLIMBS, 64), dtype=torch.int16,
                      device=dev)
    with pytest.raises(ValueError, match="no kernel is built"):
        msm.window_partials(d, pts, window_bits=5, fold_dtype="int16")
    with pytest.raises(ValueError, match="divisor"):
        msm.window_partials(d, pts, window_bits=5, win_chunk=11)
