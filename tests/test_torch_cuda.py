"""The port's CUDA kernels on the card, each against its plain PyTorch
version, at small and ragged shapes, and verify_many through resident
tables on the card.  CUDA kernels have no CPU mode, so
every test here needs an NVIDIA GPU (sm_90a) and `nvcc`; without one they
skip.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: the suite's conftest imports JAX, which the port does
not need and a GPU host may not have).  Tolerance: exact equality; K2,
K2t, K3 and K4 take the plain versions' additions in the same order."""

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


@pytest.mark.parametrize("n_shards", [1, 3])
def test_fold_shards_matches_plain(dev, n_shards):
    """K5 on per-shard window sums of real points and digits (B = 2)."""
    B, N = 2, 128
    parts = []
    for k in range(n_shards):
        d = np.random.default_rng(20 + k).integers(
            -8, 8, size=(B, limbs.NWINDOWS, N)).astype(np.int8)
        w = np.stack([_wire(N, 30 + k), _wire(N, 40 + k)])
        parts.append(msm.dispatch_window_sums_many(d, w, dev))
    gathered = torch.stack(parts)
    before = _cuda.KERNELS["fold_shards"].launches
    got = msm.fold_shards(gathered)
    want = msm.fold_shards_plain(gathered)
    torch.cuda.synchronize()
    assert _cuda.KERNELS["fold_shards"].launches == before + 1
    assert torch.equal(got, want)


def test_expand_affine_matches_plain(dev):
    """K6 on decompressed points and on limbs at the bound |limb| = 8191."""
    pts = TD.expand_compressed_points(
        torch.from_numpy(np.stack([_wire(300, 50)])).to(dev))[:, :2]
    ext = torch.from_numpy(np.random.default_rng(51).choice(
        np.array([-8191, 8191, -1, 0, 1], dtype=np.int16),
        size=(1, 2, limbs.NLIMBS, 300))).to(dev)
    for aff in (pts.contiguous(), ext):
        before = _cuda.KERNELS["expand_affine"].launches
        got = msm.expand_affine_points(aff)
        want = msm.expand_affine_points_plain(aff)
        torch.cuda.synchronize()
        assert _cuda.KERNELS["expand_affine"].launches == before + 1
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
        kw.get("chunk", 64), kw.get("win_chunk"))
    k = _cuda.kernel(base, suffix)
    before = k.launches
    got = msm.window_partials(d, pts, window_bits=window_bits, **kw)
    want = msm.window_partials_plain(
        d, pts, window_bits=window_bits, chunk=chunk,
        **{n: v for n, v in kw.items() if n in ("tbl_dtype", "fold_dtype")})
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(msm.fold_partials(got), msm.fold_partials_plain(want))


@pytest.mark.parametrize("window_bits", [4, 5])
def test_tables_forms_and_select_only_match_plain(dev, window_bits):
    """K4 at 9 and 17 entries, K2t at both radixes (W = 11 at radix 16,
    the head boundary inside a chunk) and K2s against their plain
    versions."""
    B, N, n_head = 2, 200, 70
    pts = TD.expand_compressed_points(
        torch.from_numpy(np.stack([_wire(N, 63), _wire(N, 64)])).to(dev))
    tables = msm.multiples_tables(pts, window_bits)
    assert torch.equal(tables, msm.build_tables_plain(pts, window_bits))
    d = torch.from_numpy(_digits(window_bits, B, N, 65)).to(dev)
    head = tables[..., :n_head].contiguous()
    r = tables[..., n_head:].contiguous()
    W = 11 if window_bits == 4 else None
    got = msm.window_partials_tables(d, head, r, window_bits=window_bits,
                                     win_chunk=W)
    assert torch.equal(got, msm.window_partials_tables_plain(
        d, head, r, window_bits=window_bits))
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


@pytest.mark.parametrize("env,name", [
    ({"ED25519_TPU_WIN_CHUNK": "11"}, "window_sums-w11"),
    ({"ED25519_TPU_PALLAS_BODY": "hybrid"}, "window_sums-hybrid"),
    ({"ED25519_TPU_PALLAS_BODY": "unrolled"}, "window_sums"),
])
def test_knobs_drive_the_main_path(dev, monkeypatch, env, name):
    """The stacked dispatch runs the instantiation the knobs name, with the
    default's window sums."""
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
    assert torch.equal(got, want)


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
    k = _cuda.KERNELS["window_sums-i32tbl"]
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
