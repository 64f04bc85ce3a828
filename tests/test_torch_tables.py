"""K4, the multiples-table builder of the resident-tables dispatch, on the
CPU, where `msm.multiples_tables` runs its plain version, against the JAX
package's `msm.build_multiples_tables` on the same bytes.

* The default form (`arith="u32"`, the kernel csrc/build_tables.cu on the
  8 × 32-bit arithmetic): entry 0 the identity, entry 1 P, entries 2..8
  K2's table tree, each entry `canonical_limbs20` of the tree that
  `msm._u32_table_tree` gives, and equal to the JAX package's entry as a
  point, on K1's output for torsion, non-canonical and random points and on
  a keyset's head points (the host-built head tables as points).
* What the tree buys: K2t's plain version on these tables built for every
  lane (the full-tables form, and split into head and R tables) equals
  K2's plain version on the same points limb for limb, not only as points.
* The 20-limb form (`arith="l20"`, the lab's build_tables-l20) is the
  reference's chain byte for byte, and the radix-32 form is 20-limb
  whatever `arith` says.

The JAX side runs on the CPU (its XLA table builder).  Tolerance: exact."""

import random

import numpy as np
import pytest
import torch

from ed25519_consensus_tpu.ops import msm as jmsm
from ed25519_consensus_tpu_torch import SigningKey, batch
from ed25519_consensus_tpu_torch.ops import edwards, limbs, msm
from ed25519_consensus_tpu_torch.ops import torch_decompress as TD
from ed25519_consensus_tpu_torch.ops import torch_edwards as TE
from ed25519_consensus_tpu_torch.ops import torch_field as TF
from ed25519_consensus_tpu_torch.utils import fixtures


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (the port tests' idiom)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _expanded(n: int, seed: int):
    """(1, 4, 20, n) int16: K1's plain output on the 8 torsion points, the
    26 non-canonical encodings and random points, with the host hints."""
    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()
    r = random.Random(seed)
    while len(encs) < n:
        e = r.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is not None:
            encs.append(e)
    w = limbs.identity_wire_batch(n)
    for i, e in enumerate(encs[:n]):
        w[:32, i] = np.frombuffer(e, np.uint8)
        w[32, i] = edwards.decompress_with_hint(e)[1]
    return TD.expand_compressed_points(torch.from_numpy(w[None]))


def _head_points():
    """(1, 4, 20, 2·(m + 1)) int16 head points of a 12-key keyset and its
    host-built head tables (9, 4, 20, 2·(m + 1))."""
    rng = random.Random(0x7AB)
    keys = [SigningKey.new(rng) for _ in range(12)]
    v = batch.Verifier()
    for i, sk in enumerate(keys):
        msg = b"tables-%d" % i
        v.queue((sk.verification_key_bytes(), sk.sign(msg), msg))
    staged = v._stage(random.Random(3))
    return (torch.from_numpy(staged.head_tensor()[None]),
            staged.head_tables_tensor())


def _assert_entries_equal_as_points(got, want):
    """(9, 4, 20, n) tables equal entry by entry, lane by lane, as
    projective points."""
    assert got.shape == want.shape
    for k in range(got.shape[0]):
        for j in range(got.shape[-1]):
            assert limbs.unpack_point(got[k, ..., j]) == \
                limbs.unpack_point(want[k, ..., j]), (k, j)


@pytest.mark.parametrize("source", ["expanded", "head"])
def test_u32_tables_equal_the_reference_as_points(source):
    """The default K4's plain version equals the JAX package's
    build_multiples_tables entry by entry as points, and each entry is
    canonical_limbs20 of the entry `_u32_table_tree` gives (entry 0 the
    identity); on head points it also equals the host-built head tables
    as points."""
    if source == "expanded":
        pts, host = _expanded(96, 0x4B), None
    else:
        pts, host = _head_points()
    got = msm.build_tables_plain(pts)
    assert got.dtype == torch.int16 and got.shape == (
        1, msm.NTABLE, 4, limbs.NLIMBS, pts.shape[-1])
    want = np.asarray(jmsm.build_multiples_tables(pts.numpy()))
    _assert_entries_equal_as_points(got[0].numpy(), want[0])
    p = pts.permute(1, 2, 0, 3).int()
    tree = [TE.identity_like(p)] + msm._u32_table_tree(p)
    for k, ent in enumerate(tree):
        assert torch.equal(got[:, k].permute(1, 2, 0, 3).int(),
                           TF.canonical_limbs20(ent.movedim(1, 0))
                           .movedim(0, 1)), k
    if host is not None:
        _assert_entries_equal_as_points(got[0].numpy(), host)


@pytest.mark.parametrize("N,n_head", [(150, 70), (64, 1), (193, 129)])
def test_k2t_on_u32_tables_equals_k2_limb_for_limb(N, n_head):
    """K2t's plain version on the default K4's tables for every lane — the
    full-tables form (n_head = N) and split into head tables (TH = B) and
    R tables at a boundary inside a chunk — equals K2's plain version on
    the same points limb for limb, on packed and plain digits: the tree
    makes every table entry the residue K2 builds."""
    B = 2
    pts = torch.cat([_expanded(N, 0x50 + N), _expanded(N, 0x60 + N)])
    d = np.random.default_rng(N).integers(
        -8, 8, size=(B, limbs.NWINDOWS, N)).astype(np.int8)
    d[:, :, :N // 8] = -8
    d[:, :, N // 8:N // 4] = 7
    d[:, 3] = 0
    packed = torch.from_numpy(np.stack([limbs.pack_digit_planes(x)
                                        for x in d]))
    tbl = msm.build_tables_plain(pts)
    k2 = msm.window_partials_plain(packed, pts)
    for digits in (packed, torch.from_numpy(d)):
        assert torch.equal(msm.window_partials_tables_plain(digits, tbl), k2)
        assert torch.equal(msm.window_partials_tables_plain(
            digits, tbl[..., :n_head].contiguous(),
            tbl[..., n_head:].contiguous()), k2)


def test_l20_form_is_the_reference_chain_and_r32_ignores_arith():
    """arith="l20" gives the JAX package's build_multiples_tables byte for
    byte (entry k = entry (k − 1) + P), through the plain version and the
    wrapper, and differs from the default's limbs; at radix 32 both ariths
    give the 17-entry 20-limb chain; an unknown arith raises."""
    pts = _expanded(40, 0x70)
    want = np.asarray(jmsm.build_multiples_tables(pts.numpy()))
    l20 = msm.build_tables_plain(pts, arith="l20")
    assert l20.numpy().tobytes() == want.tobytes()
    assert torch.equal(msm.multiples_tables(pts, arith="l20"), l20)
    assert not torch.equal(msm.multiples_tables(pts), l20)
    r32 = msm.build_tables_plain(pts, window_bits=5)
    assert r32.shape[1] == 17
    assert torch.equal(r32, msm.build_tables_plain(pts, window_bits=5,
                                                   arith="l20"))
    for call in (msm.build_tables_plain, msm.multiples_tables):
        with pytest.raises(ValueError, match="arith"):
            call(pts, arith="u64")
