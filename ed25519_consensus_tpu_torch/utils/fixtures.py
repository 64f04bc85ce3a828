"""Conformance-test fixture generators (reference tests/util/mod.rs:66-155).

These enumerate every non-canonical Ed25519 encoding class that ZIP215 forces
implementations to agree on, plus the libsodium-1.0.15 blacklist used by the
legacy (pre-ZIP215) rules (utils/legacy.py)."""

from ..ops import edwards
from ..ops.field import P


def non_canonical_field_encodings():
    """The 19 field elements with a second, 255-bit encoding: y + p for
    y in 0..18 (reference tests/util/mod.rs:66-79)."""
    return [(P + i).to_bytes(32, "little") for i in range(19)]


def non_canonical_point_encodings():
    """All 26 non-canonical point encodings; the first 6 are low-order
    (reference tests/util/mod.rs:82-155; the reference comment's count of
    "25" is unreachable — decompression success is sign-bit-independent, so
    the field-encoding loop contributes an even count, plus 2 explicit
    x=0 encodings).

    Two sources of non-canonicality:
    (1) a non-canonical y encoding (the 19 elements above, both sign bits,
        kept when they decompress);
    (2) x = 0 (so both sign bits give the same point), i.e. y = ±1: the
        sign-bit-1 encodings of enc(1) and enc(-1).
    """
    encodings = []

    # Canonical y with redundant sign bit (x = 0 points).
    y1 = bytearray((1).to_bytes(32, "little"))
    y1[31] |= 0x80
    encodings.append(bytes(y1))
    ym1 = bytearray((P - 1).to_bytes(32, "little"))
    ym1[31] |= 0x80
    encodings.append(bytes(ym1))

    for enc in non_canonical_field_encodings():
        if edwards.decompress(enc) is not None:
            encodings.append(enc)
        high = bytearray(enc)
        high[31] |= 0x80
        if edwards.decompress(bytes(high)) is not None:
            encodings.append(bytes(high))

    # Self-check: every generated encoding really is non-canonical.
    for enc in encodings:
        pt = edwards.decompress(enc)
        assert pt is not None and pt.compress() != enc, enc.hex()

    return encodings


# Point encodings blacklisted by libsodium 1.0.15 in an (unsuccessful)
# attempt to exclude low-order points; pinned by the Zcash protocol spec and
# the legacy rule set (reference tests/util/mod.rs:204-265).
EXCLUDED_POINT_ENCODINGS = [
    bytes.fromhex(h)
    for h in [
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0100000000000000000000000000000000000000000000000000000000000000",
        "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05",
        "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a",
        "13e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc85",
        "b4176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac03fa",
        "ecffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
        "edffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
        "eeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
        "d9ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff",
        "daffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff",
    ]
]
