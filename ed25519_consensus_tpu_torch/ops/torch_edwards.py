"""Edwards25519 group ops on int32 limb tensors, plain PyTorch.

Points are (4, NLIMBS, ...) int32 tensors — extended coordinates
(X : Y : Z : T) with each coordinate a balanced limb vector.  The addition
law is the same COMPLETE unified formula as the exact host implementation
(ops/edwards.py, add-2008-hwcd-3 with a = -1, k = 2d), so it is valid for
every input including identity padding, doublings, and 8-torsion points —
no data-dependent branching anywhere.  `csrc/fe25519.cuh` `ge_add` is the
same sequence of field ops, so kernel and plain version agree limb for
limb.
"""

import torch

from . import torch_field as F
from .field import D2, P
from .limbs import int_to_limbs

D2_LIMBS = [int(v) for v in int_to_limbs(D2 % P)]


def point_add(p, q):
    """Complete unified addition on (4, NLIMBS, ...) tensors.

    A=(Y1-X1)(Y2-X2), B=(Y1+X1)(Y2+X2), C=2d·T1·T2, D=2·Z1·Z2,
    E=B-A, F=D-C, G=D+C, H=B+A; X3=EF, Y3=GH, Z3=FG, T3=EH."""
    X1, Y1, Z1, T1 = p[0], p[1], p[2], p[3]
    X2, Y2, Z2, T2 = q[0], q[1], q[2], q[3]
    A = F.mul(F.sub(Y1, X1), F.sub(Y2, X2))
    B = F.mul(F.add(Y1, X1), F.add(Y2, X2))
    C = F.mul(F.mul(T1, F.const(D2_LIMBS, T1.shape[1:], T1.device)), T2)
    Dv = F.mul_small(F.mul(Z1, Z2), 2)
    E = F.sub(B, A)
    Fv = F.sub(Dv, C)
    G = F.add(Dv, C)
    H = F.add(B, A)
    return torch.stack(
        [F.mul(E, Fv), F.mul(G, H), F.mul(Fv, G), F.mul(E, H)])


def identity_like(p):
    """(0 : 1 : 1 : 0) broadcast to the shape of p."""
    ident = torch.zeros_like(p)
    ident[1, 0] = 1
    ident[2, 0] = 1
    return ident
