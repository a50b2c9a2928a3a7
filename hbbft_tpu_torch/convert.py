"""Carry state across from the JAX package: limbs and verify requests.

This system's "weights" are key material and device point state.  The
JAX package holds field elements as ``(..., 36)`` int32 Montgomery limbs
(the output of its ``g1_to_dev``/``g2_to_dev`` and ``fq.to_mont_batch``);
the port holds the same limbs in int64 tensors, so carrying them across
is a dtype change and a device move, and the values stay bit-identical.

Requests are rebuilt from canonical bytes: :func:`requests_from_reference`
reads only attributes and ``to_bytes()`` of the reference's objects (duck
typing), so this module imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from hbbft_tpu_torch.crypto.backend import (
    CIPHERTEXT,
    DEC_SHARE,
    SIG_SHARE,
    VerifyRequest,
)
from hbbft_tpu_torch.crypto.bls.suite import BLSSuite, G1Elem, G2Elem, _jac_from_bytes
from hbbft_tpu_torch.crypto.device import fq
from hbbft_tpu_torch.crypto.keys import (
    Ciphertext,
    DecryptionShare,
    PublicKeyShare,
    SignatureShare,
)
from hbbft_tpu_torch.device import DeviceLike, resolve


def limbs_from_reference(arr: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """The reference's (..., 36) int32 limb array -> int64 tensor on ``device``."""
    a = np.asarray(arr)
    if a.shape[-1:] != (fq.NL,) or not np.issubdtype(a.dtype, np.integer):
        raise ValueError(f"expected (..., {fq.NL}) integer limbs, got {a.shape} {a.dtype}")
    return torch.as_tensor(a.astype(np.int64), device=resolve(device))


def limbs_to_reference(t: torch.Tensor) -> np.ndarray:
    """Port limbs -> the reference's int32 numpy layout (limbs < 2^31)."""
    a = t.detach().cpu().numpy()
    if a.size and (a.min() < 0 or a.max() >= 1 << 31):
        raise ValueError("limbs outside the int32 range")
    return a.astype(np.int32)


def _g1(elem: Any) -> G1Elem:
    # Structural decode only: a non-subgroup point must reach the flush
    # as it is, so that the flush's own subgroup check can reject it.
    return G1Elem(_jac_from_bytes(elem.to_bytes(), fq2=False))


def _g2(elem: Any) -> G2Elem:
    return G2Elem(_jac_from_bytes(elem.to_bytes(), fq2=True))


def _ciphertext(suite: BLSSuite, ct: Any) -> Ciphertext:
    return Ciphertext(_g1(ct.u), bytes(ct.v), _g2(ct.w), suite)


def requests_from_reference(reqs: Sequence[Any], suite: BLSSuite) -> List[VerifyRequest]:
    """Rebuild the port's ``VerifyRequest``s from the reference's BLS
    requests, over the port's ``suite``, through canonical point bytes."""
    out: List[VerifyRequest] = []
    for r in reqs:
        if r.kind == SIG_SHARE:
            pk, msg, share = r.payload
            out.append(VerifyRequest.sig_share(
                PublicKeyShare(_g1(pk.g1), suite), bytes(msg),
                SignatureShare(_g2(share.g2), suite),
            ))
        elif r.kind == DEC_SHARE:
            pk, ct, share = r.payload
            out.append(VerifyRequest.dec_share(
                PublicKeyShare(_g1(pk.g1), suite), _ciphertext(suite, ct),
                DecryptionShare(_g1(share.g1), suite),
            ))
        elif r.kind == CIPHERTEXT:
            (ct,) = r.payload
            out.append(VerifyRequest.ciphertext(_ciphertext(suite, ct)))
        else:
            raise ValueError(f"unknown request kind {r.kind!r}")
    return out
