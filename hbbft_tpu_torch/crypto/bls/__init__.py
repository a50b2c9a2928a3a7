"""Pure-Python BLS12-381: the trusted CPU oracle suite.

Reference: the ``pairing``/``bls12_381`` crates under upstream
``threshold_crypto`` (SURVEY.md §2 #14).  This implementation is the
correctness oracle for the TPU path: slow, simple, and self-validating
(curve membership, subgroup orders, and twist cofactors are checked or
derived numerically at import — see :mod:`hbbft_tpu_torch.crypto.bls.curve`).

Tower: Fq2 = Fq[u]/(u^2 + 1); Fq12 = Fq2[w]/(w^6 - xi), xi = 1 + u.
G1 on E: y^2 = x^3 + 4 over Fq; G2 on the M-twist E': y^2 = x^3 + 4*xi
over Fq2.  Pairing: optimal ate (Miller loop over |x|, x the BLS
parameter, with a final conjugation because x < 0), generic final
exponentiation (easy part via Frobenius, hard part by integer exponent
(p^4 - p^2 + 1) / r).
"""

from hbbft_tpu_torch.crypto.bls.suite import BLSSuite  # noqa: F401
