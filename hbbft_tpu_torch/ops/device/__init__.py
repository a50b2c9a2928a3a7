"""The reliable-broadcast data plane on the card: batched SHA3-256
(:mod:`.keccak`, a hand-written CUDA kernel), Reed-Solomon as a GF(2)
bit product (:mod:`.gf256`) and :func:`.dataplane.encode_and_prove`.

Counterpart of ``hbbft_tpu/ops/jaxops``.
"""
