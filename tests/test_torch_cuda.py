"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  A CUDA kernel has no CPU or interpret mode, so
these tests skip without a card; run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the
shared conftest imports jax, which this file does not need).  Tolerance: exact
(byte-identical digests and proofs).
"""

import hashlib

import numpy as np
import pytest
import torch

from hbbft_tpu_torch import build
from hbbft_tpu_torch.ops.device import dataplane as dp
from hbbft_tpu_torch.ops.device import keccak as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the keccak kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("batch,m", [(1, 0), (33, 65), (1000, 135), (257, 136), (64, 1779)])
def test_keccak_kernel_matches_plain_and_hashlib(cuda, batch, m):
    rng = np.random.default_rng(batch + m)
    msgs = rng.integers(0, 256, size=(batch, m), dtype=np.uint8)
    padded = K.pad_tensor(torch.as_tensor(msgs, device=cuda))
    build.reset_launches()
    got = K.sha3_256_kernel(padded)
    assert build.LAUNCHES[K.KERNEL] == 1
    assert torch.equal(got, K.sha3_256_padded(padded))
    host = got.cpu().numpy()
    for i in range(0, batch, max(1, batch // 8)):
        assert host[i].tobytes() == hashlib.sha3_256(msgs[i].tobytes()).digest()


def test_dataplane_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    values = [rng.integers(0, 256, 3000, dtype=np.uint8).tobytes() for _ in range(10)]
    build.reset_launches()
    on_card = dp.encode_and_prove(values, 4, 10, device=cuda)
    assert build.LAUNCHES[K.KERNEL] == 1 + 4  # leaves + one per tree level
    on_cpu = dp.encode_and_prove(values, 4, 10, device="cpu")
    assert on_card == on_cpu
