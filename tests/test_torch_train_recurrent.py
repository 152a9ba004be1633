"""The port's recurrent archs in training against the JAX package, on
the CPU: ``loss_fn`` and its gradients for rwkv6-3b (2 layers, the
RWKV-6 scan in its out-of-place form under autograd) and
recurrentgemma-9b (its smoke depth, 4 layers: RG-LRU and local
attention), float32 (loss within 2e-4 relative, gradients within
``1e-4·max|ref|``); then rwkv6-3b's ``make_train_step`` over 5 steps from
one converted state, the loss trajectory within rtol 1e-4 in float32 and
5e-2 in bf16, and falling (``tests/test_models_smoke.py:48``).
"""

import pytest

from torch_train_cases import check_loss_and_grads, check_trajectory


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_trajectory_matches_reference_and_falls(dtype):
    losses = check_trajectory("rwkv6-3b", dtype)
    assert losses[-1] < losses[0]
