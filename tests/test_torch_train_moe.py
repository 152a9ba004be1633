"""The port's MoE and MLA training against the JAX package, on the CPU:
``loss_fn`` and its gradients (``train_step.value_and_grad``) against
``jax.value_and_grad`` of the reference's, float32, smoke configs.  The
router, the experts, the shared experts and the load-balance loss (its
0.01 weight) carry gradients as the reference's do: mixtral-8x22b at a
capacity where no pair drops and at the full config's own factor (1.25),
where pairs drop and the drop sets must be the reference's for the
values to agree; deepseek-v2-236b at factor 16 and at its smoke factor,
where it drops too.  The loss within 2e-4 relative, each gradient leaf
within ``1e-4·max|ref|``.
"""

import pytest

from repro_torch.configs import get_config
from repro_torch.models import moe

from torch_train_cases import check_loss_and_grads


@pytest.fixture
def dropped(monkeypatch):
    """The pairs each ``moe._dispatch`` call drops, in call order."""
    drops = []
    real = moe._dispatch

    def spy(xt, router, m, cap):
        buf, meta = real(xt, router, m, cap)
        drops.append(int((~meta[0]).sum()))
        return buf, meta

    monkeypatch.setattr(moe, "_dispatch", spy)
    return drops


def _full_factor(arch) -> float:
    return next(sp.moe.capacity_factor for st in get_config(arch).stages
                for sp in st.pattern if sp.moe)


@pytest.mark.parametrize("arch,capacity,drops", [
    ("mixtral-8x22b", 16.0, False),
    ("mixtral-8x22b", "full", True),
    ("deepseek-v2-236b", 16.0, False),
    ("deepseek-v2-236b", None, True),
])
def test_moe_loss_and_grads_match_reference(dropped, arch, capacity, drops):
    if capacity == "full":
        capacity = _full_factor(arch)
    metrics = check_loss_and_grads(arch, capacity=capacity)
    assert float(metrics["aux_loss"]) > 0
    assert dropped and (sum(dropped) > 0) == drops, dropped


def test_fnet_loss_and_grads_match_reference():
    """The spectral mixer's DFT products differentiate as the
    reference's."""
    check_loss_and_grads("fnet-350m")
