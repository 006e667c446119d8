"""The port's train step against the reference's for the first six of
the ten reduced configs (the other four, and the tolerances, are in
``test_torch_train.py``; the split keeps each file near 30 s)."""
import pytest

pytest.importorskip("jax")

from repro_torch.configs import ARCH_NAMES  # noqa: E402
from test_torch_train import check_train_step  # noqa: E402


@pytest.mark.parametrize("name", ARCH_NAMES[:6])
def test_train_step_matches_reference(name):
    check_train_step(name)
