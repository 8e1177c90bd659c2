"""``test_torch_train_grads.py``'s checks on internvl2-2b and
musicgen-large with prefix embeddings (musicgen adds its sinusoidal
positions over them) and on rwkv6-3b: f32 loss within 1e-5 relative,
every gradient within 1e-4 relative L2 (granite-moe-3b-a800m is in
``test_torch_train_grads_moe.py``).

About 15 s in one process, 35 s under the tier-1 run's six workers.
"""
import pytest

from test_torch_dense_family import _one_thread  # noqa: F401
from test_torch_train_grads import check_loss_and_grads


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-large", "rwkv6-3b"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
