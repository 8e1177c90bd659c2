"""``test_torch_train_grads.py``'s checks on granite-moe-3b-a800m: its MoE
aux loss in the loss and against JAX's ``forward_train``'s, f32 loss
within 1e-5 relative, every gradient within 1e-4 relative L2; its remat
policies bitwise equal (the router's and the experts' products under the
"dots" policy).

About 10 s in one process, 40 s under the tier-1 run's six workers.
"""
from test_torch_dense_family import _one_thread  # noqa: F401
from test_torch_train_grads import check_loss_and_grads, check_remat_bitwise


def test_loss_and_grads_match_jax():
    check_loss_and_grads("granite-moe-3b-a800m")


def test_moe_remat_policies_are_bitwise_equal():
    check_remat_bitwise("granite-moe-3b-a800m")
