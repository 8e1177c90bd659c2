"""``test_torch_train_grads.py``'s checks on recurrentgemma-9b at 5
layers (one cycle of rglru, rglru, local_attn, then two remainder rglru
layers, which JAX runs outside its scan and the port outside the
checkpointed cycles; the window of 64 inside the 96-token sequence): f32
loss within 1e-5 relative, every gradient within 1e-4 relative L2; its
remat policies bitwise equal (rwkv6-3b is in
``test_torch_train_grads_families.py``).

About 15 s in one process, 25 s under the tier-1 run's six workers.
"""
from test_torch_dense_family import _one_thread  # noqa: F401
from test_torch_train_grads import check_loss_and_grads, check_remat_bitwise


def test_loss_and_grads_match_jax():
    check_loss_and_grads("recurrentgemma-9b")


def test_recurrent_remat_policies_are_bitwise_equal():
    check_remat_bitwise("recurrentgemma-9b")
