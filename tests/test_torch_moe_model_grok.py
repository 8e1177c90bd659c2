"""grok-1-314b's smoke variant (8 experts top-2 reduced to 4 top-2, GeGLU,
untied head) in the port's model against JAX on the CPU: at f32, logits
within 1e-4 and greedy tokens identical to JAX's for ``prefill``, chunked
``prefill_chunk`` (a padded last chunk) and three decode steps after
each, in the default configuration and on the ``"dense"`` backend
(``test_torch_moe_model.check_case``)."""
import pytest

from test_torch_dense_family import _one_thread  # noqa: F401
from test_torch_moe_model import CASES, check_case, drops  # noqa: F401


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("grok")])
def test_prefill_chunks_and_decode_match_jax(case, drops):  # noqa: F811
    check_case(case, drops)
