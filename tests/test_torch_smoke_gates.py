"""The end-to-end gates of ``chip_smoke.py``, on the CPU (the script runs on
the card only; its gates are plain functions of cosines):

- phase 10a's ``noise_gate`` (``1 - c_plain <= max(5e-4, 2 (1 -
  c_noise))``, ``c_plain >= 0.998``, ``c_noise >= 0.995``; its constants
  pinned) passes granite-moe-3b-a800m's runs as measured on an H100
  before the gate was fixed (D: ``1 - c_plain`` 6.90e-4, S: ``c_plain``
  0.998967, a one-bf16-step noise control at 0.998953), and fails a
  control that moves the logits too far, a plain pass under 0.998 and a
  plain pass past the limit; it also passes the faulty pass that was to
  fail it on the card (D's plain pass with one selected page left out of
  layer 16's every decode call: c_plain 0.999300 under c_noise
  0.997784), which is why phase 10a now runs under the per-call oracle
  (``chip_smoke.call_oracle``, ``tests/test_torch_call_oracle.py``)
  instead;
- phase 9's ``s_gate`` at its own constants;
- phase 13 a)'s gradient gate (``grad_misses``) on the leaves an H100
  gave it: a clean pass passes, the rope and mask faults fail.

A few seconds.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

#: granite's runs D and S on the card, and its one-step noise control
GRANITE_D_PLAIN, GRANITE_S_PLAIN, GRANITE_NOISE = 1 - 6.90e-4, 0.998967, 0.998953
#: the power check on the card: D's faulty plain pass and D's noise control
GRANITE_FAULT, GRANITE_D_NOISE = 0.999300, 0.997784


def test_noise_gate_constants():
    assert (chip_smoke.NOISE_GATE_FLOOR, chip_smoke.NOISE_GATE_RATIO,
            chip_smoke.NOISE_MIN_PLAIN, chip_smoke.NOISE_MIN_NOISE) == (5e-4, 2.0, 0.998, 0.995)


@pytest.mark.parametrize("c_plain", [GRANITE_D_PLAIN, GRANITE_S_PLAIN], ids=["D", "S"])
def test_noise_gate_passes_granite_runs(c_plain):
    ok, limit = chip_smoke.noise_gate("granite", c_plain, GRANITE_NOISE)
    assert ok
    assert limit == pytest.approx(2 * (1 - GRANITE_NOISE))
    # about 2x inside the limit (D) or 1.5x (S)
    assert 1 - c_plain < limit / 1.5


@pytest.mark.parametrize("c_plain,c_noise", [
    (0.999, 0.9949),            # the control moves the logits too far: broken
    (0.9979, 0.996),            # the plain pass under 0.998, inside 2 (1 - c_noise)
    (GRANITE_D_PLAIN, 0.99999),  # past the 5e-4 floor, the control near 1
    (0.9985, 0.9995),           # past 2 (1 - c_noise)
], ids=["wide-control", "plain-floor", "floor", "ratio"])
def test_noise_gate_fails(c_plain, c_noise):
    ok, _ = chip_smoke.noise_gate("case", c_plain, c_noise)
    assert not ok


@pytest.mark.parametrize("c_plain,c_ctrl,ok", [
    (1 - 5.05e-4, 1 - 2.92e-4, True),
    (1 - 6e-4, 1 - 2e-4, False),
    (0.9989, 0.9989, False),
])
def test_s_gate(c_plain, c_ctrl, ok):
    assert chip_smoke.s_gate("case", c_plain, c_ctrl)[0] == ok


def test_noise_gate_passes_the_power_checks_fault():
    ok, limit = chip_smoke.noise_gate("power check", GRANITE_FAULT, GRANITE_D_NOISE)
    assert ok and limit == pytest.approx(4.43e-3, rel=1e-3)


def test_train_gradient_gate():
    """Phase 13 a)'s gate on the leaves an H100 gave it
    (``tools/train_grad_control.py``; NVIDIA H100 80GB HBM3, 700 W): the
    worst clean leaves pass; the rope and mask faults fail on layer 1's wq
    and wk."""
    assert (chip_smoke.TRAIN_GRAD_COS, chip_smoke.TRAIN_GRAD_RTOL) == (0.99985, 0.018)
    clean = {"embed": (0.999935, 0.01192), "final_norm": (0.999992, 0.00413),
             "layers.1.wq": (0.999956, 0.00949), "layers.1.wk": (0.99996, 0.00894)}
    assert chip_smoke.grad_misses(clean) == {}
    for wq, wk in (((0.999647, 0.02657), (0.999626, 0.02734)),      # mask
                   ((0.999489, 0.03197), (0.999483, 0.03218))):     # rope
        fault = {"embed": (0.999927, 0.01241), "layers.1.norm1": (0.999986, 0.00535),
                 "layers.1.wq": wq, "layers.1.wk": wk, "layers.1.wv": (0.999987, 0.00505)}
        assert set(chip_smoke.grad_misses(fault)) == {"layers.1.wq", "layers.1.wk"}
