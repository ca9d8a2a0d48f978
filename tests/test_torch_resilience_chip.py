"""``chip_smoke.py`` phase 11's plans (the reference's chaos and heal, the
card's cut of chaos, deadline) on the CPU: the port's engine against the
reference's under the same plan and trace, and the counters and failure
records phase 11 holds the card to (``resilience_expected``,
``DEADLINE_RECORDS``).  The harness is
``tests/test_torch_resilience_engine.py``'s."""

import pytest

from reference_cpu import reference_on_cpu  # noqa: E402, F401
from test_torch_resilience_engine import _isolated, check_case  # noqa: F401
import torch_port  # noqa: F401


@pytest.mark.parametrize("case", ["chaos", "card_chaos", "deadline",
                                  "heal"])
def test_phase11_run_matches_reference_and_card_expectations(case):
    check_case(case)
